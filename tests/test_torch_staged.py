"""The staged step (``fused=False``) on the CPU, where its kernels run
their plain versions (``stateright_tpu_torch/ops/staged.py``): KS1's
stage one against the JAX package's ``shrink_indices``, KS2's dedup
against ``pre_dedup``, the staged
chunk (KS1-KS3 with the insert) against the JAX package's staged chunk
program iteration for iteration, the row gate of the staged engine
against the JAX package's (every knob set on both sides), and the
``kovf`` rebuilds. Sound-eventually checking is
``tests/test_torch_sound.py``; the card's kernels are held to these plain
versions in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.checker import device_loop as jdl  # noqa: E402
from stateright_tpu.examples.paxos_packed import (  # noqa: E402
    PackedPaxos as JPaxos)
from stateright_tpu.models import twopc as jtwopc  # noqa: E402
from stateright_tpu.ops import expand as jexp  # noqa: E402
from stateright_tpu_torch import PackedPaxos, TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.ops.staged import (  # noqa: E402
    SC_LAST, SC_DCOUNT, SC_KOVF, SC_LEN, SC_VCOUNT, StagePlan,
    predup_reference, stage_reference, staged_sizes)
from stateright_tpu_torch.ops.words import (  # noqa: E402
    from_numpy_u32, to_numpy_u32)

JaxTwoPhaseSys = jtwopc.TwoPhaseSys


def _cpu(model, **opts):
    opts = {"device": "cpu", "race": False, **opts}
    return model.checker().gpu_options(**opts).spawn_gpu().join()


# --- KS1: stage one ----------------------------------------------------------

STAGE_CASES = [(f, a, d, kraw) for f, a in ((64, 7), (256, 16))
               for d in (0.0, 0.05, 0.5, 1.0) for kraw in (64, 1024)]


@pytest.mark.parametrize("f,a,density,kraw", STAGE_CASES)
def test_stage_one_matches_shrink_indices(f, a, density, kraw):
    """The global pick: the lowest ``kraw`` valid lanes in lane order,
    ``vcount`` and the overflow flag, against the JAX package's
    ``shrink_indices(cvalid, kraw)``; exact on the valid slots."""
    rng = np.random.default_rng(f * 1000 + kraw + int(density * 100))
    cvalid = rng.random(f * a) < density
    take = f - 3
    cvalid.reshape(f, a)[take:] = False
    plan = StagePlan(f, kraw, kraw)
    out = _stage(cvalid, f, a, take, plan)
    want = np.asarray(jdl.shrink_indices(jnp.asarray(cvalid), kraw))
    n = int(cvalid.sum())
    k = min(n, kraw)
    assert out.rvalid.numpy().tolist() == [j < n for j in range(kraw)]
    np.testing.assert_array_equal(out.src.numpy()[:k], want[:k])
    assert int(out.sctl[SC_VCOUNT]) == n
    assert int(out.sctl[SC_KOVF]) == int(n > kraw)


def _stage(cvalid, f, a, take, plan, pbits=None, terminal=None, eb=None,
           kinds=(), sound=False, q=None):
    zeros = torch.zeros((f,), dtype=torch.int32)
    return stage_reference(
        torch.from_numpy(cvalid),
        torch.zeros((f, 1), dtype=torch.bool) if pbits is None else pbits,
        torch.zeros((f,), dtype=torch.bool) if terminal is None else terminal,
        zeros if eb is None else eb,
        zeros if q is None else q[0], zeros if q is None else q[1],
        zeros if q is None else q[2], take, plan, list(kinds), sound)


def test_stage_one_discoveries_match_discovery_candidates():
    """KS1's discovery candidates: the first row of each property (an
    ALWAYS row where it fails, a SOMETIMES row where it holds, an
    EVENTUALLY terminal row with its bit pending) and its cached
    fingerprint, against the JAX package's ``discovery_candidates``."""
    from stateright_tpu.core import Property as JProperty
    f, a = 40, 3
    rng = np.random.default_rng(7)
    pbits = rng.random((f, 3)) < 0.8
    terminal = rng.random(f) < 0.3
    eb = rng.integers(0, 8, f).astype(np.uint32)
    phi = rng.integers(0, 2**32, f, dtype=np.uint64).astype(np.uint32)
    plo = rng.integers(0, 2**32, f, dtype=np.uint64).astype(np.uint32)
    take = 33
    kinds = [0, 1, 2]
    props = [JProperty.always("a", None), JProperty.sometimes("s", None),
             JProperty.eventually("e", None)]
    exp = jexp.Expansion(
        pbits=jnp.asarray(pbits), ebits=jnp.asarray(eb), flat=None,
        avalid=None, cvalid=None, chi=None, clo=None, ohi=None, olo=None,
        phi=jnp.asarray(phi), plo=jnp.asarray(plo),
        terminal=jnp.asarray(terminal & (np.arange(f) < take)), xovf=None)
    hit, whi, wlo = jexp.discovery_candidates(
        props, exp, jnp.asarray(np.arange(f) < take))
    out = _stage(np.zeros(f * a, bool), f, a, take, StagePlan(f, 8, 8),
                 pbits=torch.from_numpy(pbits),
                 terminal=torch.from_numpy(terminal & (np.arange(f) < take)),
                 eb=from_numpy_u32(eb), kinds=kinds,
                 q=(from_numpy_u32(eb), from_numpy_u32(phi),
                    from_numpy_u32(plo)))
    disc = to_numpy_u32(out.disc)
    np.testing.assert_array_equal(disc[:3].astype(bool), np.asarray(hit))
    h = np.asarray(hit)
    np.testing.assert_array_equal(disc[3:6][h], np.asarray(whi)[h])
    np.testing.assert_array_equal(disc[6:9][h], np.asarray(wlo)[h])


# --- KS2: the in-batch dedup and stage two ---------------------------------

@pytest.mark.parametrize("kfin", [32, 700, 2048])
@pytest.mark.parametrize("dups", [0.0, 0.5, 0.9])
def test_predup_matches_jax_pre_dedup(kfin, dups):
    """KS2 over the ``kraw`` slots of stage one: JAX's ``pre_dedup``
    (keys with duplicates and with keys that collide in the arena but
    differ), ``dcount``, the overflow past ``kfin`` and the stage-two
    compaction (``shrink_indices(dvalid, kfin)``) and insert mask;
    exact."""
    kraw, lanes, a = 2048, 4096, 4
    rng = np.random.default_rng(kfin + int(dups * 10))
    n_keys = max(1, int(lanes * (1 - dups)))
    pool = rng.integers(1, 2**32, (n_keys, 2), dtype=np.uint64)
    keys = pool[rng.integers(0, n_keys, lanes)].astype(np.uint32)
    # distinct keys on one arena cell: the same lo ^ hi * phi mod cells
    keys[1, 0] = keys[0, 0] ^ np.uint32(1 << 31)
    cvalid = rng.random(lanes) < 0.7
    vcount = int(cvalid.sum())
    plan = StagePlan(lanes // a, kraw, kfin)
    so = _stage(cvalid, lanes // a, a, lanes // a, plan)
    chi, clo = from_numpy_u32(keys[:, 0]), from_numpy_u32(keys[:, 1])
    sctl = so.sctl.clone()
    pd = predup_reference(so.src, so.rvalid, chi, clo,
                          torch.zeros((lanes // a,), dtype=torch.int32), a,
                          plan, sctl, sound=False)
    src = np.asarray(jdl.shrink_indices(jnp.asarray(cvalid), kraw))
    rvalid = np.arange(kraw) < vcount
    s_chi = jnp.asarray(keys[src, 0])
    s_clo = jnp.asarray(keys[src, 1])
    dvalid = np.asarray(jexp.pre_dedup(s_chi, s_clo, jnp.asarray(rvalid)))
    dcount = int(dvalid.sum())
    kovf = vcount > kraw or dcount > kfin
    assert int(sctl[SC_DCOUNT]) == dcount
    assert int(sctl[SC_KOVF]) == int(kovf)
    if kfin < kraw:
        src2 = np.asarray(jdl.shrink_indices(jnp.asarray(dvalid), kfin))
        k = min(dcount, kfin)
        np.testing.assert_array_equal(pd.lane.numpy()[:k], src[src2][:k])
        want_kv = (np.arange(kfin) < dcount) & (not kovf)
    else:
        np.testing.assert_array_equal(pd.lane.numpy()[dvalid],
                                      src[dvalid])
        want_kv = dvalid & (not kovf)
    np.testing.assert_array_equal(pd.kvalid.numpy(), want_kv)
    kv = pd.kvalid.numpy()
    lane = pd.lane.numpy().astype(np.int64)
    np.testing.assert_array_equal(to_numpy_u32(pd.khi)[kv], keys[lane[kv], 0])


def test_staged_sizes_are_the_jax_build_sizes():
    """The plans the staged chunk runs: the JAX package's
    ``build_chunk_core`` derivation of each step size's kraw and kfin,
    and its queue margin."""
    m = PackedPaxos(3)
    plans, margin = staged_sizes(m, 8192, 40960, 20480)
    assert plans[2] == StagePlan(8192, 40960, 20480)
    assert plans[1] == StagePlan(256, 4096, 4096)
    assert margin == 20480
    plans, _m = staged_sizes(m, 256, 40960, 20480)
    assert list(plans) == [2]
    assert plans[2] == StagePlan(256, 4096, 4096)


# --- the staged chunk against the JAX package's ---------------------------

def _seed_both(tmodel, jmodel, qcap, cap, sound):
    from stateright_tpu.ops.hashtable import plan_insert_host
    from stateright_tpu_torch.checker.device_loop import seed_carry
    from stateright_tpu_torch.fingerprint import fp64_node
    from stateright_tpu_torch.ops.expand import eventually_indices
    from stateright_tpu_torch.ops.hashtable import table_insert
    full = sum(1 << i for i in eventually_indices(tmodel.properties()))
    inits = [s for s in tmodel.init_states() if tmodel.within_boundary(s)]
    rows, fps, keys = [], [], []
    for s in inits:
        fp = tmodel.fingerprint(s)
        key = fp64_node(fp, full) if sound else fp
        if key not in keys:
            keys.append(key)
            fps.append(fp)
            rows.append(tmodel.encode(s))
    ecap = cap if sound else 0
    carry = seed_carry(tmodel, qcap, cap, rows, full, fps, 0, "cpu",
                       sound=sound, ecap=ecap)
    arr = np.asarray(keys, np.uint64)
    table_insert(carry.table,
                 from_numpy_u32((arr >> np.uint64(32)).astype(np.uint32)),
                 from_numpy_u32(arr.astype(np.uint32)),
                 torch.ones((len(keys),), dtype=torch.bool), mask=False)
    jcarry = jdl.seed_carry(jmodel, qcap, cap, rows, np.uint32(full),
                            steps=0, symmetry=sound, init_fps=fps,
                            table_plan=(plan_insert_host(keys, cap), keys),
                            ecap=ecap)
    return carry, jcarry, len(rows), ecap


CHUNK_CASES = [("2pc4", 1), ("2pc4", 3), ("2pc4", 9), ("ping3", 2),
               ("ping3", 6)]


@pytest.mark.parametrize("name,steps", CHUNK_CASES,
                         ids=[f"{n}-{s}" for n, s in CHUNK_CASES])
def test_staged_chunk_matches_jax_chunk_program(name, steps):
    """``steps`` iterations of the staged chunk (KS1, KS2, the insert
    and KS3's plain versions) from the same seed as the JAX package's
    staged chunk program (``build_chunk_fn(fused=False)``; under sound
    with node keys and the edge log): the queue, the log, the edge log
    and the counters, exact."""
    from stateright_tpu_torch.actor.test_util import PackedPingPong
    from stateright_tpu.actor.test_util import PackedPingPong as JPing
    from stateright_tpu_torch.checker.device_loop import (
        B_DMAX, B_E_N, B_GEN, B_LOG_N, B_PDH, B_Q_HEAD, B_Q_TAIL, B_VMAX,
        ChunkRunner, Staged, disc_registers)
    if name == "2pc4":
        tm, jm, sound, fmax, kraw, kmax = (TwoPhaseSys(4), JaxTwoPhaseSys(4),
                                           False, 64, 512, 256)
    else:
        tm = PackedPingPong(3, lossy=True, duplicating=True)
        jm = JPing(3, lossy=True, duplicating=True)
        sound, fmax, kraw, kmax = True, 32, 2048, 2048
    qcap, cap = 1 << 13, 1 << 13
    carry, jcarry, n_init, ecap = _seed_both(tm, jm, qcap, cap, sound)
    plans, margin = staged_sizes(tm, fmax, kraw, kmax)
    runner = ChunkRunner(tm, carry, fmax,
                         staged=Staged(plans, margin, sound, ecap))
    c = runner.dispatch(steps).read()
    fn = jdl.build_chunk_fn(jm, qcap, cap, fmax, kmax, symmetry=False,
                            sound=sound, n_init=n_init, kraw=kraw,
                            ecap=ecap)
    jcarry = jcarry._replace(steps=jnp.int32(steps))
    jcarry, _st = fn(jcarry, np.int32(2**31 - 1), np.int32(2**31 - 1),
                     np.int32(0))
    tail, log_n = int(jcarry.q_tail), int(jcarry.log_n)
    assert (int(c[B_Q_HEAD]), int(c[B_Q_TAIL]), int(c[B_LOG_N]),
            int(c[B_GEN]), int(c[B_E_N]), int(c[B_VMAX]), int(c[B_DMAX]),
            int(c[B_PDH])) == (
        int(jcarry.q_head), tail, log_n, int(jcarry.gen), int(jcarry.e_n),
        int(jcarry.vmax), int(jcarry.dmax), int(jcarry.pdh))
    np.testing.assert_array_equal(to_numpy_u32(carry.q[:tail]),
                                  np.asarray(jcarry.q[:tail]))
    np.testing.assert_array_equal(to_numpy_u32(carry.log[:log_n]),
                                  np.asarray(jcarry.log[:log_n]))
    if sound:
        e_n = int(jcarry.e_n)
        assert e_n > 0 or steps < 6  # the cross edges begin at depth 3
        np.testing.assert_array_equal(to_numpy_u32(carry.elog[:e_n]),
                                      np.asarray(jcarry.elog[:e_n]))
    hit, fp = disc_registers(c, len(tm.properties()))
    np.testing.assert_array_equal(hit, np.asarray(jcarry.disc_hit))
    want = (np.asarray(jcarry.disc_hi).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(jcarry.disc_lo).astype(np.uint64)
    np.testing.assert_array_equal(fp[hit], want[hit])


# --- the engine: the row gate and kovf ---------------------------------------

STAGED_2PC = [dict(fmax=16, kraw=4096, kmax=4096),
              dict(fmax=512, kraw=4096, kmax=4096),
              dict(fmax=512, kraw=256, kmax=256),
              dict(fmax=512, kraw=4096, kmax=64)]


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("opts", STAGED_2PC,
                         ids=["f16", "f512", "kovf", "kovf_kmax"])
def test_2pc4_row_gate_against_jax_staged_engine(opts, pipeline):
    """``fused=False`` against the JAX package's staged engine with every
    knob set on both sides: the search record row for row, the counts,
    the discoveries; buffers sized too small (the raw one and the
    post-dedup one, or the post-dedup one alone) rebuild on ``kovf`` in
    both, to the same record."""
    opts = dict(opts, capacity=1 << 12, chunk_steps=8, pipeline=pipeline,
                fused=False)
    want = JaxTwoPhaseSys(4).checker().tpu_options(
        race=False, mode="device", **opts).spawn_tpu().join()
    got = _cpu(TwoPhaseSys(4), cc_dedup=False, **opts)
    want._ensure_mirror()
    got._ensure_mirror()
    assert got.unique_state_count() == want.unique_state_count() == 1568
    assert got.state_count() == want.state_count()
    assert list(got._generated.items()) == list(want._generated.items())
    assert got._discovery_fps == want._discovery_fps
    prof = got.profile()
    assert prof["staged"] is True
    if opts["kmax"] < 4096:
        assert prof["kovfs"] >= 1 and prof["captures"] == 0


PAXOS_STAGED = [dict(fmax=16, kraw=4096, kmax=4096),
                dict(fmax=256, kraw=512, kmax=256),
                dict(fmax=256, kraw=64, kmax=16),
                dict(fmax=64, kraw=4096, kmax=4096, hcap=4)]


@pytest.mark.parametrize("opts", PAXOS_STAGED,
                         ids=["f16", "f256", "kovf", "hcap4"])
def test_paxos1_row_gate_staged_against_jax_staged_engine(opts):
    """PackedPaxos(1) with ``fused=False`` (the history stage after each
    staged append; from a history table of 4 keys, which grows) against
    the JAX package's staged engine, every knob set: row for row; its
    run with both buffers too small rebuilds on ``kovf``."""
    opts = dict(opts, capacity=1 << 12, chunk_steps=8, pipeline=False,
                fused=False)
    want = JPaxos(1).checker().tpu_options(
        race=False, mode="device", **opts).spawn_tpu().join()
    got = _cpu(PackedPaxos(1), **opts)
    want._ensure_mirror()
    got._ensure_mirror()
    assert got.unique_state_count() == want.unique_state_count() == 265
    assert got.state_count() == want.state_count()
    assert list(got._generated.items()) == list(want._generated.items())
    assert got._discovery_fps == want._discovery_fps
    got.assert_no_discovery("linearizable")
    if opts["kmax"] == 16:
        assert got.profile()["kovfs"] >= 1


def test_staged_growth_keeps_count_and_record():
    """The staged chunk across table growth (the log re-inserted, the
    chunk rebuilt): the same record as a run that never grows."""
    grown = _cpu(TwoPhaseSys(5), fused=False, capacity=1 << 10, fmax=16)
    flat = _cpu(TwoPhaseSys(5), fused=False, capacity=1 << 16, fmax=16)
    assert grown.profile()["grows"] >= 1
    assert grown.unique_state_count() == flat.unique_state_count() == 8832
    assert grown.state_count() == flat.state_count()
    assert grown.generated_fingerprints() == flat.generated_fingerprints()


def test_staged_options_that_raise():
    from stateright_tpu_torch.actor.test_util import PackedPingPong
    with pytest.raises(ValueError, match="fused=True"):
        PackedPingPong(3, lossy=True, duplicating=True).checker() \
            .sound_eventually().gpu_options(device="cpu",
                                            fused=True).spawn_gpu()
    with pytest.raises(NotImplementedError, match="hint"):
        TwoPhaseSys(3).checker().gpu_options(device="cpu", fused=False,
                                             hint=2).spawn_gpu()
    with pytest.raises(NotImplementedError, match="fallback"):
        TwoPhaseSys(3).checker().gpu_options(device="cpu",
                                             fused="auto").spawn_gpu()
    with pytest.raises(NotImplementedError, match="fused=False"):
        TwoPhaseSys(3).checker().gpu_options(device="cpu",
                                             kraw=64).spawn_gpu()
    with pytest.raises(NotImplementedError, match="mesh"):
        TwoPhaseSys(3).checker().gpu_options(device="cpu", fused=False,
                                             mesh=object()).spawn_gpu()


def test_sctl_layout_is_the_kernels():
    """``ops/staged.py``'s control vector and ``csrc/staged.cu``'s
    ``Sctl`` name the same words."""
    import pathlib
    import re
    src = (pathlib.Path(__file__).resolve().parent.parent
           / "stateright_tpu_torch" / "csrc" / "staged.cu").read_text()
    body = re.search(r"enum Sctl \{(.*?)\};", src, re.S).group(1)
    named = dict(re.findall(r"(SC_\w+) = (\d+)", body))
    assert {k: int(v) for k, v in named.items()} == {
        "SC_VCOUNT": SC_VCOUNT, "SC_KOVF": SC_KOVF, "SC_DCOUNT": SC_DCOUNT,
        "SC_LAST": SC_LAST}
    assert SC_LEN == SC_LAST + 1 and "SC_LEN\n" in body


@pytest.mark.parametrize("complete", [True, False],
                         ids=["complete", "reference"])
def test_2pc4_symmetry_row_gate_staged_against_jax(complete):
    """The staged step under symmetry reduction (canonical keys, the
    children's own fingerprints in the log's last two columns) against
    the JAX package's staged engine, every knob set: row for row."""
    opts = dict(fmax=64, capacity=1 << 12, chunk_steps=8, pipeline=False,
                fused=False, kraw=2048, kmax=1024)
    jm = JaxTwoPhaseSys(4, complete_symmetry=complete)
    want = jm.checker().symmetry_fn(jm.representative).tpu_options(
        race=False, mode="device", **opts).spawn_tpu().join()
    tm = TwoPhaseSys(4, complete_symmetry=complete)
    got = tm.checker().symmetry_fn(tm.representative).gpu_options(
        device="cpu", race=False, **opts).spawn_gpu().join()
    want._ensure_mirror()
    got._ensure_mirror()
    assert got.unique_state_count() == want.unique_state_count()
    assert got.state_count() == want.state_count()
    assert list(got._generated.items()) == list(want._generated.items())
    assert got._orig_of == want._orig_of
    assert got._discovery_fps == want._discovery_fps


@pytest.mark.slow
def test_paxos3_staged_pin_is_the_jax_packages():
    """The pin ``chip_smoke.py`` holds the card's staged BASELINE run
    to: the JAX package's staged engine on the CPU at the port's default
    sizes (``kraw``/``kmax`` set: its size memo could move them), bounded
    at ``PAXOS3_TARGET`` (~30 s)."""
    import hashlib
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke
    from stateright_tpu_torch.checker.gpu import auto_fmax, candidate_sizes
    assert candidate_sizes(PackedPaxos(3), auto_fmax(PackedPaxos(3)),
                           {}) == (40960, 20480)
    base = dict(race=False, fused=False, mode="device", capacity=1 << 21,
                kraw=40960, kmax=20480)
    ck = JPaxos(3).checker().tpu_options(**base) \
        .target_state_count(chip_smoke.PAXOS3_TARGET).spawn_tpu().join()
    arr = np.array(sorted(ck.generated_fingerprints()), dtype=np.uint64)
    digest = hashlib.sha256(arr.astype("<u8").tobytes()).hexdigest()
    assert (ck.unique_state_count(), ck.state_count(),
            digest) == chip_smoke.PIN_PAXOS3_STAGED


@pytest.mark.parametrize("small", [dict(kraw=256, kmax=256),
                                   dict(kraw=4096, kmax=128),
                                   dict(kraw=512, kmax=64)],
                         ids=["kraw", "kmax", "both"])
def test_kovf_rebuilds_end_as_a_run_sized_right(small):
    """Buffers sized too small (the raw one, the post-dedup one, both)
    rebuild on kovf and end with the counts, states and
    verdicts of a run whose buffers never overflow (a full enumeration:
    nothing of an aborted iteration is committed)."""
    opts = dict(fmax=512, capacity=1 << 12, fused=False)
    right = _cpu(TwoPhaseSys(5), kraw=8192, kmax=8192, **opts)
    got = _cpu(TwoPhaseSys(5), **small, **opts)
    assert right.profile()["kovfs"] == 0 and got.profile()["kovfs"] >= 1
    assert got.unique_state_count() == right.unique_state_count() == 8832
    assert got.state_count() == right.state_count()
    assert got.generated_fingerprints() == right.generated_fingerprints()
    assert sorted(got.discoveries()) == sorted(right.discoveries())
