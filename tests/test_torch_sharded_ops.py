"""The sharded engine's pieces against the JAX package's, on the CPU: the
probe-free step's plain version against the Pallas step kernel with
``probe=False`` (interpret mode), the owner-side probe's plain version
against ``build_probe_block_fn``, the owner and bucket helpers against
``owner_of`` and the JAX bucket scatter, and the size policies. Every
comparison is exact: the arithmetic is integer and bitwise."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.checker import tpu as jtpu  # noqa: E402
from stateright_tpu.models import twopc as jtwopc  # noqa: E402
from stateright_tpu.ops import expand as jexp  # noqa: E402
from stateright_tpu.ops.fused import (build_fused_block_fn,  # noqa: E402
                                      build_probe_block_fn)
from stateright_tpu.parallel import sharded as jsh  # noqa: E402
from stateright_tpu_torch.checker.device_loop import (  # noqa: E402
    LoopStats, run_loop, seed_carry)
from stateright_tpu_torch.checker.gpu import candidate_sizes  # noqa: E402
from stateright_tpu_torch.models.twopc import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.ops import expand as texp  # noqa: E402
from stateright_tpu_torch.ops.fused import (  # noqa: E402
    S_CCH, S_DEDUP, S_DISC, S_INSERTED, S_OVF, S_ROUNDS, S_VALID, S_XOVF,
    fused_step, probe_block, probe_block_reference)
from stateright_tpu_torch.ops.hashtable import (  # noqa: E402
    table_insert_reference)
from stateright_tpu_torch.ops.words import (  # noqa: E402
    from_numpy_u32, keys_from_numpy, keys_to_numpy, to_numpy_u32)
from stateright_tpu_torch.parallel import sharded as tsh  # noqa: E402

JaxTwoPhaseSys = jtwopc.TwoPhaseSys


# --- the probe-free step ---------------------------------------------------

def _mid_search(n: int):
    """The queue rows of a port CPU run a few steps in (packed row,
    eventually-bits, cached fingerprint): frontier rows whose children
    are partly known."""
    model = TwoPhaseSys(n)
    init = model.init_states()[0]
    fp = model.fingerprint(init)
    carry = seed_carry(model, 1 << 13, 1 << 13, [model.encode(init)], 0,
                       [fp], 64, "cpu")
    table_insert_reference(
        carry.table, torch.tensor([fp >> 32]), torch.tensor([fp & 0xFFFFFFFF]),
        torch.ones((1,), dtype=torch.bool))
    run_loop(model, carry, fmax=16, grow_limit=1 << 12,
             target_remaining=2**31, stats=LoopStats(), steps=8)
    return to_numpy_u32(carry.q[:carry.q_tail])


NOPROBE = [(n, f, cc) for n in (3, 4) for f in (16, 64) for cc in (0, 64)]


@pytest.mark.parametrize("n,f,cc", NOPROBE,
                         ids=[f"n{n}-f{f}-cc{cc}" for n, f, cc in NOPROBE])
def test_noprobe_step_matches_pallas_kernel(n, f, cc):
    rows_all = _mid_search(n)
    jm, tm = JaxTwoPhaseSys(n), TwoPhaseSys(n)
    width = tm.packed_width
    rng = np.random.default_rng(100 * n + f + cc)
    rows = rows_all[rng.integers(0, rows_all.shape[0], size=f)]
    fvalid = rng.random(f) < 0.9
    # a ring holding the fingerprints of some of the queue's states, so
    # children of the frontier hit it
    ring_keys = np.zeros((max(cc, 1),), np.uint64)
    if cc:
        fps = (rows_all[:, width + 1].astype(np.uint64) << np.uint64(32)) \
            | rows_all[:, width + 2]
        pick = fps[rng.random(fps.shape[0]) < 0.5]
        slot = (pick.astype(np.uint32)
                ^ ((pick >> np.uint64(32)).astype(np.uint32)
                   * np.uint32(0x9E3779B9))) & np.uint32(cc - 1)
        ring_keys[slot] = pick
    rhi = (ring_keys >> np.uint64(32)).astype(np.uint32)[:cc]
    rlo = ring_keys.astype(np.uint32)[:cc]
    fn = build_fused_block_fn(jm, f, 0, probe=False, interpret=True,
                              props=True, cc=cc)
    want = fn(jnp.asarray(rows[:, :width]), jnp.asarray(rows[:, width]),
              jnp.asarray(fvalid),
              pfp=(jnp.asarray(rows[:, width + 1]),
                   jnp.asarray(rows[:, width + 2])),
              ring=(jnp.asarray(rhi), jnp.asarray(rlo)) if cc else None)
    block = from_numpy_u32(rows)
    ring = keys_from_numpy(rhi, rlo) if cc else None
    ring0 = None if ring is None else ring.clone()
    got = fused_step(tm, block[:, :width], block[:, width],
                     torch.from_numpy(fvalid), block[:, width + 1],
                     block[:, width + 2], None, ring, probe=False)
    for name in ("pbits", "ebits", "terminal", "flat", "chi", "clo",
                 "cvalid", "dvalid", "inserted"):
        g = getattr(got, name)
        g = g.numpy() if g.dtype == torch.bool else to_numpy_u32(g)
        np.testing.assert_array_equal(g, np.asarray(getattr(want, name)),
                                      err_msg=name)
    st = to_numpy_u32(got.stats)
    assert [bool(st[S_XOVF]), bool(st[S_OVF]), int(st[S_ROUNDS]),
            int(st[S_CCH])] == [bool(want.xovf), bool(want.ovf),
                                int(want.rounds), int(want.cch)]
    dv = np.asarray(want.dvalid)
    assert (st[S_VALID], st[S_DEDUP], st[S_INSERTED]) == (
        np.asarray(want.cvalid).sum(), dv.sum(), dv.sum())
    p = len(tm.properties())
    np.testing.assert_array_equal(st[S_DISC:S_DISC + p],
                                  np.asarray(want.disc_hit))
    np.testing.assert_array_equal(st[S_DISC + p:S_DISC + 2 * p],
                                  np.asarray(want.disc_hi))
    np.testing.assert_array_equal(st[S_DISC + 2 * p:],
                                  np.asarray(want.disc_lo))
    if cc:
        assert torch.equal(ring, ring0)  # read only
        assert int(want.cch) > 0 or f == 16
    assert dv.sum() > 0


# --- the owner-side probe --------------------------------------------------

def _keys(rng, n):
    k = rng.integers(1, 2**64 - 1, size=n, dtype=np.uint64)
    return (k >> np.uint64(32)).astype(np.uint32), k.astype(np.uint32)


def _probe_case(name):
    """(table hi/lo halves, lane hi/lo, valid) for one case."""
    rng = np.random.default_rng(len(name))
    if name == "duplicates":
        cap, n, pre = 256, 64, 40
    elif name == "nearly_full":
        cap, n, pre = 256, 32, 200
    elif name == "overflow":
        cap, n, pre = 16, 8, 16
    else:  # "narrow_tail": over 4096 lanes, the phased probe
        cap, n, pre = 1 << 14, 5000, 3000
    t = torch.zeros((cap // 4, 4), dtype=torch.int64)
    ph, pl = _keys(rng, pre)
    table_insert_reference(t, from_numpy_u32(ph), from_numpy_u32(pl),
                           torch.ones((pre,), dtype=torch.bool))
    hi, lo = _keys(rng, n)
    # duplicates of each other and of keys already in the table
    dup = rng.random(n) < 0.3
    src = rng.integers(0, n, size=n)
    hi = np.where(dup, hi[src], hi)
    lo = np.where(dup, lo[src], lo)
    old = rng.random(n) < 0.15
    osrc = rng.integers(0, pre, size=n)
    hi = np.where(old, ph[osrc], hi)
    lo = np.where(old, pl[osrc], lo)
    valid = rng.random(n) < 0.9
    th, tl = keys_to_numpy(t)
    return th, tl, hi, lo, valid


@pytest.mark.parametrize("name", ["duplicates", "nearly_full", "overflow",
                                  "narrow_tail"])
def test_probe_block_matches_pallas_kernel(name):
    th, tl, hi, lo, valid = _probe_case(name)
    fn = build_probe_block_fn(hi.shape[0], th.size, interpret=True)
    ins, khi, klo, ovf, rounds = fn(jnp.asarray(hi), jnp.asarray(lo),
                                    jnp.asarray(valid), jnp.asarray(th),
                                    jnp.asarray(tl))
    table = keys_from_numpy(th, tl)
    got_ins, got_ovf, got_rounds = probe_block(
        table, from_numpy_u32(hi), from_numpy_u32(lo),
        torch.from_numpy(valid))
    np.testing.assert_array_equal(got_ins.numpy(), np.asarray(ins))
    gh, gl = keys_to_numpy(table)
    np.testing.assert_array_equal(gh, np.asarray(khi))
    np.testing.assert_array_equal(gl, np.asarray(klo))
    assert bool(got_ovf) == bool(ovf)
    assert int(got_rounds) == int(rounds)
    assert bool(ovf) == (name == "overflow")
    assert np.asarray(ins).sum() > 0 or name == "overflow"


def test_probe_block_reference_is_the_plain_insert():
    th, tl, hi, lo, valid = _probe_case("duplicates")
    a, b = keys_from_numpy(th, tl), keys_from_numpy(th, tl)
    ins, ovf, rounds = probe_block_reference(
        a, from_numpy_u32(hi), from_numpy_u32(lo), torch.from_numpy(valid))
    ins2, ovf2, rounds2 = table_insert_reference(
        b, from_numpy_u32(hi), from_numpy_u32(lo), torch.from_numpy(valid),
        with_rounds=True)
    assert torch.equal(ins, ins2) and torch.equal(a, b)
    assert (bool(ovf), int(rounds)) == (ovf2, rounds2)
    assert ovf.shape == () and rounds.shape == ()


# --- owners, buckets, sizes ------------------------------------------------

def test_owner_helpers_match_jax():
    rng = np.random.default_rng(7)
    fps = rng.integers(0, 2**64 - 1, size=512, dtype=np.uint64)
    fps[:4] = [0, 2**63, 2**64 - 1, 2**32 - 1]
    for d in (1, 2, 4, 8, 256):
        kbits = tsh.owner_bits(d)
        assert kbits == jsh._owner_bits(d)
        want = [jsh.owner_of(int(fp), d) for fp in fps]
        assert [tsh.owner_of(int(fp), d) for fp in fps] == want
        # the tensor form on int32 bit patterns: a set sign bit must pick
        # a high rank, not a negative one
        hi = from_numpy_u32((fps >> np.uint64(32)).astype(np.uint32))
        got = tsh.owner_rank(hi, kbits).tolist()
        jhi = jnp.asarray((fps >> np.uint64(32)).astype(np.uint32))
        jown = np.asarray(jhi >> jnp.uint32(32 - kbits)) if kbits \
            else np.zeros(fps.shape, np.uint32)
        assert got == jown.tolist() == want
        for kmax in (16, 4096, 56832):
            for kb in (0, 16, 256):
                assert tsh.effective_kb(kmax, d, kb) \
                    == jsh.effective_kb(kmax, d, kb)
    for bad in (3, 6, 512):
        with pytest.raises(ValueError):
            tsh.owner_bits(bad)


@pytest.mark.parametrize("d,kb", [(2, 16), (4, 8), (8, 4)])
def test_bucket_send_matches_jax_scatter(d, kb):
    rng = np.random.default_rng(d)
    n, cols = 40, 7
    cand = rng.integers(0, 2**32, size=(n, cols), dtype=np.uint64) \
        .astype(np.uint32)
    owner = rng.integers(0, d, size=n)
    kvalid = rng.random(n) < 0.7
    # at most kb valid lanes per owner: the kovf gate guarantees it
    for o in range(d):
        idx = np.flatnonzero(kvalid & (owner == o))
        kvalid[idx[kb:]] = False
    got = tsh.bucket_send(from_numpy_u32(cand), torch.from_numpy(kvalid),
                          torch.from_numpy(owner).to(torch.int64), d, kb)
    # the JAX engine's scatter (stateright_tpu/parallel/sharded.py,
    # bucketed exchange), on the same lanes
    own_f = jnp.asarray(owner, jnp.int32)
    kv = jnp.asarray(kvalid)
    oh = ((own_f[:, None] == jnp.arange(d, dtype=jnp.int32)[None, :])
          & kv[:, None]).astype(jnp.int32)
    rank = jnp.take_along_axis(jnp.cumsum(oh, axis=0), own_f[:, None],
                               axis=1)[:, 0] - 1
    dst = jnp.where(kv, own_f * kb + rank, d * kb)
    payload = jnp.concatenate([jnp.asarray(cand),
                               jnp.ones((n, 1), jnp.uint32)], axis=1)
    want = jnp.zeros((d * kb, cols + 1), jnp.uint32).at[dst].set(
        payload, mode="drop")
    np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(want))


def test_size_policies_match_jax():
    for n in (3, 4, 7):
        jm, tm = JaxTwoPhaseSys(n), TwoPhaseSys(n)
        for fmax in (16, 64, 512, 12288):
            assert texp.kmax_default(tm, fmax) \
                == jexp.kmax_default(jm, fmax, False)
            assert texp.kfinal_default(tm, fmax) \
                == jexp.kfinal_default(jm, fmax, False)
            for opts in ({}, {"kmax": 16}, {"kraw": 1000},
                         {"kraw": 64, "kmax": 4096}):
                assert candidate_sizes(tm, fmax, opts) \
                    == jtpu.candidate_sizes(jm, fmax, False, opts, None)


def test_step_sizes_clamp_like_the_jax_build():
    # (kraw, kmax) as the JAX build clamps them, per step size
    sizes = tsh.StepSizes(d=2, fmax=64, kraw=100, kmax=4096)
    assert sizes.steps(22) == ((64, 100), (64, 100), False)
    sizes = tsh.StepSizes(d=2, fmax=512, kraw=1 << 20, kmax=300)
    assert sizes.steps(22) == ((512, 300), (256, 300), True)
    assert sizes.headroom == 600 and sizes.kb_eff == 300
    assert tsh.StepSizes(d=1, fmax=512, kraw=9, kmax=9).kb_eff == 0


# --- no hidden fallback ----------------------------------------------------

class _CudaLike:
    """Stands in for a CUDA tensor: the wrappers dispatch on ``is_cuda``."""

    is_cuda = True
    device = "cuda"

    def __init__(self, *shape):
        self.shape = shape

    def numel(self):
        return 0


def test_sharded_wrappers_never_run_the_plain_version_for_cuda(monkeypatch):
    from stateright_tpu_torch.ops import _cuda, fused
    calls = []

    def plain(*args, **kwargs):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(fused, "fused_step_reference", plain)
    monkeypatch.setattr(fused, "probe_block_reference", plain)
    monkeypatch.setattr(fused, "DedupWorkspace", lambda *a: "ws")
    monkeypatch.setattr(fused, "StepWorkspace", lambda *a: "ws")
    monkeypatch.setattr(_cuda, "fused_step_noprobe",
                        lambda *a: calls.append("noprobe") or (None,) * 10)
    monkeypatch.setattr(_cuda, "probe_block",
                        lambda *a: calls.append("probe") or (None,) * 3)
    fused.fused_step(TwoPhaseSys(3), _CudaLike(64, 4), None, None, None,
                     None, None, _CudaLike(64), probe=False)
    fused.probe_block(_CudaLike(16, 4), None, None, None)
    assert calls == ["noprobe", "probe"]
