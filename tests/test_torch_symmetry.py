"""Symmetry reduction in the port (``symmetry_fn`` on ``spawn_gpu()``)
against the JAX package on the CPU: the representatives, the symmetric
expansion, the symmetric fused step (plain version against the Pallas
kernel in interpret mode), and the engine by the row gate (2pc n=4, the
reference representative) and the set gate (2pc n=5, both
representatives). Everything is integer or bit arithmetic, so the
tolerance is exact equality throughout."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.checker import device_loop as jdl  # noqa: E402
from stateright_tpu.models import twopc as jtwopc  # noqa: E402
from stateright_tpu.ops import expand as jexp  # noqa: E402
from stateright_tpu.ops.fused import build_fused_block_fn  # noqa: E402
from stateright_tpu.ops.hashtable import plan_insert_host  # noqa: E402
from stateright_tpu_torch import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.checker.device_loop import (  # noqa: E402
    carry_from_numpy)
from stateright_tpu_torch.ops import expand as texp  # noqa: E402
from stateright_tpu_torch.ops.fused import (  # noqa: E402
    S_CCH, S_DEDUP, S_DISC, S_INSERTED, S_OVF, S_ROUNDS, S_VALID, S_XOVF,
    fused_step)
from stateright_tpu_torch.ops.words import (  # noqa: E402
    from_numpy_u32, keys_to_numpy, to_numpy_u32)

JaxTwoPhaseSys = jtwopc.TwoPhaseSys
MODES = [False, True]
MODE_IDS = ["reference", "complete"]


def _reachable(model):
    seen, order, queue = set(), [], list(model.init_states())
    while queue:
        state = queue.pop()
        fp = model.fingerprint(state)
        if fp not in seen:
            seen.add(fp)
            order.append(state)
            queue.extend(model.next_states(state))
    return order


@pytest.fixture(scope="module")
def states5():
    states = _reachable(TwoPhaseSys(5))
    assert len(states) == 8832
    return states


def _np(t):
    return t.numpy() if t.dtype == torch.bool else to_numpy_u32(t)


# --- (a) the representatives -----------------------------------------------

@pytest.mark.parametrize("complete", MODES, ids=MODE_IDS)
def test_packed_representative_matches_jax_on_all_2pc5_states(states5,
                                                              complete):
    jm = JaxTwoPhaseSys(5, complete_symmetry=complete)
    tm = TwoPhaseSys(5, complete_symmetry=complete)
    rows = np.stack([tm.encode(s) for s in states5])
    want = np.asarray(jax.jit(jax.vmap(jm.packed_representative))(
        jnp.asarray(rows)))
    got = tm.packed_representative(from_numpy_u32(rows))
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    # the host representative: encode(representative(s)) is the packed
    # one, and it is the JAX package's host representative
    host = np.stack([tm.encode(tm.representative(s)) for s in states5])
    np.testing.assert_array_equal(host, want)
    assert all(tm.representative(s) == jm.representative(s)
               for s in states5[::7])


def test_orbit_counts_of_2pc5(states5):
    # the complete representative is orbit-invariant: 314 classes; the
    # reference one keys 1,092 distinct representatives (NOTES.md)
    for complete, count in ((True, 314), (False, 1092)):
        tm = TwoPhaseSys(5, complete_symmetry=complete)
        assert len({tm.fingerprint(tm.representative(s))
                    for s in states5}) == count


def test_cache_key_and_kernel_spec_name_the_mode():
    assert TwoPhaseSys(4).cache_key() != TwoPhaseSys(4, True).cache_key()
    assert TwoPhaseSys(7).cuda_spec() == ("twopc", (7,))
    assert TwoPhaseSys(7).cuda_spec(symmetry=True) == ("twopc", (7, 0))
    assert TwoPhaseSys(16, complete_symmetry=True).cuda_spec(True) \
        == ("twopc", (16, 1))


# --- (b) the symmetric expansion --------------------------------------------

@pytest.mark.parametrize("complete", MODES, ids=MODE_IDS)
def test_expand_frontier_symmetry_matches_jax(states5, complete):
    jm = JaxTwoPhaseSys(5, complete_symmetry=complete)
    tm = TwoPhaseSys(5, complete_symmetry=complete)
    rng = np.random.default_rng(5 + complete)
    rows = np.stack([tm.encode(states5[i])
                     for i in rng.integers(0, len(states5), 64)])
    fvalid = rng.random(64) < 0.9
    ebits = np.zeros(64, np.uint32)
    want = jexp.expand_frontier(jm, jnp.asarray(rows), jnp.asarray(fvalid),
                                jnp.asarray(ebits), [], symmetry=True)
    got = texp.expand_frontier(tm, from_numpy_u32(rows),
                               torch.from_numpy(fvalid),
                               from_numpy_u32(ebits), [], symmetry=True)
    for name in ("pbits", "ebits", "flat", "cvalid", "chi", "clo", "ohi",
                 "olo", "phi", "plo", "terminal"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    # canonical keys differ from the original ones where a child is not
    # its own representative
    assert not torch.equal(got.chi, got.ohi)


def test_assemble_candidates_with_original_fps_matches_jax():
    rng = np.random.default_rng(6)
    n, w = 50, 4
    rows = rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    cols = [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
            for _ in range(7)]
    jc, joff = jexp.assemble_candidates(
        jnp.asarray(rows), *(jnp.asarray(c) for c in cols), w, True, False)
    tc, toff = texp.assemble_candidates(
        from_numpy_u32(rows), *(from_numpy_u32(c) for c in cols))
    assert toff == joff and tc.shape == (n, w + 7)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))


# --- (c) the symmetric fused step --------------------------------------------

CAPACITY = 1 << 14
QCAP = 1 << 15
CC = 1 << 10


@pytest.fixture(scope="module")
def mid4():
    """A JAX fused-engine state of 2pc n=4 under the reference
    representative after 6 loop iterations of 16 rows."""
    model = JaxTwoPhaseSys(4)
    init = model.init_states()[0]
    fp = model.fingerprint(model.representative(init))
    carry = jdl.seed_carry(
        model, QCAP, CAPACITY, [model.encode(init)], np.uint32(0),
        steps=6, symmetry=True, init_fps=[fp],
        table_plan=(plan_insert_host([fp], CAPACITY), [fp]))
    chunk = jdl.build_chunk_fn(model, QCAP, CAPACITY, 16, 16 * 22,
                               symmetry=True, fused=True,
                               fused_interpret=True, cc=CC)
    carry, rhi, rlo, _stats = chunk(
        carry, jnp.zeros((CC,), jnp.uint32), jnp.zeros((CC,), jnp.uint32),
        np.int32(2**31 - 1), np.int32(2000), np.int32(0))
    carry = jax.device_get(carry)
    assert np.asarray(carry.log).shape[1] == 6
    assert int(carry.q_tail) > int(carry.q_head) > 1  # mid-search
    return carry, np.asarray(rhi), np.asarray(rlo)


@pytest.mark.parametrize("probe", [True, False], ids=["probe", "noprobe"])
def test_symmetric_fused_step_matches_pallas_kernel(mid4, probe):
    carry, rhi, rlo = mid4
    jm, tm = JaxTwoPhaseSys(4), TwoPhaseSys(4)
    width, f = tm.packed_width, 64
    q = np.asarray(carry.q)
    rng = np.random.default_rng(probe)
    start = max(0, int(carry.q_head) - f // 2)
    rows = q[start:start + f]
    fvalid = (rng.random(f) < 0.9) \
        & (start + np.arange(f) < int(carry.q_tail))
    fn = build_fused_block_fn(jm, f, CAPACITY if probe else 0,
                              symmetry=True, probe=probe, interpret=True,
                              props=True, cc=CC)
    kw = dict(pfp=(jnp.asarray(rows[:, width + 1]),
                   jnp.asarray(rows[:, width + 2])),
              ring=(jnp.asarray(rhi), jnp.asarray(rlo)))
    if probe:
        kw.update(key_hi=jnp.asarray(carry.key_hi),
                  key_lo=jnp.asarray(carry.key_lo))
    want = fn(jnp.asarray(rows[:, :width]), jnp.asarray(rows[:, width]),
              jnp.asarray(fvalid), **kw)
    port = carry_from_numpy(carry, rhi, rlo)
    assert port.symmetry and port.log.shape[1] == 6
    block = from_numpy_u32(rows)
    got = fused_step(tm, block[:, :width], block[:, width],
                     torch.from_numpy(fvalid), block[:, width + 1],
                     block[:, width + 2], port.table, port.ring,
                     probe=probe, symmetry=True)
    for name in ("pbits", "ebits", "terminal", "flat", "chi", "clo", "ohi",
                 "olo", "cvalid", "dvalid", "inserted"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert not np.array_equal(_np(got.chi), _np(got.ohi))
    if probe:
        th, tl = keys_to_numpy(port.table)
        np.testing.assert_array_equal(th, np.asarray(want.key_hi))
        np.testing.assert_array_equal(tl, np.asarray(want.key_lo))
        rh, rl = keys_to_numpy(port.ring)
        np.testing.assert_array_equal(rh, np.asarray(want.ring_hi))
        np.testing.assert_array_equal(rl, np.asarray(want.ring_lo))
    st = to_numpy_u32(got.stats)
    assert [bool(st[S_XOVF]), bool(st[S_OVF]), int(st[S_ROUNDS]),
            int(st[S_CCH])] == [bool(want.xovf), bool(want.ovf),
                                int(want.rounds), int(want.cch)]
    assert (st[S_VALID], st[S_DEDUP], st[S_INSERTED]) == (
        np.asarray(want.cvalid).sum(), np.asarray(want.dvalid).sum(),
        np.asarray(want.inserted).sum())
    p = len(tm.properties())
    for i, name in enumerate(("disc_hit", "disc_hi", "disc_lo")):
        np.testing.assert_array_equal(
            st[S_DISC + i * p:S_DISC + (i + 1) * p],
            np.asarray(getattr(want, name)), err_msg=name)
    assert int(np.asarray(want.dvalid).sum()) > 0


# --- (d) the engine's row gate -----------------------------------------------

ROW_KNOBS = dict(fmax=16, capacity=1 << 12, cc_dedup=64, chunk_steps=8)


def _jax_sym(n, complete, **opts):
    m = JaxTwoPhaseSys(n, complete_symmetry=complete)
    ck = m.checker().symmetry_fn(m.representative).tpu_options(
        race=False, fused=True, mode="device", **opts).spawn_tpu().join()
    ck._ensure_mirror()
    return ck


def _port_sym(n, complete, **opts):
    m = TwoPhaseSys(n, complete_symmetry=complete)
    ck = m.checker().symmetry_fn(m.representative).gpu_options(
        device="cpu", **opts).spawn_gpu().join()
    ck._ensure_mirror()
    return ck


def test_row_gate_against_jax_fused_engine_under_symmetry():
    # every shape knob set on both sides; the reference representative,
    # whose count depends on the order the search takes
    want = _jax_sym(4, False, **ROW_KNOBS)
    got = _port_sym(4, False, **ROW_KNOBS)
    assert got.unique_state_count() == want.unique_state_count()
    assert got.state_count() == want.state_count()
    # the 6-column log, mirrored: canonical child -> canonical parent, and
    # canonical child -> original child, row for row
    assert list(got._generated.items()) == list(want._generated.items())
    assert list(got._orig_of.items()) == list(want._orig_of.items())
    assert got._discovery_fps == want._discovery_fps
    assert got.generated_fingerprints() == want.generated_fingerprints()
    assert len(got._orig_of) == got.unique_state_count()


# --- (e) the set gate -------------------------------------------------------

SET_KNOBS = dict(fmax=64, capacity=1 << 12, cc_dedup=1 << 10,
                 chunk_steps=16)


def _replays(ck):
    model = ck.model()
    for name in ("abort agreement", "commit agreement"):
        path = ck.discovery(name)  # replays through the host model
        assert model.property(name).condition(model, path.last_state())
    ck.assert_properties()


def test_complete_symmetry_set_gate_2pc5():
    want = _jax_sym(5, True, **SET_KNOBS)
    got = _port_sym(5, True, **SET_KNOBS)
    assert got.unique_state_count() == want.unique_state_count() == 314
    assert got.state_count() == want.state_count() == 2048
    assert got.generated_fingerprints() == want.generated_fingerprints()
    _replays(got)


def test_reference_symmetry_covers_every_orbit_2pc5(states5):
    want = _jax_sym(5, False, **SET_KNOBS)
    got = _port_sym(5, False, **SET_KNOBS)
    n = got.unique_state_count()
    assert n == want.unique_state_count()
    assert 314 <= n <= 1092
    # soundness: the canonical keys reached cover every reachable orbit
    ref, full = TwoPhaseSys(5), TwoPhaseSys(5, complete_symmetry=True)
    orbit_of_key = {ref.fingerprint(ref.representative(s)):
                    full.fingerprint(full.representative(s))
                    for s in states5}
    assert len(set(orbit_of_key.values())) == 314
    assert {orbit_of_key[k] for k in got.generated_fingerprints()} \
        == set(orbit_of_key.values())
    # the original states the log records are reachable states whose
    # representative is their canonical key
    by_fp = {ref.fingerprint(s): s for s in states5}
    for key, orig in got._orig_of.items():
        assert ref.fingerprint(ref.representative(by_fp[orig])) == key
    _replays(got)


# --- (f) guards -------------------------------------------------------------

class _NoCanon(TwoPhaseSys):
    packed_representative = None


class _OwnRepresentative(TwoPhaseSys):
    def representative(self, state):
        return super().representative(state)


class _OwnPackedRepresentative(TwoPhaseSys):
    def packed_representative(self, words):
        return super().packed_representative(words)


def test_symmetry_needs_packed_representative():
    m = _NoCanon(3)
    with pytest.raises(NotImplementedError, match="packed_repr"):
        m.checker().symmetry_fn(m.representative).gpu_options(
            device="cpu").spawn_gpu()


def test_disagreeing_symmetry_fn_raises():
    def wrong(state):  # not 2pc's representative: changes the TM state
        return (state[0], 1, state[2], state[3])

    ck = TwoPhaseSys(3).checker().symmetry_fn(wrong).gpu_options(
        device="cpu").spawn_gpu()
    with pytest.raises(ValueError, match="packed_representative"):
        ck.join()


@pytest.mark.parametrize("cls", [_OwnRepresentative,
                                 _OwnPackedRepresentative],
                         ids=["representative", "packed_representative"])
def test_card_refuses_a_representative_its_kernel_does_not_run(
        cls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    m = cls(3)
    assert m.cuda_spec() == ("twopc", (3,))  # no symmetry: accepted
    with pytest.raises(NotImplementedError, match="CUDA step kernel"):
        m.cuda_spec(symmetry=True)
    with pytest.raises(NotImplementedError, match="CUDA step kernel"):
        m.checker().symmetry_fn(m.representative).spawn_gpu()


def test_symmetric_wrapper_never_runs_the_plain_version_for_cuda(
        monkeypatch):
    from stateright_tpu_torch.ops import _cuda, fused
    calls = []

    class _CudaLike:
        is_cuda = True
        device = "cuda"
        shape = (0, 4)

        def numel(self):
            return 0

    def plain(*args, **kwargs):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(fused, "fused_step_reference", plain)
    monkeypatch.setattr(fused, "StepWorkspace", lambda *a: "ws")
    monkeypatch.setattr(fused, "DedupWorkspace", lambda *a: "ws")
    monkeypatch.setattr(_cuda, "fused_step",
                        lambda *a: calls.append(("step", a[-1]))
                        or (None,) * 12)
    monkeypatch.setattr(_cuda, "fused_step_noprobe",
                        lambda *a: calls.append(("noprobe", a[-1]))
                        or (None,) * 12)
    m = TwoPhaseSys(3)
    fused.fused_step(m, _CudaLike(), None, None, None, None, _CudaLike(),
                     symmetry=True)
    fused.fused_step(m, _CudaLike(), None, None, None, None, None,
                     probe=False, symmetry=True)
    assert calls == [("step", True), ("noprobe", True)]


# --- the pins chip_smoke.py holds the card to ------------------------------

class _JaxTwoPhaseSys16(JaxTwoPhaseSys):
    """The JAX package's TwoPhaseSys with its property patterns as uint32
    constants: at n=16 the patterns (0xFFFFFFFF, 0xAAAAAAAA) are Python
    ints past int32, which JAX's scalar parsing refuses on the CPU."""

    def packed_properties(self, words):
        rmw = words[0]
        idx = jnp.arange(self.n, dtype=jnp.uint32)
        fields = (rmw >> (2 * idx)) & 3
        aborted = sum(3 << (2 * i) for i in range(self.n))
        committed = sum(2 << (2 * i) for i in range(self.n))
        return jnp.stack([
            rmw == jnp.uint32(aborted), rmw == jnp.uint32(committed),
            ~((fields == 3).any() & (fields == 2).any())])


@pytest.mark.parametrize("n", [7, 16], ids=["n7", "n16"])
def test_complete_symmetry_pins(n):
    """The orbit counts, state counts and canonical-key digests
    chip_smoke.py pins, from the JAX package's fused device engine and
    the port's plain path (256-row steps: the complete representative
    makes the answer independent of the step size)."""
    import hashlib
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    def digest(fps):
        arr = np.array(sorted(fps), dtype=np.uint64)
        return hashlib.sha256(arr.astype("<u8").tobytes()).hexdigest()

    want = {7: (chip_smoke.UNIQUE_2PC7_SYM, chip_smoke.GENERATED_2PC7_SYM,
                chip_smoke.DIGEST_2PC7_SYM),
            16: (chip_smoke.UNIQUE_2PC16_SYM,
                 chip_smoke.GENERATED_2PC16_SYM,
                 chip_smoke.DIGEST_2PC16_SYM)}[n]
    knobs = dict(fmax=256, capacity=1 << 18, cc_dedup=1 << 15)
    jm = (_JaxTwoPhaseSys16 if n == 16 else JaxTwoPhaseSys)(
        n, complete_symmetry=True)
    ref = jm.checker().symmetry_fn(jm.representative).tpu_options(
        race=False, fused=True, mode="device", chunk_steps=64,
        **knobs).spawn_tpu().join()
    got = _port_sym(n, True, **knobs)
    for ck in (ref, got):
        assert (ck.unique_state_count(), ck.state_count(),
                digest(ck.generated_fingerprints())) == want
    assert got._discovery_fps == ref._discovery_fps
    _replays(got)


def test_growth_under_symmetry():
    # 4-row steps keep a 2**8-slot table, which grows while the 6-column
    # log is re-inserted; the orbits and witnesses stay
    grown = _port_sym(5, True, capacity=1 << 8, fmax=4)
    flat = _port_sym(5, True, capacity=1 << 14, fmax=4)
    assert grown.profile()["grows"] >= 1
    assert flat.profile()["grows"] == 0
    assert grown.unique_state_count() == flat.unique_state_count() == 314
    assert grown.state_count() == flat.state_count()
    assert grown.generated_fingerprints() == flat.generated_fingerprints()
    assert grown._orig_of == flat._orig_of
    _replays(grown)
