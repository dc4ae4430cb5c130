"""The port's ops (``stateright_tpu_torch.ops``) against the JAX package's,
on the same numpy inputs made from a seed. Everything is integer or bit
arithmetic, so the tolerance is exact equality throughout."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu import core as jcore  # noqa: E402
from stateright_tpu.checker import device_loop as jdl  # noqa: E402
from stateright_tpu.ops import expand as jexp  # noqa: E402
from stateright_tpu.ops import fused as jfused  # noqa: E402
from stateright_tpu.ops import hash_kernel as jhash  # noqa: E402
from stateright_tpu.ops import hashtable as jtab  # noqa: E402
from stateright_tpu_torch import core as tcore  # noqa: E402
from stateright_tpu_torch.checker import device_loop as tdl  # noqa: E402
from stateright_tpu_torch.ops import expand as texp  # noqa: E402
from stateright_tpu_torch.ops import fused as tfused  # noqa: E402
from stateright_tpu_torch.ops import hash_kernel as thash  # noqa: E402
from stateright_tpu_torch.ops import hashtable as ttab  # noqa: E402
from stateright_tpu_torch.ops.words import (  # noqa: E402
    from_numpy_u32, keys_from_numpy, keys_to_numpy, to_numpy_u32)

M32 = 0xFFFFFFFF


def _u32(rng, shape, hi=2**32):
    return rng.integers(0, hi, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _np(t):
    """A torch result (int32 bit patterns or int64 values) as uint32."""
    if t.dtype == torch.bool:
        return t.numpy()
    return to_numpy_u32(t)


# --- fingerprints -------------------------------------------------------

@pytest.mark.parametrize("width", [1, 4, 7, 33])
def test_fp64_matches_jax_and_host(width):
    from stateright_tpu.fingerprint import fp64_words
    rng = np.random.default_rng(width)
    words = _u32(rng, (64, width))
    jhi, jlo = (np.asarray(x) for x in jhash.fp64_device(jnp.asarray(words)))
    thi, tlo = thash.fp64_device(from_numpy_u32(words))
    np.testing.assert_array_equal(_np(thi), jhi)
    np.testing.assert_array_equal(_np(tlo), jlo)
    for r in range(words.shape[0]):
        assert (int(thi[r]) << 32) | int(tlo[r]) \
            == fp64_words(words[r].tolist())


def test_fp64_zero_remap(monkeypatch):
    # a (0, 0) digest is remapped to (0, 1) in both packages: force the
    # finalizer to return zeros so every row takes the remap
    monkeypatch.setattr(jhash, "_fmix32", lambda h: h * jnp.uint32(0))
    monkeypatch.setattr(thash, "_fmix32", lambda h: h * 0)
    words = np.arange(12, dtype=np.uint32).reshape(3, 4)
    jhi, jlo = jhash.fp64_device(jnp.asarray(words))
    thi, tlo = thash.fp64_device(from_numpy_u32(words))
    np.testing.assert_array_equal(_np(thi), np.asarray(jhi))
    np.testing.assert_array_equal(_np(tlo), np.asarray(jlo))
    assert (_np(thi) == 0).all() and (_np(tlo) == 1).all()


# --- in-batch pre-dedup -------------------------------------------------

def _pre_dedup_both(chi, clo, cvalid):
    want = np.asarray(jexp.pre_dedup(jnp.asarray(chi), jnp.asarray(clo),
                                     jnp.asarray(cvalid)))
    got = texp.pre_dedup(torch.from_numpy(chi.astype(np.int64)),
                         torch.from_numpy(clo.astype(np.int64)),
                         torch.from_numpy(cvalid)).numpy()
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("n", [8, 64, 257, 4000])
def test_pre_dedup_random(n):
    rng = np.random.default_rng(n)
    pick = rng.integers(0, max(n // 4, 1), n)  # heavy duplication
    chi, clo = _u32(rng, n)[pick], _u32(rng, n)[pick]
    _pre_dedup_both(chi, clo, rng.random(n) < 0.8)


def test_pre_dedup_engineered_arena_collisions():
    # distinct keys on ONE arena cell (all must survive) plus a true
    # duplicate group alone on another cell (the later lanes die)
    n = 16
    acells = 1 << max((2 * n - 1).bit_length(), 0)
    chi = np.zeros(n, np.uint32)
    clo = np.arange(n, dtype=np.uint32) * np.uint32(acells) + np.uint32(3)
    clo[12:] = np.uint32(7)
    keep = _pre_dedup_both(chi, clo, np.ones(n, bool))
    assert keep[:13].all() and not keep[13:].any()
    # all lanes on one cell, duplicates hiding behind a foreign winner
    clo2 = np.arange(n, dtype=np.uint32) * np.uint32(acells) + np.uint32(3)
    clo2[5:9] = clo2[4]
    _pre_dedup_both(chi, clo2, np.ones(n, bool))


# --- visited table ------------------------------------------------------

def _insert_both(capacity, hi, lo, valid, pre=None, max_rounds=4096):
    """Insert into equal tables (optionally pre-populated) in both
    packages; assert lane-exact ``inserted``, equal table halves,
    overflow and rounds. Returns the port's ``inserted``."""
    nb = capacity // 4
    khi = jnp.zeros((nb, 4), jnp.uint32)
    klo = jnp.zeros((nb, 4), jnp.uint32)
    if pre is not None:
        _, khi, klo, _ = jtab.table_insert(
            khi, klo, jnp.asarray(pre[0]), jnp.asarray(pre[1]),
            jnp.ones(len(pre[0]), bool))
    table = keys_from_numpy(np.asarray(khi), np.asarray(klo))
    jins, khi, klo, jovf, jrounds = jtab.table_insert(
        khi, klo, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid),
        max_rounds=max_rounds, with_rounds=True)
    tins, tovf, trounds = ttab.table_insert(
        table, from_numpy_u32(hi), from_numpy_u32(lo),
        torch.from_numpy(valid), max_rounds=max_rounds, with_rounds=True)
    np.testing.assert_array_equal(tins.numpy(), np.asarray(jins))
    th, tl = keys_to_numpy(table)
    np.testing.assert_array_equal(th, np.asarray(khi))
    np.testing.assert_array_equal(tl, np.asarray(klo))
    assert tovf == bool(jovf)
    assert trounds == int(jrounds)
    return tins.numpy()


@pytest.mark.parametrize("n,capacity", [(100, 256), (4096, 1 << 14),
                                        (6000, 1 << 14), (9472, 1 << 16)])
def test_table_insert_matches_jax(n, capacity):
    # n <= 4096 takes the single loop, n > 4096 the narrow-tail phases
    rng = np.random.default_rng(n)
    pool = n // 3 + 1
    pick = rng.integers(0, pool, n)  # in-batch duplicates
    hi, lo = _u32(rng, pool)[pick], _u32(rng, pool, 2**32 - 1)[pick] + 1
    pre = (_u32(rng, n // 4), _u32(rng, n // 4, 2**32 - 1) + 1)
    pre[0][:pool // 4] = hi[:pool // 4]  # some keys already present
    pre[1][:pool // 4] = lo[:pool // 4]
    ins = _insert_both(capacity, hi, lo, rng.random(n) < 0.9, pre=pre)
    keys = set(zip(hi[ins].tolist(), lo[ins].tolist()))
    assert len(keys) == int(ins.sum())  # one lane per fresh key


def test_table_insert_near_full_and_overflow():
    rng = np.random.default_rng(3)
    hi, lo = _u32(rng, 60), _u32(rng, 60, 2**32 - 1) + 1
    assert _insert_both(64, hi, lo, np.ones(60, bool)).sum() == 60
    hi, lo = _u32(rng, 32), _u32(rng, 32, 2**32 - 1) + 1
    _insert_both(16, hi, lo, np.ones(32, bool), max_rounds=64)


@pytest.mark.parametrize("n", [64, 5000])
def test_table_insert_forced_claim_race(n):
    # every lane starts at bucket 0 (hi = 0, lo a multiple of the bucket
    # count): distinct keys race for the same first-empty slot round
    # after round, and same-key lanes race for one claim
    capacity = 1 << 16
    nb = capacity // 4
    rng = np.random.default_rng(n)
    distinct = (rng.choice(1 << 15, size=n // 8, replace=False)
                .astype(np.uint32) + 1) * np.uint32(nb)
    lo = distinct[rng.integers(0, len(distinct), n)]
    hi = np.zeros(n, np.uint32)
    ins = _insert_both(capacity, hi, lo, np.ones(n, bool))
    assert set(lo[ins].tolist()) == set(lo.tolist())


def test_plan_insert_host_matches_jax():
    rng = np.random.default_rng(11)
    fps = [int(x) for x in rng.integers(1, 2**63, 200)] + [5, 5]
    np.testing.assert_array_equal(ttab.plan_insert_host(fps, 256),
                                  jtab.plan_insert_host(fps, 256))


# --- cross-chunk ring ---------------------------------------------------

@pytest.mark.parametrize("cc", [64, 1 << 15])
def test_cc_ring_matches_jax(cc):
    rng = np.random.default_rng(cc)
    n = 3000
    pick = rng.integers(0, 500, n)
    chi, clo = _u32(rng, 500)[pick], _u32(rng, 500, 2**32 - 1)[pick] + 1
    mask = rng.random(n) < 0.5
    np.testing.assert_array_equal(
        _np(tfused._cc_slot(from_numpy_u32(chi), from_numpy_u32(clo), cc)),
        np.asarray(jfused._cc_slot(jnp.asarray(chi), jnp.asarray(clo), cc)))
    rhi, rlo = _u32(rng, cc), _u32(rng, cc)
    jh, jl = jfused.cc_ring_update(jnp.asarray(rhi), jnp.asarray(rlo),
                                   jnp.asarray(chi), jnp.asarray(clo),
                                   jnp.asarray(mask), cc)
    ring = keys_from_numpy(rhi, rlo)
    tfused.cc_ring_update(ring, from_numpy_u32(chi), from_numpy_u32(clo),
                          torch.from_numpy(mask))
    th, tl = keys_to_numpy(ring)
    np.testing.assert_array_equal(th, np.asarray(jh))
    np.testing.assert_array_equal(tl, np.asarray(jl))


# --- compaction, candidates, discoveries --------------------------------

@pytest.mark.parametrize("n,k", [(100, 128), (1000, 300), (37 * 64, 2368)])
def test_shrink_indices_matches_jax(n, k):
    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.4
    np.testing.assert_array_equal(
        tdl.shrink_indices(torch.from_numpy(mask), k).numpy(),
        np.asarray(jdl.shrink_indices(jnp.asarray(mask), k)))


def test_assemble_candidates_matches_jax():
    rng = np.random.default_rng(5)
    n, w = 50, 4
    rows = _u32(rng, (n, w))
    cols = [_u32(rng, n) for _ in range(5)]
    jc, joff = jexp.assemble_candidates(
        jnp.asarray(rows), *(jnp.asarray(c) for c in cols),
        None, None, w, False, False)
    tc, toff = texp.assemble_candidates(
        from_numpy_u32(rows), *(from_numpy_u32(c) for c in cols))
    assert toff == joff
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))


def _props(core):
    return [core.Property.always("a", lambda m, s: True),
            core.Property.sometimes("s", lambda m, s: True),
            core.Property.eventually("e", lambda m, s: True),
            core.Property.sometimes("s2", lambda m, s: True)]


def test_discovery_candidates_matches_jax():
    rng = np.random.default_rng(9)
    f, p = 40, 4
    pbits = rng.random((f, p)) < 0.3
    pbits[:, 0] = rng.random(f) < 0.97  # ALWAYS mostly holds
    ebits = rng.integers(0, 16, f).astype(np.uint32)
    terminal = rng.random(f) < 0.2
    fvalid = rng.random(f) < 0.8
    phi, plo = _u32(rng, f), _u32(rng, f)
    jx = jexp.Expansion(
        pbits=jnp.asarray(pbits), ebits=jnp.asarray(ebits), flat=None,
        avalid=None, cvalid=None, chi=None, clo=None, ohi=None, olo=None,
        phi=jnp.asarray(phi), plo=jnp.asarray(plo),
        terminal=jnp.asarray(terminal), xovf=None)
    tx = texp.Expansion(
        pbits=torch.from_numpy(pbits),
        ebits=torch.from_numpy(ebits.astype(np.int64)), flat=None,
        avalid=None, cvalid=None, chi=None, clo=None,
        phi=torch.from_numpy(phi.astype(np.int64)),
        plo=torch.from_numpy(plo.astype(np.int64)),
        terminal=torch.from_numpy(terminal), xovf=None)
    want = jexp.discovery_candidates(_props(jcore), jx, jnp.asarray(fvalid))
    got = texp.discovery_candidates(_props(tcore), tx,
                                    torch.from_numpy(fvalid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_small_step_sizes_match_jax():
    assert texp.FMAX_SMALL == jexp.FMAX_SMALL
    for fmax in (16, 256, 512, 12288):
        for kmax in (fmax * 37, 4096, 16):
            assert texp.small_step_sizes(fmax, kmax, 37) \
                == jexp.small_step_sizes(fmax, kmax, 37)
    assert texp.eventually_indices(_props(tcore)) \
        == jexp.eventually_indices(_props(jcore))
