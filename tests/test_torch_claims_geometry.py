"""The claims lists of the step kernels, on the CPU: K2's list of the
table slots its tiles claimed with K3 walking it, and K5's claim and
commit over the probe-free step's key arena.

K2 (``csrc/fused_step.cu`` ``claim_kernel``) and K5's claim
(``csrc/sharded_step.cu`` ``dedup_claim_kernel``) append each table slot
(with its key's ring slot) or arena cell that one of their tile's lanes
claimed to the tile's own lane range of ``claims``, with a count per
tile; the commit kernels (K3, ``dedup_commit_kernel``) run one block per
tile over those lists only.
Here numpy transcriptions of both pairs, with the kernels' data
structures (owner words tagged by the step, the 4-slot bucket table, the
step-wide arena that its commits clear), are held to the lowest-lane rule
and to the plain versions' key sets, with an adversarial claimer: the
HIGHEST tile winner of each key takes its slot or cell, so a commit that
took the claimer's lane instead of the owner word's would be caught. The
transcriptions check the algorithm, not the kernels: ``chip_smoke.py``
and ``tests/test_torch_gpu.py`` hold those on the card. numpy and small
torch tensors only: no process, no JAX, well under a second each.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

from stateright_tpu_torch import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.ops.fused import fused_step_reference  # noqa: E402
from stateright_tpu_torch.ops.words import to_numpy_u32  # noqa: E402

from test_torch_step_geometry import (  # noqa: E402
    ACTIONS, L, M64, STEP_CASES, _geometry,
    _lowest_valid_lane_of_each_fresh_key, _mid_search, _slot,
    k2_k3_transcription)

ONES = np.uint64(0xFFFFFFFFFFFFFFFF)
CASE_IDS = [f"2pc{n}-{'plain' if c is None else ('complete' if c else 'ref')}"
            f"-f{f}" for n, c, f, _s in STEP_CASES]


def _tag(step: int) -> np.uint64:
    """The owner word's high half of ``step``: ``(~step) << 32``."""
    return np.uint64((~step & 0xFFFFFFFF) << 32)


def _owner_lane(word: np.uint64, step: int, lanes: int) -> int:
    """``owner_lane`` of ``csrc/step_common.cuh``: the word's lane when
    it carries ``step``'s tag, else a kernel fault."""
    lane = int(word & M64)
    assert word & ~M64 == _tag(step) and lane < lanes, "S_FAULT"
    return lane


def _tile_winners(keys, cvalid, tile):
    """The lowest valid lane of each (tile, key), in ascending order."""
    v = np.flatnonzero(cvalid)
    _u, first = np.unique(np.stack([tile[v], keys[v].view(np.int64)], 1),
                          axis=0, return_index=True)
    return np.sort(v[first])


def _probe_claim(table, key):
    """``probe_claim`` on a table of 4-slot buckets: the slot ``key`` ends
    in, and whether this call claimed it."""
    nb = table.shape[0] // 4
    g = int(_slot(np.array([key], np.uint64), nb)[0])
    while True:
        bucket = table[4 * g:4 * g + 4]
        hit = np.flatnonzero(bucket == key)
        if hit.size:
            return 4 * g + int(hit[0]), False
        empty = np.flatnonzero(bucket == 0)
        if empty.size:
            s = 4 * g + int(empty[0])
            table[s] = key
            return s, True
        g = (g + 1) % nb


def _append(claims, n_claims, tile_lanes, t, v):
    """A claim of tile ``t``, in its own lane range of ``claims``."""
    assert n_claims[t] < tile_lanes  # a tile claims at most its lanes
    claims[t * tile_lanes + n_claims[t]] = v
    n_claims[t] += 1


def k2_claims_k3(keys, cvalid, f, a, geo, table, owner, ring, step):
    """K2 with its claims list, then K3 over the lists, in numpy, the
    tile winners racing highest lane first. ``table`` (uint64 slots),
    ``owner`` and ``ring`` are updated in place. Returns ``(inserted,
    n_claims, claimers)``: the inserted mask, the claims per tile and,
    per inserted lane, the lane whose claim took its key's slot."""
    lanes = np.arange(f * a)
    tile_lanes = geo.rows * a
    tile = lanes // tile_lanes
    winners = _tile_winners(keys, cvalid, tile)
    cc = ring.shape[0]
    rslot = _slot(keys, cc) if cc else np.zeros(f * a, np.int64)
    if cc:
        winners = winners[ring[rslot[winners]] != keys[winners]]
    # K2: every lane gets inserted = 0; a claim is ring slot << 32 | slot
    inserted = np.zeros(f * a, bool)
    claims = np.full(f * a, -1, np.int64)
    n_claims = np.zeros(geo.blocks, np.int64)
    ring_arena = np.full(cc, ONES, np.uint64)
    claimer = {}
    for lane in winners[::-1]:
        s, claimed = _probe_claim(table, keys[lane])
        owner[s] = min(owner[s], _tag(step) | np.uint64(lane))
        if claimed:
            rs = int(rslot[lane])
            _append(claims, n_claims, tile_lanes, tile[lane], rs << 32 | s)
            claimer[s] = int(lane)
            if cc:
                ring_arena[rs] = min(ring_arena[rs], keys[lane])
    # K3: one block per tile, over its claims only
    claimers = {}
    for t in range(geo.blocks):
        for claim in claims[t * tile_lanes:t * tile_lanes + n_claims[t]]:
            s, rs = int(claim) & 0xFFFFFFFF, int(claim) >> 32
            lane = _owner_lane(owner[s], step, f * a)
            inserted[lane] = True
            claimers[lane] = claimer[s]
            if cc:
                ring[rs] = ring_arena[rs]
    return inserted, n_claims, claimers


def _seeded_table(table_keys, capacity, step):
    """A table holding ``table_keys``, their owner words from an earlier
    step (so the tag check meets stale words)."""
    table = np.zeros(capacity, np.uint64)
    owner = np.full(capacity, ONES, np.uint64)
    for i, key in enumerate(np.unique(table_keys)):
        s, _claimed = _probe_claim(table, key)
        owner[s] = _tag(step - 1) | np.uint64(i)
    return table, owner


def _check_claims(keys, cvalid, f, a, geo, table_keys, ring, plain_keys):
    step = 5
    table, owner = _seeded_table(table_keys, 1 << 16, step)
    ring_after = ring.copy()
    inserted, n_claims, claimers = k2_claims_k3(
        keys, cvalid, f, a, geo, table, owner, ring_after, step)
    ins = np.flatnonzero(inserted)
    _dv, want = k2_k3_transcription(keys, cvalid, f, a, geo, table_keys,
                                    ring)
    np.testing.assert_array_equal(inserted, want)
    np.testing.assert_array_equal(
        ins, _lowest_valid_lane_of_each_fresh_key(keys, cvalid, table_keys))
    assert set(keys[ins].tolist()) == plain_keys
    # one claim per inserted lane: S_INSERTED is the claims' count
    assert int(n_claims.sum()) == ins.shape[0]
    # the trap: a fresh key whose winners lie in two tiles was claimed by
    # its highest winner, not by the inserted lane
    tile = np.arange(f * a) // (geo.rows * a)
    winners = _tile_winners(keys, cvalid, tile)
    spread = sum(int(np.unique(tile[winners[keys[winners] == keys[lane]]])
                     .shape[0] > 1) for lane in ins)
    assert sum(claimers[lane] != lane for lane in ins) == spread
    # the ring: each slot a fresh key maps to holds its smallest one
    cc = ring.shape[0]
    if cc:
        fresh = keys[ins]
        slots = _slot(fresh, cc)
        for rs in np.unique(slots):
            assert ring_after[rs] == fresh[slots == rs].min()
        untouched = np.setdiff1d(np.arange(cc), slots)
        np.testing.assert_array_equal(ring_after[untouched], ring[untouched])
    return spread


def _pool_keys(rng, f, a):
    pool = rng.integers(1, 2**63, size=int(rng.integers(3, 60)),
                        dtype=np.int64).astype(np.uint64)
    keys = pool[rng.integers(0, pool.shape[0], f * a)]
    cvalid = rng.random(f * a) < 0.7
    return pool, keys, cvalid


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("a", ACTIONS)
def test_claims_on_duplicate_heavy_keys(a, seed):
    """Random keys from a small pool (most lanes share a key with lanes
    of other tiles), some already in the table, some in the ring; tiles
    of the default budget, of 64 lanes and of one row."""
    rng = np.random.default_rng(100 * a + seed)
    f = int(rng.integers(1, 48 if a > L else 400))
    pool, keys, cvalid = _pool_keys(rng, f, a)
    table_keys = pool[rng.random(pool.shape[0]) < 0.3]
    ring = np.zeros(64, np.uint64)
    held = table_keys[: table_keys.shape[0] // 2]
    ring[_slot(held, 64)] = held
    v = np.flatnonzero(cvalid)
    plain_keys = set(keys[v].tolist()) - set(table_keys.tolist())
    for budget, threads in ((L, 256), (64, 32), (1, 32)):
        geo = _geometry(f, a, sms=1, lanes=budget, threads=threads)
        _check_claims(keys, cvalid, f, a, geo, table_keys, ring,
                      plain_keys)


def _step_lanes(model, carry, start, width, symmetry):
    """The plain probe-free step over ``width`` queue rows from
    ``start`` (rows past the queue's tail invalid): its output and
    keys."""
    w = model.packed_width
    block = carry.q[start:start + width]
    assert block.shape[0] == width
    fvalid = start + torch.arange(width) < carry.q_tail
    out = fused_step_reference(model, block[:, :w], block[:, w], fvalid,
                               block[:, w + 1], block[:, w + 2], None,
                               carry.ring, probe=False, symmetry=symmetry)
    keys = ((to_numpy_u32(out.chi).astype(np.uint64) << np.uint64(32))
            | to_numpy_u32(out.clo).astype(np.uint64))
    return out, keys


@pytest.mark.parametrize("n,complete,fmax,steps", STEP_CASES, ids=CASE_IDS)
def test_claims_on_real_step_lanes(n, complete, fmax, steps):
    """The lanes of a real mid-search step (2pc4/2pc5, with and without
    symmetry reduction) at the default geometry and at tiles of one and
    three rows: K3 over K2's claims inserts what the plain step does, the
    lowest valid lane of each fresh key, though the highest tile winner
    claimed it."""
    symmetry = complete is not None
    model = TwoPhaseSys(n, complete_symmetry=bool(complete))
    carry = _mid_search(model, fmax, steps, symmetry)
    w = model.packed_width
    block = carry.q[carry.q_head:carry.q_head + fmax]
    fvalid = torch.arange(fmax) < carry.q_tail - carry.q_head
    table_keys = carry.table[carry.table != 0].numpy().view(np.uint64)
    ring = carry.ring.numpy().view(np.uint64).copy()
    out = fused_step_reference(model, block[:, :w], block[:, w], fvalid,
                               block[:, w + 1], block[:, w + 2],
                               carry.table.clone(), carry.ring.clone(),
                               symmetry=symmetry)
    keys = ((to_numpy_u32(out.chi).astype(np.uint64) << np.uint64(32))
            | to_numpy_u32(out.clo).astype(np.uint64))
    plain_keys = set(keys[out.inserted.numpy()].tolist())
    assert plain_keys
    a = model.max_actions
    spread = 0
    for budget in (L, a, 3 * a):
        geo = _geometry(fmax, a, sms=1, lanes=budget)
        spread += _check_claims(keys, cvalid=out.cvalid.numpy(), f=fmax,
                                a=a, geo=geo, table_keys=table_keys,
                                ring=ring, plain_keys=plain_keys)
    assert spread  # some claimer was not the inserted lane


def k5_transcription(keys, cvalid, f, a, geo, ring, arena, arena_owner,
                     step):
    """K5's claim and commit in numpy, the tile winners racing highest
    lane first; ``arena`` and ``arena_owner`` are updated in place.
    Returns ``(dvalid, S_CCH, claims)``."""
    lanes = np.arange(f * a)
    tile_lanes = geo.rows * a
    tile = lanes // tile_lanes
    winners = _tile_winners(keys, cvalid, tile)
    # the tile stage writes dvalid = 0 for every lane
    dvalid = np.zeros(f * a, bool)
    cc = ring.shape[0]
    held = (ring[_slot(keys[winners], cc)] == keys[winners] if cc
            else np.zeros(winners.shape[0], bool))
    cch = int(held.sum())
    claims = np.full(f * a, -1, np.int64)
    n_claims = np.zeros(geo.blocks, np.int64)
    mask = arena.shape[0] - 1
    for lane in winners[~held][::-1]:
        g = int(_slot(keys[lane:lane + 1], arena.shape[0])[0])
        while arena[g] not in (0, keys[lane]):
            g = (g + 1) & mask
        took = arena[g] == 0
        arena[g] = keys[lane]
        arena_owner[g] = min(arena_owner[g], _tag(step) | np.uint64(lane))
        if took:
            _append(claims, n_claims, tile_lanes, tile[lane], g)
    # the commit: one block per tile, over its claims only
    for t in range(geo.blocks):
        for c in claims[t * tile_lanes:t * tile_lanes + n_claims[t]]:
            dvalid[_owner_lane(arena_owner[c], step, f * a)] = True
            arena[c] = 0
    return dvalid, cch, int(n_claims.sum())


def _check_k5(keys, cvalid, f, a, geo, ring, arena, arena_owner, step,
              plain_keys):
    dvalid, cch, n_claims = k5_transcription(keys, cvalid, f, a, geo, ring,
                                             arena, arena_owner, step)
    cc = ring.shape[0]
    hit = (ring[_slot(keys, cc)] == keys) & cvalid if cc \
        else np.zeros(f * a, bool)
    live = cvalid & ~hit
    # the lowest live lane of each key, and the plain step's key set
    lv = np.flatnonzero(live)
    _u, first = np.unique(keys[lv], return_index=True)
    np.testing.assert_array_equal(np.flatnonzero(dvalid), np.sort(lv[first]))
    assert set(keys[dvalid].tolist()) == plain_keys
    # S_DEDUP and S_INSERTED: one claim per kept lane
    assert n_claims == int(dvalid.sum())
    # the commits left the arena clean for the next step
    assert not arena.any()
    # S_CCH: the (tile, key) pairs of valid lanes whose key the ring holds
    tile = np.arange(f * a) // (geo.rows * a)
    pairs = {(int(t), int(k)) for t, k in zip(tile[hit], keys[hit])}
    assert cch == len(pairs)


def _arena(lanes):
    cells = 1 << max((2 * lanes - 1).bit_length(), 1)
    return np.zeros(cells, np.uint64), np.full(cells, ONES, np.uint64)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("a", ACTIONS)
def test_k5_on_duplicate_heavy_keys(a, seed):
    """Three consecutive probe-free steps of different widths on one
    arena (sized for the widest), each with keys from a small pool, some
    in the ring, at three tile geometries."""
    rng = np.random.default_rng(200 * a + seed)
    fmax = int(rng.integers(8, 48 if a > L else 400))
    for budget, threads in ((L, 256), (64, 32), (1, 32)):
        arena, arena_owner = _arena(fmax * a)
        for step, f in enumerate((fmax, max(1, fmax // 7), fmax // 2), 1):
            pool, keys, cvalid = _pool_keys(rng, f, a)
            ring = np.zeros(64, np.uint64)
            held = pool[rng.random(pool.shape[0]) < 0.3]
            ring[_slot(held, 64)] = held
            hit = (ring[_slot(keys, 64)] == keys)
            plain_keys = set(keys[cvalid & ~hit].tolist())
            geo = _geometry(f, a, sms=1, lanes=budget, threads=threads)
            _check_k5(keys, cvalid, f, a, geo, ring, arena, arena_owner,
                      step, plain_keys)


@pytest.mark.parametrize("n,complete,fmax,steps", STEP_CASES, ids=CASE_IDS)
def test_k5_on_real_step_lanes(n, complete, fmax, steps):
    """Three consecutive probe-free steps over the pending rows of a real
    mid-search state (widths ``fmax``, ``fmax // 8`` and ``fmax // 2``)
    on one arena: ``dvalid`` is the lowest live lane of each key with the
    plain probe-free step's key set, the arena is clean after each, and
    ``S_CCH`` is the recount of (tile, key) pairs the ring holds."""
    symmetry = complete is not None
    model = TwoPhaseSys(n, complete_symmetry=bool(complete))
    carry = _mid_search(model, fmax, steps, symmetry)
    a = model.max_actions
    ring = carry.ring.numpy().view(np.uint64)
    for budget in (L, a, 3 * a):
        arena, arena_owner = _arena(fmax * a)
        start = carry.q_head
        for step, f in enumerate((fmax, max(1, fmax // 8), fmax // 2), 1):
            out, keys = _step_lanes(model, carry, start, f, symmetry)
            start += f
            plain_keys = set(keys[out.dvalid.numpy()].tolist())
            geo = _geometry(f, a, sms=1, lanes=budget)
            _check_k5(keys, out.cvalid.numpy(), f, a, geo, ring, arena,
                      arena_owner, step, plain_keys)
