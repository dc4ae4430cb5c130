"""The launch geometry of the step kernel's K1 (expand) and K2 (claim)
and K2's two-level winner rule, on the CPU.

K1 and K2 run over block tiles of whole frontier rows whose geometry
``ops/_cuda.py`` ``tile_geometry`` computes; the kernels themselves run
only on a card. Here the geometry is held to what the kernels assume
(every lane in exactly one tile, whole rows, the thread walk of
``csrc/step_common.cuh`` ``expand_kernel``, the ring arena's grid-stride
reset), and a numpy transcription of K2 + K3 (the tile's lowest valid
lane of each key, the ring probe, then the global ``atomicMin`` of the
tile minima into the owner word) is held to the plain step's inserted key
set and to the lowest-lane rule. The transcription checks the algorithm,
not the kernel: what holds the kernels lane for lane and by the set gate
are ``chip_smoke.py``'s kernel phases and ``tests/test_torch_gpu.py``,
on the card. numpy and small torch tensors only: no process, no JAX,
well under a second each.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

from stateright_tpu_torch import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.checker.device_loop import (  # noqa: E402
    run_chunk, seed_carry)
from stateright_tpu_torch.ops import _cuda  # noqa: E402
from stateright_tpu_torch.ops.fused import fused_step_reference  # noqa: E402
from stateright_tpu_torch.ops.hashtable import (  # noqa: E402
    make_table, table_insert_reference)
from stateright_tpu_torch.ops.words import (  # noqa: E402
    from_numpy_u32, to_numpy_u32)

L = _cuda.TILE_LANES
#: the SMs of an H100 SXM
SMS = 132
ACTIONS = (1, 37, 82, L + 1)
ROWS = (0, 1, 255, 256, 257, 12288)
M64 = np.uint64(0xFFFFFFFF)
PHI = np.uint64(0x9E3779B9)


def _thread_walk(a: int, tile: int, threads: int):
    """The (row, action) each thread of one tile takes at each step of
    its lane loop, transcribed from ``expand_kernel``: start at
    ``divmod(thread, a)``, advance by ``divmod(threads, a)`` with one
    carry. Returns the lanes ``t`` and their ``(row, action)``."""
    drow, dact = divmod(threads, a)
    tid = np.arange(threads)
    row, act = tid // a, tid % a
    t = tid.copy()
    lanes, rows, acts = [], [], []
    while (t < tile).any():
        live = t < tile
        lanes.append(t[live])
        rows.append(row[live])
        acts.append(act[live])
        t = t + threads
        row = row + drow
        act = act + dact
        carry = act >= a
        act = np.where(carry, act - a, act)
        row = np.where(carry, row + 1, row)
    if not lanes:
        return (np.zeros(0, np.int64),) * 3
    return np.concatenate(lanes), np.concatenate(rows), np.concatenate(acts)


def _geometry(f, a, sms=SMS, lanes=L, threads=256):
    """``tile_geometry`` with the lane budget and thread count set as
    the tile sweep sets them."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_cuda, "TILE_LANES", lanes)
        mp.setattr(_cuda, "TILE_THREADS", threads)
        return _cuda.tile_geometry(f, a, sms)


@pytest.mark.parametrize("budget", [L // 2, L])
@pytest.mark.parametrize("f", ROWS)
@pytest.mark.parametrize("a", ACTIONS)
def test_tile_geometry_covers_every_lane_once(a, f, budget):
    g = _geometry(f, a, lanes=budget)
    assert g.rows >= 1 and g.blocks >= 1
    assert g.threads % 32 == 0 and 32 <= g.threads <= _cuda.TILE_THREADS
    assert g.rows * a <= max(budget, a)  # a row wider than L: one row
    # no block without a row (F = 0 still launches one, for the reset)
    assert (g.blocks - 1) * g.rows < max(f, 1) <= g.blocks * g.rows
    # K2's shared table: a power of two, at least two cells per lane
    tile = g.rows * a
    assert g.cells & (g.cells - 1) == 0 and g.cells >= 2 * tile
    # the tiles: contiguous whole rows, every lane exactly once
    b = np.arange(g.blocks)
    row0 = b * g.rows
    row1 = np.minimum(f, row0 + g.rows)
    n_rows = np.maximum(row1 - row0, 0)
    starts, ends = row0 * a, row0 * a + n_rows * a
    assert starts[0] == 0 and ends[-1] == f * a
    np.testing.assert_array_equal(starts[1:], ends[:-1])
    assert (starts % a == 0).all() and (ends % a == 0).all()
    # the thread walk of a full tile and of the last one
    for n in {int(n_rows[0]), int(n_rows[-1])}:
        t, row, act = _thread_walk(a, n * a, g.threads)
        assert np.array_equal(np.sort(t), np.arange(n * a))
        np.testing.assert_array_equal(row * a + act, t)
        assert ((row < n) & (act < a)).all()


@pytest.mark.parametrize("cc", [0, 1, 1 << 15])
@pytest.mark.parametrize("f,a", [(0, 37), (1, 82), (256, 37),
                                 (12288, 82)])
def test_ring_arena_reset_covers_every_slot_once(f, a, cc):
    g = _cuda.tile_geometry(f, a, SMS)
    nthreads = g.blocks * g.threads
    tid = np.arange(nthreads)
    hits = np.zeros(cc, np.int64)
    for k in range(-(-cc // nthreads) if cc else 0):
        i = tid + k * nthreads
        np.add.at(hits, i[i < cc], 1)
    assert (hits == 1).all()


def test_tile_geometry_refuses_what_the_kernels_cannot_launch():
    for bad in ((-1, 37, SMS), (8, 0, SMS), (8, 37, 0)):
        with pytest.raises(ValueError):
            _cuda.tile_geometry(*bad)
    for lanes, threads in ((0, 256), (L, 100), (L, 2048)):
        with pytest.raises(ValueError):
            _geometry(8, 37, lanes=lanes, threads=threads)


def test_tile_geometry_reads_its_knobs_when_called(monkeypatch):
    """The tile sweep sets ``TILE_LANES`` and ``TILE_THREADS`` on the
    module; the launch geometry must follow them."""
    base = _cuda.tile_geometry(12288, 37, SMS)
    monkeypatch.setattr(_cuda, "TILE_THREADS", 512)
    monkeypatch.setattr(_cuda, "TILE_LANES", 2048)
    monkeypatch.setattr(_cuda, "TILES_PER_SM", 1)
    g = _cuda.tile_geometry(12288, 37, SMS)
    assert (base.threads, g.threads) == (256, 512)
    assert (base.rows, g.rows) == (27, 55)


def test_tile_geometry_shape_at_the_main_paths_widths():
    """At the large step the tiles hold whole rows up to the budget; at
    the thin step (256 rows) one row each, so 256 blocks spread over the
    card."""
    for a in (37, 82):
        big = _cuda.tile_geometry(12288, a, SMS)
        assert big.rows == min(L // a, -(-12288 // (2 * SMS)))
        assert big.blocks == -(-12288 // big.rows)
        thin = _cuda.tile_geometry(256, a, SMS)
        assert (thin.rows, thin.blocks) == (1, 256)
        # a card of one SM: full tiles, the last one ragged
        one = _cuda.tile_geometry(256, a, 1)
        assert one.rows == min(L // a, 128) and 256 % one.rows


def _slot(keys: np.ndarray, n: int) -> np.ndarray:
    """``start_bucket`` in numpy: the ring slot (and start bucket)."""
    hi, lo = keys >> np.uint64(32), keys & M64
    return ((lo ^ ((hi * PHI) & M64)) & np.uint64(n - 1)).astype(np.int64)


def k2_k3_transcription(keys, cvalid, f, a, geo, table_keys, ring):
    """K2 then K3 in numpy: within each tile the lowest valid lane of
    each key goes on (the shared table); a tile winner whose key the ring
    holds dies; every other one reaches the table and atomicMin's its
    lane into its key's owner word; the owner of each key the table did
    not hold before the step is inserted. Returns ``(dvalid, inserted)``
    as bool ``[f * a]``."""
    lanes = np.arange(f * a)
    tile = lanes // (geo.rows * a)
    v = lanes[cvalid]
    # the lowest lane of each (tile, key): lanes are in ascending order
    _u, first = np.unique(np.stack([tile[v], keys[v].view(np.int64)], 1),
                          axis=0, return_index=True)
    winners = v[first]
    if ring is not None and ring.shape[0]:
        winners = winners[ring[_slot(keys[winners], ring.shape[0])]
                          != keys[winners]]
    dvalid = np.zeros(f * a, bool)
    dvalid[winners] = True
    # owner word per key: the least lane of its tile winners
    winners = np.sort(winners)
    _u, first = np.unique(keys[winners], return_index=True)
    owners = winners[first]
    fresh = ~np.isin(keys[owners], table_keys)
    inserted = np.zeros(f * a, bool)
    inserted[owners[fresh]] = True
    return dvalid, inserted


def _lowest_valid_lane_of_each_fresh_key(keys, cvalid, table_keys):
    lanes = np.flatnonzero(cvalid)
    _u, first = np.unique(keys[lanes], return_index=True)
    low = lanes[first]
    return np.sort(low[~np.isin(keys[low], table_keys)])


def _check(keys, cvalid, f, a, geo, table_keys, ring, plain_keys):
    dvalid, inserted = k2_k3_transcription(keys, cvalid, f, a, geo,
                                           table_keys, ring)
    ins = np.flatnonzero(inserted)
    # one lane per fresh key, the lowest valid lane carrying it
    np.testing.assert_array_equal(
        ins, _lowest_valid_lane_of_each_fresh_key(keys, cvalid,
                                                  table_keys))
    assert set(keys[ins].tolist()) == plain_keys
    # dvalid: valid lanes, one per key and tile
    assert not (dvalid & ~cvalid).any()
    tile = np.flatnonzero(dvalid) // (geo.rows * a)
    pairs = set(zip(tile.tolist(), keys[dvalid].tolist()))
    assert len(pairs) == int(dvalid.sum())


@pytest.mark.parametrize("seed", range(6))
def test_winner_rule_on_duplicate_heavy_keys(seed):
    """Random keys from a small pool (most lanes share a key with lanes
    of other tiles), some already in the table, some in the ring; the
    plain hash-set insert of the same lanes gives the fresh key set."""
    rng = np.random.default_rng(seed)
    a = int(rng.choice([1, 7, 37, 82]))
    f = int(rng.integers(1, 400))
    pool = rng.integers(1, 2**63, size=int(rng.integers(3, 60)),
                        dtype=np.int64).astype(np.uint64)
    keys = pool[rng.integers(0, pool.shape[0], f * a)]
    cvalid = rng.random(f * a) < 0.7
    table_keys = pool[rng.random(pool.shape[0]) < 0.3]
    ring = np.zeros(64, np.uint64)
    held = table_keys[: table_keys.shape[0] // 2]
    ring[_slot(held, 64)] = held
    table = make_table(1 << 12)
    hi = from_numpy_u32((keys >> np.uint64(32)).astype(np.uint32))
    lo = from_numpy_u32((keys & M64).astype(np.uint32))
    thi = from_numpy_u32((table_keys >> np.uint64(32)).astype(np.uint32))
    tlo = from_numpy_u32((table_keys & M64).astype(np.uint32))
    table_insert_reference(table, thi, tlo,
                           torch.ones(thi.shape[0], dtype=torch.bool))
    ins_p, _ovf = table_insert_reference(table, hi, lo,
                                         torch.from_numpy(cvalid))
    plain_keys = set(keys[ins_p.numpy()].tolist())
    for budget, threads in ((L, 256), (64, 32), (1, 32)):
        geo = _geometry(f, a, sms=1, lanes=budget, threads=threads)
        _check(keys, cvalid, f, a, geo, table_keys, ring, plain_keys)


def _mid_search(model, fmax, steps, symmetry):
    init = model.init_states()[0]
    fp = model.fingerprint(model.representative(init) if symmetry
                           else init)
    # the queue keeps one iteration's margin past its tail (fmax * A rows)
    carry = seed_carry(model, 1 << 15, 1 << 12, [model.encode(init)], 0,
                       [fp], 1 << 8, "cpu", symmetry=symmetry)
    table_insert_reference(
        carry.table, from_numpy_u32(np.array([fp >> 32], np.uint32)),
        from_numpy_u32(np.array([fp & 0xFFFFFFFF], np.uint32)),
        torch.ones((1,), dtype=torch.bool))
    run_chunk(model, carry, fmax=fmax, steps=steps)
    assert carry.q_tail > carry.q_head
    return carry


STEP_CASES = [(4, None, 16, 6), (4, None, 256, 4), (5, None, 512, 5),
              (5, False, 256, 4), (5, True, 256, 4)]


@pytest.mark.parametrize(
    "n,complete,fmax,steps", STEP_CASES,
    ids=[f"2pc{n}-{'plain' if c is None else ('complete' if c else 'ref')}"
         f"-f{f}" for n, c, f, _s in STEP_CASES])
def test_winner_rule_on_real_step_lanes(n, complete, fmax, steps):
    """The lanes of a real mid-search step (2pc4/2pc5, with and without
    symmetry reduction): the transcription's inserted key set is the
    plain step's, and its lanes are the lowest valid lane of each fresh
    key, at the default geometry and at tiles of a few rows."""
    symmetry = complete is not None
    model = TwoPhaseSys(n, complete_symmetry=bool(complete))
    carry = _mid_search(model, fmax, steps, symmetry)
    w = model.packed_width
    block = carry.q[carry.q_head:carry.q_head + fmax]
    take = min(carry.q_tail - carry.q_head, fmax)
    fvalid = torch.arange(fmax) < take
    table_before = carry.table.clone()
    ring_before = carry.ring.clone()
    out = fused_step_reference(model, block[:, :w], block[:, w], fvalid,
                               block[:, w + 1], block[:, w + 2],
                               carry.table, carry.ring, symmetry=symmetry)
    keys = ((to_numpy_u32(out.chi).astype(np.uint64) << np.uint64(32))
            | to_numpy_u32(out.clo).astype(np.uint64))
    cvalid = out.cvalid.numpy()
    plain_keys = set(keys[out.inserted.numpy()].tolist())
    assert plain_keys  # the step inserts something
    table_keys = table_before[table_before != 0].numpy().view(np.uint64)
    ring = ring_before.numpy().view(np.uint64)
    a = model.max_actions
    for budget in (L, a, 3 * a):
        geo = _geometry(fmax, a, sms=1, lanes=budget)
        _check(keys, cvalid, fmax, a, geo, table_keys, ring, plain_keys)
