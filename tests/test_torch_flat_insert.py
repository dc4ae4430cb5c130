"""The flat insert of the card on the CPU: K4 (the stand-alone insert,
``csrc/fused_step.cu`` ``srt_table_insert``) and K6 (the owner-side
probe, ``csrc/sharded_step.cu`` ``srt_probe_block``) both launch
``launch_insert`` of ``csrc/step_common.cuh``: ``flat_insert_kernel``,
one thread per lane; with a mask over consecutive lane ranges of at most
the resident grid's threads, each range one cooperative launch.

Here a numpy transcription of it, with the kernel's data structures
(owner words tagged by the call, 4-slot buckets, the claimer's slot kept
across the grid's barrier, a commit through ``owner_lane``), is held to
the plain version (``table_insert_reference``, which
``probe_block_reference`` is) for the inserted key set, the table's key
set and the overflow flag; to the lowest valid lane of each fresh key;
and to a repeat of the same call, whose lanes race in another order on
the same owner words, which must give the same mask. The claimer is
adversarial: the HIGHEST valid lane of each key in a range probes first
and takes its slot, so a commit that took the claimer's lane instead of
the owner word's would be caught. Without a mask (the seed and growth)
only the table and the overflow flag are made. The transcription checks
the algorithm, not the kernel: ``chip_smoke.py`` and
``tests/test_torch_gpu.py`` hold that on the card. numpy and small torch
tensors only: no process, no JAX, well under a second each.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

from stateright_tpu_torch import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.checker.device_loop import (  # noqa: E402
    shrink_indices)
from stateright_tpu_torch.ops.fused import (  # noqa: E402
    fused_step_reference, probe_block_reference)
from stateright_tpu_torch.ops.hashtable import (  # noqa: E402
    make_table, table_insert_reference)
from stateright_tpu_torch.ops.words import (  # noqa: E402
    from_numpy_u32, to_numpy_u32)

from test_torch_claims_geometry import (  # noqa: E402
    ONES, _owner_lane, _tag)
from test_torch_step_geometry import (  # noqa: E402
    M64, _lowest_valid_lane_of_each_fresh_key, _mid_search, _slot)

_COMMON = (Path(__file__).resolve().parents[1] / "stateright_tpu_torch"
           / "csrc" / "step_common.cuh")
#: ``kThreads`` of ``csrc/step_common.cuh``: lanes per block
THREADS = 256
#: resident blocks of the transcribed launches: as many as the batch
#: needs (one range), one (ranges of 256 lanes: copies of a key 1,500
#: lanes apart never share one) and eight (ranges of 2,048 lanes)
RESIDENT = (None, 1, 8)


def launch_ranges(n: int, resident):
    """``launch_insert``'s cooperative launches over ``n`` lanes with
    ``resident`` blocks resident at once (``None``: unbounded): ``(grid,
    lane0)`` of each, in order (none for an empty batch)."""
    if not n:
        return []
    need = -(-n // THREADS)
    grid = need if resident is None else min(need, resident)
    return [(grid, lane0) for lane0 in range(0, n, grid * THREADS)]


def launch_lanes(n: int, grid: int, lane0: int):
    """The lane of each thread of one launch (``flat_insert_kernel``:
    ``lane0`` plus the thread's index), -1 past ``n``."""
    lanes = lane0 + np.arange(grid * THREADS)
    return np.where(lanes < n, lanes, -1)


def _probe_claim(table, key, max_rounds: int):
    """``probe_claim`` on a table of 4-slot buckets: ``(outcome, slot,
    rounds)``, the outcome ``"dup"``, ``"claimed"`` or ``"ovf"``."""
    nb = table.shape[0] // 4
    g = int(_slot(np.array([key], np.uint64), nb)[0])
    for rounds in range(1, max_rounds + 1):
        bucket = table[4 * g:4 * g + 4]
        hit = np.flatnonzero(bucket == key)
        if hit.size:
            return "dup", 4 * g + int(hit[0]), rounds
        empty = np.flatnonzero(bucket == 0)
        if empty.size:
            s = 4 * g + int(empty[0])
            table[s] = key
            return "claimed", s, rounds
        g = (g + 1) % nb
    return "ovf", -1, max_rounds


def flat_insert(keys, valid, table, owner, step, max_rounds, mask=True,
                resident=None, rng=None):
    """K4/K6 in numpy, one launch at a time: every lane gets
    inserted = 0 (with ``mask``); each valid lane of the range probes and
    claims, the HIGHEST first (``rng``: in a random order), and with
    ``mask`` atomicMin's its tagged lane into the owner word of the slot
    its probe ends at, the claimer keeping that slot; after the range's
    barrier each claimer marks its slot's owner lane. With ``mask``
    the launches are ``launch_ranges(n, resident)``. ``table`` (uint64
    slots) and ``owner`` are updated in place. Returns ``(inserted,
    overflow, rounds, claims)``, ``inserted`` ``None`` without a
    mask."""
    n = keys.shape[0]
    inserted = np.zeros(n, bool) if mask else None
    ovf, rounds, n_claims = False, 0, 0
    # without a mask: one launch over every lane
    ranges = (launch_ranges(n, resident) if mask
              else [(-(-n // THREADS), 0)] if n else [])
    for grid, lane0 in ranges:
        lanes = launch_lanes(n, grid, lane0)
        lanes = lanes[lanes >= 0]
        probers = lanes[valid[lanes]]
        probers = probers[::-1] if rng is None else rng.permutation(probers)
        claims = []  # (claimer, slot), each in the claimer's register
        for lane in probers:
            outcome, s, r = _probe_claim(table, keys[lane], max_rounds)
            rounds = max(rounds, r)
            if outcome == "ovf":
                ovf = True
            elif mask:
                owner[s] = min(owner[s], _tag(step) | np.uint64(lane))
                if outcome == "claimed":
                    claims.append((lane, s))
        # the grid's barrier; then each claimer's commit
        for _claimer, s in claims:
            inserted[_owner_lane(owner[s], step, n)] = True
        n_claims += len(claims)
    return inserted, ovf, rounds, n_claims


def _halves(keys):
    return (from_numpy_u32((keys >> np.uint64(32)).astype(np.uint32)),
            from_numpy_u32((keys & M64).astype(np.uint32)))


def _seeded(table_keys, capacity: int):
    """A torch table holding ``table_keys`` (the plain insert)."""
    table = make_table(capacity)
    if len(table_keys):
        hi, lo = _halves(np.asarray(table_keys, np.uint64))
        _ins, ovf = table_insert_reference(
            table, hi, lo, torch.ones(hi.shape[0], dtype=torch.bool))
        assert not ovf
    return table


def _stale_owner(table_np, step: int):
    """Owner words of an earlier call on every occupied slot, so the tag
    check meets stale words."""
    owner = np.full(table_np.shape[0], ONES, np.uint64)
    used = np.flatnonzero(table_np)
    owner[used] = _tag(step - 1) | np.arange(used.shape[0], dtype=np.uint64)
    return owner


def _check(keys, valid, table0, resident, mask, max_rounds=4096,
           seed=0):
    """The transcription against the plain insert on the same table, the
    lowest-lane rule and a repeat; returns ``(inserted, overflow,
    rounds)`` of the transcription."""
    before = table0[table0 != 0].numpy().view(np.uint64)
    # the plain version (K6's plain version is the same function)
    t_p = table0.clone()
    hi, lo = _halves(keys)
    v = torch.from_numpy(valid)
    ins_p, ovf_p, _r = probe_block_reference(t_p, hi, lo, v, max_rounds)
    ins_p = ins_p.numpy()
    # the transcription, the highest valid lane of each key claiming
    step = 7
    table = table0.clone().numpy().view(np.uint64).reshape(-1).copy()
    owner = _stale_owner(table, step)
    inserted, ovf, rounds, n_claims = flat_insert(
        keys, valid, table, owner, step, max_rounds, mask, resident)
    assert ovf == bool(ovf_p)
    np.testing.assert_array_equal(np.sort(table[table != 0]),
                                  np.sort(t_p[t_p != 0].numpy()
                                          .view(np.uint64)))
    if not mask:
        assert inserted is None and n_claims == 0
        return inserted, ovf, rounds
    assert set(keys[inserted].tolist()) == set(keys[ins_p].tolist())
    # one claimed slot per inserted lane, one lane per key
    assert n_claims == int(inserted.sum()) \
        == len(set(keys[inserted].tolist()))
    if not ovf:
        np.testing.assert_array_equal(
            np.flatnonzero(inserted),
            _lowest_valid_lane_of_each_fresh_key(keys, valid, before))
    # a repeat: the same lanes into the same starting table, racing in a
    # random order, on the owner words the first call left (tagged by an
    # older call): the same mask
    table2 = table0.clone().numpy().view(np.uint64).reshape(-1).copy()
    again, ovf2, _r2, _n2 = flat_insert(
        keys, valid, table2, owner, step + 1, max_rounds, mask, resident,
        np.random.default_rng(seed))
    np.testing.assert_array_equal(again, inserted)
    assert ovf2 == ovf
    np.testing.assert_array_equal(np.sort(table2), np.sort(table))
    return inserted, ovf, rounds


def _distinct(rng, n):
    return np.unique(rng.integers(1, 2**63, size=n + 16, dtype=np.int64)
                     .astype(np.uint64))[:n]


def _case_growth(rng):
    """Distinct keys into an empty table: the growth re-insert."""
    keys = _distinct(rng, 3000)
    return keys, np.ones(keys.shape[0], bool), _seeded([], 1 << 14), 4096


def _case_twice(rng):
    """Every key twice in the batch, as ``chip_smoke.py``'s insert check
    and K6's "twice" batch send them."""
    keys = _distinct(rng, 1500)
    keys = np.concatenate([keys, keys])
    return keys, np.ones(keys.shape[0], bool), _seeded([], 1 << 14), 4096


def _case_padded(rng):
    """The received lanes of a sharded step: the lanes a real 2pc7
    probe-free step kept, compacted ahead of ~60 % invalid padding, into
    that state's table."""
    model = TwoPhaseSys(7)
    fmax = 64
    carry = _mid_search(model, fmax, 4, False)
    w = model.packed_width
    block = carry.q[carry.q_head:carry.q_head + fmax]
    fvalid = torch.arange(fmax) < carry.q_tail - carry.q_head
    out = fused_step_reference(model, block[:, :w], block[:, w], fvalid,
                               block[:, w + 1], block[:, w + 2], None,
                               carry.ring, probe=False)
    count = int(out.dvalid.sum())
    n = -(-count * 5 // 2)
    src = shrink_indices(out.dvalid, n)
    keys = ((to_numpy_u32(out.chi[src]).astype(np.uint64) << np.uint64(32))
            | to_numpy_u32(out.clo[src]).astype(np.uint64))
    valid = np.arange(n) < count
    # the padding carries the step's lane-0 key: only validity drops it
    assert count and valid.mean() < 0.45
    return keys, valid, carry.table.clone(), 4096


def _case_present(rng):
    """Half the batch's keys already in the table, most keys on a few
    lanes."""
    pool = _distinct(rng, 1000)
    keys = pool[rng.integers(0, pool.shape[0], 2000)]
    valid = rng.random(keys.shape[0]) < 0.9
    return keys, valid, _seeded(pool[::2], 1 << 14), 4096


def _case_across_tiles(rng):
    """A few keys over many lanes: most keys have valid lanes in many
    tiles, so the claimer is rarely the lowest lane."""
    pool = _distinct(rng, 40)
    keys = pool[rng.integers(0, pool.shape[0], 2000)]
    valid = rng.random(keys.shape[0]) < 0.7
    return keys, valid, _seeded(pool[:8], 1 << 10), 4096


def _case_tiny_table(rng):
    """A 64-slot table for 40 keys: probes walk several buckets."""
    pool = _distinct(rng, 40)
    keys = pool[rng.integers(0, pool.shape[0], 300)]
    valid = rng.random(keys.shape[0]) < 0.8
    valid[:pool.shape[0]] = True
    keys[:pool.shape[0]] = pool
    return keys, valid, _seeded(pool[:6], 64), 4096


def _case_full(rng):
    """A full 32-slot table: present keys are found, fresh keys walk
    every bucket and overflow."""
    old = _distinct(rng, 32)
    table = _seeded(old, 32)
    assert bool((table != 0).all())
    keys = np.concatenate([_distinct(np.random.default_rng(99), 20),
                           old[:5]])
    keys = keys[rng.permutation(keys.shape[0])]
    return keys, np.ones(keys.shape[0], bool), table, 16


CASES = {"growth": _case_growth, "twice": _case_twice,
         "padded": _case_padded, "present": _case_present,
         "across_tiles": _case_across_tiles,
         "tiny_table": _case_tiny_table, "full": _case_full}


@pytest.mark.parametrize("resident", RESIDENT,
                         ids=["one_range", "resident1", "resident8"])
@pytest.mark.parametrize("case", list(CASES))
def test_flat_insert_against_the_plain_insert(case, resident):
    """Each case with a mask, in one launch range and in ranges of one or
    eight resident blocks' lanes."""
    rng = np.random.default_rng(sorted(CASES).index(case))
    keys, valid, table0, max_rounds = CASES[case](rng)
    inserted, ovf, rounds = _check(keys, valid, table0, resident, True,
                                   max_rounds, seed=len(keys))
    assert ovf == (case == "full")
    assert inserted.any() != ovf
    if case == "tiny_table":
        assert rounds > 1  # some probe walked past its start bucket
    if case in ("twice", "across_tiles"):
        # the trap: some fresh key has several valid lanes in one range,
        # so its claimer (the highest) is not the inserted lane; or, with
        # one resident block, every copy of a "twice" key lies in another
        # range, which finds the key the earlier range inserted
        n = keys.shape[0]
        ranges = launch_ranges(n, resident)
        range_of = np.arange(n) // (ranges[0][0] * THREADS)
        shared = any(((keys == keys[lane]) & valid
                      & (range_of == range_of[lane])).sum() > 1
                     for lane in np.flatnonzero(inserted))
        if case == "twice" and resident == 1:
            assert not shared and len(ranges) > 1
        else:
            assert shared


@pytest.mark.parametrize("case", list(CASES))
def test_flat_insert_without_a_mask(case):
    """Each case without a mask (the seed and growth): one launch, no
    owner words; the plain insert's table and overflow flag."""
    rng = np.random.default_rng(sorted(CASES).index(case))
    keys, valid, table0, max_rounds = CASES[case](rng)
    inserted, ovf, rounds = _check(keys, valid, table0, None, False,
                                   max_rounds)
    assert inserted is None and ovf == (case == "full")
    if case == "tiny_table":
        assert rounds > 1


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 1024, 1025, 51456,
                               56832])
@pytest.mark.parametrize("resident", [1, 3, 1056])
def test_launch_ranges_cover_every_lane_once(n, resident):
    """``launch_insert``'s cooperative launches take every lane exactly
    once, in ranges of ascending lanes; a batch within the resident
    threads is one launch."""
    ranges = launch_ranges(n, resident)
    seen = [launch_lanes(n, grid, lane0) for grid, lane0 in ranges]
    flat = np.concatenate(seen or [np.zeros(0)])
    np.testing.assert_array_equal(np.sort(flat[flat >= 0]), np.arange(n))
    for t, (grid, lane0) in zip(seen, ranges):
        assert t[t >= 0].min() == lane0 and grid <= resident
    assert len(ranges) == -(-n // (resident * THREADS))


def test_transcribed_constants_match_the_kernel():
    """``THREADS`` is ``kThreads`` of ``csrc/step_common.cuh``."""
    src = _COMMON.read_text()
    assert re.search(rf"constexpr int kThreads = {THREADS};", src)
