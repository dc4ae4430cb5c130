"""The device-resident BFS chunk loop, driven from the host.

Counterpart of ``stateright_tpu/checker/device_loop.py`` on its fused
single-chip path (``build_chunk_core`` with ``fused=True, cc > 0``). The
carry holds

  * an append-only FIFO queue of pending packed states: row (cols
    ``0..W-1``), eventually-bits (col ``W``), cached state fingerprint
    hi/lo (cols ``W+1``, ``W+2``). Every state is enqueued exactly once,
    so the head only advances and appends are contiguous block writes;
  * the visited table (``ops/hashtable.py``: packed int64 keys);
  * the cross-chunk recent-key ring (packed int64 keys);
  * an append-only log of (child fp hi, lo, parent fp hi, lo) rows, the
    search record the host mirrors lazily;
  * sticky first-hit discovery registers and overflow flags.

JAX runs the loop as ``lax.while_loop``s on the device; here it is a host
loop of launches. Each iteration takes the small step (``FMAX_SMALL``
rows) iff at most that many rows are pending, else the large one — the
order the JAX package's small/large/small window loops walk — runs the
fused step, reads the step's stats vector with ONE device->host copy
(the iteration's only sync), and appends exactly the inserted rows to
the queue and the log. Queue, table, ring and log are updated in place.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.expand import assemble_candidates, small_step_sizes
from ..ops.fused import (S_CCH, S_DEDUP, S_DISC, S_INSERTED, S_OVF,
                         S_ROUNDS, S_VALID, S_XOVF, StepWorkspace,
                         fused_step)
from ..ops.hashtable import make_table
from ..ops.words import (from_numpy_u32, keys_from_numpy, keys_to_numpy,
                         to_numpy_u32)


@dataclass
class ChunkCarry:
    """The search state. Tensors live on the engine's device; the loop
    scalars and discovery registers live on the host (every iteration
    reads them anyway)."""

    q: torch.Tensor          # int32[qcap, W+3] append-only queue
    q_head: int              # next row to expand
    q_tail: int              # next free row
    table: torch.Tensor      # int64[cap/4, 4] visited table
    ring: Optional[torch.Tensor]  # int64[cc] recent-key ring, or None
    log: torch.Tensor        # int32[logcap, 4] (child fp, parent fp)
    log_n: int
    disc_hit: np.ndarray     # bool[P]   property discovered?
    disc_fp: np.ndarray      # uint64[P] witnessing state fingerprint
    ovf: bool = False        # table probe overflow
    xovf: bool = False       # model encoding overflow (fatal)
    ws: Optional[StepWorkspace] = None  # kernel state (CUDA only)


@dataclass
class LoopStats:
    """Counters of the host loop (``GpuChecker.profile()``)."""

    iterations: int = 0
    small_iterations: int = 0
    syncs: int = 0           # device->host copies of the step stats
    sync_s: float = 0.0      # host seconds blocked in those copies
    vmax: int = 0            # most valid lanes in one step
    dmax: int = 0            # most lanes reaching the table in one step
    cch: int = 0             # cross-chunk ring hits
    rounds: int = 0          # probe rounds (see ops/hashtable.py)


def shrink_indices(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Compaction plan: ``src[j]`` is the index of the ``j+1``-th set bit
    of ``mask`` (0 for ``j >= count``; callers slice by the count). One
    cumsum and one scatter, no host sync."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    idx = torch.where(mask & (pos < k), pos, k)
    inv = torch.zeros((k + 1,), dtype=torch.int64, device=mask.device)
    inv.scatter_(0, idx, torch.arange(mask.shape[0], dtype=torch.int64,
                                      device=mask.device))
    return inv[:k]


def seed_carry(model, qcap: int, capacity: int, init_rows, full_ebits,
               init_fps, cc: int, device) -> ChunkCarry:
    """The initial carry: init states enqueued (with their cached
    fingerprints), empty table, log and ring. The caller inserts the init
    fingerprints into the table."""
    width = model.packed_width
    q = torch.zeros((qcap, width + 3), dtype=torch.int32, device=device)
    k = len(init_rows)
    if k:
        fps = np.asarray(init_fps, np.uint64)
        block = np.concatenate(
            [np.stack(init_rows).astype(np.uint32),
             np.broadcast_to(np.asarray(full_ebits, np.uint32), (k, 1)),
             (fps >> np.uint64(32)).astype(np.uint32)[:, None],
             fps.astype(np.uint32)[:, None]], axis=1)
        q[:k] = from_numpy_u32(block, device)
    n_props = len(model.properties())
    table = make_table(capacity, device)
    return ChunkCarry(
        q=q, q_head=0, q_tail=k, table=table,
        ring=(torch.zeros((cc,), dtype=torch.int64, device=device)
              if cc else None),
        log=torch.zeros((capacity, 4), dtype=torch.int32, device=device),
        log_n=0, disc_hit=np.zeros(n_props, bool),
        disc_fp=np.zeros(n_props, np.uint64),
        ws=(StepWorkspace(capacity, cc, n_props, table.device)
            if table.is_cuda else None))


def carry_from_numpy(carry, ring_hi, ring_lo, device="cpu") -> ChunkCarry:
    """The port's carry from the JAX package's: ``carry`` has the JAX
    ``ChunkCarry`` fields as numpy-convertible arrays (``q``, ``q_head``,
    ``q_tail``, bucket-major ``key_hi``/``key_lo``, ``log``, ``log_n``,
    ``disc_hit``/``disc_hi``/``disc_lo``, ``ovf``, ``xovf``); the ring
    halves ride beside it (``None`` for no ring). The table and ring
    halves become packed int64 keys."""
    log = np.asarray(carry.log)[:, :4]
    table = keys_from_numpy(np.asarray(carry.key_hi),
                            np.asarray(carry.key_lo), device)
    ring = (None if ring_hi is None
            else keys_from_numpy(np.asarray(ring_hi), np.asarray(ring_lo),
                                 device))
    n_props = np.asarray(carry.disc_hit).shape[0]
    disc_fp = (np.asarray(carry.disc_hi, np.uint64) << np.uint64(32)) \
        | np.asarray(carry.disc_lo, np.uint64)
    return ChunkCarry(
        q=from_numpy_u32(carry.q, device), q_head=int(carry.q_head),
        q_tail=int(carry.q_tail), table=table, ring=ring,
        log=from_numpy_u32(log, device), log_n=int(carry.log_n),
        disc_hit=np.asarray(carry.disc_hit, bool).copy(), disc_fp=disc_fp,
        ovf=bool(carry.ovf), xovf=bool(carry.xovf),
        ws=(StepWorkspace(table.numel(), 0 if ring is None
                          else ring.shape[0], n_props, table.device)
            if table.is_cuda else None))


def carry_to_numpy(carry: ChunkCarry) -> dict:
    """Inverse of :func:`carry_from_numpy`: the JAX layout as numpy
    arrays (table and ring as uint32 hi/lo halves)."""
    key_hi, key_lo = keys_to_numpy(carry.table)
    out = dict(q=to_numpy_u32(carry.q), q_head=carry.q_head,
               q_tail=carry.q_tail, key_hi=key_hi, key_lo=key_lo,
               log=to_numpy_u32(carry.log), log_n=carry.log_n,
               disc_hit=carry.disc_hit.copy(),
               disc_hi=(carry.disc_fp >> np.uint64(32)).astype(np.uint32),
               disc_lo=carry.disc_fp.astype(np.uint32),
               ovf=carry.ovf, xovf=carry.xovf, ring_hi=None, ring_lo=None)
    if carry.ring is not None:
        out["ring_hi"], out["ring_lo"] = keys_to_numpy(carry.ring)
    return out


def step_once(model, carry: ChunkCarry, fmax_b: int,
              stats: LoopStats) -> np.ndarray:
    """One loop iteration over up to ``fmax_b`` pending rows: the fused
    step, the stats sync, the queue and log appends. Returns the step's
    stats vector (``ops/fused.py`` ``S_*``)."""
    width = model.packed_width
    n_actions = model.max_actions
    q = carry.q
    h = carry.q_head
    take = min(carry.q_tail - h, fmax_b)
    block = q[h:h + fmax_b]
    fvalid = torch.arange(fmax_b, device=q.device) < take
    out = fused_step(model, block[:, :width], block[:, width], fvalid,
                     block[:, width + 1], block[:, width + 2], carry.table,
                     carry.ring, carry.ws)
    src = shrink_indices(out.inserted, fmax_b * n_actions)
    t0 = time.perf_counter()
    st = out.stats.cpu().numpy()
    stats.sync_s += time.perf_counter() - t0
    stats.syncs += 1
    cnt = int(st[S_INSERTED])
    if cnt:
        src = src[:cnt]
        ridx = src // n_actions
        cand, log_off = assemble_candidates(
            out.flat[src], out.ebits[ridx], out.chi[src], out.clo[src],
            block[:, width + 1][ridx], block[:, width + 2][ridx])
        t = carry.q_tail
        q[t:t + cnt] = cand[:, :width + 3]
        carry.log[carry.log_n:carry.log_n + cnt] = \
            cand[:, log_off:log_off + 4]
    carry.q_head = h + take
    carry.q_tail += cnt
    carry.log_n += cnt
    carry.ovf |= bool(st[S_OVF])
    carry.xovf |= bool(st[S_XOVF])
    n_props = carry.disc_hit.shape[0]
    d = st[S_DISC:S_DISC + 3 * n_props].astype(np.uint32).astype(np.uint64)
    for p in range(n_props):
        if d[p] and not carry.disc_hit[p]:  # sticky first hit
            carry.disc_hit[p] = True
            carry.disc_fp[p] = (d[n_props + p] << np.uint64(32)) \
                | d[2 * n_props + p]
    stats.iterations += 1
    stats.vmax = max(stats.vmax, int(st[S_VALID]))
    stats.dmax = max(stats.dmax, int(st[S_DEDUP]))
    stats.cch += int(st[S_CCH])
    stats.rounds += int(st[S_ROUNDS])
    return st


def run_loop(model, carry: ChunkCarry, *, fmax: int, grow_limit: int,
             target_remaining: int, stats: LoopStats,
             steps: Optional[int] = None,
             grow: Optional[Callable[[], int]] = None) -> int:
    """Iterate :func:`step_once` while the JAX chunk loop's condition
    holds: rows pending, no overflow, the generation target not reached,
    not every property discovered. When the log reaches ``grow_limit`` or
    the queue has no headroom for one more append, ``grow()`` enlarges
    the carry and returns the new limit; without ``grow`` the loop stops
    there, as a JAX chunk does. ``steps`` bounds the iterations (one JAX
    chunk; ``None``: no bound). Returns the transitions generated."""
    fmax_small, _k, two_size = small_step_sizes(
        fmax, fmax * model.max_actions, model.max_actions)
    qmargin = max(fmax * model.max_actions, fmax)
    gen = iterations = 0
    while steps is None or iterations < steps:
        avail = carry.q_tail - carry.q_head
        if (avail <= 0 or carry.ovf or carry.xovf
                or gen >= target_remaining
                or (carry.disc_hit.size and carry.disc_hit.all())):
            break
        if (carry.log_n >= grow_limit
                or carry.q_tail > carry.q.shape[0] - qmargin):
            if grow is None:
                break
            grow_limit = grow()
            continue
        small = two_size and avail <= fmax_small
        st = step_once(model, carry, fmax_small if small else fmax, stats)
        stats.small_iterations += small
        gen += int(st[S_VALID])
        iterations += 1
    return gen
