"""The BFS chunk on the device.

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
    search record the host mirrors lazily; under symmetry reduction the
    child and parent fps are canonical keys and two more columns hold
    the child's original fp hi, lo (the state the queue really holds);
  * the counter block ``ctr`` (int32, :class:`CtrLayout`): the loop
    scalars, the flags, the sticky first-hit discovery registers and the
    profile counters, in the JAX package's ``base_stats`` layout, then
    the port's own fields (steps left, the fault flag, the next step's
    tag, the chunk's parameters and the iteration's gate).

A chunk is up to ``chunk_steps`` iterations of the JAX package's loop,
each run only while its condition (``make_cond``) holds on the device.
Each iteration takes the small step (``FMAX_SMALL`` rows) iff at most
that many rows are pending, else the large one — the order the JAX
package's small/large/small window loops walk — runs the fused step and
appends exactly the inserted rows to the queue and the log. The loop
condition is evaluated where the counters last change: at the chunk's
start for its first iteration, after each append for the next. On the
card one iteration (K1-K3 of both sizes, each gated on the device, and
K7, the append, whose tail evaluates the next gate) is one CUDA graph,
captured once per carry allocation and replayed ``chunk_steps`` times;
the host copies the counter block once per chunk. On the CPU the same
iterations run the kernels' plain versions. Queue, table, ring, log and
counters are updated in place.

A model with host-evaluated properties (``host_property_indices``) adds
the history stage (:class:`HistoryStage`, the JAX package's
``ChunkCarry.hkey_hi/hkey_lo/hidx/h_n/hovf``): after each append the
rows it appended are deduplicated by the fingerprint of their
host-property columns (``host_property_cols``) against a history-key
table, and the queue index of each fresh key's first row is logged in
``hidx`` (K8, ``csrc/history.cu``, the graph's eighth node on the card;
:func:`history_reference` on the CPU). ``h_n`` and ``hovf`` ride the
counter block (``B_H_N``, ``B_HOVF``); an overflowing insert still
commits its iteration, sets ``hovf`` and shuts the gate, so the loop
stops after it (the host grows the table and rescans the span). After
each chunk the first ``HIST_WINDOW`` representatives logged since the
host's pulled count are gathered with their witness fingerprints (K9,
:func:`hpull_reference`) and copied with the counter block.

A run with ``fused=False`` or ``sound_eventually()`` takes the
staged step instead (:class:`Staged`, the JAX package's ``make_step``
with ``fused=False``; ``ops/staged.py``): K1 alone, the stage-one
compaction to ``kraw`` lanes (KS1), the in-batch dedup and stage two to
``kfin`` lanes (KS2), the masked table insert (K4) and the append (KS3,
which evaluates the next gate), with the JAX package's ``kovf`` abort:
an iteration whose lanes overflow a buffer commits nothing, sets
``kovf`` (``B_KOVF``; ``vmax`` and ``dmax`` ride the block)
and shuts the gate, and the host rebuilds with larger buffers. Under
sound the dedup keys are node keys (state fingerprint and pending
eventually-bits), the log has six columns (node key, parent node key,
the state's own fingerprint) and the edge log (``ChunkCarry.elog``,
``e_n`` at ``B_E_N``) takes the cross edges the lasso sweep needs. On
the card the staged iteration is one CUDA graph as well
(:class:`StagedCard`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.expand import (assemble_candidates, eventually_indices,
                          expand_frontier, small_step_sizes)
from ..ops.fused import (S_CCH, S_DEDUP, S_DISC, S_FAULT, S_INSERTED,
                         S_OVF, S_ROUNDS, S_VALID, S_XOVF, StepWorkspace,
                         fused_step, stats_len)
from ..ops.hash_kernel import fp64_device
from ..ops.hashtable import make_table, table_insert_reference
from ..ops.words import (from_numpy_u32, keys_from_numpy, keys_to_numpy,
                         pack64, to_numpy_u32)

# the counter block: the JAX package's base_stats fields (kovf and e_n
# are the staged step's, 0 on the fused one; rmax is the per-row hint's,
# which the port does not run: 0; h_n and hovf are the
# history stage's), then
# disc_hit[P], disc_hi[P], disc_lo[P], the most recent queue row (W + 3)
# and the ring hits (CtrLayout)
(B_Q_HEAD, B_Q_TAIL, B_LOG_N, B_GEN, B_OVF, B_XOVF, B_KOVF, B_H_N, B_HOVF,
 B_VMAX, B_DMAX, B_RMAX, B_E_N, B_PDH, B_PRB, B_DISC) = range(16)
# the port's fields from CtrLayout.ext: steps left in the chunk, the
# kernel-fault flag, the next step's tag, the chunk's iterations and small
# iterations, its target_remaining and grow_limit, then the gate
(E_STEPS, E_FAULT, E_TAG, E_ITERS, E_SMALL, E_TARGET, E_GROW,
 E_GATE) = range(8)
# the gate (csrc/step_common.cuh Gate): the step size the iteration runs
# (0 none, 1 small, 2 large), the queue head, the rows taken, the tag,
# and the queue tail and log length the append writes at
(G_SIZE, G_HEAD, G_TAKE, G_TAG, G_QBASE, G_LBASE, G_LEN) = range(7)

#: the largest int32: target_remaining and grow_limit are clamped to it
I32_MAX = 2**31 - 1


class CtrLayout(NamedTuple):
    """Offsets into the counter block of a model with ``P`` properties
    and packed width ``W``."""

    P: int
    W: int

    @property
    def recent(self) -> int:
        return B_DISC + 3 * self.P

    @property
    def cch(self) -> int:
        return self.recent + self.W + 3

    @property
    def ext(self) -> int:
        return self.cch + 1

    @property
    def length(self) -> int:
        return self.ext + E_GATE + G_LEN


#: representatives gathered with each chunk's counter block; more fresh
#: ones are pulled on their own (distinct histories grow far slower than
#: states)
HIST_WINDOW = 256


def history_rounds(hcap: int) -> int:
    """The history insert's probe-round bound (the JAX package's
    ``h_rounds``): a probe through foreign buckets advances one bucket a
    round, so the bucket count bounds it, with a margin for claim
    retries; reaching it reports ``hovf`` (the growth signal)."""
    return min(4096, hcap + 64)


@dataclass
class HistoryStage:
    """The history stage of a carry (models with host-evaluated
    properties): the history-key table (packed int64 keys, the visited
    table's layout), ``hidx`` (int32, the queue index of each distinct
    key's representative, ``h_n`` of them: ``ctr[B_H_N]``) and ``hdone``
    (int32[1], the queue rows already deduplicated: K8 takes the rows
    from there to the queue tail). The keys are the fingerprints of the
    rows' words ``[hoff, hoff + hwidth)``."""

    table: torch.Tensor
    hidx: torch.Tensor
    hdone: torch.Tensor
    hoff: int
    hwidth: int

    @property
    def hcap(self) -> int:
        return self.table.numel()

    @property
    def max_rounds(self) -> int:
        return history_rounds(self.hcap)


@dataclass
class ChunkCarry:
    """The search state, on the engine's device. The loop scalars live in
    ``ctr``; the properties below read them (a sync on the card)."""

    q: torch.Tensor          # int32[qcap, W+3] append-only queue
    table: torch.Tensor      # int64[cap/4, 4] visited table
    ring: Optional[torch.Tensor]  # int64[cc] recent-key ring, or None
    log: torch.Tensor        # int32[logcap, 4 or 6] (child fp, parent fp
    #                          [, child original fp] under symmetry)
    ctr: torch.Tensor        # int32[layout.length] the counter block
    layout: CtrLayout
    ws: Optional[StepWorkspace] = None  # kernel state (CUDA only)
    symmetry: bool = False   # dedup on packed_representative keys
    #: the card's chunk for this allocation (CardChunk), made on first
    #: use and dropped when a buffer is replaced
    card: object = field(default=None, repr=False)
    #: the history stage (models with host-evaluated properties)
    hist: Optional[HistoryStage] = None
    #: the staged step's edge log under sound (int32 [ecap, 4]: parent
    #: node key, child node key), ``e_n`` rows of it used (``B_E_N``)
    elog: Optional[torch.Tensor] = None

    def counters(self) -> np.ndarray:
        return self.ctr.cpu().numpy().copy()

    @property
    def q_head(self) -> int:
        return int(self.counters()[B_Q_HEAD])

    @property
    def q_tail(self) -> int:
        return int(self.counters()[B_Q_TAIL])

    @property
    def log_n(self) -> int:
        return int(self.counters()[B_LOG_N])


def disc_registers(c: np.ndarray, n_props: int):
    """``(hit bool[P], fingerprint uint64[P])`` from a counter block."""
    d = c[B_DISC:B_DISC + 3 * n_props].astype(np.uint32).astype(np.uint64)
    fp = (d[n_props:2 * n_props] << np.uint64(32)) | d[2 * n_props:]
    return d[:n_props] != 0, fp


@dataclass
class LoopStats:
    """Counters of the chunk loop (``GpuChecker.profile()``)."""

    chunks: int = 0
    syncs: int = 0           # device->host copies of a chunk's counters
    sync_s: float = 0.0      # host seconds blocked on them (sync_stall)
    capture_s: float = 0.0   # host seconds capturing the iteration graph
    captures: int = 0        # iteration graphs captured (one per carry)
    graph_launches: int = 0  # replays of the iteration graph
    iterations: int = 0
    small_iterations: int = 0
    vmax: int = 0            # most valid lanes in one step
    dmax: int = 0            # most lanes reaching the table in one step
    cch: int = 0             # cross-chunk ring hits
    rounds: int = 0          # probe rounds (see ops/hashtable.py)
    pdh: int = 0             # valid lanes the in-step dedup dropped


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


def _new_ctr(layout: CtrLayout, device, q_head: int = 0, q_tail: int = 0,
             log_n: int = 0, recent=None) -> torch.Tensor:
    ctr = np.zeros(layout.length, np.int64)
    ctr[B_Q_HEAD], ctr[B_Q_TAIL], ctr[B_LOG_N] = q_head, q_tail, log_n
    if recent is not None:
        ctr[layout.recent:layout.cch] = np.asarray(recent, np.uint32)
    return from_numpy_u32(ctr.astype(np.uint32), device)


def new_history(model, hcap: int, logcap: int, hdone: int,
                device) -> HistoryStage:
    """An empty history stage of ``hcap`` keys (a power of two >= 4)
    for a log of ``logcap`` rows, deduplicating queue rows from
    ``hdone`` on."""
    cols = getattr(model, "host_property_cols", None)
    hoff, hwidth = cols if cols is not None else (0, model.packed_width)
    return HistoryStage(
        table=make_table(hcap, device),
        hidx=torch.zeros((logcap,), dtype=torch.int32, device=device),
        hdone=torch.tensor([hdone], dtype=torch.int32, device=device),
        hoff=int(hoff), hwidth=int(hwidth))


def seed_carry(model, qcap: int, capacity: int, init_rows, init_ebits,
               init_fps, cc: int, device, symmetry: bool = False,
               hcap: int = 0, sound: bool = False,
               ecap: int = 0, table=None) -> ChunkCarry:
    """The initial carry: init states enqueued (with their
    eventually-bits — one value for all, or one per row, as a resumed
    frontier brings them — and their cached fingerprints: the canonical
    ones under ``symmetry``; state, not node, fingerprints under
    ``sound``), empty table, log (6 columns under ``symmetry`` or
    ``sound``), ring and, with ``ecap``, edge log. The caller inserts the
    known keys into the table. A spill's new epoch passes the evicted
    ``table`` (``capacity`` slots) to keep instead of an empty one."""
    width = model.packed_width
    q = torch.zeros((qcap, width + 3), dtype=torch.int32, device=device)
    k = len(init_rows)
    block = None
    if k:
        fps = np.asarray(init_fps, np.uint64)
        ebits = np.asarray(init_ebits, np.uint32).reshape(-1, 1)
        block = np.concatenate(
            [np.stack(init_rows).astype(np.uint32),
             np.broadcast_to(ebits, (k, 1)),
             (fps >> np.uint64(32)).astype(np.uint32)[:, None],
             fps.astype(np.uint32)[:, None]], axis=1)
        q[:k] = from_numpy_u32(block, device)
    n_props = len(model.properties())
    layout = CtrLayout(n_props, width)
    if table is None:
        table = make_table(capacity, device)
    elif table.numel() != capacity:
        raise ValueError(f"a kept table has {table.numel()} slots, the "
                         f"carry {capacity}")
    return ChunkCarry(
        q=q, table=table,
        ring=(torch.zeros((cc,), dtype=torch.int64, device=device)
              if cc else None),
        log=torch.zeros((capacity, 6 if symmetry or sound else 4),
                        dtype=torch.int32, device=device),
        ctr=_new_ctr(layout, q.device, q_tail=k,
                     recent=None if block is None else block[-1]),
        layout=layout,
        ws=(StepWorkspace(capacity, cc, n_props, table.device)
            if table.is_cuda else None), symmetry=symmetry,
        hist=(new_history(model, hcap, capacity, k, q.device)
              if hcap else None),
        elog=(torch.zeros((ecap, 4), dtype=torch.int32, device=device)
              if ecap else None))


def carry_from_numpy(carry, ring_hi, ring_lo, device="cpu") -> ChunkCarry:
    """The port's carry from the JAX package's: ``carry`` has the JAX
    ``ChunkCarry`` fields as numpy-convertible arrays (``q``, ``q_head``,
    ``q_tail``, bucket-major ``key_hi``/``key_lo``, ``log``, ``log_n``,
    ``disc_hit``/``disc_hi``/``disc_lo``, ``ovf``, ``xovf``); the ring
    halves ride beside it (``None`` for no ring). The table and ring
    halves become packed int64 keys; a 6-column log is a symmetric
    run's."""
    log = np.asarray(carry.log)
    q = np.asarray(carry.q)
    table = keys_from_numpy(np.asarray(carry.key_hi),
                            np.asarray(carry.key_lo), device)
    ring = (None if ring_hi is None
            else keys_from_numpy(np.asarray(ring_hi), np.asarray(ring_lo),
                                 device))
    n_props = np.asarray(carry.disc_hit).shape[0]
    layout = CtrLayout(n_props, q.shape[1] - 3)
    tail = int(carry.q_tail)
    ctr = _new_ctr(layout, "cpu", int(carry.q_head), tail, int(carry.log_n),
                   q[max(tail - 1, 0)])
    ctr[B_OVF], ctr[B_XOVF] = int(bool(carry.ovf)), int(bool(carry.xovf))
    disc = np.concatenate([np.asarray(carry.disc_hit, np.uint32),
                           np.asarray(carry.disc_hi, np.uint32),
                           np.asarray(carry.disc_lo, np.uint32)])
    ctr[B_DISC:B_DISC + 3 * n_props] = from_numpy_u32(disc, "cpu")
    return ChunkCarry(
        q=from_numpy_u32(q, device), table=table, ring=ring,
        log=from_numpy_u32(log, device), ctr=ctr.to(device), layout=layout,
        ws=(StepWorkspace(table.numel(), 0 if ring is None
                          else ring.shape[0], n_props, table.device)
            if table.is_cuda else None), symmetry=log.shape[1] == 6)


def carry_to_numpy(carry: ChunkCarry) -> dict:
    """Inverse of :func:`carry_from_numpy`: the JAX layout as numpy
    arrays (table and ring as uint32 hi/lo halves)."""
    key_hi, key_lo = keys_to_numpy(carry.table)
    c = carry.counters()
    n_props = carry.layout.P
    hit, fp = disc_registers(c, n_props)
    out = dict(q=to_numpy_u32(carry.q), q_head=int(c[B_Q_HEAD]),
               q_tail=int(c[B_Q_TAIL]), key_hi=key_hi, key_lo=key_lo,
               log=to_numpy_u32(carry.log), log_n=int(c[B_LOG_N]),
               disc_hit=hit, disc_hi=(fp >> np.uint64(32)).astype(np.uint32),
               disc_lo=fp.astype(np.uint32), ovf=bool(c[B_OVF]),
               xovf=bool(c[B_XOVF]), ring_hi=None, ring_lo=None)
    if carry.ring is not None:
        out["ring_hi"], out["ring_lo"] = keys_to_numpy(carry.ring)
    return out


# --- the plain versions of the chunk's kernels ---------------------------

def chunk_begin_reference(ctr, layout: CtrLayout, steps: int, target: int,
                          grow_limit: int, tag: int, f_small: int,
                          f_large: int, qlimit: int, stats=None,
                          elimit: int = I32_MAX) -> list:
    """The plain version of ``chunk_begin_kernel`` (``csrc/chunk.cu``):
    the chunk's parameters, the per-chunk counters zeroed (the JAX
    package's dispatch resets its carry's so), then the first
    iteration's gate (:func:`gate_reference`, returned)."""
    x = layout.ext
    for i in (B_GEN, B_VMAX, B_DMAX, B_PDH, B_PRB, layout.cch,
              x + E_ITERS, x + E_SMALL):
        ctr[i] = 0
    ctr[x + E_STEPS], ctr[x + E_TARGET] = steps, target
    ctr[x + E_GROW], ctr[x + E_TAG] = grow_limit, tag
    return gate_reference(ctr, layout, f_small, f_large, qlimit, stats,
                          elimit)


def gate_reference(ctr, layout: CtrLayout, f_small: int, f_large: int,
                   qlimit: int, stats=None, elimit: int = I32_MAX) -> list:
    """The plain version of ``eval_gate`` (``csrc/step_common.cuh``, run
    by ``chunk_begin_kernel``, K7's tail and KS3's): ``stats`` (the
    step's stats vector, when given) zeroed, the JAX package's
    ``make_cond`` on the counters — with the staged step's terms, no
    candidate overflow (``kovf``) and ``e_n <= elimit`` (the JAX
    package's ``e_n <= ecap - qmargin``; both hold on the fused chunk) —
    and the iteration's gate, written into ``ctr`` and returned (``G_*``
    order)."""
    if stats is not None:
        stats.zero_()
    c = ctr.tolist()
    x = layout.ext
    head, tail, log_n = c[B_Q_HEAD], c[B_Q_TAIL], c[B_LOG_N]
    avail = tail - head
    disc = c[B_DISC:B_DISC + layout.P]
    go = (avail > 0 and c[x + E_STEPS] > 0 and not c[B_OVF]
          and not c[B_XOVF] and not c[B_HOVF] and not c[x + E_FAULT]
          and c[B_GEN] < c[x + E_TARGET] and log_n < c[x + E_GROW]
          and tail <= qlimit and not (disc and all(disc))
          and not c[B_KOVF] and c[B_E_N] <= elimit)
    small = 0 < f_small and avail <= f_small
    f = f_small if small else f_large
    gate = [(1 if small else 2) if go else 0, head, min(avail, f),
            c[x + E_TAG], tail, log_n]
    ctr[x + E_GATE:x + E_GATE + G_LEN] = torch.tensor(gate,
                                                      dtype=torch.int32)
    return gate


def append_reference(ctr, layout: CtrLayout, q, log, out, n_actions: int,
                     f_small: int, f_large: int, qlimit: int) -> None:
    """The plain version of K7 (``csrc/chunk.cu``): the torch glue that
    followed each step — :func:`shrink_indices`, ``assemble_candidates``
    and the queue and log slice writes — over the step ``out`` (a
    ``FusedOut`` whose frontier was the queue rows from the gate's head),
    at the gate's queue tail and log length, then the carry update of
    the counter block (``ctr``, in place, with ``q`` and ``log``) and the
    next iteration's gate (:func:`gate_reference` at these step sizes and
    ``qlimit``, ``out.stats`` zeroed). A closed gate changes nothing."""
    x = layout.ext
    c = ctr.tolist()
    size, head, take, _tag, qbase, lbase = c[x + E_GATE:x + E_GATE + G_LEN]
    if not size:
        return
    w = layout.W
    st = out.stats.tolist()
    lanes = out.inserted.shape[0]
    cnt = int(out.inserted.sum())
    if cnt:
        src = shrink_indices(out.inserted, lanes)[:cnt]
        ridx = src // n_actions
        orig = ((out.ohi[src], out.olo[src]) if log.shape[1] == 6
                else (None, None))
        cand, log_off = assemble_candidates(
            out.flat[src], out.ebits[ridx], out.chi[src], out.clo[src],
            q[head + ridx, w + 1], q[head + ridx, w + 2], *orig)
        q[qbase:qbase + cnt] = cand[:, :w + 3]
        log[lbase:lbase + cnt] = cand[:, log_off:log_off + log.shape[1]]
        c[layout.recent:layout.cch] = cand[cnt - 1, :w + 3].tolist()
    c[B_Q_HEAD] = head + take
    c[B_Q_TAIL] = qbase + cnt
    c[B_LOG_N] = lbase + cnt
    c[B_GEN] += st[S_VALID]
    c[B_OVF] |= int(st[S_OVF] != 0)
    c[B_XOVF] |= int(st[S_XOVF] != 0)
    c[x + E_FAULT] |= int(st[S_FAULT] != 0 or st[S_INSERTED] != cnt)
    c[B_VMAX] = max(c[B_VMAX], st[S_VALID])
    c[B_DMAX] = max(c[B_DMAX], st[S_DEDUP])
    c[B_PDH] += st[S_VALID] - st[S_DEDUP] - st[S_CCH]
    c[B_PRB] += st[S_ROUNDS]
    c[layout.cch] += st[S_CCH]
    p_n = layout.P
    for p in range(p_n):
        if not c[B_DISC + p] and st[S_DISC + p]:  # sticky first hit
            c[B_DISC + p] = 1
            c[B_DISC + p_n + p] = st[S_DISC + p_n + p]
            c[B_DISC + 2 * p_n + p] = st[S_DISC + 2 * p_n + p]
    c[x + E_STEPS] -= 1
    c[x + E_TAG] += 1
    c[x + E_ITERS] += 1
    c[x + E_SMALL] += int(size == 1)
    ctr.copy_(torch.tensor(c, dtype=torch.int64).to(torch.int32))
    gate_reference(ctr, layout, f_small, f_large, qlimit, out.stats)


def first_lanes(key: torch.Tensor) -> torch.Tensor:
    """bool mask of the lowest lane of each distinct value of ``key``
    (int64 ``[n]``)."""
    n = key.shape[0]
    if not n:
        return torch.zeros((0,), dtype=torch.bool, device=key.device)
    _, inv = torch.unique(key, return_inverse=True)
    lane = torch.arange(n, dtype=torch.int64, device=key.device)
    first = torch.full((n,), n, dtype=torch.int64, device=key.device)
    first.scatter_reduce_(0, inv, lane, reduce="amin")
    return first[inv] == lane


def history_reference(q, hist: HistoryStage, rows: torch.Tensor):
    """The plain version of K8 (``csrc/history.cu``) over the queue rows
    ``rows`` (int64 ``[n]``, in order): key each row by the fingerprint
    of its words ``[hoff, hoff + hwidth)`` and insert the lowest row of
    each key not yet in ``hist.table`` (in place), within the JAX
    package's ``h_rounds`` bound. Returns ``(fresh bool[n],
    overflowed)``: ``fresh`` marks the inserted rows, the keys' new
    representatives. (The JAX package's insert keeps the highest lane of
    an in-batch duplicate group instead: the same keys and counts,
    another representative of the same history.)"""
    words = q[rows, hist.hoff:hist.hoff + hist.hwidth]
    hi, lo = fp64_device(words)
    lead = first_lanes(pack64(hi, lo))
    fresh, ovf = table_insert_reference(hist.table, hi, lo, lead,
                                        hist.max_rounds)
    return fresh, ovf


def history_range_reference(q, hist: HistoryStage, start: int, end: int,
                            h_n: int) -> "tuple":
    """:func:`history_reference` over the queue rows ``[start, end)``,
    each fresh row's queue index appended to ``hist.hidx`` at ``h_n``.
    Returns ``(h_n, overflowed)``."""
    rows = torch.arange(start, end, dtype=torch.int64, device=q.device)
    fresh, ovf = history_reference(q, hist, rows)
    reps = rows[fresh]
    hist.hidx[h_n:h_n + reps.shape[0]] = reps.to(torch.int32)
    return h_n + reps.shape[0], ovf


def history_step_reference(ctr, layout: CtrLayout, q,
                           hist: HistoryStage) -> None:
    """K8's pass in a chunk, plain: the rows from ``hist.hdone`` to the
    queue tail through :func:`history_range_reference` at ``h_n``
    (``ctr[B_H_N]``, advanced), ``hdone`` moved to the tail; an overflow
    sets ``ctr[B_HOVF]`` and shuts the next iteration's gate."""
    start, tail = int(hist.hdone[0]), int(ctr[B_Q_TAIL])
    if tail <= start:
        return
    h_n, ovf = history_range_reference(q, hist, start, tail,
                                       int(ctr[B_H_N]))
    ctr[B_H_N] = h_n
    hist.hdone[0] = tail
    if ovf:
        ctr[B_HOVF] = 1
        ctr[layout.ext + E_GATE + G_SIZE] = 0


def hpull_reference(q, hidx, log, start: int, count: int, n_init: int,
                    rows: int) -> torch.Tensor:
    """The plain version of K9 (``csrc/history.cu``): int32 ``[rows,
    W + 2]``, row ``i < min(count, rows)`` the queue row
    ``hidx[start + i]`` (its ``W`` packed words) and its witness
    fingerprint (the log's child key at ``hidx[start + i] - n_init``),
    the other rows zero."""
    w = q.shape[1] - 3
    out = torch.zeros((rows, w + 2), dtype=torch.int32, device=q.device)
    k = max(0, min(count, rows))
    if k:
        sel = hidx[start:start + k].to(torch.int64)
        out[:k, :w] = q[sel, :w]
        out[:k, w:] = log[sel - n_init, 0:2]
    return out


def history_regrow(q, hist: HistoryStage, h_n: int,
                   hcap: int) -> HistoryStage:
    """A history stage with a new table of ``hcap`` keys, seeded from
    the ``h_n`` logged representatives (K8 over ``hidx[:h_n]`` without
    appending, or its plain version); ``hidx`` and ``hdone`` carry over.
    Raises if even the new table overflows."""
    new = HistoryStage(table=make_table(hcap, q.device), hidx=hist.hidx,
                       hdone=hist.hdone, hoff=hist.hoff,
                       hwidth=hist.hwidth)
    if q.is_cuda:
        from ..ops import _cuda
        _h, ovf = _cuda.history_insert(q, new, index=hist.hidx[:h_n],
                                       append=False)
    else:
        _fresh, ovf = history_reference(q, new,
                                        hist.hidx[:h_n].to(torch.int64))
    if ovf:
        raise RuntimeError(
            "history-key table overflow while re-seeding after growth; "
            "raise gpu_options(hcap=...)")
    return new


def history_rescan(q, hist: HistoryStage, start: int, end: int,
                   h_n: int) -> "tuple":
    """After an in-chunk history overflow: deduplicate the queue rows
    ``[start, end)`` against the (grown) table, appending each fresh
    key's representative to ``hidx`` at ``h_n`` (K8 over the range, or
    its plain version). Returns ``(h_n, overflowed)``."""
    if end <= start:
        return h_n, False
    if q.is_cuda:
        from ..ops import _cuda
        return _cuda.history_insert(q, hist, start=start, end=end,
                                    append=True, h_n=h_n)
    return history_range_reference(q, hist, start, end, h_n)


def pull_representatives(q, hidx, log, start: int, count: int,
                         n_init: int) -> np.ndarray:
    """The ``count`` representatives logged from ``start`` on, as numpy
    uint32 ``[count, W + 2]`` (the packed rows, then the witness
    fingerprint halves): K9 on the card, its plain version here."""
    if count <= 0:
        return np.zeros((0, q.shape[1] - 1), np.uint32)
    if q.is_cuda:
        from ..ops import _cuda
        out = torch.empty((count, q.shape[1] - 1), dtype=torch.int32,
                          device=q.device)
        _cuda.hpull(q, hidx, log, start, n_init, out, count=count)
    else:
        out = hpull_reference(q, hidx, log, start, count, n_init, count)
    return to_numpy_u32(out)


def step_sizes(model, fmax: int):
    """``(f_small, f_large, qmargin)`` of the chunk at ``fmax`` rows:
    ``f_small`` 0 when one size serves (``fmax <= FMAX_SMALL``);
    ``qmargin`` the queue rows one iteration needs past the tail (the
    widest append and the frontier window)."""
    fmax_small, _k, two_size = small_step_sizes(
        fmax, fmax * model.max_actions, model.max_actions)
    return (fmax_small if two_size else 0, fmax,
            max(fmax * model.max_actions, fmax))


def iteration_reference(model, carry: ChunkCarry, fmax: int) -> bool:
    """One iteration of the chunk's plain version: when the gate (of
    the chunk's start or of the last append) picks a step, the step over
    its rows and K7's plain version, which leaves the next gate. Returns
    whether a step ran."""
    f_small, f_large, qmargin = step_sizes(model, fmax)
    x = carry.layout.ext + E_GATE
    size, head, take = carry.ctr[x + G_SIZE:x + G_TAKE + 1].tolist()
    if not size:
        return False
    f = f_small if size == 1 else f_large
    w = model.packed_width
    block = carry.q[head:head + f]
    fvalid = torch.arange(f, device=block.device) < take
    out = fused_step(model, block[:, :w], block[:, w], fvalid,
                     block[:, w + 1], block[:, w + 2], carry.table,
                     carry.ring, carry.ws, symmetry=carry.symmetry)
    append_reference(carry.ctr, carry.layout, carry.q, carry.log, out,
                     model.max_actions, f_small, f_large,
                     carry.q.shape[0] - qmargin)
    if carry.hist is not None:
        history_step_reference(carry.ctr, carry.layout, carry.q,
                               carry.hist)
    return True


class Staged(NamedTuple):
    """A chunk's staged step (``fused=False``, sound): the
    plans of its step sizes (``ops/staged.py`` ``staged_sizes``), the
    queue rows one iteration needs past the tail, node keys or not, and
    the edge log's rows (0: none)."""

    plans: dict
    qmargin: int
    sound: bool = False
    ecap: int = 0

    @property
    def f_small(self) -> int:
        return self.plans[1].f if 1 in self.plans else 0

    @property
    def f_large(self) -> int:
        return self.plans[2].f

    @property
    def elimit(self) -> int:
        """The most ``e_n`` may be before an iteration (the JAX package's
        ``e_n <= ecap - qmargin``)."""
        return self.ecap - self.qmargin if self.ecap else I32_MAX


def staged_iteration_reference(model, carry: ChunkCarry,
                               staged: Staged) -> bool:
    """One iteration of the staged chunk's plain version: when the gate
    picks a step, K1's plain version (``expand_frontier``) over its rows,
    then KS1, KS2, the insert and KS3's plain versions
    (``ops/staged.py``), which leave the next gate, and K8's when the
    carry has a history stage. Returns whether a step ran."""
    from ..ops.fused import (S_DISC, S_OVF, S_ROUNDS, S_VALID, S_XOVF,
                             stats_len)
    from ..ops.staged import (predup_reference, prop_kinds, stage_reference,
                              staged_append_reference)
    x = carry.layout.ext + E_GATE
    size, head, take = carry.ctr[x + G_SIZE:x + G_TAKE + 1].tolist()
    if not size:
        return False
    plan = staged.plans[size]
    f, w, a = plan.f, model.packed_width, model.max_actions
    properties = model.properties()
    block = carry.q[head:head + f]
    fvalid = torch.arange(f, device=block.device) < take
    exp = expand_frontier(model, block[:, :w], fvalid, block[:, w],
                          eventually_indices(properties),
                          pfp=(block[:, w + 1], block[:, w + 2]),
                          symmetry=carry.symmetry)
    stats = torch.zeros((stats_len(model),), dtype=torch.int32,
                        device=block.device)
    stats[S_VALID] = int(exp.cvalid.sum())
    stats[S_XOVF] = int(bool(exp.xovf))
    so = stage_reference(exp.cvalid, exp.pbits, exp.terminal, exp.ebits,
                         block[:, w], block[:, w + 1], block[:, w + 2],
                         take, plan, prop_kinds(properties), staged.sound)
    stats[S_DISC:S_DISC + 3 * len(properties)] = so.disc
    pd = predup_reference(so.src, so.rvalid, exp.chi, exp.clo, exp.ebits, a,
                          plan, so.sctl, staged.sound)
    inserted, t_ovf, rounds = table_insert_reference(
        carry.table, pd.khi, pd.klo, pd.kvalid, with_rounds=True)
    stats[S_OVF], stats[S_ROUNDS] = int(t_ovf), rounds
    staged_append_reference(
        carry.ctr, carry.layout, carry.q, carry.log, carry.elog, pd,
        inserted, exp.flat, exp.ebits, exp.chi, exp.clo, exp.ohi, exp.olo,
        so.pkey, stats, so.sctl, a, staged.sound, staged.f_small,
        staged.f_large, carry.q.shape[0] - staged.qmargin, staged.elimit)
    if carry.hist is not None:
        history_step_reference(carry.ctr, carry.layout, carry.q,
                               carry.hist)
    return True


# --- the chunk on the card -------------------------------------------------

class CardChunk:
    """The chunk on the card for one carry allocation and one ``fmax``:
    the step buffers both sizes share, K7's scan state, the chunk's
    arguments and the graph of one iteration — :meth:`launch_steps`
    (K1-K3 of the small size, when there is one, and of the large size,
    each gated) and :meth:`launch_append` (K7, which leaves the next
    gate) — captured after one launch of each with the gate shut."""

    def __init__(self, model, carry: ChunkCarry, fmax: int):
        from ..ops import _cuda
        dev = carry.q.device
        f_small, f_large, qmargin = step_sizes(model, fmax)
        n_actions = model.max_actions
        sms = _cuda.sm_count(dev)
        tiles = max(_cuda.tile_geometry(f, n_actions, sms).blocks
                    for f in (f_small, f_large) if f)
        self.bufs = _cuda.step_buffers(model, f_large, stats_len(model),
                                       carry.symmetry, dev, tiles)
        # new with each allocation, so no earlier launch's status word
        # matches a tile
        lanes = f_large * n_actions
        self.scratch = _cuda.append_scratch(
            lanes, _cuda.append_tile(lanes, sms, carry.layout.W), dev)
        lay = carry.layout
        self.args = _cuda.chunk_args(
            ctr=carry.ctr, bufs=self.bufs, q=carry.q, log=carry.log,
            scratch=self.scratch, qlimit=carry.q.shape[0] - qmargin,
            n_props=lay.P, width=lay.W, n_actions=n_actions,
            f_small=f_small, f_large=f_large, ext=lay.ext,
            recent=lay.recent, cch=lay.cch)
        self.device, self.fmax = dev, fmax
        self.sizes = {1: f_small, 2: f_large} if f_small else {2: f_large}
        # the carry's buffers, not the carry: the carry holds this object
        self._model = model
        self._step = (carry.q, carry.table, carry.ring, carry.ws,
                      carry.symmetry)
        self._gate_ptr = carry.ctr[lay.ext + E_GATE:].data_ptr()
        # the history stage (K8 in the graph, K9 after each chunk)
        self.hist = carry.hist
        self.window = self.hargs = self.hscratch = None
        if carry.hist is not None:
            # K8's scratch, for the most rows one iteration appends
            self.hscratch = _cuda.history_scratch(lanes, dev)
            self.hargs = _cuda.history_chunk_args(carry.ctr, lay.ext, carry.q,
                                                  carry.hist, self.hscratch)
            self.window = torch.zeros((HIST_WINDOW, lay.W + 2),
                                      dtype=torch.int32, device=dev)
        self._q, self._log, self._ctr = carry.q, carry.log, carry.ctr
        t0 = time.perf_counter()
        # every kernel once outside the capture (loads it, sets its
        # shared-memory limit), with no steps left: the gate stays shut
        self.begin(0, 0, 0, 0)
        self._record()
        torch.cuda.synchronize(dev)
        self.graph = _cuda.ChunkGraph(self._record, dev)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def begin(self, steps: int, target: int, grow_limit: int,
              tag: int) -> None:
        from ..ops import _cuda
        _cuda.chunk_begin(self.args, self.device, steps, target, grow_limit,
                          tag)

    def launch_steps(self) -> None:
        from ..ops import _cuda
        model = self._model
        q, table, ring, ws, symmetry = self._step
        w = model.packed_width
        for size, f in self.sizes.items():
            _cuda.fused_step(model, q[:f, :w], q[:f, w], None, q[:f, w + 1],
                             q[:f, w + 2], table, ring, ws,
                             stats_len(model), symmetry, bufs=self.bufs,
                             gate=self._gate_ptr, gate_size=size)

    def launch_append(self) -> None:
        from ..ops import _cuda
        _cuda.append(self.args, self.device)

    def launch_history(self) -> None:
        from ..ops import _cuda
        _cuda.history(self.hargs, self.device)

    def _record(self) -> None:
        self.launch_steps()
        self.launch_append()
        if self.hist is not None:
            self.launch_history()

    def pull_window(self, h_base: int, n_init: int) -> None:
        """K9: the first ``HIST_WINDOW`` representatives logged from
        ``h_base`` on (the count read from the counter block on the
        device) into ``self.window``."""
        from ..ops import _cuda
        _cuda.hpull(self._q, self.hist.hidx, self._log, h_base, n_init,
                    self.window, h_n=self._ctr[B_H_N:B_H_N + 1])

    def outputs(self, size: int):
        """The step outputs of the step size ``size`` (a ``FusedOut``
        over the shared buffers)."""
        from ..ops.fused import FusedOut
        f = self.sizes[size]
        lanes = f * self._model.max_actions
        b = self.bufs
        return FusedOut(
            pbits=b["pbits"][:f], ebits=b["ebits_out"][:f],
            terminal=b["terminal"][:f], flat=b["flat"][:lanes],
            chi=b["chi"][:lanes], clo=b["clo"][:lanes],
            cvalid=b["cvalid"][:lanes], dvalid=b["dvalid"][:lanes],
            inserted=b["inserted"][:lanes], stats=b["stats"],
            ohi=b["ohi"][:lanes], olo=b["olo"][:lanes])

    def run(self, steps: int, target: int, grow_limit: int,
            tag: int) -> None:
        """One chunk: its start, then ``steps`` replays of the graph."""
        self.begin(steps, target, grow_limit, tag)
        self.graph.replay(steps)


class StagedCard:
    """The staged chunk on the card for one carry allocation, one
    ``fmax`` and one :class:`Staged` (its plans): K1's buffers, the
    staged buffers (``ops/staged.py``), the chunk's arguments and the
    graph of one iteration — for each step size K1 alone, KS1, KS2 and
    K4 (each gated on the size the gate picked), then KS3 (which leaves
    the next gate) and K8 with a history stage — captured after one
    launch of each with the gate shut."""

    def __init__(self, model, carry: ChunkCarry, fmax: int, staged: Staged):
        from ..ops import _cuda
        from ..ops.fused import stats_len
        from ..ops.staged import staged_buffers
        dev = carry.q.device
        a = model.max_actions
        large = staged.plans[2]
        sms = _cuda.sm_count(dev)
        tiles = max(_cuda.tile_geometry(p.f, a, sms).blocks
                     for p in staged.plans.values())
        self.bufs = _cuda.step_buffers(model, large.f, stats_len(model),
                                       carry.symmetry, dev, tiles)
        self.sb = staged_buffers(large, dev)
        lay = carry.layout
        self.args = _cuda.staged_args(
            ctr=carry.ctr, stats=self.bufs["stats"], bufs=self.bufs,
            sb=self.sb, q=carry.q, log=carry.log, elog=carry.elog,
            plans=staged.plans, qlimit=carry.q.shape[0] - staged.qmargin,
            elimit=staged.elimit, model=model, layout=lay,
            sound=staged.sound)
        self.begin_args = _cuda.chunk_begin_args(
            ctr=carry.ctr, stats=self.bufs["stats"],
            qlimit=carry.q.shape[0] - staged.qmargin, n_props=lay.P, f_small=staged.f_small, f_large=staged.f_large,
            ext=lay.ext, cch=lay.cch)
        self.device, self.fmax, self.staged = dev, fmax, staged
        self._model = model
        self._carry_bufs = (carry.q, carry.table, carry.ws, carry.symmetry)
        self._gate_ptr = carry.ctr[lay.ext + E_GATE:].data_ptr()
        self.hist = carry.hist
        self.hargs = self.hscratch = self.window = None
        if carry.hist is not None:
            self.hscratch = _cuda.history_scratch(large.kfin, dev)
            self.hargs = _cuda.history_chunk_args(carry.ctr, lay.ext, carry.q,
                                                  carry.hist, self.hscratch)
            self.window = torch.zeros((HIST_WINDOW, lay.W + 2),
                                      dtype=torch.int32, device=dev)
        self._q, self._log, self._ctr = carry.q, carry.log, carry.ctr
        t0 = time.perf_counter()
        self.begin(0, 0, 0, 0)  # the gate shut: every kernel loads once
        self._record()
        torch.cuda.synchronize(dev)
        self.graph = _cuda.ChunkGraph(self._record, dev)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def begin(self, steps: int, target: int, grow_limit: int,
              tag: int) -> None:
        from ..ops import _cuda
        _cuda.chunk_begin(self.begin_args, self.device, steps, target,
                          grow_limit, tag, self.staged.elimit)

    def launch_size(self, size: int) -> None:
        """K1, KS1, KS2 and K4 of step size ``size``, gated."""
        from ..ops import _cuda
        from ..ops.fused import stats_len
        from ..ops.staged import pre_dedup_arena_cells
        model = self._model
        q, table, ws, symmetry = self._carry_bufs
        plan = self.staged.plans[size]
        w, f = model.packed_width, plan.f
        _cuda.expand_step(model, q[:f, :w], q[:f, w], None, q[:f, w + 1],
                          q[:f, w + 2], ws, stats_len(model), symmetry,
                          bufs=self.bufs, gate=self._gate_ptr,
                          gate_size=size)
        _cuda.stage(self.args, self.device, size)
        _cuda.predup(self.args, self.device, size,
                     pre_dedup_arena_cells(plan.kraw))
        sb, k = self.sb, plan.kfin
        _cuda.staged_insert(table, sb.khi[:k], sb.klo[:k], sb.kvalid[:k],
                            sb.inserted[:k], self.bufs["stats"], ws,
                            self._gate_ptr, size)

    def _record(self) -> None:
        from ..ops import _cuda
        for size in sorted(self.staged.plans):
            self.launch_size(size)
        _cuda.staged_append(self.args, self.device)
        if self.hist is not None:
            _cuda.history(self.hargs, self.device)

    def pull_window(self, h_base: int, n_init: int) -> None:
        """K9 (as :meth:`CardChunk.pull_window`)."""
        from ..ops import _cuda
        _cuda.hpull(self._q, self.hist.hidx, self._log, h_base, n_init,
                    self.window, h_n=self._ctr[B_H_N:B_H_N + 1])

    def run(self, steps: int, target: int, grow_limit: int,
            tag: int) -> None:
        """One chunk: its start, then ``steps`` replays of the graph."""
        self.begin(steps, target, grow_limit, tag)
        self.graph.replay(steps)


class PendingChunk:
    """A dispatched chunk: :meth:`read` returns its counter block (numpy
    int32), waiting for the card when it has to, and adds the chunk to
    the profile the first time."""

    def __init__(self, stats: LoopStats, layout: CtrLayout, counters=None,
                 buf=None, event=None, window=None, h_base: int = 0):
        self._stats, self._layout = stats, layout
        self._c, self._buf, self._event = counters, buf, event
        self._counted = False
        #: the representative window (numpy int32 [HIST_WINDOW, W + 2],
        #: a pinned buffer until read) and the h_n it starts at
        self._window, self.h_base = window, h_base

    def wait(self) -> None:
        """Wait for the counter block to reach the host (the chunk's one
        sync; the engine's watchdog bounds it), without counting it."""
        if self._c is None:
            t0 = time.perf_counter()
            self._event.synchronize()
            self._c = self._buf.numpy().copy()
            self._stats.sync_s += time.perf_counter() - t0

    def read(self) -> np.ndarray:
        st = self._stats
        self.wait()
        if not self._counted:
            self._counted = True
            c, lay = self._c, self._layout
            st.syncs += 1
            st.iterations += int(c[lay.ext + E_ITERS])
            st.small_iterations += int(c[lay.ext + E_SMALL])
            st.vmax = max(st.vmax, int(c[B_VMAX]))
            st.dmax = max(st.dmax, int(c[B_DMAX]))
            st.cch += int(c[lay.cch])
            st.rounds += int(c[B_PRB])
            st.pdh += int(c[B_PDH])
        return self._c

    def window(self) -> Optional[np.ndarray]:
        """The chunk's representative window (after :meth:`read`), or
        ``None`` without a history stage."""
        if self._window is not None and not isinstance(self._window,
                                                       np.ndarray):
            self._window = self._window.numpy().copy()
        return self._window


class ChunkRunner:
    """Runs chunks over one carry at ``fmax`` rows per large step, the
    fused step's or with ``staged`` (a :class:`Staged`) the staged one's.
    On the card each chunk is one start launch (``chunk_begin``),
    ``steps`` replays of the iteration graph (captured
    on first use and again after :meth:`invalidate`) and one copy of the
    counter block into one of two pinned host buffers, with an event; on
    the CPU the plain versions run at dispatch, and stop early once
    ``cancelled()`` holds (checked before each iteration). ``stats``
    gathers the profile."""

    def __init__(self, model, carry: ChunkCarry, fmax: int,
                 stats: Optional[LoopStats] = None, cancelled=None,
                 staged: Optional[Staged] = None):
        self.model, self.carry, self.fmax = model, carry, fmax
        #: the staged step's plans (None: the fused step); a new value
        #: (a kovf rebuild, a grown edge log) needs :meth:`invalidate`
        self.staged = staged
        self.stats = stats if stats is not None else LoopStats()
        self._cancelled = cancelled or (lambda: False)
        self._tag = 0   # the CPU path's tags (the card's: carry.ws.step)
        self._host = None
        self._turn = 0
        self._windows = None
        self._side = None  # the shadow's copy stream (card only)
        if carry.q.is_cuda:
            n = carry.layout.length
            self._host = [(torch.empty((n,), dtype=torch.int32,
                                       pin_memory=True),
                           torch.cuda.Event()) for _ in range(2)]
            if carry.hist is not None:
                self._windows = [torch.empty(
                    (HIST_WINDOW, carry.layout.W + 2), dtype=torch.int32,
                    pin_memory=True) for _ in range(2)]

    def invalidate(self) -> None:
        """The carry's buffers were replaced (growth), or its history
        stage was (grown or dropped): recapture."""
        self.carry.card = None

    def committed(self, t: torch.Tensor, start: int, end: int) -> np.ndarray:
        """Rows ``[start, end)`` of ``t`` (the queue, the log or the edge
        log: append-only) as numpy uint32, for the host shadow. Called
        after a chunk's sync, with ``end`` that chunk's tail: under the
        pipeline the next chunk is already appending past it, so on the
        card the rows are copied on a side stream, which waits for
        nothing on the stream the chunks run on, into pinned memory."""
        if end <= start:
            return np.zeros((0, t.shape[1]), np.uint32)
        if not t.is_cuda:
            return to_numpy_u32(t[start:end])
        if self._side is None:
            self._side = torch.cuda.Stream(t.device)
        host = torch.empty((end - start, t.shape[1]), dtype=t.dtype,
                           pin_memory=True)
        with torch.cuda.stream(self._side):
            host.copy_(t[start:end], non_blocking=True)
        self._side.synchronize()
        return host.numpy().view(np.uint32).copy()

    def card(self):
        """The carry's chunk on the card at this ``fmax`` (a
        :class:`CardChunk`, or a :class:`StagedCard` for a staged
        runner), captured now if the carry has none."""
        card = self.carry.card
        if card is None or card.fmax != self.fmax:
            if self.staged is not None:
                card = StagedCard(self.model, self.carry, self.fmax,
                                  self.staged)
            else:
                card = CardChunk(self.model, self.carry, self.fmax)
            self.carry.card = card
            self.stats.capture_s += card.capture_s
            self.stats.captures += 1
        return card

    def dispatch(self, steps: int, target_remaining: int = I32_MAX,
                 grow_limit: int = I32_MAX, h_base: int = 0,
                 n_init: int = 0) -> PendingChunk:
        """Launch one chunk of at most ``steps`` iterations under the
        JAX package's loop condition with these ``target_remaining``
        (generated transitions) and ``grow_limit`` (log rows). With a
        history stage the chunk also gathers the representative window
        from ``h_base`` (the host's pulled count; ``n_init`` the queue
        rows before the log's first)."""
        carry, st = self.carry, self.stats
        target = min(max(int(target_remaining), 0), I32_MAX)
        grow_limit = min(int(grow_limit), I32_MAX)
        st.chunks += 1
        if carry.ws is not None:   # tags above every one handed out
            tag = carry.ws.step + 1
            carry.ws.step += steps
        else:
            tag = self._tag + 1
            self._tag += steps
        if not carry.q.is_cuda:
            staged = self.staged
            if staged is not None:
                f_small, f_large = staged.f_small, staged.f_large
                qmargin, elimit = staged.qmargin, staged.elimit
            else:
                f_small, f_large, qmargin = step_sizes(self.model,
                                                       self.fmax)
                elimit = I32_MAX
            chunk_begin_reference(carry.ctr, carry.layout, steps, target,
                                  grow_limit, tag, f_small, f_large,
                                  carry.q.shape[0] - qmargin, elimit=elimit)
            for _ in range(steps):
                if self._cancelled():
                    break
                if not (staged_iteration_reference(self.model, carry, staged)
                        if staged is not None
                        else iteration_reference(self.model, carry,
                                                 self.fmax)):
                    break  # the condition stays false
            c = carry.counters()
            window = None
            if carry.hist is not None:
                window = hpull_reference(
                    carry.q, carry.hist.hidx, carry.log, h_base,
                    int(c[B_H_N]) - h_base, n_init, HIST_WINDOW).numpy()
            return PendingChunk(st, carry.layout, c, window=window,
                                h_base=h_base)
        card = self.card()
        card.run(steps, target, grow_limit, tag)
        st.graph_launches += steps
        buf, event = self._host[self._turn]
        window = None
        if card.hist is not None:
            card.pull_window(h_base, n_init)
            window = self._windows[self._turn]
            window.copy_(card.window, non_blocking=True)
        self._turn ^= 1
        buf.copy_(carry.ctr, non_blocking=True)
        event.record()
        return PendingChunk(st, carry.layout, buf=buf, event=event,
                            window=window, h_base=h_base)


def run_chunk(model, carry: ChunkCarry, *, fmax: int, steps: int,
              target_remaining: int = I32_MAX, grow_limit: int = I32_MAX,
              stats: Optional[LoopStats] = None) -> np.ndarray:
    """Run one chunk of at most ``steps`` iterations at ``fmax`` rows per
    large step and return its counter block (numpy int32, ``B_*`` /
    :class:`CtrLayout`): one sync."""
    return ChunkRunner(model, carry, fmax, stats).dispatch(
        steps, target_remaining, grow_limit).read()
