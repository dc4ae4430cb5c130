"""The sharded device-resident BFS loop on ``torch.distributed``.

Counterpart of the fused branch of ``stateright_tpu/parallel/sharded.py``
(``_build_sharded_chunk_fn`` with ``fused=True``): fingerprint-prefix
ownership over one DeviceMesh dimension of ``D`` ranks.

  * Each rank owns a ``1/D`` slice of the append-only queue, the visited
    table and the (child fp, parent fp) log. A state is owned by the rank
    selected by the top ``log2 D`` bits of its fingerprint's hi word, so
    it is deduplicated and expanded by one rank only.
  * Each iteration every rank takes up to ``fmax`` pending rows and runs
    the probe-free step (``ops/fused.py`` ``fused_step(probe=False)``:
    expand, fingerprint, properties, in-batch dedup, the read-only
    cross-chunk ring), compacts the survivors to ``kmax`` lanes, routes
    them to their owners — one bucketed ``all_to_all`` (the default for
    ``D > 1``) or ``D`` ring hops — and each owner probes the lanes it
    received into its table slice (``probe_block``) and appends the
    fresh ones to its queue and log.
  * Three fused reductions per iteration (``pm1``, ``pm2``, ``ps``) keep
    every decision replicated, so all ranks take the same step and stop
    together: ``pm1`` gates the ``kovf`` abort before any mutation,
    ``pm2`` carries the loop condition's maxima and the probe overflow,
    ``ps`` the generated count and the lowest-rank discovery pick.

JAX runs this as ``lax.while_loop``s under ``shard_map``; here it is a
host loop of launches and collectives, in the shape of the single-chip
``checker/device_loop.py``. The host reads two small vectors per
iteration (two syncs): the reduced ``pm1`` (to abort without touching
anything) and, at the end, the append counts with ``pm2`` and ``ps``.
The carry is this rank's slice only; the queue, table, ring and log are
updated in place.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checker.device_loop import shrink_indices
from ..ops.expand import assemble_candidates, small_step_sizes
from ..ops.fused import (S_CCH, S_DEDUP, S_DISC, S_VALID, S_XOVF,
                         DedupWorkspace, StepWorkspace, _block_rows,
                         cc_ring_update, fused_step, probe_block)
from ..ops.hashtable import make_table
from ..ops.words import from_numpy_u32, u64

#: widest supported mesh axis (the JAX package's limit: its spill tier's
#: 8-bit prefix ranges must nest inside shard ownership)
MAX_MESH_SHARDS = 1 << 8


def owner_bits(d: int) -> int:
    """``log2 D``: the fingerprint bits that pick the owner rank."""
    if d < 1 or d & (d - 1):
        raise ValueError("mesh axis size must be a power of two")
    if d > MAX_MESH_SHARDS:
        raise ValueError(
            f"mesh axis of {d} ranks exceeds the {MAX_MESH_SHARDS}-rank "
            "limit of fingerprint-prefix ownership")
    return d.bit_length() - 1


def effective_kb(kmax: int, d: int, kb: int = 0) -> int:
    """Per-destination bucket rows of the bucketed exchange: ``kb``, or
    twice the even share of ``kmax`` (at least 1024, 256-aligned), never
    more than ``kmax``."""
    return min(kmax,
               kb or max(1 << 10, -(-(2 * kmax) // d // 256) * 256))


def owner_of(fp: int, d: int) -> int:
    """The rank owning a 64-bit fingerprint (its top ``log2 d`` bits)."""
    kbits = owner_bits(d)
    return (fp >> (64 - kbits)) if kbits else 0


def owner_rank(chi: torch.Tensor, kbits: int) -> torch.Tensor:
    """Owner rank (int64) of each fingerprint hi word (int32 bit
    patterns: masked to 32 bits first, so a set sign bit picks a high
    rank and not a negative one)."""
    if not kbits:
        return torch.zeros(chi.shape, dtype=torch.int64, device=chi.device)
    return u64(chi) >> (32 - kbits)


def bucket_send(cand: torch.Tensor, kvalid: torch.Tensor,
                owner: torch.Tensor, d: int, kb: int) -> torch.Tensor:
    """The bucketed exchange's send buffer ``[D*kb, C+1]``: valid lane
    ``i`` goes to row ``owner_i * kb + rank_i`` where ``rank_i`` is its
    rank among the valid lanes of the same owner (an exclusive one-hot
    cumsum); the extra last column is 1 on every filled row. Ranks at or
    past ``kb`` must have been ruled out by the caller (the ``kovf``
    gate)."""
    n, cols = cand.shape
    dev = cand.device
    oh = ((owner[:, None] == torch.arange(d, device=dev)[None, :])
          & kvalid[:, None]).to(torch.int64)
    rank = torch.cumsum(oh, 0).gather(1, owner[:, None])[:, 0] - 1
    dst = torch.where(kvalid, owner * kb + rank, d * kb)
    send = torch.zeros((d * kb + 1, cols + 1), dtype=torch.int32,
                       device=dev)
    send[dst] = torch.cat(
        [cand, torch.ones((n, 1), dtype=torch.int32, device=dev)], dim=1)
    return send[:d * kb]


@dataclass
class ShardedCarry:
    """This rank's slice of the search state. The loop scalars and the
    discovery registers (replicated: every rank holds the same) live on
    the host."""

    q: torch.Tensor          # int32[qloc, W+3] append-only queue slice
    q_head: int
    q_tail: int
    table: torch.Tensor      # int64[closc/4, 4] visited-table slice
    ring: Optional[torch.Tensor]  # int64[cc] recent-key ring, or None
    log: torch.Tensor        # int32[closc, 4] (child fp, parent fp)
    log_n: int
    disc_hit: np.ndarray     # bool[P]
    disc_fp: np.ndarray      # uint64[P]
    ovf: bool = False        # table probe overflow (any rank)
    xovf: bool = False       # model encoding overflow (any rank)
    kovf: bool = False       # candidate overflow: iteration aborted
    probe_ws: Optional[StepWorkspace] = None  # K6 state (CUDA only)
    dedup_ws: Dict[int, DedupWorkspace] = field(default_factory=dict)


@dataclass
class ShardedStats:
    """Counters of the sharded host loop (``profile()``)."""

    iterations: int = 0
    small_iterations: int = 0
    aborts: int = 0          # kovf iterations (nothing committed)
    syncs: int = 0           # device->host reads
    sync_s: float = 0.0
    vmax: int = 0            # most valid lanes on one rank in one step
    dmax: int = 0            # most deduplicated lanes on one rank
    bmax: int = 0            # most lanes bound for one owner
    cch: int = 0             # cross-chunk ring hits (all ranks)
    rounds: int = 0          # probe rounds (all ranks)
    pdh: int = 0             # in-batch duplicate lanes (all ranks)
    #: (vmax, dmax, bmax) of the last aborted iteration: what the abort
    #: handler widens the buffers to
    abort_sizes: Tuple[int, int, int] = (0, 0, 0)


@dataclass
class StepSizes:
    """The candidate widths of the sharded step (mutable: the ``kovf``
    handler widens them). ``kb`` is the option (0: the default share)."""

    d: int
    fmax: int
    kraw: int
    kmax: int
    kb: int = 0
    exchange: str = "bucket"

    @property
    def bucket(self) -> bool:
        return self.exchange == "bucket" and self.d > 1

    @property
    def kb_eff(self) -> int:
        return effective_kb(self.kmax, self.d, self.kb) if self.bucket \
            else 0

    @property
    def headroom(self) -> int:
        """Queue and log rows one iteration may append on one rank."""
        return max(self.d * self.kmax, self.fmax)

    def steps(self, n_actions: int) -> Tuple[Tuple[int, int],
                                             Tuple[int, int], bool]:
        """``((fmax, kfin), (fmax_small, kfin_small), two_size)``: the
        rows and the post-dedup width of the large and the small step,
        clamped as the JAX build clamps them."""
        fa = self.fmax * n_actions
        kmax = min(self.kmax, fa)
        kraw = min(self.kraw, fa) if self.kraw else kmax
        kmax = min(kmax, kraw)
        fs, kmax_small, two = small_step_sizes(self.fmax, kmax, n_actions)
        kraw_small = min(fs * n_actions, kraw)
        return (self.fmax, kmax), (fs, min(kmax_small, kraw_small)), two


def route_init(fps, d: int) -> List[List[int]]:
    """Indices of ``fps`` per owner rank, in order."""
    per: List[List[int]] = [[] for _ in range(d)]
    for i, fp in enumerate(fps):
        per[owner_of(int(fp), d)].append(i)
    return per


def seed_sharded_carry(model, d: int, rank: int, qcap: int, capacity: int,
                       init_rows, init_fps, full_ebits: int, cc: int,
                       device) -> ShardedCarry:
    """This rank's initial slice: the init states it owns enqueued (with
    their cached fingerprints), an empty table slice, log and ring. The
    caller inserts the init fingerprints the rank owns."""
    width = model.packed_width
    qloc, closc = qcap // d, capacity // d
    q = torch.zeros((qloc, width + 3), dtype=torch.int32, device=device)
    mine = route_init(init_fps, d)[rank]
    if len(mine) > qloc:
        raise RuntimeError("init states overflow a rank's queue")
    if mine:
        fps = np.asarray([int(init_fps[i]) for i in mine], np.uint64)
        block = np.concatenate(
            [np.stack([init_rows[i] for i in mine]).astype(np.uint32),
             np.full((len(mine), 1), full_ebits, np.uint32),
             (fps >> np.uint64(32)).astype(np.uint32)[:, None],
             fps.astype(np.uint32)[:, None]], axis=1)
        q[:len(mine)] = from_numpy_u32(block, device)
    n_props = len(model.properties())
    table = make_table(closc, device)
    return ShardedCarry(
        q=q, q_head=0, q_tail=len(mine), table=table,
        ring=(torch.zeros((cc,), dtype=torch.int64, device=device)
              if cc else None),
        log=torch.zeros((closc, 4), dtype=torch.int32, device=device),
        log_n=0, disc_hit=np.zeros(n_props, bool),
        disc_fp=np.zeros(n_props, np.uint64),
        probe_ws=(StepWorkspace(closc, 0, 0, device)
                  if table.is_cuda else None))


def rebuild_table(carry: ShardedCarry, capacity_local: int) -> torch.Tensor:
    """A fresh table slice of ``capacity_local`` slots holding this
    rank's logged fingerprints (every one distinct, every one owned
    here), inserted through the owner-side probe; returns its overflow
    flag as a 0-d tensor. Replaces ``carry.table`` and ``probe_ws``."""
    dev = carry.q.device
    carry.table = make_table(capacity_local, dev)
    carry.probe_ws = (StepWorkspace(capacity_local, 0, 0, dev)
                      if carry.table.is_cuda else None)
    ln = carry.log_n
    if not ln:
        return torch.zeros((), dtype=torch.bool, device=dev)
    _, ovf, _ = probe_block(carry.table, carry.log[:ln, 0],
                            carry.log[:ln, 1],
                            torch.ones((ln,), dtype=torch.bool, device=dev),
                            carry.probe_ws)
    return ovf


def _read(t: torch.Tensor, stats: ShardedStats) -> list:
    """One device->host read (a sync on the card)."""
    t0 = time.perf_counter()
    out = t.tolist()
    stats.sync_s += time.perf_counter() - t0
    stats.syncs += 1
    return out


def sharded_step_once(model, carry: ShardedCarry, grp, sizes: StepSizes,
                      fmax_b: int, kfin_b: int, stats: ShardedStats):
    """One iteration over up to ``fmax_b`` of this rank's pending rows.

    Returns ``(pavail, max_tail, max_log, gen)`` — the reduced pending,
    tail and log maxima of the loop condition and the transitions
    generated on all ranks — or ``None`` when the iteration aborted
    (``carry.kovf``: some rank's deduplicated lanes outran ``kfin_b``,
    or its lanes for one owner the bucket; nothing was committed)."""
    width = model.packed_width
    n_actions = model.max_actions
    d, me = grp.size, grp.rank
    kbits = owner_bits(d)
    n_props = carry.disc_hit.shape[0]
    dev = carry.q.device
    h = carry.q_head
    take = min(carry.q_tail - h, fmax_b)
    block = carry.q[h:h + fmax_b]
    fvalid = torch.arange(fmax_b, device=dev) < take
    ws = None
    if block.is_cuda:
        ws = carry.dedup_ws.get(fmax_b)
        if ws is None:
            ws = carry.dedup_ws[fmax_b] = DedupWorkspace(
                fmax_b * n_actions, _block_rows(fmax_b) * n_actions,
                0 if carry.ring is None else carry.ring.shape[0],
                n_props, dev)
    out = fused_step(model, block[:, :width], block[:, width], fvalid,
                     block[:, width + 1], block[:, width + 2], None,
                     carry.ring, ws, probe=False)
    st = out.stats.to(torch.int64)
    hit_l = st[S_DISC:S_DISC + n_props] != 0
    d_hi = u64(out.stats[S_DISC + n_props:S_DISC + 2 * n_props])
    d_lo = u64(out.stats[S_DISC + 2 * n_props:S_DISC + 3 * n_props])
    bucket = sizes.bucket
    kb = sizes.kb_eff
    if bucket:
        own_all = owner_rank(out.chi, kbits)
        per_dest = torch.zeros((d + 1,), dtype=torch.int64, device=dev)
        per_dest.scatter_add_(0, torch.where(out.dvalid, own_all, d),
                              torch.ones_like(own_all))
        bmax_it = per_dest[:d].max().reshape(1)
    else:
        bmax_it = torch.zeros((1,), dtype=torch.int64, device=dev)
    # pmax of (D-1 - rank) picks the LOWEST rank with a hit; -1: none
    negsel = torch.where(hit_l, d - 1 - me, -1)

    # --- fused reduction 1 of 3: what the abort gate needs
    pm1 = _read(grp.pmax(torch.cat([
        st[S_VALID:S_VALID + 1], st[S_DEDUP:S_DEDUP + 1],
        st[S_XOVF:S_XOVF + 1], bmax_it, negsel])), stats)
    vshard, dshard, xovf_any, bshard = pm1[:4]
    stats.vmax = max(stats.vmax, vshard)
    stats.dmax = max(stats.dmax, dshard)
    stats.bmax = max(stats.bmax, bshard)
    carry.xovf |= xovf_any > 0
    if dshard > kfin_b or (bucket and bshard > kb):
        carry.kovf = True  # before any mutation: retried after a resize
        stats.aborts += 1
        stats.abort_sizes = (vshard, dshard, bshard)
        return None

    lanes = fmax_b * n_actions
    if kfin_b < lanes:
        src = shrink_indices(out.dvalid, kfin_b)
        kvalid = torch.arange(kfin_b, device=dev) < st[S_DEDUP]
    else:
        src = torch.arange(lanes, device=dev)
        kvalid = out.dvalid
    ridx = src // n_actions
    cand, log_off = assemble_candidates(
        out.flat[src], out.ebits[ridx], out.chi[src], out.clo[src],
        block[:, width + 1][ridx], block[:, width + 2][ridx])
    cols = cand.shape[1]
    owner = owner_rank(cand[:, log_off], kbits)
    carry.q_head = h + take

    hops = []  # (received rows, inserted mask) per probe round
    t_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    rounds = torch.zeros((), dtype=torch.int64, device=dev)
    if bucket:
        recv = grp.all_to_all(bucket_send(cand, kvalid, owner, d, kb))
        ins, t_ovf, rounds = probe_block(
            carry.table, recv[:, log_off], recv[:, log_off + 1],
            recv[:, cols] == 1, carry.probe_ws)
        hops.append((recv, ins))
    else:
        # D hops around the ring; each rank claims the lanes it owns
        rc = torch.cat([cand, kvalid[:, None].to(torch.int32),
                        owner[:, None].to(torch.int32)], dim=1)
        for hop in range(d):
            mine = (rc[:, cols] != 0) & (rc[:, cols + 1] == me)
            ins, o, r = probe_block(carry.table, rc[:, log_off],
                                    rc[:, log_off + 1], mine,
                                    carry.probe_ws)
            hops.append((rc, ins))
            t_ovf = t_ovf | o
            rounds = rounds + r
            if hop < d - 1:
                rc = grp.ring_shift(rc)
    cnts = torch.stack([ins.sum() for _rows, ins in hops])
    srcs = [shrink_indices(ins, ins.shape[0]) for _rows, ins in hops]
    total = cnts.sum()

    # --- fused reductions 2 and 3 of 3: the loop condition's maxima and
    # the probe overflow in one pmax; the sums in one psum
    tail = carry.q_tail + total
    pm2 = grp.pmax(torch.stack([tail - carry.q_head, tail,
                                carry.log_n + total,
                                t_ovf.to(torch.int64)]))
    if carry.ring is not None:
        # staged and post-commit: ring entries stay a subset of the
        # committed visited set, so nothing is cached when some owner's
        # probe overflowed (its lanes were not all resolved)
        cc_ring_update(carry.ring, cand[:, log_off], cand[:, log_off + 1],
                       kvalid & (pm2[3] == 0))
    min_rank = d - 1 - torch.tensor(pm1[4:4 + n_props], dtype=torch.int64,
                                    device=dev)
    pick = hit_l & (min_rank == me)
    pdh_it = st[S_VALID] - st[S_DEDUP] - st[S_CCH]
    ps = grp.psum(torch.cat([
        torch.stack([st[S_VALID], pdh_it, rounds.to(torch.int64),
                     st[S_CCH]]),
        torch.where(pick, d_hi, 0), torch.where(pick, d_lo, 0)]))
    host = _read(torch.cat([cnts, pm2, ps]), stats)
    nh = len(hops)
    cnt_h, pm2_h, ps_h = host[:nh], host[nh:nh + 4], host[nh + 4:]

    for (rows, _ins), sidx, c in zip(hops, srcs, cnt_h):
        if c:
            new = rows[sidx[:c]]
            carry.q[carry.q_tail:carry.q_tail + c] = new[:, :width + 3]
            carry.log[carry.log_n:carry.log_n + c] = \
                new[:, log_off:log_off + 4]
            carry.q_tail += c
            carry.log_n += c
    carry.ovf |= pm2_h[3] > 0
    gen, pdh, prb, cch = ps_h[:4]
    stats.pdh += pdh
    stats.rounds += prb
    stats.cch += cch
    for p in range(n_props):
        if pm1[4 + p] >= 0 and not carry.disc_hit[p]:  # sticky first hit
            carry.disc_hit[p] = True
            carry.disc_fp[p] = np.uint64((ps_h[4 + p] << 32)
                                         | ps_h[4 + n_props + p])
    return pm2_h[0], pm2_h[1], pm2_h[2], gen


def run_sharded_loop(model, carry: ShardedCarry, grp, sizes: StepSizes, *,
                     grow_limit: int, target_remaining: int,
                     stats: ShardedStats,
                     grow: Optional[Callable[[], int]] = None,
                     resize: Optional[Callable[[], int]] = None,
                     steps: Optional[int] = None) -> int:
    """Iterate :func:`sharded_step_once` while the JAX sharded loop's
    condition (``go_from``) holds on the reduced maxima: rows pending on
    some rank, no overflow, the generation target not reached, not every
    property discovered, every rank's log below ``grow_limit`` and its
    queue one iteration from full. When growth is due, ``grow()``
    enlarges every rank's slice and returns the new limit; after an
    abort, ``resize()`` widens ``sizes`` and returns the new limit.
    Without them the loop stops there. The small step runs iff at most
    its rows are pending on every rank. Returns the transitions
    generated."""
    n_actions = model.max_actions
    pavail, max_tail, max_log = _read(grp.pmax(
        [carry.q_tail - carry.q_head, carry.q_tail, carry.log_n]), stats)
    gen = iterations = 0
    while steps is None or iterations < steps:
        if carry.ovf or carry.xovf:
            break
        if carry.kovf:
            if resize is None:
                break
            grow_limit = resize()
            carry.kovf = False
            continue
        if (pavail <= 0 or gen >= target_remaining
                or (carry.disc_hit.size and carry.disc_hit.all())):
            break
        if (max_log >= grow_limit
                or max_tail > carry.q.shape[0] - sizes.headroom):
            if grow is None:
                break
            grow_limit = grow()
            continue
        (f_large, k_large), (f_small, k_small), two = sizes.steps(n_actions)
        small = two and pavail <= f_small
        res = sharded_step_once(model, carry, grp, sizes,
                                f_small if small else f_large,
                                k_small if small else k_large, stats)
        iterations += 1
        if res is None:
            continue
        pavail, max_tail, max_log, g = res
        gen += g
        stats.iterations += 1
        stats.small_iterations += small
    return gen
