"""The staged BFS step: K1 alone, then three kernels of its own.

Counterpart of the staged branch of the JAX package's chunk program,
``stateright_tpu/checker/device_loop.py:384`` (``make_step`` with
``fused=False``), which it runs for ``tpu_options(fused=False)`` and for
``sound_eventually()`` (the port refuses ``hint=``, the per-row pick of
``:461-495``: no workload of the repository sets it, and the JAX package
packs tighter without it). That step calls no Pallas
kernel: its expansion is the math inside the fused kernel, so on the card
the staged iteration launches K1 (``csrc/fused_step.cu``, the expand
kernel alone, ``srt_expand_<model>``) and then

  KS1 ``stage_kernel``    (``device_loop.py:398-495``, ``:510``) the
      stage-one compaction of K1's valid lanes to the ``kraw`` buffer in
      JAX's order: the global lane order (``shrink_indices(cvalid,
      kraw)``; lanes past ``kraw`` dropped); ``vcount``, ``kovf``; the
      sticky discovery candidates of the
      frontier (``discovery_candidates``) with node-key witnesses under
      sound, and the rows' parent node keys (``fp64_node_device`` of the
      cached fingerprint and the AT-ENQUEUE eventually-bits);
  KS2 ``predup_kernel``   (``ops/expand.py:122`` ``pre_dedup``,
      ``device_loop.py:512-538``) the exact in-batch dedup over the
      ``kraw`` lanes (under sound none: each lane's node key instead),
      ``dcount``, ``kovf`` when it passes ``kfin``, the stage-two
      compaction to ``kfin`` lanes and the insert mask ``kvalid & ~kovf``;
  K4 (``table_insert``, the flat insert) inserts the ``kfin`` keys;
  KS3 ``staged_append_kernel`` (``device_loop.py:522-632``, ``make_cond``
      at ``:352``) the inserted lanes' queue and log rows at the tail,
      under sound the cross edges (dedup hits whose child still has
      pending bits, as ``(parent node key, child node key)``) into the
      edge log, the carry update with the ``kovf`` abort (nothing
      committed: ``take`` and ``gen`` zeroed) and the next gate
      (``csrc/step_common.cuh`` ``eval_gate``, whose plain version is
      ``device_loop.gate_reference``).

The chunk starts with the fused chunk's ``chunk_begin_kernel``
(``csrc/chunk.cu``), whose gate has the staged terms.

This module holds the plain versions (``*_reference``): the JAX
package's step math in torch, lane for lane on the CPU, used by the CPU
path (``checker/device_loop.py`` ``staged_iteration_reference``) and by
the card's checks, and the plans and buffers both share. A chunk on CUDA
tensors launches the kernels of ``csrc/staged.cu`` (``ops/_cuda.py``,
``device_loop.StagedCard``); one on CPU tensors runs the plain versions.
Every buffer has the kernels' dtype and layout: int32 bit patterns, bool
masks.

The staged control vector ``sctl`` (int32, ``SC_*``) carries KS1's and
KS2's counts to KS3, which zeroes it with the step's stats vector. On the
card KS2 writes the ``kfin`` slots of stage two reversed (slot ``j`` at
index ``kfin - 1 - j`` of ``lane``, ``khi``, ``klo``, ``kvalid`` and so
of K4's ``inserted``) and KS3 reads them so: K4 marks the lowest index of
each fresh key, which is then the highest slot, the one the JAX package's
insert marks (``table_insert_reference``), so the card's queue and log
are the CPU's row for row. The plain versions take and give the slots in
order (:func:`reversed_slots` turns one layout into the other).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import Expectation
from .fused import S_DISC, S_FAULT, S_OVF, S_ROUNDS, S_VALID, S_XOVF
from .hash_kernel import fp64_node_device
from .words import u32, u64

# the staged control vector: KS1's valid lanes, the candidate-overflow
# flag, KS2's dedup survivors, and KS3's last inserted slot (the card's;
# 0 between steps)
(SC_VCOUNT, SC_KOVF, SC_DCOUNT, SC_LAST, SC_LEN) = range(5)

#: the most blocks of KS1's, KS2's and KS3's cooperative grids
#: (``csrc/staged.cu`` ``kMaxCoopBlocks``: ``StagedBuffers.bcount`` holds
#: two words a block)
COOP_BLOCKS = 256


class StagePlan(NamedTuple):
    """One staged step size: ``f`` frontier rows, the ``kraw`` lanes of
    stage one and the ``kfin`` lanes of stage two (the table insert and
    the appends)."""

    f: int
    kraw: int
    kfin: int


def staged_sizes(model, fmax: int, kraw: int, kmax: int) -> "tuple":
    """``(plans, qmargin)``: the plans of the small and large steps
    (``{1: small, 2: large}``, or ``{2: large}`` when one size serves)
    from the host's ``kraw`` and ``kmax`` as the JAX package's
    ``build_chunk_core`` derives them without a hint, and the queue rows
    one iteration needs past the tail (``max(kmax, fmax)``)."""
    from .expand import small_step_sizes
    a = model.max_actions
    fa = fmax * a
    kmax = min(kmax, fa)
    kraw = min(kraw, fa) if kraw else kmax
    kmax = min(kmax, kraw)
    f_small, kmax_small, two_size = small_step_sizes(fmax, kmax, a)
    plans = {2: StagePlan(fmax, kraw, kmax)}
    if two_size:
        kraw_small = min(f_small * a, kraw)
        plans[1] = StagePlan(f_small, kraw_small,
                             min(kmax_small, kraw_small))
    return plans, max(kmax, fmax)


def prop_kinds(properties) -> list:
    """Each property's kind as KS1 reads it: 0 ALWAYS, 1 SOMETIMES, 2
    EVENTUALLY."""
    return [0 if p.expectation == Expectation.ALWAYS
            else 1 if p.expectation == Expectation.SOMETIMES else 2
            for p in properties]


class StageOut(NamedTuple):
    """KS1's outputs (its plain version's)."""

    src: torch.Tensor     # int32[kraw] the lanes of stage one
    rvalid: torch.Tensor  # bool[kraw]  which of them are valid
    pkey: torch.Tensor    # int32[F, 2] the rows' node keys (sound)
    sctl: torch.Tensor    # int32[SC_LEN] with SC_VCOUNT, SC_KOVF
    disc: torch.Tensor    # int32[3P]   hit, witness hi, witness lo


def stage_reference(cvalid, pbits, terminal, ebits_out, ebits_in, phi,
                    plo, take: int, plan: StagePlan, kinds: list,
                    sound: bool) -> StageOut:
    """The plain version of KS1 over K1's outputs of an ``F``-row step
    (``cvalid`` bool ``[F*A]``; ``pbits`` bool ``[F, >=P]``;
    ``terminal`` bool ``[F]``; ``ebits_out`` the cleared eventually-bits
    and ``ebits_in``, ``phi``, ``plo`` the queue's columns of the rows,
    ``[F]``), ``take`` rows pending: JAX's stage one, its ``kovf`` and
    its discovery candidates (``discovery_candidates`` with the parents'
    node keys as witnesses under ``sound``)."""
    from ..checker.device_loop import shrink_indices
    dev = cvalid.device
    f = ebits_out.shape[0]
    kraw = plan.kraw
    vcount = int(cvalid.sum())
    kovf = vcount > kraw
    rvalid = torch.arange(kraw, device=dev) < vcount
    src = torch.where(rvalid, shrink_indices(cvalid, kraw), 0)
    if sound:
        k_hi, k_lo = fp64_node_device(phi, plo, ebits_in)
    else:
        k_hi, k_lo = u64(phi), u64(plo)
    pkey = torch.stack([u32(k_hi), u32(k_lo)], dim=1) if sound \
        else torch.zeros((f, 2), dtype=torch.int32, device=dev)
    n_props = len(kinds)
    disc = torch.zeros((3 * n_props,), dtype=torch.int64, device=dev)
    if n_props:
        fvalid = torch.arange(f, device=dev) < take
        eb = u64(ebits_out)
        flush = terminal & (eb != 0)
        for p, kind in enumerate(kinds):
            pb = pbits[:, p]
            mask = (fvalid & ~pb if kind == 0 else fvalid & pb if kind == 1
                    else flush & (((eb >> p) & 1) != 0))
            rows = torch.nonzero(mask)
            if rows.numel():
                r = int(rows[0, 0])
                disc[p] = 1
                disc[n_props + p] = int(k_hi[r])
                disc[2 * n_props + p] = int(k_lo[r])
    sctl = torch.zeros((SC_LEN,), dtype=torch.int32, device=dev)
    sctl[SC_VCOUNT], sctl[SC_KOVF] = vcount, int(kovf)
    return StageOut(src=src.to(torch.int32), rvalid=rvalid, pkey=pkey,
                    sctl=sctl, disc=u32(disc))


class PredupOut(NamedTuple):
    """KS2's outputs (its plain version's): the ``kfin`` lanes of stage
    two."""

    lane: torch.Tensor    # int32[kfin] each slot's lane of K1's step
    khi: torch.Tensor     # int32[kfin] its dedup key (node key if sound)
    klo: torch.Tensor
    kvalid: torch.Tensor  # bool[kfin]  the insert mask (kvalid & ~kovf)


def pre_dedup_arena_cells(lanes: int) -> int:
    """The arena of ``pre_dedup`` over ``lanes`` lanes (a power of two,
    at least ``2 * lanes - 1``)."""
    return 1 << max((2 * lanes - 1).bit_length(), 0)


def predup_reference(src, rvalid, chi, clo, ebits_out, n_actions: int,
                     plan: StagePlan, sctl, sound: bool) -> PredupOut:
    """The plain version of KS2 over KS1's ``src``/``rvalid`` and K1's
    ``chi``/``clo``/``ebits_out``: JAX's ``pre_dedup`` over the ``kraw``
    lanes (or each lane's node key under ``sound``), ``dcount`` and the
    overflow into ``sctl`` (in place), the stage-two compaction and the
    insert mask."""
    from ..checker.device_loop import shrink_indices
    from .expand import pre_dedup
    kraw, kfin = plan.kraw, plan.kfin
    dev = src.device
    lane = src.to(torch.int64)
    s_chi, s_clo = u64(chi)[lane], u64(clo)[lane]
    if sound:
        k_hi, k_lo = fp64_node_device(
            s_chi, s_clo, ebits_out[lane // n_actions])
        dvalid = rvalid
    else:
        dvalid = pre_dedup(s_chi, s_clo, rvalid)
        k_hi, k_lo = s_chi, s_clo
    dcount = int(dvalid.sum())
    kovf = bool(sctl[SC_KOVF]) or dcount > kfin
    sctl[SC_DCOUNT], sctl[SC_KOVF] = dcount, int(kovf)
    if kfin < kraw:
        src2 = shrink_indices(dvalid, kfin)
        lane, k_hi, k_lo = lane[src2], k_hi[src2], k_lo[src2]
        kvalid = torch.arange(kfin, device=dev) < dcount
    else:
        kvalid = dvalid.clone()
    kvalid = kvalid & (not kovf)
    return PredupOut(lane=lane.to(torch.int32), khi=u32(k_hi),
                     klo=u32(k_lo), kvalid=kvalid)


def staged_append_reference(ctr, layout, q, log, elog, pd: PredupOut,
                            inserted, flat, ebits_out, chi, clo, ohi, olo,
                            pkey, stats, sctl, n_actions: int, sound: bool,
                            f_small: int, f_large: int, qlimit: int,
                            elimit: int) -> None:
    """The plain version of KS3 after the step the gate picked: the
    inserted lanes' rows in slot order — queue ``[row, ebits, state fp]``
    at the gate's tail, log ``[dedup key, parent key(, original fp)]``
    at its log length (node keys under ``sound``), and under ``sound``
    with an edge log (``elog`` not ``None``) the cross edges at ``e_n``
    — then the carry update with JAX's ``kovf`` abort, the stats vector
    and ``sctl`` zeroed, and the next gate. A shut gate changes
    nothing."""
    from ..checker.device_loop import (B_DISC, B_DMAX, B_E_N, B_GEN,
                                       B_KOVF, B_LOG_N, B_OVF, B_PDH,
                                       B_PRB, B_Q_HEAD, B_Q_TAIL, B_VMAX,
                                       B_XOVF, E_FAULT, E_GATE, E_ITERS,
                                       E_SMALL, E_STEPS, E_TAG, G_LEN,
                                       gate_reference)
    x = layout.ext
    c = ctr.tolist()
    size, head, take, _tag, qbase, lbase = c[x + E_GATE:x + E_GATE + G_LEN]
    if not size:
        return
    w = layout.W
    st, sc = stats.tolist(), sctl.tolist()
    kovf = bool(sc[SC_KOVF])
    lane = pd.lane.to(torch.int64)
    row = lane // n_actions
    cnt = int(inserted.sum())
    if cnt:
        sel = torch.nonzero(inserted)[:, 0]
        ln, r = lane[sel], row[sel]
        if sound:
            pw = pkey[r].to(torch.int64)
            key = (pd.khi[sel], pd.klo[sel])
        else:
            pw = q[head + r, w + 1:w + 3]
            key = (chi[ln], clo[ln])
        cols = [flat[ln], ebits_out[r][:, None], chi[ln][:, None],
                clo[ln][:, None]]
        qrows = torch.cat([t.to(torch.int32) for t in cols], dim=1)
        lcols = [key[0][:, None], key[1][:, None], pw[:, 0:1], pw[:, 1:2]]
        if log.shape[1] == 6:
            lcols += [ohi[ln][:, None], olo[ln][:, None]]
        q[qbase:qbase + cnt] = qrows
        log[lbase:lbase + cnt] = torch.cat(
            [t.to(torch.int32) for t in lcols], dim=1)
        c[layout.recent:layout.cch] = qrows[-1].tolist()
    ecnt = 0
    if sound and elog is not None:
        ehit = pd.kvalid & ~inserted & (ebits_out[row] != 0)
        ecnt = int(ehit.sum())
        if ecnt:
            sel = torch.nonzero(ehit)[:, 0]
            erows = torch.cat([pkey[row[sel]], pd.khi[sel][:, None],
                               pd.klo[sel][:, None]], dim=1)
            en = c[B_E_N]
            elog[en:en + ecnt] = erows.to(torch.int32)
    valid, dcount = st[S_VALID], sc[SC_DCOUNT]
    c[B_Q_HEAD] = head + (0 if kovf else take)
    c[B_Q_TAIL] = qbase + cnt
    c[B_LOG_N] = lbase + cnt
    c[B_GEN] += 0 if kovf else valid
    c[B_OVF] |= int(st[S_OVF] != 0 and not kovf)
    c[B_XOVF] |= int(st[S_XOVF] != 0)
    c[B_KOVF] |= int(kovf)
    c[B_E_N] += ecnt
    c[x + E_FAULT] |= int(st[S_FAULT] != 0 or sc[SC_VCOUNT] != valid)
    c[B_VMAX] = max(c[B_VMAX], valid)
    c[B_DMAX] = max(c[B_DMAX], dcount)
    if not kovf:
        c[B_PDH] += valid - dcount
        c[B_PRB] += st[S_ROUNDS]
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
    stats.zero_()
    sctl.zero_()
    gate_reference(ctr, layout, f_small, f_large, qlimit, elimit=elimit)


class StagedBuffers(NamedTuple):
    """The staged step's buffers beside K1's (``ops/_cuda.py``
    ``step_buffers``), at the large plan's sizes; both sizes share
    them."""

    src: torch.Tensor      # int32[kraw] KS1: the lanes of stage one
    rvalid: torch.Tensor   # bool[kraw]  KS1: which are valid
    dvalid: torch.Tensor   # bool[kraw]  KS2: the pre-dedup survivors
    pkey: torch.Tensor     # int32[F, 2] KS1: the rows' node keys
    # the kfin slots of stage two, reversed (slot j at kfin - 1 - j):
    lane: torch.Tensor     # int32[kfin] KS2: the slots' lanes
    khi: torch.Tensor      # int32[kfin] KS2: their dedup keys
    klo: torch.Tensor
    kvalid: torch.Tensor   # bool[kfin]  KS2: the insert mask
    inserted: torch.Tensor  # bool[kfin] K4: the fresh slots
    sel: torch.Tensor      # int32[kfin] KS3: the fresh slots' indices
    sctl: torch.Tensor     # int32[SC_LEN]
    # KS2's pre-dedup cells (int64, all ones when made: each iteration's
    # claims carry its tag, so the arena is never cleared), KS1's and
    # KS2's per-block counts, KS1's lowest hit row of each property (all
    # ones between steps)
    arena: torch.Tensor    # int64[pre_dedup_arena_cells(kraw)]
    bcount: torch.Tensor   # int32[2 * COOP_BLOCKS]
    sdisc: torch.Tensor    # int32[32]


def staged_buffers(plan: StagePlan, device) -> StagedBuffers:
    """The staged buffers of ``plan`` (the large step's) on ``device``,
    ``sctl`` zeroed."""
    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    def b8(*shape):
        return torch.zeros(shape, dtype=torch.bool, device=device)

    return StagedBuffers(
        src=i32(plan.kraw), rvalid=b8(plan.kraw), dvalid=b8(plan.kraw),
        pkey=i32(plan.f, 2), lane=i32(plan.kfin), khi=i32(plan.kfin),
        klo=i32(plan.kfin), kvalid=b8(plan.kfin), inserted=b8(plan.kfin),
        sel=i32(plan.kfin), sctl=i32(SC_LEN),
        arena=torch.full((pre_dedup_arena_cells(plan.kraw),), -1,
                         dtype=torch.int64, device=device),
        bcount=i32(2 * COOP_BLOCKS),
        sdisc=torch.full((32,), -1, dtype=torch.int32, device=device))


def reversed_slots(pd: PredupOut, kfin: int) -> PredupOut:
    """The first ``kfin`` slots of a :class:`PredupOut` reversed: the
    plain version's order from the card buffers' (KS2 writes slot ``j``
    at index ``kfin - 1 - j``), or back."""
    return PredupOut(*(t[:kfin].flip(0) for t in pd))


__all__ = ["COOP_BLOCKS", "SC_DCOUNT", "SC_KOVF", "SC_LAST", "SC_LEN",
           "SC_VCOUNT", "PredupOut", "StageOut", "StagePlan",
           "StagedBuffers", "pre_dedup_arena_cells", "predup_reference",
           "prop_kinds", "reversed_slots", "stage_reference",
           "staged_append_reference", "staged_buffers", "staged_sizes"]
