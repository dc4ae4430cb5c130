"""Frontier expansion, in-batch dedup and discovery selection in torch.

Counterpart of ``stateright_tpu/ops/expand.py`` without sound-eventually
node keys (not ported). These are the plain versions of what the step
kernel (``csrc/fused_step.cu``) computes; they compute in int64 holding
uint32 values (``ops/words.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..core import Expectation
from .hash_kernel import fp64_device
from .words import u64

#: thin-frontier knee: iterations with at most this many pending rows
#: take the small step (the JAX package's value, kept so the two engines
#: walk the same iterations)
FMAX_SMALL = 256


class Expansion(NamedTuple):
    pbits: torch.Tensor     # bool[F, P]    property bits per frontier row
    ebits: torch.Tensor     # int64[F]      eventually-bits after clearing
    flat: torch.Tensor      # int64[F*A, W] children (action-major per row)
    avalid: torch.Tensor    # bool[F, A]    per-(row, action) validity
    cvalid: torch.Tensor    # bool[F*A]     child validity
    chi: torch.Tensor       # int64[F*A]    child fingerprints (canonical
    clo: torch.Tensor       #               under symmetry reduction)
    phi: torch.Tensor       # int64[F]      frontier fingerprints
    plo: torch.Tensor       #               (canonical under symmetry)
    terminal: torch.Tensor  # bool[F]       rows with no valid action
    xovf: torch.Tensor      # bool[]        model encoding overflow
    # int64[F*A] child ORIGINAL-state fingerprints (chi/clo without
    # symmetry): recorded so witness paths replay through the states the
    # search really explored
    ohi: Optional[torch.Tensor] = None
    olo: Optional[torch.Tensor] = None


def eventually_indices(properties) -> list:
    return [i for i, p in enumerate(properties)
            if p.expectation == Expectation.EVENTUALLY]


def expand_frontier(model, frontier, fvalid, ebits,
                    eventually_idx: Sequence[int],
                    pfp: Optional[tuple] = None,
                    symmetry: bool = False) -> Expansion:
    """Evaluate properties and expand one frontier batch.

    ``pfp`` supplies the frontier fingerprints ``(hi, lo)`` from the
    queue's cache (the engine never re-hashes its frontier); without it
    they are computed. With ``symmetry`` the fingerprints are taken over
    ``model.packed_representative`` of each state (dedup works on
    canonical keys) while the children stay original rows and
    ``ohi``/``olo`` carry their own fingerprints; properties are
    evaluated on the original rows."""
    frontier = u64(frontier)
    fcount, width = frontier.shape
    pbits = model.packed_properties(frontier)
    ebits = u64(ebits)
    if eventually_idx:
        sat = torch.zeros_like(ebits)
        for i in eventually_idx:
            sat = sat | torch.where(pbits[:, i], 1 << i, 0)
        ebits = ebits & ~sat
    out = model.packed_step(frontier)
    if len(out) == 3:
        succ, avalid, aovf = out
        xovf = (aovf & fvalid[:, None]).any()
    else:
        succ, avalid = out
        xovf = torch.zeros((), dtype=torch.bool, device=frontier.device)
    avalid = avalid & fvalid[:, None]
    flat = succ.reshape(-1, width)
    if pfp is not None:
        phi, plo = u64(pfp[0]), u64(pfp[1])
    elif symmetry:
        phi, plo = fp64_device(model.packed_representative(frontier))
    else:
        phi, plo = fp64_device(frontier)
    if symmetry:
        chi, clo = fp64_device(model.packed_representative(flat))
        ohi, olo = fp64_device(flat)
    else:
        chi, clo = fp64_device(flat)
        ohi, olo = chi, clo
    terminal = fvalid & ~avalid.any(dim=1)
    return Expansion(pbits=pbits, ebits=ebits, flat=flat, avalid=avalid,
                     cvalid=avalid.reshape(-1), chi=chi, clo=clo,
                     phi=phi, plo=plo, terminal=terminal, xovf=xovf,
                     ohi=ohi, olo=olo)


def pre_dedup(chi, clo, cvalid):
    """Exact in-batch duplicate-lane mask: drop lanes whose fingerprint
    already appears at an earlier valid lane of the batch.

    One scatter-min arena keyed by fingerprint hash (the lowest lane wins
    a cell); a losing lane is dropped only when the winner's fingerprint
    verifies equal, so distinct keys colliding on a cell both survive."""
    fa = chi.shape[0]
    acells = 1 << max((2 * fa - 1).bit_length(), 0)
    dev = chi.device
    lane = torch.arange(fa, dtype=torch.int64, device=dev)
    slot = (clo ^ ((chi * 0x9E3779B9) & 0xFFFFFFFF)) & (acells - 1)
    slot = torch.where(cvalid, slot, acells)
    arena = torch.full((acells + 1,), fa, dtype=torch.int64, device=dev)
    arena.scatter_reduce_(0, slot, lane, reduce="amin")
    win = torch.clamp(arena[torch.clamp(slot, max=acells - 1)], max=fa - 1)
    dup = cvalid & (win != lane) & (chi[win] == chi) & (clo[win] == clo)
    return cvalid & ~dup


def discovery_candidates(properties, exp: Expansion, fvalid,
                         whi=None, wlo=None):
    """Per-property ``(hit, fp_hi, fp_lo)`` on the frontier batch:
    ALWAYS picks the first valid row where the condition is false,
    SOMETIMES the first where it holds, EVENTUALLY the first terminal
    row whose bit is still set."""
    if whi is None:
        whi, wlo = exp.phi, exp.plo
    n_props = len(properties)
    dev = fvalid.device
    if not n_props:
        z = torch.zeros((0,), dtype=torch.int64, device=dev)
        return torch.zeros((0,), dtype=torch.bool, device=dev), z, z
    kind = torch.tensor([0 if p.expectation == Expectation.ALWAYS
                         else 1 if p.expectation == Expectation.SOMETIMES
                         else 2 for p in properties], device=dev)
    pb = exp.pbits[:, :n_props]
    term_flush = exp.terminal & (exp.ebits != 0)
    ebit = ((exp.ebits[:, None]
             >> torch.arange(n_props, device=dev)) & 1).bool()
    masks = torch.where(
        kind[None, :] == 0, fvalid[:, None] & ~pb,
        torch.where(kind[None, :] == 1, fvalid[:, None] & pb,
                    term_flush[:, None] & ebit))
    hit = masks.any(dim=0)
    k = masks.to(torch.int8).argmax(dim=0)  # first maximal row
    return hit, whi[k], wlo[k]


def assemble_candidates(rows_k, ebits_k, s_chi, s_clo, pw_hi, pw_lo,
                        o_hi=None, o_lo=None):
    """The candidate-matrix column layout, from per-lane columns:

      [packed row (0..W-1) | child ebits (W) | state fp hi/lo (W+1, W+2)
       | parent fp hi/lo (W+3, W+4) | original fp hi/lo (W+5, W+6)]

    the last two only when ``o_hi``/``o_lo`` are given (symmetry
    reduction: the state fp is the canonical key, the original fp the
    enqueued row's own). The queue block is ``[:, :W+3]`` and the log
    block (child fp, parent fp[, original fp]) the slice from
    ``log_off``. Columns are int32 bit patterns; returns
    ``(cand, log_off)``."""
    width = rows_k.shape[1]
    cols = [rows_k, ebits_k[:, None], s_chi[:, None], s_clo[:, None],
            pw_hi[:, None], pw_lo[:, None]]
    if o_hi is not None:
        cols += [o_hi[:, None], o_lo[:, None]]
    cand = torch.cat([c.to(torch.int32) for c in cols], dim=1)
    return cand, width + 1


def small_step_sizes(fmax: int, kmax: int, n_actions: int):
    """The two-size (thin-frontier) step sizes shared by the single-chip
    and sharded loops: ``(fmax_small, kmax_small, two_size)``."""
    fmax_small = min(FMAX_SMALL, fmax)
    return (fmax_small, min(fmax_small * n_actions, kmax),
            fmax_small < fmax)


def kmax_default(model, fmax: int) -> int:
    """Default raw candidate width (``kraw``) of the sharded step: every
    raw-valid child lane of an iteration. Models that declare
    ``branching_hint`` (most valid children per state) get ``fmax*hint``
    with a 1/4 margin, others ``F*A/2`` (the JAX package's policy;
    sound-eventually node keys are not ported)."""
    fa = fmax * model.max_actions
    hint = getattr(model, "branching_hint", None)
    if hint:
        scale = 5 * fmax * hint // 4
        return min(fa, max(1 << 12, -(-scale // 256) * 256))
    return min(fa, max(1 << 12, fa // 2))


def kfinal_default(model, fmax: int) -> int:
    """Default post-dedup candidate width (``kmax``): the exchange, the
    owner-side probe and the appends run at this width — the halved
    hint, or ``F*A/8`` (the JAX package's policy)."""
    fa = fmax * model.max_actions
    hint = getattr(model, "branching_hint", None)
    if hint:
        scale = 5 * fmax * hint // 8
        return min(fa, max(1 << 12, -(-scale // 256) * 256))
    return min(fa, max(1 << 12, fa // 8))
