"""The fused BFS step: expand -> fingerprint -> dedup -> table claim,
and the sharded engine's owner-side probe.

Counterpart of ``stateright_tpu/ops/fused.py`` in the configurations the
port's engines run: ``build_fused_block_fn`` with ``probe=True``
(single chip: properties in the kernel, cross-chunk ring on) and with
``probe=False`` (the sharded step: no table, the ring read only), each
with and without ``symmetry`` (dedup on the fingerprint of
``packed_representative`` of each child, the original fingerprint kept
in ``ohi``/``olo`` for the log), and ``build_probe_block_fn``
(:func:`probe_block`).

:func:`fused_step` is the wrapper: for CUDA tensors it launches the
hand-written kernels of ``csrc/fused_step.cu`` (expand, claim, commit)
through ``ops/_cuda.py``, or raises; for CPU tensors it runs
:func:`fused_step_reference`, the plain version: the JAX package's
``_staged_block`` math over the same sequential blocks of up to 256
frontier rows, carrying table, ring and discovery registers from block
to block, lane for lane equal to the Pallas kernel on the CPU. With
``probe=False`` the wrapper launches the probe-free kernels of
``csrc/sharded_step.cu`` (expand; a dedup of each block tile in shared
memory, the ring probe and a step-wide dedup of the tile winners; a
commit over the claimed keys) instead; the plain version runs the same
blocks without the table insert and the ring update. With ``symmetry=True`` the
wrappers launch the symmetric instantiations of the same kernels (the
expand kernel also canonicalizes and hashes each child twice); the plain
version runs ``expand_frontier(symmetry=True)`` over the same blocks.

Both update the visited table and the ring IN PLACE (the carried buffers
are the engine's; a functional copy would move the whole table every
step) and return the per-step outputs as a :class:`FusedOut`.

Kernel and plain version agree on the SET gate (the same inserted key
set with one lane per key, the same table key set, discoveries and
overflow flags; lane-exact successors, fingerprints, validity, property
bits, eventually-bits and terminal rows). ``dvalid``, the ring-hit count
and the round count depend on how the work is split and are reported,
not compared: the kernel sees no ring entry written in the same step,
runs JAX's in-batch pre-dedup only as a dedup of each block tile (its
claim resolves the rest), and counts the most rounds one lane took. The
probe-free kernel and its plain version agree lane for lane on
everything but ``dvalid`` (and ``inserted``, its alias) and the ring-hit
count: the kernel's ``dvalid`` keeps one lane per key (the lowest that
survives the ring), where the plain version keeps one per key and
block, so it is held to the plain version's key set; its ring-hit count
(``S_CCH``) counts the tile winners (one per key and tile) whose key the
ring holds, where the plain version counts the lanes that survive the
pre-dedup.

:func:`probe_block` inserts the lanes a rank received in the exchange
into its table slice: on a CUDA table the flat insert of
``csrc/step_common.cuh`` through ``csrc/sharded_step.cu`` (the lowest
received lane of each fresh key is inserted; the same kernel as the
stand-alone insert, ``ops/hashtable.py`` ``table_insert``), on a CPU
table :func:`probe_block_reference`, the JAX package's ``table_insert``
round for round.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import Expectation
from .expand import (discovery_candidates, eventually_indices,
                     expand_frontier, pre_dedup)
from .hashtable import start_bucket, table_insert_reference
from .words import pack64, u32

#: frontier rows per block of the plain version: the largest of these
#: dividing the step's frontier width
_BLOCK_ROWS = (256, 128, 64, 32, 16, 8, 4, 2, 1)

#: default cross-chunk dedup ring slots (``gpu_options(cc_dedup=True)``)
CC_DEFAULT = 1 << 15

# the step's stats vector (int32): these scalars, then disc_hit[P],
# disc_hi[P], disc_lo[P] (fingerprint halves as int32 bit patterns).
# S_FAULT is set by a commit kernel that finds a claim whose owner word is
# not its step's (a kernel fault: the host loops raise); the plain
# version leaves it 0
(S_XOVF, S_OVF, S_ROUNDS, S_CCH, S_VALID, S_DEDUP, S_INSERTED, S_FAULT,
 S_DISC) = range(9)


class FusedOut(NamedTuple):
    """One fused step over an ``F``-row frontier (uint32 words as int32
    bit patterns)."""

    pbits: torch.Tensor     # bool[F, max(P, 1)] property bits per row
    ebits: torch.Tensor     # int32[F]   eventually-bits after clearing
    terminal: torch.Tensor  # bool[F]    rows with no valid action
    flat: torch.Tensor      # int32[F*A, W] children (action-major)
    chi: torch.Tensor       # int32[F*A] child fingerprint halves (the
    clo: torch.Tensor       #            canonical key under symmetry)
    cvalid: torch.Tensor    # bool[F*A]  valid child lanes
    dvalid: torch.Tensor    # bool[F*A]  lanes that reached the table
    inserted: torch.Tensor  # bool[F*A]  fresh-key lanes, one per key
    stats: torch.Tensor     # int32[8 + 3P] (S_* layout)
    # int32[F*A] the children's own (original-state) fingerprints: the
    # same tensors as chi/clo without symmetry reduction
    ohi: Optional[torch.Tensor] = None
    olo: Optional[torch.Tensor] = None


def supports(model, *, sound: bool, host_props: bool) -> Optional[str]:
    """``None`` when the fused step covers this configuration, else why
    it does not."""
    if sound:
        return ("sound_eventually dedups on (state, ebits) node keys "
                "and logs cross edges — not ported")
    if host_props:
        return ("host-evaluated properties need the in-loop history "
                "dedup — not ported")
    return None


def _block_rows(fmax_b: int) -> int:
    return next(d for d in _BLOCK_ROWS if fmax_b % d == 0)


def _cc_slot(chi, clo, cc: int):
    """Direct-mapped ring slot per lane: the visited table's bucket hash
    over ``cc`` slots."""
    return start_bucket(chi, clo, cc)


def cc_ring_update(ring, chi, clo, mask) -> None:
    """Write the ``mask``-ed lanes' keys into their ring slots IN PLACE,
    one winner per contested slot (the lowest lane, by a scatter-min
    arena). Every lane writes its slot's outcome — the winner's key, or
    the slot's old value where no lane won it — so the scatter needs no
    boolean indexing (no host sync on the card)."""
    cc = ring.shape[0]
    lanes = chi.shape[0]
    if not lanes:
        return
    lane = torch.arange(lanes, dtype=torch.int64, device=ring.device)
    slot = _cc_slot(chi, clo, cc)
    arena = torch.full((cc + 1,), lanes, dtype=torch.int64,
                       device=ring.device)
    arena.scatter_reduce_(0, torch.where(mask, slot, cc), lane,
                          reduce="amin")
    win = arena[slot]
    keys = pack64(chi, clo)
    ring.scatter_(0, slot, torch.where(win < lanes,
                                       keys[win.clamp(max=lanes - 1)],
                                       ring[slot]))


def stats_len(model) -> int:
    return S_DISC + 3 * len(model.properties())


def property_masks(model) -> dict:
    """Bitmask of property indices per expectation (the kernel's view of
    ``model.properties()``)."""
    return {e: sum(1 << i for i, p in enumerate(model.properties())
                   if p.expectation == e) for e in Expectation}


def fused_step(model, frontier, ebits, fvalid, phi, plo, table,
               ring=None, ws=None, probe: bool = True,
               symmetry: bool = False) -> FusedOut:
    """One fused step over ``frontier`` (int32 ``[F, W]``, any row
    stride; ``ebits``/``phi``/``plo`` int32 ``[F]``, the queue's cached
    eventually-bits and fingerprints; ``fvalid`` bool ``[F]``) against
    ``table`` (int64 ``[C/4, 4]``) and ``ring`` (int64 ``[cc]`` or
    ``None``), both updated in place. CUDA tensors launch the kernels
    (``ws`` carries their state — a :class:`StepWorkspace`, or with
    ``probe=False`` a :class:`DedupWorkspace` of at least the step's
    lanes; a fresh one is made when omitted); CPU tensors run
    :func:`fused_step_reference`.

    ``probe=False`` is the sharded engine's step: no table (``table`` is
    ignored), the ring read only, ``inserted`` aliasing ``dvalid``.
    ``symmetry=True`` dedups on the fingerprints of
    ``model.packed_representative`` of the children (``chi``/``clo``;
    ``phi``/``plo`` are then the frontier's canonical fingerprints) and
    returns the children's own in ``ohi``/``olo``."""
    if frontier.is_cuda and not probe:
        from . import _cuda
        if ws is None:
            ws = DedupWorkspace(frontier.shape[0] * model.max_actions,
                                0 if ring is None else ring.shape[0],
                                len(model.properties()), frontier.device)
        return FusedOut(*_cuda.fused_step_noprobe(
            model, frontier, ebits, fvalid, phi, plo, ring, ws,
            stats_len(model), symmetry))
    if frontier.is_cuda:
        from . import _cuda
        if ws is None:
            ws = StepWorkspace(table.numel(),
                               0 if ring is None else ring.shape[0],
                               len(model.properties()), frontier.device)
        return FusedOut(*_cuda.fused_step(
            model, frontier, ebits, fvalid, phi, plo, table, ring, ws,
            stats_len(model), symmetry))
    return fused_step_reference(model, frontier, ebits, fvalid, phi, plo,
                                table, ring, probe=probe, symmetry=symmetry)


class StepWorkspace:
    """Kernel state that outlives one step (CUDA only): per table slot
    the owner word of the winner rule (``csrc/step_common.cuh``), the
    ring arena, the discovery candidates, and the step counter that tags
    the owner words. The steps (K2/K3) and the masked flat inserts into
    the same table (K4 when its mask is asked for, K6 on a sharded slice)
    share it, so one counter tags them all; ``step`` is never below a
    tag handed out (a chunk on the card takes its steps' tags from its
    counter block, from ``step + 1``, and adds ``chunk_steps`` to it).
    One per table: growth makes a new one."""

    def __init__(self, capacity: int, cc: int, n_props: int, device):
        self.owner = torch.full((capacity,), -1, dtype=torch.int64,
                                device=device)
        self.ring_arena = torch.empty((max(cc, 1),), dtype=torch.int64,
                                      device=device)
        self.disc_cand = torch.full((max(n_props, 1),), -1,
                                    dtype=torch.int64, device=device)
        self.step = 0
        self.n_claims = None  # the last step's claims per tile
        # the last owner-side probe's stats vector (S_* layout): the
        # sharded loop reads its S_FAULT
        self.insert_stats = None

    def check(self, capacity: int, cc: int, n_props: int, device) -> None:
        if (self.owner.shape[0] != capacity
                or self.ring_arena.shape[0] < cc
                or self.disc_cand.shape[0] < n_props
                or self.owner.device != device):
            raise ValueError("StepWorkspace does not match this table, "
                             "ring or model")


class DedupWorkspace:
    """Kernel state of the probe-free step (CUDA only) for steps of up to
    ``lanes`` lanes: the step-wide key arena (>= 2 cells per lane), zeroed
    here once and left zero by every step (each claimed cell is cleared by
    its claim's commit), its owner words, the ring arena K1 resets, the
    discovery candidates, and the step counter that tags them."""

    def __init__(self, lanes: int, cc: int, n_props: int, device):
        self.lanes = lanes
        cells = 1 << max((2 * lanes - 1).bit_length(), 1)
        self.arena = torch.zeros((cells,), dtype=torch.int64, device=device)
        self.arena_owner = torch.full((cells,), -1, dtype=torch.int64,
                                      device=device)
        self.ring_arena = torch.empty((max(cc, 1),), dtype=torch.int64,
                                      device=device)
        self.disc_cand = torch.full((max(n_props, 1),), -1,
                                    dtype=torch.int64, device=device)
        self.step = 0
        self.n_claims = None  # the last step's claims per tile

    def check(self, lanes: int, device) -> None:
        if lanes > self.lanes or self.arena.device != device:
            raise ValueError("DedupWorkspace does not match this step")


def fused_step_reference(model, frontier, ebits, fvalid, phi, plo, table,
                         ring=None, probe: bool = True,
                         symmetry: bool = False) -> FusedOut:
    """The plain version of :func:`fused_step` (any device): the JAX
    package's fused block math, block by block. ``probe=False`` skips
    the table insert and the ring update, so every block reads the ring
    as it stood when the step began; ``symmetry`` expands with
    ``expand_frontier(symmetry=True)``."""
    f, width = frontier.shape
    properties = model.properties()
    n_props = len(properties)
    ev_idx = eventually_indices(properties)
    fb = _block_rows(f)
    dev = frontier.device
    d_hit = torch.zeros((n_props,), dtype=torch.bool, device=dev)
    d_hi = torch.zeros((n_props,), dtype=torch.int64, device=dev)
    d_lo = torch.zeros_like(d_hi)
    xovf = ovf = False
    rounds = cch = 0
    parts = []
    for b in range(0, f, fb):
        rows = slice(b, b + fb)
        fv = fvalid[rows]
        exp = expand_frontier(model, frontier[rows], fv, ebits[rows],
                              ev_idx, pfp=(phi[rows], plo[rows]),
                              symmetry=symmetry)
        dvalid = pre_dedup(exp.chi, exp.clo, exp.cvalid)
        if ring is not None:
            # an exact ring match is a key an earlier step (or block)
            # committed: kill the lane before it costs a table probe
            slot = _cc_slot(exp.chi, exp.clo, ring.shape[0])
            hit = dvalid & (ring[slot] == pack64(exp.chi, exp.clo))
            cch += int(hit.sum())
            dvalid = dvalid & ~hit
        if probe:
            inserted, b_ovf, b_rounds = table_insert_reference(
                table, exp.chi, exp.clo, dvalid, with_rounds=True)
            if ring is not None:
                cc_ring_update(ring, exp.chi, exp.clo, inserted)
        else:
            inserted, b_ovf, b_rounds = dvalid, False, 0
        if n_props:
            # sticky first hit across blocks (blocks are frontier order)
            hit, hi, lo = discovery_candidates(properties, exp, fv)
            keep = d_hit | ~hit
            d_hi = torch.where(keep, d_hi, hi)
            d_lo = torch.where(keep, d_lo, lo)
            d_hit = d_hit | hit
        xovf |= bool(exp.xovf)
        ovf |= b_ovf
        rounds += b_rounds
        parts.append((exp.pbits, exp.ebits, exp.terminal, exp.flat,
                      exp.chi, exp.clo, exp.cvalid, dvalid, inserted,
                      exp.ohi, exp.olo))
    cols = [torch.cat(c) for c in zip(*parts)]
    pbits = cols[0] if n_props else torch.zeros((f, 1), dtype=torch.bool,
                                                  device=dev)
    cvalid, dvalid, inserted = cols[6], cols[7], cols[8]
    scalars = torch.tensor(
        [int(xovf), int(ovf), rounds, cch, int(cvalid.sum()),
         int(dvalid.sum()), int(inserted.sum()), 0], dtype=torch.int64,
        device=dev)
    stats = u32(torch.cat([scalars, d_hit.to(torch.int64), d_hi, d_lo]))
    chi, clo = u32(cols[4]), u32(cols[5])
    ohi, olo = (u32(cols[9]), u32(cols[10])) if symmetry else (chi, clo)
    return FusedOut(pbits=pbits, ebits=u32(cols[1]), terminal=cols[2],
                    flat=u32(cols[3]), chi=chi, clo=clo,
                    cvalid=cvalid, dvalid=dvalid, inserted=inserted,
                    stats=stats, ohi=ohi, olo=olo)


def probe_block(table, fhi, flo, valid, ws: "Optional[StepWorkspace]" = None,
                max_rounds: int = 4096):
    """The owner-side probe: insert the received lanes ``(fhi, flo)``
    (int32 bit patterns, ``[N]``; ``valid`` bool ``[N]``) into
    ``table`` (this rank's int64 ``[C/4, 4]`` slice) IN PLACE.

    Returns ``(inserted bool[N], overflow, rounds)``, the last two as
    0-d tensors on the table's device (no host sync): ``inserted`` marks
    one lane per key that was not in the table. A CUDA table launches
    the flat insert (``csrc/step_common.cuh``; ``ws``: the table's
    :class:`StepWorkspace`, made when omitted), which inserts the LOWEST
    valid lane of each fresh key and counts the most rounds one lane
    took; a CPU table runs :func:`probe_block_reference`."""
    if table.is_cuda:
        from . import _cuda
        if ws is None:
            ws = StepWorkspace(table.numel(), 0, 0, table.device)
        return _cuda.probe_block(table, fhi, flo, valid, ws, max_rounds)
    return probe_block_reference(table, fhi, flo, valid, max_rounds)


def probe_block_reference(table, fhi, flo, valid, max_rounds: int = 4096):
    """The plain version of :func:`probe_block` (any device): the JAX
    package's ``table_insert(..., with_rounds=True)``, which its probe
    kernel evaluates, with the same winner as XLA:CPU."""
    inserted, ovf, rounds = table_insert_reference(
        table, fhi, flo, valid, max_rounds, with_rounds=True)
    dev = table.device
    return (inserted, torch.tensor(ovf, device=dev),
            torch.tensor(rounds, dtype=torch.int32, device=dev))
