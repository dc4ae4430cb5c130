"""Device-resident open-addressed fingerprint set with batched insert.

Counterpart of ``stateright_tpu/ops/hashtable.py``. The table is ONE int64
tensor ``[C/4, 4]`` of packed keys (``ops/words.py``), bucket-major:
bucket ``b`` is row ``b``, ``0`` marks an empty slot. An insert probes
whole 4-slot buckets from ``(lo ^ hi*0x9E3779B9) & (C/4 - 1)``: a key
match anywhere in the bucket means "already present", otherwise the
lane claims the bucket's first empty slot, and a bucket full of foreign
keys sends it to the next bucket. Buckets only ever fill, so a lookup
revisits every bucket between a key's start bucket and its slot.

:func:`table_insert` is the wrapper: on a CUDA table it launches the
flat insert (``csrc/step_common.cuh``, through ``csrc/fused_step.cu``:
the step kernel's bucket claim one thread per lane, and for a mask its
owner words); on a CPU table it runs :func:`table_insert_reference`, the JAX package's insert
ported lane for lane. :func:`table_evict_prefix`, the spill's eviction,
launches K10 (``csrc/evict.cu``) on a CUDA table and runs
:func:`table_evict_prefix_reference` on a CPU one.
"""

from __future__ import annotations

import numpy as np
import torch

from .words import M32, pack64, u64

_PHI = 0x9E3779B9  # 2^32 / golden ratio; scrambles hi into the probe start
_BUCKET = 4  # slots probed per round
_MIN_NARROW = 256  # floor for the narrow-tail probe width
_NARROW_THRESHOLD = 4096  # below this, a single probe loop
_CLAIM_CELLS = 1 << 16  # claim-arena floor


def _next_pow2(n: int) -> int:
    return 1 << max((n - 1).bit_length(), 0)


def make_table(capacity: int, device="cpu") -> torch.Tensor:
    """An empty table: int64 ``[capacity/4, 4]``; ``capacity`` must be a
    power of two >= 4."""
    if capacity & (capacity - 1) or capacity < _BUCKET:
        raise ValueError(
            f"capacity must be a power of two >= {_BUCKET} (got {capacity})")
    return torch.zeros((capacity // _BUCKET, _BUCKET), dtype=torch.int64,
                       device=device)


def start_bucket(hi: torch.Tensor, lo: torch.Tensor, n_buckets: int):
    """Probe start bucket (also the cross-chunk ring's slot hash)."""
    return (u64(lo) ^ ((u64(hi) * _PHI) & M32)) & (n_buckets - 1)


def table_insert(table, fhi, flo, valid, max_rounds: int = 4096,
                 with_rounds: bool = False, ws=None, mask: bool = True):
    """Insert a batch of fingerprints into ``table`` IN PLACE.

    Args:
      table: int64 ``[C/4, 4]`` packed keys (CPU or CUDA).
      fhi, flo: ``[N]`` fingerprint halves (int32 bit patterns or int64
        values; a fingerprint is never ``(0, 0)``).
      valid: bool ``[N]``; invalid lanes are ignored.
      max_rounds: probe-round bound; hitting it reports overflow.
      with_rounds: also return the probe-round count.
      ws: the table's ``ops.fused.StepWorkspace`` (CUDA only: its owner
        words and step counter, shared with the steps on the same
        table); made when omitted.
      mask: ``False`` when the caller drops ``inserted`` (the seed and
        growth): the kernel then makes no mask (one pass, no owner words,
        ``ws`` unused) and ``inserted`` is ``None`` on either device.

    Returns:
      ``(inserted bool[N], overflowed bool)`` (+ ``rounds int``):
      ``inserted`` marks exactly one lane per key that was not yet in
      the table. Which lane of an in-batch duplicate group is marked is
      unspecified by the JAX package: the CPU path marks the one the JAX
      package's XLA:CPU scatter marks, the kernel the LOWEST valid lane
      of each fresh key (the owner-word rule of the step kernel), so its
      mask repeats from call to call. On the card ``rounds`` is the most
      rounds one lane took; on the CPU it is the JAX count.
    """
    if table.is_cuda:
        from . import _cuda
        if ws is None and mask:
            from .fused import StepWorkspace
            ws = StepWorkspace(table.numel(), 0, 0, table.device)
        out = _cuda.table_insert(table, fhi, flo, valid, ws, max_rounds,
                                 mask)
    else:
        out = table_insert_reference(table, fhi, flo, valid, max_rounds,
                                     True)
        if not mask:
            out = (None,) + out[1:]
    return out if with_rounds else out[:2]


def table_insert_reference(table, fhi, flo, valid, max_rounds: int = 4096,
                           with_rounds: bool = False):
    """The plain version of :func:`table_insert` (any device): the JAX
    package's ``table_insert`` round for round, including the narrow-tail
    phases for batches over 4096 lanes. Its claim race resolves like
    XLA:CPU's scatter, where the last writer — the highest lane — wins a
    contested claim cell."""
    dev = table.device
    n_buckets = table.shape[0]
    capacity = n_buckets * _BUCKET
    n = fhi.shape[0]
    gmask = n_buckets - 1
    fhi, flo = u64(fhi), u64(flo)
    key = pack64(fhi, flo)
    offs = torch.arange(_BUCKET, dtype=torch.int64, device=dev)
    group0 = start_bucket(fhi, flo, n_buckets)
    token = torch.arange(1, n + 1, dtype=torch.int64, device=dev)

    def round_(unres, ins, group, key, token, claim_cells):
        bucket = table[group]
        is_empty = bucket == 0
        is_match = bucket == key[:, None]
        unres = unres & ~is_match.any(dim=1)
        has_empty = is_empty.any(dim=1)
        first_empty = torch.where(is_empty, offs, _BUCKET).min(dim=1).values
        cell = (group * _BUCKET + first_empty) & (claim_cells - 1)
        attempt = unres & has_empty
        # claim race in a hashed arena; the highest token wins a cell
        claim = torch.zeros((claim_cells + 1,), dtype=torch.int64,
                            device=dev)
        claim.scatter_reduce_(0, torch.where(attempt, cell, claim_cells),
                              token, reduce="amax")
        won = attempt & (claim[cell] == token)
        # one winner per slot: distinct cells are distinct slots
        table[group[won], first_empty[won]] = key[won]
        ins = ins | won
        unres = unres & ~won
        advance = unres & ~has_empty
        group = torch.where(advance, (group + 1) & gmask, group)
        return unres, ins, group

    def loop(unres, ins, group, key, token, cells, rounds):
        while bool(unres.any()) and rounds < max_rounds:
            unres, ins, group = round_(unres, ins, group, key, token,
                                       cells)
            rounds += 1
        return unres, ins, rounds

    claim_full = min(capacity, max(_CLAIM_CELLS, _next_pow2(4 * n)))
    inserted = torch.zeros((n,), dtype=torch.bool, device=dev)
    if n <= _NARROW_THRESHOLD:
        unres, inserted, rounds = loop(valid.clone(), inserted, group0,
                                       key, token, claim_full, 0)
        out = (inserted, bool(unres.any()))
        return out + (rounds,) if with_rounds else out

    # round 1 at full width, then the unresolved stragglers compacted to
    # n2 lanes; a full-width loop covers the rare over-n2 case
    unres, inserted, group = round_(valid.clone(), inserted, group0, key,
                                    token, claim_full)
    n2 = min(n, max(_MIN_NARROW, _next_pow2((n + 7) // 8)))
    ucount = int(unres.sum())
    narrow_ok = ucount <= n2
    pos = torch.cumsum(unres.to(torch.int64), 0) - 1
    sidx = torch.where(unres & (pos < n2), pos, n2)
    src = torch.zeros((n2 + 1,), dtype=torch.int64, device=dev)
    src[sidx[sidx < n2]] = torch.arange(n, dtype=torch.int64,
                                        device=dev)[sidx < n2]
    src = src[:n2]
    u2 = (torch.arange(n2, device=dev) < ucount) & narrow_ok
    claim_narrow = min(capacity, max(_CLAIM_CELLS, _next_pow2(4 * n2)))
    unres2, ins2, rounds2 = loop(
        u2, torch.zeros((n2,), dtype=torch.bool, device=dev), group[src],
        key[src], token[src], claim_narrow, 1)
    inserted[src[ins2]] = True
    unres3, inserted, rounds3 = loop(
        unres & (not narrow_ok), inserted, group, key, token, claim_full,
        1)
    overflowed = bool((unres2 & (rounds2 >= max_rounds)).any()) \
        or bool(unres3.any())
    out = (inserted, overflowed)
    return out + (1 + (rounds2 - 1) + (rounds3 - 1),) if with_rounds \
        else out


def _evict_mask(evict_pref) -> np.ndarray:
    """``evict_pref`` (bool ``[256]``: numpy, a sequence or a tensor) as
    numpy bool ``[256]``."""
    if isinstance(evict_pref, torch.Tensor):
        evict_pref = evict_pref.cpu().numpy()
    mask = np.asarray(evict_pref, bool).reshape(-1)
    if mask.shape != (256,):
        raise ValueError("evict_pref must hold 256 flags, one per 8-bit "
                         f"prefix (got {mask.shape})")
    return mask


def table_evict_prefix(table, evict_pref) -> int:
    """Evict every key whose top 8 bits (``resilience.fp_prefix``) are a
    prefix marked in ``evict_pref`` (bool ``[256]``) from ``table``
    IN PLACE, and compact each bucket: its survivors move to its front,
    in order (the insert claims a bucket's first empty slot, so its
    occupancy must stay a prefix). Returns the count of evicted keys.
    The JAX package's ``table_evict_prefix`` on the port's packed table:
    on a CUDA table K10 (``ops/_cuda.py`` ``evict_prefix``), on a CPU
    table :func:`table_evict_prefix_reference`.

    As in the JAX package, compaction can open an empty slot in a bucket
    a surviving key was once probed past while it was full, so a later
    insert of that key may claim the earlier slot and report it fresh
    again: the same maybe-fresh outcome as rediscovering an evicted key,
    which the host tier's re-probe filters (``HostShadow.note_chunk``)."""
    if table.is_cuda:
        from . import _cuda
        return _cuda.evict_prefix(table, evict_mask_words(evict_pref))
    return table_evict_prefix_reference(table, _evict_mask(evict_pref))


def evict_mask_words(evict_pref) -> list:
    """K10's mask: the 256 flags as 8 uint32 words, bit ``p % 32`` of
    word ``p // 32`` for prefix ``p``."""
    bits = np.packbits(_evict_mask(evict_pref).reshape(8, 32)[:, ::-1],
                       axis=1)
    return [int(w) for w in bits.view(">u4").reshape(8)]


def table_evict_prefix_reference(table, evict_pref) -> int:
    """The plain version of :func:`table_evict_prefix` (any device): the
    JAX package's body on packed keys. The prefix is ``(key >> 56) &
    0xFF``: torch shifts int64 arithmetically, so the mask keeps the
    top byte of a key with its high bit set."""
    mask = torch.as_tensor(_evict_mask(evict_pref), device=table.device)
    nonempty = table != 0
    drop = nonempty & mask[(table >> 56) & 0xFF]
    keep = nonempty & ~drop
    # stable per-bucket compaction: the kept slots to the front, in order
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    table.copy_(torch.where(keep, table, 0).gather(1, order))
    return int(drop.sum())


def plan_insert_host(fps, capacity: int):
    """Host-side placement plan for seeding an EMPTY table (a copy of the
    JAX package's numpy planner): an int64 slot index per fingerprint
    (-1 for duplicates), each at the first free slot of the first
    non-full bucket along its probe sequence. Raises on a full table."""
    if capacity & (capacity - 1) or capacity < _BUCKET:
        raise ValueError("capacity must be a power of two >= 4")
    n_buckets = capacity // _BUCKET
    buckets: dict = {}
    idx = np.empty((len(fps),), np.int64)
    for k, fp in enumerate(fps):
        fp = int(fp)
        hi, lo = (fp >> 32) & M32, fp & M32
        g = (lo ^ ((hi * _PHI) & M32)) & (n_buckets - 1)
        steps = 0
        while True:
            bucket = buckets.setdefault(g, [])
            if fp in bucket:
                idx[k] = -1  # duplicate fingerprint: nothing to place
                break
            if len(bucket) < _BUCKET:
                idx[k] = g * _BUCKET + len(bucket)
                bucket.append(fp)
                break
            g = (g + 1) & (n_buckets - 1)
            steps += 1
            if steps > n_buckets:
                raise RuntimeError(
                    f"hash table (capacity {capacity}) full while "
                    "planning the seed insert; raise "
                    "gpu_options(capacity=...)")
    return idx
