"""Build and bind the CUDA kernels of ``stateright_tpu_torch/csrc``.

Each source (``fused_step.cu``: the single-chip step, K1 alone and the
insert; ``sharded_step.cu``: the sharded engine's probe-free step and
owner-side probe; ``chunk.cu``: the chunk's start and K7, the append,
which between them evaluate the loop's gate; ``history.cu``: K8, the
history insert, and K9, the representative pull; ``staged.cu``: the
staged step's KS1-KS3 and its chunk's start) is
compiled with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface the first time a kernel is needed (never
at import), all ``nvcc`` processes started together, into
``<repo>/build/kernels/`` (git-ignored), named by a hash of the sources so
a stale library is never loaded. The libraries are bound
with ``ctypes``: every pointer (and the stream) goes over as a
``c_void_p`` inside an argument struct, and every C entry returns
``cudaGetLastError()`` of its launches, which the wrappers turn into an
exception. The wrappers check device, dtype, shape and contiguity,
allocate outputs and scratch with torch, launch on the current stream and
never synchronise. ``LAUNCHES`` counts each wrapper's launches.

Inside a chunk (``checker/device_loop.py``) one loop iteration — K1-K3
of both step sizes (gated on the device) and K7, whose tail evaluates
the next iteration's gate — is
captured once per carry allocation as a CUDA graph
(:class:`ChunkGraph`) and replayed; a wrapper called while a graph is
being captured records its launches with the graph, and each replay
adds them to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

from ..core import Expectation
from .fused import S_DISC, S_FAULT, S_OVF, S_ROUNDS, property_masks

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"
#: library name -> source under csrc/
_SOURCES = {"fused_step": "fused_step.cu", "sharded_step": "sharded_step.cu",
            "chunk": "chunk.cu", "history": "history.cu",
            "staged": "staged.cu"}
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel launches per wrapper: ``fused_step`` (K1-K3 of one step),
#: ``table_insert`` (K4: the flat insert), ``fused_step_noprobe`` (K1 +
#: K5 of one probe-free step), ``probe_block`` (K6: the same flat
#: insert), the symmetric steps
#: ``fused_step_sym`` and ``fused_step_noprobe_sym`` (the same kernels
#: with K1's symmetric instantiation), and the chunk's kernels:
#: ``chunk_begin`` (once per chunk, with the chunk's first gate) and
#: ``append`` (K7, with the next iteration's gate), and the history
#: stage's: ``history`` (K8, the history insert) and ``hpull`` (K9, the
#: representative pull), and the staged step's: ``expand`` (K1 alone, in
#: either instantiation), ``stage`` (KS1), ``predup`` (KS2) and
#: ``staged_append`` (KS3); its insert counts as ``table_insert`` (K4) and
#: its chunk's start as ``chunk_begin``
LAUNCHES = {"fused_step": 0, "table_insert": 0, "fused_step_noprobe": 0,
            "probe_block": 0, "fused_step_sym": 0,
            "fused_step_noprobe_sym": 0, "chunk_begin": 0, "append": 0,
            "history": 0, "hpull": 0, "expand": 0, "stage": 0,
            "predup": 0, "staged_append": 0}

#: ``counts``: while this thread captures a graph, the launches each
#: wrapper recorded in it (another thread's launches count as launches)
_CAPTURE = threading.local()
#: one graph capture at a time, and one build: the engine runs on its own
#: thread, and a race's retired device lane may still be running
_CAPTURE_LOCK = threading.Lock()
_BUILD_LOCK = threading.Lock()

#: ``{"seconds": build time, "logs": {library name: its nvcc/ptxas
#: output, kept beside the library}, "path": {library name: path}}``
BUILD_INFO: dict = {}

#: library name -> loaded ctypes library, once built
_LIB = None

_p = ctypes.c_void_p
_ll = ctypes.c_longlong
_i = ctypes.c_int
_u = ctypes.c_uint32


#: the lane budget of a block tile of K1 (expand), K2 (claim) and K5's
#: claim (K3 and K5's commit run one block per tile too): whole
#: rows, as many as fit (at least one); 1,024 was the best of 512, 1,024
#: and 2,048 for K1 and K2 on an H100 (tools/torch_tile_sweep.py)
TILE_LANES = 1024
#: the most threads per block of K1, K2 and K5's claim
TILE_THREADS = 256
#: below this many tiles per SM the rows per tile shrink (to one at the
#: least), so a thin frontier still spreads over the card
TILES_PER_SM = 2


class Geometry(NamedTuple):
    """The launch of a kernel over block tiles of whole frontier rows:
    block ``b`` takes rows ``[b * rows, min(F, (b + 1) * rows))``, lane
    ``t`` of its tile is row ``t // A``, action ``t % A``, and its
    ``threads`` walk the tile's lanes ``t, t + threads, ...``. ``cells``
    is the tile stage's (K2's, K5's) shared dedup table per block (a
    power of two, at least two per lane of a tile)."""

    rows: int
    threads: int
    blocks: int
    cells: int


def tile_geometry(f: int, a: int, sms: int) -> Geometry:
    """The launch of K1, K2, K3 or K5 over ``f`` frontier rows of ``a``
    action lanes on a card of ``sms`` SMs, from ``TILE_LANES``,
    ``TILE_THREADS`` and ``TILES_PER_SM`` as they are when called:
    ``TILE_LANES // a`` rows (at least one, so a row wider than the
    budget is one tile),
    fewer when that would give under ``TILES_PER_SM * sms`` tiles; at
    most ``TILE_THREADS`` threads, a multiple of 32; at least one block,
    also at ``f = 0`` (K1's grid resets the ring arena)."""
    lanes, threads, target = TILE_LANES, TILE_THREADS, TILES_PER_SM * sms
    if (f < 0 or a < 1 or lanes < 1 or threads < 32 or threads > 1024
            or threads % 32 or target < 1):
        raise ValueError(f"no tile geometry for f={f}, a={a}, "
                         f"lanes={lanes}, threads={threads}, sms={sms}")
    rows = max(1, min(lanes // a, -(-f // target)))
    tile = rows * a
    return Geometry(rows=rows, threads=min(threads, -(-tile // 32) * 32),
                    blocks=max(1, -(-f // rows)),
                    cells=1 << (2 * tile - 1).bit_length())


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SM count of a CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


#: K1-wide's launch: a wide model's K1 (Paxos) runs at most this many
#: rows (``csrc/step_common.cuh`` ``kWideRows``, the most one warp
#: scans) and threads a block, each thread with a staging row of
#: ``wide_stride(width)`` words in shared memory; at 128 threads the
#: registers of a lane's network and history (~165 at Paxos) fit
#: ``WIDE_BLOCKS_PER_SM`` blocks an SM, and so does the shared memory of
#: 32 rows at PackedPaxos(3)'s 96 words (two at the widest, 122)
WIDE_ROWS = 32
WIDE_THREADS = 128
WIDE_BLOCKS_PER_SM = 3
#: the wide models of ``STEP_MODELS`` (``kWideRow``): the words of their
#: row in K1's shared ``RowState`` (``PaxosModel::W``, which
#: ``PaxosCrashModel`` and ``PaxosLossyModel`` keep;
#: ``PingPongLossyModel::W``, the ping-pong fixture's 51 words made a
#: multiple of four: ``ping_pong`` is wide where lossy, its lossless one
#: narrow, :func:`drop_lanes`); the launch refuses a shared-memory size
#: below what this gives
WIDE_MODELS = {"paxos": 128, "paxos_crash": 128, "paxos_lossy": 128,
               "ping_pong": 52}
#: a row's suffix folds in K1's shared memory with drop lanes
#: (``csrc/step_common.cuh`` ``kSuffixWords``: two a network slot)
SUFFIX_WORDS = 32
#: the group models of ``STEP_MODELS`` (``kGroupRow``, ``csrc/
#: step_common.cuh`` ``GroupRow``: the register models on the unordered
#: network, each child built by a half-warp, ``kGroupLanes``, with the
#: network in its lanes): the words of their shared row (``AbdModel::W``,
#: ``SingleCopyModel::W``, ``WriteOnceModel::W``; the write-once
#: register's crash lanes follow its network slots, ``step_common.cuh``
#: ``CrashLanes``)
GROUP_MODELS = {"abd": 128, "single_copy": 128, "write_once": 128}
#: a group model's shared words a thread (``kGroupSlotWords``: a group's
#: child's history, at most 22 words, on its way to flat)
GROUP_SLOT_WORDS = 2
#: a group model with crash lanes: its shared words a thread instead, the
#: record of the delivery (or the crash edit) the thread takes in K1's
#: phase A (``csrc/actor_net.cuh`` ``DeliveryRecord``: the history's 22
#: words, the destination's ``kMaxSW`` words, three a send, a flags word;
#: made odd, ``step_common.cuh`` ``slot_words``)
GROUP_RECORD_WORDS = {"write_once": 27}
#: a group model's K1: its threads a block and its blocks an SM (the rows
#: a block cut so that they are resident at once), read when
#: ``k1_launch`` is called; the best of ``tools/torch_register_kernels.py
#: --sweep`` on an H100 (PERF.md)
GROUP_THREADS = 128
GROUP_BLOCKS_PER_SM = 4
#: the edit models of ``STEP_MODELS`` (``kEditRow``, launched over
#: K1-wide's rows): the words of their shared row and of a thread's
#: edit (``AbdOrderedModel::W`` and ``sizeof(Edit)`` in words:
#: ``actor_net.cuh`` ``OrderedEdit<6, 3>``, 45, which ``abd.cuh`` asserts)
EDIT_MODELS = {"abd_ordered": (352, 45)}
#: an edit model's K1 threads a block, however few its lanes: its warps
#: share the writing of the block's children; and its blocks an SM, its
#: rows cut so that they are resident at once (at 96 registers a thread,
#: five 128-thread blocks an SM): at abd3's 1,728-row step 3 rows and
#: ~7 children a block (``tools/torch_register_kernels.py --sweep`` on an
#: H100: K1 0.01405 device ms, against 0.01748 at 5 rows, 0.02234 at 256
#: threads)
EDIT_THREADS = 128
EDIT_BLOCKS_PER_SM = 5
#: the timer models of ``STEP_MODELS`` (``kTimerRow``, ``csrc/
#: step_common.cuh`` ``TimerRow``, launched over K1-wide's rows): the
#: words of their shared row (``TimerCountModel::W``: 32 actors' counts,
#: the network's slot and the timer word)
TIMER_MODELS = {"timer_count": 36}
#: a timer model's K1 threads a block and its blocks an SM (its rows cut
#: so that they are resident at once), read when ``k1_launch`` is called:
#: at TimerCount(8, 4)'s 8,192-row step 32 rows and 256 blocks. The
#: best two of ``tools/torch_register_kernels.py --timer-sweep`` on an
#: H100, this and 128 threads with 4 blocks, tie within 1.5 % at both of
#: its steps (PERF.md)
TIMER_THREADS = 256
TIMER_BLOCKS_PER_SM = 2


def row_words(name: str) -> int:
    """The most packed words K1's wide, group, edit or timer
    instantiation ``name`` takes: its shared row's."""
    if name in WIDE_MODELS:
        return WIDE_MODELS[name]
    if name in GROUP_MODELS:
        return GROUP_MODELS[name]
    if name in TIMER_MODELS:
        return TIMER_MODELS[name]
    return EDIT_MODELS[name][0]


def wide_stride(width: int) -> int:
    """A staging row's stride: the width made odd (``step_common.cuh``
    ``wide_stride``), so word ``k`` of a warp's 32 lanes falls in 32
    distinct shared-memory banks."""
    return width | 1


def wide_geometry(geo: Geometry, f: int, a: int, sms: int,
                  threads: int = None, per_sm: int = None) -> Geometry:
    """K1-wide's launch over ``f`` rows of ``a`` lanes on a card of
    ``sms`` SMs from the step's tile geometry ``geo`` (``StepArgs.wide``):
    its rows capped at ``WIDE_ROWS``, and fewer when that gives blocks
    for no more than ``WIDE_BLOCKS_PER_SM`` an SM, so that every block is
    resident at once and each thread steps fewer children in turn; the
    blocks that cover ``f`` with them, the tile's threads capped at
    ``WIDE_THREADS`` (an edit model: ``threads`` and ``per_sm`` blocks
    an SM, ``EDIT_THREADS`` and ``EDIT_BLOCKS_PER_SM``; a group model's
    ``GROUP_THREADS`` and ``GROUP_BLOCKS_PER_SM``); K2 and K3 keep
    ``geo``."""
    per_sm = WIDE_BLOCKS_PER_SM if per_sm is None else per_sm
    rows = max(1, min(geo.rows, WIDE_ROWS, -(-f // (per_sm * sms))))
    if threads is None:
        threads = min(-(-(rows * a) // 32) * 32, WIDE_THREADS)
    return Geometry(rows=rows, threads=threads,
                    blocks=-(-f // rows) if f > 0 else 1, cells=0)


def wide_smem_bytes(geo: Geometry, width: int, a: int,
                    row_words: int = WIDE_MODELS["paxos"],
                    slot_words: int = None, suffix: bool = False) -> int:
    """K1-wide's dynamic shared memory over ``geo`` (a
    :func:`wide_geometry`) for rows of ``width`` words and ``a`` action
    lanes (``StepArgs.wide_smem``; ``step_common.cuh`` ``WideSmem``): the
    tile's rows (``RowState``: ``row_words`` words and 16 bytes of
    flags, 16-byte aligned), four words per row (its quiet lane or
    active lanes, fingerprint and first active item) and four for the
    count, the tile's active lanes (``rows * a``), with ``suffix`` (drop
    lanes) ``SUFFIX_WORDS`` a row, then one slot per thread: a staging
    row of ``wide_stride(width)`` words, or an edit model's
    ``slot_words``."""
    if slot_words is None:
        slot_words = wide_stride(width)
    return (geo.rows * (4 * row_words + 16)
            + 4 * (4 * (geo.rows + 1) + geo.rows * a
                   + (geo.rows * SUFFIX_WORDS if suffix else 0)
                   + geo.threads * slot_words))


def timer_smem_bytes(geo: Geometry, a: int, row_words: int) -> int:
    """A timer model's K1 dynamic shared memory over ``geo`` (a
    :func:`wide_geometry`) for ``a`` action lanes (``StepArgs.wide_smem``;
    ``step_common.cuh`` ``TimerSmem``): the tile's rows (``RowState``:
    ``row_words`` words and 16 bytes of flags), four words per row (its
    active lanes, fingerprint folds and first child) and four for the
    count, then a 16-byte slot per Timeout lane of the tile (``rows * (a
    - 1)``)."""
    return (geo.rows * (4 * row_words + 16) + 4 * 4 * (geo.rows + 1)
            + 16 * geo.rows * (a - 1))


def drop_lanes(name: str, params: tuple = ()) -> bool:
    """Whether the K1 instantiation of ``STEP_MODELS`` entry ``name``
    for its ``cuda_spec`` parameters ``params`` has drop lanes
    (``csrc/step_common.cuh`` ``DropLanes``): ``paxos_lossy``, and
    ``ping_pong`` where lossy (its last parameter; ``csrc/fused_step.cu``
    ``srt_fused_step_ping_pong`` launches the narrow K1 otherwise). Each
    row of its tile keeps ``SUFFIX_WORDS`` words in shared memory."""
    return name == "paxos_lossy" or (name == "ping_pong"
                                     and bool(params) and bool(params[-1]))


def k1_launch(name: str, geo: Geometry, f: int, width: int, a: int,
              sms: int, params: tuple = ()) -> tuple:
    """``(StepArgs.wide, StepArgs.wide_smem)`` of the step kernels of
    ``STEP_MODELS`` entry ``name`` (``cuda_spec`` parameters ``params``)
    over ``f`` rows of ``width`` words and ``a`` lanes (tile geometry
    ``geo``): a wide, group, edit or timer model's K1 geometry and shared
    memory, else ``(geo, 0)`` (unused). Read when called: ``EDIT_*``,
    ``GROUP_*`` and ``TIMER_*``."""
    threads = per_sm = None
    drops = drop_lanes(name, params)
    if name == "ping_pong" and not drops:
        return geo, 0  # the lossless fixture: the narrow K1
    if name in TIMER_MODELS:
        wide = wide_geometry(geo, f, a, sms, TIMER_THREADS,
                             TIMER_BLOCKS_PER_SM)
        return wide, timer_smem_bytes(wide, a, TIMER_MODELS[name])
    if name in WIDE_MODELS:
        row_words, slot_words = WIDE_MODELS[name], None
    elif name in GROUP_MODELS:
        row_words = GROUP_MODELS[name]
        slot_words = GROUP_RECORD_WORDS.get(name, GROUP_SLOT_WORDS)
        threads, per_sm = GROUP_THREADS, GROUP_BLOCKS_PER_SM
    elif name in EDIT_MODELS:
        row_words, slot_words = EDIT_MODELS[name]
        threads, per_sm = EDIT_THREADS, EDIT_BLOCKS_PER_SM
    else:
        return geo, 0
    wide = wide_geometry(geo, f, a, sms, threads, per_sm)
    return wide, wide_smem_bytes(wide, width, a, row_words, slot_words,
                                 suffix=drops)


def pending_span(take: int, blocks: int, rows: int) -> int:
    """The pending rows a block of a gated group K1 takes
    (``csrc/step_common.cuh`` ``pending_span``): block ``b`` of
    ``blocks`` takes rows ``[b * span, min(take, (b + 1) * span))``,
    ``span`` = ``ceil(take / blocks)`` capped at the geometry's
    ``rows``."""
    span = -(-take // blocks) if take > 0 else 0
    return min(span, rows)


def pending_rows(name: str) -> bool:
    """Whether K1's instantiation ``name`` steps only the pending rows (a
    group or timer model's): a row that is not gets no child (its lanes
    ``cvalid`` 0, the row ``terminal`` 0, its other outputs unwritten).
    The wide and edit K1s step every row of their tiles."""
    return name in GROUP_MODELS or name in TIMER_MODELS


class TileGeometry(ctypes.Structure):
    """``TileGeometry`` of ``csrc/step_common.cuh``, field for field."""

    _fields_ = [("rows", _i), ("threads", _i), ("blocks", _i),
                ("cells", _i)]


class StepArgs(ctypes.Structure):
    """``StepArgs`` of ``csrc/step_common.cuh``, field for field."""

    _fields_ = [
        ("frontier", _p), ("fstride", _ll), ("ebits", _p), ("estride", _ll),
        ("phi", _p), ("plo", _p), ("pstride", _ll), ("fvalid", _p),
        ("F", _i), ("A", _i), ("P", _i), ("pcols", _i),
        ("always_mask", _u), ("sometimes_mask", _u), ("ev_mask", _u),
        ("step", _u),
        ("pbits", _p), ("ebits_out", _p), ("terminal", _p), ("flat", _p),
        ("chi", _p), ("clo", _p), ("ohi", _p), ("olo", _p),
        ("cvalid", _p), ("dvalid", _p),
        ("inserted", _p), ("claims", _p), ("n_claims", _p), ("stats", _p),
        ("keys", _p), ("n_buckets", _ll), ("max_rounds", _i), ("cc", _i),
        ("owner", _p), ("ring", _p), ("ring_arena", _p),
        ("disc_cand", _p), ("tile", TileGeometry), ("wide", TileGeometry),
        ("wide_smem", _ll), ("gate", _p), ("gate_size", _i),
        ("stream", _p),
    ]


class DedupArgs(ctypes.Structure):
    """``DedupArgs`` of ``csrc/sharded_step.cu``, field for field."""

    _fields_ = [("s", StepArgs), ("arena", _p), ("arena_owner", _p),
                ("cells", _ll)]


class ChunkArgs(ctypes.Structure):
    """``ChunkArgs`` of ``csrc/chunk.cu``, field for field."""

    _fields_ = [
        ("ctr", _p), ("stats", _p), ("inserted", _p), ("flat", _p),
        ("ebits", _p), ("chi", _p), ("clo", _p), ("ohi", _p), ("olo", _p),
        ("q", _p), ("log", _p), ("status", _p), ("ticket", _p),
        ("qlimit", _ll),
        ("P", _i), ("W", _i), ("A", _i), ("log_cols", _i),
        ("stats_len", _i), ("f_small", _i), ("f_large", _i), ("ext", _i),
        ("recent", _i), ("cch", _i), ("tile_lanes", _i), ("stream", _p),
    ]


class HistArgs(ctypes.Structure):
    """``HistArgs`` of ``csrc/history.cu``, field for field."""

    _fields_ = [
        ("q", _p), ("qstride", _ll), ("hoff", _i), ("hwidth", _i),
        ("keys", _p), ("n_buckets", _ll), ("max_rounds", _i),
        ("index", _p), ("count", _i), ("start", _p), ("end", _p),
        ("hidx", _p), ("h_n", _p), ("ovf", _p), ("gate", _p),
        ("tile_n", _p), ("akey", _p), ("arow", _p), ("ctl", _p),
        ("cap", _i), ("blocks", _i), ("stream", _p),
    ]


class StagedPlanC(ctypes.Structure):
    """``StagedPlan`` of ``csrc/staged.cu``, field for field."""

    _fields_ = [("f", _i), ("kraw", _i), ("kfin", _i)]


class StagedArgs(ctypes.Structure):
    """``StagedArgs`` of ``csrc/staged.cu``, field for field."""

    _fields_ = [
        ("ctr", _p), ("stats", _p), ("sctl", _p),
        ("cvalid", _p), ("pbits", _p), ("terminal", _p), ("ebits_out", _p),
        ("flat", _p), ("chi", _p), ("clo", _p), ("ohi", _p), ("olo", _p),
        ("src", _p), ("rvalid", _p), ("dvalid", _p), ("pkey", _p),
        ("lane", _p), ("khi", _p), ("klo", _p), ("kvalid", _p),
        ("inserted", _p), ("sel", _p), ("arena", _p), ("bcount", _p),
        ("sdisc", _p),
        ("q", _p), ("log", _p), ("elog", _p),
        ("qlimit", _ll), ("elimit", _ll),
        ("P", _i), ("pcols", _i), ("W", _i), ("A", _i), ("log_cols", _i),
        ("stats_len", _i), ("ext", _i), ("recent", _i), ("cch", _i),
        ("sound", _i),
        ("always_mask", _u), ("sometimes_mask", _u), ("ev_mask", _u),
        ("small", StagedPlanC), ("large", StagedPlanC), ("stream", _p),
    ]


class HpullArgs(ctypes.Structure):
    """``HpullArgs`` of ``csrc/history.cu``, field for field."""

    _fields_ = [
        ("q", _p), ("qstride", _ll), ("W", _i), ("hidx", _p), ("log", _p),
        ("log_cols", _i), ("n_init", _i), ("start", _i), ("h_n", _p),
        ("count", _i), ("out", _p), ("rows", _i), ("stream", _p),
    ]


#: the tile sizes of K7 (lanes per block: 256 threads of 4 or 16 lanes,
#: or 128 threads of one lane; ``csrc/chunk.cu`` instantiates each)
APPEND_TILES = (128, 1024, 4096)
#: K7's tile for queue rows wider than its 256-thread block (``W + 3 >
#: 256``, the ordered register rows): 128 lanes, so that a large step's
#: tiles outnumber the SMs (tpu_abd2's 18,990 lanes: 149 tiles), each
#: copying its rows a warp per row
APPEND_WIDE_TILE = 128
#: the threads of K7's 1,024- and 4,096-lane blocks
APPEND_THREADS = 256
#: K7's control words (``Ticket`` of ``csrc/chunk.cu``: the tickets drawn,
#: the step's highest inserted lane + 1 under its launch's epoch)
APPEND_TICKETS = 2

#: the models the step kernels are instantiated for, by ``cuda_spec``
#: name (``csrc/<header>``): the number of int parameters of the plain
#: step's C entries and of the symmetric step's (``None``: no symmetric
#: instantiation). Their entries are ``srt_fused_step_<name>[_sym]``
#: (fused_step.cu) and ``srt_dedup_step_<name>[_sym]`` (sharded_step.cu)
STEP_MODELS = {"twopc": (1, 2), "lineq": (3, None), "increment": (1, 1),
               "increment_lock": (1, None), "paxos": (3, None),
               "abd": (3, None), "abd_ordered": (3, None),
               "single_copy": (3, None), "write_once": (8, None),
               "paxos_crash": (8, None), "paxos_lossy": (3, None),
               "ping_pong": (4, None), "timer_count": (2, None)}
#: the models of STEP_MODELS with no probe-free (sharded) step: their
#: host-evaluated properties keep them off a mesh (B14), and the actor
#: test fixtures (``ping_pong``, ``timer_count``) wait for the step
#: kernel's configuration 3 (the sharded engine refuses them on the card)
SINGLE_CHIP_MODELS = ("paxos", "abd", "abd_ordered", "single_copy",
                      "write_once", "paxos_crash", "paxos_lossy",
                      "ping_pong", "timer_count")


def _step_entries(prefix: str, struct, size_fn: str,
                  sharded: bool = False) -> list:
    out = []
    for name, (n_plain, n_sym) in STEP_MODELS.items():
        if sharded and name in SINGLE_CHIP_MODELS:
            continue
        out.append((f"{prefix}_{name}", struct, size_fn, n_plain))
        if n_sym is not None:
            out.append((f"{prefix}_{name}_sym", struct, size_fn, n_sym))
    return out


#: per library: (C entry, argument struct, its size function, the
#: number of int parameters after the struct: the model's; or their
#: ctypes types) of each kernel
_ENTRIES = {
    "fused_step": _step_entries("srt_fused_step", StepArgs,
                                "srt_step_args_size")
    + _step_entries("srt_expand", StepArgs, "srt_step_args_size")
    + [("srt_table_insert", StepArgs, "srt_step_args_size", 0)],
    "staged": [("srt_stage", StagedArgs, "srt_staged_args_size", 1),
               ("srt_predup", StagedArgs, "srt_staged_args_size", 2),
               ("srt_staged_append", StagedArgs, "srt_staged_args_size", 0)],
    "chunk": [("srt_chunk_begin", ChunkArgs, "srt_chunk_args_size",
               (_i, _i, _i, _i, _ll)),
              ("srt_append", ChunkArgs, "srt_chunk_args_size", 0)],
    "sharded_step": _step_entries("srt_dedup_step", DedupArgs,
                                  "srt_dedup_args_size", sharded=True)
    + [("srt_probe_block", StepArgs, "srt_step_args_size", 0)],
    "history": [("srt_history", HistArgs, "srt_hist_args_size", 0),
                ("srt_hpull", HpullArgs, "srt_hpull_args_size", 0)],
}


def step_entry(model, symmetry: bool) -> "tuple":
    """``(entry suffix, params)`` of ``model``'s step kernels: the
    suffix after ``srt_fused_step_``/``srt_dedup_step_`` from its
    ``cuda_spec`` (which raises for a model, or a subclass, the kernels
    do not run), and the model kernel's integer parameters. Raises
    ``NotImplementedError`` for a name no kernel is instantiated for."""
    name, params = model.cuda_spec(symmetry)
    counts = STEP_MODELS.get(name)
    n_params = None if counts is None else counts[1 if symmetry else 0]
    if n_params is None:
        raise NotImplementedError(
            f"no CUDA step kernel for {name!r}"
            + (" under symmetry" if counts is not None else ""))
    if len(params) != n_params:
        raise ValueError(f"cuda_spec of {name!r} gives {len(params)} "
                         f"parameters, the kernel takes {n_params}")
    return name + ("_sym" if symmetry else ""), tuple(params)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
        "kernels of stateright_tpu_torch are built from source on first "
        "use")


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(_CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the kernels (unless this source hash is already built),
    one ``nvcc`` per source, all started together, and load the
    libraries. Returns :data:`BUILD_INFO`."""
    with _BUILD_LOCK:
        if _LIB is None:
            _build()
        return BUILD_INFO


def _build() -> None:
    global _LIB
    tag = _source_hash()
    paths = {name: _BUILD / f"libsrt_{name}_{tag}.so" for name in _SOURCES}
    logs = {}
    t0 = time.perf_counter()
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if todo:
        nvcc = _nvcc()
        _BUILD.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, path in todo.items():
            tmp = path.with_suffix(
                f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp),
                   str(_CSRC / _SOURCES[name])]
            procs[name] = (cmd, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (cmd, tmp, proc) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{logs[name]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, (_cmd, tmp, _proc) in procs.items():
            todo[name].with_suffix(".log").write_text(logs[name])
            os.replace(tmp, todo[name])
    seconds = time.perf_counter() - t0
    for name, path in paths.items():  # a library built earlier: its log
        if name not in logs and path.with_suffix(".log").exists():
            logs[name] = path.with_suffix(".log").read_text()
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for entry, struct, size_name, n_params in _ENTRIES[name]:
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.POINTER(struct)] + (
                [_i] * n_params if isinstance(n_params, int)
                else list(n_params))
            fn.restype = _i
            size_fn = getattr(lib, size_name)
            size_fn.argtypes = []
            size_fn.restype = _i
            if size_fn() != ctypes.sizeof(struct):
                raise RuntimeError(
                    f"{struct.__name__} layout differs between "
                    f"csrc/{_SOURCES[name]} and ops/_cuda.py")
        libs[name] = lib
    launch = libs["chunk"].srt_graph_launch
    launch.argtypes = [_ll, _ll, _i]
    launch.restype = _i
    tile_rows = libs["history"].srt_hist_tile_rows
    tile_rows.argtypes = []
    tile_rows.restype = _i
    if tile_rows() != HIST_TILE_ROWS:
        raise RuntimeError("K8's tile rows differ between csrc/history.cu "
                           "and ops/_cuda.py")
    _LIB = libs
    BUILD_INFO.update(seconds=seconds, logs=logs,
                      path={k: str(v) for k, v in paths.items()})


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device,
           contiguous: bool = True) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _count(name: str) -> None:
    """Count a launch of the wrapper ``name``: into the graph being
    captured (its replays count it), else into ``LAUNCHES``."""
    captured = getattr(_CAPTURE, "counts", None)
    if captured is not None:
        captured[name] = captured.get(name, 0) + 1
    else:
        LAUNCHES[name] += 1


def step_buffers(model, f: int, stats_len: int, symmetry: bool, device,
                 n_tiles: int) -> dict:
    """The outputs and scratch of a step over ``f`` frontier rows:
    ``pbits``, ``ebits_out``, ``terminal``, ``flat``, ``chi``, ``clo``,
    ``ohi``/``olo`` (new tensors under ``symmetry``, else ``chi``/``clo``
    again), ``cvalid``, ``dvalid``, ``inserted``, ``claims`` (K2's or
    K5's claims per tile, in the tile's own lane range), ``n_claims``
    (their count per tile, for ``n_tiles`` tiles) and ``stats`` (zeroed).
    A chunk allocates one set at its large size and both step sizes
    write into it."""
    w = model.packed_width
    lanes = f * model.max_actions
    pcols = max(len(model.properties()), 1)
    dev = device

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    def u8(*shape):
        return torch.empty(shape, dtype=torch.bool, device=dev)

    out = dict(pbits=u8(f, pcols), ebits_out=i32(f), terminal=u8(f),
               flat=i32(lanes, w), chi=i32(lanes), clo=i32(lanes),
               cvalid=u8(lanes), dvalid=u8(lanes), inserted=u8(lanes),
               claims=torch.empty((lanes,), dtype=torch.int64, device=dev),
               n_claims=i32(n_tiles),
               stats=torch.zeros((stats_len,), dtype=torch.int32,
                                 device=dev))
    out["ohi"], out["olo"] = ((i32(lanes), i32(lanes)) if symmetry
                              else (out["chi"], out["clo"]))
    return out


def _step_args(model, frontier, ebits, fvalid, phi, plo, ring, ws,
               stats_len: int, symmetry: bool, bufs=None, gate=None,
               gate_size: int = 0):
    """Check K1's inputs, allocate the step's outputs (or take ``bufs``,
    a :func:`step_buffers` of at least this step's rows) and fill the
    table-free fields of a ``StepArgs``; returns ``(entry, outputs,
    args)`` where ``entry`` is :func:`step_entry`'s (the C entry's
    suffix and the model kernel's parameters) and ``outputs`` the
    wrappers' return tuple (``ohi``/``olo`` last).
    ``gate`` (a device pointer to the chunk's gate) makes the launch a
    chunk's: ``frontier``, ``ebits``, ``phi`` and ``plo`` start at queue
    row 0 and the kernels read the window, the valid rows and the tag
    from the gate, and run only when it picks ``gate_size``; ``fvalid``
    is then unused and the workspace's counter untouched."""
    entry = step_entry(model, symmetry)
    dev = frontier.device
    f, w = frontier.shape
    _check(frontier, "frontier", torch.int32, 2, dev, contiguous=False)
    if frontier.stride(1) != 1 or w != model.packed_width:
        raise ValueError("frontier must be [F, packed_width] with unit "
                         "column stride")
    for t, nm in ((ebits, "ebits"), (phi, "phi"), (plo, "plo")):
        _check(t, nm, torch.int32, 1, dev, contiguous=False)
        if t.shape[0] != f:
            raise ValueError(f"{nm} must have {f} rows")
    if phi.stride(0) != plo.stride(0):
        raise ValueError("phi and plo must share one stride")
    if gate is None:
        _check(fvalid, "fvalid", torch.bool, 1, dev)
    cc = 0
    if ring is not None:
        _check(ring, "ring", torch.int64, 1, dev)
        cc = ring.shape[0]
    n_actions = model.max_actions
    lanes = f * n_actions
    n_props = len(model.properties())
    if n_props > 32 or lanes >= 1 << 31:
        raise ValueError("at most 32 properties and 2**31 lanes per step")
    if (ws.ring_arena.shape[0] < cc or ws.disc_cand.shape[0] < n_props
            or ws.disc_cand.device != dev):
        raise ValueError("workspace does not match this ring or model")
    geo = tile_geometry(f, n_actions, sm_count(dev))
    wide, wide_smem = k1_launch(entry[0], geo, f, model.packed_width,
                                n_actions, sm_count(dev), entry[1])
    if bufs is None:
        bufs = step_buffers(model, f, stats_len, symmetry, dev, geo.blocks)
    elif (bufs["inserted"].shape[0] < lanes
          or bufs["n_claims"].shape[0] < geo.blocks
          or bufs["stats"].shape[0] != stats_len
          or (bufs["ohi"] is bufs["chi"]) == symmetry):
        raise ValueError("step buffers do not fit this step")
    if gate is None:
        ws.step += 1
    masks = property_masks(model)
    pcols = max(n_props, 1)
    b = bufs
    # the workspace keeps the claim counts of its last step (a
    # diagnostic: their sum is the step's inserted lanes)
    ws.n_claims = b["n_claims"]
    args = StepArgs(
        frontier=frontier.data_ptr(), fstride=frontier.stride(0),
        ebits=ebits.data_ptr(), estride=ebits.stride(0),
        phi=phi.data_ptr(), plo=plo.data_ptr(), pstride=phi.stride(0),
        fvalid=None if gate is not None else fvalid.data_ptr(), F=f,
        A=n_actions, P=n_props,
        pcols=pcols, always_mask=masks[Expectation.ALWAYS],
        sometimes_mask=masks[Expectation.SOMETIMES],
        ev_mask=masks[Expectation.EVENTUALLY],
        step=0 if gate is not None else ws.step,
        pbits=b["pbits"].data_ptr(), ebits_out=b["ebits_out"].data_ptr(),
        terminal=b["terminal"].data_ptr(), flat=b["flat"].data_ptr(),
        chi=b["chi"].data_ptr(), clo=b["clo"].data_ptr(),
        ohi=b["ohi"].data_ptr() if symmetry else None,
        olo=b["olo"].data_ptr() if symmetry else None,
        cvalid=b["cvalid"].data_ptr(),
        dvalid=b["dvalid"].data_ptr(), inserted=b["inserted"].data_ptr(),
        claims=b["claims"].data_ptr(), n_claims=b["n_claims"].data_ptr(),
        stats=b["stats"].data_ptr(),
        max_rounds=4096, cc=cc, ring=ring.data_ptr() if cc else None,
        ring_arena=ws.ring_arena.data_ptr(),
        disc_cand=ws.disc_cand.data_ptr(),
        tile=TileGeometry(*geo), wide=TileGeometry(*wide),
        wide_smem=wide_smem, gate=gate, gate_size=gate_size,
        stream=torch.cuda.current_stream(dev).cuda_stream)
    outputs = (b["pbits"][:f], b["ebits_out"][:f], b["terminal"][:f],
               b["flat"][:lanes], b["chi"][:lanes], b["clo"][:lanes],
               b["cvalid"][:lanes], b["dvalid"][:lanes],
               b["inserted"][:lanes], b["stats"], b["ohi"][:lanes],
               b["olo"][:lanes])
    return entry, outputs, args


def fused_step(model, frontier, ebits, fvalid, phi, plo, table, ring, ws,
               stats_len: int, symmetry: bool = False, bufs=None,
               gate=None, gate_size: int = 0):
    """Launch K1-K3 for one step; returns the output tensors
    ``(pbits, ebits, terminal, flat, chi, clo, cvalid, dvalid, inserted,
    stats, ohi, olo)``. ``table`` and ``ring`` are updated in place.
    ``symmetry`` launches the symmetric instantiation (canonical keys in
    ``chi``/``clo``, the children's own fingerprints in ``ohi``/``olo``).
    ``bufs``, ``gate`` and ``gate_size``: a chunk's launch (see
    :func:`_step_args`)."""
    build()
    lib = _LIB["fused_step"]
    dev = frontier.device
    _check(table, "table", torch.int64, 2, dev)
    capacity = table.numel()
    if table.shape[1] != 4 or capacity >= 1 << 31:
        raise ValueError("table must be [C/4, 4] with C < 2**31")
    ws.check(capacity, 0 if ring is None else ring.shape[0],
             len(model.properties()), dev)
    (suffix, params), outputs, args = _step_args(
        model, frontier, ebits, fvalid, phi, plo, ring, ws, stats_len,
        symmetry, bufs, gate, gate_size)
    args.keys = table.data_ptr()
    args.n_buckets = table.shape[0]
    args.owner = ws.owner.data_ptr()
    _raise_on(getattr(lib, f"srt_fused_step_{suffix}")(ctypes.byref(args),
                                                        *params),
              f"fused step ({suffix})")
    _count("fused_step_sym" if symmetry else "fused_step")
    return outputs


def expand_launcher(model, frontier, ebits, fvalid, phi, plo, ws,
                    stats_len: int, symmetry: bool = False, bufs=None,
                    gate=None, gate_size: int = 0):
    """K1 alone (``srt_expand_<model>``: the staged step's expansion, no
    table and no ring) with its arguments built once: returns ``(launch,
    outputs)``, where ``launch()`` launches it on the stream current now
    and ``outputs`` is the output tuple of :func:`fused_step`, whose
    ``dvalid`` and ``inserted`` it leaves unwritten. ``bufs``, ``gate``
    and ``gate_size``: a chunk's launch (see :func:`_step_args`); ``ws``
    gives the discovery candidates K1 posts (the staged step takes its
    own, KS1's)."""
    build()
    (suffix, params), outputs, args = _step_args(
        model, frontier, ebits, fvalid, phi, plo, None, ws, stats_len,
        symmetry, bufs, gate, gate_size)
    entry = getattr(_LIB["fused_step"], f"srt_expand_{suffix}")

    def launch() -> None:
        _raise_on(entry(ctypes.byref(args), *params), f"expand ({suffix})")
        _count("expand")

    return launch, outputs


def expand_step(model, frontier, ebits, fvalid, phi, plo, ws,
                stats_len: int, symmetry: bool = False, bufs=None,
                gate=None, gate_size: int = 0):
    """Launch K1 alone (:func:`expand_launcher`) once; returns its
    outputs."""
    launch, outputs = expand_launcher(model, frontier, ebits, fvalid, phi,
                                      plo, ws, stats_len, symmetry, bufs,
                                      gate, gate_size)
    launch()
    return outputs


def fused_step_noprobe(model, frontier, ebits, fvalid, phi, plo, ring, ws,
                       stats_len: int, symmetry: bool = False):
    """Launch K1 + K5 for one probe-free step; returns the same output
    tuple as :func:`fused_step` with ``inserted`` aliasing ``dvalid``.
    ``ring`` is read only; ``ws`` is a ``DedupWorkspace`` of at least
    this step's lanes. ``symmetry`` launches the symmetric
    instantiation."""
    build()
    lib = _LIB["sharded_step"]
    ws.check(frontier.shape[0] * model.max_actions, frontier.device)
    (suffix, params), outputs, args = _step_args(
        model, frontier, ebits, fvalid, phi, plo, ring, ws, stats_len,
        symmetry)
    outputs = outputs[:8] + (outputs[7],) + outputs[9:]
    dargs = DedupArgs(s=args, arena=ws.arena.data_ptr(),
                      arena_owner=ws.arena_owner.data_ptr(),
                      cells=ws.arena.shape[0])
    _raise_on(getattr(lib, f"srt_dedup_step_{suffix}")(ctypes.byref(dargs),
                                                        *params),
              f"probe-free step ({suffix})")
    _count("fused_step_noprobe_sym" if symmetry else "fused_step_noprobe")
    return outputs


def _flat_insert(library: str, entry: str, what: str, table, fhi, flo,
                 valid, ws, max_rounds: int, mask: bool = True):
    """Launch the flat insert of ``csrc/step_common.cuh`` through the C
    entry ``entry`` of ``library`` (K4: ``srt_table_insert`` of
    ``fused_step``; K6: ``srt_probe_block`` of ``sharded_step``; ``what``
    names it in a launch error): insert the ``(fhi, flo)`` lanes where
    ``valid`` into ``table`` in place. With ``mask`` it marks the lowest
    valid lane of each fresh key, through the owner words and the step
    counter of ``ws``, the table's ``StepWorkspace``; without it no mask
    is made and ``ws`` is not used. Returns ``(inserted, stats)``: the
    mask (``None`` without one) and the ``S_*`` stats vector (``S_OVF``,
    ``S_ROUNDS``, ``S_FAULT``), both on the device, not synchronised."""
    build()
    dev = table.device
    _check(table, "table", torch.int64, 2, dev)
    capacity = table.numel()
    if table.shape[1] != 4 or capacity >= 1 << 31:
        raise ValueError("table must be [C/4, 4] with C < 2**31")
    n = fhi.shape[0]
    hi = fhi.to(torch.int32).contiguous()
    lo = flo.to(torch.int32).contiguous()
    _check(hi, "fhi", torch.int32, 1, dev)
    _check(lo, "flo", torch.int32, 1, dev)
    _check(valid, "valid", torch.bool, 1, dev)
    if lo.shape[0] != n or valid.shape[0] != n or n >= 1 << 31:
        raise ValueError("fhi, flo and valid must have equal lengths "
                         "below 2**31")
    inserted, owner, step = None, None, 0
    if mask:
        ws.check(capacity, 0, 0, dev)
        ws.step += 1
        # the kernel writes every lane's inserted = 0 before its barrier
        inserted = torch.empty((n,), dtype=torch.bool, device=dev)
        owner, step = ws.owner.data_ptr(), ws.step
    stats = torch.zeros((S_DISC,), dtype=torch.int32, device=dev)
    args = StepArgs(
        F=n, A=1, P=0, pcols=1, step=step, chi=hi.data_ptr(),
        clo=lo.data_ptr(), cvalid=valid.data_ptr(),
        inserted=None if inserted is None else inserted.data_ptr(),
        stats=stats.data_ptr(), keys=table.data_ptr(),
        n_buckets=table.shape[0], max_rounds=max_rounds, cc=0, owner=owner,
        stream=torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(getattr(_LIB[library], entry)(ctypes.byref(args)), what)
    return inserted, stats


def probe_block(table, fhi, flo, valid, ws, max_rounds: int):
    """Launch K6: the owner-side probe of ``(fhi, flo)`` lanes against
    ``table`` (this rank's slice), in place. Returns ``(inserted,
    overflow, rounds)``, the two scalars as 0-d device tensors (no
    sync). ``ws`` is the table's ``StepWorkspace``; it keeps this call's
    stats vector as ``ws.insert_stats``, whose ``S_FAULT`` the sharded
    loop reads with its next reduction."""
    inserted, stats = _flat_insert("sharded_step", "srt_probe_block",
                                   "owner-side probe", table, fhi, flo,
                                   valid, ws, max_rounds)
    ws.insert_stats = stats
    _count("probe_block")
    return inserted, stats[S_OVF] > 0, stats[S_ROUNDS]


def table_insert(table, fhi, flo, valid, ws, max_rounds: int,
                 mask: bool = True):
    """Launch K4: insert ``(fhi, flo)`` lanes into ``table`` in place;
    with ``mask``, through ``ws``, the table's ``StepWorkspace`` (without
    it no mask is made, ``ws`` may be ``None``). Returns ``(inserted,
    overflow, rounds)`` — the two scalars read back with one
    synchronising copy (seeding and growth only), ``inserted`` ``None``
    without a mask; raises on a kernel fault (``S_FAULT``)."""
    if fhi.shape[0] == 0:
        return (torch.zeros((0,), dtype=torch.bool, device=table.device)
                if mask else None, False, 0)
    inserted, stats = _flat_insert("fused_step", "srt_table_insert",
                                   "table insert", table, fhi, flo, valid,
                                   ws, max_rounds, mask)
    _count("table_insert")
    host = stats.tolist()
    if host[S_FAULT]:
        raise RuntimeError("the insert kernel found a claim without this "
                           "call's owner word (S_FAULT)")
    return inserted, bool(host[S_OVF]), int(host[S_ROUNDS])


def staged_insert(table, khi, klo, kvalid, inserted, stats, ws, gate,
                  gate_size: int, max_rounds: int = 4096) -> None:
    """Launch K4 in the staged chunk: the ``kvalid`` slots' keys
    ``(khi, klo)`` into ``table`` in place, ``inserted`` marking the
    lowest slot of each fresh key, gated on ``gate_size`` and tagged by
    the chunk's gate (``gate``: a device pointer to it), its overflow,
    rounds and fault into ``stats`` (the step's stats vector, ``S_*``).
    No sync."""
    build()
    dev = table.device
    _check(table, "table", torch.int64, 2, dev)
    n = khi.shape[0]
    for t, nm, dt in ((khi, "khi", torch.int32), (klo, "klo", torch.int32),
                      (kvalid, "kvalid", torch.bool),
                      (inserted, "inserted", torch.bool),
                      (stats, "stats", torch.int32)):
        _check(t, nm, dt, 1, dev)
        if nm != "stats" and t.shape[0] != n:
            raise ValueError(f"{nm} must have {n} slots")
    if table.shape[1] != 4 or table.numel() >= 1 << 31 or not n:
        raise ValueError("table must be [C/4, 4] with C < 2**31, and the "
                         "insert at least one slot")
    ws.check(table.numel(), 0, 0, dev)
    args = StepArgs(
        F=n, A=1, P=0, pcols=1, step=0, chi=khi.data_ptr(),
        clo=klo.data_ptr(), cvalid=kvalid.data_ptr(),
        inserted=inserted.data_ptr(), stats=stats.data_ptr(),
        keys=table.data_ptr(), n_buckets=table.shape[0],
        max_rounds=max_rounds, cc=0, owner=ws.owner.data_ptr(), gate=gate,
        gate_size=gate_size,
        stream=torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(_LIB["fused_step"].srt_table_insert(ctypes.byref(args)),
              "staged insert")
    _count("table_insert")


# --- the staged step (csrc/staged.cu) -------------------------------------

def staged_args(*, ctr, stats, bufs, sb, q, log, elog, plans: dict,
                qlimit: int, elimit: int, model, layout,
                sound: bool) -> StagedArgs:
    """The ``StagedArgs`` of a staged chunk on the card: the counter
    block ``ctr`` (its layout ``layout``), the step's stats vector, K1's
    buffers ``bufs`` (:func:`step_buffers` at the large plan's rows) and
    the staged buffers ``sb`` (``ops/staged.py`` ``staged_buffers`` of
    the large plan), the queue, log and edge log (``None`` without one),
    the plans (``{1: small, 2: large}`` or ``{2: large}``), the limits of
    ``q_tail`` and ``e_n`` before a step. The stream is set at each
    launch."""
    from .fused import property_masks
    dev = ctr.device
    large = plans[2]
    small = plans.get(1)
    _check(ctr, "ctr", torch.int32, 1, dev)
    _check(q, "q", torch.int32, 2, dev)
    _check(log, "log", torch.int32, 2, dev)
    if elog is not None:
        _check(elog, "elog", torch.int32, 2, dev)
    n_props = len(model.properties())
    w, a = model.packed_width, model.max_actions
    sym = log.shape[1] == 6
    if (q.shape[1] != w + 3 or bufs["cvalid"].shape[0] < large.f * a
            or sb.src.shape[0] < large.kraw or sb.lane.shape[0] < large.kfin
            or sb.pkey.shape[0] < large.f
            or (elog is not None and elog.shape[1] != 4)):
        raise ValueError("staged buffers do not fit this chunk")
    masks = property_masks(model)

    def plan_c(p):
        return (StagedPlanC(0, 0, 0) if p is None
                else StagedPlanC(p.f, p.kraw, p.kfin))

    return StagedArgs(
        ctr=ctr.data_ptr(), stats=stats.data_ptr(),
        sctl=sb.sctl.data_ptr(), cvalid=bufs["cvalid"].data_ptr(),
        pbits=bufs["pbits"].data_ptr(), terminal=bufs["terminal"].data_ptr(),
        ebits_out=bufs["ebits_out"].data_ptr(), flat=bufs["flat"].data_ptr(),
        chi=bufs["chi"].data_ptr(), clo=bufs["clo"].data_ptr(),
        ohi=bufs["ohi"].data_ptr() if sym else None,
        olo=bufs["olo"].data_ptr() if sym else None,
        src=sb.src.data_ptr(), rvalid=sb.rvalid.data_ptr(),
        dvalid=sb.dvalid.data_ptr(), pkey=sb.pkey.data_ptr(),
        lane=sb.lane.data_ptr(), khi=sb.khi.data_ptr(),
        klo=sb.klo.data_ptr(), kvalid=sb.kvalid.data_ptr(),
        inserted=sb.inserted.data_ptr(), sel=sb.sel.data_ptr(),
        arena=sb.arena.data_ptr(),
        bcount=sb.bcount.data_ptr(), sdisc=sb.sdisc.data_ptr(), q=q.data_ptr(), log=log.data_ptr(),
        elog=None if elog is None else elog.data_ptr(), qlimit=qlimit,
        elimit=elimit, P=n_props, pcols=max(n_props, 1), W=w, A=a,
        log_cols=log.shape[1], stats_len=stats.shape[0], ext=layout.ext,
        recent=layout.recent, cch=layout.cch, sound=int(sound),
        always_mask=masks[Expectation.ALWAYS],
        sometimes_mask=masks[Expectation.SOMETIMES],
        ev_mask=masks[Expectation.EVENTUALLY],
        small=plan_c(small), large=plan_c(large))


def _staged_launch(entry: str, name: str, what: str, args: StagedArgs,
                   device, *ints) -> None:
    build()
    args.stream = torch.cuda.current_stream(device).cuda_stream
    _raise_on(getattr(_LIB["staged"], entry)(ctypes.byref(args), *ints),
              what)
    _count(name)


def stage(args: StagedArgs, device, size: int) -> None:
    """Launch KS1 of step size ``size`` (1 small, 2 large; gated)."""
    _staged_launch("srt_stage", "stage", "stage", args, device, size)


def predup(args: StagedArgs, device, size: int, cells: int) -> None:
    """Launch KS2 of step size ``size`` (gated) over an arena of
    ``cells`` cells (``ops/staged.py`` ``pre_dedup_arena_cells`` of the
    size's ``kraw``)."""
    _staged_launch("srt_predup", "predup", "pre-dedup", args, device, size,
                   cells)


def staged_append(args: StagedArgs, device) -> None:
    """Launch KS3 over the step the gate picked, with the carry update
    and the next gate."""
    _staged_launch("srt_staged_append", "staged_append", "staged append",
                   args, device)


# --- the chunk (csrc/chunk.cu) -----------------------------------------

def append_tile(lanes: int, sms: int, width: int = 0) -> int:
    """K7's tile size for steps of up to ``lanes`` lanes of ``width``-word
    rows on a card of ``sms`` SMs. Rows of ``width + 3 <= 256`` words
    take the largest of 1,024 and 4,096 lanes that still gives at least
    three tiles for every four SMs (fewer, longer tiles shorten the
    look-back; more, shorter ones spread the row writes: on an H100,
    2pc7's 454,656 lanes take 4,096-lane tiles, IncrementLock(9)'s
    110,592 and Increment(16)'s 196,608 take 1,024;
    ``tools/torch_append_sweep.py``), else 1,024; wider rows
    ``APPEND_WIDE_TILE``."""
    if width + 3 > APPEND_THREADS:
        return APPEND_WIDE_TILE
    want = (3 * sms) // 4
    narrow = [t for t in APPEND_TILES if t != APPEND_WIDE_TILE]
    for tile in sorted(narrow, reverse=True):
        if lanes // tile >= want:
            return tile
    return min(narrow)


def append_grid(lanes: int, tile_lanes: int) -> int:
    """K7's blocks for steps of up to ``lanes`` lanes: one per tile of
    ``tile_lanes`` lanes, and the tail."""
    return max(1, -(-lanes // tile_lanes)) + 1


def append_scratch(lanes: int, tile: int, device) -> dict:
    """K7's scan state for steps of up to ``lanes`` lanes in tiles of
    ``tile`` lanes, zeroed (no epoch matches it): ``status`` (int64, one
    status word per block of the grid), ``ticket`` (int64 control words)
    and ``tile``. Every K7 launch leaves them ready for the next. A
    launch's epoch is its tickets over its blocks, so the scratch fixes
    the grid: :func:`chunk_args` takes its tile size from it and refuses
    it for a chunk of another grid."""
    if tile not in APPEND_TILES:
        raise ValueError(f"K7 has no {tile}-lane tile")
    return {"status": torch.zeros((append_grid(lanes, tile),),
                                  dtype=torch.int64, device=device),
            "ticket": torch.zeros((APPEND_TICKETS,), dtype=torch.int64,
                                  device=device),
            "tile": tile}


def chunk_args(*, ctr, bufs, q, log, scratch, qlimit: int, n_props: int,
               width: int, n_actions: int, f_small: int, f_large: int,
               ext: int, recent: int, cch: int) -> ChunkArgs:
    """The ``ChunkArgs`` of a chunk on the card: the counter block
    ``ctr`` (int32, its layout from ``ext``, ``recent`` and ``cch``),
    the step buffers ``bufs`` (:func:`step_buffers` at ``f_large`` rows,
    shared by both sizes; ``f_small`` 0: one size), the queue ``q``
    (int32 ``[qcap, width + 3]``) and log (int32 ``[cap, 4 or 6]``), K7's
    :func:`append_scratch` ``scratch`` (made for ``f_large`` rows: its
    grid must be this chunk's) and ``qlimit``, the most ``q_tail`` may be
    before an iteration. The stream is set at each launch."""
    dev = ctr.device
    lanes = f_large * n_actions
    status, ticket, tile = (scratch["status"], scratch["ticket"],
                            scratch["tile"])
    _check(ctr, "ctr", torch.int32, 1, dev)
    _check(q, "q", torch.int32, 2, dev)
    _check(log, "log", torch.int32, 2, dev)
    _check(status, "status", torch.int64, 1, dev)
    _check(ticket, "ticket", torch.int64, 1, dev)
    if q.shape[1] != width + 3 or log.shape[1] not in (4, 6):
        raise ValueError("q must be [qcap, W+3] and log [cap, 4 or 6]")
    # past ext: the port's seven fields, then the gate's six
    if (tile not in APPEND_TILES or ext + 13 > ctr.shape[0]
            or status.shape[0] != append_grid(lanes, tile)
            or ticket.shape[0] < APPEND_TICKETS
            or bufs["inserted"].shape[0] < lanes
            or bufs["inserted"].data_ptr() % 16
            or not 0 <= f_small <= f_large):
        raise ValueError("chunk buffers do not fit this chunk")
    sym = log.shape[1] == 6
    if sym == (bufs["ohi"] is bufs["chi"]):
        raise ValueError("a 6-column log needs the symmetric step's "
                         "ohi/olo, and only it")
    return ChunkArgs(
        ctr=ctr.data_ptr(), stats=bufs["stats"].data_ptr(),
        inserted=bufs["inserted"].data_ptr(), flat=bufs["flat"].data_ptr(),
        ebits=bufs["ebits_out"].data_ptr(), chi=bufs["chi"].data_ptr(),
        clo=bufs["clo"].data_ptr(),
        ohi=bufs["ohi"].data_ptr() if sym else None,
        olo=bufs["olo"].data_ptr() if sym else None,
        q=q.data_ptr(), log=log.data_ptr(), status=status.data_ptr(),
        ticket=ticket.data_ptr(), qlimit=qlimit, P=n_props, W=width,
        A=n_actions, log_cols=log.shape[1],
        stats_len=bufs["stats"].shape[0], f_small=f_small, f_large=f_large,
        ext=ext, recent=recent, cch=cch, tile_lanes=tile)


def chunk_begin_args(*, ctr, stats, qlimit: int, n_props: int,
                     f_small: int, f_large: int, ext: int,
                     cch: int) -> ChunkArgs:
    """The ``ChunkArgs`` :func:`chunk_begin` reads, for a chunk with no
    K7 (the staged chunk, whose KS3 appends): the counter block ``ctr``
    (its port's fields at ``ext``, the ring hits at ``cch``), the step's
    stats vector, the step sizes and the limit of ``q_tail`` before an
    iteration."""
    dev = ctr.device
    _check(ctr, "ctr", torch.int32, 1, dev)
    _check(stats, "stats", torch.int32, 1, dev)
    if ext + 13 > ctr.shape[0] or not 0 <= f_small <= f_large:
        raise ValueError("the counter block does not fit this chunk")
    return ChunkArgs(ctr=ctr.data_ptr(), stats=stats.data_ptr(),
                     qlimit=qlimit, P=n_props, stats_len=stats.shape[0],
                     f_small=f_small, f_large=f_large, ext=ext, cch=cch)


def _chunk_launch(entry: str, name: str, what: str, args: ChunkArgs,
                  device, *ints) -> None:
    build()
    args.stream = torch.cuda.current_stream(device).cuda_stream
    _raise_on(getattr(_LIB["chunk"], entry)(ctypes.byref(args), *ints),
              what)
    _count(name)


def chunk_begin(args: ChunkArgs, device, steps: int, target: int,
                grow_limit: int, tag: int,
                elimit: int = (1 << 31) - 1) -> None:
    """Launch the chunk's start: its ``steps``, ``target`` (the
    generated-transitions budget), ``grow_limit`` and first step ``tag``
    into the counter block, the per-chunk counters zeroed, then the
    first iteration's gate (the step's stats vector zeroed, the loop
    condition on the counters, the step size, window and tag), with
    ``e_n`` held to ``elimit`` (the staged chunk's edge log; the fused
    chunk keeps none)."""
    _chunk_launch("srt_chunk_begin", "chunk_begin", "chunk begin", args,
                  device, steps, target, grow_limit, tag, elimit)


def append(args: ChunkArgs, device) -> None:
    """Launch K7 over the step the gate picked: the inserted lanes'
    queue and log rows in lane order at the gate's q_tail and log_n,
    then the carry update and the next iteration's gate."""
    _chunk_launch("srt_append", "append", "append", args, device)


# --- the history stage (csrc/history.cu) ---------------------------------

#: K8's rows per tile and threads per block (``csrc/history.cu``
#: ``kHistTileRows``, ``kHistThreads``)
HIST_TILE_ROWS = 256
HIST_THREADS = 512
#: K8's most blocks per SM: its grid is at most this many per SM, fewer
#: when its scratch holds fewer tiles
HIST_BLOCKS_PER_SM = 2


def _hist_tiles(cap: int) -> int:
    """K8's tiles for at most ``cap`` rows (at least one)."""
    return max(1, -(-cap // HIST_TILE_ROWS))


def history_grid(cap: int, sms: int) -> int:
    """K8's blocks for at most ``cap`` rows on a card of ``sms`` SMs:
    one per tile of ``HIST_TILE_ROWS`` rows, at most
    ``HIST_BLOCKS_PER_SM`` per SM (a block then takes several tiles),
    at least one."""
    return max(1, min(_hist_tiles(cap), HIST_BLOCKS_PER_SM * sms))


def history_scratch(cap: int, device) -> dict:
    """K8's scratch for at most ``cap`` rows a launch: ``tile_n`` (int32,
    one count per tile), ``akey`` (int64) and ``arow`` (int32), a tile's
    absent rows in its own range of ``HIST_TILE_ROWS``, and ``ctl``
    (int32 ``[2]``, zeroed: the blocks arrived and the lookups' overflow
    flag, which every launch leaves zero). Made once, outside any
    graph."""
    tiles = _hist_tiles(cap)
    return {"tile_n": torch.zeros((tiles,), dtype=torch.int32,
                                  device=device),
            "akey": torch.zeros((tiles * HIST_TILE_ROWS,), dtype=torch.int64,
                                device=device),
            "arow": torch.zeros((tiles * HIST_TILE_ROWS,), dtype=torch.int32,
                                device=device),
            "ctl": torch.zeros((2,), dtype=torch.int32, device=device),
            "cap": cap}


def _hist_args(q, hist, scratch) -> HistArgs:
    dev = q.device
    _check(q, "q", torch.int32, 2, dev)
    _check(hist.table, "history table", torch.int64, 2, dev)
    _check(hist.hidx, "hidx", torch.int32, 1, dev)
    _check(hist.hdone, "hdone", torch.int32, 1, dev)
    if (hist.table.shape[1] != 4 or hist.hwidth < 1
            or hist.hoff + hist.hwidth > q.shape[1] - 3):
        raise ValueError("the history stage does not fit this queue")
    cap = scratch["cap"]
    tiles = _hist_tiles(cap)
    for name, dtype, n in (("tile_n", torch.int32, tiles),
                           ("akey", torch.int64, tiles * HIST_TILE_ROWS),
                           ("arow", torch.int32, tiles * HIST_TILE_ROWS),
                           ("ctl", torch.int32, 2)):
        _check(scratch[name], name, dtype, 1, dev)
        if scratch[name].shape[0] < n:
            raise ValueError(f"K8's scratch {name} holds fewer than "
                             f"{cap} rows")
    return HistArgs(q=q.data_ptr(), qstride=q.stride(0), hoff=hist.hoff,
                    hwidth=hist.hwidth, keys=hist.table.data_ptr(),
                    n_buckets=hist.table.shape[0],
                    max_rounds=hist.max_rounds,
                    tile_n=scratch["tile_n"].data_ptr(),
                    akey=scratch["akey"].data_ptr(),
                    arow=scratch["arow"].data_ptr(),
                    ctl=scratch["ctl"].data_ptr(), cap=cap,
                    blocks=history_grid(cap, sm_count(dev)))


def history_chunk_args(ctr, ext: int, q, hist, scratch) -> HistArgs:
    """K8's arguments in a chunk: the rows from ``hist.hdone`` to the
    queue tail of the counter block ``ctr`` (its port fields from
    ``ext``), ``h_n`` and ``hovf`` the block's, an overflow shutting its
    gate; ``scratch`` a :func:`history_scratch` for the most rows one
    iteration appends (more count as an overflow)."""
    from ..checker.device_loop import B_H_N, B_HOVF, B_Q_TAIL, E_GATE
    _check(ctr, "ctr", torch.int32, 1, q.device)
    args = _hist_args(q, hist, scratch)
    base = ctr.data_ptr()
    args.start = hist.hdone.data_ptr()
    args.end = base + 4 * B_Q_TAIL
    args.hidx = hist.hidx.data_ptr()
    args.h_n = base + 4 * B_H_N
    args.ovf = base + 4 * B_HOVF
    args.gate = base + 4 * (ext + E_GATE)
    return args


def history(args: HistArgs, device) -> None:
    """Launch K8 with ``args`` (:func:`history_chunk_args`)."""
    build()
    args.stream = torch.cuda.current_stream(device).cuda_stream
    _raise_on(_LIB["history"].srt_history(ctypes.byref(args)),
              "history insert")
    _count("history")


def history_insert(q, hist, *, index=None, start: int = 0, end: int = 0,
                   append: bool = True, h_n: int = 0) -> "tuple":
    """K8 outside a chunk: the rows ``index`` (int32 queue indices, the
    re-seed) or ``[start, end)`` (the rescan) into ``hist.table``, each
    fresh key's row appended to ``hist.hidx`` at ``h_n`` when
    ``append``, with a scratch of its own for these rows. Returns
    ``(h_n, overflowed)`` (one synchronising read: growth only)."""
    dev = q.device
    ctl = torch.tensor([start, end, h_n, 0], dtype=torch.int32, device=dev)
    base = ctl.data_ptr()
    if index is not None:
        index = index.to(torch.int32).contiguous()
        _check(index, "index", torch.int32, 1, dev)
        if not index.shape[0]:
            return h_n, False
        rows = index.shape[0]
    else:
        rows = max(0, end - start)
    args = _hist_args(q, hist, history_scratch(rows, dev))
    if index is not None:
        args.index, args.count = index.data_ptr(), index.shape[0]
    else:
        args.start, args.end = base, base + 4
    args.hidx = hist.hidx.data_ptr() if append else None
    args.h_n, args.ovf = base + 8, base + 12
    history(args, dev)
    out = ctl.tolist()
    return out[2], bool(out[3])


def hpull(q, hidx, log, start: int, n_init: int, out, h_n=None,
          count: int = 0) -> None:
    """Launch K9: ``out`` (int32 ``[rows, W + 2]``) row ``i`` the queue
    row ``hidx[start + i]`` and its witness fingerprint (the log's child
    key at that index ``- n_init``), for ``i`` below ``*h_n - start``
    (``h_n`` a one-element int32 device tensor: the counter block's) or
    ``count``; the other rows zero."""
    build()
    dev = q.device
    _check(q, "q", torch.int32, 2, dev)
    _check(hidx, "hidx", torch.int32, 1, dev)
    _check(log, "log", torch.int32, 2, dev)
    _check(out, "out", torch.int32, 2, dev)
    w = q.shape[1] - 3
    if out.shape[1] != w + 2 or not out.shape[0]:
        raise ValueError("out must be [rows, W + 2]")
    if h_n is not None:
        _check(h_n, "h_n", torch.int32, 1, dev)
    args = HpullArgs(q=q.data_ptr(), qstride=q.stride(0), W=w,
                     hidx=hidx.data_ptr(), log=log.data_ptr(),
                     log_cols=log.shape[1], n_init=n_init, start=start,
                     h_n=None if h_n is None else h_n.data_ptr(),
                     count=count, out=out.data_ptr(), rows=out.shape[0],
                     stream=torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(_LIB["history"].srt_hpull(ctypes.byref(args)),
              "representative pull")
    _count("hpull")


class ChunkGraph:
    """One loop iteration captured as a CUDA graph: ``record()`` (the
    wrappers' launches on the current stream) runs once inside the
    capture, on a side stream of ``device``, and the capture raises if it
    fails; every :meth:`replay` launches the graph on the current stream,
    raises if the launch fails, and adds the launches each wrapper
    recorded to ``LAUNCHES``. The kernels must have been launched once
    before (a launch outside the capture loads them and sets their
    attributes). Nothing is allocated inside the capture, so the capture
    neither collects garbage nor empties torch's allocator cache, as
    ``torch.cuda.graph`` would. A replay of ``times`` launches is one call
    into ``csrc/chunk.cu`` (``srt_graph_launch``), which gives up the
    interpreter lock once, not once a launch: another Python thread (the
    race's host BFS) then delays it once a chunk."""

    def __init__(self, record, device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with _CAPTURE_LOCK:
            _CAPTURE.counts = {}
            try:
                with torch.cuda.stream(stream):
                    self.graph.capture_begin(capture_error_mode="relaxed")
                    try:
                        record()
                    except BaseException:
                        try:  # end the capture; the launch error is news
                            self.graph.capture_end()
                        except RuntimeError:
                            pass
                        raise
                    self.graph.capture_end()
                self.counts = dict(_CAPTURE.counts)
            finally:
                _CAPTURE.counts = None
        torch.cuda.current_stream(device).wait_stream(stream)
        if not self.counts:
            raise RuntimeError("the chunk's graph captured no launch")

    def replay(self, times: int) -> None:
        build()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _raise_on(_LIB["chunk"].srt_graph_launch(
            self.graph.raw_cuda_graph_exec(), stream, times), "graph replay")
        for name, n in self.counts.items():
            LAUNCHES[name] += n * times
