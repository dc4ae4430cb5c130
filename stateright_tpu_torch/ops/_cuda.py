"""Build and bind the CUDA kernels of ``stateright_tpu_torch/csrc``.

Each source (``fused_step.cu``: the single-chip step and the insert;
``sharded_step.cu``: the sharded engine's probe-free step and owner-side
probe) is compiled with ``nvcc`` for ``sm_90a`` into its own shared
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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..core import Expectation
from .fused import property_masks

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"
#: library name -> source under csrc/
_SOURCES = {"fused_step": "fused_step.cu", "sharded_step": "sharded_step.cu"}
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel launches per wrapper: ``fused_step`` (K1-K3 of one step),
#: ``table_insert`` (K4), ``fused_step_noprobe`` (K1 + K5 of one
#: probe-free step) and ``probe_block`` (K6)
LAUNCHES = {"fused_step": 0, "table_insert": 0, "fused_step_noprobe": 0,
            "probe_block": 0}

#: ``{"seconds": build time, "log": nvcc/ptxas output of every source,
#: "path": {library name: path}}``
BUILD_INFO: dict = {}

#: library name -> loaded ctypes library, once built
_LIB = None

_p = ctypes.c_void_p
_ll = ctypes.c_longlong
_i = ctypes.c_int
_u = ctypes.c_uint32


class StepArgs(ctypes.Structure):
    """``StepArgs`` of ``csrc/fused_step.cu``, field for field."""

    _fields_ = [
        ("frontier", _p), ("fstride", _ll), ("ebits", _p), ("estride", _ll),
        ("phi", _p), ("plo", _p), ("pstride", _ll), ("fvalid", _p),
        ("F", _i), ("A", _i), ("P", _i), ("pcols", _i),
        ("always_mask", _u), ("sometimes_mask", _u), ("ev_mask", _u),
        ("step", _u),
        ("pbits", _p), ("ebits_out", _p), ("terminal", _p), ("flat", _p),
        ("chi", _p), ("clo", _p), ("cvalid", _p), ("dvalid", _p),
        ("inserted", _p), ("lane_slot", _p), ("stats", _p),
        ("keys", _p), ("n_buckets", _ll), ("max_rounds", _i), ("cc", _i),
        ("owner", _p), ("stamp", _p), ("ring", _p), ("ring_arena", _p),
        ("disc_cand", _p), ("stream", _p),
    ]


class InsertArgs(ctypes.Structure):
    """``InsertArgs`` of ``csrc/fused_step.cu``, field for field."""

    _fields_ = [
        ("hi", _p), ("lo", _p), ("valid", _p), ("n", _ll), ("keys", _p),
        ("n_buckets", _ll), ("max_rounds", _i), ("inserted", _p),
        ("stats", _p), ("stream", _p),
    ]


class DedupArgs(ctypes.Structure):
    """``DedupArgs`` of ``csrc/sharded_step.cu``, field for field."""

    _fields_ = [
        ("s", StepArgs), ("pre_arena", _p), ("block_lanes", _ll),
        ("pre_cells", _ll), ("arena", _p), ("arena_owner", _p),
        ("cells", _ll),
    ]


class ProbeArgs(ctypes.Structure):
    """``ProbeArgs`` of ``csrc/sharded_step.cu``, field for field."""

    _fields_ = [
        ("hi", _p), ("lo", _p), ("valid", _p), ("n", _ll), ("keys", _p),
        ("n_buckets", _ll), ("max_rounds", _i), ("step", _u),
        ("owner", _p), ("stamp", _p), ("lane_slot", _p), ("inserted", _p),
        ("stats", _p), ("stream", _p),
    ]

#: per library: (C entry, argument struct, its size function, whether
#: the entry takes the model parameter) of each kernel
_ENTRIES = {
    "fused_step": [("srt_fused_step_twopc", StepArgs, "srt_step_args_size",
                    True),
                   ("srt_table_insert", InsertArgs, "srt_insert_args_size",
                    False)],
    "sharded_step": [("srt_dedup_step_twopc", DedupArgs,
                      "srt_dedup_args_size", True),
                     ("srt_probe_block", ProbeArgs, "srt_probe_args_size",
                      False)],
}


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
    global _LIB
    if _LIB is not None:
        return BUILD_INFO
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
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
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
            os.replace(tmp, todo[name])
    seconds = time.perf_counter() - t0
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for entry, struct, size_name, with_n in _ENTRIES[name]:
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.POINTER(struct)] + ([_i] if with_n else [])
            fn.restype = _i
            size_fn = getattr(lib, size_name)
            size_fn.argtypes = []
            size_fn.restype = _i
            if size_fn() != ctypes.sizeof(struct):
                raise RuntimeError(
                    f"{struct.__name__} layout differs between "
                    f"csrc/{_SOURCES[name]} and ops/_cuda.py")
        libs[name] = lib
    _LIB = libs
    BUILD_INFO.update(seconds=seconds, log="".join(logs.values()),
                      path={k: str(v) for k, v in paths.items()})
    return BUILD_INFO


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


def _step_args(model, frontier, ebits, fvalid, phi, plo, ring, ws,
               stats_len: int):
    """Check K1's inputs, allocate the step's outputs and fill the
    table-free fields of a ``StepArgs``; returns ``(params, outputs,
    lane_slot, args)`` where ``params`` are the model kernel's
    parameters and ``outputs`` the wrappers' return tuple."""
    name, params = model.cuda_spec()
    if name != "twopc":
        raise NotImplementedError(f"no CUDA step kernel for {name!r}")
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
    ws.step += 1
    masks = property_masks(model)
    pcols = max(n_props, 1)
    pbits = torch.empty((f, pcols), dtype=torch.bool, device=dev)
    ebits_out = torch.empty((f,), dtype=torch.int32, device=dev)
    terminal = torch.empty((f,), dtype=torch.bool, device=dev)
    flat = torch.empty((lanes, w), dtype=torch.int32, device=dev)
    chi = torch.empty((lanes,), dtype=torch.int32, device=dev)
    clo = torch.empty((lanes,), dtype=torch.int32, device=dev)
    cvalid = torch.empty((lanes,), dtype=torch.bool, device=dev)
    dvalid = torch.empty((lanes,), dtype=torch.bool, device=dev)
    inserted = torch.empty((lanes,), dtype=torch.bool, device=dev)
    lane_slot = torch.empty((lanes,), dtype=torch.int32, device=dev)
    stats = torch.zeros((stats_len,), dtype=torch.int32, device=dev)
    args = StepArgs(
        frontier=frontier.data_ptr(), fstride=frontier.stride(0),
        ebits=ebits.data_ptr(), estride=ebits.stride(0),
        phi=phi.data_ptr(), plo=plo.data_ptr(), pstride=phi.stride(0),
        fvalid=fvalid.data_ptr(), F=f, A=n_actions, P=n_props,
        pcols=pcols, always_mask=masks[Expectation.ALWAYS],
        sometimes_mask=masks[Expectation.SOMETIMES],
        ev_mask=masks[Expectation.EVENTUALLY], step=ws.step,
        pbits=pbits.data_ptr(), ebits_out=ebits_out.data_ptr(),
        terminal=terminal.data_ptr(), flat=flat.data_ptr(),
        chi=chi.data_ptr(), clo=clo.data_ptr(), cvalid=cvalid.data_ptr(),
        dvalid=dvalid.data_ptr(), inserted=inserted.data_ptr(),
        lane_slot=lane_slot.data_ptr(), stats=stats.data_ptr(),
        max_rounds=4096, cc=cc, ring=ring.data_ptr() if cc else None,
        ring_arena=ws.ring_arena.data_ptr(),
        disc_cand=ws.disc_cand.data_ptr(),
        stream=torch.cuda.current_stream(dev).cuda_stream)
    outputs = (pbits, ebits_out, terminal, flat, chi, clo, cvalid, dvalid,
               inserted, stats)
    return params, outputs, args


def fused_step(model, frontier, ebits, fvalid, phi, plo, table, ring, ws,
               stats_len: int):
    """Launch K1-K3 for one step; returns the output tensors
    ``(pbits, ebits, terminal, flat, chi, clo, cvalid, dvalid, inserted,
    stats)``. ``table`` and ``ring`` are updated in place."""
    build()
    lib = _LIB["fused_step"]
    dev = frontier.device
    _check(table, "table", torch.int64, 2, dev)
    capacity = table.numel()
    if table.shape[1] != 4 or capacity >= 1 << 31:
        raise ValueError("table must be [C/4, 4] with C < 2**31")
    ws.check(capacity, 0 if ring is None else ring.shape[0],
             len(model.properties()), dev)
    params, outputs, args = _step_args(model, frontier, ebits, fvalid, phi,
                                       plo, ring, ws, stats_len)
    args.keys = table.data_ptr()
    args.n_buckets = table.shape[0]
    args.owner = ws.owner.data_ptr()
    args.stamp = ws.stamp.data_ptr()
    _raise_on(lib.srt_fused_step_twopc(ctypes.byref(args), *params),
              "fused step")
    LAUNCHES["fused_step"] += 1
    return outputs


def fused_step_noprobe(model, frontier, ebits, fvalid, phi, plo, ring, ws,
                       block_rows: int, stats_len: int):
    """Launch K1 + K5 for one probe-free step; returns the same output
    tuple as :func:`fused_step` with ``inserted`` aliasing ``dvalid``.
    ``ring`` is read only; ``ws`` is a ``DedupWorkspace`` for this
    step's lanes. Pre-dedup blocks are ``block_rows`` frontier rows."""
    build()
    lib = _LIB["sharded_step"]
    f = frontier.shape[0]
    lanes = f * model.max_actions
    ws.check(lanes, block_rows * model.max_actions, frontier.device)
    params, outputs, args = _step_args(model, frontier, ebits, fvalid, phi,
                                       plo, ring, ws, stats_len)
    outputs = outputs[:8] + (outputs[7], outputs[9])
    dargs = DedupArgs(
        s=args, pre_arena=ws.pre_arena.data_ptr(),
        block_lanes=block_rows * model.max_actions,
        pre_cells=ws.pre_cells, arena=ws.arena.data_ptr(),
        arena_owner=ws.arena_owner.data_ptr(), cells=ws.arena.shape[0])
    _raise_on(lib.srt_dedup_step_twopc(ctypes.byref(dargs), *params),
              "probe-free step")
    LAUNCHES["fused_step_noprobe"] += 1
    return outputs


def probe_block(table, fhi, flo, valid, ws, max_rounds: int):
    """Launch K6: the owner-side probe of ``(fhi, flo)`` lanes against
    ``table`` (this rank's slice), in place. Returns ``(inserted,
    overflow, rounds)``, the two scalars as 0-d device tensors (no
    sync). ``ws`` is the table's ``StepWorkspace`` (owner and stamp
    words)."""
    build()
    lib = _LIB["sharded_step"]
    dev = table.device
    _check(table, "table", torch.int64, 2, dev)
    capacity = table.numel()
    if table.shape[1] != 4 or capacity >= 1 << 31:
        raise ValueError("table must be [C/4, 4] with C < 2**31")
    ws.check(capacity, 0, 0, dev)
    n = fhi.shape[0]
    hi = fhi.to(torch.int32).contiguous()
    lo = flo.to(torch.int32).contiguous()
    _check(hi, "fhi", torch.int32, 1, dev)
    _check(lo, "flo", torch.int32, 1, dev)
    _check(valid, "valid", torch.bool, 1, dev)
    if lo.shape[0] != n or valid.shape[0] != n or n >= 1 << 31:
        raise ValueError("fhi, flo and valid must have equal lengths "
                         "below 2**31")
    ws.step += 1
    inserted = torch.zeros((n,), dtype=torch.bool, device=dev)
    lane_slot = torch.empty((n,), dtype=torch.int32, device=dev)
    stats = torch.zeros((2,), dtype=torch.int32, device=dev)
    args = ProbeArgs(
        hi=hi.data_ptr(), lo=lo.data_ptr(), valid=valid.data_ptr(), n=n,
        keys=table.data_ptr(), n_buckets=table.shape[0],
        max_rounds=max_rounds, step=ws.step, owner=ws.owner.data_ptr(),
        stamp=ws.stamp.data_ptr(), lane_slot=lane_slot.data_ptr(),
        inserted=inserted.data_ptr(), stats=stats.data_ptr(),
        stream=torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib.srt_probe_block(ctypes.byref(args)), "owner-side probe")
    LAUNCHES["probe_block"] += 1
    return inserted, stats[0] > 0, stats[1]


def table_insert(table, fhi, flo, valid, max_rounds: int):
    """Launch K4: insert ``(fhi, flo)`` lanes into ``table`` in place.
    Returns ``(inserted, overflow, rounds)`` — the two scalars read back
    with one synchronising copy (seeding and growth only)."""
    build()
    lib = _LIB["fused_step"]
    dev = table.device
    _check(table, "table", torch.int64, 2, dev)
    n = fhi.shape[0]
    hi = fhi.to(torch.int32).contiguous()
    lo = flo.to(torch.int32).contiguous()
    _check(hi, "fhi", torch.int32, 1, dev)
    _check(lo, "flo", torch.int32, 1, dev)
    _check(valid, "valid", torch.bool, 1, dev)
    if lo.shape[0] != n or valid.shape[0] != n:
        raise ValueError("fhi, flo and valid must have equal lengths")
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=dev), False, 0
    inserted = torch.empty((n,), dtype=torch.bool, device=dev)
    stats = torch.zeros((2,), dtype=torch.int32, device=dev)
    args = InsertArgs(
        hi=hi.data_ptr(), lo=lo.data_ptr(), valid=valid.data_ptr(), n=n,
        keys=table.data_ptr(), n_buckets=table.shape[0],
        max_rounds=max_rounds, inserted=inserted.data_ptr(),
        stats=stats.data_ptr(),
        stream=torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib.srt_table_insert(ctypes.byref(args)), "table insert")
    LAUNCHES["table_insert"] += 1
    ovf, rounds = stats.tolist()
    return inserted, bool(ovf), int(rounds)
