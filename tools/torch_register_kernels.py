#!/usr/bin/env python3
"""The ordered register path's kernels on the card, at the steps its runs
launch, and the runs around them, one JSON line per tree and
measurement.

    python tools/torch_register_kernels.py
    python tools/torch_register_kernels.py --old build/parent

The shapes are ``chip_smoke.py``'s ``REGISTER_STEPS``: a mid-search
carry of each ordered ABD configuration (the BASELINE's
PackedAbd(2, ordered=True) at its 256-row step, abd3 at 1,728 rows,
tpu_abd2 at 1,055), built by the tree's own loop (its digest printed, so
two trees are compared on the same carry). On each: K1-K3 (one
``fused_step``) timed with CUDA events and under ``torch.profiler`` (K1's
own device ms) before any plain version runs, with a digest of its
outputs on the lanes K1 writes (the same in both trees when both compute
the same function) and K1's bound (bytes of the written children); at
abd3's and tpu_abd2's rows K7 (``check_append``: held to
``append_reference`` bit for bit, device ms, bound). Then the other K1s,
timed alike, which the redesign must leave as they were: TwoPhaseSys(7)
and IncrementLock(9) at 12,288 rows, PackedPaxos(3) at 8,192,
PackedAbd(2) at 256 and PackedSingleCopy(3) at 9,954 (588 pending), and
K7 at 2pc7's narrow rows. Last, abd3 (36,213 states) and tpu_abd2
(bounded at 100,000 generated) end to end, twice each for the wall and
once under ``torch.profiler`` (device ms by kernel, busy share).

``--sweep`` times K1-abd_ordered instead at each ordered step over
other launches of this tree (no rebuild: ``ops/_cuda.py``
``EDIT_THREADS`` and ``EDIT_BLOCKS_PER_SM`` set before each), its
outputs' digest beside each.

``--old DIR`` also times another tree of the repository (the parent
commit unpacked there: ``git archive HEAD~ stateright_tpu_torch
chip_smoke.py | tar -x -C build/parent``), built from its own sources,
in separate processes in the order old, new, new, old, in the same
call. Needs a CUDA device; every line carries the card's name and power
limit from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the kernels whose registers each line reports (``chip_smoke.py``
#: ``ptxas_usage`` names, by library)
KERNELS = (("fused_step", "expand_kernel[AbdOrderedModel]"),
           ("fused_step", "expand_kernel[AbdModel]"),
           ("fused_step", "expand_kernel[SingleCopyModel]"),
           ("fused_step", "expand_kernel[PaxosModel]"),
           ("fused_step", "expand_kernel[TwoPcModel]"),
           ("fused_step", "expand_kernel[IncrementLockModel]"),
           ("chunk", "append_kernel"), ("chunk", "append_kernel[1x128]"),
           ("chunk", "append_kernel[4x256]"),
           ("chunk", "append_kernel[16x256]"))
#: H100 SXM device memory bytes per second (the bound's rate)
HBM_BYTES_S = 3.35e12


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def carry_digest(carry) -> str:
    """sha256 of the carry's queue rows and its sorted table keys."""
    h = hashlib.sha256()
    h.update(carry.q[:carry.q_tail].cpu().numpy().tobytes())
    keys = carry.table[carry.table != 0].sort().values
    h.update(keys.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_k1(smoke, model, carry, f: int, reps: int, active=None) -> dict:
    """K1-K3 over ``f`` rows of ``carry`` (``chip_smoke.py``
    ``block_args``): CUDA-event ms of one step, the profiled device ms
    by kernel, a digest of the outputs on the lanes K1 writes (``active``
    for an edit model, else every lane), and K1's bound in bytes (the
    frontier, the row outputs, the written children, the lanes'
    fingerprints and flags, the ring arena reset). No plain version."""
    import torch

    from stateright_tpu_torch.ops.fused import StepWorkspace, fused_step

    block, args = smoke.block_args(model, carry, f)
    table0, ring0 = carry.table.clone(), carry.ring.clone()
    t_k, r_k = table0.clone(), ring0.clone()
    ws = StepWorkspace(table0.numel(), ring0.shape[0],
                       len(model.properties()), block.device)

    def restore():
        t_k.copy_(table0)
        r_k.copy_(ring0)

    def launch():
        return fused_step(model, *args, t_k, r_k, ws)

    out = launch()
    torch.cuda.synchronize()
    a, w = model.max_actions, model.packed_width
    lanes = f * a
    written = (torch.ones((lanes,), dtype=torch.bool, device=block.device)
               if active is None else active(args[0]))
    h = hashlib.sha256()
    for name in ("flat", "chi", "clo"):
        h.update(getattr(out, name)[written].cpu().numpy().tobytes())
    for name in ("cvalid", "pbits", "ebits", "terminal", "stats"):
        h.update(getattr(out, name).cpu().numpy().tobytes())
    n_written = int(written.sum())
    ms = smoke.cuda_ms(launch, reps, restore)
    dev = smoke.device_times(launch, before=restore)
    by = dev.get("by_kernel_ms") or {}
    pcols = max(len(model.properties()), 1)
    k1_bytes = (f * (4 * w + 4 + 1) + f * (pcols + 4 + 1)
                + n_written * 4 * w + lanes * (8 + 1)
                + ring0.shape[0] * 8)
    return {"f": f, "lanes": lanes, "written": n_written,
            "outputs": h.hexdigest()[:16], "step_ms": ms,
            "step_device_ms": dev.get("ours_ms"),
            "k1_device_ms": by.get("expand_kernel"),
            "by_kernel_ms": by, "k1_bytes": k1_bytes,
            "k1_bound_ms": k1_bytes / HBM_BYTES_S * 1e3}


#: ``--sweep``'s launches: (threads a block, blocks an SM)
SWEEP = ((64, 3), (128, 2), (128, 3), (128, 4), (128, 6), (128, 8),
         (256, 2), (256, 3), (256, 4))


def sweep(reps: int) -> int:
    """K1-abd_ordered at each ordered ``REGISTER_STEPS`` step of this
    tree over the launches of ``SWEEP``."""
    sys.path.insert(0, ROOT)
    import torch

    from stateright_tpu_torch.ops import _cuda

    smoke = importlib.import_module("chip_smoke")
    dev = torch.device("cuda", 0)
    info = _cuda.build()
    head = {"tree": ROOT, "card": card(), "build_s": info["seconds"]}
    default = (_cuda.EDIT_THREADS, _cuda.EDIT_BLOCKS_PER_SM)
    for label, make, name, rows, pending in smoke.REGISTER_STEPS:
        if name != "abd_ordered":
            continue
        model = make()
        carry = smoke.mid_search_carry(model, dev, rows=rows,
                                       pending=pending)
        for threads, per_sm in SWEEP:
            _cuda.EDIT_THREADS, _cuda.EDIT_BLOCKS_PER_SM = threads, per_sm
            res = time_k1(smoke, model, carry, rows, reps,
                          smoke.ordered_active(model))
            geo = _cuda.k1_launch(name, _cuda.tile_geometry(
                rows, model.max_actions, _cuda.sm_count(dev)), rows,
                model.packed_width, model.max_actions,
                _cuda.sm_count(dev))
            print(json.dumps({**head, "sweep": label, "threads": threads,
                              "per_sm": per_sm,
                              "launch": {**geo[0]._asdict(),
                                         "smem_bytes": geo[1]},
                              **{k: res[k] for k in (
                                  "outputs", "k1_device_ms",
                                  "step_device_ms", "step_ms",
                                  "k1_bound_ms")}}), flush=True)
        _cuda.EDIT_THREADS, _cuda.EDIT_BLOCKS_PER_SM = default
        del carry
    return 0


def run_tree(tree: str, reps: int) -> int:
    """Time the ordered register path's kernels and runs of the
    repository at ``tree`` (its own package, build and
    ``chip_smoke.py``) in this process."""
    sys.path.insert(0, tree)
    import torch

    import stateright_tpu_torch as pkg
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    from stateright_tpu_torch.ops import _cuda

    smoke = importlib.import_module("chip_smoke")
    if not smoke.__file__.startswith(tree):
        raise RuntimeError(f"imported {smoke.__file__}, not {tree}'s")
    dev = torch.device("cuda", 0)
    info = _cuda.build()
    usage = {name: smoke.ptxas_usage(info["logs"].get(lib, "")).get(name)
             for lib, name in KERNELS}
    head = {"tree": tree, "card": card(), "build_s": info["seconds"]}
    print(json.dumps({**head, "usage": {k: v for k, v in usage.items()
                                        if v is not None}}), flush=True)

    def emit(**line):
        print(json.dumps({**head, **line}), flush=True)

    # the edit K1 at each ordered step, and K7 at the wide rows
    for label, make, name, rows, pending in smoke.REGISTER_STEPS:
        if name != "abd_ordered":
            continue
        model = make()
        carry = smoke.mid_search_carry(model, dev, rows=rows,
                                       pending=pending)
        digest = carry_digest(carry)
        res = time_k1(smoke, model, carry, rows, reps,
                      smoke.ordered_active(model))
        emit(kernel="K1-abd_ordered", model=label, carry=digest,
             width=model.packed_width, **res)
        if rows > 256:
            app = smoke.check_append(model, carry, rows, reps)
            emit(kernel="K7", model=label, carry=digest,
                 width=model.packed_width,
                 **{k: app.get(k) for k in (
                     "lanes", "appended", "ms", "device_ms", "plain_ms",
                     "bytes", "bound_ms", "bound_by", "max_abs_err",
                     "checks")})
        del carry
    # the other K1s and narrow-row K7, which must stay as they were
    others = (
        ("2pc7", lambda: pkg.TwoPhaseSys(7), 12288, None),
        ("lock9", lambda: pkg.IncrementLock(9), 12288, None),
        ("paxos3", lambda: PackedPaxos(3), 8192, None),
        ("abd2", lambda: smoke._abd(2), 256, 48),
        ("single_copy3", lambda: smoke._single_copy(3), 9954, 512))
    for label, make, rows, pending in others:
        model = make()
        carry = smoke.mid_search_carry(model, dev, rows=rows,
                                       pending=pending)
        digest = carry_digest(carry)
        res = time_k1(smoke, model, carry, rows, reps)
        emit(kernel=f"K1 {label}", carry=digest, **res)
        if label == "2pc7":
            app = smoke.check_append(model, carry, rows, reps)
            emit(kernel="K7", model="TwoPhaseSys(7)", carry=digest,
                 width=model.packed_width,
                 **{k: app.get(k) for k in (
                     "lanes", "appended", "ms", "device_ms", "plain_ms",
                     "bytes", "bound_ms", "bound_by", "max_abs_err",
                     "checks")})
        del carry
    # the ordered register runs end to end
    abd3 = dict(server_count=2, ordered=True, channel_depth=8)
    abd2s3 = dict(server_count=3, ordered=True, channel_depth=8)
    path = ("fused_step", "chunk_begin", "append", "history", "hpull")
    runs = (("abd3", lambda: smoke._abd(3, **abd3), smoke.PIN_ABD3, None,
             {}),
            ("tpu_abd2", lambda: smoke._abd(2, **abd2s3), None,
             smoke.ABD2_TARGET, {"capacity": 1 << 21}))
    keys = ("wall_s", "unique", "generated", "digest", "loop_s",
            "host_eval_s", "histories", "iterations", "graph_launches",
            "launches", "checks")
    for label, make, want, target, opts in runs:
        for turn in range(2):
            res, ck = smoke.register_run(make(), path, want=want,
                                         holds=("linearizable",),
                                         target=target, **opts)
            del ck
            emit(run=label, turn=turn, **{k: res.get(k) for k in keys})

        def one(make=make, target=target, opts=opts):
            builder = make().checker().gpu_options(race=False, **opts)
            if target is not None:
                builder = builder.target_state_count(target)
            return builder.spawn_gpu().join()
        prof = smoke.device_times(one)
        emit(run=label, profiled=True, **{k: prof.get(k) for k in (
            "loop_s", "busy", "ours_ms", "torch_ms", "copy_ms",
            "by_kernel_ms", "by_kernel_calls", "graph_launches")})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--old", help="the root of another tree of the "
                    "repository, timed before and after this one")
    ap.add_argument("--sweep", action="store_true",
                    help="time K1-abd_ordered over other launches")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_register_kernels: no CUDA device", file=sys.stderr)
        return 2
    if args.tree:
        return run_tree(args.tree, args.reps)
    if args.sweep:
        return sweep(args.reps)
    print(card(), flush=True)
    trees = [ROOT] if not args.old else [
        os.path.abspath(args.old), ROOT, ROOT, os.path.abspath(args.old)]
    for tree in trees:
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree,
               "--reps", str(args.reps)]
        rc = subprocess.run(cmd, cwd=tree).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
