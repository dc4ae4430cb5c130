#!/usr/bin/env python3
"""The flat insert (K4, the stand-alone insert, and K6, the owner-side
probe) on the card, with a mask and (K4) without, and the kernels it
replaced, one JSON line per tree, shape and setting.

    python tools/torch_insert_sweep.py
    python tools/torch_insert_sweep.py --old build/parent

The shapes are ``chip_smoke.py``'s: K6 at the received width of the
default one-rank sharded 2pc7 run (the lanes a 12,288-row probe-free
step kept, compacted ahead of padding, into the mid-search table), the
same lanes twice over, and K4 at the growth re-insert (the mid-search
log twice into an empty 2**20-slot table, with a mask and without one,
as the seed and growth call it). For each it holds the result to the
plain version (table key set; with a mask the inserted key set and the
lowest valid lane of each fresh key) and reads the mean device time per
call over ``--reps`` calls from ``torch.profiler``: the port's kernels
and every kernel of the call (torch's too), the kernel's own bound
(``chip_smoke.py`` ``insert_parts``), and the CUDA-event time of one
call.

``--old DIR`` also times the kernels of another tree of the repository
(the parent commit unpacked there, e.g. ``git archive HEAD
stateright_tpu_torch chip_smoke.py | tar -x -C build/parent``), built
from its own sources, in separate processes in the order old, new, new,
old, in the same call. Needs a CUDA device; every line carries the
card's name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def this_smoke():
    """This checkout's ``chip_smoke.py`` (its checks and bounds), whatever
    tree's package is imported."""
    spec = importlib.util.spec_from_file_location(
        "this_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

#: the flat insert's kernels and the ones it replaced, by profiler name
#: (longer names first: a name that contains another is matched as itself)
NAMES = ("flat_insert_kernel", "probe_claim_kernel", "probe_commit_kernel",
         "insert_kernel")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def device_ms(launch, restore, reps: int) -> dict:
    """Mean device ms per call: by kernel of ``NAMES``, and over every
    kernel of the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    restore()
    launch()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            restore()
            launch()
        torch.cuda.synchronize()
    by_kernel, total = {}, 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ms = us / 1e3 / reps
        name = next((k for k in NAMES if k in e.key), None)
        if name:
            by_kernel[name] = by_kernel.get(name, 0.0) + ms
        elif "memcpy" in e.key.lower() and "DtoD" in e.key:
            continue  # the table's restore, outside the call
        total += ms
    return {"ours_ms": sum(by_kernel.values()), "all_ms": total,
            "by_kernel_ms": by_kernel}


def event_ms(launch, restore, reps: int) -> float:
    import torch
    total = 0.0
    for _ in range(reps):
        restore()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def shapes(dev):
    """``{label: (table0, hi, lo, valid, kernel)}`` of the three shapes;
    ``kernel`` is ``"probe_block"`` (K6) or ``"table_insert"`` (K4). The
    tree's own ``chip_smoke.py`` builds the mid-search state, through its
    own package's API."""
    import torch

    import chip_smoke
    from stateright_tpu_torch import TwoPhaseSys
    from stateright_tpu_torch.ops.fused import DedupWorkspace, fused_step
    from stateright_tpu_torch.ops.hashtable import make_table

    model = TwoPhaseSys(7)
    carry = chip_smoke.mid_search_carry(model, dev)
    _block, args = chip_smoke.block_args(model, carry, 12288)
    ws = DedupWorkspace(12288 * model.max_actions, carry.ring.shape[0],
                        len(model.properties()), dev)
    step = fused_step(model, *args, None, carry.ring, ws, probe=False)
    # the received lanes, as chip_smoke.py's check_probe builds them
    from stateright_tpu_torch.checker.device_loop import shrink_indices
    from stateright_tpu_torch.checker.gpu import candidate_sizes
    _kraw, kmax = candidate_sizes(model, 12288, {})
    count = int(step.dvalid.sum())
    if count > kmax:
        kmax = min(max(kmax * 2, -(-(count + count // 4) // 256) * 256),
                   12288 * model.max_actions)
    src = shrink_indices(step.dvalid, kmax)
    hi, lo = step.chi[src], step.clo[src]
    valid = torch.arange(kmax, device=dev) < count
    log = carry.log[:carry.log_n]
    return {
        "k6 main": (carry.table.clone(), hi, lo, valid, "probe_block"),
        "k6 twice": (carry.table.clone(), torch.cat([hi, hi]),
                     torch.cat([lo, lo]), torch.cat([valid, valid]),
                     "probe_block"),
        "k4 growth": (make_table(1 << 20, dev),
                      torch.cat([log[:, 0], log[:, 0]]),
                      torch.cat([log[:, 1], log[:, 1]]),
                      torch.ones((2 * carry.log_n,), dtype=torch.bool,
                                 device=dev), "table_insert"),
    }


def run_tree(tree: str, reps: int) -> int:
    """Time the flat insert of the repository at ``tree`` (its own
    package, its own build) in this process."""
    sys.path.insert(0, tree)
    import torch

    from stateright_tpu_torch.ops import _cuda, fused, hashtable
    from stateright_tpu_torch.ops.words import pack64

    smoke = this_smoke()

    dev = torch.device("cuda", 0)
    smi = card()
    info = _cuda.build()
    # the first cut's K4 has no workspace and no mask parameter
    new = "mask" in inspect.signature(hashtable.table_insert).parameters
    for label, (table0, hi, lo, valid, kernel) in shapes(dev).items():
        t_p = table0.clone()
        ins_p, _ovf = hashtable.table_insert_reference(t_p, hi, lo, valid)
        keys = pack64(hi, lo)
        want_keys = set(keys[ins_p].tolist())
        want_table = torch.sort(t_p[t_p != 0]).values
        t_k = table0.clone()
        ws = fused.StepWorkspace(t_k.numel(), 0, 0, dev)
        masks = (False, True) if new and kernel == "table_insert" else (True,)
        for mask in masks:
            if kernel == "probe_block":
                def launch():
                    return fused.probe_block(t_k, hi, lo, valid, ws)[0]
            elif new:
                def launch(mask=mask):
                    return hashtable.table_insert(t_k, hi, lo, valid, ws=ws,
                                                  mask=mask)[0]
            else:
                def launch():
                    return hashtable.table_insert(t_k, hi, lo, valid)[0]

            def restore():
                t_k.copy_(table0)

            restore()
            ins = launch()
            checks = {"table_set": torch.equal(
                torch.sort(t_k[t_k != 0]).values, want_table)}
            if mask:
                checks.update({
                    "inserted_set": set(keys[ins].tolist()) == want_keys,
                    "one_lane_per_key": int(ins.sum()) == len(want_keys),
                    "lowest_valid_lane_wins":
                        smoke.lowest_valid_lane_wins(keys, valid, ins)})
            dev_ms = device_ms(launch, restore, reps)
            line = {
                "tree": "new" if new else "old", "root": tree,
                "card": smi, "shape": label, "kernel": kernel,
                "mask": mask, "n": hi.shape[0], "valid": int(valid.sum()),
                "inserted": len(want_keys), "build_s": info["seconds"],
                **dev_ms,
                # the kernel's own bound (chip_smoke.py insert_parts)
                "parts": (smoke.insert_parts(keys, valid, len(want_keys),
                                             dev_ms["by_kernel_ms"], mask)
                          if new else None),
                "event_ms": event_ms(launch, restore, reps),
                "checks": checks}
            print(json.dumps(line), flush=True)
            # the first cut's K4 lets a racing lane win: not checked there
            if not all(v for k, v in checks.items() if new
                       or kernel != "table_insert"
                       or k != "lowest_valid_lane_wins"):
                raise AssertionError(f"{tree} {label} {mask}: {checks}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--old", help="the root of another tree of the "
                    "repository, timed before and after this one")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_insert_sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.tree:
        return run_tree(args.tree, args.reps)
    print(card(), flush=True)
    trees = [ROOT] if not args.old else [
        os.path.abspath(args.old), ROOT, ROOT, os.path.abspath(args.old)]
    for tree in trees:
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree,
               "--reps", str(args.reps)]
        rc = subprocess.run(cmd).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
