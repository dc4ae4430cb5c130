#!/usr/bin/env python3
"""The tile geometry of the single-chip step's K1 (expand) and K2
(claim) on the card, one JSON line per step shape and geometry.

    python tools/torch_tile_sweep.py
    python tools/torch_tile_sweep.py --lanes 512 1024 2048 --threads 256

For each step shape of the main paths (2pc n=7 and, under symmetry,
2pc n=16 with both representatives, at F = 12,288 and 256 rows of a
mid-search frontier, as ``chip_smoke.py`` builds them) and each lane
budget and thread count, it sets ``ops/_cuda.py``'s ``TILE_LANES`` and
``TILE_THREADS`` (K1 and K2 share the tiles), launches the step on a
copy of the table, holds K1's outputs lane for lane and K2/K3's
inserted keys (one lane per key, the lowest valid lane) to the plain
version's, and reads
each kernel's mean device time over ``--reps`` launches from
``torch.profiler``. Needs a CUDA device; prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def kernel_ms(launch, restore, reps: int) -> dict:
    """Mean device ms per launch of each of the port's kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    restore()
    launch()  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            restore()
            launch()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        name = chip_smoke.kernel_name(e.key)
        if name:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


def sweep_shape(label, model, carry, f, symmetry, pfp, geometries, reps):
    import torch

    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.fused import (S_DISC, StepWorkspace,
                                                fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.words import pack64

    import chip_smoke

    _block, args = chip_smoke.block_args(model, carry, f, pfp)
    table0, ring0 = carry.table.clone(), carry.ring.clone()
    t_p, r_p = table0.clone(), ring0.clone()
    p = fused_step_reference(model, *args, t_p, r_p, symmetry=symmetry)
    p_keys = set(pack64(p.chi, p.clo)[p.inserted].tolist())
    lane_exact = ("flat", "chi", "clo", "cvalid", "pbits", "ebits",
                  "terminal") + (("ohi", "olo") if symmetry else ())
    ws = StepWorkspace(table0.numel(), ring0.shape[0],
                       len(model.properties()), table0.device)
    t_k, r_k = table0.clone(), ring0.clone()

    def restore():
        t_k.copy_(table0)
        r_k.copy_(ring0)

    def launch():
        return fused_step(model, *args, t_k, r_k, ws, symmetry=symmetry)

    for lanes, threads in geometries:
        _cuda.TILE_LANES = lanes
        _cuda.TILE_THREADS = threads
        restore()
        k = launch()
        keys = pack64(k.chi, k.clo)
        ins = keys[k.inserted]
        checks = {
            "lane_exact": all(torch.equal(getattr(k, n), getattr(p, n))
                              for n in lane_exact),
            "inserted_set": set(ins.tolist()) == p_keys,
            "one_lane_per_key": ins.shape[0] == len(p_keys),
            "lowest_valid_lane_wins": chip_smoke.lowest_lane_wins(
                k, among=k.cvalid),
            "discoveries": torch.equal(k.stats[S_DISC:], p.stats[S_DISC:]),
        }
        ms = kernel_ms(launch, restore, reps)
        geo = _cuda.tile_geometry(f, model.max_actions,
                                  _cuda.sm_count(table0.device))
        print(json.dumps({
            "shape": label, "f": f, "lanes_budget": lanes,
            "threads": threads, "geometry": geo._asdict(),
            "valid": int(k.cvalid.sum()), "to_table": int(k.dvalid.sum()),
            "inserted": int(k.inserted.sum()), "device_ms": ms,
            "checks": checks}), flush=True)
        if not all(checks.values()):
            raise AssertionError(f"{label} f={f} lanes={lanes} "
                                 f"threads={threads}: {checks}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, nargs="+",
                    default=[512, 1024, 2048])
    ap.add_argument("--threads", type=int, nargs="+",
                    default=[128, 256, 512])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    from stateright_tpu_torch import TwoPhaseSys
    from stateright_tpu_torch.ops import _cuda

    import chip_smoke

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _cuda.build()
    dev = torch.device("cuda", 0)
    geometries = [(lanes, threads) for lanes in args.lanes
                  for threads in args.threads]
    m7 = TwoPhaseSys(7)
    carry = chip_smoke.mid_search_carry(m7, dev)
    for f in (12288, 256):
        sweep_shape("2pc7", m7, carry, f, False, None, geometries,
                    args.reps)
    del carry
    ref = TwoPhaseSys(16)
    carry = chip_smoke.mid_search_carry(ref, dev, symmetry=True)
    for mode, m16 in (("reference", ref),
                      ("complete", TwoPhaseSys(16, complete_symmetry=True))):
        pfp = None if mode == "reference" else chip_smoke.frontier_fps(m16)
        for f in (12288, 256):
            sweep_shape(f"2pc16-sym {mode}", m16, carry, f, True, pfp,
                        geometries, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
