#!/usr/bin/env python3
"""Reduced state counts of 2pc under symmetry reduction in the PyTorch
port, one JSON line per run.

    python tools/torch_symmetry_counts.py --n 16 --fmax 12288 256
    python tools/torch_symmetry_counts.py --n 16 --complete --device cpu

Runs ``TwoPhaseSys(n[, complete_symmetry=True]).checker()
.symmetry_fn(model.representative).gpu_options(device=, fmax=)
.spawn_gpu()`` once per ``--fmax`` value and prints the unique and total
state counts, the sha256 of the sorted canonical keys, the iterations
and the wall time (host clock, kernels built beforehand on a card). The
complete representative gives the same answer for every step size and
device; the reference one's count depends on which orbit member each
step inserts first, so it moves with the step size and, at one step
size, between the card and the CPU (ROADMAP C1).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def digest(fps) -> str:
    import numpy as np
    arr = np.array(sorted(fps), dtype=np.uint64)
    return hashlib.sha256(arr.astype("<u8").tobytes()).hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16, help="resource managers")
    ap.add_argument("--complete", action="store_true",
                    help="the orbit-invariant representative")
    ap.add_argument("--fmax", type=int, nargs="+", default=[12288],
                    help="frontier rows per step, one run each")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args()

    import torch

    from stateright_tpu_torch import TwoPhaseSys
    if args.device == "cuda":
        from stateright_tpu_torch.ops import _cuda
        _cuda.build()
        card = torch.cuda.get_device_name(0)
    else:
        card = None
    model = TwoPhaseSys(args.n, complete_symmetry=args.complete)
    for fmax in args.fmax:
        t0 = time.perf_counter()
        ck = (model.checker().symmetry_fn(model.representative)
              .gpu_options(device=args.device, fmax=fmax)
              .spawn_gpu().join())
        wall = time.perf_counter() - t0
        prof = ck.profile()
        print(json.dumps({
            "n": args.n,
            "representative": "complete" if args.complete else "reference",
            "device": args.device, "card": card, "fmax": fmax,
            "unique": ck.unique_state_count(),
            "states": ck.state_count(),
            "digest": digest(ck.generated_fingerprints()),
            "iterations": prof.get("iterations"),
            "grows": prof.get("grows"), "wall_s": wall}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
