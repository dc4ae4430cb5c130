#!/usr/bin/env python3
"""K7, the append, on the card at the shapes of the main paths, and the
default single-chip runs around it, one JSON line per tree, shape and
tile size.

    python tools/torch_append_sweep.py
    python tools/torch_append_sweep.py --old build/parent

The shapes are ``chip_smoke.py``'s: the append after a real mid-search
step of TwoPhaseSys(7) at 12,288 and 256 rows, of TwoPhaseSys(16) under
the reference representative (6-column log) at 12,288 rows, and of
IncrementLock(9) (14-word queue rows) and Increment(16) (20-word rows)
at 12,288 rows. Each tree's own ``chip_smoke.py`` builds the state and
holds its K7 to the plain version bit for bit (``check_append``: the
device ms from ``torch.profiler``, the CUDA-event ms of one call, the
bytes bound); a tree whose K7 takes a tile size
(``ops/_cuda.py`` ``APPEND_TILES``) is timed at its own choice
(``append_tile``) and at each, forced by replacing ``append_tile``
for the run. Then
each tree runs TwoPhaseSys(7) and IncrementLock(9) end to end with
default options (wall, loop, replays, launches) and once more under
``torch.profiler`` (device time by kernel, busy share).

``--old DIR`` also times another tree of the repository (the parent
commit unpacked there, e.g. ``git archive HEAD stateright_tpu_torch
chip_smoke.py | tar -x -C build/parent``), built from its own sources,
in separate processes in the order old, new, new, old, in the same
call. Needs a CUDA device; every line carries the card's name and power
limit from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (label, model class, its arguments, symmetry, rows per step, whether
#: the search goes on past its discoveries)
SHAPES = (("2pc7 f=12288", "TwoPhaseSys", (7,), False, 12288, False),
          ("2pc7 f=256", "TwoPhaseSys", (7,), False, 256, False),
          ("2pc16-ref f=12288", "TwoPhaseSys", (16,), True, 12288, False),
          ("lock9 f=12288", "IncrementLock", (9,), False, 12288, False),
          ("inc16 f=12288", "Increment", (16,), False, 12288, True))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def run_tree(tree: str, reps: int) -> int:
    """Time K7 and the default runs of the repository at ``tree`` (its
    own package, its own build, its own ``chip_smoke.py``) in this
    process."""
    sys.path.insert(0, tree)
    import torch

    import stateright_tpu_torch as pkg
    from stateright_tpu_torch.ops import _cuda

    smoke = importlib.import_module("chip_smoke")
    if not smoke.__file__.startswith(tree):
        raise RuntimeError(f"imported {smoke.__file__}, not {tree}'s")
    dev = torch.device("cuda", 0)
    smi = card()
    info = _cuda.build()
    # None: the tree's own choice (its append_tile, where it has one)
    own_tile = getattr(_cuda, "append_tile", None)
    tiles = (None,) + (tuple(_cuda.APPEND_TILES) if own_tile else ())
    head = {"tree": tree, "card": smi, "build_s": info["seconds"]}
    carries = {}
    for label, cls, args, symmetry, rows, past in SHAPES:
        model = getattr(pkg, cls)(*args)
        key = (cls, args, symmetry)
        if key not in carries:
            carries.clear()
            carries[key] = smoke.mid_search_carry(
                model, dev, symmetry=symmetry, rows=12288,
                past_discoveries=past)
        carry = carries[key]
        for tile in tiles:
            chosen = tile
            if own_tile:
                _cuda.append_tile = (own_tile if tile is None
                                     else lambda *_a, t=tile: t)
                chosen = _cuda.append_tile(rows * model.max_actions,
                                           _cuda.sm_count(dev),
                                           model.packed_width)
            carry.card = None  # a new chunk (and tile size) per run
            res = smoke.check_append(model, carry, rows, reps)
            print(json.dumps({**head, "shape": label, "tile_lanes": chosen,
                              "tile_choice": "auto" if tile is None
                              else "forced",
                              **{k: res.get(k) for k in (
                                  "lanes", "appended", "device_ms",
                                  "device_by_kernel_ms", "ms", "plain_ms",
                                  "bytes", "bound_ms", "bound_by",
                                  "max_abs_err", "checks")}}), flush=True)
            carry.card = None
    carries.clear()
    if own_tile:
        _cuda.append_tile = own_tile
    for label, make, want in (
            ("2pc7", lambda: pkg.TwoPhaseSys(7), None),
            ("lock9", lambda: pkg.IncrementLock(9), smoke.PIN_LOCK9)):
        for turn in range(2):
            res, ck = smoke.end_to_end_model(make(), (), want=want)
            del ck
            print(json.dumps({**head, "run": label, "turn": turn, **{
                k: res.get(k) for k in (
                    "wall_s", "loop_s", "iterations", "small_iterations",
                    "chunks", "syncs", "graph_launches", "captures",
                    "grows", "launches", "checks")}}), flush=True)
        prof = smoke.device_times(lambda: make().checker().gpu_options(
            race=False).spawn_gpu().join())
        print(json.dumps({**head, "run": label, "profiled": True, **{
            k: prof.get(k) for k in ("loop_s", "busy", "ours_ms",
                                     "torch_ms", "copy_ms", "by_kernel_ms",
                                     "by_kernel_calls", "graph_launches",
                                     "captures")},
            "cuda_api": {k: v for k, v in prof["cuda_api"].items()
                         if k in ("cudaGraphLaunch", "cudaLaunchKernel")}}),
            flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--old", help="the root of another tree of the "
                    "repository, timed before and after this one")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_append_sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.tree:
        return run_tree(args.tree, args.reps)
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
