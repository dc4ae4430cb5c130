#!/usr/bin/env python3
"""The nvcc build of the port's kernels (``stateright_tpu_torch/csrc``,
one nvcc per source, all started together: ``ops/_cuda.py`` ``build``)
timed from nothing built, with each K1 instantiation's registers, spills
and shared memory from ptxas, one JSON line per build.

    python tools/torch_build_time.py
    python tools/torch_build_time.py --old build/parent

Each build runs in its own process into a fresh build directory, so
nothing is cached. ``--old DIR`` also builds another tree of the
repository (the parent commit unpacked there, e.g. ``git archive HEAD
stateright_tpu_torch | tar -x -C build/parent``) in the order old, new,
new, old, in the same call. Needs ``nvcc``; every line carries the
card's name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: run in a child whose working directory is the tree to build
CHILD = r"""
import json, pathlib, re, sys
sys.path.insert(0, ".")
from stateright_tpu_torch.ops import _cuda
_cuda._BUILD = pathlib.Path(sys.argv[1])
info = _cuda.build()
k1 = {}
for lib, log in (info["logs"] if "logs" in info
                 else {"all": info["log"]}).items():
    name = None
    for line in log.splitlines():
        m = (re.search(r"Compiling entry function '(\w+)'", line)
             or re.search(r"Function properties for (\w+)", line))
        if m:
            name = m.group(1)
        if not name or "expand_kernel" not in name:
            continue
        m = re.search(r"expand_kernelI(\d+)", name)
        model = name[m.end():m.end() + int(m.group(1))]
        key = f"{lib}:{model}" + (":sym" if "Lb1E" in name else "")
        r = re.search(r"Used (\d+) registers", line)
        sp = re.search(r"(\d+) bytes spill stores", line)
        if r:
            k1.setdefault(key, {})["registers"] = int(r.group(1))
        if sp:
            k1.setdefault(key, {})["spill_stores"] = int(sp.group(1))
print(json.dumps({"seconds": info["seconds"], "expand_kernel": k1}))
"""


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def build(tree: str) -> dict:
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        out = subprocess.run([sys.executable, "-c", CHILD, d], cwd=tree,
                             capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="another tree of the repository")
    args = ap.parse_args()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    trees = ([("old", args.old), ("new", ROOT), ("new", ROOT),
              ("old", args.old)] if args.old else [("new", ROOT)])
    gpu = card()
    for label, tree in trees:
        print(json.dumps({"tree": label, "card": gpu, **build(tree)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
