#!/usr/bin/env python3
"""Whether each kernel of the step library compiles to the same machine
code in two trees of the repository: one JSON line per kernel instance
(``chip_smoke.py`` ``kernel_instance`` names: K1 by its model struct)
with ``identical`` and the count of differing instructions.

    python tools/torch_sass_diff.py build/parent
    python tools/torch_sass_diff.py build/parent --library chunk
    python tools/torch_sass_diff.py build/parent --show 16

Each tree builds its own kernels (``ops/_cuda.py`` ``build``, in a
process of its own, into its ``build/kernels``); ``cuobjdump -sass``
lists each library's functions, and their instructions are compared
with the addresses and encodings left out; ``--show N`` adds the first
``N`` differing instructions of each kernel that differs (index, old,
new). Needs the CUDA toolkit
(``cuobjdump``, ``nvcc``); the card's name and power limit head the
output.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(tree: str) -> None:
    """Build ``tree``'s kernels in a process of its own."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from stateright_tpu_torch.ops import _cuda; _cuda.build()")
    subprocess.run([sys.executable, "-c", code, tree], cwd=tree, check=True)


def unit_free(name: str) -> str:
    """A mangled name without its anonymous namespace, whose name the
    compiler derives from the translation unit (so it differs between
    two trees' builds of the same source)."""
    m = re.match(r"_ZN(\d+)", name)
    if m:
        n = int(m.group(1))
        ident = name[m.end():m.end() + n]
        if ident.startswith(("_INTERNAL", "_GLOBAL__N")):
            return "_ZN" + name[m.end() + n:]
    return name


def functions(lib: str) -> dict:
    """Each function of ``lib`` (mangled name without its anonymous
    namespace: :func:`unit_free`) and its instructions."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = unit_free(m.group(1))
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if name and m:
            funcs[name].append(m.group(1))
    return funcs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", help="the root of the other tree")
    ap.add_argument("--library", default="fused_step")
    ap.add_argument("--show", type=int, default=0,
                    help="differing instructions listed per kernel")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    trees = {"old": os.path.abspath(args.old), "new": ROOT}
    funcs = {}
    for side, tree in trees.items():
        build(tree)
        libs = glob.glob(os.path.join(tree, "build", "kernels",
                                      f"libsrt_{args.library}_*.so"))
        if len(libs) != 1:
            raise RuntimeError(f"{tree}: {libs}")
        funcs[side] = functions(libs[0])
    for name in sorted(set(funcs["old"]) | set(funcs["new"])):
        old, new = funcs["old"].get(name), funcs["new"].get(name)
        line = {"card": card, "kernel": chip_smoke.kernel_instance(name),
                "symbol": name,
                "in_old": old is not None, "in_new": new is not None}
        if old is not None and new is not None:
            line["identical"] = old == new
            line["instructions"] = [len(old), len(new)]
            line["differing"] = sum(a != b for a, b in zip(old, new)) \
                + abs(len(old) - len(new))
            if args.show and old != new:
                line["first_differing"] = [
                    [i, a, b] for i, (a, b) in enumerate(zip(old, new))
                    if a != b][:args.show]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
