#!/usr/bin/env python3
"""K1-timer_count in several trees of the repository, one call: each
tree in a process of its own, in the order given, one JSON line per
tree and measurement.

    python tools/torch_timer_ab.py build/parent build/a build/b build/b \
        build/a build/parent

Each tree builds its own kernels and runs its own ``chip_smoke.py``; the
steps are ``tools/torch_register_kernels.py`` ``FIXTURE_STEPS``' timer
steps (TimerCount(8, 4)'s 8,192-row step and its run's 256-row small
step), timed by that file's ``time_k1`` (K1's device ms, the median of
its traces, and a digest of the outputs on the lanes the timer K1
writes) over each of ``LAUNCHES`` (``ops/_cuda.py`` ``TIMER_THREADS``,
``TIMER_BLOCKS_PER_SM``; a tree without them once, at its own launch),
then held once to the plain version (``check_step``, on the tree's
``timer_active`` lanes where it has the rule, else on every lane). A
tree that fails prints its exit code and the next one runs. Needs a
CUDA device.
"""

import importlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (threads a block, blocks an SM)
LAUNCHES = ((128, 4), (256, 2), (128, 2), (64, 4))


def one(tree: str) -> int:
    """Time and check K1-timer_count of the repository at ``tree`` in
    this process."""
    sys.path.insert(0, tree)
    sys.path.insert(1, os.path.join(ROOT, "tools"))
    import torch
    from stateright_tpu_torch.ops import _cuda
    smoke = importlib.import_module("chip_smoke")
    if not smoke.__file__.startswith(tree):
        raise RuntimeError(f"imported {smoke.__file__}, not {tree}'s")
    from torch_register_kernels import FIXTURE_STEPS, time_k1
    info = _cuda.build()
    usage = smoke.ptxas_usage(info["logs"].get("fused_step", "")).get(
        "expand_kernel[TimerCountModel]")
    name = os.path.basename(tree)
    print(json.dumps({"tree": name, "usage": usage}), flush=True)
    dev = torch.device("cuda", 0)
    for _label, make, kname, rows, pending in FIXTURE_STEPS:
        if kname != "timer_count":
            continue
        model = make(smoke)
        carry = smoke.mid_search_carry(model, dev, rows=rows,
                                       pending=pending)
        for threads, per_sm in LAUNCHES:
            if hasattr(_cuda, "TIMER_THREADS"):
                _cuda.TIMER_THREADS = threads
                _cuda.TIMER_BLOCKS_PER_SM = per_sm
            res = time_k1(smoke, model, kname, carry, rows, 20)
            print(json.dumps({"tree": name, "step": rows,
                              "launch": [threads, per_sm],
                              "k1": res["k1_device_ms"],
                              "step_ms": res["step_device_ms"],
                              "outputs": res["outputs"]}), flush=True)
            if not hasattr(_cuda, "TIMER_THREADS"):
                break
        rule = getattr(smoke, "timer_active", None)
        chk = smoke.check_step(model, carry, rows, reps=1, gated=True,
                               active=rule(model) if rule else None)
        print(json.dumps({"tree": name, "step": rows,
                          "checks": all(chk["checks"].values()),
                          "err": chk["max_abs_err"]}), flush=True)
        del carry
    return 0


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--tree":
        return one(os.path.abspath(sys.argv[2]))
    import torch
    if not torch.cuda.is_available():
        print("torch_timer_ab: no CUDA device", file=sys.stderr)
        return 2
    for t in sys.argv[1:]:
        tree = os.path.abspath(t)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--tree", tree], cwd=tree).returncode
        if rc:
            print(json.dumps({"tree": t, "rc": rc}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
