#!/usr/bin/env python3
"""The staged step on the card alone: ``chip_smoke.py``'s phase
``staged`` without the other phases.

    python3 tools/torch_staged_kernels.py

Builds the kernels, then runs ``chip_smoke.staged_kernels`` (K1 alone and
KS1-KS3 held bit for bit to their plain versions and timed at
PackedPaxos(3)'s 8,192- and 256-row steps and, under sound, at
PackedPingPong(7)'s 7,710- and 256-row steps) and
``chip_smoke.staged_phase`` (the staged BASELINE run, TwoPhaseSys(7)
staged with its candidate buffers too small, PingPong(7) under sound,
each against its pin, the BASELINE and the sound run profiled), one JSON
line each, then the ``kernels`` records of the staged step and the card's
name and power limit. Exits non-zero if a check fails. Needs a CUDA
device and a checkout of the repository.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_staged_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from stateright_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build()
    chip_smoke.emit(phase="build", seconds=time.perf_counter() - t0)
    device = torch.device("cuda", 0)
    checks = chip_smoke.staged_kernels(device)
    runs = chip_smoke.staged_phase(device)
    print(json.dumps({"kernels": chip_smoke.staged_kernel_entries(checks,
                                                                 runs)}),
          flush=True)
    print(chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
