#!/usr/bin/env python3
"""Where ``torch.profiler`` stops seeing device time in ``chip_smoke.py``'s
run, step by step: the smoke's ``race`` phase (the in-process races),
its ``checkpoint`` phase and its cold starts (``check-gpu 3`` in fresh
processes on the same card), with one probe trace
(:func:`trace_probe`: a one-row K9 launch and a torch fill) after
every line each phase emits, each printed with the interpreter's switch
interval and the live threads. On an H100 the probes held their device
time through the in-process races and lost it, mostly, from the first
fresh process on; so the smoke runs its cold starts last.

    python tools/torch_trace_probe.py

Needs a CUDA device; the first line is the card's name and power limit
from ``nvidia-smi``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def trace_probe(after: str) -> dict:
    """Trace one launch of K9 (``hpull_kernel``, a one-row pull) and one
    torch fill; returns the device microseconds the trace gives each (0:
    the trace lost it). The launch count is left as it was."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as smoke
    from stateright_tpu_torch.ops import _cuda

    dev = torch.device("cuda", 0)
    q = torch.zeros((4, 5), dtype=torch.int32, device=dev)
    hidx = torch.zeros((1,), dtype=torch.int32, device=dev)
    log = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    out = torch.empty((1, 4), dtype=torch.int32, device=dev)
    x = torch.empty((1 << 16,), device=dev)
    before = _cuda.LAUNCHES["hpull"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _cuda.hpull(q, hidx, log, 0, 0, out, count=1)
        x.fill_(1.0)
        torch.cuda.synchronize()
    _cuda.LAUNCHES["hpull"] = before
    ours = theirs = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if smoke.kernel_name(e.key):
            ours += us
        else:
            theirs += us
    return {"after": after, "ours_us": ours, "torch_us": theirs}



def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_trace_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from stateright_tpu_torch.ops import _cuda

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _cuda.build()
    emitted = smoke.emit

    def probe(label: str) -> None:
        print(json.dumps({"probe": trace_probe(label),
                          "switch_interval": sys.getswitchinterval(),
                          "threads": sorted(t.name for t in
                                            threading.enumerate())}),
              flush=True)

    def emit(**fields) -> None:
        emitted(**fields)
        probe(" ".join(str(fields.get(k)) for k in (
            "phase", "model", "raced", "injected", "mode", "command",
            "turn") if k in fields))

    probe("build")
    smoke.emit = emit
    try:
        smoke.race_phase()
        probe("race done")
        smoke.checkpoint_phase()
        probe("checkpoint done")
        smoke.cold_start_phase()
        probe("cold starts done")
    finally:
        smoke.emit = emitted
    return 0


if __name__ == "__main__":
    sys.exit(main())
