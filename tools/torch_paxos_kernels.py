#!/usr/bin/env python3
"""K1's paxos instantiation and K8, the history insert, on the card at
the shapes of the BASELINE workload, and the BASELINE run around them,
one JSON line per tree and measurement.

    python tools/torch_paxos_kernels.py
    python tools/torch_paxos_kernels.py --old build/parent
    python tools/torch_paxos_kernels.py --old build/parent --fixtures

The shapes are ``chip_smoke.py``'s: a mid-search PackedPaxos(3) carry
(the port's own loop at 8,192 rows a step until 8,192 rows are pending),
K1-K3 over those 8,192 rows (``check_step``: lane for lane against the
plain version; K1's own device ms from ``torch.profiler``, the step's
CUDA-event ms) and K8 over the rows the next step appends
(``check_history``: the search's own table, an empty one and keyed by
the actor words, each against the plain version; device ms and CUDA-event
ms per case), then K1's crash instantiation (``paxos_crash``) at the
mid-search 8,192-row step of PackedPaxos(3).crash_restart(1,
actors=[0, 1, 2]) (``chip_smoke.py``'s, gated: ``torch_register_kernels.py``
``crash_step``: the median device ms of five traces, the delivery, crash
and restart children it builds, lane for lane against the plain version
on its active lanes, and K1's phase clocks from a build with
``-DSRT_K1_PHASES``), then K1's lossy instantiation (``paxos_lossy``) at
the mid-search 8,192-row step of PackedPaxos(2).lossy_network(True)
(``chip_smoke.py``'s, gated: ``torch_register_kernels.py`` ``k1_step``,
with the delivery and drop children it builds, and at the end lane for
lane against the plain version on its active lanes and K1's phase
clocks; an older tree without the instantiation prints a line saying
so, and its K1-paxos line above stands beside it), then K1-ping_pong at
PingPong(7)'s 8,192-row step and at the non-duplicating PingPong(7)'s
2-row step and K1-timer_count at TimerCount(8, 4)'s 8,192-row step and
its run's 256-row small step (``torch_register_kernels.py``
``FIXTURE_STEPS``, alike; each held on its active lanes, the lossless
K1-ping_pong on every lane), then the narrow K1 beside them
(TwoPhaseSys(7)
and IncrementLock(9) at 12,288 rows). Each tree runs them with its own
``chip_smoke.py``, and
prints a digest of the carry it built, so two trees are compared on the
same carry (the loop's lowest-lane rule makes it the same). Then each
tree runs the BASELINE workload (PackedPaxos(3), ``capacity=1<<21``,
``race=False``, ``target_state_count(500_000)``) and the same under
``crash_restart(1, actors=[0, 1, 2])``, each twice for its wall and
once under ``torch.profiler`` (device ms by kernel, busy share), and
lossy Paxos(2), PingPong(7) in the network's four quadrants and
TimerCount(8, 4) in full, once each under ``torch.profiler``.
``--fixtures`` runs only the fixtures' K1 steps and runs.

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
KERNELS = (("fused_step", "expand_kernel[PaxosModel]"),
           ("fused_step", "expand_kernel[PaxosCrashModel]"),
           ("fused_step", "expand_kernel[PaxosLossyModel]"),
           ("fused_step", "expand_kernel[PingPongModel]"),
           ("fused_step", "expand_kernel[PingPongLossyModel]"),
           ("fused_step", "expand_kernel[TimerCountModel]"),
           ("history", "history_kernel"))


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


def run_tree(tree: str, reps: int) -> int:
    """Time K1-paxos, K8 and the BASELINE run of the repository at
    ``tree`` (its own package, build and ``chip_smoke.py``) in this
    process."""
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
    print(json.dumps({**head, "usage": usage}), flush=True)
    model = PackedPaxos(3)
    carry = smoke.mid_search_carry(model, dev, rows=8192)
    digest = carry_digest(carry)
    step = smoke.check_step(model, carry, 8192, reps=reps)
    k1 = step["parts"]["expand_kernel"]
    print(json.dumps({**head, "kernel": "K1-paxos", "carry": digest,
                      "f": step["f"], "lanes": step["lanes"],
                      "k1_device_ms": k1["device_ms"],
                      "k1_bound_ms": k1["bound_ms"],
                      "step_device_ms": step["device_ms"],
                      "step_by_kernel_ms": step["device_by_kernel_ms"],
                      "step_ms": step["ms"], "plain_ms": step["plain_ms"],
                      "step_bound_ms": step["bound_ms"],
                      "max_abs_err": step["max_abs_err"],
                      "checks": step["checks"]}), flush=True)
    hist = smoke.check_history(model, carry, 8192, reps=reps)
    print(json.dumps({**head, "kernel": "K8", "carry": digest,
                      "rows": hist["rows"], "bound_ms": hist["bound_ms"],
                      "cases": {lb: {k: c.get(k) for k in (
                          "fresh", "fresh_rows", "ms", "device_ms",
                          "plain_ms")} for lb, c in hist["cases"].items()
                          if "ms" in c},
                      "max_abs_err": hist["max_abs_err"],
                      "checks": hist["checks"]}), flush=True)
    del carry
    from torch_register_kernels import crash_step
    line, crash_finish = crash_step(
        smoke, _cuda, tree, smoke._paxos_crash(3), "paxos_crash",
        "PackedPaxos(3).crash_restart(1, actors=[0, 1, 2])", 8192, 8192,
        reps)
    print(json.dumps({**head, **line}), flush=True)
    lossy_finish = lossy_step(smoke, _cuda, tree, head, reps)
    fixture_finish = []
    if hasattr(smoke, "_ping_pong"):
        from torch_register_kernels import fixture_steps
        lines, fixture_finish = fixture_steps(smoke, _cuda, tree, reps)
        for line in lines:
            print(json.dumps({**head, **line}), flush=True)
    # the narrow K1 instantiations (the register-array path), which the
    # wide branch must leave as they were
    for label, nmodel in (("2pc7", pkg.TwoPhaseSys(7)),
                          ("lock9", pkg.IncrementLock(9))):
        ncarry = smoke.mid_search_carry(nmodel, dev)
        res = smoke.check_step(nmodel, ncarry, 12288, reps=reps)
        del ncarry
        print(json.dumps({**head, "kernel": f"K1-K3 {label}", "f": 12288,
                          "k1_device_ms": res["parts"]["expand_kernel"][
                              "device_ms"],
                          "step_device_ms": res["device_ms"],
                          "step_ms": res["ms"],
                          "max_abs_err": res["max_abs_err"]}), flush=True)
    for turn in range(2):
        res, ck, fps = smoke.paxos_run(3, (), target=smoke.PAXOS3_TARGET,
                                       capacity=1 << 21)
        del ck, fps
        print(json.dumps({**head, "run": "BASELINE paxos check 3",
                          "turn": turn, **{k: res.get(k) for k in (
                              "wall_s", "unique", "generated", "seed_s",
                              "loop_s", "sync_s", "capture_s", "mirror_s",
                              "iterations", "graph_launches", "h_n",
                              "histories", "launches", "checks")}}),
              flush=True)
    prof = smoke.device_times(lambda: PackedPaxos(3).checker().gpu_options(
        race=False, capacity=1 << 21).target_state_count(
            smoke.PAXOS3_TARGET).spawn_gpu().join())
    print(json.dumps({**head, "run": "BASELINE paxos check 3",
                      "profiled": True, **{k: prof.get(k) for k in (
                          "loop_s", "busy", "ours_ms", "torch_ms",
                          "copy_ms", "by_kernel_ms", "by_kernel_calls",
                          "graph_launches", "captures")},
                      "cuda_api": {k: v for k, v in prof["cuda_api"].items()
                                   if k in ("cudaGraphLaunch",
                                            "cudaLaunchKernel")}}),
          flush=True)
    # the BASELINE workload under crashes, bounded as the BASELINE run
    def crash_run():
        return smoke._paxos_crash(3).checker().gpu_options(
            race=False, capacity=1 << 21).target_state_count(
                smoke.PAXOS3_TARGET).spawn_gpu().join()

    path = ("fused_step", "chunk_begin", "append", "history", "hpull")
    for turn in range(2):
        res, ck = smoke.register_run(
            smoke._paxos_crash(3), path, holds=("linearizable",),
            found=("value chosen",), target=smoke.PAXOS3_TARGET,
            capacity=1 << 21)
        del ck
        print(json.dumps({**head, "run": "paxos check 3 under crashes",
                          "turn": turn, **{k: res.get(k) for k in (
                              "wall_s", "unique", "generated", "loop_s",
                              "host_eval_s", "iterations", "histories",
                              "launches", "checks")}}), flush=True)
    prof = smoke.device_times(crash_run)
    print(json.dumps({**head, "run": "paxos check 3 under crashes",
                      "profiled": True, **{k: prof.get(k) for k in (
                          "loop_s", "busy", "ours_ms", "torch_ms",
                          "copy_ms", "by_kernel_ms", "by_kernel_calls",
                          "graph_launches")}}), flush=True)
    # lossy Paxos(2) and PingPong(7) in full
    if hasattr(smoke, "_ping_pong"):
        profile_runs(smoke, head, (("lossy Paxos(2)",
                                    lambda: smoke._paxos_lossy(2)),)
                     + ping_pong_runs(smoke))
    # the edit steps' plain versions and phase clocks, every trace taken
    for finish in [crash_finish] + ([lossy_finish] if lossy_finish else []) \
            + fixture_finish:
        print(json.dumps({**head, **finish()}), flush=True)
    return 0


def ping_pong_runs(smoke) -> tuple:
    """PingPong(7)'s runs in the network's four quadrants and
    TimerCount(8, 4)'s (``smoke``'s ``_ping_pong``, ``_timer_count``):
    label, model maker."""
    return tuple((f"PingPong(7, lossy={lossy}, duplicating={dup})",
                  lambda lossy=lossy, dup=dup: smoke._ping_pong(
                      7, lossy=lossy, duplicating=dup))
                 for lossy in (True, False) for dup in (True, False)) + (
        ("TimerCount(8, 4)", lambda: smoke._timer_count(8, 4)),)


def profile_runs(smoke, head: dict, runs) -> None:
    """Each of ``runs`` (label, model maker) in full, once under
    ``torch.profiler``: device ms and calls by kernel, busy share."""
    for label, make in runs:
        def one(make=make):
            return make().checker().gpu_options(race=False).spawn_gpu() \
                .join()
        prof = smoke.device_times(one)
        print(json.dumps({**head, "run": label, "profiled": True,
                          **{k: prof.get(k) for k in (
                              "loop_s", "busy", "ours_ms", "torch_ms",
                              "copy_ms", "by_kernel_ms", "by_kernel_calls",
                              "graph_launches")}}), flush=True)


def run_fixtures(tree: str, reps: int) -> int:
    """``--fixtures``: K1-ping_pong and K1-timer_count at the
    ``FIXTURE_STEPS`` and the fixtures' runs (:func:`ping_pong_runs`)
    of the repository at ``tree``, in this process."""
    sys.path.insert(0, tree)
    from stateright_tpu_torch.ops import _cuda
    from torch_register_kernels import fixture_steps

    smoke = importlib.import_module("chip_smoke")
    if not smoke.__file__.startswith(tree):
        raise RuntimeError(f"imported {smoke.__file__}, not {tree}'s")
    info = _cuda.build()
    usage = {name: smoke.ptxas_usage(info["logs"].get(lib, "")).get(name)
             for lib, name in KERNELS}
    head = {"tree": tree, "card": card(), "build_s": info["seconds"]}
    print(json.dumps({**head, "usage": usage}), flush=True)
    lines, finish = fixture_steps(smoke, _cuda, tree, reps)
    for line in lines:
        print(json.dumps({**head, **line}), flush=True)
    profile_runs(smoke, head, ping_pong_runs(smoke))
    for fin in finish:
        print(json.dumps({**head, **fin()}), flush=True)
    return 0


def lossy_step(smoke, cuda, tree: str, head: dict, reps: int):
    """K1-paxos_lossy at the mid-search 8,192-row step of lossy
    PackedPaxos(2), gated (``torch_register_kernels.py`` ``k1_step``),
    with the delivery and drop children it builds; prints its line and
    returns a function that holds the step to its plain version on its
    active lanes and reads K1's phase clocks once every trace is taken,
    or None (printing so) for a tree without the instantiation."""
    if not hasattr(smoke, "_paxos_lossy"):
        print(json.dumps({**head, "kernel": "K1-paxos_lossy",
                          "absent": "no paxos_lossy instantiation in this "
                          "tree; its K1-paxos line stands beside it"}),
              flush=True)
        return None
    from torch_register_kernels import k1_step

    model = smoke._paxos_lossy(2)
    line, finish = k1_step(smoke, cuda, tree, model, "paxos_lossy",
                           "PackedPaxos(2).lossy_network(True)", 8192, 8192,
                           reps, rule=smoke.lossy_active(model))
    print(json.dumps({**head, **line}), flush=True)
    return finish


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--old", help="the root of another tree of the "
                    "repository, timed before and after this one")
    ap.add_argument("--fixtures", action="store_true",
                    help="only the actor test fixtures' K1 steps and "
                    "runs")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_paxos_kernels: no CUDA device", file=sys.stderr)
        return 2
    if args.tree:
        run = run_fixtures if args.fixtures else run_tree
        return run(args.tree, args.reps)
    print(card(), flush=True)
    trees = [ROOT] if not args.old else [
        os.path.abspath(args.old), ROOT, ROOT, os.path.abspath(args.old)]
    for tree in trees:
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree,
               "--reps", str(args.reps)] + (["--fixtures"] if args.fixtures
                                            else [])
        rc = subprocess.run(cmd, cwd=tree).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
