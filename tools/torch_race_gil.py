#!/usr/bin/env python3
"""What the interpreter lock costs the raced device lane, on the card.

    python3 tools/torch_race_gil.py [--turns 2]

``spawn_gpu()`` races a pure-Python host BFS against the card. The BFS
thread gives up the interpreter lock only when forced (every switch
interval) while the device lane gives it up in every CUDA call, so each
of the lane's returns waits for it. This prints one JSON line per
measurement:

  * ``handoff``: the mean host microseconds of one lock-releasing call
    (a ctypes ``getpid``) while a pure-Python thread spins, at each
    switch interval, and with no spinner;
  * ``run``: TwoPhaseSys(7) with default options, ``race=False`` and
    raced at each switch interval (``race.SWITCH_INTERVAL_S`` replaced
    for the run; ``null`` keeps the interpreter's default, 5 ms, with
    ``race._shorten_switch_interval`` replaced by a no-op), with the
    chunk's replays launched from one C call per chunk (``srt_graph_launch``,
    the engine's way) and, for comparison, from one ``graph.replay()``
    call per replay: wall, ``seed_s``, ``capture_s``, ``loop_s``, the
    winner, in turns.

Every run is held to the pinned count and digest (``chip_smoke.py``).
Needs a CUDA device; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTERVALS = (None, 1e-3, 1e-4, 1e-5)


def handoff_us(interval, calls: int = 2000, spin: bool = True) -> float:
    """Mean microseconds of one lock-releasing call while another thread
    runs Python (at ``interval``; None: the default)."""
    libc = ctypes.CDLL(None)
    stop = threading.Event()

    def spinner():
        x = 0
        while not stop.is_set():
            x += 1

    saved = sys.getswitchinterval()
    if interval is not None:
        sys.setswitchinterval(interval)
    thread = threading.Thread(target=spinner, daemon=True)
    try:
        if spin:
            thread.start()
            time.sleep(0.01)
        t0 = time.perf_counter()
        for _ in range(calls):
            libc.getpid()
        return (time.perf_counter() - t0) / calls * 1e6
    finally:
        stop.set()
        if spin:
            thread.join()
        sys.setswitchinterval(saved)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--turns", type=int, default=2)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_race_gil: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from stateright_tpu_torch import TwoPhaseSys
    from stateright_tpu_torch.checker import race
    from stateright_tpu_torch.ops import _cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    head = {"card": smi, "torch": torch.__version__,
            "raw_cuda_graph_exec": hasattr(torch.cuda.CUDAGraph,
                                           "raw_cuda_graph_exec")}
    print(json.dumps(head), flush=True)
    _cuda.build()
    TwoPhaseSys(7).checker().gpu_options(race=False).spawn_gpu().join()

    print(json.dumps({**head, "handoff": "none", "spinner": False,
                      "us": handoff_us(None, spin=False)}), flush=True)
    for interval in INTERVALS:
        print(json.dumps({**head, "handoff": interval, "spinner": True,
                          "us": handoff_us(interval)}), flush=True)

    in_c = _cuda.ChunkGraph.replay
    shorten, default_interval = (race._shorten_switch_interval,
                                 race.SWITCH_INTERVAL_S)

    def per_replay(self, times):
        for _ in range(times):
            self.graph.replay()
        for name, n in self.counts.items():
            _cuda.LAUNCHES[name] += n * times

    for turn in range(args.turns):
        for launch, replay in (("one C call a chunk", in_c),
                               ("graph.replay() a replay", per_replay)):
            _cuda.ChunkGraph.replay = replay
            for mode in ("race=False",) + INTERVALS:
                if not race.join_losers():
                    raise AssertionError("a raced loser is still running")
                t0 = time.perf_counter()
                if mode == "race=False":
                    ck = TwoPhaseSys(7).checker().gpu_options(race=False) \
                        .spawn_gpu()
                elif mode is None:
                    race._shorten_switch_interval = lambda: False
                    ck = TwoPhaseSys(7).checker().spawn_gpu()
                else:
                    race.SWITCH_INTERVAL_S = mode
                    ck = TwoPhaseSys(7).checker().spawn_gpu()
                try:
                    ck.join()
                finally:
                    race._shorten_switch_interval = shorten
                    race.SWITCH_INTERVAL_S = default_interval
                wall = time.perf_counter() - t0
                prof = ck.profile()
                ok = (ck.unique_state_count() == smoke.UNIQUE_2PC7
                      and ck.state_count() == smoke.GENERATED_2PC7
                      and smoke.fp_digest(ck.generated_fingerprints())
                      == smoke.DIGEST_2PC7)
                print(json.dumps({
                    **head, "run": "TwoPhaseSys(7)", "turn": turn,
                    "launch": launch,
                    "race": mode if mode == "race=False" else "raced",
                    "switch_interval_s": (None if mode == "race=False"
                                          else mode),
                    "wall_s": wall, "engine": prof["engine"],
                    **{k: prof.get(k) for k in ("seed_s", "capture_s",
                                                "loop_s", "sync_s",
                                                "graph_launches")},
                    "pinned": ok}), flush=True)
                if not ok:
                    raise AssertionError("2pc7 missed its pins")
                del ck
    _cuda.ChunkGraph.replay = in_c
    return 0


if __name__ == "__main__":
    sys.exit(main())
