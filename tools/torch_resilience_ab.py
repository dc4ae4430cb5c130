#!/usr/bin/env python3
"""Time the default runs (no resilience knob set) of this tree against
another tree's on the card, in turns: old, new, new, old.

    python3 tools/torch_resilience_ab.py --old DIR

(unpack the parent with ``git archive HEAD~ stateright_tpu_torch |
tar -x -C build/parent``). Each turn is a fresh process that builds its
tree's kernels (into that tree's ``build/kernels``), runs every workload
once to warm it, then once timed: TwoPhaseSys(7), lossy PackedPaxos(2),
the BASELINE PackedPaxos(3) bounded at 500,000 and PackedPingPong(7)
under ``sound_eventually()``, each with ``race=False`` and nothing else
set. One JSON line a turn and workload: the tree, the wall from
``spawn_gpu()`` to ``join()``, ``loop_s``, and the count and digest of
the fingerprint set (equal across trees: the knobs' default path did not
move).
"""

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
from stateright_tpu_torch import TwoPhaseSys
from stateright_tpu_torch.actor.test_util import PackedPingPong
from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
from stateright_tpu_torch.ops import _cuda

WORKLOADS = {
    "2pc7": lambda: TwoPhaseSys(7).checker(),
    "paxos2_lossy": lambda: PackedPaxos(2).lossy_network(True).checker(),
    "paxos3_baseline": lambda: PackedPaxos(3).checker().gpu_options(
        capacity=1 << 21).target_state_count(500_000),
    "ping7_sound": lambda: PackedPingPong(
        7, lossy=True, duplicating=True).checker().sound_eventually(),
}
_cuda.build()
for name, make in WORKLOADS.items():
    for timed in (False, True):
        t0 = time.perf_counter()
        ck = make().gpu_options(race=False).spawn_gpu().join()
        wall = time.perf_counter() - t0
        if not timed:
            continue
        arr = np.array(sorted(ck.generated_fingerprints()), dtype=np.uint64)
        print(json.dumps({
            "workload": name, "wall_s": wall,
            "loop_s": ck.profile().get("loop_s"),
            "unique": ck.unique_state_count(),
            "generated": ck.state_count(),
            "digest": hashlib.sha256(arr.astype("<u8").tobytes())
            .hexdigest()}), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True)
    args = ap.parse_args()
    new = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"old": os.path.abspath(args.old), "new": new}
    for turn, label in enumerate(("old", "new", "new", "old")):
        out = subprocess.run([sys.executable, "-c", CHILD, trees[label]],
                             capture_output=True, text=True, timeout=1500)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({"tree": label, "turn": turn,
                                  **json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
