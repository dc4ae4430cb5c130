#!/usr/bin/env python3
"""Sweep the table budget of a capped run (``gpu_options(max_capacity=,
grow_at=)``) on the card: which budgets finish, and with how many spills.

    python3 tools/torch_spill_sweep.py [--model 2pc5|2pc7|paxos2-lossy]
        [--fmax F] [--capacity C] [--max-capacity M] [--limit S]
        [--grow-at G ...] [--cpu]

A spill evicts the coldest prefix ranges of the visited table into the
host tier; a rediscovered key is filtered from the counts but its row is
expanded again, as in the JAX package. Below some share of the reachable
set the re-expansion refills the table before an epoch ends and the run
spills without end, so a capped run's budget is chosen from this sweep.
Each ``grow_at`` runs once, cancelled after ``--limit`` seconds; one JSON
line each: the table occupancy that spills as a share of the reachable
set (``hot_share``), whether it finished, its wall, its spill counters and
whether its fingerprint set is the uncapped run's (run first, same
``fmax``).
"""

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

KEYS = ("spills", "evicted_keys", "host_tier_keys", "host_probe_hits",
        "grows", "capacity", "shadow_s", "spill_s", "loop_s")


def model_of(name: str):
    if name.startswith("2pc"):
        from stateright_tpu_torch import TwoPhaseSys
        return TwoPhaseSys(int(name[3:]))
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    return PackedPaxos(2).lossy_network(True)


def digest(fps) -> str:
    import numpy as np
    arr = np.array(sorted(fps), dtype=np.uint64)
    return hashlib.sha256(arr.astype("<u8").tobytes()).hexdigest()


def run(name: str, limit: float, **opts) -> dict:
    ck = model_of(name).checker().gpu_options(race=False, **opts) \
        .spawn_gpu()
    t0 = time.perf_counter()
    ck._start_background()
    while not ck._done and time.perf_counter() - t0 < limit:
        time.sleep(0.05)
    done = ck._done
    if not done:
        ck.cancel()
        ck._thread.join()
    out = {"finished": done and ck.error() is None,
           "wall_s": time.perf_counter() - t0,
           "unique": ck.unique_state_count(),
           "generated": ck.state_count()}
    if ck.error() is not None:
        out["error"] = f"{type(ck.error()).__name__}: {ck.error()}"
    prof = ck.profile()
    out.update({k: prof[k] for k in KEYS if k in prof})
    if out["finished"]:
        out["digest"] = digest(ck.generated_fingerprints())
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="2pc7",
                    choices=("2pc5", "2pc7", "paxos2-lossy"))
    ap.add_argument("--fmax", type=int, default=1024)
    ap.add_argument("--capacity", type=int, default=1 << 17)
    ap.add_argument("--max-capacity", type=int, default=1 << 19)
    ap.add_argument("--limit", type=float, default=60.0)
    ap.add_argument("--grow-at", type=float, nargs="+",
                    default=[0.5, 0.45, 0.4, 0.35])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import torch
    if not args.cpu and not torch.cuda.is_available():
        print("torch_spill_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = {"device": "cpu"} if args.cpu else {}
    model = model_of(args.model)
    headroom = args.fmax * model.max_actions
    base = run(args.model, 10 * args.limit, fmax=args.fmax, **dev)
    print(json.dumps({"model": args.model, "uncapped": True, **base}),
          flush=True)
    for ga in args.grow_at:
        res = run(args.model, args.limit, fmax=args.fmax,
                  capacity=args.capacity, max_capacity=args.max_capacity,
                  grow_at=ga, **dev)
        # the occupancy at which growth past the budget spills (the
        # table quadruples, so it ends at the largest capacity * 4**k
        # within the budget)
        cap = res.get("capacity", args.max_capacity)
        hot = min(ga * cap, cap - headroom)
        res["same_set"] = res.get("digest") == base.get("digest")
        print(json.dumps({"model": args.model, "grow_at": ga,
                          "fmax": args.fmax, "capacity": args.capacity,
                          "max_capacity": args.max_capacity,
                          "hot_share": hot / base["unique"], **res}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
