"""The rank program of tests/test_torch_sharded.py: the port's sharded
engine on gloo over CPU processes.

``run_rank`` is what ``torch.multiprocessing.spawn`` starts in each rank.
It joins a process group through a file store (no sockets), runs every
case on a one-dimensional CPU DeviceMesh and writes what each rank's
checker answers to ``<out_dir>/rank<r>.pkl``. It imports torch and the
port only, never JAX, and records which modules of JAX or of the JAX
package were loaded, so the tests can hold the children to that.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the cases, by name: (2pc n, gpu_options). Every knob the JAX engine
#: sizes by is explicit, so both engines take the same steps.
CASES = {
    "n3": (3, dict(capacity=1 << 12, fmax=64, kraw=1088, kmax=1088)),
    "n4": (4, dict(capacity=1 << 14, fmax=64, kraw=1408, kmax=512, kb=256,
                   cc_dedup=1 << 10)),
    "n4_ring": (4, dict(capacity=1 << 14, fmax=64, kraw=1408, kmax=512,
                        cc_dedup=1 << 10, exchange="ring")),
    "n4_grow": (4, dict(capacity=1 << 10, fmax=16, kraw=352, kmax=128,
                        cc_dedup=1 << 10)),
    "n3_kmax": (3, dict(capacity=1 << 12, fmax=64, kmax=16)),
    "n3_kb": (3, dict(capacity=1 << 12, fmax=64, kraw=1088, kmax=1088,
                      kb=16)),
    # the slow grid: 8,832 states, 256-row steps
    "n5": (5, dict(capacity=1 << 16, fmax=256, kraw=6912, kmax=4096)),
}


def check(mesh, name: str) -> dict:
    """Run one case on ``mesh``; return the checker's answers."""
    from stateright_tpu_torch import TwoPhaseSys

    n, opts = CASES[name]
    ck = TwoPhaseSys(n).checker().gpu_options(mesh=mesh, **opts) \
        .spawn_gpu().join()
    fps = ck.generated_fingerprints()
    model = ck.model()
    replay = {}
    for prop, path in ck.discoveries().items():  # replays or raises
        replay[prop] = bool(model.property(prop).condition(
            model, path.last_state()))
    return {"unique": ck.unique_state_count(),
            "generated": ck.state_count(), "fps": fps,
            # the mirror is engine-internal; the row gate reads it
            "mirror": list(ck._generated.items()),
            "discoveries": dict(ck._discovery_fps), "replay": replay,
            "profile": ck.profile()}


def run_rank(rank: int, world: int, store_path: str, out_dir: str,
             names) -> None:
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", (world,),
                                mesh_dim_names=("shards",))
        results = {}
        for name in names:
            try:
                results[name] = check(mesh, name)
            except Exception:  # reported per case; the tests re-raise
                results[name] = {"error": traceback.format_exc()}
        results["_loaded"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "stateright_tpu"))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
