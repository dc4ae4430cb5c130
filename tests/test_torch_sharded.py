"""The port's sharded engine, ``gpu_options(mesh=<DeviceMesh>)``, on gloo
over CPU processes, against the JAX package's sharded fused engine
(``tpu_options(mesh=Mesh(...), fused=True)``, Pallas in interpret mode,
on the suite's virtual CPU devices) at the same mesh width and the same
explicit knobs.

D = 1 runs in this process; D = 2 and D = 4 each run in ONE spawn of
ranks (``tests/torch_sharded_worker.py``) that checks every case of its
width, since a process group costs seconds to start. The gates: equal
unique and generated counts, visited-fingerprint sets and discoveries,
witnesses that replay through the port's host model, every rank
answering alike, and at D = 1, 2 and 4 (bucket exchange at D > 1) the
mirror equal to the JAX engine's row for row. Under symmetry reduction:
the complete representative's 314 orbits of 2pc n=5 at D = 1, 2 and 4,
and the row gate (mirror and original fingerprints) at n=4 with the
reference representative at D = 1 and 2. Exact: integer arithmetic."""

import ast
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

torch.set_num_threads(1)  # leave the other test workers their cores

jax = pytest.importorskip("jax")
from jax.sharding import Mesh  # noqa: E402

from stateright_tpu.models import twopc as jtwopc  # noqa: E402
from stateright_tpu_torch import TwoPhaseSys  # noqa: E402

import torch_sharded_worker as worker  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: cases each width runs (names of torch_sharded_worker.CASES)
RUNS = {1: ("n3", "n4", "n4_grow", "n3_kmax", "n4_sym", "n5_csym"),
        2: ("n3", "n4", "n4_ring", "n4_grow", "n3_kmax", "n3_kb", "n4_sym",
            "n5_csym"),
        4: ("n3", "n4", "n5_csym")}

_JAX: dict = {}


def jax_ref(name: str, d: int) -> dict:
    """The JAX sharded fused engine's answers for one case (memoized)."""
    if (name, d) not in _JAX:
        n, opts, *sym = worker.CASES[name]
        devices = jax.devices()
        if len(devices) < d:
            pytest.skip(f"needs {d} JAX devices")
        model = jtwopc.TwoPhaseSys(n, complete_symmetry=sym == ["complete"])
        builder = model.checker().tpu_options(
            mesh=Mesh(np.array(devices[:d]), ("shards",)), fused=True,
            race=False, **opts)
        if sym:
            builder = builder.symmetry_fn(model.representative)
        ck = builder.spawn_tpu().join()
        fps = ck.generated_fingerprints()
        _JAX[name, d] = {"unique": ck.unique_state_count(),
                         "generated": ck.state_count(), "fps": fps,
                         "mirror": list(ck._generated.items()),
                         "orig": list(ck._orig_of.items()),
                         "discoveries": dict(ck._discovery_fps)}
    return _JAX[name, d]


@pytest.fixture(scope="module")
def d1():
    """D = 1 in this process: a one-rank gloo group on an in-memory
    store."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("shards",))
        yield [{name: worker.check(mesh, name) for name in RUNS[1]}], mesh
    finally:
        dist.destroy_process_group()


def _spawn_cases(d: int, tmp: pathlib.Path, names):
    """Run ``names`` on ``d`` spawned ranks; every rank's answers."""
    mp.spawn(worker.run_rank,
             args=(d, str(tmp / "store"), str(tmp), names), nprocs=d,
             join=True)
    out = []
    for r in range(d):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def d2(tmp_path_factory):
    return _spawn_cases(2, tmp_path_factory.mktemp("d2"), RUNS[2])


@pytest.fixture(scope="module")
def d4(tmp_path_factory):
    return _spawn_cases(4, tmp_path_factory.mktemp("d4"), RUNS[4])


@pytest.fixture
def ranks(d1, d2, d4):
    return {1: d1[0], 2: d2, 4: d4}


def _result(ranks, d, name) -> dict:
    res = ranks[d][0][name]
    if "error" in res:
        pytest.fail(f"D={d} {name} raised on the ranks:\n{res['error']}")
    return res


GATES = [(d, name) for d in (1, 2, 4) for name in ("n3", "n4")]


@pytest.mark.parametrize("d,name", GATES,
                         ids=[f"D{d}-{name}" for d, name in GATES])
def test_set_gate_against_jax_sharded_engine(ranks, d, name):
    got, want = _result(ranks, d, name), jax_ref(name, d)
    assert got["unique"] == want["unique"] == {"n3": 288,
                                               "n4": 1568}[name]
    assert got["generated"] == want["generated"]
    assert got["fps"] == want["fps"]
    assert got["discoveries"] == want["discoveries"]
    assert got["replay"] == {"abort agreement": True,
                             "commit agreement": True}


@pytest.mark.parametrize("d", [1, 2, 4])
def test_row_gate_against_jax_sharded_engine(ranks, d):
    # bucket exchange at D = 2 (the default); the zero-hop ring at D = 1
    got, want = _result(ranks, d, "n4"), jax_ref("n4", d)
    assert got["profile"]["exchange"] == ("bucket" if d > 1 else "ring")
    assert len(got["mirror"]) == 1568
    assert got["mirror"] == want["mirror"]


@pytest.mark.parametrize("d", [1, 2, 4])
def test_complete_symmetry_set_gate(ranks, d):
    # the orbit-invariant representative: exactly the 314 orbits of 2pc
    # n=5, the JAX sharded engine's canonical keys, whatever the width
    got, want = _result(ranks, d, "n5_csym"), jax_ref("n5_csym", d)
    assert got["unique"] == want["unique"] == 314
    assert got["generated"] == want["generated"] == 2048
    assert got["fps"] == want["fps"]
    assert got["discoveries"] == want["discoveries"]
    assert got["replay"] == {"abort agreement": True,
                             "commit agreement": True}


@pytest.mark.parametrize("d", [1, 2])
def test_symmetric_row_gate_against_jax_sharded_engine(ranks, d):
    # the reference representative, whose count depends on the order:
    # the mirror (canonical keys) and the original fingerprints of the
    # 6-column logs, row for row
    got, want = _result(ranks, d, "n4_sym"), jax_ref("n4_sym", d)
    assert got["unique"] == want["unique"]
    assert got["generated"] == want["generated"]
    assert got["mirror"] == want["mirror"]
    assert got["orig"] == want["orig"]
    assert len(got["orig"]) == got["unique"]
    assert got["discoveries"] == want["discoveries"]
    assert got["replay"] == {"abort agreement": True,
                             "commit agreement": True}


def test_ring_and_bucket_give_the_same_set(ranks):
    ring, bucket = _result(ranks, 2, "n4_ring"), _result(ranks, 2, "n4")
    assert ring["profile"]["exchange"] == "ring"
    assert bucket["profile"]["exchange"] == "bucket"
    assert ring["fps"] == bucket["fps"] == jax_ref("n4", 2)["fps"]
    assert ring["discoveries"] == bucket["discoveries"]


@pytest.mark.parametrize("d", [1, 2])
def test_growth_keeps_the_set(ranks, d):
    got = _result(ranks, d, "n4_grow")
    assert got["profile"]["grows"] >= 1
    assert got["profile"]["capacity"] > 1 << 10
    assert got["fps"] == jax_ref("n4", d)["fps"]
    assert got["generated"] == jax_ref("n4", d)["generated"]


ABORTS = [(1, "n3_kmax"), (2, "n3_kmax"), (2, "n3_kb")]


@pytest.mark.parametrize("d,name", ABORTS,
                         ids=[f"D{d}-{name}" for d, name in ABORTS])
def test_aborts_resize_and_complete(ranks, d, name):
    # kmax below the deduplicated lanes, or a bucket below the lanes for
    # one owner: the iteration aborts before any mutation, the buffers
    # widen, and the enumeration stays exact
    got = _result(ranks, d, name)
    assert got["profile"]["kovfs"] >= 1
    assert got["profile"]["aborts"] >= 1
    assert got["fps"] == jax_ref("n3", d)["fps"]
    assert got["generated"] == jax_ref("n3", d)["generated"]
    assert got["discoveries"] == jax_ref("n3", d)["discoveries"]


@pytest.mark.parametrize("d", [2, 4])
def test_every_rank_answers_alike(ranks, d):
    for name in RUNS[d]:
        first = _result(ranks, d, name)
        for r in range(1, d):
            other = ranks[d][r][name]
            for key in ("unique", "generated", "fps", "mirror", "orig",
                        "discoveries", "replay"):
                assert other[key] == first[key], (name, r, key)


@pytest.mark.parametrize("d", [2, 4])
def test_ranks_load_no_jax(ranks, d):
    for r in range(d):
        assert ranks[d][r]["_loaded"] == [], r


@pytest.mark.slow
@pytest.mark.parametrize("d", [2, 4])
def test_2pc5_row_gate(tmp_path, d):
    # a longer run per width, its own spawn: 8,832 states
    got = _spawn_cases(d, tmp_path, ("n5",))
    want = jax_ref("n5", d)
    for rank in got:
        res = rank["n5"]
        assert "error" not in res, res.get("error")
        assert res["unique"] == want["unique"] == 8832
        assert res["generated"] == want["generated"]
        assert res["mirror"] == want["mirror"]
        assert res["discoveries"] == want["discoveries"]


# --- option guards ---------------------------------------------------------

def _unbacked_mesh(size: int) -> DeviceMesh:
    """A DeviceMesh of ``size`` ranks with no process group behind it:
    enough for the checks the engine makes before it touches one."""
    return DeviceMesh("cpu", list(range(size)), mesh_dim_names=("shards",),
                      _init_backend=False, _rank=0)


def test_mesh_axis_of_three_raises():
    with pytest.raises(ValueError, match="power of two"):
        TwoPhaseSys(3).checker().gpu_options(mesh=_unbacked_mesh(3)) \
            .spawn_gpu()


def test_capacity_not_divisible_by_the_axis_raises():
    with pytest.raises(ValueError, match="divisible"):
        TwoPhaseSys(3).checker().gpu_options(mesh=_unbacked_mesh(8),
                                             capacity=4).spawn_gpu()


@pytest.mark.parametrize("opts,err,match", [
    (dict(mesh_axis="rows"), ValueError, "no axis"),
    (dict(exchange="star"), ValueError, "exchange"),
    (dict(device="cuda"), ValueError, "device type"),
    (dict(race=True), NotImplementedError, "race"),
    (dict(pipeline=True), NotImplementedError, "pipeline"),
    (dict(spill=True), NotImplementedError, "resilience"),
    (dict(symmetry=True), NotImplementedError, "not ported"),
])
def test_option_guards(opts, err, match):
    with pytest.raises(err, match=match):
        TwoPhaseSys(3).checker().gpu_options(mesh=_unbacked_mesh(2),
                                             **opts).spawn_gpu()


def test_sharded_knobs_need_a_mesh():
    with pytest.raises(NotImplementedError, match="mesh"):
        TwoPhaseSys(3).checker().gpu_options(device="cpu",
                                             exchange="ring").spawn_gpu()


class _CudaMesh:
    """A CUDA-typed mesh over a gloo group (what the engine must refuse:
    NCCL is the only backend for CUDA tensors)."""

    mesh_dim_names = ("shards",)
    device_type = "cuda"

    def size(self, dim):
        return 1

    def get_group(self, axis):
        return dist.group.WORLD

    def get_local_rank(self, axis):
        return 0


def test_cuda_mesh_without_nccl_raises(d1, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="NCCL"):
        TwoPhaseSys(3).checker().gpu_options(mesh=_CudaMesh()).spawn_gpu()


# --- the import boundary ---------------------------------------------------

def test_parallel_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "stateright_tpu_torch" / "parallel")
                   .glob("*.py"))
    assert {p.name for p in files} >= {"__init__.py", "collectives.py",
                                       "engine.py", "sharded.py"}
    for path in files + [ROOT / "tests" / "torch_sharded_worker.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "stateright_tpu"), (path, name)


def test_sharded_run_loads_no_jax():
    code = (
        "import sys\n"
        "import torch.distributed as dist\n"
        "from torch.distributed.device_mesh import init_device_mesh\n"
        "from stateright_tpu_torch import TwoPhaseSys\n"
        "dist.init_process_group('gloo', store=dist.HashStore(), rank=0,"
        " world_size=1)\n"
        "mesh = init_device_mesh('cpu', (1,), mesh_dim_names=('shards',))\n"
        "ck = TwoPhaseSys(3).checker().gpu_options(mesh=mesh, fmax=64)"
        ".spawn_gpu().join()\n"
        "assert ck.unique_state_count() == 288\n"
        "ck.discovery('commit agreement')\n"
        "dist.destroy_process_group()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'stateright_tpu'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300, env=env)
