"""The port's host engines, results surface and race against the JAX
package's, on the CPU (``gpu_options(device="cpu")``: the kernels' plain
versions run the device lane): a crashed run never reads as checked
clean, on both device engines (the sharded one on a one-rank gloo mesh);
``spawn_bfs()``'s fingerprint sets and ``spawn_dfs()``'s counts equal
the JAX package's; ``assert_discovery``; the cases of
tests/test_race.py (a small model answered by the host, a full
enumeration whoever wins, a model's encoding overflow deferring to the
host while any other device error ends the race, the eligibility
rule, ``report()``, ``race_budget``), and a cancelled plain-version
loser stopping within one iteration. The card's race is
in test_torch_gpu.py and chip_smoke.py."""

import io
import time

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

torch.set_num_threads(1)  # leave the other test workers their cores

jax = pytest.importorskip("jax")

from stateright_tpu.examples import increment as jinc  # noqa: E402
from stateright_tpu.examples import increment_lock as jlock  # noqa: E402
from stateright_tpu.models import packed as jpacked  # noqa: E402
from stateright_tpu.models import twopc as jtwopc  # noqa: E402
from stateright_tpu_torch import (Increment, IncrementLock,  # noqa: E402
                                  PackedLinearEquation, TwoPhaseSys)
from stateright_tpu_torch.checker import device_loop, race  # noqa: E402
from stateright_tpu_torch.checker.gpu import GpuChecker  # noqa: E402
from stateright_tpu_torch.checker.race import (  # noqa: E402
    RacingChecker, race_eligible)
from stateright_tpu_torch.parallel import engine  # noqa: E402


def _raced(model, **opts):
    return model.checker().gpu_options(device="cpu", **opts).spawn_gpu()


# --- the crashed-run guard --------------------------------------------------

@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo group on an in-memory store."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("shards",))
    finally:
        dist.destroy_process_group()


def _boom(*args, **kwargs):
    raise RuntimeError("injected chunk failure")


CRASH_CASES = [(IncrementLock, "mutex"), (TwoPhaseSys, "consistent")]


@pytest.mark.parametrize("model_cls,always", CRASH_CASES,
                         ids=["lock3", "2pc3"])
@pytest.mark.parametrize("sharded", [False, True],
                         ids=["single", "sharded"])
def test_crashed_run_never_reads_as_checked_clean(model_cls, always,
                                                  sharded, request,
                                                  monkeypatch):
    if sharded:
        monkeypatch.setattr(engine, "run_sharded_loop", _boom)
        opts = dict(mesh=request.getfixturevalue("mesh1"))
    else:
        monkeypatch.setattr(device_loop.ChunkRunner, "dispatch", _boom)
        opts = dict(device="cpu", race=False)
    ck = model_cls(3).checker().gpu_options(**opts).spawn_gpu()
    with pytest.raises(RuntimeError, match="injected"):
        ck.join()
    assert ck.is_done() and ck.unique_state_count() <= 1
    # the JAX package re-raises the engine's error here; before the
    # guard the port passed both with one state checked
    with pytest.raises(RuntimeError, match="injected"):
        ck.assert_properties()
    with pytest.raises(RuntimeError, match="injected"):
        ck.assert_no_discovery(always)
    with pytest.raises(RuntimeError, match="injected"):
        ck.report(io.StringIO())


# --- the host engines against the JAX package -------------------------------

BFS_CASES = {
    "2pc3": (lambda: TwoPhaseSys(3), lambda: jtwopc.TwoPhaseSys(3), 288),
    "2pc5": (lambda: TwoPhaseSys(5), lambda: jtwopc.TwoPhaseSys(5), 8832),
    "lineq247": (lambda: PackedLinearEquation(2, 4, 7),
                 lambda: jpacked.PackedLinearEquation(2, 4, 7), 65536),
}


@pytest.mark.parametrize("name", list(BFS_CASES))
def test_bfs_fingerprint_set_matches_jax(name):
    port, ref, unique = BFS_CASES[name]
    got = port().checker().spawn_bfs().join()
    want = ref().checker().spawn_bfs().join()
    assert got.unique_state_count() == want.unique_state_count() == unique
    assert got.state_count() == want.state_count()
    assert got.generated_fingerprints() == want.generated_fingerprints()
    assert sorted(got.discoveries()) == sorted(want.discoveries())
    for prop, path in got.discoveries().items():  # replays or raises
        assert path.into_actions() == want.discovery(prop).into_actions()


DFS_CASES = {
    "lock3": (lambda: IncrementLock(3), lambda: jlock.IncrementLock(3)),
    "inc2": (lambda: Increment(2), lambda: jinc.Increment(2)),
}


@pytest.mark.parametrize("symmetry", [False, True], ids=["plain", "sym"])
@pytest.mark.parametrize("name", list(DFS_CASES))
def test_dfs_counts_match_jax(name, symmetry):
    def run(model):
        builder = model.checker()
        if symmetry:
            builder = builder.symmetry_fn(model.representative)
        return builder.spawn_dfs().join()

    port, ref = DFS_CASES[name]
    got, want = run(port()), run(ref())
    assert got.unique_state_count() == want.unique_state_count()
    assert got.state_count() == want.state_count()
    assert got.generated_fingerprints() == want.generated_fingerprints()
    assert {k: p.into_actions() for k, p in got.discoveries().items()} \
        == {k: p.into_actions() for k, p in want.discoveries().items()}


def test_assert_discovery_accepts_a_witness_and_rejects_a_non_witness():
    ck = Increment(2).checker().spawn_dfs().join()
    ck.assert_discovery("fin", [("Read", 0), ("Read", 1), ("Write", 0),
                                ("Write", 1)])
    with pytest.raises(AssertionError, match="Invalid discovery"):
        ck.assert_discovery("fin", [("Read", 0), ("Write", 0)])
    # the JAX package judges the same actions alike
    ref = jinc.Increment(2).checker().spawn_dfs().join()
    ref.assert_discovery("fin", ck.discovery("fin").into_actions())


def test_host_engines_refuse_what_they_would_ignore():
    for spawn in ("spawn_bfs", "spawn_dfs"):
        with pytest.raises(NotImplementedError, match="A14"):
            getattr(TwoPhaseSys(3).checker().visitor(lambda *a: None),
                    spawn)()


@pytest.mark.parametrize("spawn", ["spawn_bfs", "spawn_dfs"])
def test_host_engines_run_sound_eventually(spawn):
    """``sound_eventually()`` on the host engines, which raised before
    their sound mode was ported: TwoPhaseSys (no eventually property:
    the plain run) and PingPong on a lossy network (its eventually
    properties under node keys: 277 nodes on the DFS) give the JAX
    package's counts, fingerprints and verdicts."""
    from stateright_tpu.actor.test_util import PingPongCfg as JCfg
    from stateright_tpu_torch.actor.test_util import PingPongCfg
    ping = PingPongCfg(maintains_history=True, max_nat=3).into_model() \
        .lossy_network(True)
    jping = JCfg(maintains_history=True, max_nat=3).into_model() \
        .lossy_network(True)
    for tm, jm in ((TwoPhaseSys(3), jtwopc.TwoPhaseSys(3)), (ping, jping)):
        got = getattr(tm.checker().sound_eventually(), spawn)().join()
        want = getattr(jm.checker().sound_eventually(), spawn)().join()
        assert got.unique_state_count() == want.unique_state_count()
        assert got.state_count() == want.state_count()
        assert got.generated_fingerprints() == want.generated_fingerprints()
        # the witnesses: the same node keys (BFS) or fingerprint paths
        # (DFS), each replaying through the host model
        assert got._discovery_fps == want._discovery_fps
        assert sorted(got.discoveries()) == sorted(want.discoveries())


# --- the race ---------------------------------------------------------------

def test_small_model_answered_by_the_host():
    t0 = time.perf_counter()
    ck = _raced(IncrementLock(3), capacity=1 << 14).join()
    dt = time.perf_counter() - t0
    want = jlock.IncrementLock(3).checker().tpu_options(
        capacity=1 << 14).spawn_tpu().join()
    assert ck.unique_state_count() == want.unique_state_count() == 61
    assert ck.profile()["engine"] == want.profile()["engine"] == "host"
    assert dt < RacingChecker.HOST_BUDGET_S, dt
    ck.assert_properties()
    # the retired device lane stops at its next iteration
    assert race.join_losers(timeout=30)


def test_full_enumeration_agnostic_to_winner():
    ck = _raced(TwoPhaseSys(3), capacity=1 << 12).join()
    assert ck.unique_state_count() == 288  # 2pc.rs:128
    ref = jtwopc.TwoPhaseSys(3).checker().spawn_bfs().join()
    assert ck.generated_fingerprints() == ref.generated_fingerprints()
    assert ck.generated_fingerprints() == \
        TwoPhaseSys(3).checker().spawn_bfs().join().generated_fingerprints()


class _OverflowingEquation(PackedLinearEquation):
    """Reports encoding overflow once x exceeds 5 (the optional third
    ``packed_step`` output), so the device run fails; the host model is
    fine, and bounded so the host finishes well inside the budget."""

    def packed_step(self, words):
        succ, valid = super().packed_step(words)
        overflow = valid & (succ[:, :, 0].to(torch.int64) > 5)
        return succ, valid & ~overflow, overflow

    def within_boundary(self, state):
        return state[0] <= 20 and state[1] <= 20


def test_device_failure_defers_to_host(monkeypatch):
    from stateright_tpu_torch.checker import bfs
    model = _OverflowingEquation(2, 0, 10 ** 9)  # unsatisfiable: full walk
    with pytest.raises(RuntimeError, match="capacity overflow"):
        model.checker().gpu_options(device="cpu", race=False,
                                    capacity=1 << 14).spawn_gpu().join()
    ck = _raced(_OverflowingEquation(2, 0, 10 ** 9), capacity=1 << 14)
    # the host starts once the device lane has failed, so the race
    # decides on the overflow
    gpu, host_run = ck._gpu, bfs.BfsChecker._run

    def held(self):
        while not gpu._done:
            time.sleep(0.001)
        host_run(self)

    monkeypatch.setattr(bfs.BfsChecker, "_run", held)
    ck.join()
    host = _OverflowingEquation(2, 0, 10 ** 9).checker().spawn_bfs().join()
    assert ck.unique_state_count() == host.unique_state_count() == 441
    prof = ck.profile()
    assert prof["engine"] == "host"
    assert "capacity overflow" in prof["device_error"]


def test_device_error_ends_the_race(monkeypatch):
    # a device error other than the model's encoding overflow (here a
    # chunk that fails to launch) surfaces from join() although the host
    # racer would answer: the host is held until the race is decided
    # (under a rule that waited for the host it would win after 30 s,
    # inside its budget)
    from stateright_tpu_torch.checker import bfs
    ck = _raced(IncrementLock(3), capacity=1 << 14, race_budget=60.0)
    assert isinstance(ck, RacingChecker)
    host_run = bfs.BfsChecker._run

    def held(self):
        ck._decided.wait(30)
        host_run(self)

    monkeypatch.setattr(device_loop.ChunkRunner, "dispatch", _boom)
    monkeypatch.setattr(bfs.BfsChecker, "_run", held)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="injected"):
        ck.join()
    assert time.monotonic() - t0 < 20
    assert race.join_losers()


def test_race_ineligible_paths():
    assert race_eligible(TwoPhaseSys(3).checker())
    assert isinstance(_raced(TwoPhaseSys(3)), RacingChecker)
    for builder in (
            TwoPhaseSys(3).checker().gpu_options(race=False),
            TwoPhaseSys(3).checker().gpu_options(mode="device"),
            TwoPhaseSys(3).checker().gpu_options(resumable=True),
            TwoPhaseSys(3).checker().resume_from("x.npz"),
            TwoPhaseSys(3).checker().gpu_options(mesh=object()),
            TwoPhaseSys(3).checker().symmetry_fn(
                TwoPhaseSys(3).representative)):
        assert not race_eligible(builder)
    ck = TwoPhaseSys(3).checker().gpu_options(
        device="cpu", race=False).spawn_gpu()
    assert isinstance(ck, GpuChecker)


def test_unported_race_knobs_raise():
    with pytest.raises(NotImplementedError, match="A9b"):
        TwoPhaseSys(3).checker().gpu_options(mesh=object(),
                                             race=True).spawn_gpu()
    with pytest.raises(NotImplementedError, match="A11"):
        _raced(TwoPhaseSys(3), failover=False)


def test_no_card_still_raises_from_spawn_gpu(monkeypatch):
    # the raced device lane is built in spawn_gpu(): without a card it
    # raises there, and never runs the host BFS alone
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available"):
        TwoPhaseSys(3).checker().spawn_gpu()


def test_report_streams_progress():
    out = io.StringIO()
    ck = _raced(TwoPhaseSys(3), capacity=1 << 12).report(out)
    text = out.getvalue()
    assert "Done. states=" in text
    assert "# engine=" in text
    assert ck.unique_state_count() == 288


def test_race_budget_option():
    # gpu_options(race_budget=...) overrides the 1.5 s host-racer budget
    ck = _raced(PackedLinearEquation(2, 4, 8), race_budget=9.0,
                capacity=1 << 10)
    assert isinstance(ck, RacingChecker)
    assert ck.HOST_BUDGET_S == 9.0
    assert RacingChecker.HOST_BUDGET_S == 1.5  # class default untouched
    found = ck.join().assert_any_discovery("solvable")
    x, y = found.last_state()
    assert (2 * x + 4 * y) & 0xFF == 8
    # the JAX package's raced run's witness is one for the port too
    ref = jpacked.PackedLinearEquation(2, 4, 8).checker().tpu_options(
        race_budget=9.0, capacity=1 << 10).spawn_tpu().join()
    ck.assert_discovery("solvable",
                        ref.assert_any_discovery("solvable").into_actions())


def test_cancelled_plain_loser_stops_within_one_iteration(monkeypatch):
    ck = TwoPhaseSys(5).checker().gpu_options(
        device="cpu", race=False, fmax=16, chunk_steps=64).spawn_gpu()
    calls = []
    plain = device_loop.iteration_reference

    def first_then_cancel(*args, **kwargs):
        calls.append(1)
        ck.cancel()
        return plain(*args, **kwargs)

    monkeypatch.setattr(device_loop, "iteration_reference",
                        first_then_cancel)
    ck.join()
    assert len(calls) == 1
    assert ck.cancelled() and not ck._thread.is_alive()
    assert ck.profile()["iterations"] == 1
    assert ck.unique_state_count() < 8832


def test_switch_interval_is_restored_after_the_race():
    import sys
    before = sys.getswitchinterval()
    _raced(IncrementLock(3)).join()
    assert sys.getswitchinterval() == before


def test_new_modules_import_no_jax():
    import ast
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parent.parent
    for name in ("bfs", "dfs", "race", "resilience"):
        tree = ast.parse((root / "stateright_tpu_torch" / "checker"
                          / f"{name}.py").read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    and node.level == 0 else [])
            assert not any(m.split(".")[0] in ("jax", "jaxlib",
                                               "stateright_tpu")
                           for m in mods), (name, mods)
    code = (
        "import sys, tempfile, os\n"
        "from stateright_tpu_torch import IncrementLock, TwoPhaseSys\n"
        "ck = IncrementLock(3).checker().gpu_options(device='cpu')"
        ".spawn_gpu().join()\n"
        "assert ck.profile()['engine'] == 'host'\n"
        "assert IncrementLock(3).checker().spawn_dfs().join()"
        ".unique_state_count() == 61\n"
        "path = os.path.join(tempfile.mkdtemp(), 'c.npz')\n"
        "TwoPhaseSys(3).checker().gpu_options(device='cpu', "
        "resumable=True).target_state_count(100).spawn_gpu().join()"
        ".save(path)\n"
        "ck = TwoPhaseSys(3).checker().gpu_options(device='cpu')"
        ".resume_from(path).spawn_gpu().join()\n"
        "assert ck.unique_state_count() == 288\n"
        "import shutil; shutil.rmtree(os.path.dirname(path))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'stateright_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=300)
