"""The port's engine, ``spawn_gpu()``: end to end on the CPU (plain
versions of the kernels) against the 2pc oracles and, row for row,
against the JAX package's fused device engine; the option guards; and
the import boundary. The card-only tests are in test_torch_gpu.py."""

import ast
import hashlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

jax = pytest.importorskip("jax")

from stateright_tpu.models import twopc as jtwopc  # noqa: E402
from stateright_tpu_torch import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.core import Property  # noqa: E402

JaxTwoPhaseSys = jtwopc.TwoPhaseSys
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _cpu(model, **opts):
    """The device engine alone on the CPU (the race would let the host
    BFS win small models, and its record is in BFS order)."""
    opts = {"device": "cpu", "race": False, **opts}
    return model.checker().gpu_options(**opts).spawn_gpu().join()


def _digest(fps) -> str:
    arr = np.array(sorted(fps), dtype=np.uint64)
    return hashlib.sha256(arr.astype("<u8").tobytes()).hexdigest()


@pytest.mark.parametrize("n,unique,generated", [(3, 288, 1146),
                                                (5, 8832, 58146)])
def test_2pc_counts_verdicts_and_witnesses(n, unique, generated):
    ck = _cpu(TwoPhaseSys(n))
    assert ck.unique_state_count() == unique
    assert ck.state_count() == generated
    assert len(ck.generated_fingerprints()) == unique
    ck.assert_properties()
    model = ck.model()
    for name in ("abort agreement", "commit agreement"):
        path = ck.discovery(name)  # replays through the host model
        assert model.property(name).condition(model, path.last_state())
        assert len(path) >= n
    assert ck.discovery("consistent") is None


ROW_GATE = [dict(fmax=16, capacity=1 << 12, cc_dedup=64),
            dict(fmax=512, capacity=1 << 14, cc_dedup=1 << 15)]
#: the chunk sizes and the pipeline: a step's rows do not depend on where
#: chunks begin or end, so neither may move a row of the record
CHUNKS = [(k, p) for k in (1, 4, 8, 64) for p in (False, True)]


@pytest.mark.parametrize("chunk_steps,pipeline", CHUNKS,
                         ids=[f"k{k}-{'pipeline' if p else 'sync'}"
                              for k, p in CHUNKS])
@pytest.mark.parametrize("opts", ROW_GATE, ids=["f16", "f512"])
def test_row_gate_against_jax_fused_engine(opts, chunk_steps, pipeline):
    # every shape knob set on both sides: the JAX engine's size memo
    # could otherwise move its defaults between runs
    opts = dict(opts, chunk_steps=chunk_steps, pipeline=pipeline)
    want = JaxTwoPhaseSys(4).checker().tpu_options(
        race=False, fused=True, mode="device", **opts).spawn_tpu().join()
    got = _cpu(TwoPhaseSys(4), **opts)
    want._ensure_mirror()
    got._ensure_mirror()
    assert got.unique_state_count() == want.unique_state_count() == 1568
    assert got.state_count() == want.state_count()
    assert list(got._generated.items()) == list(want._generated.items())
    assert got._discovery_fps == want._discovery_fps


def test_growth_keeps_count_and_mirror():
    # 16-row steps keep the 2**10 table (no capacity pre-bump), so the
    # run grows 2**10 -> 2**12 -> 2**14
    grown = _cpu(TwoPhaseSys(5), capacity=1 << 10, fmax=16)
    flat = _cpu(TwoPhaseSys(5), capacity=1 << 16, fmax=16)
    assert grown.profile()["grows"] == 2
    assert flat.profile()["grows"] == 0
    assert grown.unique_state_count() == flat.unique_state_count() == 8832
    assert grown.state_count() == flat.state_count()
    assert grown.generated_fingerprints() == flat.generated_fingerprints()
    grown.assert_properties()


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r'gpu_options\(device="cpu"\)'):
        TwoPhaseSys(3).checker().spawn_gpu()


class _HostProps(TwoPhaseSys):
    host_property_indices = (0,)


class _NoCanon(TwoPhaseSys):
    """A packed model without the device representative."""

    packed_representative = None


def _symmetry_without_canon(builder):
    # symmetry reduction is ported; what stays refused is a model whose
    # packed side cannot canonicalize
    builder.model = _NoCanon(3)
    return builder.symmetry()


@pytest.mark.parametrize("setup,match", [
    (_symmetry_without_canon, "packed_representative"),
    (lambda b: b.visitor(lambda *a: None), "visitor"),
    (lambda b: b.gpu_options(mesh=object()).resume_from("x.npz"),
     "checkpoints on a mesh"),
    (lambda b: b.gpu_options(mesh=object()), "mesh"),
    (lambda b: b.gpu_options(hint=2), "hint"),
    (lambda b: b.gpu_options(mode="level"), "per-level"),
    (lambda b: b.gpu_options(race=True, mesh=object()), "race=True"),
    (lambda b: b.gpu_options(fused="auto"), "fallback"),
    (lambda b: b.gpu_options(no_such_option=1), "not ported"),
], ids=["symmetry", "visitor", "resume", "mesh", "hint", "level", "race",
        "fused_auto", "unknown"])
def test_unported_features_raise(setup, match):
    builder = setup(TwoPhaseSys(3).checker().gpu_options(device="cpu"))
    with pytest.raises(NotImplementedError, match=match):
        builder.spawn_gpu()


@pytest.mark.parametrize("setup,jax_setup", [
    (lambda b: b.sound_eventually(), lambda b: b.sound_eventually()),
    (lambda b: b.gpu_options(fused=False),
     lambda b: b.tpu_options(fused=False)),
], ids=["sound", "fused_false"])
def test_sound_and_staged_run_and_match_jax(setup, jax_setup):
    """The calls that raised before the staged step was ported
    (``sound_eventually()``, ``fused=False``) now run: raced as the JAX
    package's are and alone on the staged step, to the JAX package's
    counts and verdicts."""
    ck = setup(TwoPhaseSys(3).checker().gpu_options(device="cpu")) \
        .spawn_gpu().join()
    want = jax_setup(JaxTwoPhaseSys(3).checker().tpu_options(
        race=False, fused=False, mode="device")).spawn_tpu().join()
    assert ck.unique_state_count() == want.unique_state_count() == 288
    assert ck.generated_fingerprints() == want.generated_fingerprints()
    assert sorted(ck.discoveries()) == sorted(want.discoveries())
    alone = setup(TwoPhaseSys(3).checker().gpu_options(
        device="cpu", race=False)).spawn_gpu().join()
    assert alone.state_count() == want.state_count()
    assert alone.generated_fingerprints() == want.generated_fingerprints()


def test_checkpoint_save_raises():
    # checkpoints are ported; a run without resumable=True has no
    # pending frontier to save
    ck = _cpu(TwoPhaseSys(3))
    with pytest.raises(RuntimeError, match="resumable"):
        ck.save("x.npz")


def test_host_evaluated_properties_raise():
    # host-evaluated properties run on one card (the chunk's history
    # stage); a mesh still refuses them (the sharded post-hoc reduction,
    # B14, is not ported)
    with pytest.raises(NotImplementedError, match="host-evaluated"):
        _HostProps(3).checker().gpu_options(
            device="cpu", mesh=object()).spawn_gpu()


def test_accepted_jax_option_values_run():
    ck = _cpu(TwoPhaseSys(3), race=False, pipeline=False, fused=True,
              mode="device")
    assert ck.unique_state_count() == 288


def test_no_properties_stops_at_the_inits():
    class Bare(TwoPhaseSys):
        def properties(self):
            return []

    ck = _cpu(Bare(3))
    assert ck.unique_state_count() == 1 and ck.state_count() == 1


def test_target_state_count_stops_early():
    ck = (TwoPhaseSys(5).checker().target_state_count(500)
          .gpu_options(device="cpu", fmax=16, chunk_steps=1)
          .spawn_gpu().join())
    assert 500 <= ck.state_count() < 58146
    assert ck.unique_state_count() < 8832


class Strict(TwoPhaseSys):
    """TwoPhaseSys with a fourth property, "no commit" (always)."""

    def properties(self):
        return super().properties() + [Property.always(
            "no commit", lambda _, s: 2 not in s[0])]

    def packed_properties(self, words):
        pb = super().packed_properties(words)
        rmw = words[:, 0].to(torch.int64) & 0xFFFFFFFF
        fields = (rmw[:, None] >> (2 * torch.arange(self.n))) & 3
        return torch.cat([pb, ~(fields == 2).any(1, keepdim=True)], 1)


def test_always_violation_is_a_replayable_counterexample():
    ck = _cpu(Strict(3))
    path = ck.discovery("no commit")
    assert 2 in path.last_state()[0]
    assert ck.discovery_classification("no commit") == "counterexample"
    with pytest.raises(AssertionError, match="no commit"):
        ck.assert_properties()


class _Lenient(TwoPhaseSys):
    """TwoPhaseSys's properties, but "consistent" only sometimes."""

    def properties(self):
        props = super().properties()
        return props[:2] + [Property.sometimes("consistent",
                                               props[2].condition)]


class _OwnStep(TwoPhaseSys):
    def packed_step(self, words):
        return super().packed_step(words)


class _OwnProps(TwoPhaseSys):
    def packed_properties(self, words):
        return super().packed_properties(words)


def test_kernel_model_spec():
    assert TwoPhaseSys(7).cuda_spec() == ("twopc", (7,))


@pytest.mark.parametrize("model", [Strict(3), _Lenient(3), _OwnStep(3),
                                   _OwnProps(3)],
                         ids=["extra_property", "expectation", "step",
                              "properties"])
def test_card_refuses_models_its_kernel_does_not_implement(model,
                                                           monkeypatch):
    # the step kernel runs csrc/twopc.cuh: TwoPhaseSys's own step and
    # three properties; a subclass changing them is refused on the card
    # at spawn, before any launch, instead of getting 2pc's verdicts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="CUDA step kernel"):
        model.cuda_spec()
    with pytest.raises(NotImplementedError, match="CUDA step kernel"):
        model.checker().spawn_gpu()


# --- the import boundary --------------------------------------------------

def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax_or_the_jax_package_statically():
    files = sorted((ROOT / "stateright_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "stateright_tpu"), \
                f"{path.relative_to(ROOT)} imports {name}"


def test_port_run_loads_no_jax():
    code = (
        "import sys\n"
        "from stateright_tpu_torch import TwoPhaseSys\n"
        "ck = TwoPhaseSys(3).checker().gpu_options(device='cpu')"
        ".spawn_gpu().join()\n"
        "assert ck.unique_state_count() == 288\n"
        "ck.discovery('commit agreement')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'stateright_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)



# --- no hidden fallback ----------------------------------------------------

class _CudaLike:
    """Stands in for a CUDA tensor: the wrappers dispatch on ``is_cuda``."""

    is_cuda = True
    device = "cuda"

    def __init__(self, n=0):
        self.shape = (n, 4)

    def numel(self):
        return 0


def test_wrappers_never_run_the_plain_version_for_cuda(monkeypatch):
    from stateright_tpu_torch.ops import _cuda, fused, hashtable
    calls = []

    def plain(*args, **kwargs):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(fused, "fused_step_reference", plain)
    monkeypatch.setattr(hashtable, "table_insert_reference", plain)
    monkeypatch.setattr(fused, "StepWorkspace", lambda *a: "ws")
    monkeypatch.setattr(_cuda, "fused_step",
                        lambda *a: calls.append("step") or (None,) * 10)
    monkeypatch.setattr(_cuda, "table_insert",
                        lambda *a: calls.append("insert") or (None, False, 0))
    fused.fused_step(TwoPhaseSys(3), _CudaLike(), None, None, None, None,
                     _CudaLike())
    hashtable.table_insert(_CudaLike(), None, None, None)
    assert calls == ["step", "insert"]


def test_build_and_launch_errors_raise(monkeypatch, tmp_path):
    from stateright_tpu_torch.ops import _cuda
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _cuda._raise_on(700, "fused step")
    _cuda._raise_on(0, "fused step")  # success is silent
    # no library built here and no nvcc: building raises, never falls back
    monkeypatch.setattr(_cuda, "_LIB", None)
    monkeypatch.setattr(_cuda, "_BUILD", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build()
    assert not (tmp_path / "kernels").exists()

# --- the slice at full size (plain path) ----------------------------------

@pytest.mark.slow
def test_2pc7_plain_path_digest():
    """The counts and fingerprint-set digest chip_smoke.py holds the card
    to: from the port's plain path and from the JAX package's fused
    device engine, both on the CPU."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    want = (chip_smoke.UNIQUE_2PC7, chip_smoke.GENERATED_2PC7,
            chip_smoke.DIGEST_2PC7)
    ck = _cpu(TwoPhaseSys(7))
    assert (ck.unique_state_count(), ck.state_count(),
            _digest(ck.generated_fingerprints())) == want
    ck.assert_properties()
    ref = JaxTwoPhaseSys(7).checker().tpu_options(
        race=False, fused=True, mode="device").spawn_tpu().join()
    assert (ref.unique_state_count(), ref.state_count(),
            _digest(ref.generated_fingerprints())) == want
