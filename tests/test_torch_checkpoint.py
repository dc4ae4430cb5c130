"""Checkpoints in the port (``gpu_options(resumable=True)``, ``save()``,
``resume_from()``) on the CPU (the kernels' plain versions), against the
JAX package: the single-chip and file-integrity cases of
tests/test_checkpoint.py (a bounded 2pc5 run resumed to the full 8,832
states, PackedLinearEquation(3, 5, 81) paths through the stitched
mirror, Increment(2) under symmetry, the refusals, garbage, truncated
and tampered files, the atomic save and the ``.g1`` rollback), and
checkpoints across the two packages in both directions. The card's
resume is in test_torch_gpu.py and chip_smoke.py."""

import importlib
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

jax = pytest.importorskip("jax")

from stateright_tpu.checker import tpu as jtpu  # noqa: E402
from stateright_tpu.examples import increment as jinc  # noqa: E402
from stateright_tpu.examples import increment_lock as jlock  # noqa: E402
from stateright_tpu.models import packed as jpacked  # noqa: E402
from stateright_tpu.models import twopc as jtwopc  # noqa: E402
from stateright_tpu_torch import (Increment, IncrementLock,  # noqa: E402
                                  PackedLinearEquation, TwoPhaseSys)
from stateright_tpu_torch.checker.gpu import (GpuChecker,  # noqa: E402
                                              model_tag)

#: every shape knob of a bounded 2pc5 run (the JAX test's)
PARTIAL = dict(capacity=1 << 14, fmax=64, chunk_steps=4)


def _partial(path, **opts):
    ck = (TwoPhaseSys(5).checker()
          .gpu_options(device="cpu", resumable=True, **PARTIAL, **opts)
          .target_state_count(2000).spawn_gpu().join())
    assert ck.state_count() >= 2000
    assert ck.unique_state_count() < 8832
    ck.save(path)
    return ck


def _resume(model, path, **opts):
    return (model.checker().gpu_options(device="cpu", capacity=1 << 14,
                                        **opts)
            .resume_from(path).spawn_gpu().join())


@pytest.fixture(scope="module")
def bfs5():
    return jtwopc.TwoPhaseSys(5).checker().spawn_bfs().join() \
        .generated_fingerprints()


def test_resume_converges_to_same_set(tmp_path, bfs5):
    path = tmp_path / "ckpt.npz"
    partial = _partial(path)
    resumed = _resume(TwoPhaseSys(5), path)
    assert isinstance(resumed, GpuChecker)  # resume_from is never raced
    assert resumed.unique_state_count() == 8832
    assert resumed.generated_fingerprints() == bfs5
    # resumed counts continue from the checkpoint
    assert resumed.state_count() >= partial.state_count()
    resumed.assert_properties()


def test_resumed_paths_replay(tmp_path):
    # discoveries found after a resume reconstruct valid paths through
    # the stitched mirror (parents from both run segments)
    path = tmp_path / "ckpt.npz"
    partial = (PackedLinearEquation(3, 5, 81).checker()
               .gpu_options(device="cpu", capacity=1 << 14, resumable=True,
                            fmax=32, chunk_steps=2)
               .target_state_count(100).spawn_gpu().join())
    # stopped short of the shallowest witness, (2, 15): 17 actions deep
    assert partial.discovery("solvable") is None
    partial.save(path)
    resumed = _resume(PackedLinearEquation(3, 5, 81), path)
    found = resumed.assert_any_discovery("solvable")
    x, y = found.last_state()
    assert (3 * x + 5 * y) & 0xFF == 81
    # the witness's actions are one for the JAX package's model too
    ref = jpacked.PackedLinearEquation(3, 5, 81).checker().spawn_bfs().join()
    ref.assert_discovery("solvable", found.into_actions())


def test_save_requires_resumable(tmp_path):
    ck = (TwoPhaseSys(3).checker().gpu_options(device="cpu", race=False)
          .spawn_gpu().join())
    with pytest.raises(RuntimeError, match="resumable"):
        ck.save(tmp_path / "nope.npz")
    raced = TwoPhaseSys(3).checker().gpu_options(device="cpu").spawn_gpu()
    with pytest.raises(RuntimeError, match="resumable"):
        raced.join().save(tmp_path / "nope.npz")
    assert not list(tmp_path.iterdir())


def test_save_roundtrip_preserves_discoveries(tmp_path):
    path = tmp_path / "ckpt.npz"
    ck = (TwoPhaseSys(3).checker()
          .gpu_options(device="cpu", capacity=1 << 12, resumable=True)
          .spawn_gpu().join())
    assert ck.unique_state_count() == 288
    ck.save(path)
    resumed = _resume(TwoPhaseSys(3), path)
    # nothing left to search; counts and discoveries carry over
    assert resumed.unique_state_count() == 288
    assert resumed.state_count() == ck.state_count()
    assert set(resumed.discoveries()) == set(ck.discoveries())
    assert resumed.discoveries() == ck.discoveries()


def test_symmetry_roundtrip(tmp_path):
    # Increment(2): a value-complete representative, so exactly 8
    # canonical classes (increment.rs:36-105); the resumed run converges
    # to the uninterrupted reduced set
    path = tmp_path / "sym.npz"
    m = Increment(2)
    partial = (m.checker().symmetry_fn(m.representative)
               .gpu_options(device="cpu", capacity=1 << 10, fmax=4,
                            chunk_steps=1, resumable=True)
               .target_state_count(3).spawn_gpu().join())
    partial.save(path)
    meta = json.loads(str(np.load(path)["meta"]))
    assert meta["symmetry"] is True and len(np.load(path)["okeys"])
    m2 = Increment(2)
    resumed = (m2.checker().symmetry_fn(m2.representative)
               .gpu_options(device="cpu", capacity=1 << 10, fmax=4)
               .resume_from(path).spawn_gpu().join())
    assert resumed.unique_state_count() == 8
    # witnesses replay through concrete states via the restored
    # _orig_of translation
    assert len(resumed.assert_any_discovery("fin")) == 4
    whole = (Increment(2).checker().symmetry_fn(Increment(2).representative)
             .gpu_options(device="cpu", capacity=1 << 10, fmax=4)
             .spawn_gpu().join())
    assert resumed.generated_fingerprints() == whole.generated_fingerprints()


def test_mode_mismatch_rejected(tmp_path):
    # a symmetric checkpoint's keys are canonical: resuming it without
    # symmetry would misread them as state fingerprints
    path = tmp_path / "sym.npz"
    m = Increment(2)
    (m.checker().symmetry_fn(m.representative)
     .gpu_options(device="cpu", capacity=1 << 10, fmax=4, chunk_steps=1,
                  resumable=True)
     .target_state_count(3).spawn_gpu().join().save(path))
    with pytest.raises(RuntimeError, match="semantics"):
        _resume(Increment(2), path)


# --- identity and corruption -------------------------------------------

@pytest.fixture
def saved(tmp_path):
    path = tmp_path / "ckpt.npz"
    (TwoPhaseSys(3).checker()
     .gpu_options(device="cpu", capacity=1 << 12, resumable=True)
     .spawn_gpu().join().save(path))
    return path


def test_different_model_config_refused(saved):
    with pytest.raises(RuntimeError, match="different model config"):
        _resume(TwoPhaseSys(4), saved)


def test_different_model_class_refused(saved):
    class Other(TwoPhaseSys):
        pass

    with pytest.raises(RuntimeError, match="different model config"):
        _resume(Other(3), saved)


def test_different_fp_version_refused(saved, monkeypatch):
    # old-scheme fingerprints would silently fail to dedup against newly
    # computed ones; the tag embeds fpv and must refuse
    fingerprint = importlib.import_module("stateright_tpu_torch.fingerprint")
    monkeypatch.setattr(fingerprint, "FP_VERSION", 999)
    with pytest.raises(RuntimeError, match="different model config"):
        _resume(TwoPhaseSys(3), saved)


def test_garbage_file_raises_clear_error(tmp_path):
    path = tmp_path / "ckpt.npz"
    path.write_bytes(b"this is not a checkpoint")
    with pytest.raises(RuntimeError, match="corrupt, truncated"):
        _resume(TwoPhaseSys(3), path)


def test_truncated_file_raises_clear_error(saved):
    blob = saved.read_bytes()
    saved.write_bytes(blob[:len(blob) // 2])
    with pytest.raises(RuntimeError, match="corrupt, truncated"):
        _resume(TwoPhaseSys(3), saved)


def test_tampered_payload_fails_the_integrity_chain(saved):
    with np.load(saved) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["state_count"] = np.int64(int(arrays["state_count"]) + 1)
    np.savez(saved, **arrays)
    with pytest.raises(RuntimeError, match="integrity chain"):
        _resume(TwoPhaseSys(3), saved)


def test_corrupt_newest_rolls_back_one_generation(saved):
    prev = saved.with_name(saved.name + ".g1")
    prev.write_bytes(saved.read_bytes())
    saved.write_bytes(b"torn write")
    assert _resume(TwoPhaseSys(3), saved).unique_state_count() == 288


def test_interrupted_save_never_clobbers_good_checkpoint(saved, tmp_path,
                                                         monkeypatch):
    good = saved.read_bytes()
    ck = (TwoPhaseSys(3).checker()
          .gpu_options(device="cpu", capacity=1 << 12, resumable=True)
          .spawn_gpu().join())

    def boom(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez_compressed", boom)
    with pytest.raises(OSError):
        ck.save(saved)
    # the good checkpoint is intact and no temp litter remains
    assert saved.read_bytes() == good
    assert [p.name for p in tmp_path.iterdir()] == ["ckpt.npz"]
    monkeypatch.undo()
    ck.save(saved)  # and a healthy save still lands atomically
    assert _resume(TwoPhaseSys(3), saved).unique_state_count() == 288


def test_resumable_and_resume_on_a_mesh_raise():
    with pytest.raises(NotImplementedError, match="A9b"):
        TwoPhaseSys(3).checker().gpu_options(
            mesh=object(), resumable=True).spawn_gpu()
    with pytest.raises(NotImplementedError, match="A9b"):
        TwoPhaseSys(3).checker().gpu_options(
            mesh=object()).resume_from("x.npz").spawn_gpu()


# --- across the two packages --------------------------------------------

TAG_PAIRS = [
    (TwoPhaseSys(3), jtwopc.TwoPhaseSys(3)),
    (TwoPhaseSys(5, complete_symmetry=True),
     jtwopc.TwoPhaseSys(5, complete_symmetry=True)),
    (PackedLinearEquation(3, 5, 81), jpacked.PackedLinearEquation(3, 5, 81)),
    (Increment(2), jinc.Increment(2)),
    (IncrementLock(3), jlock.IncrementLock(3)),
]


@pytest.mark.parametrize("port,ref", TAG_PAIRS,
                         ids=["2pc3", "2pc5-complete", "lineq", "inc2",
                              "lock3"])
def test_model_tag_is_the_jax_packages(port, ref):
    # the same tag, but for the cache_key: the JAX package's Increment
    # and IncrementLock have none (None), so their checkpoints do not
    # cross between the packages (each refuses the other's)
    tag = model_tag(port)
    assert tag.startswith("stateright_tpu.")
    if ref.cache_key() is None:
        assert tag != jtpu.model_tag(ref)
        tag = tag.replace(repr(port.cache_key()), "None")
    assert tag == jtpu.model_tag(ref)


def test_jax_checkpoint_resumes_on_the_port(tmp_path, bfs5):
    path = tmp_path / "jax.npz"
    partial = (jtwopc.TwoPhaseSys(5).checker()
               .tpu_options(resumable=True, race=False, **PARTIAL)
               .target_state_count(2000).spawn_tpu().join())
    assert partial.unique_state_count() < 8832
    partial.save(path)
    resumed = _resume(TwoPhaseSys(5), path)
    assert resumed.unique_state_count() == 8832
    assert resumed.generated_fingerprints() == bfs5
    assert resumed.state_count() >= partial.state_count()
    for name in ("abort agreement", "commit agreement"):
        resumed.assert_any_discovery(name)  # replays or raises


def test_port_checkpoint_resumes_on_the_jax_package(tmp_path, bfs5):
    path = tmp_path / "port.npz"
    partial = _partial(path)
    resumed = (jtwopc.TwoPhaseSys(5).checker()
               .tpu_options(capacity=1 << 14, race=False)
               .resume_from(path).spawn_tpu().join())
    assert resumed.unique_state_count() == 8832
    assert resumed.generated_fingerprints() == bfs5
    assert resumed.state_count() >= partial.state_count()
