"""The port's resilience layer on one card (``checker/resilience.py``,
``checker/gpu.py``, ``checker/race.py``) against the JAX package's, on
the CPU: the taxonomy and the policies against the JAX functions; retry,
autosave, the audit, the watchdog and the race's failover rung on the
engine's plain versions, each case mirroring the JAX package's test of
the same name (``tests/test_resilience.py``) with its knobs, its counts,
fingerprint sets and discoveries equal to the JAX package's; the native
fingerprint core against its Python body; and what stays refused."""

import importlib
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

jax = pytest.importorskip("jax")

from stateright_tpu.actor.test_util import (  # noqa: E402
    PackedPingPong as JPing)
from stateright_tpu.checker import resilience as jres  # noqa: E402
from stateright_tpu.examples.paxos_packed import (  # noqa: E402
    PackedPaxos as JPaxos)
from stateright_tpu.models.twopc import TwoPhaseSys as JTwoPhaseSys  # noqa
from stateright_tpu_torch import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch import fingerprint as tfp  # noqa: E402
from stateright_tpu_torch.actor.test_util import PackedPingPong  # noqa: E402
from stateright_tpu_torch.checker import resilience as tres  # noqa: E402
from stateright_tpu_torch.examples.paxos_packed import PackedPaxos  # noqa

#: the module (the package exports a function of the same name)
jfp = importlib.import_module("stateright_tpu.fingerprint")

pytestmark = pytest.mark.faults


def _unavailable(msg="UNAVAILABLE: fake tunnel drop (injected)"):
    return RuntimeError(msg)


def _hook_at(k):
    """A fake transient backend fault when chunk ``k`` syncs."""

    def hook(chunk):
        if chunk == k:
            raise _unavailable()

    return hook


def _run(mk, **opts):
    """The port's engine alone on the CPU (its kernels' plain versions)."""
    opts = {"device": "cpu", "race": False, **opts}
    return mk().checker().gpu_options(**opts).spawn_gpu().join()


def _assert_parity(got, want):
    """The JAX package's acceptance: the same unique count, fingerprint
    set and discoveries."""
    assert got.unique_state_count() == want.unique_state_count()
    assert got.generated_fingerprints() == want.generated_fingerprints()
    assert set(got.discoveries()) == set(want.discoveries())


@pytest.fixture(scope="module")
def jax_2pc3():
    """The JAX package's answer for TwoPhaseSys(3): its host BFS, the
    oracle its own parity tests hold every engine to."""
    return JTwoPhaseSys(3).checker().spawn_bfs().join()


@pytest.fixture(scope="module")
def jax_paxos1():
    return JPaxos(1).checker().spawn_bfs().join()


# --- the taxonomy and the policies ---------------------------------------

def _chain(outer, inner):
    try:
        try:
            raise inner
        except BaseException as e:
            raise outer from e
    except BaseException as wrapped:
        return wrapped


MESSAGES = [
    "UNAVAILABLE: TPU backend setup/compile error",
    "DEADLINE_EXCEEDED: slice op",
    "connection reset by peer",
    "the tunnel collapsed",
    "ABORTED: chip 1 power fault",
    "UNAVAILABLE: device 3 heartbeat lost",
    "UNAVAILABLE: TPU_2 tunnel reset",
    "RESOURCE_EXHAUSTED: out of memory while trying",
    "device hash table overflow while seeding",
    "device hash table probe overflow below the growth limit",
    "packed-state capacity overflow: a successor state could not be encoded",
    "model capacity overflow: a successor could not be encoded in the "
    "packed layout",
    "CUDA out of memory. Tried to allocate 2.00 GiB",
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "a genuine model bug",
] + list(jres.CAPACITY_MARKERS) + list(jres.TRANSIENT_MARKERS)


@pytest.mark.parametrize("msg", MESSAGES)
def test_classification_is_the_jax_packages(msg):
    """``classify_error``, ``spill_eligible`` and ``blamed_device`` of
    each message (raised alone and wrapped by a cause chain) equal the
    JAX functions'; the marker tuples are the JAX package's verbatim."""
    assert tres.TRANSIENT_MARKERS == jres.TRANSIENT_MARKERS
    assert tres.CAPACITY_MARKERS == jres.CAPACITY_MARKERS
    assert tres.SPILLABLE_MARKERS == jres.SPILLABLE_MARKERS
    for exc in (RuntimeError(msg),
                _chain(RuntimeError("run failed after retries"),
                       RuntimeError(msg))):
        assert tres.classify_error(exc).value \
            == jres.classify_error(exc).value, msg
        assert tres.spill_eligible(exc) == jres.spill_eligible(exc), msg
        assert tres.blamed_device(exc) == jres.blamed_device(exc), msg


def test_cuda_faults_classify_as_the_module_says():
    """A CUDA allocation failure is a capacity fault spill can relieve;
    a sticky CUDA error is a programming error (it surfaces)."""
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert tres.classify_error(oom) is tres.FaultKind.CAPACITY
    assert tres.spill_eligible(oom)
    sticky = RuntimeError("CUDA error: an illegal memory access was "
                          "encountered")
    assert tres.classify_error(sticky) is tres.FaultKind.PROGRAMMING


@pytest.mark.parametrize("make", [
    lambda m: m.ChunkDeadlineError("hung"),
    lambda m: ConnectionResetError(),
    lambda m: TimeoutError(),
    lambda m: m.CorruptionError("lied", device_index=2, mismatches=3),
    lambda m: m.CandidateOverflowError(
        "candidate-buffer capacity overflow (kovf) wedged", vmax=100,
        dmax=80, bmax=10),
    lambda m: ValueError("a model bug"),
], ids=["deadline", "reset", "timeout", "corruption", "kovf", "bug"])
def test_error_types_classify_as_in_jax(make):
    got, want = make(tres), make(jres)
    assert tres.classify_error(got).value == jres.classify_error(want).value
    assert tres.spill_eligible(got) == jres.spill_eligible(want)
    assert tres.blamed_device(got) == jres.blamed_device(want)
    assert (tres.find_candidate_overflow(got) is None) \
        == (jres.find_candidate_overflow(want) is None)


@pytest.mark.parametrize("seed,backoff", [(42, 1.0), (7, 1.0), (9, 0.25),
                                          (None, 0.0)])
def test_retry_policy_delays_are_jaxs(seed, backoff):
    """Seeded jitter draws the JAX package's delays; no backoff, none."""
    opts = {"retries": 3, "backoff": backoff}
    if seed is not None:
        opts["retry_seed"] = seed
    got = tres.RetryPolicy.from_options(opts)
    want = jres.RetryPolicy.from_options(opts)
    if seed is None:
        assert [got.delay(i) for i in (1, 2, 3)] == [0.0] * 3
    else:
        assert [got.delay(i) for i in (1, 2, 3, 4, 8)] \
            == [want.delay(i) for i in (1, 2, 3, 4, 8)]
    with pytest.raises(ValueError):
        tres.RetryPolicy(retries=-1)


def test_policy_bounds_and_mapping():
    """``SpillPolicy`` and ``AuditPolicy`` read and check their options
    as the JAX package's do."""
    for opts in ({}, {"max_capacity": 1 << 10}, {"spill": False},
                 {"spill_frac": 0.25, "max_spills": 3}):
        got, want = (tres.SpillPolicy.from_options(opts),
                     jres.SpillPolicy.from_options(opts))
        assert (got.enabled, got.max_capacity, got.frac, got.max_spills) \
            == (want.enabled, want.max_capacity, want.frac, want.max_spills)
        assert [got.can_grow(1 << k) for k in range(4, 12)] \
            == [want.can_grow(1 << k) for k in range(4, 12)]
    for bad in ({"max_capacity": 300}, {"spill_frac": 0.0},
                {"spill_frac": 1.5}):
        with pytest.raises(ValueError):
            tres.SpillPolicy.from_options(bad)
    for raw in (False, None, True, 4, 0.25, 1):
        assert tres.AuditPolicy.from_options({"audit": raw}).every \
            == jres.AuditPolicy.from_options({"audit": raw}).every
    pol = tres.AuditPolicy.from_options({"audit": 2})
    assert [o for o in range(6) if pol.should_audit(o)] == [0, 2, 4]
    for bad in (-1, 1.5):
        with pytest.raises(ValueError):
            tres.AuditPolicy.from_options({"audit": bad})


def test_fp_prefix_and_pack_qrows_are_jaxs():
    rng = np.random.default_rng(0)
    fps = rng.integers(1, 2 ** 64 - 1, 100, dtype=np.uint64)
    assert np.array_equal(tres.fp_prefix(fps), jres.fp_prefix(fps))
    rows = rng.integers(0, 2 ** 32, (5, 7), dtype=np.uint64) \
        .astype(np.uint32)
    assert np.array_equal(tres.pack_qrows(rows, 3, fps[:5], 7),
                          jres.pack_qrows(rows, 3, fps[:5], 7))


# --- the native fingerprint core ------------------------------------------

@pytest.mark.parametrize("width", [1, 2, 3, 4, 7, 31, 52, 96, 255, 256, 257,
                                   331])
def test_native_core_is_the_python_body(width):
    """``fp64_rows`` and ``fp64_words`` through the C core equal the
    pure-Python body and the JAX package's on seeded rows."""
    assert tfp.core() == "native"  # built by the C compiler at first use
    rows = np.random.default_rng(width).integers(
        0, 2 ** 32, (40, width), dtype=np.uint64).astype(np.uint32)
    want = [jfp._fp64_words_py(r.tolist()) for r in rows]
    assert tfp.fp64_rows(rows) == want
    assert [tfp.fp64_words(r.tolist()) for r in rows] == want
    assert [tfp._fp64_words_py(r.tolist()) for r in rows] == want


def test_native_core_pins():
    """The fingerprints the kernels and every earlier test pin: the empty
    row, words past 32 bits (masked), a node key, and 2pc's init state."""
    for words in ([], [0], [1, 2, 3], [0xFFFFFFFF] * 9, [2 ** 40 + 5, 7]):
        assert tfp.fp64_words(words) == tfp._fp64_words_py(words) \
            == jfp.fp64_words(words)
    assert tfp.fp64_node(0x123456789ABCDEF, 5) \
        == jfp.fp64_node(0x123456789ABCDEF, 5)
    model, jmodel = TwoPhaseSys(3), JTwoPhaseSys(3)
    for s, js in zip(model.init_states(), jmodel.init_states()):
        assert model.fingerprint(s) == jmodel.fingerprint(js)


def test_audit_oracle_is_jaxs():
    """``oracle_fps`` equals the JAX package's host oracle, and
    ``audit_chunk_rows`` counts the same mismatches."""
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 2 ** 32, (64, 11), dtype=np.uint64) \
        .astype(np.uint32)
    want = jres.oracle_fps(rows)
    assert np.array_equal(tres.oracle_fps(rows), want)
    q = tres.pack_qrows(rows, 1, want, 11)
    log = np.stack([(want >> np.uint64(32)).astype(np.uint32),
                    want.astype(np.uint32),
                    np.zeros(64, np.uint32), np.zeros(64, np.uint32)], 1)
    log[5, 0] ^= 1
    q[9, 12] ^= 1
    assert tres.audit_chunk_rows(q, log, 11) \
        == jres.audit_chunk_rows(q, log, 11) == 2


# --- retry ------------------------------------------------------------------

class TestRetryParity:
    @pytest.mark.parametrize("pipeline", [True, False],
                             ids=["pipelined", "sync"])
    def test_single_chip(self, jax_2pc3, pipeline):
        faulty = _run(lambda: TwoPhaseSys(3), capacity=1 << 12, fmax=64,
                      chunk_steps=2, retries=2, backoff=0.0,
                      pipeline=pipeline, fault_hook=_hook_at(2))
        _assert_parity(faulty, jax_2pc3)
        assert faulty.profile()["retries"] == 1

    def test_host_props_and_witness_paths(self, jax_paxos1):
        # Paxos: 'linearizable' is host-evaluated — the re-seed re-arms
        # the history stage and keeps the memoised results
        faulty = _run(lambda: PackedPaxos(1), capacity=1 << 12, fmax=64,
                      chunk_steps=2, retries=2, backoff=0.0,
                      fault_hook=_hook_at(2))
        _assert_parity(faulty, jax_paxos1)
        assert faulty.profile()["retries"] == 1
        faulty.assert_properties()

    def test_mid_growth_recovery(self):
        # a fault after table growths: the re-seeded table holds the
        # whole (grown) mirror
        want = JTwoPhaseSys(4).checker().spawn_bfs().join()
        clean = _run(lambda: TwoPhaseSys(4), capacity=1 << 8, fmax=16,
                     chunk_steps=2)
        faulty = _run(lambda: TwoPhaseSys(4), capacity=1 << 8, fmax=16,
                      chunk_steps=2, retries=2, backoff=0.0,
                      fault_hook=_hook_at(3))
        _assert_parity(faulty, want)
        assert faulty.profile()["retries"] == 1
        assert clean.profile()["grows"] > 0

    def test_staged_step_retry(self, jax_2pc3):
        # fused=False: the staged chunk re-seeds as the fused one does
        faulty = _run(lambda: TwoPhaseSys(3), capacity=1 << 12, fmax=64,
                      chunk_steps=2, fused=False, retries=2, backoff=0.0,
                      fault_hook=_hook_at(2))
        _assert_parity(faulty, jax_2pc3)
        assert faulty.profile()["retries"] == 1

    def test_sound_eventually_retry(self):
        # the lasso sweep rebuilds from the shadow's records of every
        # epoch, not the (last epoch's) device logs
        knobs = dict(fmax=256, capacity=1 << 14, kraw=4096, kmax=4096)
        want = (JPing(3, lossy=True, duplicating=True).checker()
                .sound_eventually().tpu_options(race=False, **knobs)
                .spawn_tpu().join())
        faulty = (PackedPingPong(3, lossy=True, duplicating=True).checker()
                  .sound_eventually()
                  .gpu_options(device="cpu", race=False, chunk_steps=1,
                               retries=2, backoff=0.0,
                               fault_hook=_hook_at(2), **knobs)
                  .spawn_gpu().join())
        assert faulty.unique_state_count() == want.unique_state_count() \
            == 269
        _assert_parity(faulty, want)
        assert faulty.profile()["retries"] == 1
        model = faulty.model()
        for name in ("must exceed max", "must reach max"):
            prop = model.property(name)
            path = faulty.discovery(name)  # replays through the model
            assert not any(prop.condition(model, s)
                           for s in path.into_states())

    def test_non_transient_faults_not_retried(self):
        def hook(chunk):
            if chunk == 2:
                raise ValueError("a genuine model bug")

        with pytest.raises(ValueError, match="model bug"):
            _run(lambda: TwoPhaseSys(3), capacity=1 << 12, fmax=64,
                 chunk_steps=2, retries=2, backoff=0.0, fault_hook=hook)


# --- autosave ---------------------------------------------------------------

class TestAutosave:
    def test_exhausted_retries_write_loadable_checkpoint(self, tmp_path,
                                                         jax_2pc3):
        path = tmp_path / "auto.npz"

        def hook(chunk):
            if chunk >= 2:
                raise _unavailable()

        ck = (TwoPhaseSys(3).checker()
              .gpu_options(device="cpu", race=False, capacity=1 << 12,
                           fmax=64, chunk_steps=2, retries=1, backoff=0.0,
                           autosave=os.fspath(path), fault_hook=hook)
              .spawn_gpu())
        with pytest.raises(RuntimeError, match="resume_from"):
            ck.join()
        assert path.exists()
        assert ck.profile()["retries"] == 1
        assert ck.profile()["autosaves"] >= 1
        # the checkpoint resumes in the port and in the JAX package alike
        resumed = (TwoPhaseSys(3).checker()
                   .gpu_options(device="cpu", race=False, capacity=1 << 12)
                   .resume_from(path).spawn_gpu().join())
        jresumed = (JTwoPhaseSys(3).checker()
                    .tpu_options(race=False, capacity=1 << 12)
                    .resume_from(path).spawn_tpu().join())
        assert resumed.unique_state_count() == 288
        _assert_parity(resumed, jax_2pc3)
        _assert_parity(jresumed, jax_2pc3)

    def test_periodic_autosave(self, tmp_path):
        path = tmp_path / "periodic.npz"
        ck = _run(lambda: TwoPhaseSys(3), capacity=1 << 12, fmax=64,
                  chunk_steps=2, autosave=os.fspath(path),
                  autosave_interval=1)
        assert ck.profile()["autosaves"] >= 1
        assert path.exists()
        # the last autosave resumes to the full reached set
        resumed = (TwoPhaseSys(3).checker()
                   .gpu_options(device="cpu", race=False, capacity=1 << 12)
                   .resume_from(path).spawn_gpu().join())
        assert resumed.generated_fingerprints() \
            == ck.generated_fingerprints()

    def test_degrade_without_autosave_names_the_knob(self):
        def hook(chunk):
            raise _unavailable()

        ck = (TwoPhaseSys(3).checker()
              .gpu_options(device="cpu", race=False, capacity=1 << 12,
                           retries=1, backoff=0.0, fault_hook=hook)
              .spawn_gpu())
        with pytest.raises(RuntimeError, match="autosave"):
            ck.join()

    def test_corrupt_newest_generation_resumes_from_previous(self, tmp_path,
                                                             jax_2pc3):
        path = tmp_path / "auto.npz"
        ck = _run(lambda: TwoPhaseSys(3), capacity=1 << 12, fmax=64,
                  chunk_steps=2, autosave=os.fspath(path),
                  autosave_interval=1)
        assert ck.profile()["autosaves"] >= 2
        prev = str(path) + ".g1"
        assert os.path.exists(prev)  # the rotation kept a generation
        with open(path, "r+b") as f:  # truncated mid-payload
            f.truncate(max(os.path.getsize(path) // 2, 16))
        resumed = (TwoPhaseSys(3).checker()
                   .gpu_options(device="cpu", race=False, capacity=1 << 12)
                   .resume_from(path).spawn_gpu().join())
        assert resumed.unique_state_count() == jax_2pc3.unique_state_count()
        assert resumed.generated_fingerprints() \
            == jax_2pc3.generated_fingerprints()
        with open(prev, "r+b") as f:  # both generations gone
            f.truncate(16)
        with pytest.raises(RuntimeError, match="integrity|checkpoint"):
            (TwoPhaseSys(3).checker()
             .gpu_options(device="cpu", race=False, capacity=1 << 12)
             .resume_from(path).spawn_gpu().join())


# --- the audit --------------------------------------------------------------

class TestAudit:
    @pytest.mark.parametrize("pipeline", [True, False],
                             ids=["pipelined", "sync"])
    def test_lying_chip_caught_single(self, jax_2pc3, pipeline):
        faulty = _run(lambda: TwoPhaseSys(3), capacity=1 << 12, fmax=64,
                      chunk_steps=2, audit=1, retries=2, backoff=0.0,
                      pipeline=pipeline,
                      corrupt_hook=lambda o, d: 0 if o == 2 else None)
        _assert_parity(faulty, jax_2pc3)
        prof = faulty.profile()
        assert prof["audits"] >= 1
        assert prof["audit_mismatches"] >= 1
        assert prof["quarantined"] == 1
        assert prof["fp_core"] == "native"

    def test_clean_audited_run_reports_zero_mismatches(self, jax_2pc3):
        audited = _run(lambda: TwoPhaseSys(3), capacity=1 << 12, fmax=64,
                       chunk_steps=2, audit=1)
        _assert_parity(audited, jax_2pc3)
        prof = audited.profile()
        assert prof["audits"] >= 1
        assert not prof["audit_mismatches"]
        assert not prof["quarantined"]

    def test_audit_off_default_adds_nothing(self, jax_2pc3):
        # no knob: no shadow (the log stays on the device until asked
        # for), no audit, the same record as ever
        plain = (TwoPhaseSys(3).checker()
                 .gpu_options(device="cpu", race=False, capacity=1 << 12,
                              fmax=64, chunk_steps=2).spawn_gpu())
        plain.join()
        assert plain._mirror is not None  # the device log not pulled
        _assert_parity(plain, jax_2pc3)
        prof = plain.profile()
        assert not prof["audits"] and "fp_core" not in prof
        assert "shadow_s" not in prof

    def test_symmetry_with_audit_is_explicit(self):
        def mk():
            return TwoPhaseSys(3, complete_symmetry=True)

        with pytest.raises(NotImplementedError, match="audit"):
            (mk().checker().symmetry_fn(mk().representative)
             .gpu_options(device="cpu", race=False, capacity=1 << 12,
                          audit=1).spawn_gpu().join())


# --- the watchdog -------------------------------------------------------------

class TestWatchdog:
    def test_stalled_sync_becomes_classified_fault(self, jax_2pc3):
        # the hook stalls one chunk's sync past the deadline: the
        # watchdog turns the hang into a transient fault the retry
        # envelope recovers from
        def hook(chunk):
            if chunk == 2:
                time.sleep(1.5)

        ck = _run(lambda: TwoPhaseSys(3), capacity=1 << 12, fmax=64,
                  chunk_steps=2, retries=2, backoff=0.0,
                  chunk_deadline=0.3, fault_hook=hook)
        _assert_parity(ck, jax_2pc3)
        assert ck.profile()["retries"] >= 1

    def test_wedged_card_takes_the_autosave_ending(self, tmp_path,
                                                   jax_2pc3, monkeypatch):
        # a card whose stream does not drain before the re-seed (the
        # drain's own watchdog gave up) is not re-seeded: the run writes
        # its autosave at once, with retries to spare, and it resumes
        from stateright_tpu_torch.checker import gpu as tgpu

        def wedged(self):
            raise tgpu.DeviceWedgedError("the card did not drain (test)")

        monkeypatch.setattr(tgpu.GpuChecker, "_drain_device", wedged)
        path = tmp_path / "wedged.npz"
        ck = (TwoPhaseSys(3).checker()
              .gpu_options(device="cpu", race=False, capacity=1 << 12,
                           fmax=64, chunk_steps=2, retries=3, backoff=0.0,
                           autosave=os.fspath(path), fault_hook=_hook_at(2))
              .spawn_gpu())
        with pytest.raises(RuntimeError, match="did not drain.*resume_from"):
            ck.join()
        assert ck.profile()["autosaves"] == 1
        monkeypatch.undo()
        resumed = (TwoPhaseSys(3).checker()
                   .gpu_options(device="cpu", race=False, capacity=1 << 12)
                   .resume_from(path).spawn_gpu().join())
        _assert_parity(resumed, jax_2pc3)

    def test_invalid_deadline_rejected(self):
        with pytest.raises(ValueError, match="chunk_deadline"):
            TwoPhaseSys(3).checker().gpu_options(
                device="cpu", race=False, chunk_deadline=0).spawn_gpu()

    def test_call_with_deadline_returns_and_reraises(self):
        assert tres.call_with_deadline(lambda: 7, 5.0) == 7
        with pytest.raises(KeyError):
            tres.call_with_deadline(lambda: {}["x"], 5.0)
        with pytest.raises(tres.ChunkDeadlineError, match="chunk_deadline"):
            tres.call_with_deadline(lambda: time.sleep(1.0), 0.05)


# --- the race's failover rung -------------------------------------------------

class TestFailover:
    def test_raced_transient_failure_falls_over_to_host(self):
        # race budget 0 retires the budgeted racer at once; the device
        # dies with a transient fault; the un-budgeted host BFS answers
        def hook(chunk):
            raise _unavailable("UNAVAILABLE: permanent tunnel death")

        # the port's failover is opt-in (the JAX package's default)
        ck = (TwoPhaseSys(4).checker()
              .gpu_options(device="cpu", capacity=1 << 12, race_budget=0.0,
                           failover=True, fault_hook=hook)
              .spawn_gpu().join())
        want = JTwoPhaseSys(4).checker().spawn_bfs().join()
        _assert_parity(ck, want)
        prof = ck.profile()
        assert prof["engine"] == "host"
        assert prof["failovers"] == 1
        ck.assert_properties()

    def test_programming_error_still_surfaces(self):
        def hook(chunk):
            raise ValueError("a genuine model bug")

        ck = (TwoPhaseSys(4).checker()
              .gpu_options(device="cpu", capacity=1 << 12, race_budget=0.0,
                           failover=True, fault_hook=hook)
              .spawn_gpu())
        with pytest.raises(ValueError, match="model bug"):
            ck.join()

    @pytest.mark.parametrize("opt", [{}, {"failover": False}],
                             ids=["default", "explicit"])
    def test_failover_opt_out(self, opt):
        # off unless asked for: the transient fault surfaces, and no
        # host engine answers for the card
        def hook(chunk):
            raise _unavailable()

        ck = (TwoPhaseSys(4).checker()
              .gpu_options(device="cpu", capacity=1 << 12, race_budget=0.0,
                           fault_hook=hook, **opt)
              .spawn_gpu())
        with pytest.raises(RuntimeError, match="UNAVAILABLE"):
            ck.join()


# --- what stays refused ---------------------------------------------------------

@pytest.mark.parametrize("key,value", [("degrade", True), ("min_mesh", 1),
                                       ("blame_after", 2)])
def test_mesh_ladder_knobs_refused_on_one_card(key, value):
    with pytest.raises(NotImplementedError, match="A9b"):
        TwoPhaseSys(3).checker().gpu_options(
            device="cpu", race=False, **{key: value}).spawn_gpu()


def test_max_segment_refused_without_the_level_engine():
    with pytest.raises(NotImplementedError, match="B16"):
        TwoPhaseSys(3).checker().gpu_options(
            device="cpu", race=False, max_segment=1 << 10).spawn_gpu()


@pytest.mark.parametrize("key,value", [
    ("retries", 1), ("autosave", "x.npz"), ("audit", 1),
    ("max_capacity", 1 << 12), ("fault_hook", print), ("failover", False),
    ("degrade", True)])
def test_resilience_keys_refused_on_a_mesh(key, value):
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh("cpu", [0, 1], mesh_dim_names=("shards",),
                      _init_backend=False, _rank=0)
    with pytest.raises(NotImplementedError, match="A9b"):
        TwoPhaseSys(3).checker().gpu_options(mesh=mesh, **{key: value}) \
            .spawn_gpu()
