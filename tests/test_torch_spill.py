"""Spill to the host tier on one card (``checker/resilience.py``
``SpillPolicy``/``HostShadow``, ``ops/hashtable.py``
``table_evict_prefix``, ``checker/gpu.py`` ``handle_spill``) against the
JAX package's, on the CPU: the eviction's plain version slot for slot
against the JAX function; a run whose table is capped far below its
reachable set against the JAX package's engine with the same knobs —
counts, fingerprint set, record and the spill counters equal; the
capacity-fault recoveries and endings of ``tests/test_spill.py``, each
case with its knobs, held to the JAX package's answers. K10 itself is
held to the plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``)."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.checker import resilience as jres  # noqa: E402
from stateright_tpu.examples.paxos_packed import (  # noqa: E402
    PackedPaxos as JPaxos)
from stateright_tpu.models.twopc import TwoPhaseSys as JTwoPhaseSys  # noqa
from stateright_tpu.ops import hashtable as jht  # noqa: E402
from stateright_tpu_torch import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.checker import resilience as tres  # noqa: E402
from stateright_tpu_torch.core import Property  # noqa: E402
from stateright_tpu_torch.examples.paxos_packed import PackedPaxos  # noqa
from stateright_tpu_torch.models.fixtures import PackedDGraph  # noqa: E402
from stateright_tpu_torch.ops import hashtable as tht  # noqa: E402
from stateright_tpu_torch.ops.words import (keys_from_numpy,  # noqa: E402
                                            keys_to_numpy)

pytestmark = pytest.mark.faults

SPILL_KEYS = ("spills", "evicted_keys", "host_tier_keys", "host_probe_hits")


def _run(mk, **opts):
    """The port's engine alone on the CPU (its kernels' plain versions)."""
    opts = {"device": "cpu", "race": False, **opts}
    return mk().checker().gpu_options(**opts).spawn_gpu().join()


def _assert_parity(got, want):
    assert got.unique_state_count() == want.unique_state_count()
    assert got.generated_fingerprints() == want.generated_fingerprints()
    assert set(got.discoveries()) == set(want.discoveries())


@pytest.fixture(scope="module")
def jax_2pc3():
    return JTwoPhaseSys(3).checker().spawn_bfs().join()


@pytest.fixture(scope="module")
def jax_2pc4():
    return JTwoPhaseSys(4).checker().spawn_bfs().join()


# --- policy and classification ---------------------------------------------

class TestPolicyAndClassification:
    def test_max_capacity_below_capacity_rejected(self):
        with pytest.raises(ValueError, match="max_capacity"):
            TwoPhaseSys(3).checker().gpu_options(
                device="cpu", race=False, capacity=1 << 12,
                max_capacity=1 << 10).spawn_gpu()

    def test_sound_eventually_rejects_tiering(self):
        m = (PackedDGraph.with_property(
            Property.eventually("odd", lambda _, s: s % 2 == 1))
            .with_path([0, 2, 4, 2]))
        with pytest.raises(NotImplementedError, match="tiering"):
            m.checker().sound_eventually().gpu_options(
                device="cpu", race=False, capacity=1 << 10,
                max_capacity=1 << 10).spawn_gpu()

    @pytest.mark.parametrize("msg", [
        "RESOURCE_EXHAUSTED: oom",
        "device hash table probe overflow below the growth limit",
        "packed-state capacity overflow: a successor state could not be "
        "encoded",
        "model capacity overflow: a successor could not be encoded in the "
        "packed layout",
        "CUDA out of memory. Tried to allocate 1.00 GiB",
        "a model bug"])
    def test_spill_eligibility(self, msg):
        exc = RuntimeError(msg)
        assert tres.spill_eligible(exc) == jres.spill_eligible(exc)


# --- the eviction -------------------------------------------------------------

def _filled(seed: int, n: int = 512, capacity: int = 1 << 11):
    """The same seeded keys inserted into the JAX table and the port's
    (the JAX insert's layout carried over slot for slot)."""
    rng = np.random.default_rng(seed)
    fps = rng.integers(1, 2 ** 64 - 1, n, dtype=np.uint64)
    hi = (fps >> np.uint64(32)).astype(np.uint32)
    lo = fps.astype(np.uint32)
    khi, klo = jht.make_table(capacity)
    ins, khi, klo, ovf = jht.table_insert(
        khi.reshape(-1, 4), klo.reshape(-1, 4), jnp.asarray(hi),
        jnp.asarray(lo), jnp.ones(n, bool))
    assert int(ins.sum()) == n and not bool(ovf)
    table = keys_from_numpy(np.asarray(khi), np.asarray(klo))
    return fps, hi, lo, khi, klo, table


MASKS = {
    "none": lambda pref: np.zeros(256, bool),
    "third": lambda pref: np.isin(np.arange(256), pref[::3]),
    "all": lambda pref: np.ones(256, bool),
}


@pytest.mark.parametrize("kind", sorted(MASKS))
@pytest.mark.parametrize("seed", [0, 1, 3])
def test_evict_is_the_jax_functions_slot_for_slot(seed, kind):
    """``table_evict_prefix`` (its plain version on a CPU table) leaves
    the JAX function's table slot for slot and returns its count; each
    bucket's occupancy stays a prefix."""
    fps, _hi, _lo, khi, klo, table = _filled(seed)
    mask = MASKS[kind](tres.fp_prefix(fps))
    jhi, jlo, jcount = jht.table_evict_prefix(khi, klo, jnp.asarray(mask))
    count = tht.table_evict_prefix(table, mask)
    hi2, lo2 = keys_to_numpy(table)
    assert count == int(jcount) == int(mask[tres.fp_prefix(fps)].sum())
    assert np.array_equal(hi2, np.asarray(jhi))
    assert np.array_equal(lo2, np.asarray(jlo))
    occupied = (table != 0).numpy()
    assert bool((occupied[:, 1:] <= occupied[:, :-1]).all())


def test_evicted_keys_reinsert_and_survivors_dedup():
    fps, hi, lo, _khi, _klo, table = _filled(0)
    mask = np.zeros(256, bool)
    mask[tres.fp_prefix(fps)[:200]] = True
    in_range = mask[tres.fp_prefix(fps)]
    assert tht.table_evict_prefix(table, torch.from_numpy(mask)) \
        == int(in_range.sum())
    keep = table.clone()
    ins, _ovf = tht.table_insert(keep, torch.from_numpy(hi.view(np.int32)),
                                 torch.from_numpy(lo.view(np.int32)),
                                 torch.from_numpy(in_range))
    assert int(ins.sum()) == int(in_range.sum())
    ins, _ovf = tht.table_insert(table, torch.from_numpy(hi.view(np.int32)),
                                 torch.from_numpy(lo.view(np.int32)),
                                 torch.from_numpy(~in_range))
    assert int(ins.sum()) == 0  # no full bucket was probed past


def test_evict_mask_shape_checked():
    with pytest.raises(ValueError, match="256"):
        tht.table_evict_prefix(tht.make_table(16), np.zeros(255, bool))


# --- capped parity ----------------------------------------------------------------

CAPPED = dict(capacity=1 << 8, max_capacity=1 << 8, fmax=8, chunk_steps=2)


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "sync"])
def test_capped_parity_is_the_jax_engines(jax_2pc3, pipeline):
    """TwoPhaseSys(3)'s 288 states through a 256-slot table: the run
    spills, and its counts, record and spill counters equal the JAX
    package's fused engine's with the same knobs (the CPU path keeps the
    row gate, so the spills fall on the same chunks)."""
    want = JTwoPhaseSys(3).checker().tpu_options(
        race=False, fused=True, mode="device", pipeline=pipeline,
        **CAPPED).spawn_tpu().join()
    got = _run(lambda: TwoPhaseSys(3), pipeline=pipeline, **CAPPED)
    _assert_parity(got, jax_2pc3)
    assert got.state_count() == want.state_count()
    assert list(got._generated.items()) == list(want._generated.items())
    prof, jprof = got.profile(), want.profile()
    assert {k: prof[k] for k in SPILL_KEYS} \
        == {k: jprof[k] for k in SPILL_KEYS}
    assert prof["spills"] >= 1 and prof["host_probe_hits"] >= 1
    assert not prof["grows"]  # the budget bound
    assert got._mirror is None  # the shadow's mirror: no device pull


def test_budgeted_growth_then_spill(jax_2pc4):
    """A table that grows 2**10 -> 2**12 up to its budget, then spills
    (``grow_at`` 0.25: the budget's growth limit holds 65 % of the 1,568
    states; every rediscovered key is expanded again, so a budget far
    below the reachable set spills without end): the grows stop at the
    budget, and the set is the JAX package's."""
    got = _run(lambda: TwoPhaseSys(4), capacity=1 << 8,
               max_capacity=1 << 12, fmax=8, grow_at=0.25, chunk_steps=2)
    _assert_parity(got, jax_2pc4)
    prof = got.profile()
    assert prof["grows"] == 1 and prof["capacity"] == 1 << 12
    assert prof["spills"] >= 2 and prof["host_probe_hits"] >= 1


def test_resume_past_the_budget_spills_at_seed(tmp_path, jax_2pc4):
    """A checkpoint whose mirror (1,149 keys) passes the table budget's
    growth threshold: the resume plans the coldest ranges into the host
    tier before its first chunk (no table to evict from yet) and ends
    with the JAX package's set."""
    path = tmp_path / "partial.npz"
    partial = TwoPhaseSys(4).checker().gpu_options(
        device="cpu", race=False, resumable=True, fmax=16,
        chunk_steps=2).target_state_count(5000).spawn_gpu().join()
    assert partial.unique_state_count() == 1149
    partial.save(path)
    resumed = (TwoPhaseSys(4).checker()
               .gpu_options(device="cpu", race=False, capacity=1 << 8,
                            max_capacity=1 << 12, fmax=8, grow_at=0.3)
               .resume_from(path).spawn_gpu().join())
    _assert_parity(resumed, jax_2pc4)
    prof = resumed.profile()
    assert prof["spills"] >= 1 and prof["capacity"] == 1 << 12


def test_host_props_capped_parity():
    """Paxos's host-evaluated 'linearizable' under a 256-slot budget: each
    epoch re-arms the history stage and keeps the memoised results."""
    want = JPaxos(1).checker().spawn_bfs().join()
    got = _run(lambda: PackedPaxos(1), capacity=1 << 8, max_capacity=1 << 8,
               fmax=8, chunk_steps=2)
    _assert_parity(got, want)
    assert got.profile()["spills"] >= 1
    got.assert_properties()


# --- capacity-fault recovery ---------------------------------------------------------

class TestCapacityFaultRecovery:
    def test_injected_resource_exhausted_recovers(self, jax_2pc3):
        # an allocation-class fault inside the retry envelope: spill,
        # growth clamped at the current capacity, resume
        def hook(chunk):
            if chunk == 2:
                raise RuntimeError("RESOURCE_EXHAUSTED: injected allocation "
                                   "failure at grow")

        faulty = _run(lambda: TwoPhaseSys(3), capacity=1 << 12, fmax=64,
                      chunk_steps=2, retries=2, backoff=0.0, fault_hook=hook)
        _assert_parity(faulty, jax_2pc3)
        assert faulty.profile()["spills"] >= 1

    def test_cuda_out_of_memory_recovers(self, jax_2pc3):
        # torch's own allocation failure carries "out of memory": the
        # same recovery
        def hook(chunk):
            if chunk == 2:
                raise torch.cuda.OutOfMemoryError(
                    "CUDA out of memory. Tried to allocate 2.00 GiB")

        faulty = _run(lambda: TwoPhaseSys(3), capacity=1 << 12, fmax=64,
                      chunk_steps=2, retries=2, backoff=0.0, fault_hook=hook)
        _assert_parity(faulty, jax_2pc3)
        assert faulty.profile()["spills"] >= 1

    def test_spill_disabled_capacity_terminal_leaves_artifacts(
            self, tmp_path, jax_2pc3):
        # the capacity-terminal ending writes the autosave checkpoint
        # before raising, and it resumes (in the port and in the JAX
        # package) to the full reached set
        path = tmp_path / "cap.npz"

        def hook(chunk):
            if chunk >= 2:
                raise RuntimeError("RESOURCE_EXHAUSTED: injected, never "
                                   "recovers")

        ck = (TwoPhaseSys(3).checker()
              .gpu_options(device="cpu", race=False, capacity=1 << 12,
                           fmax=64, chunk_steps=2, retries=1, backoff=0.0,
                           spill=False, autosave=os.fspath(path),
                           fault_hook=hook)
              .spawn_gpu())
        with pytest.raises(RuntimeError, match="resume_from"):
            ck.join()
        assert path.exists()
        assert ck.profile()["autosaves"] >= 1
        resumed = (TwoPhaseSys(3).checker()
                   .gpu_options(device="cpu", race=False, capacity=1 << 12)
                   .resume_from(path).spawn_gpu().join())
        _assert_parity(resumed, jax_2pc3)
        jresumed = (JTwoPhaseSys(3).checker()
                    .tpu_options(race=False, capacity=1 << 12)
                    .resume_from(path).spawn_tpu().join())
        _assert_parity(jresumed, jax_2pc3)

    def test_spill_budget_exhaustion_is_terminal(self):
        # max_spills bounds consecutive capacity recoveries
        def hook(chunk):
            raise RuntimeError("RESOURCE_EXHAUSTED: every chunk")

        ck = (TwoPhaseSys(3).checker()
              .gpu_options(device="cpu", race=False, capacity=1 << 12,
                           fmax=64, chunk_steps=2, retries=1, backoff=0.0,
                           max_spills=2, fault_hook=hook)
              .spawn_gpu())
        with pytest.raises(RuntimeError, match="capacity exhausted"):
            ck.join()
        assert ck.profile()["spills"] <= 2

    @pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
    def test_wedged_kovf_recovers_with_grown_kbuffer(self, jax_2pc3, fused):
        # the kovf abort, reclassified as a capacity fault, routes through
        # the retry envelope with grown candidate buffers, no eviction
        def hook(chunk):
            if chunk == 2:
                raise tres.CandidateOverflowError(
                    "candidate-buffer capacity overflow (kovf) wedged at "
                    "kraw=1 kmax=1", vmax=64, dmax=48)

        faulty = _run(lambda: TwoPhaseSys(3), capacity=1 << 12, fmax=64,
                      chunk_steps=2, retries=1, backoff=0.0, fused=fused,
                      fault_hook=hook)
        _assert_parity(faulty, jax_2pc3)
        assert faulty.profile()["kovfs"] >= 1
        assert not faulty.profile()["spills"]

    def test_xovf_stays_terminal_even_with_spill(self):
        def hook(chunk):
            if chunk == 2:
                raise RuntimeError(
                    "packed-state capacity overflow: a successor state could "
                    "not be encoded (injected)")

        ck = (TwoPhaseSys(3).checker()
              .gpu_options(device="cpu", race=False, capacity=1 << 12,
                           fmax=64, chunk_steps=2, retries=2, backoff=0.0,
                           fault_hook=hook)
              .spawn_gpu())
        with pytest.raises(RuntimeError,
                           match="packed-state capacity overflow"):
            ck.join()
        assert not ck.profile()["spills"]


# --- K10's body on the host ---------------------------------------------------

_STUB = r"""
#include <cstdint>
struct dim3_ { unsigned x; };
static dim3_ threadIdx, blockIdx, blockDim, gridDim;
struct longlong2 { long long x, y; };
static inline longlong2 make_longlong2(long long a, long long b) {
  return {a, b};
}
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(x)
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
static inline int cudaGetLastError() { return 0; }
static inline void __syncthreads() {}
static inline int __shfl_down_sync(unsigned, int, int) { return 0; }
static inline int atomicAdd(int* p, int v) { int o = *p; *p += v; return o; }
"""


@pytest.fixture(scope="module")
def host_k10(tmp_path_factory):
    """``csrc/evict.cu`` compiled with g++ under a stub of the CUDA
    built-ins, its launch one thread over the whole grid-stride loop."""
    import ctypes
    import pathlib
    import shutil
    import subprocess
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel's body on the host")
    src = (pathlib.Path(tht.__file__).resolve().parent.parent / "csrc"
           / "evict.cu").read_text()
    launch = "evict_prefix_kernel<<<a->blocks, kEvictThreads, 0, st>>>(*a);"
    assert launch in src
    src = src.replace("#include <cuda_runtime.h>", _STUB).replace(
        launch, "(void)st; gridDim.x = blockDim.x = 1; threadIdx.x = 0; "
        "blockIdx.x = 0; evict_prefix_kernel(*a);")
    d = tmp_path_factory.mktemp("k10")
    (d / "k10.cpp").write_text(src)
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o",
                    str(d / "libk10.so"), str(d / "k10.cpp")], check=True,
                   capture_output=True, timeout=120)
    from stateright_tpu_torch.ops import _cuda
    lib = ctypes.CDLL(str(d / "libk10.so"))
    lib.srt_evict_prefix.argtypes = [ctypes.POINTER(_cuda.EvictArgs)]
    lib.srt_evict_prefix.restype = ctypes.c_int
    assert lib.srt_evict_args_size() == ctypes.sizeof(_cuda.EvictArgs)
    assert lib.srt_evict_threads() == _cuda.EVICT_THREADS
    return lib


@pytest.mark.parametrize("prefixes", [0, 1, 85, 200, 256])
def test_k10_body_on_the_host_is_the_plain_version(host_k10, prefixes):
    """K10's bucket loop, compiled for the host, leaves the plain
    version's table and count (the 8-word mask as ``ops/_cuda.py`` packs
    it)."""
    import ctypes

    from stateright_tpu_torch.ops import _cuda
    rng = np.random.default_rng(prefixes)
    fps = rng.integers(1, 2 ** 64 - 1, 6000, dtype=np.uint64)
    table = tht.make_table(1 << 13)
    tht.table_insert(
        table, torch.from_numpy((fps >> np.uint64(32)).astype(np.uint32)
                                .view(np.int32)),
        torch.from_numpy(fps.astype(np.uint32).view(np.int32)),
        torch.ones(6000, dtype=torch.bool), mask=False)
    mask = np.zeros(256, bool)
    mask[rng.permutation(256)[:prefixes]] = True
    want = table.clone()
    count = tht.table_evict_prefix_reference(want, mask)
    got = torch.zeros(1, dtype=torch.int32)
    args = _cuda.EvictArgs(
        keys=table.data_ptr(), n_buckets=table.shape[0],
        count=got.data_ptr(),
        mask=(ctypes.c_uint32 * 8)(*tht.evict_mask_words(mask)), blocks=1,
        stream=None)
    assert host_k10.srt_evict_prefix(ctypes.byref(args)) == 0
    assert int(got) == count
    assert torch.equal(table, want)
