"""The GPU engine: ``spawn_gpu()``.

Counterpart of the single-chip main path of ``stateright_tpu/checker/
tpu.py`` (``TpuChecker`` with ``fused=True``, synchronous chunk loop):
seed the init states, run the chunk loop of ``device_loop.py`` (whose
step is the hand-written CUDA kernel on the card, its plain version on
the CPU), grow the visited table when it fills, and mirror the search
log into the fingerprint -> parent map on first use, from which
discoveries replay through the host model.

What the JAX engine offers beyond that path is not ported yet and raises
``NotImplementedError`` naming the reason; nothing is silently ignored.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from ..ops.expand import eventually_indices
from ..ops.fused import CC_DEFAULT, StepWorkspace, supports
from ..ops.hashtable import table_insert
from ..ops.words import from_numpy_u32, to_numpy_u32
from .builder import CheckerBuilder
from .device_loop import LoopStats, run_loop, seed_carry
from .host import HostChecker

#: tpu_options keys of the JAX engine, accepted only at the value that
#: is this engine's behaviour
_FIXED = {"race": False, "pipeline": False, "fused": True}

_NOT_PORTED = {
    "race": "the host-BFS race (checker/race.py) is not ported; the "
            "engine always runs on the device — drop race or pass "
            "race=False",
    "pipeline": "the double-buffered chunk pipeline is not ported; the "
                "loop is synchronous — drop pipeline or pass "
                "pipeline=False",
    "fused": "the staged (unfused) path and the fused='auto' fallback "
             "are not ported: the step always runs the CUDA kernel (its "
             "plain version on the CPU)",
    "mode": "the per-level engine (mode='level') is not ported",
    "hint": "the per-row staged compaction (hint=) is not ported",
    "host_map": "fleet host labels (cluster/mesh.py) are not ported",
    "hcap": "host-evaluated properties (the history dedup and the "
            "post-hoc reduction) are not ported",
    "hmax": "host-evaluated properties (the history dedup and the "
            "post-hoc reduction) are not ported",
}
for _key in ("retries", "backoff", "chunk_deadline", "retry_seed",
             "degrade", "min_mesh", "blame_after", "spill", "spill_frac",
             "max_spills", "max_capacity", "max_segment", "audit",
             "corrupt_hook", "fault_hook", "autosave", "autosave_interval",
             "resumable"):
    _NOT_PORTED[_key] = (
        "the resilience layer (retry, the degrade/promote ladder, spill, "
        "audit, the host shadow, autosave and checkpoints) is not ported")
for _key in ("mesh_axis", "exchange", "kb", "kraw", "kmax"):
    _NOT_PORTED[_key] = ("a knob of the sharded engine: pass "
                         "gpu_options(mesh=<DeviceMesh>) as well")


def auto_fmax(model, shards: int = 1) -> int:
    """Default frontier rows per step (the JAX package's ``auto_fmax``,
    kept so both engines take the same steps: 12,288 rows for 2pc)."""
    target = (3 << 21) if model.packed_width >= 256 else (3 << 22)
    return max(max(256, (1 << 10) // shards), min(
        3 << 12,
        target // (model.max_actions * model.packed_width * shards)))


def candidate_sizes(model, fmax: int, opts: dict) -> "tuple":
    """``(kraw, kmax)`` of the sharded step: the static defaults
    (``ops/expand.py``) or the explicit ``kraw``/``kmax`` options, each
    clamped (``kraw <= F*A``, ``kmax <= kraw``). The JAX package also
    tightens the defaults from sizes earlier runs in the process
    observed; the port does not, so its defaults never move between
    runs."""
    from ..ops.expand import kfinal_default, kmax_default
    fa = fmax * model.max_actions
    kraw = min(int(opts.get("kraw", kmax_default(model, fmax))), fa)
    kmax = min(int(opts.get("kmax", kfinal_default(model, fmax))), kraw)
    return kraw, kmax


class GpuChecker(HostChecker):
    """Device-resident BFS over a packed model on one CUDA device (or,
    with ``gpu_options(device="cpu")``, the kernels' plain versions)."""

    #: gpu_options keys the engine reads
    _OPTIONS = ("capacity", "fmax", "cc_dedup", "chunk_steps", "grow_at",
                "device")

    def _resolve_device(self, opts: dict) -> torch.device:
        return torch.device(opts.get("device", "cuda"))

    def __init__(self, builder: CheckerBuilder):
        model = builder.model
        for attr in ("packed_width", "max_actions", "encode",
                     "packed_step", "packed_properties"):
            if not hasattr(model, attr):
                raise TypeError(
                    f"spawn_gpu() requires a PackedModel (missing {attr!r});"
                    " see stateright_tpu_torch.models.packed.PackedModel")
        super().__init__(builder)
        opts = dict(builder.gpu_options_)
        for key, value in opts.items():
            if key in self._OPTIONS:
                continue
            if key == "mode" and value in ("auto", "device"):
                continue
            if key in _FIXED and value is _FIXED[key]:
                continue
            raise NotImplementedError(
                f"gpu_options({key}={value!r}): "
                + _NOT_PORTED.get(key, "not ported to stateright_tpu_torch"))
        reason = supports(
            model, sound=builder.sound_eventually_,
            host_props=bool(getattr(model, "host_property_indices", ())))
        if reason is not None:
            raise NotImplementedError(reason)
        if builder.symmetry_fn_ is not None:
            raise NotImplementedError(
                "symmetry reduction (packed_representative in the step "
                "kernel) is not ported")
        if builder.visitor_ is not None:
            raise NotImplementedError("checker visitors are not ported")
        if builder.resume_path_ is not None:
            raise NotImplementedError(
                "resume_from() and checkpoints are not ported")
        self._opts = opts
        self._device = self._resolve_device(opts)
        if self._device.type == "cuda":
            model.cuda_spec()  # raises for a model the kernel lacks
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "spawn_gpu() runs on a CUDA device and none is available; "
                "pass gpu_options(device=\"cpu\") to run the kernels' plain "
                "versions on the CPU")
        self._capacity = int(opts.get("capacity", 1 << 20))
        if self._capacity & (self._capacity - 1) or self._capacity < 4:
            raise ValueError("capacity must be a power of two >= 4")
        self._grow_at = float(opts.get("grow_at", 0.55))
        cc_opt = opts.get("cc_dedup", True)
        if cc_opt is True:
            self._cc = CC_DEFAULT
        elif cc_opt is False:
            self._cc = 0
        else:
            self._cc = int(cc_opt)
            if self._cc & (self._cc - 1) or self._cc < 4:
                raise ValueError(
                    f"gpu_options(cc_dedup={cc_opt!r}) must be True, False "
                    "or a power-of-two slot count >= 4")
        self._mirror = None  # (log, log_n) until first pulled

    # --- seeding ------------------------------------------------------
    def _seed_inits(self) -> List[np.ndarray]:
        """Fingerprint and encode the in-boundary init states into the
        mirror; returns the packed rows of the distinct ones."""
        model = self._model
        init_states = [s for s in model.init_states()
                       if model.within_boundary(s)]
        self._state_count = len(init_states)
        rows = []
        for s in init_states:
            fp = model.fingerprint(s)
            if fp not in self._generated:
                self._generated[fp] = None
                rows.append(model.encode(s))
        self._unique_state_count = len(self._generated)
        return rows

    def _insert_keys(self, table, fps) -> None:
        """Insert known fingerprints (Python ints) into ``table``."""
        if not len(fps):
            return
        arr = np.asarray(fps, np.uint64)
        hi = from_numpy_u32((arr >> np.uint64(32)).astype(np.uint32),
                            table.device)
        lo = from_numpy_u32(arr.astype(np.uint32), table.device)
        valid = torch.ones((len(arr),), dtype=torch.bool,
                           device=table.device)
        _, ovf = table_insert(table, hi, lo, valid)
        if ovf:
            raise RuntimeError(
                "device hash table overflow while inserting known "
                "fingerprints; raise gpu_options(capacity=...)")

    # --- growth -------------------------------------------------------
    def _device_qcap(self, n_init: int, headroom: int) -> int:
        """Queue rows needed between growths: every enqueued state is
        unique, so the tail never passes n_init + the growth limit + one
        iteration's appends."""
        grow_limit = int(min(self._grow_at * self._capacity,
                             self._capacity - headroom))
        if self._target_state_count is not None:
            grow_limit = min(grow_limit,
                             self._target_state_count + headroom)
        return n_init + grow_limit + 2 * headroom

    def _grow_device(self, carry, n_init: int, headroom: int) -> None:
        """Quadruple the table and log, move the queue into a
        correspondingly larger buffer at the same positions, and
        re-insert every known fingerprint: the log's through the insert
        kernel (plain insert on the CPU), then the seed-time keys."""
        self._capacity *= 4
        dev = carry.q.device
        q = torch.zeros((self._device_qcap(n_init, headroom),
                         carry.q.shape[1]), dtype=torch.int32, device=dev)
        q[:carry.q_tail] = carry.q[:carry.q_tail]
        log = torch.zeros((self._capacity, 4), dtype=torch.int32,
                          device=dev)
        log[:carry.log_n] = carry.log[:carry.log_n]
        table = torch.zeros((self._capacity // 4, 4), dtype=torch.int64,
                            device=dev)
        valid = torch.ones((carry.log_n,), dtype=torch.bool, device=dev)
        _, ovf = table_insert(table, log[:carry.log_n, 0],
                              log[:carry.log_n, 1], valid)
        if ovf:
            raise RuntimeError("overflow while re-inserting during growth")
        self._insert_keys(table, self._base_fps)
        carry.q, carry.log, carry.table = q, log, table
        if carry.ws is not None:
            carry.ws = StepWorkspace(self._capacity, self._cc,
                                     len(self._properties), dev)

    # --- the run --------------------------------------------------------
    def _run(self) -> None:
        t_start = time.perf_counter()
        model = self._model
        opts = self._opts
        properties = self._properties
        prop_count = len(properties)
        full_ebits = sum(1 << i for i in eventually_indices(properties))
        fmax = int(opts.get("fmax", auto_fmax(model)))
        headroom = fmax * model.max_actions
        stats = LoopStats()
        prof = self._profile
        prof.update(engine="gpu", device=str(self._device), fmax=fmax,
                    cc_dedup_capacity=self._cc, grows=0)

        init_rows = self._seed_inits()
        n_init = len(init_rows)
        # everything known at seed time is re-inserted on growth (the
        # log only records states found since)
        self._base_fps = list(self._generated)
        if prop_count == 0:
            return  # nothing to search for
        preload = len(self._base_fps)
        while self._grow_at * self._capacity <= headroom + preload:
            self._capacity *= 4
        qcap = self._device_qcap(n_init, headroom)
        carry = seed_carry(model, qcap, self._capacity, init_rows,
                           full_ebits, self._base_fps, self._cc,
                           self._device)
        self._insert_keys(carry.table, self._base_fps)
        prof["seed_s"] = time.perf_counter() - t_start

        def grow_limit() -> int:
            return int(min(self._grow_at * self._capacity,
                           self._capacity - headroom) - preload)

        def grow() -> int:
            self._grow_device(carry, n_init, headroom)
            prof["grows"] += 1
            return grow_limit()

        target = self._target_state_count
        t_loop = time.perf_counter()
        # one host loop: chunk_steps bounds a JAX chunk, which has no
        # counterpart here, so it is accepted and has no effect
        self._state_count += run_loop(
            model, carry, fmax=fmax, grow_limit=grow_limit(),
            target_remaining=(target - self._state_count
                              if target is not None else 2**63),
            stats=stats, grow=grow)
        self._unique_state_count = preload + carry.log_n
        if carry.xovf:
            raise RuntimeError(
                "model capacity overflow: a successor could not be "
                "encoded in the packed layout")
        if carry.ovf:
            raise RuntimeError(
                "device hash table probe overflow below the growth "
                f"limit (capacity {self._capacity}); raise "
                "gpu_options(capacity=...)")
        if carry.q.is_cuda:
            torch.cuda.synchronize(carry.q.device)
        prof["loop_s"] = time.perf_counter() - t_loop
        for i, prop in enumerate(properties):
            if carry.disc_hit[i]:
                self._discovery_fps[prop.name] = int(carry.disc_fp[i])
        # the search record stays on the device until a path or the
        # fingerprint set is asked for
        self._mirror = (carry.log, carry.log_n)
        prof.update(
            capacity=self._capacity, iterations=stats.iterations,
            small_iterations=stats.small_iterations, syncs=stats.syncs,
            sync_s=stats.sync_s,
            vmax=stats.vmax, dmax=stats.dmax, cc_dedup_hits=stats.cch,
            probe_rounds=stats.rounds,
            wall_s=time.perf_counter() - t_start)

    def save(self, path) -> None:
        raise NotImplementedError(
            "checkpoints (Checker.save / resume_from) are not ported")

    # --- the search record ---------------------------------------------
    def _ensure_mirror(self) -> None:
        """Pull the (child fp, parent fp) log into the host mirror."""
        if self._mirror is None:
            return
        log, log_n = self._mirror
        self._mirror = None
        t0 = time.perf_counter()
        rows = to_numpy_u32(log[:log_n]).astype(np.uint64)
        child = (rows[:, 0] << np.uint64(32)) | rows[:, 1]
        parent = (rows[:, 2] << np.uint64(32)) | rows[:, 3]
        self._generated.update(zip(child.tolist(), parent.tolist()))
        self._unique_state_count = len(self._generated)
        self._profile["mirror_s"] = time.perf_counter() - t0

    def generated_fingerprints(self) -> set:
        self._ensure_mirror()
        return super().generated_fingerprints()

    def _reconstruct_path(self, fp: int):
        self._ensure_mirror()
        return super()._reconstruct_path(fp)
