"""The GPU engine: ``spawn_gpu()``.

Counterpart of the single-chip main path of ``stateright_tpu/checker/
tpu.py`` (``TpuChecker`` with ``fused=True``): seed the init states, run
chunks of ``chunk_steps`` iterations on the device (``device_loop.py``:
on the card a CUDA graph of one iteration replayed, the hand-written
kernels inside; on the CPU their plain versions), one host sync per
chunk, double-buffered by default (``pipeline=True``, as in the JAX
package: chunk N+1 is launched before chunk N's counters are read), grow
the visited table between chunks when it fills, and mirror the search
log into the fingerprint -> parent map on first use, from which
discoveries replay through the host model.

Under symmetry reduction (``symmetry_fn``) dedup, the visited table and
the mirror work on canonical keys (the fingerprint of the model's
``packed_representative``) while the queue holds the original rows the
search reached; the log's two extra columns map each canonical key to
its original state's fingerprint (``_orig_of``), through which witness
paths replay as concrete paths.

What the JAX engine offers beyond that path is not ported yet and raises
``NotImplementedError`` naming the reason; nothing is silently ignored.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List

import numpy as np
import torch

from ..ops.expand import eventually_indices
from ..ops.fused import CC_DEFAULT, StepWorkspace, supports
from ..ops.hashtable import table_insert
from ..ops.words import from_numpy_u32, to_numpy_u32
from .builder import CheckerBuilder
from .device_loop import (B_DISC, B_GEN, B_LOG_N, B_OVF, B_Q_HEAD,
                          B_Q_TAIL, B_XOVF, E_FAULT, I32_MAX, ChunkRunner,
                          LoopStats, disc_registers, seed_carry,
                          step_sizes)
from .host import HostChecker

#: tpu_options keys of the JAX engine, accepted only at the value that
#: is this engine's behaviour
_FIXED = {"race": False, "fused": True}

_NOT_PORTED = {
    "race": "the host-BFS race (checker/race.py) is not ported; the "
            "engine always runs on the device — drop race or pass "
            "race=False",
    "pipeline": "the sharded engine's loop is a host loop with no chunk "
                "pipeline — drop pipeline or pass pipeline=False",
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
                "device", "pipeline")
    #: tpu_options keys accepted only at the value that is the engine's
    _FIXED = _FIXED

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
            if key in self._FIXED and value is self._FIXED[key]:
                continue
            raise NotImplementedError(
                f"gpu_options({key}={value!r}): "
                + _NOT_PORTED.get(key, "not ported to stateright_tpu_torch"))
        reason = supports(
            model, sound=builder.sound_eventually_,
            host_props=bool(getattr(model, "host_property_indices", ())))
        if reason is not None:
            raise NotImplementedError(reason)
        self._symmetry_fn = builder.symmetry_fn_
        self._symmetry = builder.symmetry_fn_ is not None
        if (self._symmetry
                and getattr(model, "packed_representative", None) is None):
            raise NotImplementedError(
                "symmetry reduction on the GPU engine requires the model "
                "to implement packed_representative (the device "
                "canonicalization)")
        if builder.visitor_ is not None:
            raise NotImplementedError("checker visitors are not ported")
        if builder.resume_path_ is not None:
            raise NotImplementedError(
                "resume_from() and checkpoints are not ported")
        self._opts = opts
        self._device = self._resolve_device(opts)
        if self._device.type == "cuda":
            # raises for a model (or representative) the kernel lacks
            model.cuda_spec(self._symmetry)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "spawn_gpu() runs on a CUDA device and none is available; "
                "pass gpu_options(device=\"cpu\") to run the kernels' plain "
                "versions on the CPU")
        self._capacity = int(opts.get("capacity", 1 << 20))
        if self._capacity & (self._capacity - 1) or self._capacity < 4:
            raise ValueError("capacity must be a power of two >= 4")
        self._grow_at = float(opts.get("grow_at", 0.55))
        self._chunk_steps = int(opts.get("chunk_steps", 64))
        if self._chunk_steps < 1:
            raise ValueError("chunk_steps must be at least 1")
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
        #: under symmetry, (queue, tail): the original rows the search
        #: enqueued, kept on the device with the checker (coverage
        #: diagnostics read them)
        self._queue = None

    # --- seeding ------------------------------------------------------
    def _canon_fp(self, state) -> int:
        """The dedup key: the fingerprint of the state's canonical
        member under symmetry reduction, of the state otherwise."""
        if self._symmetry:
            return self._model.fingerprint(self._symmetry_fn(state))
        return self._model.fingerprint(state)

    def _check_symmetry_fn(self, init_states) -> None:
        """The host ``symmetry_fn`` and the device
        ``packed_representative`` must agree bit for bit, or dedup would
        silently go wrong: checked on the first init states
        (``symmetry_fn`` accepts any function)."""
        model = self._model
        for s in init_states[:4]:
            host = model.encode(self._symmetry_fn(s))
            row = torch.from_numpy(model.encode(s).astype(np.int64)[None])
            dev = to_numpy_u32(model.packed_representative(row)[0])
            if not np.array_equal(host, dev):
                raise ValueError(
                    "symmetry_fn disagrees with the model's "
                    "packed_representative on an init state: host "
                    f"canonical {host.tolist()} vs device {dev.tolist()}. "
                    "The device engines require the two "
                    "canonicalizations to be bit-identical.")

    def _seed_inits(self) -> List[np.ndarray]:
        """Fingerprint (canonically, under symmetry) and encode the
        in-boundary init states into the mirror; returns the packed rows
        of the distinct ones."""
        model = self._model
        init_states = [s for s in model.init_states()
                       if model.within_boundary(s)]
        self._state_count = len(init_states)
        if self._symmetry:
            self._check_symmetry_fn(init_states)
        rows = []
        for s in init_states:
            fp = self._canon_fp(s)
            if fp not in self._generated:
                self._generated[fp] = None
                if self._symmetry:
                    self._orig_of[fp] = model.fingerprint(s)
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
        _, ovf = table_insert(table, hi, lo, valid, mask=False)
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
        q_tail, log_n = carry.q_tail, carry.log_n
        q = torch.zeros((self._device_qcap(n_init, headroom),
                         carry.q.shape[1]), dtype=torch.int32, device=dev)
        q[:q_tail] = carry.q[:q_tail]
        log = torch.zeros((self._capacity, carry.log.shape[1]),
                          dtype=torch.int32, device=dev)
        log[:log_n] = carry.log[:log_n]
        table = torch.zeros((self._capacity // 4, 4), dtype=torch.int64,
                            device=dev)
        valid = torch.ones((log_n,), dtype=torch.bool, device=dev)
        _, ovf = table_insert(table, log[:log_n, 0], log[:log_n, 1], valid,
                              mask=False)
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
        k_steps = self._chunk_steps
        pipeline = bool(opts.get("pipeline", True))
        stats = LoopStats()
        prof = self._profile
        prof.update(engine="gpu", device=str(self._device), fmax=fmax,
                    cc_dedup_capacity=self._cc, grows=0,
                    chunk_steps=k_steps, pipeline=pipeline)

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
                           self._device, symmetry=self._symmetry)
        self._insert_keys(carry.table, self._base_fps)
        prof["seed_s"] = time.perf_counter() - t_start
        runner = ChunkRunner(model, carry, fmax, stats)
        qmargin = step_sizes(model, fmax)[2]
        target = self._target_state_count
        inflight: deque = deque()
        last = None  # the newest counter block read

        def dispatch() -> None:
            # the growth limit bounds the log; the seed-time keys count
            # against the table's load. The generation budget is the
            # host's count at dispatch, which lags one chunk under the
            # pipeline, as in the JAX package
            grow_limit = int(min(self._grow_at * self._capacity,
                                 self._capacity - headroom) - preload)
            remaining = (min(max(target - self._state_count, 0), I32_MAX)
                         if target is not None else I32_MAX)
            inflight.append((runner.dispatch(k_steps, remaining,
                                             grow_limit), grow_limit))

        def process(pending, grow_limit: int) -> set:
            """Consume one chunk's counters; returns the host actions it
            demands (handled once the pipeline is drained)."""
            nonlocal last
            c = last = pending.read()
            if c[carry.layout.ext + E_FAULT]:
                raise RuntimeError(
                    "the step kernel found a claimed slot without this "
                    "step's owner word, or the append's count disagreed "
                    "with the step's (S_FAULT)")
            self._state_count += int(c[B_GEN])
            if c[B_XOVF]:
                raise RuntimeError(
                    "model capacity overflow: a successor could not be "
                    "encoded in the packed layout")
            if c[B_OVF]:
                raise RuntimeError(
                    "device hash table probe overflow below the growth "
                    f"limit (capacity {self._capacity}); raise "
                    "gpu_options(capacity=...)")
            acts = set()
            q_tail, log_n = int(c[B_Q_TAIL]), int(c[B_LOG_N])
            if (q_tail == c[B_Q_HEAD]
                    or c[B_DISC:B_DISC + prop_count].all()
                    or (target is not None and self._state_count >= target)):
                acts.add("done")
            elif (log_n >= grow_limit
                  or q_tail > carry.q.shape[0] - qmargin):
                acts.add("grow")
            return acts

        t_loop = time.perf_counter()
        # the JAX package's chunk loop (checker/tpu.py _drive_device):
        # with the pipeline, chunk N+1 is in flight while chunk N's
        # counters are read; a chunk launched past a stop condition runs
        # no iteration, since every condition the host acts on is also in
        # the device's loop condition
        dispatch()
        while True:
            if pipeline and len(inflight) == 1:
                dispatch()
            acts = process(*inflight.popleft())
            if not acts:
                if not inflight:
                    dispatch()
                continue
            while inflight:
                acts |= process(*inflight.popleft())
            if "done" in acts:
                break
            self._grow_device(carry, n_init, headroom)
            runner.invalidate()
            prof["grows"] += 1
            dispatch()
        prof["loop_s"] = time.perf_counter() - t_loop
        log_n = int(last[B_LOG_N])
        self._unique_state_count = preload + log_n
        hit, fps = disc_registers(last, prop_count)
        for i, prop in enumerate(properties):
            if hit[i]:
                self._discovery_fps[prop.name] = int(fps[i])
        # the search record stays on the device until a path or the
        # fingerprint set is asked for
        self._mirror = (carry.log, log_n)
        if self._symmetry:
            self._queue = (carry.q, int(last[B_Q_TAIL]))
        prof.update(
            capacity=self._capacity, chunks=stats.chunks, syncs=stats.syncs,
            sync_s=stats.sync_s, sync_stall=stats.sync_s,
            capture_s=stats.capture_s, captures=stats.captures,
            graph_launches=stats.graph_launches,
            iterations=stats.iterations,
            small_iterations=stats.small_iterations,
            vmax=stats.vmax, dmax=stats.dmax, cc_dedup_hits=stats.cch,
            probe_rounds=stats.rounds, predup_hits=stats.pdh,
            wall_s=time.perf_counter() - t_start)

    def save(self, path) -> None:
        raise NotImplementedError(
            "checkpoints (Checker.save / resume_from) are not ported")

    # --- the search record ---------------------------------------------
    def _mirror_rows(self, log) -> None:
        """Add log rows (child fp, parent fp[, child original fp]) to
        the host mirror (and, under symmetry, to ``_orig_of``)."""
        rows = to_numpy_u32(log).astype(np.uint64)
        child = (rows[:, 0] << np.uint64(32)) | rows[:, 1]
        parent = (rows[:, 2] << np.uint64(32)) | rows[:, 3]
        self._generated.update(zip(child.tolist(), parent.tolist()))
        if rows.shape[1] == 6:
            orig = (rows[:, 4] << np.uint64(32)) | rows[:, 5]
            self._orig_of.update(zip(child.tolist(), orig.tolist()))

    def _ensure_mirror(self) -> None:
        """Pull the search log into the host mirror."""
        if self._mirror is None:
            return
        log, log_n = self._mirror
        self._mirror = None
        t0 = time.perf_counter()
        self._mirror_rows(log[:log_n])
        self._unique_state_count = len(self._generated)
        self._profile["mirror_s"] = time.perf_counter() - t0

    def generated_fingerprints(self) -> set:
        """The visited fingerprints: the canonical keys under symmetry
        reduction (as the JAX package's engines answer)."""
        self._ensure_mirror()
        return super().generated_fingerprints()

    def _reconstruct_path(self, fp: int):
        self._ensure_mirror()
        return super()._reconstruct_path(fp)
