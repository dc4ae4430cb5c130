"""The sharded engine: ``spawn_gpu()`` over a ``torch.distributed``
DeviceMesh.

Counterpart of ``stateright_tpu/parallel/engine.py`` (``ShardedTpuChecker``)
on its fused path. Selected by ``gpu_options(mesh=<DeviceMesh>)``; every
rank of the mesh dimension runs the same program on its own device
(NCCL for a CUDA mesh, gloo for a CPU mesh). The engine sizes the
buffers, seeds each rank's slice, drives ``run_sharded_loop``, widens
the candidate buffers after an abort (``kovf``), grows every slice when
one fills, and at the end gathers every rank's log, so each rank's
checker answers ``unique_state_count()``, ``generated_fingerprints()``
and ``discoveries()`` the same way. The mirror is the init states, then
each rank's log in rank order (the JAX engine's shard order); under
symmetry reduction the logs carry each canonical key's original
fingerprint, so every rank also holds the same ``_orig_of``.

What the JAX engine offers beyond that path raises ``NotImplementedError``
(through ``GpuChecker``'s guards, or here): the resilience layer on a
mesh (the degrade/promote ladder, retry, spill, audit, the shadow;
ROADMAP A9b), post-hoc host properties, the lasso sweep, checkpoints,
the race and traces.
"""

from __future__ import annotations

import time

import torch

from ..core import Expectation

from ..checker.builder import CheckerBuilder
from ..checker.gpu import (RESILIENCE_OPTIONS, EncodingOverflow,
                           GpuChecker, auto_fmax, candidate_sizes)
from ..ops.expand import eventually_indices
from .collectives import AxisGroup
from .sharded import (ShardedStats, StepSizes, owner_bits, owner_of,
                      rebuild_table, route_init, run_sharded_loop,
                      seed_sharded_carry)


#: what the engine reads of a mesh (torch's DeviceMesh has all of it)
_MESH_API = ("mesh_dim_names", "size", "device_type", "get_group",
             "get_local_rank")


class ShardedGpuChecker(GpuChecker):
    """Fingerprint-prefix-sharded BFS over one DeviceMesh dimension."""

    _OPTIONS = tuple(k for k in GpuChecker._OPTIONS
                     if k != "pipeline" and k not in RESILIENCE_OPTIONS) \
        + ("mesh", "mesh_axis", "exchange", "kb", "kraw", "kmax")
    #: the sharded loop stays a host loop: no chunk pipeline
    _FIXED = {**GpuChecker._FIXED, "pipeline": False}

    def _resolve_device(self, opts: dict) -> torch.device:
        kind = self._mesh.device_type
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"mesh device type {kind!r} is neither "
                             "'cuda' nor 'cpu'")
        if "device" in opts and torch.device(opts["device"]).type != kind:
            raise ValueError(
                f"gpu_options(device={opts['device']!r}) disagrees with "
                f"the mesh's device type {kind!r}")
        return torch.device(kind)

    def __init__(self, builder: CheckerBuilder):
        opts = builder.gpu_options_
        for key in RESILIENCE_OPTIONS + ("degrade", "min_mesh",
                                         "blame_after"):
            if key in opts:
                raise NotImplementedError(
                    f"gpu_options({key}=...) on a mesh: the resilience "
                    "layer on a mesh (the per-shard shadow, the "
                    "degradation ladder, spill and audit across ranks) is "
                    "not ported (ROADMAP A9b); on one card it is")
        if builder.sound_eventually_ and any(
                p.expectation == Expectation.EVENTUALLY
                for p in builder.model.properties()):
            raise NotImplementedError(
                "sound_eventually() on a mesh is not ported (ROADMAP A11: "
                "sound on a mesh); run it on one card")
        if opts.get("fused", True) is not True:
            raise NotImplementedError(
                "the staged step (gpu_options(fused=False)) on a mesh is "
                "not ported: the sharded engine's step is its own staged "
                "exchange (kraw, kmax)")
        if getattr(builder.model, "host_property_indices", ()):
            raise NotImplementedError(
                "host-evaluated properties on a mesh need the sharded "
                "post-hoc reduction (B14, build_sharded_posthoc; ROADMAP "
                "A9b); run this model on one card")
        if opts.get("resumable") or builder.resume_path_ is not None:
            raise NotImplementedError(
                "checkpoints on a mesh (gpu_options(resumable=True), "
                "resume_from) are not ported (ROADMAP A9b)")
        self._mesh = opts["mesh"]
        if not all(hasattr(self._mesh, a) for a in _MESH_API):
            raise NotImplementedError(
                "gpu_options(mesh=...) takes a torch.distributed "
                "DeviceMesh; other mesh objects (a jax.sharding.Mesh "
                f"included) are not ported, got {type(self._mesh)!r}")
        self._axis = str(opts.get("mesh_axis", "shards"))
        names = tuple(self._mesh.mesh_dim_names or ())
        if self._axis not in names:
            raise ValueError(f"mesh has no axis {self._axis!r}; axes: "
                             f"{names}")
        d = int(self._mesh.size(names.index(self._axis)))
        owner_bits(d)  # raises unless a power of two within the limit
        super().__init__(builder)
        if self._capacity % d or self._capacity // d < 4:
            raise ValueError("capacity must be divisible by the mesh axis "
                             "(at least 4 slots per rank)")
        self._exchange = str(opts.get("exchange", "bucket"))
        if self._exchange not in ("ring", "bucket"):
            raise ValueError(
                f"unknown gpu_options exchange {self._exchange!r}; "
                "expected 'ring' or 'bucket'")
        self._grp = AxisGroup(self._mesh, self._axis)
        if self._device.type == "cuda":
            self._device = self._grp.device
            from ..ops._cuda import SINGLE_CHIP_MODELS
            name = builder.model.cuda_spec(
                builder.symmetry_fn_ is not None)[0]
            if name in SINGLE_CHIP_MODELS:
                raise NotImplementedError(
                    f"the CUDA step kernel {name!r} has no probe-free "
                    "(sharded) instantiation yet (the step kernel's "
                    "configuration 3 for it, ROADMAP B); run this model "
                    "on one card, or on a CPU mesh")
        self._logs = None  # every rank's log, gathered after the run
        self._started = False

    def _start_background(self) -> None:
        """The sharded run stays on the caller's thread, the one that set
        up the rank's process group and device: a mesh never races, and
        with gloo's collectives on a worker thread the process aborted at
        exit now and then ("terminate called without an active
        exception", 1 run in 32 of a one-rank gloo 2pc3 under load).
        ``join()`` and ``report()`` return once it is done."""
        with self._start_lock:
            if not self._started:
                self._started = True
                self._run_wrapper()

    # --- growth -------------------------------------------------------
    def _sharded_qcap(self, n_init: int, headroom: int, d: int) -> int:
        """Append-only queues: a rank's tail never passes its seed count
        plus its log growth limit plus one iteration (global rows, as
        the JAX engine counts them)."""
        closc = self._capacity // d
        grow_limit = int(min(self._grow_at * closc, closc - headroom))
        return (n_init + grow_limit + 2 * headroom) * d

    def _grow_sharded(self, carry, n_init: int, headroom: int) -> None:
        """Quadruple every rank's table and log slice, move its queue
        into a larger slice at the same positions, rebuild its table from
        its own log (through the owner-side probe) and re-insert the
        seed-time keys it owns. Collective: every rank grows at once."""
        grp = self._grp
        d = grp.size
        self._capacity *= 4
        qloc = self._sharded_qcap(n_init, headroom, d) // d
        closc = self._capacity // d
        dev = carry.q.device
        q = torch.zeros((qloc, carry.q.shape[1]), dtype=torch.int32,
                        device=dev)
        q[:carry.q_tail] = carry.q[:carry.q_tail]
        log = torch.zeros((closc, carry.log.shape[1]), dtype=torch.int32,
                          device=dev)
        log[:carry.log_n] = carry.log[:carry.log_n]
        carry.q, carry.log = q, log
        ovf, fault = grp.pmax(rebuild_table(carry, closc)).tolist()
        if fault:
            raise RuntimeError("the owner-side probe kernel found a claim "
                               "without this call's owner word (S_FAULT)")
        if ovf:
            raise RuntimeError("overflow while re-inserting during growth")
        self._insert_keys(carry.table, self._owned_base_fps)

    # --- the run --------------------------------------------------------
    def _run(self) -> None:
        t_start = time.perf_counter()
        model = self._model
        opts = self._opts
        grp = self._grp
        d = grp.size
        properties = self._properties
        full_ebits = sum(1 << i for i in eventually_indices(properties))
        fmax = int(opts.get("fmax", auto_fmax(model, shards=d)))
        kraw, kmax = candidate_sizes(model, fmax, opts)
        fa = fmax * model.max_actions
        sizes = StepSizes(d=d, fmax=fmax, kraw=kraw, kmax=kmax,
                          kb=int(opts.get("kb", 0)),
                          exchange=self._exchange)
        stats = ShardedStats()
        prof = self._profile
        prof.update(engine="gpu-sharded", device=str(self._device),
                    shards=d, exchange=("bucket" if sizes.bucket
                                        else "ring"),
                    fmax=fmax, cc_dedup_capacity=self._cc, grows=0,
                    kovfs=0)

        init_rows = self._seed_inits()
        self._base_fps = list(self._generated)
        if not properties:
            return  # nothing to search for
        preload = len(self._base_fps)
        while (self._grow_at * (self._capacity // d)
               <= sizes.headroom + preload):
            self._capacity *= 4
        per_rank = route_init(self._base_fps, d)
        n_init = len(init_rows)
        qcap = self._sharded_qcap(max(len(b) for b in per_rank),
                                  sizes.headroom, d)
        carry = seed_sharded_carry(model, d, grp.rank, qcap, self._capacity,
                                   init_rows, self._base_fps, full_ebits,
                                   self._cc, self._device,
                                   symmetry=self._symmetry)
        # everything known at seed time, on its owner (re-inserted on
        # growth: the log only records states found since)
        self._owned_base_fps = [fp for fp in self._base_fps
                                if owner_of(fp, d) == grp.rank]
        self._insert_keys(carry.table, self._owned_base_fps)
        prof["seed_s"] = time.perf_counter() - t_start

        def grow_limit() -> int:
            closc = self._capacity // d
            return int(min(self._grow_at * closc,
                           closc - sizes.headroom) - preload)

        def grow() -> int:
            self._grow_sharded(carry, n_init, sizes.headroom)
            prof["grows"] += 1
            return grow_limit()

        def resize() -> int:
            # nothing was committed: widen what overflowed (the reduced
            # dmax sizes kmax, bmax the bucket) and retry the iteration;
            # the fused step dedups at full width, so kraw is F*A
            vmax, dmax, bmax = stats.abort_sizes
            before = (sizes.kraw, sizes.kmax, sizes.kb)
            grew = False
            if sizes.kraw < fa:
                sizes.kraw = fa
                grew = True
            if vmax > sizes.kraw:
                sizes.kraw = min(max(sizes.kraw * 2,
                                     -(-(vmax + vmax // 4) // 256) * 256),
                                 fa)
                grew = True
            if sizes.bucket:
                kb_now = sizes.kb_eff
                if bmax > kb_now:
                    sizes.kb = min(sizes.kmax, max(
                        kb_now * 2, -(-(bmax + bmax // 4) // 256) * 256))
                    grew = True
            if dmax > sizes.kmax or not grew:
                sizes.kmax = min(max(sizes.kmax * 2,
                                     -(-(dmax + dmax // 4) // 256) * 256),
                                 sizes.kraw)
            sizes.kmax = min(sizes.kmax, sizes.kraw)
            if (sizes.kraw, sizes.kmax, sizes.kb) == before:
                raise RuntimeError(
                    "candidate-buffer overflow (kovf) wedged at "
                    f"kraw={sizes.kraw} kmax={sizes.kmax} kb={sizes.kb} "
                    f"(observed vmax={vmax} dmax={dmax} bmax={bmax})")
            prof["kovfs"] += 1
            return grow_limit()

        target = self._target_state_count
        t_loop = time.perf_counter()
        calls0 = grp.calls
        self._state_count += run_sharded_loop(
            model, carry, grp, sizes, grow_limit=grow_limit(),
            target_remaining=(target - self._state_count
                              if target is not None else 2**63),
            stats=stats, grow=grow, resize=resize)
        if carry.xovf:
            raise EncodingOverflow(
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
        collectives = grp.calls - calls0
        for i, prop in enumerate(properties):
            if carry.disc_hit[i]:
                self._discovery_fps[prop.name] = int(carry.disc_fp[i])
        # every rank's log, so every rank answers the same; the host
        # mirror is built from them on first use
        t0 = time.perf_counter()
        self._logs = grp.gather_rows(carry.log, carry.log_n)
        prof["gather_s"] = time.perf_counter() - t0
        rank_rows = [int(rows.shape[0]) for rows in self._logs]
        self._unique_state_count = preload + sum(rank_rows)
        prof.update(
            capacity=self._capacity, kraw=sizes.kraw, kmax=sizes.kmax,
            kb=sizes.kb_eff, iterations=stats.iterations,
            small_iterations=stats.small_iterations, aborts=stats.aborts,
            syncs=stats.syncs, sync_s=stats.sync_s,
            collectives=collectives,
            collectives_per_iteration=(collectives / stats.iterations
                                       if stats.iterations else 0.0),
            vmax=stats.vmax, dmax=stats.dmax, bmax=stats.bmax,
            cc_dedup_hits=stats.cch, probe_rounds=stats.rounds,
            predup_hits=stats.pdh, rank_rows=rank_rows,
            wall_s=time.perf_counter() - t_start)

    # --- the search record ---------------------------------------------
    def _ensure_mirror(self) -> None:
        """Add every rank's log rows to the host mirror (and
        ``_orig_of``), in rank order."""
        if self._logs is None:
            return
        logs, self._logs = self._logs, None
        t0 = time.perf_counter()
        for rows in logs:
            if rows.shape[0]:
                self._mirror_rows(rows)
        self._unique_state_count = len(self._generated)
        self._profile["mirror_s"] = time.perf_counter() - t0
