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

With ``gpu_options(resumable=True)`` the run keeps its pending frontier
(the queue rows from its head to its tail, their eventually-bits and
cached fingerprints, the JAX package's layout), so ``save()`` can write
it with the whole search record; ``resume_from(path)`` seeds a fresh
run from such a file — written by this package or by the JAX package:
the frontier becomes the queue, the mirror the visited table (through
K4, the flat insert) — and the search goes on from there.

The engine runs on its own thread (``HostChecker``), on the engine's
device, and stops at the next chunk boundary — on the CPU at the next
iteration — once ``cancel()`` is called: the race retires its loser so.

What the JAX engine offers beyond that path is not ported yet and raises
``NotImplementedError`` naming the reason; nothing is silently ignored.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, List

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


class EncodingOverflow(RuntimeError):
    """A successor of the model could not be encoded in its packed
    layout: a limit of the model's encoding, not of the card (a raced
    run waits for the host racer on it; ``race.py``)."""


#: tpu_options keys of the JAX engine, accepted only at the value that
#: is this engine's behaviour
_FIXED = {"fused": True}

_NOT_PORTED = {
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
             "failover"):
    _NOT_PORTED[_key] = (
        "the resilience layer (retry, the degrade/promote ladder, spill, "
        "audit, the host shadow, autosave and the race's failover rung) "
        "is not ported (ROADMAP A11)")
for _key in ("mesh_axis", "exchange", "kb", "kraw", "kmax"):
    _NOT_PORTED[_key] = ("a knob of the sharded engine: pass "
                         "gpu_options(mesh=<DeviceMesh>) as well")


def model_tag(model) -> str:
    """A checkpoint's model identity (the JAX package's ``model_tag``,
    ``stateright_tpu/checker/tpu.py:73``): a checkpoint only makes sense
    for the same model config (packed layout, transitions) and the same
    fingerprint algorithm. Written in the JAX package's form — this
    package's name mapped to ``stateright_tpu`` — so a checkpoint of
    either package resumes on the other; models of different classes or
    configs still differ."""
    from .. import fingerprint

    module = type(model).__module__
    port = __name__.split(".")[0]
    if module == port or module.startswith(port + "."):
        module = "stateright_tpu" + module[len(port):]
    return (f"{module}.{type(model).__qualname__}"
            f"|{model.cache_key()!r}|w={model.packed_width}"
            f"|fpv={fingerprint.FP_VERSION}")


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

    #: gpu_options keys the engine reads (``race`` and ``race_budget``
    #: are read by ``CheckerBuilder.spawn_gpu()``, which routes the race)
    _OPTIONS = ("capacity", "fmax", "cc_dedup", "chunk_steps", "grow_at",
                "device", "pipeline", "race", "race_budget", "resumable")
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
            raise NotImplementedError(
                "checker visitors are not ported (ROADMAP A14)")
        self._resume_path = builder.resume_path_
        #: (rows, ebits, cached fps) of the pending frontier, kept after a
        #: resumable run for save()
        self._resume_frontier = None
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
    def _start_background(self) -> None:
        if self._device.type == "cuda" and self._device.index is None:
            # the run's thread starts on device 0: name the caller's
            self._device = torch.device("cuda", torch.cuda.current_device())
        super()._start_background()

    def _run_wrapper(self) -> None:
        """The run on its thread, with the engine's device current there
        (a new thread starts on device 0)."""
        if self._device.type == "cuda":
            with torch.cuda.device(self._device):
                super()._run_wrapper()
        else:
            super()._run_wrapper()

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

        # discoveries by name: a resumed run's come from its checkpoint
        discoveries: Dict[str, int] = {}
        if self._resume_path is not None:
            # the checkpoint's frontier is the queue, with its own
            # eventually-bits and cached fps; its mirror is the preload
            init_rows, seed_ebits, seed_fps = self._load_checkpoint(
                discoveries)
        else:
            init_rows = self._seed_inits()
            seed_ebits, seed_fps = full_ebits, list(self._generated)
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
                           seed_ebits, seed_fps, self._cc, self._device,
                           symmetry=self._symmetry)
        self._insert_keys(carry.table, self._base_fps)
        prof["seed_s"] = time.perf_counter() - t_start
        runner = ChunkRunner(model, carry, fmax, stats,
                             cancelled=self._cancel_event.is_set)
        # discoveries a resumed run brought along count as found
        known = np.array([prop.name in discoveries for prop in properties],
                         bool)
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
                raise EncodingOverflow(
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
                    or all(c[B_DISC:B_DISC + prop_count] | known)
                    or (target is not None and self._state_count >= target)
                    or self._cancel_event.is_set()):
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
            if hit[i] and prop.name not in discoveries:
                discoveries[prop.name] = int(fps[i])
        self._discovery_fps.update(discoveries)
        if opts.get("resumable"):
            # the pending frontier, pulled now so save() needs no device
            # buffers: its rows, eventually-bits and cached fps
            # (canonical under symmetry), the JAX package's layout
            w = model.packed_width
            pend = to_numpy_u32(
                carry.q[int(last[B_Q_HEAD]):int(last[B_Q_TAIL])])
            self._resume_frontier = (
                pend[:, :w].copy(), pend[:, w].copy(),
                (pend[:, w + 1].astype(np.uint64) << np.uint64(32))
                | pend[:, w + 2].astype(np.uint64))
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

    # --- checkpoints ----------------------------------------------------
    def save(self, path) -> None:
        """Checkpoint a finished (typically ``target_state_count``-bounded)
        resumable run: the whole fingerprint -> parent record and the
        pending frontier, from which ``CheckerBuilder.resume_from``
        continues the search (the JAX package's ``TpuChecker.save``,
        whose file format this is)."""
        if not self.is_done():
            raise RuntimeError(
                "save() requires a finished run; bound it with "
                "target_state_count(...) to checkpoint mid-search")
        if self._resume_frontier is None:
            raise RuntimeError(
                "save() needs the pending frontier: run with "
                "gpu_options(resumable=True) on the device engine")
        self._ensure_mirror()
        rows, ebits, ffps = self._resume_frontier
        self._checkpoint_save(path, rows, ebits, ffps, self._discovery_fps)

    def _checkpoint_save(self, path, rows, ebits, ffps,
                         discoveries: Dict[str, int]) -> None:
        """Write a ``resume_from``-loadable checkpoint (the whole mirror
        and the given pending frontier) through the crash-safe atomic
        write, its metadata carrying the payload's sha256 chained to the
        run's chunk-digest head (``""``: the port keeps no shadow)."""
        from .resilience import atomic_savez, chain_integrity, payload_digest

        n = len(self._generated)
        child = np.fromiter(self._generated.keys(), np.uint64, n)
        parent = np.fromiter((p if p is not None else 0
                              for p in self._generated.values()),
                             np.uint64, n)
        okeys = np.fromiter(self._orig_of.keys(), np.uint64,
                            len(self._orig_of))
        ovals = np.fromiter(self._orig_of.values(), np.uint64,
                            len(self._orig_of))
        arrays = dict(child=child, parent=parent,
                      rows=np.asarray(rows, np.uint32),
                      ebits=np.asarray(ebits, np.uint32),
                      ffps=np.asarray(ffps, np.uint64),
                      okeys=okeys, ovals=ovals,
                      state_count=np.int64(self._state_count))
        chain_head = ""
        meta = json.dumps({
            "model": model_tag(self._model),
            "discoveries": {name: int(fp)
                            for name, fp in discoveries.items()},
            "symmetry": self._symmetry,
            "sound": False,
            "chain_head": chain_head,
            "integrity": chain_integrity(payload_digest(arrays),
                                         chain_head),
        })
        atomic_savez(path, meta=np.asarray(meta), **arrays)

    @staticmethod
    def _read_checkpoint(path):
        """Open and verify one checkpoint file. Structural load errors
        (a truncated archive, missing entries, bad JSON) and an
        integrity-chain mismatch raise one actionable RuntimeError."""
        from .resilience import chain_integrity, payload_digest

        try:
            with np.load(path) as data:
                meta = json.loads(str(data["meta"]))
                arrays = {key: data[key] for key in data.files
                          if key != "meta"}
            missing = {"child", "parent", "rows", "ebits", "ffps",
                       "state_count"} - set(arrays)
            if missing:
                raise KeyError(f"missing {sorted(missing)}")
        except Exception as e:
            # zipfile.BadZipFile for a truncated archive, KeyError for a
            # missing entry, OSError, a JSON decode error: not a usable
            # checkpoint
            raise RuntimeError(
                f"cannot resume from {path!r}: the checkpoint file is "
                "corrupt, truncated, or not a Checker.save() file "
                f"({type(e).__name__}: {e}). Re-create it with save() on "
                "a finished resumable run.") from e
        want = meta.get("integrity")
        if want is not None and chain_integrity(
                payload_digest(arrays),
                meta.get("chain_head") or "") != want:
            raise RuntimeError(
                f"cannot resume from {path!r}: integrity chain mismatch — "
                "the payload no longer matches the sha256 it was written "
                "under (bit rot, tampering, or a partial write)")
        return arrays, meta

    def _load_checkpoint(self, discoveries: Dict[str, int]):
        """Seed the run from a ``save()`` file: the mirror (with its
        canonical key -> original fp map), the state count, the saved
        discoveries (into ``discoveries``), and the pending frontier,
        returned as ``(rows, ebits, cached fps)`` (canonical fps under
        symmetry). A corrupt newest file rolls back to the previous
        autosave generation (``<path>.g1``) when one exists."""
        from .resilience import AUTOSAVE_PREV_SUFFIX

        try:
            data, meta = self._read_checkpoint(self._resume_path)
        except RuntimeError:
            prev = os.fspath(self._resume_path) + AUTOSAVE_PREV_SUFFIX
            if not os.path.exists(prev):
                raise
            data, meta = self._read_checkpoint(prev)
        tag = model_tag(self._model)
        if meta["model"] != tag:
            raise RuntimeError(
                "checkpoint was written by a different model config: "
                f"saved {meta['model']!r}, resuming {tag!r}")
        if (bool(meta.get("symmetry")) != self._symmetry
                or bool(meta.get("sound"))):
            raise RuntimeError(
                "checkpoint dedup-key semantics do not match this run: "
                f"saved symmetry={meta.get('symmetry')} "
                f"sound={meta.get('sound')}, resuming "
                f"symmetry={self._symmetry} sound=False")
        parent = [None if p == 0 else p for p in data["parent"].tolist()]
        self._generated.update(zip(data["child"].tolist(), parent))
        if "okeys" in data:
            self._orig_of.update(zip(data["okeys"].tolist(),
                                     data["ovals"].tolist()))
        self._state_count = int(data["state_count"])
        self._unique_state_count = len(self._generated)
        discoveries.update((name, int(fp))
                           for name, fp in meta["discoveries"].items())
        rows = [np.asarray(r, np.uint32) for r in data["rows"]]
        return (rows, np.asarray(data["ebits"], np.uint32),
                data["ffps"].tolist())

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
