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

A model with host-evaluated properties (``host_property_indices``, e.g.
the linearizability tester of ``PackedPaxos``) runs the chunk with its
history stage (``device_loop.py``: K8 in the graph deduplicates the
appended rows by their history columns, K9 gathers each chunk's fresh
representatives into the chunk's one sync); the host evaluates each
distinct history once (memoised by ``model.host_property_key``), the
init states at seed time, and grows the history table (``hcap``,
default ``1 << 16``) when it fills or overflows, rescanning the span an
overflow left unlogged: the JAX package's ``_pull_host_reps``,
``_regrow_history_table``, ``_rescan_history`` and ``hgrow`` loop
(``stateright_tpu/checker/tpu.py``).

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

``sound_eventually()`` runs the staged step instead (the JAX package's
``fused=False`` branch, ``device_loop.py`` :class:`Staged`), which it
needs for its node keys and cross-edge log; ``gpu_options(fused=False)``
chooses it for any configuration, so that the BASELINE workload
(``paxos check 3``, which the JAX package keeps staged: it has
host-evaluated properties) runs as the JAX package runs it, to its
record. The staged step has the candidate buffers ``kraw``/``kmax``
(``candidate_sizes``) and the ``kovf`` protocol — an
iteration whose lanes overflow a buffer commits nothing, and the host
rebuilds the chunk with buffers sized from the observed maxima
(``handle_kovf``). Under ``sound_eventually()`` dedup works on (state,
pending eventually-bits) node keys, the log's extra columns map each
node key to its state's fingerprint (``_orig_of``), the edge log takes
the cross edges (grown by the host when it fills), and at exhaustion the
lasso sweep (``checker/lasso.py``) over the insert and cross edges
reports the cycles on which an ``eventually`` property never holds.

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

from ..fingerprint import fp64_node
from ..ops.expand import eventually_indices
from ..ops.fused import CC_DEFAULT, StepWorkspace, supports
from ..ops.hashtable import table_insert
from ..ops.staged import staged_sizes
from ..ops.words import from_numpy_u32, to_numpy_u32
from .builder import CheckerBuilder
from ..core import Expectation
from .device_loop import (B_DISC, B_DMAX, B_E_N, B_GEN, B_H_N, B_HOVF,
                          B_KOVF, B_LOG_N, B_OVF, B_Q_HEAD, B_Q_TAIL,
                          B_VMAX, B_XOVF, E_FAULT, HIST_WINDOW,
                          I32_MAX, ChunkRunner, LoopStats, Staged,
                          disc_registers, history_regrow, history_rescan,
                          pull_representatives, seed_carry, step_sizes)
from .host import HostChecker


class EncodingOverflow(RuntimeError):
    """A successor of the model could not be encoded in its packed
    layout: a limit of the model's encoding, not of the card (a raced
    run waits for the host racer on it; ``race.py``)."""


#: tpu_options keys of the JAX engine, accepted only at the value that
#: is this engine's behaviour
_FIXED: dict = {}

_NOT_PORTED = {
    "pipeline": "the sharded engine's loop is a host loop with no chunk "
                "pipeline — drop pipeline or pass pipeline=False",
    "fused": "fused='auto' (the JAX package's build-probe fallback) is "
             "not ported: pass fused=True (the fused step, the default) "
             "or fused=False (the staged step)",
    "mode": "the per-level engine (mode='level') is not ported",
    "hint": "the per-row staged compaction (hint=) is not ported: no "
            "workload needs it, and the staged step packs tighter without "
            "it (its kraw/kmax buffers grow on overflow)",
    "host_map": "fleet host labels (cluster/mesh.py) are not ported",
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
for _key in ("mesh_axis", "exchange", "kb"):
    _NOT_PORTED[_key] = ("a knob of the sharded engine: pass "
                         "gpu_options(mesh=<DeviceMesh>) as well")
for _key in ("kraw", "kmax"):
    _NOT_PORTED[_key] = ("a candidate buffer of the sharded engine and "
                         "of the staged step: pass gpu_options(mesh="
                         "<DeviceMesh>) or fused=False as well")


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


def candidate_sizes(model, fmax: int, opts: dict,
                    sound: bool = False) -> "tuple":
    """``(kraw, kmax)`` of the sharded step and of the staged one: the
    static defaults (``ops/expand.py``; under ``sound`` ``kmax`` is the
    raw width) or the explicit ``kraw``/``kmax`` options, each clamped
    (``kraw <= F*A``, ``kmax <= kraw``). The JAX package also tightens
    the defaults from sizes earlier runs in the process observed; the
    port does not, so its defaults never move between runs."""
    from ..ops.expand import kfinal_default, kmax_default
    fa = fmax * model.max_actions
    kraw = min(int(opts.get("kraw", kmax_default(model, fmax, sound))), fa)
    kmax = min(int(opts.get("kmax", kfinal_default(model, fmax, sound))),
               kraw)
    return kraw, kmax


class GpuChecker(HostChecker):
    """Device-resident BFS over a packed model on one CUDA device (or,
    with ``gpu_options(device="cpu")``, the kernels' plain versions)."""

    #: gpu_options keys the engine reads (``race`` and ``race_budget``
    #: are read by ``CheckerBuilder.spawn_gpu()``, which routes the race)
    #: (``hmax``, the sharded engine's post-hoc buffer in the JAX
    #: package, is accepted and not read here, as there)
    _OPTIONS = ("capacity", "fmax", "cc_dedup", "chunk_steps", "grow_at",
                "device", "pipeline", "race", "race_budget", "resumable",
                "hcap", "hmax")
    #: the staged step's own keys (``fused=False``, sound)
    _STAGED_OPTIONS = ("kraw", "kmax")
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
        # sound-eventually mode: node-keyed dedup, only with an eventually
        # property to be sound about (the JAX package's rule)
        ev_idx = eventually_indices(self._properties)
        self._sound = bool(builder.sound_eventually_) and bool(ev_idx)
        fused = opts.get("fused", None)
        if fused not in (None, True, False):
            raise NotImplementedError(
                f"gpu_options(fused={fused!r}): " + _NOT_PORTED["fused"])
        reason = supports(model, sound=self._sound)
        if fused is True and reason is not None:
            raise ValueError("gpu_options(fused=True) is unsupported for "
                             f"this configuration: {reason}")
        #: the staged step (the JAX package's fused=False branch)
        self._staged = fused is False or reason is not None
        for key, value in opts.items():
            if key in self._OPTIONS or key == "fused":
                continue
            if key in self._STAGED_OPTIONS and self._staged:
                continue
            if key == "mode" and value in ("auto", "device"):
                continue
            if key in self._FIXED and value is self._FIXED[key]:
                continue
            raise NotImplementedError(
                f"gpu_options({key}={value!r}): "
                + _NOT_PORTED.get(key, "not ported to stateright_tpu_torch"))
        self._symmetry_fn = builder.symmetry_fn_
        self._symmetry = builder.symmetry_fn_ is not None
        if self._sound:
            self._check_sound(builder, ev_idx, opts)
        # host-evaluated properties (e.g. the linearizability search):
        # evaluated on the host once per distinct history, memoised by
        # model.host_property_key(row)
        self._host_props = [
            (i, self._properties[i])
            for i in getattr(model, "host_property_indices", ())]
        self._host_fns = self._resolve_host_fns(
            getattr(model, "host_property_fns", None))
        self._host_prop_cache: Dict[bytes, List[bool]] = {}
        self._hcap = int(opts.get("hcap", 1 << 16))
        if self._hcap & (self._hcap - 1) or self._hcap < 4:
            raise ValueError(
                "gpu_options(hcap=...) must be a power of two >= 4 (the "
                "open-addressing probe ring masks by bucket count)")
        if self._host_props and self._symmetry:
            raise NotImplementedError(
                "host-evaluated properties under symmetry reduction wait "
                "for A8's next slice (ROADMAP.md)")
        self._h_pulled = 0    # representatives already host-evaluated
        self._hscan_tail = 0  # queue rows known fully history-deduped
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

    def _check_sound(self, builder, ev_idx, opts) -> None:
        """The JAX package's guards of ``sound_eventually()`` (its
        ``TpuChecker.__init__``) and the combinations this slice of the
        port leaves out, each naming its ROADMAP item."""
        if max(ev_idx) > 31:
            raise NotImplementedError(
                "sound_eventually() supports eventually-property indices "
                "0..31")
        if getattr(self._model, "host_property_indices", ()):
            raise NotImplementedError(
                "sound_eventually() with host-evaluated properties is not "
                "supported on the GPU engine (nor on the JAX package's): "
                "node-key dedup and the history stage's state keys cannot "
                "share one table")
        if opts.get("resumable") or builder.resume_path_ is not None:
            raise NotImplementedError(
                "sound_eventually() checkpoints (gpu_options(resumable="
                "True), resume_from) are not ported (ROADMAP A11: sound "
                "checkpoints and resume)")
        if (self._symmetry and torch.device(opts.get("device", "cuda")).type
                == "cuda"):
            raise NotImplementedError(
                "sound_eventually() under symmetry reduction on the card is "
                "not ported (ROADMAP A11: sound under symmetry on the "
                "card); pass gpu_options(device=\"cpu\")")

    def _resolve_host_fns(self, fns) -> "Optional[list]":
        """``model.host_property_fns`` in ``_host_props`` order: a dict
        binds by property name (unknown or missing names raise); a
        sequence binds by position behind a length check (the JAX
        package's ``TpuChecker._resolve_host_fns``)."""
        if fns is None:
            return None
        if isinstance(fns, dict):
            names = [p.name for _i, p in self._host_props]
            unknown = sorted(set(fns) - set(names))
            missing = [n for n in names if n not in fns]
            if unknown or missing:
                raise ValueError(
                    "host_property_fns keys must match the model's "
                    "host-evaluated property names exactly "
                    f"(host_property_indices -> {names}); "
                    f"unknown={unknown}, missing={missing}")
            return [fns[n] for n in names]
        if len(fns) != len(self._host_props):
            raise ValueError(
                f"model declares {len(self._host_props)} host-evaluated "
                f"properties (host_property_indices) but {len(fns)} "
                "host_property_fns")
        return list(fns)

    # --- host-evaluated properties --------------------------------------
    def _evaluate_host_props(self, row) -> List[bool]:
        """The host properties' values on one packed row."""
        if self._host_fns is not None:
            # the model evaluates each property straight off the packed
            # row (e.g. the history columns alone)
            return [bool(fn(row)) for fn in self._host_fns]
        state = self._model.decode(row)
        return [bool(prop.condition(self._model, state))
                for _i, prop in self._host_props]

    def _eval_host_props_block(self, rows, fps,
                               discoveries: Dict[str, int]) -> None:
        """Evaluate the host properties over a block of packed rows (with
        their fingerprints ``fps``) in order: keys in one vectorised pass
        (``model.host_property_key_block`` when the model has it), each
        missing key evaluated once, the first failing (ALWAYS) or holding
        (SOMETIMES) row of each property its discovery; stops once every
        host property has one (the JAX package's
        ``_eval_host_props_block``)."""
        host_props = self._host_props
        n = len(rows)
        if not n or not host_props or all(
                p.name in discoveries for _i, p in host_props):
            return
        t0 = time.perf_counter()
        model = self._model
        block_fn = getattr(model, "host_property_key_block", None)
        keys = (block_fn(rows) if block_fn is not None
                else [model.host_property_key(row) for row in rows])
        cache = self._host_prop_cache
        for j in range(n):
            results = cache.get(keys[j])
            if results is None:
                results = cache[keys[j]] = self._evaluate_host_props(
                    rows[j])
            for (_i, prop), res in zip(host_props, results):
                if prop.name in discoveries:
                    continue
                if ((prop.expectation == Expectation.ALWAYS and not res)
                        or (prop.expectation == Expectation.SOMETIMES
                            and res)):
                    discoveries[prop.name] = int(fps[j])
            if all(p.name in discoveries for _i, p in host_props):
                break
        prof = self._profile
        prof["host_eval_s"] += time.perf_counter() - t0
        prof["host_evals"] += n

    def _want_reps(self, discoveries: Dict[str, int]) -> bool:
        return any(p.name not in discoveries for _i, p in self._host_props)

    def _eval_reps(self, block, discoveries: Dict[str, int]) -> None:
        """Evaluate pulled representatives: uint32 ``[n, W + 2]``, the
        packed rows, then their witness fingerprints' halves (K9's
        layout)."""
        w = self._model.packed_width
        fps = (block[:, w].astype(np.uint64) << np.uint64(32)) \
            | block[:, w + 1].astype(np.uint64)
        self._eval_host_props_block(block[:, :w], fps.tolist(), discoveries)

    def _pull_host_reps(self, carry, h_n: int, n_init: int,
                        discoveries: Dict[str, int]) -> None:
        """Host-evaluate the representatives logged since the last pull
        (K9 over ``hidx[h_pulled:h_n]``, one sync)."""
        start = self._h_pulled
        if h_n <= start or not self._want_reps(discoveries):
            self._h_pulled = max(start, h_n)
            return
        self._eval_reps(pull_representatives(
            carry.q, carry.hist.hidx, carry.log, start, h_n - start,
            n_init), discoveries)
        self._profile["pulls"] += 1
        self._h_pulled = h_n

    def _take_window(self, window, h_base: int, h_n: int, carry,
                     n_init: int, discoveries: Dict[str, int]) -> None:
        """Evaluate a chunk's fresh representatives: those of its window
        the host has not seen (the window starts at the pulled count at
        dispatch, ``h_base``), then the rest by a standalone pull."""
        fresh = h_n - self._h_pulled
        if fresh <= 0:
            return
        if not self._want_reps(discoveries):
            self._h_pulled = h_n
            return
        offset = self._h_pulled - h_base
        take = max(0, min(fresh, HIST_WINDOW - offset))
        if take:
            self._eval_reps(window[offset:offset + take].astype(np.uint32),
                            discoveries)
            self._h_pulled += take
        if fresh > take:
            self._pull_host_reps(carry, h_n, n_init, discoveries)

    def _grow_history(self, carry, h_n: int, hovf: bool, q_tail: int,
                      n_init: int, discoveries: Dict[str, int]) -> None:
        """Grow the history table: at the growth threshold (``grow_at``
        of ``hcap``) or on an overflow, to at least four times its size,
        re-seeded from the logged representatives; after an overflow the
        span since the last clean chunk is rescanned (growing again if
        even that overflows) and its recovered representatives are
        evaluated. The JAX package's ``handle_hgrow``."""
        t0 = time.perf_counter()
        while True:
            new_hcap = self._hcap
            while new_hcap * self._grow_at <= h_n:
                new_hcap *= 4
            if new_hcap == self._hcap:
                new_hcap *= 4  # an overflow below the threshold
            self._hcap = new_hcap
            carry.hist = history_regrow(carry.q, carry.hist, h_n, new_hcap)
            if not hovf:
                break
            new_n, ovf = history_rescan(carry.q, carry.hist,
                                        self._hscan_tail, q_tail, h_n)
            if not ovf:
                h_n = new_n
                break
        carry.ctr[B_H_N] = h_n
        carry.ctr[B_HOVF] = 0
        carry.hist.hdone[0] = q_tail
        self._hscan_tail = q_tail
        self._pull_host_reps(carry, h_n, n_init, discoveries)
        prof = self._profile
        prof["hgrow"] += 1
        prof["hgrow_s"] += time.perf_counter() - t0

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
        # under sound the dedup keys are node keys (the state's canonical
        # fingerprint and every eventually bit pending) and the queue
        # caches the state fingerprints they are derived from
        full = sum(1 << i for i in eventually_indices(self._properties))
        self._seed_cache_fps = []
        for s in init_states:
            fp = self._canon_fp(s)
            key = fp64_node(fp, full) if self._sound else fp
            if key not in self._generated:
                self._generated[key] = None
                if self._symmetry or self._sound:
                    self._orig_of[key] = model.fingerprint(s)
                rows.append(model.encode(s))
                self._seed_cache_fps.append(fp)
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
        if carry.hist is not None:  # one representative per log row
            hidx = torch.zeros((self._capacity,), dtype=torch.int32,
                               device=dev)
            hidx[:carry.hist.hidx.shape[0]] = carry.hist.hidx
            carry.hist.hidx = hidx
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
        if self._host_props:  # the history stage's counters
            prof.update(pulls=0, hgrow=0, hgrow_s=0.0, host_eval_s=0.0,
                        host_evals=0)

        # discoveries by name: a resumed run's come from its checkpoint
        discoveries: Dict[str, int] = {}
        if self._resume_path is not None:
            # the checkpoint's frontier is the queue, with its own
            # eventually-bits and cached fps; its mirror is the preload
            init_rows, seed_ebits, seed_fps = self._load_checkpoint(
                discoveries)
        else:
            init_rows = self._seed_inits()
            seed_ebits, seed_fps = full_ebits, self._seed_cache_fps
        n_init = len(init_rows)
        # everything known at seed time is re-inserted on growth (the
        # log only records states found since)
        self._base_fps = list(self._generated)
        host_idx = {i for i, _p in self._host_props}
        if self._host_props and self._resume_path is None:
            # the init rows never enter the history log (only appended
            # rows do): evaluate them here once. A resumed frontier was
            # evaluated before its checkpoint (its discoveries ride it)
            self._eval_host_props_block(
                [np.asarray(row) for row in init_rows], seed_fps,
                discoveries)
        if prop_count == 0:
            return  # nothing to search for
        preload = len(self._base_fps)
        while self._grow_at * self._capacity <= headroom + preload:
            self._capacity *= 4
        qcap = self._device_qcap(n_init, headroom)
        # the staged step's buffers (the JAX package's kraw/kmax) and,
        # under sound, the edge log, grown on demand
        fa = fmax * model.max_actions
        kraw, kmax = candidate_sizes(model, fmax, opts, self._sound)
        ecap = self._capacity if self._sound else 0

        def staged_plan():
            plans, margin = staged_sizes(model, fmax, kraw, kmax)
            return Staged(plans, margin, self._sound, ecap)

        staged = staged_plan() if self._staged else None
        if staged is not None:
            prof.update(staged=True, kraw=kraw, kmax=kmax, kovfs=0,
                        egrows=0)
        carry = seed_carry(model, qcap, self._capacity, init_rows,
                           seed_ebits, seed_fps,
                           0 if staged is not None else self._cc,
                           self._device, symmetry=self._symmetry,
                           hcap=(self._hcap if self._want_reps(discoveries)
                                 else 0), sound=self._sound, ecap=ecap)
        self._hscan_tail = n_init
        self._insert_keys(carry.table, self._base_fps)
        prof["seed_s"] = time.perf_counter() - t_start
        runner = ChunkRunner(model, carry, fmax, stats,
                             cancelled=self._cancel_event.is_set,
                             staged=staged)
        qmargin = (staged.qmargin if staged is not None
                   else step_sizes(model, fmax)[2])
        kovf_pend = [0, 0]  # vmax, dmax of the kovf chunks
        target = self._target_state_count
        inflight: deque = deque()
        last = None  # the newest counter block read

        def found() -> np.ndarray:
            """Each property's discovery so far: the device registers
            (not for host-evaluated properties: their device bits are
            placeholders) or a known one (a resumed run's, the host's)."""
            hit = last[B_DISC:B_DISC + prop_count] != 0
            return np.array([(bool(hit[i]) and i not in host_idx)
                             or prop.name in discoveries
                             for i, prop in enumerate(properties)], bool)

        def dispatch() -> None:
            # the growth limit bounds the log; the seed-time keys count
            # against the table's load. The generation budget is the
            # host's count at dispatch, which lags one chunk under the
            # pipeline, as in the JAX package; the representative window
            # starts at the host's pulled count at dispatch
            grow_limit = int(min(self._grow_at * self._capacity,
                                 self._capacity - headroom) - preload)
            remaining = (min(max(target - self._state_count, 0), I32_MAX)
                         if target is not None else I32_MAX)
            inflight.append((runner.dispatch(k_steps, remaining,
                                             grow_limit, self._h_pulled,
                                             n_init), grow_limit))

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
            if c[B_KOVF]:
                # an iteration overflowed a candidate buffer and committed
                # nothing: rebuild with larger ones, then go on
                kovf_pend[0] = max(kovf_pend[0], int(c[B_VMAX]))
                kovf_pend[1] = max(kovf_pend[1], int(c[B_DMAX]))
                acts.add("kovf")
            window = pending.window()
            if window is not None:
                h_n, hovf = int(c[B_H_N]), bool(c[B_HOVF])
                self._take_window(window, pending.h_base, h_n, carry,
                                  n_init, discoveries)
                if not self._want_reps(discoveries):
                    acts.add("hdrop")  # the history stage is dead work
                elif hovf or h_n >= self._grow_at * self._hcap:
                    acts.add("hgrow")
                    hgrow_pend["hovf"] |= hovf
                    hgrow_pend["h_n"] = max(hgrow_pend["h_n"], h_n)
                else:
                    self._hscan_tail = q_tail
            if "kovf" in acts:
                return acts
            if (q_tail == c[B_Q_HEAD] or all(found())
                    or (target is not None and self._state_count >= target)
                    or self._cancel_event.is_set()):
                acts.add("done")
            elif ecap and int(c[B_E_N]) >= ecap - max(kmax, fmax):
                acts.add("egrow")
            elif (log_n >= grow_limit
                  or q_tail > carry.q.shape[0] - qmargin):
                acts.add("grow")
            return acts

        def handle_kovf() -> None:
            """The JAX package's ``handle_kovf``: each overflowed stage
            resized to the observed branching (at least doubled), the
            chunk rebuilt (a new graph on the card), ``kovf`` cleared."""
            nonlocal kraw, kmax
            vmax, dmax = kovf_pend
            before = (kraw, kmax)
            grew = False
            if vmax > kraw:
                kraw = min(max(kraw * 2, -(-(vmax + vmax // 4) // 256) * 256),
                           fa)
                grew = True
            if dmax > kmax or not grew:
                kmax = min(max(kmax * 2, -(-(dmax + dmax // 4) // 256) * 256),
                           kraw)
            kmax = min(kmax, kraw)
            if (kraw, kmax) == before:
                raise RuntimeError(
                    "candidate-buffer overflow (kovf) wedged at "
                    f"kraw={kraw} kmax={kmax} (observed vmax={vmax} "
                    f"dmax={dmax})")
            kovf_pend[:] = [0, 0]
            prof["kovfs"] += 1
            prof.update(kraw=kraw, kmax=kmax)
            runner.staged = staged_plan()
            runner.invalidate()
            carry.ctr[B_KOVF] = 0

        def handle_egrow() -> None:
            """The edge log full: quadrupled, the chunk rebuilt."""
            nonlocal ecap
            elog = torch.zeros((ecap * 4, 4), dtype=torch.int32,
                               device=carry.elog.device)
            elog[:ecap] = carry.elog
            carry.elog, ecap = elog, ecap * 4
            prof["egrows"] += 1
            runner.staged = staged_plan()
            runner.invalidate()

        hgrow_pend = {"hovf": False, "h_n": 0}

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
            if "hdrop" in acts and carry.hist is not None:
                carry.hist = None
                carry.ctr[B_HOVF] = 0
                runner.invalidate()
            if "hgrow" in acts and carry.hist is not None:
                # before the exit, as in the JAX package: an overflow in
                # the last chunk leaves rows whose histories only the
                # rescan logs and evaluates
                self._grow_history(carry, hgrow_pend["h_n"],
                                   hgrow_pend["hovf"], int(last[B_Q_TAIL]),
                                   n_init, discoveries)
                hgrow_pend.update(hovf=False, h_n=0)
                runner.invalidate()
            if "kovf" in acts:
                handle_kovf()
                dispatch()
                continue
            if "done" in acts or all(found()):
                break
            if "egrow" in acts:
                handle_egrow()
            elif "grow" in acts:
                self._grow_device(carry, n_init, headroom)
                runner.invalidate()
                prof["grows"] += 1
            dispatch()
        prof["loop_s"] = time.perf_counter() - t_loop
        log_n = int(last[B_LOG_N])
        self._unique_state_count = preload + log_n
        hit, fps = disc_registers(last, prop_count)
        for i, prop in enumerate(properties):
            if hit[i] and i not in host_idx and prop.name not in discoveries:
                discoveries[prop.name] = int(fps[i])
        if (self._sound and int(last[B_Q_TAIL]) == int(last[B_Q_HEAD])
                and not self._symmetry and not self._cancel_event.is_set()):
            # exhaustion under sound: the lasso sweep over the node graph
            # of the insert and cross edges (not under symmetry: a
            # cross-branch witness cannot replay through concrete orbit
            # members, as the JAX package's engines rule)
            t0 = time.perf_counter()
            self._device_lasso_sweep(carry, log_n, int(last[B_E_N]), n_init,
                                     full_ebits, discoveries)
            prof.update(lasso_s=time.perf_counter() - t0,
                        e_n=int(last[B_E_N]))
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
            h_n=int(carry.ctr[B_H_N]), histories=len(self._host_prop_cache),
            iterations=stats.iterations,
            small_iterations=stats.small_iterations,
            vmax=stats.vmax, dmax=stats.dmax,
            cc_dedup_hits=stats.cch,
            probe_rounds=stats.rounds, predup_hits=stats.pdh,
            wall_s=time.perf_counter() - t_start)

    def _device_lasso_sweep(self, carry, log_n: int, e_n: int, n_init: int,
                            full_mask: int, discoveries: Dict) -> None:
        """The JAX package's ``_device_lasso_sweep``: the (state, pending
        bits) node graph rebuilt from the device's logs — the insert
        edges of the log, each node's pending mask from its queue row's
        at-enqueue eventually-bits (queue row ``n_init + i`` is log row
        ``i``'s), the cross edges of the edge log — and the shared SCC
        sweep (``checker/lasso.py``), whose witnesses land in
        ``discoveries`` as fingerprint paths (stem and one lap)."""
        from .lasso import add_log_block, add_seed_nodes, lasso_sweep
        w = self._model.packed_width
        node_fp: Dict[int, int] = {}
        node_parent: Dict[int, tuple] = {}
        node_mask: Dict[int, int] = {}
        node_edges: Dict[int, list] = {}
        add_seed_nodes(node_fp, node_parent, node_mask, self._base_fps,
                       self._orig_of, full_mask)
        add_log_block(node_fp, node_parent, node_mask, node_edges,
                      to_numpy_u32(carry.log[:log_n]),
                      to_numpy_u32(carry.q[n_init:n_init + log_n, w]),
                      to_numpy_u32(carry.elog[:e_n]))
        lasso_sweep(self._properties, discoveries, node_edges, node_mask,
                    node_parent, node_fp)
        self._profile.update(lasso_nodes=len(node_mask),
                             lasso_edges=sum(len(v)
                                             for v in node_edges.values()))

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
                f"symmetry={self._symmetry} sound=False"
                + (" (resuming a sound_eventually() checkpoint is not "
                   "ported: ROADMAP A11, sound checkpoints and resume)"
                   if meta.get("sound") else ""))
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
        reduction (as the JAX package's engines answer); under sound the
        node keys translated to their states' fingerprints."""
        self._ensure_mirror()
        if self._sound:
            return {self._orig_of.get(k, k) for k in self._generated}
        return super().generated_fingerprints()

    def _reconstruct_path(self, fp: int):
        self._ensure_mirror()
        return super()._reconstruct_path(fp)
