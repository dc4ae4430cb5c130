"""Shared results state and execution of a checking run.

Counterpart of ``stateright_tpu/checker/host.py``, trimmed: the
properties, the discovered fingerprints, the counts, path
reconstruction from the fingerprint -> parent mirror (translated
through ``_orig_of`` under symmetry reduction), and the run itself on
one background thread started lazily — at the first ``join()`` or
``report()`` — with a cooperative ``cancel()`` (the race stops its loser
with it), and the host engines' sound-eventually node keys
(``_init_sound``). The JAX package's trace, flight recorder,
``StepDriver``, pause and profiler plumbing is not ported.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..core import Expectation, Model
from ..fingerprint import fp64_node
from .builder import Checker, CheckerBuilder
from .path import Path


class HostChecker(Checker):
    """Base of every engine: results bookkeeping and the background
    run."""

    def __init__(self, builder: CheckerBuilder):
        self._model = builder.model
        self._symmetry_fn = builder.symmetry_fn_
        self._target_state_count = builder.target_state_count_
        self._properties = self._model.properties()
        self._state_count = 0
        self._unique_state_count = 0
        self._discovery_fps: Dict[str, object] = {}
        #: fingerprint -> parent fingerprint (None for init states), in
        #: insertion order: the search record witness paths replay from
        self._generated: Dict[int, Optional[int]] = {}
        #: under symmetry reduction the mirror's keys are canonical:
        #: canonical key -> the fingerprint of the original state the
        #: search explored for it (empty otherwise)
        self._orig_of: Dict[int, int] = {}
        self._done = False
        self._error: Optional[BaseException] = None
        self._profile: Dict[str, object] = {}
        self._thread: Optional[threading.Thread] = None
        self._start_lock = threading.Lock()
        self._cancel_event = threading.Event()

    def _run(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    # --- execution -------------------------------------------------------
    def cancel(self) -> None:
        """Cooperatively stop the run (checked at the engines' loop
        points); the race stops its loser with it."""
        self._cancel_event.set()

    def cancelled(self) -> bool:
        return self._cancel_event.is_set()

    def _start_background(self) -> None:
        with self._start_lock:
            if self._thread is None:
                self._thread = threading.Thread(target=self._run_wrapper,
                                                daemon=True)
                self._thread.start()

    def _run_wrapper(self) -> None:
        """The run on its thread: an error lands in ``error()`` (raised
        at ``join()``), and the run is done either way."""
        try:
            self._run()
        except BaseException as exc:  # re-raised at join()
            self._error = exc
        finally:
            self._done = True

    def join(self) -> "HostChecker":
        self._start_background()
        if self._thread is not None:  # else it ran in this thread
            self._thread.join()
        if self._error is not None:
            raise self._error
        return self

    def is_done(self) -> bool:
        # a crashed engine counts as done for polling; the failure
        # itself surfaces on join() (and on report(), which joins)
        return self._done or (
            len(self._discovery_fps) == len(self._properties))

    def error(self) -> Optional[BaseException]:
        """The engine's failure, if it crashed; raised by ``join()``."""
        return self._error

    def _init_ebits(self) -> frozenset:
        """Bit per not-yet-satisfied ``eventually`` property."""
        return frozenset(
            i for i, p in enumerate(self._properties)
            if p.expectation == Expectation.EVENTUALLY)

    # --- sound_eventually() on the host engines (BFS, DFS) ---------------
    def _init_sound(self, builder: CheckerBuilder, ebits) -> None:
        """Node-keyed dedup: with ``sound_eventually()`` and at least one
        ``eventually`` property, keys combine the state fingerprint with
        the pending eventually-bits (``fingerprint.fp64_node``);
        ``_node_fp`` translates a key back to its state fingerprint."""
        self._sound = bool(builder.sound_eventually_) and bool(ebits)
        if self._sound:
            if max(ebits) > 31:
                # fp64_node hashes a 32-bit mask; truncating it would
                # bring back the miss this mode removes
                raise NotImplementedError(
                    "sound_eventually() supports eventually-property "
                    "indices 0..31")
            self._node_fp: Dict[int, int] = {}

    def _ebits_mask(self, ebits) -> int:
        """The bitmask of an ebits set (0 when sound mode is off)."""
        if not self._sound:
            return 0
        return sum(1 << i for i in ebits)

    def _node_key(self, fp: int, ebits_mask: int) -> int:
        if not self._sound:
            return fp
        key = fp64_node(fp, ebits_mask)
        self._node_fp[key] = fp
        return key

    # --- Checker interface ----------------------------------------------
    def model(self) -> Model:
        return self._model

    def state_count(self) -> int:
        return self._state_count

    def unique_state_count(self) -> int:
        return self._unique_state_count

    def profile(self) -> Dict[str, object]:
        return dict(self._profile)

    def generated_fingerprints(self) -> set:
        """The visited state fingerprints (a sound run's node keys
        translated to their states')."""
        node_fp = getattr(self, "_node_fp", None)
        if node_fp is None:
            return set(self._generated)
        return {node_fp.get(k, k) for k in self._generated}

    def _reconstruct_path(self, fp: int) -> Path:
        """Walk parent pointers to an init state, then replay forward
        through the host model (the Rust crate's ``bfs.rs:314-342``).
        Under symmetry reduction the chain is canonical; each node is
        translated to its original state's fingerprint, so the replay
        follows the concrete states the search explored (the DFS
        engine's enqueue-original rule, ``dfs.rs:260-285``); a sound
        run's node keys are translated to their states' fingerprints
        alike (``_node_fp`` on the host engines, ``_orig_of`` on the GPU
        engine)."""
        node_fp = getattr(self, "_node_fp", None) or self._orig_of
        fingerprints = []
        next_fp = fp
        while next_fp in self._generated:
            fingerprints.append(node_fp.get(next_fp, next_fp))
            parent = self._generated[next_fp]
            if parent is None:
                break
            next_fp = parent
        return Path.from_fingerprints(self._model, fingerprints[::-1])

    def discoveries(self) -> Dict[str, Path]:
        # a list-valued discovery is an explicit fingerprint path (a lasso
        # witness: stem and one lap of the cycle, not a parent chain)
        return {name: (Path.from_fingerprints(self._model, fp)
                       if isinstance(fp, (list, tuple))
                       else self._reconstruct_path(fp))
                for name, fp in list(self._discovery_fps.items())}


def refuse_unported(builder: CheckerBuilder) -> None:
    """The host engines' guard: a visitor the engine would silently
    ignore raises instead."""
    if builder.visitor_ is not None:
        raise NotImplementedError(
            "checker visitors are not ported (ROADMAP A14)")
