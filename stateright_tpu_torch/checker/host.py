"""Shared results state of a checking run.

Counterpart of ``stateright_tpu/checker/host.py``, trimmed: the
properties, the discovered fingerprints, the counts, ``join`` and path
reconstruction from the fingerprint -> parent mirror (translated through
``_orig_of`` under symmetry reduction). The run executes in the caller's
thread on the first ``join()``.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..core import Model
from .builder import Checker, CheckerBuilder
from .path import Path


class HostChecker(Checker):
    """Base of the GPU engine: results bookkeeping and ``join``."""

    def __init__(self, builder: CheckerBuilder):
        self._model = builder.model
        self._target_state_count = builder.target_state_count_
        self._properties = self._model.properties()
        self._state_count = 0
        self._unique_state_count = 0
        self._discovery_fps: Dict[str, int] = {}
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

    def _run(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def join(self) -> "HostChecker":
        if not self._done:
            try:
                self._run()
            except BaseException as exc:
                self._error = exc
            finally:
                self._done = True
        if self._error is not None:
            raise self._error
        return self

    def is_done(self) -> bool:
        return self._done

    def error(self) -> Optional[BaseException]:
        return self._error

    def model(self) -> Model:
        return self._model

    def state_count(self) -> int:
        return self._state_count

    def unique_state_count(self) -> int:
        return self._unique_state_count

    def profile(self) -> Dict[str, object]:
        return dict(self._profile)

    def generated_fingerprints(self) -> set:
        return set(self._generated)

    def _reconstruct_path(self, fp: int) -> Path:
        """Walk parent pointers to an init state, then replay forward
        through the host model (the Rust crate's ``bfs.rs:314-342``).
        Under symmetry reduction the chain is canonical; each node is
        translated to its original state's fingerprint, so the replay
        follows the concrete states the search explored (the DFS
        engine's enqueue-original rule, ``dfs.rs:260-285``)."""
        fingerprints = []
        next_fp = fp
        while next_fp in self._generated:
            fingerprints.append(self._orig_of.get(next_fp, next_fp))
            parent = self._generated[next_fp]
            if parent is None:
                break
            next_fp = parent
        return Path.from_fingerprints(self._model, fingerprints[::-1])

    def discoveries(self) -> Dict[str, Path]:
        return {name: self._reconstruct_path(fp)
                for name, fp in self._discovery_fps.items()}
