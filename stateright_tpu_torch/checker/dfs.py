"""Host depth-first search engine.

A copy of ``stateright_tpu/checker/dfs.py`` (the Rust crate's
``src/checker/dfs.rs``): a LIFO stack of ``(state, fingerprint path,
ebits)`` with the full path carried on the stack (no parent map);
discoveries store whole fingerprint paths. This is the only host engine
with symmetry reduction, with the Rust crate's load-bearing subtlety
(``dfs.rs:260-285``): dedup inserts ``fingerprint(representative(
next_state))`` but the enqueued path continues with the original
state's fingerprint — jumping to the canonical member could leave the
collected path without a valid extension (``dfs.rs:394-483``). Trimmed
of the JAX package's trace events and of the sound-mode lasso (not
ported); visitors and ``sound_eventually()`` raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List, Set

from ..core import Expectation
from .builder import CheckerBuilder
from .host import HostChecker, refuse_unported
from .path import Path


class DfsChecker(HostChecker):
    def __init__(self, builder: CheckerBuilder):
        refuse_unported(builder)
        super().__init__(builder)
        # dedup keys: canonical state fingerprints
        self._generated: Set[int] = set()
        model = self._model
        symmetry = self._symmetry_fn
        init_states = [s for s in model.init_states()
                       if model.within_boundary(s)]
        self._state_count = len(init_states)
        ebits = self._init_ebits()
        for s in init_states:
            self._generated.add(model.fingerprint(
                symmetry(s) if symmetry is not None else s))
        self._unique_state_count = len(self._generated)
        #: stack entries: (state, fingerprint path, ebits)
        self._pending: List = [(s, [model.fingerprint(s)], ebits)
                               for s in init_states]
        #: name -> full fingerprint path (dfs.rs:26)
        self._discovery_fps: Dict[str, List[int]] = {}

    def _run(self) -> None:
        model = self._model
        properties = self._properties
        generated = self._generated
        pending = self._pending
        discoveries = self._discovery_fps
        symmetry = self._symmetry_fn
        target = self._target_state_count
        cancelled = self._cancel_event.is_set
        while pending:
            if cancelled():
                return
            state, fingerprints, ebits = pending.pop()

            # Property evaluation (dfs.rs:204-237).
            is_awaiting_discoveries = False
            for i, prop in enumerate(properties):
                if prop.name in discoveries:
                    continue
                if prop.expectation == Expectation.ALWAYS:
                    if not prop.condition(model, state):
                        discoveries[prop.name] = list(fingerprints)
                    else:
                        is_awaiting_discoveries = True
                elif prop.expectation == Expectation.SOMETIMES:
                    if prop.condition(model, state):
                        discoveries[prop.name] = list(fingerprints)
                    else:
                        is_awaiting_discoveries = True
                else:  # EVENTUALLY
                    is_awaiting_discoveries = True
                    if prop.condition(model, state):
                        ebits = ebits - {i}
            if not is_awaiting_discoveries:
                return

            # Expansion (dfs.rs:239-301).
            actions: List = []
            is_terminal = True
            model.actions(state, actions)
            for action in actions:
                next_state = model.next_state(state, action)
                if next_state is None:
                    continue
                if not model.within_boundary(next_state):
                    continue
                self._state_count += 1
                if symmetry is not None:
                    rep_fp = model.fingerprint(symmetry(next_state))
                    # the pre-canonicalized state's fingerprint continues
                    # the path (dfs.rs:266-269), computed only for a new
                    # key: dedup hits (the common case) never need it
                    next_fp = None
                else:
                    rep_fp = next_fp = model.fingerprint(next_state)
                if rep_fp in generated:
                    is_terminal = False
                    continue
                generated.add(rep_fp)
                self._unique_state_count = len(generated)
                is_terminal = False
                if next_fp is None:
                    next_fp = model.fingerprint(next_state)
                pending.append((next_state, fingerprints + [next_fp], ebits))
            if is_terminal:
                for i, prop in enumerate(properties):
                    # first discovery wins (the Rust crate's insert-once
                    # flush): a late terminal whose path skipped
                    # ebit-clearing must not overwrite the witness
                    if i in ebits and prop.name not in discoveries:
                        discoveries[prop.name] = list(fingerprints)
            if target is not None and self._state_count >= target:
                return

    def discoveries(self) -> Dict[str, Path]:
        return {name: Path.from_fingerprints(self._model, fps)
                for name, fps in list(self._discovery_fps.items())}
