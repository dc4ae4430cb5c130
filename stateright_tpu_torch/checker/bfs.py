"""Host breadth-first search engine.

A copy of ``stateright_tpu/checker/bfs.py`` (the Rust crate's
``src/checker/bfs.rs``): a FIFO frontier of ``(state, fingerprint,
ebits)``; a ``generated`` map of fingerprint -> parent fingerprint used
both for dedup and for trace reconstruction by replay
(``bfs.rs:314-342``); property evaluation on pop with early exit once
every property has a discovery; ``eventually`` bits flushed as
counterexamples at terminal states, with the Rust crate's two
documented caveats (``bfs.rs:239-244``, ``:249-256``).
``CheckerBuilder.sound_eventually()`` opts into node-keyed dedup (state
fingerprint and pending eventually-bits, ``fingerprint.fp64_node``),
which removes the first caveat (DAG rejoins). Trimmed of the JAX
package's trace events; visitors raise ``NotImplementedError`` (not
ported).

Symmetry reduction is intentionally not applied here: as in the Rust
crate, only the DFS engine honours it.
"""

from __future__ import annotations

from collections import deque
from typing import List

from ..core import Expectation
from .builder import CheckerBuilder
from .host import HostChecker, refuse_unported


class BfsChecker(HostChecker):
    def __init__(self, builder: CheckerBuilder):
        refuse_unported(builder)
        super().__init__(builder)
        model = self._model
        init_states = [s for s in model.init_states()
                       if model.within_boundary(s)]
        self._state_count = len(init_states)
        ebits = self._init_ebits()
        # dedup keys: state fingerprints, or under sound_eventually()
        # node keys (_node_fp translates them back for replay)
        self._init_sound(builder, ebits)
        mask = self._ebits_mask(ebits)
        for s in init_states:
            self._generated.setdefault(
                self._node_key(model.fingerprint(s), mask), None)
        self._unique_state_count = len(self._generated)
        self._pending = deque(
            (s, model.fingerprint(s), ebits) for s in init_states)

    def _run(self) -> None:
        model = self._model
        properties = self._properties
        generated = self._generated
        pending = self._pending
        discoveries = self._discovery_fps
        target = self._target_state_count
        cancelled = self._cancel_event.is_set
        while pending:
            if cancelled():
                break
            state, state_fp, ebits = pending.popleft()
            # this node's key has its AT-ENQUEUE bits (dedup happened at
            # enqueue, before this pop clears any)
            state_key = self._node_key(state_fp, self._ebits_mask(ebits))

            # Property evaluation (bfs.rs:192-226).
            is_awaiting_discoveries = False
            for i, prop in enumerate(properties):
                if prop.name in discoveries:
                    continue
                if prop.expectation == Expectation.ALWAYS:
                    if not prop.condition(model, state):
                        discoveries[prop.name] = state_key
                    else:
                        is_awaiting_discoveries = True
                elif prop.expectation == Expectation.SOMETIMES:
                    if prop.condition(model, state):
                        discoveries[prop.name] = state_key
                    else:
                        is_awaiting_discoveries = True
                else:  # EVENTUALLY: discoveries only surface at terminals.
                    is_awaiting_discoveries = True
                    if prop.condition(model, state):
                        ebits = ebits - {i}
            if not is_awaiting_discoveries:
                return

            # Expansion (bfs.rs:229-264).
            actions: List = []
            is_terminal = True
            child_mask = self._ebits_mask(ebits)
            model.actions(state, actions)
            for action in actions:
                next_state = model.next_state(state, action)
                if next_state is None:
                    continue
                if not model.within_boundary(next_state):
                    continue
                self._state_count += 1
                next_fp = model.fingerprint(next_state)
                next_key = self._node_key(next_fp, child_mask)
                if next_key in generated:
                    is_terminal = False
                    continue
                generated[next_key] = state_key
                self._unique_state_count = len(generated)
                is_terminal = False
                pending.append((next_state, next_fp, ebits))
            if is_terminal:
                for i, prop in enumerate(properties):
                    # first discovery wins (the Rust crate's insert-once
                    # flush, bfs.rs:265-272): a late terminal whose path
                    # skipped ebit-clearing must not overwrite the
                    # witness
                    if i in ebits and prop.name not in discoveries:
                        discoveries[prop.name] = state_key
            if target is not None and self._state_count >= target:
                return
