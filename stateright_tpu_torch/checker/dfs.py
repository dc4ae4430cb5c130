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
of the JAX package's trace events; visitors raise
``NotImplementedError``. Under ``sound_eventually()`` dedup is on
(state, pending-ebits) node keys, a rejoin of the current path with bits
pending reports a lasso at once, and without symmetry the explored node
graph (every edge, dedup hits included) is swept for cycles at
exhaustion (``checker/lasso.py``), which finds the cycles entered
through a cross edge into an explored branch as well.
"""

from __future__ import annotations

from typing import Dict, List, Set

from ..core import Expectation
from .builder import CheckerBuilder
from .host import HostChecker, refuse_unported
from .lasso import lasso_sweep
from .path import Path


class DfsChecker(HostChecker):
    def __init__(self, builder: CheckerBuilder):
        refuse_unported(builder)
        super().__init__(builder)
        # dedup keys: canonical state fingerprints; under
        # sound_eventually(), (state, pending-ebits) node keys
        self._generated: Set[int] = set()
        model = self._model
        symmetry = self._symmetry_fn
        init_states = [s for s in model.init_states()
                       if model.within_boundary(s)]
        self._state_count = len(init_states)
        ebits = self._init_ebits()
        self._init_sound(builder, ebits)
        mask = self._ebits_mask(ebits)
        for s in init_states:
            self._generated.add(self._node_key(model.fingerprint(
                symmetry(s) if symmetry is not None else s), mask))
        self._unique_state_count = len(self._generated)
        #: stack entries: (state, fingerprint path, ebits, the canonical
        #: state fingerprints on the path — sound mode only, else None —
        #: and the node key)
        self._pending: List = []
        # the lasso sweep's node graph (sound mode, no symmetry): every
        # edge between nodes with bits pending, dedup hits included (the
        # cross edges the on-path check cannot see), the pending mask of
        # each node and a parent map for witnesses
        self._lasso = self._sound and symmetry is None
        if self._lasso:
            self._node_edges: Dict[int, List[int]] = {}
            self._node_mask: Dict[int, int] = {}
            self._node_parent: Dict[int, tuple] = {}
        for s in init_states:
            fp = model.fingerprint(s)
            rep = (model.fingerprint(symmetry(s))
                   if symmetry is not None else fp)
            key = self._node_key(rep, mask)
            self._pending.append(
                (s, [fp], ebits,
                 frozenset([rep]) if self._sound else None, key))
            if self._lasso:
                self._node_mask[key] = mask
                self._node_parent.setdefault(key, (None, fp))
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
        lasso = self._lasso
        while pending:
            if cancelled():
                return
            state, fingerprints, ebits, on_path, node_key = pending.pop()

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
            child_mask = self._ebits_mask(ebits)
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
                if on_path is not None and ebits and rep_fp in on_path:
                    # a lasso: the expansion rejoined the current path
                    # with bits pending; the ancestor's pending set was a
                    # superset (bits only clear), so each pending bit
                    # stays unsatisfied around the whole loop
                    if next_fp is None:
                        next_fp = model.fingerprint(next_state)
                    for i, prop in enumerate(properties):
                        if i in ebits and prop.name not in discoveries:
                            discoveries[prop.name] = \
                                fingerprints + [next_fp]
                next_key = self._node_key(rep_fp, child_mask)
                if lasso and child_mask:
                    # every edge between still-pending nodes (dedup hits
                    # included: those are the cross edges)
                    self._node_edges.setdefault(node_key, []).append(
                        next_key)
                    self._node_mask[next_key] = child_mask
                if next_key in generated:
                    is_terminal = False
                    continue
                generated.add(next_key)
                self._unique_state_count = len(generated)
                is_terminal = False
                if next_fp is None:
                    next_fp = model.fingerprint(next_state)
                if lasso and child_mask:
                    self._node_parent.setdefault(next_key,
                                                 (node_key, next_fp))
                pending.append(
                    (next_state, fingerprints + [next_fp], ebits,
                     on_path | {rep_fp} if on_path is not None else None,
                     next_key))
            if is_terminal:
                for i, prop in enumerate(properties):
                    # first discovery wins (the Rust crate's insert-once
                    # flush): a late terminal whose path skipped
                    # ebit-clearing must not overwrite the witness
                    if i in ebits and prop.name not in discoveries:
                        discoveries[prop.name] = list(fingerprints)
            if target is not None and self._state_count >= target:
                return
        if lasso:
            # at exhaustion: the cycles entered through a cross edge into
            # an explored branch, which the on-path check cannot see
            lasso_sweep(properties, discoveries, self._node_edges,
                        self._node_mask, self._node_parent, self._node_fp)

    def discoveries(self) -> Dict[str, Path]:
        return {name: Path.from_fingerprints(self._model, fps)
                for name, fps in list(self._discovery_fps.items())}
