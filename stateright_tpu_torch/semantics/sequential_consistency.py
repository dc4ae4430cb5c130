"""Sequential-consistency tester
(`src/semantics/sequential_consistency.rs`): the same
interleaving search as linearizability minus the real-time constraints —
only per-thread program order and the sequential spec prune the search
(`sequential_consistency.rs:166-213`).

A copy of ``stateright_tpu/semantics/sequential_consistency.py`` (host side only, no JAX); the
Rust crate's sources are cited by their paths in that crate.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .core import ConsistencyTester, SequentialSpec

# history key -> serialization (or None); see the linearizability tester
_SERIALIZATION_CACHE: dict = {}
_CACHE_MAX = 1 << 20
_MISS = object()


class SequentialConsistencyTester(ConsistencyTester):
    def __init__(self, init_ref_obj: SequentialSpec):
        self._init = init_ref_obj
        self._history: Dict[Any, List[Tuple[Any, Any]]] = {}
        self._in_flight: Dict[Any, Any] = {}
        self._valid = True

    # --- value semantics -------------------------------------------------
    def clone(self) -> "SequentialConsistencyTester":
        dup = SequentialConsistencyTester(self._init.clone())
        dup._history = {t: list(h) for t, h in self._history.items()}
        dup._in_flight = dict(self._in_flight)
        dup._valid = self._valid
        return dup

    def _key(self):
        return (self._init,
                tuple(sorted((t, tuple(h))
                             for t, h in self._history.items())),
                tuple(sorted(self._in_flight.items())),
                self._valid)

    def __eq__(self, other):
        return isinstance(other, SequentialConsistencyTester) \
            and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __stable_words__(self, out):
        from ..fingerprint import stable_words
        stable_words(("SequentialConsistencyTester",) + self._key(), out)

    def __len__(self) -> int:
        return len(self._in_flight) \
            + sum(len(h) for h in self._history.values())

    # --- recording -------------------------------------------------------
    def on_invoke(self, thread_id, op):
        if not self._valid:
            raise ValueError("Earlier history was invalid.")
        if thread_id in self._in_flight:
            self._valid = False
            raise ValueError(
                f"Thread already has an operation in flight. "
                f"thread_id={thread_id!r}")
        self._in_flight[thread_id] = op
        self._history.setdefault(thread_id, [])
        return self

    def on_return(self, thread_id, ret):
        if not self._valid:
            raise ValueError("Earlier history was invalid.")
        if thread_id not in self._in_flight:
            self._valid = False
            raise ValueError(
                f"There is no in-flight invocation for this thread ID. "
                f"thread_id={thread_id!r}, unexpected_return={ret!r}")
        op = self._in_flight.pop(thread_id)
        self._history.setdefault(thread_id, []).append((op, ret))
        return self

    def is_consistent(self) -> bool:
        return self.serialized_history() is not None

    # --- the search ------------------------------------------------------
    def serialized_history(self) -> Optional[List[Tuple[Any, Any]]]:
        """Memoized by the canonical history key (histories recur across
        explored states; see the linearizability tester)."""
        if not self._valid:
            return None
        # see the linearizability tester: only cache for value-equal specs
        cacheable = type(self._init).__eq__ is not object.__eq__
        if cacheable:
            key = self._key()
            hit = _SERIALIZATION_CACHE.get(key, _MISS)
            if hit is not _MISS:
                return None if hit is None else list(hit)
        remaining = {t: list(h) for t, h in self._history.items()}
        # dead-configuration memo (see the linearizability tester): the
        # subtree depends only on (spec state, per-thread suffix length,
        # in-flight threads), so failed configurations prune on revisit
        failed = set() if cacheable else None
        result = _serialize([], self._init, remaining,
                            dict(self._in_flight), failed)
        if cacheable:
            if len(_SERIALIZATION_CACHE) >= _CACHE_MAX:
                _SERIALIZATION_CACHE.clear()
            _SERIALIZATION_CACHE[key] = None if result is None \
                else tuple(result)
        return result


#: dead-configuration memo cap (matches the linearizability tester)
_FAILED_MAX = 1 << 20


def _config_key(ref_obj, remaining, in_flight):
    # each thread's remaining list is a suffix of its original, so
    # its length pins the position; in-flight entries only leave
    return (ref_obj,
            tuple(sorted((t, len(h)) for t, h in remaining.items())),
            frozenset(in_flight))


def _branches(ref_obj, remaining, in_flight):
    """Candidate next steps (see the linearizability tester; here only
    program order and the spec prune)."""
    for thread_id in list(remaining):
        history = remaining[thread_id]
        if not history:
            if thread_id not in in_flight:
                continue
            op = in_flight[thread_id]
            obj = ref_obj.clone()
            ret = obj.invoke(op)
            branch_in_flight = {t: v for t, v in in_flight.items()
                                if t != thread_id}
            yield op, ret, obj, remaining, branch_in_flight
        else:
            op, ret = history[0]
            obj = ref_obj.clone()
            if not obj.is_valid_step(op, ret):
                continue
            branch_remaining = dict(remaining)
            branch_remaining[thread_id] = history[1:]
            yield op, ret, obj, branch_remaining, in_flight


def _serialize(valid_history, ref_obj, remaining, in_flight,
               failed=None):
    """Iterative DFS over the interleavings (one explicit frame per
    serialized op; matches the linearizability tester — long runtime
    histories must not consume Python recursion depth)."""
    if all(not h for h in remaining.values()):
        return list(valid_history)
    path = list(valid_history)

    def open_node(obj, rem, flight):
        key = None
        if failed is not None:
            key = _config_key(obj, rem, flight)
            if key in failed:
                return None
        return (key, _branches(obj, rem, flight))

    stack = [open_node(ref_obj, remaining, in_flight)]
    if stack[0] is None:
        return None
    while stack:
        key, branches = stack[-1]
        pushed = False
        for op, ret, obj, b_rem, b_flight in branches:
            path.append((op, ret))
            if all(not h for h in b_rem.values()):
                return path
            child = open_node(obj, b_rem, b_flight)
            if child is None:
                path.pop()
                continue
            stack.append(child)
            pushed = True
            break
        if not pushed:
            if key is not None and len(failed) < _FAILED_MAX:
                failed.add(key)
            stack.pop()
            if stack:
                path.pop()
    return None
