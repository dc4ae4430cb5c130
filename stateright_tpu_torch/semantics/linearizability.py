"""Linearizability tester
(`src/semantics/linearizability.rs`).

Captures real-time ordering without a global clock: each invocation records,
per *other* thread, the index of that thread's last completed operation
(`linearizability.rs:102-125`). ``serialized_history`` then searches the
interleavings recursively, pruning when a candidate step would place an
operation before one of its recorded prerequisites or fail the sequential
spec (`:177-240`) — worst-case exponential, which is why the framework runs
it host-side (it executes inside ``Property`` conditions, once per explored
history).

The tester is a value carried in model state ``history``: equality, hash,
and stable fingerprints are defined over its canonical contents, and the
record hooks clone before mutating.

A copy of ``stateright_tpu/semantics/linearizability.py`` (host side only, no JAX); the
Rust crate's sources are cited by their paths in that crate.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .core import ConsistencyTester, SequentialSpec

# history key -> serialization (or None for "not linearizable"); cleared
# wholesale if it ever reaches _CACHE_MAX entries (histories are tiny, so
# in practice a checking run never evicts)
_SERIALIZATION_CACHE: dict = {}
_CACHE_MAX = 1 << 20
_MISS = object()


class LinearizabilityTester(ConsistencyTester):
    def __init__(self, init_ref_obj: SequentialSpec):
        self._init = init_ref_obj
        # thread -> list of (last_completed: dict peer->index, op, ret)
        self._history: Dict[Any, List[Tuple[dict, Any, Any]]] = {}
        # thread -> (last_completed, op)
        self._in_flight: Dict[Any, Tuple[dict, Any]] = {}
        self._valid = True

    # --- value semantics -------------------------------------------------
    def clone(self) -> "LinearizabilityTester":
        dup = LinearizabilityTester(self._init.clone())
        dup._history = {t: list(h) for t, h in self._history.items()}
        dup._in_flight = dict(self._in_flight)
        dup._valid = self._valid
        return dup

    def _key(self):
        return (self._init,
                tuple(sorted(
                    (t, tuple((tuple(sorted(c.items())), op, ret)
                              for c, op, ret in h))
                    for t, h in self._history.items())),
                tuple(sorted(
                    (t, (tuple(sorted(c.items())), op))
                    for t, (c, op) in self._in_flight.items())),
                self._valid)

    def __eq__(self, other):
        return isinstance(other, LinearizabilityTester) \
            and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __stable_words__(self, out):
        from ..fingerprint import stable_words
        stable_words(("LinearizabilityTester",) + self._key(), out)

    def __len__(self) -> int:
        return len(self._in_flight) \
            + sum(len(h) for h in self._history.values())

    # --- recording (`linearizability.rs:102-155`) -------------------------
    def on_invoke(self, thread_id, op):
        if not self._valid:
            raise ValueError("Earlier history was invalid.")
        if thread_id in self._in_flight:
            self._valid = False
            raise ValueError(
                f"Thread already has an operation in flight. "
                f"thread_id={thread_id!r}, "
                f"op={self._in_flight[thread_id][1]!r}")
        last_completed = {
            t: len(h) - 1 for t, h in self._history.items()
            if t != thread_id and h}
        self._in_flight[thread_id] = (last_completed, op)
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
        completed, op = self._in_flight.pop(thread_id)
        self._history.setdefault(thread_id, []).append(
            (completed, op, ret))
        return self

    def is_consistent(self) -> bool:
        return self.serialized_history() is not None

    # --- the search (`linearizability.rs:177-240`) ------------------------
    def serialized_history(self) -> Optional[List[Tuple[Any, Any]]]:
        """Memoized by the canonical history key: the checker re-evaluates
        the ``linearizable`` property once per explored *state*, but
        histories recur massively across states (SURVEY hard-part #4), so
        the exponential interleaving search runs once per distinct history.
        """
        if not self._valid:
            return None
        # caching keys on spec value-equality; identity-equality specs
        # would never hit (every state holds fresh clones) and only leak
        cacheable = type(self._init).__eq__ is not object.__eq__
        if cacheable:
            key = self._key()
            hit = _SERIALIZATION_CACHE.get(key, _MISS)
            if hit is not _MISS:
                return None if hit is None else list(hit)
        remaining = {
            t: [(i, entry) for i, entry in enumerate(h)]
            for t, h in self._history.items()}
        # Wing&Gong-style dead-configuration memo (Lowe's optimization):
        # the search below a node depends only on (spec state, per-thread
        # progress, in-flight set), never on the path that reached it, so
        # a configuration that once failed can be pruned on revisit. This
        # is what makes REJECTING a long runtime soak history tractable —
        # the naive search must exhaust every interleaving of the valid
        # prefix before concluding "not linearizable". Only usable when
        # the spec has value equality (same `cacheable` condition).
        failed = set() if cacheable else None
        result = _serialize([], self._init, remaining,
                            dict(self._in_flight), failed)
        if cacheable:
            if len(_SERIALIZATION_CACHE) >= _CACHE_MAX:
                _SERIALIZATION_CACHE.clear()
            _SERIALIZATION_CACHE[key] = None if result is None \
                else tuple(result)
        return result


def _violates_realtime(last_completed: dict, remaining: dict) -> bool:
    """A step is invalid if any peer still has an operation pending at or
    before the index this operation observed as completed."""
    for peer_id, min_peer_time in last_completed.items():
        ops = remaining.get(peer_id)
        if ops:
            next_peer_time = ops[0][0]
            if next_peer_time <= min_peer_time:
                return True
    return False


#: dead-configuration memo cap (soak histories are long; a runaway
#: search should degrade to the naive behavior, not exhaust memory)
_FAILED_MAX = 1 << 20


def _config_key(ref_obj, remaining, in_flight):
    return (ref_obj,
            tuple(sorted((t, h[0][0] if h else -1)
                         for t, h in remaining.items())),
            frozenset(in_flight))


def _branches(ref_obj, remaining, in_flight):
    """Candidate next steps from one search node: for each thread,
    either its next completed op (validated against the spec) or its
    in-flight op (the spec decides the return). Yields
    ``(op, ret, obj, branch_remaining, branch_in_flight)``; node dicts
    are never mutated, only replaced."""
    for thread_id in list(remaining):
        history = remaining[thread_id]
        if not history:
            # Case 1: no completed ops left; maybe an in-flight one.
            if thread_id not in in_flight:
                continue
            last_completed, op = in_flight[thread_id]
            if _violates_realtime(last_completed, remaining):
                continue
            obj = ref_obj.clone()
            ret = obj.invoke(op)
            branch_in_flight = {t: v for t, v in in_flight.items()
                                if t != thread_id}
            yield op, ret, obj, remaining, branch_in_flight
        else:
            # Case 2: interleave this thread's next completed op.
            _index, (last_completed, op, ret) = history[0]
            if _violates_realtime(last_completed, remaining):
                continue
            obj = ref_obj.clone()
            if not obj.is_valid_step(op, ret):
                continue
            branch_remaining = dict(remaining)
            branch_remaining[thread_id] = history[1:]
            yield op, ret, obj, branch_remaining, in_flight


def _serialize(valid_history, ref_obj, remaining, in_flight,
               failed=None):
    """Iterative DFS over the interleavings (one explicit frame per
    serialized op — a multi-thousand-op runtime history must not burn
    a Python stack frame per op; the old recursive form needed
    ``sys.setrecursionlimit`` past ~10k ops and hard-crashed beyond
    the C stack)."""
    if all(not h for h in remaining.values()):
        return list(valid_history)
    path = list(valid_history)

    def open_node(obj, rem, flight):
        """A new search frame, or None when the configuration is a
        memoized dead end. (spec, per-thread next index, in-flight
        threads) pins the whole subtree: in_flight entries only ever
        *leave* the dict, so the thread set identifies their
        content."""
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
            # every branch failed: this configuration is dead
            if key is not None and len(failed) < _FAILED_MAX:
                failed.add(key)
            stack.pop()
            if stack:
                path.pop()  # the op that led into the dead frame
    return None
