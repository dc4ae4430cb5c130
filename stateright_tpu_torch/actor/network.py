"""The in-model network: nondeterministic delivery as *data*.

Three semantics, mirroring `src/actor/network.rs:44-64`:

  * ``UnorderedDuplicating`` — a set of envelopes; delivery leaves the
    envelope in place (redelivery allowed); dropping removes it ("never
    deliver again", the semantics pinned by the reference's
    ``unordered_network_has_a_bug`` test, `src/actor/model.rs:754-836`).
  * ``UnorderedNonDuplicating`` — a multiset; delivery and dropping each
    consume one count.
  * ``Ordered`` — per-(src, dst) FIFO channels; only channel heads are
    deliverable/droppable.

All variants are immutable values: every mutation returns a new network.
Canonical representations (frozensets / sorted channel tuples) make
equality, hashing, and stable fingerprints order-insensitive exactly like
the reference's ``HashableHashSet``/``HashableHashMap`` recipe
(`src/util.rs:124-145`, `:321-343`).

A copy of ``stateright_tpu/actor/network.py`` (host side only, no JAX); the
Rust crate's sources are cited by their paths in that crate.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Tuple

from .core import Envelope, Id


def _env_order(env: Envelope) -> int:
    """Deterministic envelope iteration order.

    Python set iteration depends on the process hash seed (messages contain
    strings), which would make action order — and with it early-exit state
    counts and witness choice — vary run to run. Iterating unordered
    networks in stable-fingerprint order keeps every engine's exploration
    deterministic, which path replay and the pinned oracle counts rely on.
    """
    from ..fingerprint import stable_fingerprint
    return stable_fingerprint(env)


class Network:
    """Base class + factories (`network.rs:79-140`)."""

    # --- factories -------------------------------------------------------
    @staticmethod
    def new_unordered_duplicating(envelopes: Iterable[Envelope] = ()) \
            -> "UnorderedDuplicating":
        return UnorderedDuplicating(frozenset(envelopes))

    @staticmethod
    def new_unordered_nonduplicating(envelopes: Iterable[Envelope] = ()) \
            -> "UnorderedNonDuplicating":
        counts: dict = {}
        for env in envelopes:
            counts[env] = counts.get(env, 0) + 1
        return UnorderedNonDuplicating(
            frozenset(counts.items()))

    @staticmethod
    def new_ordered(envelopes: Iterable[Envelope] = ()) -> "Ordered":
        channels: dict = {}
        for env in envelopes:
            channels.setdefault((env.src, env.dst), []).append(env.msg)
        return Ordered(tuple(sorted(
            ((key, tuple(msgs)) for key, msgs in channels.items()))))

    @staticmethod
    def names() -> Tuple[str, ...]:
        return ("ordered", "unordered_duplicating",
                "unordered_nonduplicating")

    @staticmethod
    def from_name(name: str) -> "Network":
        """CLI network selection (`network.rs:278-290`)."""
        if name == "ordered":
            return Network.new_ordered()
        if name == "unordered_duplicating":
            return Network.new_unordered_duplicating()
        if name == "unordered_nonduplicating":
            return Network.new_unordered_nonduplicating()
        raise ValueError(f"unable to parse network name: {name}")

    # --- interface -------------------------------------------------------
    def iter_all(self) -> Iterator[Envelope]:
        """Every message in flight, with multiplicity (`network.rs:143`)."""
        raise NotImplementedError

    def iter_deliverable(self) -> Iterator[Envelope]:
        """Distinct deliverable envelopes (`network.rs:157-170`): multiset
        keys once each; ordered channels expose only their head."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def send(self, envelope: Envelope) -> "Network":
        raise NotImplementedError

    def on_deliver(self, envelope: Envelope) -> "Network":
        raise NotImplementedError

    def on_drop(self, envelope: Envelope) -> "Network":
        raise NotImplementedError


class UnorderedDuplicating(Network):
    __slots__ = ("_set", "_sorted")

    def __init__(self, envelopes: frozenset):
        self._set = envelopes
        self._sorted = None  # lazy: sorted-by-fingerprint iteration order

    def _iter_sorted(self):
        if self._sorted is None:
            self._sorted = sorted(self._set, key=_env_order)
        return iter(self._sorted)

    def iter_all(self):
        return self._iter_sorted()

    def iter_deliverable(self):
        return self._iter_sorted()

    def __len__(self):
        return len(self._set)

    def send(self, envelope):
        return UnorderedDuplicating(self._set | {envelope})

    def on_deliver(self, envelope):
        # no-op: the message can be redelivered (network.rs:203-205)
        return self

    def on_drop(self, envelope):
        # "never deliver again" (model.rs:754-836)
        return UnorderedDuplicating(self._set - {envelope})

    def __eq__(self, other):
        return isinstance(other, UnorderedDuplicating) \
            and self._set == other._set

    def __hash__(self):
        return hash(self._set)

    def __repr__(self):
        return f"UnorderedDuplicating({sorted(map(repr, self._set))})"

    def __stable_words__(self, out):
        from ..fingerprint import stable_words
        stable_words(("UnorderedDuplicating", self._set), out)


class UnorderedNonDuplicating(Network):
    __slots__ = ("_counts", "_sorted")

    def __init__(self, counts: frozenset):
        # frozenset of (envelope, count>0) pairs — canonical since counts
        # are unique per envelope
        self._counts = counts
        self._sorted = None  # lazy: sorted-by-fingerprint iteration order

    def _iter_sorted(self):
        if self._sorted is None:
            self._sorted = sorted(self._counts,
                                  key=lambda ec: _env_order(ec[0]))
        return iter(self._sorted)

    def iter_all(self):
        for env, count in self._iter_sorted():
            for _ in range(count):
                yield env

    def iter_deliverable(self):
        for env, _count in self._iter_sorted():
            yield env

    def __len__(self):
        return sum(count for _, count in self._counts)

    def _as_dict(self) -> dict:
        return dict(self._counts)

    def send(self, envelope):
        counts = self._as_dict()
        counts[envelope] = counts.get(envelope, 0) + 1
        return UnorderedNonDuplicating(frozenset(counts.items()))

    def _consume(self, envelope):
        counts = self._as_dict()
        if envelope not in counts:
            raise ValueError(f"envelope not found: {envelope!r}")
        if counts[envelope] == 1:
            del counts[envelope]
        else:
            counts[envelope] -= 1
        return UnorderedNonDuplicating(frozenset(counts.items()))

    def on_deliver(self, envelope):
        return self._consume(envelope)

    def on_drop(self, envelope):
        return self._consume(envelope)

    def __eq__(self, other):
        return isinstance(other, UnorderedNonDuplicating) \
            and self._counts == other._counts

    def __hash__(self):
        return hash(self._counts)

    def __repr__(self):
        return f"UnorderedNonDuplicating({sorted(map(repr, self._counts))})"

    def __stable_words__(self, out):
        from ..fingerprint import stable_words
        stable_words(("UnorderedNonDuplicating", self._counts), out)


class Ordered(Network):
    __slots__ = ("_channels",)

    def __init__(self, channels: Tuple[Tuple[Tuple[Id, Id], tuple], ...]):
        # sorted tuple of ((src, dst), (msg, ...)) with non-empty queues —
        # canonical (flows are deleted when emptied, network.rs:228-234)
        self._channels = channels

    def iter_all(self):
        for (src, dst), msgs in self._channels:
            for msg in msgs:
                yield Envelope(src=src, dst=dst, msg=msg)

    def iter_deliverable(self):
        for (src, dst), msgs in self._channels:
            yield Envelope(src=src, dst=dst, msg=msgs[0])

    def __len__(self):
        return sum(len(msgs) for _, msgs in self._channels)

    def _as_dict(self) -> dict:
        return {key: list(msgs) for key, msgs in self._channels}

    @staticmethod
    def _freeze(channels: dict) -> "Ordered":
        return Ordered(tuple(sorted(
            (key, tuple(msgs)) for key, msgs in channels.items() if msgs)))

    def send(self, envelope):
        channels = self._as_dict()
        channels.setdefault((envelope.src, envelope.dst), []) \
            .append(envelope.msg)
        return Ordered._freeze(channels)

    def _remove(self, envelope):
        channels = self._as_dict()
        key = (envelope.src, envelope.dst)
        if key not in channels:
            raise ValueError(
                f"flow not found. src={envelope.src!r}, dst={envelope.dst!r}")
        try:
            channels[key].remove(envelope.msg)  # first match
        except ValueError:
            raise ValueError(f"message not found: {envelope.msg!r}")
        return Ordered._freeze(channels)

    def on_deliver(self, envelope):
        return self._remove(envelope)

    def on_drop(self, envelope):
        return self._remove(envelope)

    def __eq__(self, other):
        return isinstance(other, Ordered) \
            and self._channels == other._channels

    def __hash__(self):
        return hash(self._channels)

    def __repr__(self):
        return f"Ordered({self._channels!r})"

    def __stable_words__(self, out):
        from ..fingerprint import stable_words
        stable_words(("Ordered", self._channels), out)


# --- symmetry rewrites (`network.rs:292-304`) -------------------------------

def _rewrite_env(env: Envelope, plan) -> Envelope:
    from ..checker.representative import rewrite_value
    return Envelope(src=Id(plan.rewrite(env.src)),
                    dst=Id(plan.rewrite(env.dst)),
                    msg=rewrite_value(env.msg, plan))


def _add_rewrites():
    def dup_rewrite(self, plan):
        return UnorderedDuplicating(
            frozenset(_rewrite_env(e, plan) for e in self._set))

    def nondup_rewrite(self, plan):
        return UnorderedNonDuplicating(
            frozenset((_rewrite_env(e, plan), c) for e, c in self._counts))

    def ordered_rewrite(self, plan):
        from ..checker.representative import rewrite_value
        return Ordered(tuple(sorted(
            ((Id(plan.rewrite(src)), Id(plan.rewrite(dst))),
             tuple(rewrite_value(m, plan) for m in msgs))
            for (src, dst), msgs in self._channels)))

    UnorderedDuplicating.rewrite = dup_rewrite
    UnorderedNonDuplicating.rewrite = nondup_rewrite
    Ordered.rewrite = ordered_rewrite


_add_rewrites()
