"""Actor protocol: event-driven state machines that can be model-checked
and executed.

Mirrors the reference's ``Actor`` trait and effect vocabulary
(`src/actor.rs:243-286`, `:154-231`). One Python-idiomatic
divergence: where the reference passes ``&mut Cow<State>`` and detects
no-ops via ``Cow::Borrowed`` (`src/actor.rs:233-237`), handlers here
*return* the next state — ``None`` means "unchanged", which combined with an
empty ``Out`` is the no-op signal the model uses to prune actions.

A copy of ``stateright_tpu/actor/core.py`` (host side only, no JAX); the
Rust crate's sources are cited by their paths in that crate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, List, Optional, Tuple


class Id(int):
    """Uniquely identifies an actor. Encodes an index for model-checked
    actors and an IPv4 socket address for spawned actors
    (`src/actor.rs:107-151`, `src/actor/spawn.rs:9-33`)."""

    __slots__ = ()

    def __repr__(self) -> str:  # Id(3) — matches the reference's Debug
        return f"Id({int(self)})"

    # --- runtime encoding: (ip << 16) | port, as in spawn.rs:9-33 --------
    @staticmethod
    def from_socket_addr(ip: Tuple[int, int, int, int], port: int) -> "Id":
        ip_u32 = (ip[0] << 24) | (ip[1] << 16) | (ip[2] << 8) | ip[3]
        return Id((ip_u32 << 16) | port)

    def socket_addr(self) -> Tuple[Tuple[int, int, int, int], int]:
        v = int(self)
        ip_u32 = (v >> 16) & 0xFFFFFFFF
        ip = ((ip_u32 >> 24) & 0xFF, (ip_u32 >> 16) & 0xFF,
              (ip_u32 >> 8) & 0xFF, ip_u32 & 0xFF)
        return ip, v & 0xFFFF


@dataclass(frozen=True)
class Envelope:
    """A message in flight (`src/actor/network.rs:24-39`)."""
    src: Id
    dst: Id
    msg: Any


# --- commands (`src/actor.rs:154-165`) -------------------------------------

@dataclass(frozen=True)
class Send:
    dst: Id
    msg: Any


@dataclass(frozen=True)
class SetTimer:
    """Durations only matter at runtime; the model reduces a set timer to a
    boolean (`src/actor/model.rs:59-64`)."""
    min_seconds: float
    max_seconds: float


@dataclass(frozen=True)
class CancelTimer:
    pass


class Out(list):
    """Commands collected from an actor handler (`src/actor.rs:167-231`)."""

    def send(self, recipient: Id, msg: Any) -> None:
        self.append(Send(Id(recipient), msg))

    def broadcast(self, recipients: Iterable[Id], msg: Any) -> None:
        for recipient in recipients:
            self.send(recipient, msg)

    def set_timer(self, timer_range: Tuple[float, float]) -> None:
        lo, hi = timer_range
        self.append(SetTimer(lo, hi))

    def cancel_timer(self) -> None:
        self.append(CancelTimer())


class Actor:
    """An event-driven state machine (`src/actor.rs:243-286`).

    The same instance serves model checking (`ActorModel`) and real
    execution (`spawn`) — the framework's signature dual use.
    """

    def on_start(self, id: Id, o: Out) -> Any:
        """Return the initial state, optionally emitting commands."""
        raise NotImplementedError

    def on_msg(self, id: Id, state: Any, src: Id, msg: Any,
               o: Out) -> Optional[Any]:
        """Handle a delivery; return the next state or ``None`` if
        unchanged (the ``Cow::Borrowed`` analog)."""
        return None

    def on_timeout(self, id: Id, state: Any, o: Out) -> Optional[Any]:
        return None

    # --- crash–restart fault injection (``ActorModel.crash_restart``) ----
    def durable(self, id: Id, state: Any) -> Any:
        """The substate that survives a crash (stable storage).

        The default is ``None``: nothing survives, the fail-stop model.
        Actors with durable state (an fsync'd log, an acceptor's promised
        ballot) return the persisted projection of ``state``; the checker
        hands it back via :meth:`on_restart`.
        """
        return None

    def on_restart(self, id: Id, durable: Any, o: Out) -> Any:
        """Rebuild state after a crash–restart; returns the new state.

        The default re-runs :meth:`on_start` — a restarted actor rejoins
        exactly like a fresh boot, ignoring ``durable`` (which is ``None``
        unless :meth:`durable` was overridden). Actors that persist state
        override this to merge ``durable`` back in.
        """
        return self.on_start(id, o)


@dataclass(frozen=True)
class Down:
    """State marker for a crashed actor: volatile state is gone; only the
    :meth:`Actor.durable` projection rides along until the matching
    ``Restart`` action. Injected by ``ActorModel.crash_restart``."""
    durable: Any = None

    def rewrite(self, plan):
        from ..checker.representative import rewrite_value
        return Down(rewrite_value(self.durable, plan))


def is_no_op(next_state: Optional[Any], out: Out) -> bool:
    """True if the actor neither changed state nor emitted commands
    (`src/actor.rs:233-237`)."""
    return next_state is None and not out


class ScriptedActor(Actor):
    """Sends a scripted series of (dst, msg) pairs, advancing one step per
    delivery received — the ``Vec<(Id, Msg)> as Actor`` testing helper
    (`src/actor.rs:415-437`). State is the index of the next message."""

    def __init__(self, script: List[Tuple[Id, Any]]):
        self.script = list(script)

    def on_start(self, id: Id, o: Out) -> int:
        if self.script:
            dst, msg = self.script[0]
            o.send(dst, msg)
            return 1
        return 0

    def on_msg(self, id: Id, state: int, src: Id, msg: Any,
               o: Out) -> Optional[int]:
        if state < len(self.script):
            dst, nxt = self.script[state]
            o.send(dst, nxt)
            return state + 1
        return None


# --- helpers ----------------------------------------------------------------

def majority(participant_count: int) -> int:
    """Minimum size of a majority (`src/actor.rs:440-442`)."""
    return participant_count // 2 + 1


def peer_ids(self_id: Id, other_ids) -> List[Id]:
    """Filter one's own id out of an id collection
    (`src/actor.rs:445-447`)."""
    return [i for i in other_ids if i != self_id]


def model_peers(self_ix: int, count: int) -> List[Id]:
    """All ids but one's own (`src/actor/model.rs:68-73`)."""
    return [Id(j) for j in range(count) if j != self_ix]


def model_timeout() -> Tuple[float, float]:
    """Arbitrary zero-length timer range for model checking
    (`src/actor/model.rs:59-64`)."""
    return (0.0, 0.0)
