"""``ActorModel``: N actors + a network (+ optional history) as a ``Model``.

The bridge between the actor world and the checker world — a direct
behavioral port of `src/actor/model.rs` (struct `:27-40`,
builder `:79-155`, ``Model`` impl `:187-494`). Because it implements the
``Model`` protocol, every engine (host BFS/DFS and, via the packed actor
encoding, ``spawn_gpu``) checks actor systems without knowing about actors.

A copy of ``stateright_tpu/actor/model.py`` (host side only, no JAX); the
Rust crate's sources are cited by their paths in that crate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, List, Optional, Tuple

from ..core import Expectation, Model, Property
from .core import (Actor, CancelTimer, Down, Envelope, Id, Out, Send,
                   SetTimer, is_no_op)
from .network import Network, Ordered


@dataclass(frozen=True)
class ActorModelState:
    """Snapshot of the entire actor system
    (`src/actor/model_state.rs:10-15`).

    ``crashes`` is ``None`` unless crash–restart fault injection is
    configured (``ActorModel.crash_restart``), keeping state identity —
    and thus fingerprints — bit-stable for existing models. With
    injection on it is the per-actor crash-count tuple; a down actor
    additionally has its slot in ``actor_states`` replaced by a
    :class:`~stateright_tpu_torch.actor.core.Down` marker.
    """
    actor_states: Tuple[Any, ...]
    network: Network
    is_timer_set: Tuple[bool, ...]
    history: Any = None
    crashes: Any = None

    def representative(self) -> "ActorModelState":
        """Symmetry canonicalization: sort actor states and rewrite ids
        (`model_state.rs:103-118`)."""
        from ..checker.representative import RewritePlan, rewrite_value
        plan = RewritePlan.from_values_to_sort(self.actor_states)
        return ActorModelState(
            actor_states=plan.reindex(self.actor_states),
            network=rewrite_value(self.network, plan),
            is_timer_set=plan.reindex(self.is_timer_set),
            history=rewrite_value(self.history, plan),
            crashes=(None if self.crashes is None
                     else plan.reindex(self.crashes)),
        )


def _xml_escape(s: str) -> str:
    from xml.sax.saxutils import escape
    return escape(s, {"'": "&apos;"})


# --- actions (`model.rs:43-51`) --------------------------------------------

@dataclass(frozen=True)
class Deliver:
    src: Id
    dst: Id
    msg: Any


@dataclass(frozen=True)
class Drop:
    envelope: Envelope


@dataclass(frozen=True)
class Timeout:
    id: Id


@dataclass(frozen=True)
class Crash:
    """Fault injection: actor ``id`` loses its volatile state and timer;
    only its ``Actor.durable()`` projection survives until ``Restart``."""
    id: Id


@dataclass(frozen=True)
class Restart:
    """Fault injection: a down actor rejoins via ``Actor.on_restart``."""
    id: Id


class ActorModel(Model):
    """Builder + ``Model`` implementation (`model.rs:79-155`, `:187-494`).

    ``record_msg_in``/``record_msg_out`` return a new history or ``None``
    for "unchanged" — the consistency testers hook in here.
    """

    def __init__(self, cfg: Any = None, init_history: Any = None):
        self.actors: List[Actor] = []
        self.cfg = cfg
        self.init_history = init_history
        self.init_network_: Network = Network.new_unordered_duplicating()
        self.lossy_network_: bool = False
        self.max_crashes_: int = 0
        self.crashable_: Optional[Tuple[int, ...]] = None
        self.properties_: List[Property] = []
        self.record_msg_in_: Callable = lambda cfg, history, env: None
        self.record_msg_out_: Callable = lambda cfg, history, env: None
        self.within_boundary_: Callable = lambda cfg, state: True

    # --- builder ---------------------------------------------------------
    def actor(self, actor: Actor) -> "ActorModel":
        self.actors.append(actor)
        return self

    def with_actors(self, actors: Iterable[Actor]) -> "ActorModel":
        self.actors.extend(actors)
        return self

    def init_network(self, network: Network) -> "ActorModel":
        self.init_network_ = network
        return self

    def lossy_network(self, lossy: bool) -> "ActorModel":
        self.lossy_network_ = lossy
        return self

    def crash_restart(self, max_crashes: int,
                      actors: Optional[Iterable[int]] = None) \
            -> "ActorModel":
        """Enable crash–restart fault injection: each eligible actor may
        crash up to ``max_crashes`` times (the bound keeps the state
        space finite). A ``Crash`` wipes the actor's volatile state —
        only its :meth:`~stateright_tpu_torch.actor.core.Actor.durable`
        projection survives — and cancels its timer; while down the
        actor takes no deliveries or timeouts (its in-flight messages
        wait in the network). A ``Restart`` rejoins it via
        :meth:`~stateright_tpu_torch.actor.core.Actor.on_restart`. ``actors``
        restricts which actor indices may crash (default: all)."""
        self.max_crashes_ = int(max_crashes)
        self.crashable_ = None if actors is None \
            else tuple(sorted({int(a) for a in actors}))
        return self

    def _crashable_indices(self) -> List[int]:
        if self.crashable_ is None:
            return list(range(len(self.actors)))
        return [i for i in self.crashable_ if i < len(self.actors)]

    def property(self, *args):
        """Two roles, as in the reference: with one argument, the ``Model``
        lookup (`src/lib.rs:218-225`); with three, the builder method
        adding a property (`model.rs:119-125`)."""
        if len(args) == 1:
            return super().property(args[0])
        expectation, name, condition = args
        self.properties_.append(Property(expectation, name, condition))
        return self

    def record_msg_in(self, fn: Callable) -> "ActorModel":
        self.record_msg_in_ = fn
        return self

    def record_msg_out(self, fn: Callable) -> "ActorModel":
        self.record_msg_out_ = fn
        return self

    def within_boundary_fn(self, fn: Callable) -> "ActorModel":
        self.within_boundary_ = fn
        return self

    # --- command processing (`model.rs:157-184`) --------------------------
    def _process_commands(self, id: Id, out: Out, actor_states: list,
                          network: Network, is_timer_set: list,
                          history: Any) -> Tuple[Network, Any]:
        index = int(id)
        for command in out:
            if isinstance(command, Send):
                env = Envelope(src=id, dst=command.dst, msg=command.msg)
                new_history = self.record_msg_out_(self.cfg, history, env)
                if new_history is not None:
                    history = new_history
                network = network.send(env)
            elif isinstance(command, SetTimer):
                while len(is_timer_set) <= index:
                    is_timer_set.append(False)
                is_timer_set[index] = True
            elif isinstance(command, CancelTimer):
                is_timer_set[index] = False
            else:
                raise TypeError(f"unknown command {command!r}")
        return network, history

    # --- Model implementation (`model.rs:187-494`) ------------------------
    def init_states(self) -> List[ActorModelState]:
        actor_states: list = []
        network = self.init_network_
        is_timer_set = [False] * len(self.actors)
        history = self.init_history
        for index, actor in enumerate(self.actors):
            id = Id(index)
            out = Out()
            state = actor.on_start(id, out)
            actor_states.append(state)
            network, history = self._process_commands(
                id, out, actor_states, network, is_timer_set, history)
        return [ActorModelState(
            actor_states=tuple(actor_states), network=network,
            is_timer_set=tuple(is_timer_set), history=history,
            crashes=((0,) * len(self.actors) if self.max_crashes_
                     else None))]

    def actions(self, state: ActorModelState, actions: List) -> None:
        # iter_deliverable already yields exactly one head per ordered
        # channel (`network.rs:157-170`), so no per-channel dedup is needed
        for env in state.network.iter_deliverable():
            # option 1: message is lost
            if self.lossy_network_:
                actions.append(Drop(env))
            # option 2: message is delivered (ignored if recipient DNE or
            # is down — a crashed actor's messages wait in the network)
            if int(env.dst) < len(self.actors) \
                    and not isinstance(state.actor_states[int(env.dst)],
                                       Down):
                actions.append(Deliver(src=env.src, dst=env.dst,
                                       msg=env.msg))
        # option 3: actor timeout
        for index, is_scheduled in enumerate(state.is_timer_set):
            if is_scheduled \
                    and not isinstance(state.actor_states[index], Down):
                actions.append(Timeout(Id(index)))
        # options 4/5: crash–restart fault injection
        if self.max_crashes_:
            for index in self._crashable_indices():
                if isinstance(state.actor_states[index], Down):
                    actions.append(Restart(Id(index)))
                elif state.crashes[index] < self.max_crashes_:
                    actions.append(Crash(Id(index)))

    # --- crash–restart projection hooks ----------------------------------
    # PackedActorModel overrides both for bit-parity with the device
    # kernels (the durable projection is the packed word mask there).
    def _crash_durable(self, index: int, state: Any) -> Any:
        """What survives actor ``index`` crashing in ``state``."""
        return self.actors[index].durable(Id(index), state)

    def _restart_state(self, index: int, durable: Any, out: Out) -> Any:
        """The post-restart state (commands land in ``out``)."""
        return self.actors[index].on_restart(Id(index), durable, out)

    def next_state(self, last_sys_state: ActorModelState,
                   action: Any) -> Optional[ActorModelState]:
        if isinstance(action, Drop):
            return ActorModelState(
                actor_states=last_sys_state.actor_states,
                network=last_sys_state.network.on_drop(action.envelope),
                is_timer_set=last_sys_state.is_timer_set,
                history=last_sys_state.history,
                crashes=last_sys_state.crashes)

        if isinstance(action, Crash):
            index = int(action.id)
            state = last_sys_state.actor_states[index]
            if isinstance(state, Down) \
                    or last_sys_state.crashes[index] >= self.max_crashes_:
                return None
            actor_states = list(last_sys_state.actor_states)
            actor_states[index] = Down(self._crash_durable(index, state))
            is_timer_set = list(last_sys_state.is_timer_set)
            is_timer_set[index] = False  # the pending timer dies too
            crashes = list(last_sys_state.crashes)
            crashes[index] += 1
            return ActorModelState(
                actor_states=tuple(actor_states),
                network=last_sys_state.network,
                is_timer_set=tuple(is_timer_set),
                history=last_sys_state.history, crashes=tuple(crashes))

        if isinstance(action, Restart):
            index = int(action.id)
            down = last_sys_state.actor_states[index]
            if not isinstance(down, Down):
                return None
            out = Out()
            actor_states = list(last_sys_state.actor_states)
            actor_states[index] = self._restart_state(
                index, down.durable, out)
            is_timer_set = list(last_sys_state.is_timer_set)
            network, history = self._process_commands(
                Id(index), out, actor_states, last_sys_state.network,
                is_timer_set, last_sys_state.history)
            return ActorModelState(
                actor_states=tuple(actor_states), network=network,
                is_timer_set=tuple(is_timer_set), history=history,
                crashes=last_sys_state.crashes)

        if isinstance(action, Deliver):
            index = int(action.dst)
            if index >= len(last_sys_state.actor_states):
                return None  # not all messages can be delivered
            last_actor_state = last_sys_state.actor_states[index]
            if isinstance(last_actor_state, Down):
                return None  # recipient is crashed; the message waits
            out = Out()
            next_actor_state = self.actors[index].on_msg(
                action.dst, last_actor_state, action.src, action.msg, out)
            if is_no_op(next_actor_state, out):
                return None
            env = Envelope(src=action.src, dst=action.dst, msg=action.msg)
            history = self.record_msg_in_(
                self.cfg, last_sys_state.history, env)
            if history is None:
                history = last_sys_state.history

            actor_states = list(last_sys_state.actor_states)
            if next_actor_state is not None:
                actor_states[index] = next_actor_state
            network = last_sys_state.network.on_deliver(env)
            is_timer_set = list(last_sys_state.is_timer_set)
            network, history = self._process_commands(
                action.dst, out, actor_states, network, is_timer_set,
                history)
            return ActorModelState(
                actor_states=tuple(actor_states), network=network,
                is_timer_set=tuple(is_timer_set), history=history,
                crashes=last_sys_state.crashes)

        if isinstance(action, Timeout):
            index = int(action.id)
            if isinstance(last_sys_state.actor_states[index], Down):
                return None  # the crash cancelled the timer
            out = Out()
            next_actor_state = self.actors[index].on_timeout(
                action.id, last_sys_state.actor_states[index], out)
            keep_timer = any(isinstance(c, SetTimer) for c in out)
            if is_no_op(next_actor_state, out) and keep_timer:
                return None
            actor_states = list(last_sys_state.actor_states)
            if next_actor_state is not None:
                actor_states[index] = next_actor_state
            is_timer_set = list(last_sys_state.is_timer_set)
            is_timer_set[index] = False  # timer is no longer valid
            network, history = self._process_commands(
                action.id, out, actor_states, last_sys_state.network,
                is_timer_set, last_sys_state.history)
            return ActorModelState(
                actor_states=tuple(actor_states), network=network,
                is_timer_set=tuple(is_timer_set), history=history,
                crashes=last_sys_state.crashes)

        raise TypeError(f"unknown action {action!r}")

    def properties(self) -> List[Property]:
        return list(self.properties_)

    def within_boundary(self, state: ActorModelState) -> bool:
        return self.within_boundary_(self.cfg, state)

    def as_svg(self, path) -> Optional[str]:
        """Sequence diagram for a path through the actor system: one
        vertical lifeline per actor, an arrow per message delivery from
        its send event, a circle per timeout (`model.rs:383-485`). Used by
        the Explorer's states endpoint."""
        def plot(x, y):
            return x * 100, y * 30

        actor_count = len(path.last_state().actor_states)
        steps = path.into_vec()
        svg_w, svg_h = plot(actor_count, len(steps))
        svg_w += 300  # extra width for event labels
        parts = [
            f"<svg version='1.1' baseProfile='full' width='{svg_w}' "
            f"height='{svg_h}' viewBox='-20 -20 {svg_w + 20} {svg_h + 20}'"
            " xmlns='http://www.w3.org/2000/svg'>",
            "<defs><marker class='svg-event-shape' id='arrow' "
            "markerWidth='12' markerHeight='10' refX='12' refY='5' "
            "orient='auto'><polygon points='0 0, 12 5, 0 10' />"
            "</marker></defs>",
        ]

        for i in range(actor_count):
            x1, y1 = plot(i, 0)
            x2, y2 = plot(i, len(steps))
            parts.append(
                f"<line x1='{x1}' y1='{y1}' x2='{x2}' y2='{y2}' "
                "class='svg-actor-timeline' />")
            parts.append(f"<text x='{x1}' y='{y1}' "
                         f"class='svg-actor-label'>{i}</text>")

        def record_sends(state, index, run_handler):
            """Re-run the handler to learn which sends this event emits
            (so later deliveries can draw arrows from this row)."""
            if index >= len(state.actor_states):
                return
            out = Out()
            run_handler(state.actor_states[index], out)
            for command in out:
                if isinstance(command, Send):
                    send_time[(Id(index), command.dst,
                               _msg_key(command.msg))] = time

        def _msg_key(msg):
            try:
                hash(msg)
                return msg
            except TypeError:
                return repr(msg)

        # arrows for deliveries, circles for timeouts
        send_time: dict = {}
        for t, (state, action) in enumerate(steps):
            time = t + 1  # the action lands on the next row
            if isinstance(action, Deliver):
                src_time = send_time.get(
                    (action.src, action.dst, _msg_key(action.msg)), 0)
                x1, y1 = plot(int(action.src), src_time)
                x2, y2 = plot(int(action.dst), time)
                parts.append(
                    f"<line x1='{x1}' x2='{x2}' y1='{y1}' y2='{y2}' "
                    "marker-end='url(#arrow)' class='svg-event-line' />")
                index = int(action.dst)
                record_sends(
                    state, index,
                    lambda st, out: self.actors[index].on_msg(
                        action.dst, st, action.src, action.msg, out))
            elif isinstance(action, Timeout):
                x, y = plot(int(action.id), time)
                parts.append(f"<circle cx='{x}' cy='{y}' r='10' "
                             "class='svg-event-shape' />")
                index = int(action.id)
                record_sends(
                    state, index,
                    lambda st, out: self.actors[index].on_timeout(
                        action.id, st, out))

        # labels last so they draw over the shapes
        for t, (_state, action) in enumerate(steps):
            time = t + 1
            if isinstance(action, Deliver):
                x, y = plot(int(action.dst), time)
                label = _xml_escape(repr(action.msg))
                parts.append(f"<text x='{x}' y='{y}' "
                             f"class='svg-event-label'>{label}</text>")
            elif isinstance(action, Timeout):
                x, y = plot(int(action.id), time)
                parts.append(f"<text x='{x}' y='{y}' "
                             "class='svg-event-label'>Timeout</text>")
            elif isinstance(action, (Crash, Restart)):
                x, y = plot(int(action.id), time)
                label = "Crash" if isinstance(action, Crash) else "Restart"
                parts.append(f"<rect x='{x - 8}' y='{y - 8}' width='16' "
                             "height='16' class='svg-event-shape' />")
                parts.append(f"<text x='{x}' y='{y}' "
                             f"class='svg-event-label'>{label}</text>")

        parts.append("</svg>")
        return "".join(parts)

    def format_action(self, action: Any) -> str:
        if isinstance(action, Deliver):
            return f"{action.src!r} → {action.msg!r} → {action.dst!r}"
        if isinstance(action, Crash):
            return f"Crash({int(action.id)})"
        if isinstance(action, Restart):
            return f"Restart({int(action.id)})"
        return repr(action)
