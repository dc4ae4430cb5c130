"""Actor test fixtures: the ping_pong pair and the timer counters.

A copy of ``stateright_tpu/actor/test_util.py`` (the Rust crate's
``src/actor/actor_test_util.rs:4-96``) with its device half in batched
torch: two actors bouncing an incrementing counter, with optional (in,
out) message-count history and six properties (two deliberately
falsifiable), and N actors counting their own timer firings. Their
exact state counts anchor the lossy and duplicating network lanes and
the Timeout lanes: lossy duplicating max 5 -> 4,094 unique states;
lossless non-duplicating max 5 -> 11 (`src/actor/model.rs:611`,
`:642`); TimerCount(3, 2) -> 27.

On the card :class:`PackedPingPong` runs ``csrc/ping_pong.cuh`` (one
instantiation for the four network quadrants: ``dup`` and ``lossy`` are
kernel parameters) and :class:`PackedTimerCount` ``csrc/timer_count.cuh``
(one Timeout lane per actor); ``cuda_spec`` names them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..core import Expectation
from ..models.packed import check_cuda_model
from ..ops.words import M32, u64
from .core import Actor, Down, Id, Out
from .model import ActorModel
from .packed import PackedActorModel


def _count(state) -> int:
    """A crashed counter reads as its durable content (0 when volatile) —
    the host view of the device's wiped words, so crash-injected variants
    of these fixtures keep host/device property parity."""
    if isinstance(state, Down):
        return _count(state.durable) if state.durable is not None else 0
    return state


@dataclass(frozen=True)
class Ping:
    value: int


@dataclass(frozen=True)
class Pong:
    value: int


class PingPongActor(Actor):
    def __init__(self, serve_to: Optional[Id]):
        self.serve_to = serve_to

    def on_start(self, id: Id, o: Out) -> int:
        if self.serve_to is not None:
            o.send(self.serve_to, Ping(0))
        return 0

    def on_msg(self, id: Id, state: int, src: Id, msg: Any,
               o: Out) -> Optional[int]:
        if isinstance(msg, Pong) and state == msg.value:
            o.send(src, Ping(msg.value + 1))
            return state + 1
        if isinstance(msg, Ping) and state == msg.value:
            o.send(src, Pong(msg.value))
            return state + 1
        return None


@dataclass
class PingPongCfg:
    maintains_history: bool
    max_nat: int

    def into_model(self) -> ActorModel:
        def record_msg_in(cfg, history, env):
            if cfg.maintains_history:
                msg_in, msg_out = history
                return (msg_in + 1, msg_out)
            return None

        def record_msg_out(cfg, history, env):
            if cfg.maintains_history:
                msg_in, msg_out = history
                return (msg_in, msg_out + 1)
            return None

        return (ActorModel(cfg=self, init_history=(0, 0))
                .actor(PingPongActor(serve_to=Id(1)))
                .actor(PingPongActor(serve_to=None))
                .record_msg_in(record_msg_in)
                .record_msg_out(record_msg_out)
                .within_boundary_fn(
                    lambda cfg, state: all(
                        count <= cfg.max_nat
                        for count in state.actor_states))
                .property(
                    Expectation.ALWAYS, "delta within 1",
                    lambda _, state: (max(state.actor_states)
                                      - min(state.actor_states)) <= 1)
                .property(
                    Expectation.SOMETIMES, "can reach max",
                    lambda model, state: any(
                        count == model.cfg.max_nat
                        for count in state.actor_states))
                .property(
                    Expectation.EVENTUALLY, "must reach max",
                    lambda model, state: any(
                        count == model.cfg.max_nat
                        for count in state.actor_states))
                .property(
                    # falsifiable due to the boundary
                    Expectation.EVENTUALLY, "must exceed max",
                    lambda model, state: any(
                        count == model.cfg.max_nat + 1
                        for count in state.actor_states))
                .property(
                    Expectation.ALWAYS, "#in <= #out",
                    lambda _, state: state.history[0] <= state.history[1])
                .property(
                    Expectation.EVENTUALLY, "#out <= #in + 1",
                    lambda _, state: state.history[1]
                    <= state.history[0] + 1))


def _no_send(n: int, msg_width: int, device):
    zero = torch.zeros((n,), dtype=torch.int64, device=device)
    return (zero, torch.zeros((n, msg_width), dtype=torch.int64,
                              device=device),
            torch.zeros((n,), dtype=torch.bool, device=device))


class PackedPingPong(PackedActorModel):
    """Device encoding of the ping_pong fixture — the workload that pins
    lossy/duplicating network semantics on the device engine (oracle
    counts `src/actor/model.rs:611`, `:642`). History is not maintained
    (the pinned configs use ``maintains_history=False``)."""

    def __init__(self, max_nat: int, lossy: bool = False,
                 duplicating: bool = True, net_capacity: int = 16):
        from .network import Network

        super().__init__(cfg=self, init_history=(0, 0))
        self.max_nat = max_nat
        self.actor(PingPongActor(serve_to=Id(1)))
        self.actor(PingPongActor(serve_to=None))
        self.init_network(Network.new_unordered_duplicating()
                          if duplicating
                          else Network.new_unordered_nonduplicating())
        self.lossy_network(lossy)
        self.within_boundary_fn(
            lambda cfg, state: all(_count(c) <= cfg.max_nat
                                   for c in state.actor_states))
        self.property(Expectation.ALWAYS, "delta within 1",
                      lambda _, s: (max(_count(c)
                                        for c in s.actor_states)
                                    - min(_count(c)
                                          for c in s.actor_states)) <= 1)
        self.property(Expectation.SOMETIMES, "can reach max",
                      lambda m, s: any(_count(c) == m.cfg.max_nat
                                       for c in s.actor_states))
        self.property(Expectation.EVENTUALLY, "must reach max",
                      lambda m, s: any(_count(c) == m.cfg.max_nat
                                       for c in s.actor_states))
        self.property(Expectation.EVENTUALLY, "must exceed max",
                      lambda m, s: any(_count(c) == m.cfg.max_nat + 1
                                       for c in s.actor_states))
        self.actor_widths = [1, 1]
        self.msg_width = 1
        self.net_capacity = net_capacity
        self.max_sends = 1
        self.history_width = 0
        self.finalize_layout()

    def cache_key(self):
        return ("ping_pong", self.max_nat, self.net_capacity,
                self._net_dup)

    #: the hooks ``csrc/ping_pong.cuh`` computes in place of a subclass's
    CUDA_HOOKS = ("packed_deliver", "packed_boundary", "encode_actor",
                  "encode_msg", "packed_on_restart", "_restart_state")

    def cuda_spec(self, symmetry: bool = False):
        """``("ping_pong", (max_nat, net_capacity, duplicating, lossy))``:
        the kernel runs ``csrc/ping_pong.cuh`` (the narrow K1, a thread a
        lane) for up to 16 network slots on either unordered network,
        lossy or not. Refused: symmetry (no representative), crashes,
        timers, and a subclass that changes the step, the encoding, the
        properties or the boundary."""
        cls = type(self).__name__
        if symmetry:
            raise NotImplementedError(f"{cls} has no packed_representative")
        if self.max_crashes_:
            raise NotImplementedError(
                "csrc/ping_pong.cuh has no crash/restart lanes; check this "
                f"{cls} under crash_restart() with spawn_bfs() or on the "
                "CPU (gpu_options(device='cpu'))")
        if self.device_timers:
            raise NotImplementedError(
                "csrc/ping_pong.cuh has no Timeout lanes (device timers)")
        if not 1 <= self.net_capacity <= 16 \
                or not 0 <= self.max_nat < 1 << 31:
            raise NotImplementedError(
                "csrc/ping_pong.cuh takes 1 to 16 network slots and a "
                "max_nat below 2**31")
        for name in self.CUDA_HOOKS:
            if getattr(type(self), name) is not getattr(PackedPingPong,
                                                        name):
                raise NotImplementedError(
                    f"{cls} overrides {name}; the CUDA step kernel runs "
                    "PackedPingPong's own (csrc/ping_pong.cuh)")
        lossy = bool(self.lossy_network_)
        check_cuda_model(
            self, PackedPingPong, "ping_pong.cuh",
            (("delta within 1", Expectation.ALWAYS),
             ("can reach max", Expectation.SOMETIMES),
             ("must reach max", Expectation.EVENTUALLY),
             ("must exceed max", Expectation.EVENTUALLY)),
            3 + 3 * self.net_capacity,
            self.net_capacity * (2 if lossy else 1), symmetry)
        return "ping_pong", (self.max_nat, self.net_capacity,
                             int(self._net_dup), int(lossy))

    # --- packing ----------------------------------------------------------
    _T_PING, _T_PONG = 1, 2

    def encode_actor(self, index, state):
        return [int(state)]

    def decode_actor(self, index, words):
        return int(words[0])

    def encode_msg(self, msg):
        if isinstance(msg, Ping):
            return [(self._T_PING << 8) | msg.value]
        assert isinstance(msg, Pong)
        return [(self._T_PONG << 8) | msg.value]

    def decode_msg(self, words):
        mtype, value = words[0] >> 8, words[0] & 0xFF
        return Ping(value) if mtype == self._T_PING else Pong(value)

    # --- the batched hooks (the plain versions of csrc/ping_pong.cuh) -----
    def packed_deliver(self, actors, src, dst, msg):
        sel = torch.arange(2, device=actors.device)[None, :] == dst[:, None]
        w = torch.where(sel, actors, 0).sum(dim=1)
        mtype = msg[:, 0] >> 8
        value = msg[:, 0] & 0xFF
        changed = (w == value) & ((mtype == self._T_PING)
                                  | (mtype == self._T_PONG))
        new_actors = torch.where(sel & changed[:, None], (w + 1)[:, None],
                                 actors) & M32
        # Pong(v) -> Ping(v+1); Ping(v) -> Pong(v)  (test_util.rs:20-33)
        reply = torch.where(mtype == self._T_PONG,
                            (self._T_PING << 8) | (value + 1),
                            (self._T_PONG << 8) | value)
        return new_actors, changed, [(src, reply[:, None], changed)]

    def packed_properties(self, words):
        w = u64(words)
        a, b = w[:, 0], w[:, 1]
        mx = self.max_nat
        delta = (torch.maximum(a, b) - torch.minimum(a, b)) <= 1
        reach = (a == mx) | (b == mx)
        exceed = (a == mx + 1) | (b == mx + 1)
        return torch.stack([delta, reach, reach, exceed], dim=1)

    def packed_boundary(self, words):
        mx = self.max_nat
        return (words[:, 0] <= mx) & (words[:, 1] <= mx)


class TimerCountActor(Actor):
    """Counts timer firings: each ``on_timeout`` increments and re-sets
    the timer until ``max_nat``. The interleavings of N independent
    counters exercise ``Timeout`` actions exhaustively."""

    def __init__(self, max_nat: int):
        self.max_nat = max_nat

    def on_start(self, id: Id, o: Out) -> int:
        if self.max_nat > 0:
            o.set_timer((0.0, 0.0))
        return 0

    def on_msg(self, id, state, src, msg, o):
        return None

    def on_timeout(self, id: Id, state: int, o: Out):
        nxt = state + 1
        if nxt < self.max_nat:
            o.set_timer((0.0, 0.0))
        return nxt


class PackedTimerCount(PackedActorModel):
    """Device encoding of N :class:`TimerCountActor`s — the fixture
    pinning the Timeout lanes on the device engine."""

    device_timers = True

    def __init__(self, n_actors: int, max_nat: int):
        from .network import Network

        super().__init__(cfg=self, init_history=None)
        self.max_nat = max_nat
        self.n_actors = n_actors
        for _ in range(n_actors):
            self.actor(TimerCountActor(max_nat))
        self.init_network(Network.new_unordered_nonduplicating())
        self.property(Expectation.ALWAYS, "bounded",
                      lambda m, s: all(_count(c) <= m.cfg.max_nat
                                       for c in s.actor_states))
        self.property(Expectation.SOMETIMES, "all max",
                      lambda m, s: all(_count(c) == m.cfg.max_nat
                                       for c in s.actor_states))
        self.actor_widths = [1] * n_actors
        self.msg_width = 1
        self.net_capacity = 1  # the network stays empty
        self.max_sends = 1
        self.history_width = 0
        self.finalize_layout()

    def cache_key(self):
        return ("timer_count", self.n_actors, self.max_nat)

    #: the hooks ``csrc/timer_count.cuh`` computes in place of a subclass's
    CUDA_HOOKS = ("packed_deliver", "packed_on_timeout", "packed_boundary",
                  "encode_actor", "packed_on_restart", "_restart_state")

    def cuda_spec(self, symmetry: bool = False):
        """``("timer_count", (n_actors, max_nat))``: the kernel runs
        ``csrc/timer_count.cuh`` (the narrow K1, a thread a lane: one
        delivery lane, never valid, and one Timeout lane per actor) for
        up to 32 actors on the non-duplicating network. Refused:
        symmetry, a lossy network, crashes, and a subclass that changes
        the step, the encoding or the properties."""
        cls = type(self).__name__
        if symmetry:
            raise NotImplementedError(f"{cls} has no packed_representative")
        if self.lossy_network_:
            raise NotImplementedError(
                "csrc/timer_count.cuh has no lossy drop lanes; check this "
                f"{cls} on the CPU (gpu_options(device='cpu'))")
        if self.max_crashes_:
            raise NotImplementedError(
                "csrc/timer_count.cuh has no crash/restart lanes; check "
                f"this {cls} under crash_restart() on the CPU "
                "(gpu_options(device='cpu'))")
        if self._net_dup or self._net_ordered or self.net_capacity != 1 \
                or not 1 <= self.n_actors <= 32 \
                or not 0 <= self.max_nat < 1 << 31:
            raise NotImplementedError(
                "csrc/timer_count.cuh takes 1 to 32 actors (the timer "
                "word's bits), one slot of the non-duplicating network and "
                "a max_nat below 2**31")
        for name in self.CUDA_HOOKS:
            if getattr(type(self), name) is not getattr(PackedTimerCount,
                                                        name):
                raise NotImplementedError(
                    f"{cls} overrides {name}; the CUDA step kernel runs "
                    "PackedTimerCount's own (csrc/timer_count.cuh)")
        check_cuda_model(
            self, PackedTimerCount, "timer_count.cuh",
            (("bounded", Expectation.ALWAYS),
             ("all max", Expectation.SOMETIMES)),
            self.n_actors + 4, self.n_actors + 1, symmetry)
        return "timer_count", (self.n_actors, self.max_nat)

    def encode_actor(self, index, state):
        return [int(state)]

    def decode_actor(self, index, words):
        return int(words[0])

    def encode_msg(self, msg):  # pragma: no cover - network unused
        return [0]

    def decode_msg(self, words):  # pragma: no cover - network unused
        return None

    # --- the batched hooks (the plain versions of csrc/timer_count.cuh) ---
    def packed_deliver(self, actors, src, dst, msg):
        n = actors.shape[0]
        no = torch.zeros((n,), dtype=torch.bool, device=actors.device)
        return actors, no, [_no_send(n, self.msg_width, actors.device)]

    def packed_on_timeout(self, actors, aidx):
        n = actors.shape[0]
        sel = torch.arange(self.n_actors, device=actors.device)[None, :] \
            == aidx[:, None]
        c = torch.where(sel, actors, 0).sum(dim=1)
        new_actors = torch.where(sel, (c + 1)[:, None], actors) & M32
        keep = ((c + 1) & M32) < self.max_nat
        yes = torch.ones((n,), dtype=torch.bool, device=actors.device)
        return new_actors, yes, [_no_send(n, self.msg_width,
                                          actors.device)], keep

    def packed_properties(self, words):
        counts = u64(words)[:, :self.n_actors]
        mx = self.max_nat
        return torch.stack([(counts <= mx).all(dim=1),
                            (counts == mx).all(dim=1)], dim=1)
