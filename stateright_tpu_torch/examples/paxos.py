"""Single Decree Paxos — the north-star benchmark workload.

A copy of ``stateright_tpu/examples/paxos.py``, a behavioural port of
the Rust crate's `examples/paxos.rs`: three servers run
single-decree Paxos under the register protocol; scripted clients put then
get; a :class:`LinearizabilityTester` rides in the model history and an
``always linearizable`` property queries it per state. Oracle: 2 clients +
3 servers = 16,668 unique states (`paxos.rs:291`, `:311`).

Run: ``python -m stateright_tpu_torch.examples.paxos check [CLIENT_COUNT]
[NETWORK]`` (the host BFS) or ``... check-gpu [CLIENT_COUNT] [--cpu]
[--no-race]`` (:class:`~stateright_tpu_torch.examples.paxos_packed.
PackedPaxos` on the GPU engine). ``explore`` and ``spawn`` (the Explorer
and the UDP runtime) are not ported.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, Optional, Tuple

from ..actor import ActorModel, Id, Network, Out, majority, model_peers
from ..actor.core import Actor
from ..actor.register import (Get, GetOk, Internal, Put, PutOk,
                              RegisterClient, RegisterServer,
                              record_invocations, record_returns)
from ..core import Expectation
from ..semantics import LinearizabilityTester, Register
from . import not_ported

# Ballot = (round, leader id); Proposal = (request id, requester, value).
Ballot = Tuple[int, int]
Proposal = Tuple[int, int, Any]


@dataclass(frozen=True)
class Prepare:
    ballot: Ballot


@dataclass(frozen=True)
class Prepared:
    ballot: Ballot
    last_accepted: Optional[Tuple[Ballot, Proposal]]


@dataclass(frozen=True)
class Accept:
    ballot: Ballot
    proposal: Proposal


@dataclass(frozen=True)
class Accepted:
    ballot: Ballot


@dataclass(frozen=True)
class Decided:
    ballot: Ballot
    proposal: Proposal


@dataclass(frozen=True)
class PaxosState:
    ballot: Ballot
    # leader state
    proposal: Optional[Proposal]
    prepares: tuple  # sorted ((id, last_accepted), ...)
    accepts: frozenset
    # acceptor state
    accepted: Optional[Tuple[Ballot, Proposal]]
    is_decided: bool


def _accepted_key(accepted):
    """Rust orders ``Option<(Ballot, Proposal)>`` with ``None`` least."""
    return (0,) if accepted is None else (1, accepted)


class PaxosActor(Actor):
    def __init__(self, peer_ids):
        self.peer_ids = list(peer_ids)

    def on_start(self, id: Id, o: Out) -> PaxosState:
        return PaxosState(ballot=(0, 0), proposal=None, prepares=(),
                          accepts=frozenset(), accepted=None,
                          is_decided=False)

    def on_msg(self, id: Id, state: PaxosState, src: Id, msg: Any,
               o: Out) -> Optional[PaxosState]:
        if state.is_decided:
            if isinstance(msg, Get):
                # Deliberately no reply when undecided (paxos.rs:119-126).
                assert state.accepted is not None, \
                    "decided but lacks accepted state"
                _b, (_req_id, _src, value) = state.accepted
                o.send(src, GetOk(msg.request_id, value))
            return None

        if isinstance(msg, Put) and state.proposal is None:
            ballot = (state.ballot[0] + 1, int(id))
            # Simulate `Prepare` + `Prepared` self-sends.
            prepares = ((int(id), state.accepted),)
            o.broadcast(self.peer_ids, Internal(Prepare(ballot)))
            return PaxosState(
                ballot=ballot, proposal=(msg.request_id, int(src), msg.value),
                prepares=prepares, accepts=frozenset(),
                accepted=state.accepted, is_decided=False)

        if isinstance(msg, Internal):
            inner = msg.msg
            if isinstance(inner, Prepare) and state.ballot < inner.ballot:
                o.send(src, Internal(Prepared(
                    ballot=inner.ballot, last_accepted=state.accepted)))
                return PaxosState(
                    ballot=inner.ballot, proposal=state.proposal,
                    prepares=state.prepares, accepts=state.accepts,
                    accepted=state.accepted, is_decided=False)

            if isinstance(inner, Prepared) and inner.ballot == state.ballot:
                prepares = dict(state.prepares)
                prepares[int(src)] = inner.last_accepted
                prepares_t = tuple(sorted(prepares.items()))
                if len(prepares) == majority(len(self.peer_ids) + 1):
                    # leadership handoff: favor the most recently accepted
                    # proposal from the prepare quorum (paxos.rs:157-180)
                    newest = max(prepares.values(), key=_accepted_key)
                    proposal = newest[1] if newest is not None \
                        else state.proposal
                    assert proposal is not None, "proposal expected"
                    o.broadcast(self.peer_ids, Internal(Accept(
                        ballot=inner.ballot, proposal=proposal)))
                    return PaxosState(
                        ballot=state.ballot, proposal=proposal,
                        prepares=prepares_t,
                        accepts=frozenset({int(id)}),
                        accepted=(inner.ballot, proposal),
                        is_decided=False)
                return PaxosState(
                    ballot=state.ballot, proposal=state.proposal,
                    prepares=prepares_t, accepts=state.accepts,
                    accepted=state.accepted, is_decided=False)

            if isinstance(inner, Accept) and state.ballot <= inner.ballot:
                o.send(src, Internal(Accepted(inner.ballot)))
                return PaxosState(
                    ballot=inner.ballot, proposal=state.proposal,
                    prepares=state.prepares, accepts=state.accepts,
                    accepted=(inner.ballot, inner.proposal),
                    is_decided=False)

            if isinstance(inner, Accepted) and inner.ballot == state.ballot:
                accepts = state.accepts | {int(src)}
                if len(accepts) == majority(len(self.peer_ids) + 1):
                    proposal = state.proposal
                    assert proposal is not None, "proposal expected"
                    o.broadcast(self.peer_ids, Internal(Decided(
                        ballot=inner.ballot, proposal=proposal)))
                    request_id, requester_id, _ = proposal
                    o.send(Id(requester_id), PutOk(request_id))
                    return PaxosState(
                        ballot=state.ballot, proposal=state.proposal,
                        prepares=state.prepares, accepts=accepts,
                        accepted=state.accepted, is_decided=True)
                return PaxosState(
                    ballot=state.ballot, proposal=state.proposal,
                    prepares=state.prepares, accepts=accepts,
                    accepted=state.accepted, is_decided=False)

            if isinstance(inner, Decided):
                return PaxosState(
                    ballot=inner.ballot, proposal=state.proposal,
                    prepares=state.prepares, accepts=state.accepts,
                    accepted=(inner.ballot, inner.proposal),
                    is_decided=True)
        return None


@dataclass
class PaxosModelCfg:
    client_count: int
    server_count: int
    network: Network

    def into_model(self) -> ActorModel:
        model = ActorModel(
            cfg=self,
            init_history=LinearizabilityTester(Register('\0')))
        for i in range(self.server_count):
            model.actor(RegisterServer(PaxosActor(
                model_peers(i, self.server_count))))
        for _ in range(self.client_count):
            model.actor(RegisterClient(
                put_count=1, server_count=self.server_count))

        def value_chosen(_model, state):
            for env in state.network.iter_deliverable():
                if isinstance(env.msg, GetOk) and env.msg.value != '\0':
                    return True
            return False

        return (model
                .init_network(self.network)
                .property(Expectation.ALWAYS, "linearizable",
                          lambda _, state:
                          state.history.serialized_history() is not None)
                .property(Expectation.SOMETIMES, "value chosen",
                          value_chosen)
                .record_msg_in(record_returns)
                .record_msg_out(record_invocations))


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    module = "stateright_tpu_torch.examples.paxos"
    flags = {"--cpu": ("device", "cpu"), "--no-race": ("race", False)}
    opts = dict(flags[a] for a in args if a in flags)
    args = [a for a in args if a not in flags]
    cmd = args[0] if args else None
    client_count = int(args[1]) if len(args) > 1 else 2
    if cmd == "check":
        network = Network.from_name(args[2]) if len(args) > 2 \
            else Network.new_unordered_nonduplicating()
        print(f"Model checking Single Decree Paxos with {client_count} "
              "clients.")
        (PaxosModelCfg(client_count=client_count, server_count=3,
                       network=network)
         .into_model().checker().spawn_bfs().report(sys.stdout))
        return 0
    if cmd == "check-gpu":
        from .paxos_packed import PackedPaxos
        print(f"Model checking Single Decree Paxos with {client_count} "
              "clients on the GPU engine.")
        (PackedPaxos(client_count).checker().gpu_options(**opts)
         .spawn_gpu().report(sys.stdout))
        return 0
    if cmd in ("explore", "spawn"):
        return not_ported(module, cmd)
    print("USAGE:")
    print(f"  python -m {module} check [CLIENT_COUNT] [NETWORK]")
    print(f"  python -m {module} check-gpu [CLIENT_COUNT] [--cpu] "
          "[--no-race]")
    print("  (explore, spawn: not ported)")
    print(f"NETWORK: {' | '.join(Network.names())}")
    return 2


if __name__ == "__main__":
    sys.exit(main())
