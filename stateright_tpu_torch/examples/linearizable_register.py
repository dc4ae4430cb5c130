"""ABD quorum-replicated linearizable register.

A copy of ``stateright_tpu/examples/linearizable_register.py`` (the Rust
crate's `examples/linearizable-register.rs`): the Attiya/Bar-Noy/Dolev
algorithm ("Sharing Memory Robustly in Message-Passing Systems") — a
two-phase (query-quorum then record-quorum) read/write register that
stays linearizable as long as a majority of servers is reachable.
Oracle: 2 clients + 2 servers = 544 unique states
(`linearizable-register.rs:258`, `:281`). The packed model is
:mod:`stateright_tpu_torch.examples.abd_packed`.

Run: ``python -m stateright_tpu_torch.examples.linearizable_register check [N] [NETWORK]``
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, FrozenSet, Optional, Tuple

from ..actor import ActorModel, Id, Network, Out, majority, model_peers
from ..actor.core import Actor
from ..actor.register import (Get, GetOk, Internal, Put, PutOk,
                              RegisterClient, RegisterServer,
                              record_invocations, record_returns)
from ..core import Expectation
from ..semantics import LinearizabilityTester, Register

# Seq = (logical clock, server id); higher wins, ids break ties.
Seq = Tuple[int, int]


# --- protocol messages (`linearizable-register.rs:29-36`) -------------------

@dataclass(frozen=True)
class Query:
    request_id: int


@dataclass(frozen=True)
class AckQuery:
    request_id: int
    seq: Seq
    value: Any


@dataclass(frozen=True)
class Record:
    request_id: int
    seq: Seq
    value: Any


@dataclass(frozen=True)
class AckRecord:
    request_id: int


# --- server state (`linearizable-register.rs:38-50`) ------------------------

@dataclass(frozen=True)
class Phase1:
    request_id: int
    requester_id: int
    write: Optional[Any]  # None = this is a read
    responses: FrozenSet[Tuple[int, Tuple[Seq, Any]]]


@dataclass(frozen=True)
class Phase2:
    request_id: int
    requester_id: int
    read: Optional[Any]  # None = this is a write
    acks: FrozenSet[int]


@dataclass(frozen=True)
class AbdState:
    seq: Seq
    val: Any
    phase: Any  # None | Phase1 | Phase2


class AbdActor(Actor):
    """One ABD replica (`linearizable-register.rs:57-188`)."""

    def __init__(self, peers):
        self.peers = list(peers)

    def _quorum(self) -> int:
        return majority(len(self.peers) + 1)

    def on_start(self, id: Id, o: Out) -> AbdState:
        return AbdState(seq=(0, int(id)), val='\0', phase=None)

    def on_msg(self, id: Id, state: AbdState, src: Id, msg: Any,
               o: Out) -> Optional[AbdState]:
        if isinstance(msg, (Put, Get)) and state.phase is None:
            # Phase 1: query a quorum for the latest (seq, value)
            write = msg.value if isinstance(msg, Put) else None
            o.broadcast(self.peers, Internal(Query(msg.request_id)))
            responses = frozenset({(int(id), (state.seq, state.val))})
            return AbdState(
                seq=state.seq, val=state.val,
                phase=Phase1(request_id=msg.request_id,
                             requester_id=int(src), write=write,
                             responses=responses))

        if isinstance(msg, Internal):
            inner = msg.msg
            if isinstance(inner, Query):
                o.send(src, Internal(AckQuery(
                    inner.request_id, state.seq, state.val)))
                return None

            if isinstance(inner, AckQuery) \
                    and isinstance(state.phase, Phase1) \
                    and state.phase.request_id == inner.request_id:
                ph = state.phase
                responses = dict(ph.responses)
                responses[int(src)] = (inner.seq, inner.value)
                if len(responses) == self._quorum():
                    # Quorum reached: pick the newest (seq, value) — the
                    # seq's id component makes ties impossible — then move
                    # to phase 2 recording it (or its increment on writes)
                    seq, val = max(responses.values())
                    read = None
                    if ph.write is not None:
                        seq = (seq[0] + 1, int(id))
                        val = ph.write
                    else:
                        read = val
                    o.broadcast(self.peers, Internal(Record(
                        ph.request_id, seq, val)))
                    # self-deliver Record and AckRecord
                    new_seq, new_val = (seq, val) if seq > state.seq \
                        else (state.seq, state.val)
                    return AbdState(
                        seq=new_seq, val=new_val,
                        phase=Phase2(request_id=ph.request_id,
                                     requester_id=ph.requester_id,
                                     read=read,
                                     acks=frozenset({int(id)})))
                return AbdState(
                    seq=state.seq, val=state.val,
                    phase=Phase1(request_id=ph.request_id,
                                 requester_id=ph.requester_id,
                                 write=ph.write,
                                 responses=frozenset(responses.items())))

            if isinstance(inner, Record):
                o.send(src, Internal(AckRecord(inner.request_id)))
                if inner.seq > state.seq:
                    return AbdState(seq=inner.seq, val=inner.value,
                                    phase=state.phase)
                return None

            if isinstance(inner, AckRecord) \
                    and isinstance(state.phase, Phase2) \
                    and state.phase.request_id == inner.request_id \
                    and int(src) not in state.phase.acks:
                ph = state.phase
                acks = ph.acks | {int(src)}
                if len(acks) == self._quorum():
                    if ph.read is not None:
                        o.send(Id(ph.requester_id),
                               GetOk(ph.request_id, ph.read))
                    else:
                        o.send(Id(ph.requester_id), PutOk(ph.request_id))
                    return AbdState(seq=state.seq, val=state.val,
                                    phase=None)
                return AbdState(
                    seq=state.seq, val=state.val,
                    phase=Phase2(request_id=ph.request_id,
                                 requester_id=ph.requester_id,
                                 read=ph.read, acks=acks))
        return None


@dataclass
class AbdModelCfg:
    client_count: int
    server_count: int
    network: Network

    def into_model(self) -> ActorModel:
        model = ActorModel(
            cfg=self, init_history=LinearizabilityTester(Register('\0')))
        for i in range(self.server_count):
            model.actor(RegisterServer(AbdActor(
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
    from . import not_ported
    args = list(sys.argv[1:] if argv is None else argv)
    module = "stateright_tpu_torch.examples.linearizable_register"
    flags = {"--cpu": ("device", "cpu"), "--no-race": ("race", False)}
    opts = dict(flags[a] for a in args if a in flags)
    args = [a for a in args if a not in flags]
    cmd = args[0] if args else None
    client_count = int(args[1]) if len(args) > 1 else 2
    if cmd == "check":
        network = Network.from_name(args[2]) if len(args) > 2 \
            else Network.new_unordered_nonduplicating()
        print(f"Model checking a linearizable register with {client_count} "
              "clients.")
        (AbdModelCfg(client_count=client_count, server_count=3,
                     network=network)
         .into_model().checker().spawn_dfs().report(sys.stdout))
        return 0
    if cmd == "check-gpu":
        print(f"Model checking a linearizable register with {client_count} "
              "clients on the GPU engine.")
        from .abd_packed import PackedAbd
        (PackedAbd(client_count, server_count=3).checker()
         .gpu_options(**opts).spawn_gpu().report(sys.stdout))
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
