"""Unreplicated single-copy register servers — no consensus.

A copy of ``stateright_tpu/examples/single_copy_register.py`` (the Rust
crate's `examples/single-copy-register.rs`): each server exposes a
rewritable register; with one server the system is linearizable (93
unique states for 2 clients), with two it is not — the checker finds a
linearizability *counterexample*. The packed model is
:mod:`stateright_tpu_torch.examples.single_copy_packed`.

Run: ``python -m stateright_tpu_torch.examples.single_copy_register check [N]``
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, Optional

from ..actor import ActorModel, Id, Network, Out
from ..actor.core import Actor
from ..actor.register import (Get, GetOk, Put, PutOk, RegisterClient,
                              RegisterServer, record_invocations,
                              record_returns)
from ..core import Expectation
from ..semantics import LinearizabilityTester, Register


class SingleCopyActor(Actor):
    """A server holding one mutable value (`single-copy-register.rs:18-37`)."""

    def on_start(self, id: Id, o: Out) -> str:
        return '\0'

    def on_msg(self, id: Id, state: str, src: Id, msg: Any,
               o: Out) -> Optional[str]:
        if isinstance(msg, Put):
            o.send(src, PutOk(msg.request_id))
            return msg.value
        if isinstance(msg, Get):
            o.send(src, GetOk(msg.request_id, state))
        return None


@dataclass
class SingleCopyModelCfg:
    client_count: int
    server_count: int
    network: Network

    def into_model(self) -> ActorModel:
        model = ActorModel(
            cfg=self, init_history=LinearizabilityTester(Register('\0')))
        for _ in range(self.server_count):
            model.actor(RegisterServer(SingleCopyActor()))
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
    module = "stateright_tpu_torch.examples.single_copy_register"
    cmd = args[0] if args else None
    if cmd == "check":
        client_count = int(args[1]) if len(args) > 1 else 2
        network = Network.from_name(args[2]) if len(args) > 2 \
            else Network.new_unordered_nonduplicating()
        print(f"Model checking a single-copy register with {client_count} "
              "clients.")
        (SingleCopyModelCfg(client_count=client_count, server_count=1,
                            network=network)
         .into_model().checker().spawn_dfs().report(sys.stdout))
        return 0
    if cmd in ("explore", "spawn"):
        return not_ported(module, cmd)
    print("USAGE:")
    print(f"  python -m {module} check [CLIENT_COUNT] [NETWORK]")
    print("  (explore, spawn: not ported)")
    print(f"NETWORK: {' | '.join(Network.names())}")
    return 2


if __name__ == "__main__":
    sys.exit(main())
