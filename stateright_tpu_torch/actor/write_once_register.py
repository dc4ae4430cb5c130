"""Write-once register protocol interface + model-checking client actor.

Port of `src/actor/write_once_register.rs`: the
``WORegisterMsg`` vocabulary (``Put``/``Get``/``PutOk``/``PutFail``/
``GetOk`` plus protocol-internal messages), history hooks feeding a
:class:`~stateright_tpu_torch.semantics.ConsistencyTester` over a
:class:`~stateright_tpu_torch.semantics.write_once_register.WORegister`, a
scripted client that keeps writing until its final ``Get``
(`write_once_register.rs:127-263`), and ``rewrite`` support so
write-once-register systems can use symmetry reduction
(`write_once_register.rs:269-299`) — the reference's only workload
combining consistency testing with symmetry.

A copy of ``stateright_tpu/actor/write_once_register.py`` (host side only, no JAX); the
Rust crate's sources are cited by their paths in that crate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ..semantics.register import Read as ReadOp, ReadOk, Write as WriteOp, \
    WriteOk
from ..semantics.write_once_register import WriteFail
from .core import Actor, Id, Out


# --- message vocabulary (`write_once_register.rs:17-32`) --------------------

@dataclass(frozen=True)
class Internal:
    """A message specific to the register system's internal protocol."""
    msg: Any

    def rewrite(self, plan):
        from ..checker.representative import rewrite_value
        return Internal(rewrite_value(self.msg, plan))


@dataclass(frozen=True)
class Put:
    request_id: int
    value: Any

    def rewrite(self, plan):
        from ..checker.representative import rewrite_value
        return Put(self.request_id, rewrite_value(self.value, plan))


@dataclass(frozen=True)
class Get:
    request_id: int

    def rewrite(self, plan):
        return self


@dataclass(frozen=True)
class PutOk:
    request_id: int

    def rewrite(self, plan):
        return self


@dataclass(frozen=True)
class PutFail:
    request_id: int

    def rewrite(self, plan):
        return self


@dataclass(frozen=True)
class GetOk:
    request_id: int
    value: Any

    def rewrite(self, plan):
        from ..checker.representative import rewrite_value
        return GetOk(self.request_id, rewrite_value(self.value, plan))


# --- history hooks (`write_once_register.rs:36-97`) -------------------------

def record_invocations(cfg, history, env) -> Optional[Any]:
    """``record_msg_out`` hook: ``Get`` -> ``Read`` invoke; ``Put`` ->
    ``Write`` invoke."""
    if isinstance(env.msg, Get):
        history = history.clone()
        try:
            history.on_invoke(env.src, ReadOp())
        except ValueError:
            pass
        return history
    if isinstance(env.msg, Put):
        history = history.clone()
        try:
            history.on_invoke(env.src, WriteOp(env.msg.value))
        except ValueError:
            pass
        return history
    return None


def record_returns(cfg, history, env) -> Optional[Any]:
    """``record_msg_in`` hook: ``GetOk`` -> ``ReadOk``; ``PutOk`` ->
    ``WriteOk``; ``PutFail`` -> ``WriteFail``."""
    if isinstance(env.msg, GetOk):
        history = history.clone()
        try:
            history.on_return(env.dst, ReadOk(env.msg.value))
        except ValueError:
            pass
        return history
    if isinstance(env.msg, PutOk):
        history = history.clone()
        try:
            history.on_return(env.dst, WriteOk())
        except ValueError:
            pass
        return history
    if isinstance(env.msg, PutFail):
        history = history.clone()
        try:
            history.on_return(env.dst, WriteFail())
        except ValueError:
            pass
        return history
    return None


# --- client/server actors (`write_once_register.rs:99-263`) -----------------

@dataclass(frozen=True)
class ClientState:
    awaiting: Optional[int]
    op_count: int

    def rewrite(self, plan):
        return self

    def _sort_key(self):
        # total order across the state variants so symmetry reduction can
        # sort actor states (the reference derives Ord with Client first,
        # `write_once_register.rs:113-122`)
        return (0, -1 if self.awaiting is None else self.awaiting,
                self.op_count)

    def __lt__(self, other):
        return self._sort_key() < other._sort_key()


@dataclass(frozen=True)
class ServerState:
    state: Any

    def rewrite(self, plan):
        from ..checker.representative import rewrite_value
        return ServerState(rewrite_value(self.state, plan))

    def _sort_key(self):
        return (1, repr(self.state))

    def __lt__(self, other):
        if isinstance(other, ClientState):
            return False
        return self._sort_key() < other._sort_key()


class WORegisterClient(Actor):
    """Scripted test client: ``put_count`` puts (continuing past
    ``PutFail``, unlike the plain register client) then one get,
    round-robining the servers (which must precede clients in the actor
    list — `write_once_register.rs:125-144`)."""

    def __init__(self, put_count: int, server_count: int):
        self.put_count = put_count
        self.server_count = server_count

    def on_start(self, id: Id, o: Out) -> ClientState:
        index = int(id)
        if index < self.server_count:
            raise RuntimeError(
                "WORegisterClient actors must be added to the model after "
                "servers.")
        if self.put_count == 0:
            return ClientState(awaiting=None, op_count=0)
        unique_request_id = index
        value = chr(ord('A') + index - self.server_count)
        o.send(Id(index % self.server_count), Put(unique_request_id, value))
        return ClientState(awaiting=unique_request_id, op_count=1)

    def _next_op(self, index: int, state: ClientState, o: Out) -> ClientState:
        unique_request_id = (state.op_count + 1) * index
        if state.op_count < self.put_count:
            value = chr(ord('Z') - (index - self.server_count))
            o.send(Id((index + state.op_count) % self.server_count),
                   Put(unique_request_id, value))
        else:
            o.send(Id((index + state.op_count) % self.server_count),
                   Get(unique_request_id))
        return ClientState(awaiting=unique_request_id,
                           op_count=state.op_count + 1)

    def on_msg(self, id: Id, state: ClientState, src: Id, msg: Any,
               o: Out) -> Optional[ClientState]:
        if not isinstance(state, ClientState) or state.awaiting is None:
            return None
        index = int(id)
        if isinstance(msg, (PutOk, PutFail)) \
                and msg.request_id == state.awaiting:
            return self._next_op(index, state, o)
        if isinstance(msg, GetOk) and msg.request_id == state.awaiting:
            return ClientState(awaiting=None, op_count=state.op_count + 1)
        return None


class WORegisterServer(Actor):
    """Wraps a server actor being validated
    (`write_once_register.rs:99-110`)."""

    def __init__(self, server_actor: Actor):
        self.server_actor = server_actor

    def on_start(self, id: Id, o: Out) -> ServerState:
        return ServerState(self.server_actor.on_start(id, o))

    def on_msg(self, id, state, src, msg, o):
        if not isinstance(state, ServerState):
            return None
        inner = self.server_actor.on_msg(id, state.state, src, msg, o)
        return None if inner is None else ServerState(inner)

    def on_timeout(self, id, state, o):
        if not isinstance(state, ServerState):
            return None
        inner = self.server_actor.on_timeout(id, state.state, o)
        return None if inner is None else ServerState(inner)

    # crash–restart hooks delegate to the wrapped server (unwrapping the
    # ServerState tag, re-wrapping on the way back)
    def durable(self, id, state):
        if not isinstance(state, ServerState):
            return None
        return self.server_actor.durable(id, state.state)

    def on_restart(self, id, durable, o):
        return ServerState(self.server_actor.on_restart(id, durable, o))
