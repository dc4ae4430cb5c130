"""Register protocol interface + model-checking client actor.

Port of `src/actor/register.rs`: a shared message vocabulary
for register-like systems (``Put``/``Get``/``PutOk``/``GetOk`` plus
protocol-internal messages), history hooks that feed a
:class:`~stateright_tpu_torch.semantics.ConsistencyTester`, and a scripted client
(`register.rs:127-216`) that puts then gets, round-robining servers.

A copy of ``stateright_tpu/actor/register.py`` (host side only, no JAX); the
Rust crate's sources are cited by their paths in that crate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ..semantics import Read as ReadOp, Write as WriteOp
from ..semantics.register import ReadOk, WriteOk
from .core import Actor, Id, Out


# --- message vocabulary (`register.rs:14-29`) -------------------------------

@dataclass(frozen=True)
class Internal:
    """A message specific to the register system's internal protocol."""
    msg: Any


@dataclass(frozen=True)
class Put:
    request_id: int
    value: Any


@dataclass(frozen=True)
class Get:
    request_id: int


@dataclass(frozen=True)
class PutOk:
    request_id: int


@dataclass(frozen=True)
class GetOk:
    request_id: int
    value: Any


# --- history hooks (`register.rs:37-87`) ------------------------------------

def record_invocations(cfg, history, env) -> Optional[Any]:
    """``record_msg_out`` hook: ``Get`` -> ``Read`` invoke; ``Put`` ->
    ``Write`` invoke. Invalid histories are discarded silently, mirroring
    the reference's caveat."""
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
    ``WriteOk``."""
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
    return None


# --- client state (`register.rs:105-117`) -----------------------------------

@dataclass(frozen=True)
class ClientState:
    awaiting: Optional[int]
    op_count: int


@dataclass(frozen=True)
class ServerState:
    state: Any


class RegisterClient(Actor):
    """Scripted test client: ``put_count`` puts then one get, round-robining
    the servers (which must precede clients in the actor list —
    `register.rs:116-118`)."""

    def __init__(self, put_count: int, server_count: int):
        self.put_count = put_count
        self.server_count = server_count

    def on_start(self, id: Id, o: Out) -> ClientState:
        index = int(id)
        if index < self.server_count:
            raise RuntimeError(
                "RegisterClient actors must be added to the model after "
                "servers.")
        if self.put_count == 0:
            return ClientState(awaiting=None, op_count=0)
        unique_request_id = index  # next will be 2 * index
        value = chr(ord('A') + index - self.server_count)
        o.send(Id(index % self.server_count), Put(unique_request_id, value))
        return ClientState(awaiting=unique_request_id, op_count=1)

    def on_msg(self, id: Id, state: ClientState, src: Id, msg: Any,
               o: Out) -> Optional[ClientState]:
        if not isinstance(state, ClientState) or state.awaiting is None:
            return None
        index = int(id)
        if isinstance(msg, PutOk) and msg.request_id == state.awaiting:
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
        if isinstance(msg, GetOk) and msg.request_id == state.awaiting:
            return ClientState(awaiting=None, op_count=state.op_count + 1)
        return None


class RegisterServer(Actor):
    """Wraps a server actor being validated (`register.rs:92-103`) so its
    state is tagged distinctly from client states."""

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


# --- wire serde for the spawn runtime (`register.rs` + serde_json shape) ----

def register_msg_to_json(msg, encode_internal) -> bytes:
    """Externally-tagged JSON for the register vocabulary; protocol
    internals delegate to ``encode_internal(inner) -> dict``."""
    import json
    if isinstance(msg, Put):
        obj = {"Put": [msg.request_id, msg.value]}
    elif isinstance(msg, Get):
        obj = {"Get": [msg.request_id]}
    elif isinstance(msg, PutOk):
        obj = {"PutOk": [msg.request_id]}
    elif isinstance(msg, GetOk):
        obj = {"GetOk": [msg.request_id, msg.value]}
    elif isinstance(msg, Internal):
        obj = {"Internal": encode_internal(msg.msg)}
    else:
        raise TypeError(f"unknown message {msg!r}")
    return json.dumps(obj).encode()


def register_msg_from_json(data: bytes, decode_internal):
    """Inverse of :func:`register_msg_to_json`; ``decode_internal(tag,
    value)`` handles the protocol's internal messages."""
    import json
    obj = json.loads(data)
    (tag, value), = obj.items()
    if tag == "Put":
        return Put(value[0], value[1])
    if tag == "Get":
        return Get(value[0])
    if tag == "PutOk":
        return PutOk(value[0])
    if tag == "GetOk":
        return GetOk(value[0], value[1])
    if tag == "Internal":
        (itag, ivalue), = value.items()
        return Internal(decode_internal(itag, ivalue))
    raise ValueError(f"unknown message tag in {obj!r}")
