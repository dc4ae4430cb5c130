"""Packed write-once register: the crash–restart demonstration pair.

A copy of ``stateright_tpu/examples/write_once_packed.py``. An
unreplicated write-once value server ('\\0' = unwritten; the first
``Put`` wins, a conflicting later ``Put`` gets ``PutFail``) checked by
put-once register clients with a linearizability history — the workload
proving ``crash_restart`` finds real bugs:

* ``PackedWriteOnce(c, durable=True)`` models a server whose register
  value is on stable storage (``durable_word_mask`` keeps the value
  word). Under ``crash_restart(1)`` it stays linearizable on both the
  host and the GPU engine.
* ``PackedWriteOnce(c, durable=False)`` models the buggy variant: the
  value lives only in volatile memory, so a crash silently loses an
  acknowledged write. Both engines produce a linearizability
  counterexample whose path contains the ``Crash``/``Restart`` actions
  (client writes, gets ``PutOk``, server crashes and forgets, client
  reads '\\0').

The host side IS the ``ActorModel`` semantics. The server step is
written in batched torch here (the plain version) and as a CUDA device
function in ``csrc/write_once.cuh``, whose K1 also has the crash and
restart lanes."""

from __future__ import annotations

import sys
from typing import Any, List, Optional

import torch

from ..actor.core import Actor, Id, Out
from ..actor.packed_register import (PackedRegisterModel, T_GET, T_GETOK,
                                     T_INTERNAL0, T_PUT, T_PUTOK,
                                     val_char as _val_char,
                                     val_code as _val_code)
from ..actor.register import Get, GetOk, Put, PutOk
from ..actor.write_once_register import PutFail
from ..ops.words import M32

# write-once failure reply; reuses the first protocol-internal tag slot
# (this model has no internal messages)
T_PUTFAIL = T_INTERNAL0


class WriteOnceActor(Actor):
    """Unreplicated write-once value server: first ``Put`` wins; a
    conflicting later ``Put`` fails; re-putting the same value succeeds
    (mirroring the ``WORegister`` spec semantics). '\\0' = unwritten."""

    def on_start(self, id: Id, o: Out) -> str:
        return '\0'

    def on_msg(self, id: Id, state: str, src: Id, msg: Any,
               o: Out) -> Optional[str]:
        if isinstance(msg, Put):
            if state == '\0':
                o.send(src, PutOk(msg.request_id))
                return msg.value
            if state == msg.value:
                o.send(src, PutOk(msg.request_id))
                return None
            o.send(src, PutFail(msg.request_id))
            return None
        if isinstance(msg, Get):
            o.send(src, GetOk(msg.request_id, state))
            return None
        return None


class PackedWriteOnce(PackedRegisterModel):
    """Write-once value server(s) + C put-once register clients.

    ``durable`` selects whether the server's register value survives a
    crash (``durable_word_mask``); it is part of the model identity.
    Enable fault injection with ``.crash_restart(k, actors=[0])``.
    """

    def __init__(self, client_count: int, server_count: int = 1,
                 durable: bool = True, net_capacity: int = 8):
        self.durable_server = bool(durable)
        self._init_register(
            client_count, server_count,
            server_actor=lambda i: WriteOnceActor(),
            server_width=1,
            net_capacity=net_capacity,
            max_sends=1)

    def cache_key(self):
        return ("write_once", self.client_count, self.server_count,
                self.net_capacity, self.durable_server)

    def durable_word_mask(self, index: int) -> List[int]:
        if index < self.server_count and self.durable_server:
            return [1] * self.actor_widths[index]
        return [0] * self.actor_widths[index]

    # --- server packing: one word, the stored value ----------------------
    def encode_server(self, val: str) -> List[int]:
        return [_val_code(val)]

    def decode_server(self, words: List[int]) -> str:
        return _val_char(words[0])

    def encode_internal(self, msg: Any) -> List[int]:
        raise AssertionError("write-once register has no internal msgs")

    def decode_internal(self, words: List[int]) -> Any:
        raise AssertionError("write-once register has no internal msgs")

    # PutFail rides the register vocabulary (tag T_PUTFAIL)
    def encode_msg(self, msg: Any) -> List[int]:
        if isinstance(msg, PutFail):
            return [(T_PUTFAIL << 24) | (msg.request_id << 12), 0]
        return super().encode_msg(msg)

    def decode_msg(self, words: List[int]) -> Any:
        if (words[0] >> 24) == T_PUTFAIL:
            return PutFail((words[0] >> 12) & 0xFFF)
        return super().decode_msg(words)

    # --- the CUDA device functions ---------------------------------------
    def cuda_spec(self, symmetry: bool = False):
        """``("write_once", (client_count, server_count, net_capacity,
        *crash_params()))``: the kernel runs ``csrc/write_once.cuh``
        (with ``csrc/actor_net.cuh``) for up to 7 clients, 4 servers, 16
        network slots, 8 actors and 128 packed words on the unordered
        non-duplicating network, with or without ``crash_restart``
        (``check_cuda_register``: no symmetry, drops, timers or ordered
        network, no subclass that changes the step, the encoding, the
        properties or the recovery; the durable mask is a parameter)."""
        self.check_cuda_register(PackedWriteOnce, "write_once.cuh",
                                 symmetry, "write_once", crash=True)
        return "write_once", (self.client_count, self.server_count,
                              self.net_capacity) + self.crash_params()

    # --- the batched server step (`write_once_packed.py:120-155`) --------
    def _server_step(self, sid, w, src, msg):
        """The write-once server's ``on_msg`` per lane (``w`` int64
        ``[N, 1]``): the first Put stores its value, a Put answers PutOk
        when the value was unwritten or equal and PutFail otherwise, a
        Get answers GetOk with the stored word."""
        val = w[:, 0]
        m0 = msg[:, 0]
        mtype = m0 >> 24
        m_rid = (m0 >> 12) & 0xFFF
        m_val = m0 & 0xF
        is_put = mtype == T_PUT
        is_get = mtype == T_GET
        unwritten = val == 0
        ok = is_put & (unwritten | (val == m_val))
        fail = is_put & ~unwritten & (val != m_val)
        new_val = torch.where(is_put & unwritten, m_val, val)
        zero = torch.zeros_like(val)
        putok = torch.stack([(T_PUTOK << 24) | (m_rid << 12), zero], dim=1)
        putfail = torch.stack([(T_PUTFAIL << 24) | (m_rid << 12), zero],
                              dim=1)
        getok = torch.stack([((T_GETOK << 24) | (m_rid << 12) | val) & M32,
                             zero], dim=1)
        zmsg = torch.zeros_like(msg)
        reply = is_put | is_get
        no = torch.zeros_like(reply)
        sends = [(zero, zmsg, no) for _ in range(self.max_sends)]
        sends[0] = (torch.where(reply, src, zero),
                    torch.where(is_get[:, None], getok,
                                torch.where(ok[:, None], putok,
                                            torch.where(fail[:, None],
                                                        putfail, zmsg))),
                    reply)
        changed = is_put & unwritten
        return new_val[:, None], changed, sends


def main(argv=None) -> int:
    """``check [CLIENT_COUNT] [volatile] [no-crash]`` runs the host BFS,
    ``check-gpu [CLIENT_COUNT] [volatile] [no-crash] [--cpu]
    [--no-race]`` the GPU engine (``spawn_gpu().report()``): a durable
    (or ``volatile``) server under ``crash_restart(1, actors=[0])``, or
    none with ``no-crash``."""
    args = list(sys.argv[1:] if argv is None else argv)
    module = "stateright_tpu_torch.examples.write_once_packed"
    flags = {"--cpu": ("device", "cpu"), "--no-race": ("race", False)}
    opts = dict(flags[a] for a in args if a in flags)
    args = [a for a in args if a not in flags]
    cmd = args[0] if args else None
    words = [a for a in args[1:] if a not in ("volatile", "no-crash")]
    client_count = int(words[0]) if words else 1
    volatile = "volatile" in args
    crashes = 0 if "no-crash" in args else 1
    if cmd in ("check", "check-gpu"):
        kind = "volatile" if volatile else "durable"
        where = "GPU" if cmd == "check-gpu" else "host"
        print(f"Model checking a packed write-once register "
              f"({kind} server, {client_count} clients, "
              f"max_crashes={crashes}) on the {where} engine.")
        model = PackedWriteOnce(client_count, durable=not volatile)
        if crashes:
            model.crash_restart(crashes, actors=[0])
        checker = model.checker()
        if cmd == "check-gpu":
            checker.gpu_options(**opts).spawn_gpu().report(sys.stdout)
        else:
            checker.spawn_bfs().report(sys.stdout)
        return 0
    print("USAGE:")
    print(f"  python -m {module} check [CLIENT_COUNT] [volatile] [no-crash]")
    print(f"  python -m {module} check-gpu [CLIENT_COUNT] [volatile] "
          "[no-crash] [--cpu] [--no-race]")
    return 2


if __name__ == "__main__":
    sys.exit(main())
