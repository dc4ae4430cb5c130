"""Packed single-copy register: the linearizability-counterexample
workload on the GPU engine.

A copy of ``stateright_tpu/examples/single_copy_packed.py``: the same
system as :mod:`stateright_tpu_torch.examples.single_copy_register` (the
Rust crate's `examples/single-copy-register.rs`): unreplicated value
servers on the unordered network. One server is linearizable (93 states
for 2 clients); two servers are NOT — the checker must produce a
linearizability counterexample, whose witness replays through the host
model. The server step is written in batched torch here (the plain
version) and as a CUDA device function in ``csrc/single_copy.cuh``.
Server state = 1 word (the value code)."""

from __future__ import annotations

import sys
from typing import Any, List

import torch

from ..actor.packed_register import (PackedRegisterModel,
                                     T_GET, T_GETOK, T_PUT, T_PUTOK,
                                     val_char as _val_char,
                                     val_code as _val_code)
from ..ops.words import M32
from .single_copy_register import SingleCopyActor


class PackedSingleCopy(PackedRegisterModel):
    """Unreplicated value server(s) + C put-once register clients."""

    def __init__(self, client_count: int, server_count: int = 1,
                 net_capacity: int = 16):
        self._init_register(
            client_count, server_count,
            server_actor=lambda i: SingleCopyActor(),
            server_width=1,
            net_capacity=net_capacity,
            max_sends=1)

    def cache_key(self):
        return ("single_copy", self.client_count, self.server_count,
                self.net_capacity)

    # --- server packing: one word, the stored value ----------------------
    def encode_server(self, val: str) -> List[int]:
        return [_val_code(val)]

    def decode_server(self, words: List[int]) -> str:
        return _val_char(words[0])

    def encode_internal(self, msg: Any) -> List[int]:
        raise AssertionError("single-copy register has no internal msgs")

    def decode_internal(self, words: List[int]) -> Any:
        raise AssertionError("single-copy register has no internal msgs")

    # --- the CUDA device functions ---------------------------------------
    def cuda_spec(self, symmetry: bool = False):
        """``("single_copy", (client_count, server_count,
        net_capacity))``: the kernel runs ``csrc/single_copy.cuh`` (with
        ``csrc/actor_net.cuh``) for up to 7 clients, 4 servers, 16
        network slots and 128 packed words on the unordered
        non-duplicating network (``check_cuda_register``)."""
        self.check_cuda_register(PackedSingleCopy, "single_copy.cuh",
                                 symmetry, "single_copy")
        return "single_copy", (self.client_count, self.server_count,
                               self.net_capacity)

    # --- the batched server step (`single-copy-register.rs:18-37`) -------
    def _server_step(self, sid, w, src, msg):
        """A Put stores its value and answers PutOk, a Get answers GetOk
        with the stored word, per lane (``w`` int64 ``[N, 1]``)."""
        val = w[:, 0]
        m0 = msg[:, 0]
        mtype = m0 >> 24
        m_rid = (m0 >> 12) & 0xFFF
        is_put = mtype == T_PUT
        is_get = mtype == T_GET
        new_val = torch.where(is_put, m0 & 0xF, val)
        zero = torch.zeros_like(val)
        putok = torch.stack([(T_PUTOK << 24) | (m_rid << 12), zero], dim=1)
        getok = torch.stack([((T_GETOK << 24) | (m_rid << 12) | val) & M32,
                             zero], dim=1)
        reply = is_put | is_get
        sends = [(torch.where(reply, src, zero),
                  torch.where(is_put[:, None], putok,
                              torch.where(is_get[:, None], getok,
                                          torch.zeros_like(msg))),
                  reply)]
        changed = is_put & (new_val != val)
        return new_val[:, None], changed, sends


def main(argv=None) -> int:
    """``check [CLIENT_COUNT] [SERVER_COUNT]`` runs the host BFS,
    ``check-gpu [CLIENT_COUNT] [SERVER_COUNT] [--cpu] [--no-race]`` the
    GPU engine (``spawn_gpu().report()``)."""
    args = list(sys.argv[1:] if argv is None else argv)
    module = "stateright_tpu_torch.examples.single_copy_packed"
    flags = {"--cpu": ("device", "cpu"), "--no-race": ("race", False)}
    opts = dict(flags[a] for a in args if a in flags)
    args = [a for a in args if a not in flags]
    cmd = args[0] if args else None
    client_count = int(args[1]) if len(args) > 1 else 2
    server_count = int(args[2]) if len(args) > 2 else 1
    model = None
    if cmd in ("check", "check-gpu"):
        model = PackedSingleCopy(client_count, server_count)
        where = "on the GPU engine" if cmd == "check-gpu" \
            else "on the host engine"
        print(f"Model checking a packed single-copy register with "
              f"{client_count} clients, {server_count} servers {where}.")
    if cmd == "check-gpu":
        model.checker().gpu_options(**opts).spawn_gpu().report(sys.stdout)
        return 0
    if cmd == "check":
        model.checker().spawn_bfs().report(sys.stdout)
        return 0
    print("USAGE:")
    print(f"  python -m {module} check [CLIENT_COUNT] [SERVER_COUNT]")
    print(f"  python -m {module} check-gpu [CLIENT_COUNT] [SERVER_COUNT] "
          "[--cpu] [--no-race]")
    return 2


if __name__ == "__main__":
    sys.exit(main())
