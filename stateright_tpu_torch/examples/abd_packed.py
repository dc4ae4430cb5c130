"""Packed ABD linearizable register: quorum replication on the GPU engine.

A copy of ``stateright_tpu/examples/abd_packed.py``: the same protocol as
:mod:`stateright_tpu_torch.examples.linearizable_register` (the Rust
crate's `examples/linearizable-register.rs`), expressed through
:class:`~stateright_tpu_torch.actor.packed_register.PackedRegisterModel`
so ``spawn_gpu`` checks it on the card. The server step is written in
batched torch here (the plain version) and as CUDA device functions in
``csrc/abd.cuh``, on the unordered network and on the ordered one (the
BASELINE's ``linearizable-register check 2 ordered``). Host BFS on this
model agrees state for state with the plain model (544 for 2 clients +
2 servers, `linearizable-register.rs:258`).

Packed layout (integer comparison of a packed seq equals the host's tuple
comparison, since the server id is the low component and ids are unique):

* seq ``(clock, sid)`` = ``clock<<4 | sid`` (12 bits);
* server state = 2+S words:
  - w0: ``seq | val<<12 | phase_tag<<16 | request_id<<18 | requester<<26``
    (tag: 0 = idle, 1 = phase 1 query, 2 = phase 2 record);
  - w1: ``write_present | write_val<<1 | read_present<<5 | read_val<<6 |
    acks_mask<<10`` (phase payload);
  - resp[k]: ``present<<16 | seq<<4 | val`` (phase-1 responses, by server);
* internal message = 2 words:
  ``[type<<24 | request_id<<12 | seq, value]``.
"""

from __future__ import annotations

import sys
from typing import Any, List

import torch

from ..actor import Id
from ..actor.packed_register import (PackedRegisterModel, T_GET, T_GETOK,
                                     T_INTERNAL0, T_PUT, T_PUTOK,
                                     val_char as _val_char,
                                     val_code as _val_code)
from ..ops.words import M32
from .linearizable_register import (AbdActor, AbdState, AckQuery,
                                    AckRecord, Phase1, Phase2, Query,
                                    Record)

T_QUERY, T_ACKQUERY, T_RECORD, T_ACKRECORD = range(
    T_INTERNAL0, T_INTERNAL0 + 4)

def _seq_word(seq) -> int:
    clock, sid = seq
    assert clock <= 0xFF and sid <= 0xF
    return (clock << 4) | sid


def _seq_tuple(word: int):
    return (word >> 4, word & 0xF)


class PackedAbd(PackedRegisterModel):
    """ABD with S replicas + C put-once register clients, packed."""

    def __init__(self, client_count: int, server_count: int = 2,
                 net_capacity: int = 16, ordered: bool = False,
                 channel_depth: int = 4):
        self._init_register(
            client_count, server_count, ordered=ordered,
            channel_depth=channel_depth,
            server_actor=lambda i: AbdActor(
                [Id(j) for j in range(server_count) if j != i]),
            server_width=2 + server_count,
            net_capacity=net_capacity,
            max_sends=max(server_count - 1, 1))  # broadcasts to peers

    def cache_key(self):
        return ("abd", self.client_count, self.server_count,
                self.net_capacity, self._net_ordered, self.channel_depth)

    # ------------------------------------------------------------------
    # server state packing
    # ------------------------------------------------------------------
    def encode_server(self, p: AbdState) -> List[int]:
        s = self.server_count
        w0 = _seq_word(p.seq) | (_val_code(p.val) << 12)
        w1 = 0
        resp = [0] * s
        if isinstance(p.phase, Phase1):
            w0 |= (1 << 16) | (p.phase.request_id << 18) \
                | (p.phase.requester_id << 26)
            if p.phase.write is not None:
                w1 |= 1 | (_val_code(p.phase.write) << 1)
            for sid, (seq, val) in p.phase.responses:
                resp[sid] = (1 << 16) | (_seq_word(seq) << 4) \
                    | _val_code(val)
        elif isinstance(p.phase, Phase2):
            w0 |= (2 << 16) | (p.phase.request_id << 18) \
                | (p.phase.requester_id << 26)
            if p.phase.read is not None:
                w1 |= (1 << 5) | (_val_code(p.phase.read) << 6)
            for a in p.phase.acks:
                w1 |= 1 << (10 + a)
        return [w0, w1] + resp

    def decode_server(self, words: List[int]) -> AbdState:
        s = self.server_count
        w0, w1 = words[0], words[1]
        seq = _seq_tuple(w0 & 0xFFF)
        val = _val_char((w0 >> 12) & 0xF)
        tag = (w0 >> 16) & 3
        rid = (w0 >> 18) & 0xFF
        requester = (w0 >> 26) & 0xF
        phase = None
        if tag == 1:
            write = _val_char((w1 >> 1) & 0xF) if w1 & 1 else None
            responses = frozenset(
                (sid, (_seq_tuple((rw >> 4) & 0xFFF),
                       _val_char(rw & 0xF)))
                for sid, rw in enumerate(words[2:2 + s])
                if (rw >> 16) & 1)
            phase = Phase1(request_id=rid, requester_id=requester,
                           write=write, responses=responses)
        elif tag == 2:
            read = _val_char((w1 >> 6) & 0xF) if (w1 >> 5) & 1 else None
            acks = frozenset(a for a in range(s) if (w1 >> (10 + a)) & 1)
            phase = Phase2(request_id=rid, requester_id=requester,
                           read=read, acks=acks)
        return AbdState(seq=seq, val=val, phase=phase)

    # ------------------------------------------------------------------
    # internal message packing
    # ------------------------------------------------------------------
    def encode_internal(self, inner: Any) -> List[int]:
        if isinstance(inner, Query):
            return [(T_QUERY << 24) | (inner.request_id << 12), 0]
        if isinstance(inner, AckQuery):
            return [(T_ACKQUERY << 24) | (inner.request_id << 12)
                    | _seq_word(inner.seq), _val_code(inner.value)]
        if isinstance(inner, Record):
            return [(T_RECORD << 24) | (inner.request_id << 12)
                    | _seq_word(inner.seq), _val_code(inner.value)]
        assert isinstance(inner, AckRecord)
        return [(T_ACKRECORD << 24) | (inner.request_id << 12), 0]

    def decode_internal(self, words: List[int]) -> Any:
        w0, w1 = words
        mtype = w0 >> 24
        rid = (w0 >> 12) & 0xFFF
        seq = _seq_tuple(w0 & 0xFFF)
        if mtype == T_QUERY:
            return Query(rid)
        if mtype == T_ACKQUERY:
            return AckQuery(rid, seq, _val_char(w1 & 0xF))
        if mtype == T_RECORD:
            return Record(rid, seq, _val_char(w1 & 0xF))
        assert mtype == T_ACKRECORD
        return AckRecord(rid)

    # ------------------------------------------------------------------
    # the CUDA device functions
    # ------------------------------------------------------------------
    def cuda_spec(self, symmetry: bool = False):
        """``("abd", (client_count, server_count, net_capacity))`` on the
        unordered network, ``("abd_ordered", (client_count,
        server_count, channel_depth))`` on the ordered one: the kernel
        runs ``csrc/abd.cuh`` (with ``csrc/actor_net.cuh``) for up to 7
        clients and 4 servers, 16 network slots and 128 packed words
        unordered, the register channels (at most 32) and 352 packed
        words ordered, without drops, timers or crashes
        (``check_cuda_register``: no symmetry, no subclass that changes
        the step, the encoding or the properties)."""
        name = "abd_ordered" if self._net_ordered else "abd"
        self.check_cuda_register(PackedAbd, "abd.cuh", symmetry, name,
                                 ordered=True)
        if self._net_ordered:
            return name, (self.client_count, self.server_count,
                          self.channel_depth)
        return name, (self.client_count, self.server_count,
                      self.net_capacity)

    # ------------------------------------------------------------------
    # the batched server step (`linearizable-register.rs:57-188`)
    # ------------------------------------------------------------------
    def _server_step(self, sid, w, src, msg):
        """One server's ``on_msg`` per lane, the JAX package's masked
        arithmetic over a batch: ``sid`` ``[N]``, ``w`` int64 ``[N, 2 +
        S]``, ``src`` ``[N]``, ``msg`` ``[N, 2]``; uint32 values (each
        word masked where it could pass 32 bits). Peer targets are
        ``(sid + 1 + k) % S``."""
        s = self.server_count
        quorum = s // 2 + 1
        dev = w.device
        srv_src = torch.clamp(src, max=s - 1)
        servers = torch.arange(s, device=dev)[None, :]
        src_sel = servers == srv_src[:, None]

        w0, w1 = w[:, 0], w[:, 1]
        resp = w[:, 2:2 + s]
        seq = w0 & 0xFFF
        val = (w0 >> 12) & 0xF
        tag = (w0 >> 16) & 3
        rid = (w0 >> 18) & 0xFF
        requester = (w0 >> 26) & 0xF
        wr_p = (w1 & 1) != 0
        wr_v = (w1 >> 1) & 0xF
        rd_p = ((w1 >> 5) & 1) != 0
        rd_v = (w1 >> 6) & 0xF
        acks = (w1 >> 10) & 0xF

        m0, m1 = msg[:, 0], msg[:, 1]
        mtype = m0 >> 24
        m_rid = (m0 >> 12) & 0xFFF
        m_seq = m0 & 0xFFF
        m_val = m1 & 0xF

        zero = torch.zeros_like(w0)
        no = torch.zeros_like(wr_p)
        sends = [[zero, torch.zeros_like(msg), no]
                 for _ in range(self.max_sends)]

        def mk(x, y):
            return torch.stack([x & M32, y & M32], dim=1)

        def set_send(k, cond, dst, m):
            sends[k][0] = torch.where(cond, dst, sends[k][0])
            sends[k][1] = torch.where(cond[:, None], m, sends[k][1])
            sends[k][2] = sends[k][2] | cond

        def broadcast(cond, m):
            for k in range(s - 1):
                set_send(k, cond, (sid + 1 + k) % s, m)

        # --- Put/Get while idle: phase 1 query --------------------------
        start = ((mtype == T_PUT) | (mtype == T_GET)) & (tag == 0)
        is_put = mtype == T_PUT
        put_val = m0 & 0xF  # register msgs carry the value in word 0
        broadcast(start, mk((T_QUERY << 24) | (m_rid << 12), zero))
        start_w0 = seq | (val << 12) | (1 << 16) | (m_rid << 18) \
            | (src << 26)
        start_w1 = torch.where(is_put, 1 | (put_val << 1), 0)
        start_resp = torch.where(servers == sid[:, None],
                                 ((1 << 16) | (seq << 4) | val)[:, None], 0)
        nw0 = torch.where(start, start_w0, w0)
        nw1 = torch.where(start, start_w1, w1)
        nresp = torch.where(start[:, None], start_resp, resp)

        # --- Query: answer with our (seq, val) --------------------------
        is_query = mtype == T_QUERY
        set_send(0, is_query, src,
                 mk((T_ACKQUERY << 24) | (m_rid << 12) | seq, val))

        # --- AckQuery in phase 1: collect, act at quorum ----------------
        ackq = (mtype == T_ACKQUERY) & (tag == 1) & (m_rid == rid)
        entry = (1 << 16) | (m_seq << 4) | m_val
        resp2 = torch.where(ackq[:, None] & src_sel, entry[:, None], nresp)
        present = ((resp2 >> 16) & 1) != 0
        q_hit = ackq & (present.sum(dim=1) == quorum)
        # newest (seq, value): integer max over packed (seq<<4 | val)
        best = torch.where(present, resp2 & 0xFFFF, 0).max(dim=1).values
        b_seq, b_val = best >> 4, best & 0xF
        n_seq = torch.where(wr_p, (((b_seq >> 4) + 1) << 4) | sid, b_seq)
        n_val = torch.where(wr_p, wr_v, b_val)
        broadcast(q_hit, mk((T_RECORD << 24) | (rid << 12) | n_seq, n_val))
        # move to phase 2 (self-ack); adopt the recorded value if newer
        newer = n_seq > seq
        ph2_w0 = torch.where(newer, n_seq | (n_val << 12),
                             seq | (val << 12)) \
            | (2 << 16) | (rid << 18) | (requester << 26)
        ph2_w1 = torch.where(wr_p, 0, (1 << 5) | (b_val << 6)) \
            | ((1 << sid) << 10)
        nw0 = torch.where(q_hit, ph2_w0, nw0)
        nw1 = torch.where(q_hit, ph2_w1, nw1)
        nresp = torch.where(q_hit[:, None], 0,
                            torch.where(ackq[:, None], resp2, nresp))

        # --- Record: ack; adopt if newer --------------------------------
        is_rec = mtype == T_RECORD
        set_send(0, is_rec, src,
                 mk((T_ACKRECORD << 24) | (m_rid << 12), zero))
        adopt = is_rec & (m_seq > (nw0 & 0xFFF))
        nw0 = torch.where(adopt, (nw0 & (M32 ^ 0xFFFF)) | m_seq
                          | (m_val << 12), nw0)

        # --- AckRecord in phase 2: count, respond at quorum -------------
        already = ((acks >> srv_src) & 1) != 0
        ackr = (mtype == T_ACKRECORD) & (tag == 2) & (m_rid == rid) \
            & ~already
        acks2 = acks | (1 << srv_src)
        cnt2 = torch.zeros_like(acks2)
        for j in range(s):
            cnt2 = cnt2 + ((acks2 >> j) & 1)
        r_hit = ackr & (cnt2 == quorum)
        done_msg = torch.where(
            rd_p[:, None], mk((T_GETOK << 24) | (rid << 12) | rd_v, zero),
            mk((T_PUTOK << 24) | (rid << 12), zero))
        set_send(0, r_hit, requester, done_msg)
        nw1 = torch.where(ackr & ~r_hit,
                          (nw1 & (M32 ^ (0xF << 10))) | (acks2 << 10), nw1)
        # back to idle: clear the phase bits entirely
        nw0 = torch.where(r_hit, nw0 & 0xFFFF, nw0)
        nw1 = torch.where(r_hit, 0, nw1)

        changed = start | ackq | adopt | ackr
        new_w = torch.cat([torch.stack([nw0, nw1], dim=1), nresp],
                          dim=1) & M32
        return new_w, changed, [tuple(x) for x in sends]


def main(argv=None) -> int:
    """``check [CLIENT_COUNT] [ordered]`` runs the host BFS,
    ``check-gpu [CLIENT_COUNT] [ordered] [--cpu] [--no-race]`` the GPU
    engine (``spawn_gpu().report()``); ``ordered`` is the ordered
    network with channels of depth 8 (the JAX package's CLI)."""
    args = list(sys.argv[1:] if argv is None else argv)
    module = "stateright_tpu_torch.examples.abd_packed"
    flags = {"--cpu": ("device", "cpu"), "--no-race": ("race", False)}
    opts = dict(flags[a] for a in args if a in flags)
    args = [a for a in args if a not in flags]
    cmd = args[0] if args else None
    client_count = int(args[1]) if len(args) > 1 else 2
    ordered = len(args) > 2 and args[2] == "ordered"
    kw = dict(ordered=True, channel_depth=8) if ordered else {}
    net = "ordered" if ordered else "unordered"
    if cmd == "check-gpu":
        print(f"Model checking packed ABD with {client_count} clients "
              f"({net} network) on the GPU engine.")
        PackedAbd(client_count, **kw).checker().gpu_options(**opts) \
            .spawn_gpu().report(sys.stdout)
        return 0
    if cmd == "check":
        print(f"Model checking packed ABD with {client_count} clients "
              f"({net} network) on the host engine.")
        PackedAbd(client_count, **kw).checker().spawn_bfs() \
            .report(sys.stdout)
        return 0
    print("USAGE:")
    print(f"  python -m {module} check [CLIENT_COUNT] [ordered]")
    print(f"  python -m {module} check-gpu [CLIENT_COUNT] [ordered] "
          "[--cpu] [--no-race]")
    return 2


if __name__ == "__main__":
    sys.exit(main())
