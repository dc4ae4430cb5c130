"""Shared packing for register-protocol actor systems on the GPU engine.

A copy of ``stateright_tpu/actor/packed_register.py`` with its device
functions in batched torch (the plain versions of the CUDA device
functions, ``csrc/actor_net.cuh``).

Every reference register workload (paxos, ABD, single-copy) combines the
same three ingredients: ``RegisterClient`` test clients
(the Rust crate's `src/actor/register.rs:127-216`), the
``Put``/``Get``/``PutOk``/``GetOk`` message vocabulary, and a
``LinearizabilityTester`` history over a ``Register``. This base class
packs all three once — client state slots, register message codecs, the
tester's packed word layout with its device-side record hooks, the
one-hot ``packed_deliver`` dispatch, and the shared device properties
(host-evaluated ``linearizable`` + device-scanned ``value chosen``) — so
a protocol only supplies its server packing and its batched server
step. ``PackedPaxos``, ``PackedAbd`` and ``PackedSingleCopy`` are the
in-tree instances.

Clients are ``put_count=1`` (one put then one get), matching the
reference examples; history packing relies on the resulting <=2
completed ops per thread.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from ..core import Expectation
from ..ops.words import M32
from ..semantics import LinearizabilityTester, Register
from ..semantics.register import Read as ReadOp, ReadOk, Write as WriteOp, \
    WriteOk
from .core import Id
from .network import Network
from .packed import PackedActorModel
from .register import (Get, GetOk, Internal, Put, PutOk, RegisterClient,
                       RegisterServer, record_invocations, record_returns)

# register message type tags; protocol-internal tags start at T_INTERNAL0
T_PUT, T_GET, T_PUTOK, T_GETOK = 1, 2, 3, 4
T_INTERNAL0 = 5


def val_code(value: Any) -> int:
    if value == '\0':
        return 0
    code = ord(value) - ord('A') + 1
    assert 1 <= code <= 15, f"value out of packed range: {value!r}"
    return code


def val_char(code: int) -> str:
    return '\0' if code == 0 else chr(ord('A') + code - 1)


class PackedRegisterModel(PackedActorModel):
    """Base for packed register-protocol systems.

    Subclasses implement: ``encode_server(state) -> List[int]`` /
    ``decode_server(words)`` (the unwrapped server actor state),
    ``encode_internal(msg) -> List[int]`` / ``decode_internal(words)``
    (protocol messages, 2 words), ``_server_step(sid, words, src, msg)``
    (the masked JAX kernel), and ``cache_key``.
    """

    def _init_register(self, client_count: int, server_count: int,
                       server_actor, server_width: int,
                       net_capacity: int, max_sends: int,
                       ordered: bool = False,
                       channel_depth: int = 4) -> None:
        """``server_actor`` is a factory ``(index) -> Actor`` (protocols
        typically pass each server its peer list). ``ordered`` selects
        the ordered network semantics (per-(src, dst) FIFO channels of
        ``channel_depth``), the `check N ordered` CLI configuration of
        the reference examples."""
        assert server_count <= 4, "accepts masks pack up to 4 servers"
        assert client_count <= 7, "last-completed codes pack up to 7 peers"
        super().__init__(cfg=self,
                         init_history=LinearizabilityTester(Register('\0')))
        self.client_count = client_count
        self.server_count = server_count
        self._server_w = server_width
        for i in range(server_count):
            self.actor(RegisterServer(server_actor(i)))
        for _ in range(client_count):
            self.actor(RegisterClient(put_count=1,
                                      server_count=server_count))
        self.channel_depth = channel_depth
        self.init_network(Network.new_ordered() if ordered
                          else Network.new_unordered_nonduplicating())

        def value_chosen(_model, state):
            for env in state.network.iter_deliverable():
                if isinstance(env.msg, GetOk) and env.msg.value != '\0':
                    return True
            return False

        self.property(Expectation.ALWAYS, "linearizable",
                      lambda _, state:
                      state.history.serialized_history() is not None)
        self.property(Expectation.SOMETIMES, "value chosen", value_chosen)
        self.record_msg_in(record_returns)
        self.record_msg_out(record_invocations)

        self.actor_widths = [server_width] * server_count \
            + [1] * client_count
        self.msg_width = 2
        self.net_capacity = net_capacity
        self.history_width = 1 + 3 * client_count
        self.max_sends = max_sends
        self.host_property_indices = (0,)  # linearizable
        # packed fast path (GpuChecker._host_props_results): evaluate
        # linearizability from the history columns alone — the full
        # decode() rebuilt every actor/server and the network per
        # representative, ~4x the cost of the history walk itself.
        # Keyed by PROPERTY NAME (not position): a subclass that
        # renames or reorders its host-evaluated properties binds the
        # right evaluator or fails loudly at spawn, where the old
        # positional list could silently bind the wrong lambda behind
        # a matching length.
        self.host_property_fns = {
            "linearizable":
                lambda row: self.decode_history(
                    [int(w) for w in row[self._hist_off:]]
                ).serialized_history() is not None}
        if ordered:
            # declare the flows the register protocol actually uses —
            # client<->server and server<->server; client<->client FIFOs
            # would waste ~30% row width (and expansion lanes)
            self.ordered_channels = self.register_channels()
        self.finalize_layout()

    def register_channels(self) -> List[tuple]:
        """The ordered channels of a register protocol, in this order:
        client -> server, server -> client, server -> server (``s !=
        t``), each by sender, then recipient (``csrc/actor_net.cuh``
        ``reg_chan`` computes the index from the pair)."""
        s, c = self.server_count, self.client_count
        servers = range(s)
        clients = range(s, s + c)
        return ([(x, y) for x in clients for y in servers]
                + [(x, y) for x in servers for y in clients]
                + [(x, y) for x in servers for y in servers if x != y])

    #: the batched hooks whose CUDA device functions run in place of a
    #: register model's own on the card (the restart hooks: the kernels'
    #: crash lanes run the default recovery, actor_net.cuh crash_edit)
    CUDA_HOOKS = ("packed_deliver", "_server_step", "_client_step",
                  "packed_record_in", "packed_record_out",
                  "packed_boundary", "encode_server", "encode_internal",
                  "encode_msg", "encode_history", "packed_on_restart",
                  "_restart_state")

    def check_cuda_register(self, base: type, header: str,
                            symmetry: bool, name: str,
                            ordered: bool = False,
                            crash: bool = False,
                            lossy: bool = False) -> None:
        """Refuse this model on the card unless ``csrc/<header>``
        (written for ``base``) computes what it does: refused are
        symmetry (no device representative), the Timeout lanes (device
        timers), the lossy drop lanes unless ``lossy`` (the
        instantiation has them; never together with crashes: no
        instantiation has both, and a lane mask holds 32 lanes), the
        crash/restart lanes unless ``crash`` (the instantiation has them:
        on the unordered network, at most 8 actors), the duplicating
        network, the ordered network unless ``ordered`` (and then any
        channels but :meth:`register_channels`, or more than 32 of
        them), more than 7 clients, 4 servers or 16 network slots, more
        packed words than the instantiation ``name`` takes
        (``ops/_cuda.py`` ``row_words``), and a subclass that overrides
        one of :data:`CUDA_HOOKS` or what ``check_cuda_model`` checks.
        ``durable_word_mask`` is data: the kernel takes the mask
        (:meth:`crash_params`)."""
        from ..models.packed import check_cuda_model
        from ..ops._cuda import row_words
        cls = type(self).__name__
        max_width = row_words(name)
        if symmetry:
            raise NotImplementedError(f"{cls} has no packed_representative")
        if self.lossy_network_:
            if self.max_crashes_ and not self._net_ordered:
                lanes = 2 * self.net_capacity + 2 * len(self._crash_idx)
                raise NotImplementedError(
                    f"a lossy {cls} under crash_restart() has {lanes} "
                    "lanes (deliveries, drops, crashes and restarts); no "
                    "instantiation has both the drop and the crash lanes "
                    "(a lane mask holds 32); check it with spawn_bfs() or "
                    "on the CPU (gpu_options(device='cpu'))")
            if not lossy or self._net_ordered:
                raise NotImplementedError(
                    f"csrc/{header} has no lossy drop lanes"
                    + (" on the ordered network" if self._net_ordered
                       else "")
                    + f"; check this lossy {cls} with spawn_bfs() or on "
                    "the CPU (gpu_options(device='cpu'))")
        if self.device_timers:
            raise NotImplementedError(
                f"csrc/{header} has no Timeout lanes (device timers); "
                f"check this {cls} with spawn_bfs() or on the CPU "
                "(gpu_options(device='cpu'))")
        if self.max_crashes_ and not crash:
            raise NotImplementedError(
                f"csrc/{header} has no crash/restart lanes; check this "
                f"{cls} under crash_restart() with spawn_bfs() or on the "
                "CPU (gpu_options(device='cpu'))")
        if self._net_dup:
            raise NotImplementedError(
                f"csrc/{header} runs the non-duplicating network only")
        if self._net_ordered and not ordered:
            raise NotImplementedError(
                f"csrc/{header} has no step on the ordered network; check "
                f"this {cls} with spawn_bfs() or on the CPU "
                "(gpu_options(device='cpu'))")
        if self._net_ordered and (
                [tuple(ch) for ch in self.ordered_channels]
                != self.register_channels() or self._n_chan > 32):
            raise NotImplementedError(
                f"csrc/{header} runs the register protocol's own ordered "
                "channels (register_channels(), at most 32)")
        if (self.client_count > 7 or self.server_count > 4
                or (not self._net_ordered and self.net_capacity > 16)
                or self.packed_width > max_width):
            raise NotImplementedError(
                f"csrc/{header} takes at most 7 clients, 4 servers, 16 "
                f"network slots and {max_width} packed words")
        for name in self.CUDA_HOOKS:
            if getattr(type(self), name) is not getattr(base, name):
                raise NotImplementedError(
                    f"{cls} overrides {name}; the CUDA step kernel runs "
                    f"{base.__name__}'s own (csrc/{header})")
        check_cuda_model(self, base, header,
                         (("linearizable", Expectation.ALWAYS),
                          ("value chosen", Expectation.SOMETIMES)),
                         self.packed_width, self.max_actions, symmetry)

    def crash_params(self) -> tuple:
        """The crash lanes' kernel parameters (``csrc/actor_net.cuh``
        ``CrashSpec``): ``(max_crashes, crashable actors, their indices a
        nibble each, the durable actor words' mask as two 32-bit
        halves)``, each as a C ``int``; all zero without crashes."""
        def c_int(v: int) -> int:
            return v - (1 << 32) if v >= 1 << 31 else v
        if not self.max_crashes_:
            return (0, 0, 0, 0, 0)
        idx = 0
        for c, a in enumerate(self._crash_idx.tolist()):
            idx |= int(a) << (4 * c)
        dur = 0
        for j, d in enumerate(self._word_durable.tolist()):
            dur |= int(d) << j
        return (int(self.max_crashes_), len(self._crash_idx), c_int(idx),
                c_int(dur & 0xFFFFFFFF), c_int(dur >> 32))

    # --- subclass interface ----------------------------------------------
    def encode_server(self, state: Any) -> List[int]:
        raise NotImplementedError

    def decode_server(self, words: List[int]) -> Any:
        raise NotImplementedError

    def encode_internal(self, msg: Any) -> List[int]:
        raise NotImplementedError

    def decode_internal(self, words: List[int]) -> Any:
        raise NotImplementedError

    # ------------------------------------------------------------------
    # actor state packing (client part shared)
    # ------------------------------------------------------------------
    def encode_actor(self, index: int, state: Any) -> List[int]:
        if index < self.server_count:
            return self.encode_server(state.state)  # unwrap ServerState
        c = state  # ClientState
        w = (c.op_count & 0xF)
        if c.awaiting is not None:
            w |= (1 << 31) | (c.awaiting << 8)
        return [w]

    def decode_actor(self, index: int, words: List[int]) -> Any:
        from .register import ClientState, ServerState
        if index < self.server_count:
            return ServerState(self.decode_server(words))
        w = words[0]
        awaiting = (w >> 8) & 0xFF if (w >> 31) & 1 else None
        return ClientState(awaiting=awaiting, op_count=w & 0xF)

    # ------------------------------------------------------------------
    # message packing: [type<<24 | request_id<<12 | b, c]
    # ------------------------------------------------------------------
    def encode_msg(self, msg: Any) -> List[int]:
        if isinstance(msg, Put):
            return [(T_PUT << 24) | (msg.request_id << 12)
                    | val_code(msg.value), 0]
        if isinstance(msg, Get):
            return [(T_GET << 24) | (msg.request_id << 12), 0]
        if isinstance(msg, PutOk):
            return [(T_PUTOK << 24) | (msg.request_id << 12), 0]
        if isinstance(msg, GetOk):
            return [(T_GETOK << 24) | (msg.request_id << 12)
                    | val_code(msg.value), 0]
        assert isinstance(msg, Internal)
        return self.encode_internal(msg.msg)

    def decode_msg(self, words: List[int]) -> Any:
        w0 = words[0]
        mtype = w0 >> 24
        a = (w0 >> 12) & 0xFFF
        b = w0 & 0xFFF
        if mtype == T_PUT:
            return Put(a, val_char(b & 0xF))
        if mtype == T_GET:
            return Get(a)
        if mtype == T_PUTOK:
            return PutOk(a)
        if mtype == T_GETOK:
            return GetOk(a, val_char(b & 0xF))
        return Internal(self.decode_internal(words))

    # ------------------------------------------------------------------
    # history packing (LinearizabilityTester over Register)
    # ------------------------------------------------------------------
    def _lc_bits(self, thread: int, lc: dict) -> int:
        """2-bit completed-count codes for each peer of ``thread``."""
        bits = 0
        pos = 0
        s = self.server_count
        for peer in range(self.client_count):
            if peer == thread:
                continue
            idx = lc.get(Id(s + peer))
            code = 0 if idx is None else idx + 1
            bits |= code << (2 * pos)
            pos += 1
        return bits

    def _lc_dict(self, thread: int, bits: int) -> dict:
        lc = {}
        pos = 0
        s = self.server_count
        for peer in range(self.client_count):
            if peer == thread:
                continue
            code = (bits >> (2 * pos)) & 3
            if code:
                lc[Id(s + peer)] = code - 1
            pos += 1
        return lc

    @staticmethod
    def _entry_word(lc_bits: int, op, ret) -> int:
        kind = int(isinstance(op, ReadOp))
        opval = 0 if kind else val_code(op.value)
        retval = val_code(ret.value) if isinstance(ret, ReadOk) else 0
        return (1 << 31) | (kind << 30) | (opval << 26) | (retval << 22) \
            | lc_bits

    def encode_history(self, history: LinearizabilityTester) -> List[int]:
        words = [int(history._valid)]
        s = self.server_count
        for t in range(self.client_count):
            tid = Id(s + t)
            entries = history._history.get(tid, [])
            assert len(entries) <= 2, "put_count=1 clients do <=2 ops"
            e = [0, 0]
            for k, (lc, op, ret) in enumerate(entries):
                e[k] = self._entry_word(self._lc_bits(t, lc), op, ret)
            inflight = 0
            if tid in history._in_flight:
                lc, op = history._in_flight[tid]
                kind = int(isinstance(op, ReadOp))
                opval = 0 if kind else val_code(op.value)
                inflight = (1 << 31) | (kind << 30) | (opval << 26) \
                    | self._lc_bits(t, lc)
            words.extend([e[0], e[1], inflight])
        return words

    def decode_history(self, words: List[int]) -> LinearizabilityTester:
        tester = LinearizabilityTester(Register('\0'))
        tester._valid = bool(words[0] & 1)
        s = self.server_count
        for t in range(self.client_count):
            tid = Id(s + t)
            e0, e1, inflight = words[1 + 3 * t: 4 + 3 * t]
            entries = []
            for w in (e0, e1):
                if not (w >> 31) & 1:
                    continue
                kind = (w >> 30) & 1
                opval = (w >> 26) & 0xF
                retval = (w >> 22) & 0xF
                op = ReadOp() if kind else WriteOp(val_char(opval))
                ret = ReadOk(val_char(retval)) if kind else WriteOk()
                entries.append((self._lc_dict(t, w & 0x3FFF), op, ret))
            if entries:
                tester._history[tid] = entries
            if (inflight >> 31) & 1:
                kind = (inflight >> 30) & 1
                opval = (inflight >> 26) & 0xF
                op = ReadOp() if kind else WriteOp(val_char(opval))
                tester._in_flight[tid] = (
                    self._lc_dict(t, inflight & 0x3FFF), op)
                tester._history.setdefault(tid, [])
        return tester

    def host_property_key(self, row) -> bytes:
        """The linearizable property depends only on the history words."""
        return np.asarray(row[self._hist_off:], dtype=np.uint32).tobytes()

    def host_property_key_block(self, rows) -> list:
        """Vectorized ``host_property_key`` over a pulled block
        (``GpuChecker._eval_host_props_block``): ONE contiguous
        slice/copy of every row's history columns instead of a per-row
        slice + buffer round trip — the per-row overhead dominated the
        host's representative-consumption cost on memo-hit-heavy runs."""
        block = np.ascontiguousarray(
            np.asarray(rows, dtype=np.uint32)[:, self._hist_off:])
        return [block[j].tobytes() for j in range(block.shape[0])]

    def packed_properties(self, words):
        """``bool[F, 2]``: index 0 ``linearizable`` is host-evaluated
        (neutral True); ``value chosen`` scans the deliverable envelopes
        (every occupied slot of the multiset; the channel heads of an
        ordered network) for a ``GetOk`` of a non-null value."""
        from ..ops.words import u64
        w = u64(words)
        if self._net_ordered:
            lens = w[:, self._net_off:self._msgs_off]
            m0 = w[:, self._msgs_off:self._timer_off].reshape(
                w.shape[0], self._n_chan, -1)[:, :, 0]
            live = lens > 0
        else:
            slots = w[:, self._net_off:self._timer_off].reshape(
                w.shape[0], self.net_capacity, self._sw)
            live = ((slots[:, :, 0] >> 16) & 1) != 0
            m0 = slots[:, :, 2]
        chosen = live & ((m0 >> 24) == T_GETOK) & ((m0 & 0xF) != 0)
        return torch.stack([torch.ones_like(chosen[:, 0]),
                            chosen.any(dim=1)], dim=1)

    # ------------------------------------------------------------------
    # batched device functions (history record hooks, client FSM,
    # dispatch): int64 ``[N, ...]`` lanes holding uint32 values
    # ------------------------------------------------------------------
    def _peer_weight(self) -> np.ndarray:
        """Static ``(C, C)`` matrix: ``W[t, p] = 1 << (2 * pos)`` where
        ``pos`` is peer ``p``'s position among ``t``'s peers (0 when
        ``p == t``). One multiply-sum turns per-peer completed counts
        into every thread's packed last-completed code (``on_invoke``,
        ``linearizability.rs:102-125``)."""
        w = getattr(self, "_peer_w", None)
        if w is None:
            c = self.client_count
            w = np.zeros((c, c), np.int64)
            for t in range(c):
                pos = 0
                for p in range(c):
                    if p == t:
                        continue
                    w[t, p] = 1 << (2 * pos)
                    pos += 1
            self._peer_w = w
        return w

    def _hist_cols(self, hist):
        h = hist[:, 1:].reshape(hist.shape[0], self.client_count, 3)
        return h[:, :, 0], h[:, :, 1], h[:, :, 2]

    @staticmethod
    def _hist_pack(w0, e0, e1, infl):
        return torch.cat([w0[:, None],
                          torch.stack([e0, e1, infl], dim=2).reshape(
                              w0.shape[0], -1)], dim=1)

    def _client_ids(self, device):
        return torch.arange(self.client_count, dtype=torch.int64,
                            device=device) + self.server_count

    def packed_record_out(self, hist, src, dst, msg):
        """``record_invocations``: Put -> Write invoke, Get -> Read."""
        mtype = msg[:, 0] >> 24
        is_put = mtype == T_PUT
        applies = is_put | (mtype == T_GET)
        valid = (hist[:, 0] & 1) != 0
        e0, e1, infl = self._hist_cols(hist)
        sel = applies[:, None] & (src[:, None]
                                  == self._client_ids(hist.device))
        has_infl = ((infl >> 31) & 1) != 0
        # double-invoke invalidates the history (on_invoke raising after
        # setting _valid=False; the record hook swallows it)
        invalidate = (sel & valid[:, None] & has_infl).any(dim=1)
        counts = ((e0 >> 31) & 1) + ((e1 >> 31) & 1)
        weight = torch.from_numpy(self._peer_weight()).to(hist.device)
        lc_bits = (counts[:, None, :] * weight[None]).sum(dim=2) & M32
        kind = torch.where(is_put, 0, 1)
        opval = torch.where(is_put, msg[:, 0] & 0xF, 0)
        word = ((1 << 31) | (kind << 30) | (opval << 26))[:, None] | lc_bits
        do_set = sel & valid[:, None] & ~has_infl
        infl = torch.where(do_set, word, infl)
        w0 = torch.where(invalidate, hist[:, 0] & ~1 & M32, hist[:, 0])
        return self._hist_pack(w0, e0, e1, infl)

    def packed_record_in(self, hist, src, dst, msg):
        """``record_returns``: GetOk -> ReadOk, PutOk -> WriteOk."""
        mtype = msg[:, 0] >> 24
        is_getok = mtype == T_GETOK
        applies = is_getok | (mtype == T_PUTOK)
        valid = (hist[:, 0] & 1) != 0
        e0, e1, infl = self._hist_cols(hist)
        sel = applies[:, None] & (dst[:, None]
                                  == self._client_ids(hist.device))
        has_infl = ((infl >> 31) & 1) != 0
        invalidate = (sel & valid[:, None] & ~has_infl).any(dim=1)
        retval = torch.where(is_getok, msg[:, 0] & 0xF, 0)
        entry = infl | (retval << 22)[:, None]
        do_set = sel & valid[:, None] & has_infl
        e0_empty = ((e0 >> 31) & 1) == 0
        e0 = torch.where(do_set & e0_empty, entry, e0)
        e1 = torch.where(do_set & ~e0_empty, entry, e1)
        infl = torch.where(do_set, 0, infl)
        w0 = torch.where(invalidate, hist[:, 0] & ~1 & M32, hist[:, 0])
        return self._hist_pack(w0, e0, e1, infl)

    def _client_step(self, index, w, src, msg):
        """Register client ``on_msg`` (``register.rs:127-216``) per lane:
        ``index`` the client's actor index ``[N]`` (>= server_count),
        ``w`` its word ``[N]``. Returns ``(new word [N], changed [N],
        sends)``."""
        s = self.server_count
        word = w
        has_awaiting = ((word >> 31) & 1) != 0
        awaiting = (word >> 8) & 0xFF
        opc = word & 0xF
        mtype = msg[:, 0] >> 24
        a = (msg[:, 0] >> 12) & 0xFFF
        putok = (mtype == T_PUTOK) & has_awaiting & (a == awaiting)
        getok = (mtype == T_GETOK) & has_awaiting & (a == awaiting)
        new_req = ((opc + 1) * index) & M32
        get_dst = (index + opc) % s
        get_msg = torch.stack([((T_GET << 24) | (new_req << 12)) & M32,
                               torch.zeros_like(word)], dim=1)
        new_word = torch.where(
            putok, ((1 << 31) | (new_req << 8) | (opc + 1)) & M32,
            torch.where(getok, (opc + 1) & 0xF, word))
        zero = torch.zeros_like(word)
        no = torch.zeros_like(putok)
        sends = [(zero, torch.zeros_like(msg), no)
                 for _ in range(self.max_sends)]
        sends[0] = (torch.where(putok, get_dst, zero),
                    torch.where(putok[:, None], get_msg,
                                torch.zeros_like(msg)), putok)
        return new_word, putok | getok, sends

    def _server_step(self, sid, w, src, msg):
        """One server's ``on_msg`` per lane: ``sid`` ``[N]``, ``w`` the
        server's words ``[N, server_width]``. Returns ``(new words,
        changed, sends)``."""
        raise NotImplementedError

    def packed_deliver(self, actors, src, dst, msg):
        """Dispatch on ``dst`` per lane: the server step on the
        destination server's span (the last server's when ``dst`` is a
        client) and the client step on the destination client's word
        (the one at ``clip(dst - S, 0, C - 1)``), each result written
        back where the destination is of its kind."""
        s, sw, n = self.server_count, self._server_w, actors.shape[0]
        dev = actors.device
        is_server = dst < s
        sidx = torch.clamp(dst, max=s - 1)
        cols = sidx[:, None] * sw + torch.arange(sw, device=dev)[None, :]
        s_words = actors.gather(1, cols)
        n_sw, s_ch, s_snds = self._server_step(sidx, s_words, src, msg)
        cidx = torch.clamp(dst - s, 0, self.client_count - 1)
        c_off = s * sw + cidx
        c_word = actors.gather(1, c_off[:, None])[:, 0]
        n_cw, c_ch, c_snds = self._client_step(cidx + s, c_word, src, msg)
        upd_server = actors.scatter(1, cols, n_sw)
        upd_client = actors.scatter(1, c_off[:, None], n_cw[:, None])
        new_actors = torch.where(is_server[:, None], upd_server, upd_client)
        changed = torch.where(is_server, s_ch, c_ch)
        sends = []
        for k in range(self.max_sends):
            sends.append((
                torch.where(is_server, s_snds[k][0], c_snds[k][0]),
                torch.where(is_server[:, None], s_snds[k][1], c_snds[k][1]),
                torch.where(is_server, s_snds[k][2], c_snds[k][2])))
        assert n == new_actors.shape[0]
        return new_actors, changed, sends
