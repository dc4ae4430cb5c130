"""Packed Single-Decree Paxos: the north-star workload on the GPU engine.

A copy of ``stateright_tpu/examples/paxos_packed.py``: the same protocol
as :mod:`stateright_tpu_torch.examples.paxos` (a behavioural port of the
Rust crate's `examples/paxos.rs`), expressed as a
:class:`~stateright_tpu_torch.actor.packed.PackedActorModel` so
``spawn_gpu`` checks it on the card. The server step is written in
batched torch here (the plain version) and as CUDA device functions in
``csrc/paxos.cuh``; the clients, messages, history hooks and network
come from ``csrc/actor_net.cuh``. The host side IS the ActorModel semantics (servers,
register clients, linearizability history), so host BFS on this model and
the plain paxos model agree state-for-state (16,668 for 2 clients).

Packed layout decisions (all bit-level orderings chosen so that *integer*
comparison of packed words equals the host's tuple comparison):

* value code: ``'\\0'`` = 0, ``chr(ord('A')+k)`` = k+1 (monotonic in the
  char, so max-by-proposal picks the same winner);
* ballot ``(r, l)`` = ``r<<4 | l`` (12 bits);
* proposal ``(req, requester, value)`` = ``req<<8 | requester<<4 | value``
  (14 bits, flag bit 15 when wrapped in an Option);
* ``last_accepted`` Option[(Ballot, Proposal)] = ``flag<<26 | ballot<<14 |
  proposal`` (27 bits) — integer order equals the host's
  ``None-least, then (Ballot, Proposal)`` order (`paxos.rs:157-180`);
* server state = 3+S words: [ballot|accepts|decided, proposal,
  prepares×S, accepted];
* client state = 1 word: [flag<<31 | awaiting<<8 | op_count];
* message = 2 words: [type<<24 | a<<12 | b, c];
* history = 1 + 3·C words: [valid] + per client thread
  [entry0, entry1, in_flight] where an entry packs
  present | op kind | op value | ret value | last-completed codes
  (2 bits per peer: 0 = none, k = peer completed k ops at invocation) —
  a bounded, injective encoding of the LinearizabilityTester's
  ``_key()`` state for put_count=1 clients.
"""

from __future__ import annotations

import sys
from typing import Any, List, Optional, Tuple

import torch

from ..actor import Id
from ..ops.words import M32
from ..actor.packed_register import (PackedRegisterModel, T_GET, T_GETOK,
                                     T_INTERNAL0, T_PUT, T_PUTOK,
                                     val_char as _val_char,
                                     val_code as _val_code)
from .paxos import (Accept, Accepted, Decided, PaxosActor, PaxosState,
                    Prepare, Prepared)

# protocol-internal message type tags
T_PREPARE, T_PREPARED, T_ACCEPT, T_ACCEPTED, T_DECIDED = range(
    T_INTERNAL0, T_INTERNAL0 + 5)


def _ballot_word(ballot: Tuple[int, int]) -> int:
    r, l = ballot
    assert r <= 0xFF and l <= 0xF
    return (r << 4) | l


def _ballot_tuple(word: int) -> Tuple[int, int]:
    return (word >> 4, word & 0xF)


def _proposal_word(proposal) -> int:
    """14-bit packed (req, requester, value); 0x8000 flag when optional."""
    req, requester, value = proposal
    assert req <= 0x3F and requester <= 0xF
    return (req << 8) | (requester << 4) | _val_code(value)


def _proposal_tuple(word: int) -> Tuple[int, int, str]:
    return ((word >> 8) & 0x3F, (word >> 4) & 0xF, _val_char(word & 0xF))


def _la_word(last_accepted) -> int:
    """27-bit packed Option[(Ballot, Proposal)] (`paxos.rs:71-74`)."""
    if last_accepted is None:
        return 0
    ballot, proposal = last_accepted
    return (1 << 26) | (_ballot_word(ballot) << 14) \
        | _proposal_word(proposal)


def _la_tuple(word: int):
    if not (word >> 26) & 1:
        return None
    return (_ballot_tuple((word >> 14) & 0xFFF),
            _proposal_tuple(word & 0x3FFF))


class PackedPaxos(PackedRegisterModel):
    """Paxos with S servers + C put-once register clients, packed.

    Client slots, register messages, the linearizability history, and the
    one-hot dispatch come from :class:`PackedRegisterModel`; this class
    supplies the paxos server packing and its masked step kernel."""

    def __init__(self, client_count: int, server_count: int = 3,
                 net_capacity: int = 16):
        self._init_register(
            client_count, server_count,
            server_actor=lambda i: PaxosActor(
                [Id(j) for j in range(server_count) if j != i]),
            server_width=3 + server_count,
            net_capacity=net_capacity,
            max_sends=server_count)  # Decided broadcast + PutOk
        # measured batch branching ~3.3 valid children per state on the
        # device engine (profile()['vmax'] / fmax); sizes the engine's
        # candidate buffer well below the max_actions axis
        self.branching_hint = 4

    def cache_key(self):
        return ("paxos", self.client_count, self.server_count,
                self.net_capacity)

    def durable_word_mask(self, index: int) -> List[int]:
        """Crash–restart support: a paxos server's entire state is on
        stable storage (the protocol is *defined* against crash–recovery
        with durable promises and accepted proposals), so a crash wipes
        nothing — the fault injected is the downtime itself (deliveries
        pause while down). Clients stay fail-stop (all-volatile)."""
        if index < self.server_count:
            return [1] * self.actor_widths[index]
        return [0] * self.actor_widths[index]

    # ------------------------------------------------------------------
    # server state packing
    # ------------------------------------------------------------------
    def encode_server(self, p: PaxosState) -> List[int]:
        s = self.server_count
        w0 = _ballot_word(p.ballot)
        for a in p.accepts:
            w0 |= 1 << (12 + a)
        w0 |= int(p.is_decided) << 16
        w1 = 0 if p.proposal is None \
            else (1 << 15) | _proposal_word(p.proposal)
        preps = [0] * s
        for sid, la in p.prepares:
            preps[sid] = (1 << 27) | _la_word(la)
        return [w0, w1] + preps + [_la_word(p.accepted)]

    def decode_server(self, words: List[int]) -> PaxosState:
        s = self.server_count
        w0, w1 = words[0], words[1]
        preps = words[2:2 + s]
        ballot = _ballot_tuple(w0 & 0xFFF)
        accepts = frozenset(a for a in range(s)
                            if (w0 >> (12 + a)) & 1)
        decided = bool((w0 >> 16) & 1)
        proposal = _proposal_tuple(w1 & 0x3FFF) if (w1 >> 15) & 1 \
            else None
        prepares = tuple(sorted(
            (sid, _la_tuple(pw & 0x7FFFFFF))
            for sid, pw in enumerate(preps) if (pw >> 27) & 1))
        return PaxosState(
            ballot=ballot, proposal=proposal, prepares=prepares,
            accepts=accepts, accepted=_la_tuple(words[2 + s]),
            is_decided=decided)

    # ------------------------------------------------------------------
    # message packing: [type<<24 | a<<12 | b, c]
    # ------------------------------------------------------------------
    def encode_internal(self, inner: Any) -> List[int]:
        if isinstance(inner, Prepare):
            return [(T_PREPARE << 24) | _ballot_word(inner.ballot), 0]
        if isinstance(inner, Prepared):
            return [(T_PREPARED << 24) | _ballot_word(inner.ballot),
                    _la_word(inner.last_accepted)]
        if isinstance(inner, Accept):
            return [(T_ACCEPT << 24) | _ballot_word(inner.ballot),
                    _proposal_word(inner.proposal)]
        if isinstance(inner, Accepted):
            return [(T_ACCEPTED << 24) | _ballot_word(inner.ballot), 0]
        assert isinstance(inner, Decided)
        return [(T_DECIDED << 24) | _ballot_word(inner.ballot),
                _proposal_word(inner.proposal)]

    def decode_internal(self, words: List[int]) -> Any:
        w0, c = words
        mtype = w0 >> 24
        b = w0 & 0xFFF
        if mtype == T_PREPARE:
            return Prepare(_ballot_tuple(b))
        if mtype == T_PREPARED:
            return Prepared(_ballot_tuple(b), _la_tuple(c))
        if mtype == T_ACCEPT:
            return Accept(_ballot_tuple(b), _proposal_tuple(c))
        if mtype == T_ACCEPTED:
            return Accepted(_ballot_tuple(b))
        assert mtype == T_DECIDED
        return Decided(_ballot_tuple(b), _proposal_tuple(c))

    # ------------------------------------------------------------------
    # the CUDA device functions
    # ------------------------------------------------------------------
    def cuda_spec(self, symmetry: bool = False):
        """``("paxos", (client_count, server_count, net_capacity))``: the
        kernel runs ``csrc/paxos.cuh`` (with ``csrc/actor_net.cuh``) for
        up to 7 clients, 4 servers and 16 network slots on the
        unordered non-duplicating network without timers
        (``check_cuda_register``: no symmetry, no ordered network, no
        subclass that changes the step, the encoding, the properties or
        the recovery). Under ``lossy_network(True)``: ``("paxos_lossy",
        (...))``, ``PaxosLossyModel`` with a drop lane per slot after the
        deliveries. Under ``crash_restart``: ``("paxos_crash", (...,
        *crash_params()))``, ``PaxosCrashModel`` with the crashable set
        and the durable mask (lossy and crashes together are
        refused)."""
        crash = bool(self.max_crashes_)
        lossy = bool(self.lossy_network_)
        name = ("paxos_crash" if crash else "paxos_lossy" if lossy
                else "paxos")
        self.check_cuda_register(PackedPaxos, "paxos.cuh", symmetry, name,
                                 crash=crash, lossy=True)
        params = (self.client_count, self.server_count, self.net_capacity)
        return name, params + (self.crash_params() if crash else ())

    # ------------------------------------------------------------------
    # the batched server step
    # ------------------------------------------------------------------
    def _server_step(self, sid, w, src, msg):
        """One server's ``on_msg`` (``paxos.rs:85-172``) per lane, the
        JAX package's masked arithmetic over a batch: ``sid`` ``[N]``,
        ``w`` int64 ``[N, 3 + S]``, ``src`` ``[N]``, ``msg`` ``[N, 2]``.
        Peer targets are modular arithmetic on ``sid``."""
        s = self.server_count
        quorum = s // 2 + 1
        n = w.shape[0]
        dev = w.device
        srv_src = torch.clamp(src, max=s - 1)
        w0, w1 = w[:, 0], w[:, 1]
        preps = w[:, 2:2 + s]
        accepted = w[:, 2 + s]
        ballot = w0 & 0xFFF
        accepts_mask = (w0 >> 12) & 0xF
        decided = ((w0 >> 16) & 1) != 0
        has_proposal = ((w1 >> 15) & 1) != 0
        m0, c = msg[:, 0], msg[:, 1]
        mtype = m0 >> 24
        a = (m0 >> 12) & 0xFFF
        b = m0 & 0xFFF
        zero = torch.zeros_like(w0)
        no = torch.zeros_like(decided)
        sends = [[zero, torch.zeros_like(msg), no]
                 for _ in range(self.max_sends)]

        def mk(x, y):
            return torch.stack([x & M32, y & M32], dim=1)

        def set_send(k, cond, dst, m):
            sends[k][0] = torch.where(cond, dst, sends[k][0])
            sends[k][1] = torch.where(cond[:, None], m, sends[k][1])
            sends[k][2] = sends[k][2] | cond

        def broadcast(cond, m):
            # peers of sid are (sid+1+k) mod s (paxos.rs:100, :127, :153)
            for k in range(s - 1):
                set_send(k, cond, (sid + 1 + k) % s, m)

        # --- decided: only Get is answered (paxos.rs:87-95) -------------
        dec_get = decided & (mtype == T_GET)
        set_send(0, dec_get, src,
                 mk((T_GETOK << 24) | (a << 12) | (accepted & 0xF), zero))
        nw0, nw1 = w0, w1
        npreps = preps
        naccepted = accepted
        live = ~decided

        # --- Put: become leader of a fresh ballot (paxos.rs:96-104) -----
        put_ok = live & (mtype == T_PUT) & ~has_proposal
        nb = ((((ballot >> 4) + 1) << 4) | sid) & M32
        put_proposal = ((1 << 15) | (a << 8) | (src << 4) | (m0 & 0xF)) & M32
        nw0 = torch.where(put_ok, nb, nw0)  # accepts/decided bits cleared
        nw1 = torch.where(put_ok, put_proposal, nw1)
        self_entry = (1 << 27) | (accepted & 0x7FFFFFF)
        put_preps = torch.where(
            torch.arange(s, device=dev)[None, :] == sid[:, None],
            self_entry[:, None], 0)
        npreps = torch.where(put_ok[:, None], put_preps, npreps)
        broadcast(put_ok, mk((T_PREPARE << 24) | nb, zero))

        # --- Prepare (paxos.rs:108-114) ---------------------------------
        prep_ok = live & (mtype == T_PREPARE) & (ballot < b)
        nw0 = torch.where(prep_ok, (nw0 & ~0xFFF & M32) | b, nw0)
        set_send(0, prep_ok, src,
                 mk((T_PREPARED << 24) | b, accepted & 0x7FFFFFF))

        # --- Prepared (paxos.rs:116-138) --------------------------------
        prpd_ok = live & (mtype == T_PREPARED) & (b == ballot)
        entry = (1 << 27) | (c & 0x7FFFFFF)
        src_sel = torch.arange(s, device=dev)[None, :] == srv_src[:, None]
        npreps = torch.where(prpd_ok[:, None] & src_sel, entry[:, None],
                             npreps)
        present = (npreps >> 27) & 1
        count = present.sum(dim=1)
        la_all = torch.where(present != 0, npreps & 0x7FFFFFF, 0)
        la_max = la_all.max(dim=1).values
        prpd_q = prpd_ok & (count == quorum)
        # leadership handoff: favor the newest accepted proposal
        la_has = ((la_max >> 26) & 1) != 0
        q_proposal = torch.where(la_has, (1 << 15) | (la_max & 0x3FFF), nw1)
        nw1 = torch.where(prpd_q, q_proposal, nw1)
        nw0 = torch.where(prpd_q, (nw0 & ~(0xF << 12) & M32)
                          | (((1 << sid) << 12) & M32), nw0)
        naccepted = torch.where(
            prpd_q, (1 << 26) | (b << 14) | (q_proposal & 0x3FFF),
            naccepted)
        broadcast(prpd_q, mk((T_ACCEPT << 24) | b, q_proposal & 0x3FFF))

        # --- Accept (paxos.rs:140-146) ----------------------------------
        acc_ok = live & (mtype == T_ACCEPT) & (ballot <= b)
        nw0 = torch.where(acc_ok, (nw0 & ~0xFFF & M32) | b, nw0)
        naccepted = torch.where(
            acc_ok, (1 << 26) | (b << 14) | (c & 0x3FFF), naccepted)
        set_send(0, acc_ok, src, mk((T_ACCEPTED << 24) | b, zero))

        # --- Accepted (paxos.rs:148-164) --------------------------------
        acd_ok = live & (mtype == T_ACCEPTED) & (b == ballot)
        new_mask = (accepts_mask | (1 << srv_src)) & 0xF
        cnt = torch.zeros_like(new_mask)
        for j in range(s):
            cnt = cnt + ((new_mask >> j) & 1)
        acd_q = acd_ok & (cnt == quorum)
        nw0 = torch.where(acd_ok,
                          (nw0 & ~(0xF << 12) & M32) | (new_mask << 12), nw0)
        nw0 = torch.where(acd_q, nw0 | (1 << 16), nw0)
        requester = (nw1 >> 4) & 0xF
        broadcast(acd_q, mk((T_DECIDED << 24) | b, nw1 & 0x3FFF))
        set_send(self.max_sends - 1, acd_q, requester,
                 mk((T_PUTOK << 24) | (((nw1 >> 8) & 0x3F) << 12), zero))

        # --- Decided (paxos.rs:166-171) ---------------------------------
        dcd = live & (mtype == T_DECIDED)
        nw0 = torch.where(dcd, ((nw0 & ~0xFFF & M32) | b) | (1 << 16), nw0)
        naccepted = torch.where(
            dcd, (1 << 26) | (b << 14) | (c & 0x3FFF), naccepted)

        changed = put_ok | prep_ok | prpd_ok | acc_ok | acd_ok | dcd
        new_w = torch.cat([torch.stack([nw0, nw1], dim=1), npreps,
                           naccepted[:, None]], dim=1) & M32
        assert new_w.shape[0] == n
        return new_w, changed, [tuple(x) for x in sends]


def main(argv=None) -> int:
    """The JAX package's ``paxos_packed`` CLI: ``check`` runs the host
    BFS on the packed model, ``check-gpu`` the GPU engine (the same as
    ``python -m stateright_tpu_torch.examples.paxos check-gpu``)."""
    from .paxos import main as paxos_main
    args = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] == "check":
        client_count = int(args[1]) if len(args) > 1 else 2
        print(f"Model checking packed Paxos with {client_count} clients "
              "on the host engine.")
        PackedPaxos(client_count).checker().spawn_bfs().report(sys.stdout)
        return 0
    return paxos_main(args)


if __name__ == "__main__":
    sys.exit(main())
