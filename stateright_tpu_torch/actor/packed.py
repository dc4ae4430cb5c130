"""Packed ``ActorModel`` encoding: actor systems on the GPU engine.

A copy of ``stateright_tpu/actor/packed.py`` with its device half in
batched torch. A :class:`PackedActorModel` *is* an ``ActorModel`` (the
host side is the exact behavioural semantics) that also implements the
:class:`~stateright_tpu_torch.models.packed.PackedModel` protocol with a
canonical struct-of-words state layout:

    [ actor states | E network slots | timer bits | history words ]

* **Actor states** are fixed-width per actor index; the subclass
  supplies ``encode_actor``/``decode_actor`` and a batched
  ``packed_deliver`` that dispatches on the destination.
* **The network multiset** keeps each distinct in-flight envelope in one
  slot ``[hdr, count, msg...]`` with ``hdr = occupied<<16 | src<<8 |
  dst``, sorted by ``(hdr, msg)`` with the empties last, so the encoding
  (and the fingerprint) is order-insensitive; the count column is not
  part of the order. A delivery decrements its slot's count (removing
  the slot at zero by a suffix shift), a send bumps a matching slot's
  count or inserts a fresh slot at its rank.
* **History** (e.g. a linearizability tester) rides as packed words with
  batched record hooks mirroring ``record_msg_out``/``record_msg_in``;
  properties that need the decoded history are declared in
  ``host_property_indices`` and evaluated on the host, once per distinct
  history (``checker/gpu.py``).

Delivery nondeterminism is the action axis: action ``e`` delivers slot
``e``; disabled slots, missing recipients and no-op handler results are
mask bits.

An ordered network keeps one FIFO per declared ``(src, dst)`` channel
at a fixed position, ``[lengths | channel x depth x message words]``;
action ``c`` delivers the head of channel ``c``.

The port's step (:meth:`PackedActorModel.packed_step`) is the JAX
package's ``_packed_step_unordered`` (``stateright_tpu/actor/packed.py``
:710, with ``_net_consume`` :489 and ``_net_send`` :519) or
``_packed_step_ordered`` (:588) over a batch, in int64 holding uint32
values: the plain version of the CUDA device functions a model names in
``cuda_spec`` (``csrc/actor_net.cuh``). On the unordered network it
has the crash/restart lanes (``crash_restart``: the JAX package's
``:849-900``): lane ``E + c`` crashes the ``c``-th crashable actor,
lane ``E + n_cr + c`` restarts it, and a delivery to a down recipient
is invalid. The lossy drop lanes and the device timers are not ported:
``packed_step`` raises ``NotImplementedError`` for them (A8's next
slice), as for crashes on the ordered network; the host engines check
such models.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..models.packed import PackedModel
from ..ops.words import M32, u64
from .core import Down, Envelope, Id, Out
from .model import ActorModel, ActorModelState
from .network import (Ordered, UnorderedDuplicating,
                      UnorderedNonDuplicating)

_OCC = 1 << 16  # slot-occupied flag in the hdr word
_EMPTY_SORT_KEY = 0xFFFFFFFF  # empties sort last

_LOSSY_ORDERED_MESSAGE = (
    "lossy ordered networks are not supported on the device engine (no "
    "Drop lanes for FIFO channels yet). Check this model on the host "
    "engines instead — checker().spawn_bfs() or .spawn_dfs() explore "
    "the identical Drop interleavings and reach identical discoveries.")

_CRASH_ORDERED_MESSAGE = (
    "crash_restart() on an ordered network is not supported on the "
    "device engine yet. Check this model on the host engines instead — "
    "checker().spawn_bfs() or .spawn_dfs() explore the identical "
    "Crash/Restart interleavings and reach identical discoveries.")


class PackedActorModel(ActorModel, PackedModel):
    """An ``ActorModel`` with a packed device encoding.

    Subclasses configure (before calling :meth:`finalize_layout`):
      * ``actor_widths``: words per actor state, by actor index;
      * ``msg_width``: words per message;
      * ``net_capacity``: max distinct in-flight envelopes (E);
      * ``history_width``: words of packed history (0 = no history);
      * ``max_sends``: max Sends one handler emits;
      * ``host_property_indices``: property indices evaluated host-side.

    And implement: ``encode_actor``/``decode_actor``, ``encode_msg``/
    ``decode_msg``, ``encode_history``/``decode_history`` (if any),
    ``packed_deliver``, ``packed_record_out``/``packed_record_in`` (if
    history), and ``packed_properties``.
    """

    msg_width: int
    net_capacity: int
    history_width: int = 0
    max_sends: int = 1
    host_property_indices: Tuple[int, ...] = ()

    #: per-(src, dst) FIFO depth for ordered networks
    channel_depth: int = 4

    #: ordered networks: the (src, dst) pairs the protocol actually uses
    #: (None = the dense actor x actor grid). Register protocols never
    #: use client<->client channels, so declaring the real flows shrinks
    #: the packed row ~30% — width the expansion pays for every lane.
    ordered_channels: Optional[List[Tuple[int, int]]] = None

    def finalize_layout(self) -> None:
        """Compute offsets once the config fields are set."""
        self.actor_widths: List[int] = list(self.actor_widths)
        self._actor_off = np.cumsum([0] + self.actor_widths).tolist()
        self._aw = self._actor_off[-1]
        self._net_off = self._aw
        self._net_dup = isinstance(self.init_network_,
                                   UnorderedDuplicating)
        self._net_ordered = isinstance(self.init_network_, Ordered)
        if self._net_ordered:
            # ordered layout: one FIFO per declared (src, dst) channel
            # at a FIXED position — no sorting needed for canonicality,
            # the channel index and queue order are the identity
            a = len(self.actor_widths)
            if self.ordered_channels is None:
                chans = [(s, d) for s in range(a) for d in range(a)]
            else:
                chans = [(int(s), int(d))
                         for s, d in self.ordered_channels]
                if len(set(chans)) != len(chans):
                    raise ValueError("ordered_channels has duplicates")
                for s, d in chans:
                    if not (0 <= s < a and 0 <= d < a):
                        raise ValueError(
                            f"ordered_channels pair ({s}, {d}) is out "
                            f"of range for {a} actors")
            self._n_chan = len(chans)
            self._chan_src = np.asarray([s for s, _ in chans], np.int32)
            self._chan_dst = np.asarray([d for _, d in chans], np.int32)
            self._chan_lut = np.full((a * a,), -1, np.int32)
            for c, (s, d) in enumerate(chans):
                self._chan_lut[s * a + d] = c
            self._msgs_off = self._net_off + self._n_chan
            self._timer_off = self._msgs_off \
                + self._n_chan * self.channel_depth * self.msg_width
        else:
            self._sw = 2 + self.msg_width  # hdr, count, msg words
            self._timer_off = self._net_off \
                + self.net_capacity * self._sw
        # crash–restart: one extra word of per-actor nibbles right after
        # the timer word — bits [0..2] = crash count, bit 3 = down. Only
        # present when injection is configured, so the packed layout (and
        # every fingerprint) of existing models is untouched.
        a = len(self.actor_widths)
        if self.max_crashes_:
            if a > 8:
                raise NotImplementedError(
                    "crash_restart() on the device engine packs per-actor "
                    "crash nibbles into one word: at most 8 actors")
            if self.max_crashes_ > 7:
                raise NotImplementedError(
                    "crash_restart(max_crashes=k) supports k <= 7 on the "
                    "device engine (3-bit crash counters)")
            self._crash_off = self._timer_off + 1
            self._crash_idx = np.asarray(self._crashable_indices(),
                                         np.int32)
            owner = np.zeros((self._aw,), np.int32)
            durable = np.zeros((self._aw,), np.uint32)
            for i in range(a):
                lo, hi = self._actor_off[i], self._actor_off[i + 1]
                owner[lo:hi] = i
                mask = list(self.durable_word_mask(i))
                if len(mask) != self.actor_widths[i]:
                    raise ValueError(
                        f"durable_word_mask({i}) returned {len(mask)} "
                        f"entries; the declared actor width is "
                        f"{self.actor_widths[i]}")
                durable[lo:hi] = [1 if m else 0 for m in mask]
            self._word_owner = owner
            self._word_durable = durable
            self._hist_off = self._crash_off + 1
        else:
            self._hist_off = self._timer_off + 1
        self.packed_width = self._hist_off + self.history_width
        if self.history_width:
            # host properties (e.g. consistency testers) read the history
            self.host_property_cols = (self._hist_off, self.history_width)

    def crash_restart(self, max_crashes, actors=None):
        """See :meth:`ActorModel.crash_restart`. Unlike ``lossy_network``
        this changes the packed layout (the crash-nibble word), so the
        layout is recomputed if already finalized."""
        super().crash_restart(max_crashes, actors)
        if hasattr(self, "_actor_off"):
            self.finalize_layout()
        return self

    @property
    def max_actions(self) -> int:
        # a lossy network doubles the axis: action E + e drops slot e;
        # ``device_timers`` appends one Timeout lane per actor and
        # ``crash_restart`` one Crash + one Restart lane per crashable
        # actor. Computed on demand because ``lossy_network(...)`` may be
        # set after construction (the compiled-program caches key on it).
        if self._net_ordered:
            if self.lossy_network_:
                raise NotImplementedError(_LOSSY_ORDERED_MESSAGE)
            if self.max_crashes_:
                raise NotImplementedError(_CRASH_ORDERED_MESSAGE)
            n = self._n_chan
        else:
            n = self.net_capacity * (2 if self.lossy_network_ else 1)
        if self.device_timers:
            n += len(self.actor_widths)
        if self.max_crashes_:
            n += 2 * len(self._crash_idx)
        return n

    # --- subclass interface ----------------------------------------------
    def encode_actor(self, index: int, state: Any) -> List[int]:
        raise NotImplementedError

    def decode_actor(self, index: int, words: List[int]) -> Any:
        raise NotImplementedError

    def encode_msg(self, msg: Any) -> List[int]:
        raise NotImplementedError

    def decode_msg(self, words: List[int]) -> Any:
        raise NotImplementedError

    def encode_history(self, history: Any) -> List[int]:
        raise NotImplementedError

    def decode_history(self, words: List[int]) -> Any:
        raise NotImplementedError

    def packed_deliver(self, actors, src, dst, msg):
        """Batched delivery (the plain torch version of the model's
        device function).

        Args:
          actors: int64 ``[N, AW]`` concatenated actor states of ``N``
            lanes (uint32 values);
          src, dst: int64 ``[N]``; msg: int64 ``[N, msg_width]``.
        Returns:
          ``(new_actors int64[N, AW], changed bool[N], sends)``, where
          ``sends`` is a list of ``max_sends`` ``(dst int64[N], msg
          int64[N, msg_width], valid bool[N])`` in emission order.
        """
        raise NotImplementedError

    #: Timeout lanes (``packed_on_timeout``) are not ported: a model that
    #: sets this True is refused by ``packed_step`` (A8's next slice)
    device_timers: bool = False

    # --- crash-restart (``crash_restart``) ----------------------------------
    def durable_word_mask(self, index: int) -> List[int]:
        """Per-word 0/1 mask of actor ``index``'s crash-surviving words.

        A device Crash wipes the non-durable words to zero; the host
        projection (:meth:`_crash_durable`) applies the identical mask
        through the codec, so both engines agree bit for bit. Default:
        all zeros — nothing survives, the fail-stop model."""
        return [0] * self.actor_widths[index]

    def packed_on_restart(self, actors, aidx):
        """Batched restart (the device ``Actor.on_restart``).

        Args:
          actors: int64 ``[N, AW]`` concatenated actor states — actor
            ``aidx``'s words already hold only its durable content (the
            crash wiped the rest);
          aidx: int64 ``[N]`` index of the restarting actor.
        Returns:
          ``(new_actors int64[N, AW], sends like packed_deliver's,
          set_timer bool[N])`` — ``set_timer`` True arms the restarted
          actor's timer.

        Default: adopt the durable words as the new state, emit nothing —
        the mirror of the host default :meth:`_restart_state`. Override
        BOTH together for richer recovery (e.g. announce-rejoin sends).
        """
        n = actors.shape[0]
        zero = torch.zeros((n,), dtype=torch.int64, device=actors.device)
        no = torch.zeros((n,), dtype=torch.bool, device=actors.device)
        zmsg = torch.zeros((n, self.msg_width), dtype=torch.int64,
                           device=actors.device)
        return actors, [(zero, zmsg, no) for _ in range(self.max_sends)], no

    def _crash_durable(self, index: int, state: Any) -> Any:
        """Host-side crash projection: encode, zero the volatile words,
        decode. (The actor-level ``durable()`` hook is bypassed — the
        word mask IS the durable contract for packed models.)"""
        words = self.encode_actor(index, state)
        mask = self.durable_word_mask(index)
        return self.decode_actor(
            index, [int(w) if m else 0 for w, m in zip(words, mask)])

    def _restart_state(self, index: int, durable: Any, out: Out) -> Any:
        """Host-side restart, mirroring the default
        :meth:`packed_on_restart`: adopt the durable projection, emit
        nothing. Override together with ``packed_on_restart``."""
        return durable

    def packed_record_out(self, history, src, dst, msg):
        """Batched ``record_msg_out`` (applied per valid Send): history
        int64 ``[N, history_width]``, ``src``/``dst`` ``[N]``, ``msg``
        ``[N, msg_width]``."""
        return history

    def packed_record_in(self, history, src, dst, msg):
        """Batched ``record_msg_in`` (applied per delivery)."""
        return history

    # --- canonical encode/decode (host side) ------------------------------
    def _slot_sort_key(self, slot_words: Tuple[int, ...]) -> Tuple[int, ...]:
        # (hdr, msg) — the count column (index 1) is not part of the
        # canonical order; (src, dst, msg) is unique per distinct envelope
        if slot_words[0] == 0:  # empty
            return (_EMPTY_SORT_KEY,) + slot_words[2:]
        return (slot_words[0],) + slot_words[2:]

    def encode(self, state: ActorModelState) -> np.ndarray:
        out = np.zeros((self.packed_width,), dtype=np.uint32)
        for i, actor_state in enumerate(state.actor_states):
            off = self._actor_off[i]
            if isinstance(actor_state, Down):
                # a crashed actor's row holds exactly its durable words
                # (the device wipe leaves the masked words in place)
                words = self.encode_actor(i, actor_state.durable)
            else:
                words = self.encode_actor(i, actor_state)
            if len(words) != self.actor_widths[i]:
                raise ValueError(
                    f"encode_actor({i}) returned {len(words)} words; the "
                    f"declared actor width is {self.actor_widths[i]}")
            out[off:off + len(words)] = words
        network = state.network
        if self._net_ordered:
            if not isinstance(network, Ordered):
                raise TypeError(
                    "model was configured with an ordered init network; "
                    f"got {type(network).__name__}")
            a = len(self.actor_widths)
            d, mw = self.channel_depth, self.msg_width
            for (src, dst), msgs in network._channels:
                if int(src) >= a or int(dst) >= a:
                    raise ValueError(
                        f"ordered channel ({src}, {dst}) references an "
                        f"actor index >= {a}; out-of-range recipients "
                        "are not encodable on the device")
                c = int(self._chan_lut[int(src) * a + int(dst)])
                if c < 0:
                    raise ValueError(
                        f"ordered channel ({src}, {dst}) is not in the "
                        "model's declared ordered_channels; declare it "
                        "or drop the declaration for the dense grid")
                if len(msgs) > d:
                    raise ValueError(
                        f"channel ({src}, {dst}) holds {len(msgs)} "
                        f"messages, exceeding channel_depth={d}; raise "
                        "channel_depth to encode this state")
                out[self._net_off + c] = len(msgs)
                for j, msg in enumerate(msgs):
                    off = self._msgs_off + (c * d + j) * mw
                    out[off:off + mw] = self.encode_msg(msg)
        else:
            slots = []
            if isinstance(network, UnorderedNonDuplicating):
                assert not self._net_dup, \
                    "model was configured with a duplicating init network"
                entries = [(env, count) for env, count in network._counts]
            else:
                assert isinstance(network, UnorderedDuplicating) \
                    and self._net_dup, \
                    "PackedActorModel packs the two unordered network " \
                    f"semantics; got {type(network).__name__}"
                entries = [(env, 1) for env in network._set]
            for env, count in entries:
                if int(env.src) >= 256 or int(env.dst) >= 256:
                    raise ValueError(
                        f"envelope ({env.src} -> {env.dst}) does not fit "
                        "the 8-bit src/dst header fields; actor ids >= "
                        "256 are not encodable on the device")
                hdr = _OCC | (int(env.src) << 8) | int(env.dst)
                slots.append(tuple([hdr, count]
                                   + self.encode_msg(env.msg)))
            if len(slots) > self.net_capacity:
                raise ValueError(
                    f"network exceeds net_capacity={self.net_capacity}: "
                    f"{len(slots)} distinct envelopes; raise net_capacity "
                    "to encode this state")
            slots.sort(key=self._slot_sort_key)
            for e, slot in enumerate(slots):
                off = self._net_off + e * self._sw
                out[off:off + self._sw] = slot
        timer = 0
        for i, set_ in enumerate(state.is_timer_set):
            timer |= int(bool(set_)) << i
        out[self._timer_off] = timer
        if self.max_crashes_:
            crashes = state.crashes \
                or (0,) * len(state.actor_states)
            cw = 0
            for i, actor_state in enumerate(state.actor_states):
                cw |= (int(crashes[i]) & 7) << (4 * i)
                if isinstance(actor_state, Down):
                    cw |= 1 << (4 * i + 3)
            out[self._crash_off] = cw
        if self.history_width:
            hwords = self.encode_history(state.history)
            assert len(hwords) == self.history_width
            out[self._hist_off:] = hwords
        return out

    def decode(self, words) -> ActorModelState:
        words = [int(w) for w in words]
        actor_states = tuple(
            self.decode_actor(i, words[self._actor_off[i]:
                                       self._actor_off[i + 1]])
            for i in range(len(self.actor_widths)))
        if self._net_ordered:
            a = len(self.actor_widths)
            d, mw = self.channel_depth, self.msg_width
            channels = {}
            for c in range(self._n_chan):
                ln = words[self._net_off + c]
                if not ln:
                    continue
                msgs = []
                for j in range(ln):
                    off = self._msgs_off + (c * d + j) * mw
                    msgs.append(self.decode_msg(words[off:off + mw]))
                channels[(Id(int(self._chan_src[c])),
                          Id(int(self._chan_dst[c])))] = msgs
            network = Ordered._freeze(channels)
        else:
            counts = {}
            for e in range(self.net_capacity):
                off = self._net_off + e * self._sw
                hdr = words[off]
                if not hdr & _OCC:
                    continue
                env = Envelope(
                    src=Id((hdr >> 8) & 0xFF), dst=Id(hdr & 0xFF),
                    msg=self.decode_msg(words[off + 2:off + self._sw]))
                counts[env] = words[off + 1]
            if self._net_dup:
                network = UnorderedDuplicating(frozenset(counts.keys()))
            else:
                network = UnorderedNonDuplicating(
                    frozenset(counts.items()))
        timer = words[self._timer_off]
        is_timer_set = tuple(bool((timer >> i) & 1)
                             for i in range(len(self.actor_widths)))
        crashes = None
        if self.max_crashes_:
            cw = words[self._crash_off]
            crashes = tuple((cw >> (4 * i)) & 7
                            for i in range(len(self.actor_widths)))
            actor_states = tuple(
                Down(st) if (cw >> (4 * i + 3)) & 1 else st
                for i, st in enumerate(actor_states))
        history = self.decode_history(words[self._hist_off:]) \
            if self.history_width else self.init_history
        return ActorModelState(actor_states=actor_states, network=network,
                               is_timer_set=is_timer_set, history=history,
                               crashes=crashes)

    # --- device step (the plain version, batched torch) ---------------------
    def validate_device_state(self, state: ActorModelState) -> None:
        """Refuse configurations whose transitions the packed action axis
        cannot express: a set timer needs the Timeout lanes, which are
        not ported."""
        if any(state.is_timer_set) and not self.device_timers:
            raise NotImplementedError(
                "PackedActorModel needs device_timers=True (and a "
                "packed_on_timeout kernel) to explore Timeout actions on "
                "the device engine; use the host engines otherwise")

    def unported_lanes(self) -> Optional[str]:
        """Why the port's device step cannot run this configuration (the
        lossy drop lanes, device timers: A8's next slice), or ``None``.
        With neither, the crash/restart lanes follow the delivery lanes
        (``cr_base`` = E)."""
        what = []
        if self.lossy_network_:
            what.append("the lossy drop lanes")
        if self.device_timers:
            what.append("the device timers")
        if not what:
            return None
        return (f"{', '.join(what)} of PackedActorModel wait for A8's next "
                "slice of the port (ROADMAP.md); check this model with "
                "spawn_bfs() or spawn_dfs()")

    def packed_boundary(self, words):
        """Batched ``within_boundary`` of the children ``words`` (int64
        ``[N, W]``): ``bool[N]``, True = keep (default: every child)."""
        return torch.ones((words.shape[0],), dtype=torch.bool,
                          device=words.device)

    def packed_step(self, words):
        """Successors of a ``[F, W]`` batch: ``(succ int64[F, A, W], valid
        bool[F, A], overflow bool[F, A])``, the JAX package's
        ``_packed_step_unordered`` or ``_packed_step_ordered`` lane for
        lane (an overflowing lane is poisoned with ``0xDEADBEEF`` and
        invalid)."""
        reason = self.unported_lanes()
        if reason is not None:
            raise NotImplementedError(reason)
        w = u64(words)
        f, width = w.shape
        a = self.max_actions  # raises for crashes on the ordered network
        rows = w[:, None, :].expand(f, a, width).reshape(f * a, width)
        act = torch.arange(a, device=w.device).repeat(f)
        lanes = (self._step_lanes_ordered if self._net_ordered
                 else self._step_lanes)
        succ, valid, ovf = lanes(rows, act)
        return (succ.reshape(f, a, width), valid.reshape(f, a),
                ovf.reshape(f, a))

    def _step_lanes_ordered(self, rows, c):
        """One delivery per lane on the ordered network: ``rows`` int64
        ``[N, W]``, ``c`` the channel whose head is delivered ``[N]``.
        The head is popped (the channel shifted left, a zero entering at
        its tail, its length less one), then each send appends at the
        tail of the channel ``chan_lut[sender * A + recipient]``; a full
        channel, an undeclared one or a recipient past the actors is an
        overflow. An empty channel's lane delivers its zero head: its
        length wraps to ``0xFFFFFFFF`` in the (invalid) child, as in the
        JAX package."""
        aw, mw = self._aw, self.msg_width
        d, n_chan = self.channel_depth, self._n_chan
        hw = self.history_width
        n = rows.shape[0]
        dev = rows.device
        n_actors = len(self.actor_widths)
        lane = torch.arange(n, device=dev)
        chan_src = torch.from_numpy(self._chan_src.astype(np.int64)).to(dev)
        chan_dst = torch.from_numpy(self._chan_dst.astype(np.int64)).to(dev)
        chan_lut = torch.from_numpy(self._chan_lut.astype(np.int64)).to(dev)
        actors = rows[:, :aw]
        lens = rows[:, self._net_off:self._msgs_off]
        msgs = rows[:, self._msgs_off:self._timer_off].reshape(
            n, n_chan, d, mw)
        rest = rows[:, self._timer_off:self._hist_off]  # timer, crashes
        hist = rows[:, self._hist_off:] if hw else None
        src, dst = chan_src[c], chan_dst[c]
        ln = lens[lane, c]
        head = msgs[lane, c, 0]
        new_actors, changed, sends = self.packed_deliver(actors, src, dst,
                                                         head)
        assert len(sends) == self.max_sends
        any_send = torch.zeros_like(changed)
        for _sdst, _smsg, svalid in sends:
            any_send = any_send | svalid
        valid = (ln > 0) & (changed | any_send)
        # pop the head: the channel shifted left, a zero at its tail
        csel = torch.arange(n_chan, device=dev)[None, :] == c[:, None]
        shifted = torch.cat([msgs[:, :, 1:], torch.zeros_like(
            msgs[:, :, :1])], dim=2)
        msgs = torch.where(csel[:, :, None, None], shifted, msgs)
        lens = torch.where(csel, (lens - 1) & M32, lens)
        if hw:
            hist = self.packed_record_in(hist, src, dst, head)
        overflow = torch.zeros_like(valid)
        slot = torch.arange(d, device=dev)[None, :]
        for sdst, smsg, svalid in sends:
            if hw:
                rec = self.packed_record_out(hist, dst, sdst, smsg)
                hist = torch.where(svalid[:, None], rec, hist)
            flat = torch.clamp(dst * n_actors + sdst,
                               max=n_actors * n_actors - 1)
            cd = chan_lut[flat]
            to = torch.arange(n_chan, device=dev)[None, :] == cd[:, None]
            pos = torch.where(to, lens, 0).sum(dim=1)
            ovf = svalid & ((pos >= d) | (sdst >= n_actors) | (cd < 0))
            put = svalid & ~ovf
            at = to[:, :, None] & (slot == torch.clamp(pos, max=d - 1)[
                :, None])[:, None, :] & put[:, None, None]
            msgs = torch.where(at[:, :, :, None], smsg[:, None, None, :],
                               msgs)
            lens = torch.where(to & put[:, None], (lens + 1) & M32, lens)
            overflow = overflow | ovf
        parts = [new_actors, lens, msgs.reshape(n, -1), rest]
        if hw:
            parts.append(hist)
        row_out = torch.cat(parts, dim=1) & M32
        overflow = valid & overflow
        row_out = torch.where(overflow[:, None],
                              torch.full_like(row_out, 0xDEADBEEF), row_out)
        valid = valid & ~overflow & self.packed_boundary(row_out)
        return row_out, valid, overflow

    def _step_lanes(self, rows, act):
        """One action per lane: ``rows`` int64 ``[N, W]``, ``act`` the
        lane's action ``[N]``: below E the delivery of slot ``act``, then
        (with ``crash_restart``) a crash and a restart lane per crashable
        actor."""
        aw, e_cap, sw = self._aw, self.net_capacity, self._sw
        hw = self.history_width
        n = rows.shape[0]
        dev = rows.device
        actors = rows[:, :aw]
        slots = rows[:, self._net_off:self._timer_off].reshape(n, e_cap, sw)
        hist = rows[:, self._hist_off:] if hw else None
        timer = rows[:, self._timer_off:self._timer_off + 1]
        # the crash-nibble word rides between timer and history; the
        # slice is empty when injection is off
        crash = rows[:, self._timer_off + 1:self._hist_off]
        crashes_on = bool(self.max_crashes_)
        n_actors = len(self.actor_widths)
        e = torch.clamp(act, max=e_cap - 1)
        row = slots[torch.arange(n, device=dev), e]
        hdr = row[:, 0]
        occupied = (hdr & _OCC) != 0
        src = (hdr >> 8) & 0xFF
        dst = hdr & 0xFF
        msg = row[:, 2:]
        new_actors, changed, sends = self.packed_deliver(actors, src, dst,
                                                         msg)
        assert len(sends) == self.max_sends
        any_send = torch.zeros_like(occupied)
        for _sdst, _smsg, svalid in sends:
            any_send = any_send | svalid
        # no-op pruning (model.rs:259-260) + recipient existence
        valid = occupied & (dst < n_actors) & (changed | any_send)
        if crashes_on:
            # a down recipient takes no deliveries (its messages wait in
            # the network until Restart)
            dst_nib = torch.clamp(dst, max=n_actors - 1) * 4
            valid = valid & (((crash[:, 0] >> (dst_nib + 3)) & 1) == 0)
        # a duplicating delivery leaves the envelope in flight
        new_slots = slots if self._net_dup else net_consume(slots, e)
        new_hist = None
        if hw:
            new_hist = self.packed_record_in(hist, src, dst, msg)
        overflow = torch.zeros_like(occupied)
        for sdst, smsg, svalid in sends:
            if hw:
                recorded = self.packed_record_out(new_hist, dst, sdst, smsg)
                new_hist = torch.where(svalid[:, None], recorded, new_hist)
            new_slots, ovf = net_send(new_slots, dst, sdst, smsg, svalid,
                                      dup=self._net_dup)
            overflow = overflow | ovf
        parts = [new_actors, new_slots.reshape(n, -1), timer, crash]
        if hw:
            parts.append(new_hist)
        row_out = torch.cat(parts, dim=1) & M32
        if crashes_on:
            row_out, valid, overflow = self._crash_lanes(
                rows, act, row_out, valid, overflow)
        # an overflowing successor would drop a message: poison the row,
        # invalidate it and report the overflow (the engines raise)
        overflow = valid & overflow
        row_out = torch.where(overflow[:, None],
                              torch.full_like(row_out, 0xDEADBEEF), row_out)
        valid = valid & ~overflow & self.packed_boundary(row_out)
        return row_out, valid, overflow

    def _crash_lanes(self, rows, act, row_out, valid, overflow):
        """The crash/restart lanes over the delivery lanes' results (the
        JAX package's ``_packed_step_unordered`` crash branch): lane
        ``cr_base + c`` crashes the ``c``-th crashable actor — its
        volatile words (``durable_word_mask``) zeroed, its timer bit
        cleared, its crash count bumped and its down bit set; valid iff
        it is up with fewer than ``max_crashes_`` crashes, and never an
        overflow — and lane ``cr_base + n_cr + c`` restarts it — the down
        bit cleared and :meth:`packed_on_restart` run, whose sends go
        through ``record_out`` and the network; valid iff it is down.
        Both write a full child whether valid or not."""
        aw, e_cap, sw = self._aw, self.net_capacity, self._sw
        hw = self.history_width
        n = rows.shape[0]
        dev = rows.device
        actors = rows[:, :aw]
        slots = rows[:, self._net_off:self._timer_off].reshape(n, e_cap, sw)
        hist = rows[:, self._hist_off:] if hw else None
        tw = rows[:, self._timer_off]
        cw = rows[:, self._crash_off]
        n_cr = len(self._crash_idx)
        cr_base = e_cap  # no drop lanes, no timer lanes (unported_lanes)
        is_crash = (act >= cr_base) & (act < cr_base + n_cr)
        is_restart = act >= cr_base + n_cr
        ci = torch.clamp(torch.where(is_restart, act - cr_base - n_cr,
                                     act - cr_base), 0, n_cr - 1)
        crash_idx = torch.from_numpy(self._crash_idx.astype(np.int64)).to(dev)
        aidx = crash_idx[ci]
        nib = aidx * 4
        cnt = (cw >> nib) & 7
        dbit = ((cw >> (nib + 3)) & 1) != 0
        owner = torch.from_numpy(self._word_owner.astype(np.int64)).to(dev)
        durable = torch.from_numpy(self._word_durable.astype(bool)).to(dev)
        wipe = (owner[None, :] == aidx[:, None]) & ~durable[None, :]
        c_actors = torch.where(wipe, 0, actors)
        c_timer = tw & ~(1 << aidx) & M32
        # cnt < max_crashes when valid, so +1 never carries into the down
        # bit
        c_cw = ((cw + (1 << nib)) | (1 << (nib + 3))) & M32
        c_parts = [c_actors, slots.reshape(n, -1), c_timer[:, None],
                   c_cw[:, None]]
        if hw:
            c_parts.append(hist)
        c_row = torch.cat(c_parts, dim=1) & M32
        c_valid = ~dbit & (cnt < self.max_crashes_)

        r_actors, r_sends, r_set_timer = self.packed_on_restart(actors, aidx)
        assert len(r_sends) == self.max_sends
        r_slots = slots
        r_hist = hist
        r_ovf = torch.zeros_like(dbit)
        for sdst, smsg, svalid in r_sends:
            if hw:
                rec = self.packed_record_out(r_hist, aidx, sdst, smsg)
                r_hist = torch.where(svalid[:, None], rec, r_hist)
            r_slots, ovf = net_send(r_slots, aidx, sdst, smsg, svalid,
                                    dup=self._net_dup)
            r_ovf = r_ovf | ovf
        r_timer = tw | (r_set_timer.to(torch.int64) << aidx)
        r_cw = cw & ~(1 << (nib + 3)) & M32
        r_parts = [r_actors, r_slots.reshape(n, -1), r_timer[:, None],
                   r_cw[:, None]]
        if hw:
            r_parts.append(r_hist)
        r_row = torch.cat(r_parts, dim=1) & M32

        row_out = torch.where(is_crash[:, None], c_row, row_out)
        valid = torch.where(is_crash, c_valid, valid)
        overflow = overflow & ~is_crash
        row_out = torch.where(is_restart[:, None], r_row, row_out)
        valid = torch.where(is_restart, dbit, valid)
        overflow = torch.where(is_restart, r_ovf, overflow)
        return row_out, valid, overflow

    # --- fingerprint ------------------------------------------------------
    def fingerprint(self, state: ActorModelState) -> int:
        from ..fingerprint import fp64_words
        return fp64_words(self.encode(state).tolist())


def net_consume(slots, e):
    """Deliver slot ``e`` of each lane (``slots`` int64 ``[N, E, 2 + mw]``,
    ``e`` ``[N]``): decrement its count, or at a count of at most one
    remove it by shifting the suffix up one row (a zeroed row enters at
    the tail), which keeps the sorted-by-(hdr, msg) order."""
    e_cap = slots.shape[1]
    idx = torch.arange(e_cap, device=slots.device)[None, :]
    rowsel = idx == e[:, None]
    count = torch.where(rowsel, slots[:, :, 1], 0).sum(dim=1)
    emptied = count <= 1
    slots = slots.clone()
    slots[:, :, 1] = torch.where(rowsel, (slots[:, :, 1] - 1) & M32,
                                 slots[:, :, 1])
    up = torch.cat([slots[:, 1:], torch.zeros_like(slots[:, :1])], dim=1)
    return torch.where((emptied[:, None] & (idx >= e[:, None]))[:, :, None],
                       up, slots)


def net_send(slots, src, dst, msg, valid, dup: bool = False):
    """Send one envelope per lane (``src``, ``dst`` ``[N]``, ``msg``
    ``[N, mw]``, where ``valid``): bump the matching slot's count in
    place, or insert ``[hdr, 1, msg]`` at its ``(hdr, msg)`` rank by
    shifting the suffix down one row (the last row is empty whenever
    there is an empty row). Returns ``(slots, overflowed)``: no empty
    row, or a recipient at or above 256 (it would not fit the 8-bit
    header field), is an overflow. A duplicating network (``dup``) is a
    set: re-sending a present envelope changes nothing."""
    e_cap, sw = slots.shape[1], slots.shape[2]
    idx = torch.arange(e_cap, device=slots.device)[None, :]
    hdr = _OCC | ((src << 8) & M32) | dst
    occupied = (slots[:, :, 0] & _OCC) != 0
    match = occupied & (slots[:, :, 0] == hdr[:, None]) \
        & (slots[:, :, 2:] == msg[:, None, :]).all(dim=2)
    has_match = match.any(dim=1)
    has_empty = (~occupied).any(dim=1)
    if not dup:
        slots = slots.clone()
        slots[:, :, 1] = torch.where(match & valid[:, None],
                                     (slots[:, :, 1] + 1) & M32,
                                     slots[:, :, 1])
    # fresh: lexicographic rank of (hdr, msg) among the occupied rows
    lt = torch.zeros_like(occupied)
    eq = torch.ones_like(occupied)
    for col in (0,) + tuple(range(2, sw)):
        ref = hdr if col == 0 else msg[:, col - 2]
        c = slots[:, :, col]
        lt = lt | (eq & (c < ref[:, None]))
        eq = eq & (c == ref[:, None])
    pos = (occupied & lt).sum(dim=1)
    new_slot = torch.cat([hdr[:, None], torch.ones_like(hdr)[:, None], msg],
                         dim=1)
    down = torch.cat([torch.zeros_like(slots[:, :1]), slots[:, :-1]], dim=1)
    oob = dst >= 256
    do_ins = valid & ~has_match & has_empty & ~oob
    slots = torch.where((do_ins[:, None] & (idx > pos[:, None]))[:, :, None],
                        down, slots)
    slots = torch.where((do_ins[:, None] & (idx == pos[:, None]))[:, :, None],
                        new_slot[:, None, :], slots)
    overflowed = valid & ((~has_match & ~has_empty) | oob)
    return slots, overflowed
