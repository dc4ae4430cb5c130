"""Two-phase commit, from Gray & Lamport's "Consensus on Transaction Commit".

A copy of ``stateright_tpu/models/twopc.py`` (the same protocol as the
Rust ``stateright`` crate's ``examples/2pc.rs``): N resource managers
(RMs) and one transaction manager (TM) exchange messages through a
persistent message set. Oracle counts: 3 RMs -> 288 unique states,
5 RMs -> 8,832, 7 RMs -> 296,448; under RM-permutation symmetry with
``complete_symmetry=True`` 5 RMs -> 314 orbits, 7 -> 920, 16 -> 21,335.

The whole state packs into 4 uint32 words (RM states as 2-bit fields, TM
state, a prepared bitmask and a message bitset). The packed side is
written twice: in torch here (the plain version, vectorised over the
frontier) and as CUDA device functions in ``csrc/twopc.cuh`` (what the
step kernel runs). So is the representative under RM permutation:
:meth:`TwoPhaseSys.packed_representative` in torch, ``canon`` in
``csrc/twopc.cuh``.

State (host view): ``(rm_state, tm_state, tm_prepared, msgs)`` where
``rm_state`` is a tuple of per-RM codes, ``tm_prepared`` a tuple of 0/1 and
``msgs`` a frozenset of message codes. Message codes: ``rm`` for
Prepared{rm}, 16 for Commit, 17 for Abort (N <= 16).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..checker.representative import RewritePlan
from ..core import Expectation, Property
from ..ops.words import M32, u64
from .packed import PackedModel, check_cuda_model

# RM state codes, in the reference's Ord order (RmState in 2pc.rs:27).
WORKING, PREPARED, COMMITTED, ABORTED = 0, 1, 2, 3
# TM state codes (TmState in 2pc.rs:30).
TM_INIT, TM_COMMITTED, TM_ABORTED = 0, 1, 2
MSG_COMMIT = 16
MSG_ABORT = 17

State = Tuple[Tuple[int, ...], int, Tuple[int, ...], frozenset]

#: the properties ``props`` of ``csrc/twopc.cuh`` evaluates, bit for bit
_CUDA_PROPERTIES = (("abort agreement", Expectation.SOMETIMES),
                    ("commit agreement", Expectation.SOMETIMES),
                    ("consistent", Expectation.ALWAYS))


class TwoPhaseSys(PackedModel):
    packed_width = 4

    def __init__(self, n: int, complete_symmetry: bool = False):
        """``complete_symmetry=True`` swaps the reference's sort-by-RM-
        state representative (``2pc.rs:165-182``: ties broken by original
        position, so a reduced count depends on the order the engine
        explores in) for an orbit-invariant one that sorts the complete
        per-RM record (state, prepared bit, Prepared-message bit). Every
        engine then reduces to exactly the orbit partition: 314 classes
        at n=5."""
        if not 1 <= n <= 16:
            raise ValueError("packed 2pc supports 1 to 16 RMs")
        self.n = n
        self.complete_symmetry = bool(complete_symmetry)
        self.max_actions = 2 + 5 * n

    def cache_key(self):
        return ("twopc", self.n, self.complete_symmetry)

    def cuda_spec(self, symmetry: bool = False):
        """The kernel runs ``csrc/twopc.cuh``: TwoPhaseSys's own packed
        step, encoding and three properties, and under ``symmetry`` its
        own representative (``canon``, the mode of
        ``complete_symmetry``). A subclass that changes any of them would
        get TwoPhaseSys's verdicts from the card, so it is refused here
        (its plain version still runs on the CPU). Returns the kernel's
        name and integer parameters: ``(n,)``, or under ``symmetry``
        ``(n, complete)``."""
        check_cuda_model(self, TwoPhaseSys, "twopc.cuh", _CUDA_PROPERTIES,
                         4, 2 + 5 * self.n, symmetry)
        if symmetry:
            return "twopc", (self.n, int(self.complete_symmetry))
        return "twopc", (self.n,)

    # ------------------------------------------------------------------
    # Host side (2pc.rs:43-121 of the Rust crate)
    # ------------------------------------------------------------------
    def init_states(self) -> List[State]:
        return [((WORKING,) * self.n, TM_INIT, (0,) * self.n, frozenset())]

    def actions(self, state: State, actions: List) -> None:
        rm_state, tm_state, tm_prepared, msgs = state
        if tm_state == TM_INIT and all(tm_prepared):
            actions.append(("TmCommit",))
        if tm_state == TM_INIT:
            actions.append(("TmAbort",))
        for rm in range(self.n):
            if tm_state == TM_INIT and rm in msgs:
                actions.append(("TmRcvPrepared", rm))
            if rm_state[rm] == WORKING:
                actions.append(("RmPrepare", rm))
            if rm_state[rm] == WORKING:
                actions.append(("RmChooseToAbort", rm))
            if MSG_COMMIT in msgs:
                actions.append(("RmRcvCommitMsg", rm))
            if MSG_ABORT in msgs:
                actions.append(("RmRcvAbortMsg", rm))

    def next_state(self, state: State, action) -> State:
        rm_state, tm_state, tm_prepared, msgs = state
        kind = action[0]
        if kind == "TmRcvPrepared":
            rm = action[1]
            tm_prepared = tm_prepared[:rm] + (1,) + tm_prepared[rm + 1:]
        elif kind == "TmCommit":
            tm_state = TM_COMMITTED
            msgs = msgs | {MSG_COMMIT}
        elif kind == "TmAbort":
            tm_state = TM_ABORTED
            msgs = msgs | {MSG_ABORT}
        elif kind == "RmPrepare":
            rm = action[1]
            rm_state = rm_state[:rm] + (PREPARED,) + rm_state[rm + 1:]
            msgs = msgs | {rm}
        elif kind == "RmChooseToAbort":
            rm = action[1]
            rm_state = rm_state[:rm] + (ABORTED,) + rm_state[rm + 1:]
        elif kind == "RmRcvCommitMsg":
            rm = action[1]
            rm_state = rm_state[:rm] + (COMMITTED,) + rm_state[rm + 1:]
        elif kind == "RmRcvAbortMsg":
            rm = action[1]
            rm_state = rm_state[:rm] + (ABORTED,) + rm_state[rm + 1:]
        else:
            raise ValueError(f"unknown action {action!r}")
        return (rm_state, tm_state, tm_prepared, msgs)

    def properties(self) -> List[Property]:
        return [
            Property.sometimes(
                "abort agreement",
                lambda _, s: all(r == ABORTED for r in s[0])),
            Property.sometimes(
                "commit agreement",
                lambda _, s: all(r == COMMITTED for r in s[0])),
            Property.always(
                "consistent",
                lambda _, s: not (any(r == ABORTED for r in s[0])
                                  and any(r == COMMITTED for r in s[0]))),
        ]

    def representative(self, state: State) -> State:
        """Canonical member under RM-permutation symmetry: the
        reference's sort-by-RM-state (``2pc.rs:165-182``), or the
        orbit-invariant complete-record sort under
        ``complete_symmetry``."""
        rm_state, tm_state, tm_prepared, msgs = state
        if self.complete_symmetry:
            keys = [(rm_state[i], tm_prepared[i],
                     1 if i in msgs else 0) for i in range(self.n)]
            plan = RewritePlan.from_values_to_sort(keys)
        else:
            plan = RewritePlan.from_values_to_sort(rm_state)
        return (
            tuple(plan.reindex(rm_state)),
            tm_state,
            tuple(plan.reindex(tm_prepared)),
            frozenset(plan.rewrite(m) if m < 16 else m for m in msgs),
        )

    def format_action(self, action) -> str:
        return action[0] + (f"({action[1]})" if len(action) > 1 else "")

    # ------------------------------------------------------------------
    # Packed side: words = [rm_fields, tm_state, prepared_bits, msg_bits]
    # ------------------------------------------------------------------
    def encode(self, state: State) -> np.ndarray:
        rm_state, tm_state, tm_prepared, msgs = state
        rmw = 0
        for i, r in enumerate(rm_state):
            rmw |= r << (2 * i)
        prep = 0
        for i, p in enumerate(tm_prepared):
            prep |= int(bool(p)) << i
        msgw = 0
        for m in msgs:
            msgw |= 1 << m
        return np.array([rmw, tm_state, prep, msgw], dtype=np.uint32)

    def decode(self, words) -> State:
        rmw, tm_state, prep, msgw = (int(w) for w in words)
        rm_state = tuple((rmw >> (2 * i)) & 3 for i in range(self.n))
        tm_prepared = tuple((prep >> i) & 1 for i in range(self.n))
        msgs = frozenset(m for m in range(18) if msgw & (1 << m))
        return (rm_state, tm_state, tm_prepared, msgs)

    def packed_representative(self, words):
        """Canonical rows of a ``[F, 4]`` batch under RM permutation
        (int64 values): a stable sort of the per-RM (state, prepared,
        message) triples by RM state (bit-exact with the reference-style
        :meth:`representative`), or by the packed complete record
        ``state*4 + prepared*2 + message`` (the host's tuple order) under
        ``complete_symmetry``. Message bits ``>= n`` (Commit, Abort) pass
        through. The JAX package's counterpart canonicalizes one row;
        this one a batch."""
        w = u64(words)
        n = self.n
        idx = torch.arange(n, dtype=torch.int64, device=w.device)
        r = (w[:, 0:1] >> (2 * idx)) & 3
        p = (w[:, 2:3] >> idx) & 1
        m = (w[:, 3:4] >> idx) & 1  # message bit i: RM i sent Prepared
        key = (r << 2) | (p << 1) | m if self.complete_symmetry else r
        order = torch.sort(key, dim=1, stable=True).indices
        r, p, m = (x.gather(1, order) for x in (r, p, m))
        rest = w[:, 3] & (~((1 << n) - 1) & M32)
        return torch.stack([(r << (2 * idx)).sum(1), w[:, 1],
                            (p << idx).sum(1), (m << idx).sum(1) | rest],
                           dim=1)

    def packed_step(self, words):
        """Successors of a ``[F, 4]`` batch. Action lanes, in order:
        TmCommit, TmAbort, then per RM i: TmRcvPrepared(i) for all i,
        RmPrepare(i), RmChooseToAbort(i), RmRcvCommitMsg(i),
        RmRcvAbortMsg(i) — the lane order of the JAX package's
        ``packed_step`` and of ``csrc/twopc.cuh``."""
        w = u64(words)
        n = self.n
        rmw, tm, prep, msgs = w[:, 0:1], w[:, 1:2], w[:, 2:3], w[:, 3:4]
        idx = torch.arange(n, dtype=torch.int64, device=w.device)
        shift = 2 * idx
        fields = (rmw >> shift) & 3                      # [F, n]
        is_working = fields == WORKING
        cleared = rmw & (~(3 << shift) & M32)
        rm_bit = 1 << idx
        all_mask = (1 << n) - 1
        tm_init = tm == TM_INIT                          # [F, 1]
        has_commit = (msgs & (1 << MSG_COMMIT)) != 0
        has_abort = (msgs & (1 << MSG_ABORT)) != 0

        def rows(w0, w1, w2, w3):
            shape = torch.broadcast_shapes(w0.shape, w1.shape, w2.shape,
                                           w3.shape)
            return torch.stack([x.expand(shape) for x in
                                (w0, w1, w2, w3)], dim=2)

        ones = torch.ones_like(rmw)
        succ = torch.cat([
            rows(rmw, ones * TM_COMMITTED, prep,
                 msgs | (1 << MSG_COMMIT)),                  # TmCommit
            rows(rmw, ones * TM_ABORTED, prep,
                 msgs | (1 << MSG_ABORT)),                   # TmAbort
            rows(rmw, tm, prep | rm_bit, msgs),              # TmRcvPrepared
            rows(cleared | (PREPARED << shift), tm, prep,
                 msgs | rm_bit),                             # RmPrepare
            rows(cleared | (ABORTED << shift), tm, prep,
                 msgs),                                      # RmChooseToAbort
            rows(cleared | (COMMITTED << shift), tm, prep,
                 msgs),                                      # RmRcvCommitMsg
            rows(cleared | (ABORTED << shift), tm, prep,
                 msgs),                                      # RmRcvAbortMsg
        ], dim=1)
        f = w.shape[0]
        valid = torch.cat([
            tm_init & ((prep & all_mask) == all_mask),
            tm_init,
            tm_init & ((msgs & rm_bit) != 0),
            is_working,
            is_working,
            has_commit.expand(f, n),
            has_abort.expand(f, n),
        ], dim=1)
        return succ, valid

    def packed_properties(self, words):
        rmw = u64(words)[:, 0:1]
        n = self.n
        pat_aborted = sum(ABORTED << (2 * i) for i in range(n))
        pat_committed = sum(COMMITTED << (2 * i) for i in range(n))
        idx = torch.arange(n, dtype=torch.int64, device=rmw.device)
        fields = (rmw >> (2 * idx)) & 3
        return torch.cat([
            rmw == pat_aborted,
            rmw == pat_committed,
            ~((fields == ABORTED).any(dim=1, keepdim=True)
              & (fields == COMMITTED).any(dim=1, keepdim=True)),
        ], dim=1)
