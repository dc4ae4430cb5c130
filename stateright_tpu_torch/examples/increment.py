"""Shared-counter race: N threads read then write-increment without a lock.

A copy of ``stateright_tpu/examples/increment.py`` (the Rust crate's
``examples/increment.rs``): each thread runs ``1: local = SHARED; 2:
SHARED = local + 1; 3:`` with the two instructions atomic but
interleavable. The intended invariant "SHARED == number of finished
threads" (property ``fin``) is falsifiable by design, so a run stops at
its counterexample. The full 2-thread space has 13 unique states (8
under symmetry reduction); 3 threads 84, 4 threads 755.

The packed side is written twice: in torch here (the plain version,
batched over the frontier) and as CUDA device functions in
``csrc/increment.cuh`` (what the step kernel runs), the representative
under thread permutation (a sort of the thread words) too.

Run: ``python -m stateright_tpu_torch.examples.increment check-gpu
[THREAD_COUNT] [--cpu]``
"""

from __future__ import annotations

import sys
from typing import List, Tuple

import numpy as np
import torch

from ..checker.representative import RewritePlan
from ..core import Expectation, Property
from ..models.packed import PackedModel, check_cuda_model
from ..ops.words import M32, u64
from . import not_ported, parse_args

# state: (i, ((t, pc), ...)) — shared counter, per-thread (local, counter)
State = Tuple[int, Tuple[Tuple[int, int], ...]]


class Increment(PackedModel):
    """N racing increment threads (``increment.rs:147-204``)."""

    def __init__(self, n: int):
        if not 1 <= n <= 16:
            raise ValueError("packed Increment supports 1 to 16 threads")
        self.n = n
        self.packed_width = 1 + n
        self.max_actions = n

    def cache_key(self):
        return ("increment", self.n)

    def cuda_spec(self, symmetry: bool = False):
        """``("increment", (n,))``: the kernel runs
        ``csrc/increment.cuh``, under ``symmetry`` with its sort of the
        thread words. A subclass that changes the step, the encoding,
        the properties or (under ``symmetry``) the representative is
        refused."""
        check_cuda_model(self, Increment, "increment.cuh",
                         (("fin", Expectation.ALWAYS),), 1 + self.n,
                         self.n, symmetry)
        return "increment", (self.n,)

    # --- host side -------------------------------------------------------
    def init_states(self) -> List[State]:
        return [(0, ((0, 1),) * self.n)]

    def actions(self, state: State, actions: List) -> None:
        _i, s = state
        for thread_id in range(self.n):
            pc = s[thread_id][1]
            if pc == 1:
                actions.append(("Read", thread_id))
            elif pc == 2:
                actions.append(("Write", thread_id))

    def next_state(self, state: State, action) -> State:
        i, s = state
        kind, tid = action
        if kind == "Read":
            s = s[:tid] + ((i, 2),) + s[tid + 1:]
            return (i, s)
        t = s[tid][0]
        s = s[:tid] + ((t, 3),) + s[tid + 1:]
        return ((t + 1) & 0xFF, s)

    def properties(self) -> List[Property]:
        return [Property.always(
            "fin",
            lambda _, state: sum(1 for t, pc in state[1] if pc == 3)
            == state[0])]

    def representative(self, state: State) -> State:
        """Sort the (identical) threads' states (``increment.rs:143-153``)."""
        i, s = state
        plan = RewritePlan.from_values_to_sort(s)
        return (i, tuple(plan.reindex(s)))

    def format_action(self, action) -> str:
        return f"{action[0]}({action[1]})"

    # --- packed side: [i, thread_0, ..., thread_n-1], thread = t<<4 | pc --
    def encode(self, state: State) -> np.ndarray:
        i, s = state
        return np.array([i] + [(t << 4) | pc for t, pc in s],
                        dtype=np.uint32)

    def decode(self, words) -> State:
        i = int(words[0])
        s = tuple((int(w) >> 4, int(w) & 0xF) for w in words[1:self.n + 1])
        return (i, s)

    def packed_representative(self, words):
        """Canonical rows of a ``[F, n + 1]`` batch: the thread words
        sorted (int64 values) — bit-exact with :meth:`representative`,
        since a thread word is ``t << 4 | pc`` and the host's stable sort
        of the (t, pc) tuples orders them as the integers (pc < 16);
        equal words are identical, so ties need no order."""
        w = u64(words)
        threads = torch.sort(w[:, 1:self.n + 1], dim=1).values
        return torch.cat([w[:, :1], threads, w[:, self.n + 1:]], dim=1)

    def packed_step(self, words):
        """Successors of a ``[F, n + 1]`` batch: lane ``tid`` is thread
        ``tid``'s Read (pc 1: local = i, pc 2) or Write (pc 2: i = local
        + 1, pc 3), the lane order of the JAX package and of
        ``csrc/increment.cuh``."""
        w = u64(words)
        n = self.n
        i = w[:, 0:1]
        threads = w[:, 1:n + 1]
        t, pc = threads >> 4, threads & 0xF
        is_read = pc == 1
        new_thread = torch.where(is_read, ((i << 4) & M32) | 2,
                                 (t << 4) | 3)
        new_i = torch.where(is_read, i, (t + 1) & 0xFF)
        succ = w[:, None, :].repeat(1, n, 1)
        lanes = torch.arange(n, device=w.device)
        succ[:, lanes, 0] = new_i
        succ[:, lanes, 1 + lanes] = new_thread
        return succ, (pc == 1) | (pc == 2)

    def packed_properties(self, words):
        w = u64(words)
        fin = ((w[:, 1:self.n + 1] & 0xF) == 3).sum(dim=1)
        return (fin == w[:, 0])[:, None]


def main(argv=None) -> int:
    cmd, thread_count, opts = parse_args(argv)
    module = "stateright_tpu_torch.examples.increment"
    model = Increment(thread_count)
    if cmd == "check":
        print(f"Model checking increment with {thread_count} threads.")
        model.checker().spawn_dfs().report(sys.stdout)
        return 0
    if cmd == "check-sym":
        print(f"Model checking increment with {thread_count} threads "
              "using symmetry reduction.")
        (model.checker().symmetry_fn(model.representative)
         .spawn_dfs().report(sys.stdout))
        return 0
    if cmd == "check-gpu":
        print(f"Model checking increment with {thread_count} threads "
              "on the GPU engine.")
        model.checker().gpu_options(**opts).spawn_gpu().report(sys.stdout)
        return 0
    if cmd == "check-gpu-sym":
        print(f"Model checking increment with {thread_count} threads "
              "on the GPU engine using symmetry reduction.")
        (model.checker().symmetry_fn(model.representative)
         .gpu_options(**opts).spawn_gpu().report(sys.stdout))
        return 0
    if cmd == "explore":
        return not_ported(module, cmd)
    print("USAGE:")
    for sub in ("check", "check-sym", "check-gpu", "check-gpu-sym"):
        print(f"  python -m {module} {sub} [THREAD_COUNT] [--cpu] "
              "[--no-race]")
    print("  (explore: not ported)")
    return 2


if __name__ == "__main__":
    sys.exit(main())
