"""Shared counter with a lock: the fixed version of the increment race.

A copy of ``stateright_tpu/examples/increment_lock.py`` (the Rust
crate's ``examples/increment_lock.rs``): each thread acquires a global
lock, reads, write-increments, and releases. Properties ``fin`` (the
counter equals the finished threads) and ``mutex`` (at most one thread
in the critical section) both hold. Unique states: 61 at 3 threads,
54,797 at 7, 438,401 at 8, 3,945,637 at 9. A BASELINE.md config.

The packed side is written in torch here (the plain version) and as
CUDA device functions in ``csrc/increment_lock.cuh``. The JAX package's
model has no ``packed_representative``, so symmetry reduction is refused
on the GPU engine, as on the JAX package's device engines.

Run: ``python -m stateright_tpu_torch.examples.increment_lock check-gpu
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
from . import check_gpu, not_ported, parse_args

# state: (i, lock, ((t, pc), ...))
State = Tuple[int, bool, Tuple[Tuple[int, int], ...]]


class IncrementLock(PackedModel):
    """N lock-protected increment threads (``increment_lock.rs:47-107``)."""

    def __init__(self, n: int):
        if not 1 <= n <= 16:
            raise ValueError("packed IncrementLock supports 1 to 16 "
                             "threads")
        self.n = n
        self.packed_width = 2 + n
        self.max_actions = n

    def cache_key(self):
        return ("increment_lock", self.n)

    def cuda_spec(self, symmetry: bool = False):
        """``("increment_lock", (n,))``: the kernel runs
        ``csrc/increment_lock.cuh``. There is no device representative,
        so ``symmetry`` is refused, as is a subclass that changes the
        step, the encoding or the properties."""
        if symmetry:
            raise NotImplementedError(
                "IncrementLock has no packed_representative")
        check_cuda_model(self, IncrementLock, "increment_lock.cuh",
                         (("fin", Expectation.ALWAYS),
                          ("mutex", Expectation.ALWAYS)), 2 + self.n,
                         self.n, symmetry)
        return "increment_lock", (self.n,)

    # --- host side -------------------------------------------------------
    def init_states(self) -> List[State]:
        return [(0, False, ((0, 0),) * self.n)]

    def actions(self, state: State, actions: List) -> None:
        _i, lock, s = state
        for thread_id in range(self.n):
            pc = s[thread_id][1]
            if pc == 0 and not lock:
                actions.append(("Lock", thread_id))
            elif pc == 1:
                actions.append(("Read", thread_id))
            elif pc == 2:
                actions.append(("Write", thread_id))
            elif pc == 3 and lock:
                actions.append(("Release", thread_id))

    def next_state(self, state: State, action) -> State:
        i, lock, s = state
        kind, tid = action
        t, pc = s[tid]
        if kind == "Lock":
            return (i, True, s[:tid] + ((t, 1),) + s[tid + 1:])
        if kind == "Read":
            return (i, lock, s[:tid] + ((i, 2),) + s[tid + 1:])
        if kind == "Write":
            return ((t + 1) & 0xFF, lock, s[:tid] + ((t, 3),) + s[tid + 1:])
        assert kind == "Release"
        return (i, False, s[:tid] + ((t, 4),) + s[tid + 1:])

    def properties(self) -> List[Property]:
        return [
            Property.always(
                "fin",
                lambda _, state: sum(1 for t, pc in state[2] if pc >= 3)
                == state[0]),
            Property.always(
                "mutex",
                lambda _, state: sum(1 for t, pc in state[2]
                                     if 1 <= pc < 4) <= 1),
        ]

    def representative(self, state: State) -> State:
        i, lock, s = state
        plan = RewritePlan.from_values_to_sort(s)
        return (i, lock, tuple(plan.reindex(s)))

    def format_action(self, action) -> str:
        return f"{action[0]}({action[1]})"

    # --- packed side: [i, lock, thread_0, ...], thread = t<<4 | pc --------
    def encode(self, state: State) -> np.ndarray:
        i, lock, s = state
        return np.array([i, int(lock)] + [(t << 4) | pc for t, pc in s],
                        dtype=np.uint32)

    def decode(self, words) -> State:
        i = int(words[0])
        lock = bool(int(words[1]))
        s = tuple((int(w) >> 4, int(w) & 0xF) for w in words[2:self.n + 2])
        return (i, lock, s)

    def packed_step(self, words):
        """Successors of a ``[F, n + 2]`` batch: lane ``tid`` is thread
        ``tid``'s one enabled action (Lock, Read, Write or Release by its
        pc), the lane order of the JAX package and of
        ``csrc/increment_lock.cuh``."""
        w = u64(words)
        n = self.n
        i, lock = w[:, 0:1], w[:, 1:2]
        threads = w[:, 2:n + 2]
        t, pc = threads >> 4, threads & 0xF
        can_lock = (pc == 0) & (lock == 0)
        is_read = pc == 1
        is_write = pc == 2
        can_release = (pc == 3) & (lock == 1)
        new_pc = torch.where(can_lock, 1, torch.where(
            is_read, 2, torch.where(is_write, 3, 4)))
        new_t = torch.where(is_read, i, t)
        new_i = torch.where(is_write, (t + 1) & 0xFF, i)
        new_lock = torch.where(can_lock, 1,
                               torch.where(can_release, 0, lock))
        succ = w[:, None, :].repeat(1, n, 1)
        lanes = torch.arange(n, device=w.device)
        succ[:, lanes, 0] = new_i
        succ[:, lanes, 1] = new_lock
        succ[:, lanes, 2 + lanes] = ((new_t << 4) & M32) | new_pc
        return succ, can_lock | is_read | is_write | can_release

    def packed_properties(self, words):
        w = u64(words)
        pc = w[:, 2:self.n + 2] & 0xF
        fin = (pc >= 3).sum(dim=1) == w[:, 0]
        crit = ((pc >= 1) & (pc < 4)).sum(dim=1) <= 1
        return torch.stack([fin, crit], dim=1)


def main(argv=None) -> int:
    cmd, thread_count, opts = parse_args(argv)
    module = "stateright_tpu_torch.examples.increment_lock"
    if cmd in ("check", "check-sym", "explore"):
        return not_ported(module, cmd)
    if cmd == "check-gpu":
        print(f"Model checking increment_lock with {thread_count} threads "
              "on the GPU engine.")
        return check_gpu(IncrementLock(thread_count).checker()
                         .gpu_options(**opts))
    print("USAGE:")
    print(f"  python -m {module} check-gpu [THREAD_COUNT] [--cpu]")
    print("  (check, check-sym and explore: not ported)")
    return 2


if __name__ == "__main__":
    sys.exit(main())
