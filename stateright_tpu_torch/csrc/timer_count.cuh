// The timer-count fixture as CUDA device functions: the packed step and
// the property bits of stateright_tpu_torch/actor/test_util.py
// (PackedTimerCount.packed_step / packed_properties: the JAX package's
// _packed_step_unordered with its Timeout lanes and PackedTimerCount's
// packed_on_timeout, stateright_tpu/actor/test_util.py:239), for n <= 32
// actors (the timer word's bits) as a runtime argument.
//
// Packed state (actor/packed.py finalize_layout), width n + 4: [actor a's
// count x n | [hdr, count, msg]: the network's one slot | timer (bit a:
// actor a's timer)]. Action lane 0 delivers the slot (never valid: the
// actors take no message, and the network stays empty), lane 1 + a fires
// actor a's timer.
//
// A narrow model (a thread a lane, as increment.cuh): the row and the
// child are register arrays of W words walked to the runtime width by
// unrolled selects (words.cuh), so they stay in registers.
#pragma once

#include <cstdint>

#include "words.cuh"

struct TimerCountModel {
  static constexpr int W = 32 + 4;  // the most packed words (n = 32)

  int n;
  uint32_t max_nat;

  __host__ TimerCountModel(int actors, int max_nat_)
      : n(actors), max_nat((uint32_t)max_nat_) {}

  __host__ bool ok() const { return n >= 1 && n <= 32 && (int)max_nat >= 0; }

  __host__ __device__ int width() const { return n + 4; }
  __host__ int max_actions() const { return n + 1; }

  // Successor of w under action lane act into s; returns whether it is a
  // valid child (nothing overflows: no handler sends). Lane 0 consumes the
  // slot (its count less one, or at most one the slot zeroed), invalid.
  // Lane 1 + a: actor a's count plus one, its timer bit cleared and set
  // again while the new count stays below max_nat; valid iff the bit was
  // set (a Timeout is never pruned as a no-op).
  __device__ __forceinline__ bool step(const uint32_t (&w)[W], int act,
                                       uint32_t (&s)[W], bool& ovf) const {
    ovf = false;
#pragma unroll
    for (int k = 0; k < W; ++k) s[k] = w[k];
    if (act == 0) {
      const uint32_t cnt = word_at(w, n + 1);
      if (cnt > 1u) {
        set_word(s, n + 1, cnt - 1u);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (k >= n && k < n + 3) s[k] = 0u;
      }
      return false;
    }
    const int a = act - 1;
    const uint32_t c = word_at(w, a) + 1u;
    set_word(s, a, c);
    const uint32_t tw = word_at(w, n + 3);
    const bool keep = c < max_nat;
    set_word(s, n + 3, (tw & ~(1u << a)) | ((keep ? 1u : 0u) << a));
    return (tw >> a) & 1u;
  }

  // Bit 0 "bounded" (every count at most max_nat), bit 1 "all max".
  __device__ __forceinline__ uint32_t props(const uint32_t (&w)[W]) const {
    bool bounded = true, all = true;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (k < n) {
        bounded &= w[k] <= max_nat;
        all &= w[k] == max_nat;
      }
    }
    return (bounded ? 1u : 0u) | (all ? 2u : 0u);
  }
};
