// The lock-protected increment threads as CUDA device functions: the
// packed step and the property bits of
// stateright_tpu_torch/examples/increment_lock.py
// (IncrementLock.packed_step / packed_properties), with the number of
// threads n (1..16) as a runtime argument.
//
// Packed state, width n + 2: w[0] the shared counter i, w[1] the lock,
// w[2 + k] thread k's word t << 4 | pc (t its local copy, pc its
// program counter: 0 before the lock, 1 holding it, 2 read, 3 written,
// 4 released). Action lane k is thread k's one enabled action, chosen by
// its pc: Lock (pc 0, lock free), Read (1), Write (2), Release (3, lock
// held). The row arrays hold W = 18 words, the most n allows; only the
// first width() are the state (step_common.cuh walks those).
#pragma once

#include <cstdint>

#include "words.cuh"

struct IncrementLockModel {
  static constexpr int W = 18;  // the most packed words (n = 16)

  int n;  // threads (1..16)

  __host__ explicit IncrementLockModel(int threads) : n(threads) {}

  __host__ __device__ int width() const { return n + 2; }
  __host__ int max_actions() const { return n; }

  // Successor of w under action lane k into s; returns whether thread
  // k's action is enabled. The counter is a byte, so nothing overflows.
  __device__ __forceinline__ bool step(const uint32_t (&w)[W], int k,
                                       uint32_t (&s)[W], bool& ovf) const {
    const uint32_t i = w[0], lock = w[1];
    const uint32_t u = word_at(w, 2 + k);
    const uint32_t t = u >> 4, pc = u & 0xFu;
    const bool can_lock = pc == 0u && lock == 0u;
    const bool is_read = pc == 1u;
    const bool is_write = pc == 2u;
    const bool can_release = pc == 3u && lock == 1u;
    const uint32_t new_pc = can_lock ? 1u : is_read ? 2u : is_write ? 3u : 4u;
    const uint32_t new_t = is_read ? i : t;
#pragma unroll
    for (int j = 0; j < W; ++j) s[j] = w[j];
    s[0] = is_write ? (t + 1u) & 0xFFu : i;
    s[1] = can_lock ? 1u : can_release ? 0u : lock;
    set_word(s, 2 + k, (new_t << 4) | new_pc);
    return can_lock || is_read || is_write || can_release;
  }

  // Bit 0: "fin" (threads with pc >= 3 == i); bit 1: "mutex" (at most
  // one thread with 1 <= pc < 4).
  __device__ __forceinline__ uint32_t props(const uint32_t (&w)[W]) const {
    uint32_t fin = 0, crit = 0;
#pragma unroll
    for (int j = 2; j < W; ++j) {
      if (j < n + 2) {
        const uint32_t pc = w[j] & 0xFu;
        fin += pc >= 3u;
        crit += pc >= 1u && pc < 4u;
      }
    }
    return (fin == w[0] ? 1u : 0u) | (crit <= 1u ? 2u : 0u);
  }
};
