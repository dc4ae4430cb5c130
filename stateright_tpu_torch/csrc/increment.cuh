// The increment race as CUDA device functions: the packed step, the
// property bit and the representative under thread permutation of
// stateright_tpu_torch/examples/increment.py (Increment.packed_step /
// packed_properties / packed_representative), with the number of
// threads n (1..16) as a runtime argument. The representative is taken
// once per frontier row (row_canon: the thread words sorted) and
// carried to each successor by moving the one thread word the action
// changed (canon_child).
//
// Packed state, width n + 1: w[0] the shared counter i, w[1 + k] thread
// k's word t << 4 | pc (t its local copy, pc 1 before the read, 2 after
// it, 3 after the write). Action lane k is thread k's Read (pc 1) or
// Write (pc 2). The row arrays hold W = 17 words, the most n allows;
// only the first width() are the state (step_common.cuh walks those).
#pragma once

#include <cstdint>

#include "words.cuh"

struct IncrementModel {
  static constexpr int W = 17;  // the most packed words (n = 16)

  int n;  // threads (1..16)

  __host__ explicit IncrementModel(int threads) : n(threads) {}

  __host__ __device__ int width() const { return n + 1; }
  __host__ int max_actions() const { return n; }

  // Successor of w under action lane k into s; returns whether thread k
  // can read or write. The counter is a byte, so nothing overflows.
  __device__ __forceinline__ bool step(const uint32_t (&w)[W], int k,
                                       uint32_t (&s)[W], bool& ovf) const {
    const uint32_t i = w[0];
    const uint32_t u = word_at(w, 1 + k);
    const uint32_t pc = u & 0xFu;
#pragma unroll
    for (int j = 0; j < W; ++j) s[j] = w[j];
    s[0] = next_i(i, u);
    set_word(s, 1 + k, next_thread(i, u));
    return pc == 1u || pc == 2u;
  }

  // Bit 0: "fin" (threads with pc == 3 == i).
  __device__ __forceinline__ uint32_t props(const uint32_t (&w)[W]) const {
    uint32_t fin = 0;
#pragma unroll
    for (int j = 1; j < W; ++j)
      if (j <= n) fin += (w[j] & 0xFu) == 3u;
    return fin == w[0] ? 1u : 0u;
  }

  // The row's thread words in ascending order, and each thread's
  // position in that order (ties by thread index, so the positions are
  // distinct).
  struct RowCanon {
    uint32_t srt[16];
    uint8_t pos[16];
  };

  // canon(w), bit-exact with Increment.packed_representative (a sort of
  // the uint32 thread words; equal words are identical, so ties need no
  // order): each thread's rank counted over the others, O(n^2)
  // comparisons once per row, in registers.
  __device__ __forceinline__ void row_canon(const uint32_t (&w)[W],
                                            RowCanon& rc) const {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < n) {
        const uint32_t v = w[1 + k];
        uint32_t rank = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (j < n)
            rank += w[1 + j] < v || (w[1 + j] == v && j < k);
        rc.pos[k] = (uint8_t)rank;
        rc.srt[rank] = v;
      }
    }
  }

  // canon(s) into c for the successor s of row w under action lane k,
  // from the row's rc. s differs from w only in the counter and thread
  // k's word: its old word leaves the sorted list at pos[k] (the others
  // stay sorted) and the new word v enters after every remaining word
  // below it. Each output word is picked from the list with static
  // indices, so the list stays in registers.
  __device__ __forceinline__ void canon_child(const RowCanon& rc,
                                              const uint32_t (&w)[W], int k,
                                              const uint32_t (&s)[W],
                                              uint32_t (&c)[W]) const {
    uint32_t srt[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) srt[j] = j < n ? rc.srt[j] : 0u;
    const int p = rc.pos[k];
    const uint32_t v = next_thread(w[0], rc.srt[p]);
    int to = 0;  // remaining words below v
#pragma unroll
    for (int j = 0; j < 16; ++j) to += j < n && j != p && srt[j] < v;
    c[0] = s[0];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      // the list without p: r[j] = srt[j < p ? j : j + 1]
      const uint32_t here = j < p ? srt[j] : srt[j + 1 < 16 ? j + 1 : 15];
      const uint32_t below =
          j == 0 ? 0u : (j - 1 < p ? srt[j - 1] : srt[j]);
      if (j < n) c[1 + j] = j < to ? here : j == to ? v : below;
    }
  }

 private:
  // Thread word u's successor word and the counter after its action:
  // Read (pc 1) copies the counter and goes to pc 2; Write (pc 2)
  // writes t + 1 and goes to pc 3. (A disabled lane's values are never
  // valid children.)
  static __device__ __forceinline__ uint32_t next_thread(uint32_t i,
                                                         uint32_t u) {
    return (u & 0xFu) == 1u ? (i << 4) | 2u : (u & ~0xFu) | 3u;
  }
  static __device__ __forceinline__ uint32_t next_i(uint32_t i, uint32_t u) {
    return (u & 0xFu) == 1u ? i : ((u >> 4) + 1u) & 0xFFu;
  }
};
