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
// A timer model (step_common.cuh TimerRow): K1 keeps the tile's rows in
// shared memory, each folded and read for its property bits and active
// lanes by a group of lanes, a lane a column (row_fold). Its active lanes
// are the Timeout lanes whose timer bit is set (bit a of the mask is lane
// 1 + a, so 32 actors' 33 lanes fit it): each one's child is the row with
// its count and at most its timer word changed (timer_edit), a thread's,
// whose fingerprint is the row's folds with those words refolded
// (timer_fold) and whose words the block writes from the shared row with
// the edit applied (timer_word). Every other lane's child is invalid and
// never overflows: K1 leaves its row of flat unwritten.
#pragma once

#include <cstdint>

#include "fold.cuh"

struct TimerCountModel {
  static constexpr int W = 32 + 4;  // the most packed words (n = 32)
  static constexpr bool kTimerRow = true;

  int n;
  uint32_t max_nat;

  // Timeout lane 1 + col's child: column col holds count, column n + 3
  // timer; every other word is the row's.
  struct Edit {
    uint32_t col, count, timer;
  };

  __host__ TimerCountModel(int actors, int max_nat_)
      : n(actors), max_nat((uint32_t)max_nat_) {}

  __host__ bool ok() const { return n >= 1 && n <= 32 && (int)max_nat >= 0; }

  __host__ __device__ int width() const { return n + 4; }
  __host__ int max_actions() const { return n + 1; }

  // Row w by a group g of lanes, lane r taking columns r, r + g.size(),
  // ...: its fingerprint folds (h1, h2: every lane gets them); pb the
  // property bits (bit 0 "bounded": every count at most max_nat, bit 1
  // "all max"); lanes the Timeout lanes with a valid child: the timer
  // word's bits of the n actors (bit a, lane 1 + a: a Timeout is never
  // pruned as a no-op). Every lane of the group calls it.
  template <class G>
  __device__ __forceinline__ void row_fold(const uint32_t* w, const G& g,
                                           uint32_t& h1, uint32_t& h2,
                                           uint32_t& pb,
                                           uint32_t& lanes) const {
    uint32_t x1 = 0u, x2 = 0u, tw = 0u;
    bool over = false, below = false;
    for (int k = g.rank(); k < n + 4; k += g.size()) {
      const uint32_t v = w[k];
      fold_word(x1, x2, k, v);
      if (k < n) {
        over |= v > max_nat;
        below |= v != max_nat;
      }
      if (k == n + 3) tw = v;
    }
    h1 = g.xor_all(x1);
    h2 = g.xor_all(x2);
    lanes = g.xor_all(tw) & (n >= 32 ? ~0u : (1u << n) - 1u);
    const bool bounded = g.ballot(over) == 0u;
    const bool all = g.ballot(below) == 0u;
    pb = (bounded ? 1u : 0u) | (all ? 2u : 0u);
  }

  // Timeout lane 1 + a of row w (its timer bit set): actor a's count plus
  // one, its timer bit cleared and set again while the new count stays
  // below max_nat.
  __device__ __forceinline__ Edit timer_edit(const uint32_t* w, int a) const {
    const uint32_t c = w[a] + 1u, tw = w[n + 3];
    return {(uint32_t)a, c,
            (tw & ~(1u << a)) | ((c < max_nat ? 1u : 0u) << a)};
  }

  // The child's fingerprint: the row's folds (r1, r2) with the count and,
  // where it changed, the timer word refolded.
  __device__ __forceinline__ void timer_fold(const uint32_t* w,
                                             const Edit& ed, uint32_t r1,
                                             uint32_t r2, uint32_t& hi,
                                             uint32_t& lo) const {
    fold_change(r1, r2, (int)ed.col, w[ed.col], ed.count);
    if (ed.timer != w[n + 3]) fold_change(r1, r2, n + 3, w[n + 3], ed.timer);
    fp64_finish(r1, r2, n + 4, hi, lo);
  }

  // Word k of the child, old the row's.
  __device__ __forceinline__ uint32_t timer_word(const Edit& ed, int k,
                                                 uint32_t old) const {
    return k == (int)ed.col ? ed.count : k == n + 3 ? ed.timer : old;
  }
};
