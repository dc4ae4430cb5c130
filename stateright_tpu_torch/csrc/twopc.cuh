// Two-phase commit as CUDA device functions: the packed step, the
// property bits, the lane order and the representative under RM
// permutation of stateright_tpu_torch/models/twopc.py
// (``TwoPhaseSys.packed_step`` / ``packed_properties`` /
// ``packed_representative``), with the number of resource managers n and
// the representative's mode as runtime arguments.
//
// Packed state: w[0] RM states (2 bits per RM), w[1] TM state, w[2]
// prepared bitmask, w[3] message bits (bit i = Prepared{i}, bit 16 =
// Commit, bit 17 = Abort). Action lanes: TmCommit, TmAbort, then five
// families of n lanes each: TmRcvPrepared(i), RmPrepare(i),
// RmChooseToAbort(i), RmRcvCommitMsg(i), RmRcvAbortMsg(i).
#pragma once

#include <cstdint>

struct TwoPcModel {
  static constexpr int W = 4;  // packed words per state

  int n;                   // resource managers (1..16)
  int complete;            // canon sorts by the complete per-RM record
  uint32_t all_mask;       // (1 << n) - 1
  uint32_t pat_aborted;    // every RM field == ABORTED (3)
  uint32_t pat_committed;  // every RM field == COMMITTED (2)

  __host__ explicit TwoPcModel(int rms, int complete_symmetry = 0)
      : n(rms), complete(complete_symmetry) {
    all_mask = (rms >= 32) ? 0xFFFFFFFFu : ((1u << rms) - 1u);
    pat_aborted = 0;
    pat_committed = 0;
    for (int i = 0; i < rms; ++i) {
      pat_aborted |= 3u << (2 * i);
      pat_committed |= 2u << (2 * i);
    }
  }

  __host__ int max_actions() const { return 2 + 5 * n; }

  // Successor of w under action lane a into s; returns whether the action
  // is enabled. 2pc's encoding cannot overflow, so ovf is left untouched.
  __device__ __forceinline__ bool step(const uint32_t (&w)[W], int a,
                                       uint32_t (&s)[W], bool& ovf) const {
    const uint32_t rmw = w[0], tm = w[1], prep = w[2], msgs = w[3];
    s[0] = rmw;
    s[1] = tm;
    s[2] = prep;
    s[3] = msgs;
    const bool tm_init = tm == 0u;
    if (a == 0) {  // TmCommit
      s[1] = 1u;
      s[3] = msgs | (1u << 16);
      return tm_init && (prep & all_mask) == all_mask;
    }
    if (a == 1) {  // TmAbort
      s[1] = 2u;
      s[3] = msgs | (1u << 17);
      return tm_init;
    }
    const int k = a - 2;
    const int family = k / n;
    const int i = k - family * n;
    const uint32_t shift = 2u * (uint32_t)i;
    const uint32_t field = (rmw >> shift) & 3u;
    const uint32_t cleared = rmw & ~(3u << shift);
    const uint32_t bit = 1u << i;
    switch (family) {
      case 0:  // TmRcvPrepared(i)
        s[2] = prep | bit;
        return tm_init && (msgs & bit) != 0u;
      case 1:  // RmPrepare(i)
        s[0] = cleared | (1u << shift);
        s[3] = msgs | bit;
        return field == 0u;
      case 2:  // RmChooseToAbort(i)
        s[0] = cleared | (3u << shift);
        return field == 0u;
      case 3:  // RmRcvCommitMsg(i)
        s[0] = cleared | (2u << shift);
        return (msgs & (1u << 16)) != 0u;
      default:  // RmRcvAbortMsg(i)
        s[0] = cleared | (3u << shift);
        return (msgs & (1u << 17)) != 0u;
    }
  }

  // Bit p is property p: "abort agreement", "commit agreement",
  // "consistent".
  __device__ __forceinline__ uint32_t props(const uint32_t (&w)[W]) const {
    const uint32_t rmw = w[0];
    bool any_aborted = false, any_committed = false;
    for (int i = 0; i < n; ++i) {
      const uint32_t f = (rmw >> (2 * i)) & 3u;
      any_aborted |= f == 3u;
      any_committed |= f == 2u;
    }
    return (rmw == pat_aborted ? 1u : 0u) |
           (rmw == pat_committed ? 2u : 0u) |
           (!(any_aborted && any_committed) ? 4u : 0u);
  }

  // The canonical member of w's class under RM permutation into c,
  // bit-exact with TwoPhaseSys.packed_representative: a stable sort of
  // the RMs by key, k = r (reference mode: the RM state, 4 values) or
  // k = r << 2 | p << 1 | m (complete mode: state, prepared bit,
  // Prepared-message bit, 16 values), each RM's (r, p, m) moved to its
  // sorted position. A counting sort in registers: the key histogram is
  // held as byte counters (counts <= 16) in two 64-bit words, one
  // multiply turns it into exclusive prefix sums, and each RM takes the
  // next position of its key in original order, so ties keep it
  // (stable). Message bits >= n (Commit, Abort) pass through.
  __device__ __forceinline__ void canon(const uint32_t (&w)[W],
                                        uint32_t (&c)[W]) const {
    const uint32_t rmw = w[0], prep = w[2], msgs = w[3];
    constexpr unsigned long long kBytes = 0x0101010101010101ull;
    unsigned long long h0 = 0, h1 = 0;  // counts of keys 0..7, 8..15
    for (int i = 0; i < n; ++i) {
      const uint32_t k = key(rmw, prep, msgs, i);
      const unsigned long long one = 1ull << (8 * (k & 7u));
      if (k < 8u) h0 += one; else h1 += one;
    }
    // exclusive prefix sums of the 16 byte counters
    unsigned long long o0 = (h0 * kBytes) << 8;
    unsigned long long o1 = ((h1 * kBytes) << 8) + ((h0 * kBytes) >> 56) *
                                                        kBytes;
    uint32_t r2 = 0, p2 = 0, m2 = 0;
    for (int i = 0; i < n; ++i) {
      const uint32_t k = key(rmw, prep, msgs, i);
      const int sh = 8 * (int)(k & 7u);
      const bool low = k < 8u;
      const uint32_t pos = (uint32_t)((low ? o0 : o1) >> sh) & 0xFFu;
      const unsigned long long inc = 1ull << sh;
      o0 += low ? inc : 0ull;
      o1 += low ? 0ull : inc;
      r2 |= ((rmw >> (2 * i)) & 3u) << (2 * pos);
      p2 |= ((prep >> i) & 1u) << pos;
      m2 |= ((msgs >> i) & 1u) << pos;
    }
    c[0] = r2;
    c[1] = w[1];
    c[2] = p2;
    c[3] = m2 | (msgs & ~all_mask);
  }

 private:
  __device__ __forceinline__ uint32_t key(uint32_t rmw, uint32_t prep,
                                          uint32_t msgs, int i) const {
    const uint32_t r = (rmw >> (2 * i)) & 3u;
    if (!complete) return r;
    return (r << 2) | (((prep >> i) & 1u) << 1) | ((msgs >> i) & 1u);
  }
};
