// Two-phase commit as CUDA device functions: the packed step, the
// property bits, the lane order and the representative under RM
// permutation of stateright_tpu_torch/models/twopc.py
// (``TwoPhaseSys.packed_step`` / ``packed_properties`` /
// ``packed_representative``), with the number of resource managers n and
// the representative's mode as runtime arguments. The representative is
// taken once per frontier row (row_canon) and carried to each successor
// by moving the one RM the action changed (canon_child).
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

  // The canonical member of a row's class under RM permutation, and
  // what K1 needs to canonicalize each of the row's successors without
  // sorting again (row_canon fills it once per row, canon_child uses it
  // per lane).
  struct RowCanon {
    uint32_t r2, p2, m2;  // canon(w): RM fields, prepared and message
                          // bits (< n) in sorted order
    uint16_t mask[16];    // the RMs of each key
    uint8_t pos[16];      // each RM's position in the sorted order
    uint8_t off[16];      // how many RMs have a smaller key
  };

  // canon(w), bit-exact with TwoPhaseSys.packed_representative: a stable
  // sort of the RMs by key, k = r (reference mode: the RM state, 4
  // values) or k = r << 2 | p << 1 | m (complete mode: state, prepared
  // bit, Prepared-message bit, 16 values), each RM's (r, p, m) moved to
  // its sorted position. A counting sort in registers: the key
  // histogram is held as byte counters (counts <= 16) in two 64-bit
  // words, one multiply turns it into exclusive prefix sums, and each RM
  // takes the next position of its key in original order, so ties keep
  // it (stable).
  __device__ __forceinline__ void row_canon(const uint32_t (&w)[W],
                                            RowCanon& rc) const {
    const uint32_t rmw = w[0], prep = w[2], msgs = w[3];
    constexpr unsigned long long kBytes = 0x0101010101010101ull;
    unsigned long long h0 = 0, h1 = 0;  // counts of keys 0..7, 8..15
    for (int k = 0; k < 16; ++k) rc.mask[k] = 0;
    for (int i = 0; i < n; ++i) {
      const uint32_t k = key(rmw, prep, msgs, i);
      const unsigned long long one = 1ull << (8 * (k & 7u));
      if (k < 8u) h0 += one; else h1 += one;
      rc.mask[k] |= (uint16_t)(1u << i);
    }
    // exclusive prefix sums of the 16 byte counters
    unsigned long long o0 = (h0 * kBytes) << 8;
    unsigned long long o1 = ((h1 * kBytes) << 8) + ((h0 * kBytes) >> 56) *
                                                        kBytes;
    for (int k = 0; k < 8; ++k) {
      rc.off[k] = (uint8_t)(o0 >> (8 * k));
      rc.off[8 + k] = (uint8_t)(o1 >> (8 * k));
    }
    uint32_t r2 = 0, p2 = 0, m2 = 0;
    for (int i = 0; i < n; ++i) {
      const uint32_t k = key(rmw, prep, msgs, i);
      const int sh = 8 * (int)(k & 7u);
      const bool low = k < 8u;
      const uint32_t pos = (uint32_t)((low ? o0 : o1) >> sh) & 0xFFu;
      const unsigned long long inc = 1ull << sh;
      o0 += low ? inc : 0ull;
      o1 += low ? 0ull : inc;
      rc.pos[i] = (uint8_t)pos;
      r2 |= ((rmw >> (2 * i)) & 3u) << (2 * pos);
      p2 |= ((prep >> i) & 1u) << pos;
      m2 |= ((msgs >> i) & 1u) << pos;
    }
    rc.r2 = r2;
    rc.p2 = p2;
    rc.m2 = m2;
  }

  // canon(s) into c for the successor s of row w under action lane a,
  // from the row's rc. s differs from w only in the TM state, the
  // message bits >= n and the (r, p, m) of the lane's RM i (none for
  // TmCommit and TmAbort): removing RM i from w's sorted order leaves
  // the others sorted, and RM i enters where its new key k1 puts it,
  // after every other RM with a smaller key and every RM j < i with key
  // k1 (ties keep original order) — the same order the stable sort of s
  // gives. Three word edits instead of a sort per lane.
  __device__ __forceinline__ void canon_child(const RowCanon& rc,
                                              const uint32_t (&w)[W], int a,
                                              const uint32_t (&s)[W],
                                              uint32_t (&c)[W]) const {
    uint32_t r2 = rc.r2, p2 = rc.p2, m2 = rc.m2;
    if (a >= 2) {
      const int k = a - 2;
      const int i = k - (k / n) * n;
      const uint32_t k0 = key(w[0], w[2], w[3], i);
      const uint32_t k1 = key(s[0], s[2], s[3], i);
      const uint32_t from = rc.pos[i];
      const uint32_t to = rc.off[k1] - (k0 < k1 ? 1u : 0u) +
                          __popc(rc.mask[k1] & ((1u << i) - 1u));
      r2 = move_field<2>(r2, from, to, (s[0] >> (2 * i)) & 3u);
      p2 = move_field<1>(p2, from, to, (s[2] >> i) & 1u);
      m2 = move_field<1>(m2, from, to, (s[3] >> i) & 1u);
    }
    c[0] = r2;
    c[1] = s[1];
    c[2] = p2;
    c[3] = m2 | (s[3] & ~all_mask);
  }

 private:
  // x's B-bit field at position from taken out (the fields above it move
  // down), then v put in at position to (the fields from there up move
  // up); positions < 16, so every shift stays below 32.
  template <int B>
  static __device__ __forceinline__ uint32_t move_field(uint32_t x,
                                                        uint32_t from,
                                                        uint32_t to,
                                                        uint32_t v) {
    const uint32_t lf = (1u << (B * from)) - 1u;
    x = (x & lf) | ((x >> B) & ~lf);
    const uint32_t lt = (1u << (B * to)) - 1u;
    return (x & lt) | (v << (B * to)) | ((x & ~lt) << B);
  }

  __device__ __forceinline__ uint32_t key(uint32_t rmw, uint32_t prep,
                                          uint32_t msgs, int i) const {
    const uint32_t r = (rmw >> (2 * i)) & 3u;
    if (!complete) return r;
    return (r << 2) | (((prep >> i) & 1u) << 1) | ((msgs >> i) & 1u);
  }
};
