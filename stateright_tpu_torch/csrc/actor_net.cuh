// The packed actor system's device functions shared by the register
// protocols (Paxos here; ABD and single-copy in A8's next slice): the
// unordered non-duplicating network of stateright_tpu_torch/actor/
// packed.py (net_consume, net_send), the register client's step and the
// linearizability history's record hooks of actor/packed_register.py
// (_client_step, packed_record_in, packed_record_out), and the row sink
// a wide model writes its child through (RowOut).
//
// They compute what the JAX package's _packed_step_unordered
// (stateright_tpu/actor/packed.py:710, with _net_consume :489 and
// _net_send :519) and the register hooks
// (stateright_tpu/actor/packed_register.py:363-447) compute for one
// (state, action) lane, not the vmapped mask arithmetic: the child's
// network lives in registers as four columns of kMaxSlots words (hdr,
// count, msg[0], msg[1]), every loop over it is unrolled with static
// indices and guarded by the runtime slot count, so nothing goes to
// local memory; the history (1 + 3 C words) lives in registers the
// same way.
#pragma once

#include <cstdint>

namespace actor {

constexpr uint32_t kOcc = 1u << 16;  // the slot-occupied flag of hdr
constexpr int kMaxSlots = 16;        // network slots (net_capacity)
constexpr int kMaxClients = 7;       // register clients
constexpr int kMaxHist = 1 + 3 * kMaxClients;
constexpr uint32_t kPoison = 0xDEADBEEFu;  // an overflowing child's words

// register message type tags (actor/packed_register.py T_*)
constexpr uint32_t T_PUT = 1, T_GET = 2, T_PUTOK = 3, T_GETOK = 4;

// One send of a handler: recipient, the two message words, and whether
// it is emitted.
struct Send {
  uint32_t dst, m0, m1;
  bool valid;
};

__device__ __forceinline__ Send no_send() { return {0u, 0u, 0u, false}; }

// A child's network: slot j is [hdr[j], cnt[j], m0[j], m1[j]], sorted by
// (hdr, m0, m1) with the empty (all-zero) slots last; E slots are live.
struct Net {
  uint32_t hdr[kMaxSlots], cnt[kMaxSlots], m0[kMaxSlots], m1[kMaxSlots];
};

__device__ __forceinline__ void net_load(Net& n, const uint32_t* w,
                                         int E) {
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j) {
    const bool live = j < E;
    n.hdr[j] = live ? w[4 * j] : 0u;
    n.cnt[j] = live ? w[4 * j + 1] : 0u;
    n.m0[j] = live ? w[4 * j + 2] : 0u;
    n.m1[j] = live ? w[4 * j + 3] : 0u;
  }
}

// Slot j takes slot k's words (static indices after unrolling).
__device__ __forceinline__ void net_copy(Net& n, int j, int k) {
  n.hdr[j] = n.hdr[k];
  n.cnt[j] = n.cnt[k];
  n.m0[j] = n.m0[k];
  n.m1[j] = n.m1[k];
}

__device__ __forceinline__ void net_zero(Net& n, int j) {
  n.hdr[j] = n.cnt[j] = n.m0[j] = n.m1[j] = 0u;
}

// Deliver slot e: decrement its count, or at a count of at most one
// remove it by shifting the suffix up one slot (a zeroed slot enters at
// the tail). The count wraps like the JAX uint32 column, but a wrapped
// slot is always the one the shift overwrites.
__device__ __forceinline__ void net_consume(Net& n, int e, int E) {
  uint32_t c = 0u;
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j)
    if (j == e) c = n.cnt[j];
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j)
    if (j == e) n.cnt[j] -= 1u;
  if (c > 1u) return;
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j) {
    if (j >= e && j < E) {
      if (j + 1 < E)
        net_copy(n, j, j + 1 < kMaxSlots ? j + 1 : j);
      else
        net_zero(n, j);
    }
  }
}

// Send (m0, m1) from src to dst where valid: bump the count of the slot
// that holds the envelope, or insert [hdr, 1, m0, m1] at its (hdr, m0,
// m1) rank by shifting the suffix down one slot. Returns the overflow:
// a valid send that finds no match and no empty slot, or a recipient at
// or above 256 (the 8-bit hdr field).
__device__ __forceinline__ bool net_send(Net& n, uint32_t src, uint32_t dst,
                                         uint32_t m0, uint32_t m1,
                                         bool valid, int E) {
  const uint32_t hdr = kOcc | (src << 8) | dst;
  bool has_match = false, has_empty = false;
  int pos = 0;
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j) {
    if (j < E) {
      const bool occ = (n.hdr[j] & kOcc) != 0u;
      const bool match = occ && n.hdr[j] == hdr && n.m0[j] == m0 &&
                         n.m1[j] == m1;
      if (match && valid) n.cnt[j] += 1u;
      has_match |= match;
      has_empty |= !occ;
      // lexicographic (hdr, m0, m1) < the new envelope
      const bool lt = n.hdr[j] < hdr ||
                      (n.hdr[j] == hdr &&
                       (n.m0[j] < m0 || (n.m0[j] == m0 && n.m1[j] < m1)));
      pos += occ && lt;
    }
  }
  const bool oob = dst >= 256u;
  const bool ins = valid && !has_match && has_empty && !oob;
  if (ins) {
#pragma unroll
    for (int j = kMaxSlots - 1; j >= 0; --j) {
      if (j < E) {
        if (j > pos) {
          net_copy(n, j, j > 0 ? j - 1 : 0);
        } else if (j == pos) {
          n.hdr[j] = hdr;
          n.cnt[j] = 1u;
          n.m0[j] = m0;
          n.m1[j] = m1;
        }
      }
    }
  }
  return valid && ((!has_match && !has_empty) || oob);
}

// "value chosen": some occupied slot holds a GetOk of a non-null value
// (w: the network's words in shared memory).
__device__ __forceinline__ bool value_chosen(const uint32_t* w, int E) {
  bool chosen = false;
  for (int j = 0; j < E; ++j) {
    const uint32_t hdr = w[4 * j], m0 = w[4 * j + 2];
    chosen |= ((hdr >> 16) & 1u) && (m0 >> 24) == T_GETOK &&
              (m0 & 0xFu) != 0u;
  }
  return chosen;
}

// The register client's on_msg (put_count = 1): word = flag << 31 |
// awaiting << 8 | op_count; index its actor index (>= S). A PutOk of the
// awaited request sends Get(new request) to server (index + op_count) %
// S; a GetOk of it finishes.
__device__ __forceinline__ uint32_t client_step(uint32_t index,
                                                uint32_t word, uint32_t m0,
                                                int S, bool& changed,
                                                Send& s0) {
  const bool has_awaiting = (word >> 31) & 1u;
  const uint32_t awaiting = (word >> 8) & 0xFFu;
  const uint32_t opc = word & 0xFu;
  const uint32_t mtype = m0 >> 24, a = (m0 >> 12) & 0xFFFu;
  const bool putok = mtype == T_PUTOK && has_awaiting && a == awaiting;
  const bool getok = mtype == T_GETOK && has_awaiting && a == awaiting;
  const uint32_t new_req = (opc + 1u) * index;
  changed = putok || getok;
  s0 = putok ? Send{(index + opc) % (uint32_t)S,
                    (T_GET << 24) | (new_req << 12), 0u, true}
             : no_send();
  return putok ? (1u << 31) | (new_req << 8) | (opc + 1u)
               : getok ? (opc + 1u) & 0xFu : word;
}

// The linearizability history: h[0] the valid bit, then per client t
// (actor S + t) its entries e0, e1 and its in-flight word.
struct Hist {
  uint32_t h[kMaxHist];
};

__device__ __forceinline__ void hist_load(Hist& x, const uint32_t* w,
                                          int hw) {
#pragma unroll
  for (int i = 0; i < kMaxHist; ++i) x.h[i] = i < hw ? w[i] : 0u;
}

// record_invocations: a Put or Get sent by client t sets its in-flight
// word (kind, value and the peers' completed counts, 2 bits each in peer
// order) unless one is in flight, which invalidates the history.
__device__ __forceinline__ void record_out(Hist& x, int S, int C,
                                           uint32_t src, uint32_t m0) {
  const uint32_t mtype = m0 >> 24;
  const bool is_put = mtype == T_PUT;
  if (!(is_put || mtype == T_GET) || !(x.h[0] & 1u)) return;
  uint32_t counts[kMaxClients];
#pragma unroll
  for (int t = 0; t < kMaxClients; ++t)
    counts[t] = t < C ? ((x.h[1 + 3 * t] >> 31) & 1u) +
                            ((x.h[2 + 3 * t] >> 31) & 1u)
                      : 0u;
  bool invalidate = false;
#pragma unroll
  for (int t = 0; t < kMaxClients; ++t) {
    if (t < C && src == (uint32_t)(S + t)) {
      uint32_t& infl = x.h[3 + 3 * t];
      if ((infl >> 31) & 1u) {
        invalidate = true;
      } else {
        uint32_t lc = 0u;
#pragma unroll
        for (int p = 0; p < kMaxClients; ++p)
          if (p < C && p != t) lc += counts[p] << (2 * (p < t ? p : p - 1));
        infl = (1u << 31) | ((is_put ? 0u : 1u) << 30) |
               ((is_put ? m0 & 0xFu : 0u) << 26) | lc;
      }
    }
  }
  if (invalidate) x.h[0] &= ~1u;
}

// record_returns: a GetOk or PutOk delivered to client t completes its
// in-flight operation into its first free entry (with the read value);
// without one in flight the history is invalidated.
__device__ __forceinline__ void record_in(Hist& x, int S, int C,
                                          uint32_t dst, uint32_t m0) {
  const uint32_t mtype = m0 >> 24;
  const bool is_getok = mtype == T_GETOK;
  if (!(is_getok || mtype == T_PUTOK) || !(x.h[0] & 1u)) return;
  const uint32_t retval = is_getok ? m0 & 0xFu : 0u;
  bool invalidate = false;
#pragma unroll
  for (int t = 0; t < kMaxClients; ++t) {
    if (t < C && dst == (uint32_t)(S + t)) {
      uint32_t& e0 = x.h[1 + 3 * t];
      uint32_t& e1 = x.h[2 + 3 * t];
      uint32_t& infl = x.h[3 + 3 * t];
      if (!((infl >> 31) & 1u)) {
        invalidate = true;
      } else {
        const uint32_t entry = infl | (retval << 22);
        if (!((e0 >> 31) & 1u))
          e0 = entry;
        else
          e1 = entry;
        infl = 0u;
      }
    }
  }
  if (invalidate) x.h[0] &= ~1u;
}

}  // namespace actor
