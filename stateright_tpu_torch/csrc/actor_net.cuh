// The packed actor system's device functions shared by the register
// protocols (csrc/paxos.cuh, abd.cuh, single_copy.cuh): the unordered
// non-duplicating network of stateright_tpu_torch/actor/packed.py
// (net_consume, net_send), the ordered network's FIFO channels
// (reg_chan, OrderedEdit, OrderedHead), the register client's step and the
// linearizability history's record hooks of actor/packed_register.py
// (_client_step, packed_record_in, packed_record_out), and the steps a
// register model runs: register_step_unordered, which writes the child
// through step_common.cuh's RowOut (Paxos), register_step_group, which
// builds it with a group of lanes holding the network (ABD and the
// single-copy register on the unordered network), and
// register_edit_ordered with ordered_child_word, which describe the
// child as the row plus an edit (ABD on the ordered network); and the
// crash/restart lanes of a model that has them (crash_restart: M::kCrash,
// CrashSpec below; Paxos under crashes, the write-once register), whose
// children are the row with at most one actor's words, the timer word and
// the crash word changed (crash_edit, crash_word; crash_fingerprint, a
// thread's, and crash_copy, a group's); and a
// delivery's child in two phases, its scalar part once a child
// (register_deliver_scalar) and its network and words by a group
// (register_deliver_group: the write-once register); the lossy drop lanes
// of a model that has them (M::kLossy: Paxos on a lossy network), whose
// children are the row with one count word less one or the network's
// words from the dropped slot on moved up a slot (drop_edit, drop_word;
// drop_fingerprint, a thread's, and drop_copy, a warp's); and the
// unordered network of a narrow model's register row with one message
// word a slot, the duplicating network's set semantics among them
// (row_net_consume, row_net_send: the ping-pong fixture).
//
// They compute what the JAX package's _packed_step_unordered
// (stateright_tpu/actor/packed.py:710, with _net_consume :489 and
// _net_send :519), _packed_step_ordered (:588) and the register hooks
// (stateright_tpu/actor/packed_register.py:363-447) compute for one
// (state, action) lane, not the vmapped mask arithmetic: the child's
// unordered network lives in registers as four columns of kMaxSlots
// words (hdr, count, msg[0], msg[1]), every loop over it is unrolled
// with static indices and guarded by the runtime slot count, so nothing
// goes to local memory; the history (1 + 3 C words) lives in registers
// the same way.
#pragma once

#include <cstdint>
#include <type_traits>

#include "fold.cuh"

namespace actor {

constexpr uint32_t kOcc = 1u << 16;  // the slot-occupied flag of hdr
constexpr int kMaxSlots = 16;        // network slots (net_capacity)
constexpr int kMaxClients = 7;       // register clients
constexpr int kMaxHist = 1 + 3 * kMaxClients;
constexpr uint32_t kPoison = 0xDEADBEEFu;  // an overflowing child's words

// register message type tags (actor/packed_register.py T_*)
constexpr uint32_t T_PUT = 1, T_GET = 2, T_PUTOK = 3, T_GETOK = 4;

// The crash/restart lanes of a model (ActorModel.crash_restart, the
// packed layout of actor/packed.py finalize_layout): with k > 0 the crash
// word follows the timer word (actor a's nibble at bits 4 a: bits 0-2 its
// crash count, bit 3 down) and the history follows it; lane E + c crashes
// the c-th crashable actor (its index in nibble c of idx), lane E + n + c
// restarts it. Bit j of the durable mask (dur_lo, then dur_hi) keeps word
// j of the actors' words through a crash (durable_word_mask); at most 8
// actors, 8 crashable ones, k <= 7 and 64 actor words.
struct CrashSpec {
  int k;                    // crashes an actor may take (0: no crash word)
  int n;                    // the crashable actors
  uint32_t idx;             // the c-th crashable actor's index, nibble c
  uint32_t dur_lo, dur_hi;  // the durable actor words, bit j = word j

  __host__ __device__ uint32_t actor(int c) const {
    return (idx >> (4 * c)) & 0xFu;
  }
  __host__ __device__ bool durable(int j) const {
    return j < 32 ? (dur_lo >> j) & 1u : (dur_hi >> (j - 32)) & 1u;
  }
  // the spec over `actors` actors of aw words in all, with E delivery
  // lanes (the lane mask holds at most 32 lanes)
  __host__ bool ok(int actors, int aw, int E) const {
    if (k < 0 || k > 7 || n < 0 || n > 8 || actors > 8 || aw > 64 ||
        E + 2 * n > 32 || (k == 0 && n > 0))
      return false;
    for (int c = 0; c < n; ++c)
      if (actor(c) >= (uint32_t)actors) return false;
    return true;
  }
};

// Whether M has the crash/restart lanes (M::kCrash and a CrashSpec cr);
// models without the member compile to their steps as they were.
template <class M, class = void>
struct HasCrash : std::false_type {};
template <class M>
struct HasCrash<M, std::void_t<decltype(M::kCrash)>>
    : std::integral_constant<bool, M::kCrash> {};

// Whether actor a is down in crash word cw.
__host__ __device__ __forceinline__ bool is_down(uint32_t cw, uint32_t a) {
  return (cw >> (4 * a + 3)) & 1u;
}

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

// The network's zero tail: the first slot from which every slot of the
// E is all-zero words (a sorted network's empty slots; E when the last
// slot holds a word). Delivering a slot there changes nothing: it
// carries no message, and consuming it shifts zeros.
__device__ __forceinline__ int zero_tail(const uint32_t* w, int E) {
  int z = E;
  while (z > 0 && (w[4 * z - 4] | w[4 * z - 3] | w[4 * z - 2] |
                   w[4 * z - 1]) == 0u)
    --z;
  return z;
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

// The register dispatch (packed_register.py packed_deliver) of a
// delivery of (m0, m1) from src to dst on row w: the server step on the
// destination server's words (the last server's for a client), the
// client step on the destination client's word (clipped), each kept
// where the destination is of its kind. M gives C, S, sw (a server's
// words), M::kMaxSW, M::kMaxSends, m.n_sends() (its handlers' sends) and
// m.server_step(sid, sv, src, m0, m1, nw, sends). Out: the
// destination's first word (doff) and its new words (nw, dn of them),
// whether it changed, and its sends (the client's in slot 0).
template <class M>
struct Delivery {
  uint32_t nw[M::kMaxSW];
  Send sends[M::kMaxSends];
  int doff, dn;
  bool changed, any_send;
};

template <class M>
__device__ __forceinline__ void register_dispatch(const M& m,
                                                  const uint32_t* w,
                                                  uint32_t src, uint32_t dst,
                                                  uint32_t m0, uint32_t m1,
                                                  Delivery<M>& d) {
  const bool is_server = dst < (uint32_t)m.S;
  const uint32_t sidx = min(dst, (uint32_t)(m.S - 1));
  const int soff = (int)sidx * m.sw;
  uint32_t sv[M::kMaxSW];
#pragma unroll
  for (int j = 0; j < M::kMaxSW; ++j) sv[j] = j < m.sw ? w[soff + j] : 0u;
  const bool s_ch = m.server_step(sidx, sv, src, m0, m1, d.nw, d.sends);
  const int cidx = min(max((int)dst - m.S, 0), m.C - 1);
  const int coff = m.S * m.sw + cidx;
  bool c_ch;
  Send c_send;
  const uint32_t ncw =
      client_step((uint32_t)(cidx + m.S), w[coff], m0, m.S, c_ch, c_send);
  d.changed = is_server ? s_ch : c_ch;
  d.any_send = false;
#pragma unroll
  for (int k = 0; k < M::kMaxSends; ++k) {
    if (!is_server) d.sends[k] = k == 0 ? c_send : no_send();
    d.any_send |= k < m.n_sends() && d.sends[k].valid;
  }
  if (!is_server) {
    d.nw[0] = ncw;
#pragma unroll
    for (int j = 1; j < M::kMaxSW; ++j) d.nw[j] = 0u;
  }
  d.doff = is_server ? soff : coff;
  d.dn = is_server ? m.sw : 1;
}

// --- the crash/restart lanes (M::kCrash) --------------------------------
//
// What the JAX package's _packed_step_unordered computes on its crash
// and restart lanes (stateright_tpu/actor/packed.py:849-900) with the
// default packed_on_restart (the durable words adopted, no sends, no
// timer: the models refuse a subclass with its own), for one lane. M
// gives S, C, sw (a server's words: servers first, then a word per
// client), aw, E, timer_off and cr.

// Whether row w's delivery to dst goes to a down recipient (invalid: the
// message waits for the restart).
template <class M>
__device__ __forceinline__ bool dst_down(const M& m, const uint32_t* w,
                                         uint32_t dst) {
  return m.cr.k && is_down(w[m.timer_off + 1],
                           min(dst, (uint32_t)(m.S + m.C - 1)));
}

// The active lanes of row w (bit e; at most 32 lanes): the deliveries
// before the network's zero tail to a recipient that is up, each crash
// lane of an actor that is up with fewer than k crashes, each restart
// lane of an actor that is down. Every other lane's child is invalid and
// does not overflow.
template <class M>
__device__ __forceinline__ uint32_t crash_active_lanes(const M& m,
                                                       const uint32_t* w) {
  const int E = m.E;
  const int z = zero_tail(w + m.net_off, E);
  const uint32_t cw = m.cr.k ? w[m.timer_off + 1] : 0u;
  const uint32_t last = (uint32_t)(m.S + m.C - 1);
  uint32_t mask = 0u;
  for (int j = 0; j < z; ++j)
    if (!is_down(cw, min(w[m.net_off + 4 * j] & 0xFFu, last)))
      mask |= 1u << j;
  for (int c = 0; c < m.cr.n; ++c) {
    const uint32_t a = m.cr.actor(c);
    if (is_down(cw, a))
      mask |= 1u << (E + m.cr.n + c);
    else if (((cw >> (4 * a)) & 7u) < (uint32_t)m.cr.k)
      mask |= 1u << (E + c);
  }
  return mask;
}

// The register models' property bits (bit 0, "linearizable",
// host-evaluated: neutral true; bit 1, "value chosen") and the network's
// zero tail (returned) of row w (in shared memory), computed by a group
// of 32 lanes, lane r reading slot r: every test a ballot (in lane
// order), instead of one thread's walks over the slots. hdr is lane r's
// slot header (0 past E). K1 takes them so for a model with crash or
// drop lanes (a warp per row, beside the row's fingerprint folds), whose
// active lanes crash_row_lanes and drop_row_lanes build from them.
template <class M, class Grp>
__device__ __forceinline__ int row_slot_scan(const M& m, const uint32_t* w,
                                             const Grp& g, uint32_t& pb,
                                             uint32_t& hdr) {
  const int r = g.rank();
  const bool live = r < m.E;
  const uint32_t* slot = w + m.net_off + 4 * (live ? r : 0);
  hdr = live ? slot[0] : 0u;
  const uint32_t m0 = live ? slot[2] : 0u;
  const bool word = live && (hdr | slot[1] | m0 | slot[3]) != 0u;
  const bool chosen = ((hdr >> 16) & 1u) && (m0 >> 24) == T_GETOK &&
                      (m0 & 0xFu) != 0u;
  pb = 1u | (g.ballot(chosen) != 0u ? 2u : 0u);
  // the network's zero tail: past the last slot holding a word
  const uint32_t nz = g.ballot(word);
  return nz ? 32 - __clz(nz) : 0;
}

// The property bits (row_slot_scan) and crash_active_lanes of row w by a
// group of 32 lanes.
template <class M, class Grp>
__device__ __forceinline__ void crash_row_lanes(const M& m,
                                                const uint32_t* w,
                                                const Grp& g, uint32_t& pb,
                                                uint32_t& mask) {
  const int E = m.E;
  uint32_t hdr;
  const int z = row_slot_scan(m, w, g, pb, hdr);
  const uint32_t cw = m.cr.k ? w[m.timer_off + 1] : 0u;
  const uint32_t last = (uint32_t)(m.S + m.C - 1);
  mask = g.ballot(g.rank() < z && !is_down(cw, min(hdr & 0xFFu, last)));
  for (int c = 0; c < m.cr.n; ++c) {
    const uint32_t a = m.cr.actor(c);
    if (is_down(cw, a))
      mask |= 1u << (E + m.cr.n + c);
    else if (((cw >> (4 * a)) & 7u) < (uint32_t)m.cr.k)
      mask |= 1u << (E + c);
  }
}

// A crash or restart lane's child as an edit of the row: the actor, the
// new timer and crash words, whether it restarts, whether the child is
// valid, and the words a crash wipes where they are volatile: the
// actor's, [first, first + n) (n = 0 on a restart).
struct CrashEdit {
  uint32_t a, timer, cw;
  bool restart, valid;
  int first, n;
};

// Lane e (>= E) of row w: a crash clears the actor's timer bit, bumps
// its count and sets its down bit (valid when it is up with fewer than k
// crashes: the count never carries into the down bit); a restart clears
// the down bit (valid when it is down).
template <class M>
__device__ __forceinline__ CrashEdit crash_edit(const M& m, const uint32_t* w,
                                                int e) {
  const int c = e - m.E;
  CrashEdit ed;
  ed.restart = c >= m.cr.n;
  ed.a = m.cr.actor(ed.restart ? c - m.cr.n : c);
  const uint32_t nib = 4u * ed.a;
  const uint32_t tw = w[m.timer_off], cw = w[m.timer_off + 1];
  const bool down = is_down(cw, ed.a);
  const bool server = ed.a < (uint32_t)m.S;
  ed.first = server ? (int)ed.a * m.sw : m.S * m.sw + (int)ed.a - m.S;
  ed.n = ed.restart ? 0 : server ? m.sw : 1;
  if (ed.restart) {
    ed.timer = tw;
    ed.cw = cw & ~(1u << (nib + 3));
    ed.valid = down;
  } else {
    ed.timer = tw & ~(1u << ed.a);
    ed.cw = (cw + (1u << nib)) | (1u << (nib + 3));
    ed.valid = !down && ((cw >> nib) & 7u) < (uint32_t)m.cr.k;
  }
  return ed;
}

// Word k of the child that ed makes of the row, whose word k is old: a
// crashed actor's volatile words zero, the timer and crash words new,
// every other word the row's.
template <class M>
__device__ __forceinline__ uint32_t crash_word(const M& m, const CrashEdit& ed,
                                               int k, uint32_t old) {
  if ((unsigned)(k - ed.first) < (unsigned)ed.n)
    return m.cr.durable(k) ? old : 0u;
  if (k == m.timer_off) return ed.timer;
  if (k == m.timer_off + 1) return ed.cw;
  return old;
}

// Crash or restart lane e's child of row w (in shared memory) as its
// edit, with its fingerprint (hi, lo): the row's folds (r1, r2) with the
// words the child changes refolded (fold.cuh fold_change): the crashed
// actor's volatile words that are not zero, the timer word where the
// actor's bit was set, the crash word. One thread's work; the edit's
// valid says whether the child is valid (it never overflows).
template <class M>
__device__ __forceinline__ CrashEdit crash_fingerprint(const M& m,
                                                       const uint32_t* w,
                                                       int e, uint32_t r1,
                                                       uint32_t r2,
                                                       uint32_t& hi,
                                                       uint32_t& lo) {
  const CrashEdit ed = crash_edit(m, w, e);
  uint32_t h1 = r1, h2 = r2;
  for (int k = ed.first; k < ed.first + ed.n; ++k)
    if (!m.cr.durable(k) && w[k] != 0u) fold_change(h1, h2, k, w[k], 0u);
  const uint32_t tw = w[m.timer_off], cw = w[m.timer_off + 1];
  if (ed.timer != tw) fold_change(h1, h2, m.timer_off, tw, ed.timer);
  if (ed.cw != cw) fold_change(h1, h2, m.timer_off + 1, cw, ed.cw);
  fp64_finish(h1, h2, m.width(), hi, lo);
  return ed;
}

// The child that edit ed makes of row w (in shared memory), written to
// dst (its row of flat) by lane r of G lanes: words r, r + G, ... (G
// consecutive words a store).
template <class M>
__device__ __forceinline__ void crash_copy(const M& m, const uint32_t* w,
                                           const CrashEdit& ed, int r, int G,
                                           uint32_t* dst) {
  for (int k = r; k < m.width(); k += G) dst[k] = crash_word(m, ed, k, w[k]);
}

// --- the lossy drop lanes (M::kLossy) -----------------------------------
//
// What the JAX package's _packed_step_unordered computes on its drop lanes
// (stateright_tpu/actor/packed.py:790-804) for one lane: lane E + e drops
// one copy of slot e's envelope. The actors, the timer word and the
// history stay as they are; on the non-duplicating network a slot with a
// count above one keeps its place with the count less one, and at a count
// of at most one (or, on the duplicating network, whatever the count: the
// envelope is removed outright, _net_remove :509) the network's words from
// slot e on move up one slot, a zeroed slot entering at the tail. The lane
// is valid iff the slot is occupied, and never overflows. M gives E,
// net_off and width().

// A drop lane's child as an edit of the row: the dropped slot, whether
// the network's words from it on move up a slot (else only its count word
// changes, less one), and whether the child is valid.
struct DropEdit {
  int e;
  bool shift, valid;
};

// Lane `lane` (E + e) of row w on the network of the model (dup: the
// duplicating network).
template <class M>
__device__ __forceinline__ DropEdit drop_edit(const M& m, const uint32_t* w,
                                              int lane, bool dup) {
  DropEdit ed;
  ed.e = lane - m.E;
  const uint32_t* slot = w + m.net_off + 4 * ed.e;
  ed.valid = (slot[0] & kOcc) != 0u;
  ed.shift = dup || slot[1] <= 1u;
  return ed;
}

// Word k of the child that ed makes of row w, whose word k is old.
template <class M>
__device__ __forceinline__ uint32_t drop_word(const M& m, const DropEdit& ed,
                                              const uint32_t* w, int k,
                                              uint32_t old) {
  const int j = k - (m.net_off + 4 * ed.e);
  if (j < 0 || k >= m.net_off + 4 * m.E) return old;
  if (!ed.shift) return j == 1 ? old - 1u : old;
  return k + 4 < m.net_off + 4 * m.E ? w[k + 4] : 0u;
}

// Drop lane `lane`'s child of row w (in shared memory) as its edit, with
// its fingerprint (hi, lo): the row's folds (r1, r2) with the words the
// child changes refolded (the count word, or the network's words from the
// dropped slot on). One thread's work.
template <class M>
__device__ __forceinline__ DropEdit drop_fingerprint(
    const M& m, const uint32_t* w, int lane, bool dup, uint32_t r1,
    uint32_t r2, uint32_t& hi, uint32_t& lo) {
  const DropEdit ed = drop_edit(m, w, lane, dup);
  uint32_t h1 = r1, h2 = r2;
  const int end = ed.shift ? m.net_off + 4 * m.E : m.net_off + 4 * ed.e + 2;
  for (int k = m.net_off + 4 * ed.e; k < end; ++k) {
    const uint32_t v = drop_word(m, ed, w, k, w[k]);
    if (v != w[k]) fold_change(h1, h2, k, w[k], v);
  }
  fp64_finish(h1, h2, m.width(), hi, lo);
  return ed;
}

// The child that edit ed makes of row w (in shared memory), written to
// dst (its row of flat) by lane r of G lanes (G consecutive words a
// store).
template <class M>
__device__ __forceinline__ void drop_copy(const M& m, const uint32_t* w,
                                          const DropEdit& ed, int r, int G,
                                          uint32_t* dst) {
  for (int k = r; k < m.width(); k += G) dst[k] = drop_word(m, ed, w, k, w[k]);
}

// The property bits (row_slot_scan) and the active lanes of a lossy
// model's row w by a group of 32 lanes: the deliveries and the drops of
// the slots before the network's zero tail (bits e and E + e). Every
// other lane's child is invalid and does not overflow.
template <class M, class Grp>
__device__ __forceinline__ void drop_row_lanes(const M& m, const uint32_t* w,
                                               const Grp& g, uint32_t& pb,
                                               uint32_t& mask) {
  uint32_t hdr;
  const int z = row_slot_scan(m, w, g, pb, hdr);
  const uint32_t below = g.ballot(g.rank() < z);
  mask = below | (below << m.E);
}

// The same lanes by one thread (the host harness's rule).
template <class M>
__device__ __forceinline__ uint32_t drop_active_lanes(const M& m,
                                                      const uint32_t* w) {
  const int z = zero_tail(w + m.net_off, m.E);
  const uint32_t below = z >= 32 ? ~0u : (1u << z) - 1u;
  return below | (below << m.E);
}

// --- a narrow model's network in its register row (ping_pong.cuh) -------
//
// The unordered network of actor/packed.py (net_consume, net_remove,
// net_send) with one message word a slot, [hdr, cnt, msg] at words
// OFF + 3 j of a row array s of W words (OFF a compile-time offset, so
// every index is static after unrolling and the row stays in registers),
// E <= kMaxSlots slots live.

// Deliver (consume) slot e: its count less one, or at a count of at most
// one the suffix moved up a slot (a zeroed slot entering at the tail);
// with `remove` the suffix moves up whatever the count (a drop on the
// duplicating network, net_remove).
template <int OFF, int W>
__device__ __forceinline__ void row_net_consume(uint32_t (&s)[W], int e,
                                                int E, bool remove) {
  static_assert(OFF + 3 * kMaxSlots <= W, "the network fits the row");
  uint32_t c = 0u;
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j)
    if (j == e) {
      c = s[OFF + 3 * j + 1];
      s[OFF + 3 * j + 1] = c - 1u;
    }
  if (!remove && c > 1u) return;
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j) {
    if (j >= e && j < E) {
#pragma unroll
      for (int x = 0; x < 3; ++x)
        s[OFF + 3 * j + x] =
            j + 1 < E ? s[OFF + 3 * (j + 1 < kMaxSlots ? j + 1 : j) + x] : 0u;
    }
  }
}

// Send msg from src to dst where valid: on the non-duplicating network
// bump the count of the slot that holds the envelope, on the duplicating
// one (a set) leave it; else insert [hdr, 1, msg] at its (hdr, msg) rank
// by moving the suffix down a slot. Returns the overflow: a valid send
// that finds no match and no empty slot, or a recipient at or above 256.
template <int OFF, int W>
__device__ __forceinline__ bool row_net_send(uint32_t (&s)[W], uint32_t src,
                                             uint32_t dst, uint32_t msg,
                                             bool valid, bool dup, int E) {
  const uint32_t hdr = kOcc | (src << 8) | dst;
  bool has_match = false, has_empty = false;
  int pos = 0;
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j) {
    if (j < E) {
      const uint32_t h = s[OFF + 3 * j], x = s[OFF + 3 * j + 2];
      const bool occ = (h & kOcc) != 0u;
      const bool match = occ && h == hdr && x == msg;
      if (match && valid && !dup) s[OFF + 3 * j + 1] += 1u;
      has_match |= match;
      has_empty |= !occ;
      pos += occ && (h < hdr || (h == hdr && x < msg));
    }
  }
  const bool oob = dst >= 256u;
  if (valid && !has_match && has_empty && !oob) {
#pragma unroll
    for (int j = kMaxSlots - 1; j >= 0; --j) {
      if (j < E) {
        if (j > pos) {
#pragma unroll
          for (int x = 0; x < 3; ++x)
            s[OFF + 3 * j + x] = s[OFF + 3 * (j > 0 ? j - 1 : 0) + x];
        } else if (j == pos) {
          s[OFF + 3 * j] = hdr;
          s[OFF + 3 * j + 1] = 1u;
          s[OFF + 3 * j + 2] = msg;
        }
      }
    }
  }
  return valid && ((!has_match && !has_empty) || oob);
}

// A register model's child on the unordered network (slot e of row w,
// in shared memory) into out, word by word (step_common.cuh RowOut);
// returns whether it is a valid successor, ovf whether it overflowed the
// network (then its words are kPoison and it is invalid). M adds E,
// aw, net_off, timer_off, hist_off and hw to what register_dispatch
// reads.
template <class M, class Out>
__device__ __forceinline__ bool register_step_unordered(const M& m,
                                                        const uint32_t* w,
                                                        int e, Out& out,
                                                        bool& ovf) {
  const int E = m.E;
  const uint32_t* slot = w + m.net_off + 4 * e;
  const uint32_t hdr = slot[0], m0 = slot[2], m1 = slot[3];
  const bool occupied = (hdr & kOcc) != 0u;
  const uint32_t src = (hdr >> 8) & 0xFFu, dst = hdr & 0xFFu;
  Delivery<M> d;
  register_dispatch(m, w, src, dst, m0, m1, d);
  bool valid = occupied && dst < (uint32_t)(m.S + m.C) &&
               (d.changed || d.any_send);
  if constexpr (HasCrash<M>::value) valid = valid && !dst_down(m, w, dst);

  // the network and the history: consume the slot, record the
  // delivery, then each send's invocation record and network insert
  Net net;
  net_load(net, w + m.net_off, E);
  net_consume(net, e, E);
  Hist hist;
  hist_load(hist, w + m.hist_off, m.hw);
  record_in(hist, m.S, m.C, dst, m0);
  bool overflow = false;
#pragma unroll
  for (int k = 0; k < M::kMaxSends; ++k) {
    const Send& sd = d.sends[k];
    if (k < m.n_sends() && sd.valid) {  // an invalid send changes nothing
      record_out(hist, m.S, m.C, dst, sd.m0);
      overflow |= net_send(net, dst, sd.dst, sd.m0, sd.m1, true, E);
    }
  }
  const bool poison = valid && overflow;
  ovf = poison;

  // the child, word by word
  for (int k = 0; k < m.aw; ++k) {
    uint32_t v = w[k];
#pragma unroll
    for (int j = 0; j < M::kMaxSW; ++j)
      if (j < d.dn && k == d.doff + j) v = d.nw[j];
    out.put(k, poison ? kPoison : v);
  }
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j) {
    if (j < E) {
      const int k = m.net_off + 4 * j;
      out.put(k, poison ? kPoison : net.hdr[j]);
      out.put(k + 1, poison ? kPoison : net.cnt[j]);
      out.put(k + 2, poison ? kPoison : net.m0[j]);
      out.put(k + 3, poison ? kPoison : net.m1[j]);
    }
  }
  out.put(m.timer_off, poison ? kPoison : w[m.timer_off]);
  if constexpr (HasCrash<M>::value)
    if (m.cr.k) out.put(m.timer_off + 1, poison ? kPoison : w[m.timer_off + 1]);
#pragma unroll
  for (int i = 0; i < kMaxHist; ++i)
    if (i < m.hw) out.put(m.hist_off + i, poison ? kPoison : hist.h[i]);
  return valid && !poison;
}

// --- the unordered network in a group's lanes --------------------------
//
// register_step_group builds one child with a group of G lanes (a
// half-warp in step_common.cuh's group K1, G >= E): slot j of
// the child's network [hdr, cnt, m0, m1] lives in lane j's registers
// (lanes from E on hold zeros), so a consume or a send is a few
// shuffles and ballots instead of one lane's unrolled walk over 16
// slots; the delivery (register_dispatch) and the history record are
// computed alike by every lane of the group (one instruction stream);
// then the lanes write the child's words to its row (the actors' words
// and the history G consecutive ones a store, slot j's four words by
// lane j), each folding its own into the fingerprint (fold.cuh), and the
// group XOR-reduces the folds. Grp gives rank() (the lane's place in
// the group), size(), down(v) / up(v) (lane r + 1's / r - 1's v, where
// it exists), ballot(p) (the group's lanes whose p holds, as bits of any
// order: only popcounts are read), xor_all(v), words() (the group's
// 2 G words of shared memory, at least kMaxHist) and sync() (the group's
// barrier, which orders its lanes' shared-memory accesses); every lane
// of the group calls each of them at the same point (the control flow
// around them is the same for the whole group).

// Deliver slot e (the group's net_consume): decrement its count, or at
// a count c of at most one shift the suffix up one slot by a shuffle (a
// zeroed slot enters at the tail); the count wraps as in net_consume.
template <class Grp>
__device__ __forceinline__ void group_consume(const Grp& g, uint32_t& hdr,
                                              uint32_t& cnt, uint32_t& m0,
                                              uint32_t& m1, int e,
                                              uint32_t c, int E) {
  const int r = g.rank();
  if (r == e) cnt -= 1u;
  if (c > 1u) return;
  const uint32_t nh = g.down(hdr), nc = g.down(cnt), n0 = g.down(m0),
                 n1 = g.down(m1);
  if (r >= e && r < E) {
    const bool last = r + 1 >= E;
    hdr = last ? 0u : nh;
    cnt = last ? 0u : nc;
    m0 = last ? 0u : n0;
    m1 = last ? 0u : n1;
  }
}

// A valid send of (sm0, sm1) from src to dst (the group's net_send):
// bump the count of the slot that holds the envelope (its lane's match,
// by ballot), or insert [hdr, 1, sm0, sm1] at its rank (the popcount of
// the occupied slots below it in (hdr, m0, m1) order) by shifting the
// suffix down one slot by a shuffle. Returns the overflow: no match and
// no empty slot, or a recipient at or above 256.
template <class Grp>
__device__ __forceinline__ bool group_send(const Grp& g, uint32_t& hdr,
                                           uint32_t& cnt, uint32_t& m0,
                                           uint32_t& m1, uint32_t src,
                                           uint32_t dst, uint32_t sm0,
                                           uint32_t sm1, int E) {
  const int r = g.rank();
  const uint32_t h = kOcc | (src << 8) | dst;
  const bool live = r < E;
  const bool occ = (hdr & kOcc) != 0u;
  const bool match = live && occ && hdr == h && m0 == sm0 && m1 == sm1;
  if (match) cnt += 1u;
  const bool lt =
      hdr < h || (hdr == h && (m0 < sm0 || (m0 == sm0 && m1 < sm1)));
  const bool has_match = g.ballot(match) != 0u;
  const bool has_empty = g.ballot(live && !occ) != 0u;
  const int pos = __popc(g.ballot(live && occ && lt));
  const bool oob = dst >= 256u;
  if (!has_match && has_empty && !oob) {
    const uint32_t ph = g.up(hdr), pc = g.up(cnt), p0 = g.up(m0),
                   p1 = g.up(m1);
    if (live && r > pos) {
      hdr = ph;
      cnt = pc;
      m0 = p0;
      m1 = p1;
    } else if (r == pos) {
      hdr = h;
      cnt = 1u;
      m0 = sm0;
      m1 = sm1;
    }
  }
  return (!has_match && !has_empty) || oob;
}

// A register model's child on the unordered network (slot e of row w, in
// shared memory), built by the group g into dst (the child's row of
// flat); returns whether it is a valid successor, ovf whether it
// overflowed the network (then its words are kPoison and it is invalid),
// and (hi, lo) its fingerprint, in every lane. The same child, validity
// and overflow as register_step_unordered, bit for bit: the same
// consume, the same record_in, then per valid send record_out before
// its insert, in send order. M is register_step_unordered's.
template <class M, class Grp>
__device__ __forceinline__ bool register_step_group(const M& m,
                                                    const uint32_t* w,
                                                    int e, const Grp& g,
                                                    uint32_t* dst, bool& ovf,
                                                    uint32_t& hi,
                                                    uint32_t& lo) {
  const int E = m.E, r = g.rank(), G = g.size();
  const uint32_t* slot = w + m.net_off + 4 * e;
  const uint32_t hdr = slot[0], m0 = slot[2], m1 = slot[3];
  const bool occupied = (hdr & kOcc) != 0u;
  const uint32_t src = (hdr >> 8) & 0xFFu, to = hdr & 0xFFu;
  Delivery<M> d;
  register_dispatch(m, w, src, to, m0, m1, d);
  bool valid = occupied && to < (uint32_t)(m.S + m.C) &&
               (d.changed || d.any_send);
  if constexpr (HasCrash<M>::value) valid = valid && !dst_down(m, w, to);

  // the network, slot r in lane r: consume slot e, record the delivery,
  // then each send's invocation record and network insert
  const bool live = r < E;
  const uint32_t* own = w + m.net_off + 4 * (live ? r : 0);
  uint32_t nh = live ? own[0] : 0u, nc = live ? own[1] : 0u,
           n0 = live ? own[2] : 0u, n1 = live ? own[3] : 0u;
  group_consume(g, nh, nc, n0, n1, e, slot[1], E);
  Hist hist;
  hist_load(hist, w + m.hist_off, m.hw);
  record_in(hist, m.S, m.C, to, m0);
  bool overflow = false;
#pragma unroll
  for (int k = 0; k < M::kMaxSends; ++k) {
    const Send& sd = d.sends[k];
    if (k < m.n_sends() && sd.valid) {  // an invalid send changes nothing
      record_out(hist, m.S, m.C, to, sd.m0);
      overflow |= group_send(g, nh, nc, n0, n1, to, sd.dst, sd.m0, sd.m1, E);
    }
  }
  const bool poison = valid && overflow;
  ovf = poison;

  // the child's words, each lane folding the words it writes: the
  // actors' words (the destination's new ones) G consecutive a store,
  // slot r's four words by lane r (the group's 4 G consecutive words in
  // four stores), the history G consecutive a store, the timer by the
  // last lane
  const int width = m.hist_off + m.hw;
  uint32_t h1 = 0u, h2 = 0u;
  auto put = [&](int k, uint32_t v) {
    if (poison) v = kPoison;
    dst[k] = v;
    fold_word(h1, h2, k, v);
  };
  for (int k = r; k < m.aw; k += G) {
    uint32_t v = w[k];
#pragma unroll
    for (int j = 0; j < M::kMaxSW; ++j)
      if (j < d.dn && k == d.doff + j) v = d.nw[j];
    put(k, v);
  }
  if (live) {
    const int k = m.net_off + 4 * r;
    put(k, nh);
    put(k + 1, nc);
    put(k + 2, n0);
    put(k + 3, n1);
  }
  if (r == G - 1) put(m.timer_off, w[m.timer_off]);
  if constexpr (HasCrash<M>::value)
    if (m.cr.k && r == G - 2) put(m.timer_off + 1, w[m.timer_off + 1]);
  // the history through the group's shared words (a lane's own word
  // from its registers would need a runtime index into hist.h, which
  // puts the history in local memory): the first lane writes them
  uint32_t* hs = g.words();
  g.sync();  // the group's last child has read them
  if (r == 0) {
#pragma unroll
    for (int i = 0; i < kMaxHist; ++i)
      if (i < m.hw) hs[i] = hist.h[i];
  }
  g.sync();
  for (int i = r; i < m.hw; i += G) put(m.hist_off + i, hs[i]);
  fp64_finish(g.xor_all(h1), g.xor_all(h2), width, hi, lo);
  return valid && !poison;
}

// --- a delivery's child in two phases (a group model with crash lanes) --
//
// register_step_group's child split where its work splits: the scalar
// part (the dispatch, the validity, the history's records), which every
// lane of a group would compute alike, is computed once per child by a
// thread (register_deliver_scalar, phase A) into a DeliveryRecord in
// shared memory; the group then builds the child from the record
// (register_deliver_group, phase B): the network in its lanes (the
// consume, then each recorded send), the child's words written to its
// row and folded. The same child, validity, overflow and fingerprint as
// register_step_group, bit for bit.

// A delivery's scalar part: the history after its records, the
// destination's new words, the handler's sends, and flags: bit 0 the
// validity before the sends' overflow, bit 1 + k send k emitted, the
// destination's first word (doff) at bit 8, its word count (dn) at bit
// 16.
template <class M>
struct DeliveryRecord {
  uint32_t hist[kMaxHist];
  uint32_t nw[M::kMaxSW];
  uint32_t dst[M::kMaxSends], m0[M::kMaxSends], m1[M::kMaxSends];
  uint32_t flags;
};

// Phase A: the scalar part of slot e's delivery on row w (in shared
// memory) into rec.
template <class M>
__device__ __forceinline__ void register_deliver_scalar(
    const M& m, const uint32_t* w, int e, DeliveryRecord<M>& rec) {
  const uint32_t* slot = w + m.net_off + 4 * e;
  const uint32_t hdr = slot[0], m0 = slot[2], m1 = slot[3];
  const bool occupied = (hdr & kOcc) != 0u;
  const uint32_t src = (hdr >> 8) & 0xFFu, to = hdr & 0xFFu;
  Delivery<M> d;
  register_dispatch(m, w, src, to, m0, m1, d);
  bool valid = occupied && to < (uint32_t)(m.S + m.C) &&
               (d.changed || d.any_send);
  if constexpr (HasCrash<M>::value) valid = valid && !dst_down(m, w, to);
  Hist hist;
  hist_load(hist, w + m.hist_off, m.hw);
  record_in(hist, m.S, m.C, to, m0);
  uint32_t flags = (valid ? 1u : 0u) | ((uint32_t)d.doff << 8) |
                   ((uint32_t)d.dn << 16);
#pragma unroll
  for (int k = 0; k < M::kMaxSends; ++k) {
    const Send& sd = d.sends[k];
    if (k < m.n_sends() && sd.valid) {  // an invalid send changes nothing
      record_out(hist, m.S, m.C, to, sd.m0);
      flags |= 2u << k;
    }
    rec.dst[k] = sd.dst;
    rec.m0[k] = sd.m0;
    rec.m1[k] = sd.m1;
  }
#pragma unroll
  for (int j = 0; j < M::kMaxSW; ++j) rec.nw[j] = d.nw[j];
#pragma unroll
  for (int i = 0; i < kMaxHist; ++i)
    if (i < m.hw) rec.hist[i] = hist.h[i];
  rec.flags = flags;
}

// Phase B: slot e's child of row w from its record rec, built by the
// group g into dst (its row of flat) as register_step_group writes and
// folds it (the actors' words and the history G consecutive a store,
// slot r's four words by lane r, the timer and crash words by the last
// lanes, each lane folding its own). Returns whether it is a valid
// successor, ovf whether it overflowed (its words kPoison), (hi, lo) its
// fingerprint, in every lane.
template <class M, class Grp>
__device__ __forceinline__ bool register_deliver_group(
    const M& m, const uint32_t* w, int e, const DeliveryRecord<M>& rec,
    const Grp& g, uint32_t* dst, bool& ovf, uint32_t& hi, uint32_t& lo) {
  const int E = m.E, r = g.rank(), G = g.size();
  const uint32_t* slot = w + m.net_off + 4 * e;
  const uint32_t to = slot[0] & 0xFFu, flags = rec.flags;
  const bool live = r < E;
  const uint32_t* own = w + m.net_off + 4 * (live ? r : 0);
  uint32_t nh = live ? own[0] : 0u, nc = live ? own[1] : 0u,
           n0 = live ? own[2] : 0u, n1 = live ? own[3] : 0u;
  group_consume(g, nh, nc, n0, n1, e, slot[1], E);
  bool overflow = false;
#pragma unroll
  for (int k = 0; k < M::kMaxSends; ++k)
    if ((flags >> (1 + k)) & 1u)
      overflow |= group_send(g, nh, nc, n0, n1, to, rec.dst[k], rec.m0[k],
                             rec.m1[k], E);
  const bool valid = flags & 1u;
  const bool poison = valid && overflow;
  ovf = poison;

  uint32_t h1 = 0u, h2 = 0u;
  auto put = [&](int k, uint32_t v) {
    if (poison) v = kPoison;
    dst[k] = v;
    fold_word(h1, h2, k, v);
  };
  const int doff = (int)((flags >> 8) & 0xFFu), dn = (int)(flags >> 16);
  for (int k = r; k < m.aw; k += G)
    put(k, (unsigned)(k - doff) < (unsigned)dn ? rec.nw[k - doff] : w[k]);
  if (live) {
    const int k = m.net_off + 4 * r;
    put(k, nh);
    put(k + 1, nc);
    put(k + 2, n0);
    put(k + 3, n1);
  }
  if (r == G - 1) put(m.timer_off, w[m.timer_off]);
  if constexpr (HasCrash<M>::value)
    if (m.cr.k && r == G - 2) put(m.timer_off + 1, w[m.timer_off + 1]);
  for (int i = r; i < m.hw; i += G) put(m.hist_off + i, rec.hist[i]);
  fp64_finish(g.xor_all(h1), g.xor_all(h2), m.hist_off + m.hw, hi, lo);
  return valid && !poison;
}

// --- the ordered network: one FIFO per register channel ---------------
//
// A register model's channels (packed_register.py register_channels):
// client -> server (C * S), server -> client (S * C), server -> server
// without self-channels (S * (S - 1)), each by sender, then recipient.
// The row holds their lengths, then depth entries of two message words
// per channel.

// The channel of (src, dst), or -1 when the model declares none (a
// client to a client, a server to itself, an actor past the C + S).
__device__ __forceinline__ int reg_chan(uint32_t src, uint32_t dst, int C,
                                        int S) {
  const uint32_t s = (uint32_t)S, n = (uint32_t)(S + C);
  if (src >= n || dst >= n) return -1;
  if (src >= s && dst < s) return (int)((src - s) * s + dst);
  if (src < s && dst >= s) return C * S + (int)(src * (uint32_t)C + dst - s);
  if (src < s && dst < s && src != dst)
    return 2 * C * S + (int)(src * (s - 1u) + (dst < src ? dst : dst - 1u));
  return -1;
}

// The sender and recipient of channel ch (the inverse of reg_chan).
__device__ __forceinline__ void reg_chan_ends(int ch, int C, int S,
                                              uint32_t& src,
                                              uint32_t& dst) {
  if (ch < C * S) {
    src = (uint32_t)(S + ch / S);
    dst = (uint32_t)(ch % S);
  } else if (ch < 2 * C * S) {
    const int r = ch - C * S;
    src = (uint32_t)(r / C);
    dst = (uint32_t)(S + r % C);
  } else {
    const int r = ch - 2 * C * S, s1 = S - 1;
    src = (uint32_t)(r / s1);
    const uint32_t t = (uint32_t)(r % s1);
    dst = t < src ? t : t + 1u;
  }
}

// A lane's child on the ordered network as an edit of the row, in
// shared memory (one slot per thread of K1, read by the warp that writes
// the child): the destination's new words, the history and the appended
// messages, and where each lands in the child as absolute columns, so
// the writer needs no channel arithmetic: the destination's span [aoff,
// aoff + an), the popped channel's length column and first entry word,
// each append's length column and entry word (-2 past the appends); or
// the poison of an overflowing child.
template <int kMaxSW, int kMaxSends>
struct OrderedEdit {
  uint32_t actor[kMaxSW];  // the destination's words from aoff, an of them
  uint32_t hist[kMaxHist];
  uint32_t am0[kMaxSends], am1[kMaxSends];  // the appended messages
  int aoff, an, plen, pword, poison;
  int alen[kMaxSends], aword[kMaxSends];
};

// An OrderedEdit's columns in registers (ordered_head), read once per
// child by the warp that writes it; pend is the popped channel's end.
template <int kMaxSends>
struct OrderedHead {
  int aoff, an, plen, pword, pend, poison;
  int alen[kMaxSends], aword[kMaxSends];
};

template <int kMaxSW, int kMaxSends>
__device__ __forceinline__ OrderedHead<kMaxSends> ordered_head(
    const OrderedEdit<kMaxSW, kMaxSends>& ed, int depth) {
  OrderedHead<kMaxSends> h;
  h.aoff = ed.aoff;
  h.an = ed.an;
  h.plen = ed.plen;
  h.pword = ed.pword;
  h.pend = ed.pword + 2 * depth;
  h.poison = ed.poison;
#pragma unroll
  for (int a = 0; a < kMaxSends; ++a) {
    h.alen[a] = ed.alen[a];
    h.aword[a] = ed.aword[a];
  }
  return h;
}

// The edit of the lane that delivers the head of channel c of row w (in
// shared memory) into ed; returns whether the child is a valid
// successor, ovf whether it overflowed (a send into a full channel or
// one the model does not declare: the child is poisoned and invalid).
// An empty channel's lane is never asked for (its child is invalid and
// K1 does not write it). M adds D (the depth), lens_off, msgs_off and
// hist_off and hw to what register_dispatch reads.
template <class M, class Edit>
__device__ __forceinline__ bool register_edit_ordered(const M& m,
                                                      const uint32_t* w,
                                                      int c, Edit& ed,
                                                      bool& ovf) {
  uint32_t src, dst;
  reg_chan_ends(c, m.C, m.S, src, dst);
  const uint32_t ln = w[m.lens_off + c];
  const uint32_t* head = w + m.msgs_off + 2 * m.D * c;
  const uint32_t m0 = head[0], m1 = head[1];
  Delivery<M> d;
  register_dispatch(m, w, src, dst, m0, m1, d);
  const bool valid = ln > 0u && (d.changed || d.any_send);
  Hist hist;
  hist_load(hist, w + m.hist_off, m.hw);
  record_in(hist, m.S, m.C, dst, m0);
  bool overflow = false;
  int napp = 0;
  int achan[M::kMaxSends];  // each send's channel (-1: none appended)
#pragma unroll
  for (int k = 0; k < M::kMaxSends; ++k) {
    achan[k] = -1;
    ed.alen[k] = ed.aword[k] = -2;  // past the appends: no column
    const Send& sd = d.sends[k];
    if (k < m.n_sends() && sd.valid) {
      record_out(hist, m.S, m.C, dst, sd.m0);
      const int cd = reg_chan(dst, sd.dst, m.C, m.S);
      // the channel's length after the pop and the appends before
      uint32_t pos =
          cd >= 0 ? w[m.lens_off + cd] - (cd == c ? 1u : 0u) : 0u;
#pragma unroll
      for (int j = 0; j < k; ++j) pos += achan[j] == cd ? 1u : 0u;
      const bool bad = cd < 0 || pos >= (uint32_t)m.D;
      overflow |= bad;
      if (!bad) {
        achan[k] = cd;
        ed.am0[napp] = sd.m0;
        ed.am1[napp] = sd.m1;
        ed.alen[napp] = m.lens_off + cd;
        ed.aword[napp] = m.msgs_off + 2 * (m.D * cd + (int)pos);
        ++napp;
      }
    }
  }
  const bool poison = valid && overflow;
  ovf = poison;
  ed.poison = poison;
  ed.plen = m.lens_off + c;
  ed.pword = m.msgs_off + 2 * m.D * c;
  ed.aoff = d.doff;
  ed.an = d.dn;
#pragma unroll
  for (int j = 0; j < M::kMaxSW; ++j) ed.actor[j] = d.nw[j];
#pragma unroll
  for (int i = 0; i < kMaxHist; ++i)
    if (i < m.hw) ed.hist[i] = hist.h[i];
  return valid && !poison;
}

// Word k of the child that edit ed (its columns h in registers) makes of
// row w, whose word k is old. The child is the row but for the edit's
// spans: the destination's words [aoff, aoff + an) from the edit; the
// popped channel's entries [pword, pend) shifted by one entry, a zero
// entry entering at its tail; the popped channel's length one less and
// each append's channel's one more; each appended entry's two words
// (over the shift where a lane appends to the channel it pops); the
// history [hist_off, width) from the edit. The poison's every word is
// kPoison.
template <class M, class Edit, class Head>
__device__ __forceinline__ uint32_t ordered_child_word(const M& m,
                                                       const uint32_t* w,
                                                       const Edit& ed,
                                                       const Head& h, int k,
                                                       uint32_t old) {
  if (h.poison) return kPoison;
  uint32_t v = old;
  if ((unsigned)(k - h.aoff) < (unsigned)h.an) v = ed.actor[k - h.aoff];
  if (k >= h.pword && k < h.pend) v = k + 2 < h.pend ? w[k + 2] : 0u;
  if (k == h.plen) v -= 1u;
#pragma unroll
  for (int a = 0; a < M::kMaxSends; ++a) {
    if (k == h.alen[a]) v += 1u;
    if (k == h.aword[a]) v = ed.am0[a];
    if (k == h.aword[a] + 1) v = ed.am1[a];
  }
  if (k >= m.hist_off) v = ed.hist[k - m.hist_off];
  return v;
}

// "value chosen" on the ordered network: some channel's head is a GetOk
// of a non-null value.
__device__ __forceinline__ bool value_chosen_ordered(const uint32_t* w,
                                                     int lens_off,
                                                     int msgs_off, int nchan,
                                                     int D) {
  bool chosen = false;
  for (int ch = 0; ch < nchan; ++ch) {
    const uint32_t m0 = w[msgs_off + 2 * D * ch];
    chosen |= w[lens_off + ch] != 0u && (m0 >> 24) == T_GETOK &&
              (m0 & 0xFu) != 0u;
  }
  return chosen;
}

// The channels with a message (bit ch): the lanes whose child is not
// the row's junk (an empty channel's lane is invalid).
__device__ __forceinline__ uint32_t nonempty_channels(const uint32_t* w,
                                                      int lens_off,
                                                      int nchan) {
  uint32_t mask = 0u;
  for (int ch = 0; ch < nchan; ++ch)
    mask |= (w[lens_off + ch] != 0u ? 1u : 0u) << ch;
  return mask;
}

}  // namespace actor
