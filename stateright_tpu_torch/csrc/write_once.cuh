// The write-once register (an unreplicated write-once value server) with
// its crash/restart lanes as CUDA device functions: the server step and
// the property bits of stateright_tpu_torch/examples/write_once_packed.py
// (PackedWriteOnce._server_step / packed_properties: the JAX package's
// stateright_tpu/examples/write_once_packed.py:120-155 with the register
// dispatch of actor/packed_register.py), and the crash and restart lanes
// of actor/packed.py (the JAX package's _packed_step_unordered
// :849-900), for C <= 7 clients, S <= 4 servers, E <= 16 slots of the
// unordered non-duplicating network, at most 8 actors and 128 words (no
// drops or timers). A group model (kGroupRow, step_common.cuh) with crash
// lanes (kCrash): K1 builds each active lane's child in two phases: A, a
// thread takes a delivery's scalar part (the dispatch, the validity, the
// history) into a Record in shared memory, or a crash or restart lane's
// edit (the row with at most the actor's words, the timer word and the
// crash word changed) and its fingerprint (the row's folds with those
// words refolded); B, a group of lanes builds the delivery's child with
// the network in its registers, or writes the crash child's words
// (actor_net.cuh register_deliver_scalar, register_deliver_group,
// crash_fingerprint, crash_copy).
// K1 steps the active lanes only
// (active_lanes: the deliveries before the network's zero tail to a
// recipient that is up, the crash lanes of actors that may crash, the
// restart lanes of actors that are down); every other lane is invalid
// and does not overflow. Server state: one word, the stored value (0:
// unwritten).
#pragma once

#include <cstdint>

#include "actor_net.cuh"

struct WriteOnceModel {
  static constexpr int W = 128;  // C = 7, S = 4, E = 16 need 99
  static constexpr bool kGroupRow = true;
  static constexpr bool kCrash = true;
  static constexpr int kMaxServers = 4;
  static constexpr int kMaxSW = 1;
  static constexpr int kMaxSends = 1;
  // the failure reply's tag (write_once_packed.py T_PUTFAIL = T_INTERNAL0)
  static constexpr uint32_t T_PUTFAIL = 5;

  int C, S, E;
  int sw, aw, net_off, timer_off, hist_off, hw, width_;
  actor::CrashSpec cr;

  __host__ WriteOnceModel(int clients, int servers, int slots,
                          actor::CrashSpec spec)
      : C(clients), S(servers), E(slots), cr(spec) {
    sw = 1;
    aw = S + C;
    net_off = aw;
    timer_off = net_off + 4 * E;
    hist_off = timer_off + (cr.k ? 2 : 1);  // the crash word, with crashes
    hw = 1 + 3 * C;
    width_ = hist_off + hw;
  }

  __host__ bool ok() const {
    return C >= 1 && C <= actor::kMaxClients && S >= 1 &&
           S <= kMaxServers && E >= 1 && E <= actor::kMaxSlots &&
           width_ <= W && cr.ok(S + C, aw, E);
  }

  __host__ __device__ int width() const { return width_; }
  __host__ int max_actions() const { return E + 2 * cr.n; }
  __host__ __device__ int n_sends() const { return 1; }

  // write_once_packed.py WriteOnceActor: the first Put stores its value
  // and answers PutOk, a Put of the stored value answers PutOk, any other
  // Put answers PutFail; a Get answers GetOk with the stored word.
  __device__ __forceinline__ bool server_step(
      uint32_t sid, const uint32_t (&sv)[kMaxSW], uint32_t src, uint32_t m0,
      uint32_t m1, uint32_t (&nw)[kMaxSW],
      actor::Send (&sends)[kMaxSends]) const {
    using namespace actor;
    const uint32_t val = sv[0], mtype = m0 >> 24,
                   m_rid = (m0 >> 12) & 0xFFFu, m_val = m0 & 0xFu;
    const bool is_put = mtype == T_PUT, is_get = mtype == T_GET;
    const bool unwritten = val == 0u;
    const bool ok = is_put && (unwritten || val == m_val);
    nw[0] = is_put && unwritten ? m_val : val;
    sends[0] =
        is_get ? Send{src, (T_GETOK << 24) | (m_rid << 12) | val, 0u, true}
        : is_put ? Send{src, ((ok ? T_PUTOK : T_PUTFAIL) << 24) | (m_rid << 12),
                        0u, true}
                 : no_send();
    return is_put && unwritten;
  }

  __device__ __forceinline__ uint32_t props_row(const uint32_t* w) const {
    return 1u | (actor::value_chosen(w + net_off, E) ? 2u : 0u);
  }

  __device__ __forceinline__ uint32_t active_lanes(const uint32_t* w) const {
    return actor::crash_active_lanes(*this, w);
  }

  // A delivery's scalar part, K1's phase A (a thread per child).
  using Record = actor::DeliveryRecord<WriteOnceModel>;

  __device__ __forceinline__ void deliver_scalar(const uint32_t* w, int e,
                                                 Record& rec) const {
    actor::register_deliver_scalar(*this, w, e, rec);
  }

  // Delivery lane e's child of row w (shared memory) from its record,
  // built by the group g into dst (its row of flat): whether it is a valid
  // successor, ovf whether it overflowed (its words kPoison, invalid),
  // (hi, lo) its fingerprint.
  template <class Grp>
  __device__ __forceinline__ bool deliver_group(const uint32_t* w, int e,
                                                const Record& rec,
                                                const Grp& g, uint32_t* dst,
                                                bool& ovf, uint32_t& hi,
                                                uint32_t& lo) const {
    return actor::register_deliver_group(*this, w, e, rec, g, dst, ovf, hi,
                                         lo);
  }

  // The property bits and the active lanes of row w (shared memory),
  // props_row's and active_lanes', by a group g of 32 lanes (ballots in
  // lane order).
  template <class Grp>
  __device__ __forceinline__ void row_lanes(const uint32_t* w, const Grp& g,
                                            uint32_t& pb,
                                            uint32_t& mask) const {
    actor::crash_row_lanes(*this, w, g, pb, mask);
  }

  // A crash or restart lane's child (e >= E; valid or not, never
  // overflowing) in two parts: its edit and fingerprint (hi, lo), from
  // the row's folds (r1, r2), by a thread; then its words, the row's with
  // the edit's, written to dst by lane r of G lanes.
  using CrashEdit = actor::CrashEdit;

  __device__ __forceinline__ CrashEdit crash_child(const uint32_t* w, int e,
                                                   uint32_t r1, uint32_t r2,
                                                   uint32_t& hi,
                                                   uint32_t& lo) const {
    return actor::crash_fingerprint(*this, w, e, r1, r2, hi, lo);
  }

  __device__ __forceinline__ void crash_write(const uint32_t* w,
                                              const CrashEdit& ed, int r,
                                              int G, uint32_t* dst) const {
    actor::crash_copy(*this, w, ed, r, G, dst);
  }
};
