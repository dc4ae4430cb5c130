// The single-copy register (unreplicated value servers) as CUDA device
// functions: the server step and the property bits of
// stateright_tpu_torch/examples/single_copy_packed.py
// (PackedSingleCopy._server_step / packed_properties: the JAX package's
// stateright_tpu/examples/single_copy_packed.py:59-84 with the register
// dispatch of actor/packed_register.py), for C <= 7 clients, S <= 4
// servers and E <= 16 slots of the unordered non-duplicating network (at
// most 128 words; no drops, timers or crashes). A group model
// (kGroupRow, step_common.cuh): each child is built by a group of lanes
// with the network in their registers (actor_net.cuh
// register_step_group), the network's zero tail is quiet. Server state:
// one word, the stored value.
#pragma once

#include <cstdint>

#include "actor_net.cuh"

struct SingleCopyModel {
  static constexpr int W = 128;  // C = 7, S = 4, E = 16 need 98
  static constexpr bool kGroupRow = true;
  static constexpr int kMaxServers = 4;
  static constexpr int kMaxSW = 1;
  static constexpr int kMaxSends = 1;

  int C, S, E;
  int sw, aw, net_off, timer_off, hist_off, hw, width_;

  __host__ SingleCopyModel(int clients, int servers, int slots)
      : C(clients), S(servers), E(slots) {
    sw = 1;
    aw = S + C;
    net_off = aw;
    timer_off = net_off + 4 * E;
    hist_off = timer_off + 1;
    hw = 1 + 3 * C;
    width_ = hist_off + hw;
  }

  __host__ bool ok() const {
    return C >= 1 && C <= actor::kMaxClients && S >= 1 &&
           S <= kMaxServers && E >= 1 && E <= actor::kMaxSlots &&
           width_ <= W;
  }

  __host__ __device__ int width() const { return width_; }
  __host__ int max_actions() const { return E; }
  __host__ __device__ int n_sends() const { return 1; }

  // single-copy-register.rs:18-37: a Put stores its value and answers
  // PutOk, a Get answers GetOk with the stored word.
  __device__ __forceinline__ bool server_step(
      uint32_t sid, const uint32_t (&sv)[kMaxSW], uint32_t src, uint32_t m0,
      uint32_t m1, uint32_t (&nw)[kMaxSW],
      actor::Send (&sends)[kMaxSends]) const {
    using namespace actor;
    const uint32_t val = sv[0], mtype = m0 >> 24,
                   m_rid = (m0 >> 12) & 0xFFFu;
    const bool is_put = mtype == T_PUT, is_get = mtype == T_GET;
    nw[0] = is_put ? m0 & 0xFu : val;
    sends[0] = is_put ? Send{src, (T_PUTOK << 24) | (m_rid << 12), 0u, true}
               : is_get
                   ? Send{src, (T_GETOK << 24) | (m_rid << 12) | val, 0u, true}
                   : no_send();
    return is_put && nw[0] != val;
  }

  __device__ __forceinline__ uint32_t props_row(const uint32_t* w) const {
    return 1u | (actor::value_chosen(w + net_off, E) ? 2u : 0u);
  }

  __device__ __forceinline__ int quiet_from(const uint32_t* w) const {
    return actor::zero_tail(w + net_off, E);
  }

  // The child of row w (shared memory) under action lane e, built by the
  // group g into dst (its row of flat): whether it is a valid successor,
  // ovf whether it overflowed (its words kPoison, invalid), (hi, lo) its
  // fingerprint.
  template <class Grp>
  __device__ __forceinline__ bool step_group(const uint32_t* w, int e,
                                             const Grp& g, uint32_t* dst,
                                             bool& ovf, uint32_t& hi,
                                             uint32_t& lo) const {
    return actor::register_step_group(*this, w, e, g, dst, ovf, hi, lo);
  }
};
