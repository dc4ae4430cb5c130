// The ping-pong fixture as CUDA device functions: the packed step, the
// property bits and the boundary of stateright_tpu_torch/actor/test_util.py
// (PackedPingPong.packed_step / packed_properties / packed_boundary: the
// JAX package's _packed_step_unordered with PackedPingPong's
// packed_deliver, stateright_tpu/actor/test_util.py:117), for E <= 16
// network slots on either unordered network, lossy or not: the network
// (dup) and the drop lanes (lossy) are kernel parameters, so one
// instantiation serves the four quadrants.
//
// Packed state (actor/packed.py finalize_layout), width 3 + 3 E (51 at
// E = 16): [actor 0's count, actor 1's count | [hdr, count, msg] x E |
// timer]; msg = type << 8 | value (Ping 1, Pong 2). Action lane e < E
// delivers slot e; with lossy, lane E + e drops it.
//
// A narrow model (a thread a lane, as increment.cuh): the row and the
// child are register arrays of W words, the network's slots at the static
// offset 2 (actor_net.cuh row_net_consume, row_net_send), every loop over
// them unrolled with static indices and guarded by the runtime E.
#pragma once

#include <cstdint>

#include "actor_net.cuh"

struct PingPongModel {
  static constexpr int kNetOff = 2;  // the actors' words come first
  // the most packed words: E = 16
  static constexpr int W = kNetOff + 3 * actor::kMaxSlots + 1;
  static constexpr uint32_t T_PING = 1, T_PONG = 2;

  uint32_t max_nat;
  int E;
  bool dup, lossy;

  __host__ PingPongModel(int max_nat_, int slots, int dup_, int lossy_)
      : max_nat((uint32_t)max_nat_), E(slots), dup(dup_ != 0),
        lossy(lossy_ != 0) {}

  __host__ bool ok() const {
    return E >= 1 && E <= actor::kMaxSlots && (int)max_nat >= 0;
  }

  __host__ __device__ int width() const { return kNetOff + 3 * E + 1; }
  __host__ int max_actions() const { return lossy ? 2 * E : E; }

  // Successor of w under action lane act into s; returns whether it is a
  // valid child, ovf whether it overflowed the network (its words are
  // then actor::kPoison and it is invalid). A delivery of slot e: the
  // recipient whose count equals the message's value takes it (its count
  // plus one) and answers a Pong(v) with Ping(v + 1), a Ping(v) with
  // Pong(v); the slot is consumed (on the duplicating network it stays);
  // valid iff the slot is occupied, the recipient exists and took it. A
  // drop of slot e (lane E + e): the slot consumed, or removed on the
  // duplicating network; valid iff it is occupied. Either is kept within
  // the boundary (both counts at most max_nat).
  __device__ __forceinline__ bool step(const uint32_t (&w)[W], int act,
                                       uint32_t (&s)[W], bool& ovf) const {
    const bool drop = lossy && act >= E;
    const int e = drop ? act - E : min(act, E - 1);
    uint32_t hdr = 0u, msg = 0u;
#pragma unroll
    for (int j = 0; j < actor::kMaxSlots; ++j)
      if (j == e) {
        hdr = w[kNetOff + 3 * j];
        msg = w[kNetOff + 3 * j + 2];
      }
#pragma unroll
    for (int k = 0; k < W; ++k) s[k] = w[k];
    const bool occupied = (hdr & actor::kOcc) != 0u;
    ovf = false;
    bool valid;
    if (drop) {
      actor::row_net_consume<kNetOff>(s, e, E, dup);
      valid = occupied;
    } else {
      const uint32_t src = (hdr >> 8) & 0xFFu, dst = hdr & 0xFFu;
      const uint32_t cnt = dst == 0u ? w[0] : dst == 1u ? w[1] : 0u;
      const uint32_t mtype = msg >> 8, value = msg & 0xFFu;
      const bool changed =
          cnt == value && (mtype == T_PING || mtype == T_PONG);
      if (changed && dst == 0u) s[0] = cnt + 1u;
      if (changed && dst == 1u) s[1] = cnt + 1u;
      const uint32_t reply = mtype == T_PONG ? (T_PING << 8) | (value + 1u)
                                             : (T_PONG << 8) | value;
      if (!dup) actor::row_net_consume<kNetOff>(s, e, E, false);
      const bool overflow =
          actor::row_net_send<kNetOff>(s, dst, src, reply, changed, dup, E);
      valid = occupied && dst < 2u && changed;
      if (valid && overflow) {
        ovf = true;
#pragma unroll
        for (int k = 0; k < W; ++k) s[k] = actor::kPoison;
        return false;
      }
    }
    return valid && s[0] <= max_nat && s[1] <= max_nat;
  }

  // Bit 0 "delta within 1", bit 1 "can reach max", bit 2 "must reach
  // max" (eventually), bit 3 "must exceed max" (eventually).
  __device__ __forceinline__ uint32_t props(const uint32_t (&w)[W]) const {
    const uint32_t a = w[0], b = w[1];
    const bool delta = max(a, b) - min(a, b) <= 1u;
    const bool reach = a == max_nat || b == max_nat;
    const bool exceed = a == max_nat + 1u || b == max_nat + 1u;
    return (delta ? 1u : 0u) | (reach ? 6u : 0u) | (exceed ? 8u : 0u);
  }
};
