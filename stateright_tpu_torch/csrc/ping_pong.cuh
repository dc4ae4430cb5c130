// The ping-pong fixture as CUDA device functions: the packed step, the
// property bits and the boundary of stateright_tpu_torch/actor/test_util.py
// (PackedPingPong.packed_step / packed_properties / packed_boundary: the
// JAX package's _packed_step_unordered with PackedPingPong's
// packed_deliver, stateright_tpu/actor/test_util.py:117), for E <= 16
// network slots on either unordered network, lossy or not: the network
// (dup) is a parameter; the drop lanes (lossy) pick the instantiation.
//
// Packed state (actor/packed.py finalize_layout), width 3 + 3 E (51 at
// E = 16): [actor 0's count, actor 1's count | [hdr, count, msg] x E |
// timer]; msg = type << 8 | value (Ping 1, Pong 2). Action lane e < E
// delivers slot e; with lossy, lane E + e drops it.
//
// PingPongModel::step is one lane's step on register arrays of W words,
// the network's slots at the static offset 2 (actor_net.cuh
// row_net_consume, row_net_send), every loop over them unrolled with
// static indices and guarded by the runtime E. Lossless, K1 runs it as a
// narrow model (a thread a lane, as increment.cuh; every level of the
// lossless fixture is one row, where the narrow K1 is the faster one).
// Lossy (PingPongLossyModel), K1 runs it on the shared-row path
// (step_common.cuh WideRow, DropLanes): the rows in shared memory, only
// the deliveries and drops before the network's zero tail, each delivery
// stepped densely by a thread through step_row (the row copied into the
// step's arrays, the child put through a RowOut into the thread's
// staging row, which its warp copies to flat 32 consecutive words a
// store), each drop child's fingerprint from the row's suffix folds and
// its words written by a group of lanes from the shared row
// (actor_net.cuh drop_suffix_folds, drop_fold, drop_write).
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

// The fixture on a lossy network, on K1's shared-row path (step_common.cuh
// WideRow, DropLanes; actor_net.cuh DropEdit): the rows in shared memory,
// only the active lanes stepped (row_lanes: the deliveries and the drops
// of the slots before the network's zero tail, by a warp). A delivery
// goes through step_row; a drop child is the row with slot e's count
// less one or the network's words from slot e on moved up a slot (on the
// duplicating network always: the envelope removed), as
// PaxosLossyModel's (actor_net.cuh DropLaneOps), valid iff the slot is
// occupied and the row within the boundary; every other lane is invalid,
// does not overflow, and its row of flat is not written.
struct PingPongLossyModel : PingPongModel,
                            actor::DropLaneOps<PingPongLossyModel> {
  static constexpr bool kWideRow = true;
  static constexpr bool kLossy = true;
  // a slot's words (actor_net.cuh kSlotWords): hdr, count, msg
  static constexpr int kSlotWords = 3;
  static constexpr int net_off = kNetOff;
  // K1's shared row (RowState): the widest row's 51 words made a
  // multiple of four, so that the row and its flags fill whole 16-byte
  // units (ops/_cuda.py WIDE_MODELS sizes the launch with it)
  static constexpr int W = 52;

  __host__ PingPongLossyModel(int max_nat_, int slots, int dup_)
      : PingPongModel(max_nat_, slots, dup_, 1) {}

  // PingPongModel::props of the shared row w.
  __device__ __forceinline__ uint32_t props_row(const uint32_t* w) const {
    const uint32_t a = w[0], b = w[1];
    const bool delta = max(a, b) - min(a, b) <= 1u;
    const bool reach = a == max_nat || b == max_nat;
    const bool exceed = a == max_nat + 1u || b == max_nat + 1u;
    return (delta ? 1u : 0u) | (reach ? 6u : 0u) | (exceed ? 8u : 0u);
  }

  // The deliveries and drops of the slots before the network's zero tail
  // (the first slot from which every slot is all-zero words).
  __device__ __forceinline__ uint32_t active_lanes(const uint32_t* w) const {
    const uint32_t* net = w + kNetOff;
    int z = E;
    while (z > 0 && (net[3 * z - 3] | net[3 * z - 2] | net[3 * z - 1]) == 0u)
      --z;
    const uint32_t below = (1u << z) - 1u;  // z <= 16
    return below | (below << E);
  }

  // The property bits and the active lanes of row w (shared memory) by a
  // group g of 32 lanes, lane r reading slot r (the zero tail by a
  // ballot).
  template <class Grp>
  __device__ __forceinline__ void row_lanes(const uint32_t* w, const Grp& g,
                                            uint32_t& pb,
                                            uint32_t& mask) const {
    pb = props_row(w);
    const int r = g.rank();
    const uint32_t* slot = w + kNetOff + 3 * (r < E ? r : 0);
    const bool word = r < E && (slot[0] | slot[1] | slot[2]) != 0u;
    const uint32_t nz = g.ballot(word);
    const int z = nz ? 32 - __clz(nz) : 0;
    const uint32_t below = (1u << z) - 1u;  // z <= 16
    mask = below | (below << E);
  }

  // Delivery lane act's child of row w (shared memory) into out (a
  // RowOut: the thread's staging row and the child's fingerprint):
  // PingPongModel::step on a register copy of the row, with its
  // overflow and kPoison rules.
  template <class Out>
  __device__ __forceinline__ bool step_row(const uint32_t* w, int act,
                                           Out& out, bool& ovf) const {
    constexpr int kW = PingPongModel::W;
    const int width_ = width();
    uint32_t x[kW], s[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) x[k] = k < width_ ? w[k] : 0u;
    const bool v = step(x, act, s, ovf);
#pragma unroll
    for (int k = 0; k < kW; ++k)
      if (k < width_) out.put(k, s[k]);
    return v;
  }

  // A drop lane's edit (lane >= E; never overflowing): valid iff the slot
  // is occupied and the row within the boundary (the child's counts are
  // the row's).
  __device__ __forceinline__ actor::DropEdit drop_edit(const uint32_t* w,
                                                       int lane) const {
    actor::DropEdit ed = actor::drop_edit(*this, w, lane, dup);
    ed.valid = ed.valid && w[0] <= max_nat && w[1] <= max_nat;
    return ed;
  }
};
