// ABD (the quorum-replicated linearizable register) as CUDA device
// functions: the server step and the property bits of
// stateright_tpu_torch/examples/abd_packed.py (PackedAbd._server_step /
// packed_properties: the JAX package's stateright_tpu/examples/
// abd_packed.py:153-289 with the register dispatch of
// actor/packed_register.py), for C <= 7 clients and S <= 4 servers on
// both networks of actor/packed.py (no drops, timers or crashes:
// PackedAbd.cuda_spec refuses the rest):
//
//   AbdModel         the unordered non-duplicating network of E <= 16
//                    slots (at most 128 words): a group model
//                    (kGroupRow, step_common.cuh), each child built by a
//                    group of lanes with the network in their registers
//                    (actor_net.cuh register_step_group), the network's
//                    zero tail quiet;
//   AbdOrderedModel  the ordered network's register channels of depth D
//                    (at most 32 channels and 352 words: the BASELINE's
//                    PackedAbd(2, ordered=True) is 108, bench.py's
//                    tpu_abd3 260 and tpu_abd2 331): an edit model
//                    (kEditRow, step_common.cuh), whose lane computes
//                    the edit of its child (actor_net.cuh
//                    register_edit_ordered) and whose warps write the
//                    children from the shared row (ordered_child_word).
//
// Packed server state (2 + S words): w0 = seq | val << 12 | tag << 16 |
// rid << 18 | requester << 26 (tag 0 idle, 1 phase 1, 2 phase 2), w1 =
// write_present | write_val << 1 | read_present << 5 | read_val << 6 |
// acks << 10, resp[k] = present << 16 | seq << 4 | val. Messages: [type
// << 24 | rid << 12 | seq, value]. The step is uint32 arithmetic, as the
// JAX package's.
#pragma once

#include <cstdint>

#include "actor_net.cuh"

// ABD's server step (linearizable-register.rs:57-188), shared by both
// networks' models.
struct AbdServer {
  static constexpr int kMaxServers = 4;
  static constexpr int kMaxSW = 2 + kMaxServers;  // a server's words
  static constexpr int kMaxSends = kMaxServers - 1;  // the peers
  // protocol-internal message tags (abd_packed.py T_*)
  static constexpr uint32_t T_QUERY = 5, T_ACKQUERY = 6, T_RECORD = 7,
                            T_ACKRECORD = 8;

  int C, S;

  // its handlers' sends: the S - 1 peers (one for a single server)
  __host__ __device__ int n_sends() const { return S > 1 ? S - 1 : 1; }

  // Server sid's on_msg on its words sv, from src, message (m0, m1):
  // the new words nw, whether it changed, and its sends (the peers
  // (sid + 1 + k) % S at k, a reply at k = 0).
  __device__ __forceinline__ bool server_step(
      uint32_t sid, const uint32_t (&sv)[kMaxSW], uint32_t src, uint32_t m0,
      uint32_t m1, uint32_t (&nw)[kMaxSW],
      actor::Send (&sends)[kMaxSends]) const {
    using namespace actor;
    const uint32_t quorum = (uint32_t)(S / 2 + 1);
    const uint32_t srv_src = min(src, (uint32_t)(S - 1));
    const uint32_t w0 = sv[0], w1 = sv[1];
    const uint32_t seq = w0 & 0xFFFu, val = (w0 >> 12) & 0xFu,
                   tag = (w0 >> 16) & 3u, rid = (w0 >> 18) & 0xFFu,
                   requester = (w0 >> 26) & 0xFu;
    const bool wr_p = w1 & 1u, rd_p = (w1 >> 5) & 1u;
    const uint32_t wr_v = (w1 >> 1) & 0xFu, rd_v = (w1 >> 6) & 0xFu,
                   acks = (w1 >> 10) & 0xFu;
    const uint32_t mtype = m0 >> 24, m_rid = (m0 >> 12) & 0xFFFu,
                   m_seq = m0 & 0xFFFu, m_val = m1 & 0xFu;
#pragma unroll
    for (int k = 0; k < kMaxSends; ++k) sends[k] = no_send();
    auto set_send = [&](int k, bool cond, uint32_t dst, uint32_t x0,
                        uint32_t x1) {
#pragma unroll
      for (int j = 0; j < kMaxSends; ++j)
        if (j == k && cond) sends[j] = Send{dst, x0, x1, true};
    };
    auto broadcast = [&](bool cond, uint32_t x0, uint32_t x1) {
#pragma unroll
      for (int k = 0; k < kMaxSends; ++k)
        if (k < S - 1) set_send(k, cond, (sid + 1u + k) % (uint32_t)S, x0, x1);
    };
    uint32_t resp[kMaxServers];
#pragma unroll
    for (int j = 0; j < kMaxServers; ++j) resp[j] = j < S ? sv[2 + j] : 0u;

    // Put/Get while idle: phase 1, query the peers
    const bool is_put = mtype == T_PUT;
    const bool start = (is_put || mtype == T_GET) && tag == 0u;
    broadcast(start, (T_QUERY << 24) | (m_rid << 12), 0u);
    uint32_t nw0 = w0, nw1 = w1;
    if (start) {
      nw0 = seq | (val << 12) | (1u << 16) | (m_rid << 18) | (src << 26);
      nw1 = is_put ? 1u | ((m0 & 0xFu) << 1) : 0u;
#pragma unroll
      for (int j = 0; j < kMaxServers; ++j)
        resp[j] = (uint32_t)j == sid ? (1u << 16) | (seq << 4) | val : 0u;
    }

    // Query: answer with our (seq, val)
    set_send(0, mtype == T_QUERY, src,
             (T_ACKQUERY << 24) | (m_rid << 12) | seq, val);

    // AckQuery in phase 1: collect, act at quorum
    const bool ackq = mtype == T_ACKQUERY && tag == 1u && m_rid == rid;
    uint32_t cnt = 0u, best = 0u;
    uint32_t resp2[kMaxServers];
#pragma unroll
    for (int j = 0; j < kMaxServers; ++j) {
      resp2[j] = ackq && (uint32_t)j == srv_src
                     ? (1u << 16) | (m_seq << 4) | m_val
                     : resp[j];
      if (j < S && ((resp2[j] >> 16) & 1u)) {
        ++cnt;
        best = max(best, resp2[j] & 0xFFFFu);
      }
    }
    const bool q_hit = ackq && cnt == quorum;
    // newest (seq, value): the integer max over packed seq << 4 | val
    const uint32_t b_seq = best >> 4, b_val = best & 0xFu;
    const uint32_t n_seq = wr_p ? (((b_seq >> 4) + 1u) << 4) | sid : b_seq;
    const uint32_t n_val = wr_p ? wr_v : b_val;
    broadcast(q_hit, (T_RECORD << 24) | (rid << 12) | n_seq, n_val);
    if (q_hit) {  // phase 2 (self-ack); adopt the recorded value if newer
      nw0 = (n_seq > seq ? n_seq | (n_val << 12) : seq | (val << 12)) |
            (2u << 16) | (rid << 18) | (requester << 26);
      nw1 = (wr_p ? 0u : (1u << 5) | (b_val << 6)) | ((1u << sid) << 10);
    }
#pragma unroll
    for (int j = 0; j < kMaxServers; ++j)
      resp[j] = q_hit ? 0u : ackq ? resp2[j] : resp[j];

    // Record: ack; adopt if newer
    const bool is_rec = mtype == T_RECORD;
    set_send(0, is_rec, src, (T_ACKRECORD << 24) | (m_rid << 12), 0u);
    const bool adopt = is_rec && m_seq > (nw0 & 0xFFFu);
    if (adopt) nw0 = (nw0 & ~0xFFFFu) | m_seq | (m_val << 12);

    // AckRecord in phase 2: count, respond at quorum
    const bool already = (acks >> srv_src) & 1u;
    const bool ackr =
        mtype == T_ACKRECORD && tag == 2u && m_rid == rid && !already;
    const uint32_t acks2 = acks | (1u << srv_src);
    uint32_t cnt2 = 0u;
#pragma unroll
    for (int j = 0; j < kMaxServers; ++j)
      if (j < S) cnt2 += (acks2 >> j) & 1u;
    const bool r_hit = ackr && cnt2 == quorum;
    set_send(0, r_hit, requester,
             rd_p ? (T_GETOK << 24) | (rid << 12) | rd_v
                  : (T_PUTOK << 24) | (rid << 12),
             0u);
    if (ackr && !r_hit) nw1 = (nw1 & ~(0xFu << 10)) | (acks2 << 10);
    if (r_hit) {  // back to idle: the phase bits cleared
      nw0 &= 0xFFFFu;
      nw1 = 0u;
    }

    nw[0] = nw0;
    nw[1] = nw1;
#pragma unroll
    for (int j = 2; j < kMaxSW; ++j) nw[j] = resp[j - 2];
    return start || ackq || adopt || ackr;
  }
};

// ABD on the unordered network: the layout of actor/packed.py
// finalize_layout, S (2 + S) + C + 4 E + 1 + 1 + 3 C words.
struct AbdModel : AbdServer {
  static constexpr int W = 128;  // C = 7, S = 4, E = 16 need 118
  static constexpr bool kGroupRow = true;

  int E;  // network slots
  int sw, aw, net_off, timer_off, hist_off, hw, width_;

  __host__ AbdModel(int clients, int servers, int slots) : E(slots) {
    C = clients;
    S = servers;
    sw = 2 + S;
    aw = S * sw + C;
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

  // Bit 0: "linearizable", evaluated on the host (neutral true); bit 1:
  // "value chosen".
  __device__ __forceinline__ uint32_t props_row(const uint32_t* w) const {
    return 1u | (actor::value_chosen(w + net_off, E) ? 2u : 0u);
  }

  // The network's zero tail (paxos.cuh quiet_from): an empty slot's
  // child is the row, invalid.
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

// ABD on the ordered network: the register channels of depth D, the
// layout of finalize_layout: S (2 + S) + C actor words, the channels'
// lengths, their entries (2 D words each), the timer and the history.
// Action lane c delivers the head of channel c. Only the lanes of
// non-empty channels are stepped (active_lanes): an empty channel's lane
// is invalid and never overflows, and K1 leaves its child unwritten
// (the JAX step and the plain version write the row with the length
// wrapped to 0xFFFFFFFF there); every other lane's words, fingerprint,
// validity and overflow are the plain version's bit for bit.
struct AbdOrderedModel : AbdServer {
  static constexpr int W = 352;  // bench.py's tpu_abd2 (C 2, S 3, D 8): 331
  static constexpr bool kEditRow = true;
  static constexpr int kMaxChannels = 32;  // a mask of the lanes
  using Edit = actor::OrderedEdit<kMaxSW, kMaxSends>;
  using Head = actor::OrderedHead<kMaxSends>;
  // ops/_cuda.py EDIT_MODELS sizes K1's shared memory with it
  static_assert(sizeof(Edit) == 45 * sizeof(uint32_t), "EDIT_MODELS");

  int D;  // channel depth
  int sw, aw, nchan, lens_off, msgs_off, timer_off, hist_off, hw, width_;

  __host__ AbdOrderedModel(int clients, int servers, int depth) : D(depth) {
    C = clients;
    S = servers;
    sw = 2 + S;
    aw = S * sw + C;
    nchan = 2 * C * S + S * (S - 1);
    lens_off = aw;
    msgs_off = lens_off + nchan;
    timer_off = msgs_off + nchan * D * 2;
    hist_off = timer_off + 1;
    hw = 1 + 3 * C;
    width_ = hist_off + hw;
  }

  __host__ bool ok() const {
    return C >= 1 && C <= actor::kMaxClients && S >= 1 &&
           S <= kMaxServers && D >= 1 && nchan <= kMaxChannels &&
           width_ <= W;
  }

  __host__ __device__ int width() const { return width_; }
  __host__ int max_actions() const { return nchan; }

  __device__ __forceinline__ uint32_t props_row(const uint32_t* w) const {
    return 1u | (actor::value_chosen_ordered(w, lens_off, msgs_off, nchan,
                                             D)
                     ? 2u
                     : 0u);
  }

  // The lanes K1 steps (bit c: channel c holds a message).
  __device__ __forceinline__ uint32_t active_lanes(const uint32_t* w) const {
    return actor::nonempty_channels(w, lens_off, nchan);
  }

  __device__ __forceinline__ bool edit_lane(const uint32_t* w, int c,
                                            Edit& ed, bool& ovf) const {
    return actor::register_edit_ordered(*this, w, c, ed, ovf);
  }

  __device__ __forceinline__ Head edit_head(const Edit& ed) const {
    return actor::ordered_head(ed, D);
  }

  __device__ __forceinline__ uint32_t child_word(const uint32_t* w,
                                                 const Edit& ed,
                                                 const Head& h, int k,
                                                 uint32_t old) const {
    return actor::ordered_child_word(*this, w, ed, h, k, old);
  }
};
