// Single-decree Paxos as CUDA device functions: the packed step and the
// property bits of stateright_tpu_torch/examples/paxos_packed.py
// (PackedPaxos.packed_step / packed_properties: the JAX package's
// _packed_step_unordered with the register dispatch and the Paxos
// server step, stateright_tpu/examples/paxos_packed.py:193), for C <= 7
// clients, S <= 4 servers and E <= 16 network slots as runtime
// arguments (unordered non-duplicating network, no timers:
// PackedPaxos.cuda_spec refuses the rest); under crash_restart its
// crash/restart lanes (PaxosCrashModel), on a lossy network its drop
// lanes (PaxosLossyModel, at the end).
//
// Packed state (actor/packed.py finalize_layout), width
// S (3 + S) + C + 4 E + 1 + 1 + 3 C (96 words at C = 3, S = 3, E = 16):
//   [server s: w0 = accepts << 12 | ballot | decided << 16, w1 the
//    proposal, prepares x S, accepted] x S | client word x C |
//   [hdr, count, m0, m1] x E | timer | history (valid, [e0, e1, inflight]
//   x C)
// Action lane e delivers network slot e.
//
// A row this wide does not fit K1's register arrays (two of 96 words a
// lane), so the model is a wide one (kWideRow, step_common.cuh): K1
// keeps the frontier row in shared memory, and step_row reads the
// delivered slot, the destination's words and the history from there,
// holds the child's network (64 words) and history in registers
// (actor_net.cuh) and writes the child once, word by word, through a
// RowOut that folds each word into the fingerprint; the words go to the
// thread's staging row in shared memory, from which K1 copies the child
// to flat with coalesced stores. Lanes from quiet_from on are not
// stepped: their child is the row. An overflowing child (a send that
// finds no slot) is written as 0xDEADBEEF words and is invalid, as in
// the JAX package.
#pragma once

#include <cstdint>

#include "actor_net.cuh"

struct PaxosModel {
  // the most packed words of a row (RowState's shared copy): C = 7,
  // S = 4, E = 16 need 122
  static constexpr int W = 128;
  // K1 takes the row from shared memory and the child through RowOut
  static constexpr bool kWideRow = true;
  static constexpr int kMaxServers = 4;
  static constexpr int kMaxSW = 3 + kMaxServers;  // a server's words
  static constexpr int kMaxSends = kMaxServers;   // a handler's sends

  // protocol-internal message tags (paxos_packed.py T_*)
  static constexpr uint32_t T_PREPARE = 5, T_PREPARED = 6, T_ACCEPT = 7,
                            T_ACCEPTED = 8, T_DECIDED = 9;

  int C, S, E;       // clients, servers, network slots
  int sw, aw;        // a server's words; all actors' words
  int net_off, timer_off, hist_off, hw, width_;

  __host__ PaxosModel(int clients, int servers, int slots)
      : C(clients), S(servers), E(slots) {
    sw = 3 + S;
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

  // The first action lane whose child is the row itself, as are all
  // after it (K1 copies the row there and steps only the lanes before
  // it): the network's zero tail. A slot there holds no message (header
  // 0: server 0 is handed message type 0, which no branch of
  // server_step takes; record_in ignores it), and consuming it shifts
  // zeros, so the child is the row, invalid and without overflow.
  __device__ __forceinline__ int quiet_from(const uint32_t* w) const {
    return actor::zero_tail(w + net_off, E);
  }

  // Server sid's on_msg (paxos.rs:85-172) on its words sv, from src,
  // message (m0, m1): the new words nw, whether it changed, and its
  // sends (the S - 1 peers (sid + 1 + k) % S at k, the requester's
  // PutOk or a reply at k = 0 or S - 1).
  __device__ __forceinline__ bool server_step(
      uint32_t sid, const uint32_t (&sv)[kMaxSW], uint32_t src, uint32_t m0,
      uint32_t c, uint32_t (&nw)[kMaxSW],
      actor::Send (&sends)[kMaxSends]) const {
    using namespace actor;
    const uint32_t quorum = (uint32_t)(S / 2 + 1);
    const uint32_t srv_src = min(src, (uint32_t)(S - 1));
    const uint32_t w0 = sv[0], w1 = sv[1];
    uint32_t accepted = 0u;
#pragma unroll
    for (int j = 0; j < kMaxSW; ++j)
      if (j == 2 + S) accepted = sv[j];
    const uint32_t ballot = w0 & 0xFFFu;
    const uint32_t accepts_mask = (w0 >> 12) & 0xFu;
    const bool decided = (w0 >> 16) & 1u;
    const bool has_proposal = (w1 >> 15) & 1u;
    const uint32_t mtype = m0 >> 24, a = (m0 >> 12) & 0xFFFu,
                   b = m0 & 0xFFFu;
#pragma unroll
    for (int k = 0; k < kMaxServers; ++k) sends[k] = no_send();
    auto set_send = [&](int k, bool cond, uint32_t dst, uint32_t x0,
                        uint32_t x1) {
#pragma unroll
      for (int j = 0; j < kMaxServers; ++j) {
        if (j == k && cond) sends[j] = Send{dst, x0, x1, true};
      }
    };
    auto broadcast = [&](bool cond, uint32_t x0, uint32_t x1) {
#pragma unroll
      for (int k = 0; k < kMaxServers - 1; ++k)
        if (k < S - 1) set_send(k, cond, (sid + 1u + k) % (uint32_t)S, x0, x1);
    };

    // decided: only Get is answered (paxos.rs:87-95)
    set_send(0, decided && mtype == T_GET, src,
             (T_GETOK << 24) | (a << 12) | (accepted & 0xFu), 0u);
    uint32_t nw0 = w0, nw1 = w1, naccepted = accepted;
    uint32_t npreps[kMaxServers];
#pragma unroll
    for (int j = 0; j < kMaxServers; ++j) npreps[j] = sv[2 + j];
    const bool live = !decided;

    // Put: become leader of a fresh ballot (paxos.rs:96-104)
    const bool put_ok = live && mtype == T_PUT && !has_proposal;
    const uint32_t nb = ((((ballot >> 4) + 1u) << 4) | sid);
    if (put_ok) {
      nw0 = nb;  // accepts/decided bits cleared
      nw1 = (1u << 15) | (a << 8) | (src << 4) | (m0 & 0xFu);
#pragma unroll
      for (int j = 0; j < kMaxServers; ++j)
        npreps[j] = (uint32_t)j == sid
                        ? (1u << 27) | (accepted & 0x7FFFFFFu) : 0u;
    }
    broadcast(put_ok, (T_PREPARE << 24) | nb, 0u);

    // Prepare (paxos.rs:108-114)
    const bool prep_ok = live && mtype == T_PREPARE && ballot < b;
    if (prep_ok) nw0 = (nw0 & ~0xFFFu) | b;
    set_send(0, prep_ok, src, (T_PREPARED << 24) | b,
             accepted & 0x7FFFFFFu);

    // Prepared (paxos.rs:116-138)
    const bool prpd_ok = live && mtype == T_PREPARED && b == ballot;
    uint32_t count = 0u, la_max = 0u;
#pragma unroll
    for (int j = 0; j < kMaxServers; ++j) {
      if (j < S) {
        if (prpd_ok && (uint32_t)j == srv_src)
          npreps[j] = (1u << 27) | (c & 0x7FFFFFFu);
        const bool present = (npreps[j] >> 27) & 1u;
        count += present;
        la_max = max(la_max, present ? npreps[j] & 0x7FFFFFFu : 0u);
      }
    }
    const bool prpd_q = prpd_ok && count == quorum;
    // leadership handoff: favour the newest accepted proposal
    const uint32_t q_proposal =
        ((la_max >> 26) & 1u) ? (1u << 15) | (la_max & 0x3FFFu) : nw1;
    if (prpd_q) {
      nw1 = q_proposal;
      nw0 = (nw0 & ~(0xFu << 12)) | ((1u << sid) << 12);
      naccepted = (1u << 26) | (b << 14) | (q_proposal & 0x3FFFu);
    }
    broadcast(prpd_q, (T_ACCEPT << 24) | b, q_proposal & 0x3FFFu);

    // Accept (paxos.rs:140-146)
    const bool acc_ok = live && mtype == T_ACCEPT && ballot <= b;
    if (acc_ok) {
      nw0 = (nw0 & ~0xFFFu) | b;
      naccepted = (1u << 26) | (b << 14) | (c & 0x3FFFu);
    }
    set_send(0, acc_ok, src, (T_ACCEPTED << 24) | b, 0u);

    // Accepted (paxos.rs:148-164)
    const bool acd_ok = live && mtype == T_ACCEPTED && b == ballot;
    const uint32_t new_mask = (accepts_mask | (1u << srv_src)) & 0xFu;
    uint32_t cnt = 0u;
#pragma unroll
    for (int j = 0; j < kMaxServers; ++j)
      if (j < S) cnt += (new_mask >> j) & 1u;
    const bool acd_q = acd_ok && cnt == quorum;
    if (acd_ok) nw0 = (nw0 & ~(0xFu << 12)) | (new_mask << 12);
    if (acd_q) nw0 |= 1u << 16;
    broadcast(acd_q, (T_DECIDED << 24) | b, nw1 & 0x3FFFu);
    set_send(S - 1, acd_q, (nw1 >> 4) & 0xFu,
             (T_PUTOK << 24) | (((nw1 >> 8) & 0x3Fu) << 12), 0u);

    // Decided (paxos.rs:166-171)
    const bool dcd = live && mtype == T_DECIDED;
    if (dcd) {
      nw0 = ((nw0 & ~0xFFFu) | b) | (1u << 16);
      naccepted = (1u << 26) | (b << 14) | (c & 0x3FFFu);
    }

    nw[0] = nw0;
    nw[1] = nw1;
#pragma unroll
    for (int j = 2; j < kMaxSW; ++j)
      nw[j] = j - 2 < S ? npreps[j - 2 < kMaxServers ? j - 2 : 0]
                        : (j == 2 + S ? naccepted : 0u);
    return put_ok || prep_ok || prpd_ok || acc_ok || acd_ok || dcd;
  }

  // its handlers' sends: the S - 1 peers, and the PutOk of a decision
  __device__ __forceinline__ int n_sends() const { return S; }

  // The child of row w (shared memory) under action lane e into out;
  // returns whether it is a valid successor, ovf whether it overflowed
  // the network (then its words are kPoison and it is invalid).
  template <class Out>
  __device__ __forceinline__ bool step_row(const uint32_t* w, int e,
                                           Out& out, bool& ovf) const {
    return actor::register_step_unordered(*this, w, e, out, ovf);
  }
};

// PackedPaxos under crash_restart(k, actors=...): PaxosModel with the
// crash word after the timer word (the history one word right) and a
// crash and a restart lane per crashable actor after the E deliveries
// (actor_net.cuh CrashSpec; the durable mask a kernel argument: a Paxos
// server's words all survive, a client's none, paxos_packed.py
// durable_word_mask). K1-wide steps the active lanes only (active_lanes:
// no quiet tail): a delivery's child through step_row, as PaxosModel's;
// a crash or restart lane's child, the row with one to three words
// changed, as an edit with its fingerprint (the row's folds with those
// words refolded) by a thread, then written from the shared row by a
// warp (crash_child, crash_write); every other lane is invalid, does not
// overflow, and its row of flat is not written.
struct PaxosCrashModel : PaxosModel {
  static constexpr bool kCrash = true;
  actor::CrashSpec cr;

  __host__ PaxosCrashModel(int clients, int servers, int slots,
                           actor::CrashSpec spec)
      : PaxosModel(clients, servers, slots), cr(spec) {
    hist_off = timer_off + 2;
    width_ = hist_off + hw;
  }

  __host__ bool ok() const {
    return PaxosModel::ok() && cr.k >= 1 && cr.ok(S + C, aw, E);
  }

  __host__ int max_actions() const { return E + 2 * cr.n; }

  __device__ __forceinline__ uint32_t active_lanes(const uint32_t* w) const {
    return actor::crash_active_lanes(*this, w);
  }

  // Delivery lane e's child (e < E) as PaxosModel's, with the crash
  // lanes' rules (a recipient that is down, the crash word).
  template <class Out>
  __device__ __forceinline__ bool step_row(const uint32_t* w, int e,
                                           Out& out, bool& ovf) const {
    return actor::register_step_unordered(*this, w, e, out, ovf);
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

// PackedPaxos on a lossy network (lossy_network(True)): PaxosModel with a
// drop lane per network slot after the E deliveries (actor_net.cuh
// DropEdit). K1-wide steps the active lanes only (row_lanes: the
// deliveries and the drops of the slots before the network's zero tail,
// by a warp): a delivery's child through step_row, as PaxosModel's; a
// drop child, the row with its count word less one or its network's
// words from the dropped slot on moved up a slot, as an edit with its
// fingerprint (the row's folds with those words refolded) by a thread,
// then written from the shared row by a warp (drop_child, drop_write);
// every other lane is invalid, does not overflow, and its row of flat is
// not written.
struct PaxosLossyModel : PaxosModel {
  static constexpr bool kLossy = true;

  __host__ PaxosLossyModel(int clients, int servers, int slots)
      : PaxosModel(clients, servers, slots) {}

  __host__ int max_actions() const { return 2 * E; }

  __device__ __forceinline__ uint32_t active_lanes(const uint32_t* w) const {
    return actor::drop_active_lanes(*this, w);
  }

  // The property bits and the active lanes of row w (shared memory) by a
  // group g of 32 lanes (ballots in lane order).
  template <class Grp>
  __device__ __forceinline__ void row_lanes(const uint32_t* w, const Grp& g,
                                            uint32_t& pb,
                                            uint32_t& mask) const {
    actor::drop_row_lanes(*this, w, g, pb, mask);
  }

  // A drop lane's child (lane >= E; valid or not, never overflowing) in
  // two parts: its edit and fingerprint (hi, lo), from the row's folds
  // (r1, r2), by a thread; then its words, written to dst by lane r of G
  // lanes.
  using DropEdit = actor::DropEdit;

  __device__ __forceinline__ DropEdit drop_child(const uint32_t* w, int lane,
                                                 uint32_t r1, uint32_t r2,
                                                 uint32_t& hi,
                                                 uint32_t& lo) const {
    return actor::drop_fingerprint(*this, w, lane, false, r1, r2, hi, lo);
  }

  __device__ __forceinline__ void drop_write(const uint32_t* w,
                                             const DropEdit& ed, int r,
                                             int G, uint32_t* dst) const {
    actor::drop_copy(*this, w, ed, r, G, dst);
  }
};
