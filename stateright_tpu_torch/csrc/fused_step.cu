// The fused BFS step on Hopper: expand -> fingerprint -> ring probe ->
// visited-table claim -> commit, in three kernels, plus the stand-alone
// table insert (K4).
//
// Replaces the Pallas step kernel of the JAX package,
// stateright_tpu/ops/fused.py:259 (build_fused_block_fn), in the
// configurations the single-chip main path runs: probe=True, properties
// in the kernel, cross-chunk ring on, without symmetry
// (srt_fused_step_<model>) and with it (srt_fused_step_<model>_sym:
// K1's symmetric instantiation keys each child on fp64(canon(child)) and
// writes fp64(child) to ohi/olo; K2 and K3 key on chi/clo either way, so
// they dedup, claim and ring-cache canonical keys). The Pallas kernel
// vmaps any packed model's step; here K1 is a template over the model's
// device functions, instantiated for TwoPhaseSys (twopc.cuh, both
// flags), PackedLinearEquation (lineq.cuh), Increment (increment.cuh,
// both flags), IncrementLock (increment_lock.cuh), PackedPaxos
// (paxos.cuh, a wide model: K1 keeps its 96-word rows in shared memory,
// stages each child there and writes each warp's children with
// coalesced stores, step_common.cuh WideRow), PackedSingleCopy
// (single_copy.cuh, a group model: each child built by a half-warp with
// the network in its lanes, step_common.cuh GroupRow), PackedWriteOnce
// (write_once.cuh, a group model with crash/restart lanes,
// step_common.cuh CrashLanes), PackedPaxos under crash_restart
// (paxos.cuh PaxosCrashModel, the wide K1 with crash lanes) and on a
// lossy network (PaxosLossyModel, the wide K1 with drop lanes,
// step_common.cuh DropLanes), the actor test fixtures PackedPingPong
// (ping_pong.cuh: lossy, the wide K1 with drop lanes; lossless, a narrow
// model; the duplicating network a parameter) and PackedTimerCount
// (timer_count.cuh: a timer model, each Timeout child an edit of the
// shared row, step_common.cuh TimerRow), and PackedAbd (abd.cuh: a
// group model on the unordered network; on the ordered one an edit model
// of up to 352 words, whose warps write each child from the shared row
// and the lane's edit, step_common.cuh EditRow); the group and timer
// models step only the pending rows, which a gated launch spreads over
// its grid; K2 and
// K3 do not depend on the model. Built with nvcc for
// sm_90a into a shared library with a plain C interface and driven over
// ctypes by stateright_tpu_torch/ops/_cuda.py. K4 replaces the XLA insert
// stateright_tpu/ops/hashtable.py:71 (table_insert), not a pallas_call.
//
// What it computes (per step over F frontier rows of A action lanes):
//   K1 expand_kernel   one thread per lane over block tiles of whole
//                      rows (StepArgs.tile, from ops/_cuda.py
//                      tile_geometry): the row's words, property bits
//                      and eventually-bit clear once per row in shared
//                      memory; each lane's successor (flat), its
//                      fingerprints and validity, written coalesced;
//                      terminal as a per-row OR, and the discovery
//                      candidates (atomicMin of the row per property:
//                      the lowest row wins, which is the Pallas rule
//                      "first block with a hit, first row in it").
//   K2 claim_kernel    one block per tile of K1's: the tile stage
//                      (step_common.cuh) finds the tile's lowest valid
//                      lane of each key in a shared open-addressed table;
//                      only those probe the cross-chunk ring as it stood
//                      when the step began (a hit kills the lane), then
//                      walk the 4-slot buckets of the visited table and
//                      claim the first empty slot with a 64-bit
//                      atomicCAS; each claimed slot goes on the tile's
//                      claims list.
//   K3 commit_kernel   one block per tile, over its claims only: the
//                      inserted lane of each claimed slot (its owner
//                      word), the ring write, and the per-step discovery
//                      registers.
//   K4 flat_insert_kernel  the flat insert of step_common.cuh (one
//                      thread per lane: the bucket probe/claim, and with
//                      a mask the owner word, the grid's barrier and the
//                      claimer's commit), for seeding and growth, and in
//                      the staged chunk (staged.cu) the insert of the
//                      kfin slots, gated and tagged by the chunk's gate;
//                      its mask marks the LOWEST valid lane of each
//                      fresh key, as K2/K3 do.
//   K1 alone           srt_expand_<model>: the expand kernel without K2
//                      and K3, the staged step's expansion.
//
// K1, the bucket probe/claim, the counters and the flat insert are in
// step_common.cuh, shared with the sharded step (sharded_step.cu, whose
// K6 is the same flat insert).
//
// Rules the design takes:
//   * The table holds one 64-bit key (hi << 32 | lo) per slot, so a
//     claim writes both halves in one atomicCAS; 0 is the empty slot
//     and a fingerprint is never 0.
//   * Winner rule: exactly one lane per fresh key is "inserted", the
//     LOWEST valid lane carrying it. Every tile winner (the lowest valid
//     lane of its key in its tile) whose probe ends at slot s
//     atomicMin's ((~step) << 32 | lane) into owner[s]; the lane whose
//     CAS claimed s lists s among its tile's claims. After K2, the
//     inserted lane of each claimed slot is the low half of owner[s]:
//     the minimum of the tiles' minima, which may be a lane of another
//     tile than the claimer's. The step tag in the high half makes older
//     owner words larger, so they never need clearing between steps, and
//     K3 checks it (S_FAULT otherwise). The tile stage changes which
//     lanes reach the table (dvalid, the ring-hit and round counts), not
//     which lane is inserted.
//   * Ring: the claiming lane atomicMin's its key into ring_arena[rs];
//     in K3 every claim of ring slot rs writes ring[rs] =
//     ring_arena[rs], the same value: the smallest fresh key of the slot,
//     whatever the order. K1 resets the arena for the step.
//   * Within one step K2 sees no ring entries written in that step
//     (the Pallas grid's later blocks do); such lanes die in the table
//     probe instead, so the inserted key set is the same.
//   * K4 with a mask takes the owner words and the step counter of the
//     table's workspace (ops/fused.py StepWorkspace), so one counter tags
//     the steps and the inserts alike and no owner word needs clearing;
//     without a mask (the seed and growth, which drop it) it posts none.
//   * Inside a chunk (chunk.cu) K1-K3 are captured once per step size in
//     a CUDA graph of one iteration and read their window and tag from
//     the chunk's gate (StepArgs.gate, open_gate in step_common.cuh):
//     the tag grows by one per step that runs and starts each chunk
//     above every tag the host has handed out, so the owner-word rule
//     holds across replays, chunks and K4's masked inserts.
//
// What bounds it on this card: at 2pc n=7 and F = 12,288 rows (454,656
// lanes) the step moves ~7.3 MB of successors, ~3.6 MB of fingerprint
// pairs and ~32 B of bucket reads per lane that reaches the table, all
// in device memory (the whole working set fits in the 50 MB L2), and
// does ~120 integer operations per lane; the bytes bound it at ~5 us on
// an H100 SXM. Under symmetry at 2pc n=16 (82 actions, 1,007,616 lanes
// at F = 12,288) K1 also writes ~8 MB of original fingerprints and does
// ~500 integer operations per lane (the counting sort over 16 RMs and a
// second fingerprint): bytes still bound the step at ~14 us, and K1's
// integer work comes close. The design: K1 runs one thread per lane in
// ~1,000-lane tiles, so the grid fills the card (the first cut, one
// thread per row walking 37 or 82 actions in 48 blocks, spent ~13x the
// bound), and does the row's work once; K2 sends only one lane per key
// and tile to the ring and the table (~90 % of 2pc7's valid lanes carry
// a key already there or claimed in the same step; under symmetry the n
// lanes of an action family often share one canonical key), reads a
// bucket as two 16-byte L2 loads, and adds its counters once per block;
// K3 reads nothing per lane: it walks the ~2 * 10^4 claimed slots of a
// large step (of 454,656 lanes at 2pc n=7), which K2 listed per tile
// with their ring slots, since K2 already writes every lane's inserted =
// 0. At the thin-frontier step (256 rows) the tiles shrink to one row per
// block so the launch still spreads over the SMs; latency rules there.
// The increment models' rows are n + 1 or n + 2 words (up to 18), a
// runtime width within the row arrays' compile-time bound: K1 walks it
// with guarded unrolled loops (registers, no local memory) and writes
// each child as width strided words, so at IncrementLock(9) (11 words,
// F = 12,288: ~5 MB of successors) and Increment(16) (17 words: ~13 MB)
// the strided stores, not the bytes, set K1's time (7-10x its byte
// bound on an H100, PERF.md).

#include "abd.cuh"
#include "increment.cuh"
#include "increment_lock.cuh"
#include "lineq.cuh"
#include "paxos.cuh"
#include "ping_pong.cuh"
#include "single_copy.cuh"
#include "step_common.cuh"
#include "timer_count.cuh"
#include "twopc.cuh"
#include "write_once.cuh"

namespace {

// K2. One block per tile of whole rows (a.tile, K1's tiles): the tile
// stage (step_common.cuh: the tile's LOWEST valid lane of each key goes
// on; every lane gets inserted = 0 and every other lane dvalid = 0), then
// one thread per tile winner: the ring probe (read only in K2, through
// the read-only path; a hit kills the lane: committed in an earlier
// step), then the bucket walk and claim of probe_claim, and the owner
// word ((~step) << 32 | lane) atomicMin'ed into owner[s] by every winner
// whose probe ends at s, a claimer or not (the claimer may be a higher
// lane of another tile). owner[s] so ends holding the minimum of the
// tiles' minima: the lowest valid lane of each fresh key, as without the
// tile stage. The claiming lane atomicMin's its key into the ring arena
// and appends (ring slot << 32 | s) to the tile's claims
// (warp-aggregated, in the tile's own lane range of a.claims: a tile
// claims at most one slot per lane); the tile's count goes to a.n_claims
// and S_INSERTED: each claimed slot is one inserted lane, which K3
// finds. Inside a chunk the launch is gated like K1's (open_gate).
__global__ void claim_kernel(StepArgs a) {
  if (!open_gate(a, nullptr)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  const TileSmem s = tile_stage_smem(smem, a.tile, a.A);
  __shared__ int s_nwin, s_ncl, s_cch, s_dv, s_rounds;
  const Tile t = tile_of(a);
  if (threadIdx.x == 0) s_ncl = s_cch = s_dv = s_rounds = 0;
  const int nwin = tile_stage(a, s, t, &s_nwin, a.inserted, a.dvalid);
  const unsigned long long tag = (unsigned long long)(~a.step) << 32;
  int cch = 0, dvs = 0, rounds = 0;
  // uniform trip count: the claims list's ballot needs the whole warp
  for (int base = 0; base < nwin; base += blockDim.x) {
    const int i = base + threadIdx.x;
    bool claimed = false;
    unsigned long long claim = 0ull;  // ring slot << 32 | table slot
    if (i < nwin) {
      const uint32_t tl = s.win[i];
      const long long l = t.lane0 + tl;
      const unsigned long long key = s.key[s.cell[tl]];
      const uint32_t hi = (uint32_t)(key >> 32), lo = (uint32_t)key;
      const uint32_t rs =
          a.cc ? ((lo ^ (hi * kPhi)) & (uint32_t)(a.cc - 1)) : 0u;
      int dv = 0;
      if (a.cc && __ldg(a.ring + rs) == key) {
        ++cch;  // committed in an earlier step: a duplicate
      } else {
        dv = 1;
        long long slot;
        int r;
        const int st = probe_claim(a.keys, a.n_buckets, hi, lo,
                                   a.max_rounds, &slot, &r);
        rounds = max(rounds, r);
        if (st == PROBE_OVF) {
          atomicOr(&a.stats[S_OVF], 1);
        } else {
          if (st == PROBE_CLAIMED) {
            if (a.cc) atomicMin(&a.ring_arena[rs], key);
            claimed = true;
            claim = ((unsigned long long)rs << 32) | (unsigned long long)slot;
          }
          atomicMin(&a.owner[slot], tag | (unsigned long long)l);
        }
      }
      dvs += dv;
      a.dvalid[l] = (uint8_t)dv;
    }
    warp_append(a.claims + t.lane0, &s_ncl, claimed, claim);
  }
  warp_add(&s_cch, cch);
  warp_add(&s_dv, dvs);
  warp_max(&s_rounds, rounds);
  __syncthreads();
  if (threadIdx.x == 0) {
    a.n_claims[blockIdx.x] = s_ncl;
    if (s_ncl) atomicAdd(&a.stats[S_INSERTED], s_ncl);
    if (s_cch) atomicAdd(&a.stats[S_CCH], s_cch);
    if (s_dv) atomicAdd(&a.stats[S_DEDUP], s_dv);
    if (s_rounds) atomicMax(&a.stats[S_ROUNDS], s_rounds);
  }
}

// K3. One block per tile of K2's launch, over that tile's claims only:
// for each slot s it claimed, the inserted lane is the owner word's low
// half (the lowest valid lane of the key, which may lie in another tile:
// the claimer is only its own tile's lowest), and the key's ring slot rs
// gets ring_arena[rs], the smallest fresh key of that slot, which every
// claim of rs writes alike. An owner word without this step's tag is a
// kernel fault: S_FAULT, which the host loop raises. Block 0 publishes
// the step's discovery registers. Each claim is two dependent loads (the
// claim, then its owner word and ring arena slot together), and a thread
// reads its first claim with the tile's count (claims_walk). Gated like
// K1 inside a chunk.
__global__ void commit_kernel(StepArgs a) {
  if (!open_gate(a, nullptr)) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) publish_discoveries(a);
  const long long lanes = (long long)a.F * a.A;
  claims_walk(a, [&](unsigned long long claim) {
    const long long s = (long long)(claim & 0xFFFFFFFFull);
    const uint32_t rs = (uint32_t)(claim >> 32);
    const unsigned long long word = a.owner[s];
    const unsigned long long smallest = a.cc ? a.ring_arena[rs] : 0ull;
    const long long lane = owner_lane(word, a.step, lanes);
    if (lane < 0) {
      atomicOr(&a.stats[S_FAULT], 1);
      return;
    }
    a.inserted[lane] = 1;
    if (a.cc) a.ring[rs] = smallest;
  });
}

template <class M, bool SYM>
int launch_step(const M& m, const StepArgs& a) {
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const TileGeometry& g = a.tile;
  if (!tile_stage_ok(g, a.F, a.A)) return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_expand<M, SYM>(m, a, st);
  if (e != cudaSuccess) return (int)e;
  if ((long long)a.F * a.A == 0) return 0;
  const size_t smem = tile_stage_smem_bytes(g, a.A);
  e = allow_smem(claim_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  claim_kernel<<<g.blocks, g.threads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  commit_kernel<<<g.blocks, kCommitThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// The crash spec of a model's crash_restart (actor_net.cuh CrashSpec):
// max_crashes, the crashable actors, their indices a nibble each, the
// durable actor words' mask (two 32-bit halves).
inline actor::CrashSpec crash_spec(int k, int n, int idx, int dur_lo,
                                   int dur_hi) {
  return actor::CrashSpec{k, n, (uint32_t)idx, (uint32_t)dur_lo,
                          (uint32_t)dur_hi};
}

// How an entry runs its model's kernels: the whole fused step (K1-K3),
// or K1 alone, the staged step's expansion (staged.cu's kernels take
// its outputs).
enum class Run { kStep, kExpand };

template <Run R, class M, bool SYM>
int run(const M& m, const StepArgs& a) {
  if constexpr (R == Run::kExpand)
    return (int)launch_expand<M, SYM>(m, a,
                                      static_cast<cudaStream_t>(a.stream));
  else
    return launch_step<M, SYM>(m, a);
}

// One fused step for TwoPhaseSys(n).
template <Run R>
int twopc_entry(const StepArgs* args, int n) {
  const TwoPcModel m(n);
  if (args->A != m.max_actions()) return (int)cudaErrorInvalidValue;
  return run<R, TwoPcModel, false>(m, *args);
}

// The same step under RM-permutation symmetry: dedup on canonical keys
// (complete = 1: the orbit-invariant representative), original
// fingerprints to ohi/olo.
template <Run R>
int twopc_sym_entry(const StepArgs* args, int n, int complete) {
  const TwoPcModel m(n, complete);
  if (args->A != m.max_actions() || args->ohi == nullptr ||
      args->olo == nullptr)
    return (int)cudaErrorInvalidValue;
  return run<R, TwoPcModel, true>(m, *args);
}

// One fused step for PackedLinearEquation(a, b, c) (a and b as bytes, c
// a byte or 256: models/packed.py PackedLinearEquation.cuda_spec).
template <Run R>
int lineq_entry(const StepArgs* args, int a, int b, int c) {
  const LinearEquationModel m(a, b, c);
  if (args->A != m.max_actions()) return (int)cudaErrorInvalidValue;
  return run<R, LinearEquationModel, false>(m, *args);
}

// One fused step for Increment(n), 1 <= n <= 16.
template <Run R>
int increment_entry(const StepArgs* args, int n) {
  if (n < 1 || n > 16) return (int)cudaErrorInvalidValue;
  const IncrementModel m(n);
  if (args->A != m.max_actions()) return (int)cudaErrorInvalidValue;
  return run<R, IncrementModel, false>(m, *args);
}

// The same step under thread-permutation symmetry: dedup on the keys of
// the sorted thread words, original fingerprints to ohi/olo.
template <Run R>
int increment_sym_entry(const StepArgs* args, int n) {
  if (n < 1 || n > 16) return (int)cudaErrorInvalidValue;
  const IncrementModel m(n);
  if (args->A != m.max_actions() || args->ohi == nullptr ||
      args->olo == nullptr)
    return (int)cudaErrorInvalidValue;
  return run<R, IncrementModel, true>(m, *args);
}

// One fused step for PackedPaxos(clients, servers, slots) (paxos.cuh:
// at most 7 clients, 4 servers, 16 slots and 128 words; the wide K1).
template <Run R>
int paxos_entry(const StepArgs* args, int clients, int servers,
                         int slots) {
  const PaxosModel m(clients, servers, slots);
  if (!m.ok() || args->A != m.max_actions())
    return (int)cudaErrorInvalidValue;
  return run<R, PaxosModel, false>(m, *args);
}

// One fused step for PackedPaxos(clients, servers, slots) under
// crash_restart (paxos.cuh PaxosCrashModel: the wide K1 with a crash and
// a restart lane per crashable actor).
template <Run R>
int paxos_crash_entry(const StepArgs* args, int clients,
                               int servers, int slots, int k, int n, int idx,
                               int dur_lo, int dur_hi) {
  const PaxosCrashModel m(clients, servers, slots,
                          crash_spec(k, n, idx, dur_lo, dur_hi));
  if (!m.ok() || args->A != m.max_actions())
    return (int)cudaErrorInvalidValue;
  return run<R, PaxosCrashModel, false>(m, *args);
}

// One fused step for PackedPaxos(clients, servers, slots) on a lossy
// network (paxos.cuh PaxosLossyModel: the wide K1 with a drop lane per
// network slot).
template <Run R>
int paxos_lossy_entry(const StepArgs* args, int clients,
                               int servers, int slots) {
  const PaxosLossyModel m(clients, servers, slots);
  if (!m.ok() || args->A != m.max_actions())
    return (int)cudaErrorInvalidValue;
  return run<R, PaxosLossyModel, false>(m, *args);
}

// One fused step for PackedPingPong(max_nat, lossy, duplicating, slots)
// (ping_pong.cuh: at most 16 slots; lossy, the wide K1 with drop lanes,
// PingPongLossyModel; lossless, the narrow K1, PingPongModel).
template <Run R>
int ping_pong_entry(const StepArgs* args, int max_nat, int slots, int dup,
                    int lossy) {
  if (lossy) {
    const PingPongLossyModel m(max_nat, slots, dup);
    if (!m.ok() || args->A != m.max_actions())
      return (int)cudaErrorInvalidValue;
    return run<R, PingPongLossyModel, false>(m, *args);
  }
  const PingPongModel m(max_nat, slots, dup, 0);
  if (!m.ok() || args->A != m.max_actions())
    return (int)cudaErrorInvalidValue;
  return run<R, PingPongModel, false>(m, *args);
}

// One fused step for PackedTimerCount(n, max_nat) (timer_count.cuh: at
// most 32 actors; K1's timer path, step_common.cuh TimerRow, stepping the
// Timeout lanes whose timer bit is set).
template <Run R>
int timer_count_entry(const StepArgs* args, int n, int max_nat) {
  const TimerCountModel m(n, max_nat);
  if (!m.ok() || args->A != m.max_actions())
    return (int)cudaErrorInvalidValue;
  return run<R, TimerCountModel, false>(m, *args);
}

// One fused step for PackedWriteOnce(clients, servers, durable, slots),
// with or without crash_restart (write_once.cuh: at most 7 clients, 4
// servers, 16 slots, 8 actors and 128 words; the group K1 with crash
// lanes).
template <Run R>
int write_once_entry(const StepArgs* args, int clients, int servers,
                              int slots, int k, int n, int idx, int dur_lo,
                              int dur_hi) {
  const WriteOnceModel m(clients, servers, slots,
                         crash_spec(k, n, idx, dur_lo, dur_hi));
  if (!m.ok() || args->A != m.max_actions())
    return (int)cudaErrorInvalidValue;
  return run<R, WriteOnceModel, false>(m, *args);
}

// One fused step for PackedSingleCopy(clients, servers, slots)
// (single_copy.cuh: at most 7 clients, 4 servers, 16 slots and 128
// words; the group K1).
template <Run R>
int single_copy_entry(const StepArgs* args, int clients,
                               int servers, int slots) {
  const SingleCopyModel m(clients, servers, slots);
  if (!m.ok() || args->A != m.max_actions())
    return (int)cudaErrorInvalidValue;
  return run<R, SingleCopyModel, false>(m, *args);
}

// One fused step for PackedAbd(clients, servers, slots) on the unordered
// network (abd.cuh AbdModel: at most 7 clients, 4 servers, 16 slots and
// 128 words; the group K1).
template <Run R>
int abd_entry(const StepArgs* args, int clients, int servers,
                       int slots) {
  const AbdModel m(clients, servers, slots);
  if (!m.ok() || args->A != m.max_actions())
    return (int)cudaErrorInvalidValue;
  return run<R, AbdModel, false>(m, *args);
}

// One fused step for PackedAbd(clients, servers, ordered=True,
// channel_depth=depth) (abd.cuh AbdOrderedModel: at most 7 clients, 4
// servers, 32 channels and 352 words; the edit K1).
template <Run R>
int abd_ordered_entry(const StepArgs* args, int clients,
                               int servers, int depth) {
  const AbdOrderedModel m(clients, servers, depth);
  if (!m.ok() || args->A != m.max_actions())
    return (int)cudaErrorInvalidValue;
  return run<R, AbdOrderedModel, false>(m, *args);
}

// One fused step for IncrementLock(n), 1 <= n <= 16.
template <Run R>
int increment_lock_entry(const StepArgs* args, int n) {
  if (n < 1 || n > 16) return (int)cudaErrorInvalidValue;
  const IncrementLockModel m(n);
  if (args->A != m.max_actions()) return (int)cudaErrorInvalidValue;
  return run<R, IncrementLockModel, false>(m, *args);
}

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() of its launches (0 = launched);
// the caller raises on anything else. srt_fused_step_<model> launches
// K1-K3 of one fused step, srt_expand_<model> K1 alone (the staged
// step's expansion).

int srt_fused_step_twopc(const StepArgs* args, int n) {
  return twopc_entry<Run::kStep>(args, n);
}
int srt_expand_twopc(const StepArgs* args, int n) {
  return twopc_entry<Run::kExpand>(args, n);
}

int srt_fused_step_twopc_sym(const StepArgs* args, int n, int complete) {
  return twopc_sym_entry<Run::kStep>(args, n, complete);
}
int srt_expand_twopc_sym(const StepArgs* args, int n, int complete) {
  return twopc_sym_entry<Run::kExpand>(args, n, complete);
}

int srt_fused_step_lineq(const StepArgs* args, int a, int b, int c) {
  return lineq_entry<Run::kStep>(args, a, b, c);
}
int srt_expand_lineq(const StepArgs* args, int a, int b, int c) {
  return lineq_entry<Run::kExpand>(args, a, b, c);
}

int srt_fused_step_increment(const StepArgs* args, int n) {
  return increment_entry<Run::kStep>(args, n);
}
int srt_expand_increment(const StepArgs* args, int n) {
  return increment_entry<Run::kExpand>(args, n);
}

int srt_fused_step_increment_sym(const StepArgs* args, int n) {
  return increment_sym_entry<Run::kStep>(args, n);
}
int srt_expand_increment_sym(const StepArgs* args, int n) {
  return increment_sym_entry<Run::kExpand>(args, n);
}

int srt_fused_step_paxos(const StepArgs* args, int clients, int servers,
                         int slots) {
  return paxos_entry<Run::kStep>(args, clients, servers, slots);
}
int srt_expand_paxos(const StepArgs* args, int clients, int servers,
                         int slots) {
  return paxos_entry<Run::kExpand>(args, clients, servers, slots);
}

int srt_fused_step_paxos_crash(const StepArgs* args, int clients,
                               int servers, int slots, int k, int n, int idx,
                               int dur_lo, int dur_hi) {
  return paxos_crash_entry<Run::kStep>(args, clients, servers, slots, k, n, idx, dur_lo, dur_hi);
}
int srt_expand_paxos_crash(const StepArgs* args, int clients,
                               int servers, int slots, int k, int n, int idx,
                               int dur_lo, int dur_hi) {
  return paxos_crash_entry<Run::kExpand>(args, clients, servers, slots, k, n, idx, dur_lo, dur_hi);
}

int srt_fused_step_paxos_lossy(const StepArgs* args, int clients,
                               int servers, int slots) {
  return paxos_lossy_entry<Run::kStep>(args, clients, servers, slots);
}
int srt_expand_paxos_lossy(const StepArgs* args, int clients,
                               int servers, int slots) {
  return paxos_lossy_entry<Run::kExpand>(args, clients, servers, slots);
}

int srt_fused_step_ping_pong(const StepArgs* args, int max_nat, int slots,
                             int dup, int lossy) {
  return ping_pong_entry<Run::kStep>(args, max_nat, slots, dup, lossy);
}
int srt_expand_ping_pong(const StepArgs* args, int max_nat, int slots,
                             int dup, int lossy) {
  return ping_pong_entry<Run::kExpand>(args, max_nat, slots, dup, lossy);
}

int srt_fused_step_timer_count(const StepArgs* args, int n, int max_nat) {
  return timer_count_entry<Run::kStep>(args, n, max_nat);
}
int srt_expand_timer_count(const StepArgs* args, int n, int max_nat) {
  return timer_count_entry<Run::kExpand>(args, n, max_nat);
}

int srt_fused_step_write_once(const StepArgs* args, int clients, int servers,
                              int slots, int k, int n, int idx, int dur_lo,
                              int dur_hi) {
  return write_once_entry<Run::kStep>(args, clients, servers, slots, k, n, idx, dur_lo, dur_hi);
}
int srt_expand_write_once(const StepArgs* args, int clients, int servers,
                              int slots, int k, int n, int idx, int dur_lo,
                              int dur_hi) {
  return write_once_entry<Run::kExpand>(args, clients, servers, slots, k, n, idx, dur_lo, dur_hi);
}

int srt_fused_step_single_copy(const StepArgs* args, int clients,
                               int servers, int slots) {
  return single_copy_entry<Run::kStep>(args, clients, servers, slots);
}
int srt_expand_single_copy(const StepArgs* args, int clients,
                               int servers, int slots) {
  return single_copy_entry<Run::kExpand>(args, clients, servers, slots);
}

int srt_fused_step_abd(const StepArgs* args, int clients, int servers,
                       int slots) {
  return abd_entry<Run::kStep>(args, clients, servers, slots);
}
int srt_expand_abd(const StepArgs* args, int clients, int servers,
                       int slots) {
  return abd_entry<Run::kExpand>(args, clients, servers, slots);
}

int srt_fused_step_abd_ordered(const StepArgs* args, int clients,
                               int servers, int depth) {
  return abd_ordered_entry<Run::kStep>(args, clients, servers, depth);
}
int srt_expand_abd_ordered(const StepArgs* args, int clients,
                               int servers, int depth) {
  return abd_ordered_entry<Run::kExpand>(args, clients, servers, depth);
}

int srt_fused_step_increment_lock(const StepArgs* args, int n) {
  return increment_lock_entry<Run::kStep>(args, n);
}
int srt_expand_increment_lock(const StepArgs* args, int n) {
  return increment_lock_entry<Run::kExpand>(args, n);
}

// K4, the stand-alone batched insert (seeding and growth): the flat
// insert of step_common.cuh over args->F lanes.
int srt_table_insert(const StepArgs* args) {
  return (int)launch_insert(*args);
}

// Bytes of the argument struct, checked by the Python binding.
int srt_step_args_size() { return (int)sizeof(StepArgs); }

#ifdef SRT_K1_PHASES
// K1's phase clocks since the last call (step_common.cuh K1Clock: the
// ticks of each phase summed over blocks, then the blocks) into out
// (kK1Phases + 1 values), cleared; a tool's build only.
int srt_k1_phase_ticks(unsigned long long* out) {
  const size_t n = sizeof(unsigned long long) * (kK1Phases + 1);
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, k1_phase_ticks, n);
  unsigned long long zero[kK1Phases + 1] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(k1_phase_ticks, zero, n);
  return (int)e;
}
#endif

}  // extern "C"
