// The fused BFS step on Hopper: expand -> fingerprint -> ring probe ->
// visited-table claim -> commit, in three kernels, plus the stand-alone
// table insert.
//
// Replaces the Pallas step kernel of the JAX package,
// stateright_tpu/ops/fused.py:259 (build_fused_block_fn), in the
// configurations the single-chip main path runs: probe=True, properties
// in the kernel, cross-chunk ring on, without symmetry
// (srt_fused_step_twopc) and with it (srt_fused_step_twopc_sym: K1's
// symmetric instantiation keys each child on fp64(canon(child)) and
// writes fp64(child) to ohi/olo; K2 and K3 key on chi/clo either way, so
// they dedup, claim and ring-cache canonical keys). Built with nvcc for
// sm_90a into a shared library with a plain C interface and driven over
// ctypes by stateright_tpu_torch/ops/_cuda.py.
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
//   K2 claim_kernel    one block per tile of K1's: the tile's lowest
//                      valid lane of each key, found in a shared
//                      open-addressed table,
//                      probes the cross-chunk ring as it stood when the
//                      step began (a hit kills the lane), then walks the
//                      4-slot buckets of the visited table and claims the
//                      first empty slot with a 64-bit atomicCAS; the
//                      tile's other lanes stop there.
//   K3 commit_kernel   one thread per lane: resolve which lane of each
//                      fresh key is the inserted one, write the ring,
//                      publish the per-step discovery registers.
//   K4 insert_kernel   the probe/claim of K2 on its own, for seeding and
//                      growth.
//
// K1, the bucket probe/claim and the counters are in step_common.cuh,
// shared with the sharded step (sharded_step.cu).
//
// Rules the design takes:
//   * The table holds one 64-bit key (hi << 32 | lo) per slot, so a
//     claim writes both halves in one atomicCAS; 0 is the empty slot
//     and a fingerprint is never 0.
//   * Winner rule: exactly one lane per fresh key is "inserted", the
//     LOWEST valid lane carrying it. Every tile winner (the lowest valid
//     lane of its key in its tile) whose probe ends at slot s
//     atomicMin's ((~step) << 32 | lane) into owner[s]; the lane whose
//     CAS claimed s writes stamp[s] = step. After K2, lane l is inserted
//     iff stamp[slot(l)] == step and owner[slot(l)] holds its own word:
//     the minimum of the tiles' minima. The step tag in the high half
//     makes older owner words larger, so owner and stamp never need
//     clearing between steps. The tile stage changes which lanes reach
//     the table (dvalid, lane_slot, the ring-hit and round counts), not
//     which lane is inserted.
//   * Ring: the claiming lane atomicMin's its key into ring_arena[slot];
//     in K3 the inserted lane of the smallest fresh key of each ring
//     slot writes it: one deterministic writer per slot. K1 resets the
//     arena for the step.
//   * Within one step K2 sees no ring entries written in that step
//     (the Pallas grid's later blocks do); such lanes die in the table
//     probe instead, so the inserted key set is the same.
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
// bucket as two 16-byte L2 loads, and adds its counters once per block.
// At the thin-frontier step (256 rows) the tiles shrink to one row per
// block so the launch still spreads over the SMs; latency rules there.

#include "step_common.cuh"

// Mirrored by ops/_cuda.py InsertArgs.
struct InsertArgs {
  const uint32_t* hi;  // [n]
  const uint32_t* lo;
  const uint8_t* valid;
  long long n;
  unsigned long long* keys;
  long long n_buckets;
  int max_rounds;
  uint8_t* inserted;  // [n]
  int* stats;         // [2]: overflow, most rounds of one lane
  void* stream;
};

namespace {

// K2. One block per tile of whole rows (a.tile, K1's tiles), in three
// phases:
//   1. every valid lane enters (key, its tile lane) into an
//      open-addressed table of a.tile.cells shared cells (64-bit CAS on
//      the key, atomicMin on the lane), so each cell ends holding the
//      tile's LOWEST valid lane of its key;
//   2. those tile winners go to a shared list (warp-aggregated); every
//      other lane is done: dvalid = 0, lane_slot = -1;
//   3. one thread per winner: the ring probe (read only in K2, through
//      the read-only path; a hit kills the lane: committed in an earlier
//      step), then the bucket walk and claim of probe_claim, stamp[s] =
//      step by the claiming lane, and the owner word ((~step) << 32 |
//      lane) atomicMin'ed into owner[s] by every winner whose probe ends
//      at s, a claimer or not (a claimer of this step may not have
//      written its stamp yet).
// owner[s] so ends holding the minimum of the tiles' minima: the lowest
// valid lane of each fresh key, as without the tile stage.
__global__ void claim_kernel(StepArgs a) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const TileGeometry& g = a.tile;
  const int A = a.A;
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(tile_smem);
  uint32_t* s_lane = reinterpret_cast<uint32_t*>(s_key + g.cells);
  uint32_t* s_cell = s_lane + g.cells;  // [rows * A] tile lane -> cell
  uint32_t* s_win = s_cell + g.rows * A;  // [rows * A] the tile's winners
  __shared__ int s_nwin, s_cch, s_dv, s_rounds;
  const long long row0 = (long long)blockIdx.x * g.rows;
  const int nrows = (int)min((long long)g.rows, (long long)a.F - row0);
  const int n = nrows * A;
  const long long lane0 = row0 * A;
  const uint32_t cmask = (uint32_t)g.cells - 1u;
  if (threadIdx.x == 0) s_nwin = s_cch = s_dv = s_rounds = 0;
  for (int c = threadIdx.x; c < g.cells; c += blockDim.x) {
    s_key[c] = 0ull;
    s_lane[c] = ~0u;
  }
  __syncthreads();
  // 1. at most half the cells are ever taken: each walk ends
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const long long l = lane0 + t;
    uint32_t cell = ~0u;
    if (a.cvalid[l]) {
      const uint32_t hi = a.chi[l], lo = a.clo[l];
      const unsigned long long key = ((unsigned long long)hi << 32) | lo;
      uint32_t c = (lo ^ (hi * kPhi)) & cmask;
      while (true) {
        const unsigned long long prev = atomicCAS(&s_key[c], 0ull, key);
        if (prev == 0ull || prev == key) break;
        c = (c + 1) & cmask;
      }
      atomicMin(&s_lane[c], (uint32_t)t);
      cell = c;
    }
    s_cell[t] = cell;
  }
  __syncthreads();
  // 2. uniform trip count: the ballot needs the whole warp
  for (int base = 0; base < n; base += blockDim.x) {
    const int t = base + threadIdx.x;
    bool win = false;
    if (t < n) {
      const uint32_t c = s_cell[t];
      win = c != ~0u && s_lane[c] == (uint32_t)t;
      if (!win) {
        a.dvalid[lane0 + t] = 0;
        a.lane_slot[lane0 + t] = -1;
      }
    }
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, win);
    const int wl = threadIdx.x & 31;
    int at = 0;
    if (wl == 0 && ballot) at = atomicAdd(&s_nwin, __popc(ballot));
    at = __shfl_sync(0xFFFFFFFFu, at, 0);
    if (win) s_win[at + __popc(ballot & ((1u << wl) - 1u))] = (uint32_t)t;
  }
  __syncthreads();
  // 3.
  const int nwin = s_nwin;
  const unsigned long long tag = (unsigned long long)(~a.step) << 32;
  int cch = 0, dvs = 0, rounds = 0;
  for (int i = threadIdx.x; i < nwin; i += blockDim.x) {
    const int t = (int)s_win[i];
    const long long l = lane0 + t;
    const unsigned long long key = s_key[s_cell[t]];
    const uint32_t hi = (uint32_t)(key >> 32), lo = (uint32_t)key;
    const uint32_t rs =
        a.cc ? ((lo ^ (hi * kPhi)) & (uint32_t)(a.cc - 1)) : 0u;
    int dv = 0, slot = -1;
    if (a.cc && __ldg(a.ring + rs) == key) {
      ++cch;  // committed in an earlier step: a duplicate
    } else {
      dv = 1;
      long long s;
      int r;
      const int st = probe_claim(a.keys, a.n_buckets, hi, lo, a.max_rounds,
                                 &s, &r);
      rounds = max(rounds, r);
      if (st == PROBE_OVF) {
        atomicOr(&a.stats[S_OVF], 1);
      } else {
        if (st == PROBE_CLAIMED) {
          a.stamp[s] = a.step;
          if (a.cc) atomicMin(&a.ring_arena[rs], key);
        }
        atomicMin(&a.owner[s], tag | (unsigned long long)l);
        slot = (int)s;
      }
    }
    dvs += dv;
    a.dvalid[l] = (uint8_t)dv;
    a.lane_slot[l] = slot;
  }
  warp_add(&s_cch, cch);
  warp_add(&s_dv, dvs);
  warp_max(&s_rounds, rounds);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_cch) atomicAdd(&a.stats[S_CCH], s_cch);
    if (s_dv) atomicAdd(&a.stats[S_DEDUP], s_dv);
    if (s_rounds) atomicMax(&a.stats[S_ROUNDS], s_rounds);
  }
}

__global__ void commit_kernel(StepArgs a, long long n) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned long long tag = (unsigned long long)(~a.step) << 32;
  if (l == 0) publish_discoveries(a);
  int ins = 0;
  if (l < n) {
    const int s = a.lane_slot[l];
    ins = s >= 0 && a.stamp[s] == a.step &&
          a.owner[s] == (tag | (unsigned long long)l);
    a.inserted[l] = (uint8_t)ins;
    if (ins && a.cc) {
      const uint32_t hi = a.chi[l], lo = a.clo[l];
      const unsigned long long key = ((unsigned long long)hi << 32) | lo;
      const uint32_t rs = (lo ^ (hi * kPhi)) & (uint32_t)(a.cc - 1);
      if (a.ring_arena[rs] == key) a.ring[rs] = key;
    }
  }
  warp_add(&a.stats[S_INSERTED], ins);
}

__global__ void insert_kernel(InsertArgs a) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int rounds = 0;
  if (l < a.n) {
    int ins = 0;
    if (a.valid[l]) {
      long long s;
      const int st = probe_claim(a.keys, a.n_buckets, a.hi[l], a.lo[l],
                                 a.max_rounds, &s, &rounds);
      ins = st == PROBE_CLAIMED;
      if (st == PROBE_OVF) atomicOr(&a.stats[0], 1);
    }
    a.inserted[l] = (uint8_t)ins;
  }
  warp_max(&a.stats[1], rounds);
}

// K2's dynamic shared memory: cells keys and lanes, and per tile lane
// its cell and a slot of the winner list.
inline size_t claim_smem(const TileGeometry& g, int A) {
  return (size_t)g.cells * (sizeof(unsigned long long) + sizeof(uint32_t)) +
         (size_t)g.rows * A * 2 * sizeof(uint32_t);
}

template <class M, bool SYM>
int launch_step(const M& m, const StepArgs& a) {
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const long long lanes = (long long)a.F * a.A;
  const TileGeometry& g = a.tile;
  if (!geometry_ok(g, a.F, a.A) || g.cells < 2 * g.rows * a.A ||
      (g.cells & (g.cells - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_expand<M, SYM>(m, a, st);
  if (e != cudaSuccess) return (int)e;
  if (lanes == 0) return 0;
  const size_t smem = claim_smem(g, a.A);
  e = allow_smem(claim_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  claim_kernel<<<g.blocks, g.threads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  commit_kernel<<<blocks_for(lanes), kThreads, 0, st>>>(a, lanes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One fused step for TwoPhaseSys(n). Returns cudaGetLastError() of the
// launches (0 = launched); the caller raises on anything else.
int srt_fused_step_twopc(const StepArgs* args, int n) {
  const TwoPcModel m(n);
  if (args->A != m.max_actions()) return (int)cudaErrorInvalidValue;
  return launch_step<TwoPcModel, false>(m, *args);
}

// The same step under RM-permutation symmetry: dedup on canonical keys
// (complete = 1: the orbit-invariant representative), original
// fingerprints to ohi/olo.
int srt_fused_step_twopc_sym(const StepArgs* args, int n, int complete) {
  const TwoPcModel m(n, complete);
  if (args->A != m.max_actions() || args->ohi == nullptr ||
      args->olo == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_step<TwoPcModel, true>(m, *args);
}

// Stand-alone batched insert (seeding and growth).
int srt_table_insert(const InsertArgs* args) {
  const InsertArgs& a = *args;
  if (a.n == 0) return 0;
  insert_kernel<<<blocks_for(a.n), kThreads, 0,
                  static_cast<cudaStream_t>(a.stream)>>>(a);
  return (int)cudaGetLastError();
}

// Bytes of the argument structs, checked by the Python binding.
int srt_step_args_size() { return (int)sizeof(StepArgs); }
int srt_insert_args_size() { return (int)sizeof(InsertArgs); }

}  // extern "C"
