// The sharded engine's two kernels on Hopper: the probe-free step (K1
// expand + K5 dedup) and the owner-side probe (K6).
//
// Replaces the two Pallas kernels of the JAX package's sharded fused
// path (stateright_tpu/parallel/sharded.py, fused branch):
//   * stateright_tpu/ops/fused.py:259 build_fused_block_fn with
//     probe=False: expand, fingerprint, properties, in-batch pre-dedup,
//     read-only cross-chunk ring probe; no visited table (children are
//     routed to their owner rank before any table probe); without
//     symmetry (srt_dedup_step_twopc) and with it
//     (srt_dedup_step_twopc_sym: K1's symmetric instantiation, so K5
//     dedups canonical keys and the owner is chosen by them);
//   * stateright_tpu/ops/fused.py:526 build_probe_block_fn: the owner
//     rank's probe/insert of the lanes it received in the exchange.
// Built with nvcc for sm_90a into its own shared library with a plain C
// interface, driven over ctypes by stateright_tpu_torch/ops/_cuda.py.
//
// What it computes:
//   K1 expand_kernel        (step_common.cuh) one thread per lane
//                           over block tiles of whole rows: successors,
//                           fingerprints (canonical keys and original
//                           ones under symmetry), validity, property
//                           bits, discovery rows.
//   K5 dedup_claim_kernel   one block per tile of K1's: the tile stage
//                           of fused_step.cu's K2 (step_common.cuh: the
//                           tile's lowest valid lane of each key; dvalid
//                           = 0 for every lane), then one thread per tile
//                           winner: probe the ring (read only; a hit
//                           counts cch and drops the lane), else claim
//                           the key in a step-wide arena of >= 2*F*A
//                           single-key cells (linear probing, 64-bit
//                           atomicCAS) and atomicMin the owner word
//                           ((~step) << 32 | lane) of its cell; the lane
//                           whose CAS took the cell lists it among its
//                           tile's claims.
//      dedup_commit_kernel  one block per tile, over its claims only:
//                           dvalid for the owner lane of each claimed
//                           cell (the LOWEST live lane of its key,
//                           step-wide), and the cell cleared, so the
//                           arena is all zero for the next step without a
//                           memset; publishes the discoveries.
//   K6 flat_insert_kernel   the flat insert of step_common.cuh, the
//                           kernel of fused_step.cu's K4, with a mask:
//                           one thread per received lane walks the
//                           4-slot buckets of this rank's table slice,
//                           claims, and atomicMin's the owner word; after
//                           the grid's barrier each claimer marks its
//                           slot's owner lane: the LOWEST received lane
//                           of each fresh key.
//
// Rules the design takes:
//   * dvalid keeps the lowest live lane of each key, step-wide: a key's
//     lowest valid lane wins its own tile, the ring kills every lane of a
//     key or none, and the owner word takes the minimum over the tile
//     winners. So dvalid holds the plain version's key set with one lane
//     per key, where JAX keeps one lane per key and <=256-row block, or
//     more when a foreign key won the key's pre-dedup cell.
//   * cch counts the tile winners whose key the ring holds, not the
//     lanes that survive JAX's per-block pre-dedup as the plain version
//     does: the same change as K2's.
//   * The arena's cells are cleared by their claims' commit, so it is
//     zero between steps (zeroed once, when the workspace is made, and
//     shared by steps of every width up to its own); owner words carry
//     the step tag in their high half, so older words are larger and
//     never need clearing (the rule of fused_step.cu), and the commit
//     checks the tag (S_FAULT otherwise).
//   * K6 reuses fused_step.cu's winner rule on the table slice, so the
//     owner's search record (which parent a child keeps) repeats run to
//     run; its owner words and step counter are the slice's workspace's
//     (ops/fused.py StepWorkspace), and the claimer keeps its slot in a
//     register across the barrier, so no per-slot claim stamp and no
//     per-lane slot scratch are kept.
//
// What bounds it on this card: at 2pc n=7 and F = 12,288 rows (454,656
// lanes) the probe-free step writes ~7.3 MB of successors and ~3.6 MB
// of fingerprints (all within the 50 MB L2): bytes bound it at a few
// microseconds. The first cut cleared a 6.3 MB pre-dedup arena
// and the 8 MB key arena each step and ran three one-thread-per-lane
// kernels with global atomics after K1; now the tile stage keeps the
// dedup of a tile in shared memory, only the ~67k tile winners touch the
// ring and the arena, and the commit walks only the ~22k claims. K6 on
// ~57k received lanes (~22k valid, the rest padding) reads ~0.5 MB of
// lanes and one 32-byte bucket per valid key: well under a microsecond
// of bytes, so its launch and its chain of dependent memory steps rule
// (the lane, its bucket, the CAS, the grid's barrier, the owner word).
// The first cut ran two kernels after a torch fill of the mask, stamped
// each claimed slot and re-read every lane's slot, stamp and owner word;
// K2's tile stage and per-tile claims lists, tried in its place, cost
// more latency than they saved on these batches, whose lanes are mostly
// distinct keys (tools/torch_insert_sweep.py, PERF.md). Under
// symmetry only K1 changes (its symmetric instantiation; fused_step.cu
// notes its bound).

#include "step_common.cuh"

// Mirrored by ops/_cuda.py DedupArgs.
struct DedupArgs {
  StepArgs s;                       // K1's and the tile stage's arguments
                                    // (no table: keys, owner
                                    // unused)
  unsigned long long* arena;        // [cells] step-wide key arena, all 0
                                    // between steps
  unsigned long long* arena_owner;  // [cells] owner words
  long long cells;
};

namespace {

__device__ __forceinline__ uint32_t key_hash(uint32_t hi, uint32_t lo) {
  return lo ^ (hi * kPhi);
}

__global__ void dedup_claim_kernel(DedupArgs d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const StepArgs& a = d.s;
  const TileSmem s = tile_stage_smem(smem, a.tile, a.A);
  __shared__ int s_nwin, s_ncl, s_cch;
  const Tile t = tile_of(a);
  if (threadIdx.x == 0) s_ncl = s_cch = 0;
  const int nwin = tile_stage(a, s, t, &s_nwin, a.dvalid, nullptr);
  const unsigned long long tag = (unsigned long long)(~a.step) << 32;
  const unsigned long long mask = (unsigned long long)(d.cells - 1);
  int cch = 0;
  // uniform trip count: the claims list's ballot needs the whole warp
  for (int base = 0; base < nwin; base += blockDim.x) {
    const int i = base + threadIdx.x;
    bool took = false;
    unsigned long long cell = 0ull;
    if (i < nwin) {
      const uint32_t tl = s.win[i];
      const unsigned long long key = s.key[s.cell[tl]];
      const uint32_t h = key_hash((uint32_t)(key >> 32), (uint32_t)key);
      if (a.cc && __ldg(a.ring + (h & (uint32_t)(a.cc - 1))) == key) {
        ++cch;  // committed in an earlier step: a duplicate
      } else {
        unsigned long long g = (unsigned long long)h & mask;
        unsigned long long prev;
        // at most half the cells are ever taken: this ends
        while (true) {
          prev = atomicCAS(&d.arena[g], 0ull, key);
          if (prev == 0ull || prev == key) break;
          g = (g + 1) & mask;
        }
        atomicMin(&d.arena_owner[g],
                  tag | (unsigned long long)(t.lane0 + tl));
        took = prev == 0ull;
        cell = g;
      }
    }
    warp_append(a.claims + t.lane0, &s_ncl, took, cell);
  }
  warp_add(&s_cch, cch);
  __syncthreads();
  if (threadIdx.x == 0) {
    a.n_claims[blockIdx.x] = s_ncl;
    if (s_cch) atomicAdd(&a.stats[S_CCH], s_cch);
  }
}

__global__ void dedup_commit_kernel(DedupArgs d) {
  const StepArgs& a = d.s;
  if (blockIdx.x == 0 && threadIdx.x == 0) publish_discoveries(a);
  const long long lanes = (long long)a.F * a.A;
  const int n = claims_walk(a, [&](unsigned long long c) {
    const long long lane = owner_lane(d.arena_owner[c], a.step, lanes);
    d.arena[c] = 0ull;  // the claim's own cell: clean for the next step
    if (lane < 0)
      atomicOr(&a.stats[S_FAULT], 1);
    else
      a.dvalid[lane] = 1;
  });
  if (threadIdx.x == 0 && n) {
    atomicAdd(&a.stats[S_DEDUP], n);
    atomicAdd(&a.stats[S_INSERTED], n);
  }
}

template <class M, bool SYM>
int launch_dedup_step(const M& m, const DedupArgs& d) {
  const StepArgs& a = d.s;
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const TileGeometry& g = a.tile;
  cudaError_t e = launch_expand<M, SYM>(m, a, st);
  if (e != cudaSuccess || (long long)a.F * a.A == 0) return (int)e;
  const size_t smem = tile_stage_smem_bytes(g, a.A);
  e = allow_smem(dedup_claim_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dedup_claim_kernel<<<g.blocks, g.threads, smem, st>>>(d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dedup_commit_kernel<<<g.blocks, kCommitThreads, 0, st>>>(d);
  return (int)cudaGetLastError();
}

// The arena holds >= 2 cells per lane, so a linear probe ends.
bool dedup_args_ok(const TwoPcModel& m, const DedupArgs& d) {
  const long long lanes = (long long)d.s.F * d.s.A;
  return d.s.A == m.max_actions() && tile_stage_ok(d.s.tile, d.s.F, d.s.A) &&
         d.cells >= 2 * lanes && (d.cells & (d.cells - 1)) == 0;
}

}  // namespace

extern "C" {

// One probe-free step for TwoPhaseSys(n). Returns cudaGetLastError() of
// the launches (0 = launched); the caller raises on anything else.
int srt_dedup_step_twopc(const DedupArgs* args, int n) {
  const TwoPcModel m(n);
  if (!dedup_args_ok(m, *args)) return (int)cudaErrorInvalidValue;
  return launch_dedup_step<TwoPcModel, false>(m, *args);
}

// The same step under RM-permutation symmetry (complete = 1: the
// orbit-invariant representative): dedup and ownership on canonical
// keys, original fingerprints to ohi/olo.
int srt_dedup_step_twopc_sym(const DedupArgs* args, int n, int complete) {
  const TwoPcModel m(n, complete);
  if (!dedup_args_ok(m, *args) || args->s.ohi == nullptr ||
      args->s.olo == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_dedup_step<TwoPcModel, true>(m, *args);
}

// K6, the owner-side probe of the received lanes against this rank's
// slice: the flat insert of step_common.cuh over args->F lanes.
int srt_probe_block(const StepArgs* args) {
  return (int)launch_insert(*args);
}

// Bytes of the argument structs, checked by the Python binding.
int srt_dedup_args_size() { return (int)sizeof(DedupArgs); }
int srt_step_args_size() { return (int)sizeof(StepArgs); }

}  // extern "C"
