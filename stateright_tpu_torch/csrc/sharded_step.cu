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
//   K5 predup_kernel        one thread per lane: the JAX pre_dedup
//                           arena of the lane's <=256-row block (the
//                           lowest valid lane of each cell wins, by
//                           atomicMin of the block-local lane).
//      dedup_claim_kernel   one thread per lane that survives that
//                           pre-dedup: probe the ring (read only; a hit
//                           counts cch and drops the lane), then claim
//                           the key in a step-wide scratch arena of
//                           >= 2*F*A single-key cells (linear probing,
//                           64-bit atomicCAS) and atomicMin the owner
//                           word ((~step) << 32 | lane) of its cell.
//      dedup_commit_kernel  one thread per lane: dvalid iff the lane
//                           owns its cell, so the LOWEST surviving lane
//                           of each key goes on, deterministically, and
//                           no key twice; publishes the discoveries.
//   K6 probe_claim_kernel   one thread per received lane: the 4-slot
//                           bucket walk and claim of the visited-table
//                           slice (probe_claim), stamp and owner words
//                           as in fused_step.cu K2.
//      probe_commit_kernel  one thread per lane: inserted iff its slot
//                           was claimed in this call and it owns it:
//                           the LOWEST received lane of each fresh key.
//
// Rules the design takes:
//   * The pre-dedup is JAX's, lane for lane (same cells, same winner),
//     so the ring probe sees the same lanes and counts the same hits
//     (cch) as the plain version. The step-wide arena then drops what
//     JAX keeps: a key repeated across blocks, or two lanes of one key
//     whose cell a foreign key won. dvalid is therefore a subset of the
//     plain version's with the same key set and one lane per key.
//   * The arena is cleared (cudaMemsetAsync) before each step; owner
//     words carry the step tag in their high half, so older words are
//     larger and never need clearing (the rule of fused_step.cu).
//   * K6 reuses fused_step.cu's winner rule on the table slice, so the
//     owner's search record (which parent a child keeps) repeats run to
//     run; the stand-alone insert kernel there lets a racing lane win.
//
// What bounds it on this card: at 2pc n=7 and F = 12,288 rows (454,656
// lanes) the probe-free step writes ~7.3 MB of successors and ~3.6 MB
// of fingerprints and clears a 6.3 MB pre-dedup arena and an 8 MB key
// arena (all within the 50 MB L2): bytes bound it at a few
// microseconds. K6 on ~57k received lanes reads ~0.5 MB of lanes and
// one 32-byte bucket per lane: well under a microsecond of bytes; its
// launches and the random bucket reads rule. A first, simple cut: one
// thread per lane, global-memory atomics. Under symmetry only K1
// changes (its symmetric instantiation; fused_step.cu notes its bound).

#include "step_common.cuh"

// Mirrored by ops/_cuda.py DedupArgs.
struct DedupArgs {
  StepArgs s;                       // K1's arguments (no table: keys,
                                    // owner, stamp unused)
  uint32_t* pre_arena;              // [F*A/block_lanes * pre_cells]
  long long block_lanes;            // lanes of one pre-dedup block
  long long pre_cells;              // cells of one block's arena
  unsigned long long* arena;        // [cells] step-wide key arena
  unsigned long long* arena_owner;  // [cells] owner words
  long long cells;
};

// Mirrored by ops/_cuda.py ProbeArgs.
struct ProbeArgs {
  const uint32_t* hi;  // [n] received lanes
  const uint32_t* lo;
  const uint8_t* valid;
  long long n;
  unsigned long long* keys;  // [n_buckets * 4] this rank's table slice
  long long n_buckets;
  int max_rounds;
  uint32_t step;             // this call's tag (>= 1)
  unsigned long long* owner;  // [n_buckets * 4]
  uint32_t* stamp;            // [n_buckets * 4]
  int* lane_slot;             // [n] scratch
  uint8_t* inserted;          // [n]
  int* stats;                 // [2]: overflow, most rounds of one lane
  void* stream;
};

namespace {

__device__ __forceinline__ uint32_t key_hash(uint32_t hi, uint32_t lo) {
  return lo ^ (hi * kPhi);
}

__global__ void predup_kernel(DedupArgs d, long long n) {
  const StepArgs& a = d.s;
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l < n && a.cvalid[l]) {
    const long long b = l / d.block_lanes;
    const uint32_t local = (uint32_t)(l - b * d.block_lanes);
    const uint32_t c =
        key_hash(a.chi[l], a.clo[l]) & (uint32_t)(d.pre_cells - 1);
    atomicMin(&d.pre_arena[b * d.pre_cells + c], local);
  }
}

__global__ void dedup_claim_kernel(DedupArgs d, long long n) {
  const StepArgs& a = d.s;
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int cch = 0;
  if (l < n) {
    long long cell = -1;
    if (a.cvalid[l]) {
      const uint32_t hi = a.chi[l], lo = a.clo[l];
      const uint32_t h = key_hash(hi, lo);
      const long long b = l / d.block_lanes;
      const uint32_t local = (uint32_t)(l - b * d.block_lanes);
      const uint32_t w =
          d.pre_arena[b * d.pre_cells + (h & (uint32_t)(d.pre_cells - 1))];
      const long long wl = b * d.block_lanes + w;
      // JAX pre_dedup: a lane dies iff a lower lane of its block won its
      // cell with the same key
      if (w == local || a.chi[wl] != hi || a.clo[wl] != lo) {
        const unsigned long long key =
            ((unsigned long long)hi << 32) | lo;
        if (a.cc && a.ring[h & (uint32_t)(a.cc - 1)] == key) {
          cch = 1;  // committed in an earlier step: a duplicate
        } else {
          const unsigned long long mask =
              (unsigned long long)(d.cells - 1);
          unsigned long long g = (unsigned long long)h & mask;
          // at most half the cells are ever taken: this ends
          while (true) {
            const unsigned long long prev = atomicCAS(&d.arena[g], 0ull, key);
            if (prev == 0ull || prev == key) break;
            g = (g + 1) & mask;
          }
          atomicMin(&d.arena_owner[g],
                    ((unsigned long long)(~a.step) << 32) |
                        (unsigned long long)l);
          cell = (long long)g;
        }
      }
    }
    a.lane_slot[l] = (int)cell;
  }
  warp_add(&a.stats[S_CCH], cch);
}

__global__ void dedup_commit_kernel(DedupArgs d, long long n) {
  const StepArgs& a = d.s;
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l == 0) publish_discoveries(a);
  int dv = 0;
  if (l < n) {
    const int c = a.lane_slot[l];
    dv = c >= 0 && d.arena_owner[c] == (((unsigned long long)(~a.step)
                                         << 32) |
                                        (unsigned long long)l);
    a.dvalid[l] = (uint8_t)dv;
  }
  warp_add(&a.stats[S_DEDUP], dv);
  warp_add(&a.stats[S_INSERTED], dv);
}

__global__ void probe_claim_kernel(ProbeArgs a) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int rounds = 0;
  if (l < a.n) {
    int slot = -1;
    if (a.valid[l]) {
      long long s;
      const int st = probe_claim(a.keys, a.n_buckets, a.hi[l], a.lo[l],
                                 a.max_rounds, &s, &rounds);
      if (st == PROBE_OVF) {
        atomicOr(&a.stats[0], 1);
      } else {
        if (st == PROBE_CLAIMED) a.stamp[s] = a.step;
        atomicMin(&a.owner[s], ((unsigned long long)(~a.step) << 32) |
                                   (unsigned long long)l);
        slot = (int)s;
      }
    }
    a.lane_slot[l] = slot;
  }
  warp_max(&a.stats[1], rounds);
}

__global__ void probe_commit_kernel(ProbeArgs a) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l < a.n) {
    const int s = a.lane_slot[l];
    a.inserted[l] =
        (uint8_t)(s >= 0 && a.stamp[s] == a.step &&
                  a.owner[s] == (((unsigned long long)(~a.step) << 32) |
                                 (unsigned long long)l));
  }
}

template <class M, bool SYM>
int launch_dedup_step(const M& m, const DedupArgs& d) {
  const StepArgs& a = d.s;
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const long long lanes = (long long)a.F * a.A;
  cudaError_t e = cudaSuccess;
  if (lanes > 0) {
    e = cudaMemsetAsync(d.pre_arena, 0xFF,
                        (size_t)(lanes / d.block_lanes) * d.pre_cells *
                            sizeof(uint32_t),
                        st);
    if (e != cudaSuccess) return (int)e;
    e = cudaMemsetAsync(d.arena, 0,
                        (size_t)d.cells * sizeof(unsigned long long), st);
    if (e != cudaSuccess) return (int)e;
  }
  e = launch_expand<M, SYM>(m, a, st);
  if (e != cudaSuccess || lanes == 0) return (int)e;
  predup_kernel<<<blocks_for(lanes), kThreads, 0, st>>>(d, lanes);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dedup_claim_kernel<<<blocks_for(lanes), kThreads, 0, st>>>(d, lanes);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dedup_commit_kernel<<<blocks_for(lanes), kThreads, 0, st>>>(d, lanes);
  return (int)cudaGetLastError();
}

bool dedup_args_ok(const TwoPcModel& m, const DedupArgs& d) {
  const long long lanes = (long long)d.s.F * d.s.A;
  return d.s.A == m.max_actions() && d.block_lanes > 0 &&
         lanes % d.block_lanes == 0 && d.cells >= 2 * lanes &&
         (d.cells & (d.cells - 1)) == 0 &&
         (d.pre_cells & (d.pre_cells - 1)) == 0;
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

// The owner-side probe of the received lanes against this rank's slice.
int srt_probe_block(const ProbeArgs* args) {
  const ProbeArgs& a = *args;
  if (a.n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  probe_claim_kernel<<<blocks_for(a.n), kThreads, 0, st>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  probe_commit_kernel<<<blocks_for(a.n), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Bytes of the argument structs, checked by the Python binding.
int srt_dedup_args_size() { return (int)sizeof(DedupArgs); }
int srt_probe_args_size() { return (int)sizeof(ProbeArgs); }

}  // extern "C"
