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
//   K1 expand_kernel   one thread per frontier row: property bits, the
//                      eventually-bit clear, terminal, the A successors
//                      (flat), their fingerprints and validity, and the
//                      discovery candidates (atomicMin of the row per
//                      property: the lowest row wins, which is the
//                      Pallas rule "first block with a hit, first row
//                      in it").
//   K2 claim_kernel    one thread per lane: probe the cross-chunk ring
//                      as it stood when the step began (a hit kills the
//                      lane), then walk the 4-slot buckets of the visited
//                      table and claim the first empty slot with a
//                      64-bit atomicCAS.
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
//     LOWEST valid lane carrying it. Every lane whose probe ends at slot
//     s atomicMin's ((~step) << 32 | lane) into owner[s]; the lane whose
//     CAS claimed s writes stamp[s] = step. After K2, lane l is inserted
//     iff stamp[slot(l)] == step and owner[slot(l)] holds its own word.
//     The step tag in the high half makes older owner words larger, so
//     owner and stamp never need clearing between steps.
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
// an H100 SXM. At the thin-frontier step (256 rows, 9,472 lanes) the
// bound is ~0.1 us and latency rules: K1's one block of row threads,
// each walking the actions one after another, plus three launches. The
// design keeps each lane's successor, fingerprint and probe in
// registers within a kernel, writes each output once, and uses
// warp-aggregated atomics for the step counters so 454k lanes do not
// serialise on one address. It is a first, simple cut: K1's serial
// action loop is the first thing to parallelise (PERF.md). Under
// symmetry at 2pc n=16 (82 actions, 1,007,616 lanes at F = 12,288) K1
// also writes ~8 MB of original fingerprints and does ~500 integer
// operations per lane (the counting sort over 16 RMs and a second
// fingerprint): bytes still bound the step at ~14 us, and the serial
// row loop, 82 lanes per thread in only 48 blocks, is what it spends.

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

__global__ void claim_kernel(StepArgs a, long long n) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int cch = 0, dv = 0, rounds = 0;
  if (l < n) {
    int slot = -1;
    if (a.cvalid[l]) {
      const uint32_t hi = a.chi[l], lo = a.clo[l];
      const unsigned long long key = ((unsigned long long)hi << 32) | lo;
      const uint32_t rs =
          a.cc ? ((lo ^ (hi * kPhi)) & (uint32_t)(a.cc - 1)) : 0u;
      if (a.cc && a.ring[rs] == key) {
        cch = 1;  // committed in an earlier step: a duplicate
      } else {
        dv = 1;
        long long s;
        const int st = probe_claim(a.keys, a.n_buckets, hi, lo,
                                   a.max_rounds, &s, &rounds);
        if (st == PROBE_OVF) {
          atomicOr(&a.stats[S_OVF], 1);
        } else {
          if (st == PROBE_CLAIMED) {
            a.stamp[s] = a.step;
            if (a.cc) atomicMin(&a.ring_arena[rs], key);
          }
          const unsigned long long tag =
              (unsigned long long)(~a.step) << 32;
          atomicMin(&a.owner[s], tag | (unsigned long long)l);
          slot = (int)s;
        }
      }
    }
    a.dvalid[l] = (uint8_t)dv;
    a.lane_slot[l] = slot;
  }
  warp_add(&a.stats[S_CCH], cch);
  warp_add(&a.stats[S_DEDUP], dv);
  warp_max(&a.stats[S_ROUNDS], rounds);
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

template <class M, bool SYM>
int launch_step(const M& m, const StepArgs& a) {
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const long long lanes = (long long)a.F * a.A;
  expand_kernel<M, SYM>
      <<<blocks_for(a.F > 0 ? a.F : 1), kThreads, 0, st>>>(m, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (lanes == 0) return 0;
  claim_kernel<<<blocks_for(lanes), kThreads, 0, st>>>(a, lanes);
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
