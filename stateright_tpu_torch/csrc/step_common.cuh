// Device code shared by the step kernels of fused_step.cu and
// sharded_step.cu: the constants, the StepArgs layout, the fingerprint,
// the warp-aggregated counters, the 4-slot bucket probe/claim and K1,
// the expand kernel. Each .cu file includes it and is built on its own
// into its own library (ops/_cuda.py), so everything here has internal
// linkage.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "twopc.cuh"

namespace {

constexpr uint32_t kC1_1 = 0xCC9E2D51u;
constexpr uint32_t kC1_2 = 0x239B961Bu;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kSeed1 = 0x9747B28Cu;
constexpr uint32_t kSeed2 = 0x85EBCA6Bu;
constexpr uint32_t kPhi = 0x9E3779B9u;
constexpr int kBucket = 4;
constexpr int kThreads = 256;

// stats vector layout (ops/fused.py S_*)
enum Stat {
  S_XOVF = 0,
  S_OVF = 1,
  S_ROUNDS = 2,
  S_CCH = 3,
  S_VALID = 4,
  S_DEDUP = 5,
  S_INSERTED = 6,
  S_DISC = 7,
};

enum Probe { PROBE_DUP = 0, PROBE_CLAIMED = 1, PROBE_OVF = 2 };

}  // namespace

// Mirrored field for field by ops/_cuda.py StepArgs.
struct StepArgs {
  const uint32_t* frontier;  // [F, >=W] words, row stride fstride
  long long fstride;
  const uint32_t* ebits;     // [F], element stride estride
  long long estride;
  const uint32_t* phi;       // [F] cached frontier fingerprints
  const uint32_t* plo;
  long long pstride;
  const uint8_t* fvalid;     // [F]
  int F, A, P, pcols;
  uint32_t always_mask, sometimes_mask, ev_mask;
  uint32_t step;             // this step's tag (>= 1)
  uint8_t* pbits;            // [F, pcols]
  uint32_t* ebits_out;       // [F]
  uint8_t* terminal;         // [F]
  uint32_t* flat;            // [F*A, W]
  uint32_t* chi;             // [F*A]
  uint32_t* clo;
  uint8_t* cvalid;           // [F*A]
  uint8_t* dvalid;
  uint8_t* inserted;
  int* lane_slot;            // [F*A] scratch
  int* stats;                // [7 + 3P], zeroed by the caller
  unsigned long long* keys;  // [n_buckets * 4] visited table
  long long n_buckets;
  int max_rounds;
  int cc;                    // ring slots (0 = no ring)
  unsigned long long* owner;       // [n_buckets * 4]
  uint32_t* stamp;                 // [n_buckets * 4]
  unsigned long long* ring;        // [cc]
  unsigned long long* ring_arena;  // [cc]
  unsigned long long* disc_cand;   // [P]
  void* stream;
};

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The fingerprint of stateright_tpu_torch/fingerprint.py fp64_words.
template <int W>
__device__ __forceinline__ void fp64(const uint32_t (&w)[W], uint32_t& hi,
                                     uint32_t& lo) {
  uint32_t h1 = 0, h2 = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t x = w[i] ^ fmix32((uint32_t)(i + 1) * kGolden);
    h1 ^= fmix32(x * kC1_1);
    h2 ^= fmix32(x * kC1_2);
  }
  h1 = fmix32(h1 ^ kSeed1 ^ (uint32_t)W);
  h2 = fmix32(h2 ^ kSeed2 ^ ((uint32_t)W * kC1_1));
  if (h1 == 0u && h2 == 0u) h2 = 1u;
  hi = h1;
  lo = h2;
}

// Every lane of the warp must call these (no early returns before them).
__device__ __forceinline__ void warp_add(int* dst, int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(dst, v);
}

__device__ __forceinline__ void warp_max(int* dst, int v) {
  const unsigned m = __reduce_max_sync(0xFFFFFFFFu, (unsigned)v);
  if ((threadIdx.x & 31) == 0 && m) atomicMax(dst, (int)m);
}

// Probe the 4-slot buckets for key from its start bucket; claim the first
// empty slot of the first bucket without a match and with room. Returns
// the outcome, the slot the key ends in and the rounds (bucket reads).
__device__ int probe_claim(unsigned long long* keys, long long n_buckets,
                           uint32_t hi, uint32_t lo, int max_rounds,
                           long long* slot_out, int* rounds_out) {
  const unsigned long long key = ((unsigned long long)hi << 32) | lo;
  const unsigned long long mask = (unsigned long long)(n_buckets - 1);
  unsigned long long g = (unsigned long long)(lo ^ (hi * kPhi)) & mask;
  int rounds = 0;
  while (rounds < max_rounds) {
    ++rounds;
    // volatile: a slot another lane claimed must be seen on re-read
    const volatile unsigned long long* b =
        keys + (long long)g * kBucket;
    int first_empty = kBucket;
#pragma unroll
    for (int j = 0; j < kBucket; ++j) {
      const unsigned long long v = b[j];
      if (v == key) {
        *slot_out = (long long)g * kBucket + j;
        *rounds_out = rounds;
        return PROBE_DUP;
      }
      if (v == 0ull && first_empty == kBucket) first_empty = j;
    }
    if (first_empty == kBucket) {  // full of foreign keys: next bucket
      g = (g + 1) & mask;
      continue;
    }
    const long long s = (long long)g * kBucket + first_empty;
    const unsigned long long prev = atomicCAS(keys + s, 0ull, key);
    if (prev == 0ull || prev == key) {
      *slot_out = s;
      *rounds_out = rounds;
      return prev == 0ull ? PROBE_CLAIMED : PROBE_DUP;
    }
    // another key took the slot: read this bucket again
  }
  *rounds_out = rounds;
  return PROBE_OVF;
}

template <class M>
__global__ void expand_kernel(M m, StepArgs a) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  for (long long i = tid; i < a.cc; i += nthreads) a.ring_arena[i] = ~0ull;
  int nvalid = 0;
  if (tid < a.F) {
    const int r = (int)tid;
    uint32_t w[M::W];
#pragma unroll
    for (int i = 0; i < M::W; ++i) w[i] = a.frontier[r * a.fstride + i];
    const bool fv = a.fvalid[r] != 0;
    const uint32_t pb = m.props(w);
    for (int p = 0; p < a.pcols; ++p)
      a.pbits[(long long)r * a.pcols + p] =
          p < a.P ? (uint8_t)((pb >> p) & 1u) : (uint8_t)0;
    const uint32_t eb = a.ebits[r * a.estride] & ~(pb & a.ev_mask);
    a.ebits_out[r] = eb;
    bool xovf = false;
    for (int act = 0; act < a.A; ++act) {
      uint32_t s[M::W];
      bool ovf = false;
      const bool v = m.step(w, act, s, ovf);
      const long long lane = (long long)r * a.A + act;
      if constexpr (M::W == 4) {
        reinterpret_cast<uint4*>(a.flat)[lane] =
            make_uint4(s[0], s[1], s[2], s[3]);
      } else {
#pragma unroll
        for (int i = 0; i < M::W; ++i) a.flat[lane * M::W + i] = s[i];
      }
      uint32_t hi, lo;
      fp64<M::W>(s, hi, lo);
      a.chi[lane] = hi;
      a.clo[lane] = lo;
      const bool cv = v && fv;
      a.cvalid[lane] = cv;
      nvalid += cv;
      xovf |= ovf && fv;
    }
    const bool term = fv && nvalid == 0;
    a.terminal[r] = term;
    if (xovf) atomicOr(&a.stats[S_XOVF], 1);
    uint32_t hits = 0;
    if (fv) hits |= (~pb & a.always_mask) | (pb & a.sometimes_mask);
    if (term && eb != 0u) hits |= eb & a.ev_mask;
    const unsigned long long tag = (unsigned long long)(~a.step) << 32;
    while (hits) {
      const int p = __ffs(hits) - 1;
      hits &= hits - 1;
      atomicMin(&a.disc_cand[p], tag | (unsigned long long)r);
    }
  }
  warp_add(&a.stats[S_VALID], nvalid);
}

inline int blocks_for(long long n) {
  return (int)((n + kThreads - 1) / kThreads);
}

// Publish this step's discovery registers from the candidates K1 left
// in disc_cand (one thread calls it, after K1 has finished).
__device__ __forceinline__ void publish_discoveries(const StepArgs& a) {
  const unsigned long long tag = (unsigned long long)(~a.step) << 32;
  for (int p = 0; p < a.P; ++p) {
    const unsigned long long v = a.disc_cand[p];
    const bool hit = (v & 0xFFFFFFFF00000000ull) == tag;
    const long long row = (long long)(v & 0xFFFFFFFFull);
    a.stats[S_DISC + p] = hit ? 1 : 0;
    a.stats[S_DISC + a.P + p] = hit ? (int)a.phi[row * a.pstride] : 0;
    a.stats[S_DISC + 2 * a.P + p] = hit ? (int)a.plo[row * a.pstride] : 0;
  }
}

}  // namespace
