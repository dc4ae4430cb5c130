// Device code shared by the step kernels of fused_step.cu and
// sharded_step.cu (and the chunk kernels of chunk.cu): the constants, the
// StepArgs layout with the tile geometry of K1, K2 and K5 and the chunk's
// gate, the fingerprint, the warp- and
// block-aggregated counters and lists, the 4-slot bucket probe/claim,
// K1, the expand kernel (with a compile-time symmetry flag: the
// symmetric instantiation keys each child on the fingerprint of its
// canonical representative and writes the child's own fingerprint beside
// it), the tile stage of K2 and K5 (the tile's lowest valid lane of
// each key), and the flat insert (K4 in fused_step.cu, K6 in
// sharded_step.cu). Each .cu file includes it and is built on its own
// into its own library (ops/_cuda.py), so everything here has internal
// linkage.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr uint32_t kC1_1 = 0xCC9E2D51u;
constexpr uint32_t kC1_2 = 0x239B961Bu;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kSeed1 = 0x9747B28Cu;
constexpr uint32_t kSeed2 = 0x85EBCA6Bu;
constexpr uint32_t kPhi = 0x9E3779B9u;
constexpr int kBucket = 4;
// threads per block of the flat insert (one lane per thread)
constexpr int kThreads = 256;
// threads per block of the commit kernels (K3, K5's commit), which walk
// one tile's claims: ~10-30 per tile on a large step of 2pc n=7 or n=16
constexpr int kCommitThreads = 64;

// stats vector layout (ops/fused.py S_*)
enum Stat {
  S_XOVF = 0,
  S_OVF = 1,
  S_ROUNDS = 2,
  S_CCH = 3,
  S_VALID = 4,
  S_DEDUP = 5,
  S_INSERTED = 6,
  S_FAULT = 7,  // a commit kernel found a claim whose owner word is not
                // this step's: a kernel fault, raised by the host loop
  S_DISC = 8,
};

enum Probe { PROBE_DUP = 0, PROBE_CLAIMED = 1, PROBE_OVF = 2 };

// The chunk's gate (chunk.cu eval_gate writes it before each iteration:
// chunk_begin_kernel for a chunk's first, K7's tail for every next one;
// checker/device_loop.py G_* mirror it): which step size runs (0: none,
// 1: the small one, 2: the large one), the queue head, the rows pending
// (at most the size's), the step's owner-word tag, and the queue tail and
// log length the append writes at.
enum Gate {
  G_SIZE = 0,
  G_HEAD = 1,
  G_TAKE = 2,
  G_TAG = 3,
  G_QBASE = 4,
  G_LBASE = 5,
  G_LEN = 6,
};

}  // namespace

// The launch geometry of a kernel that works on block tiles of whole
// frontier rows (K1, K2, K3, K5), computed by ops/_cuda.py
// tile_geometry and mirrored there field for field: block b takes rows
// [b * rows, min(F, (b + 1) * rows)), lane t of its tile is row t / A,
// action t % A, and its threads walk the tile's lanes t, t + threads,
// ... (K3 and K5's commit: the tile's claims, with kCommitThreads)
struct TileGeometry {
  int rows;     // frontier rows per block
  int threads;  // threads per block (a multiple of 32)
  int blocks;   // blocks of the launch (>= 1, blocks * rows >= F)
  int cells;    // the tile stage's shared dedup cells per block (a
                // power of two >= 2 * rows * A); K1: unused
};

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
  uint32_t* chi;             // [F*A] dedup keys (canonical under symmetry)
  uint32_t* clo;
  uint32_t* ohi;             // [F*A] the children's own fingerprints
  uint32_t* olo;             //       (written by the symmetric step only)
  uint8_t* cvalid;           // [F*A]
  uint8_t* dvalid;
  uint8_t* inserted;
  // [F*A] per tile, in its own lane range, n_claims[tile] entries: the
  // table slots its lanes claimed with their keys' ring slots (K2:
  // ring slot << 32 | table slot) or the arena cells they claimed (K5)
  unsigned long long* claims;
  int* n_claims;             // [tile.blocks]
  int* stats;                // [8 + 3P], zeroed by the caller
  unsigned long long* keys;  // [n_buckets * 4] visited table
  long long n_buckets;
  int max_rounds;
  int cc;                    // ring slots (0 = no ring)
  unsigned long long* owner;       // [n_buckets * 4]
  unsigned long long* ring;        // [cc]
  unsigned long long* ring_arena;  // [cc]
  unsigned long long* disc_cand;   // [P]
  TileGeometry tile;               // the launch of K1, K2, K3 and K5
  // Inside a chunk on the card (chunk.cu), K1-K3 are launched for both
  // step sizes in every iteration and read their window from the
  // device: a launch runs only when gate[G_SIZE] == gate_size, over the
  // frontier rows from gate[G_HEAD] (frontier, ebits, phi and plo point
  // at queue row 0), gate[G_TAKE] of them valid (fvalid unused), under
  // the tag gate[G_TAG] (step unused). Null: the host arguments.
  const int* gate;
  int gate_size;
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

// The fingerprint of stateright_tpu_torch/fingerprint.py fp64_words
// over the first width words of w (width <= W; a runtime width is
// walked by an unrolled, guarded loop, so w stays in registers): each
// word mixed with its column key, the width mixed into the seeds.
template <int W>
__device__ __forceinline__ void fp64(const uint32_t (&w)[W], int width,
                                     uint32_t& hi, uint32_t& lo) {
  uint32_t h1 = 0, h2 = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (i < width) {
      const uint32_t x = w[i] ^ fmix32((uint32_t)(i + 1) * kGolden);
      h1 ^= fmix32(x * kC1_1);
      h2 ^= fmix32(x * kC1_2);
    }
  }
  h1 = fmix32(h1 ^ kSeed1 ^ (uint32_t)width);
  h2 = fmix32(h2 ^ kSeed2 ^ ((uint32_t)width * kC1_1));
  if (h1 == 0u && h2 == 0u) h2 = 1u;
  hi = h1;
  lo = h2;
}

// A wide model's child row (kWideRow below): put(i, v) stores word i at
// dst[i] and folds it into the fingerprint as fp64 does, so the child is
// never held whole; finish() gives fp64 of the width words put.
struct RowOut {
  uint32_t* dst;
  uint32_t h1 = 0u, h2 = 0u;

  __device__ explicit RowOut(uint32_t* d) : dst(d) {}

  __device__ __forceinline__ void put(int i, uint32_t v) {
    dst[i] = v;
    const uint32_t x = v ^ fmix32((uint32_t)(i + 1) * kGolden);
    h1 ^= fmix32(x * kC1_1);
    h2 ^= fmix32(x * kC1_2);
  }

  __device__ __forceinline__ void finish(int width, uint32_t& hi,
                                         uint32_t& lo) const {
    uint32_t a = fmix32(h1 ^ kSeed1 ^ (uint32_t)width);
    uint32_t b = fmix32(h2 ^ kSeed2 ^ ((uint32_t)width * kC1_1));
    if (a == 0u && b == 0u) b = 1u;
    hi = a;
    lo = b;
  }
};

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

// Append v to list[] where take, warp-aggregated: one shared or global
// atomicAdd on *count per warp. Every lane of the warp must call it.
template <class T>
__device__ __forceinline__ void warp_append(T* list, int* count, bool take,
                                            T v) {
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, take);
  const int wl = threadIdx.x & 31;
  int at = 0;
  if (wl == 0 && ballot) at = atomicAdd(count, __popc(ballot));
  at = __shfl_sync(0xFFFFFFFFu, at, 0);
  if (take) list[at + __popc(ballot & ((1u << wl) - 1u))] = v;
}

// Add v over the block into *dst with one global atomic per block. acc
// is a __shared__ int the block zeroed before a __syncthreads; every
// thread of the block must call this (it holds a barrier).
__device__ __forceinline__ void block_add(int* dst, int v, int* acc) {
  warp_add(acc, v);
  __syncthreads();
  if (threadIdx.x == 0 && *acc) atomicAdd(dst, *acc);
}

// One 4-slot bucket as two 16-byte loads that bypass L1 (ld.global.cg:
// other blocks claim slots during the kernel, and the atomics that do it
// live in L2). volatile, so a re-read after a lost CAS is not merged
// with the first read.
__device__ __forceinline__ void load_bucket(const unsigned long long* b,
                                            unsigned long long (&v)[4]) {
  asm volatile("ld.global.cg.v2.u64 {%0, %1}, [%2];"
               : "=l"(v[0]), "=l"(v[1])
               : "l"(b)
               : "memory");
  asm volatile("ld.global.cg.v2.u64 {%0, %1}, [%2+16];"
               : "=l"(v[2]), "=l"(v[3])
               : "l"(b)
               : "memory");
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
    unsigned long long v[kBucket];
    load_bucket(keys + (long long)g * kBucket, v);
    int first_empty = kBucket;
#pragma unroll
    for (int j = 0; j < kBucket; ++j) {
      if (v[j] == key) {
        *slot_out = (long long)g * kBucket + j;
        *rounds_out = rounds;
        return PROBE_DUP;
      }
      if (v[j] == 0ull && first_empty == kBucket) first_empty = j;
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

// The chunk's gate (StepArgs.gate) for one launch of K1-K3: false when
// the iteration picked no step or the other step size (every block
// returns at once: the value is the same for every thread); otherwise the
// frontier window moves to the queue head, a.step takes the iteration's
// tag, and *take (when not null) the rows pending. Without a gate: true,
// *take = -1 (fvalid holds the rows).
__device__ __forceinline__ bool open_gate(StepArgs& a, int* take) {
  if (a.gate == nullptr) {
    if (take) *take = -1;
    return true;
  }
  if (a.gate[G_SIZE] != a.gate_size) return false;
  const long long h = a.gate[G_HEAD];
  a.frontier += h * a.fstride;
  a.ebits += h * a.estride;
  a.phi += h * a.pstride;
  a.plo += h * a.pstride;
  a.step = (uint32_t)a.gate[G_TAG];
  if (take) *take = a.gate[G_TAKE];
  return true;
}

struct NoCanon {};

// Whether M is a wide model (M::kWideRow): its row is too wide for K1's
// per-lane register arrays (Paxos: 96 words), so K1 loads the tile's
// rows into shared memory cooperatively and calls m.props_row(row) and
// m.step_row(row, act, out, ovf) on the shared copy, the child going
// straight to its flat row through a RowOut. Models without the member
// (every other) compile to K1 as it was.
template <class M, class = void>
struct WideRow : std::false_type {};
template <class M>
struct WideRow<M, std::void_t<decltype(M::kWideRow)>>
    : std::integral_constant<bool, M::kWideRow> {};

// The row's representative state of a model under SYM (M::RowCanon),
// else nothing: models without symmetry define no RowCanon.
template <class M, bool SYM>
struct CanonOf {
  using type = NoCanon;
};
template <class M>
struct CanonOf<M, true> {
  using type = typename M::RowCanon;
};

// K1's per-row state in shared memory, written once per row (16-byte
// aligned, so a lane reads its row's words as one vector load; a wide
// model's lanes read the words they need from it).
template <class M, bool SYM>
struct alignas(16) RowState {
  uint32_t w[M::W];  // the frontier row (its first m.width() words)
  uint32_t pb;       // property bits m.props(w)
  uint32_t eb;       // eventually-bits after the clear
  uint8_t fv;        // fvalid
  uint8_t valid;     // some lane of the row is a valid child
  uint8_t xovf;      // some lane of a valid row overflowed its encoding
  // SYM: the row's representative, carried to each child (canon_child)
  typename CanonOf<M, SYM>::type rc;
};

// The model interface K1 takes (csrc/twopc.cuh, lineq.cuh,
// increment.cuh, increment_lock.cuh; the wide paxos.cuh: see WideRow):
// M::W, the words of a row array;
// m.width(), the words of the state (at most W: a runtime width, n + 1
// or n + 2 for the increment models, is walked by unrolled loops
// guarded by it, so the row arrays stay in registers); m.step(w, act,
// s, ovf), the successor of row w under action lane act and whether it
// is enabled; m.props(w), the property bits; under SYM M::RowCanon,
// m.row_canon(w, rc) once per row and m.canon_child(rc, w, act, s, c),
// the representative of the child s.
//
// K1. One thread per lane over block tiles of whole rows (a.tile):
// one thread per row loads the row, its fvalid and ebits and evaluates
// the properties (under SYM also the row's representative, m.row_canon)
// into shared memory; then each lane (row t / A, action
// t % A of the tile, so the lanes of a warp are consecutive) computes
// its successor, fingerprint(s) and validity and writes them coalesced;
// then one thread per row writes pbits, ebits_out and terminal (a
// per-row OR of the lanes' validity) and posts the row's discovery
// candidates (atomicMin: the lowest row wins). SYM = false: chi/clo =
// fp64(child), ohi/olo untouched. SYM = true: chi/clo =
// fp64(canon(child)) (m.canon_child from the row's representative), the
// key every later kernel dedups on, and
// ohi/olo = fp64(child), the original state's fingerprint the log keeps;
// flat stays the original child and the properties are evaluated on the
// original frontier rows either way. The grid also resets the ring
// arena for the step (grid-stride). Inside a chunk the launch is gated
// (open_gate): its rows are the queue's from the head, the first take of
// them valid.
template <class M, bool SYM>
__global__ void expand_kernel(M m, StepArgs a) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  RowState<M, SYM>* rows = reinterpret_cast<RowState<M, SYM>*>(tile_smem);
  __shared__ int s_valid;
  int take;
  if (!open_gate(a, &take)) return;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  for (long long i = tid; i < a.cc; i += nthreads) a.ring_arena[i] = ~0ull;
  const int A = a.A;
  const int width = m.width();
  const long long row0 = (long long)blockIdx.x * a.tile.rows;
  const int nrows =
      (int)max(0ll, min((long long)a.tile.rows, (long long)a.F - row0));
  if (threadIdx.x == 0) s_valid = 0;
  if constexpr (WideRow<M>::value) {
    static_assert(!SYM, "a wide model has no symmetric K1");
    // the tile's rows, neighbouring threads on neighbouring words
    for (int k = threadIdx.x; k < nrows * width; k += blockDim.x) {
      const int i = k / width, c = k - i * width;
      rows[i].w[c] = a.frontier[(row0 + i) * a.fstride + c];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
      const long long r = row0 + i;
      RowState<M, SYM>& rs = rows[i];
      const uint32_t pb = m.props_row(rs.w);
      rs.pb = pb;
      rs.eb = a.ebits[r * a.estride] & ~(pb & a.ev_mask);
      rs.fv = take >= 0 ? r < take : a.fvalid[r] != 0;
      rs.valid = 0;
      rs.xovf = 0;
    }
  } else {
    for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
      const long long r = row0 + i;
      RowState<M, SYM>& rs = rows[i];
      uint32_t w[M::W];
#pragma unroll
      for (int k = 0; k < M::W; ++k)
        w[k] = rs.w[k] = k < width ? a.frontier[r * a.fstride + k] : 0u;
      const uint32_t pb = m.props(w);
      if constexpr (SYM) m.row_canon(w, rs.rc);
      rs.pb = pb;
      rs.eb = a.ebits[r * a.estride] & ~(pb & a.ev_mask);
      rs.fv = take >= 0 ? r < take : a.fvalid[r] != 0;
      rs.valid = 0;
      rs.xovf = 0;
    }
  }
  __syncthreads();
  int nvalid = 0;
  const int tile = nrows * A;
  const long long lane0 = row0 * A;
  // lane t = row * A + act, walked in strides of blockDim.x
  const int drow = blockDim.x / A, dact = blockDim.x - drow * A;
  int row = threadIdx.x / A, act = threadIdx.x - row * A;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    RowState<M, SYM>& rs = rows[row];
    const long long lane = lane0 + t;
    bool ovf = false, v;
    uint32_t hi, lo;
    if constexpr (WideRow<M>::value) {
      RowOut out(a.flat + lane * width);
      v = m.step_row(rs.w, act, out, ovf);
      out.finish(width, hi, lo);
    } else {
      uint32_t w[M::W], s[M::W];
#pragma unroll
      for (int k = 0; k < M::W; ++k) w[k] = rs.w[k];
      v = m.step(w, act, s, ovf);
      if constexpr (M::W == 4) {  // 2pc: one 16-byte store
        reinterpret_cast<uint4*>(a.flat)[lane] =
            make_uint4(s[0], s[1], s[2], s[3]);
      } else {
#pragma unroll
        for (int k = 0; k < M::W; ++k)
          if (k < width) a.flat[lane * width + k] = s[k];
      }
      if constexpr (SYM) {
        uint32_t c[M::W];
        m.canon_child(rs.rc, w, act, s, c);
        fp64(c, width, hi, lo);
        uint32_t ohi, olo;
        fp64(s, width, ohi, olo);
        a.ohi[lane] = ohi;
        a.olo[lane] = olo;
      } else {
        fp64(s, width, hi, lo);
      }
    }
    a.chi[lane] = hi;
    a.clo[lane] = lo;
    const bool cv = v && rs.fv;
    a.cvalid[lane] = cv;
    nvalid += cv;
    // plain stores of one value: the row's OR, read after the barrier
    if (cv) rs.valid = 1;
    if (ovf && rs.fv) rs.xovf = 1;
    row += drow;
    act += dact;
    if (act >= A) {
      act -= A;
      ++row;
    }
  }
  __syncthreads();
  const unsigned long long tag = (unsigned long long)(~a.step) << 32;
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
    const RowState<M, SYM>& rs = rows[i];
    const long long r = row0 + i;
    const uint32_t pb = rs.pb, eb = rs.eb;
    for (int p = 0; p < a.pcols; ++p)
      a.pbits[r * a.pcols + p] =
          p < a.P ? (uint8_t)((pb >> p) & 1u) : (uint8_t)0;
    a.ebits_out[r] = eb;
    const bool term = rs.fv && !rs.valid;
    a.terminal[r] = term;
    if (rs.xovf) atomicOr(&a.stats[S_XOVF], 1);
    uint32_t hits = 0;
    if (rs.fv) hits |= (~pb & a.always_mask) | (pb & a.sometimes_mask);
    if (term && eb != 0u) hits |= eb & a.ev_mask;
    while (hits) {
      const int p = __ffs(hits) - 1;
      hits &= hits - 1;
      atomicMin(&a.disc_cand[p], tag | (unsigned long long)r);
    }
  }
  block_add(&a.stats[S_VALID], nvalid, &s_valid);
}

// Whether g can launch a kernel over tiles of F rows of A lanes.
inline bool geometry_ok(const TileGeometry& g, int F, int A) {
  return g.rows >= 1 && g.threads >= 32 && g.threads <= 1024 &&
         g.threads % 32 == 0 && g.blocks >= 1 &&
         (long long)g.blocks * g.rows >= F &&
         (long long)(g.blocks - 1) * g.rows < (F > 0 ? F : 1) && A >= 1;
}

// Allow a kernel smem bytes of dynamic shared memory (above the 48 KB
// every kernel may take, up to the 227 KB of a Hopper block).
template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Launch K1 over a.tile (blocks >= 1 even at F = 0: the grid resets
// the ring arena).
template <class M, bool SYM>
cudaError_t launch_expand(const M& m, const StepArgs& a, cudaStream_t st) {
  const TileGeometry& g = a.tile;
  if (!geometry_ok(g, a.F, a.A)) return cudaErrorInvalidValue;
  const size_t smem = (size_t)g.rows * sizeof(RowState<M, SYM>);
  cudaError_t e = allow_smem(expand_kernel<M, SYM>, smem);
  if (e != cudaSuccess) return e;
  expand_kernel<M, SYM><<<g.blocks, g.threads, smem, st>>>(m, a);
  return cudaGetLastError();
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

// The tile of block blockIdx.x of a launch over a.tile: its first lane
// and its lanes.
struct Tile {
  long long lane0;
  int n;
};

__device__ __forceinline__ Tile tile_of(const StepArgs& a) {
  const long long row0 = (long long)blockIdx.x * a.tile.rows;
  const int nrows = (int)max(0ll, min((long long)a.tile.rows,
                                      (long long)a.F - row0));
  return {row0 * a.A, nrows * a.A};
}

// The tile stage's dynamic shared memory: per cell a key and a lane, per
// tile lane its cell and a slot of the winner list.
struct TileSmem {
  unsigned long long* key;  // [cells]
  uint32_t* lane;           // [cells] the lowest tile lane of the key
  uint32_t* cell;           // [rows * A] tile lane -> cell (~0u: invalid)
  uint32_t* win;            // [rows * A] the tile's winners (tile lanes)
};

inline size_t tile_stage_smem_bytes(const TileGeometry& g, int A) {
  return (size_t)g.cells * (sizeof(unsigned long long) + sizeof(uint32_t)) +
         (size_t)g.rows * A * 2 * sizeof(uint32_t);
}

__device__ __forceinline__ TileSmem tile_stage_smem(unsigned char* smem,
                                                    const TileGeometry& g,
                                                    int A) {
  TileSmem s;
  s.key = reinterpret_cast<unsigned long long*>(smem);
  s.lane = reinterpret_cast<uint32_t*>(s.key + g.cells);
  s.cell = s.lane + g.cells;
  s.win = s.cell + g.rows * A;
  return s;
}

// Whether g can launch the tile stage over F rows of A lanes.
inline bool tile_stage_ok(const TileGeometry& g, int F, int A) {
  return geometry_ok(g, F, A) && g.cells >= 2 * g.rows * A &&
         (g.cells & (g.cells - 1)) == 0;
}

// The tile stage of K2 and K5 over tile t, in two phases:
//   1. every valid lane enters (key, its tile lane) into an
//      open-addressed table of a.tile.cells shared cells (64-bit CAS on
//      the key, atomicMin on the lane), so each cell ends holding the
//      tile's LOWEST valid lane of its key;
//   2. those tile winners go to the shared list s.win (warp-aggregated);
//      every lane l of the tile gets zero_all[l] = 0, and every lane that
//      is not a winner zero_losers[l] = 0 (where not null).
// Returns the number of winners: s.win[i] is a tile lane, and
// s.key[s.cell[s.win[i]]] its key. Every thread of the block must call
// it (it holds barriers, the first of which publishes what thread 0 set
// before the call).
__device__ __forceinline__ int tile_stage(const StepArgs& a, TileSmem s,
                                          Tile t, int* s_nwin,
                                          uint8_t* zero_all,
                                          uint8_t* zero_losers) {
  const uint32_t cmask = (uint32_t)a.tile.cells - 1u;
  if (threadIdx.x == 0) *s_nwin = 0;
  for (int c = threadIdx.x; c < a.tile.cells; c += blockDim.x) {
    s.key[c] = 0ull;
    s.lane[c] = ~0u;
  }
  __syncthreads();
  // 1. at most half the cells are ever taken: each walk ends
  for (int i = threadIdx.x; i < t.n; i += blockDim.x) {
    const long long l = t.lane0 + i;
    uint32_t cell = ~0u;
    if (a.cvalid[l]) {
      const uint32_t hi = a.chi[l], lo = a.clo[l];
      const unsigned long long key = ((unsigned long long)hi << 32) | lo;
      uint32_t c = (lo ^ (hi * kPhi)) & cmask;
      while (true) {
        const unsigned long long prev = atomicCAS(&s.key[c], 0ull, key);
        if (prev == 0ull || prev == key) break;
        c = (c + 1) & cmask;
      }
      atomicMin(&s.lane[c], (uint32_t)i);
      cell = c;
    }
    s.cell[i] = cell;
  }
  __syncthreads();
  // 2. uniform trip count: the ballot needs the whole warp
  for (int base = 0; base < t.n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    bool win = false;
    if (i < t.n) {
      const uint32_t c = s.cell[i];
      win = c != ~0u && s.lane[c] == (uint32_t)i;
      zero_all[t.lane0 + i] = 0;
      if (!win && zero_losers) zero_losers[t.lane0 + i] = 0;
    }
    warp_append(s.win, s_nwin, win, (uint32_t)i);
  }
  __syncthreads();
  return *s_nwin;
}

// The commit kernels' walk (K3, K5's commit; one block per tile, any
// thread count): call fn(claim) for each of the tile's n_claims claims,
// and return their count. A thread reads its first entry of the tile's
// claims list together with the count (the list spans the tile's lanes,
// so the read stays in bounds when the tile has fewer claims), and the
// next one before it works on the current one.
template <class Fn>
__device__ __forceinline__ int claims_walk(const StepArgs& a, Fn fn) {
  const Tile t = tile_of(a);
  const unsigned long long* list = a.claims + t.lane0;
  unsigned long long next = threadIdx.x < t.n ? list[threadIdx.x] : 0ull;
  const int n = a.n_claims[blockIdx.x];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned long long claim = next;
    if (i + (int)blockDim.x < n) next = list[i + blockDim.x];
    fn(claim);
  }
  return n;
}

// The owner word's lane when it carries this step's tag (and names a lane
// of the step), else -1: a kernel fault the caller must flag.
__device__ __forceinline__ long long owner_lane(unsigned long long word,
                                                uint32_t step,
                                                long long lanes) {
  const unsigned long long tag = (unsigned long long)(~step) << 32;
  const long long lane = (long long)(word & 0xFFFFFFFFull);
  return (word & 0xFFFFFFFF00000000ull) == tag && lane < lanes ? lane : -1;
}

// The flat insert (K4, K6): insert the a.F lanes (key chi << 32 | clo,
// where cvalid) into the table a.keys, and with a mask (MASK; a.inserted)
// mark the LOWEST valid lane of each fresh key, by the owner-word rule of
// K2/K3. One thread per lane, from lane0: it loads the lane's key with
// its validity (one memory latency), then walks and claims its bucket
// (probe_claim). With a mask every lane gets inserted = 0, every valid
// lane atomicMin's (~step) << 32 | lane into owner[s] of the slot s its
// probe ends at, a claimer or not, and the claimer keeps s in a register;
// after the grid's barrier (one cooperative launch) the claimer reads
// owner[s], whose lane it marks: the lowest valid lane of the key, though
// the claimer may be any lane that raced in first. An owner word without
// this call's tag is a kernel fault (S_FAULT). Without a mask there are
// no owner words, no barrier and no commit: one pass of claims, launched
// plainly. Overflow goes to S_OVF, the most rounds of one lane to
// S_ROUNDS.
template <bool MASK>
__global__ void __launch_bounds__(kThreads)
    flat_insert_kernel(StepArgs a, long long lane0) {
  const long long l =
      lane0 + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long claimed = -1;
  int rounds = 0;
  if (l < a.F) {
    const bool valid = a.cvalid[l];
    const uint32_t hi = a.chi[l], lo = a.clo[l];
    if (MASK) a.inserted[l] = 0;
    if (valid) {
      long long s;
      const int st = probe_claim(a.keys, a.n_buckets, hi, lo, a.max_rounds,
                                 &s, &rounds);
      if (st == PROBE_OVF) {
        atomicOr(&a.stats[S_OVF], 1);
      } else if (MASK) {
        atomicMin(&a.owner[s], ((unsigned long long)(~a.step) << 32) |
                                   (unsigned long long)l);
        if (st == PROBE_CLAIMED) claimed = s;
      }
    }
  }
  warp_max(&a.stats[S_ROUNDS], rounds);
  if (!MASK) return;
  cooperative_groups::this_grid().sync();
  if (claimed >= 0) {
    const long long lane = owner_lane(a.owner[claimed], a.step, a.F);
    if (lane < 0)
      atomicOr(&a.stats[S_FAULT], 1);
    else
      a.inserted[lane] = 1;
  }
}

// Launch the flat insert of a.F lanes into a.keys (a.A == 1, no ring),
// kThreads lanes per block. Without a mask: one launch over every lane.
// With one, the cooperative grid is capped at the blocks that can be
// resident at once, so a batch wider than its threads runs as
// consecutive launches over lane ranges in order, under the same tag: a
// later range's lanes are all higher, so its owner words never undercut
// an earlier range's, and a key an earlier range inserted is found
// there. Only the table, a.inserted, the owner words and a.stats (zeroed
// by the caller) are written.
inline cudaError_t launch_insert(const StepArgs& a) {
  if (a.F == 0) return cudaSuccess;
  if (a.A != 1 || a.cc != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const long long blocks = (a.F + kThreads - 1) / kThreads;
  if (!a.inserted) {
    flat_insert_kernel<false><<<(int)blocks, kThreads, 0, st>>>(a, 0ll);
    return cudaGetLastError();
  }
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, flat_insert_kernel<true>, kThreads, 0);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long grid = min(blocks, (long long)per_sm * sms);
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  StepArgs copy = a;
  for (long long lane0 = 0; lane0 < a.F; lane0 += grid * kThreads) {
    void* params[] = {&copy, &lane0};
    e = cudaLaunchCooperativeKernel((const void*)flat_insert_kernel<true>,
                                    (int)grid, kThreads, params, 0, st);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

}  // namespace
