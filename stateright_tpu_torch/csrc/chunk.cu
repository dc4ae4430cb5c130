// The BFS chunk on Hopper: the kernels that let one CUDA graph of one
// loop iteration, replayed chunk_steps times, run a chunk with no host
// sync, and K7, the append after each step.
//
// Replaces what the JAX package's chunk program computes around its step
// kernel in XLA (no pallas_call), stateright_tpu/checker/device_loop.py:
//   * the loop condition make_cond (:352), evaluated on the device once
//     per iteration (eval_gate: at the end of chunk_begin_kernel for a
//     chunk's first iteration, in K7's tail for every next one);
//   * after the step kernel (:673-719): the ordered compaction of the
//     fresh lanes (shrink_indices, :140), the candidate rows
//     (assemble_candidates, stateright_tpu/ops/expand.py:153), the queue
//     and log appends (the two dynamic_update_slices, :696-701) and the
//     carry update (:702-719) (K7: append_kernel);
//   * the dispatch's carry reset (stateright_tpu/checker/tpu.py:1377)
//     (chunk_begin_kernel).
// Built with nvcc for sm_90a into its own shared library with a plain C
// interface and driven over ctypes by stateright_tpu_torch/ops/_cuda.py;
// the graph is captured by stateright_tpu_torch/checker/device_loop.py.
//
// The counter block (int32 ctr, checker/device_loop.py CtrLayout): the
// JAX package's base_stats layout [q_head, q_tail, log_n, gen, ovf, xovf,
// kovf, h_n, hovf, vmax, dmax, rmax, e_n, pdh, prb, disc_hit[P],
// disc_hi[P], disc_lo[P], the most recent queue row (W + 3), cch], then
// the port's own fields from ctr + ext (E_*): the steps left in the
// chunk, the fault flag, the next step's tag, the chunk's iterations and
// small iterations, the chunk's target_remaining and grow_limit, and the
// gate (step_common.cuh G_*). One copy of it is the chunk's stats vector.
//
// One iteration, as the graph holds it:
//   K1-K3 small, K1-K3 large   (fused_step.cu) each gated: only the size
//                          the gate picked runs, over the rows from the
//                          queue head, under the gate's tag.
//   K7 append_kernel       one launch: a block per tile of 1,024 or 4,096
//                          lanes of the large step (256 threads of 4 or
//                          16 lanes; rows wider than 256 words: 128
//                          lanes, a thread each; ops/_cuda.py
//                          append_tile picks the size per chunk), and
//                          one block more,
//                          the tail. Each block reads the gate and draws
//                          a ticket (its tile, and the launch's epoch);
//                          a tile's block counts its inserted lanes from
//                          the mask, stages their offsets and frontier
//                          rows in lane order in shared memory
//                          (shrink_indices' order, which fixes the queue
//                          order and so the search record), finds the
//                          rows before its tile by a single-pass scan
//                          with decoupled look-back (Merrill and Garland)
//                          over the blocks' status words, and writes its
//                          queue rows (child words, the row's
//                          eventually-bits, the child's key) and log rows
//                          (child key, parent key from the frontier row's
//                          cached columns, under symmetry the child's own
//                          fingerprint) as two contiguous spans, each
//                          thread one column. The tail waits for every
//                          block's last status word, then writes the most
//                          recent queue row, updates the carry (q_head +=
//                          take, q_tail and log_n += count, gen +=
//                          S_VALID, steps -= 1, the flags, the sticky
//                          first-hit discovery merge, the profile
//                          counters and the tag; a count that disagrees
//                          with the step's S_INSERTED sets the fault
//                          flag) and evaluates the next iteration's gate.
//   K8 history_kernel      (history.cu) only for a model with
//                          host-evaluated properties: the rows K7
//                          appended, deduplicated by their history
//                          words; an overflow sets hovf and shuts the gate
//                          K7's tail just wrote (the gate reads hovf).
// Per chunk, outside the graph: chunk_begin_kernel writes the chunk's
// parameters (steps, target_remaining, grow_limit, the first tag), zeroes
// the per-chunk counters, as the JAX package's dispatch does to its
// carry, and evaluates the chunk's first gate.
//
// A shut gate stays shut with no kernel to re-evaluate it: make_cond
// reads only the carry and the chunk's parameters, a replay whose gate is
// shut changes neither (the gated steps and K7 return at their first
// load of the gate), so the gate it would compute is the one it finds.
//
// What bounds it on this card: K7 reads the inserted mask (454,656 bytes
// at 2pc n=7, F = 12,288; ~1 MB at 2pc n=16) and, per inserted lane
// (~2 * 10^4 on a large 2pc7 step, ~10^5 on Increment(16)'s), ~40 bytes
// of its successor and keys and writes a 28-byte queue row (56 at
// IncrementLock(9), 80 at Increment(16)) and a 16- or 24-byte log row:
// 2 to 20 MB, bound by bytes at 0.5 to 6 microseconds; a chain of
// dependent round trips to device memory (the ticket, the mask, the
// look-back, the row loads, the tail's wait and its counters) rules.
// What the design does: one launch (no count pass, no gate kernel), one
// pass over the mask, the look-back reading up to 256 status words at
// once, the counter update in shared memory and registers, each thread's
// column fixed so its loads go out together and neighbouring threads
// store neighbouring words. The no-op tail of a chunk (iterations after
// the condition fails) still launches every node; each returns at its
// first load of the gate.

#include "step_common.cuh"

namespace {

// the base_stats fields of the counter block (checker/device_loop.py B_*)
enum Base {
  B_Q_HEAD = 0,
  B_Q_TAIL = 1,
  B_LOG_N = 2,
  B_GEN = 3,
  B_OVF = 4,
  B_XOVF = 5,
  B_H_N = 7,
  B_HOVF = 8,
  B_VMAX = 9,
  B_DMAX = 10,
  B_PDH = 13,
  B_PRB = 14,
  B_DISC = 15,
};

// the port's fields from ctr + ext (checker/device_loop.py E_*)
enum Extra {
  E_STEPS = 0,
  E_FAULT = 1,
  E_TAG = 2,
  E_ITERS = 3,
  E_SMALL = 4,
  E_TARGET = 5,
  E_GROW = 6,
  E_GATE = 7,
};

// K7's blocks: 256 threads, each over 4 or 16 consecutive lanes
// (ChunkArgs.tile_lanes: a tile of 1,024 or 4,096 lanes), or for rows
// wider than that block 128 threads of one lane each (a tile of 128
// lanes: a large step's tiles then outnumber the SMs)
constexpr int kAppendThreads = 256;
constexpr int kWideTileThreads = 128;
// the words of a wide queue row a lane holds (rows of up to
// 32 * kQueueWords words) and the rows a warp copies at once
constexpr int kQueueWords = 12;
constexpr int kRowsInFlight = 2;
// the words a thread has in flight at once (row words, status words)
constexpr int kBatch = 8;
// threads of chunk_begin_kernel
constexpr int kBeginThreads = 128;
// the most counter-block and stats-vector words the kernels stage in
// shared memory (srt_append and srt_chunk_begin check them): the block
// holds the most recent queue row, up to 352 + 3 words
constexpr int kMaxCtr = 512;
constexpr int kMaxStats = 64;
// the words of the most recent queue row K7's tail holds per lane of its
// warp in registers (rows of up to 32 * kRecentWords - 3 words; a wider
// row's other words are copied after the update); the widest row K7
// takes
constexpr int kRecentWords = 5;
constexpr int kMaxRowWords = 352;
static_assert(kMaxRowWords + 3 <= 32 * kQueueWords, "a wide queue row");

// A block's status word: the epoch of the K7 launch that wrote it (high
// 32 bits), a flag (2 bits) and a count of rows (30 bits): its tile's
// own (F_AGG; a block past the step's tiles publishes 0) or its tile's
// and every tile's before it (F_PREFIX). A word of an earlier launch has
// another epoch, so the words are never cleared.
enum Flag : uint32_t { F_NONE = 0, F_AGG = 1, F_PREFIX = 2 };
constexpr uint32_t kValueMask = (1u << 30) - 1u;
// K7's control words (ChunkArgs.ticket, 64-bit): the tickets drawn so far
// (every launch that runs a step draws one a block, so its epoch is its
// tickets over its grid, plus one), and the step's highest inserted
// lane + 1 under its epoch (epoch << 32 | lane + 1, by atomicMax: a
// later epoch is larger, so it is never reset).
enum Ticket { T_NEXT = 0, T_LAST = 1 };

}  // namespace

// Mirrored field for field by ops/_cuda.py ChunkArgs.
struct ChunkArgs {
  int* ctr;                  // the counter block
  int* stats;                // [stats_len] the step's stats vector (both
                             // sizes share it and the outputs below)
  const uint8_t* inserted;   // [f_large * A]
  const uint32_t* flat;      // [f_large * A, W]
  const uint32_t* ebits;     // [f_large] the step's ebits_out
  const uint32_t* chi;       // [f_large * A] the children's keys
  const uint32_t* clo;
  const uint32_t* ohi;       // [f_large * A] own fingerprints (symmetry;
  const uint32_t* olo;       //               null otherwise)
  uint32_t* q;               // [qcap, W + 3] the queue, contiguous
  uint32_t* log;             // [logcap, log_cols] the log, contiguous
  unsigned long long* status;  // [K7's blocks] their status words
                               // (zeroed when allocated)
  unsigned long long* ticket;  // [2] K7's control words (T_*; zeroed when
                               // allocated)
  long long qlimit;          // qcap - qmargin: the most q_tail may be
  int P, W, A, log_cols, stats_len;
  int f_small;               // rows of the small step (0: one size)
  int f_large;               // rows of the large step
  int ext;                   // ctr offset of the port's fields
  int recent;                // ctr offset of the most recent queue row
  int cch;                   // ctr offset of the ring hits
  int tile_lanes;            // K7's lanes per block: 1024 or 4096
  void* stream;
};

namespace {

__device__ __forceinline__ long long step_lanes(const ChunkArgs& c,
                                                int size) {
  return (long long)(size == 1 ? c.f_small : c.f_large) * c.A;
}

__host__ __device__ __forceinline__ int append_blocks(long long lanes,
                                                      int tile_lanes) {
  return (int)((lanes + tile_lanes - 1) / tile_lanes);
}

// The counter block's words (the port's fields and the gate last).
__host__ __device__ __forceinline__ int ctr_len(const ChunkArgs& c) {
  return c.ext + E_GATE + G_LEN;
}

// The inserted bits of lanes [l0, l0 + LPT) below `lanes` (bit k: lane
// l0 + k), from one LPT-byte load when all LPT are in range.
template <int LPT>
__device__ __forceinline__ uint32_t lane_bits(const uint8_t* ins,
                                              long long l0,
                                              long long lanes) {
  if constexpr (LPT == 1) {
    return l0 < lanes && ins[l0] ? 1u : 0u;
  } else {
    uint32_t m = 0;
    if (l0 + LPT <= lanes) {
      uint32_t w[LPT / 4];
      if constexpr (LPT == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(ins + l0);
        w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
      } else {
        w[0] = *reinterpret_cast<const uint32_t*>(ins + l0);
      }
#pragma unroll
      for (int k = 0; k < LPT / 4; ++k)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if ((w[k] >> (8 * b)) & 0xFFu) m |= 1u << (4 * k + b);
    } else {
      for (int k = 0; k < LPT && l0 + k < lanes; ++k)
        if (ins[l0 + k]) m |= 1u << k;
    }
    return m;
  }
}

// Orders this thread's earlier loads and stores before its later ones,
// as other threads of the card see them.
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// A status word, read or written whole with no ordering of its own: a
// word carries everything a reader takes from it. A thread's loads are
// in flight together.
__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// A block's last status word: its reads of the gate and its atomicMax on
// T_LAST come before it for whoever reads the word and then fences.
__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long status_word(uint32_t epoch,
                                                          uint32_t flag,
                                                          int value) {
  return ((unsigned long long)epoch << 32) | (flag << 30) |
         ((uint32_t)value & kValueMask);
}

// Whether a status word is this launch's and carries at least the flag
// `least` (F_AGG: any; F_PREFIX: the inclusive prefix).
__device__ __forceinline__ bool ready(unsigned long long v, uint32_t epoch,
                                      uint32_t least) {
  return (uint32_t)(v >> 32) == epoch && ((uint32_t)v >> 30) >= least;
}

// The status words of blocks j0, j0 + stride, ... in [0, end) (kBatch of
// them; the others read as an empty prefix), re-read together until all
// are ready(). Each block drew an earlier ticket, so it runs; it
// publishes its aggregate without waiting on anything, and its prefix
// after waiting only on tiles before it.
__device__ __forceinline__ void wait_words(const unsigned long long* status,
                                           int j0, int stride, int end,
                                           uint32_t epoch, uint32_t least,
                                           unsigned long long* s) {
  const unsigned long long none = status_word(epoch, F_PREFIX, 0);
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int j = j0 + u * stride;
    s[u] = j >= 0 && j < end ? load_relaxed(status + j) : none;
  }
  for (;;) {
    bool all = true;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) all = all && ready(s[u], epoch, least);
    if (all) return;
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (!ready(s[u], epoch, least))
        s[u] = load_relaxed(status + j0 + u * stride);
  }
}

// The rows appended before `tile` (warp-wide; every lane gets it): the
// status words of the tiles before it, nearest first, 32 * kBatch at a
// time, summed up to and including the nearest that holds an inclusive
// prefix (decoupled look-back). Tiles before tile 0 read as an empty
// inclusive prefix.
__device__ int look_back(const unsigned long long* status, int tile,
                         uint32_t epoch) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int base = tile - 1;; base -= 32 * kBatch) {
    unsigned long long s[kBatch];
    // lane + 32 u is the word's distance from base: tile base - lane - 32 u
    wait_words(status, base - lane, -32, base + 1, epoch, F_AGG, s);
    int stop = 32 * kBatch;  // the nearest inclusive prefix's distance
#pragma unroll
    for (int u = kBatch - 1; u >= 0; --u) {
      const unsigned b =
          __ballot_sync(0xFFFFFFFFu, ((uint32_t)s[u] >> 30) == F_PREFIX);
      if (b) stop = 32 * u + __ffs(b) - 1;
    }
    int v = 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (lane + 32 * u <= stop) v += (int)((uint32_t)s[u] & kValueMask);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    excl += v;
    if (stop < 32 * kBatch) return excl;
  }
}

// The JAX package's make_cond on the counters (rows pending, steps left,
// no overflow, history overflow or fault, gen < target_remaining,
// log_n < grow_limit, q_tail <= qcap - qmargin, not every property discovered: `every`), the
// step size (the small one iff at most f_small rows are pending) and the
// gate, written to `g`.
__device__ __forceinline__ void write_gate(const ChunkArgs& c, int* g,
                                           int head, int tail, int log_n,
                                           int steps, int ovf, int xovf,
                                           int hovf, int fault, int gen,
                                           int target, int grow, int tag,
                                           bool every) {
  const int avail = tail - head;
  const bool go = avail > 0 && steps > 0 && !ovf && !xovf && !hovf &&
                  !fault &&
                  gen < target && log_n < grow &&
                  (long long)tail <= c.qlimit && !every;
  const bool small = c.f_small > 0 && avail <= c.f_small;
  const int f = small ? c.f_small : c.f_large;
  g[G_SIZE] = go ? (small ? 1 : 2) : 0;
  g[G_HEAD] = head;
  g[G_TAKE] = min(avail, f);
  g[G_TAG] = tag;
  g[G_QBASE] = tail;
  g[G_LBASE] = log_n;
}

// The gate of the counter block `ctr` as it stands (one thread).
__device__ void eval_gate(const ChunkArgs& c, int* ctr) {
  const int* x = ctr + c.ext;
  bool every = c.P > 0;
  for (int p = 0; p < c.P; ++p) every = every && ctr[B_DISC + p] != 0;
  write_gate(c, ctr + c.ext + E_GATE, ctr[B_Q_HEAD], ctr[B_Q_TAIL],
             ctr[B_LOG_N], x[E_STEPS], ctr[B_OVF], ctr[B_XOVF],
             ctr[B_HOVF], x[E_FAULT], ctr[B_GEN], x[E_TARGET], x[E_GROW],
             x[E_TAG], every);
}

// The counter block and the stats vector into shared memory, one word a
// thread of the `n` threads from thread t (one round trip to device
// memory).
__device__ __forceinline__ void stage_counters(const ChunkArgs& c, int t,
                                               int n, int* s_ctr,
                                               int* s_st) {
  for (int i = t; i < ctr_len(c); i += n) s_ctr[i] = c.ctr[i];
  for (int i = t; i < c.stats_len; i += n) s_st[i] = c.stats[i];
}

// The staged counter block written back and the stats vector zeroed, by
// the same threads, after a barrier.
__device__ __forceinline__ void commit_counters(const ChunkArgs& c, int t,
                                                int n, const int* s_ctr) {
  for (int i = t; i < ctr_len(c); i += n) c.ctr[i] = s_ctr[i];
  for (int i = t; i < c.stats_len; i += n) c.stats[i] = 0;
}

// Per chunk (one block): the chunk's parameters, the per-chunk counters
// zeroed (gen, vmax, dmax, pdh, prb, cch, iterations), then the gate of
// the chunk's first iteration and the step's stats vector zeroed.
__global__ void chunk_begin_kernel(ChunkArgs c, int steps, int target,
                                   int grow_limit, int tag) {
  __shared__ int s_ctr[kMaxCtr], s_st[kMaxStats];
  stage_counters(c, threadIdx.x, blockDim.x, s_ctr, s_st);
  __syncthreads();
  if (threadIdx.x == 0) {
    int* x = s_ctr + c.ext;
    s_ctr[B_GEN] = 0;
    s_ctr[B_VMAX] = 0;
    s_ctr[B_DMAX] = 0;
    s_ctr[B_PDH] = 0;
    s_ctr[B_PRB] = 0;
    s_ctr[c.cch] = 0;
    x[E_STEPS] = steps;
    x[E_TARGET] = target;
    x[E_GROW] = grow_limit;
    x[E_TAG] = tag;
    x[E_ITERS] = 0;
    x[E_SMALL] = 0;
    eval_gate(c, s_ctr);
  }
  __syncthreads();
  commit_counters(c, threadIdx.x, blockDim.x, s_ctr);
}

// Where one column of the appended rows comes from: word
// base[l * mul_l + r * mul_r + add] for the row of lane l (frontier row
// r).
struct ColumnSrc {
  const uint32_t* base;
  int mul_l, mul_r;
  long long add;
};

// Column col of a queue row: the child's words, the row's
// eventually-bits, the child's key.
__device__ __forceinline__ ColumnSrc queue_column(const ChunkArgs& c,
                                                  int col) {
  const int W = c.W;
  if (col < W) return {c.flat, W, 0, col};
  if (col == W) return {c.ebits, 0, 1, 0};
  return {col == W + 1 ? c.chi : c.clo, 1, 0, 0};
}

// Column col of a log row: the child's key, its parent's key (the
// frontier row's cached columns, a queue row before qbase) and under
// symmetry the child's own fingerprint.
__device__ __forceinline__ ColumnSrc log_column(const ChunkArgs& c, int col,
                                                int head) {
  const int qc = c.W + 3;
  switch (col) {
    case 0: return {c.chi, 1, 0, 0};
    case 1: return {c.clo, 1, 0, 0};
    case 2: return {c.q, 0, qc, (long long)head * qc + c.W + 1};
    case 3: return {c.q, 0, qc, (long long)head * qc + c.W + 2};
    case 4: return {c.ohi, 1, 0, 0};
    default: return {c.olo, 1, 0, 0};
  }
}

// A tile's n rows, by `nthreads` threads (thread t of them): one span of
// the queue from row qbase + excl and one of the log from row lbase +
// excl. Thread t keeps one column of each span (t % cols) and walks rows
// t / cols, t / cols + nthreads / cols, ..., so neighbouring threads store
// neighbouring words, the column's source is fixed for the whole walk (no
// branch per word), and each thread has up to kBatch words of each span
// in flight before it stores them. Queue rows wider than the threads
// (W + 3 > nthreads: the ordered register rows of up to 352 words, in
// 128-lane tiles) are copied a warp per row instead, 32 consecutive
// words a store: a row's source is fixed for the whole row (no division
// or column switch per word), and each lane holds kRowsInFlight rows'
// words (up to 24) in flight. Row i is lane t0 + s_off[i] of frontier
// row r0 + s_row[i].
__device__ __forceinline__ void write_rows(
    const ChunkArgs& c, int t, int nthreads, int n, int t0, int r0,
    const uint16_t* s_off, const uint16_t* s_row, int head, int qbase,
    int lbase, int excl) {
  const int qc = c.W + 3, lc = c.log_cols;
  const int qstride = nthreads / qc, lstride = nthreads / lc;
  const int qrow = t < qstride * qc ? t / qc : n;  // n: no column
  const int lrow = t < lstride * lc ? t / lc : n;
  const int qcol = t - (t / qc) * qc, lcol = t - (t / lc) * lc;
  if (qstride == 0) {
    // a warp per row, kRowsInFlight rows at once: the row's words from
    // its lane's flat row, then the row's eventually-bits and the
    // child's key, lane wl holding words wl + 32 u
    const int wl = t & 31, wid = t >> 5, nw = nthreads >> 5;
    uint32_t* q0 = c.q + ((long long)qbase + excl) * qc;
    for (int i0 = wid; i0 < n; i0 += nw * kRowsInFlight) {
      uint32_t v[kRowsInFlight][kQueueWords];
#pragma unroll
      for (int j = 0; j < kRowsInFlight; ++j) {
        const int i = i0 + j * nw;
        if (i < n) {
          const long long l = t0 + s_off[i];
          const uint32_t* src = c.flat + l * c.W;
#pragma unroll
          for (int u = 0; u < kQueueWords; ++u) {
            const int k = wl + 32 * u;
            if (k < c.W)
              v[j][u] = src[k];
            else if (k == c.W)
              v[j][u] = c.ebits[r0 + s_row[i]];
            else if (k < qc)
              v[j][u] = (k == c.W + 1 ? c.chi : c.clo)[l];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kRowsInFlight; ++j) {
        const int i = i0 + j * nw;
        if (i < n) {
          uint32_t* dst = q0 + (long long)i * qc;
#pragma unroll
          for (int u = 0; u < kQueueWords; ++u) {
            const int k = wl + 32 * u;
            if (k < qc) dst[k] = v[j][u];
          }
        }
      }
    }
  }
  const ColumnSrc qs = queue_column(c, qcol);
  const ColumnSrc ls = log_column(c, lcol, head);
  uint32_t* qd = c.q + ((long long)qbase + excl) * qc + qcol;
  uint32_t* ld = c.log + ((long long)lbase + excl) * lc + lcol;
  for (int k = 0; qrow + k * qstride < n || lrow + k * lstride < n;
       k += kBatch) {
    uint32_t qv[kBatch], lv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = qrow + (k + u) * qstride;
      if (i < n)
        qv[u] = qs.base[(long long)(t0 + s_off[i]) * qs.mul_l +
                        (long long)(r0 + s_row[i]) * qs.mul_r + qs.add];
      const int i2 = lrow + (k + u) * lstride;
      if (i2 < n)
        lv[u] = ls.base[(long long)(t0 + s_off[i2]) * ls.mul_l +
                        (long long)(r0 + s_row[i2]) * ls.mul_r + ls.add];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = qrow + (k + u) * qstride;
      if (i < n) qd[(long long)i * qc] = qv[u];
      const int i2 = lrow + (k + u) * lstride;
      if (i2 < n) ld[(long long)i2 * lc] = lv[u];
    }
  }
}

// The tail of K7 (warp 0 of the block that drew the last ticket, which
// holds no tile): the counter block and the stats vector staged in shared
// memory; every block's last status word (the tiles' inclusive prefixes,
// the last one's the step's total; the other blocks' aggregate of 0),
// each a release after that block's reads of the gate and its atomicMax
// on T_LAST; the step's highest inserted lane; the carry update (lane 0:
// q_head += take, q_tail and log_n += total, gen += S_VALID, the flags,
// the profile counters, steps -= 1, the tag; a total that disagrees
// with the step's S_INSERTED sets the fault flag), the sticky first-hit
// merge (lane p + 1 for property p), the most recent queue row (word i
// by lane i % 32, from the last inserted lane, its loads issued first) and
// the next gate; then the counter block written back and the stats
// vector zeroed. The counters are read by the next kernel in the stream
// or by the host after the chunk, so the tail need not wait for the
// other blocks' row stores.
__device__ __forceinline__ void append_tail(const ChunkArgs& c, int size,
                                            int nblk, uint32_t epoch,
                                            int* s_ctr, int* s_st) {
  const int lane = threadIdx.x & 31;
  const int nb = gridDim.x;
  // nothing in this launch writes them before the tail
  stage_counters(c, lane, 32, s_ctr, s_st);
  int total = 0;
  for (int j0 = lane; j0 < nb; j0 += 32 * kBatch) {
    unsigned long long s[kBatch];
    wait_words(c.status, j0, 32, nb, epoch, F_AGG, s);
    // a tile's word must be its prefix, its last
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + 32 * u;
      while (j < nblk && ((uint32_t)s[u] >> 30) != F_PREFIX)
        s[u] = load_relaxed(c.status + j);
      if (j == nblk - 1) total = (int)((uint32_t)s[u] & kValueMask);
    }
  }
  fence_acq_rel();  // those words before everything below
  __syncwarp();
  total = __reduce_max_sync(0xFFFFFFFFu, total);
  unsigned long long lastw = 0;
  if (lane == 0) lastw = load_relaxed(c.ticket + T_LAST);
  lastw = __shfl_sync(0xFFFFFFFFu, lastw, 0);
  // the last inserted lane (none when no lane of this launch's was)
  const int last = (uint32_t)(lastw >> 32) == epoch ? (int)(uint32_t)lastw - 1
                                                    : 0;
  __syncwarp();
  const int P = c.P, W = c.W, x = c.ext;
  // the most recent queue row, its loads in flight during the update:
  // word lane + 32 u of it in recent[u]
  uint32_t recent[kRecentWords];
#pragma unroll
  for (int u = 0; u < kRecentWords; ++u) {
    const int w = lane + 32 * u;
    recent[u] = 0u;
    if (w < W + 3 && total > 0)
      recent[u] = w < W ? c.flat[(long long)last * W + w]
                  : w == W ? c.ebits[last / c.A]
                           : (w == W + 1 ? c.chi : c.clo)[last];
  }
  bool hit = false;
  if (lane >= 1 && lane <= P) {  // the sticky first hit of property p
    const int p = lane - 1;
    hit = s_ctr[B_DISC + p] != 0;
    if (!hit && s_st[S_DISC + p]) {
      hit = true;
      s_ctr[B_DISC + p] = 1;
      s_ctr[B_DISC + P + p] = s_st[S_DISC + P + p];
      s_ctr[B_DISC + 2 * P + p] = s_st[S_DISC + 2 * P + p];
    }
  }
  const unsigned hits = __ballot_sync(0xFFFFFFFFu, hit);
  const bool every = P > 0 && hits == ((1u << P) - 1u) << 1;
  if (lane == 0) {  // every read before any write
    const int* g = s_ctr + x + E_GATE;
    const int head = g[G_HEAD] + g[G_TAKE], tail = g[G_QBASE] + total;
    const int log_n = g[G_LBASE] + total;
    const int valid = s_st[S_VALID], dedup = s_st[S_DEDUP];
    const int cch = s_st[S_CCH];
    const int gen = s_ctr[B_GEN] + valid;
    const int ovf = s_ctr[B_OVF] | (s_st[S_OVF] != 0);
    const int xovf = s_ctr[B_XOVF] | (s_st[S_XOVF] != 0);
    const int fault = s_ctr[x + E_FAULT] | (s_st[S_FAULT] != 0) |
                      (s_st[S_INSERTED] != total);
    const int vmax = max(s_ctr[B_VMAX], valid);
    const int dmax = max(s_ctr[B_DMAX], dedup);
    const int pdh = s_ctr[B_PDH] + valid - dedup - cch;
    const int prb = s_ctr[B_PRB] + s_st[S_ROUNDS];
    const int ring = s_ctr[c.cch] + cch;
    const int steps = s_ctr[x + E_STEPS] - 1, tag = s_ctr[x + E_TAG] + 1;
    const int iters = s_ctr[x + E_ITERS] + 1;
    const int small = s_ctr[x + E_SMALL] + (size == 1);
    const int target = s_ctr[x + E_TARGET], grow = s_ctr[x + E_GROW];
    s_ctr[B_Q_HEAD] = head;
    s_ctr[B_Q_TAIL] = tail;
    s_ctr[B_LOG_N] = log_n;
    s_ctr[B_GEN] = gen;
    s_ctr[B_OVF] = ovf;
    s_ctr[B_XOVF] = xovf;
    s_ctr[B_VMAX] = vmax;
    s_ctr[B_DMAX] = dmax;
    s_ctr[B_PDH] = pdh;
    s_ctr[B_PRB] = prb;
    s_ctr[c.cch] = ring;
    s_ctr[x + E_FAULT] = fault;
    s_ctr[x + E_STEPS] = steps;
    s_ctr[x + E_TAG] = tag;
    s_ctr[x + E_ITERS] = iters;
    s_ctr[x + E_SMALL] = small;
    write_gate(c, s_ctr + x + E_GATE, head, tail, log_n, steps, ovf, xovf,
               s_ctr[B_HOVF], fault, gen, target, grow, tag, every);
  }
#pragma unroll
  for (int u = 0; u < kRecentWords; ++u) {
    const int w = lane + 32 * u;
    if (w < W + 3 && total > 0) s_ctr[c.recent + w] = (int)recent[u];
  }
  for (int w = lane + 32 * kRecentWords; w < W + 3 && total > 0; w += 32)
    s_ctr[c.recent + w] = (int)(w < W ? c.flat[(long long)last * W + w]
                                : w == W ? c.ebits[last / c.A]
                                         : (w == W + 1 ? c.chi : c.clo)[last]);
  __syncwarp();
  commit_counters(c, lane, 32, s_ctr);
}

// K7 over tiles of THREADS * LPT lanes: the appends in lane order, and
// (the tail) the carry update and the next gate. Each block reads the gate,
// and on an open gate draws a ticket; its last status word (a release)
// comes after its reads of the gate, and the tail (the block that draws
// the launch's last ticket) rewrites the gate only after it has read
// every block's last word, so every block works on this iteration's
// gate.
template <int LPT, int THREADS>
__global__ void __launch_bounds__(THREADS) append_kernel(ChunkArgs c) {
  constexpr int kTile = THREADS * LPT;
  constexpr int kAppendWarps = THREADS / 32;
  __shared__ unsigned long long s_ticket;
  __shared__ int s_size, s_head, s_qbase, s_lbase, s_excl, s_tile_last;
  __shared__ int s_warp[kAppendWarps];
  __shared__ uint16_t s_off[kTile];  // the tile's inserted lanes
  __shared__ uint16_t s_row[kTile];  // their frontier rows
  __shared__ int s_ctr[kMaxCtr], s_st[kMaxStats];
  const int tid = threadIdx.x;
  if (tid == 0) {
    const int* g = c.ctr + c.ext + E_GATE;
    s_size = g[G_SIZE];
    if (s_size != 0) {
      s_ticket = atomicAdd(&c.ticket[T_NEXT], 1ull);
      s_head = g[G_HEAD];
      s_qbase = g[G_QBASE];
      s_lbase = g[G_LBASE];
    }
  }
  __syncthreads();
  // A shut gate: nothing runs, nothing changes (no block draws a ticket:
  // with no tail, nothing rewrites the gate in this launch, so every
  // block reads it shut). An open one stays open until the tail, which
  // comes after every block's last status word.
  const int size = s_size;
  if (size == 0) return;
  // every launch that runs draws one ticket a block: [e G, e G + G)
  const int nb = gridDim.x;
  const int tile = (int)(s_ticket % nb);
  const uint32_t epoch = (uint32_t)(s_ticket / nb) + 1u;
  const long long lanes = step_lanes(c, size);
  const int nblk = append_blocks(lanes, kTile);
  const int t0 = tile * kTile, r0 = t0 / c.A;
  const int wl = tid & 31, wid = tid >> 5;
  if (tile == nb - 1) {  // the tail (the grid has one block past the tiles)
    if (wid == 0) {
      if (tid == 0) store_release(c.status + tile,
                                  status_word(epoch, F_AGG, 0));
      append_tail(c, size, nblk, epoch, s_ctr, s_st);
    }
    return;
  }
  int n = 0;
  if (tile < nblk) {
    const int k0 = tid * LPT;
    uint32_t m = lane_bits<LPT>(c.inserted, (long long)t0 + k0, lanes);
    const int cnt = __popc(m);
    int incl = cnt;  // inclusive scan of the counts over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (wl >= o) incl += v;
    }
    if (wl == 31) s_warp[wid] = incl;
    __syncthreads();
    int off = incl - cnt;
#pragma unroll
    for (int w = 0; w < kAppendWarps; ++w) {
      const int v = s_warp[w];
      if (w < wid) off += v;
      n += v;
    }
    // the tile's inserted lanes in lane order: row off of the tile is
    // lane t0 + s_off[off], of frontier row r0 + s_row[off]
    int k = 0;
    while (m) {
      k = __ffs(m) - 1;
      m &= m - 1;
      s_off[off] = (uint16_t)(k0 + k);
      s_row[off++] = (uint16_t)((t0 + k0 + k) / c.A - r0);
    }
    if (cnt && off == n) s_tile_last = k0 + k;
    __syncthreads();
    if (wid == 0) {  // the rows before this tile
      if (tid == 0) {
        if (n)
          atomicMax(&c.ticket[T_LAST], (unsigned long long)epoch << 32 |
                                           (uint32_t)(t0 + s_tile_last + 1));
        if (tile == 0)  // its inclusive prefix, its last word
          store_release(c.status, status_word(epoch, F_PREFIX, n));
        else
          store_relaxed(c.status + tile, status_word(epoch, F_AGG, n));
      }
      const int excl = tile == 0 ? 0 : look_back(c.status, tile, epoch);
      if (tid == 0) {
        if (tile > 0)
          store_release(c.status + tile,
                        status_word(epoch, F_PREFIX, excl + n));
        s_excl = excl;
      }
    }
    __syncthreads();
  } else if (tid == 0) {  // past the step's tiles: the gate was read
    store_release(c.status + tile, status_word(epoch, F_AGG, 0));
  }
  if (tile >= nblk || n == 0) return;
  write_rows(c, tid, THREADS, n, t0, r0, s_off, s_row, s_head,
             s_qbase, s_lbase, s_excl);
}

}  // namespace

extern "C" {

// Each entry launches on c->stream and returns cudaGetLastError() of its
// launches (0 = launched); the caller raises on anything else.

// The chunk's parameters and its first gate (outside the graph, once per
// chunk).
int srt_chunk_begin(const ChunkArgs* c, int steps, int target, int grow_limit,
                    int tag) {
  if (ctr_len(*c) > kMaxCtr || c->stats_len > kMaxStats)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  chunk_begin_kernel<<<1, kBeginThreads, 0, st>>>(*c, steps, target,
                                                  grow_limit, tag);
  return (int)cudaGetLastError();
}

// K7 over the lanes of the step the gate picked (the grid covers the
// large size's and one block more, the tail; the blocks past the small
// size's tiles only draw their tickets), then the carry update and the
// next gate.
int srt_append(const ChunkArgs* c) {
  const int t = c->tile_lanes;
  if (c->W < 1 || c->A < 1 || c->f_large < 1 || c->f_small < 0 ||
      c->f_small > c->f_large || (c->log_cols != 4 && c->log_cols != 6) ||
      (c->log_cols == 6 && (c->ohi == nullptr || c->olo == nullptr)) ||
      c->status == nullptr || c->ticket == nullptr ||
      (long long)c->f_large * c->A > (long long)kValueMask ||
      ctr_len(*c) > kMaxCtr || c->stats_len > kMaxStats || c->P > 31 ||
      c->W > kMaxRowWords ||
      (t != kWideTileThreads && t != 1024 && t != 4096))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  // the tiles of the large step, and the tail
  const int blocks = append_blocks((long long)c->f_large * c->A, t) + 1;
  if (t == kWideTileThreads)  // one lane a thread
    append_kernel<1, kWideTileThreads><<<blocks, kWideTileThreads, 0, st>>>(
        *c);
  else if (t == 1024)
    append_kernel<4, kAppendThreads><<<blocks, kAppendThreads, 0, st>>>(*c);
  else
    append_kernel<16, kAppendThreads><<<blocks, kAppendThreads, 0, st>>>(
        *c);
  return (int)cudaGetLastError();
}

// The chunk's replays: the graph of one iteration (captured by torch,
// its cudaGraphExec_t passed as an integer) launched `times` times on
// `stream`, in one call, so the host gives up the interpreter lock once
// a chunk instead of once a replay. Returns the first launch error.
int srt_graph_launch(long long exec, long long stream, int times) {
  if (exec == 0 || times < 0) return (int)cudaErrorInvalidValue;
  cudaGraphExec_t g = reinterpret_cast<cudaGraphExec_t>(
      static_cast<intptr_t>(exec));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(
      static_cast<intptr_t>(stream));
  for (int i = 0; i < times; ++i) {
    cudaError_t e = cudaGraphLaunch(g, st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Bytes of the argument struct, checked by the Python binding.
int srt_chunk_args_size() { return (int)sizeof(ChunkArgs); }

}  // extern "C"
