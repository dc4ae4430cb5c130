// The BFS chunk on Hopper: the kernels that let one CUDA graph of one
// loop iteration, replayed chunk_steps times, run a chunk with no host
// sync, and K7, the append after each step.
//
// Replaces what the JAX package's chunk program computes around its step
// kernel in XLA (no pallas_call), stateright_tpu/checker/device_loop.py:
//   * the loop condition make_cond (:352), evaluated on the device once
//     per iteration (gate_kernel);
//   * after the step kernel (:673-719): the ordered compaction of the
//     fresh lanes (shrink_indices, :140), the candidate rows
//     (assemble_candidates, stateright_tpu/ops/expand.py:153), the queue
//     and log appends (the two dynamic_update_slices, :696-701) and the
//     carry update (:702-719) (K7: append_count_kernel, append_kernel).
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
//   gate_kernel            one block: zero the step's stats vector,
//                          evaluate the loop condition on the counters,
//                          pick the step size (the small one iff at most
//                          f_small rows are pending) and write the gate.
//   K1-K3 small, K1-K3 large   (fused_step.cu) each gated: only the size
//                          the gate picked runs, over the rows from the
//                          queue head, under the gate's tag.
//   K7 append_count_kernel one thread per 16 lanes of the step that ran:
//                          the inserted lanes of each block of 4,096
//                          lanes.
//      append_kernel       the same blocks: each block's offset is the sum
//                          of the counts before it; within the block a
//                          warp scan over the threads' counts orders the
//                          inserted lanes by lane (shrink_indices' order,
//                          which fixes the queue order and so the search
//                          record); each inserted lane writes its queue
//                          row (child words, the row's eventually-bits,
//                          the child's key) at q_tail + its rank and its
//                          log row (child key, parent key from the
//                          frontier row's cached columns, under symmetry
//                          the child's own fingerprint) at log_n + its
//                          rank; block 0 then updates the carry: q_head
//                          += take, q_tail and log_n += count, gen +=
//                          S_VALID, steps -= 1, the flags, the sticky
//                          first-hit discovery merge, the profile
//                          counters and the tag. A count that disagrees
//                          with the step's S_INSERTED sets the fault flag.
// Per chunk, outside the graph: chunk_begin_kernel (one thread) writes
// the chunk's parameters (steps, target_remaining, grow_limit, the first
// tag) and zeroes the per-chunk counters, as the JAX package's dispatch
// does to its carry.
//
// What bounds it on this card: K7 reads the inserted mask (454,656 bytes
// at 2pc n=7, F = 12,288; ~1 MB at 2pc n=16) and, per inserted lane
// (~2 * 10^4 on a large 2pc7 step), ~40 bytes of its successor and keys
// and writes a 28-byte queue row and a 16- or 24-byte log row: under
// 2 MB, bound by bytes at well under a microsecond; launch latency rules.
// The control kernels move a few hundred bytes. What the design does: one
// pass over the mask as 16-byte loads, the block offsets from a 1-D
// scan of at most a few hundred counts (no decoupled look-back), no
// atomics on the rows. The no-op tail of a chunk (iterations after the
// condition fails) still launches every node; each returns at its first
// load of the gate.

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

// K7's blocks: 256 threads of 16 consecutive lanes each
constexpr int kAppendThreads = 256;
constexpr int kLanesPerThread = 16;
constexpr int kAppendLanes = kAppendThreads * kLanesPerThread;

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
  int* blk_cnt;              // [append_blocks(f_large * A)]
  long long qlimit;          // qcap - qmargin: the most q_tail may be
  int P, W, A, log_cols, stats_len;
  int f_small;               // rows of the small step (0: one size)
  int f_large;               // rows of the large step
  int ext;                   // ctr offset of the port's fields
  int recent;                // ctr offset of the most recent queue row
  int cch;                   // ctr offset of the ring hits
  void* stream;
};

namespace {

__device__ __forceinline__ long long step_lanes(const ChunkArgs& c,
                                                int size) {
  return (long long)(size == 1 ? c.f_small : c.f_large) * c.A;
}

__host__ __device__ __forceinline__ int append_blocks(long long lanes) {
  return (int)((lanes + kAppendLanes - 1) / kAppendLanes);
}

// The inserted bits of lanes [l0, l0 + 16) below `lanes` (bit k: lane
// l0 + k), from one 16-byte load when all 16 are in range.
__device__ __forceinline__ uint32_t lane_bits(const uint8_t* ins,
                                              long long l0,
                                              long long lanes) {
  uint32_t m = 0;
  if (l0 + kLanesPerThread <= lanes) {
    const uint4 v = *reinterpret_cast<const uint4*>(ins + l0);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((w[k] >> (8 * b)) & 0xFFu) m |= 1u << (4 * k + b);
  } else {
    for (int k = 0; k < kLanesPerThread && l0 + k < lanes; ++k)
      if (ins[l0 + k]) m |= 1u << k;
  }
  return m;
}

// Per chunk (one thread): the chunk's parameters and zeroed per-chunk
// counters (gen, vmax, dmax, pdh, prb, cch, iterations).
__global__ void chunk_begin_kernel(ChunkArgs c, int steps, int target,
                                   int grow_limit, int tag) {
  int* ctr = c.ctr;
  int* x = ctr + c.ext;
  ctr[B_GEN] = 0;
  ctr[B_VMAX] = 0;
  ctr[B_DMAX] = 0;
  ctr[B_PDH] = 0;
  ctr[B_PRB] = 0;
  ctr[c.cch] = 0;
  x[E_STEPS] = steps;
  x[E_TARGET] = target;
  x[E_GROW] = grow_limit;
  x[E_TAG] = tag;
  x[E_ITERS] = 0;
  x[E_SMALL] = 0;
}

// Per iteration (one block): zero the step's stats vector, then the JAX
// package's make_cond on the counters (rows pending, steps left, no
// overflow or fault, gen < target_remaining, log_n < grow_limit, q_tail
// <= qcap - qmargin, not every property discovered) and the gate.
__global__ void gate_kernel(ChunkArgs c) {
  for (int i = threadIdx.x; i < c.stats_len; i += blockDim.x) c.stats[i] = 0;
  if (threadIdx.x != 0) return;
  const int* ctr = c.ctr;
  const int* x = ctr + c.ext;
  int* g = c.ctr + c.ext + E_GATE;
  const int head = ctr[B_Q_HEAD], tail = ctr[B_Q_TAIL];
  const int log_n = ctr[B_LOG_N];
  const int avail = tail - head;
  bool every = c.P > 0;
  for (int p = 0; p < c.P; ++p) every = every && ctr[B_DISC + p] != 0;
  const bool go = avail > 0 && x[E_STEPS] > 0 && !ctr[B_OVF] &&
                  !ctr[B_XOVF] && !x[E_FAULT] && ctr[B_GEN] < x[E_TARGET] &&
                  log_n < x[E_GROW] && (long long)tail <= c.qlimit && !every;
  const bool small = c.f_small > 0 && avail <= c.f_small;
  const int f = small ? c.f_small : c.f_large;
  g[G_SIZE] = go ? (small ? 1 : 2) : 0;
  g[G_HEAD] = head;
  g[G_TAKE] = min(avail, f);
  g[G_TAG] = x[E_TAG];
  g[G_QBASE] = tail;
  g[G_LBASE] = log_n;
}

// K7, first launch: each block's count of inserted lanes.
__global__ void __launch_bounds__(kAppendThreads)
    append_count_kernel(ChunkArgs c) {
  const int* g = c.ctr + c.ext + E_GATE;
  const int size = g[G_SIZE];
  if (size == 0) return;
  const long long lanes = step_lanes(c, size);
  if ((int)blockIdx.x >= append_blocks(lanes)) return;
  __shared__ int s_cnt;
  if (threadIdx.x == 0) s_cnt = 0;
  __syncthreads();
  const long long l0 = (long long)blockIdx.x * kAppendLanes +
                       (long long)threadIdx.x * kLanesPerThread;
  warp_add(&s_cnt, __popc(lane_bits(c.inserted, l0, lanes)));
  __syncthreads();
  if (threadIdx.x == 0) c.blk_cnt[blockIdx.x] = s_cnt;
}

// The carry update after the appends (one thread): total is the step's
// appended rows.
__device__ void carry_update(const ChunkArgs& c, const int* g, int total,
                             int size) {
  int* ctr = c.ctr;
  int* x = ctr + c.ext;
  const int* st = c.stats;
  ctr[B_Q_HEAD] = g[G_HEAD] + g[G_TAKE];
  ctr[B_Q_TAIL] = g[G_QBASE] + total;
  ctr[B_LOG_N] = g[G_LBASE] + total;
  ctr[B_GEN] += st[S_VALID];
  ctr[B_OVF] = ctr[B_OVF] | (st[S_OVF] != 0);
  ctr[B_XOVF] = ctr[B_XOVF] | (st[S_XOVF] != 0);
  x[E_FAULT] = x[E_FAULT] | (st[S_FAULT] != 0) | (st[S_INSERTED] != total);
  ctr[B_VMAX] = max(ctr[B_VMAX], st[S_VALID]);
  ctr[B_DMAX] = max(ctr[B_DMAX], st[S_DEDUP]);
  ctr[B_PDH] += st[S_VALID] - st[S_DEDUP] - st[S_CCH];
  ctr[B_PRB] += st[S_ROUNDS];
  ctr[c.cch] += st[S_CCH];
  const int P = c.P;
  for (int p = 0; p < P; ++p) {
    if (!ctr[B_DISC + p] && st[S_DISC + p]) {  // sticky first hit
      ctr[B_DISC + p] = 1;
      ctr[B_DISC + P + p] = st[S_DISC + P + p];
      ctr[B_DISC + 2 * P + p] = st[S_DISC + 2 * P + p];
    }
  }
  x[E_STEPS] -= 1;
  x[E_TAG] += 1;
  x[E_ITERS] += 1;
  x[E_SMALL] += size == 1;
}

// K7, second launch: the appends in lane order, then (block 0) the carry
// update. Every block reads the gate's snapshot of q_tail and log_n, and
// block 0 writes only the counters, so no block waits for another.
__global__ void __launch_bounds__(kAppendThreads)
    append_kernel(ChunkArgs c) {
  const int* g = c.ctr + c.ext + E_GATE;
  const int size = g[G_SIZE];
  if (size == 0) return;
  const long long lanes = step_lanes(c, size);
  const int nblk = append_blocks(lanes);
  if ((int)blockIdx.x >= nblk) return;
  __shared__ int s_before, s_total, s_warp[kAppendThreads / 32];
  if (threadIdx.x == 0) s_before = s_total = 0;
  __syncthreads();
  int before = 0, total = 0;
  for (int b = threadIdx.x; b < nblk; b += blockDim.x) {
    const int v = c.blk_cnt[b];
    total += v;
    if (b < (int)blockIdx.x) before += v;
  }
  warp_add(&s_before, before);
  warp_add(&s_total, total);
  const long long l0 = (long long)blockIdx.x * kAppendLanes +
                       (long long)threadIdx.x * kLanesPerThread;
  uint32_t m = lane_bits(c.inserted, l0, lanes);
  const int cnt = __popc(m);
  const int wl = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int incl = cnt;  // inclusive scan of the counts over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (wl >= o) incl += v;
  }
  if (wl == 31) s_warp[wid] = incl;
  __syncthreads();
  int wbefore = 0;
  for (int w = 0; w < wid; ++w) wbefore += s_warp[w];
  long long pos = (long long)s_before + wbefore + incl - cnt;
  const long long qbase = g[G_QBASE], lbase = g[G_LBASE], head = g[G_HEAD];
  const int W = c.W, qc = W + 3, lc = c.log_cols, A = c.A;
  const long long last = (long long)s_total - 1;
  while (m) {
    const int k = __ffs(m) - 1;
    m &= m - 1;
    const long long l = l0 + k, r = l / A;
    const uint32_t* fl = c.flat + l * W;
    const uint32_t hi = c.chi[l], lo = c.clo[l], eb = c.ebits[r];
    uint32_t* qr = c.q + (qbase + pos) * qc;
    for (int w = 0; w < W; ++w) qr[w] = fl[w];
    qr[W] = eb;
    qr[W + 1] = hi;
    qr[W + 2] = lo;
    const uint32_t* par = c.q + (head + r) * qc;  // a row before qbase
    uint32_t* lr = c.log + (lbase + pos) * lc;
    lr[0] = hi;
    lr[1] = lo;
    lr[2] = par[W + 1];
    lr[3] = par[W + 2];
    if (lc == 6) {
      lr[4] = c.ohi[l];
      lr[5] = c.olo[l];
    }
    if (pos == last) {  // the most recent queue row rides the stats
      int* rec = c.ctr + c.recent;
      for (int w = 0; w < W; ++w) rec[w] = (int)fl[w];
      rec[W] = (int)eb;
      rec[W + 1] = (int)hi;
      rec[W + 2] = (int)lo;
    }
    ++pos;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) carry_update(c, g, s_total, size);
}

}  // namespace

extern "C" {

// Each entry launches on c->stream and returns cudaGetLastError() of its
// launches (0 = launched); the caller raises on anything else.

// The chunk's parameters (outside the graph, once per chunk).
int srt_chunk_begin(const ChunkArgs* c, int steps, int target, int grow_limit,
                    int tag) {
  cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  chunk_begin_kernel<<<1, 1, 0, st>>>(*c, steps, target, grow_limit, tag);
  return (int)cudaGetLastError();
}

// The iteration's gate (the graph's first node).
int srt_chunk_gate(const ChunkArgs* c) {
  cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  gate_kernel<<<1, 128, 0, st>>>(*c);
  return (int)cudaGetLastError();
}

// K7 over the lanes of the step the gate picked (the grid covers the
// large size's; the blocks past the small size's return).
int srt_append(const ChunkArgs* c) {
  if (c->W < 1 || c->A < 1 || c->f_large < 1 || c->f_small < 0 ||
      c->f_small > c->f_large || (c->log_cols != 4 && c->log_cols != 6) ||
      (c->log_cols == 6 && (c->ohi == nullptr || c->olo == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  const int blocks = append_blocks((long long)c->f_large * c->A);
  append_count_kernel<<<blocks, kAppendThreads, 0, st>>>(*c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  append_kernel<<<blocks, kAppendThreads, 0, st>>>(*c);
  return (int)cudaGetLastError();
}

// Bytes of the argument struct, checked by the Python binding.
int srt_chunk_args_size() { return (int)sizeof(ChunkArgs); }

}  // extern "C"
