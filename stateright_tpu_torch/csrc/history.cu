// The history stage of the BFS chunk on Hopper, for models with
// host-evaluated properties (PackedPaxos's linearizability): K8, the
// history insert, and K9, the representative pull.
//
// Replaces what the JAX package computes in XLA (no pallas_call) for its
// host-property path:
//   * K8 history_kernel: the in-loop history dedup of
//     stateright_tpu/checker/device_loop.py:574-595 (the fingerprint of
//     each appended row's host-property columns, the insert into the
//     history-key table within h_rounds, :344, hovf on overflow, and the
//     queue index of each fresh key appended to hidx in lane order), and
//     with an index list instead of a queue range the re-seed and the
//     rescan of stateright_tpu/checker/tpu.py:2461 and :2494;
//   * K9 hpull_kernel: the gather of stateright_tpu/checker/tpu.py:2410
//     (_hpull_jit) and of the per-chunk window,
//     stateright_tpu/checker/device_loop.py:846-856: the queue rows at
//     hidx[start : start + n] and their witness fingerprints (the log's
//     child key at the row's index - n_init).
// Built with nvcc for sm_90a into its own shared library with a plain C
// interface and driven over ctypes by stateright_tpu_torch/ops/_cuda.py.
//
// K8 in the chunk's graph runs after K7 (chunk.cu), over the queue rows
// from *start (the stage's hdone) to the queue tail (ctr[B_Q_TAIL]), and
// moves *start to the tail; h_n and hovf are the counter block's
// (ctr[B_H_N], ctr[B_HOVF]). An overflow still commits the iteration (its
// rows are real; the unresolved keys go unlogged, as in the JAX package)
// and shuts the next iteration's gate (gate[G_SIZE] = 0; chunk.cu's gate
// also reads hovf), so the loop stops after it and the host grows the
// table and rescans.
//
// The representative of a key is its LOWEST (first appended) row of the
// batch: each row's key is looked up in the table, the absent keys are
// deduplicated in shared memory (the lowest lane of each wins), each
// winner claims its slot (distinct keys: only slot races between
// different keys retry) and the winners append their queue indices in
// lane order by a block scan. (The JAX package's insert keeps the
// highest lane of an in-batch duplicate group: the same keys and
// counts, another representative of the same history.)
//
// What bounds it on this card: per appended row K8 reads the row's
// history columns (40 bytes at Paxos(3)) and one 32-byte bucket of the
// table, and writes 4 bytes per fresh key: ~0.5 MB for the ~7,000 rows a
// large Paxos(3) step appends, ~0.2 us of the card's bytes. Distinct
// histories are few (Paxos(2) has 5), so almost every lookup is a hit,
// and the whole stage is latency: one block walks the rows 512 at a time
// (one memory round trip for the columns, one for the bucket, a few
// barriers), which keeps the appends in order with no grid-wide scan.
// K9 moves at most HIST_WINDOW (256) rows of W + 2 words a chunk (~100 KB
// at W = 96): one block per row, its threads over the columns.

#include "step_common.cuh"

namespace {

constexpr int kHistThreads = 512;
constexpr int kHistCells = 2 * kHistThreads;  // the batch's shared table
constexpr int kPullThreads = 128;
constexpr int kPullBlocks = 1024;

enum Lookup { FOUND = 0, ABSENT = 1, LOOKUP_OVF = 2 };

}  // namespace

// Mirrored field for field by ops/_cuda.py HistArgs.
struct HistArgs {
  const uint32_t* q;         // [qcap, qstride] the queue
  long long qstride;
  int hoff, hwidth;          // the key columns of a row
  unsigned long long* keys;  // [n_buckets * 4] the history-key table
  long long n_buckets;
  int max_rounds;            // h_rounds
  const int* index;          // rows index[0:count], or null: the queue
  int count;                 // rows [*start, *end)
  int* start;                // moved to *end after the pass (range mode)
  const int* end;
  int* hidx;                 // the representatives' queue indices (null:
                             // insert only, as the re-seed does)
  int* h_n;                  // read, and advanced by the appended count
  int* ovf;                  // set to 1 on an overflow
  int* gate;                 // the chunk's gate, or null
  void* stream;
};

// Mirrored field for field by ops/_cuda.py HpullArgs.
struct HpullArgs {
  const uint32_t* q;  // [qcap, qstride]
  long long qstride;
  int W;              // the packed words a row gives
  const int* hidx;
  const uint32_t* log;  // [logcap, log_cols]
  int log_cols;
  int n_init;         // queue rows before the log's first
  int start;          // hidx[start + i] is row i
  const int* h_n;     // rows: min(rows, *h_n - start), or with null
  int count;          // min(rows, count)
  uint32_t* out;      // [rows, W + 2], the rows past the count zero
  int rows;
  void* stream;
};

namespace {

// fp64 of the width words at p (a row of that width).
__device__ __forceinline__ void fp64_span(const uint32_t* p, int width,
                                          uint32_t& hi, uint32_t& lo) {
  uint32_t h1 = 0u, h2 = 0u;
  for (int i = 0; i < width; ++i) {
    const uint32_t x = p[i] ^ fmix32((uint32_t)(i + 1) * kGolden);
    h1 ^= fmix32(x * kC1_1);
    h2 ^= fmix32(x * kC1_2);
  }
  h1 = fmix32(h1 ^ kSeed1 ^ (uint32_t)width);
  h2 = fmix32(h2 ^ kSeed2 ^ ((uint32_t)width * kC1_1));
  if (h1 == 0u && h2 == 0u) h2 = 1u;
  hi = h1;
  lo = h2;
}

// Whether the table holds key: its buckets from the start bucket until a
// match (FOUND), a bucket with an empty slot (ABSENT) or max_rounds
// buckets (LOOKUP_OVF).
__device__ __forceinline__ int probe_find(const unsigned long long* keys,
                                          long long n_buckets, uint32_t hi,
                                          uint32_t lo, int max_rounds) {
  const unsigned long long key = ((unsigned long long)hi << 32) | lo;
  const unsigned long long mask = (unsigned long long)(n_buckets - 1);
  unsigned long long g = (unsigned long long)(lo ^ (hi * kPhi)) & mask;
  for (int r = 0; r < max_rounds; ++r) {
    unsigned long long v[kBucket];
    load_bucket(keys + (long long)g * kBucket, v);
    bool empty = false;
#pragma unroll
    for (int j = 0; j < kBucket; ++j) {
      if (v[j] == key) return FOUND;
      empty |= v[j] == 0ull;
    }
    if (empty) return ABSENT;
    g = (g + 1) & mask;
  }
  return LOOKUP_OVF;
}

// K8. One block over the rows (see the file's head), kHistThreads at a
// time: each thread keys its row, looks it up, enters an absent key into
// the batch's shared table (the lowest lane wins its cell), the winners
// claim their slots and append their queue indices in lane order.
__global__ void __launch_bounds__(kHistThreads)
    history_kernel(HistArgs a) {
  __shared__ unsigned long long s_key[kHistCells];
  __shared__ uint32_t s_lane[kHistCells];
  __shared__ int s_warp[kHistThreads / 32];
  __shared__ int s_base, s_ovf;
  const int tid = threadIdx.x, wl = tid & 31, wid = tid >> 5;
  const long long first = a.index ? 0 : *a.start;
  const long long n = a.index ? a.count : *a.end - first;
  for (int c = tid; c < kHistCells; c += blockDim.x) {
    s_key[c] = 0ull;
    s_lane[c] = ~0u;
  }
  if (tid == 0) {
    s_base = *a.h_n;
    s_ovf = 0;
  }
  __syncthreads();
  for (long long base = 0; base < n; base += blockDim.x) {
    const long long i = base + tid;
    long long r = 0;
    uint32_t hi = 0u, lo = 0u;
    bool fresh = false;
    if (i < n) {
      r = a.index ? a.index[i] : first + i;
      fp64_span(a.q + r * a.qstride + a.hoff, a.hwidth, hi, lo);
      const int st = probe_find(a.keys, a.n_buckets, hi, lo, a.max_rounds);
      if (st == LOOKUP_OVF) s_ovf = 1;
      fresh = st == ABSENT;
    }
    // the batch's lowest lane of each absent key
    uint32_t cell = ~0u;
    if (fresh) {
      const unsigned long long key = ((unsigned long long)hi << 32) | lo;
      uint32_t c = (lo ^ (hi * kPhi)) & (uint32_t)(kHistCells - 1);
      while (true) {
        const unsigned long long prev = atomicCAS(&s_key[c], 0ull, key);
        if (prev == 0ull || prev == key) break;
        c = (c + 1) & (uint32_t)(kHistCells - 1);
      }
      atomicMin(&s_lane[c], (uint32_t)tid);
      cell = c;
    }
    __syncthreads();
    bool win = fresh && s_lane[cell] == (uint32_t)tid;
    if (win) {
      long long slot;
      int rounds;
      const int st = probe_claim(a.keys, a.n_buckets, hi, lo, a.max_rounds,
                                 &slot, &rounds);
      if (st != PROBE_CLAIMED) {  // only an overflow: the keys are new
        s_ovf = 1;
        win = false;
      }
    }
    // the winners' queue indices at h_n, in lane order
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, win);
    if (wl == 0) s_warp[wid] = __popc(ballot);
    __syncthreads();
    int excl = __popc(ballot & ((1u << wl) - 1u)), total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      excl += w < wid ? s_warp[w] : 0;
      total += s_warp[w];
    }
    if (win && a.hidx) a.hidx[s_base + excl] = (int)r;
    if (cell != ~0u) {  // clear the batch's cells for the next one
      s_key[cell] = 0ull;
      s_lane[cell] = ~0u;
    }
    __syncthreads();
    if (tid == 0 && a.hidx) s_base += total;
  }
  __syncthreads();
  if (tid == 0) {
    *a.h_n = s_base;
    if (s_ovf) {
      *a.ovf = 1;
      if (a.gate) a.gate[G_SIZE] = 0;
    }
    if (!a.index) *a.start = (int)(first + n);
  }
}

// K9. Block b takes rows b, b + gridDim.x, ...; its threads the row's
// W + 2 columns (the packed words, then the witness fingerprint).
__global__ void __launch_bounds__(kPullThreads) hpull_kernel(HpullArgs a) {
  const int n = max(0, min(a.rows, a.h_n ? *a.h_n - a.start : a.count));
  const int cols = a.W + 2;
  for (int i = blockIdx.x; i < a.rows; i += gridDim.x) {
    const long long sel = i < n ? a.hidx[a.start + i] : 0;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      uint32_t v = 0u;
      if (i < n)
        v = c < a.W ? a.q[sel * a.qstride + c]
                    : a.log[(sel - a.n_init) * a.log_cols + (c - a.W)];
      a.out[(long long)i * cols + c] = v;
    }
  }
}

}  // namespace

extern "C" {

// K8: one block (the appends stay in lane order). Returns
// cudaGetLastError() of the launch.
int srt_history(const HistArgs* a) {
  if (a->hwidth < 1 || a->n_buckets < 1 ||
      (a->n_buckets & (a->n_buckets - 1)) || a->max_rounds < 1 ||
      a->h_n == nullptr || a->ovf == nullptr ||
      (a->index == nullptr && (a->start == nullptr || a->end == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(a->stream);
  history_kernel<<<1, kHistThreads, 0, st>>>(*a);
  return (int)cudaGetLastError();
}

// K9 over a->rows rows.
int srt_hpull(const HpullArgs* a) {
  if (a->rows < 1 || a->W < 1 || a->log_cols < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(a->stream);
  hpull_kernel<<<min(a->rows, kPullBlocks), kPullThreads, 0, st>>>(*a);
  return (int)cudaGetLastError();
}

// Bytes of the argument structs, checked by the Python binding.
int srt_hist_args_size() { return (int)sizeof(HistArgs); }
int srt_hpull_args_size() { return (int)sizeof(HpullArgs); }

}  // extern "C"
