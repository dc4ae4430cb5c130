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
// batch. K8 is one launch over a grid: the blocks key their tiles of
// kHistTileRows rows (a group of kHistGroup threads per row reads the
// row's key columns together and XOR-folds its per-word mixes by
// shuffles: fp64 folds its words in any order), look each key up in the
// table (writing nothing to it) and compact the lowest absent row of
// each key of their tiles (deduplicated in shared memory) in row order
// into the scratch, each tile in its own range, with the tile's count.
// The last block to arrive (a grid counter with __threadfence; it resets
// the counter, so the next launch or graph replay starts clean, and no
// block waits on another) walks the absent rows only, in row order, 512
// at a time: it deduplicates them in shared memory (the lowest row of
// each key wins), each winner claims its slot (an earlier batch's row
// of the same key makes the claim a duplicate: that row won) and the
// winners append their queue indices at h_n by a block scan. (The JAX package's insert keeps the highest
// lane of an in-batch duplicate group: the same keys and counts, another
// representative of the same history.) More rows than the scratch holds
// count as an overflow, so the host rescans them after growing: the
// chunk sizes its scratch for the most rows one iteration appends, so
// that never happens on the path.
//
// What bounds it on this card: per appended row K8 reads the row's
// history columns (40 bytes at Paxos(3)) and one 32-byte bucket of the
// table, and writes 4 bytes per fresh key: ~1 MB for the ~15,000 rows a
// large Paxos(3) step appends, ~0.3 us of the card's bytes. Distinct
// histories are few (Paxos(2) has 5), so almost every lookup is a hit
// and the tail has nothing to do; the lookups are latency (a column
// read, then a bucket read), which the grid spreads over the SMs, so
// the launch costs about one such round trip. K9 moves at most
// HIST_WINDOW (256) rows of W + 2 words a chunk (~100 KB at W = 96):
// one block per row, its threads over the columns.

#include "step_common.cuh"

namespace {

// K8: threads per block (every block of the grid, the tail's too), the
// threads keying one row, the rows each group keys per tile, and the
// tile's rows; the tail's shared dedup table per batch of kHistThreads
constexpr int kHistThreads = 512;
constexpr int kHistGroup = 8;
constexpr int kHistPasses = 4;
constexpr int kHistTileRows = kHistThreads / kHistGroup * kHistPasses;
constexpr int kHistCells = 2 * kHistThreads;
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
  // the scratch for at most cap rows (ops/_cuda.py history_scratch): per
  // tile of kHistTileRows rows the count of its absent rows, and their
  // keys and queue indices in row order in the tile's own range; ctl[0]
  // counts the blocks arrived, ctl[1] flags a lookup's overflow (both
  // zero between launches: the last block resets them)
  int* tile_n;               // [ceil(cap / kHistTileRows)]
  unsigned long long* akey;  // [tiles * kHistTileRows]
  int* arow;
  int* ctl;                  // [2]
  int cap;
  int blocks;                // the grid
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

// The exclusive prefix sum of v over the block, and its total. Every
// thread of the block calls it (two barriers; s_warp has a slot per warp).
__device__ __forceinline__ int block_scan(int v, int* s_warp, int& total) {
  const int wl = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (wl >= o) x += y;
  }
  if (wl == 31) s_warp[wid] = x;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int c = s_warp[w];
    before += w < wid ? c : 0;
    total += c;
  }
  __syncthreads();
  return before + x - v;
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

// K8 (see the file's head): the blocks' lookups and ordered compaction
// over tiles blockIdx.x, blockIdx.x + gridDim.x, ...; then the last block
// to arrive inserts the absent rows in row order. With no rows (a replay
// whose gate was shut) block 0 alone arrives and finds nothing to do.
__global__ void __launch_bounds__(kHistThreads)
    history_kernel(HistArgs a) {
  constexpr int kGroups = kHistThreads / kHistGroup;
  __shared__ unsigned long long s_key[kHistCells];
  __shared__ uint32_t s_lane[kHistCells];
  __shared__ unsigned long long s_tkey[kHistTileRows];
  __shared__ int s_trow[kHistTileRows];
  __shared__ uint8_t s_tabs[kHistTileRows];
  __shared__ int s_off[kHistThreads];
  __shared__ int s_warp[kHistThreads / 32];
  __shared__ int s_base, s_ovf, s_last;
  const int tid = threadIdx.x;
  const int g = tid / kHistGroup, gl = tid % kHistGroup;
  const long long first = a.index ? 0 : *a.start;
  const long long n_all =
      max(0ll, a.index ? (long long)a.count : (long long)*a.end - first);
  const long long n = n_all > a.cap ? 0 : n_all;
  const int tiles = (int)((n + kHistTileRows - 1) / kHistTileRows);
  // the blocks with a tile (block 0 at least) take part; the others
  // leave at once (a block that starts after the tail moved *start finds
  // no rows: it leaves too, unless it is block 0, which has arrived)
  const int active = max(1, min((int)gridDim.x, tiles));
  if ((int)blockIdx.x >= active) return;
  if (tid == 0) s_ovf = 0;
  for (int c = tid; c < kHistCells; c += blockDim.x) {
    s_key[c] = 0ull;
    s_lane[c] = ~0u;
  }
  __syncthreads();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long t0 = (long long)tile * kHistTileRows;
    // 1. group g keys the tile's rows g + kGroups * j, its threads over
    // the columns; thread gl = j keeps row j's key and queue index
    uint32_t hi = 0u, lo = 0u;
    long long r = 0;
    bool have = false;
#pragma unroll
    for (int j = 0; j < kHistPasses; ++j) {
      const long long i = t0 + g + kGroups * j;
      uint32_t h1 = 0u, h2 = 0u;
      long long rj = 0;
      if (i < n) {
        rj = a.index ? a.index[i] : first + i;
        const uint32_t* p = a.q + rj * a.qstride + a.hoff;
        for (int c = gl; c < a.hwidth; c += kHistGroup) {
          const uint32_t x = p[c] ^ fmix32((uint32_t)(c + 1) * kGolden);
          h1 ^= fmix32(x * kC1_1);
          h2 ^= fmix32(x * kC1_2);
        }
      }
#pragma unroll
      for (int o = kHistGroup / 2; o > 0; o >>= 1) {
        h1 ^= __shfl_xor_sync(0xFFFFFFFFu, h1, o);
        h2 ^= __shfl_xor_sync(0xFFFFFFFFu, h2, o);
      }
      if (gl == j) {
        fp64_finish(h1, h2, a.hwidth, hi, lo);
        r = rj;
        have = i < n;
      }
    }
    // 2. the lookups, kHistPasses threads of each group at once
    bool absent = false;
    if (have) {
      const int st = probe_find(a.keys, a.n_buckets, hi, lo, a.max_rounds);
      if (st == LOOKUP_OVF) s_ovf = 1;
      absent = st == ABSENT;
    }
    if (gl < kHistPasses) {
      const int o = g + kGroups * gl;
      s_tabs[o] = absent;
      s_tkey[o] = ((unsigned long long)hi << 32) | lo;
      s_trow[o] = (int)r;
    }
    __syncthreads();
    // 3. the tile's lowest absent row of each key (s_key/s_lane: at most
    // half their cells taken), in row order into the tile's range
    uint32_t cell = ~0u;
    if (tid < kHistTileRows && s_tabs[tid]) {
      const unsigned long long key = s_tkey[tid];
      const uint32_t khi = (uint32_t)(key >> 32), klo = (uint32_t)key;
      uint32_t c = (klo ^ (khi * kPhi)) & (uint32_t)(kHistCells - 1);
      while (true) {
        const unsigned long long prev = atomicCAS(&s_key[c], 0ull, key);
        if (prev == 0ull || prev == key) break;
        c = (c + 1) & (uint32_t)(kHistCells - 1);
      }
      atomicMin(&s_lane[c], (uint32_t)tid);
      cell = c;
    }
    __syncthreads();
    const bool take = cell != ~0u && s_lane[cell] == (uint32_t)tid;
    int count;
    const int at = block_scan(take ? 1 : 0, s_warp, count);
    if (take) {
      a.akey[t0 + at] = s_tkey[tid];
      a.arow[t0 + at] = s_trow[tid];
    }
    if (tid == 0) a.tile_n[tile] = count;
    if (cell != ~0u) {  // clear the cells for the next tile
      s_key[cell] = 0ull;
      s_lane[cell] = ~0u;
    }
    __syncthreads();  // s_t* and the cells are the next tile's
  }
  // arrive (every thread's scratch writes fenced first); the last block
  // goes on
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    if (s_ovf) atomicOr(&a.ctl[1], 1);
    __threadfence();
    s_last = atomicAdd(&a.ctl[0], 1) == active - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the tail: the absent rows of kHistThreads tiles at a time, in row
  // order (tile by tile, each tile's in order), kHistThreads per batch
  for (int c = tid; c < kHistCells; c += blockDim.x) {
    s_key[c] = 0ull;
    s_lane[c] = ~0u;
  }
  if (tid == 0) {
    s_base = *a.h_n;
    s_ovf = n_all > a.cap || __ldcg(&a.ctl[1]) != 0;
  }
  __syncthreads();
  for (int tg = 0; tg < tiles; tg += kHistThreads) {
    const int nt = min(kHistThreads, tiles - tg);
    int total;
    s_off[tid] = block_scan(tid < nt ? __ldcg(&a.tile_n[tg + tid]) : 0,
                            s_warp, total);
    __syncthreads();
    for (int b0 = 0; b0 < total; b0 += kHistThreads) {
      const int i = b0 + tid;
      bool fresh = i < total;
      unsigned long long key = 0ull;
      int r = 0;
      if (fresh) {
        // its tile: the last of the group whose offset is at most i
        int lo_t = 0, hi_t = nt - 1;
        while (lo_t < hi_t) {
          const int mid = (lo_t + hi_t + 1) >> 1;
          if (s_off[mid] <= i)
            lo_t = mid;
          else
            hi_t = mid - 1;
        }
        const long long e =
            (long long)(tg + lo_t) * kHistTileRows + (i - s_off[lo_t]);
        key = __ldcg(&a.akey[e]);
        r = __ldcg(&a.arow[e]);
      }
      const uint32_t khi = (uint32_t)(key >> 32), klo = (uint32_t)key;
      // the batch's lowest row of each key
      uint32_t cell = ~0u;
      if (fresh) {
        uint32_t c = (klo ^ (khi * kPhi)) & (uint32_t)(kHistCells - 1);
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
        const int st = probe_claim(a.keys, a.n_buckets, khi, klo,
                                   a.max_rounds, &slot, &rounds);
        if (st == PROBE_OVF) s_ovf = 1;
        // a duplicate: an earlier batch's row of the key claimed it
        win = st == PROBE_CLAIMED;
      }
      int won;
      const int excl = block_scan(win ? 1 : 0, s_warp, won);
      if (win && a.hidx) a.hidx[s_base + excl] = r;
      if (cell != ~0u) {  // clear the batch's cells for the next one
        s_key[cell] = 0ull;
        s_lane[cell] = ~0u;
      }
      __syncthreads();
      if (tid == 0 && a.hidx) s_base += won;
      __syncthreads();
    }
  }
  if (tid == 0) {
    *a.h_n = s_base;
    if (s_ovf) {
      *a.ovf = 1;
      if (a.gate) a.gate[G_SIZE] = 0;
    }
    if (!a.index) *a.start = (int)(first + n_all);
    a.ctl[0] = 0;
    a.ctl[1] = 0;
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

// K8 over a->blocks blocks (the last to arrive appends in row order).
// Returns cudaGetLastError() of the launch.
int srt_history(const HistArgs* a) {
  if (a->hwidth < 1 || a->n_buckets < 1 ||
      (a->n_buckets & (a->n_buckets - 1)) || a->max_rounds < 1 ||
      a->h_n == nullptr || a->ovf == nullptr || a->tile_n == nullptr ||
      a->akey == nullptr || a->arow == nullptr || a->ctl == nullptr ||
      a->cap < 0 || a->blocks < 1 ||
      (a->index == nullptr && (a->start == nullptr || a->end == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(a->stream);
  history_kernel<<<a->blocks, kHistThreads, 0, st>>>(*a);
  return (int)cudaGetLastError();
}

// K8's rows per tile (ops/_cuda.py HIST_TILE_ROWS mirrors it).
int srt_hist_tile_rows() { return kHistTileRows; }

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
