// The staged BFS step on Hopper: the kernels between K1 (the expand
// kernel, launched alone: fused_step.cu srt_expand_<model>) and K4 (the
// flat insert) and after it.
//
// Replaces what the JAX package's staged chunk step computes in XLA (no
// pallas_call), stateright_tpu/checker/device_loop.py make_step (:384),
// which it runs for tpu_options(fused=False) and for sound_eventually()
// (the port refuses hint=, the per-row pick of :461-495):
//   KS1 stage_kernel        :398-495 and :510: the overflow test, the
//                           discovery candidates of the frontier
//                           (ops/expand.py discovery_candidates, :241)
//                           with node-key witnesses under sound
//                           (fold.cuh fp64_node; the JAX package's fp64_node_device,
//                           ops/hash_kernel.py:68),
//                           the stage-one compaction to kraw lanes in
//                           JAX's order (shrink_indices(cvalid, kraw),
//                           :140: the lowest kraw valid lanes, in lane
//                           order);
//   KS2 predup_kernel       :512-538: pre_dedup (ops/expand.py:122) over
//                           the kraw lanes, or under sound each lane's
//                           node key, the stage-two compaction
//                           (shrink_indices(dvalid, kfin)) and the insert
//                           mask kvalid & ~kovf;
//   KS3 staged_append_kernel :522-632: the compaction of the inserted
//                           lanes, the queue and log appends (the rows
//                           of assemble_candidates, ops/expand.py:153,
//                           with the node-key columns spliced in under
//                           sound), the cross-edge rows (:552-567), the
//                           carry update with the kovf abort, and the
//                           next iteration's gate (make_cond, :352, with
//                           the kovf and edge-log terms: step_common.cuh
//                           eval_gate).
// The chunk's start is chunk.cu's chunk_begin_kernel, whose gate has the
// same terms.
// Built with nvcc for sm_90a into its own shared library with a plain C
// interface and driven over ctypes by stateright_tpu_torch/ops/_cuda.py;
// checker/device_loop.py StagedCard captures one iteration as a CUDA
// graph: K1, KS1, KS2 and K4 of each step size (each gated on the size
// the gate picked), then KS3, then K8 (history.cu) for a model with
// host-evaluated properties.
//
// The kernels meet in these buffers (ops/staged.py StagedBuffers): src
// and rvalid (KS1: the kraw lanes of stage one), pkey (KS1: the rows'
// node keys under sound), dvalid (KS2's pre-dedup survivors), lane, khi,
// klo, kvalid (KS2: the kfin slots of stage two, their lanes, dedup keys
// and insert mask, which K4 takes; slot j at index kfin - 1 - j),
// inserted (K4, the same indices), sel (KS3: the inserted slots by
// position), arena (KS2's pre-dedup cells, 64-bit, tagged by the
// iteration), bcount (each grid's block counts), sdisc (KS1's lowest hit
// row of each property), and the control vector sctl (SC_*: KS1's valid
// lanes and kovf; KS2's survivors; KS3's last inserted slot), which KS3
// zeroes with the step's stats vector (it is zero when allocated).
//
// KS1, KS2 and KS3 are each one cooperative launch (every block resident,
// cooperative_groups' grid barrier between phases, as K4's masked insert
// has), so each runs as one node of the graph: each block counts its own
// range (rows, slots) first, and after the barrier places it at its
// prefix of the blocks' counts (bcount), its run of lanes a thread in
// order (a block-wide scan of the runs' counts, then the run written in
// order), which fixes JAX's lane order exactly: KS1, KS2 and KS3 agree
// with their plain versions lane for lane (pre_dedup included: the
// lowest stage-one position of each arena cell wins it and a lane dies
// only when that winner carries its key, as in ops/expand.py). KS2 writes stage two's slots reversed
// (slot j at index kfin - 1 - j) and KS3 reads them so: K4 marks the
// lowest index of each fresh key, so the highest slot, which is the one
// the JAX package's insert marks (its claim arena's highest token wins a
// cell, and two lanes of one key always contend for the same cell), and
// the queue and the log come out row for row as the JAX package's (the
// row gate, under sound too, where duplicates reach the table).
//
// What bounds it on this card: at PackedPaxos(3)'s 8,192-row step (16
// actions, 131,072 lanes) KS1 reads 131 KB of validity bytes, 8 KB of
// row flags and writes up to kraw = 40,960 lane indices; KS2 reads the
// kraw lanes' keys (8 B each) and writes kfin = 20,480 slots of 13 B;
// KS3 reads the kfin slots' masks and writes the inserted rows (99
// words of queue and 4 of log each, ~6 MB at 15,085 rows): bytes bound
// KS1 and KS2 at well under a microsecond and KS3 at ~2 microseconds,
// and their time is the latency of their dependent phases (scans, grid
// barriers): PERF.md times each against its bound. A single block per
// kernel is too few warps for KS3's row writes (0.94 ms at that step), so
// each kernel spreads its range over a grid.

#include "step_common.cuh"

namespace {

// the staged control vector (ops/staged.py SC_*)
// (SC_LAST: KS3's last inserted slot, for the most recent queue row)
enum Sctl {
  SC_VCOUNT = 0,
  SC_KOVF = 1,
  SC_DCOUNT = 2,
  SC_LAST = 3,
  SC_LEN
};

// KS1's, KS2's and KS3's cooperative grids: threads a block, the most
// blocks (bcount holds two words a block), the rows a block of KS1 takes
// and the slots a block of KS2 or KS3 takes (fewer blocks where fewer are
// resident at once)
constexpr int kCoopThreads = 512;
constexpr int kMaxCoopBlocks = 256;
constexpr int kCoopRows = 256;
constexpr int kCoopSlots = 1024;
// the slots a block of KS3 takes: fewer than KS2's, so that the row
// copies spread over more warps
constexpr int kAppendSlots = 256;

}  // namespace

// One staged step size (ops/staged.py StagePlan): f frontier rows, the
// kraw lanes of stage one, the kfin slots of stage two.
struct StagedPlan {
  int f, kraw, kfin;
};

// Mirrored field for field by ops/_cuda.py StagedArgs.
struct StagedArgs {
  int* ctr;                   // the counter block
  int* stats;                 // the step's stats vector (S_*)
  int* sctl;                  // [SC_LEN]
  // K1's outputs, at the large step's size (both sizes share them)
  const uint8_t* cvalid;      // [F*A]
  const uint8_t* pbits;       // [F, pcols]
  const uint8_t* terminal;    // [F]
  const uint32_t* ebits_out;  // [F]
  const uint32_t* flat;       // [F*A, W]
  const uint32_t* chi;        // [F*A] keys (canonical under symmetry)
  const uint32_t* clo;
  const uint32_t* ohi;        // [F*A] own fingerprints (6-column log)
  const uint32_t* olo;
  // the staged buffers (ops/staged.py StagedBuffers)
  int* src;                   // [kraw]
  uint8_t* rvalid;            // [kraw]
  uint8_t* dvalid;            // [kraw]
  uint32_t* pkey;             // [F, 2]
  int* lane;                  // [kfin]
  uint32_t* khi;              // [kfin]
  uint32_t* klo;
  uint8_t* kvalid;            // [kfin]
  const uint8_t* inserted;    // [kfin] (K4's)
  int* sel;                   // [kfin] KS3: the inserted slots by position
  unsigned long long* arena;  // [arena_cells] KS2's pre-dedup cells
  int* bcount;                // [2 * kMaxCoopBlocks] the grids' block counts
  unsigned int* sdisc;        // [32] KS1's lowest row of each property's
                              //      hit (all ones between steps)
  // the carry
  uint32_t* q;                // [qcap, W + 3]
  uint32_t* log;              // [logcap, log_cols]
  uint32_t* elog;             // [ecap, 4] or null
  long long qlimit;           // the most q_tail may be before a step
  long long elimit;           // the most e_n may be before a step
  int P, pcols, W, A, log_cols, stats_len, ext, recent, cch, sound;
  uint32_t always_mask, sometimes_mask, ev_mask;
  StagedPlan small;           // small.f == 0: one size
  StagedPlan large;
  void* stream;
};

namespace {

__device__ __forceinline__ StagedPlan plan_of(const StagedArgs& a,
                                              int size) {
  return size == 1 ? a.small : a.large;
}

// The exclusive prefix of each thread's count over the block, and the
// total (every thread of the block calls it; s_warp holds 32 words).
__device__ __forceinline__ int block_scan(int v, int* s_warp, int* total) {
  const int wl = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (wl >= o) incl += u;
  }
  __syncthreads();  // s_warp free from any earlier scan
  if (wl == 31) s_warp[wid] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < nw; ++w) {
    const int u = s_warp[w];
    if (w < wid) before += u;
    all += u;
  }
  *total = all;
  return before + incl - v;
}

// The contiguous run of [lo, hi) this thread of the block scans:
// [*b, *e).
__device__ __forceinline__ void run_of(long long lo, long long hi,
                                       long long* b, long long* e) {
  const long long n = max(0ll, hi - lo);
  const long long per = (n + blockDim.x - 1) / blockDim.x;
  *b = lo + min(n, (long long)threadIdx.x * per);
  *e = lo + min(n, (long long)threadIdx.x * per + per);
}

// The range [*lo, *hi) of [0, n) block b of g takes.
__device__ __forceinline__ void block_range(long long n, int b, int g,
                                            long long* lo, long long* hi) {
  const long long per = (n + g - 1) / g;
  *lo = min(n, (long long)b * per);
  *hi = min(n, *lo + per);
}

// The exclusive prefix of block b's count over the grid's (bcount, the
// g blocks'), and the total, into *before and *total (one thread).
__device__ __forceinline__ void grid_prefix(const int* bcount, int b, int g,
                                            int* before, int* total) {
  int x = 0, t = 0;
  for (int k = 0; k < g; ++k) {
    const int v = bcount[k];
    if (k < b) x += v;
    t += v;
  }
  *before = x;
  *total = t;
}

// KS1, gated on `size`: a cooperative grid (every block resident), block
// b taking the rows [b * R, (b + 1) * R). Phase 1, a thread a row: its
// valid lanes, under sound its node key (pkey, from the queue row's
// cached fingerprint and its at-enqueue eventually-bits), and its
// discovery candidates (the ALWAYS/SOMETIMES properties among the take
// pending rows, the EVENTUALLY ones on a terminal row with the bit
// pending: the lowest row of each property, by one atomicMin a warp into
// sdisc); the block's valid lanes into bcount. Phase 2, after the grid's
// barrier: the block's lanes in lane order at its prefix of the grid's
// counts into src (a run a thread: count, block scan, write), the lanes
// past kraw dropped, and rvalid (and the empty slots of src) over the
// block's share of the kraw slots; block 0 writes vcount and kovf to
// sctl and the discovery registers to the stats vector (witnesses: the
// rows' node keys under sound, else their cached fingerprints), and
// leaves sdisc empty for the next step.
__global__ void __launch_bounds__(kCoopThreads)
    stage_kernel(StagedArgs a, int size) {
  const int* g = a.ctr + a.ext + E_GATE;
  if (g[G_SIZE] != size) return;  // the whole grid: no barrier reached
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  __shared__ int s_warp[32];
  __shared__ int s_before, s_total;
  const StagedPlan pl = plan_of(a, size);
  const int head = g[G_HEAD], take = g[G_TAKE];
  const int F = pl.f, A = a.A, kraw = pl.kraw;
  const int qc = a.W + 3;
  const int tid = threadIdx.x, nt = blockDim.x, nb = gridDim.x;
  const int bk = blockIdx.x;
  long long r0, r1;
  block_range(F, bk, nb, &r0, &r1);
  int nvalid = 0;
  uint32_t found = 0;  // the properties this thread has hit
  for (long long rr = r0 + tid; rr < r1; rr += nt) {
    const int r = (int)rr;
    const uint32_t* qr = a.q + (long long)(head + r) * qc;
    const uint8_t* cv = a.cvalid + (long long)r * A;
    for (int k = 0; k < A; ++k) nvalid += cv[k] != 0;
    if (a.sound) {
      uint32_t nhi, nlo;
      fp64_node(qr[a.W + 1], qr[a.W + 2], qr[a.W], nhi, nlo);
      a.pkey[2 * r] = nhi;
      a.pkey[2 * r + 1] = nlo;
    }
    uint32_t hits = 0;
    if (r < take) {
      uint32_t pb = 0;
      for (int p = 0; p < a.P; ++p)
        if (a.pbits[(long long)r * a.pcols + p]) pb |= 1u << p;
      hits |= (~pb & a.always_mask) | (pb & a.sometimes_mask);
    }
    if (a.terminal[r]) {
      const uint32_t eb = a.ebits_out[r];
      if (eb != 0u) hits |= eb & a.ev_mask;
    }
    // a thread's rows rise, so its first hit of a property is its
    // lowest; the warp's is its lowest lane's (its rows are the warp's
    // consecutive ones): one atomic a warp and property
    const uint32_t fresh = hits & ~found;
    found |= hits;
    const unsigned act = __activemask();
    uint32_t any = __reduce_or_sync(act, fresh);
    while (any) {
      const int p = __ffs(any) - 1;
      any &= any - 1;
      const unsigned m = __ballot_sync(act, (fresh >> p) & 1u);
      if ((int)(threadIdx.x & 31) == __ffs(m) - 1)
        atomicMin(&a.sdisc[p], (unsigned int)r);
    }
  }
  int bsum;
  block_scan(nvalid, s_warp, &bsum);
  if (tid == 0) a.bcount[bk] = bsum;
  grid.sync();
  if (tid == 0) grid_prefix(a.bcount, bk, nb, &s_before, &s_total);
  __syncthreads();
  const int total = s_total;
  {
    // the block's lanes in lane order, the lanes past kraw dropped
    long long b, e;
    run_of(r0 * A, r1 * A, &b, &e);
    int cnt = 0;
    for (long long l = b; l < e; ++l) cnt += a.cvalid[l] != 0;
    int tot;
    int pos = s_before + block_scan(cnt, s_warp, &tot);
    for (long long l = b; l < e && pos < kraw; ++l)
      if (a.cvalid[l]) a.src[pos++] = (int)l;
    long long j0, j1;
    block_range(kraw, bk, nb, &j0, &j1);
    for (long long j = j0 + tid; j < j1; j += nt) {
      if (j >= total) a.src[j] = 0;
      a.rvalid[j] = j < total;
    }
  }
  if (bk != 0) return;
  if (tid == 0) {
    a.sctl[SC_VCOUNT] = total;
    a.sctl[SC_KOVF] = total > kraw;
  }
  if (tid < a.P) {
    const int p = tid;
    const unsigned int r = a.sdisc[p];
    const bool hit = r != 0xFFFFFFFFu;
    uint32_t whi = 0u, wlo = 0u;
    if (hit) {
      const uint32_t* qr = a.q + (long long)(head + (int)r) * qc;
      if (a.sound)
        fp64_node(qr[a.W + 1], qr[a.W + 2], qr[a.W], whi, wlo);
      else
        whi = qr[a.W + 1], wlo = qr[a.W + 2];
    }
    a.stats[S_DISC + p] = hit ? 1 : 0;
    a.stats[S_DISC + a.P + p] = (int)whi;
    a.stats[S_DISC + 2 * a.P + p] = (int)wlo;
    a.sdisc[p] = 0xFFFFFFFFu;
  }
}

// KS2, gated on `size`: a cooperative grid, block b taking the kraw
// slots [b * S, (b + 1) * S) of stage one. Without sound, pre_dedup:
// phase 1, each valid slot j posts (~tag) << 32 | j to its arena cell
// (its key's hash over the arena, ops/staged.py pre_dedup_arena_cells)
// by a 64-bit atomicMin, the tag the iteration's (the gate's): an older
// iteration's word is larger, so the arena needs no clearing (it starts
// all ones); phase 2, after the grid's barrier, a slot dies when its
// cell's winner (the lowest slot posting there) carries its key. Under
// sound each valid slot survives with its node key (its key and its
// row's cleared eventually-bits). The block's survivors go to bcount;
// phase 3, after the grid's barrier: when kfin < kraw the survivors in
// slot order at the block's prefix of the grid's counts to the first
// kfin slots of stage two (a run a thread), else slot for slot; kvalid =
// survivor and no overflow (kovf: KS1's, or more survivors than kfin).
// Stage two's slot j lies at index kfin - 1 - j (the slots reversed: K4
// marks the lowest index of each fresh key, so the highest slot, as the
// JAX package's insert does). Block 0 writes dcount and kovf to sctl.
__global__ void __launch_bounds__(kCoopThreads)
    predup_kernel(StagedArgs a, int size, int cells) {
  const int* g = a.ctr + a.ext + E_GATE;
  if (g[G_SIZE] != size) return;  // the whole grid: no barrier reached
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  __shared__ int s_warp[32];
  __shared__ int s_before, s_total;
  const StagedPlan pl = plan_of(a, size);
  const int kraw = pl.kraw, kfin = pl.kfin, A = a.A;
  const int tid = threadIdx.x, nt = blockDim.x, nb = gridDim.x;
  const int bk = blockIdx.x;
  const uint32_t cmask = (uint32_t)cells - 1u;
  const unsigned long long tag =
      (unsigned long long)(~(uint32_t)g[G_TAG]) << 32;
  const bool kovf1 = a.sctl[SC_KOVF] != 0;  // KS1's: block 0 writes it
  long long s0, s1;
  block_range(kraw, bk, nb, &s0, &s1);
  if (!a.sound)
    for (long long j = s0 + tid; j < s1; j += nt)
      if (a.rvalid[j]) {
        const int l = a.src[j];
        atomicMin(&a.arena[(a.clo[l] ^ (a.chi[l] * kPhi)) & cmask],
                  tag | (unsigned long long)j);
      }
  grid.sync();
  long long b, e;
  run_of(s0, s1, &b, &e);
  int nd = 0;
  for (long long j = b; j < e; ++j) {
    bool dv = a.rvalid[j];
    if (dv && !a.sound) {
      const int l = a.src[j];
      const uint32_t hi = a.chi[l], lo = a.clo[l];
      const unsigned long long w = a.arena[(lo ^ (hi * kPhi)) & cmask];
      const int win = min((int)(uint32_t)w, kraw - 1);
      const int wl = a.src[win];
      dv = win == (int)j || a.chi[wl] != hi || a.clo[wl] != lo;
    }
    a.dvalid[j] = dv;
    nd += dv;
  }
  int bsum;
  block_scan(nd, s_warp, &bsum);
  if (tid == 0) a.bcount[bk] = bsum;
  grid.sync();
  if (tid == 0) grid_prefix(a.bcount, bk, nb, &s_before, &s_total);
  __syncthreads();
  const int dcount = s_total;
  const bool kovf = kovf1 || dcount > kfin;
  // slot j's lane and dedup key, written to slot `pos` of stage two at
  // index kfin - 1 - pos
  auto put = [&](long long j, int pos, bool valid) {
    const int l = a.src[j];
    const int at = kfin - 1 - pos;
    uint32_t hi = a.chi[l], lo = a.clo[l];
    if (a.sound) fp64_node(hi, lo, a.ebits_out[l / A], hi, lo);
    a.lane[at] = l;
    a.khi[at] = hi;
    a.klo[at] = lo;
    a.kvalid[at] = valid && !kovf;
  };
  if (kfin < kraw) {
    int cnt = 0;
    for (long long j = b; j < e; ++j) cnt += a.dvalid[j] != 0;
    int tot;
    int pos = s_before + block_scan(cnt, s_warp, &tot);
    for (long long j = b; j < e && pos < kfin; ++j)
      if (a.dvalid[j]) put(j, pos++, true);
    long long k0, k1;
    block_range(kfin, bk, nb, &k0, &k1);
    for (long long j = k0 + tid; j < k1; j += nt)
      if (j >= dcount) a.kvalid[kfin - 1 - j] = 0;
  } else {
    for (long long j = s0 + tid; j < s1; j += nt)
      put(j, (int)j, a.dvalid[j] != 0);
  }
  if (bk == 0 && tid == 0) {
    a.sctl[SC_DCOUNT] = dcount;
    a.sctl[SC_KOVF] = kovf;
  }
}

// KS3, after K4, on the step the gate picked: a cooperative grid, block
// b taking the kfin slots [b * S, (b + 1) * S) of stage two (slot j at
// index kfin - 1 - j of KS2's and K4's buffers: KS2 reversed them).
// Phase 1, a run of slots a thread: the inserted slots (K4's marks) and,
// under sound with an edge log, the cross edges (kvalid, not inserted,
// the child's eventually-bits pending) counted, the block's counts into
// bcount. Phase 2, after the grid's barrier, at the block's prefixes of
// the grid's counts: each inserted slot's index into sel at its
// position in slot order, each cross edge's row (its row's node key and
// the child's) at e_n + its position; then, after a block barrier, a
// warp per row of the block's positions writes the queue row (the
// child's words, its row's cleared eventually-bits, its key) at the
// gate's tail and the log row (its dedup key, its parent's — the row's
// node key under sound, else the queue row's cached fingerprint — and on
// a 6-column log its own fingerprint) at the gate's log length; the last
// position's slot goes to sctl. Phase 3, after the grid's barrier (every
// block has read the gate), block 0 updates the carry (kovf: nothing
// committed — q_head and gen unmoved; the flags, maxima and counters as
// device_loop.py make_step's), merges the discovery registers, writes
// the most recent queue row and the next gate; the counter block goes
// back, the stats and control vectors zeroed.
__global__ void __launch_bounds__(kCoopThreads)
    staged_append_kernel(StagedArgs a) {
  const int* gt = a.ctr + a.ext + E_GATE;
  const int size = gt[G_SIZE];
  if (size == 0) return;  // the whole grid: nothing changes
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  __shared__ int s_ctr[kMaxCtr], s_st[kMaxStats], s_sc[SC_LEN];
  __shared__ int s_warp[32];
  __shared__ int s_bi, s_be, s_cnt, s_ecnt;
  const int tid = threadIdx.x, nt = blockDim.x, nb = gridDim.x;
  const int bk = blockIdx.x;
  const StagedPlan pl = plan_of(a, size);
  const int head = gt[G_HEAD], take = gt[G_TAKE];
  const int qbase = gt[G_QBASE], lbase = gt[G_LBASE];
  const int e_n = a.ctr[B_E_N];
  const int kfin = pl.kfin, A = a.A, W = a.W, qc = W + 3;
  const bool edges = a.sound && a.elog != nullptr;
  long long s0, s1, b, e;
  block_range(kfin, bk, nb, &s0, &s1);
  run_of(s0, s1, &b, &e);
  int ci = 0, ce = 0;
  for (long long j = b; j < e; ++j) {
    const int at = kfin - 1 - (int)j;
    if (a.inserted[at]) {
      ++ci;
    } else if (edges && a.kvalid[at] &&
               a.ebits_out[a.lane[at] / A] != 0u) {
      ++ce;
    }
  }
  int bi, be;
  int pos = block_scan(ci, s_warp, &bi);
  int epos = block_scan(ce, s_warp, &be);
  if (tid == 0) {
    a.bcount[2 * bk] = bi;
    a.bcount[2 * bk + 1] = be;
  }
  grid.sync();
  if (tid == 0) {
    int xi = 0, xe = 0, ti = 0, te = 0;
    for (int k = 0; k < nb; ++k) {
      const int vi = a.bcount[2 * k], ve = a.bcount[2 * k + 1];
      if (k < bk) xi += vi, xe += ve;
      ti += vi;
      te += ve;
    }
    s_bi = xi, s_be = xe, s_cnt = ti, s_ecnt = te;
  }
  __syncthreads();
  const int cnt = s_cnt, ecnt = s_ecnt, base = s_bi;
  pos += base;
  epos += s_be;
  if (ci || ce) {
    for (long long j = b; j < e; ++j) {
      const int at = kfin - 1 - (int)j;
      if (a.inserted[at]) {
        a.sel[pos] = at;
        if (pos == cnt - 1) a.sctl[SC_LAST] = at;
        ++pos;
      } else if (edges && a.kvalid[at]) {
        const int r = a.lane[at] / A;
        if (a.ebits_out[r] != 0u) {
          uint32_t* er = a.elog + (long long)(e_n + epos++) * 4;
          er[0] = a.pkey[2 * r];
          er[1] = a.pkey[2 * r + 1];
          er[2] = a.khi[at];
          er[3] = a.klo[at];
        }
      }
    }
  }
  __syncthreads();  // sel, by this block's threads
  const int wl = tid & 31, wid = tid >> 5, nw = nt >> 5;
  for (int i = base + wid; i < base + bi; i += nw) {
    const int j = a.sel[i];
    const long long l = a.lane[j];
    const int r = (int)(l / A);
    const uint32_t* src = a.flat + l * W;
    uint32_t* dq = a.q + (long long)(qbase + i) * qc;
    for (int c = wl; c < qc; c += 32)
      dq[c] = c < W ? src[c] : c == W ? a.ebits_out[r]
                             : c == W + 1 ? a.chi[l] : a.clo[l];
    if (wl < a.log_cols) {
      uint32_t v;
      switch (wl) {
        case 0: v = a.sound ? a.khi[j] : a.chi[l]; break;
        case 1: v = a.sound ? a.klo[j] : a.clo[l]; break;
        case 2:
          v = a.sound ? a.pkey[2 * r]
                      : a.q[(long long)(head + r) * qc + W + 1];
          break;
        case 3:
          v = a.sound ? a.pkey[2 * r + 1]
                      : a.q[(long long)(head + r) * qc + W + 2];
          break;
        case 4: v = a.ohi[l]; break;
        default: v = a.olo[l]; break;
      }
      a.log[(long long)(lbase + i) * a.log_cols + wl] = v;
    }
  }
  grid.sync();
  if (bk != 0) return;
  const int len = a.ext + E_GATE + G_LEN;
  for (int i = tid; i < len; i += nt) s_ctr[i] = a.ctr[i];
  for (int i = tid; i < a.stats_len; i += nt) s_st[i] = a.stats[i];
  if (tid < SC_LEN) s_sc[tid] = a.sctl[tid];
  __syncthreads();
  if (tid == 0) {
    int* c = s_ctr;
    int* x = s_ctr + a.ext;
    const bool kovf = s_sc[SC_KOVF] != 0;
    const int valid = s_st[S_VALID], dcount = s_sc[SC_DCOUNT];
    c[B_Q_HEAD] = head + (kovf ? 0 : take);
    c[B_Q_TAIL] = qbase + cnt;
    c[B_LOG_N] = lbase + cnt;
    c[B_GEN] += kovf ? 0 : valid;
    c[B_OVF] |= (s_st[S_OVF] != 0 && !kovf);
    c[B_XOVF] |= s_st[S_XOVF] != 0;
    c[B_KOVF] |= kovf;
    c[B_E_N] += ecnt;
    x[E_FAULT] |= (s_st[S_FAULT] != 0) | (s_sc[SC_VCOUNT] != valid);
    c[B_VMAX] = max(c[B_VMAX], valid);
    c[B_DMAX] = max(c[B_DMAX], dcount);
    if (!kovf) {
      c[B_PDH] += valid - dcount;
      c[B_PRB] += s_st[S_ROUNDS];
    }
    const int P = a.P;
    for (int p = 0; p < P; ++p)
      if (!c[B_DISC + p] && s_st[S_DISC + p]) {  // the sticky first hit
        c[B_DISC + p] = 1;
        c[B_DISC + P + p] = s_st[S_DISC + P + p];
        c[B_DISC + 2 * P + p] = s_st[S_DISC + 2 * P + p];
      }
    x[E_STEPS] -= 1;
    x[E_TAG] += 1;
    x[E_ITERS] += 1;
    x[E_SMALL] += size == 1;
  }
  if (cnt > 0) {  // the most recent queue row: the last inserted slot's
    const long long l = a.lane[s_sc[SC_LAST]];
    const int r = (int)(l / A);
    for (int k = tid; k < qc; k += nt)
      s_ctr[a.recent + k] =
          (int)(k < W ? a.flat[l * W + k]
                      : k == W ? a.ebits_out[r]
                               : k == W + 1 ? a.chi[l] : a.clo[l]);
  }
  __syncthreads();
  if (tid == 0)
    eval_gate(GateLimits{a.qlimit, a.small.f, a.large.f}, s_ctr, a.ext, a.P,
              a.elimit);
  __syncthreads();
  for (int i = tid; i < len; i += nt) a.ctr[i] = s_ctr[i];
  for (int i = tid; i < a.stats_len; i += nt) a.stats[i] = 0;
  if (tid < SC_LEN) a.sctl[tid] = 0;
}

// A cooperative launch of `kernel` (KS1, KS2, KS3) over at most `want`
// blocks of kCoopThreads, capped at the blocks resident at once and at
// kMaxCoopBlocks (the bcount entries), at least one.
template <class K>
int coop_launch(K kernel, long long want, void** params,
                cudaStream_t st) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kCoopThreads, 0);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long grid =
      max(1ll, min(want, min((long long)per_sm * sms,
                             (long long)kMaxCoopBlocks)));
  e = cudaLaunchCooperativeKernel((const void*)kernel, (int)grid,
                                  kCoopThreads, params, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool args_ok(const StagedArgs& a) {
  const StagedPlan& s = a.small;
  const StagedPlan& l = a.large;
  return a.W >= 1 && a.A >= 1 && a.P >= 0 && a.P <= 31 &&
         (a.log_cols == 4 || a.log_cols == 6) &&
         a.ext + E_GATE + G_LEN <= kMaxCtr && a.stats_len <= kMaxStats &&
         a.recent + a.W + 3 <= a.ext && l.f >= 1 && l.kraw >= 1 &&
         l.kfin >= 1 && l.kfin <= l.kraw && s.f >= 0 && s.f <= l.f &&
         s.kraw <= l.kraw && s.kfin <= l.kfin && s.kfin <= s.kraw &&
         (long long)l.f * a.A < (1ll << 31);
}

}  // namespace

extern "C" {

// Each entry launches on a->stream and returns cudaGetLastError() of its
// launch (0 = launched); the caller raises on anything else.

// KS1 of step size `size` (1 small, 2 large): a block for each
// kCoopRows rows.
int srt_stage(const StagedArgs* a, int size) {
  if (!args_ok(*a) || (size != 1 && size != 2) ||
      (size == 1 && a->small.f == 0))
    return (int)cudaErrorInvalidValue;
  const StagedPlan& p = size == 1 ? a->small : a->large;
  StagedArgs copy = *a;
  void* params[] = {&copy, &size};
  return coop_launch(stage_kernel, (p.f + kCoopRows - 1) / kCoopRows, params,
                     static_cast<cudaStream_t>(a->stream));
}

// KS2 of step size `size` over an arena of `cells` 64-bit cells (a power
// of two, at least 2 * kraw - 1; all ones when allocated): a block for
// each kCoopSlots slots of stage one.
int srt_predup(const StagedArgs* a, int size, int cells) {
  if (!args_ok(*a) || (size != 1 && size != 2) ||
      (size == 1 && a->small.f == 0) || cells < 1 || (cells & (cells - 1)))
    return (int)cudaErrorInvalidValue;
  const StagedPlan& p = size == 1 ? a->small : a->large;
  if ((long long)cells < 2ll * p.kraw - 1) return (int)cudaErrorInvalidValue;
  StagedArgs copy = *a;
  void* params[] = {&copy, &size, &cells};
  return coop_launch(predup_kernel, (p.kraw + kCoopSlots - 1) / kCoopSlots,
                     params, static_cast<cudaStream_t>(a->stream));
}

// KS3 of the step the gate picked: a block for each kAppendSlots of the
// large step's kfin slots (the small step's fewer slots spread over the
// same grid).
int srt_staged_append(const StagedArgs* a) {
  if (!args_ok(*a) || (a->log_cols == 6 && !a->ohi))
    return (int)cudaErrorInvalidValue;
  StagedArgs copy = *a;
  void* params[] = {&copy};
  return coop_launch(staged_append_kernel,
                     (a->large.kfin + kAppendSlots - 1) / kAppendSlots,
                     params, static_cast<cudaStream_t>(a->stream));
}

// Bytes of the argument struct, checked by the Python binding.
int srt_staged_args_size() { return (int)sizeof(StagedArgs); }

}  // extern "C"
