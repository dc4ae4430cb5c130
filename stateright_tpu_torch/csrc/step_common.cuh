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

#include "fold.cuh"

namespace {

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
  // A wide model's K1 (WideRow) is launched over wide instead, with
  // wide_smem bytes of dynamic shared memory (ops/_cuda.py
  // wide_geometry, wide_smem_bytes); the other models leave them unused.
  TileGeometry wide;
  long long wide_smem;
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

// The column keys fmix32((i + 1) * kGolden) of fp64 for columns i <
// kColumnKeys, for a wide model's words, whose column indices are
// runtime values: a lane would compute the key again for every word, and
// a table in shared memory would be read behind the staging row's
// stores, which may alias it; a constant table does not.
// (tests/test_torch_paxos_geometry.py holds it to fingerprint.py.)
constexpr int kColumnKeys = 128;
__constant__ uint32_t kColumnKey[kColumnKeys] = {
    0x92CA2F0Eu, 0x3CD6E3F3u, 0x1B147DCCu, 0x4C081DBFu, 0x487981ABu,
    0xDB408C9Du, 0x78BC1B8Fu, 0xD83072E5u, 0x65CBDD54u, 0x1F4B8CEFu,
    0x91783BB0u, 0x0231739Bu, 0x2AA96DD0u, 0xB42BC0B0u, 0x04E90BF5u,
    0xE2AD51BAu, 0x79F70494u, 0x010B6880u, 0xA4523835u, 0xCEEB36B7u,
    0xD939FF68u, 0xB18C6441u, 0xDD507B42u, 0x5DB59265u, 0x33469494u,
    0xA65D9B7Au, 0x57DCB96Bu, 0x1B486183u, 0xE411DDC1u, 0x3E2CF241u,
    0x9E2EA24Fu, 0xB7FBE3E5u, 0xA452933Au, 0x1E712332u, 0x52DF2E19u,
    0x336BD315u, 0x56D396D2u, 0xF857A331u, 0x4FE97DA7u, 0x9B972A46u,
    0x9D3E0D8Au, 0xA6ECE606u, 0xC5C7990Cu, 0x17D886BFu, 0x62CE7C21u,
    0x827E3843u, 0xB9D7427Cu, 0x17891EA1u, 0xD0F0E17Au, 0x5139A741u,
    0xA3D32F02u, 0xDB12A15Cu, 0x13B3ABCFu, 0x730C5F25u, 0x1DB71420u,
    0xF9435A88u, 0x51EE6AF8u, 0xAF1EA67Fu, 0x71D9CB92u, 0x3E2C1C4Eu,
    0x1D6722CFu, 0xF9D656F3u, 0x2F16C17Eu, 0xF8262992u, 0x8E0CE9DFu,
    0xAE71F440u, 0x578EC0A1u, 0xFF95D72Eu, 0x09B28281u, 0xAF7E56B5u,
    0x535A0944u, 0xB7E2D8D3u, 0xF5E7B311u, 0x974B2094u, 0xC73099C2u,
    0xB361D660u, 0x171C8432u, 0x7263CAD3u, 0xC661216Eu, 0xB1A0EBCAu,
    0x6B48AA35u, 0x6ED7A14Au, 0xE1FEF49Fu, 0x86A1C4E4u, 0xF918B5F7u,
    0x8A927E91u, 0xCB840F04u, 0xEDDFC8E4u, 0xC6A57EEAu, 0x52FB3D10u,
    0xA57C5997u, 0x2B1613BCu, 0x8A6D276Du, 0x0207F551u, 0xE7A5E850u,
    0x13CEA631u, 0x1E8C037Eu, 0xF2EBE3A2u, 0xEE6E1AC7u, 0x45516E65u,
    0xF23F1FC4u, 0x40F455EBu, 0xDC72791Bu, 0xFC0DF56Du, 0xB81049B8u,
    0x68F4A814u, 0x7740174Du, 0x8FD60C81u, 0x59D7D340u, 0xF20F0D94u,
    0xB28913B6u, 0x5B53B292u, 0x85F6B629u, 0xF4E7D086u, 0x8D4F664Du,
    0x5DEAC120u, 0xE12DE03Bu, 0x180E3AC5u, 0x53B4B547u, 0x95236D9Eu,
    0xD640B398u, 0x121A5DE7u, 0x00D4705Eu, 0xF3ADADE7u, 0x394B58D3u,
    0x0846CD67u, 0x263FC0DCu, 0x7740D790u};

// A wide model's child row (kWideRow below): put(i, v) stores word i at
// dst[i] (the thread's staging row in shared memory, which K1 copies to
// flat with the warp's other children) and folds it into the
// fingerprint as fp64 does, so the child is never held whole in
// registers; finish() gives fp64 of the width words put. The words may
// come in any order (the fold is an XOR).
struct RowOut {
  uint32_t* dst;
  uint32_t h1 = 0u, h2 = 0u;

  __device__ explicit RowOut(uint32_t* d) : dst(d) {}

  __device__ __forceinline__ void put(int i, uint32_t v) {
    dst[i] = v;
    const uint32_t x = v ^ kColumnKey[i];
    h1 ^= fmix32(x * kC1_1);
    h2 ^= fmix32(x * kC1_2);
  }

  __device__ __forceinline__ void finish(int width, uint32_t& hi,
                                         uint32_t& lo) const {
    fp64_finish(h1, h2, width, hi, lo);
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
// rows into shared memory cooperatively and calls m.props_row(row),
// m.quiet_from(row) (the first action lane from which every lane's child
// is the row itself, invalid and not overflowing: K1 copies the row to
// those lanes with the row's fingerprint) and, for the lanes before it,
// m.step_row(row, act, out, ovf) on the shared copy, the child going to
// the thread's staging row through a RowOut; each warp then writes its
// children to flat with coalesced (16-byte where the width allows)
// stores. Models
// without the member (every other) compile to K1 as it was.
template <class M, class = void>
struct WideRow : std::false_type {};
template <class M>
struct WideRow<M, std::void_t<decltype(M::kWideRow)>>
    : std::integral_constant<bool, M::kWideRow> {};

// Whether M is an edit model (M::kEditRow): a row too wide to stage each
// child in shared memory (ABD on the ordered network: up to 352 words),
// whose lane's child is the row plus a short edit (M::Edit: the words
// the lane's action changes and the columns they land in). K1 keeps the
// tile's rows in shared memory as for a wide model (loaded block-wide,
// kEditLoads words in flight a thread), with each row's fingerprint
// folds, and steps the lanes of m.active_lanes(row) (a mask of at most
// 32 lanes) densely, a thread each: m.edit_lane(row, act, ed, ovf)
// writes the lane's edit to the thread's slot in shared memory. After a
// barrier the block's warps share the children, child c of the pass by
// warp c % nwarps: the warp reads the edit's columns into registers
// once (m.edit_head(ed)) and writes the child's words 32 consecutive
// ones a store (m.child_word(row, ed, head, k, old)); a lane whose word
// differs from the row's folds the old word out and the new one in
// (fold.cuh fold_change), so the child's fingerprint is the row's folds
// with its changed columns refolded, XOR-reduced over the warp and
// finished. The other lanes are invalid and do not overflow (the
// model's rule): they get the row's fingerprint and cvalid = 0, and
// their rows of flat are not written.
template <class M, class = void>
struct EditRow : std::false_type {};
template <class M>
struct EditRow<M, std::void_t<decltype(M::kEditRow)>>
    : std::integral_constant<bool, M::kEditRow> {};

// Whether M is a group model (M::kGroupRow): a register model on the
// unordered network (ABD, the single-copy register), whose rows K1 keeps
// in shared memory as for a wide model, with their quiet lanes
// (m.quiet_from), and whose children it builds a half-warp each
// (WarpGroup below): m.step_group(row, act, g, dst, ovf, hi, lo)
// (actor_net.cuh register_step_group), the network in the group's
// lanes, the child's words written straight to its row of flat (16
// consecutive words a store; slot j's four by lane j), each lane
// folding its own, the folds XOR-reduced over the group. A quiet lane
// gets the row's fingerprint and cvalid = 0, and its row of flat is not
// written. There is no staging row and no barrier between children: a
// group's child is its own. A group model's K1 steps only the pending
// rows, which a gated launch spreads over its grid (pending_span below).
template <class M, class = void>
struct GroupRow : std::false_type {};
template <class M>
struct GroupRow<M, std::void_t<decltype(M::kGroupRow)>>
    : std::integral_constant<bool, M::kGroupRow> {};

// Whether a wide or group model has crash/restart lanes (M::kCrash:
// PaxosCrashModel, WriteOnceModel; actor_net.cuh CrashSpec): its active
// lanes are no quiet tail but a mask (at most 32 lanes: the deliveries
// before the network's zero tail to a recipient that is up, the crash
// lanes of the actors that may crash, the restart lanes of the down
// ones), taken with the row's property bits by a warp per row, a lane a
// network slot (m.row_lanes), and listed deliveries first, then the
// crash and restart lanes (nact[1]: the deliveries). K1 keeps each
// row's fingerprint folds, as for an edit model: a crash or restart
// child is the row with one to three words changed, whose edit and
// fingerprint (the row's folds with those words refolded) a thread
// takes (m.crash_child) and whose words the block's warps, or groups,
// write from the shared row (m.crash_write). The wide model stages each
// delivery as before; the group model builds each active lane's child in
// two phases (m.deliver_scalar or m.crash_child by a thread into its
// slot, then m.deliver_group or m.crash_write by a group). Every other
// lane gets the row's fingerprint and cvalid = 0, and its row of flat is
// not written. A group model's delivery lanes, not its crash lanes, are
// its group's network slots (the launch refuses more than kGroupLanes of
// them).
template <class M, class = void>
struct CrashLanes : std::false_type {};
template <class M>
struct CrashLanes<M, std::void_t<decltype(M::kCrash)>>
    : std::integral_constant<bool, M::kCrash> {};

// Whether a wide model has the lossy drop lanes (M::kLossy:
// PaxosLossyModel, ping_pong.cuh PingPongLossyModel; actor_net.cuh
// DropEdit): lanes [E, 2E) drop slot lane - E. Its active lanes are a
// mask, as with crash lanes (at most 32 lanes: the deliveries and the
// drops of the slots before the network's zero tail), taken with the
// row's property bits by a warp per row (m.row_lanes) and listed
// deliveries first, then the drops (nact[1]: the deliveries); K1 keeps
// each row's fingerprint folds and, by the same warp, the row's suffix
// folds (m.drop_suffix: lanes 2 j and 2 j + 1 slot j, the XOR of the
// changes a shift makes to the network's words from slot j on,
// kSuffixWords a row in shared memory). A delivery is staged as a wide
// model's; a drop child is the row with its count word less one or its
// network's words from the dropped slot on moved up a slot: its
// fingerprint is the row's folds with the slot's suffix folds (or its
// count word refolded), one lane's lookup (m.drop_fold), and its words
// are written from the shared row by a group of kDropLanes lanes
// (m.drop_write: 16-byte vectors where the width allows), the groups
// taking the children from a shared counter (a warp idle in the
// deliveries' last pass starts early), with no barrier and no staging.
// Every other lane gets the row's fingerprint and cvalid = 0, and its
// row of flat is not written.
template <class M, class = void>
struct DropLanes : std::false_type {};
template <class M>
struct DropLanes<M, std::void_t<decltype(M::kLossy)>>
    : std::integral_constant<bool, M::kLossy> {};

// The models whose lanes after the deliveries are edits of the row (crash
// and restart lanes, or drop lanes): a lane mask, the rows' folds, the
// deliveries listed first.
template <class M>
constexpr bool kEditLanes = CrashLanes<M>::value || DropLanes<M>::value;

// The models whose K1 keeps its tile's rows in shared memory and walks
// their active lanes densely (wide, edit and group models).
template <class M>
constexpr bool kSharedRow =
    WideRow<M>::value || EditRow<M>::value || GroupRow<M>::value;

// Whether M is a timer model (M::kTimerRow: timer_count.cuh
// TimerCountModel), a narrow row (at most M::W = 36 words) whose only
// valid lanes are Timeout lanes, each child the row with one or two words
// changed. K1 takes its own path, launched over a.wide (ops/_cuda.py
// k1_launch): only the pending rows, as a group model's (pending_span);
// each row loaded into shared memory by a group of kTimerLanes lanes, a
// lane a column, which then takes the row's fingerprint folds, property
// bits and active lanes (m.row_fold: bit a of the mask is lane 1 + a, so
// 32 actors' 33 lanes fit it); the block's active lanes listed densely by
// one warp's scan of the rows' counts. Then a thread a lane of the tile:
// an active lane takes its edit (m.timer_edit) and fingerprint
// (m.timer_fold: the row's folds with the changed words refolded), writes
// chi, clo and cvalid and posts the edit to its child's slot in the list
// (TimerSmem); every other lane gets the row's fingerprint and cvalid =
// 0, and its row of flat is not written. After a barrier the block's
// threads walk the words of all its children as one range, child c's
// words from its slot's shared row with the edit applied (m.timer_word),
// 16-byte vectors where the width is a multiple of four: the children of
// a row's consecutive active lanes are adjacent in flat, so a warp's
// stores are coalesced.
template <class M, class = void>
struct TimerRow : std::false_type {};
template <class M>
struct TimerRow<M, std::void_t<decltype(M::kTimerRow)>>
    : std::integral_constant<bool, M::kTimerRow> {};

// K1's phase clocks, in a tool's build only (tools/torch_paxos_kernels.py
// and torch_register_kernels.py pass -DSRT_K1_PHASES to nvcc; the
// library's own build has none of it): a shared-row K1 ends each phase
// at a barrier, after which thread 0 of the block adds the SM clock's
// ticks since the last one to k1_phase_ticks[phase] (kPhaseRows: the
// prologue, from the gate to the active lanes listed; kPhaseDeliveries:
// the delivery children; kPhaseEdits: the crash and restart, or drop,
// children; kPhaseTail: the other lanes and the rows' outputs) and counts
// the block in k1_phase_ticks[kK1Phases]. fused_step.cu
// srt_k1_phase_ticks reads and clears them.
enum K1Phase {
  kPhaseRows = 0,
  kPhaseDeliveries = 1,
  kPhaseEdits = 2,
  kPhaseTail = 3,
  kK1Phases = 4
};
#ifdef SRT_K1_PHASES
__device__ unsigned long long k1_phase_ticks[kK1Phases + 1];
struct K1Clock {
  long long t = 0;
  __device__ void start() {
    if (threadIdx.x == 0) t = clock64();
  }
  __device__ void end(int phase) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long now = clock64();
      atomicAdd(&k1_phase_ticks[phase], (unsigned long long)(now - t));
      if (phase == kPhaseTail) atomicAdd(&k1_phase_ticks[kK1Phases], 1ull);
      t = now;
    }
  }
};
#else
struct K1Clock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void end(int) {}
};
#endif

// The lanes of a group model's child: a half-warp, one lane a network
// slot (actor_net.cuh kMaxSlots); a whole warp a child lost at every
// register step on an H100 (tools/torch_register_kernels.py --sweep).
constexpr int kGroupLanes = 16;

// A half-warp (lanes [base, base + 16) of a warp), with the collectives
// actor_net.cuh's register_step_group calls; every lane of the group
// calls each at the same point.
struct WarpGroup {
  unsigned mask;
  int r;
  uint32_t* smem;  // the group's 2 kGroupLanes words of shared memory

  __device__ explicit WarpGroup(uint32_t* words) : smem(words) {
    const int wl = threadIdx.x & 31;
    r = wl & (kGroupLanes - 1);
    mask = ((1u << kGroupLanes) - 1u) << (wl - r);
  }
  __device__ __forceinline__ uint32_t* words() const { return smem; }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  __device__ __forceinline__ int rank() const { return r; }
  __device__ __forceinline__ int size() const { return kGroupLanes; }
  __device__ __forceinline__ uint32_t down(uint32_t v) const {
    return __shfl_down_sync(mask, v, 1, kGroupLanes);
  }
  __device__ __forceinline__ uint32_t up(uint32_t v) const {
    return __shfl_up_sync(mask, v, 1, kGroupLanes);
  }
  __device__ __forceinline__ uint32_t ballot(bool p) const {
    return __ballot_sync(mask, p) & mask;
  }
  __device__ __forceinline__ uint32_t xor_all(uint32_t v) const {
#pragma unroll
    for (int o = kGroupLanes / 2; o > 0; o >>= 1)
      v ^= __shfl_xor_sync(mask, v, o, kGroupLanes);
    return v;
  }
};

// A whole warp as a group of 32 lanes with ballots in lane order
// (actor_net.cuh crash_row_lanes) and suffix XORs (drop_suffix_folds:
// lane r gets the XOR of lanes r to 31).
struct FullWarp {
  __device__ __forceinline__ int rank() const { return threadIdx.x & 31; }
  __device__ __forceinline__ uint32_t ballot(bool p) const {
    return __ballot_sync(0xFFFFFFFFu, p);
  }
  __device__ __forceinline__ uint32_t suffix_xor(uint32_t v) const {
    const int r = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_down_sync(0xFFFFFFFFu, v, o);
      if (r + o < 32) v ^= y;
    }
    return v;
  }
};

// The lanes that load and fold one row of a timer model (TimerRow): a
// lane a column, 8 rows a warp.
constexpr int kTimerLanes = 4;

// G consecutive lanes of a warp (G a power of two, at most 32) with the
// collectives a timer model's row_fold calls; every lane of the group
// calls each at the same point.
template <int G>
struct LaneGroup {
  unsigned mask;
  int r;

  __device__ LaneGroup() {
    const int wl = threadIdx.x & 31;
    r = wl & (G - 1);
    mask = (G == 32 ? 0xFFFFFFFFu : (1u << G) - 1u) << (wl - r);
  }
  __device__ __forceinline__ int rank() const { return r; }
  __device__ __forceinline__ int size() const { return G; }
  __device__ __forceinline__ uint32_t ballot(bool p) const {
    return __ballot_sync(mask, p) & mask;
  }
  __device__ __forceinline__ uint32_t xor_all(uint32_t v) const {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) v ^= __shfl_xor_sync(mask, v, o, G);
    return v;
  }
};

// The rows a block of a gated launch of a group K1 takes: block b
// of `blocks` takes the pending rows [b * span, min(take, (b + 1) *
// span)), span = ceil(take / blocks) capped at the geometry's rows (what
// its shared memory holds; blocks * rows >= F >= take, so the cap never
// cuts a row off). ops/_cuda.py pending_span mirrors it.
__host__ __device__ __forceinline__ int pending_span(int take, int blocks,
                                                     int rows) {
  const int span = take > 0 ? (take + blocks - 1) / blocks : 0;
  return span < rows ? span : rows;
}

// K1-wide's launch is ops/_cuda.py wide_geometry's; its tile holds at
// most kWideRows rows (one warp scans them). So is an edit or a group
// model's.
constexpr int kWideRows = 32;
// the frontier words an edit model's K1 thread has in flight as it
// loads the tile's rows
constexpr int kEditLoads = 8;

// A staging row's stride in words: the width made odd, so word k of the
// 32 lanes of a warp falls in 32 distinct banks (at width 96 an even
// stride would put them all in one).
__host__ __device__ __forceinline__ int wide_stride(int width) {
  return width | 1;
}

// K1-wide's shared memory after the tile's rows: per row its quiet lane
// (m.quiet_from), its fingerprint (hi, lo) and its first active item (4
// words), then the count of active lanes (4 words, for alignment: with
// edit lanes the deliveries' count too, with drop lanes the next drop
// child to take), the tile's active lanes (rows * A), with drop lanes
// each row's suffix folds (kSuffixWords), and one staging row of
// wide_stride(width) words per thread.
struct WideSmem {
  uint32_t* info;
  uint32_t* nact;
  uint32_t* act;
  uint32_t* sfx;
  uint32_t* stage;
};

// A row's suffix folds with drop lanes (actor_net.cuh drop_suffix_folds):
// two words a network slot, at most 16 slots.
constexpr int kSuffixWords = 32;
// The lanes that write one drop child (actor_net.cuh drop_write): four
// children a warp at once, 8 consecutive words or vectors a store.
constexpr int kDropLanes = 8;

// The words of a thread's slot after the active lanes: a wide model's
// staging row, an edit model's M::Edit, a group model's two (its
// group's 2 kGroupLanes words: the child's history on its way to
// flat), or with crash lanes the M::Record of the delivery its thread
// takes in phase A (actor_net.cuh DeliveryRecord), its words made odd so
// that the threads' records start in distinct banks.
constexpr int kGroupSlotWords = 2;
template <class M>
__host__ __device__ __forceinline__ size_t slot_words(int width) {
  if constexpr (EditRow<M>::value)
    return sizeof(typename M::Edit) / sizeof(uint32_t);
  else if constexpr (GroupRow<M>::value && CrashLanes<M>::value)
    return (sizeof(typename M::Record) / sizeof(uint32_t)) | 1u;
  else if constexpr (GroupRow<M>::value)
    return kGroupSlotWords;
  else
    return (size_t)wide_stride(width);
}

// The suffix folds' words of a tile of `rows` rows: a model with drop
// lanes has them, the others none.
template <class M>
__host__ __device__ __forceinline__ size_t suffix_words(int rows) {
  return DropLanes<M>::value ? (size_t)rows * kSuffixWords : 0;
}

template <class M>
__host__ __device__ __forceinline__ size_t wide_words(const TileGeometry& w,
                                                      int width, int A) {
  return 4 * ((size_t)w.rows + 1) + (size_t)w.rows * A +
         suffix_words<M>(w.rows) + (size_t)w.threads * slot_words<M>(width);
}

template <class M>
__device__ __forceinline__ WideSmem wide_smem(unsigned char* smem,
                                              const TileGeometry& w,
                                              size_t row_bytes, int A) {
  WideSmem s;
  s.info = reinterpret_cast<uint32_t*>(smem + (size_t)w.rows * row_bytes);
  s.nact = s.info + 4 * w.rows;
  s.act = s.nact + 4;
  s.sfx = s.act + w.rows * A;
  s.stage = s.sfx + suffix_words<M>(w.rows);
  return s;
}

// A timer model's K1 shared memory after the tile's rows (TimerRow): per
// row its active lanes (bit a: lane 1 + a), fingerprint folds (h1, h2)
// and first child in the list (4 words), then the block's count of
// children (4 words, for alignment), then a slot a Timeout lane of the
// tile (rows * (A - 1)), child c's in slot c: its lane in the tile, its
// row << 8 | the edit's column, the count and timer words.
struct TimerSmem {
  uint32_t* info;
  uint32_t* nact;
  uint4* slots;
};

__device__ __forceinline__ TimerSmem timer_smem(unsigned char* smem,
                                                int rows, size_t row_bytes) {
  TimerSmem s;
  s.info = reinterpret_cast<uint32_t*>(smem + (size_t)rows * row_bytes);
  s.nact = s.info + 4 * rows;
  s.slots = reinterpret_cast<uint4*>(s.nact + 4);
  return s;
}

// The column key of fp64 for column k: kColumnKey's below its size,
// computed past it.
__device__ __forceinline__ uint32_t column_key(int k) {
  return k < kColumnKeys ? kColumnKey[k]
                         : fmix32((uint32_t)(k + 1) * kGolden);
}

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
// increment.cuh, increment_lock.cuh; the wide paxos.cuh, single_copy.cuh
// and abd.cuh's AbdModel: see WideRow; abd.cuh's AbdOrderedModel: see
// EditRow; timer_count.cuh's TimerCountModel: see TimerRow):
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
// original frontier rows either way. A wide model (WideRow; launched over
// a.wide) loads the tile's rows word by word and takes
// each row's fingerprint and quiet lane (m.quiet_from); the lanes below
// the quiet lanes are listed and stepped densely, a thread each, each
// child going to the thread's staging row in shared memory; after each
// pass of the block's threads every warp copies its children to flat,
// as 16-byte vectors, 32 a store, where the width is a multiple of four
// words, else each child's contiguous words 32 a store (where each
// lane's own strided stores would touch 32 sectors an instruction); the
// quiet lanes get the row's words and fingerprint. An edit model
// (EditRow; launched over a.wide too) loads its rows block-wide, takes
// each row's fingerprint folds and active lanes (m.active_lanes), steps
// those densely into edits, and spreads the children over the block's
// warps, each writing its children from the shared rows, 32 consecutive
// words a store, and folding only the words it changes. A group model
// (GroupRow; launched over a.wide too) loads and lists its rows as a wide
// model does and builds each active lane's child with a half-warp,
// written straight to flat. A model with crash lanes (CrashLanes) takes
// its crash and restart children as edits of the row (see there), and a
// lossy one (DropLanes) its drop children from the rows' suffix folds, a
// group of lanes each. A timer model (TimerRow; launched over a.wide
// too) loads its pending rows with a group of lanes a row, takes their
// folds, bits and Timeout lanes on the way, gives each active lane's
// fingerprint a thread and writes the block's children as one range of
// words from the shared rows.
// The grid also resets the ring arena for the step (grid-stride).
// Inside a chunk the launch is gated (open_gate): its rows are the
// queue's from the head, the first take of them valid.
//
// What the later kernels read of K1's outputs, which sets what a
// shared-row model (wide, edit, group: kSharedRow) or a timer model must
// write:
//   K2 claim_kernel (fused_step.cu; K5's claim in sharded_step.cu
//     alike) in tile_stage: cvalid on every lane of its tiles, chi and
//     clo only where cvalid; no row output.
//   K3 commit_kernel: the claims lists, owner words and ring arena K2
//     left, the discovery candidates (publish_discoveries, with the
//     step's phi/plo inputs); no lane or row output of K1.
//   K7 append_kernel (chunk.cu): inserted; for each inserted lane (a
//     cvalid lane: K2 and K3 mark only tile winners of valid lanes) its
//     flat row, chi and clo (queue_column, log_column, write_rows) and
//     ebits_out at its row (a pending row: cvalid needs fv); the tail
//     the same of the last inserted lane; the stats K1 added to.
//   K8 history_kernel (history.cu): the queue rows K7 wrote, nothing of
//     K1's.
//   pbits and terminal: no kernel; K1 itself turns a pending row's bits
//     into discovery candidates. The host reads them only from an
//     ungated step's outputs (the tests, chip_smoke.py).
// So a group or timer K1 steps the pending rows only: a row that is not
// pending (past take in a gated launch, fvalid 0 in an ungated one) is not
// loaded, folded or stepped; its lanes get cvalid = 0 and the row
// terminal = 0 (the plain version's), its other outputs are unwritten.
// In a gated launch the blocks spread over the pending rows
// (pending_span), the rows past them cleared grid-stride; lanes keep
// their absolute numbers (row * A + act), so every output and the
// discovery atomicMin's are placed as before. The wide and edit K1s
// step every row of their tiles: at Paxos's all-pending step the rule
// and the spread skip nothing and cost K1-paxos a few per cent, and at
// the ordered register steps they cost K1-abd_ordered as much (PERF.md).
// The edit, group and timer models leave the rows of flat of their
// inactive or quiet lanes unwritten (cvalid = 0, the row's fingerprint);
// the wide one copies the row there.
template <class M, bool SYM>
__global__ void expand_kernel(M m, StepArgs a) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  RowState<M, SYM>* rows = reinterpret_cast<RowState<M, SYM>*>(tile_smem);
  __shared__ int s_valid;
  int take;
  if (!open_gate(a, &take)) return;
  K1Clock clk;
  constexpr bool kTimer = TimerRow<M>::value;
  if constexpr (kSharedRow<M> || kTimer) clk.start();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  for (long long i = tid; i < a.cc; i += nthreads) a.ring_arena[i] = ~0ull;
  const int A = a.A;
  const int width = m.width();
  // a group or timer model steps the pending rows only (GroupRow,
  // TimerRow)
  constexpr bool kPend = GroupRow<M>::value || kTimer;
  long long row0 = (long long)blockIdx.x * a.tile.rows;
  int nrows =
      (int)max(0ll, min((long long)a.tile.rows, (long long)a.F - row0));
  if constexpr (kPend) {
    if (take >= 0) {
      // a gated launch: the pending rows spread over the grid; the rows
      // past them get no child (cvalid = 0, terminal = 0; grid-stride)
      const int pend = min(take, a.F);
      const int span = pending_span(pend, gridDim.x, a.tile.rows);
      row0 = (long long)blockIdx.x * span;
      nrows = (int)max(0ll, min((long long)span, (long long)pend - row0));
      const long long lanes = (long long)a.F * A;
      for (long long l = (long long)pend * A + tid; l < lanes; l += nthreads)
        a.cvalid[l] = 0;
      for (long long r = pend + tid; r < a.F; r += nthreads)
        a.terminal[r] = 0;
    }
  }
  if (threadIdx.x == 0) s_valid = 0;
  // a lane mask of active lanes and the rows' fingerprint folds (an edit
  // model, a model with crash lanes), or a quiet tail and the rows'
  // fingerprints (the other wide and group models)
  constexpr bool kMask = EditRow<M>::value || kEditLanes<M>;
  if constexpr (kSharedRow<M>) {
    static_assert(!SYM, "a shared-row model has no symmetric K1");
    static_assert(kWideRows <= 32, "one warp scans the tile's rows");
    constexpr bool kEdit = EditRow<M>::value;
    const WideSmem ws =
        wide_smem<M>(tile_smem, a.tile, sizeof(RowState<M, SYM>), A);
    const int wl = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    // which rows a group model steps: in a gated launch every row of the
    // block's span, in an ungated one those with fvalid (read once, in
    // shared memory); a row that is not gets no load, no fold, no step
    // and no child: its lanes cvalid = 0, the row terminal = 0 (the
    // plain version's), its other outputs unwritten. A wide or edit
    // model steps every row.
    if constexpr (kPend) {
      if (take < 0) {  // the same for the whole block
        for (int i = threadIdx.x; i < nrows; i += blockDim.x)
          rows[i].fv = a.fvalid[row0 + i] != 0;
        __syncthreads();
      }
    }
    auto pending = [&](int i) { return !kPend || take >= 0 || rows[i].fv; };
    if constexpr (kEdit || (WideRow<M>::value && kEditLanes<M>)) {
      // the tile's rows, block-wide, kEditLoads words in flight a thread
      // (word x of the tile is word x % width of row x / width)
      const int total = nrows * width, nt = blockDim.x;
      for (int x0 = threadIdx.x; x0 < total; x0 += kEditLoads * nt) {
        uint32_t v[kEditLoads];
        int i = x0 / width, c = x0 - i * width;
        int at[kEditLoads];
#pragma unroll
        for (int u = 0; u < kEditLoads; ++u) {
          at[u] = -1;
          if (x0 + u * nt < total) {
            v[u] = a.frontier[(row0 + i) * a.fstride + c];
            at[u] = i * (int)(sizeof(RowState<M, SYM>) / 4) + c;
          }
          for (c += nt; c >= width; c -= width) ++i;
        }
        uint32_t* base = reinterpret_cast<uint32_t*>(rows);
#pragma unroll
        for (int u = 0; u < kEditLoads; ++u)
          if (at[u] >= 0) base[at[u]] = v[u];
      }
    } else {
      // the tile's rows, a warp per row
      for (int i = wid; i < nrows; i += nwarps)
        if (pending(i))
          for (int c = wl; c < width; c += 32)
            rows[i].w[c] = a.frontier[(row0 + i) * a.fstride + c];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
      const long long r = row0 + i;
      RowState<M, SYM>& rs = rows[i];
      if constexpr (kPend) {
        rs.valid = 0;
        rs.xovf = 0;
        if (!pending(i)) {  // no active lane
          ws.info[4 * i] = 0u;
          continue;
        }
        rs.fv = 1;
      }
      if constexpr (kEditLanes<M>) {
        if constexpr (!kPend) {
          rs.fv = take >= 0 ? r < take : a.fvalid[r] != 0;
          rs.valid = 0;
          rs.xovf = 0;
        }
        continue;  // the bits and the lanes by the row's warp below
      }
      const uint32_t pb = m.props_row(rs.w);
      rs.pb = pb;
      rs.eb = a.ebits[r * a.estride] & ~(pb & a.ev_mask);
      if constexpr (!kPend) {
        rs.fv = take >= 0 ? r < take : a.fvalid[r] != 0;
        rs.valid = 0;
        rs.xovf = 0;
      }
      // a wide or group model's quiet lane, the mask of active lanes of
      // an edit model
      if constexpr (kMask)
        ws.info[4 * i] =
            m.active_lanes(rs.w) & (A >= 32 ? ~0u : (1u << A) - 1u);
      else
        ws.info[4 * i] = (uint32_t)min(A, max(0, m.quiet_from(rs.w)));
    }
    // each row's fingerprint, a warp per row (a group model's pending
    // rows, from the last warp down: the first threads take the rows'
    // flags above): an edit model, or one with crash lanes, keeps the
    // folds (its children's are the row's with their changed words
    // refolded), the other wide and group models the fingerprint; with
    // crash lanes the warp also takes the row's property bits and active
    // lanes, a lane a network slot (m.row_lanes), and with drop lanes the
    // row's suffix folds (m.drop_suffix)
    for (int i = kPend ? nwarps - 1 - wid : wid; i < nrows; i += nwarps) {
      if (!pending(i)) continue;  // the whole warp
      if constexpr (kEditLanes<M>) {
        const uint32_t eb = wl == 0 ? a.ebits[(row0 + i) * a.estride] : 0u;
        uint32_t pb, mask;
        m.row_lanes(rows[i].w, FullWarp{}, pb, mask);
        if (wl == 0) {
          rows[i].pb = pb;
          rows[i].eb = eb & ~(pb & a.ev_mask);
          ws.info[4 * i] = mask & (A >= 32 ? ~0u : (1u << A) - 1u);
        }
      }
      if constexpr (DropLanes<M>::value) {
        uint32_t s1, s2;
        m.drop_suffix(rows[i].w, FullWarp{}, s1, s2);
        if ((wl & 1) == 0 && (wl >> 1) < m.E) {  // slot wl / 2's
          ws.sfx[i * kSuffixWords + wl] = s1;
          ws.sfx[i * kSuffixWords + wl + 1] = s2;
        }
      }
      uint32_t h1 = 0u, h2 = 0u;
      for (int k = wl; k < width; k += 32) {
        if constexpr (kMask) {
          fold_word(h1, h2, k, rows[i].w[k]);
        } else {
          const uint32_t x = rows[i].w[k] ^ column_key(k);
          h1 ^= fmix32(x * kC1_1);
          h2 ^= fmix32(x * kC1_2);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        h1 ^= __shfl_xor_sync(0xFFFFFFFFu, h1, o);
        h2 ^= __shfl_xor_sync(0xFFFFFFFFu, h2, o);
      }
      if (wl == 0) {
        if constexpr (kMask) {
          ws.info[4 * i + 1] = h1;
          ws.info[4 * i + 2] = h2;
        } else {
          fp64_finish(h1, h2, width, ws.info[4 * i + 1],
                      ws.info[4 * i + 2]);
        }
      }
    }
    __syncthreads();
    // the active lanes, in lane order: each row's first at the prefix of
    // the active counts before it; with crash lanes the deliveries
    // first, then the crash and restart lanes (nact[1] deliveries: the
    // two counts scanned at once, the deliveries' in the low 16 bits)
    if (wid == 0) {
      const uint32_t info = wl < nrows ? ws.info[4 * wl] : 0u;
      int q;
      if constexpr (kEditLanes<M>) {
        const uint32_t dmask = (1u << m.E) - 1u;
        q = __popc(info & dmask) | (__popc(info & ~dmask) << 16);
      } else {
        q = kMask ? __popc(info) : (int)info;
      }
      int x = q;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
        if (wl >= o) x += y;
      }
      if (wl < nrows) ws.info[4 * wl + 3] = (uint32_t)(x - q);
      if (wl == 31) {
        if constexpr (kEditLanes<M>) {
          ws.nact[0] = (uint32_t)((x & 0xFFFF) + (x >> 16));
          ws.nact[1] = (uint32_t)(x & 0xFFFF);
          // with drop lanes, the next drop child to take
          if constexpr (DropLanes<M>::value) ws.nact[2] = 0u;
        } else {
          *ws.nact = (uint32_t)x;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
      uint32_t info = ws.info[4 * i];
      int off = (int)ws.info[4 * i + 3];
      if constexpr (kEditLanes<M>) {
        int d = off & 0xFFFF, c = (int)ws.nact[1] + (off >> 16);
        for (; info; info &= info - 1u) {
          const int e = __ffs(info) - 1;
          ws.act[e < m.E ? d++ : c++] = (uint32_t)(i * A + e);
        }
      } else if constexpr (kMask) {
        for (; info; info &= info - 1u)
          ws.act[off++] = (uint32_t)(i * A + __ffs(info) - 1);
      } else {
        for (int e = 0; e < (int)info; ++e)
          ws.act[off + e] = (uint32_t)(i * A + e);
      }
    }
  } else if constexpr (kTimer) {
    static_assert(!SYM, "a timer model has no symmetric K1");
    static_assert(kWideRows <= 32, "one warp scans the tile's rows");
    const TimerSmem ts =
        timer_smem(tile_smem, a.tile.rows, sizeof(RowState<M, SYM>));
    // each row by a group of kTimerLanes lanes, a lane a column: its
    // words loaded (all of a lane's in flight at once, with the row's
    // ebits) into shared memory, then its folds, property bits and active
    // lanes (m.row_fold: a lane folds the columns it loaded); a row that
    // is not pending (fvalid 0 in an ungated launch) none of them, and no
    // active lane
    constexpr int kCols = (M::W + kTimerLanes - 1) / kTimerLanes;
    const LaneGroup<kTimerLanes> g;
    const int ngroups = blockDim.x / kTimerLanes;
    for (int i = threadIdx.x / kTimerLanes; i < nrows; i += ngroups) {
      const long long r = row0 + i;
      RowState<M, SYM>& rs = rows[i];
      const bool fv = take >= 0 || a.fvalid[r] != 0;  // the group's
      uint32_t h1 = 0u, h2 = 0u, pb = 0u, lanes = 0u, eb = 0u;
      if (fv) {
        const uint32_t* src = a.frontier + r * a.fstride;
        uint32_t v[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int k = g.rank() + j * kTimerLanes;
          if (k < width) v[j] = src[k];
        }
        if (g.rank() == 0) eb = a.ebits[r * a.estride];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int k = g.rank() + j * kTimerLanes;
          if (k < width) rs.w[k] = v[j];
        }
        m.row_fold(rs.w, g, h1, h2, pb, lanes);
      }
      if (g.rank() == 0) {
        rs.fv = fv;
        rs.valid = lanes != 0u;  // every active lane is a valid child
        rs.xovf = 0;
        if (fv) {
          rs.pb = pb;
          rs.eb = eb & ~(pb & a.ev_mask);
        }
        ts.info[4 * i] = lanes;
        ts.info[4 * i + 1] = h1;
        ts.info[4 * i + 2] = h2;
      }
    }
    __syncthreads();
    // each row's first child in the list: the prefix of the active counts
    // before it
    if (threadIdx.x < 32) {
      const int wl = threadIdx.x;
      const int q = wl < nrows ? __popc(ts.info[4 * wl]) : 0;
      int x = q;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
        if (wl >= o) x += y;
      }
      if (wl < nrows) ts.info[4 * wl + 3] = (uint32_t)(x - q);
      if (wl == 31) *ts.nact = (uint32_t)x;
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
  if constexpr (kSharedRow<M> || kTimer) clk.end(kPhaseRows);
  int nvalid = 0;
  const int tile = nrows * A;
  const long long lane0 = row0 * A;
  // lane t = row * A + act, walked in strides of blockDim.x
  const int drow = blockDim.x / A, dact = blockDim.x - drow * A;
  int row = threadIdx.x / A, act = threadIdx.x - row * A;
  if constexpr (WideRow<M>::value || GroupRow<M>::value) {
    const WideSmem ws =
        wide_smem<M>(tile_smem, a.tile, sizeof(RowState<M, SYM>), A);
    const int nact = (int)*ws.nact;
    const int wl = threadIdx.x & 31, w0 = threadIdx.x - wl;
    const int wid = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    // 16-byte stores where every row of flat starts 16-byte aligned
    const bool vec16 =
        (width & 3) == 0 && (reinterpret_cast<uintptr_t>(a.flat) & 15) == 0;
    if constexpr (WideRow<M>::value) {
      static_assert(M::W <= kColumnKeys,
                    "RowOut: a column without its key");
      const int stride = wide_stride(width);
      // the staged children: every active lane, or with crash lanes the
      // deliveries (the list's first nact[1])
      int nstaged = nact;
      if constexpr (kEditLanes<M>) nstaged = (int)ws.nact[1];
      // the staged lanes, densely: each thread steps one into its
      // staging row; uniform trip count: the warp then writes its
      // children
      for (int base = 0; base < nstaged; base += blockDim.x) {
        const int j = base + threadIdx.x;
        if (j < nstaged) {
          const int t = (int)ws.act[j], i = t / A;
          RowState<M, SYM>& rs = rows[i];
          const long long lane = lane0 + t;
          bool ovf = false;
          uint32_t hi, lo;
          RowOut out(ws.stage + threadIdx.x * stride);
          const bool v = m.step_row(rs.w, t - i * A, out, ovf);
          out.finish(width, hi, lo);
          a.chi[lane] = hi;
          a.clo[lane] = lo;
          const bool cv = v && rs.fv;
          a.cvalid[lane] = cv;
          nvalid += cv;
          if (cv) rs.valid = 1;
          if (ovf && rs.fv) rs.xovf = 1;
        }
        __syncwarp();
        // each child is width contiguous words of flat
        const int n = min(32, nstaged - (base + w0));
        if (vec16) {
          // the warp's n children as n * q4 16-byte vectors, 32 a store
          // (the staging rows' odd stride: read a word at a time)
          const int q4 = width >> 2, dc = 32 / q4, dk = 32 - dc * q4;
          int c = wl / q4, k4 = wl - c * q4;
          for (int j = wl; j < n * q4; j += 32) {
            const uint32_t* src = ws.stage + (w0 + c) * stride + 4 * k4;
            reinterpret_cast<uint4*>(
                a.flat + (lane0 + ws.act[base + w0 + c]) * width)[k4] =
                make_uint4(src[0], src[1], src[2], src[3]);
            c += dc;
            k4 += dk;
            if (k4 >= q4) {
              k4 -= q4;
              ++c;
            }
          }
        } else {
          // 32 consecutive words of one child a store
          for (int c = 0; c < n; ++c) {
            uint32_t* dst = a.flat + (lane0 + ws.act[base + w0 + c]) * width;
            const uint32_t* src = ws.stage + (w0 + c) * stride;
            for (int k = wl; k < width; k += 32) dst[k] = src[k];
          }
        }
        __syncwarp();
      }
      if constexpr (DropLanes<M>::value) {
        clk.end(kPhaseDeliveries);
        // the drop children, the list's rest, a group of kDropLanes lanes
        // each, taken in turn from a shared counter (nact[2]): a warp
        // with no delivery in the last pass (none past the deliveries'
        // count) starts on them while the others still step theirs, so
        // the drops' stores overlap the deliveries' chains. The group's
        // lanes write the child's words from the shared row straight to
        // flat (m.drop_write); its first lane takes its fingerprint, the
        // row's folds with the row's suffix folds of the slot or its
        // count word refolded (m.drop_fold), and writes the lane's
        // outputs
        const int gr = threadIdx.x % kDropLanes;
        const int g0 = wl - gr;  // the group's first lane in the warp
        const unsigned gmask = ((1u << kDropLanes) - 1u) << g0;
        const int ndrop = nact - nstaged;
        int* next = reinterpret_cast<int*>(ws.nact + 2);
        while (true) {
          int c = 0;
          if (gr == 0) c = atomicAdd(next, 1);
          c = __shfl_sync(gmask, c, g0);
          if (c >= ndrop) break;
          const int t = (int)ws.act[nstaged + c], i = t / A;
          RowState<M, SYM>& rs = rows[i];
          const long long lane = lane0 + t;
          const auto ed = m.drop_edit(rs.w, t - i * A);
          m.drop_write(rs.w, ed, gr, kDropLanes, a.flat + lane * width,
                       vec16);
          if (gr == 0) {
            uint32_t hi, lo;
            m.drop_fold(rs.w, ed, ws.sfx + i * kSuffixWords,
                        ws.info[4 * i + 1], ws.info[4 * i + 2], hi, lo);
            a.chi[lane] = hi;
            a.clo[lane] = lo;
            const bool cv = ed.valid && rs.fv;
            a.cvalid[lane] = cv;
            nvalid += cv;
            if (cv) rs.valid = 1;
          }
        }
      } else if constexpr (kEditLanes<M>) {
        clk.end(kPhaseDeliveries);
        // the crash and restart children, the list's rest, in passes of
        // blockDim.x: each thread takes one's edit and fingerprint (the
        // row's folds with its changed words refolded) and leaves the
        // edit in its staging row; after a barrier child c of the pass is
        // written from the shared row by warp c % nwarps, 32 consecutive
        // words a store
        using Edit = typename M::CrashEdit;
        const int ncr = nact - nstaged;
        for (int base = 0; base < ncr; base += blockDim.x) {
          const int n = min((int)blockDim.x, ncr - base);
          if ((int)threadIdx.x < n) {
            const int t = (int)ws.act[nstaged + base + threadIdx.x];
            const int i = t / A;
            RowState<M, SYM>& rs = rows[i];
            const long long lane = lane0 + t;
            uint32_t hi, lo;
            const Edit ed =
                m.crash_child(rs.w, t - i * A, ws.info[4 * i + 1],
                              ws.info[4 * i + 2], hi, lo);
            *reinterpret_cast<Edit*>(ws.stage + threadIdx.x * stride) = ed;
            a.chi[lane] = hi;
            a.clo[lane] = lo;
            const bool cv = ed.valid && rs.fv;
            a.cvalid[lane] = cv;
            nvalid += cv;
            if (cv) rs.valid = 1;
          }
          __syncthreads();
          for (int c = wid; c < n; c += nwarps) {
            const int t = (int)ws.act[nstaged + base + c], i = t / A;
            const Edit ed =
                *reinterpret_cast<const Edit*>(ws.stage + c * stride);
            m.crash_write(rows[i].w, ed, wl, 32,
                          a.flat + (lane0 + t) * width);
          }
          __syncthreads();  // the staging rows are the next pass's
        }
      }
    } else {
      const int gid = threadIdx.x / kGroupLanes;
      const int ngroups = blockDim.x / kGroupLanes;
      if constexpr (CrashLanes<M>::value) {
        // the active lanes in passes of blockDim.x, each in two phases:
        // A, a thread each, a delivery's scalar part (the dispatch, the
        // validity, the history) into its record, or a crash or restart
        // lane's edit into it with the child's fingerprint (the row's
        // folds with its changed words refolded); B, after a barrier, a
        // group each, a delivery's child built from its record with the
        // network in the group's lanes, or a crash child's words written
        // from the shared row
        using Rec = typename M::Record;
        using Edit = typename M::CrashEdit;
        static_assert(sizeof(Edit) <= sizeof(Rec), "an edit fits a slot");
        const int rec_words = (int)slot_words<M>(width);
        const WarpGroup g(ws.stage);  // no group words: the records
        const int nd = (int)ws.nact[1];  // the deliveries come first
        for (int base = 0; base < nact; base += blockDim.x) {
          const int n = min((int)blockDim.x, nact - base);
          if (base > 0) __syncthreads();  // the last pass's records read
          if ((int)threadIdx.x < n) {
            const int j = base + threadIdx.x;
            const int t = (int)ws.act[j], i = t / A;
            RowState<M, SYM>& rs = rows[i];
            uint32_t* slot = ws.stage + threadIdx.x * rec_words;
            if (j < nd) {
              m.deliver_scalar(rs.w, t - i * A, *reinterpret_cast<Rec*>(slot));
            } else {
              const long long lane = lane0 + t;
              uint32_t hi, lo;
              const Edit ed =
                  m.crash_child(rs.w, t - i * A, ws.info[4 * i + 1],
                                ws.info[4 * i + 2], hi, lo);
              *reinterpret_cast<Edit*>(slot) = ed;
              a.chi[lane] = hi;
              a.clo[lane] = lo;
              a.cvalid[lane] = ed.valid;
              nvalid += ed.valid;
              if (ed.valid) rs.valid = 1;
            }
          }
          __syncthreads();
          for (int c = gid; c < n; c += ngroups) {
            const int j = base + c;
            const int t = (int)ws.act[j], i = t / A;
            RowState<M, SYM>& rs = rows[i];
            const long long lane = lane0 + t;
            const uint32_t* slot = ws.stage + c * rec_words;
            if (j >= nd) {
              const Edit ed = *reinterpret_cast<const Edit*>(slot);
              m.crash_write(rs.w, ed, g.rank(), g.size(),
                            a.flat + lane * width);
              continue;
            }
            bool ovf;
            uint32_t hi, lo;
            const bool v = m.deliver_group(
                rs.w, t - i * A, *reinterpret_cast<const Rec*>(slot), g,
                a.flat + lane * width, ovf, hi, lo);
            if (g.rank() == 0) {
              a.chi[lane] = hi;
              a.clo[lane] = lo;
              a.cvalid[lane] = v;
              nvalid += v;
              if (v) rs.valid = 1;
              if (ovf) rs.xovf = 1;
            }
          }
        }
        clk.end(kPhaseDeliveries);
      } else {
        const WarpGroup g(ws.stage + gid * kGroupLanes * kGroupSlotWords);
        // the active lanes, a child a group (the same trip count for the
        // group; no barrier: no group reads another's work)
        for (int j = gid; j < nact; j += ngroups) {
          const int t = (int)ws.act[j], i = t / A;
          RowState<M, SYM>& rs = rows[i];
          const long long lane = lane0 + t;
          bool ovf = false;
          uint32_t hi, lo;
          const bool v = m.step_group(rs.w, t - i * A, g,
                                      a.flat + lane * width, ovf, hi, lo);
          if (g.rank() == 0) {
            a.chi[lane] = hi;
            a.clo[lane] = lo;
            a.cvalid[lane] = v;
            nvalid += v;
            if (v) rs.valid = 1;
            if (ovf) rs.xovf = 1;
          }
        }
      }
    }
    if constexpr (!kEditLanes<M>) clk.end(kPhaseDeliveries);
    clk.end(kPhaseEdits);
    // the quiet (or, with crash lanes, inactive) lanes: the row's
    // fingerprint, invalid (a group model's row that is not pending:
    // invalid only)
    for (int t = threadIdx.x; t < tile; t += blockDim.x) {
      const uint32_t info = ws.info[4 * row];
      if (kMask ? !((info >> act) & 1u) : act >= (int)info) {
        const long long lane = lane0 + t;
        if (!kPend || rows[row].fv) {
          if constexpr (kMask) {
            fp64_finish(ws.info[4 * row + 1], ws.info[4 * row + 2], width,
                        a.chi[lane], a.clo[lane]);
          } else {
            a.chi[lane] = ws.info[4 * row + 1];
            a.clo[lane] = ws.info[4 * row + 2];
          }
        }
        a.cvalid[lane] = 0;
      }
      row += drow;
      act += dact;
      if (act >= A) {
        act -= A;
        ++row;
      }
    }
    // a wide model's quiet lanes get the row itself (a group model's
    // rows of flat, and those of a model with crash lanes, stay
    // unwritten)
    if constexpr (WideRow<M>::value && !kEditLanes<M>) {
      for (int i = wid; i < nrows; i += nwarps) {
        const int e0 = (int)ws.info[4 * i];
        if (vec16) {
          // the row's quiet lanes are one span of (A - e0) * width words
          const int q4 = width >> 2, dk = 32 % q4;
          const uint4* src = reinterpret_cast<const uint4*>(rows[i].w);
          uint4* dst = reinterpret_cast<uint4*>(a.flat +
                                                (lane0 + i * A + e0) * width);
          int k4 = wl % q4;
          for (int j = wl; j < (A - e0) * q4; j += 32) {
            dst[j] = src[k4];
            k4 += dk;
            if (k4 >= q4) k4 -= q4;
          }
        } else {
          for (int e = e0; e < A; ++e) {
            uint32_t* dst = a.flat + (lane0 + i * A + e) * width;
            for (int k = wl; k < width; k += 32) dst[k] = rows[i].w[k];
          }
        }
      }
    }
  } else if constexpr (EditRow<M>::value) {
    using Edit = typename M::Edit;
    const WideSmem ws =
        wide_smem<M>(tile_smem, a.tile, sizeof(RowState<M, SYM>), A);
    Edit* edits = reinterpret_cast<Edit*>(ws.stage);
    const int nact = (int)*ws.nact;
    const int wl = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    // the active lanes, densely, a pass of at most blockDim.x: each
    // thread writes one's edit to its slot; then child c of the pass is
    // written by warp c % nwarps (uniform trip counts: every thread
    // meets both barriers)
    for (int base = 0; base < nact; base += blockDim.x) {
      const int n = min((int)blockDim.x, nact - base);
      if ((int)threadIdx.x < n) {
        const int t = (int)ws.act[base + threadIdx.x], i = t / A;
        RowState<M, SYM>& rs = rows[i];
        bool ovf = false;
        const bool v = m.edit_lane(rs.w, t - i * A, edits[threadIdx.x], ovf);
        const bool cv = v && rs.fv;
        a.cvalid[lane0 + t] = cv;
        nvalid += cv;
        if (cv) rs.valid = 1;
        if (ovf && rs.fv) rs.xovf = 1;
      }
      __syncthreads();
      // the child's width contiguous words of flat, 32 a store; each
      // lane folds the words it changes into the row's folds
      for (int c = wid; c < n; c += nwarps) {
        const int t = (int)ws.act[base + c], i = t / A;
        const Edit& ed = edits[c];
        const auto h = m.edit_head(ed);
        const uint32_t* row = rows[i].w;
        const long long lane = lane0 + t;
        uint32_t* dst = a.flat + lane * width;
        uint32_t h1 = 0u, h2 = 0u;
        for (int k = wl; k < width; k += 32) {
          const uint32_t old = row[k];
          const uint32_t v = m.child_word(row, ed, h, k, old);
          dst[k] = v;
          if (v != old) fold_change(h1, h2, k, old, v);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          h1 ^= __shfl_xor_sync(0xFFFFFFFFu, h1, o);
          h2 ^= __shfl_xor_sync(0xFFFFFFFFu, h2, o);
        }
        if (wl == 0) {
          uint32_t hi, lo;
          fp64_finish(ws.info[4 * i + 1] ^ h1, ws.info[4 * i + 2] ^ h2,
                      width, hi, lo);
          a.chi[lane] = hi;
          a.clo[lane] = lo;
        }
      }
      __syncthreads();  // the slots are the next pass's
    }
    clk.end(kPhaseDeliveries);
    clk.end(kPhaseEdits);
    // the other lanes: the row's fingerprint, invalid; flat unwritten
    for (int t = threadIdx.x; t < tile; t += blockDim.x) {
      if (!((ws.info[4 * row] >> act) & 1u)) {
        const long long lane = lane0 + t;
        uint32_t hi, lo;
        fp64_finish(ws.info[4 * row + 1], ws.info[4 * row + 2], width, hi,
                    lo);
        a.chi[lane] = hi;
        a.clo[lane] = lo;
        a.cvalid[lane] = 0;
      }
      row += drow;
      act += dact;
      if (act >= A) {
        act -= A;
        ++row;
      }
    }
  } else if constexpr (kTimer) {
    using Edit = typename M::Edit;
    const TimerSmem ts =
        timer_smem(tile_smem, a.tile.rows, sizeof(RowState<M, SYM>));
    const int nact = (int)*ts.nact;
    // a thread a lane: an active lane's edit and fingerprint (the row's
    // folds with its changed words refolded), its edit posted to its
    // child's slot; every other lane the row's fingerprint (a row that is
    // not pending: none), invalid
    for (int t = threadIdx.x; t < tile; t += blockDim.x) {
      const uint32_t* info = ts.info + 4 * row;
      const uint32_t lanes = info[0];
      const int b = act - 1;  // a Timeout lane's actor
      const long long lane = lane0 + t;
      if (act > 0 && ((lanes >> b) & 1u)) {
        const uint32_t* w = rows[row].w;
        const Edit ed = m.timer_edit(w, b);
        uint32_t hi, lo;
        m.timer_fold(w, ed, info[1], info[2], hi, lo);
        a.chi[lane] = hi;
        a.clo[lane] = lo;
        a.cvalid[lane] = 1;
        ts.slots[info[3] + __popc(lanes & ((1u << b) - 1u))] = make_uint4(
            (uint32_t)t, (uint32_t)row << 8 | ed.col, ed.count, ed.timer);
      } else {
        if (rows[row].fv)
          fp64_finish(info[1], info[2], width, a.chi[lane], a.clo[lane]);
        a.cvalid[lane] = 0;
      }
      row += drow;
      act += dact;
      if (act >= A) {
        act -= A;
        ++row;
      }
    }
    if (threadIdx.x == 0) nvalid = nact;
    __syncthreads();
    // the block's children as one range of q units each (16-byte vectors
    // where every row of flat starts 16-byte aligned, else words), unit x
    // the k-th of child c: its slot's row with the edit applied
    const bool vec16 =
        (width & 3) == 0 && (reinterpret_cast<uintptr_t>(a.flat) & 15) == 0;
    const int q = vec16 ? width >> 2 : width;
    const int dc = blockDim.x / q, dk = blockDim.x - dc * q;
    int c = threadIdx.x / q, k = threadIdx.x - c * q;
    for (int x = threadIdx.x; x < nact * q; x += blockDim.x) {
      const uint4 s = ts.slots[c];
      const uint32_t* w = rows[s.y >> 8].w;
      const Edit ed{s.y & 0xFFu, s.z, s.w};
      uint32_t* dst = a.flat + (lane0 + s.x) * width;
      if (vec16) {
        uint4 v = reinterpret_cast<const uint4*>(w)[k];
        v.x = m.timer_word(ed, 4 * k, v.x);
        v.y = m.timer_word(ed, 4 * k + 1, v.y);
        v.z = m.timer_word(ed, 4 * k + 2, v.z);
        v.w = m.timer_word(ed, 4 * k + 3, v.w);
        reinterpret_cast<uint4*>(dst)[k] = v;
      } else {
        dst[k] = m.timer_word(ed, k, w[k]);
      }
      c += dc;
      k += dk;
      if (k >= q) {
        k -= q;
        ++c;
      }
    }
    clk.end(kPhaseEdits);
  } else {
    for (int t = threadIdx.x; t < tile; t += blockDim.x) {
      RowState<M, SYM>& rs = rows[row];
      const long long lane = lane0 + t;
      bool ovf = false, v;
      uint32_t hi, lo;
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
  }
  __syncthreads();
  const unsigned long long tag = (unsigned long long)(~a.step) << 32;
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
    const RowState<M, SYM>& rs = rows[i];
    const long long r = row0 + i;
    if (kPend && !rs.fv) {  // not pending: no child, nothing found
      a.terminal[r] = 0;
      continue;
    }
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
  if constexpr (kSharedRow<M> || kTimer) clk.end(kPhaseTail);
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

// The dynamic shared memory K1-wide's layout takes over the geometry w
// at width words and A lanes a row: the tile's rows, then wide_words
// 32-bit words (WideSmem). The launch checks that ops/_cuda.py's
// wide_smem_bytes gave at least this much.
template <class M, bool SYM>
size_t wide_smem_bytes(const TileGeometry& w, int width, int A) {
  return (size_t)w.rows * sizeof(RowState<M, SYM>) +
         wide_words<M>(w, width, A) * sizeof(uint32_t);
}

// The dynamic shared memory a timer model's K1 takes over a tile of rows
// rows of A lanes (TimerSmem): the rows, four words a row and four of
// the count, a 16-byte slot a Timeout lane. The launch checks that
// ops/_cuda.py's timer_smem_bytes gave at least this much.
template <class M, bool SYM>
size_t timer_smem_bytes(int rows, int A) {
  return (size_t)rows * sizeof(RowState<M, SYM>) +
         (4 * ((size_t)rows + 1) + 4 * (size_t)rows * (A - 1)) *
             sizeof(uint32_t);
}

// The delivery lanes of A action lanes: those before the crash or drop
// lanes.
template <class M>
int delivery_lanes(const M& m, int A) {
  if constexpr (CrashLanes<M>::value)
    return A - 2 * m.cr.n;
  else if constexpr (DropLanes<M>::value)
    return A - m.E;
  else
    return A;
}

// Launch K1 over a.tile (blocks >= 1 even at F = 0: the grid resets
// the ring arena); a wide, edit, group or timer model over a.wide.
template <class M, bool SYM>
cudaError_t launch_expand(const M& m, const StepArgs& a, cudaStream_t st) {
  const TileGeometry& g = a.tile;
  if (!geometry_ok(g, a.F, a.A)) return cudaErrorInvalidValue;
  if constexpr (kSharedRow<M>) {
    StepArgs wa = a;
    wa.tile = a.wide;
    const size_t smem = (size_t)a.wide_smem;
    if (!geometry_ok(wa.tile, a.F, a.A) || wa.tile.rows > kWideRows ||
        a.wide_smem < 0 ||
        smem < wide_smem_bytes<M, SYM>(wa.tile, m.width(), a.A))
      return cudaErrorInvalidValue;
    // a group model's delivery lanes are its group's slots; a lane mask
    // holds 32 lanes
    if (GroupRow<M>::value && delivery_lanes(m, a.A) > kGroupLanes)
      return cudaErrorInvalidValue;
    if (kEditLanes<M> && a.A > 32) return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(expand_kernel<M, SYM>, smem);
    if (e != cudaSuccess) return e;
    expand_kernel<M, SYM><<<wa.tile.blocks, wa.tile.threads, smem, st>>>(
        m, wa);
    return cudaGetLastError();
  } else if constexpr (TimerRow<M>::value) {
    StepArgs wa = a;
    wa.tile = a.wide;
    const size_t smem = (size_t)a.wide_smem;
    // one warp scans the tile's rows; a row's Timeout lanes fit a mask
    if (!geometry_ok(wa.tile, a.F, a.A) || wa.tile.rows > kWideRows ||
        a.A > 33 || a.wide_smem < 0 ||
        smem < timer_smem_bytes<M, SYM>(wa.tile.rows, a.A))
      return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(expand_kernel<M, SYM>, smem);
    if (e != cudaSuccess) return e;
    expand_kernel<M, SYM><<<wa.tile.blocks, wa.tile.threads, smem, st>>>(
        m, wa);
    return cudaGetLastError();
  } else {
    const size_t smem = (size_t)g.rows * sizeof(RowState<M, SYM>);
    cudaError_t e = allow_smem(expand_kernel<M, SYM>, smem);
    if (e != cudaSuccess) return e;
    expand_kernel<M, SYM><<<g.blocks, g.threads, smem, st>>>(m, a);
    return cudaGetLastError();
  }
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
