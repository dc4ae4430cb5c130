// K10: evict marked fingerprint-prefix ranges from the visited table and
// compact each bucket, in place — the device half of the spill to the
// host tier.
//
// Replaces stateright_tpu/ops/hashtable.py:257 table_evict_prefix (an XLA
// program, jitted at stateright_tpu/checker/tpu.py:174-183, no
// pallas_call): every key whose top 8 bits are a marked prefix is
// dropped, each 4-slot bucket's survivors move to its front in order (the
// insert claims a bucket's FIRST empty slot, so occupancy must stay a
// prefix), and the count of dropped keys is returned. The port's table is
// one int64 [C/4, 4] of packed keys (0 marks an empty slot; a key's top 8
// bits are its hi half's top 8 bits, resilience.fp_prefix), so a bucket
// is 32 contiguous bytes.
//
// Bound: one read and one write of the table (bytes; 0.010 ms at 2**21
// slots and 3.35 TB/s). Design: one thread a bucket over a grid-stride
// loop; the bucket loads as two 16-byte vectors; the 256-bit mask sits in
// shared memory (8 words, loaded by the block's first threads); the
// survivors are compacted in registers (no dynamically indexed array:
// the positions are selected, so nothing goes to local memory); a bucket
// is stored, as two 16-byte vectors, only if it changed; the count is
// summed over each warp by shuffles and added with one atomicAdd a warp.
// In place, so every captured chunk graph keeps its table pointer.
// Built with nvcc for sm_90a into its own shared library with a plain C
// interface and driven over ctypes by stateright_tpu_torch/ops/_cuda.py
// (table_evict_prefix); the plain version is ops/hashtable.py
// table_evict_prefix_reference.

#include <cuda_runtime.h>

// K10's arguments (ops/_cuda.py EvictArgs mirrors it, field for field;
// outside the unnamed namespace, so the C entries that take it keep
// external linkage)
struct EvictArgs {
  long long* keys;        // int64 [n_buckets, 4] packed keys, in place
  long long n_buckets;
  int* count;             // int32 [1], the evicted keys (added to)
  unsigned int mask[8];   // bit p of the 256: prefix p is evicted
  int blocks;
  void* stream;
};

namespace {

constexpr int kEvictThreads = 256;

__device__ __forceinline__ bool evicted(const unsigned int* smask,
                                        long long key) {
  unsigned int p = (unsigned int)((unsigned long long)key >> 56);
  return key != 0 && ((smask[p >> 5] >> (p & 31)) & 1u);
}

__global__ void __launch_bounds__(kEvictThreads)
    evict_prefix_kernel(EvictArgs a) {
  __shared__ unsigned int smask[8];
  for (int i = threadIdx.x; i < 8; i += blockDim.x) smask[i] = a.mask[i];
  __syncthreads();
  int dropped = 0;
  longlong2* table = reinterpret_cast<longlong2*>(a.keys);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       b < a.n_buckets; b += stride) {
    longlong2 v0 = table[2 * b], v1 = table[2 * b + 1];
    const long long k[4] = {v0.x, v0.y, v1.x, v1.y};
    long long o0 = 0, o1 = 0, o2 = 0, o3 = 0;
    int n = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (k[s] == 0) continue;
      if (evicted(smask, k[s])) {
        ++dropped;
        continue;
      }
      o0 = n == 0 ? k[s] : o0;
      o1 = n == 1 ? k[s] : o1;
      o2 = n == 2 ? k[s] : o2;
      o3 = n == 3 ? k[s] : o3;
      ++n;
    }
    if (o0 != k[0] || o1 != k[1] || o2 != k[2] || o3 != k[3]) {
      table[2 * b] = make_longlong2(o0, o1);
      table[2 * b + 1] = make_longlong2(o2, o3);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dropped += __shfl_down_sync(0xffffffffu, dropped, off);
  if ((threadIdx.x & 31) == 0 && dropped) atomicAdd(a.count, dropped);
}

}  // namespace

extern "C" {

// K10 over a->blocks blocks of kEvictThreads threads. *count is added
// to (the wrapper zeroes it). Returns cudaGetLastError() of the launch.
int srt_evict_prefix(const EvictArgs* a) {
  if (a->keys == nullptr || a->count == nullptr || a->n_buckets < 1 ||
      a->blocks < 1 ||
      (reinterpret_cast<unsigned long long>(a->keys) & 15ull))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(a->stream);
  evict_prefix_kernel<<<a->blocks, kEvictThreads, 0, st>>>(*a);
  return (int)cudaGetLastError();
}

// K10's threads a block (ops/_cuda.py EVICT_THREADS mirrors it).
int srt_evict_threads() { return kEvictThreads; }

// Bytes of the argument struct, checked by the Python binding.
int srt_evict_args_size() { return (int)sizeof(EvictArgs); }

}  // extern "C"
