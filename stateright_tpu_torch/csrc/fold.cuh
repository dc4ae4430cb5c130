// The fingerprint of stateright_tpu_torch/fingerprint.py fp64_words as
// XOR-folds: each word of a row mixed with its column's key and folded
// into two 32-bit sums (h1, h2), which fp64_finish mixes with the seeds
// and the width. A fold is an XOR, so a child that differs from its row
// in a few words has the row's folds with those columns' old words
// folded out and their new words folded in (fold_change): step_common.cuh
// K1's edit models take their children's fingerprints so. Included by
// step_common.cuh; host-compilable (tests/test_torch_register_geometry.py
// builds it with g++ under a header that defines CUDA's qualifiers away).
#pragma once

#include <cstdint>

namespace {

constexpr uint32_t kC1_1 = 0xCC9E2D51u;
constexpr uint32_t kC1_2 = 0x239B961Bu;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kSeed1 = 0x9747B28Cu;
constexpr uint32_t kSeed2 = 0x85EBCA6Bu;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// fp64's seeds and width mixed into the XOR-folds h1, h2 of a row's
// width words (as fp64 ends).
__device__ __forceinline__ void fp64_finish(uint32_t h1, uint32_t h2,
                                            int width, uint32_t& hi,
                                            uint32_t& lo) {
  h1 = fmix32(h1 ^ kSeed1 ^ (uint32_t)width);
  h2 = fmix32(h2 ^ kSeed2 ^ ((uint32_t)width * kC1_1));
  if (h1 == 0u && h2 == 0u) h2 = 1u;
  hi = h1;
  lo = h2;
}

// Word v of column k folded into (h1, h2), its column key computed (no
// table lookup: the lanes of a warp fold distinct columns).
__device__ __forceinline__ void fold_word(uint32_t& h1, uint32_t& h2, int k,
                                          uint32_t v) {
  const uint32_t x = v ^ fmix32((uint32_t)(k + 1) * kGolden);
  h1 ^= fmix32(x * kC1_1);
  h2 ^= fmix32(x * kC1_2);
}

// Column k's word changed from old to v: old folded out, v folded in.
__device__ __forceinline__ void fold_change(uint32_t& h1, uint32_t& h2,
                                            int k, uint32_t old,
                                            uint32_t v) {
  const uint32_t key = fmix32((uint32_t)(k + 1) * kGolden);
  const uint32_t x = old ^ key, y = v ^ key;
  h1 ^= fmix32(x * kC1_1) ^ fmix32(y * kC1_1);
  h2 ^= fmix32(x * kC1_2) ^ fmix32(y * kC1_2);
}

// fingerprint.py fp64_node: the node key of sound-eventually checking,
// the fingerprint of the words [lo, hi, eb] of a state fingerprint
// (hi, lo) and its pending eventually-bits eb (staged.cu's KS1 and KS2;
// ops/hash_kernel.py fp64_node_device is its plain version).
__device__ __forceinline__ void fp64_node(uint32_t hi, uint32_t lo,
                                          uint32_t eb, uint32_t& nhi,
                                          uint32_t& nlo) {
  uint32_t h1 = 0u, h2 = 0u;
  fold_word(h1, h2, 0, lo);
  fold_word(h1, h2, 1, hi);
  fold_word(h1, h2, 2, eb);
  fp64_finish(h1, h2, 3, nhi, nlo);
}

}  // namespace
