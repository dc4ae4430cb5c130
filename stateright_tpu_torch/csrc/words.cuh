// Helpers for the models whose row is a register array longer than the
// state (the width is a runtime argument): a word at a runtime index,
// read and written by an unrolled select over the array, so the array
// stays in registers (a dynamic index would move it to local memory).
#pragma once

#include <cstdint>

template <int W>
__device__ __forceinline__ uint32_t word_at(const uint32_t (&x)[W], int k) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) v = j == k ? x[j] : v;
  return v;
}

template <int W>
__device__ __forceinline__ void set_word(uint32_t (&x)[W], int k,
                                         uint32_t v) {
#pragma unroll
  for (int j = 0; j < W; ++j) x[j] = j == k ? v : x[j];
}
