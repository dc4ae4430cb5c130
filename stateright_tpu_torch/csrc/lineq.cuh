// The LinearEquation fixture as CUDA device functions: the packed step
// and the property bit of stateright_tpu_torch/models/packed.py
// (PackedLinearEquation.packed_step / packed_properties), with a, b and
// c as runtime arguments.
//
// Packed state: w[0] = x, w[1] = y (each a byte). Action lanes:
// IncreaseX, IncreaseY, both always enabled. One property, "solvable"
// (sometimes): (a*x + b*y) & 0xFF == c. The low byte of a*x + b*y
// depends only on the low bytes of a, b, x and y, so the host passes a
// and b as bytes and c as a byte, or 256 (which no byte equals) when c
// is not one.
#pragma once

#include <cstdint>

struct LinearEquationModel {
  static constexpr int W = 2;  // packed words per state

  uint32_t a, b, c;

  __host__ LinearEquationModel(int a_, int b_, int c_)
      : a((uint32_t)a_ & 0xFFu), b((uint32_t)b_ & 0xFFu), c((uint32_t)c_) {}

  __host__ __device__ int width() const { return W; }
  __host__ int max_actions() const { return 2; }

  // Successor of w under action lane act into s; always enabled, never
  // overflows (ovf untouched).
  __device__ __forceinline__ bool step(const uint32_t (&w)[W], int act,
                                       uint32_t (&s)[W], bool& ovf) const {
    s[0] = act == 0 ? (w[0] + 1u) & 0xFFu : w[0];
    s[1] = act == 0 ? w[1] : (w[1] + 1u) & 0xFFu;
    return true;
  }

  // Bit 0: "solvable".
  __device__ __forceinline__ uint32_t props(const uint32_t (&w)[W]) const {
    return ((a * w[0] + b * w[1]) & 0xFFu) == c ? 1u : 0u;
  }
};
