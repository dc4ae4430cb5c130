/* Native fingerprint core (a copy of stateright_tpu/_native/fphash.c).
 *
 * C implementation of the column-parallel two-lane 64-bit fingerprint
 * defined in stateright_tpu_torch/fingerprint.py (the host reference) and
 * mirrored by the plain torch version in ops/hash_kernel.py and the CUDA
 * kernels' csrc/fold.cuh. The Rust crate's stable hasher is native too
 * (fixed-key aHash, lib.rs:331-344). Built at first use by
 * _native/__init__.py and loaded via ctypes; the pure-Python
 * implementation remains the fallback and the bit-exactness oracle
 * (tests/test_torch_resilience.py holds the two equal).
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>

#define C1_1 0xCC9E2D51u
#define C1_2 0x239B961Bu
#define GOLDEN 0x9E3779B9u
#define SEED1 0x9747B28Cu
#define SEED2 0x85EBCA6Bu

static inline uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

/* Per-position whitening key P_i = fmix32((i + 1) * GOLDEN). */
static inline uint32_t col_key(size_t i) {
    return fmix32((uint32_t)(i + 1) * GOLDEN);
}

uint64_t fp64_words(const uint32_t *words, size_t n) {
    uint32_t h1 = 0, h2 = 0;
    for (size_t i = 0; i < n; i++) {
        uint32_t x = words[i] ^ col_key(i);
        h1 ^= fmix32(x * C1_1);
        h2 ^= fmix32(x * C1_2);
    }
    h1 = fmix32(h1 ^ SEED1 ^ (uint32_t)n);
    h2 = fmix32(h2 ^ SEED2 ^ ((uint32_t)n * C1_1));
    uint64_t fp = ((uint64_t)h1 << 32) | (uint64_t)h2;
    return fp ? fp : 1u;
}

/* Batch variant: fingerprint `count` rows of `width` words each (row-major),
 * writing one uint64 per row. Used for bulk host-side mirroring. The
 * whitening keys are computed once per call, not once per row. */
void fp64_rows(const uint32_t *rows, size_t count, size_t width,
               uint64_t *out) {
    uint32_t stack_keys[256];
    uint32_t *keys = stack_keys;
    if (width > 256) {
        keys = (uint32_t *)malloc(width * sizeof(uint32_t));
        if (!keys) { /* fall back to the scalar path */
            for (size_t r = 0; r < count; r++)
                out[r] = fp64_words(rows + r * width, width);
            return;
        }
    }
    for (size_t i = 0; i < width; i++)
        keys[i] = col_key(i);
    uint32_t fin2 = (uint32_t)width * C1_1;
    for (size_t r = 0; r < count; r++) {
        const uint32_t *row = rows + r * width;
        uint32_t h1 = 0, h2 = 0;
        for (size_t i = 0; i < width; i++) {
            uint32_t x = row[i] ^ keys[i];
            h1 ^= fmix32(x * C1_1);
            h2 ^= fmix32(x * C1_2);
        }
        h1 = fmix32(h1 ^ SEED1 ^ (uint32_t)width);
        h2 = fmix32(h2 ^ SEED2 ^ fin2);
        uint64_t fp = ((uint64_t)h1 << 32) | (uint64_t)h2;
        out[r] = fp ? fp : 1u;
    }
    if (keys != stack_keys)
        free(keys);
}
