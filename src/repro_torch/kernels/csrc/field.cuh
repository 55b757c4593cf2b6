// Mod-p helpers shared by the port's kernels.
//
// Field elements are uint32 values in [0, p) with p < 2^30 (stored in int32
// tensors).  A product of two elements is < 2^60, formed as uint64.  A
// uint64 accumulator that starts below p stays exact while it takes at most
// R = floor((2^64 - p) / (p-1)^2) products:
//     (p-1) + R (p-1)^2 < 2^64.
// R is 76921 for P = 15485863 and 16 for P30 = 2^30 - 35; the wrappers
// compute it (kernels/build.py: reduce_every) and pass it in, and the
// kernels reduce mod p at least every R terms.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t fp_add(uint32_t a, uint32_t b, uint32_t p) {
  uint32_t s = a + b;  // < 2p < 2^31
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t fp_mul(uint32_t a, uint32_t b, uint32_t p) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) % p);
}

// a * b + acc in uint64 (one IMAD.WIDE); the caller bounds the term count.
__device__ __forceinline__ uint64_t fp_mac(uint64_t acc, uint32_t a, uint32_t b) {
  return acc + static_cast<uint64_t>(a) * b;
}
