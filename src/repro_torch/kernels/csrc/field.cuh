// Mod-p helpers shared by the port's kernels.
//
// Field elements are uint32 values in [0, p) with p < 2^30 (stored in int32
// tensors).  A product of two elements is < 2^60, formed as uint64.  A
// uint64 accumulator that starts below p stays exact while it takes at most
// R = floor((2^64 - p) / (p-1)^2) products:
//     (p-1) + R (p-1)^2 < 2^64.
// R is 76921 for P = 15485863 and 16 for P30 = 2^30 - 35 (kernels/build.py:
// reduce_every).  coded_grad adds 8 <= R products to a residue, and a
// row's d products unreduced where d <= R (kernels/coded_grad.py: raw_sums).
//
// Cheaper than a 64-bit `%` inside a sum: the fold.  With c = 2^32 mod p,
//     acc = hi 2^32 + lo  ==  lo + hi c   (mod p),
// one 32x32 -> 64 multiply-add, and the result is at most (2^32-1)(c+1).
// After a fold the accumulator takes L more products while
//     (2^32-1)(c+1) + L (p-1)^2 < 2^64
// (L = 16 for P30, c = 140; 76825 for P, c = 5383245: build.py fold_every).
// The one true reduction per output is Barrett's, with m = floor(2^64 / p).
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

// acc == lo + hi c (mod p), c = 2^32 mod p; the result is <= (2^32-1)(c+1).
__device__ __forceinline__ uint64_t fp_fold(uint64_t acc, uint32_t c) {
  return static_cast<uint64_t>(static_cast<uint32_t>(acc >> 32)) * c +
         static_cast<uint32_t>(acc);
}

// x mod p for any uint64 x, m = floor(2^64 / p): q = floor(x m / 2^64) lies in
// (x/p - 2, x/p], so x - q p is in [0, 2p) and fits 32 bits (2p < 2^31).
__device__ __forceinline__ uint32_t fp_reduce(uint64_t x, uint32_t p, uint64_t m) {
  const uint64_t q = __umul64hi(x, m);
  const uint32_t r = static_cast<uint32_t>(x) - static_cast<uint32_t>(q) * p;
  return r >= p ? r - p : r;
}
