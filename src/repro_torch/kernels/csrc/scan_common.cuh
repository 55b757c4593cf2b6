// What the selective scan's forward (mamba_scan.cu) and backward
// (mamba_scan_bwd.cu) kernels share: the state count they keep in
// registers, the float32 widening and narrowing store, and the base-2 exp
// they compute with.
#pragma once
#include <cuda_bf16.h>

constexpr int NS = 16;  // states in registers; n <= NS are live
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// A float32 result stored in T (bf16: rounded to nearest even, as torch's
// .to(torch.bfloat16) rounds).
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 2^v on the multi-function unit (one MUFU op; flushes denormals to zero).
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
