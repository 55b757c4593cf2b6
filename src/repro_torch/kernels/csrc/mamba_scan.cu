// replaces repro/kernels/mamba_scan.py::_scan_kernel (selective_scan)
//
// Mamba-1 selective scan over the whole sequence, for every (batch b,
// channel i, state j):
//     h_t = exp(dt_t[i] * A[i,j]) * h_{t-1} + (dt_t[i] * x_t[i]) * B_t[j]
//     y_t[i] = sum_j h_t[i,j] * C_t[j] + D[i] * x_t[i],   A = -exp(A_log)
// x and dt (B,S,di) both float32 or both bfloat16, read in that dtype (the
// TPU kernel casts them inside too); bc (B,S,2,16) float32 holds B_t and C_t
// zero-padded to 16 states; A_log (di,n), D (di,), h0 (B,di,n) float32;
// y (B,S,di) and h_last (B,di,n) float32.  Any B, S >= 1, di and
// 1 <= n <= 16: states j >= n run on zeros (A2, B_t, C_t) and store nothing.
//
// What bounds it on an H100: the exp.  At the serve shape (B 4, S 2048,
// di 8192, n 16) the scan needs B*S*di*n = 1.07e9 exp, one multi-function
// unit (MUFU) op each at 16 per clock per SM: 0.26 ms, against 0.16 ms for
// its bytes.  A thread per (b, i, j) would spend shuffles and shared-memory
// loads on every state of every step, and the MIO pipe, not the exp, would
// bound it.  This design:
//
//  * One thread per (b, channel), all NS = 16 states in registers (h[NS]
//    and A2[j] = -exp(A_log[i,j]) log2 e), so a step is NS ex2.approx (one
//    MUFU op each), about 4 FP32 ops per state and an in-thread sum for y_t
//    in two chains: no shuffles.  The NS state chains are independent, which
//    feeds the MUFU pipe from the 8 warps per SM that the serve shape has
//    (B * di = 32,768 threads).  There it runs at 1.7x the exp bound: two
//    threads per channel (more warps, a shuffle per step) and a polynomial
//    exp2 on the FMA pipe for some states (fewer MUFU ops, more
//    instructions) were both slower on the H100, so the instruction rate
//    and latency at 8 warps per SM, not the MUFU rate alone, are what is
//    left.
//  * B_t and C_t are shared by the block's channels: read as broadcast
//    128-bit loads from shared memory, 8 loads for the 16 states.
//  * x and dt tiles (kT steps x kCh channels, coalesced across channels)
//    and the bc tile come through a kStages-deep ring in shared memory,
//    filled by cp.async while earlier tiles compute: one barrier per tile
//    of kT steps, none per step.  y_t is stored every step, coalesced
//    across the block's channels.  Shapes whose rows are not 16-byte
//    aligned (di % 8 != 0) fill the same ring with plain loads.
//  * dt in bfloat16 is read as such: the serve path no longer writes and
//    reads a float32 copy of it per layer.
// The TPU kernel carried h across a sequential grid axis in VMEM scratch;
// here the time loop inside the block takes that axis' place.  Channels
// i >= di compute on zeros and store nothing.
//
// The bf16 a/b mode (RunConfig.ssm_dtype = "bf16", kAB16) follows the
// reference model's chunked scan (repro/models/mamba.py: _discretize,
// _chunk_scan): a_t = exp(dt_t A) and b_t = (dt_t B_t) x_t rounded to
// bf16, combined in bf16 within chunks of `chunk` steps, h carried in
// float32 across chunk boundaries.  Each thread keeps, per state, the
// chunk's running products in registers, each rounded to bf16 after
// every step:
//     A_c <- bf16(a_t A_c),  B_c <- bf16(bf16(a_t B_c) + b_t)
//     h_t = float(A_c) h_c0 + float(B_c)   (float32; h_c0 = h at the
//                                           chunk's start)
// and restarts A_c = 1, B_c = 0 at each multiple of `chunk`.  The
// reference combines a chunk as a tree (associative_scan); a sequential
// combine rounds in another order, so the two agree within a tolerance.
// The mode computes exp with expf (not ex2.approx) and its products with
// the _rn intrinsics (never contracted into an FMA), the same operations
// as the plain version, so both round a_t, b_t, A_c and B_c alike.  Its
// last partial chunk needs no padding: the reference pads with identity
// steps (a = 1, b = 0), which leave A_c, B_c and h unchanged.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scan_common.cuh"

namespace {

constexpr int kCh = 64;      // channels (threads) per block
constexpr int kT = 32;       // time steps per tile
constexpr int kStages = 3;   // tiles in flight in the ring

// v rounded to bfloat16 (to nearest even), as a float.
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
struct Ring {
  static constexpr int kBC = kT * 2 * NS;  // floats of B_t, C_t per tile
  static constexpr size_t kXOff = kBC * sizeof(float);
  static constexpr size_t kDOff = kXOff + kT * kCh * sizeof(T);
  static constexpr size_t kStage = kDOff + kT * kCh * sizeof(T);
  static constexpr size_t kBytes = kStages * kStage;
};

// One (kT x kCh) tile of a (B,S,di) operand into shared memory.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, size_t row0,
                                          int t0, int S, int di, int c0, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
    constexpr int CPR = kCh / E;       // chunks per row of the tile
    for (int e = threadIdx.x; e < kT * CPR; e += kCh) {
      const int tt = e / CPR, cc = (e % CPR) * E;
      const bool ok = t0 + tt < S && c0 + cc < di;
      cp_async16(dst + tt * kCh + cc,
                 ok ? src + (row0 + t0 + tt) * di + c0 + cc : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kT * kCh; e += kCh) {
      const int tt = e / kCh, cc = e % kCh;
      const bool ok = t0 + tt < S && c0 + cc < di;
      dst[e] = ok ? src[(row0 + t0 + tt) * di + c0 + cc] : static_cast<T>(0.f);
    }
  }
}

template <typename T, bool kAB16>
__global__ void __launch_bounds__(kCh)
scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
            const float* __restrict__ bc, const float* __restrict__ a_log,
            const float* __restrict__ dvec, const float* __restrict__ h0,
            float* __restrict__ y, float* __restrict__ h_last, int S, int di, int n,
            bool vec, int chunk) {
  using R = Ring<T>;
  extern __shared__ __align__(16) unsigned char ring[];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCh;
  const int i = c0 + threadIdx.x;
  const bool live = i < di;
  const size_t row0 = static_cast<size_t>(b) * S;  // row of (b, t = 0)
  const size_t hoff = (static_cast<size_t>(b) * di + i) * n;

  // A2: A log2 e for ex2 (float32 mode), A itself for expf (kAB16).
  // h: the state (float32 mode), the state at the chunk's start (kAB16).
  // Ac, Bc: the chunk's bf16 running products (kAB16 only).
  float A2[NS], h[NS], Ac[kAB16 ? NS : 1], Bc[kAB16 ? NS : 1];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const bool on = live && j < n;
    const float A = on ? -expf(a_log[static_cast<size_t>(i) * n + j]) : 0.f;
    A2[j] = kAB16 ? A : A * kLog2e;
    h[j] = on ? h0[hoff + j] : 0.f;
    if constexpr (kAB16) {
      Ac[j] = 1.f;
      Bc[j] = 0.f;
    }
  }
  int left = chunk;  // steps left in the current chunk (kAB16)
  const float Dv = live ? dvec[i] : 0.f;
  const int tiles = (S + kT - 1) / kT;

  auto load = [&](int tile) {
    if (tile < tiles) {
      unsigned char* st = ring + (tile % kStages) * R::kStage;
      const int t0 = tile * kT;
      float* bcs = reinterpret_cast<float*>(st);
      const float* src = bc + (row0 + t0) * 2 * NS;
      constexpr int CPT = 2 * NS / 4;  // 16-byte chunks per time step
      for (int e = threadIdx.x; e < R::kBC / 4; e += kCh) {
        const bool ok = t0 + e / CPT < S;
        cp_async16(bcs + 4 * e, ok ? src + 4 * e : bc, ok);
      }
      load_rows(reinterpret_cast<T*>(st + R::kXOff), x, row0, t0, S, di, c0, vec);
      load_rows(reinterpret_cast<T*>(st + R::kDOff), dt, row0, t0, S, di, c0, vec);
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  for (int tile = 0; tile < kStages - 1; ++tile) load(tile);
  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `tile` are done
    __syncthreads();               // everyone's are, and tile-1's slot is free
    load(tile + kStages - 1);
    const unsigned char* st = ring + (tile % kStages) * R::kStage;
    const float* bcs = reinterpret_cast<const float*>(st);
    const T* xs = reinterpret_cast<const T*>(st + R::kXOff) + threadIdx.x;
    const T* dts = reinterpret_cast<const T*>(st + R::kDOff) + threadIdx.x;
    const int t0 = tile * kT;
    const int steps = min(kT, S - t0);
    float* yp = y + (row0 + t0) * di + i;
#pragma unroll 2
    for (int tt = 0; tt < steps; ++tt) {
      const float xv = to_f32(xs[tt * kCh]);
      const float dv = to_f32(dts[tt * kCh]);
      const float4* bv = reinterpret_cast<const float4*>(bcs + tt * 2 * NS);
      const float4* cv = reinterpret_cast<const float4*>(bcs + tt * 2 * NS + NS);
      float Bv[NS], Cv[NS];
#pragma unroll
      for (int q = 0; q < NS / 4; ++q) {
        const float4 bq = bv[q], cq = cv[q];
        Bv[4 * q] = bq.x; Bv[4 * q + 1] = bq.y; Bv[4 * q + 2] = bq.z; Bv[4 * q + 3] = bq.w;
        Cv[4 * q] = cq.x; Cv[4 * q + 1] = cq.y; Cv[4 * q + 2] = cq.z; Cv[4 * q + 3] = cq.w;
      }
      float acc0 = Dv * xv, acc1 = 0.f;  // two chains: half the add latency
      if constexpr (kAB16) {
        if (left == 0) {  // a new chunk: carry h in float32, restart A_c, B_c
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            h[j] = __fadd_rn(__fmul_rn(Ac[j], h[j]), Bc[j]);
            Ac[j] = 1.f;
            Bc[j] = 0.f;
          }
          left = chunk;
        }
        --left;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float a = bf16r(expf(__fmul_rn(dv, A2[j])));
          const float b = bf16r(__fmul_rn(__fmul_rn(dv, Bv[j]), xv));
          Ac[j] = bf16r(__fmul_rn(a, Ac[j]));
          Bc[j] = bf16r(__fadd_rn(bf16r(__fmul_rn(a, Bc[j])), b));
          const float ht = __fadd_rn(__fmul_rn(Ac[j], h[j]), Bc[j]);
          if (j % 2 == 0) acc0 = fmaf(ht, Cv[j], acc0);
          else acc1 = fmaf(ht, Cv[j], acc1);
        }
      } else {
        const float u = dv * xv;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          h[j] = fmaf(ex2(dv * A2[j]), h[j], u * Bv[j]);
          if (j % 2 == 0) acc0 = fmaf(h[j], Cv[j], acc0);
          else acc1 = fmaf(h[j], Cv[j], acc1);
        }
      }
      if (live) yp[static_cast<size_t>(tt) * di] = acc0 + acc1;
    }
  }
  cp_async_wait<0>();
  if (live) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float hl = h[j];
      if constexpr (kAB16) hl = __fadd_rn(__fmul_rn(Ac[j], h[j]), Bc[j]);
      if (j < n) h_last[hoff + j] = hl;
    }
  }
}

template <typename T, bool kAB16>
cudaError_t launch(dim3 grid, cudaStream_t st, const void* x, const void* dt,
                   const float* bc, const float* a_log, const float* d, const float* h0,
                   float* y, float* h_last, int S, int di, int n, bool vec, int chunk) {
  constexpr size_t smem = Ring<T>::kBytes;
  auto* kernel = scan_kernel<T, kAB16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kCh, smem, st>>>(static_cast<const T*>(x), static_cast<const T*>(dt), bc,
                                  a_log, d, h0, y, h_last, S, di, n, vec, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(bool ab16, dim3 grid, cudaStream_t st, const void* x,
                        const void* dt, const float* bc, const float* a_log, const float* d,
                        const float* h0, float* y, float* h_last, int S, int di, int n,
                        bool vec, int chunk) {
  return ab16 ? launch<T, true>(grid, st, x, dt, bc, a_log, d, h0, y, h_last, S, di, n,
                                vec, chunk)
              : launch<T, false>(grid, st, x, dt, bc, a_log, d, h0, y, h_last, S, di, n,
                                 vec, chunk);
}

}  // namespace

// bf16: 1 when x and dt are bfloat16, 0 when both are float32.  vec: 1 when
// di % 8 == 0 and x and dt are 16-byte aligned (cp.async in 16-byte chunks).
// ab_bf16: 1 for the bf16 a/b mode, in chunks of `chunk` >= 1 steps; 0 for
// the float32 recurrence (chunk unread).
extern "C" int mamba_scan_launch(const void* x, const void* dt, const void* bc,
                                 const void* a_log, const void* d, const void* h0,
                                 void* y, void* h_last, int B, int S, int di, int n,
                                 int bf16, int vec, int ab_bf16, int chunk,
                                 void* stream) {
  if (B <= 0 || S <= 0 || di <= 0 || n <= 0 || n > NS || B > 65535 ||
      (vec && di % 8 != 0) || (ab_bf16 && chunk <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((di + kCh - 1) / kCh, B);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* bcp = static_cast<const float*>(bc);
  const auto* alp = static_cast<const float*>(a_log);
  const auto* dp = static_cast<const float*>(d);
  const auto* h0p = static_cast<const float*>(h0);
  auto* yp = static_cast<float*>(y);
  auto* hlp = static_cast<float*>(h_last);
  const cudaError_t err =
      bf16 ? launch_mode<__nv_bfloat16>(ab_bf16 != 0, grid, st, x, dt, bcp, alp, dp, h0p,
                                        yp, hlp, S, di, n, vec != 0, chunk)
           : launch_mode<float>(ab_bf16 != 0, grid, st, x, dt, bcp, alp, dp, h0p, yp, hlp,
                                S, di, n, vec != 0, chunk);
  return static_cast<int>(err);
}
