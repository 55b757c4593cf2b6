// Backward of the Mamba-1 selective scan of mamba_scan.cu (float32 mode).
//
// The port's own kernel: the JAX package trains through its plain jnp
// chunked scan (repro/models/mamba.py: _chunk_scan), so no TPU kernel
// stands behind it; here every mamba layer's forward is the CUDA scan,
// and this is its gradient (kernels/mamba_scan.py: SelectiveScanFn).
//
// The forward, for every (batch b, channel i, state j), A = -exp(A_log):
//     a_t = exp(dt_t[i] A[i,j]),  h_t = a_t h_{t-1} + dt_t[i] x_t[i] B_t[j]
//     y_t[i] = sum_j C_t[j] h_t[j] + D[i] x_t[i]
// Given dy (B,S,di) and dh_last (B,di,n), the reverse recurrence
//     g_t = dy_t C_t + a_{t+1} g_{t+1},   g_{S-1} = dy_{S-1} C_{S-1} + dh_last
// (g_t = dL/dh_t) gives
//     dx_t      = dt_t sum_j g_t[j] B_t[j] + D dy_t
//     ddt_t     = x_t sum_j g_t[j] B_t[j] + sum_j g_t[j] h_{t-1}[j] a_t[j] A[j]
//     dB_t[j]   = sum_i g_t[j] dt_t x_t          dC_t[j] = sum_i dy_t h_t[j]
//     dA_log    = A sum_{b,t} g_t h_{t-1} a_t dt_t   (dA/dA_log = A)
//     dD        = sum_{b,t} dy_t x_t              dh0 = a_0 g_0
// Inputs as the forward's: x and dt (B,S,di) both float32 or both bf16; bc
// (B,S,2,16) float32, B_t and C_t zero-padded; A_log (di,n), D (di,), h0
// (B,di,n), dy (B,S,di) and dh_last (B,di,n) float32.  Outputs: dx, ddt
// (B,S,di) in x's and dt's dtype (computed in float32; bf16 stores round to
// nearest even); float32 dbc_part (blocks, B,S,2,16), the per-block sums of dB_t
// and dC_t; da_part (B,di,n), dd_part (B,di), each batch row's dA_log and
// dD; dh0 (B,di,n).  The wrapper folds the partials with torch.sum, so the
// result does not depend on the order blocks run in: no atomics.
//
// What makes it hard, and this design (right and simple first):
//  * The reverse walk needs h_{t-1} in reverse order.  One thread per
//    (b, channel) holds its 16 states, as the forward does.  A first pass
//    runs the forward from h0 and writes the state at the start of every
//    chunk of kL = 16 steps to scratch (hck, [b][chunk][j][i], coalesced
//    across channels).  Then, chunk by chunk from the last, the thread runs
//    the chunk forward again from its checkpoint, keeping each step's
//    h_{t-1} in shared memory (its own column: no barrier), and walks the
//    chunk in reverse, carrying g in registers.  a_t is recomputed (one
//    ex2 a state), so the scan costs three passes of exps.
//  * dB_t and dC_t are sums over all di channels, which live in different
//    threads and blocks.  Each warp sums its 32 channels' 32 values (16 dB,
//    16 dC) in 31 shuffles, a transposing butterfly that leaves lane l with
//    the warp's sum of value l; the block's warps are added in shared memory
//    once a chunk, and each block writes its own partial.
//  * dA_log and dD are sums over batch and time: each thread sums its
//    channel's over time in registers and writes one partial a batch row.
// What bounds it on an H100: the exps (3 a state and step) and the
// latency of a step's dependent chain; it runs 64-thread blocks with 68 KB
// of shared memory, 3 to an SM.  Making it fast (chunked in parallel
// across time, wgmma for the channel sums) is later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scan_common.cuh"

namespace {

constexpr int kCh = 64;  // channels (threads) per block
constexpr int kWarps = kCh / 32;
constexpr int kL = 16;   // steps per chunk: the interval of the checkpoints
constexpr int kV = 2 * NS;  // dB_t and dC_t values a step: one per lane
constexpr size_t kHist = static_cast<size_t>(kL) * NS * kCh;  // floats
constexpr size_t kSmem = (kHist + static_cast<size_t>(kWarps) * kL * kV) * sizeof(float);
static_assert(kV == 32, "one dB/dC value per lane of a warp");

template <int W>
__device__ __forceinline__ void fold(float (&v)[kV], int lane) {
  const bool up = lane & W;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float send = up ? v[k] : v[k + W];
    const float keep = up ? v[k + W] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// Lane l gets the sum over the warp's lanes of v[l] (31 shuffles).
__device__ __forceinline__ float warp_sums(float (&v)[kV], int lane) {
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  return v[0];
}

// One forward step of row r from h; with kKeep, h_{t-1} to hist[j kCh].
template <bool kKeep, typename T>
__device__ __forceinline__ void fwd_step(const T* __restrict__ x, const T* __restrict__ dt,
                                         const float* __restrict__ bc, size_t r, int i, int di,
                                         bool live, const float (&A)[NS], float (&h)[NS],
                                         float* hist) {
  const float xv = live ? to_f32(x[r * di + i]) : 0.f;
  const float dv = live ? to_f32(dt[r * di + i]) : 0.f;
  const float* bt = bc + r * kV;
  const float u = dv * xv, dl = dv * kLog2e;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if constexpr (kKeep) hist[j * kCh] = h[j];
    h[j] = fmaf(ex2(dl * A[j]), h[j], u * __ldg(bt + j));
  }
}

template <typename T>
__global__ void __launch_bounds__(kCh)
scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ bc, const float* __restrict__ a_log,
                const float* __restrict__ dvec, const float* __restrict__ h0,
                const float* __restrict__ dy, const float* __restrict__ dh_last,
                float* __restrict__ hck, T* __restrict__ dx, T* __restrict__ ddt,
                float* __restrict__ dbc_part, float* __restrict__ da_part,
                float* __restrict__ dd_part, float* __restrict__ dh0, int S, int di,
                int n) {
  extern __shared__ __align__(16) float smem[];
  float* red = smem + kHist;  // [kWarps][kL][kV]: the warps' dB_t, dC_t sums
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kCh + threadIdx.x;
  const bool live = i < di;
  const size_t row0 = static_cast<size_t>(b) * S;  // row of (b, t = 0)
  const size_t hoff = (static_cast<size_t>(b) * di + i) * n;
  const int nck = (S + kL - 1) / kL;
  float* ck = hck + static_cast<size_t>(b) * nck * NS * di + i;  // + (c NS + j) di
  float* hist = smem + threadIdx.x;  // + (tt NS + j) kCh: h_{t-1} of step tt

  // Channels i >= di and states j >= n run on zeros and store nothing.
  float A[NS], h[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const bool on = live && j < n;
    A[j] = on ? -expf(a_log[static_cast<size_t>(i) * n + j]) : 0.f;
    h[j] = on ? h0[hoff + j] : 0.f;
  }
  const float Dv = live ? dvec[i] : 0.f;

  // 1. The forward from h0: the state before each chunk's first step.
  for (int c = 0; c < nck; ++c) {
    if (live) {
#pragma unroll
      for (int j = 0; j < NS; ++j) ck[(static_cast<size_t>(c) * NS + j) * di] = h[j];
    }
    const int t0 = c * kL, steps = min(kL, S - t0);
    for (int tt = 0; tt < steps; ++tt)
      fwd_step<false>(x, dt, bc, row0 + t0 + tt, i, di, live, A, h, hist + tt * NS * kCh);
  }

  // 2. Chunk by chunk from the last, g (= dL/dh) carried in registers.
  float g[NS], dA[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    g[j] = (live && j < n) ? dh_last[hoff + j] : 0.f;
    dA[j] = 0.f;
  }
  float dD = 0.f;
  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * kL, steps = min(kL, S - t0);
    // 2a. The chunk's states again, from its checkpoint.
#pragma unroll
    for (int j = 0; j < NS; ++j) h[j] = live ? ck[(static_cast<size_t>(c) * NS + j) * di] : 0.f;
    for (int tt = 0; tt < steps; ++tt)
      fwd_step<true>(x, dt, bc, row0 + t0 + tt, i, di, live, A, h, hist + tt * NS * kCh);
    // 2b. The chunk in reverse.
    for (int tt = steps - 1; tt >= 0; --tt) {
      const size_t r = row0 + t0 + tt;
      const float xv = live ? to_f32(x[r * di + i]) : 0.f;
      const float dv = live ? to_f32(dt[r * di + i]) : 0.f;
      const float dyv = live ? dy[r * di + i] : 0.f;
      const float* bt = bc + r * kV;
      const float u = dv * xv, dl = dv * kLog2e;
      float v[kV];  // this channel's dB_t[j] (j < NS) and dC_t[j] (NS + j)
      float gB = 0.f, gdt = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float Bj = __ldg(bt + j), Cj = __ldg(bt + NS + j);
        const float hp = hist[(tt * NS + j) * kCh];
        const float a = ex2(dl * A[j]);
        const float gj = fmaf(dyv, Cj, g[j]);
        v[j] = gj * u;
        v[NS + j] = dyv * fmaf(a, hp, u * Bj);  // dy_t h_t[j]
        gB = fmaf(gj, Bj, gB);
        const float gha = gj * hp * a;
        gdt = fmaf(gha, A[j], gdt);
        dA[j] = fmaf(gha, dv, dA[j]);
        g[j] = a * gj;
      }
      if (live) {
        store(dx + r * di + i, fmaf(gB, dv, Dv * dyv));
        store(ddt + r * di + i, fmaf(gB, xv, gdt));
      }
      dD = fmaf(dyv, xv, dD);
      red[(warp * kL + tt) * kV + lane] = warp_sums(v, lane);
    }
    __syncthreads();  // every warp's sums of the chunk are in `red`
    // 2c. The block's dB_t, dC_t of the chunk: its warps' sums added.
    for (int e = threadIdx.x; e < steps * kV; e += kCh) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * kL * kV + e];
      dbc_part[(static_cast<size_t>(blockIdx.x) * gridDim.y * S + row0 + t0) * kV + e] = s;
    }
    __syncthreads();  // `red` is free for the next chunk
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (j < n) {
        da_part[hoff + j] = dA[j] * A[j];
        dh0[hoff + j] = g[j];
      }
    }
    dd_part[static_cast<size_t>(b) * di + i] = dD;
  }
}

template <typename T>
cudaError_t launch(dim3 grid, cudaStream_t st, const void* x, const void* dt,
                   const float* bc, const float* a_log, const float* d, const float* h0,
                   const float* dy, const float* dh_last, float* hck, void* dx, void* ddt,
                   float* dbc_part, float* da_part, float* dd_part, float* dh0, int S, int di,
                   int n) {
  auto* kernel = scan_bwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kCh, kSmem, st>>>(static_cast<const T*>(x), static_cast<const T*>(dt), bc,
                                   a_log, d, h0, dy, dh_last, hck, static_cast<T*>(dx),
                                   static_cast<T*>(ddt), dbc_part, da_part,
                                   dd_part, dh0, S, di, n);
  return cudaGetLastError();
}

}  // namespace

// bf16: 1 when x and dt are bfloat16 (and dx, ddt are written in bfloat16),
// 0 when all four are float32.  channels
// and chunk are the wrapper's sizes of dbc_part's blocks (channels a block)
// and of hck's chunks (steps a chunk): refused unless they are this
// kernel's kCh and kL.  hck holds B * ceil(S / chunk) * 16 * di floats,
// dbc_part ceil(di / channels) * B * S * 32.
extern "C" int mamba_scan_bwd_launch(const void* x, const void* dt, const void* bc,
                                     const void* a_log, const void* d, const void* h0,
                                     const void* dy, const void* dh_last, void* hck, void* dx,
                                     void* ddt, void* dbc_part, void* da_part, void* dd_part,
                                     void* dh0, int B, int S, int di, int n, int bf16,
                                     int channels, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0 || n <= 0 || n > NS || B > 65535 || channels != kCh ||
      chunk != kL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((di + kCh - 1) / kCh, B);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(grid, st, x, dt, f(bc), f(a_log), f(d), f(h0), f(dy),
                                   f(dh_last), o(hck), dx, ddt, o(dbc_part),
                                   o(da_part), o(dd_part), o(dh0), S, di, n)
           : launch<float>(grid, st, x, dt, f(bc), f(a_log), f(d), f(h0), f(dy), f(dh_last),
                           o(hck), dx, ddt, o(dbc_part), o(da_part), o(dd_part),
                           o(dh0), S, di, n);
  return static_cast<int>(err);
}
