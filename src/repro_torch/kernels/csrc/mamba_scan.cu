// replaces repro/kernels/mamba_scan.py::_scan_kernel (selective_scan)
//
// Mamba-1 selective scan over the whole sequence, for every (batch b,
// channel i, state j):
//     h_t = exp(dt_t[i] * A[i,j]) * h_{t-1} + (dt_t[i] * x_t[i]) * B_t[j]
//     y_t[i] = sum_j h_t[i,j] * C_t[j] + D[i] * x_t[i],   A = -exp(A_log)
// x (B,S,di) float32 or bfloat16, dt (B,S,di) float32, Bm, Cm (B,S,n)
// float32, A_log (di,n), D (di,), h0 (B,di,n) float32, all contiguous;
// y (B,S,di) and h_last (B,di,n) float32.  Any B, S >= 1, di, and n <= 16.
//
// What bounds it on an H100: the exp.  At the serve shape (B 4, S 2048,
// di 8192, n 16) the scan needs B*S*di*n = 1.07e9 exp, one multi-function
// unit op each (16 per clock per SM), against 0.68 GB of operands and
// results; the exp takes longer than the bytes.  This first version is the
// simple one: one thread per (b, i, j), 16 lanes per channel, h in a
// register for the whole sequence, the sequence walked in order, y_t a
// shuffle-sum over the channel's lanes.  x and dt tiles of kTile steps x
// kChannels channels are staged through shared memory so that their loads
// and the stores of y coalesce across channels; B_t and C_t are staged
// beside them.  The TPU kernel carried h across a sequential grid axis in
// VMEM scratch; here the time loop inside the block takes that axis' place.
// Lanes j >= n and channels i >= di compute on zeros and store nothing.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;                    // state lanes per channel: n <= 16
constexpr int kChannels = 16;                 // channels per block
constexpr int kThreads = kLanes * kChannels;  // 256
constexpr int kTile = 64;                     // time steps staged per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename XT>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const XT* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ bm, const float* __restrict__ cm,
            const float* __restrict__ a_log, const float* __restrict__ dvec,
            const float* __restrict__ h0, float* __restrict__ y,
            float* __restrict__ h_last, int S, int di, int n) {
  __shared__ float x_s[kTile][kChannels];
  __shared__ float dt_s[kTile][kChannels];
  __shared__ float b_s[kTile][kLanes];
  __shared__ float c_s[kTile][kLanes];
  __shared__ float y_s[kTile][kChannels];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int ch = threadIdx.x / kLanes;  // channel within the block
  const int j = threadIdx.x % kLanes;   // state index
  const int i = c0 + ch;
  const bool live = i < di && j < n;
  const size_t hoff = (static_cast<size_t>(b) * di + i) * n + j;
  const float A = live ? -expf(a_log[static_cast<size_t>(i) * n + j]) : 0.f;
  const float Dv = i < di ? dvec[i] : 0.f;
  float h = live ? h0[hoff] : 0.f;
  const size_t row0 = static_cast<size_t>(b) * S;  // row of (b, t = 0)

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int steps = min(kTile, S - t0);
    __syncthreads();  // the previous tile's y_s has been stored
    for (int e = threadIdx.x; e < kTile * kChannels; e += kThreads) {
      const int tt = e / kChannels, cc = e % kChannels, gi = c0 + cc;
      float xv = 0.f, dv = 0.f;
      if (tt < steps && gi < di) {
        const size_t off = (row0 + t0 + tt) * di + gi;
        xv = to_f32(x[off]);
        dv = dt[off];
      }
      x_s[tt][cc] = xv;
      dt_s[tt][cc] = dv;
    }
    for (int e = threadIdx.x; e < kTile * kLanes; e += kThreads) {
      const int tt = e / kLanes, jj = e % kLanes;
      float bv = 0.f, cv = 0.f;
      if (tt < steps && jj < n) {
        const size_t off = (row0 + t0 + tt) * n + jj;
        bv = bm[off];
        cv = cm[off];
      }
      b_s[tt][jj] = bv;
      c_s[tt][jj] = cv;
    }
    __syncthreads();
    for (int tt = 0; tt < steps; ++tt) {
      const float xt = x_s[tt][ch], dtt = dt_s[tt][ch];
      h = expf(dtt * A) * h + (dtt * xt) * b_s[tt][j];
      float part = h * c_s[tt][j];
      part += __shfl_xor_sync(0xffffffffu, part, 8);
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (j == 0) y_s[tt][ch] = part + Dv * xt;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < steps * kChannels; e += kThreads) {
      const int tt = e / kChannels, cc = e % kChannels, gi = c0 + cc;
      if (gi < di) y[(row0 + t0 + tt) * di + gi] = y_s[tt][cc];
    }
  }
  if (live) h_last[hoff] = h;
}

}  // namespace

// x_bf16: 1 when x is bfloat16, 0 when it is float32.
extern "C" int mamba_scan_launch(const void* x, const void* dt, const void* bm,
                                 const void* cm, const void* a_log, const void* d,
                                 const void* h0, void* y, void* h_last, int B, int S,
                                 int di, int n, int x_bf16, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0 || n <= 0 || n > kLanes || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((di + kChannels - 1) / kChannels, B);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* bmp = static_cast<const float*>(bm);
  const auto* cmp = static_cast<const float*>(cm);
  const auto* alp = static_cast<const float*>(a_log);
  const auto* dp = static_cast<const float*>(d);
  const auto* h0p = static_cast<const float*>(h0);
  auto* yp = static_cast<float*>(y);
  auto* hlp = static_cast<float*>(h_last);
  if (x_bf16)
    scan_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), dtp, bmp, cmp, alp, dp, h0p, yp, hlp, S,
        di, n);
  else
    scan_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x), dtp,
                                                   bmp, cmp, alp, dp, h0p, yp, hlp,
                                                   S, di, n);
  return static_cast<int>(cudaGetLastError());
}
