// replaces repro/kernels/modmatmul.py::_modmatmul_kernel (modmatmul)
//
// Exact C = (A @ B) mod p for int32 field elements, A (M, K), B (K, N),
// row-major, p < 2^30.
//
// What bounds it on an H100: bytes.  On the protocol's main path the
// contraction is skinny (K+T = 14 for the encodes, R = 40 for the decode)
// and N is wide (up to 1,495,872 columns for the dataset encode), so the
// work is a few multiply-adds per byte of B read and C written.  The design
// follows from that: tile the output COLUMNS first.  One thread owns one
// output column and walks all M rows in passes of kBM rows, so B's column
// is read from device memory once (the later passes find it in L1/L2) and
// every load and store of B and C is coalesced across the warp.  The small
// A tile (kBM x kBK) sits in shared memory and is read as a broadcast.
//
// Arithmetic: products are formed as uint64 (a*b < 2^60) and summed in
// uint64.  The accumulator is reduced mod p before it could exceed 2^64,
// i.e. at least every R = floor((2^64 - p) / (p-1)^2) terms (field.cuh):
// 76921 for P and 16 for P30.  The TPU kernel's bk <= 256 bound came from
// fp32 accumulation on the MXU and does not apply here.
#include "field.cuh"

namespace {

constexpr int kThreads = 256;  // output columns per block
constexpr int kBM = 16;        // output rows per pass (accumulators per thread)
constexpr int kBK = 16;        // contraction depth per A tile; kBM * kBK == kThreads

__global__ void __launch_bounds__(kThreads)
modmatmul_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
                 uint32_t* __restrict__ C, int M, int K, long long N, uint32_t p,
                 int reduce_every) {
  __shared__ uint32_t a_s[kBM][kBK];
  const long long n = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = n < N;
  const int ti = threadIdx.x / kBK;
  const int tk = threadIdx.x % kBK;
  for (int m0 = 0; m0 < M; m0 += kBM) {
    uint64_t acc[kBM];
#pragma unroll
    for (int i = 0; i < kBM; ++i) acc[i] = 0;
    int since = 0;  // terms added since the last reduction
    for (int k0 = 0; k0 < K; k0 += kBK) {
      __syncthreads();
      const int gm = m0 + ti, gk = k0 + tk;
      a_s[ti][tk] = (gm < M && gk < K) ? A[static_cast<size_t>(gm) * K + gk] : 0u;
      __syncthreads();
      if (since + kBK > reduce_every) {
#pragma unroll
        for (int i = 0; i < kBM; ++i) acc[i] %= p;
        since = 0;
      }
      if (live) {
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          const uint32_t b =
              (k0 + kk < K) ? __ldg(B + static_cast<size_t>(k0 + kk) * N + n) : 0u;
#pragma unroll
          for (int i = 0; i < kBM; ++i) acc[i] = fp_mac(acc[i], a_s[i][kk], b);
        }
      }
      since += kBK;
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < kBM; ++i)
        if (m0 + i < M)
          C[static_cast<size_t>(m0 + i) * N + n] = static_cast<uint32_t>(acc[i] % p);
    }
  }
}

}  // namespace

extern "C" int modmatmul_launch(const void* a, const void* b, void* c, int M, int K,
                                long long N, unsigned int p, int reduce_every,
                                void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || reduce_every < kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>((N + kThreads - 1) / kThreads));
  modmatmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(c), M, K, N, p, reduce_every);
  return static_cast<int>(cudaGetLastError());
}
