// replaces repro/kernels/coded_grad.py::_coded_grad_kernel (coded_grad, coded_grad_mc)
//
// The fused worker step of CodedPrivateML (paper Eq. 20) for ALL N workers
// in one launch:
//     out[n] = X̃_nᵀ ḡ(X̃_n W̃_n) mod p,   X̃ (N, mk, d), W̃ (N, d, c, r) -> (N, d, c)
// with ḡ(z) = c̄0 + sum_i c̄_i prod_{j<=i} z_j per head.
//
// What bounds it on an H100: bytes for the paper's binary task (c = 1,
// r = 1: four multiply-adds per 4-byte share element), the uint64
// multiply-adds when c*r grows (c = 10, r = 2: 60 per element).  X̃ is the
// only large operand (239 MB at the paper's Case 1), so the design streams
// it in row blocks:
//   grid (row block, worker); each block of kThreads threads owns kRows rows
//   1. Z_b = X̃_b W̃ mod p: one warp per row, lanes stride over d (coalesced),
//      W̃ is passed transposed (c*r, d) so its reads coalesce too; lane sums
//      are reduced mod p and added across the warp with shuffles.
//   2. the c polynomial heads of every row, with mulmod, into shared memory.
//   3. X̃_bᵀ S_b: one thread per column k re-reads its column of the block
//      (mostly from L1/L2: the block has just streamed it) and adds each
//      head's residue (< p) into a uint64 scratch (N, d, c) with atomicAdd.
// Blocks run in parallel in no order, so the TPU's (c, d) accumulator that
// a sequential grid carries is replaced by the atomics plus a finishing
// kernel that takes % p.  Integer addition is associative: the result does
// not depend on the order of the atomics.  A plain int32 atomicAdd would
// not be a mod-p add; the uint64 scratch holds at most ceil(mk/kRows)
// residues per entry.
//
// Every uint64 accumulator is reduced mod p at least every R terms
// (field.cuh).  Ragged row blocks are masked.  A single pass over X̃ (the
// TPU kernel's design) and the 8-bit-limb tensor-core path are left to a
// later speed-up.
#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;  // X̃ rows per block

template <int CR>  // CR >= c * r: compile-time bound of the register arrays
__global__ void __launch_bounds__(kThreads)
coded_grad_kernel(const uint32_t* __restrict__ X, const uint32_t* __restrict__ Wt,
                  const uint32_t* __restrict__ cbar,
                  unsigned long long* __restrict__ acc_out, int mk, int d, int c,
                  int r, uint32_t p, int reduce_every) {
  __shared__ uint32_t z_s[kRows][CR];
  __shared__ uint32_t s_s[kRows][CR];
  const int n = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, mk - row0);
  const int cr = c * r;
  const uint32_t* x = X + (static_cast<size_t>(n) * mk + row0) * d;
  const uint32_t* w = Wt + static_cast<size_t>(n) * cr * d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // 1. Z_b = X̃_b W̃ mod p.
  const long long span = 32LL * reduce_every;  // each lane adds reduce_every terms
  for (int i = warp; i < rows; i += kWarps) {
    const uint32_t* xr = x + static_cast<size_t>(i) * d;
    uint64_t z[CR];
#pragma unroll
    for (int j = 0; j < CR; ++j) z[j] = 0;
    for (long long k0 = lane; k0 < d; k0 += span) {
      const long long kend = min(static_cast<long long>(d), k0 + span);
      for (long long k = k0; k < kend; k += 32) {
        const uint32_t xv = __ldg(xr + k);
#pragma unroll
        for (int j = 0; j < CR; ++j)
          if (j < cr) z[j] = fp_mac(z[j], xv, __ldg(w + static_cast<size_t>(j) * d + k));
      }
#pragma unroll
      for (int j = 0; j < CR; ++j) z[j] %= p;
    }
#pragma unroll
    for (int j = 0; j < CR; ++j) {
      if (j < cr) {  // uniform across the warp
        uint64_t v = z[j];  // 32 residues sum to < 32p
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) z_s[i][j] = static_cast<uint32_t>(v % p);
      }
    }
  }
  __syncthreads();

  // 2. s[row][h] = c̄0 + sum_e c̄_e prod_{j<=e} z[row][h*r + j - 1].
  for (int idx = threadIdx.x; idx < rows * c; idx += kThreads) {
    const int i = idx / c, h = idx % c;
    uint32_t s = __ldg(cbar), prod = 0;
    for (int e = 1; e <= r; ++e) {
      const uint32_t ze = z_s[i][h * r + e - 1];
      prod = (e == 1) ? ze : fp_mul(prod, ze, p);
      s = fp_add(s, fp_mul(__ldg(cbar + e), prod, p), p);
    }
    s_s[i][h] = s;
  }
  __syncthreads();

  // 3. out[n, k, h] += sum_rows X̃[row, k] s[row, h].
  for (int k = threadIdx.x; k < d; k += kThreads) {
    uint64_t acc[CR];
#pragma unroll
    for (int h = 0; h < CR; ++h) acc[h] = 0;
    int since = 0;
    for (int i = 0; i < rows; ++i) {
      if (since == reduce_every) {
#pragma unroll
        for (int h = 0; h < CR; ++h) acc[h] %= p;
        since = 0;
      }
      const uint32_t xv = __ldg(x + static_cast<size_t>(i) * d + k);
#pragma unroll
      for (int h = 0; h < CR; ++h)
        if (h < c) acc[h] = fp_mac(acc[h], xv, s_s[i][h]);
      ++since;
    }
    unsigned long long* o = acc_out + (static_cast<size_t>(n) * d + k) * c;
#pragma unroll
    for (int h = 0; h < CR; ++h)
      if (h < c) atomicAdd(o + h, static_cast<unsigned long long>(acc[h] % p));
  }
}

__global__ void coded_grad_finish_kernel(const unsigned long long* __restrict__ acc,
                                         uint32_t* __restrict__ out, long long total,
                                         uint32_t p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < total) out[i] = static_cast<uint32_t>(acc[i] % p);
}

}  // namespace

// x (N, mk, d), wt (N, c*r, d), cbar (r+1,) int32; scratch (N, d, c) 8-byte
// words; out (N, d, c) int32.  Two launches on `stream`, no allocation.
extern "C" int coded_grad_launch(const void* x, const void* wt, const void* cbar,
                                 void* scratch, void* out, int N, int mk, int d,
                                 int c, int r, unsigned int p, int reduce_every,
                                 void* stream) {
  const int cr = c * r;
  if (N <= 0 || mk <= 0 || d <= 0 || c <= 0 || r <= 0 || cr > 32 || N > 65535 ||
      reduce_every < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(N) * d * c;
  cudaError_t err = cudaMemsetAsync(scratch, 0, total * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((mk + kRows - 1) / kRows, N);
  const uint32_t* xp = static_cast<const uint32_t*>(x);
  const uint32_t* wp = static_cast<const uint32_t*>(wt);
  const uint32_t* cp = static_cast<const uint32_t*>(cbar);
  unsigned long long* ap = static_cast<unsigned long long*>(scratch);
#define CODED_GRAD_LAUNCH(CRV)                                                     \
  coded_grad_kernel<CRV><<<grid, kThreads, 0, s>>>(xp, wp, cp, ap, mk, d, c, r, p, \
                                                   reduce_every)
  if (cr <= 1) CODED_GRAD_LAUNCH(1);
  else if (cr <= 2) CODED_GRAD_LAUNCH(2);
  else if (cr <= 4) CODED_GRAD_LAUNCH(4);
  else if (cr <= 8) CODED_GRAD_LAUNCH(8);
  else if (cr <= 16) CODED_GRAD_LAUNCH(16);
  else CODED_GRAD_LAUNCH(32);
#undef CODED_GRAD_LAUNCH
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int fin_threads = 256;
  const auto fin_blocks = static_cast<unsigned int>((total + fin_threads - 1) / fin_threads);
  coded_grad_finish_kernel<<<fin_blocks, fin_threads, 0, s>>>(
      ap, static_cast<uint32_t*>(out), total, p);
  return static_cast<int>(cudaGetLastError());
}
