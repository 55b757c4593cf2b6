// replaces repro/kernels/modmatmul.py::_modmatmul_kernel (modmatmul)
//
// Exact C = (A @ B) mod p for int32 field elements, A (M, K), B (K, N),
// row-major, p < 2^30.
//
// What bounds it on an H100: bytes, where the card is filled.  On the main
// paths A is small and B wide: (40x14)(14x1,495,872) for the dataset
// encode, (6x5)(5x66,584,576) for the coded head's encode, and
// (4x4096)(4096x16256) for one coded-head shard per token.  That is a few
// multiply-adds per byte of B read and C written, so the kernel has to
// spend few instructions per multiply-add (no software 64-bit `% p` inside
// the sum), waste none on padding rows or depth, and keep enough loads in
// flight on all 132 SMs (the shard's 16,256 columns alone fill 64 blocks).
// This design:
//
//  * Rows as they are.  A thread owns CN output columns (1, or 4 with
//    128-bit loads and stores and kChunk rows of B in flight at once) and
//    RM rows, RM a template in {1, 2, 4, 8, 16} (at most 8 with 4
//    columns) chosen from M by the wrapper's plan (kernels/modmatmul.py); M > 16
//    is cut into row groups that run as neighbouring blocks, so B's tile
//    is read from device memory once and from L2 by the other groups.
//  * Depth as it is, and A staged once.  The block's A panel (RM rows of
//    its K-slice, at most kPanelWords words) sits in shared memory, loaded
//    once with one barrier pair, and is read as broadcast vector loads.
//  * The card filled.  When the columns give too few threads (the shard's
//    16,256), K is split across blocks: each slice writes its residues to a
//    (splits, M, N) buffer and a second small kernel sums them and reduces.
//    Integer sums do not depend on order, so the result is deterministic
//    and bit-equal.
//  * A fold in place of `%` (field.cuh): every fold_every products each
//    uint64 accumulator becomes lo + hi (2^32 mod p), one multiply-add; the
//    one true reduction per output is Barrett's.
// No tensor cores: at these shapes the byte bound leaves room for a few
// integer instructions per multiply-add on the CUDA cores.
#include "field.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kPanelWords = 8192;  // A panel in shared memory: 32 KB at most
constexpr int kChunk = 8;          // rows of B in flight per thread (CN == 4)

template <int RM>
__device__ __forceinline__ void load_rows(const uint32_t* src, uint32_t (&a)[RM]) {
  if constexpr (RM >= 4) {
#pragma unroll
    for (int q = 0; q < RM / 4; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[q];
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
    }
  } else if constexpr (RM == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    a[0] = v.x;
    a[1] = v.y;
  } else {
    a[0] = src[0];
  }
}

template <int CN>
__device__ __forceinline__ void load_cols(const uint32_t* src, uint32_t (&b)[CN]) {
  if constexpr (CN == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    b[0] = v.x;
    b[1] = v.y;
    b[2] = v.z;
    b[3] = v.w;
  } else {
    b[0] = __ldg(src);
  }
}

// acc[i][c] += a_s row (RM values, broadcast from shared memory) x b[c].
template <int RM, int CN>
__device__ __forceinline__ void mac_row(uint64_t (&acc)[RM][CN], const uint32_t* a_row,
                                        const uint32_t (&b)[CN]) {
  uint32_t a[RM];
  load_rows<RM>(a_row, a);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = fp_mac(acc[i][c], a[i], b[c]);
}

// Block bid: row group fastest, then column block, then K-slice.
template <int RM, int CN>
__global__ void __launch_bounds__(kMaxThreads)
modmatmul_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
                 uint32_t* __restrict__ out, int M, int K, long long N, int groups,
                 long long col_blocks, int slice, int panel, uint32_t p, int fold_every,
                 uint32_t c32, unsigned long long bm) {
  extern __shared__ __align__(16) uint32_t a_s[];  // [panel][RM]
  const long long bid = blockIdx.x;
  const int g = static_cast<int>(bid % groups);
  const long long rest = bid / groups;
  const long long cb = rest % col_blocks;
  const int s = static_cast<int>(rest / col_blocks);
  const int m0 = g * RM;
  const int k_begin = s * slice;
  const int k_end = min(K, k_begin + slice);
  const long long n0 = (cb * blockDim.x + threadIdx.x) * CN;
  const bool live = n0 < N;

  uint64_t acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0;
  int room = fold_every;  // products the accumulators take before a fold

  for (int kp = k_begin; kp < k_end; kp += panel) {
    const int kn = min(panel, k_end - kp);
    __syncthreads();  // the previous panel has been read
    for (int e = threadIdx.x; e < kn * RM; e += blockDim.x) {
      const int kk = e / RM, i = e % RM;
      a_s[e] = (m0 + i < M) ? __ldg(A + static_cast<size_t>(m0 + i) * K + kp + kk) : 0u;
    }
    __syncthreads();
    if (!live) continue;
    const uint32_t* bp = B + static_cast<size_t>(kp) * N + n0;  // row kp
    int kk = 0;
    while (kk < kn) {
      const int stop = min(kn, kk + room);
      room -= stop - kk;
      if constexpr (CN == 4) {
        // wide streams: kChunk rows of B per thread in flight together
        for (int k0 = kk; k0 < stop; k0 += kChunk) {
          const uint32_t* bk = bp + static_cast<size_t>(k0) * N;
          uint32_t b[kChunk][CN];
#pragma unroll
          for (int u = 0; u < kChunk; ++u)
            if (k0 + u < stop) load_cols<CN>(bk + static_cast<size_t>(u) * N, b[u]);
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            if (k0 + u >= stop) break;
            mac_row<RM, CN>(acc, a_s + (k0 + u) * RM, b[u]);
          }
        }
      } else {
        // one column: a plain loop, unrolled, keeps the deep K-slices fast
        const uint32_t* bk = bp + static_cast<size_t>(kk) * N;
#pragma unroll 4
        for (int k = kk; k < stop; ++k, bk += N) {
          uint32_t b[CN];
          load_cols<CN>(bk, b);
          mac_row<RM, CN>(acc, a_s + k * RM, b);
        }
      }
      kk = stop;
      if (room == 0) {
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int c = 0; c < CN; ++c) acc[i][c] = fp_fold(acc[i][c], c32);
        room = fold_every;
      }
    }
  }
  if (!live) return;
  out += static_cast<size_t>(s) * M * N;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (m0 + i >= M) break;
    uint32_t* o = out + static_cast<size_t>(m0 + i) * N + n0;
    if constexpr (CN == 4) {
      *reinterpret_cast<uint4*>(o) =
          make_uint4(fp_reduce(acc[i][0], p, bm), fp_reduce(acc[i][1], p, bm),
                     fp_reduce(acc[i][2], p, bm), fp_reduce(acc[i][3], p, bm));
    } else {
      o[0] = fp_reduce(acc[i][0], p, bm);
    }
  }
}

// out[i] = (sum over the K-slices of partial[s][i]) mod p.
__global__ void modmatmul_finish_kernel(const uint32_t* __restrict__ partial,
                                        uint32_t* __restrict__ out, long long total,
                                        int splits, uint32_t p, unsigned long long bm) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  uint64_t sum = 0;  // splits residues < 2^30 each
  for (int s = 0; s < splits; ++s) sum += __ldg(partial + s * total + i);
  out[i] = fp_reduce(sum, p, bm);
}

template <int RM, int CN>
cudaError_t launch(unsigned int blocks, int threads, int panel, cudaStream_t st,
                   const uint32_t* a, const uint32_t* b, uint32_t* out, int M, int K,
                   long long N, int groups, long long col_blocks, int slice, uint32_t p,
                   int fold_every, uint32_t c32, unsigned long long bm) {
  const size_t smem = static_cast<size_t>(panel) * RM * sizeof(uint32_t);
  modmatmul_kernel<RM, CN><<<blocks, threads, smem, st>>>(
      a, b, out, M, K, N, groups, col_blocks, slice, panel, p, fold_every, c32, bm);
  return cudaGetLastError();
}

}  // namespace

// The launch's shapes, plan and field constants (build.py: ModmatmulParams).
struct MatmulParams {
  int M, K;
  long long N;
  int rows, cols, threads, splits, slice;  // kernels/modmatmul.py: plan
  unsigned int p;
  int fold_every;          // build.py: fold_every
  unsigned int c32;        // 2^32 mod p
  unsigned long long bm;   // floor(2^64 / p)
};
static_assert(sizeof(MatmulParams) == 56, "layout shared with build.py");

// a (M, K), b (K, N), c (M, N) int32; partial (splits, M, N) int32 scratch
// when splits > 1, else unused.  One launch, or two when K is split, on
// `stream`; no allocation.
extern "C" int modmatmul_launch(const void* a, const void* b, void* c, void* partial,
                                const MatmulParams* prm, void* stream) {
  const int M = prm->M, K = prm->K, rows = prm->rows, cols = prm->cols;
  const int threads = prm->threads, splits = prm->splits, slice = prm->slice;
  const int fold_every = prm->fold_every;
  const long long N = prm->N;
  const uint32_t p = prm->p, c32 = prm->c32;
  const unsigned long long bm = prm->bm;
  const bool rows_ok = rows == 1 || rows == 2 || rows == 4 || rows == 8 || rows == 16;
  if (M <= 0 || K <= 0 || N <= 0 || !rows_ok || (cols != 1 && cols != 4) ||
      (cols == 4 && (N % 4 != 0 || rows > 8)) || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || splits < 1 || slice < 1 ||
      static_cast<long long>(slice) * splits < K ||
      static_cast<long long>(slice) * (splits - 1) >= K || fold_every < 1 ||
      (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (M + rows - 1) / rows;
  const long long col_threads = (N + cols - 1) / cols;
  const long long col_blocks = (col_threads + threads - 1) / threads;
  const long long blocks = static_cast<long long>(groups) * col_blocks * splits;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int panel = min(slice, kPanelWords / rows);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const uint32_t*>(a);
  const auto* bp = static_cast<const uint32_t*>(b);
  uint32_t* dst = static_cast<uint32_t*>(splits > 1 ? partial : c);
  const auto nb = static_cast<unsigned int>(blocks);
  cudaError_t err;
#define MODMATMUL_CASE(RMV, CNV)                                                      \
  if (rows == RMV && cols == CNV)                                                     \
    err = launch<RMV, CNV>(nb, threads, panel, st, ap, bp, dst, M, K, N, groups,     \
                           col_blocks, slice, p, fold_every, c32, bm);
  MODMATMUL_CASE(1, 1) else MODMATMUL_CASE(2, 1) else MODMATMUL_CASE(4, 1)
  else MODMATMUL_CASE(8, 1) else MODMATMUL_CASE(16, 1) else MODMATMUL_CASE(1, 4)
  else MODMATMUL_CASE(2, 4) else MODMATMUL_CASE(4, 4) else MODMATMUL_CASE(8, 4)
  else return static_cast<int>(cudaErrorInvalidValue);
#undef MODMATMUL_CASE
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(M) * N;
  const int fin_threads = 256;
  const auto fin_blocks = static_cast<unsigned int>((total + fin_threads - 1) / fin_threads);
  modmatmul_finish_kernel<<<fin_blocks, fin_threads, 0, st>>>(
      static_cast<const uint32_t*>(partial), static_cast<uint32_t*>(c), total, splits, p,
      bm);
  return static_cast<int>(cudaGetLastError());
}
