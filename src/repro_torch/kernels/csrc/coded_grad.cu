// replaces repro/kernels/coded_grad.py::_coded_grad_kernel (coded_grad, coded_grad_mc)
//
// The fused worker step of CodedPrivateML (paper Eq. 20) for ALL N workers:
//     out[n] = X̃_nᵀ ḡ(X̃_n W̃_n) mod p,   X̃ (N, mk, d), W̃ (N, d, c, r) -> (N, d, c)
// with ḡ(z) = c̄0 + sum_e c̄_e prod_{j<=e} z_j per head, any c and r.
//
// What bounds it on an H100: bytes for the paper's binary task (c = 1,
// r = 1: two multiply-adds per 4-byte element of X̃, which is 239 MB at
// Case 1), the 32x32 -> 64 integer multiply-adds when heads grow (c = 10,
// r = 2: thirty per element).  So X̃ comes from device memory once, and
// each multiply-add costs one IMAD.WIDE and little else.  This design:
//
//  * Persistent blocks, grid (splits, N), two to an SM.  Block (s, n)
//    walks its share of worker n's row tiles (kernels/coded_grad.py: plan
//    sizes rows, stages, splits and shared memory from the card's SM
//    count).  Each tile of `rows` rows x d is copied into shared memory
//    once by 16-byte cp.async (the stage is shifted by the tile's word
//    offset mod 4, so any d works; 4-byte copies at the ends), through a
//    ring of `stages` tiles, so the next tile streams in while this one
//    is computed.  Steps 1 and 3 both read the tile from there.
//  * Heads in groups of whole heads (`group` heads, group*r columns of Z),
//    all groups over the same staged tile, so X̃ is read once whatever c
//    and r are.  Per group:
//    1. Z = X̃_tile W̃_group in column chunks of CH (1, 2 or 4, a template)
//       and register blocks of kRB rows: thread t owns columns k ≡ t (mod
//       threads), keeps several columns' loads in flight (unrolled), loads
//       each W̃ value once per register block and chunk (not once per
//       row; CH values in one 8- or 16-byte load where aligned) and keeps
//       kRB x CH uint64 sums.  Then a butterfly across the warp (each
//       step halves the values a lane holds) and a sum over warps: raw
//       uint64 adds where d (p-1)^2 < 2^64 (P at Case 1), else Barrett
//       residues added mod p.
//    2. the group's polynomial heads per row, into shared memory.
//    3. part[k, h] += sum_rows X̃[row, k] s[row, h]: thread t again owns
//       columns k ≡ t, so each (k, h) residue is private to one thread
//       across all tiles; it is kept in shared memory when d x c words fit
//       (c = 1: 6 KB at Case 1), else in the block's own slot of the
//       scratch (or in `out` when there is one split), which stays in L2.
//  * No atomics, no memset, no copy of W̃ (read in its (N, d, c, r)
//    layout).  With one split the block writes `out` itself: one launch.
//    With more, each block writes its residues to its (splits, N, d, c)
//    slot and a second kernel sums the slots mod p: two launches.
//  * No 64-bit `%` (field.cuh): step 1's sums fold by 2^32 mod p every
//    fold_every products; every reduction to a residue is Barrett's.
//    Step 3 adds at most kRB products to a residue before reducing it,
//    which stays below 2^64 for p < 2^30.
//  * Where two stages of TILE_ROWS rows do not fit, the plan takes fewer
//    rows, then one stage of one row; where not even one row of d can be
//    staged (4·d above the shared-memory opt-in, d > ~58,000), it takes
//    the re-read route (stages = 0): each tile is read from global memory
//    by both steps, so X̃ comes from device memory (or L2) twice.  No
//    configuration in the repo reaches that route.
// The only limits on the shapes are N <= 65535 (a grid dimension) and
// device memory.  The 8-bit-limb tensor-core path is not taken.
#include "field.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRB = 8;  // rows of a register block (steps 1 and 3)

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Sums for the warp reduction: residues add mod p; raw uint64 sums (whose
// total stays below 2^64) add as they are.
__device__ __forceinline__ uint32_t sum2(uint32_t a, uint32_t b, uint32_t p) {
  return fp_add(a, b, p);
}
__device__ __forceinline__ uint64_t sum2(uint64_t a, uint64_t b, uint32_t) { return a + b; }

// One halving step of the warp reduction over N values: lanes whose bit
// o = 16 N / V is set keep the upper half, the others the lower, and each
// adds the half its partner sends.  Recursion keeps every index a
// compile-time constant, so the values stay in registers.
template <int N, int V, typename T>
__device__ __forceinline__ void halve(T (&v)[V], int lane, uint32_t p) {
  if constexpr (N > 1) {
    constexpr int o = 16 * N / V;
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const T send = upper ? v[q] : v[q + N / 2];
      const T keep = upper ? v[q + N / 2] : v[q];
      v[q] = sum2(keep, __shfl_xor_sync(0xffffffffu, send, o), p);
    }
    halve<N / 2, V>(v, lane, p);
  }
}

// The warp's sums of V values: after log2(V) halving steps and the
// remaining xor steps, lane l holds the sum of value (l >> (5 - log2 V)).
template <int V, typename T>
__device__ __forceinline__ T warp_sum_many(T (&v)[V], int lane, uint32_t p) {
  halve<V, V>(v, lane, p);
  T s = v[0];
#pragma unroll
  for (int o = 16 / V; o >= 1; o >>= 1) s = sum2(s, __shfl_xor_sync(0xffffffffu, s, o), p);
  return s;
}

// CH consecutive words of W̃ in one 8- or 16-byte load (aligned pointer).
template <int CH>
__device__ __forceinline__ void load_w(const uint32_t* src, uint32_t (&w)[CH]) {
  if constexpr (CH == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (CH == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = __ldg(src);
  }
}

template <bool STAGED>
__device__ __forceinline__ uint32_t ldx(const uint32_t* p) {
  if constexpr (STAGED) return *p;
  else return __ldg(p);
}

}  // namespace

// The launch's shapes, plan and field constants (build.py: CodedGradParams).
struct CodedGradParams {
  int N, mk, d, c, r;
  int rows, stages, group, chunk, threads, splits, tiles_per, part_smem, smem;
  int raw;                 // d (p-1)^2 < 2^64 and d <= fold_every: step 1 sums unreduced
  unsigned int p;
  int fold_every;          // build.py: fold_every
  unsigned int c32;        // 2^32 mod p
  unsigned long long bm;   // floor(2^64 / p)
};
static_assert(sizeof(CodedGradParams) == 80, "layout shared with build.py");

namespace {

template <int CH, bool STAGED>
__global__ void __launch_bounds__(kMaxThreads, 2)
coded_grad_kernel(const uint32_t* __restrict__ X, const uint32_t* __restrict__ W,
                  const uint32_t* __restrict__ cbar, uint32_t* __restrict__ slot,
                  uint32_t* __restrict__ out, const CodedGradParams prm) {
  constexpr int V = kRB * CH;  // step 1's sums per thread
  constexpr int kUnroll = CH == 1 ? 4 : 2;  // columns a thread has in flight
  extern __shared__ __align__(16) uint32_t smem[];
  const int mk = prm.mk, d = prm.d, c = prm.c, r = prm.r, cr = c * r;
  const int rows = prm.rows, group = prm.group, threads = blockDim.x;
  const uint32_t p = prm.p, c32 = prm.c32;
  const unsigned long long bm = prm.bm;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, warps = threads / 32;
  const int n = blockIdx.y, s = blockIdx.x;
  const int gcols = group * r;  // Z columns of a full group

  // shared memory: [stages x stage words][2 x warps x V reduction uint64s]
  //                [z rows x gcols][s rows x group][part d x c when part_smem]
  const int stage_words = ((rows * d + 3) & ~3) + 4;
  uint32_t* ring = smem;
  uint64_t* red_s = reinterpret_cast<uint64_t*>(ring + (STAGED ? prm.stages * stage_words : 0));
  uint32_t* z_s = reinterpret_cast<uint32_t*>(red_s + 2 * warps * V);
  uint32_t* s_s = z_s + rows * gcols;
  uint32_t* part_s = s_s + rows * group;

  const size_t dc = static_cast<size_t>(d) * c;
  uint32_t* dest = prm.splits > 1 ? slot + (static_cast<size_t>(s) * prm.N + n) * dc
                                  : out + static_cast<size_t>(n) * dc;
  uint32_t* part = prm.part_smem ? part_s : dest;  // (d, c) residues, thread-private rows
  for (int k = tid; k < d; k += threads)
    for (int h = 0; h < c; ++h) part[static_cast<size_t>(k) * c + h] = 0;

  const uint32_t* xn = X + static_cast<size_t>(n) * mk * d;
  const uint32_t* wn = W + static_cast<size_t>(n) * d * cr;
  const int tiles = (mk + rows - 1) / rows;
  const int t_begin = s * prm.tiles_per;
  const int t_end = min(tiles, t_begin + prm.tiles_per);

  // Tile t's first word in shared memory: its ring stage, shifted by the
  // tile's word offset mod 4 so that shared and global addresses agree mod
  // 16 bytes and the copy can go 16 bytes at a time whatever d is.
  auto tile_x = [&](int t) -> const uint32_t* {
    const uint32_t* src = xn + static_cast<size_t>(t) * rows * d;
    if constexpr (STAGED) {
      const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
      return ring + (t % prm.stages) * stage_words + shift;
    } else {
      return src;
    }
  };
  // cp.async of tile t: 4-byte copies up to the first 16-byte boundary
  // and after the last, 16-byte copies between
  auto load_tile = [&](int t) {
    const int row0 = t * rows;
    const uint32_t* src = xn + static_cast<size_t>(row0) * d;
    uint32_t* dst = const_cast<uint32_t*>(tile_x(t));
    const int count = min(rows, mk - row0) * d;
    const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    const int head = min(count, (4 - shift) & 3);
    const int body = (count - head) & ~3;
    for (int e = tid; e < head; e += threads) cp_async4(dst + e, src + e);
    for (int e = head + 4 * tid; e < head + body; e += 4 * threads) cp_async16(dst + e, src + e);
    for (int e = head + body + tid; e < count; e += threads) cp_async4(dst + e, src + e);
  };

  if constexpr (STAGED) {
    for (int j = 0; j < prm.stages - 1; ++j) {
      if (t_begin + j < t_end) load_tile(t_begin + j);
      cp_async_commit();
    }
  }
  int buf = 0;  // which half of red_s the next reduction writes
  for (int t = t_begin; t < t_end; ++t) {
    if constexpr (STAGED) {
      const int ahead = t + prm.stages - 1;
      if (ahead < t_end) load_tile(ahead);
      cp_async_commit();  // an empty group past the end keeps the count uniform
      if (prm.stages == 2) cp_async_wait<1>();  // this thread's copies of tile t are done
      else cp_async_wait<0>();
      __syncthreads();
    }
    const uint32_t* xs = tile_x(t);
    const int trows = min(rows, mk - t * rows);

    for (int h_first = 0; h_first < c; h_first += group) {
      const int gh = min(group, c - h_first);  // heads of this group
      const int gc = gh * r;                   // its Z columns
      const uint32_t* wg = wn + h_first * r;
      // W̃'s CH values of a column in one load where they are aligned
      const bool wvec = CH > 1 && gc % CH == 0 &&
                        ((reinterpret_cast<uintptr_t>(wg) | static_cast<uintptr_t>(cr) * 4) %
                         (4 * CH)) == 0;

      // 1. Z[i, j] = sum_k X̃[i, k] W̃[k, j] mod p, j over the group's columns
      for (int rb = 0; rb < trows; rb += kRB) {
        for (int j0 = 0; j0 < gc; j0 += CH) {
          uint64_t acc[kRB][CH];
#pragma unroll
          for (int i = 0; i < kRB; ++i)
#pragma unroll
            for (int j = 0; j < CH; ++j) acc[i][j] = 0;
          int room = prm.fold_every;
#pragma unroll kUnroll
          for (int k = tid; k < d; k += threads) {
            if (room == 0) {
#pragma unroll
              for (int i = 0; i < kRB; ++i)
#pragma unroll
                for (int j = 0; j < CH; ++j) acc[i][j] = fp_fold(acc[i][j], c32);
              room = prm.fold_every;
            }
            --room;
            uint32_t xv[kRB], wv[CH];
#pragma unroll
            for (int i = 0; i < kRB; ++i)
              xv[i] = rb + i < trows ? ldx<STAGED>(xs + static_cast<size_t>(rb + i) * d + k) : 0u;
            const uint32_t* wk = wg + static_cast<size_t>(k) * cr + j0;
            if (wvec) {
              load_w<CH>(wk, wv);
            } else {
#pragma unroll
              for (int j = 0; j < CH; ++j) wv[j] = j0 + j < gc ? __ldg(wk + j) : 0u;
            }
#pragma unroll
            for (int i = 0; i < kRB; ++i)
#pragma unroll
              for (int j = 0; j < CH; ++j) acc[i][j] = fp_mac(acc[i][j], xv[i], wv[j]);
          }
          uint64_t* red = red_s + buf * warps * V;
          const int slot_of_lane = warp * V + lane / (32 / V);
          const bool writer = (lane & (32 / V - 1)) == 0;
          if (prm.raw) {  // the block's total of each sum fits uint64
            uint64_t v[V];
#pragma unroll
            for (int i = 0; i < kRB; ++i)
#pragma unroll
              for (int j = 0; j < CH; ++j) v[i * CH + j] = acc[i][j];
            const uint64_t wsum = warp_sum_many<V>(v, lane, p);
            if (writer) red[slot_of_lane] = wsum;
          } else {
            uint32_t v[V];
#pragma unroll
            for (int i = 0; i < kRB; ++i)
#pragma unroll
              for (int j = 0; j < CH; ++j) v[i * CH + j] = fp_reduce(acc[i][j], p, bm);
            const uint32_t wsum = warp_sum_many<V>(v, lane, p);
            if (writer) red[slot_of_lane] = wsum;
          }
          __syncthreads();
          if (tid < V) {
            uint64_t zsum = 0;  // warps <= 8 residues, or the raw total
            for (int q = 0; q < warps; ++q) zsum += red[q * V + tid];
            const int i = rb + tid / CH, j = j0 + tid % CH;
            if (i < trows && j < gc) z_s[i * gcols + j] = fp_reduce(zsum, p, bm);
          }
          buf ^= 1;  // the next reduction writes the other half: no second barrier
        }
      }
      __syncthreads();

      // 2. s[i, h] = c̄0 + sum_e c̄_e prod_{j<=e} Z[i, h*r + j - 1]
      for (int e = tid; e < trows * gh; e += threads) {
        const int i = e / gh, h = e % gh;
        const uint32_t* zi = z_s + i * gcols + h * r;
        uint32_t sv = __ldg(cbar), prod = 0;
        for (int q = 1; q <= r; ++q) {
          prod = q == 1 ? zi[0] : fp_reduce(static_cast<uint64_t>(prod) * zi[q - 1], p, bm);
          sv = fp_add(sv, fp_reduce(static_cast<uint64_t>(__ldg(cbar + q)) * prod, p, bm), p);
        }
        s_s[i * group + h] = sv;
      }
      __syncthreads();

      // 3. part[k, h] += sum_i X̃[i, k] s[i, h], kRB rows at a time: a
      //    residue plus kRB products < p + 8 (p-1)^2 < 2^64
      for (int h0 = 0; h0 < gh; h0 += CH) {
        for (int rb = 0; rb < trows; rb += kRB) {
          uint32_t sv[kRB][CH];
#pragma unroll
          for (int i = 0; i < kRB; ++i)
#pragma unroll
            for (int j = 0; j < CH; ++j)
              sv[i][j] = (rb + i < trows && h0 + j < gh) ? s_s[(rb + i) * group + h0 + j] : 0u;
#pragma unroll kUnroll
          for (int k = tid; k < d; k += threads) {
            uint32_t* pk = part + static_cast<size_t>(k) * c + h_first + h0;
            uint64_t acc[CH];
#pragma unroll
            for (int j = 0; j < CH; ++j) acc[j] = h0 + j < gh ? pk[j] : 0u;
#pragma unroll
            for (int i = 0; i < kRB; ++i) {
              const uint32_t xv =
                  rb + i < trows ? ldx<STAGED>(xs + static_cast<size_t>(rb + i) * d + k) : 0u;
#pragma unroll
              for (int j = 0; j < CH; ++j) acc[j] = fp_mac(acc[j], xv, sv[i][j]);
            }
#pragma unroll
            for (int j = 0; j < CH; ++j)
              if (h0 + j < gh) pk[j] = fp_reduce(acc[j], p, bm);
          }
        }
      }
    }
    __syncthreads();  // the stage is read; the next load may overwrite it
  }
  if (prm.part_smem) {
    for (int k = tid; k < d; k += threads)
      for (int h = 0; h < c; ++h)
        dest[static_cast<size_t>(k) * c + h] = part_s[static_cast<size_t>(k) * c + h];
  }
}

// out[i] = (sum over the splits of slot[s][i]) mod p.
__global__ void coded_grad_finish_kernel(const uint32_t* __restrict__ slot,
                                         uint32_t* __restrict__ out, long long total,
                                         int splits, uint32_t p, unsigned long long bm) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  uint64_t sum = 0;  // splits residues < 2^30 each
  for (int s = 0; s < splits; ++s) sum += __ldg(slot + s * total + i);
  out[i] = fp_reduce(sum, p, bm);
}

template <int CH, bool STAGED>
cudaError_t launch(const CodedGradParams& prm, cudaStream_t st, const uint32_t* x,
                   const uint32_t* w, const uint32_t* cbar, uint32_t* slot, uint32_t* out) {
  auto* kernel = coded_grad_kernel<CH, STAGED>;
  if (prm.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, prm.smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(prm.splits, prm.N);
  kernel<<<grid, prm.threads, prm.smem, st>>>(x, w, cbar, slot, out, prm);
  return cudaGetLastError();
}

}  // namespace

// x (N, mk, d), w (N, d, c, r), cbar (r+1,) int32; out (N, d, c) int32;
// slot (splits, N, d, c) int32 scratch when splits > 1, else unused.  One
// launch, or two when the rows are split, on `stream`; no allocation.
extern "C" int coded_grad_launch(const void* x, const void* w, const void* cbar,
                                 void* slot, void* out, const CodedGradParams* prm,
                                 void* stream) {
  const CodedGradParams& q = *prm;
  const int warps = q.threads / 32;
  const long long tiles = q.rows > 0 ? (q.mk + q.rows - 1) / q.rows : 0;
  if (q.N <= 0 || q.N > 65535 || q.mk <= 0 || q.d <= 0 || q.c <= 0 || q.r <= 0 ||
      q.rows < 1 || q.stages < 0 || q.stages > 2 || q.group < 1 || q.group > q.c ||
      (q.chunk != 1 && q.chunk != 2 && q.chunk != 4) || q.threads < 32 ||
      q.threads > kMaxThreads || q.threads % 32 != 0 || q.splits < 1 ||
      q.splits > 65535 || q.tiles_per < 1 ||
      static_cast<long long>(q.tiles_per) * q.splits < tiles ||
      static_cast<long long>(q.tiles_per) * (q.splits - 1) >= tiles || q.fold_every < 1 ||
      q.smem < 0 || (q.splits > 1 && slot == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the plan's shared bytes must hold what the kernel lays out
  const long long stage_words = ((static_cast<long long>(q.rows) * q.d + 3) & ~3LL) + 4;
  const long long need =
      4 * (q.stages * stage_words + 4LL * warps * kRB * q.chunk +
           static_cast<long long>(q.rows) * q.group * q.r + static_cast<long long>(q.rows) * q.group +
           (q.part_smem ? static_cast<long long>(q.d) * q.c : 0));
  if (need > q.smem) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const uint32_t*>(x);
  const auto* wp = static_cast<const uint32_t*>(w);
  const auto* cp = static_cast<const uint32_t*>(cbar);
  auto* sp = static_cast<uint32_t*>(slot);
  auto* op = static_cast<uint32_t*>(out);
  cudaError_t err;
  const bool staged = q.stages > 0;
#define CODED_GRAD_CASE(CHV)                                     \
  if (q.chunk == CHV)                                            \
    err = staged ? launch<CHV, true>(q, st, xp, wp, cp, sp, op)  \
                 : launch<CHV, false>(q, st, xp, wp, cp, sp, op);
  CODED_GRAD_CASE(1) else CODED_GRAD_CASE(2) else CODED_GRAD_CASE(4)
  else return static_cast<int>(cudaErrorInvalidValue);
#undef CODED_GRAD_CASE
  if (err != cudaSuccess || q.splits == 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(q.N) * q.d * q.c;
  const int fin_threads = 256;
  const auto fin_blocks = static_cast<unsigned int>((total + fin_threads - 1) / fin_threads);
  coded_grad_finish_kernel<<<fin_blocks, fin_threads, 0, st>>>(sp, op, total, q.splits,
                                                               q.p, q.bm);
  return static_cast<int>(cudaGetLastError());
}
