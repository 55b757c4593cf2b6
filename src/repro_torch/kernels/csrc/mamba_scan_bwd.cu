// Backward of the Mamba-1 selective scan of mamba_scan.cu, in its float32
// mode and in its bf16 a/b mode (kAB16, at the end of this note).
//
// The port's own kernel: the JAX package trains through its plain jnp
// chunked scan (repro/models/mamba.py: _chunk_scan), so no TPU kernel
// stands behind it; here every mamba layer's forward is the CUDA scan,
// and this is its gradient (kernels/mamba_scan.py: SelectiveScanFn).
//
// The forward, for every (batch b, channel i, state j), A = -exp(A_log):
//     a_t = exp(dt_t[i] A[i,j]),  h_t = a_t h_{t-1} + u_t B_t[j],  u_t = dt_t[i] x_t[i]
//     y_t[i] = sum_j C_t[j] h_t[j] + D[i] x_t[i]
// Given dy (B,S,di) and dh_last (B,di,n), the reverse recurrence
//     g_t = dy_t C_t + a_{t+1} g_{t+1},   g_{S-1} = dy_{S-1} C_{S-1} + dh_last
// (g_t = dL/dh_t) gives
//     dx_t      = dt_t sum_j g_t[j] B_t[j] + D dy_t
//     ddt_t     = x_t sum_j g_t[j] B_t[j] + sum_j g_t[j] h_{t-1}[j] a_t[j] A[j]
//     dB_t[j]   = sum_i g_t[j] u_t             dC_t[j] = sum_i dy_t h_t[j]
//     dA_log    = A sum_{b,t} g_t h_{t-1} a_t dt_t   (dA/dA_log = A)
//     dD        = sum_{b,t} dy_t x_t              dh0 = a_0 g_0
// Inputs as the forward's: x and dt (B,S,di) both float32 or both bf16; bc
// (B,S,2,16) float32, B_t and C_t zero-padded; A_log (di,n), D (di,), h0
// (B,di,n), dy (B,S,di) and dh_last (B,di,n) float32.  Outputs: dx, ddt
// (B,S,di) in x's and dt's dtype (computed in float32; bf16 stores round to
// nearest even); float32 dbc_part (blocks, B,S,2,16), each block's sums of
// dB_t and dC_t over its channels; da_part (B,chunks,di,16) and dd_part
// (B,chunks,di), each (batch row, chunk)'s dA_log and dD; dh0 (B,di,n).  The
// wrapper folds the partials with torch.sum, so the result does not depend
// on the order blocks run in: no atomics, and two calls give the same bits.
//
// The decomposition.  Both recurrences are first-order and linear, so the
// sequence is cut into chunks of L steps (the launch plan's `chunk`,
// kernels/mamba_scan.py: plan_bwd), run side by side and joined by a short
// carry pass.  Three launches on the caller's stream, in order:
//  1. scan_bwd_summary_kernel, per chunk c of steps f..l, from zero: the
//     local state hloc_c (the chunk's forward from h = 0), the adjoint sum
//     gamma_c = sum_t P_t dy_t C_t with P_t = a_f ... a_t, and
//     D_c = sum_t dt_t, so that P_c = a_f ... a_l = exp(D_c A).  One exp an
//     element.
//  2. scan_bwd_carry_kernel, one thread per (b, i, j), sequential over the
//     chunks only: the state entering each chunk, H_0 = h0 and
//     H_{c+1} = P_c H_c + hloc_c, and the adjoint entering it from the
//     right, Gamma_last = dh_last and Gamma_{c-1} = gamma_c + P_c Gamma_c
//     (Gamma_c = a_{l+1} g_{l+1}: what the reverse walk carries).  Written
//     in place of hloc and gamma.
//  3. scan_bwd_chunk_kernel, per chunk: the chunk's backward from H_c and
//     Gamma_c.  h_{t-1} is needed in reverse: the chunk's forward from H_c
//     checkpoints the state every kSub = 8 steps in shared memory (the last
//     sub-chunk needs none); then, sub-chunk by sub-chunk from the last, the
//     sub-chunk's forward again from its checkpoint keeps each h_{t-1} in
//     shared memory and the reverse walk carries g in registers.  dx and ddt
//     on the chunk's rows, the block's dB_t/dC_t sums on the chunk's rows
//     (no two blocks write one element), one dA_log and dD partial per
//     (b, chunk); chunk 0 writes dh0 = a_0 g_0.
// Exps: 1 + (L - kSub)/L + 2, just under 4 an element where one chunk over
// the whole sequence would take 3, spread over ceil(S / L) times as many
// threads.
//
// What bounds it on an H100: instruction issue, not bytes or exps.  At
// hymba's training shape (B 4, S 2048, di 3200, n 16: 4.2e8 elements) the
// bytes take 0.095 ms and the exps 0.40 ms at the multi-function unit's 16
// a clock per SM, but each element also costs about 40 other instructions
// (the summary ~8, the checkpoints and the recompute ~6 each, the reverse
// walk ~20 with its share of the channel sums): ~0.5 ms of issue at 4
// warp-instructions a clock per SM.  One thread per (b, channel) over the
// whole sequence would give that shape 12,800 threads, too few to hide
// each step's loads.  This design fills the card and keeps the issue
// slots busy:
//  * A quad of threads per (b, channel), 4 states a thread: a quarter of the
//    registers and of the shared-memory history a thread of 16 states
//    needs, so 5 blocks of 128 threads (20 warps) fit on an SM at L = 64
//    (__launch_bounds__ holds the registers to 102; ptxas uses 96, no
//    spills), and the grid has 1.6 million threads.  The sums over a
//    quad's states (dx, ddt) take 3 shuffles.
//  * x, dt, dy and B_t/C_t tiles of kSub steps come through a 2-stage
//    cp.async ring in shared memory (coalesced across the block's 32
//    channels), in the order the passes use them: sub-chunks 0..K-2 for the
//    checkpoints, then K-1..0.  Each thread's copies of a tile (one or two
//    16-byte chunks) are worked out once a block, so a tile costs a few
//    instructions.  B_t and C_t are read as broadcast 128-bit loads, x, dt
//    and dy as one word a quad.
//  * dB_t and dC_t sum over channels, which live in other lanes, warps and
//    blocks: each thread's 8 values (4 dB, 4 dC) are summed over the warp's
//    8 channels in 7 shuffles, a transposing butterfly that leaves each
//    lane with one of the warp's 32 sums; the block's 4 warps are added in
//    shared memory once a sub-chunk and written as one partial.
//  * The reverse walk takes dC's h_t from the history (the next step's
//    h_{t-1}) and g_t h_{t-1} a_t from the updated g: 10 operations a state.
//  * Rows past the end of the sequence are zero-filled, which makes them
//    identity steps (a = 1, u = 0, dy = 0), so every sub-chunk runs its kSub
//    steps unrolled; only the stores are guarded.
// Measured on an H100 (700 W) by chip_smoke.py at hymba's training shape,
// bf16: 1.05 ms from a CUDA graph, of which the chunk kernel 0.76, the
// summaries 0.19, the carries 0.04 and torch.sum's folds 0.06.
// The plan (kernels/mamba_scan.py: plan_bwd) picks L from {64, 32, 16, 8},
// the largest whose grid of (ceil(di/32), ceil(S/L), B) blocks covers the
// SMs twice at 5 blocks an SM (64 at the training shapes: L = 32 and 128
// were slower there); the C entry refuses channels, chunks and
// shared-memory sizes it was not built for.
//
// The bf16 a/b mode (RunConfig.ssm_dtype = "bf16", chunks of M steps):
// the forward rounds a_t = bf16(e_t), e_t = exp(dt_t A), and b_t =
// bf16((dt_t B_t) x_t), runs the chunk's products A_c <- bf16(a_t A_c),
// B_c <- bf16(bf16(a_t B_c) + b_t) from (1, 0) and takes h_t = A_c H_c +
// B_c from the state H_c entering the chunk.  Its gradient, every rounding
// straight-through (kernels/ref.py: selective_scan_bwd_ref), is the
// recurrence above with a_t rounded where it carries g and e_t where exp
// is differentiated (g_t h_{t-1} e_t), h_{t-1} the mode's, and one change
// at a chunk's start: H_c enters every h_t of its chunk through A_c,t, so
// the carry into the step before is Gamma_{c-1} = sum_t A_c,t dy_t C_t +
// A_c,last Gamma_c, Gamma_c the carry into the chunk's last step.  No
// closed form P_c = exp(D_c A) composes the mode's chunks (each step
// rounds), so the plan's chunks never span two of the mode's: M <= L is
// one plan chunk of M steps (any M, padded rows being identity steps in
// this mode too: bf16(1 A_c) = A_c, bf16(bf16(1 B_c) + 0) = B_c), and a
// longer M is cut into per = ceil(M / L) plan chunks of L steps (L a
// multiple of kSub).  The grid is (blocks * chunks, 1, B), so any number
// of chunks fits.  The three launches:
//  1. scan_bwd_summary_ab16_kernel, one block per (channel block, mode
//     chunk), in order over the chunk: A_c and B_c at its last step and
//     gamma_c (they do not depend on H_c); where it is cut, per plan chunk
//     the (A_c, B_c) entering it (bf16 pairs), P_s, the float32 product of
//     its rounded a_t, and gamma'_s = sum_t P_s,t dy_t C_t.
//  2. scan_bwd_carry_ab16_kernel: H_{c+1} = A_c,last H_c + B_c,last (the
//     product and sum rounded singly, as the forward carries h), Gamma_c,
//     dh0 = Gamma_{-1}, and inside a cut chunk the carry into each plan
//     chunk's last step, G <- gamma'_s + P_s G from Gamma_c.
//  3. scan_bwd_chunk_kernel<T, true>: the float32 mode's chunk kernel with
//     the mode's forward: it keeps H_c and checkpoints (A_c, B_c) as bf16
//     pairs (16 bytes a thread, the float32 mode's size), recomputes
//     h_{t-1} = A_c H_c + B_c into the history, and walks back with
//     a_t = bf16(e_t).
// Every forward value is recomputed with the forward kernel's operations
// (expf, the _rn products, never an FMA), so that a_t, b_t, A_c and B_c
// round as they did in the forward that ran.  The cotangents are float32.
// The mode costs more than the float32 mode: an exact expf and four bf16
// roundings a step in each pass, and its summaries walk a whole mode
// chunk.  Measured on an H100 (700 W) by chip_smoke.py at hymba's
// training shape, bf16, chunks of 128 (plan chunks of 64): 2.54 ms from a
// CUDA graph (the float32 mode 1.06 in the same run), of which the chunk
// kernel 1.73, the summaries 0.68, the carries 0.06 and the folds 0.06;
// 96 registers and no spills.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scan_common.cuh"

namespace {

constexpr int kQ = 4;                     // states a thread
constexpr int kQuads = NS / kQ;           // threads a channel
constexpr int kCh = 32;                   // channels a block
constexpr int kThreads = kCh * kQuads;    // 128
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 8;                   // steps a tile and a history
constexpr int kMaxChunk = 256;            // steps a chunk, at most
constexpr int kStages = 2;                // tiles in the ring
constexpr int kV = 2 * NS;                // dB_t and dC_t values a step
constexpr int kMinBlocks = 5;             // blocks an SM: registers <= 65536 / (5 * 128)
constexpr int kCarryThreads = 256;
static_assert(kV == 32 && kQ * kQuads == NS, "one dB/dC value per lane of a warp");

// One ring stage: kSub steps of B_t/C_t, x, dt (in T) and dy (float32).
template <typename T>
struct Tile {
  static constexpr size_t kX = kSub * kV * sizeof(float);
  static constexpr size_t kDt = kX + kSub * kCh * sizeof(T);
  static constexpr size_t kDy = kDt + kSub * kCh * sizeof(T);
  static constexpr size_t kBytes = kDy + kSub * kCh * sizeof(float);
};

constexpr size_t kHistBytes = static_cast<size_t>(kSub) * kThreads * sizeof(float4);
constexpr size_t kRedBytes = static_cast<size_t>(kWarps) * kSub * kV * sizeof(float);

// The chunk kernel's dynamic shared memory: ring, history, the warps' sums,
// and a checkpoint for each of the chunk's sub-chunks.
template <typename T>
constexpr size_t chunk_smem(int chunk) {
  return kStages * Tile<T>::kBytes + kHistBytes + kRedBytes +
         static_cast<size_t>(chunk / kSub) * kThreads * sizeof(float4);
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// One 16-byte copy that a thread makes of every tile of its chunk: tile k
// copies src + k stride to byte dst of the stage if its step tt is one of
// the tile's, else zero-fills it (tt = kSub: always); src null: no copy.
struct Copy {
  const char* src;
  size_t stride;
  unsigned dst;
  int tt;
};

// Copy e of the (kSub x kCh) tile of a (B,S,di) operand whose first row is
// `row`, to byte dst0 + 16 e of a stage.
template <typename U>
__device__ __forceinline__ Copy rows_copy(const U* src, size_t row, int e, int di, int c0,
                                          size_t dst0) {
  constexpr int E = 16 / sizeof(U);  // elements per 16-byte chunk
  constexpr int CPR = kCh / E;       // chunks per row of the tile
  const int tt = e / CPR, cc = (e % CPR) * E;
  const bool on = c0 + cc < di;
  return {reinterpret_cast<const char*>(src + (row + tt) * di + c0 + cc),
          static_cast<size_t>(kSub) * di * sizeof(U), static_cast<unsigned>(dst0 + 16 * e),
          on ? tt : kSub};
}

// The copies this thread makes of each tile of its chunk (first row `row`):
// copy 0 is B_t/C_t (threads 0-63) or dy (64-127), copy 1 x or dt or none.
template <typename T>
__device__ __forceinline__ void plan_copies(Copy (&cp)[2], const T* x, const T* dt,
                                            const float* dy, const float* bc, size_t row,
                                            int di, int c0) {
  constexpr int kBcCopies = kSub * kV / 4, kXCopies = kSub * kCh * sizeof(T) / 16;
  static_assert(kBcCopies == kThreads / 2 && kSub * kCh / 4 == kThreads / 2 &&
                    2 * kXCopies <= kThreads,
                "one B_t/C_t or dy copy a thread, at most one x or dt copy");
  const int t = threadIdx.x;
  if (t < kBcCopies)
    cp[0] = {reinterpret_cast<const char*>(bc + row * kV) + 16 * t,
             static_cast<size_t>(kSub) * kV * sizeof(float), static_cast<unsigned>(16 * t),
             t / (kV / 4)};
  else
    cp[0] = rows_copy(dy, row, t - kBcCopies, di, c0, Tile<T>::kDy);
  if (t < kXCopies)
    cp[1] = rows_copy(x, row, t, di, c0, Tile<T>::kX);
  else if (t < 2 * kXCopies)
    cp[1] = rows_copy(dt, row, t - kXCopies, di, c0, Tile<T>::kDt);
  else
    cp[1] = {nullptr, 0, 0, kSub};
}

__device__ __forceinline__ void issue(unsigned char* st, const Copy& c, int k, int steps,
                                      const void* safe) {
  if (c.src == nullptr) return;  // no copy (a zero-filling one would still write)
  const bool ok = c.tt < steps;
  cp_async16(st + c.dst, ok ? c.src + static_cast<size_t>(k) * c.stride : safe, ok);
}

// `steps` rows of the block's kCh channels of a (B,S,di) operand from `row`
// into a (kSub x kCh) tile with plain loads (rows not 16-byte aligned);
// rows past `steps` and channels past di are 0.
template <typename U>
__device__ __forceinline__ void load_rows(U* dst, const U* __restrict__ src, size_t row,
                                          int steps, int di, int c0) {
  for (int e = threadIdx.x; e < kSub * kCh; e += kThreads) {
    const int tt = e / kCh, cc = e % kCh;
    const bool ok = tt < steps && c0 + cc < di;
    dst[e] = ok ? src[(row + tt) * di + c0 + cc] : static_cast<U>(0.f);
  }
}

// Tile k of the chunk (first row `row`), its first `steps` <= kSub steps,
// into the stage st; then commits a group.  vec: cp.async of 16-byte chunks (the
// copies cp); else B_t/C_t by cp.async and the rest by plain loads.
template <typename T>
__device__ __forceinline__ void load_tile(unsigned char* st, const Copy (&cp)[2], int k,
                                          int steps, bool vec, const T* __restrict__ x,
                                          const T* __restrict__ dt,
                                          const float* __restrict__ dy,
                                          const float* __restrict__ bc, size_t row, int di,
                                          int c0) {
  if (vec) {
    issue(st, cp[0], k, steps, bc);
    issue(st, cp[1], k, steps, bc);
  } else {
    if (threadIdx.x < kThreads / 2) issue(st, cp[0], k, steps, bc);
    const size_t r = row + static_cast<size_t>(k) * kSub;
    load_rows(reinterpret_cast<T*>(st + Tile<T>::kX), x, r, steps, di, c0);
    load_rows(reinterpret_cast<T*>(st + Tile<T>::kDt), dt, r, steps, di, c0);
    load_rows(reinterpret_cast<float*>(st + Tile<T>::kDy), dy, r, steps, di, c0);
  }
  cp_async_commit();
}

// What a thread reads of step tt of a tile: its channel's x, dt, dy and its
// quad's 4 states of B_t and C_t.
struct Step {
  float x, dt, dy, B[kQ], C[kQ];
};

template <typename T>
__device__ __forceinline__ Step read_step(const unsigned char* st, int tt, int ch, int q) {
  Step s;
  s.x = to_f32(reinterpret_cast<const T*>(st + Tile<T>::kX)[tt * kCh + ch]);
  s.dt = to_f32(reinterpret_cast<const T*>(st + Tile<T>::kDt)[tt * kCh + ch]);
  s.dy = reinterpret_cast<const float*>(st + Tile<T>::kDy)[tt * kCh + ch];
  const float* bcs = reinterpret_cast<const float*>(st) + tt * kV;
  const float4 bq = reinterpret_cast<const float4*>(bcs)[q];
  const float4 cq = reinterpret_cast<const float4*>(bcs + NS)[q];
  s.B[0] = bq.x; s.B[1] = bq.y; s.B[2] = bq.z; s.B[3] = bq.w;
  s.C[0] = cq.x; s.C[1] = cq.y; s.C[2] = cq.z; s.C[3] = cq.w;
  return s;
}

__device__ __forceinline__ float4 pack(const float (&v)[kQ]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void unpack(float4 p, float (&v)[kQ]) {
  v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
}

// v rounded to bfloat16 (to nearest even), as a float: mamba_scan.cu's bf16r.
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The bf16 a/b mode's running products of 4 states, each a bf16 value held
// in a float (its low 16 bits 0), as 4 (A_c, B_c) pairs in 16 bytes.
__device__ __forceinline__ uint4 pack_ab(const float (&Ac)[kQ], const float (&Bc)[kQ]) {
  uint32_t w[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k)
    w[k] = (__float_as_uint(Ac[k]) >> 16) | (__float_as_uint(Bc[k]) & 0xffff0000u);
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void unpack_ab(uint4 p, float (&Ac)[kQ], float (&Bc)[kQ]) {
  const uint32_t w[kQ] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    Ac[k] = __uint_as_float(w[k] << 16);
    Bc[k] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// One step of the bf16 a/b mode's forward for state k, as mamba_scan.cu's
// kAB16 computes it (expf and _rn products, never contracted into an FMA):
// a = bf16(e), e = exp(dt A); b = bf16((dt B) x); A_c <- bf16(a A_c),
// B_c <- bf16(bf16(a B_c) + b).  Returns a.
__device__ __forceinline__ float ab_step(float dt, float x, float Bk, float A, float& Ac,
                                         float& Bc) {
  const float a = bf16r(expf(__fmul_rn(dt, A)));
  const float b = bf16r(__fmul_rn(__fmul_rn(dt, Bk), x));
  Ac = bf16r(__fmul_rn(a, Ac));
  Bc = bf16r(__fadd_rn(bf16r(__fmul_rn(a, Bc)), b));
  return a;
}

// The mode's state from the chunk's first state H: A_c H + B_c, unfused.
__device__ __forceinline__ float ab_state(float Ac, float H, float Bc) {
  return __fadd_rn(__fmul_rn(Ac, H), Bc);
}

// A = -exp(A_log) of the thread's 4 states; 0 for states j >= n and
// channels past di, which then run on zeros and store nothing.
__device__ __forceinline__ void load_A(const float* __restrict__ a_log, int i, int q, int n,
                                       bool live, float (&A)[kQ]) {
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int j = kQ * q + k;
    A[k] = (live && j < n) ? -expf(a_log[static_cast<size_t>(i) * n + j]) : 0.f;
  }
}

// kSub forward steps of the thread's states from h; with kKeep, each
// h_{t-1} to hist[tt kThreads].
template <bool kKeep, typename T>
__device__ __forceinline__ void forward(const unsigned char* st, int ch, int q,
                                        const float (&A)[kQ], float (&h)[kQ], float4* hist) {
#pragma unroll
  for (int tt = 0; tt < kSub; ++tt) {
    const Step s = read_step<T>(st, tt, ch, q);
    if constexpr (kKeep) hist[tt * kThreads] = pack(h);
    const float u = s.dt * s.x, dl = s.dt * kLog2e;
#pragma unroll
    for (int k = 0; k < kQ; ++k) h[k] = fmaf(ex2(dl * A[k]), h[k], u * s.B[k]);
  }
}

// kSub forward steps of the bf16 a/b mode from the running products Ac,
// Bc (the chunk's first state H); with kKeep, each h_{t-1} = A_c H + B_c to
// hist[tt kThreads], and h the last step's h_t.
template <bool kKeep, typename T>
__device__ __forceinline__ void forward_ab(const unsigned char* st, int ch, int q,
                                           const float (&A)[kQ], const float (&H)[kQ],
                                           float (&Ac)[kQ], float (&Bc)[kQ], float (&h)[kQ],
                                           float4* hist) {
#pragma unroll
  for (int tt = 0; tt < kSub; ++tt) {
    const Step s = read_step<T>(st, tt, ch, q);
    if constexpr (kKeep) {
#pragma unroll
      for (int k = 0; k < kQ; ++k) h[k] = ab_state(Ac[k], H[k], Bc[k]);
      hist[tt * kThreads] = pack(h);
    }
#pragma unroll
    for (int k = 0; k < kQ; ++k) ab_step(s.dt, s.x, s.B[k], A[k], Ac[k], Bc[k]);
  }
  if constexpr (kKeep) {
#pragma unroll
    for (int k = 0; k < kQ; ++k) h[k] = ab_state(Ac[k], H[k], Bc[k]);
  }
}

// The transposing butterfly's level over lane bit W on 2H values: lanes with
// the bit set keep the upper half, the others the lower, each adding its
// partner's copy of the half it keeps.
template <int W, int H>
__device__ __forceinline__ void fold(float (&v)[2 * kQ], int lane) {
  const bool up = lane & W;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = up ? v[k] : v[k + H];
    const float keep = up ? v[k + H] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_bwd_summary_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                        const float* __restrict__ bc, const float* __restrict__ a_log,
                        const float* __restrict__ dy, float* __restrict__ hsum,
                        float* __restrict__ gsum, float* __restrict__ dsum, int S, int di,
                        int n, int chunk, bool vec) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int b = blockIdx.z, c = blockIdx.y, nck = gridDim.y;
  const int c0 = blockIdx.x * kCh, ch = threadIdx.x / kQuads, q = threadIdx.x % kQuads;
  const int i = c0 + ch;
  const bool live = i < di;
  const int f = c * chunk, steps = min(chunk, S - f), K = (steps + kSub - 1) / kSub;
  const size_t row = static_cast<size_t>(b) * S + f;

  float A[kQ], h[kQ], P[kQ], gm[kQ];
  load_A(a_log, i, q, n, live, A);
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    h[k] = 0.f;
    P[k] = 1.f;
    gm[k] = 0.f;
  }
  float D = 0.f;
  Copy cp[2];
  plan_copies(cp, x, dt, dy, bc, row, di, c0);
  auto load = [&](int k) {
    if (k < K)
      load_tile(ring + (k % kStages) * Tile<T>::kBytes, cp, k, min(kSub, steps - k * kSub),
                vec, x, dt, dy, bc, row, di, c0);
    else
      cp_async_commit();
  };
  load(0);
  for (int k = 0; k < K; ++k) {
    cp_async_wait_all();
    __syncthreads();  // tile k is in; tile k-1's slot is free
    load(k + 1);
    const unsigned char* st = ring + (k % kStages) * Tile<T>::kBytes;
#pragma unroll
    for (int tt = 0; tt < kSub; ++tt) {
      const Step s = read_step<T>(st, tt, ch, q);
      const float u = s.dt * s.x, dl = s.dt * kLog2e;
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const float a = ex2(dl * A[j]);
        P[j] *= a;
        h[j] = fmaf(a, h[j], u * s.B[j]);
        gm[j] = fmaf(P[j], s.dy * s.C[j], gm[j]);
      }
      D += s.dt;
    }
  }
  if (live) {
    const size_t r = (static_cast<size_t>(b) * nck + c) * di + i;
    reinterpret_cast<float4*>(hsum + r * NS)[q] = pack(h);
    reinterpret_cast<float4*>(gsum + r * NS)[q] = pack(gm);
    if (q == 0) dsum[r] = D;
  }
}

// The bf16 a/b mode's summaries, one block per (channel block, mode chunk
// c, b) on a grid of (blocks * mode chunks, 1, B): the chunk's forward from
// A_c = 1, B_c = 0 (which does not depend on the state entering it), in
// order over its steps.  Writes A_c and B_c of its last step (acar, hcar)
// and gamma_c = sum_t A_c,t dy_t C_t (gcar); where the chunk is split into
// per > 1 plan chunks of L steps (L a multiple of kSub, so each starts on a
// tile), also per plan chunk s the (A_c, B_c) entering it (abseg), its
// product P_s of the rounded a_t and gamma'_s = sum_t P_s,t dy_t C_t with
// P_s,t its product up to t (pseg, gseg); plan chunks past the sequence's
// end get P = 1 and gamma' = 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_bwd_summary_ab16_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                             const float* __restrict__ bc, const float* __restrict__ a_log,
                             const float* __restrict__ dy, float* __restrict__ hcar,
                             float* __restrict__ acar, float* __restrict__ gcar,
                             uint4* __restrict__ abseg, float* __restrict__ pseg,
                             float* __restrict__ gseg, int S, int di, int n, int M, int L,
                             int per, bool vec) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int nb = (di + kCh - 1) / kCh;
  const int cb = blockIdx.x % nb, c = blockIdx.x / nb, nab = gridDim.x / nb;
  const int b = blockIdx.z;
  const int c0 = cb * kCh, ch = threadIdx.x / kQuads, q = threadIdx.x % kQuads;
  const int i = c0 + ch;
  const bool live = i < di;
  const int f = c * M, steps = min(M, S - f), K = (steps + kSub - 1) / kSub;
  const int tiles_per = L / kSub;  // tiles a plan chunk (per > 1)
  const size_t row = static_cast<size_t>(b) * S + f;
  const size_t rc = (static_cast<size_t>(b) * nab + c) * di + i;
  const auto rs = [&](int p) {  // (b, plan chunk c per + p, i)
    return (static_cast<size_t>(b) * nab * per + static_cast<size_t>(c) * per + p) * di + i;
  };

  float A[kQ], Ac[kQ], Bc[kQ], P[kQ], gs[kQ], gm[kQ];
  load_A(a_log, i, q, n, live, A);
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    Ac[k] = 1.f;
    Bc[k] = 0.f;
    P[k] = 1.f;
    gs[k] = 0.f;
    gm[k] = 0.f;
  }
  Copy cp[2];
  plan_copies(cp, x, dt, dy, bc, row, di, c0);
  auto load = [&](int k) {
    if (k < K)
      load_tile(ring + (k % kStages) * Tile<T>::kBytes, cp, k, min(kSub, steps - k * kSub),
                vec, x, dt, dy, bc, row, di, c0);
    else
      cp_async_commit();
  };
  auto close_seg = [&](int p) {  // plan chunk p's P and gamma'; reset them
    if (live) {
      reinterpret_cast<float4*>(pseg + rs(p) * NS)[q] = pack(P);
      reinterpret_cast<float4*>(gseg + rs(p) * NS)[q] = pack(gs);
    }
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      P[k] = 1.f;
      gs[k] = 0.f;
    }
  };
  load(0);
  for (int k = 0; k < K; ++k) {
    cp_async_wait_all();
    __syncthreads();  // tile k is in; tile k-1's slot is free
    load(k + 1);
    if (per > 1 && k > 0 && k % tiles_per == 0) {
      const int p = k / tiles_per;
      close_seg(p - 1);
      if (live) abseg[rs(p) * kQuads + q] = pack_ab(Ac, Bc);
    }
    const unsigned char* st = ring + (k % kStages) * Tile<T>::kBytes;
#pragma unroll
    for (int tt = 0; tt < kSub; ++tt) {
      const Step s = read_step<T>(st, tt, ch, q);
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const float a = ab_step(s.dt, s.x, s.B[j], A[j], Ac[j], Bc[j]);
        const float dc = s.dy * s.C[j];
        P[j] *= a;
        gs[j] = fmaf(P[j], dc, gs[j]);
        gm[j] = fmaf(Ac[j], dc, gm[j]);
      }
    }
  }
  if (per > 1)
    for (int p = (K - 1) / tiles_per; p < per; ++p) close_seg(p);  // then P = 1, gamma' = 0
  if (live) {
    reinterpret_cast<float4*>(acar + rc * NS)[q] = pack(Ac);
    reinterpret_cast<float4*>(hcar + rc * NS)[q] = pack(Bc);
    reinterpret_cast<float4*>(gcar + rc * NS)[q] = pack(gm);
  }
}

// One chain of the carry pass for one (b, i, j): v_{k+1} = P_k v_k + s_k
// over k = 0 .. nk-1 in the caller's order, each v_k written to *out(k)
// first; returns v_nk.  s_of(k) and p_of(k) read chunk k's s and P.
// kExact: the product and the sum rounded singly (the bf16 a/b mode's
// state, as the forward carries it), else one FMA.  Batches of kBatch
// chunks; the next batch's loads are issued before this batch's stores, so
// a batch's latency hides behind the one before.
template <bool kExact, typename Out, typename SF, typename PF>
__device__ __forceinline__ float carry_chain(int nk, float v, Out out, SF s_of, PF p_of) {
  constexpr int kBatch = 8;
  float s[kBatch], P[kBatch], sn[kBatch], Pn[kBatch];
  const auto fetch = [&](int k0, float (&s_)[kBatch], float (&P_)[kBatch]) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {  // past the last chunk: the last again
      const int k = min(k0 + u, nk - 1);
      s_[u] = s_of(k);
      P_[u] = p_of(k);
    }
  };
  fetch(0, s, P);
  for (int k0 = 0; k0 < nk; k0 += kBatch) {
    fetch(k0 + kBatch, sn, Pn);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k0 + u < nk) {
        *out(k0 + u) = v;
        v = kExact ? ab_state(P[u], v, s[u]) : fmaf(P[u], v, s[u]);
      }
      s[u] = sn[u];
      P[u] = Pn[u];
    }
  }
  return v;
}

// One thread per (b, i, j): H and Gamma across the chunks, in place of the
// summaries (hcar: hloc in, H out; gcar: gamma in, Gamma out), with
// P_c = exp2(D_c A2).
__global__ void __launch_bounds__(kCarryThreads)
scan_bwd_carry_kernel(const float* __restrict__ a_log, const float* __restrict__ h0,
                      const float* __restrict__ dh_last, const float* __restrict__ dsum,
                      float* __restrict__ hcar, float* __restrict__ gcar, int B, int di,
                      int n, int nck) {
  const size_t e = static_cast<size_t>(blockIdx.x) * kCarryThreads + threadIdx.x;
  if (e >= static_cast<size_t>(B) * di * NS) return;
  const int j = static_cast<int>(e % NS);
  const size_t bi = e / NS;  // b di + i
  const int i = static_cast<int>(bi % di), b = static_cast<int>(bi / di);
  const bool on = j < n;
  const float A2 = on ? -expf(a_log[static_cast<size_t>(i) * n + j]) * kLog2e : 0.f;
  const size_t r0 = static_cast<size_t>(b) * nck * di + i;  // + k di: (b, k, i)
  const auto fwd = [&](int k) { return r0 + static_cast<size_t>(k) * di; };
  const auto rev = [&](int k) { return fwd(nck - 1 - k); };
  carry_chain<false>(
      nck, on ? h0[bi * n + j] : 0.f, [&](int k) { return hcar + fwd(k) * NS + j; },
      [&](int k) { return hcar[fwd(k) * NS + j]; },
      [&](int k) { return ex2(dsum[fwd(k)] * A2); });
  carry_chain<false>(
      nck, on ? dh_last[bi * n + j] : 0.f, [&](int k) { return gcar + rev(k) * NS + j; },
      [&](int k) { return gcar[rev(k) * NS + j]; },
      [&](int k) { return ex2(dsum[rev(k)] * A2); });
}

// The bf16 a/b mode's carries, one thread per (b, i, j), over the mode's
// nab chunks: the state entering chunk c, H_0 = h0 and H_{c+1} =
// A_c,last H_c + B_c,last (rounded singly, as the forward carries it), in
// place of B_c,last in hcar; the carry into chunk c's last step,
// Gamma_last = dh_last and Gamma_{c-1} = gamma_c + A_c,last Gamma_c, in
// place of gamma_c in gcar, and dh0 = Gamma_{-1}.  Where a chunk is split
// into per > 1 plan chunks, the carry into each one's last step, over all
// nab per of them from the last: G = Gamma_c at chunk c's last plan chunk,
// then G <- gamma'_s + P_s G, in place of gamma'_s in gseg (a first plan
// chunk's step takes P = 0 and s = Gamma_{c-1} instead).
__global__ void __launch_bounds__(kCarryThreads)
scan_bwd_carry_ab16_kernel(const float* __restrict__ h0, const float* __restrict__ dh_last,
                           const float* __restrict__ acar, float* __restrict__ hcar,
                           float* __restrict__ gcar, const float* __restrict__ pseg,
                           float* __restrict__ gseg, float* __restrict__ dh0, int B, int di,
                           int n, int nab, int per) {
  const size_t e = static_cast<size_t>(blockIdx.x) * kCarryThreads + threadIdx.x;
  if (e >= static_cast<size_t>(B) * di * NS) return;
  const int j = static_cast<int>(e % NS);
  const size_t bi = e / NS;  // b di + i
  const int i = static_cast<int>(bi % di), b = static_cast<int>(bi / di);
  const bool on = j < n;
  const auto at = [&](int c) {  // element (b, c, i, j) of a mode chunk's buffer
    return ((static_cast<size_t>(b) * nab + c) * di + i) * NS + j;
  };
  const auto rev = [&](int k) { return at(nab - 1 - k); };
  carry_chain<true>(
      nab, on ? h0[bi * n + j] : 0.f, [&](int k) { return hcar + at(k); },
      [&](int k) { return hcar[at(k)]; }, [&](int k) { return acar[at(k)]; });
  const float g0 = carry_chain<false>(
      nab, on ? dh_last[bi * n + j] : 0.f, [&](int k) { return gcar + rev(k); },
      [&](int k) { return gcar[rev(k)]; }, [&](int k) { return acar[rev(k)]; });
  if (on) dh0[bi * n + j] = g0;
  if (per == 1) return;
  const int nseg = nab * per;
  const auto seg = [&](int k) {  // plan chunk nseg-1-k, (b, s, i, j)
    return ((static_cast<size_t>(b) * nseg + nseg - 1 - k) * di + i) * NS + j;
  };
  const auto first = [&](int k) { return (nseg - 1 - k) % per == 0; };
  carry_chain<false>(
      nseg, on ? dh_last[bi * n + j] : 0.f, [&](int k) { return gseg + seg(k); },
      [&](int k) {
        const int c = (nseg - 1 - k) / per;
        return first(k) ? (c > 0 ? gcar[at(c - 1)] : 0.f) : gseg[seg(k)];
      },
      [&](int k) { return first(k) ? 0.f : pseg[seg(k)]; });
}

template <typename T, bool kAB16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_bwd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const float* __restrict__ bc, const float* __restrict__ a_log,
                      const float* __restrict__ dvec, const float* __restrict__ dy,
                      const float* __restrict__ hcar, const float* __restrict__ gcar,
                      T* __restrict__ dx, T* __restrict__ ddt, float* __restrict__ dbc_part,
                      float* __restrict__ da_part, float* __restrict__ dd_part,
                      float* __restrict__ dh0, const uint4* __restrict__ abseg, int S,
                      int di, int n, int chunk, int M, int per, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float4* hist = reinterpret_cast<float4*>(smem + kStages * Tile<T>::kBytes) + threadIdx.x;
  float* red = reinterpret_cast<float*>(smem + kStages * Tile<T>::kBytes + kHistBytes);
  float4* ckpt = reinterpret_cast<float4*>(smem + kStages * Tile<T>::kBytes + kHistBytes +
                                           kRedBytes) + threadIdx.x;  // + k kThreads
  // grid (blocks, chunks, B); in the bf16 a/b mode (blocks * chunks, 1, B),
  // channel blocks fastest, and chunk c is part c % per of mode chunk c / per
  const int nb = kAB16 ? (di + kCh - 1) / kCh : gridDim.x;
  const int cb = kAB16 ? blockIdx.x % nb : blockIdx.x;
  const int c = kAB16 ? blockIdx.x / nb : blockIdx.y;
  const int nck = kAB16 ? gridDim.x / nb : gridDim.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = cb * kCh, ch = threadIdx.x / kQuads, q = threadIdx.x % kQuads;
  const int i = c0 + ch;
  const bool live = i < di;
  const int f = kAB16 ? c / per * M + c % per * chunk : c * chunk;
  const int steps = kAB16 ? min(min(chunk, M - c % per * chunk), S - f) : min(chunk, S - f);
  const int K = (steps + kSub - 1) / kSub;
  const size_t row = static_cast<size_t>(b) * S + f;  // row of (b, f)
  const size_t r = (static_cast<size_t>(b) * nck + c) * di + i;
  if (kAB16 && steps <= 0) {  // past the sequence's end in its last mode chunk
    if (live) {
      reinterpret_cast<float4*>(da_part + r * NS)[q] = make_float4(0, 0, 0, 0);
      if (q == 0) dd_part[r] = 0.f;
    }
    return;
  }
  // this lane's sum after the butterfly: value (lane >> 2) & 7 of quad q,
  // dB (values 0-3) or dC (4-7) of state 4q + (value & 3)
  const int val = (lane >> 2) & 7;
  const int slot = (val >> 2) * NS + kQ * q + (val & 3);

  // kAB16: H the state entering the mode chunk, Ac and Bc the running
  // products (entering this chunk, then at each step)
  float A[kQ], h[kQ], g[kQ], dA[kQ], H[kAB16 ? kQ : 1], Ac[kAB16 ? kQ : 1], Bc[kAB16 ? kQ : 1];
  load_A(a_log, i, q, n, live, A);
  const float4 zero4 = make_float4(0, 0, 0, 0);
  if constexpr (kAB16) {
    const size_t rm = (static_cast<size_t>(b) * (nck / per) + c / per) * di + i;
    unpack(live ? reinterpret_cast<const float4*>(hcar + rm * NS)[q] : zero4, H);
    if (live && c % per) {
      unpack_ab(abseg[r * kQuads + q], Ac, Bc);
    } else {
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        Ac[k] = 1.f;
        Bc[k] = 0.f;
      }
    }
  } else {
    unpack(live ? reinterpret_cast<const float4*>(hcar + r * NS)[q] : zero4, h);
  }
  unpack(live ? reinterpret_cast<const float4*>(gcar + r * NS)[q] : zero4, g);
#pragma unroll
  for (int k = 0; k < kQ; ++k) dA[k] = 0.f;
  const float Dv = live ? dvec[i] : 0.f;
  float dD = 0.f;
  // lane q = 0 of a quad writes dx, q = 1 ddt, on the chunk's rows
  T* out = (live && q < 2) ? (q == 0 ? dx : ddt) + row * di + i : nullptr;

  // Tiles in the order the passes use them: sub-chunks 0..K-2 (the
  // checkpoints), then K-1 down to 0 (recompute and reverse).
  const int last = 2 * K - 2;
  auto sub = [&](int s) { return s < K - 1 ? s : last - s; };
  Copy cp[2];
  plan_copies(cp, x, dt, dy, bc, row, di, c0);
  auto load = [&](int s) {
    if (s <= last) {
      const int k = sub(s);
      load_tile(ring + (s % kStages) * Tile<T>::kBytes, cp, k, min(kSub, steps - k * kSub),
                vec, x, dt, dy, bc, row, di, c0);
    } else {
      cp_async_commit();
    }
  };
  load(0);
  for (int s = 0; s <= last; ++s) {
    cp_async_wait_all();
    __syncthreads();  // tile s is in; tile s-1's slot, `red` and `hist` are free
    load(s + 1);
    const unsigned char* st = ring + (s % kStages) * Tile<T>::kBytes;
    const int k = sub(s);
    if (s < K - 1) {  // the checkpoint of sub-chunk k, then its steps
      if constexpr (kAB16) {
        reinterpret_cast<uint4*>(ckpt)[k * kThreads] = pack_ab(Ac, Bc);
        forward_ab<false, T>(st, ch, q, A, H, Ac, Bc, h, nullptr);
      } else {
        ckpt[k * kThreads] = pack(h);
        forward<false, T>(st, ch, q, A, h, nullptr);
      }
      continue;
    }
    if constexpr (kAB16) {  // h_{t-1} of each step
      if (s > K - 1) unpack_ab(reinterpret_cast<const uint4*>(ckpt)[k * kThreads], Ac, Bc);
      forward_ab<true, T>(st, ch, q, A, H, Ac, Bc, h, hist);
    } else {
      if (s > K - 1) unpack(ckpt[k * kThreads], h);
      forward<true, T>(st, ch, q, A, h, hist);
    }
    const int t0 = k * kSub, n_t = min(kSub, steps - t0);
    // h holds the sub-chunk's last h_t; each step's h_{t-1} is the next h_t
#pragma unroll
    for (int tt = kSub - 1; tt >= 0; --tt) {
      const Step st_ = read_step<T>(st, tt, ch, q);
      float hp[kQ];
      unpack(hist[tt * kThreads], hp);
      const float u = st_.dt * st_.x, dl = st_.dt * kLog2e;
      float v[2 * kQ];  // dB_t (0-3) and dC_t (4-7) of this channel's 4 states
      float gB = 0.f, gdt = 0.f;
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const float gj = fmaf(st_.dy, st_.C[j], g[j]);
        v[j] = gj * u;
        v[kQ + j] = st_.dy * h[j];
        h[j] = hp[j];
        gB = fmaf(gj, st_.B[j], gB);
        float gha;  // g_t h_{t-1} a_t, a_t's derivative e_t in the bf16 a/b mode
        if constexpr (kAB16) {
          const float e = expf(__fmul_rn(st_.dt, A[j]));
          g[j] = bf16r(e) * gj;
          gha = gj * hp[j] * e;
        } else {
          g[j] = ex2(dl * A[j]) * gj;
          gha = g[j] * hp[j];
        }
        gdt = fmaf(gha, A[j], gdt);
        dA[j] = fmaf(gha, st_.dt, dA[j]);
      }
      // the quad's sums: lanes q even get sum gB, odd sum (x gB + gdt)
      float w[2] = {gB, fmaf(gB, st_.x, gdt)};
      const bool odd = lane & 1;
      float qs = (odd ? w[1] : w[0]) + __shfl_xor_sync(0xffffffffu, odd ? w[0] : w[1], 1);
      qs += __shfl_xor_sync(0xffffffffu, qs, 2);
      dD = fmaf(st_.dy, st_.x, dD);
      if (out && tt < n_t)
        store(out + static_cast<size_t>(t0 + tt) * di, q == 0 ? fmaf(qs, st_.dt, Dv * st_.dy) : qs);
      fold<16, 4>(v, lane);
      fold<8, 2>(v, lane);
      fold<4, 1>(v, lane);
      red[(warp * kSub + tt) * kV + slot] = v[0];
    }
    __syncthreads();  // every warp's sums of the sub-chunk are in `red`
    for (int e = threadIdx.x; e < n_t * kV; e += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < kWarps; ++w2) sum += red[w2 * kSub * kV + e];
      dbc_part[(static_cast<size_t>(cb) * gridDim.z * S + row + t0) * kV + e] = sum;
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < kQ; ++k) dA[k] *= A[k];
    reinterpret_cast<float4*>(da_part + r * NS)[q] = pack(dA);
    if (q == 0) dd_part[r] = dD;
    if (!kAB16 && c == 0) {  // the bf16 a/b mode's dh0 is the carry pass's
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        const int j = kQ * q + k;
        if (j < n) dh0[(static_cast<size_t>(b) * di + i) * n + j] = g[k];
      }
    }
  }
}

// The C entry's pointers: inputs, scratch and outputs.
struct Args {
  const void *x, *dt;
  const float *bc, *a_log, *d, *h0, *dy, *dh_last;
  float *hcar, *gcar, *dsum, *acar, *pseg, *gseg;
  uint4* abseg;
  void *dx, *ddt;
  float *dbc_part, *da_part, *dd_part, *dh0;
};

template <typename T, bool kAB16>
cudaError_t launch_chunks(dim3 grid, const Args& a, const float* gin, int S, int di, int n,
                          int chunk, int M, int per, bool vec, cudaStream_t st) {
  auto* kernel = scan_bwd_chunk_kernel<T, kAB16>;
  const size_t smem = chunk_smem<T>(chunk);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dt), a.bc, a.a_log, a.d, a.dy,
      a.hcar, gin, static_cast<T*>(a.dx), static_cast<T*>(a.ddt), a.dbc_part, a.da_part,
      a.dd_part, a.dh0, a.abseg, S, di, n, chunk, M, per, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int B, int S, int di, int n, int chunk, bool vec, cudaStream_t st,
                   const Args& a) {
  const int nck = (S + chunk - 1) / chunk;
  const dim3 grid((di + kCh - 1) / kCh, nck, B);
  scan_bwd_summary_kernel<T><<<grid, kThreads, kStages * Tile<T>::kBytes, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dt), a.bc, a.a_log, a.dy, a.hcar,
      a.gcar, a.dsum, S, di, n, chunk, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t carry = static_cast<size_t>(B) * di * NS;
  scan_bwd_carry_kernel<<<static_cast<unsigned>((carry + kCarryThreads - 1) / kCarryThreads),
                          kCarryThreads, 0, st>>>(a.a_log, a.h0, a.dh_last, a.dsum, a.hcar,
                                                  a.gcar, B, di, n, nck);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_chunks<T, false>(grid, a, a.gcar, S, di, n, chunk, chunk, 1, vec, st);
}

// The bf16 a/b mode: mode chunks of M steps, each `per` plan chunks of
// `chunk` steps (per = 1: chunk = M).
template <typename T>
cudaError_t launch_ab16(int B, int S, int di, int n, int chunk, int M, bool vec,
                        cudaStream_t st, const Args& a) {
  const int nb = (di + kCh - 1) / kCh, nab = (S + M - 1) / M, per = (M + chunk - 1) / chunk;
  scan_bwd_summary_ab16_kernel<T>
      <<<dim3(nb * nab, 1, B), kThreads, kStages * Tile<T>::kBytes, st>>>(
          static_cast<const T*>(a.x), static_cast<const T*>(a.dt), a.bc, a.a_log, a.dy,
          a.hcar, a.acar, a.gcar, a.abseg, a.pseg, a.gseg, S, di, n, M, chunk, per, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t carry = static_cast<size_t>(B) * di * NS;
  scan_bwd_carry_ab16_kernel<<<static_cast<unsigned>((carry + kCarryThreads - 1) /
                                                     kCarryThreads),
                               kCarryThreads, 0, st>>>(a.h0, a.dh_last, a.acar, a.hcar,
                                                       a.gcar, a.pseg, a.gseg, a.dh0, B, di,
                                                       n, nab, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_chunks<T, true>(dim3(nb * nab * per, 1, B), a, per > 1 ? a.gseg : a.gcar, S,
                                di, n, chunk, M, per, vec, st);
}

}  // namespace

// bf16: 1 when x and dt are bfloat16 (and dx, ddt are written in bfloat16),
// 0 when all four are float32.  vec: 1 when di % 8 == 0 and x, dt and dy are
// 16-byte aligned (cp.async in 16-byte chunks).  channels, chunk and smem
// are the plan's (kernels/mamba_scan.py: plan_bwd): channels a block (one
// dbc partial each), steps a chunk and the chunk kernel's dynamic shared
// memory in bytes; refused unless channels is kCh, chunk a multiple of kSub
// up to kMaxChunk and smem what this kernel lays out for that chunk.
// Scratch, all float32: hcar and gcar B * chunks * di * 16 (the summaries,
// then the carries), dsum B * chunks * di; outputs dbc_part
// ceil(di / channels) * B * S * 32, da_part B * chunks * di * 16, dd_part
// B * chunks * di, chunks = ceil(S / chunk) <= 65535.
// ab_chunk >= 1: the bf16 a/b mode in chunks of M = min(ab_chunk, S) steps,
// each split into ceil(M / chunk) plan chunks; chunk <= kMaxChunk and either
// chunk = M or chunk a multiple of kSub below M.  Its scratch: hcar, acar
// and gcar B * ceil(S / M) * di * 16 (dsum unread); where M > chunk also
// abseg, pseg and gseg B * chunks * di * 16 (abseg of bf16 pairs), chunks =
// ceil(S / M) * ceil(M / chunk), any number of them; dh0 written by the
// carry kernel.
extern "C" int mamba_scan_bwd_launch(const void* x, const void* dt, const void* bc,
                                     const void* a_log, const void* d, const void* h0,
                                     const void* dy, const void* dh_last, void* hcar,
                                     void* gcar, void* dsum, void* dx, void* ddt,
                                     void* dbc_part, void* da_part, void* dd_part, void* dh0,
                                     void* acar, void* abseg, void* pseg, void* gseg, int B,
                                     int S, int di, int n, int bf16, int vec, int channels,
                                     int chunk, int smem, int ab_chunk, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0 || n <= 0 || n > NS || B > 65535 || channels != kCh ||
      chunk <= 0 || chunk > kMaxChunk || ab_chunk < 0 || (vec && di % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = ab_chunk < S ? ab_chunk : S;
  if (ab_chunk == 0 ? chunk % kSub != 0 || (S + chunk - 1) / chunk > 65535
                    : (chunk != M && (chunk > M || chunk % kSub != 0)) ||
                          static_cast<long long>((di + kCh - 1) / kCh) * ((S + M - 1) / M) *
                                  ((M + chunk - 1) / chunk) > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t want = bf16 ? chunk_smem<__nv_bfloat16>(chunk) : chunk_smem<float>(chunk);
  if (static_cast<size_t>(smem) != want) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
  const Args a{x, dt, f(bc), f(a_log), f(d), f(h0), f(dy), f(dh_last), o(hcar), o(gcar),
               o(dsum), o(acar), o(pseg), o(gseg), static_cast<uint4*>(abseg), dx, ddt,
               o(dbc_part), o(da_part), o(dd_part), o(dh0)};
  cudaError_t err;
  if (ab_chunk == 0)
    err = bf16 ? launch<__nv_bfloat16>(B, S, di, n, chunk, vec != 0, st, a)
               : launch<float>(B, S, di, n, chunk, vec != 0, st, a);
  else
    err = bf16 ? launch_ab16<__nv_bfloat16>(B, S, di, n, chunk, M, vec != 0, st, a)
               : launch_ab16<float>(B, S, di, n, chunk, M, vec != 0, st, a);
  return static_cast<int>(err);
}
