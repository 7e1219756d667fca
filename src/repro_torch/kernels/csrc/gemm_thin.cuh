// Weight-streaming body for thin expert buckets (grouped_matmul.cu):
// Y[e][c, n] = sum_k X[e][c, k] W[e][k, n] for a bucket of C <= 16 rows,
// the expert products of a decode step (mixtral: 8 rows an expert).
//
// Bound on the H100.  Such a bucket does 2C flops per weight element it
// reads (4 bytes in fp32): at C = 16, 8 flop/byte against the card's
// 67 TFLOP/s / 3.35 TB/s = 20, so the weights' bytes bound it: mixtral's
// decode bucket (8, 8, 6144) x (8, 6144, 16384) streams 3.2 GB, 0.96 ms
// at 3.35 TB/s.  The tiled body of gemm_tile.cuh ran such a bucket in a
// 128-row tile and streamed the weights at 0.80 TB/s (24 % of HBM).  From
// C = 17 on the tiled body takes over (the threshold THIN_ROWS, also in
// repro_torch/kernels/grouped_matmul.py).
//
// Design.
//   * A CTA covers all the bucket's rows, padded to CM = 8 or 16, by a
//     wide N tile of THIN_BN = 256 columns, one column a thread: CM fp32
//     accumulators a thread and no fragments kept.
//   * W tiles (THIN_BK = 16 rows x 256) go HBM -> shared memory by
//     cp.async (16-byte chunks for a row-major W, 4-byte transposing
//     copies for an expert-transposed one) through a ring of
//     THIN_STAGES = 6; the bucket's X rows (16 x CM) ride along each
//     stage.  Bytes in flight: Little's law at 3.35 TB/s and about 1 us of
//     loaded latency asks for some 3.4 MB on the card, 26 KB an SM.  The
//     ring keeps five stages = 80 KB of W in flight a CTA; its 104 KB of
//     shared memory let two CTAs share an SM (160 KB in flight).
//   * Each thread reads its column of the W stage (a warp reads 128
//     contiguous bytes) and the stage's X values as float4 broadcasts,
//     and sums over k in order with fmaf: without split-K a thin launch
//     gives the same bits as the tiled body.
//   * Split-K only where the CTA count E * ceil(f / 256) would not fill
//     the card's 132 SMs (the wrapper's planner picks the count, a
//     function of the shape; mixtral's w_i, w_g (512 CTAs) and w_o (192)
//     need none).  Split s covers rows [s * k_split, (s + 1) * k_split) of
//     K, k_split a whole number of K steps, and writes its partial sums to
//     an fp32 workspace (splits, E, C, f) that the wrapper allocates; a
//     second kernel adds the splits in order 0, 1, ... and writes Y.  No
//     atomics: two launches on the same inputs give the same bits.

#pragma once

#include "gemm_tile.cuh"

namespace {

constexpr int THIN_ROWS = 16;     // largest bucket this body takes
constexpr int THIN_BN = 256;      // columns a CTA (one a thread)
constexpr int THIN_BK = 16;       // K rows a stage of the ring
constexpr int THIN_STAGES = 6;    // the ring's depth

template <typename T, int CM>
constexpr int thin_smem_bytes() {
  return THIN_STAGES * THIN_BK *
         ((CM + pad_elems<T>()) + (THIN_BN + pad_elems<T>())) *
         (int)sizeof(T);
}

template <typename T, int CM>
__global__ void __launch_bounds__(THREADS, 2)
thin_kernel(const Params p, int k_split, float* ws) {
  constexpr int PAD = pad_elems<T>();
  constexpr int LDX = CM + PAD;             // sX[k][c]
  constexpr int LDW = THIN_BN + PAD;        // sW[k][n]
  constexpr int X_ELEMS = THIN_BK * LDX;
  constexpr int W_ELEMS = THIN_BK * LDW;
  static_assert(THIN_BN == THREADS && CM % 4 == 0, "thin tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sX = reinterpret_cast<T*>(smem_raw);   // [STAGES][THIN_BK][LDX]
  T* sW = sX + THIN_STAGES * X_ELEMS;       // [STAGES][THIN_BK][LDW]

  const int tid = threadIdx.x;
  const int tn = blockIdx.x % p.ctas_n;
  const int split = blockIdx.x / p.ctas_n;
  const long long ex = blockIdx.y;
  const int n0 = tn * THIN_BN;
  const int kb = split * k_split;
  const int ke = min(p.k, kb + k_split);
  const T* X = static_cast<const T*>(p.a) + ex * p.sae;
  const T* W = static_cast<const T*>(p.b) + ex * p.sbe;

  auto load_stage = [&](int slot, int k0) {
    copy_tile<T, THIN_BK, CM>(sX + slot * X_ELEMS, LDX, X, p.sak, p.sam, k0,
                              0, ke, p.m, p.a_vec, tid);
    copy_tile<T, THIN_BK, THIN_BN>(sW + slot * W_ELEMS, LDW, W, p.sbk,
                                   p.sbn, k0, n0, ke, p.n, p.b_vec, tid);
  };

  float acc[CM];
#pragma unroll
  for (int r = 0; r < CM; ++r) acc[r] = 0.f;

  const int nk = (ke - kb + THIN_BK - 1) / THIN_BK;
#pragma unroll
  for (int s = 0; s < THIN_STAGES - 1; ++s) {
    if (s < nk) load_stage(s, kb + s * THIN_BK);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<THIN_STAGES - 2>();
    __syncthreads();
    const int tl = t + THIN_STAGES - 1;
    if (tl < nk) load_stage(tl % THIN_STAGES, kb + tl * THIN_BK);
    cp_async_commit();
    const T* x_s = sX + (t % THIN_STAGES) * X_ELEMS;
    const T* w_s = sW + (t % THIN_STAGES) * W_ELEMS + tid;
#pragma unroll
    for (int kk = 0; kk < THIN_BK; ++kk) {
      const float wv = ld1(w_s + kk * LDW);
#pragma unroll
      for (int q = 0; q < CM / 4; ++q) {
        const float4 xv = ld4(x_s + kk * LDX + 4 * q);
        acc[4 * q + 0] = fmaf(xv.x, wv, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(xv.y, wv, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(xv.z, wv, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(xv.w, wv, acc[4 * q + 3]);
      }
    }
  }
  cp_async_wait<0>();

  const int col = n0 + tid;
  if (col >= p.n) return;
  const size_t plane = (size_t)p.m * (size_t)p.n;
  const size_t base = (size_t)ex * plane + col;
  if (ws == nullptr) {
#pragma unroll
    for (int r = 0; r < CM; ++r)
      if (r < p.m) store_out(p.c, base + (size_t)r * p.n, acc[r], p.out_bf16);
  } else {
    float* part = ws + (size_t)split * gridDim.y * plane + base;
#pragma unroll
    for (int r = 0; r < CM; ++r)
      if (r < p.m) part[(size_t)r * p.n] = acc[r];
  }
}

// Y = the sum of the splits' partials, in split order
__global__ void __launch_bounds__(THREADS)
split_sum_kernel(const float* ws, int splits, size_t total, void* y,
                 int out_bf16) {
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * THREADS) {
    float v = ws[i];
    for (int s = 1; s < splits; ++s) v += ws[(size_t)s * total + i];
    store_out(y, i, v, out_bf16);
  }
}

template <typename T, int CM>
cudaError_t launch_thin(const Params& p, int experts, int splits,
                        int k_split, float* ws, cudaStream_t s) {
  constexpr int smem = thin_smem_bytes<T, CM>();
  cudaError_t err = cudaFuncSetAttribute(
      thin_kernel<T, CM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(p.ctas_n * splits), (unsigned)experts);
  thin_kernel<T, CM><<<grid, THREADS, smem, s>>>(
      p, k_split, splits > 1 ? ws : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = (size_t)experts * p.m * p.n;
  const size_t blocks = (total + THREADS - 1) / THREADS;
  split_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), THREADS, 0,
                     s>>>(ws, splits, total, p.c, p.out_bf16);
  return cudaGetLastError();
}

// Validate and launch the thin body: cta_m (8 or 16) covers the bucket's
// rows, cta_n = THIN_BN, k_step = THIN_BK, stages = THIN_STAGES (the
// planner's copies of these constants are checked here), K cut into
// `splits` whole
// numbers of K steps (none empty); the workspace holds splits * E * C * f
// floats when splits > 1.  Returns the cudaError_t (0 on success).
inline int thin_launch(Params p, int experts, int cta_m, int cta_n,
                       int k_step, int stages, int splits, void* workspace,
                       int dtype, int out_dtype, void* stream) {
  if (p.m <= 0 || p.k <= 0 || p.n <= 0 || experts <= 0 ||
      experts > 65535 || p.m > cta_m || (cta_m != 8 && cta_m != 16) ||
      cta_n != THIN_BN || k_step != THIN_BK || stages != THIN_STAGES ||
      splits <= 0 ||
      (splits > 1 && workspace == nullptr) || p.sae < 0 || p.sam < 0 ||
      p.sak < 0 || p.sbe < 0 || p.sbk < 0 || p.sbn < 0 ||
      (out_dtype != 0 && out_dtype != 1) || dtype != GEMM_DTYPE)
    return (int)cudaErrorInvalidValue;
  const int steps = (p.k + THIN_BK - 1) / THIN_BK;
  const int k_split = (steps + splits - 1) / splits * THIN_BK;
  if ((p.k + k_split - 1) / k_split != splits)
    return (int)cudaErrorInvalidValue;
  p.ctas_m = 1;
  p.ctas_n = (p.n + THIN_BN - 1) / THIN_BN;
  if ((long long)p.ctas_n * splits > INT_MAX)
    return (int)cudaErrorInvalidValue;
  p.out_bf16 = out_dtype;
  const int elem = (int)sizeof(GemmT);
  // X's tile is [k][c]: its rows are K, its columns the bucket's rows
  p.a_vec = rows_aligned(p.a, p.sae, p.sak, p.sam, experts, elem);
  p.b_vec = rows_aligned(p.b, p.sbe, p.sbk, p.sbn, experts, elem);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cta_m == 8 ? launch_thin<GemmT, 8>(p, experts, splits, k_split, ws, s)
                 : launch_thin<GemmT, 16>(p, experts, splits, k_split, ws, s);
  return (int)err;
}

}  // namespace
