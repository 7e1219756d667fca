// Tiled GEMM body for Hopper (sm_90a), shared by matmul.cu (one GEMM) and
// grouped_matmul.cu (one GEMM per expert): C[e][m, n] = sum_k A[e][m, k]
// B[e][k, n] with an fp32 accumulator, fp32 or bf16 operands, and fp32 or
// bf16 output.  A plain GEMM is the grouped one with a single expert.
//
// Design.  On the TPU the K axis was a sequential grid dimension that
// carried the accumulator in VMEM scratch, and ragged operands were
// zero-padded to the tile grid.  Here one thread block owns one output
// tile of one expert (blockIdx.y) and loops over K itself, with the
// accumulator in registers.  No padded copy is made: loads outside the
// matrix read 0 and stores outside it are dropped.  A and B are read
// through (expert, row, column) element strides, so a transposed view
// (ops.syrk's B^T, an expert-transposed weight) launches without a copy;
// each operand's global-to-shared load walks its unit-stride axis
// fastest.  Offsets are 64-bit: one expert stack can exceed 2^31
// elements (mixtral's w_i is 805 M).
//
//   * 256 threads (16 x 16) compute a BM x BN tile, each thread a
//     (BM/16) x (BN/16) register micro-tile from rows ty*4 + 64*g and
//     columns tx*4 + 64*h (float4 reads from shared memory, no bank
//     conflicts).
//   * K steps of BK through two shared-memory buffers; the next step's
//     operands are loaded into registers while the current step computes
//     (one __syncthreads per step).  bf16 operands are widened to fp32
//     on the way into shared memory.
//   * Each thread sums over k in order, so the result does not depend on
//     the tile: every launch shape gives the same bits.
//   * In the grouped kernel (GROUPED) a warp whose rows all lie below the
//     bucket skips the FMAs (it still loads and synchronises): an expert
//     bucket of a decode step has 8 rows in a 64- or 128-row tile.  The
//     plain GEMM compiles without the skip and without the expert
//     offsets, to the kernel it was tuned as: with them, ptxas allocates
//     its registers differently and the tiles' times move by up to 5 %.
//
// The tuner's tile.  ADSALA's (bm, bk, bn) presets were sized for TPU
// VMEM (up to 512 a side), too large for one block's registers.  The
// logical tile keeps a meaning as a launch shape (the wrapper,
// repro_torch/kernels/matmul.py::launch_shape, computes it):
//
//   tuner tile          CTA tile BM x BN          K step BK    raster group
//   bm, bn < 128        64                        -            -
//   bm, bn >= 128       128                       -            -
//   bk <= 128           -                         8            -
//   128 < bk <= 256     -                         16           -
//   bk > 256            -                         32           -
//   (bm, bn)            -                         -            max(1, bm/BM) x
//                                                              max(1, bn/BN) CTAs
//
// The raster group is the logical (bm, bn) tile: consecutive block ids
// walk the CTAs of one logical tile (row-major) before the next logical
// tile, so blocks that run together share rows of A and columns of B in
// L2.  The 8 DEFAULT_TILES map to 8 different launches:
//
//   id  (bm, bk, bn)       BM x BN    BK   group
//   0   (128, 128, 128)    128 x 128   8   1 x 1
//   1   (256, 128, 256)    128 x 128   8   2 x 2
//   2   (128, 512, 128)    128 x 128  32   1 x 1
//   3   (256, 256, 256)    128 x 128  16   2 x 2
//   4   (512, 128, 512)    128 x 128   8   4 x 4
//   5   (512, 512, 512)    128 x 128  32   4 x 4
//   6   (128, 128, 512)    128 x 128   8   1 x 4
//   7   (512, 128, 128)    128 x 128   8   4 x 1
//
// Shared memory is 2 * BK * (BM + 4 + BN + 4) floats: 16.5 KB at BK = 8
// and 66 KB at BK = 32, 128 x 128 (dynamic, above 48 KB after
// cudaFuncSetAttribute).
//
// This first version is plain SIMT fp32 from shared memory (8 x 8
// micro-tiles give 16 shared loads, as 4 float4, per 64 FMAs) with no
// tensor cores and no asynchronous copies; bf16 runs the same fp32
// arithmetic, so it is far from the tensor cores' bf16 bound.  wgmma and
// TMA are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int THREADS = 256;      // 16 x 16

struct Params {
  const void* a;
  const void* b;
  void* c;
  int m, k, n;
  long long sae, sam, sak;   // A's element strides (expert, row, column)
  long long sbe, sbk, sbn;   // B's element strides (expert, row, column)
  int gm, gn;           // CTAs per logical tile along M, N
  int lt_n;             // logical tiles along N
  int ctas_m, ctas_n;   // CTA tiles covering M, N
  int out_bf16;         // 1: C is bf16, 0: fp32
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, int BM, int BN, int BK, bool GROUPED>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const Params p) {
  constexpr int TM = BM / 16;               // rows per thread (4 or 8)
  constexpr int TN = BN / 16;               // columns per thread
  constexpr int LDA = BM + 4;               // sA[k][m] row stride
  constexpr int LDB = BN + 4;               // sB[k][n] row stride
  constexpr int A_LOADS = BM * BK / THREADS;
  constexpr int B_LOADS = BN * BK / THREADS;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                         // [2][BK][LDA]
  float* sB = smem + 2 * BK * LDA;          // [2][BK][LDB]

  // raster: block id -> logical tile (row-major) -> CTA inside it
  const int per_tile = p.gm * p.gn;
  const int lt = blockIdx.x / per_tile;
  const int w = blockIdx.x % per_tile;
  const int tm = (lt / p.lt_n) * p.gm + w / p.gn;
  const int tn = (lt % p.lt_n) * p.gn + w % p.gn;
  if (tm >= p.ctas_m || tn >= p.ctas_n) return;   // edge of the group
  const int m0 = tm * BM;
  const int n0 = tn * BN;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long ex = GROUPED ? blockIdx.y : 0;   // expert
  const T* A = static_cast<const T*>(p.a) + ex * p.sae;
  const T* B = static_cast<const T*>(p.b) + ex * p.sbe;
  const size_t c_off = (size_t)ex * (size_t)p.m * (size_t)p.n;
  // walk the unit-stride axis fastest in the global loads
  const bool a_kfast = p.sak == 1 && p.sam != 1;
  const bool b_kfast = p.sbk == 1 && p.sbn != 1;
  // this thread's lowest row lies inside C (else all its rows lie below)
  const bool live = !GROUPED || m0 + ty * 4 < p.m;

  float ra[A_LOADS], rb[B_LOADS];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = a_kfast ? e / BK : e % BM;
      const int c = a_kfast ? e % BK : e / BM;
      const int gr = m0 + r, gc = k0 + c;
      ra[i] = (gr < p.m && gc < p.k)
          ? load_f32(A + gr * p.sam + gc * p.sak) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = b_kfast ? e % BK : e / BN;
      const int c = b_kfast ? e / BK : e % BN;
      const int gr = k0 + r, gc = n0 + c;
      rb[i] = (gr < p.k && gc < p.n)
          ? load_f32(B + gr * p.sbk + gc * p.sbn) : 0.f;
    }
  };
  auto store = [&](int buf) {
    float* a_s = sA + buf * BK * LDA;
    float* b_s = sB + buf * BK * LDB;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = a_kfast ? e / BK : e % BM;
      const int c = a_kfast ? e % BK : e / BM;
      a_s[c * LDA + r] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = b_kfast ? e % BK : e / BN;
      const int c = b_kfast ? e / BK : e % BN;
      b_s[r * LDB + c] = rb[i];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nk = (p.k + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk) load((t + 1) * BK);
    const float* a_s = sA + cur * BK * LDA;
    const float* b_s = sB + cur * BK * LDB;
    if (live) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float af[TM], bf[TN];
#pragma unroll
        for (int g = 0; g < TM / 4; ++g) {
          const float4 x = *reinterpret_cast<const float4*>(
              a_s + kk * LDA + g * 64 + ty * 4);
          af[4 * g + 0] = x.x; af[4 * g + 1] = x.y;
          af[4 * g + 2] = x.z; af[4 * g + 3] = x.w;
        }
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 x = *reinterpret_cast<const float4*>(
              b_s + kk * LDB + h * 64 + tx * 4);
          bf[4 * h + 0] = x.x; bf[4 * h + 1] = x.y;
          bf[4 * h + 2] = x.z; bf[4 * h + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
      }
    }
    // the other buffer was last read in step t - 1, before its barrier
    if (t + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (row >= p.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + (j / 4) * 64 + tx * 4 + j % 4;
      if (col >= p.n) continue;
      const size_t off = c_off + (size_t)row * p.n + col;
      if (p.out_bf16)
        static_cast<__nv_bfloat16*>(p.c)[off] = __float2bfloat16(acc[i][j]);
      else
        static_cast<float*>(p.c)[off] = acc[i][j];
    }
  }
}

template <typename T, int BM, int BN, int BK, bool GROUPED>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * 2 * BK * (BM + 4 + BN + 4);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<T, BM, BN, BK, GROUPED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gemm_kernel<T, BM, BN, BK, GROUPED><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int BM, int BN, bool G>
cudaError_t launch_bk(const Params& p, int bk, dim3 grid, cudaStream_t s) {
  switch (bk) {
    case 8: return launch<T, BM, BN, 8, G>(p, grid, s);
    case 16: return launch<T, BM, BN, 16, G>(p, grid, s);
    case 32: return launch<T, BM, BN, 32, G>(p, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool G>
cudaError_t launch_t(const Params& p, int bm, int bn, int bk, dim3 grid,
                     cudaStream_t s) {
  if (bm == 64 && bn == 64) return launch_bk<T, 64, 64, G>(p, bk, grid, s);
  if (bm == 64 && bn == 128) return launch_bk<T, 64, 128, G>(p, bk, grid, s);
  if (bm == 128 && bn == 64) return launch_bk<T, 128, 64, G>(p, bk, grid, s);
  if (bm == 128 && bn == 128)
    return launch_bk<T, 128, 128, G>(p, bk, grid, s);
  return cudaErrorInvalidValue;
}

// Validate the launch shape, fill in the raster fields of `p` and launch
// `experts` GEMMs (blockIdx.y) of p.m x p.k x p.n on `stream`: the
// grouped kernel when GROUPED, else the plain GEMM (experts must be 1).
// Returns the cudaError_t of the launch (0 on success).
template <bool GROUPED>
int gemm_launch(Params p, int experts, int cta_m, int cta_n, int k_step,
                int group_m, int group_n, int dtype, int out_dtype,
                void* stream) {
  if (p.m <= 0 || p.k <= 0 || p.n <= 0 || experts <= 0 ||
      experts > 65535 || (!GROUPED && experts != 1) || group_m <= 0 ||
      group_n <= 0 || p.sae < 0 || p.sam < 0 || p.sak < 0 || p.sbe < 0 ||
      p.sbk < 0 || p.sbn < 0 ||
      cta_m <= 0 || cta_n <= 0 || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  p.gm = group_m; p.gn = group_n;
  p.ctas_m = (p.m + cta_m - 1) / cta_m;
  p.ctas_n = (p.n + cta_n - 1) / cta_n;
  const long long lt_m = (p.ctas_m + group_m - 1) / group_m;
  const long long lt_n = (p.ctas_n + group_n - 1) / group_n;
  const long long grid = lt_m * lt_n * group_m * group_n;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  p.lt_n = (int)lt_n;
  p.out_bf16 = out_dtype;
  const dim3 g((unsigned)grid, (unsigned)experts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0
      ? launch_t<float, GROUPED>(p, cta_m, cta_n, k_step, g, s)
      : dtype == 1
          ? launch_t<__nv_bfloat16, GROUPED>(p, cta_m, cta_n, k_step, g, s)
          : cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace
