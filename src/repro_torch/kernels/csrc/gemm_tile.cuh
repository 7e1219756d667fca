// Tiled GEMM body for Hopper (sm_90a), shared by matmul.cu (one GEMM) and
// grouped_matmul.cu (one GEMM per expert): C[e][m, n] = sum_k A[e][m, k]
// B[e][k, n] with an fp32 accumulator, fp32 or bf16 operands, and fp32 or
// bf16 output.  A plain GEMM is the grouped one with a single expert.
// Thin expert buckets (a decode step's 8 rows) run the weight-streaming
// body of gemm_thin.cuh instead; this file holds the compute-bound body.
//
// Design.  On the TPU the K axis was a sequential grid dimension that
// carried the accumulator in VMEM scratch, and ragged operands were
// zero-padded to the tile grid.  Here one thread block owns one output
// tile of one expert (blockIdx.y) and loops over K itself, with the
// accumulator in registers.  No padded copy is made.  A and B are read
// through (expert, row, column) element strides, so a transposed view
// (ops.syrk's B^T, an expert-transposed weight, strided bucket rows)
// launches without a copy.  Offsets are 64-bit: one expert stack can
// exceed 2^31 elements (mixtral's w_i is 805 M).
//
//   * Operands go from global to shared memory by cp.async, never
//     through registers.  Shared memory keeps both operands K-major: A as
//     sA[k][m] and B as sB[k][n], each row padded by 16 bytes, so that a
//     thread's fragments for one k are float4 reads along M and N.  Where
//     the global operand's unit-stride axis is the shared row's (a
//     transposed A view, a row-major B) and its rows are 16-byte aligned,
//     each thread copies 16-byte chunks (cp.async.cg); the chunk that
//     crosses the ragged edge copies only its valid bytes and the hardware
//     zero-fills the rest.  cp.async cannot transpose, so any other layout
//     (the usual row-major A, ops.syrk's B^T, a strided view, an unaligned
//     row stride) copies 4-byte elements (cp.async.ca) with the source
//     size 0 outside the matrix, walking the global unit-stride axis across
//     8 lanes: the reads fill 32-byte sectors and the 32 lanes' shared
//     writes hit 32 banks.  A row-major A of 128 x 16 costs a thread 8
//     such copies a K step, against 1,024 FMAs.  bf16 elements (2 bytes,
//     below cp.async's 4-byte minimum) in such a layout are loaded and
//     stored by the thread itself.  Every copy's pointer and bounds come
//     from a per-thread base and compile-time steps (copy_tile), so the
//     copies unroll without divisions or loops.
//   * A ring of STAGES K steps (3 or 4) in shared memory: STAGES - 1 steps
//     of loads are in flight while one step computes, and one
//     __syncthreads per K step both publishes the step that landed
//     (cp.async.wait_group STAGES - 2) and frees the slot the next load
//     overwrites (it was read in the previous step).
//   * 256 threads in 8 warps of 4 (M) x 2 (N).  A warp owns a
//     (BM/4) x (BN/2) sub-tile; lane (r = lane/8, c = lane%8) owns the
//     TM = BM/16 contiguous rows from r*TM and the columns c*4 + 32*g
//     (g < BN/64).  Per k: TM/4 float4 reads of A (float2 for TM = 6; the
//     8 lanes of a quarter-warp read the same rows: a broadcast) and BN/64
//     float4 reads of B (a quarter-warp reads 128 contiguous bytes): no
//     bank conflicts, 4 shared reads per 64 FMAs at 128 x 128.  That tile
//     holds 64 accumulators and 16 fragment registers a thread;
//     __launch_bounds__(256, 2) asks for two CTAs (16 warps) an SM.
//   * Each thread sums over k in order with fmaf, so the result does not
//     depend on the launch shape: every launch shape gives the same bits.
//     There is no split-K in this body.
//   * In the grouped kernel (GROUPED) a thread whose rows all lie below
//     the bucket skips its FMAs (it still copies and synchronises).  The
//     plain GEMM compiles without the skip and without the expert offset.
//
// Bound on the H100.  fp32 runs on the CUDA cores (67 TFLOP/s): a
// 2048^3 GEMM needs 0.256 ms of FMAs against 0.015 ms of bytes, so
// operations bound this body at every shape it gets.  Its inner loop is
// 1,024 FFMA and 64 LDS.128 a K step of 16, nothing else.  What holds it
// back is the copies, above all the 4-byte transposing copies of a
// row-major A: 8 copy instructions a thread a K step of 16 at 128 x 128,
// where a column-major A takes two 16-byte ones (scripts/ab_kernels.py
// times the two layouts of A at 2048^3 and at mixtral's prefill bucket).
// Copying a row-major A in wider pieces keeps it K-fast in shared memory
// and reads it along K: as float4 that holds 32 more registers (spills at
// two CTAs an SM), as scalars it costs 4 more shared loads a k.
//
// The tuner's tile.  ADSALA's (bm, bk, bn) presets were sized for TPU
// VMEM (up to 512 a side), too large for one block's registers.  The
// logical tile keeps a meaning as a launch shape (the wrappers compute
// it: repro_torch/kernels/matmul.py::launch_shape and, for the grouped
// kernel, grouped_matmul.py::grouped_launch):
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
//   stages: 4 when four K steps of the fp32 tile fit in half of 227 KB
//   (two CTAs an SM), else 3.
//
// A grouped launch takes BM from the bucket too: of 128, 96 and 64 (not
// above the tile's BM), the one that leaves the fewest dead rows in
// ceil(C / BM) * BM, the largest on a tie (deepseek-v2's 192 rows: 2 x 96,
// not 2 x 128).  A bucket of at most 16 rows runs gemm_thin.cuh.
//
// The raster group is the logical (bm, bn) tile: consecutive block ids
// walk the CTAs of one logical tile (row-major) before the next logical
// tile, so blocks that run together share rows of A and columns of B in
// L2.  The 8 DEFAULT_TILES map to 8 different launches:
//
//   id  (bm, bk, bn)       BM x BN    BK  stages  group   shared (fp32)
//   0   (128, 128, 128)    128 x 128   8    4     1 x 1    33,792 B
//   1   (256, 128, 256)    128 x 128   8    4     2 x 2    33,792 B
//   2   (128, 512, 128)    128 x 128  32    3     1 x 1   101,376 B
//   3   (256, 256, 256)    128 x 128  16    4     2 x 2    67,584 B
//   4   (512, 128, 512)    128 x 128   8    4     4 x 4    33,792 B
//   5   (512, 512, 512)    128 x 128  32    3     4 x 4   101,376 B
//   6   (128, 128, 512)    128 x 128   8    4     1 x 4    33,792 B
//   7   (512, 128, 128)    128 x 128   8    4     4 x 1    33,792 B
//
// Shared memory is stages * BK * (BM + PAD + BN + PAD) elements, PAD = 16
// bytes of elements (dynamic, above 48 KB after cudaFuncSetAttribute).
//
// Not here: tensor cores.  The fp32 path must keep fp32 products (TF32
// keeps 10 mantissa bits), and bf16 runs the same fp32 FMAs; a wgmma path
// for bf16 is later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

// Each translation unit that includes this header compiles the kernels
// of one operand type, GEMM_DTYPE (0 = float32, 1 = bfloat16, given by
// the build with -D): the two halves compile in parallel
// (kernels/_build.py), and the .cu files join them behind one C entry.
#ifndef GEMM_DTYPE
#error "compile with -DGEMM_DTYPE=0 (float32) or -DGEMM_DTYPE=1 (bfloat16)"
#endif

namespace {

#if GEMM_DTYPE == 0
using GemmT = float;
#else
using GemmT = __nv_bfloat16;
#endif

constexpr int THREADS = 256;      // 8 warps
// shared memory a block may use (H100), and the share that leaves room
// for two blocks an SM
constexpr int SMEM_MAX = 232448;
constexpr int SMEM_TWO_CTAS = SMEM_MAX / 2;

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
  int a_vec, b_vec;     // 1: the operand's rows take 16-byte copies
};

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes; only `bytes` (0..16) are read, the rest of dst is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

// 4 bytes; `bytes` is 0 (zero-fill) or 4
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// one element: 4 bytes by cp.async (src is a valid address either way),
// and bf16 by the thread itself (2 bytes are below cp.async's minimum)
__device__ __forceinline__ void copy_elem(float* dst, const float* src,
                                          bool ok) {
  cp_async4(dst, src, ok ? 4 : 0);
}
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16(0.f);
}

// Copy the ROWS x COLS tile at global (row0, col0) of an operand with
// element strides (srow, scol) into shared memory dst[r * lds + c].
// Elements at global rows >= nrows or columns >= ncols read as 0.  `vec`:
// scol == 1 and every row starts 16-byte aligned, so a thread copies
// 16-byte chunks of a row.  Else each element is copied alone, walking the
// global unit-stride axis (rows when srow == 1) across 8 lanes.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void copy_tile(
    T* dst, int lds, const T* src, long long srow, long long scol, int row0,
    int col0, int nrows, int ncols, bool vec, int tid) {
  constexpr int V = 16 / sizeof(T);              // elements a chunk
  constexpr int CH = COLS / V;                   // chunks a row
  constexpr int Q = THREADS / 8;                 // 8-lane groups
  if (vec) {
    static_assert(COLS % V == 0, "tile columns hold whole chunks");
    if constexpr (THREADS % CH == 0) {
      // a thread keeps one chunk column and steps down the rows: its
      // column, byte count and pointer are computed once
      constexpr int RSTEP = THREADS / CH;
      constexpr int N = (ROWS * CH + THREADS - 1) / THREADS;
      const int r0 = tid / CH, c = (tid % CH) * V;
      int valid = ncols - (col0 + c);
      valid = valid < 0 ? 0 : valid < V ? valid : V;
      const T* g = src + (long long)(row0 + r0) * srow + (col0 + c);
      const long long gstep = RSTEP * srow;
      T* d = dst + r0 * lds + c;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int r = r0 + i * RSTEP;
        if ((ROWS * CH) % THREADS != 0 && r >= ROWS) break;
        const int bytes = row0 + r < nrows ? valid * (int)sizeof(T) : 0;
        cp_async16(d + i * RSTEP * lds, bytes ? g + i * gstep : src, bytes);
      }
    } else {
#pragma unroll
      for (int e = tid; e < ROWS * CH; e += THREADS) {
        const int r = e / CH;
        const int c = (e % CH) * V;
        const int gr = row0 + r, gc = col0 + c;
        int valid = ncols - gc;
        valid = gr < nrows ? (valid < 0 ? 0 : valid < V ? valid : V) : 0;
        const T* g = valid > 0 ? src + gr * srow + gc : src;
        cp_async16(dst + r * lds + c, g, valid * (int)sizeof(T));
      }
    }
  } else if (srow == 1) {
    static_assert(ROWS % 8 == 0, "transposing copy walks 8 rows");
    if constexpr (COLS % Q == 0) {
      // lane group (r8, q): rows 8 * b + r8 of columns q + Q * j
      constexpr int NC = COLS / Q;
      const int r8 = tid % 8, q = tid / 8;
      const T* g = src + (row0 + r8) + (long long)(col0 + q) * scol;
      const long long gstep = Q * scol;
#pragma unroll
      for (int i = 0; i < ROWS * COLS / THREADS; ++i) {
        const int r = 8 * (i / NC) + r8, c = q + Q * (i % NC);
        const bool ok = row0 + r < nrows && col0 + c < ncols;
        copy_elem(dst + r * lds + c,
                  ok ? g + 8 * (i / NC) + (i % NC) * gstep : src, ok);
      }
    } else {
#pragma unroll
      for (int e = tid; e < ROWS * COLS; e += THREADS) {
        const int rest = e / 8;
        const int c = rest % COLS;
        const int r = (rest / COLS) * 8 + e % 8;
        const int gr = row0 + r, gc = col0 + c;
        const bool ok = gr < nrows && gc < ncols;
        copy_elem(dst + r * lds + c, src + (ok ? gr + gc * scol : 0), ok);
      }
    }
  } else {
#pragma unroll
    for (int e = tid; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS, c = e % COLS;
      const int gr = row0 + r, gc = col0 + c;
      const bool ok = gr < nrows && gc < ncols;
      copy_elem(dst + r * lds + c,
                src + (ok ? gr * srow + gc * scol : 0), ok);
    }
  }
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// four consecutive operands from shared memory, widened to fp32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// TM consecutive operands (TM = 4, 6 or 8): float4 reads, or float2 for 6
template <int TM, typename T>
__device__ __forceinline__ void load_rows(float* out, const T* p) {
  if constexpr (TM % 4 == 0) {
#pragma unroll
    for (int q = 0; q < TM / 4; ++q) {
      const float4 x = ld4(p + 4 * q);
      out[4 * q] = x.x; out[4 * q + 1] = x.y;
      out[4 * q + 2] = x.z; out[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < TM / 2; ++q) {
      const float2 x = ld2(p + 2 * q);
      out[2 * q] = x.x; out[2 * q + 1] = x.y;
    }
  }
}

__device__ __forceinline__ void store_out(void* c, size_t off, float v,
                                          int out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(c)[off] = __float2bfloat16(v);
  else
    static_cast<float*>(c)[off] = v;
}

// ---------------------------------------------------------------------------
// the compute-bound body
// ---------------------------------------------------------------------------

template <typename T>
__host__ __device__ constexpr int pad_elems() { return 16 / (int)sizeof(T); }

// bytes of one K step of the tile in shared memory
template <typename T, int BM, int BN, int BK>
constexpr int stage_bytes() {
  return BK * (BM + pad_elems<T>() + BN + pad_elems<T>()) * (int)sizeof(T);
}

// the ring's depth, from the fp32 tile (bf16 uses the same depth)
template <int BM, int BN, int BK>
constexpr int ring_stages() {
  return 4 * stage_bytes<float, BM, BN, BK>() <= SMEM_TWO_CTAS ? 4 : 3;
}

template <typename T, int BM, int BN, int BK, int STAGES, bool GROUPED>
__global__ void __launch_bounds__(THREADS, 2)
gemm_kernel(const Params p) {
  constexpr int PAD = pad_elems<T>();
  constexpr int LDA = BM + PAD;             // sA[k][m]
  constexpr int A_ELEMS = BK * LDA;
  constexpr int LDB = BN + PAD;             // sB[k][n]
  constexpr int B_ELEMS = BK * LDB;
  constexpr int TM = BM / 16;               // rows per thread (4, 6 or 8)
  constexpr int NG = BN / 64;               // float4 column groups (1, 2)
  static_assert(BM % 16 == 0 && BN % 64 == 0 && BK % 4 == 0, "tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);   // [STAGES][BK][LDA]
  T* sB = sA + STAGES * A_ELEMS;            // [STAGES][BK][LDB]

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
  const int lane = tid % 32, warp = tid / 32;
  const int lr = lane / 8, lc = lane % 8;
  const int row_t = (warp / 2) * (BM / 4) + lr * TM;
  const int col_t = (warp % 2) * (BN / 2) + lc * 4;
  const long long ex = GROUPED ? blockIdx.y : 0;   // expert
  const T* A = static_cast<const T*>(p.a) + ex * p.sae;
  const T* B = static_cast<const T*>(p.b) + ex * p.sbe;
  const size_t c_off = (size_t)ex * (size_t)p.m * (size_t)p.n;
  // this thread's first row lies inside C (else all its rows lie below)
  const bool live = !GROUPED || m0 + row_t < p.m;

  auto load_stage = [&](int slot, int k0) {
    copy_tile<T, BK, BM>(sA + slot * A_ELEMS, LDA, A, p.sak, p.sam, k0, m0,
                         p.k, p.m, p.a_vec, tid);
    copy_tile<T, BK, BN>(sB + slot * B_ELEMS, LDB, B, p.sbk, p.sbn, k0, n0,
                         p.k, p.n, p.b_vec, tid);
  };

  float acc[TM][4 * NG];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;

  const int nk = (p.k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();            // step t has landed
    __syncthreads();                        // ... for all; slot t-1 free
    const int tl = t + STAGES - 1;
    if (tl < nk) load_stage(tl % STAGES, tl * BK);
    cp_async_commit();
    const T* a_s = sA + (t % STAGES) * A_ELEMS + row_t;
    const T* b_s = sB + (t % STAGES) * B_ELEMS + col_t;
    if (live) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float af[TM], bf[4 * NG];
        load_rows<TM>(af, a_s + kk * LDA);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 x = ld4(b_s + kk * LDB + 32 * g);
          bf[4 * g + 0] = x.x; bf[4 * g + 1] = x.y;
          bf[4 * g + 2] = x.z; bf[4 * g + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4 * NG; ++j)
            acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();                       // no copy outlives the block

  const bool vec_out = !p.out_bf16 && p.n % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + row_t + i;
    if (row >= p.m) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = n0 + col_t + 32 * g;
      const size_t off = c_off + (size_t)row * p.n + col;
      if (vec_out && col + 3 < p.n) {
        *reinterpret_cast<float4*>(static_cast<float*>(p.c) + off) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
        continue;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < p.n) store_out(p.c, off + j, acc[i][4 * g + j],
                                     p.out_bf16);
    }
  }
}

// `stages` is the wrapper's ring depth: a launch is refused unless it is
// the one this tile compiles (ring_stages<>()), so the two cannot drift apart
template <typename T, int BM, int BN, int BK, bool GROUPED>
cudaError_t launch(const Params& p, int stages, dim3 grid,
                   cudaStream_t stream) {
  constexpr int S = ring_stages<BM, BN, BK>();
  constexpr int smem = S * stage_bytes<T, BM, BN, BK>();
  static_assert(smem <= SMEM_MAX, "ring exceeds shared memory");
  if (stages != S) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<T, BM, BN, BK, S, GROUPED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gemm_kernel<T, BM, BN, BK, S, GROUPED><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int BM, int BN, bool G>
cudaError_t launch_bk(const Params& p, int bk, int st, dim3 grid,
                      cudaStream_t s) {
  switch (bk) {
    case 8: return launch<T, BM, BN, 8, G>(p, st, grid, s);
    case 16: return launch<T, BM, BN, 16, G>(p, st, grid, s);
    case 32: return launch<T, BM, BN, 32, G>(p, st, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

// the CTA tiles the launch table reaches: 64 or 128 a side, and 96 x 128
// for grouped buckets
template <typename T, bool G>
cudaError_t launch_t(const Params& p, int bm, int bn, int bk, int st,
                     dim3 grid, cudaStream_t s) {
  if (bm == 64 && bn == 64)
    return launch_bk<T, 64, 64, G>(p, bk, st, grid, s);
  if (bm == 64 && bn == 128)
    return launch_bk<T, 64, 128, G>(p, bk, st, grid, s);
  if (bm == 128 && bn == 64)
    return launch_bk<T, 128, 64, G>(p, bk, st, grid, s);
  if (bm == 128 && bn == 128)
    return launch_bk<T, 128, 128, G>(p, bk, st, grid, s);
  if constexpr (G) {
    if (bm == 96 && bn == 128)
      return launch_bk<T, 96, 128, G>(p, bk, st, grid, s);
  }
  return cudaErrorInvalidValue;
}

// 1 when every row of an operand at `ptr` (and every expert's, for more
// than one) starts 16-byte aligned and its columns are unit-stride
inline int rows_aligned(const void* ptr, long long s_expert, long long s_row,
                        long long s_col, int experts, int elem) {
  const long long a = 16;
  return s_col == 1 && reinterpret_cast<uintptr_t>(ptr) % a == 0 &&
         (s_row * elem) % a == 0 && (experts == 1 || (s_expert * elem) % a == 0);
}

// Validate the launch shape (the ring depth `stages` must be the one the
// tile compiles), fill in the raster and copy fields of `p`
// and launch `experts` GEMMs (blockIdx.y) of p.m x p.k x p.n on `stream`:
// the grouped kernel when GROUPED, else the plain GEMM (experts must be
// 1).  Returns the cudaError_t of the launch (0 on success).
template <bool GROUPED>
int gemm_launch(Params p, int experts, int cta_m, int cta_n, int k_step,
                int stages, int group_m, int group_n, int dtype,
                int out_dtype, void* stream) {
  if (p.m <= 0 || p.k <= 0 || p.n <= 0 || experts <= 0 ||
      experts > 65535 || (!GROUPED && experts != 1) || group_m <= 0 ||
      group_n <= 0 || p.sae < 0 || p.sam < 0 || p.sak < 0 || p.sbe < 0 ||
      p.sbk < 0 || p.sbn < 0 ||
      cta_m <= 0 || cta_n <= 0 || (out_dtype != 0 && out_dtype != 1) ||
      dtype != GEMM_DTYPE)
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
  const int elem = (int)sizeof(GemmT);
  // A's tile is [k][m]: its rows are K, its columns M
  p.a_vec = rows_aligned(p.a, p.sae, p.sak, p.sam, experts, elem);
  p.b_vec = rows_aligned(p.b, p.sbe, p.sbk, p.sbn, experts, elem);
  const dim3 g((unsigned)grid, (unsigned)experts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_t<GemmT, GROUPED>(p, cta_m, cta_n, k_step, stages, g,
                                       s);
}

}  // namespace
