// Tiled GEMM for Hopper (sm_90a): C[m, n] = sum_k A[m, k] B[k, n] with an
// fp32 accumulator, fp32 or bf16 operands, and fp32 or bf16 output.
//
// Replaces the TPU kernel repro/kernels/matmul.py::matmul_pallas
// (_matmul_kernel, _pad_to): the GEMM the ADSALA tuner tunes, which
// carries ops.matmul, ops.syrk and every panel update of ops.trsm.  The
// kernel, its design and the table from the tuner's tile to the launch
// shape are in gemm_tile.cuh (one expert of the grouped GEMM).
//
// Bound.  fp32 runs on the CUDA cores: at 2048^3 the GEMM does 17.2
// GFLOP, 0.256 ms at 67 TFLOP/s, against 50 MB moved (A, B read once, C
// written once), 0.015 ms at 3.35 TB/s: operations bound it at every
// shape the install samples except the thinnest.

#include "gemm_tile.cuh"

// Plain C interface, bound from Python through ctypes.
//   dtype: operands, 0 = float32, 1 = bfloat16; out_dtype: C, the same
//   codes.  C is row-major and contiguous (m x n).  Strides are in
//   elements.  cta_m x cta_n (64 or 128), k_step (8, 16 or 32), the
//   ring's depth `stages` (refused unless it is the one the tile
//   compiles) and the group_m x group_n raster group are the launch shape
//   of the table in gemm_tile.cuh.  Launches on `stream`, does not
//   synchronise, and returns the cudaError_t of the launch (0 on
//   success).
//
// This file compiles twice (gemm_tile.cuh: GEMM_DTYPE): each build
// defines the entry of its operand type, and the float32 build also
// matmul_forward, which calls the one the dtype names.
#define MATMUL_ARGS                                                        \
    const void *a, const void *b, void *c, int m, int k, int n,            \
    long long sam, long long sak, long long sbk, long long sbn, int cta_m, \
    int cta_n, int k_step, int stages, int group_m, int group_n,           \
    int dtype, int out_dtype, void *stream
#define MATMUL_CALL                                                        \
    a, b, c, m, k, n, sam, sak, sbk, sbn, cta_m, cta_n, k_step, stages,    \
    group_m, group_n, dtype, out_dtype, stream

#if GEMM_DTYPE == 0
#define MATMUL_TYPED matmul_forward_f32
#else
#define MATMUL_TYPED matmul_forward_bf16
#endif

extern "C" int MATMUL_TYPED(MATMUL_ARGS) {
  Params p = {};
  p.a = a; p.b = b; p.c = c;
  p.m = m; p.k = k; p.n = n;
  p.sam = sam; p.sak = sak; p.sbk = sbk; p.sbn = sbn;
  return gemm_launch<false>(p, 1, cta_m, cta_n, k_step, stages, group_m,
                            group_n, dtype, out_dtype, stream);
}

#if GEMM_DTYPE == 0
extern "C" int matmul_forward_bf16(MATMUL_ARGS);

extern "C" int matmul_forward(MATMUL_ARGS) {
  return dtype == 1 ? matmul_forward_bf16(MATMUL_CALL)
                    : matmul_forward_f32(MATMUL_CALL);
}

extern "C" const char* matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
