// Expert-grouped GEMM for Hopper (sm_90a): Y[e] = X[e] @ W[e] for every
// expert e, X (E, C, d), W (E, d, f), Y (E, C, f), with an fp32
// accumulator, fp32 or bf16 operands, and fp32 or bf16 output.
//
// Replaces the TPU kernel repro/kernels/grouped_matmul.py::
// grouped_matmul_pallas (_grouped_kernel, _pad3): the three expert
// products of every MoE layer (w_i, w_g, w_o), over fixed-capacity token
// buckets.
//
// Design.  The TPU grid was (E, gm, gn, gk) with K sequential and the
// operands zero-padded to the tile grid (_pad3), then sliced back.  Here
// one launch covers every expert: the expert is blockIdx.y, and each
// block runs the GEMM body of gemm_tile.cuh on its expert's operands,
// reached through 64-bit (expert, row, column) strides: mixtral's
// w_i (8, 6144, 16384) holds 805 M elements, and 3.2 GB in fp32, so
// e * stride_e in bytes overflows an int.  The ragged edges in C, d and f
// are masked, not padded.  The tuner's (bm, bk, bn) becomes the launch
// shape by the same table as the plain GEMM's (gemm_tile.cuh).
//
// Bound.  A prefill bucket (8, 1280, 6144) x (8, 6144, 16384) does
// 2.06e12 flop, 30.8 ms at 67 TFLOP/s fp32 against 3.2 GB of weights
// at 3.35 TB/s (0.96 ms): operations bound it.  A decode bucket has 8
// rows per expert: the same 3.2 GB of weights bound it at 0.96 ms, while
// its flops take 0.02 ms.  Rows of a tile that lie below the bucket skip
// their FMAs (gemm_tile.cuh), so the 8-row decode does not pay for 128.

#include "gemm_tile.cuh"

// Plain C interface, bound from Python through ctypes.
//   x (e, c, d), w (e, d, f): element strides (expert, row, column);
//   y (e, c, f) is contiguous.  dtype: operands, 0 = float32,
//   1 = bfloat16; out_dtype: y, the same codes.  cta_m x cta_n, k_step
//   and the group_m x group_n raster group are the launch shape of the
//   table in gemm_tile.cuh.  e <= 65535.  Launches on `stream`, does not
//   synchronise, and returns the cudaError_t of the launch (0 on
//   success).
extern "C" int grouped_matmul_forward(
    const void* x, const void* w, void* y, int e, int c, int d, int f,
    long long sxe, long long sxc, long long sxd, long long swe,
    long long swd, long long swf, int cta_m, int cta_n, int k_step,
    int group_m, int group_n, int dtype, int out_dtype, void* stream) {
  Params p = {};
  p.a = x; p.b = w; p.c = y;
  p.m = c; p.k = d; p.n = f;
  p.sae = sxe; p.sam = sxc; p.sak = sxd;
  p.sbe = swe; p.sbk = swd; p.sbn = swf;
  return gemm_launch<true>(p, e, cta_m, cta_n, k_step, group_m, group_n,
                           dtype, out_dtype, stream);
}

extern "C" const char* grouped_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
