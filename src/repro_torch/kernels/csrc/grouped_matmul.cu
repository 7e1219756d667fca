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
// one launch covers every expert: the expert is blockIdx.y, reached
// through 64-bit (expert, row, column) strides (mixtral's w_i
// (8, 6144, 16384) holds 805 M elements, 3.2 GB in fp32).  The ragged
// edges in C, d and f are masked, not padded.  Two bodies, chosen by the
// wrapper's planner (grouped_matmul.py::grouped_launch) from the bucket's
// rows:
//
//   * C > 16 (prefill buckets): the tiled, cp.async-pipelined body of
//     gemm_tile.cuh, its CTA rows fitted to the bucket (128, 96 or 64);
//   * C <= 16 (decode buckets): the weight-streaming body of
//     gemm_thin.cuh, with split-K where the experts' N tiles would not
//     fill the card, summed in a fixed order through a workspace.
//
// Bound.  A prefill bucket (8, 1280, 6144) x (8, 6144, 16384) does
// 2.06e12 flop, 30.8 ms at 67 TFLOP/s fp32 against 3.2 GB of weights
// at 3.35 TB/s (0.96 ms): operations bound it.  A decode bucket has 8
// rows per expert: the same 3.2 GB of weights bound it at 0.96 ms, while
// its flops take 0.02 ms.

#include "gemm_thin.cuh"
#include "gemm_tile.cuh"

// Plain C interface, bound from Python through ctypes.
//   x (e, c, d), w (e, d, f): element strides (expert, row, column);
//   y (e, c, f) is contiguous.  dtype: operands, 0 = float32,
//   1 = bfloat16; out_dtype: y, the same codes.  cta_m x cta_n, k_step,
//   the ring's depth `stages` and the group_m x group_n raster group are
//   the launch shape of the planner: cta_m of 8 or 16 selects the thin
//   body (cta_n 256, k_step 16, stages 6, K cut into `splits`;
//   `workspace` holds splits * e * c * f floats when splits > 1), else
//   the tiled body of gemm_tile.cuh (splits 1).  A launch shape the
//   kernels do not compile, a ring depth among them, is refused.
//   e <= 65535.  Launches on `stream`, does not synchronise, and returns
//   the cudaError_t of the launch (0 on success).
//
// This file compiles twice (gemm_tile.cuh: GEMM_DTYPE): each build
// defines the entry of its operand type, and the float32 build also
// grouped_matmul_forward, which calls the one the dtype names.
#define GROUPED_ARGS                                                       \
    const void *x, const void *w, void *y, int e, int c, int d, int f,     \
    long long sxe, long long sxc, long long sxd, long long swe,            \
    long long swd, long long swf, int cta_m, int cta_n, int k_step,        \
    int stages, int group_m, int group_n, int splits, void *workspace,     \
    int dtype, int out_dtype, void *stream
#define GROUPED_CALL                                                       \
    x, w, y, e, c, d, f, sxe, sxc, sxd, swe, swd, swf, cta_m, cta_n,       \
    k_step, stages, group_m, group_n, splits, workspace, dtype, out_dtype, \
    stream

#if GEMM_DTYPE == 0
#define GROUPED_TYPED grouped_matmul_forward_f32
#else
#define GROUPED_TYPED grouped_matmul_forward_bf16
#endif

extern "C" int GROUPED_TYPED(GROUPED_ARGS) {
  Params p = {};
  p.a = x; p.b = w; p.c = y;
  p.m = c; p.k = d; p.n = f;
  p.sae = sxe; p.sam = sxc; p.sak = sxd;
  p.sbe = swe; p.sbk = swd; p.sbn = swf;
  if (cta_m <= THIN_ROWS)
    return thin_launch(p, e, cta_m, cta_n, k_step, stages, splits,
                       workspace, dtype, out_dtype, stream);
  if (splits != 1) return (int)cudaErrorInvalidValue;
  return gemm_launch<true>(p, e, cta_m, cta_n, k_step, stages, group_m,
                           group_n, dtype, out_dtype, stream);
}

#if GEMM_DTYPE == 0
extern "C" int grouped_matmul_forward_bf16(GROUPED_ARGS);

extern "C" int grouped_matmul_forward(GROUPED_ARGS) {
  return dtype == 1 ? grouped_matmul_forward_bf16(GROUPED_CALL)
                    : grouped_matmul_forward_f32(GROUPED_CALL);
}

extern "C" const char* grouped_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
