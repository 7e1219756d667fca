// Blocked (flash) attention forward for Hopper (sm_90a), with online
// softmax in fp32, causal / sliding-window masks, and the two KV walks
// the ADSALA tuner chooses between.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (_flash_dense_kernel, _flash_tri_kernel and
// their shared _block_update).
//
// Design.  On the TPU the KV axis was a sequential grid dimension that
// carried (m, l, acc) in VMEM scratch from one grid step to the next.
// Blocks on the GPU run in no order and carry nothing, so one thread
// block owns one (batch-head, Q row block) and loops over that row's KV
// tiles itself, keeping the running max m, denominator l and
// accumulator acc in registers.
//
//   * The tuner's logical (bq, bkv) blocks were sized for TPU VMEM (up
//     to 1024 x 512).  They fix the tile map: which KV ranges a Q row
//     block visits.  A thread block takes BM = 64 rows of one logical Q
//     block and runs each logical KV tile as sub-tiles of BN = 64
//     columns that fit shared memory.
//   * dense: walk every logical KV tile of the row and skip the
//     invisible ones by the reference's _visible predicate.
//   * tri: walk only the row's entries of flash_tile_map, passed as a
//     device int32 list with per-row offsets (CSR).
//   Both walks reach the same sub-tiles in the same order and run the
//   same per-sub-tile arithmetic, so their outputs are bitwise equal.
//   A sub-tile with no visible (q, kv) pair for this block's rows is
//   skipped: its p is all zero, so it would leave m, l and acc bitwise
//   unchanged (corr = exp(0) = 1).
//
// Masking uses the finite -1e30, never -INFINITY: exp(-inf - -inf) is
// NaN.  p is zeroed explicitly where the mask is false, so a row with no
// visible key keeps l = 0 and outputs 0 (l is clamped at 1e-30, as in
// the reference).
//
// Bound.  At the serving path's shape (BH = 128, S = 1024, D = 64, fp32,
// causal) the kernel does ~17.2 GFLOP (QK^T and PV over the causal
// triangle).  fp32 runs on the CUDA cores (67 TFLOP/s), about 0.26 ms,
// far above the ~40 us it takes to move q, k, v and o (134 MB at
// 3.35 TB/s): operations bound it.  This first version is plain SIMT
// fp32 from shared memory (4x4 register micro-tiles, no tensor cores,
// no copy pipelining); bf16 inputs are widened to fp32 in shared memory
// and run the same arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;            // Q rows per thread block
constexpr int BN = 64;            // KV columns per sub-tile
constexpr int THREADS = 256;      // 16 x 16 threads
constexpr int TM = BM / 16;       // rows per thread
constexpr int TN = BN / 16;       // score columns per thread
constexpr int LDP = BN + 4;       // sP row stride (conflict-free)
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int sq, skv;
  int bq, bkv;          // logical (clamped) blocks of the tile map
  int gkv;              // logical KV tiles per row (dense walk)
  int n_sub;            // thread blocks per logical Q block
  int causal;
  int window;           // <= 0: no window
  float sm_scale;
  const int* row_ptr;   // tri walk: per-row offsets (gq + 1); null: dense
  const int* kv_list;   // tri walk: KV tile index per entry
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows ty*TM .. ty*TM+TM-1 live on the 16 lanes that share ty; they
// are one half of a warp, so xor offsets below 16 stay inside it
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const Params p) {
  constexpr int LDK = D + 1;      // padded stride: conflict-free K reads
  constexpr int TD = D / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;               // BM x LDK
  float* sK = sQ + BM * LDK;      // BN x LDK
  float* sV = sK + BN * LDK;      // BN x D
  float* sP = sV + BN * D;        // BM x LDP

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.y;
  const int iq = blockIdx.x / p.n_sub;           // logical Q block
  const int q_start = iq * p.bq;
  const int row0 = q_start + (blockIdx.x % p.n_sub) * BM;
  const int row_end = min(min(row0 + BM, q_start + p.bq), p.sq);
  if (row0 >= row_end) return;                   // whole block uniform

  const T* q = static_cast<const T*>(p.q) + (size_t)bh * p.sq * D;
  const T* k = static_cast<const T*>(p.k) + (size_t)bh * p.skv * D;
  const T* v = static_cast<const T*>(p.v) + (size_t)bh * p.skv * D;
  T* o = static_cast<T*>(p.o) + (size_t)bh * p.sq * D;

  for (int e = tid; e < BM * D; e += THREADS) {
    const int r = e / D, c = e % D;
    sQ[r * LDK + c] = (row0 + r < row_end)
        ? load_f32(q + (size_t)(row0 + r) * D + c) : 0.f;
  }

  float m_i[TM], l_i[TM], acc[TM][TD];
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    m_i[a] = NEG_INF;
    l_i[a] = 0.f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[a][c] = 0.f;
  }

  int first = 0, n_tiles = p.gkv;
  if (p.row_ptr != nullptr) {
    first = p.row_ptr[iq];
    n_tiles = p.row_ptr[iq + 1] - first;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int j = p.row_ptr != nullptr ? p.kv_list[first + t] : t;
    const int kv_start = j * p.bkv;
    // the reference's _visible, on the logical tile (padded=True)
    bool visible = kv_start < p.skv;
    if (p.causal) visible = visible && kv_start <= q_start + p.bq - 1;
    if (p.window > 0)
      visible = visible && kv_start + p.bkv - 1 > q_start - p.window;
    if (!visible) continue;
    const int tile_end = min(kv_start + p.bkv, p.skv);

    for (int c0 = kv_start; c0 < tile_end; c0 += BN) {
      const int ncols = min(BN, tile_end - c0);
      if (p.causal && c0 > row_end - 1) break;   // above the diagonal
      if (p.window > 0 && c0 + ncols - 1 <= row0 - p.window) continue;

      __syncthreads();          // the previous sub-tile's reads are done
      for (int e = tid; e < BN * D; e += THREADS) {
        const int r = e / D, c = e % D;
        const bool in = r < ncols;
        const size_t g = (size_t)(c0 + r) * D + c;
        sK[r * LDK + c] = in ? load_f32(k + g) : 0.f;
        sV[r * D + c] = in ? load_f32(v + g) : 0.f;
      }
      __syncthreads();

      float s[TM][TN];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) s[a][b] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qa[TM], kb[TN];
#pragma unroll
        for (int a = 0; a < TM; ++a) qa[a] = sQ[(ty * TM + a) * LDK + d];
#pragma unroll
        for (int b = 0; b < TN; ++b) kb[b] = sK[(tx + 16 * b) * LDK + d];
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int b = 0; b < TN; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
      }

#pragma unroll
      for (int a = 0; a < TM; ++a) {
        const int qi = row0 + ty * TM + a;
        bool ok[TN];
        float m_cur = NEG_INF;
#pragma unroll
        for (int b = 0; b < TN; ++b) {
          const int col = tx + 16 * b;
          const int kv = c0 + col;
          bool keep = col < ncols;               // kv < skv, inside tile
          if (p.causal) keep = keep && kv <= qi;
          if (p.window > 0) keep = keep && kv > qi - p.window;
          ok[b] = keep;
          s[a][b] = keep ? s[a][b] * p.sm_scale : NEG_INF;
          m_cur = fmaxf(m_cur, s[a][b]);
        }
        m_cur = row_max16(m_cur);
        const float m_new = fmaxf(m_i[a], m_cur);
        const float corr = expf(m_i[a] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int b = 0; b < TN; ++b) {
          const float pv = ok[b] ? expf(s[a][b] - m_new) : 0.f;
          psum += pv;
          sP[(ty * TM + a) * LDP + tx + 16 * b] = pv;
        }
        psum = row_sum16(psum);
        l_i[a] = corr * l_i[a] + psum;
        m_i[a] = m_new;
#pragma unroll
        for (int c = 0; c < TD; ++c) acc[a][c] *= corr;
      }
      __syncthreads();

#pragma unroll 8
      for (int kk = 0; kk < BN; ++kk) {
        float pa[TM], vc[TD];
#pragma unroll
        for (int a = 0; a < TM; ++a) pa[a] = sP[(ty * TM + a) * LDP + kk];
#pragma unroll
        for (int c = 0; c < TD; ++c) vc[c] = sV[kk * D + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int c = 0; c < TD; ++c) acc[a][c] = fmaf(pa[a], vc[c], acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int qi = row0 + ty * TM + a;
    if (qi >= row_end) continue;
    const float inv = fmaxf(l_i[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < TD; ++c)
      store_f32(o + (size_t)qi * D + tx + 16 * c, acc[a][c] / inv);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int grid_x, int bh, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (BM * (D + 1) + BN * (D + 1) + BN * D + BM * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D><<<dim3(grid_x, bh), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int d, int grid_x, int bh,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, grid_x, bh, stream);
    case 32: return launch<T, 32>(p, grid_x, bh, stream);
    case 64: return launch<T, 64>(p, grid_x, bh, stream);
    case 128: return launch<T, 128>(p, grid_x, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, bound from Python through ctypes.
//   dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window.
//   row_ptr / kv_list: the tri walk's CSR tile list, or both null for
//   the dense walk.  Launches on `stream`, does not synchronise, and
//   returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* o,
    int bh, int sq, int skv, int d, int bq, int bkv, int causal,
    int window, float sm_scale, int dtype, const int* row_ptr,
    const int* kv_list, void* stream) {
  if (bh <= 0 || bh > 65535 || sq <= 0 || skv <= 0 || bq <= 0 || bkv <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.sq = sq; p.skv = skv; p.bq = bq; p.bkv = bkv;
  p.gkv = (skv + bkv - 1) / bkv;
  p.n_sub = (bq + BM - 1) / BM;
  p.causal = causal; p.window = window; p.sm_scale = sm_scale;
  p.row_ptr = row_ptr; p.kv_list = kv_list;
  const int gq = (sq + bq - 1) / bq;
  const int grid_x = gq * p.n_sub;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0
      ? launch_d<float>(p, d, grid_x, bh, s)
      : dtype == 1 ? launch_d<__nv_bfloat16>(p, d, grid_x, bh, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
