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
// block (CTA) owns one (batch-head, run of Q rows) and loops over that
// row block's KV tiles itself, keeping the running max m, denominator l
// and accumulator acc in registers.
//
//   * The tuner's logical (bq, bkv) blocks were sized for TPU VMEM (up
//     to 1024 x 512).  They fix the tile map: which KV ranges a Q row
//     block visits.  A CTA takes BM rows of one logical Q block (128, 64,
//     32 or 16: the planner kernels/flash_attention.py::flash_launch
//     picks them, never more than the clamped bq allows) and runs each
//     logical KV tile as sub-tiles of BN columns (32 or 64).
//   * dense: walk every logical KV tile of the row and skip the
//     invisible ones by the reference's _visible predicate.
//   * tri: walk only the row's entries of flash_tile_map, passed as a
//     device int32 list with per-row offsets (CSR).
//   Both walks reach the same sub-tiles in the same order (next_sub) and
//   run the same per-sub-tile arithmetic, so their outputs are bitwise
//   equal.  A sub-tile with no visible (q, kv) pair for this CTA's rows
//   is skipped, and within a CTA so is one a warp's 16 rows do not see:
//   its p is all zero, so it would leave m, l and acc bitwise unchanged
//   (corr = exp2(0) = 1).
//   * K and V go from global to shared memory by 16-byte cp.async into a
//     ring of STAGES sub-tiles (2 or 3): the next sub-tiles' copies are in
//     flight while the current one computes, and one __syncthreads a
//     sub-tile both publishes the slot that landed and frees the slot the
//     next copy overwrites.  Q is copied once per CTA the same way.  K, V
//     and Q stay D-fast, as they lie in memory, so no copy transposes;
//     bf16 stays bf16 in shared memory and is widened when read.  Rows
//     are padded by 16 bytes (D + 4 floats): 8 lanes' 16-byte reads of 8
//     consecutive rows fall in distinct bank groups for every D.
//   * A warp owns 16 query rows, and its lanes hold them in two layouts.
//     Scores: lane (r = lane / 8, c = lane % 8) holds rows r, r + 4,
//     r + 8, r + 12 by columns c + 8j (j < BN / 8), and QK^T is a dot
//     product along d read as 4-element chunks of Q (one address per
//     quarter-warp: a broadcast) and of 8 K rows: 16 BN / 8 FMAs per
//     4 + BN / 8 shared loads (8 at BN = 32, 10.7 at 64).  Output: lane
//     (h = lane / 16, c = lane % 16) holds rows 8h .. 8h + 7 by the
//     columns of its chunks c + 16g, so the 16 lanes of a half-warp read
//     16 distinct chunks of a V row (the score layout's 8 columns would
//     make all four quarter-warps read the same 128 bytes, which costs
//     as much as 512 distinct ones): 8 + 4 D / 64 loads per 32 D / 16
//     FMAs per 4 columns of P (10.7 at D = 64, 16 at 128; at D = 16 and
//     32 the chunks are 1 and 2 columns).
//   * The row max and sum reduce over the 8 lanes of a row by xor
//     shuffles.  P and each row's rescale go to the warp's own slices of
//     shared memory under __syncwarp, never through a CTA barrier; the
//     output layout reads them back (P as 4-column chunks, the rescale
//     and, at the end, the row sums as 8-row chunks).
//   * exp2 on the SFU (ex2.approx) with sm_scale * log2(e) folded into
//     the score scale.  A sub-tile wholly inside the mask for every row
//     of a warp skips the per-element mask there (the same values: every
//     element is kept).
//   * Causal launches walk the Q row blocks from the last (the heaviest:
//     they see the most keys) to the first, with the batch-head on the
//     fastest grid axis, so the lightest CTAs form the last wave.
//   * Each lane sums over d, and over the sub-tiles, in order with fmaf,
//     and the shuffle trees are fixed: two launches give the same bits.
//
// Masking uses the finite -1e30, never -INFINITY: exp(-inf - -inf) is
// NaN.  p is zeroed explicitly where the mask is false, so a row with no
// visible key keeps l = 0 through the main walk.  The reference gives
// such a row p = exp(-1e30 - -1e30) = 1 on every column of every visible
// logical tile (padded columns included, where v is zero): the uniform
// average of v over those tiles, or 0 when no logical tile of the row's
// Q block is visible.  That value is the same for every such row of a
// logical Q block, so a CTA that holds one walks the visible logical
// tiles once more after the main walk (whole tiles: the sub-tile skips do
// not apply) and sums v column by column.  Both walks visit the same
// tiles in the same order, so this pass too is bitwise equal between
// them.
//
// Bound.  At the serving path's shape (BH = 128, S = 1024, D = 64, fp32,
// causal) the kernel does ~17.2 GFLOP (QK^T and PV over the causal
// triangle).  fp32 runs on the CUDA cores (67 TFLOP/s), about 0.26 ms,
// far above the ~40 us it takes to move q, k, v and o (134 MB at
// 3.35 TB/s): operations bound it.  Next to the FMAs, shared memory
// limits it: an SM does 128 fp32 FMAs a clock but serves 128 bytes of
// shared loads a clock, and a warp's 16-byte load takes 4 of those
// clocks unless each quarter-warp reads a single address (then 2), even
// when the four quarter-warps read the same 128 bytes
// (scripts/smem_bench.py measures it).  QK^T costs 24 such clocks per
// 64 FMAs of a warp, PV 32 per 128 at D = 64: with 16 score and 32 output
// registers a lane (128 registers at two 256-thread CTAs an SM), QK^T
// cannot run at the FMA rate.  Larger register tiles cost occupancy,
// which the softmax's shuffle and SFU chains need more.  No tensor
// cores: the served paths are fp32 and TF32 keeps 10 mantissa bits; bf16
// runs the same fp32 FMAs.
//
// Plans.  The planner's (CTA rows, BN, STAGES) for each head dim are the
// table below (Plan), mirrored in kernels/flash_attention.py; the C entry
// refuses any other.  Shared memory is BM x (D + pad) for Q, STAGES x 2 x
// BN x (D + pad) for the K/V ring (elements), BM x (BN + 8) floats of
// P and BM row scalars, at most 116 KB, so two CTAs fit an SM:
//
//   dtype  D    BN  stages  most rows  shared (at most rows)
//   fp32   16   64    3       128       78,336 B
//   fp32   32   64    3       128      111,104 B
//   fp32   64   32    3       128      108,032 B
//   fp32   128  32    2        64      111,872 B
//   bf16   16   64    3       128       61,952 B
//   bf16   32   64    3       128       78,336 B
//   bf16   64   64    3       128      111,104 B
//   bf16   128  64    2        64      105,728 B
//
// At D = 128 a lane holds 64 accumulators: 128 rows (256 threads) at two
// CTAs an SM would cap it at 128 registers, so the CTA takes 64 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// Each translation unit compiles the kernels of one input type,
// FLASH_DTYPE (0 = float32, 1 = bfloat16, given by the build with -D):
// the two halves compile in parallel (kernels/_build.py), and the float32
// unit joins them behind one C entry.
#ifndef FLASH_DTYPE
#error "compile with -DFLASH_DTYPE=0 (float32) or -DFLASH_DTYPE=1 (bfloat16)"
#endif

namespace {

#if FLASH_DTYPE == 0
using FlashT = float;
#else
using FlashT = __nv_bfloat16;
#endif

constexpr int WARP_ROWS = 16;     // query rows per warp
constexpr int LANE_ROWS = 4;      // a lane's rows: r, r + 4, r + 8, r + 12
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_MAX = 232448;  // shared memory a block may use (H100)

// sub-tile columns, ring stages and most CTA rows for head dim D
template <int D>
struct Plan;
#if FLASH_DTYPE == 0
template <> struct Plan<16> { static constexpr int BN = 64, STAGES = 3, ROWS = 128; };
template <> struct Plan<32> { static constexpr int BN = 64, STAGES = 3, ROWS = 128; };
template <> struct Plan<64> { static constexpr int BN = 32, STAGES = 3, ROWS = 128; };
template <> struct Plan<128> { static constexpr int BN = 32, STAGES = 2, ROWS = 64; };
#else
template <> struct Plan<16> { static constexpr int BN = 64, STAGES = 3, ROWS = 128; };
template <> struct Plan<32> { static constexpr int BN = 64, STAGES = 3, ROWS = 128; };
template <> struct Plan<64> { static constexpr int BN = 64, STAGES = 3, ROWS = 128; };
template <> struct Plan<128> { static constexpr int BN = 64, STAGES = 2, ROWS = 64; };
#endif

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int sq, skv;
  int bq, bkv;          // logical (clamped) blocks of the tile map
  int gkv;              // logical KV tiles per row (dense walk)
  int n_sub;            // CTAs per logical Q block
  int causal;
  int window;           // <= 0: no window
  float scale_log2;     // sm_scale * log2(e)
  const int* row_ptr;   // tri walk: per-row offsets (gq + 1); null: dense
  const int* kv_list;   // tri walk: KV tile index per entry
};

// ---------------------------------------------------------------------------
// copies and shared reads
// ---------------------------------------------------------------------------

// 16 bytes; only `bytes` (0 or 16) are read, the rest of dst is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ROWS rows of D elements from src (row-major, D-fast) into dst (row
// stride D + 16 bytes), in 16-byte chunks spread over NT threads: thread
// t copies chunk t % CPR of rows t / CPR + i * NT / CPR, so its pointers
// step by constants.  Rows from `valid` on are zero-filled.
template <int D, int ROWS, int NT, typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int valid,
                                          int tid) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int CPR = D / CH;       // chunks a row
  constexpr int LD = D + CH;
  constexpr int N = ROWS * CPR;
  constexpr int STEP = NT / CPR;    // rows between a thread's chunks
  static_assert(NT % CPR == 0, "a thread's chunks share one column");
  const int r0 = tid / CPR, ch = tid % CPR;
  dst += r0 * LD + ch * CH;
  src += (size_t)r0 * D + ch * CH;
#pragma unroll
  for (int it = 0; it < (N + NT - 1) / NT; ++it) {
    if (N % NT == 0 || tid + it * NT < N) {
      const bool ok = r0 + it * STEP < valid;
      cp_async16(dst + it * STEP * LD, src + (ok ? (size_t)it * STEP * D : 0),
                 ok ? 16 : 0);
    }
  }
}

// W consecutive elements of a shared row, widened to fp32
template <int W>
__device__ __forceinline__ void lds(const float* p, float (&x)[W]) {
  if constexpr (W == 1) {
    x[0] = *p;
  } else if constexpr (W == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x; x[1] = f.y;
  }
}
// bf16 widens exactly by moving its bits to the top of an fp32 word
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}
template <int W>
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float (&x)[W]) {
  if constexpr (W == 1) {
    x[0] = bf16_lo(*reinterpret_cast<const unsigned short*>(p));
  } else if constexpr (W == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    x[0] = bf16_lo(u.x); x[1] = bf16_hi(u.x);
    x[2] = bf16_lo(u.y); x[3] = bf16_hi(u.y);
  } else {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    x[0] = bf16_lo(u); x[1] = bf16_hi(u);
  }
}

template <int W>
__device__ __forceinline__ void stg(float* p, const float (&x)[W]) {
  if constexpr (W == 1)
    *p = x[0];
  else if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}
template <int W>
__device__ __forceinline__ void stg(__nv_bfloat16* p, const float (&x)[W]) {
  if constexpr (W == 1)
    *p = __float2bfloat16_rn(x[0]);
  else if constexpr (W == 4)
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf16_pair(x[0], x[1]), bf16_pair(x[2], x[3]));
  else
    *reinterpret_cast<unsigned*>(p) = bf16_pair(x[0], x[1]);
}

// 8 row scalars of a warp's exchange slot (two 16-byte reads)
__device__ __forceinline__ void lds_rows(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ float ldg1(const float* p) { return *p; }
__device__ __forceinline__ float ldg1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// 2^x by the SFU (ex2.approx.ftz: relative error below 2^-22, subnormal
// results flushed to 0, far below the tolerance); 2^0 = 1 (PTX special case)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a row's 8 lanes are lane / 8 == r: xor offsets below 8 stay inside them
__device__ __forceinline__ float row_max8(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum8(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// the walk
// ---------------------------------------------------------------------------

// the reference's _visible, on the logical tile (padded=True)
__device__ __forceinline__ bool visible(const Params& p, int q_start,
                                        int kv_start) {
  bool vis = kv_start < p.skv;
  if (p.causal) vis = vis && kv_start <= q_start + p.bq - 1;
  if (p.window > 0) vis = vis && kv_start + p.bkv - 1 > q_start - p.window;
  return vis;
}

struct Walk {
  int first, n_tiles;   // the row's tile list (dense: 0 .. gkv - 1)
  int t, c0, end;       // next tile, next sub-tile column, tile's end
};

// Advance to the next sub-tile this CTA computes (rows row0 .. row_end-1
// of the logical Q block at q_start): (c0, n) columns.  Every thread of
// the CTA runs it with the same values; both walks yield the same list.
template <int BN>
__device__ __forceinline__ bool next_sub(const Params& p, Walk& w,
                                         int q_start, int row0, int row_end,
                                         int& c0, int& n) {
  while (true) {
    if (w.c0 >= w.end) {
      if (w.t >= w.n_tiles) return false;
      const int j = p.row_ptr != nullptr ? p.kv_list[w.first + w.t] : w.t;
      ++w.t;
      const int kv_start = j * p.bkv;
      if (!visible(p, q_start, kv_start)) continue;
      w.c0 = kv_start;
      w.end = min(kv_start + p.bkv, p.skv);
      continue;
    }
    const int c = w.c0, cols = min(BN, w.end - c);
    w.c0 += BN;
    if (p.causal && c > row_end - 1) {           // above the diagonal
      w.c0 = w.end;
      continue;
    }
    if (p.window > 0 && c + cols - 1 <= row0 - p.window) continue;
    c0 = c;                     // written only for a sub-tile it yields
    n = cols;
    return true;
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// T is FlashT, a template argument so that ptxas names the type.
// Registers: at most 128 a thread for CTAs of 64 or more rows at D <= 64
// (two 256-thread CTAs an SM), else 255 (at D = 128 a lane holds 64
// accumulators); asking for 512 / NT or 256 / NT blocks an SM sets it.
template <typename T, int D, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(
    BM * 2, (D == 128 || BM < 64 ? 256 : 512) / (BM * 2))
flash_fwd_kernel(const Params p) {
  constexpr int NT = BM * 2;              // BM / 16 warps
  constexpr int CH = 16 / sizeof(T);
  constexpr int LD = D + CH;              // Q, K, V row stride (elements)
  constexpr int LDP = BN + 8;             // P slice row stride (floats)
  constexpr int TC = BN / 8;              // score columns a lane
  constexpr int OR = 8;                   // output rows a lane
  constexpr int VW = D >= 64 ? 4 : D / 16;  // output columns a chunk
  constexpr int OG = D / (16 * VW);       // output chunks a lane
  constexpr int OC = OG * VW;             // output columns a lane (D / 16)

  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);                   // BM x LD
  T* sKV = sQ + BM * LD;                                // STAGES x 2 x BN x LD
  float* sP = reinterpret_cast<float*>(sKV + STAGES * 2 * BN * LD);
  float* sR = sP + BM * LDP;                            // BM row scalars

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int lr = lane / 8, lc = lane % 8;      // scores: rows lr + 4i
  const int oh = lane / 16, oc = lane % 16;    // output: rows 8 oh + i
  const int bh = blockIdx.x;
  // causal: the last (heaviest) row blocks first
  const int blk = p.causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                           : (int)blockIdx.y;
  const int iq = blk / p.n_sub;                  // logical Q block
  const int q_start = iq * p.bq;
  const int row0 = q_start + (blk % p.n_sub) * BM;
  const int row_end = min(min(row0 + BM, q_start + p.bq), p.sq);
  if (row0 >= row_end) return;                   // whole block uniform
  const int wrow0 = row0 + warp * WARP_ROWS;     // the warp's first row
  const bool active = wrow0 < row_end;           // warp-uniform
  const T* sQw = sQ + warp * WARP_ROWS * LD;
  float* sPw = sP + warp * WARP_ROWS * LDP;
  float* sRw = sR + warp * WARP_ROWS;

  const T* q = static_cast<const T*>(p.q) + (size_t)bh * p.sq * D;
  const T* k = static_cast<const T*>(p.k) + (size_t)bh * p.skv * D;
  const T* v = static_cast<const T*>(p.v) + (size_t)bh * p.skv * D;
  T* o = static_cast<T*>(p.o) + (size_t)bh * p.sq * D;

  copy_rows<D, BM, NT>(sQ, q + (size_t)row0 * D, row_end - row0, tid);

  float m_i[LANE_ROWS], l_i[LANE_ROWS], acc[OR][OC];
#pragma unroll
  for (int i = 0; i < LANE_ROWS; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < OR; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;

  Walk w{0, p.gkv, 0, 0, 0};
  if (p.row_ptr != nullptr) {
    w.first = p.row_ptr[iq];
    w.n_tiles = p.row_ptr[iq + 1] - w.first;
  }

  // the ring: pending sub-tiles (c0s[s], ns[s]) in the slots it + s;
  // ns = 0: none.  Every group is committed, empty or not, so that
  // wait_group counts sub-tiles.
  int c0s[STAGES], ns[STAGES];
  auto load = [&](int slot, int c0, int n) {
    T* sK = sKV + slot * 2 * BN * LD;
    copy_rows<D, BN, NT>(sK, k + (size_t)c0 * D, n, tid);
    copy_rows<D, BN, NT>(sK + BN * LD, v + (size_t)c0 * D, n, tid);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    ns[s] = 0;
    if (next_sub<BN>(p, w, q_start, row0, row_end, c0s[s], ns[s]))
      load(s, c0s[s], ns[s]);
    cp_async_commit();                           // Q rides in group 0
  }

  for (int it = 0; ns[0] > 0; ++it) {
    cp_async_wait<STAGES - 2>();
    // publishes slot it; frees slot it - 1, which the next copy reuses
    __syncthreads();
    ns[STAGES - 1] = 0;
    if (next_sub<BN>(p, w, q_start, row0, row_end, c0s[STAGES - 1],
                     ns[STAGES - 1]))
      load((it + STAGES - 1) % STAGES, c0s[STAGES - 1], ns[STAGES - 1]);
    cp_async_commit();

    const int c0 = c0s[0], nc = ns[0];
    // the warp's rows see a key of the sub-tile; else p is 0 on each of
    // them, which would leave m, l and acc bitwise as they are
    const int wlast = min(wrow0 + WARP_ROWS, row_end) - 1;
    if (active && (!p.causal || c0 <= wlast) &&
        (p.window <= 0 || c0 + nc - 1 > wrow0 - p.window)) {
      const T* sK = sKV + (it % STAGES) * 2 * BN * LD;
      const T* sV = sK + BN * LD;

      float s[LANE_ROWS][TC];
#pragma unroll
      for (int i = 0; i < LANE_ROWS; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
      // one d step at a time at D <= 64 keeps 128 registers, unspilled
#pragma unroll (D == 128 ? 4 : 1)
      for (int d = 0; d < D; d += 4) {
        float qa[LANE_ROWS][4];
#pragma unroll
        for (int i = 0; i < LANE_ROWS; ++i) lds<4>(sQw + (lr + 4 * i) * LD + d, qa[i]);
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          float kb[4];
          lds<4>(sK + (lc + 8 * j) * LD + d, kb);
#pragma unroll
          for (int i = 0; i < LANE_ROWS; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[i][j] = fmaf(qa[i][e], kb[e], s[i][j]);
        }
      }

      // every element of the sub-tile is kept for every row of the warp
      const bool full = nc == BN &&
          (!p.causal || c0 + BN - 1 <= wrow0) &&
          (p.window <= 0 || c0 > wlast - p.window);
#pragma unroll
      for (int i = 0; i < LANE_ROWS; ++i) {
        const int qi = wrow0 + lr + 4 * i;
        auto keep = [&](int j) {
          const int col = lc + 8 * j;
          const int kv = c0 + col;
          return full || (col < nc && (!p.causal || kv <= qi) &&
                          (p.window <= 0 || kv > qi - p.window));
        };
        float m_cur = NEG_INF;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          s[i][j] = keep(j) ? s[i][j] * p.scale_log2 : NEG_INF;
          m_cur = fmaxf(m_cur, s[i][j]);
        }
        m_cur = row_max8(m_cur);
        const float m_new = fmaxf(m_i[i], m_cur);
        const float corr = exp2_fast(m_i[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const float pv = keep(j) ? exp2_fast(s[i][j] - m_new) : 0.f;
          psum += pv;
          sPw[(lr + 4 * i) * LDP + lc + 8 * j] = pv;
        }
        psum = row_sum8(psum);
        l_i[i] = corr * l_i[i] + psum;
        m_i[i] = m_new;
        if (lc == 0) sRw[lr + 4 * i] = corr;
      }
      __syncwarp();

      // the output rows' rescale, from the lanes that own their scores
      float cr[OR];
      lds_rows(sRw + oh * OR, cr);
#pragma unroll
      for (int i = 0; i < OR; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] *= cr[i];

#pragma unroll 4
      for (int kk = 0; kk < BN; kk += 4) {
        float pa[OR][4];
#pragma unroll
        for (int i = 0; i < OR; ++i) lds<4>(sPw + (oh * OR + i) * LDP + kk, pa[i]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const T* vrow = sV + (kk + u) * LD + oc * VW;
#pragma unroll
          for (int g = 0; g < OG; ++g) {
            float vv[VW];
            lds<VW>(vrow + g * 16 * VW, vv);
#pragma unroll
            for (int i = 0; i < OR; ++i)
#pragma unroll
              for (int e = 0; e < VW; ++e)
                acc[i][g * VW + e] = fmaf(pa[i][u], vv[e], acc[i][g * VW + e]);
          }
        }
      }
    }

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      c0s[s] = c0s[s + 1];
      ns[s] = ns[s + 1];
    }
  }
  cp_async_wait<0>();

  // rows with no visible key: the reference's uniform average over the
  // visible logical tiles (see the header)
  bool empty_row = false;
#pragma unroll
  for (int i = 0; i < LANE_ROWS; ++i)
    empty_row |= wrow0 + lr + 4 * i < row_end && l_i[i] == 0.f;
  float* sVbar = sP;              // D floats; every warp is past its PV
  const bool any_empty = __syncthreads_or(empty_row);
  if (any_empty) {
    for (int col = tid; col < D; col += NT) {
      float vsum = 0.f;
      int n_vis = 0;
      for (int t = 0; t < w.n_tiles; ++t) {
        const int j = p.row_ptr != nullptr ? p.kv_list[w.first + t] : t;
        const int kv_start = j * p.bkv;
        if (!visible(p, q_start, kv_start)) continue;
        ++n_vis;
        const int tile_end = min(kv_start + p.bkv, p.skv);
        for (int c = kv_start; c < tile_end; ++c)
          vsum += ldg1(v + (size_t)c * D + col);
      }
      sVbar[col] = n_vis > 0 ? vsum / (float)(n_vis * p.bkv) : 0.f;
    }
    __syncthreads();
  }

  if (!active) return;
  // the output rows' sums, from the lanes that own their scores (every
  // read of sRw in the walk came before the barrier above)
  if (lc == 0) {
#pragma unroll
    for (int i = 0; i < LANE_ROWS; ++i) sRw[lr + 4 * i] = l_i[i];
  }
  __syncwarp();
  float lsum[OR];
  lds_rows(sRw + oh * OR, lsum);
#pragma unroll
  for (int i = 0; i < OR; ++i) {
    const int qi = wrow0 + oh * OR + i;
    if (qi >= row_end) continue;
    const bool empty = lsum[i] == 0.f;
    const float inv = fmaxf(lsum[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < OG; ++g) {
      const int col = oc * VW + g * 16 * VW;
      float x[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e)
        x[e] = empty ? sVbar[col + e] : acc[i][g * VW + e] / inv;
      stg<VW>(o + (size_t)qi * D + col, x);
    }
  }
}

template <int D, int BM>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
  using P = Plan<D>;
  constexpr size_t smem =
      sizeof(FlashT) * (BM + P::STAGES * 2 * P::BN) * (D + 16 / sizeof(FlashT))
      + sizeof(float) * BM * (P::BN + 8 + 1);
  static_assert(smem <= SMEM_MAX / 2, "two CTAs an SM");
  auto kernel = flash_fwd_kernel<FlashT, D, BM, P::BN, P::STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, BM * 2, smem, stream>>>(p);
  return cudaGetLastError();
}

// the plan (rows, bn, stages) must be one this unit compiles
template <int D>
cudaError_t launch_plan(const Params& p, int rows, int bn, int stages,
                        dim3 grid, cudaStream_t stream) {
  using P = Plan<D>;
  if (bn != P::BN || stages != P::STAGES || rows > P::ROWS)
    return cudaErrorInvalidValue;
  switch (rows) {
    case 16: return launch<D, 16>(p, grid, stream);
    case 32: return launch<D, 32>(p, grid, stream);
    case 64: return launch<D, 64>(p, grid, stream);
    case 128:
      if constexpr (P::ROWS >= 128) return launch<D, 128>(p, grid, stream);
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, bound from Python through ctypes.
//   dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window.
//   row_ptr / kv_list: the tri walk's CSR tile list, or both null for
//   the dense walk.  cta_rows, sub_cols and stages are the planner's
//   (kernels/flash_attention.py::flash_launch) and must be a plan of the
//   table in the header; q, k, v and o must be 16-byte aligned.  Launches
//   on `stream`, does not synchronise, and returns the cudaError_t of the
//   launch (0 on success).
//
// This file compiles twice (FLASH_DTYPE): each build defines the entry of
// its input type, and the float32 build also flash_attention_forward,
// which calls the one the dtype names.
#define FLASH_ARGS                                                         \
    const void *q, const void *k, const void *v, void *o, int bh, int sq,  \
    int skv, int d, int bq, int bkv, int causal, int window,               \
    float sm_scale, int dtype, const int *row_ptr, const int *kv_list,     \
    int cta_rows, int sub_cols, int stages, void *stream
#define FLASH_CALL                                                         \
    q, k, v, o, bh, sq, skv, d, bq, bkv, causal, window, sm_scale, dtype,  \
    row_ptr, kv_list, cta_rows, sub_cols, stages, stream

#if FLASH_DTYPE == 0
#define FLASH_TYPED flash_attention_forward_f32
#else
#define FLASH_TYPED flash_attention_forward_bf16
#endif

extern "C" int FLASH_TYPED(FLASH_ARGS) {
  if (bh <= 0 || sq <= 0 || skv <= 0 || bq <= 0 || bkv <= 0 ||
      cta_rows <= 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15)
    return (int)cudaErrorMisalignedAddress;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.sq = sq; p.skv = skv; p.bq = bq; p.bkv = bkv;
  p.gkv = (skv + bkv - 1) / bkv;
  p.n_sub = (bq + cta_rows - 1) / cta_rows;
  p.causal = causal; p.window = window;
  p.scale_log2 = sm_scale * LOG2E;
  p.row_ptr = row_ptr; p.kv_list = kv_list;
  const long long rows = (long long)((sq + bq - 1) / bq) * p.n_sub;
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, (unsigned)rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return (int)launch_plan<16>(p, cta_rows, sub_cols, stages, grid, s);
    case 32: return (int)launch_plan<32>(p, cta_rows, sub_cols, stages, grid, s);
    case 64: return (int)launch_plan<64>(p, cta_rows, sub_cols, stages, grid, s);
    case 128: return (int)launch_plan<128>(p, cta_rows, sub_cols, stages, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#if FLASH_DTYPE == 0
extern "C" int flash_attention_forward_bf16(FLASH_ARGS);

extern "C" int flash_attention_forward(FLASH_ARGS) {
  return dtype == 1 ? flash_attention_forward_bf16(FLASH_CALL)
         : dtype == 0 ? flash_attention_forward_f32(FLASH_CALL)
                      : (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
