// Eval-mode fused Linear -> BatchNorm (running statistics) -> ReLU for
// Hopper (sm_90a), f32 in and out.
//
//   y = relu((x @ w + b - running_mean) * rsqrt(running_var + eps) * gamma + beta)
//
// x (B, F), w (F, H), b/gamma/beta/running_mean/running_var (H,), y (B, H);
// all float32, row-major, contiguous.
//
// A trial axis: K independent problems in one launch (the K-stacked HPO
// trials' validation), trial k in blockIdx.y; the cluster spans x only. w,
// the vectors and y carry a leading K axis ((K, F, H), (K, H), (K, B, H)); x
// is (K, B, F) or one (B, F) that every trial reads (trial stride 0: the
// validation split is the same for every trial). K = 1 is the single model.
//
// Replaces flexynesis_tpu/ops/pallas/fused_linear.py:223 (the pallas_call of
// fused_linear_bn_relu_eval; its kernel body is fused_linear.py:215-220). As
// there, the pre-activation h = x @ w + b never reaches device memory: bias,
// BatchNorm and ReLU run in the epilogue before the only store of y.
//
// What bounds it on an H100, by the sizes of its paths:
// * The 2000-row cohort, (2000, 2000, 600) at the gex encoder: 4.8 GFLOP
//   against 25 MB, about 190 FLOP per byte, so arithmetic bounds it: 72 us at
//   the f32 FMA rate (67 TFLOP/s), 29 us for three TF32 products on the tensor
//   cores (495 TFLOP/s).
// * 64-row requests and the 400- and 500-row validation and test batches: one
//   CTA per 64 x 64 tile of y gives 1 to 80 CTAs for 132 SMs, each walking all
//   of F; latency and occupancy, not FLOPs or bytes, set the time there.
//
// What the design does about it:
// * Split F over a thread-block cluster. Each 64 x 64 tile of y gets `split`
//   CTAs (1, 2, 4 or 8; the wrapper's planner, kernels/fused_linear.py::
//   plan_b2, picks the split and the slice depth per launch), each over one
//   contiguous slice of F, until the grid fills the 3 CTAs an SM holds at
//   once (__launch_bounds__ keeps registers and shared memory within that):
//   one CTA, one warp per scheduler, cannot hide the latency of its mma.sync
//   and shared-memory loads. 80 CTAs at (64, 2000, 600), 560 and 640 at the
//   400- and 500-row gex encoders, 640 at the cohort's (split 2, which also
//   spreads its 320 tiles evenly over the SMs), split 1 (no cluster) at the
//   64-deep head.
// * The main loop runs on the tensor cores in 3xTF32: mma.sync m16n8k8 with
//   TF32 operands. One TF32 pass keeps 10 mantissa bits and misses the 1e-4
//   tolerance at F = 2000, so each operand is split, a = big + small with
//   big = tf32(a) and small = tf32(a - big), and the product accumulates
//   small*big and big*small before big*big (small*small, about 2^-22 of the
//   product, is dropped): close to f32 accuracy for three products. The
//   tensor cores' own additions do not round to nearest, so each stage
//   (32 of depth) sums into fresh registers that a plain f32 add folds into
//   the running sum: the error of those additions stays that of one stage.
//   The TF32 roundings are integer adds (see round_tf32), not conversions.
// * Loads overlap the arithmetic: a 3-stage ring of 32-deep cp.async stages
//   in 55 KB of dynamic shared memory (four k8 steps per barrier), 16 bytes
//   a copy where the row strides allow it (F % 4 == 0 for x, H % 4 == 0 for
//   w, and 16-byte aligned bases), 4 bytes otherwise, a template parameter
//   picked per launch; ragged rows, columns and depth are zero-filled by the
//   copies' source size.
// * The shared tiles are padded (x rows 36 floats apart, w rows 72) so that
//   the fragment loads of a warp fall on 32 distinct banks.
// * The partial tiles of a cluster are reduced through distributed shared
//   memory in rank order: after cluster.sync() CTA r sums the `split`
//   partials of its 64 / split columns over ranks 0, 1, ..., runs the
//   per-element epilogue on them and stores y (the `split` remote loads of an
//   element are issued together, then summed in order); a second
//   cluster.sync() keeps every CTA's shared memory alive until all have
//   read it. No float atomics: two calls give the same bits.
//
// Why mma.sync and not wgmma: TF32 wgmma takes both operands K-major in
// shared memory, and w is (F, H), N-major (the Flax layout the port keeps), so
// wgmma would need a transposed copy of w that the port does not hold. That,
// and TMA loads with mbarriers, are later work.

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;          // rows of y per tile
constexpr int BN = 64;          // columns of y per tile
constexpr int BK = 32;          // depth of one cp.async stage
constexpr int NSTAGE = 3;       // stages in flight
constexpr int WM = 32;          // rows of a warp's part of the tile
constexpr int WN = 32;          // columns of a warp's part of the tile
constexpr int MT = WM / 16;     // m16 fragments per warp
constexpr int NT = WN / 8;      // n8 fragments per warp
constexpr int WARPS = (BM / WM) * (BN / WN);  // 4
constexpr int THREADS = WARPS * 32;           // 128
constexpr int MAX_SPLIT = 8;    // the portable cluster size
constexpr int CTAS_PER_SM = 3;  // kernels/fused_linear.py::B2_CTAS_PER_SM
constexpr int XS_LD = BK + 4;   // padded row of the x tile
constexpr int WS_LD = BN + 8;   // padded row of the w tile
constexpr int PART_LD = BN + 8; // padded row of the partial tile
constexpr int STAGE_FLOATS = BM * XS_LD + BK * WS_LD;
constexpr int RING_FLOATS = NSTAGE * STAGE_FLOATS;
constexpr int RING_BYTES = RING_FLOATS * 4;  // 55,296: dynamic shared memory

static_assert(BM * PART_LD <= RING_FLOATS, "the partial tile reuses the ring");
static_assert((BM * BK / 4) % THREADS == 0, "16-byte x copies split evenly");
static_assert((BK * BN / 4) % THREADS == 0, "16-byte w copies split evenly");
static_assert(BN % MAX_SPLIT == 0, "every cluster size divides the tile's columns");
static_assert(BK % 8 == 0, "a stage is whole k8 steps");

// One stage: x rows [row0, row0 + 64) x depth [k0, k0 + 32) and w depth
// [k0, k0 + 32) x columns [col0, col0 + 64), zero outside B, k_end and H.
template <bool VEC_X, bool VEC_W>
__device__ __forceinline__ void load_stage(float* xs, float* ws, const float* __restrict__ x,
                                           const float* __restrict__ w, int B, int F, int H,
                                           int row0, int col0, int k0, int k_end, int tid) {
  if (VEC_X) {
#pragma unroll
    for (int l = 0; l < BM * BK / 4 / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / (BK / 4), k = (idx % (BK / 4)) * 4;
      const bool ok = row0 + r < B && k0 + k < k_end;
      fxk::cp_async16(xs + r * XS_LD + k, ok ? x + (long long)(row0 + r) * F + k0 + k : x,
                      ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int l = 0; l < BM * BK / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BK, k = idx % BK;
      const bool ok = row0 + r < B && k0 + k < k_end;
      fxk::cp_async4(xs + r * XS_LD + k, ok ? x + (long long)(row0 + r) * F + k0 + k : x,
                     ok ? 4 : 0);
    }
  }
  if (VEC_W) {
#pragma unroll
    for (int l = 0; l < BK * BN / 4 / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int k = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
      const bool ok = k0 + k < k_end && col0 + c < H;
      fxk::cp_async16(ws + k * WS_LD + c, ok ? w + (long long)(k0 + k) * H + col0 + c : w,
                      ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int l = 0; l < BK * BN / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int k = idx / BN, c = idx % BN;
      const bool ok = k0 + k < k_end && col0 + c < H;
      fxk::cp_async4(ws + k * WS_LD + c, ok ? w + (long long)(k0 + k) * H + col0 + c : w,
                     ok ? 4 : 0);
    }
  }
}

// TF32 rounding of a to nearest, ties away from zero (the rule of
// cvt.rna.tf32.f32, whose bits it gives for finite a) by one integer add of
// half the 13 dropped bits: the tensor cores ignore those bits, so they need
// no clearing. An integer add in place of a conversion instruction.
__device__ __forceinline__ unsigned round_tf32(float a) { return __float_as_uint(a) + 0x1000u; }

// a = big + small, each rounded to TF32; small is the rounding of the exact
// remainder a - big
__device__ __forceinline__ void split_tf32(float a, unsigned& big, unsigned& small) {
  big = round_tf32(a);
  small = round_tf32(a - __uint_as_float(big & 0xffffe000u));
}

// c += a (16 x 8, rows) * b (8 x 8, columns) on the tensor cores
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// grid: one CTA per (row tile, column tile, rank), rank fastest; cluster
// (split, 1, 1), so the CTAs of one tile form one cluster.
template <bool VEC_X, bool VEC_W>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
fused_linear_bn_relu_eval_kernel(const float* __restrict__ x,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta,
                                 const float* __restrict__ running_mean,
                                 const float* __restrict__ running_var,
                                 float* __restrict__ y,
                                 int B, int F, int H, int split, int slice, int col_tiles,
                                 long long x_stride, float eps) {
  // the ring of stages (RING_BYTES); after the main loop, this CTA's partial
  // tile
  extern __shared__ __align__(16) float smem[];
  // per column of the columns this CTA finishes: bias, mean, rsqrt(var + eps),
  // gamma, beta
  __shared__ float col_b[BN], col_mean[BN], col_inv[BN], col_g[BN], col_be[BN];

  // split 1 is launched without a cluster, and its CTA reads only its own tile
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = split == 1 ? 0 : (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;  // the mma fragments' row group and column
  const int wr = (warp / (BN / WN)) * WM, wc = (warp % (BN / WN)) * WN;
  // this CTA's trial: every operand moves to its slice
  const long long trial = blockIdx.y;
  x += trial * x_stride;
  w += trial * F * H;
  b += trial * H;
  gamma += trial * H;
  beta += trial * H;
  running_mean += trial * H;
  running_var += trial * H;
  y += trial * B * H;
  const int tile = blockIdx.x / split;
  const int row0 = (tile / col_tiles) * BM;
  const int col0 = (tile % col_tiles) * BN;
  const int k_begin = (int)min((long long)F, (long long)rank * slice);
  const int k_end = (int)min((long long)F, (long long)k_begin + slice);
  const int n_stages = (k_end - k_begin + BK - 1) / BK;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // the ring: stage s lives in buffer s % NSTAGE; one commit group per stage
  // (empty past the slice) keeps the group count the same in every thread
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_stages)
      load_stage<VEC_X, VEC_W>(smem + s * STAGE_FLOATS, smem + s * STAGE_FLOATS + BM * XS_LD,
                               x, w, B, F, H, row0, col0, k_begin + s * BK, k_end, tid);
    fxk::cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    fxk::cp_async_wait<NSTAGE - 2>();  // stage s has landed (this thread's copies)
    __syncthreads();                   // ... everyone's; and stage s - 1 is consumed
    const int next = s + NSTAGE - 1;
    if (next < n_stages) {
      float* buf = smem + (next % NSTAGE) * STAGE_FLOATS;
      load_stage<VEC_X, VEC_W>(buf, buf + BM * XS_LD, x, w, B, F, H, row0, col0,
                               k_begin + next * BK, k_end, tid);
    }
    fxk::cp_async_commit();
    const float* xs = smem + (s % NSTAGE) * STAGE_FLOATS;
    const float* ws = xs + BM * XS_LD;

    float st[MT][NT][4];  // this stage's sum, folded into acc by f32 adds
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) st[i][j][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      // A fragments (rows g and g + 8, depth t and t + 4 of each m16 tile)
      unsigned a_big[MT][4], a_small[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* p = xs + (wr + i * 16 + g) * XS_LD + kk + t;
        split_tf32(p[0], a_big[i][0], a_small[i][0]);
        split_tf32(p[8 * XS_LD], a_big[i][1], a_small[i][1]);
        split_tf32(p[4], a_big[i][2], a_small[i][2]);
        split_tf32(p[8 * XS_LD + 4], a_big[i][3], a_small[i][3]);
      }
      // B fragments (depth t and t + 4, column g of each n8 tile)
      unsigned b_big[NT][2], b_small[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* p = ws + (kk + t) * WS_LD + wc + j * 8 + g;
        split_tf32(p[0], b_big[j][0], b_small[j][0]);
        split_tf32(p[4 * WS_LD], b_big[j][1], b_small[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(st[i][j], a_small[i], b_big[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(st[i][j], a_big[i], b_small[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(st[i][j], a_big[i], b_big[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += st[i][j][q];
  }
  fxk::cp_async_wait<0>();
  __syncthreads();  // no warp reads the ring any more: the partial tile reuses it

  // this CTA's partial tile: element q of fragment (i, j) is row g (+8 for
  // q >= 2), column 2t + (q & 1)
  float* part = smem;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = wr + i * 16 + g, c = wc + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(part + r * PART_LD + c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(part + (r + 8) * PART_LD + c) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  // reduce-scatter: this CTA finishes columns [c_own, c_own + cw) of the tile
  const int cw = BN / split;
  const int c_own = rank * cw;
  if (tid < cw) {
    const int c = col0 + c_own + tid;
    const bool ok = c < H;
    col_b[tid] = ok ? b[c] : 0.f;
    col_mean[tid] = ok ? running_mean[c] : 0.f;
    col_inv[tid] = ok ? rsqrtf(running_var[c] + eps) : 0.f;
    col_g[tid] = ok ? gamma[c] : 0.f;
    col_be[tid] = ok ? beta[c] : 0.f;
  }
  // every partial tile of the cluster is written
  if (split > 1) cluster.sync(); else __syncthreads();

  // cw is a power of two; unrolled, the loads of several elements are in
  // flight at once
  const int cw_log2 = 31 - __clz(cw);
#pragma unroll 4
  for (int idx = tid; idx < BM * cw; idx += THREADS) {
    const int r = idx >> cw_log2, lc = idx & (cw - 1);
    const int gr = row0 + r, c = col0 + c_own + lc;
    float s = 0.f;
    if (split == 1) {
      s += part[r * PART_LD + lc];
    } else {
      // every rank's value in flight at once, then the sum in rank order
      float v[MAX_SPLIT];
#pragma unroll
      for (int q = 0; q < MAX_SPLIT; ++q)
        if (q < split) v[q] = cluster.map_shared_rank(part + r * PART_LD + c_own + lc, q)[0];
#pragma unroll
      for (int q = 0; q < MAX_SPLIT; ++q)
        if (q < split) s += v[q];
    }
    if (gr < B && c < H) {
      const float h = s + col_b[lc];
      y[(long long)gr * H + c] =
          fmaxf((h - col_mean[lc]) * col_inv[lc] * col_g[lc] + col_be[lc], 0.f);
    }
  }
  // no CTA reads another's shared memory past this point
  if (split > 1) cluster.sync();
}

template <bool VEC_X, bool VEC_W>
cudaError_t launch(unsigned blocks, unsigned trials, cudaStream_t stream, const float* x,
                   const float* w, const float* b, const float* gamma, const float* beta,
                   const float* running_mean, const float* running_var, float* y, int B,
                   int F, int H, int split, int slice, int col_tiles, long long x_stride,
                   float eps) {
  auto kernel = fused_linear_bn_relu_eval_kernel<VEC_X, VEC_W>;
  // above 48 KB a block's shared memory must be allowed per function and
  // device: once, at the first launch on each device (a bit per device; a
  // device past the 64th sets it every launch)
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(allowed.load(std::memory_order_relaxed) & bit)) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
    if (rc != cudaSuccess) return rc;
    allowed.fetch_or(bit, std::memory_order_relaxed);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, trials);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = RING_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;  // split 1 needs no cluster
  return cudaLaunchKernelEx(&cfg, kernel, x, w, b, gamma, beta, running_mean, running_var, y,
                            B, F, H, split, slice, col_tiles, x_stride, eps);
}

}  // namespace

// Launches on `stream` and returns the first CUDA error as an int (0 =
// launched). Pointers are device pointers. `split` (1, 2, 4 or 8) CTAs share
// each 64 x 64 tile of y, CTA r over depth [r * slice, (r + 1) * slice) of F,
// so `slice` is a multiple of 32 with split * slice >= F and, for split > 1,
// (split - 1) * slice < F: no CTA of a cluster is idle (the wrapper's
// planner, kernels/fused_linear.py::plan_b2, picks both). `trials` (K >= 1)
// problems run in one launch; x_per_trial says whether x is (K, B, F) or one
// (B, F) for all. The caller checks shapes, types and layout.
extern "C" int fused_linear_bn_relu_eval_f32(const void* x, const void* w, const void* b,
                                             const void* gamma, const void* beta,
                                             const void* running_mean,
                                             const void* running_var, void* y, int trials,
                                             int x_per_trial, int B, int F, int H, int split,
                                             int slice, float eps, void* stream) {
  if (trials <= 0 || trials > 65535 || B <= 0 || H <= 0 || F < 0)
    return (int)cudaErrorInvalidValue;
  if (split != 1 && split != 2 && split != 4 && split != MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  if (slice < 0 || slice % BK != 0 || (long long)split * slice < F ||
      (split > 1 && (long long)(split - 1) * slice >= F))
    return (int)cudaErrorInvalidValue;
  const long long col_tiles = (H + BN - 1) / BN;
  const long long blocks = (B + BM - 1) / BM * col_tiles * split;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long x_stride = x_per_trial ? (long long)B * F : 0;
  // a 16-byte copy needs every trial's rows 16-byte aligned: the base, the
  // row stride and the trial stride (F * H for w) in whole float4s
  const bool vec_x = F % 4 == 0 && x_stride % 4 == 0 &&
                     reinterpret_cast<unsigned long long>(x) % 16 == 0;
  const bool vec_w = H % 4 == 0 && ((long long)F * H) % 4 == 0 &&
                     reinterpret_cast<unsigned long long>(w) % 16 == 0;
  auto run = vec_x ? (vec_w ? &launch<true, true> : &launch<true, false>)
                   : (vec_w ? &launch<false, true> : &launch<false, false>);
  int rc = (int)run((unsigned)blocks, (unsigned)trials, static_cast<cudaStream_t>(stream),
                    static_cast<const float*>(x), static_cast<const float*>(w),
                    static_cast<const float*>(b), static_cast<const float*>(gamma),
                    static_cast<const float*>(beta), static_cast<const float*>(running_mean),
                    static_cast<const float*>(running_var), static_cast<float*>(y), B, F, H,
                    split, slice, (int)col_tiles, x_stride, eps);
  if (rc == 0) rc = (int)cudaGetLastError();
  return rc;
}
