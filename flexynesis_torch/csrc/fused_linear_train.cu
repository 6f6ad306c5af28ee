// Training-mode fused Linear -> BatchNorm (batch statistics) -> ReLU for
// Hopper (sm_90a), f32.
//
//   h   = x @ w + b
//   mu  = mean over the batch of h          (per column)
//   var = mean over the batch of (h - mu)^2 (biased, per column)
//   y   = relu((h - mu) * rsqrt(var + eps) * gamma + beta)
//
// x (B, F), w (F, H), b/gamma/beta (H,); outputs y and h (B, H), mu and var
// (H,); all float32, row-major, contiguous. h is kept for the backward pass.
//
// A trial axis: K independent problems in one launch (the K-stacked HPO
// trials), trial k in blockIdx.y. w, the vectors and every output carry a
// leading K axis ((K, F, H), (K, H), (K, B, H)); x is (K, B, F), or one
// (B, F) that every trial reads (a trial stride of 0: same-architecture
// trials share their batch rows). The JAX engine gets this axis from vmap over
// the pallas_call, which adds a grid dimension. K = 1 is the single model.
//
// Replaces flexynesis_tpu/ops/pallas/fused_linear.py::_fused_forward (the
// Pallas kernel body _fused_fwd_kernel, fused_linear.py:59-80). The Pallas
// kernel keeps the whole batch of a column tile in VMEM and falls back to
// unfused XLA above a VMEM budget. Here nothing falls back.
//
// What bounds it: at the DirectPred training shapes (B = 64; F 2000 or 1000;
// H 600 or 300) the work is 154 MFLOP and 5.6 MB at the largest, about
// 2.3 us of an H100's f32 FMA rate and 1.7 us of its memory rate. A grid of
// one block per 64 x 64 tile of h has only ceil(H / 64) blocks (10 at
// H = 600) on 132 SMs, each walking all of F with nothing in flight, so the
// kernel is bound by latency and occupancy, not by FLOPs or bytes. So:
//
// * Split F over a thread-block cluster. Each 64-row x 32-column tile of h
//   gets a cluster of `split` CTAs (1, 2, 4 or 8; the wrapper's planner picks
//   it and the slice depth per launch), each over one contiguous slice of F:
//   152 CTAs at (64, 2000, 600) and 80 at (64, 1000, 300) instead of 10 and 5.
// * Overlap loads with arithmetic: each CTA walks its slice in 16-deep stages
//   through a 4-stage ring of cp.async copies, 16 bytes a copy where the row
//   strides allow it (F % 4 == 0 for x, H % 4 == 0 for w), 4 bytes otherwise;
//   ragged rows, columns and depth are zero-filled by the copies themselves.
// * Reduce through distributed shared memory in a fixed order (a
//   reduce-scatter by columns): every CTA keeps its 64 x 32 partial tile in
//   its own shared memory; after cluster.sync() CTA r sums the `split`
//   partials of its 32 / split columns in rank order 0, 1, ..., adds the
//   bias, stores h, and computes each column's mean and centred sum of
//   squares (M2) over the valid rows with fixed-order warp sums. No float
//   atomics anywhere: two calls give the same bits.
// * B <= 64 (one row tile, the training batch of 32 or 64): the same CTA
//   finishes the BatchNorm and the ReLU and writes y, mu and var: one launch.
//   B > 64: each row tile writes its (mean, M2) partials, and a second launch
//   (bn_relu_merge_kernel) merges them for its 32 columns in one fixed order
//   (tile 0, 1, 2, ... with Chan's formula), then normalises and applies the
//   ReLU. This split reduction has no batch-size ceiling.
//
// The arithmetic is f32 FMA: TF32 tensor-core operands would miss the 1e-4
// tolerance against the f32 plain version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;      // rows of h per tile
constexpr int BN = 32;      // columns of h per tile
constexpr int BK = 16;      // depth of one cp.async stage
constexpr int NSTAGE = 4;   // stages in flight
constexpr int TM = 4;       // rows per thread
constexpr int TN = 2;       // columns per thread
constexpr int THREADS_X = BN / TN;  // 16
constexpr int THREADS_Y = BM / TM;  // 16
constexpr int THREADS = THREADS_X * THREADS_Y;  // 256
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SPLIT = 8;  // the portable cluster size

constexpr int MERGE_COLS = 32;   // columns per block of the merge launch
constexpr int MERGE_ROWS = 64;   // rows per block of the merge launch
constexpr int MERGE_THREADS = 256;
static_assert(MERGE_ROWS == BM, "the merge's blocks of rows are the row tiles");

static_assert(BM * BK / 4 == THREADS, "one 16-byte x copy per thread and stage");
static_assert(BK * BN / 4 <= THREADS, "at most one 16-byte w copy per thread and stage");
static_assert(BN % MAX_SPLIT == 0, "every cluster size divides the tile's columns");

// One stage: x rows [row0, row0 + 64) x depth [k0, k0 + 16) and w depth
// [k0, k0 + 16) x columns [col0, col0 + 32), zero outside B, k_end and H.
template <bool VEC_X, bool VEC_W>
__device__ __forceinline__ void load_stage(float (*xs)[BK], float (*ws)[BN],
                                           const float* __restrict__ x,
                                           const float* __restrict__ w, int B, int F,
                                           int H, int row0, int col0, int k0, int k_end,
                                           int tid) {
  if (VEC_X) {
    const int r = tid >> 2, k = (tid & 3) * 4;
    const bool ok = row0 + r < B && k0 + k < k_end;
    fxk::cp_async16(&xs[r][k], ok ? x + (long long)(row0 + r) * F + k0 + k : x, ok ? 16 : 0);
  } else {
#pragma unroll
    for (int l = 0; l < BM * BK / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BK, k = idx % BK;
      const bool ok = row0 + r < B && k0 + k < k_end;
      fxk::cp_async4(&xs[r][k], ok ? x + (long long)(row0 + r) * F + k0 + k : x, ok ? 4 : 0);
    }
  }
  if (VEC_W) {
    if (tid < BK * BN / 4) {
      const int k = tid / (BN / 4), c = (tid % (BN / 4)) * 4;
      const bool ok = k0 + k < k_end && col0 + c < H;
      fxk::cp_async16(&ws[k][c], ok ? w + (long long)(k0 + k) * H + col0 + c : w, ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int l = 0; l < BK * BN / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int k = idx / BN, c = idx % BN;
      const bool ok = k0 + k < k_end && col0 + c < H;
      fxk::cp_async4(&ws[k][c], ok ? w + (long long)(k0 + k) * H + col0 + c : w, ok ? 4 : 0);
    }
  }
}

// grid: one CTA per (row tile, column tile, rank), rank fastest; cluster
// (split, 1, 1), so the CTAs of one tile form one cluster.
template <bool VEC_X, bool VEC_W>
__global__ void __launch_bounds__(THREADS)
fused_linear_bn_relu_train_split_kernel(const float* __restrict__ x,
                                        const float* __restrict__ w,
                                        const float* __restrict__ b,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta,
                                        float* __restrict__ h,
                                        float* __restrict__ y,
                                        float* __restrict__ mean,
                                        float* __restrict__ var,
                                        float* __restrict__ part_mean,
                                        float* __restrict__ part_m2,
                                        int B, int F, int H, int split, int slice,
                                        int col_tiles, long long x_stride, float eps) {
  __shared__ __align__(16) float xs[NSTAGE][BM][BK];
  __shared__ __align__(16) float ws[NSTAGE][BK][BN];
  __shared__ float part[BM][BN + 1];  // this CTA's partial tile, read by its cluster
  __shared__ float hs[BM][BN + 1];    // h of the columns this CTA finishes
  __shared__ float col_mean[BN];
  __shared__ float col_inv[BN];

  // split 1 is launched without a cluster, and its CTA reads only its own tile
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = split == 1 ? 0 : (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int tx = tid % THREADS_X;
  const int ty = tid / THREADS_X;
  // this CTA's trial: every operand moves to its slice
  const long long trial = blockIdx.y;
  const int row_tiles = (B + BM - 1) / BM;
  x += trial * x_stride;
  w += trial * F * H;
  b += trial * H;
  gamma += trial * H;
  beta += trial * H;
  h += trial * B * H;
  y += trial * B * H;
  mean += trial * H;
  var += trial * H;
  if (part_mean != nullptr) {
    part_mean += trial * row_tiles * H;
    part_m2 += trial * row_tiles * H;
  }
  const int tile = blockIdx.x / split;
  const int row_tile = tile / col_tiles;
  const int row0 = row_tile * BM;
  const int col0 = (tile % col_tiles) * BN;
  const int rows = min(BM, B - row0);  // valid rows of this tile (>= 1)
  const bool whole_batch = B <= BM;    // the same for every CTA of the grid
  const int k_begin = (int)min((long long)F, (long long)rank * slice);
  const int k_end = (int)min((long long)F, (long long)k_begin + slice);
  const int n_stages = (k_end - k_begin + BK - 1) / BK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // the ring: stage s lives in buffer s % NSTAGE; one commit group per stage
  // (empty past the slice) keeps the group count the same in every thread
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_stages)
      load_stage<VEC_X, VEC_W>(xs[s], ws[s], x, w, B, F, H, row0, col0, k_begin + s * BK,
                               k_end, tid);
    fxk::cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    fxk::cp_async_wait<NSTAGE - 2>();  // stage s has landed (this thread's copies)
    __syncthreads();                   // ... everyone's; and stage s - 1 is consumed
    const int next = s + NSTAGE - 1;
    if (next < n_stages)
      load_stage<VEC_X, VEC_W>(xs[next % NSTAGE], ws[next % NSTAGE], x, w, B, F, H, row0,
                               col0, k_begin + next * BK, k_end, tid);
    fxk::cp_async_commit();
    const int buf = s % NSTAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(&xs[buf][ty + i * THREADS_Y][kk]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = ws[buf][kk + q][tx + j * THREADS_X];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = fxk::component(a[i], q);
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }
  fxk::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) part[ty + i * THREADS_Y][tx + j * THREADS_X] = acc[i][j];
  // every partial tile of the cluster is written
  if (split > 1) cluster.sync(); else __syncthreads();

  // reduce-scatter: this CTA finishes columns [c_own, c_own + cw) of the tile,
  // summing the cluster's partials in rank order
  const int cw = BN / split;
  const int c_own = rank * cw;
  for (int idx = tid; idx < BM * cw; idx += THREADS) {
    const int r = idx / cw, lc = idx % cw;
    float s = 0.f;
    if (split == 1) {
      s += part[r][lc];
    } else {
      for (int q = 0; q < split; ++q) s += cluster.map_shared_rank(&part[r][c_own + lc], q)[0];
    }
    const int c = col0 + c_own + lc;
    const float hv = s + (c < H ? b[c] : 0.f);
    hs[r][lc] = hv;
    if (r < rows && c < H) h[(long long)(row0 + r) * H + c] = hv;
  }
  // no CTA reads another's shared memory past this point
  if (split > 1) cluster.sync(); else __syncthreads();

  // column statistics over the valid rows: one warp per column, two rows per
  // lane, the exact two-pass mean and centred sum of squares
  const int warp = tid / 32, lane = tid % 32;
  for (int lc = warp; lc < cw; lc += WARPS) {
    const int c = col0 + c_own + lc;
    if (c >= H) break;  // the same for the whole warp
    const float v0 = lane < rows ? hs[lane][lc] : 0.f;
    const float v1 = lane + 32 < rows ? hs[lane + 32][lc] : 0.f;
    const float m = fxk::warp_sum(v0 + v1) / rows;
    const float d0 = lane < rows ? v0 - m : 0.f;
    const float d1 = lane + 32 < rows ? v1 - m : 0.f;
    const float m2 = fxk::warp_sum(fmaf(d0, d0, d1 * d1));
    if (lane == 0) {
      if (whole_batch) {
        mean[c] = m;
        var[c] = m2 / rows;
      } else {
        part_mean[(long long)row_tile * H + c] = m;
        part_m2[(long long)row_tile * H + c] = m2;
      }
      col_mean[lc] = m;
      col_inv[lc] = rsqrtf(m2 / rows + eps);
    }
  }
  // more than one row tile: the merge launch finishes the statistics and y
  if (!whole_batch) return;
  __syncthreads();

  for (int idx = tid; idx < BM * cw; idx += THREADS) {
    const int r = idx / cw, lc = idx % cw;
    const int c = col0 + c_own + lc;
    if (r < rows && c < H)
      y[(long long)(row0 + r) * H + c] =
          fmaxf((hs[r][lc] - col_mean[lc]) * col_inv[lc] * gamma[c] + beta[c], 0.f);
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
bn_relu_merge_kernel(const float* __restrict__ h,
                     const float* __restrict__ part_mean,
                     const float* __restrict__ part_m2,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     float* __restrict__ y,
                     float* __restrict__ mean,
                     float* __restrict__ var,
                     int B, int H, int n_tiles, int col_blocks, float eps) {
  const long long trial = blockIdx.y;  // as in the split kernel
  h += trial * B * H;
  y += trial * B * H;
  part_mean += trial * n_tiles * H;
  part_m2 += trial * n_tiles * H;
  gamma += trial * H;
  beta += trial * H;
  mean += trial * H;
  var += trial * H;
  __shared__ float s_mean[MERGE_COLS];
  __shared__ float s_scale[MERGE_COLS];  // rsqrt(var + eps) * gamma
  __shared__ float s_beta[MERGE_COLS];

  // one-dimensional grid: column block fastest, then the block of rows
  const int row_block = blockIdx.x / col_blocks;
  const int lc = threadIdx.x % MERGE_COLS;
  const int c = (blockIdx.x % col_blocks) * MERGE_COLS + lc;
  if (threadIdx.x < MERGE_COLS && c < H) {
    // Chan et al.'s pairwise update, tiles merged in index order
    float n = 0.f, m = 0.f, m2 = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      const float nb = (float)min(BM, B - t * BM);
      const float mb = part_mean[(long long)t * H + c];
      const float m2b = part_m2[(long long)t * H + c];
      const float nn = n + nb;
      const float delta = mb - m;
      m += delta * (nb / nn);
      m2 += m2b + delta * delta * (n * nb / nn);
      n = nn;
    }
    const float v = m2 / n;
    s_mean[lc] = m;
    s_scale[lc] = rsqrtf(v + eps) * gamma[c];
    s_beta[lc] = beta[c];
    if (row_block == 0) {
      mean[c] = m;
      var[c] = v;
    }
  }
  __syncthreads();
  if (c >= H) return;
  const int r_end = (int)min((long long)B, (long long)(row_block + 1) * MERGE_ROWS);
  for (int r = row_block * MERGE_ROWS + threadIdx.x / MERGE_COLS; r < r_end;
       r += MERGE_THREADS / MERGE_COLS) {
    const long long o = (long long)r * H + c;
    y[o] = fmaxf((h[o] - s_mean[lc]) * s_scale[lc] + s_beta[lc], 0.f);
  }
}

template <bool VEC_X, bool VEC_W>
cudaError_t launch_split(unsigned blocks, unsigned trials, cudaStream_t stream, const float* x,
                         const float* w, const float* b, const float* gamma,
                         const float* beta, float* h, float* y, float* mean, float* var,
                         float* part_mean, float* part_m2, int B, int F, int H, int split,
                         int slice, int col_tiles, long long x_stride, float eps) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, trials);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;  // split 1 needs no cluster
  return cudaLaunchKernelEx(&cfg, fused_linear_bn_relu_train_split_kernel<VEC_X, VEC_W>, x,
                            w, b, gamma, beta, h, y, mean, var, part_mean, part_m2, B, F, H,
                            split, slice, col_tiles, x_stride, eps);
}

}  // namespace

// Launches on `stream` and returns the first CUDA error as an int (0 =
// launched). Pointers are device pointers. `split` (1, 2, 4 or 8) CTAs share
// each 64 x 32 tile of h, CTA r over depth [r * slice, (r + 1) * slice) of F,
// so `slice` is a multiple of 16 with split * slice >= F (the wrapper's
// planner, kernels/fused_linear.py::plan_b1, picks both). `trials` (K >= 1)
// problems run in one launch; x_per_trial says whether x is (K, B, F) or one
// (B, F) for all. part_mean and part_m2 hold (K, ceil(B / 64), H) floats when
// B > 64 and may be null otherwise. The caller checks shapes, types and
// layout.
extern "C" int fused_linear_bn_relu_train_f32(
    const void* x, const void* w, const void* b, const void* gamma,
    const void* beta, void* h, void* y, void* mean, void* var,
    void* part_mean, void* part_m2, int trials, int x_per_trial, int B, int F, int H,
    int split, int slice, float eps, void* stream) {
  if (trials <= 0 || trials > 65535 || B <= 0 || H <= 0 || F < 0)
    return (int)cudaErrorInvalidValue;
  if (split != 1 && split != 2 && split != 4 && split != MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  if (slice < 0 || slice % BK != 0 || (long long)split * slice < F)
    return (int)cudaErrorInvalidValue;
  const long long row_tiles = (B + BM - 1) / BM;
  const long long col_tiles = (H + BN - 1) / BN;
  const long long blocks = row_tiles * col_tiles * split;
  const long long merge_cols = (H + MERGE_COLS - 1) / MERGE_COLS;
  if (blocks > 0x7fffffffLL || row_tiles * merge_cols > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (row_tiles > 1 && (part_mean == nullptr || part_m2 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long x_stride = x_per_trial ? (long long)B * F : 0;
  // a 16-byte copy needs every trial's rows 16-byte aligned: the base, the
  // row stride and the trial stride (F * H for w) in whole float4s
  const bool vec_x = F % 4 == 0 && x_stride % 4 == 0 &&
                     reinterpret_cast<unsigned long long>(x) % 16 == 0;
  const bool vec_w = H % 4 == 0 && ((long long)F * H) % 4 == 0 &&
                     reinterpret_cast<unsigned long long>(w) % 16 == 0;
  auto run = vec_x ? (vec_w ? &launch_split<true, true> : &launch_split<true, false>)
                   : (vec_w ? &launch_split<false, true> : &launch_split<false, false>);
  int rc = (int)run((unsigned)blocks, (unsigned)trials, s, static_cast<const float*>(x),
                    static_cast<const float*>(w), static_cast<const float*>(b),
                    static_cast<const float*>(gamma), static_cast<const float*>(beta),
                    static_cast<float*>(h), static_cast<float*>(y),
                    static_cast<float*>(mean), static_cast<float*>(var),
                    static_cast<float*>(part_mean), static_cast<float*>(part_m2), B, F, H,
                    split, slice, (int)col_tiles, x_stride, eps);
  if (rc == 0) rc = (int)cudaGetLastError();
  if (rc != 0 || row_tiles == 1) return rc;
  // MERGE_ROWS == BM: one block of rows per row tile
  bn_relu_merge_kernel<<<dim3((unsigned)(row_tiles * merge_cols), (unsigned)trials),
                         MERGE_THREADS, 0, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(part_mean),
      static_cast<const float*>(part_m2), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(y),
      static_cast<float*>(mean), static_cast<float*>(var), B, H, (int)row_tiles,
      (int)merge_cols, eps);
  return (int)cudaGetLastError();
}
