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
// Replaces flexynesis_tpu/ops/pallas/fused_linear.py::_fused_forward (the
// Pallas kernel body _fused_fwd_kernel, fused_linear.py:59-80). The Pallas
// kernel keeps the whole batch of a column tile in VMEM and falls back to
// unfused XLA above a VMEM budget. Here nothing falls back:
//
// * Launch 1 (fused_linear_bn_relu_train_kernel): one thread block per 64x64
//   tile of h, F walked in 16-deep shared-memory stages with a 4x4 register
//   block per thread, exactly as kernel B2 (fused_linear_eval.cu). The
//   epilogue adds the bias, stores h, stages the tile in shared memory and
//   computes each column's statistics over the tile's valid rows: the mean
//   first, then the centred sum of squares (M2). When the whole batch fits in
//   one row tile (B <= 64, the usual training batch of 32 or 64) the block
//   holds every row of its columns, so it finishes the BatchNorm and the ReLU
//   in the same launch and writes y, mu and var.
// * Launch 2 (bn_relu_merge_kernel), only for B > 64: each row tile has
//   written its (mean, M2) partials; every block merges them for its 32
//   columns in one fixed order (tile 0, 1, 2, ... with Chan's formula), so the
//   result does not change from run to run, then normalises and applies the
//   ReLU to its rows of h. This split reduction has no batch-size ceiling.
//
// What bounds it: the GEMM. At the DirectPred training encoder (B=64,
// F=2000, H=600) the block does 154 MFLOP against 5.6 MB of inputs and
// outputs, about 27 FLOP per byte; an H100 needs about 20 (67 TFLOP/s f32
// over 3.35 TB/s), so it is nearly balanced and a fast version must both
// stream w at full bandwidth and keep the FMA units busy. This first version
// does neither well: with 64-row batches the 64x64 tile grid has only
// ceil(H/64) blocks (10 for H=600) on 132 SMs. Splitting F across blocks
// (split-K), TF32/bf16 operands, wgmma and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;  // rows of x per block
constexpr int BN = 64;  // hidden columns per block
constexpr int BK = 16;  // depth of one shared-memory stage
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // columns per thread
constexpr int THREADS_X = BN / TN;  // 16
constexpr int THREADS_Y = BM / TM;  // 16
constexpr int THREADS = THREADS_X * THREADS_Y;  // 256

constexpr int MERGE_COLS = 32;   // columns per block of the merge launch
constexpr int MERGE_ROWS = 64;   // rows per block of the merge launch
constexpr int MERGE_THREADS = 256;

static_assert((BM * BK) % THREADS == 0, "x tile must split evenly");
static_assert((BK * BN) % THREADS == 0, "w tile must split evenly");
static_assert(BN <= THREADS, "one thread per column for the statistics");

__global__ void __launch_bounds__(THREADS)
fused_linear_bn_relu_train_kernel(const float* __restrict__ x,
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
                                  int B, int F, int H, float eps) {
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];
  __shared__ float hs[BM][BN + 1];  // the block's tile of h, for the statistics
  __shared__ float col_mean[BN];
  __shared__ float col_inv[BN];

  const int tid = threadIdx.x;
  const int tx = tid % THREADS_X;
  const int ty = tid / THREADS_X;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int rows = min(BM, B - row0);  // valid rows of this tile (>= 1)

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < F; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BK;
      const int k = idx % BK;
      const int gr = row0 + r;
      const int gk = k0 + k;
      xs[k][r] = (gr < B && gk < F) ? x[(long long)gr * F + gk] : 0.f;
    }
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int k = idx / BN;
      const int c = idx % BN;
      const int gk = k0 + k;
      const int gc = col0 + c;
      ws[k][c] = (gk < F && gc < H) ? w[(long long)gk * H + gc] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM];
      float bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + i * THREADS_Y];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ws[k][tx + j * THREADS_X];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue 1: bias; store h; stage the tile for the column statistics
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int lc = tx + j * THREADS_X;
    const int c = col0 + lc;
    const float bias = c < H ? b[c] : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int lr = ty + i * THREADS_Y;
      const float hv = acc[i][j] + bias;
      hs[lr][lc] = hv;
      if (row0 + lr < B && c < H) h[(long long)(row0 + lr) * H + c] = hv;
    }
  }
  __syncthreads();

  // epilogue 2: one thread per column, exact two-pass statistics over the
  // tile's valid rows (mean, then the centred sum of squares)
  if (tid < BN) {
    const int c = col0 + tid;
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += hs[r][tid];
    const float m = s / rows;
    float m2 = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float d = hs[r][tid] - m;
      m2 = fmaf(d, d, m2);
    }
    if (c < H) {
      if (gridDim.x == 1) {
        mean[c] = m;
        var[c] = m2 / rows;
      } else {
        part_mean[(long long)blockIdx.x * H + c] = m;
        part_m2[(long long)blockIdx.x * H + c] = m2;
      }
    }
    col_mean[tid] = m;
    col_inv[tid] = rsqrtf(m2 / rows + eps);
  }
  // more than one row tile: the merge launch finishes the statistics and y
  // (the condition is the same for every thread of the grid)
  if (gridDim.x != 1) return;
  __syncthreads();

  // epilogue 3: the block holds the whole batch: normalise, ReLU, store y
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int lc = tx + j * THREADS_X;
    const int c = col0 + lc;
    if (c >= H) continue;
    const float g = gamma[c];
    const float be = beta[c];
    const float m = col_mean[lc];
    const float inv = col_inv[lc];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int lr = ty + i * THREADS_Y;
      if (lr >= rows) continue;
      y[(long long)(row0 + lr) * H + c] = fmaxf((hs[lr][lc] - m) * inv * g + be, 0.f);
    }
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
                     int B, int H, int n_tiles, float eps) {
  __shared__ float s_mean[MERGE_COLS];
  __shared__ float s_scale[MERGE_COLS];  // rsqrt(var + eps) * gamma
  __shared__ float s_beta[MERGE_COLS];

  const int lc = threadIdx.x % MERGE_COLS;
  const int c = blockIdx.x * MERGE_COLS + lc;
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
    if (blockIdx.y == 0) {
      mean[c] = m;
      var[c] = v;
    }
  }
  __syncthreads();
  if (c >= H) return;
  const int r_end = min(B, (int)(blockIdx.y + 1) * MERGE_ROWS);
  for (int r = blockIdx.y * MERGE_ROWS + threadIdx.x / MERGE_COLS; r < r_end;
       r += MERGE_THREADS / MERGE_COLS) {
    const long long o = (long long)r * H + c;
    y[o] = fmaxf((h[o] - s_mean[lc]) * s_scale[lc] + s_beta[lc], 0.f);
  }
}

}  // namespace

// Launches on `stream` and returns the first cudaGetLastError() as an int
// (0 = launched). Pointers are device pointers; part_mean and part_m2 hold
// (ceil(B / 64), H) floats when B > 64 and may be null otherwise (the
// wrapper's ROW_TILE is BM). The caller checks shapes, types and layout.
extern "C" int fused_linear_bn_relu_train_f32(
    const void* x, const void* w, const void* b, const void* gamma,
    const void* beta, void* h, void* y, void* mean, void* var,
    void* part_mean, void* part_m2, int B, int F, int H, float eps,
    void* stream) {
  if (B <= 0 || H <= 0 || F < 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = (B + BM - 1) / BM;
  if (n_tiles > 1 && (part_mean == nullptr || part_m2 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, (H + BN - 1) / BN);
  fused_linear_bn_relu_train_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(h),
      static_cast<float*>(y), static_cast<float*>(mean),
      static_cast<float*>(var), static_cast<float*>(part_mean),
      static_cast<float*>(part_m2), B, F, H, eps);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || n_tiles == 1) return rc;
  const dim3 merge_grid((H + MERGE_COLS - 1) / MERGE_COLS,
                        (B + MERGE_ROWS - 1) / MERGE_ROWS);
  bn_relu_merge_kernel<<<merge_grid, MERGE_THREADS, 0, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(part_mean),
      static_cast<const float*>(part_m2), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(y),
      static_cast<float*>(mean), static_cast<float*>(var), B, H, n_tiles, eps);
  return (int)cudaGetLastError();
}
