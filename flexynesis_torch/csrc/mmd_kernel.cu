// Gaussian-kernel mean of the VAE-MMD loss for Hopper (sm_90a), f32.
//
//   out = mean over i < N, j < M of exp(-max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0) / d^2)
//
// x (N, d), y (M, d), float32, row-major, contiguous; out is one float.
// The N x M kernel matrix never reaches device memory.
//
// Replaces flexynesis_tpu/ops/pallas/mmd_kernel.py::gaussian_kernel_mean (the
// Pallas body _kernel_mean_kernel, mmd_kernel.py:29-49). It computes what that
// body computes: the Gram expansion clamped at 0 and divided by the unpadded
// d^2, with ragged rows, columns and depth masked. The Pallas kernel keeps the
// whole of x in VMEM, streams y in 512-row tiles and adds each grid step into
// one SMEM scalar in grid order. Hopper blocks run in no order, so:
//
// * Launch 1 (kernel_mean_tile_kernel): one block per 64 x 64 tile of (x rows,
//   y rows), d walked in 16-deep shared-memory stages. Each of the 256 threads
//   keeps a 4 x 4 block of dot products and the squared norms of its 4 x rows
//   and 4 y rows in registers, so no norm pass is needed. The epilogue applies
//   the clamp, the division and exp to its valid pairs and the block sums them
//   in a fixed tree order. A grid of one tile (N, M <= 64) writes the mean
//   itself; otherwise each block writes its partial sum.
// * Launch 2 (kernel_mean_reduce_kernel), only for more than one tile: one
//   block sums the partials in double, each thread over a fixed stride and
//   then in a fixed tree, and writes the mean. No float atomics anywhere, so
//   the result is bit-identical from call to call. The grid is one-dimensional
//   (up to 2^31 - 1 tiles), so no shape the model gives comes near a ceiling.
//
// What bounds it: at the VAE's training shapes (N, M <= 400, d = 64) the work
// is tiny: at (200, 64, 64) about 1.6 MFLOP and 66 KB, some 0.03 us of an
// H100 at its f32 peak. One launch costs a few microseconds, so the kernel is
// launch-bound. This design keeps every intermediate in registers and shared
// memory and makes one launch where the pairs fit one tile, two otherwise.
// One launch for all three means of an MMD, and a trial axis for stacked HPO
// trials, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;  // x rows per block
constexpr int BN = 64;  // y rows per block
constexpr int BK = 16;  // depth of one shared-memory stage
constexpr int TM = 4;   // x rows per thread
constexpr int TN = 4;   // y rows per thread
constexpr int THREADS_X = BN / TN;  // 16
constexpr int THREADS_Y = BM / TM;  // 16
constexpr int THREADS = THREADS_X * THREADS_Y;  // 256
constexpr int REDUCE_THREADS = 256;

static_assert(BM == BN, "x and y tiles share one load loop");
static_assert((BM * BK) % THREADS == 0, "a tile must split evenly");

__global__ void __launch_bounds__(THREADS)
kernel_mean_tile_kernel(const float* __restrict__ x, const float* __restrict__ y,
                        float* __restrict__ partial, float* __restrict__ out,
                        int N, int M, int d, int tiles_m, float d2, double count) {
  __shared__ float xs[BK][BM + 1];
  __shared__ float ys[BK][BN + 1];
  __shared__ float red[THREADS];

  const int tid = threadIdx.x;
  const int tx = tid % THREADS_X;
  const int ty = tid / THREADS_X;
  const int row0 = (blockIdx.x / tiles_m) * BM;
  const int col0 = (blockIdx.x % tiles_m) * BN;

  float acc[TM][TN];
  float xn[TM];
  float yn[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    xn[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) yn[j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BK;
      const int k = idx % BK;
      const int gk = k0 + k;
      xs[k][r] = (row0 + r < N && gk < d) ? x[(long long)(row0 + r) * d + gk] : 0.f;
      ys[k][r] = (col0 + r < M && gk < d) ? y[(long long)(col0 + r) * d + gk] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = xs[k][ty + i * THREADS_Y];
        xn[i] = fmaf(a[i], a[i], xn[i]);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b[j] = ys[k][tx + j * THREADS_X];
        yn[j] = fmaf(b[j], b[j], yn[j]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: the kernel values of this thread's valid pairs, summed
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (row0 + ty + i * THREADS_Y >= N) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (col0 + tx + j * THREADS_X >= M) continue;
      const float sq = fmaxf(xn[i] + yn[j] - 2.f * acc[i][j], 0.f);
      s += expf(-sq / d2);
    }
  }

  // the block's sum, in a fixed tree order
  red[tid] = s;
  __syncthreads();
#pragma unroll
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
    if (tid < stride) red[tid] += red[tid + stride];
    __syncthreads();
  }
  if (tid == 0) {
    if (gridDim.x == 1) {
      out[0] = (float)((double)red[0] / count);
    } else {
      partial[blockIdx.x] = red[0];
    }
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS)
kernel_mean_reduce_kernel(const float* __restrict__ partial, int n,
                          float* __restrict__ out, double count) {
  __shared__ double red[REDUCE_THREADS];
  const int tid = threadIdx.x;
  double s = 0.0;
  for (int i = tid; i < n; i += REDUCE_THREADS) s += (double)partial[i];
  red[tid] = s;
  __syncthreads();
#pragma unroll
  for (int stride = REDUCE_THREADS / 2; stride > 0; stride >>= 1) {
    if (tid < stride) red[tid] += red[tid + stride];
    __syncthreads();
  }
  if (tid == 0) out[0] = (float)(red[0] / count);
}

}  // namespace

// Launches on `stream` and returns the first cudaGetLastError() as an int
// (0 = launched). Pointers are device pointers; `partial` holds one float per
// 64 x 64 tile, ceil(N / 64) * ceil(M / 64) of them, and may be null when that
// is 1 (the wrapper's TILE is BM = BN). The caller checks shapes, types and
// layout.
extern "C" int gaussian_kernel_mean_f32(const void* x, const void* y, void* partial,
                                        void* out, int N, int M, int d, void* stream) {
  if (N <= 0 || M <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles_m = (M + BN - 1) / BN;
  const long long tiles = ((N + BM - 1) / BM) * tiles_m;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (tiles > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double count = (double)N * (double)M;
  kernel_mean_tile_kernel<<<(unsigned)tiles, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(partial), static_cast<float*>(out), N, M, d,
      (int)tiles_m, (float)d * (float)d, count);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || tiles == 1) return rc;
  kernel_mean_reduce_kernel<<<1, REDUCE_THREADS, 0, s>>>(
      static_cast<const float*>(partial), (int)tiles, static_cast<float*>(out), count);
  return (int)cudaGetLastError();
}
