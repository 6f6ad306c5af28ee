// Eval-mode fused Linear -> BatchNorm -> ReLU for Hopper (sm_90a), f32.
//
//   y = relu((x @ w + b - running_mean) * rsqrt(running_var + eps) * gamma + beta)
//
// x (B, F), w (F, H), b/gamma/beta/running_mean/running_var (H,), y (B, H);
// all float32, row-major, contiguous.
//
// Replaces flexynesis_tpu/ops/pallas/fused_linear.py::fused_linear_bn_relu_eval
// (the Pallas kernel body at fused_linear.py:215-220). Like the Pallas kernel,
// the pre-activation h = x @ w + b never reaches device memory: the BatchNorm
// and ReLU run in the epilogue, on the accumulators, before the only store of y.
//
// What bounds it: at the DirectPred headline encoder (B=2000, F=2000, H=600)
// the product is 4.8 GFLOP against about 25 MB of inputs and outputs, about
// 190 FLOP per byte, so on an H100 it is bound by f32 arithmetic (67 TFLOP/s
// outside the tensor cores), not by the 3.35 TB/s of HBM. The design answers
// that with register blocking: each thread keeps a 4x4 block of accumulators
// and reuses every value it reads from shared memory four times, so the FMA
// units, not the loads, set the pace as far as a simple kernel allows. There
// is one thread block per 64x64 output tile; F is walked in 16-deep tiles
// staged through shared memory. Ragged B, F and H are masked in the kernel, so
// there is no host-side padding and no size ceiling.
//
// This first version computes in full f32 with plain FMAs; TF32/bf16 operands,
// wgmma and TMA are later work.

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

static_assert((BM * BK) % THREADS == 0, "x tile must split evenly");
static_assert((BK * BN) % THREADS == 0, "w tile must split evenly");

__global__ void __launch_bounds__(THREADS)
fused_linear_bn_relu_eval_kernel(const float* __restrict__ x,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta,
                                 const float* __restrict__ running_mean,
                                 const float* __restrict__ running_var,
                                 float* __restrict__ y,
                                 int B, int F, int H, float eps) {
  // x is stored transposed (k-major) so a thread's TM rows at one k are one
  // row of xs; the +1 column breaks the bank conflicts of the transposing store
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % THREADS_X;
  const int ty = tid / THREADS_X;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < F; k0 += BK) {
    // x tile (BM x BK): neighbouring threads read neighbouring k of one row
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BK;
      const int k = idx % BK;
      const int gr = row0 + r;
      const int gk = k0 + k;
      xs[k][r] = (gr < B && gk < F) ? x[(long long)gr * F + gk] : 0.f;
    }
    // w tile (BK x BN): neighbouring threads read neighbouring columns
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

  // epilogue: bias, running-statistics BatchNorm, ReLU, then the only store
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = col0 + tx + j * THREADS_X;
    if (c >= H) continue;
    const float bias = b[c];
    const float mean = running_mean[c];
    const float inv = rsqrtf(running_var[c] + eps);
    const float g = gamma[c];
    const float be = beta[c];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + ty + i * THREADS_Y;
      if (r >= B) continue;
      const float h = acc[i][j] + bias;
      y[(long long)r * H + c] = fmaxf((h - mean) * inv * g + be, 0.f);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = launched).
// Pointers are device pointers; the caller checks shapes, types and layout.
extern "C" int fused_linear_bn_relu_eval_f32(const void* x, const void* w,
                                             const void* b, const void* gamma,
                                             const void* beta,
                                             const void* running_mean,
                                             const void* running_var, void* y,
                                             int B, int F, int H, float eps,
                                             void* stream) {
  if (B <= 0 || H <= 0 || F < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + BM - 1) / BM, (H + BN - 1) / BN);
  fused_linear_bn_relu_eval_kernel<<<grid, THREADS, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const float*>(gamma),
      static_cast<const float*>(beta),
      static_cast<const float*>(running_mean),
      static_cast<const float*>(running_var), static_cast<float*>(y), B, F, H,
      eps);
  return (int)cudaGetLastError();
}
