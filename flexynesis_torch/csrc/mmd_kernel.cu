// Gaussian-kernel means of the VAE-MMD loss for Hopper (sm_90a), f32.
//
//   mean(a, b) = mean over i < na, j < nb of
//                exp(-max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j, 0) / d^2)
//
// Two entry points, one kernel:
// * gaussian_kernel_mean_f32: mean(x, y) of x (N, d) and y (M, d);
// * mmd_term_f32: the whole MMD term of K trials in one launch: y (K, M, d)
//   and x (K, N, d), or one x (N, d) shared by the trials (a trial stride of
//   0); out (K, 4), per trial [mean(x, x), mean(y, y), mean(x, y),
//   mean(x, x) + mean(y, y) - 2 mean(x, y)].
// float32, row-major, contiguous. No pairwise matrix reaches device memory.
//
// Replaces flexynesis_tpu/ops/pallas/mmd_kernel.py::gaussian_kernel_mean (the
// Pallas body _kernel_mean_kernel, mmd_kernel.py:29-49) and the three calls
// compute_mmd_pallas (mmd_kernel.py:119-125) makes of it. It computes what that
// body computes: the Gram expansion clamped at 0 and divided by the unpadded
// d^2, with ragged rows and depth masked.
//
// What bounds it: at the VAE's shapes (N, M <= 400, d = 64) a whole MMD term
// is under 5 MFLOP, well under a microsecond of an H100 at its f32 rate, so the
// time is launches and latency. The design therefore:
// * enumerates in one 1-D grid the 64 x 64 tiles of every pair set of the
//   call (one set for a mean; xx, yy and xy for a term). A self set (a, a)
//   computes only the tiles with ti <= tj and weights an off-diagonal tile
//   twice: 10 tiles instead of 16 at 200 rows;
// * stages the whole 64 x d tiles of both sides with one round of cp.async
//   copies when d <= 64 (16 bytes a copy where d % 4 == 0, 4 bytes
//   otherwise), a larger d in 64-deep chunks; each of the 256 threads keeps a
//   4 x 4 block of dot products, and 128 of them one row's squared norm;
// * reduces in the same launch, in a fixed order: each block sums its pairs
//   with fixed-order warp sums and writes one partial, then draws an integer
//   ticket; the block that draws the last ticket sums every set's partials in
//   double in a fixed order (one warp per set: a fixed stride of tiles per
//   lane, then a fixed butterfly), writes the outputs and resets the ticket to
//   0 for the next call. The integer atomic only picks the block that
//   reduces; no float is ever added atomically, so two calls give the same
//   bits;
// * puts the trial in blockIdx.y: trial k's blocks read its rows at its
//   trial strides, write their partials to its own range of the workspace
//   and draw its own ticket, and the last of them reduces trial k alone. A
//   block does the same work whatever K is, so trial k of a K-trial launch
//   gives the bits of a one-trial launch on trial k's rows.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int BT = 64;   // rows of each side per tile
constexpr int BK = 64;   // depth staged at once
constexpr int LD = BK + 4;  // padded row of a staged tile (16-byte aligned)
constexpr int TM = 4;    // a rows per thread
constexpr int TN = 4;    // b rows per thread
constexpr int THREADS_X = BT / TN;  // 16
constexpr int THREADS_Y = BT / TM;  // 16
constexpr int THREADS = THREADS_X * THREADS_Y;  // 256
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SETS = 3;
static_assert(MAX_SETS <= WARPS, "one warp per set in the final reduction");
static_assert(2 * BT <= THREADS, "one thread per row for the norms");

// One set of pairs: rows of a against rows of b. A self set (a == b) runs
// only the tiles with ti <= tj, in row-major order of the upper triangle.
struct PairSet {
  const float* a;
  const float* b;
  long long a_stride, b_stride;  // floats from one trial's rows to the next
  int na, nb;
  int tiles_a, tiles_b;
  int self;
  long long first_tile;  // index of the set's first block in the grid
  long long n_tiles;
  double pairs;  // na * nb
};

struct Sets {
  PairSet set[MAX_SETS];
  int n;
};

long long tile_count(int tiles_a, int tiles_b, bool self) {
  return self ? (long long)tiles_a * (tiles_a + 1) / 2 : (long long)tiles_a * tiles_b;
}

// The t-th tile of a set as (ti, tj); the row of the upper triangle comes from
// the closed form, then is corrected for rounding.
__device__ void decode_tile(const PairSet& s, long long t, int& ti, int& tj) {
  if (!s.self) {
    ti = (int)(t / s.tiles_b);
    tj = (int)(t % s.tiles_b);
    return;
  }
  const long long n = s.tiles_a;
  auto start = [n](long long i) { return i * n - i * (i - 1) / 2; };  // first t of row i
  const double q = (double)(2 * n + 1);
  long long i = (long long)((q - sqrt(q * q - 8.0 * (double)t)) / 2.0);
  if (i < 0) i = 0;
  if (i > n - 1) i = n - 1;
  while (i > 0 && start(i) > t) --i;
  while (i + 1 < n && start(i + 1) <= t) ++i;
  ti = (int)i;
  tj = (int)(i + (t - start(i)));
}

// rows [row0, row0 + 64) x depth [k0, k0 + 64) of src (n rows, d wide), zero
// outside n and d
template <bool VEC>
__device__ __forceinline__ void load_tile(float (*dst)[LD], const float* __restrict__ src,
                                          int n, int d, int row0, int k0, int tid) {
  if (VEC) {
#pragma unroll
    for (int l = 0; l < BT * BK / 4 / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / (BK / 4), k = (idx % (BK / 4)) * 4;
      const bool ok = row0 + r < n && k0 + k < d;
      fxk::cp_async16(&dst[r][k], ok ? src + (long long)(row0 + r) * d + k0 + k : src,
                      ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int l = 0; l < BT * BK / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BK, k = idx % BK;
      const bool ok = row0 + r < n && k0 + k < d;
      fxk::cp_async4(&dst[r][k], ok ? src + (long long)(row0 + r) * d + k0 + k : src,
                     ok ? 4 : 0);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gaussian_kernel_mean_kernel(const Sets sets, int d, float d2, float* __restrict__ partial,
                            unsigned int* __restrict__ tickets, float* __restrict__ out) {
  __shared__ __align__(16) float as[BT][LD];
  __shared__ __align__(16) float bs[BT][LD];
  __shared__ float norm[2][BT];  // squared norms of the a rows and the b rows
  __shared__ float warp_part[WARPS];
  __shared__ double set_mean[MAX_SETS];
  __shared__ bool last;

  const int tid = threadIdx.x;
  const int tx = tid % THREADS_X;
  const int ty = tid / THREADS_X;
  const long long t = blockIdx.x;
  const int trial = blockIdx.y;
  // this trial's partials and ticket
  partial += (long long)trial * gridDim.x;
  unsigned int* ticket = tickets + trial;
  int si = 0;
  while (si + 1 < sets.n && t >= sets.set[si + 1].first_tile) ++si;
  const PairSet& s = sets.set[si];
  const float* a = s.a + trial * s.a_stride;
  const float* b = s.b + trial * s.b_stride;
  int ti, tj;
  decode_tile(s, t - s.first_tile, ti, tj);
  const int row0 = ti * BT, col0 = tj * BT;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  // threads 0-63 keep the squared norm of a row of a, 64-127 of a row of b,
  // in depth order across the chunks
  float row_norm = 0.f;
  float(*own)[LD] = tid < BT ? as : bs;

  for (int k0 = 0; k0 < d; k0 += BK) {
    if (k0 > 0) __syncthreads();  // the previous chunk is consumed
    load_tile<VEC>(as, a, s.na, d, row0, k0, tid);
    load_tile<VEC>(bs, b, s.nb, d, col0, k0, tid);
    fxk::cp_async_commit();
    fxk::cp_async_wait<0>();
    __syncthreads();
    const int kc = min(BK, (d - k0 + 3) / 4 * 4);  // past d the tiles hold zeros
    if (tid < 2 * BT) {
      for (int kk = 0; kk < kc; kk += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&own[tid % BT][kk]);
        row_norm = fmaf(v.x, v.x, row_norm);
        row_norm = fmaf(v.y, v.y, row_norm);
        row_norm = fmaf(v.z, v.z, row_norm);
        row_norm = fmaf(v.w, v.w, row_norm);
      }
    }
    for (int kk = 0; kk < kc; kk += 4) {
      float4 av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(&as[ty + i * THREADS_Y][kk]);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        bv[j] = *reinterpret_cast<const float4*>(&bs[tx + j * THREADS_X][kk]);
      // depth in order kk, kk + 1, kk + 2, kk + 3 for every accumulator
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(fxk::component(av[i], q), fxk::component(bv[j], q), acc[i][j]);
    }
  }
  if (tid < 2 * BT) norm[tid / BT][tid % BT] = row_norm;
  __syncthreads();

  // the kernel values of this thread's valid pairs, summed in a fixed order
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (row0 + ty + i * THREADS_Y >= s.na) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (col0 + tx + j * THREADS_X >= s.nb) continue;
      const float sq = fmaxf(norm[0][ty + i * THREADS_Y] + norm[1][tx + j * THREADS_X] -
                             2.f * acc[i][j], 0.f);
      v += expf(-sq / d2);
    }
  }
  v = fxk::warp_sum(v);
  if (tid % 32 == 0) warp_part[tid / 32] = v;
  __syncthreads();
  if (tid == 0) {
    float block = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) block += warp_part[w];
    // an off-diagonal tile of a self set stands for its mirror too (x2 is exact)
    partial[t] = (s.self && ti != tj) ? 2.f * block : block;
    __threadfence();  // the partial is visible before the ticket is drawn
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: warp k sums set k's partials in double, each lane over a
  // fixed stride of tiles, then a fixed-order butterfly across the lanes
  __threadfence();
  const int warp = tid / 32, lane = tid % 32;
  if (warp < sets.n) {
    const PairSet& p = sets.set[warp];
    double sum = 0.0;
    for (long long i = lane; i < p.n_tiles; i += 32)
      sum += (double)__ldcg(&partial[p.first_tile + i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) set_mean[warp] = sum / p.pairs;
  }
  __syncthreads();
  if (tid == 0) {
    // a term writes 4 outputs per trial, a mean 1
    out += trial * (sets.n == MAX_SETS ? MAX_SETS + 1 : sets.n);
    for (int k = 0; k < sets.n; ++k) out[k] = (float)set_mean[k];
    if (sets.n == MAX_SETS)
      out[MAX_SETS] = (float)(set_mean[0] + set_mean[1] - 2.0 * set_mean[2]);
    *ticket = 0u;  // ready for the next launch on this workspace
  }
}

PairSet pair_set(const float* a, const float* b, long long a_stride, long long b_stride,
                 int na, int nb, bool self, long long first) {
  PairSet p;
  p.a = a;
  p.b = b;
  p.a_stride = a_stride;
  p.b_stride = b_stride;
  p.na = na;
  p.nb = nb;
  p.tiles_a = (na + BT - 1) / BT;
  p.tiles_b = (nb + BT - 1) / BT;
  p.self = self ? 1 : 0;
  p.first_tile = first;
  p.n_tiles = tile_count(p.tiles_a, p.tiles_b, self);
  p.pairs = (double)na * (double)nb;
  return p;
}

int launch(const Sets& sets, int trials, int d, void* partial, long long capacity,
           void* tickets, void* out, void* stream) {
  const PairSet& tail = sets.set[sets.n - 1];
  const long long blocks = tail.first_tile + tail.n_tiles;
  if (trials <= 0 || trials > 65535 || blocks > 0x7fffffffLL ||
      blocks * trials > capacity)
    return (int)cudaErrorInvalidValue;
  // d % 4 == 0 keeps every trial's rows 16-byte aligned when the bases are
  bool vec = d % 4 == 0;
  for (int k = 0; k < sets.n; ++k)
    vec = vec && reinterpret_cast<unsigned long long>(sets.set[k].a) % 16 == 0 &&
          reinterpret_cast<unsigned long long>(sets.set[k].b) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float d2 = (float)d * (float)d;
  const dim3 grid((unsigned)blocks, (unsigned)trials);
  if (vec)
    gaussian_kernel_mean_kernel<true><<<grid, THREADS, 0, s>>>(
        sets, d, d2, static_cast<float*>(partial), static_cast<unsigned int*>(tickets),
        static_cast<float*>(out));
  else
    gaussian_kernel_mean_kernel<false><<<grid, THREADS, 0, s>>>(
        sets, d, d2, static_cast<float*>(partial), static_cast<unsigned int*>(tickets),
        static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Both launch on `stream` once and return the launch's CUDA error as an int
// (0 = launched). Pointers are device pointers. `partial` holds `capacity`
// floats, at least one per tile of the call and trial
// (kernels/mmd.py::call_tiles counts a trial's); `tickets` holds one unsigned
// int per trial, each 0 between launches (zero them once when the workspace is
// allocated; the kernel leaves them 0). Calls that share a workspace must be
// ordered on one stream. The caller checks shapes, types and layout.

// out[0] = mean(x, y)
extern "C" int gaussian_kernel_mean_f32(const void* x, const void* y, int N, int M, int d,
                                        void* partial, long long capacity, void* tickets,
                                        void* out, void* stream) {
  if (N <= 0 || M <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  Sets sets;
  sets.n = 1;
  sets.set[0] = pair_set(static_cast<const float*>(x), static_cast<const float*>(y), 0, 0, N,
                         M, false, 0);
  return launch(sets, 1, d, partial, capacity, tickets, out, stream);
}

// out[4 k .. 4 k + 3] = mean(x_k, x_k), mean(y_k, y_k), mean(x_k, y_k) and the
// MMD of trial k < K; y_k = y + k M d, x_k = x + k x_stride (x_stride N d, or 0
// for an x shared by the trials)
extern "C" int mmd_term_f32(const void* x, const void* y, int K, long long x_stride, int N,
                            int M, int d, void* partial, long long capacity, void* tickets,
                            void* out, void* stream) {
  if (N <= 0 || M <= 0 || d <= 0 || x_stride < 0) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const long long y_stride = (long long)M * d;
  Sets sets;
  sets.n = 3;
  sets.set[0] = pair_set(xf, xf, x_stride, x_stride, N, N, true, 0);
  sets.set[1] = pair_set(yf, yf, y_stride, y_stride, M, M, true, sets.set[0].n_tiles);
  sets.set[2] = pair_set(xf, yf, x_stride, y_stride, N, M, false,
                         sets.set[1].first_tile + sets.set[1].n_tiles);
  return launch(sets, K, d, partial, capacity, tickets, out, stream);
}
