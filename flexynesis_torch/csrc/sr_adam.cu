// SR-bf16 Adam: one step over every leaf of a stacked trial round, in place,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel. flexynesis_tpu/ops/sr_adam.py::sr_adam_step is
// plain jnp, which XLA fuses into a few loops a leaf. In eager PyTorch the
// same chain (flexynesis_torch/ops/sr_adam.py::sr_adam_step, this kernel's
// plain version) is several dozen elementwise launches a leaf, and their
// issue on the host bounds a stacked step. This kernel is the port's
// counterpart of XLA's fusion: two launches a step, whatever the leaf count.
//
// What it computes, per trial k of K and per element of every leaf i (the
// leaves in the JAX flatten order and the Flax layout, each seen as (R, C) of
// one trial):
//   gscale_k = min(clip * (1 / (sqrt(sum over leaves of (g mask)^2) + 1e-12)), 1)
//   g32 = (g mask) gscale_k
//   m'  = fma(m, b1, g32 (1 - b1)),   v' = fma(v, b2, (g32 (1 - b2)) g32)
//   u   = m' / (b1c (sqrt(v' / b2c) + eps)) mask
//   p'  = fma(-lr_k, u, p), stored stochastically rounded to bfloat16 with the
//         murmur hash of the Flax flat index r C + c and the seed
//         seed_k + i P2 + count P3 (mod 2^32), or in float32 for a float32 leaf
//   m', v' stored in their own type (bfloat16 round to nearest even).
// Every operation is IEEE-rounded (__fmaf_rn, __fsqrt_rn, __fdiv_rn, ...;
// built without fast-math), so the kernel gives the plain chain's bits,
// except where the plain chain's float64 route for a fused multiply-add
// rounds twice (the kernel rounds once, as XLA does) and, where the clip is
// active, the last place of gscale: the kernel sums the squares in float64 in
// its own fixed order.
//
// What bounds it: memory. An element moves 16-24 bytes at least (g read,
// the mask in a padded round, p, m and v read and written in bfloat16), and
// the norm reads g again: at least 0.12 ms a step for 16 DirectPred trials on
// an H100 (chip_smoke.py times it). The design:
// * a leaf table on the device (one row per leaf: pointers, shape, p's
//   strides, types, its first tile), written once per round, and a gradient
//   table (one row per leaf: pointer and strides), whose pointers change every
//   step: the wrapper writes it to pinned memory and copies it on the step's
//   stream ahead of the launches, so no leaf count is too many for the
//   kernel's parameters and a step never waits for the card;
// * one 1-D grid of blocks, trial by trial, over the leaves' tiles: a leaf
//   whose p is contiguous in the Flax layout (biases, BatchNorm vectors,
//   untransposed weights) takes blocks of 4,096 consecutive elements ("flat"),
//   a transposed weight (p in torch's layout, p.mT in the Flax layout) 64 x 64
//   tiles ("tiled"); m, v and the mask are contiguous in the Flax layout. A
//   block finds its leaf by votes of its threads over the leaves' first
//   tiles (one vote per 256 leaves), reads the leaf's rows once into
//   registers, and works in 32-bit offsets within its trial (trial offsets
//   are 64-bit);
// * in a tiled block, an operand whose column stride is not 1 but whose row
//   stride is (p, or g, transposed) is read and written through shared
//   memory, threads running along its rows, so every global access of a warp
//   covers consecutive addresses; other strides are read as they come;
// * a block wholly inside its leaf (most) runs without bounds checks; each
//   thread issues the loads of two elements before their arithmetic and
//   stores, and four blocks share an SM (64 registers a thread). Measured on
//   the card, the arithmetic does not set the time (a copy of the same bytes
//   in the same blocks takes nearly as long), and the blocks move their bytes
//   at about a third of the rate a plain stream reaches;
// * launch 1 (sr_adam_norm_kernel) writes each block's sum of squares
//   (float64, fixed order) and draws an integer ticket; the block that draws
//   the last ticket reduces each trial's partials (contiguous, a trial's
//   tiles in order) in a fixed order, one warp a trial, writes gscale and
//   resets the ticket. The integer atomic only picks that block: no float is
//   added atomically, and a repeat gives the same bits;
// * launch 2 (sr_adam_update_kernel) reads gscale and updates every element
//   in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;                        // tiled mode: 64 x 64 of (R, C)
constexpr int PER_THREAD = TILE * TILE / THREADS;  // 16 elements a thread
constexpr int FLAT = THREADS * PER_THREAD;      // flat mode: 4,096 elements a block
constexpr int BATCH = 2;        // elements whose loads a thread issues together
constexpr int MIN_BLOCKS = 4;   // the update's blocks an SM holds at least
constexpr unsigned int P1 = 2654435761u;
constexpr unsigned int P2 = 2246822519u;
constexpr unsigned int P3 = 3266489917u;
static_assert(THREADS % TILE == 0, "threads cover whole rows of a tile");

// One row of the leaf table (kernels/sr_adam.py::LEAF_FIELDS, 16 int64).
struct Leaf {
  long long p, m, v, mask;     // device pointers; mask 0: none
  long long tile_start;        // the leaf's first tile in a trial's run of tiles
  long long tiles;             // tiles a trial
  long long rows, cols;        // R, C: one trial's leaf in the Flax layout
  long long tiles_c;           // tiled: tiles along C; 0: flat
  long long p_sk, p_sr, p_sc;  // p's strides in elements: trial, row, column
  long long flags;             // 1: p bfloat16, 2: m bfloat16, 4: v bfloat16
  long long index;             // the leaf's place i in the tree (seed mixing)
  long long unused[2];
};
static_assert(sizeof(Leaf) == 16 * 8, "kernels/sr_adam.py writes 16 int64 a leaf");

// One row of the gradient table (kernels/sr_adam.py::GRAD_FIELDS, 4 int64),
// written every step: a null pointer is a zero gradient; strides in
// elements, in the Flax layout's (R, C).
struct Grad {
  long long g;                 // device pointer (float32)
  long long sk, sr, sc;        // strides: trial, row, column
};
static_assert(sizeof(Grad) == 4 * 8, "kernels/sr_adam.py writes 4 int64 a gradient");

// The rest of a step (kernels/sr_adam.py::_StepArgs).
struct Step {
  const Leaf* leaves;
  const Grad* grads;           // one row a leaf, in the leaf table's order
  double* partials;            // one sum of squares a block, trial by trial
  unsigned int* ticket;        // 0 between launches
  float* scale;                // gscale, one a trial
  const float* lr;             // lr_k at lr[k * lr_stride]
  const long long* seed;       // seed_k at seed[k * seed_stride]
  long long n_tiles;           // blocks: K x tiles_per_trial
  long long tiles_per_trial;
  int n_leaves, K, lr_stride, seed_stride;
  unsigned int count;          // the step count after this step
  float b1, b2, one_m_b1, one_m_b2, b1c, b2c, eps, clip;
};

struct Where {
  int leaf, k;
  long long t;                 // the block's tile within trial k's leaf
};

// Block b is tile b % T of trial b / T (T tiles a trial); its leaf is the
// last whose first tile is at most that tile. The block's threads vote over
// the leaves' first tiles, THREADS leaves a vote (a barrier, no search); the
// first tiles rise with the leaf, so the votes stop at the first that is not
// unanimous, the same for every thread.
__device__ __forceinline__ Where locate(const Step& s, long long block) {
  const int k = (int)(block / s.tiles_per_trial);
  const long long t = block - (long long)k * s.tiles_per_trial;
  int leaf = -1;
  for (int base = 0; base < s.n_leaves; base += THREADS) {
    const int i = base + threadIdx.x;
    const int started = __syncthreads_count(i < s.n_leaves && s.leaves[i].tile_start <= t);
    leaf = base + started - 1;
    if (started < THREADS) break;
  }
  return {leaf, k, t - s.leaves[leaf].tile_start};
}

// What a block works on: its leaf's geometry and trial k's operands, held in
// registers (the leaf table is read once), with 32-bit coordinates and
// offsets within the trial (the wrapper holds every index and offset within
// one trial's leaf, its tiles' overhang included, under 2^31).
struct Block {
  int rows, cols;
  int r0, c0;                  // tiled: the tile's first row and column
  int f0;                      // flat: the block's first flat index
  bool full;                   // every element of the block lies in the leaf
  const float* g;              // trial k's gradient; null: zero
  int gsr, gsc;
  bool g_flat;                 // g's offset is the flat index
  const float* mask;           // trial k's mask (Flax layout); null: none
  char* p;                     // trial k's parameters
  int psr, psc;
  bool p_bf16, m_bf16, v_bf16;
  char* m;                     // trial k's moments (Flax layout)
  char* v;
  unsigned int index;          // the leaf's place in the tree
};

__device__ __forceinline__ Block block_of(const Step& s, const Where& w, bool& tiled) {
  const Leaf L = s.leaves[w.leaf];
  const Grad G = s.grads[w.leaf];
  Block b;
  b.rows = (int)L.rows;
  b.cols = (int)L.cols;
  tiled = L.tiles_c != 0;
  b.r0 = b.c0 = b.f0 = 0;
  if (tiled) {
    const int tr = (int)(w.t / L.tiles_c);
    b.r0 = tr * TILE;
    b.c0 = (int)(w.t - (long long)tr * L.tiles_c) * TILE;
    b.full = b.r0 + TILE <= b.rows && b.c0 + TILE <= b.cols;
  } else {
    b.f0 = (int)w.t * FLAT;
    b.full = b.f0 + FLAT <= b.rows * b.cols;
  }
  const long long flat = (long long)w.k * L.rows * L.cols;  // trial k in m, v and the mask
  b.gsr = (int)G.sr;
  b.gsc = (int)G.sc;
  b.g = G.g == 0 ? nullptr : reinterpret_cast<const float*>(G.g) + w.k * G.sk;
  b.g_flat = (b.cols == 1 || b.gsc == 1) && (b.rows == 1 || b.gsr == b.cols);
  b.mask = L.mask == 0 ? nullptr : reinterpret_cast<const float*>(L.mask) + flat;
  b.p_bf16 = L.flags & 1;
  b.m_bf16 = L.flags & 2;
  b.v_bf16 = L.flags & 4;
  b.p = reinterpret_cast<char*>(L.p) + w.k * L.p_sk * (b.p_bf16 ? 2 : 4);
  b.psr = (int)L.p_sr;
  b.psc = (int)L.p_sc;
  b.m = reinterpret_cast<char*>(L.m) + flat * (b.m_bf16 ? 2 : 4);
  b.v = reinterpret_cast<char*>(L.v) + flat * (b.v_bf16 ? 2 : 4);
  b.index = (unsigned int)L.index;
  return b;
}

// Element j of thread tid in the block as (r, c) and the flat index r C + c;
// false outside the leaf (never in a full block). Flat: consecutive flat
// indices across the threads. Tiled: the threads run along c (row-major), or
// along r where ``col_major``.
template <bool TILED, bool FULL>
__device__ __forceinline__ bool element(const Block& b, int tid, int j, bool col_major,
                                        int& r, int& c, int& f) {
  if (!TILED) {
    f = b.f0 + tid + j * THREADS;
    r = c = 0;  // found where an operand needs them (offset)
    return FULL || f < b.rows * b.cols;
  }
  const int a = tid % TILE, d = tid / TILE + (THREADS / TILE) * j;
  r = b.r0 + (col_major ? a : d);
  c = b.c0 + (col_major ? d : a);
  f = r * b.cols + c;
  return FULL || (r < b.rows && c < b.cols);
}

// The offset of (r, c) (flat index f) in an operand of strides (sr, sc); a
// flat block finds r and c only for an operand that is not flat itself.
template <bool TILED>
__device__ __forceinline__ int offset(const Block& b, bool flat_operand, int r, int c, int f,
                                      int sr, int sc) {
  if (!TILED) {
    if (flat_operand) return f;
    r = f / b.cols;
    c = f - r * b.cols;
  }
  return r * sr + c * sc;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Global loads and stores, cached in L2 only: each element is read, then
// written, by one thread, once.
__device__ __forceinline__ float load(const char* base, bool bf16, int off) {
  return bf16 ? __uint_as_float(
                    (unsigned int)__ldcg(reinterpret_cast<const unsigned short*>(base) + off) << 16)
              : __ldcg(reinterpret_cast<const float*>(base) + off);
}

__device__ __forceinline__ float load(const float* base, int off) { return __ldcg(base + off); }

__device__ __forceinline__ void store(char* base, bool bf16, int off, unsigned int bits) {
  if (bf16) __stcg(reinterpret_cast<unsigned short*>(base) + off, (unsigned short)bits);
  else __stcg(reinterpret_cast<unsigned int*>(base) + off, bits);
}

__device__ __forceinline__ unsigned int to_bits(float x, bool bf16) {
  return bf16 ? (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(x)) : __float_as_uint(x);
}

// The murmur-style finalizer of ops/sr_adam.py::hash_bits.
__device__ __forceinline__ unsigned int hash32(unsigned int idx, unsigned int seed) {
  unsigned int h = (idx + seed) * P1;
  h ^= h >> 16;
  h *= P2;
  h ^= h >> 13;
  h *= P3;
  return h ^ (h >> 16);
}

// A block's sum of (g mask)^2 in a fixed order: each thread's 16 in order,
// then the warps' butterflies, then the warps in order (thread 0).
template <bool TILED, bool FULL>
__device__ __forceinline__ double block_sumsq(const Block& b, int tid) {
  double acc = 0.0;
  if (b.g != nullptr) {
    const bool col_major = TILED && b.gsc != 1 && b.gsr == 1;
    float x[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {  // every load first, so that they overlap
      int r, c, f;
      x[j] = 0.0f;
      if (!element<TILED, FULL>(b, tid, j, col_major, r, c, f)) continue;
      x[j] = load(b.g, offset<TILED>(b, b.g_flat, r, c, f, b.gsr, b.gsc));
      if (b.mask != nullptr) x[j] = __fmul_rn(x[j], load(b.mask, f));
    }
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) acc += (double)__fmul_rn(x[j], x[j]);
  }
  return acc;
}

// Launch 1: each block's sum of (g mask)^2; the last block turns each trial's
// partials into gscale.
__global__ void __launch_bounds__(THREADS) sr_adam_norm_kernel(const Step s) {
  __shared__ double warp_sums[WARPS];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long block = blockIdx.x;
  bool tiled;
  const Block b = block_of(s, locate(s, block), tiled);
  double acc = tiled ? (b.full ? block_sumsq<true, true>(b, tid) : block_sumsq<true, false>(b, tid))
                     : (b.full ? block_sumsq<false, true>(b, tid) : block_sumsq<false, false>(b, tid));
  acc = warp_sum(acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    double total = 0.0;
    for (int i = 0; i < WARPS; ++i) total += warp_sums[i];
    s.partials[block] = total;
    __threadfence();  // the partial is visible before the ticket is drawn
    last = atomicAdd(s.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int k = warp; k < s.K; k += WARPS) {
    const double* part = s.partials + (long long)k * s.tiles_per_trial;
    double a = 0.0;
#pragma unroll 8
    for (long long t = lane; t < s.tiles_per_trial; t += 32) a += __ldcg(part + t);
    a = warp_sum(a);
    if (lane == 0) {
      // min(clip / (norm + 1e-12), 1) as PyTorch computes it: the reciprocal,
      // then the product
      const float norm = __fsqrt_rn((float)a);
      const float sc = __fmul_rn(__frcp_rn(__fadd_rn(norm, 1e-12f)), s.clip);
      s.scale[k] = sc > 1.0f ? 1.0f : sc;  // a NaN stays NaN, as in torch.clamp
    }
  }
  if (tid == 0) *s.ticket = 0u;  // ready for the next step
}

// The update of a block's elements. Transposed operands (p, or g) are read
// along their rows into shared memory first; each batch of a thread's
// elements issues its loads before its arithmetic and stores.
template <bool TILED, bool FULL>
__device__ __forceinline__ void update_block(const Step& s, const Block& b, int k, int tid,
                                             float (*gs)[TILE + 1],
                                             unsigned int (*ps)[TILE + 1]) {
  const bool g_stage = TILED && b.g != nullptr && b.gsc != 1 && b.gsr == 1;
  const bool p_stage = TILED && b.psc != 1 && b.psr == 1;
  if (g_stage || p_stage) {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      int r, c, f;
      if (!element<TILED, FULL>(b, tid, j, true, r, c, f)) continue;
      if (g_stage) gs[r - b.r0][c - b.c0] = load(b.g, r * b.gsr + c * b.gsc);
      if (p_stage) ps[r - b.r0][c - b.c0] = __float_as_uint(load(b.p, b.p_bf16, r * b.psr + c * b.psc));
    }
    __syncthreads();
  }
  const float sc = s.scale[k];
  const float lr = s.lr[(long long)k * s.lr_stride];
  const unsigned int seed = (unsigned int)s.seed[(long long)k * s.seed_stride]
                            + b.index * P2 + s.count * P3;
#pragma unroll
  for (int j0 = 0; j0 < PER_THREAD; j0 += BATCH) {
    float gv[BATCH], mk[BATCH], mv[BATCH], vv[BATCH], pv[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      int r, c, f;
      gv[u] = mk[u] = mv[u] = vv[u] = pv[u] = 0.0f;
      if (!element<TILED, FULL>(b, tid, j0 + u, false, r, c, f)) continue;
      if (g_stage) gv[u] = gs[r - b.r0][c - b.c0];
      else if (b.g != nullptr) gv[u] = load(b.g, offset<TILED>(b, b.g_flat, r, c, f, b.gsr, b.gsc));
      if (b.mask != nullptr) mk[u] = load(b.mask, f);
      mv[u] = load(b.m, b.m_bf16, f);
      vv[u] = load(b.v, b.v_bf16, f);
      pv[u] = p_stage ? __uint_as_float(ps[r - b.r0][c - b.c0])
                      : load(b.p, b.p_bf16, offset<TILED>(b, true, r, c, f, b.psr, b.psc));
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      int r, c, f;
      if (!element<TILED, FULL>(b, tid, j0 + u, false, r, c, f)) continue;
      float g = gv[u];
      if (b.mask != nullptr) g = __fmul_rn(g, mk[u]);
      const float g32 = __fmul_rn(g, sc);
      const float m32 = __fmaf_rn(mv[u], s.b1, __fmul_rn(g32, s.one_m_b1));
      const float v32 = __fmaf_rn(vv[u], s.b2, __fmul_rn(__fmul_rn(g32, s.one_m_b2), g32));
      const float denom = __fmul_rn(s.b1c, __fadd_rn(__fsqrt_rn(__fdiv_rn(v32, s.b2c)), s.eps));
      float upd = __fdiv_rn(m32, denom);
      if (b.mask != nullptr) upd = __fmul_rn(upd, mk[u]);
      const float p32 = __fmaf_rn(-lr, upd, pv[u]);
      unsigned int out;
      if (b.p_bf16) {  // 16 hashed bits below the bfloat16 cut, then truncation
        const unsigned int h = hash32((unsigned int)f, seed);
        out = to_bits(__uint_as_float((__float_as_uint(p32) + (h & 0xFFFFu)) & 0xFFFF0000u),
                      true);
      } else {
        out = __float_as_uint(p32);
      }
      if (p_stage) ps[r - b.r0][c - b.c0] = out;  // the cell this thread read
      else store(b.p, b.p_bf16, offset<TILED>(b, true, r, c, f, b.psr, b.psc), out);
      store(b.m, b.m_bf16, f, to_bits(m32, b.m_bf16));
      store(b.v, b.v_bf16, f, to_bits(v32, b.v_bf16));
    }
  }
  if (p_stage) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      int r, c, f;
      if (!element<TILED, FULL>(b, tid, j, true, r, c, f)) continue;
      store(b.p, b.p_bf16, r * b.psr + c * b.psc, ps[r - b.r0][c - b.c0]);
    }
  }
}

// Launch 2: the update of every element, in place.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) sr_adam_update_kernel(const Step s) {
  __shared__ float gs[TILE][TILE + 1];          // g, when staged
  __shared__ unsigned int ps[TILE][TILE + 1];   // p's value in, then its stored bits out
  const int tid = threadIdx.x;
  const Where w = locate(s, blockIdx.x);
  bool tiled;
  const Block b = block_of(s, w, tiled);
  if (tiled) {
    if (b.full) update_block<true, true>(s, b, w.k, tid, gs, ps);
    else update_block<true, false>(s, b, w.k, tid, gs, ps);
  } else {
    if (b.full) update_block<false, true>(s, b, w.k, tid, gs, ps);
    else update_block<false, false>(s, b, w.k, tid, gs, ps);
  }
}

}  // namespace

// One step: launch 1 then launch 2 on ``stream``, no synchronisation. ``step``
// is a host struct (kernels/sr_adam.py's _StepArgs), copied into the launches'
// parameters; the tables it points to are on the device, in the stream's
// order. Returns the CUDA error code of the launches (0 on success).
extern "C" int sr_adam_step(const void* step, void* stream) {
  const Step& s = *static_cast<const Step*>(step);
  if (s.n_leaves < 1 || s.K < 1 || s.n_tiles < 1 || s.n_tiles > 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = (unsigned int)s.n_tiles;
  sr_adam_norm_kernel<<<blocks, THREADS, 0, st>>>(s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sr_adam_update_kernel<<<blocks, THREADS, 0, st>>>(s);
  return (int)cudaGetLastError();
}

// Sizes of the host structs, which the wrapper holds its ctypes mirrors to.
extern "C" int sr_adam_struct_sizes(long long* out) {
  out[0] = (long long)sizeof(Step);
  out[1] = (long long)sizeof(Grad);
  out[2] = (long long)sizeof(Leaf);
  return 0;
}
