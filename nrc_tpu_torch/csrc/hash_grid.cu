// Multiresolution hash-grid encoding: the lookup (H1) and its adjoint (H2).
//
// Stands where the JAX package computes the grid with XLA gathers and, on a
// TPU, a one-hot matrix-product adjoint:
//   nrc_hash_lookup  <- nrc_tpu/ops/encodings.py::hash_grid_lookup
//                       (_corner_index_weight_all_levels + the 8 row gathers)
//   nrc_hash_adjoint <- the adjoint of that lookup with respect to the table
//                       (XLA's scatter-add on the CPU; _grid_gather_bwd's
//                       one-hot products on a TPU, a workaround not ported)
// No Pallas kernel stood there. Plain versions: ops/hash_cuda.py.
//
// The arithmetic of a (query, level): the level's cell from p = pos * res
// (one f32 multiply per axis), floor, frac and an int32 cast; the 8 corners
// in the JAX order (corner bits x, y, z): the dense stride index over the
// (res + 1)^3 vertex grid, clamped to it, where the whole grid fits the
// table (ops/encodings.py::dense_levels), otherwise the uint32 hash
// x * 1 ^ y * 2654435761 ^ z * 805459861 masked to the table size; the
// trilinear weight (wx * wy) * wz. Every float operation is an _rn
// intrinsic and the file is built with -fmad=false.
//
// What bounds them on an H100, measured (PERF.md §6): not device
// memory. H1 reads 8 scattered rows a (query, level) from the table, which
// stays in the 50 MB L2; its time went with the number of those reads (one
// row read instead of eight took 0.083 ms to 0.026 at B = 128,000) and
// above the floor of its arithmetic and stores (no reads: 0.021). H2's went
// with its atomics: one per (query, level) instead of eight took a frame's
// four launches from 0.131 ms to 0.034; plain stores in their place were
// slower still (0.212).
//
// The x-corner pair. With PRIMES[0] = 1, for an even x0 the hashed rows of
// the corners x0 and x0 + 1 are h and h ^ 1: an aligned pair of rows, one
// 16-byte read (F = 2) or one vector atomic. A dense level's two x-corners
// are neighbouring rows, a pair when the first is even. The kernels test
// each y, z corner pair for idx1 == idx0 ^ 1 and then read or add both rows
// at once; otherwise row by row. Half the cells of a hashed level take 6
// reads or atomics instead of 8.
//
// H1: a block of 512 threads takes 32 consecutive queries; warp w takes
// levels w and w + 16, lane i query i. A warp's 32 reads of one corner then
// name one level's rows for neighbouring queries: on the frame's inference
// launch, whose queries are in pixel order, neighbours share cells at the
// coarse levels and the coalescer merges their sectors. The features go
// through shared memory (rows padded to an odd number of a lane's store
// words, so a warp's stores of one level meet each bank once) and leave as
// contiguous 16-byte stores of the block's [32, L * F] tile. H1 stays equal
// to its plain version bit for bit: the corners are summed in order 0..7
// from 0, each term w * row[f] rounded before the add, whatever reads
// brought the rows.
//
// H2: w * g summed into the table gradient, the same bits on every launch.
// Each term is quantised to a signed 64-bit fixed-point number and the
// numbers are added with integer atomics, whose sum does not depend on the
// order of the adds; one last pass turns each row's sum into f32. Three
// kernels in one stream, all on the device (no host read, so a frame's CUDA
// graph holds them):
//   1. hash_gmax_kernel: each level's largest |g| over the batch (the f32
//      bits' atomicMax, exact and order-free);
//   2. hash_adjoint_kernel: each term w * g (f32, as the plain version
//      rounds it) times the level's scale 2^s, rounded to the nearest int64
//      and added. The scale is a power of two chosen a level from that
//      largest |g| < 2^e: s = 62 - ceil(log2(8 B)) - e, so that a row's sum
//      of at most 8 B terms (|w| <= 1) stays below 2^62. A term is then
//      known to 2^-(s+1), about 2^-46 of the level's largest |g| at
//      B = 16,384; a row's f32 sum in the plain version rounds at 2^-24 of
//      its own size, so the fixed-point sum is the more exact of the two.
//      A term below half a quantum adds nothing (a row of such terms stays
//      0 where the plain version's is not);
//   3. hash_convert_kernel: dtable = sum * 2^-s, rounded to f32 once.
// The tiles: 32 queries a block, g's rows staged through shared memory (g
// is the hash columns of K4's dX, read through its row stride: 32 coalesced
// rows), a warp a level; an aligned x-corner pair takes 2 F consecutive
// 64-bit atomics (no vector form of the integer add exists), a single row
// F. Dense levels whose 64-bit rows fit a block's shared memory go to
// blocks of their own, one for every kDenseQueries queries: each sums its
// queries' terms into a shared-memory copy of the level's rows with 64-bit
// shared atomics (as order-free) and adds each row it touched into the
// global sums once (the shipped level 0: 17^3 rows, 2 features, 78.6 KB).
// H2's time goes with the number of its atomic instructions, about 65 G a
// second whatever their width: a (query, level) now takes 16 64-bit ones,
// where the f32 design took 6 to 8 vector ones (PERF.md §6). The accumulator
// (8 bytes a table float, behind a header of kMaxLevels words) is the
// caller's scratch, zeroed here. The parent's f32 atomics added in an order
// that changed from run to run, and Adam's eps of 1e-15 turned the residues
// into full steps; a stable radix sort of the (row, term) pairs, then each
// row summed in the plain order, took 0.30 ms a batch against 0.033
// (PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 16 warps. Both kernels are declared for one block an SM at least, which
// lets ptxas spend registers on keeping more reads and atomics in flight:
// the same source without the 1 took a frame's H2 0.093 -> 0.106 ms and H1
// 0.091 -> 0.093 (PERF.md §6).
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // queries a block (a warp's lanes)
constexpr int kMaxLevels = 32;     // ops/hash_cuda.py::MAX_LEVELS
constexpr int kDenseQueries = 128;  // queries a pre-summing block of H2 takes at most
// H2's dense pre-sum budget a block, opted in above the 48 KB a block has
// by default: the shipped level 0's 64-bit rows (78.6 KB) fit, and a
// frame's four launches took 0.266 ms with it against 0.304 without
// (PERF.md §6); the tiles' blocks get as much, two blocks an SM
constexpr int kSharedBytes = 80 * 1024;
constexpr uint32_t kPrimeY = 2654435761u;
constexpr uint32_t kPrimeZ = 805459861u;

struct Levels {
  float res[kMaxLevels];  // the level's resolution as f32
  int verts[kMaxLevels];  // res + 1 vertices an axis
  uint32_t dense;         // bit l set: level l is indexed densely
  uint32_t presum;        // bit l set: H2 sums level l in shared memory first
  int presum_ofs[kMaxLevels];  // its first float in the pre-sum region
};

// The cell of one level: integer origin and fractional offset per axis.
struct Cell {
  int x0, y0, z0;
  float fx, fy, fz;
};

__device__ __forceinline__ void axis(float p_in, float res, int& i0, float& frac) {
  const float p = __fmul_rn(p_in, res);
  const float f = floorf(p);
  frac = __fsub_rn(p, f);
  i0 = static_cast<int>(f);
}

__device__ __forceinline__ Cell cell_of(const float (&p)[3], float res) {
  Cell c;
  axis(p[0], res, c.x0, c.fx);
  axis(p[1], res, c.y0, c.fy);
  axis(p[2], res, c.z0, c.fz);
  return c;
}

// The rows of the two x-corners (x0 and x0 + 1) of the y, z corner pair j
// (dy = j & 1, dz = j >> 1) within the level, and their weights.
struct XPair {
  int idx0, idx1;
  float w0, w1;
};

__device__ __forceinline__ XPair x_pair(const Cell& c, int j, bool dense, int verts, uint32_t mask) {
  const int dy = j & 1, dz = j >> 1;
  const int vy = c.y0 + dy, vz = c.z0 + dz;
  XPair q;
  if (dense) {
    const int top = verts - 1;
    const int cy = min(max(vy, 0), top), cz = min(max(vz, 0), top);
    const int base = verts * (cy + verts * cz);
    q.idx0 = min(max(c.x0, 0), top) + base;
    q.idx1 = min(max(c.x0 + 1, 0), top) + base;
  } else {
    const uint32_t yz = (static_cast<uint32_t>(vy) * kPrimeY) ^ (static_cast<uint32_t>(vz) * kPrimeZ);
    q.idx0 = static_cast<int>((static_cast<uint32_t>(c.x0) ^ yz) & mask);
    q.idx1 = static_cast<int>((static_cast<uint32_t>(c.x0 + 1) ^ yz) & mask);
  }
  const float wy = dy ? c.fy : __fsub_rn(1.0f, c.fy);
  const float wz = dz ? c.fz : __fsub_rn(1.0f, c.fz);
  q.w0 = __fmul_rn(__fmul_rn(__fsub_rn(1.0f, c.fx), wy), wz);
  q.w1 = __fmul_rn(__fmul_rn(c.fx, wy), wz);
  return q;
}

// N consecutive floats from 16-byte (N >= 4) or 8-byte (N == 2) aligned p.
template <int N>
__device__ __forceinline__ void load_floats(const float* __restrict__ p, float (&r)[N]) {
  if constexpr (N == 1) {
    r[0] = __ldg(p);
  } else if constexpr (N == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    r[0] = v.x;
    r[1] = v.y;
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + k));
      r[k] = v.x;
      r[k + 1] = v.y;
      r[k + 2] = v.z;
      r[k + 3] = v.w;
    }
  }
}

// F floats at p in shared memory, as the words tile_stride pads for (p is
// aligned to them: F floats, at most 4).
template <int F>
__device__ __forceinline__ void store_shared(float* p, const float (&r)[F]) {
  if constexpr (F == 1) {
    p[0] = r[0];
  } else if constexpr (F == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
#pragma unroll
    for (int k = 0; k < F; k += 4)
      *reinterpret_cast<float4*>(p + k) = make_float4(r[k], r[k + 1], r[k + 2], r[k + 3]);
  }
}

template <int F>
__device__ __forceinline__ void load_shared(const float* p, float (&r)[F]) {
  if constexpr (F == 1) {
    r[0] = p[0];
  } else if constexpr (F == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x;
    r[1] = v.y;
  } else {
#pragma unroll
    for (int k = 0; k < F; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + k);
      r[k] = v.x;
      r[k + 1] = v.y;
      r[k + 2] = v.z;
      r[k + 3] = v.w;
    }
  }
}

// A block's tile: kTile rows of L * F floats, each padded to an odd number
// of the words a lane stores at once (F floats, at most 4), so that the
// lanes of one shared-memory phase meet each bank once.
__host__ __device__ __forceinline__ int tile_stride(int levels, int features) {
  const int word = features < 4 ? features : 4;
  return word * ((levels * features / word) | 1);
}

__device__ __forceinline__ void load_position(const float* __restrict__ pos, int b, float (&p)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = __ldg(pos + 3 * static_cast<int64_t>(b) + a);
}

// One (query, level) of H1: the 8 corners' rows blended in order 0..7.
template <int F>
__device__ __forceinline__ void lookup_level(const float (&p)[3], int l, const float* __restrict__ table,
                                             int log2_size, const Levels& lv, float (&acc)[F]) {
  const uint32_t mask = (1u << log2_size) - 1u;
  const Cell c = cell_of(p, lv.res[l]);
  const bool dense = (lv.dense >> l) & 1u;
  const float* level_rows = table + (static_cast<int64_t>(l) << log2_size) * F;
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const XPair q = x_pair(c, j, dense, lv.verts[l], mask);
    float two[2 * F];  // the aligned pair of rows that holds idx0
    load_floats<2 * F>(level_rows + static_cast<int64_t>(q.idx0 & ~1) * F, two);
    const bool odd = q.idx0 & 1;
    float r0[F], r1[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      r0[f] = odd ? two[F + f] : two[f];
      r1[f] = odd ? two[f] : two[F + f];
    }
    if (q.idx1 != (q.idx0 ^ 1)) load_floats<F>(level_rows + static_cast<int64_t>(q.idx1) * F, r1);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(q.w0, r0[f]));
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(q.w1, r1[f]));
  }
}

// H1: out[b, l * F + f] = sum over the 8 corners of w * table[l, idx, f].
template <int F>
__global__ void __launch_bounds__(kThreads, 1)
    hash_lookup_kernel(const float* __restrict__ pos, const float* __restrict__ table, int n,
                       int levels, int log2_size, Levels lv, float* __restrict__ out) {
  extern __shared__ float tile[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * kTile;
  const int rows = min(kTile, n - b0);
  const int width = levels * F, stride = tile_stride(levels, F);
  if (lane < rows) {
    float p[3];
    load_position(pos, b0 + lane, p);
    for (int l = warp; l < levels; l += kWarps) {
      float acc[F];
      lookup_level<F>(p, l, table, log2_size, lv, acc);
      store_shared<F>(tile + lane * stride + l * F, acc);
    }
  }
  __syncthreads();
  // the tile's rows are contiguous in out: 16-byte stores (b0 * width * 4
  // bytes is a multiple of 128), a scalar tail
  const int total = rows * width;
  float* dst = out + static_cast<int64_t>(b0) * width;
  for (int i = 4 * threadIdx.x; i < total; i += 4 * kThreads) {
    float v[4];
    int r = i / width, col = i - r * width;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = tile[r * stride + col];
      if (++col == width) col = 0, ++r;
    }
    if (i + 4 <= total) {
      *reinterpret_cast<float4*>(dst + i) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int k = 0; i + k < total; ++k) dst[i + k] = v[k];
    }
  }
}

// H2's fixed point. A level's scale 2^s from its largest |g| (f32 bits) and
// the batch's headroom (ceil(log2(8 B))): the sum of a row's at most 8 B
// terms stays below 2^62. A level whose g is all zero adds only zeros.
__device__ __forceinline__ int level_shift(uint32_t gmax_bits, int headroom) {
  if (gmax_bits == 0u) return 0;
  int e;
  frexpf(__uint_as_float(gmax_bits), &e);  // largest |g| < 2^e
  return 62 - headroom - e;
}

// a term w * g (already rounded to f32) in units of 2^-s: exact in double
// (a power of two), then rounded to the nearest integer once
__device__ __forceinline__ unsigned long long quantise(float t, double scale) {
  return static_cast<unsigned long long>(__double2ll_rn(__dmul_rn(static_cast<double>(t), scale)));
}

template <int N>
__device__ __forceinline__ void atomic_add_fixed(unsigned long long* p, const unsigned long long (&r)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) atomicAdd(p + k, r[k]);
}

// One (query, level) of H2: w * g quantised and added into the 8 corners'
// rows, an aligned x-corner pair as 2 F consecutive words.
template <int F>
__device__ __forceinline__ void adjoint_level(const float (&p)[3], const float (&gl)[F], int l,
                                              unsigned long long* acc, int log2_size, const Levels& lv,
                                              double scale) {
  const uint32_t mask = (1u << log2_size) - 1u;
  const Cell c = cell_of(p, lv.res[l]);
  const bool dense = (lv.dense >> l) & 1u;
  unsigned long long* level_rows = acc + (static_cast<int64_t>(l) << log2_size) * F;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const XPair q = x_pair(c, j, dense, lv.verts[l], mask);
    unsigned long long u0[F], u1[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      u0[f] = quantise(__fmul_rn(q.w0, gl[f]), scale);
      u1[f] = quantise(__fmul_rn(q.w1, gl[f]), scale);
    }
    if (q.idx1 == (q.idx0 ^ 1)) {
      unsigned long long two[2 * F];
      const bool odd = q.idx0 & 1;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        two[f] = odd ? u1[f] : u0[f];
        two[F + f] = odd ? u0[f] : u1[f];
      }
      atomic_add_fixed<2 * F>(level_rows + static_cast<int64_t>(q.idx0 & ~1) * F, two);
    } else {
      atomic_add_fixed<F>(level_rows + static_cast<int64_t>(q.idx0) * F, u0);
      atomic_add_fixed<F>(level_rows + static_cast<int64_t>(q.idx1) * F, u1);
    }
  }
}

// H2's first kernel: gmax[l] = the largest |g[b, l * F + f]| as f32 bits
// (non-negative floats order as their bits), a block's maxima in shared
// memory, then one global atomic a level a block.
__global__ void __launch_bounds__(kThreads)
    hash_gmax_kernel(const float* __restrict__ g, int64_t ld, int n, int levels, int features,
                     uint32_t* gmax) {
  __shared__ uint32_t block_max[kMaxLevels];
  if (threadIdx.x < kMaxLevels) block_max[threadIdx.x] = 0u;
  __syncthreads();
  const int width = levels * features;
  const int64_t total = static_cast<int64_t>(n) * width;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t b = i / width;
    const int col = static_cast<int>(i - b * width);
    atomicMax(block_max + col / features, __float_as_uint(fabsf(__ldg(g + b * ld + col))));
  }
  __syncthreads();
  if (threadIdx.x < levels && block_max[threadIdx.x]) atomicMax(gmax + threadIdx.x, block_max[threadIdx.x]);
}

// H2 on the levels not pre-summed, a block a tile of 32 queries. g's rows
// are ld floats apart.
template <int F>
__device__ __forceinline__ void adjoint_tile(const float* __restrict__ pos, const float* __restrict__ g,
                                             int64_t ld, int n, int levels, int log2_size, const Levels& lv,
                                             const uint32_t* gmax, int headroom, unsigned long long* acc,
                                             int tile_index, float* gtile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = tile_index * kTile;
  const int rows = min(kTile, n - b0);
  const int width = levels * F, stride = tile_stride(levels, F);
  for (int i = threadIdx.x; i < rows * width; i += kThreads) {
    const int r = i / width, col = i - r * width;
    gtile[r * stride + col] = __ldg(g + static_cast<int64_t>(b0 + r) * ld + col);
  }
  __syncthreads();
  if (lane >= rows) return;
  float p[3];
  load_position(pos, b0 + lane, p);
  for (int l = warp; l < levels; l += kWarps) {
    if ((lv.presum >> l) & 1u) continue;
    float gl[F];
    load_shared<F>(gtile + lane * stride + l * F, gl);
    adjoint_level<F>(p, gl, l, acc, log2_size, lv, ldexp(1.0, level_shift(gmax[l], headroom)));
  }
}

// H2 on the pre-summed dense levels: one block, queries [q0, q1).
template <int F>
__device__ __forceinline__ void adjoint_presum(const float* __restrict__ pos, const float* __restrict__ g,
                                               int64_t ld, int q0, int q1, int levels, int log2_size,
                                               const Levels& lv, const uint32_t* gmax, int headroom,
                                               unsigned long long* acc, unsigned long long* sums,
                                               int sum_words) {
  for (int i = threadIdx.x; i < sum_words; i += kThreads) sums[i] = 0ull;
  __syncthreads();
  for (int b = q0 + threadIdx.x; b < q1; b += kThreads) {
    float p[3];
    load_position(pos, b, p);
    for (int l = 0; l < levels; ++l) {
      if (!((lv.presum >> l) & 1u)) continue;
      const double scale = ldexp(1.0, level_shift(gmax[l], headroom));
      const Cell c = cell_of(p, lv.res[l]);
      unsigned long long* level_sums = sums + lv.presum_ofs[l];
      float gl[F];
#pragma unroll
      for (int f = 0; f < F; ++f) gl[f] = __ldg(g + static_cast<int64_t>(b) * ld + l * F + f);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const XPair q = x_pair(c, j, true, lv.verts[l], 0u);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          atomicAdd(level_sums + q.idx0 * F + f, quantise(__fmul_rn(q.w0, gl[f]), scale));
          atomicAdd(level_sums + q.idx1 * F + f, quantise(__fmul_rn(q.w1, gl[f]), scale));
        }
      }
    }
  }
  __syncthreads();
  // each row a term touched, added into the global sums once
  for (int l = 0; l < levels; ++l) {
    if (!((lv.presum >> l) & 1u)) continue;
    const int nrows = lv.verts[l] * lv.verts[l] * lv.verts[l];
    const unsigned long long* level_sums = sums + lv.presum_ofs[l];
    unsigned long long* level_rows = acc + (static_cast<int64_t>(l) << log2_size) * F;
    for (int r = threadIdx.x; r < nrows; r += kThreads) {
      unsigned long long v[F];
      bool any = false;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        v[f] = level_sums[r * F + f];
        any |= v[f] != 0ull;
      }
      if (any) atomic_add_fixed<F>(level_rows + static_cast<int64_t>(r) * F, v);
    }
  }
}

// H2's second kernel: blocks [0, dense_blocks) pre-sum the dense levels over
// ranges of the queries, the others take a tile each of the remaining levels.
template <int F>
__global__ void __launch_bounds__(kThreads, 1)
    hash_adjoint_kernel(const float* __restrict__ pos, const float* __restrict__ g, int64_t ld, int n,
                        int levels, int log2_size, Levels lv, const uint32_t* gmax, int headroom,
                        unsigned long long* acc, int dense_blocks, int sum_words) {
  extern __shared__ unsigned long long smem[];
  if (static_cast<int>(blockIdx.x) < dense_blocks) {
    const int per = (n + dense_blocks - 1) / dense_blocks;
    const int q0 = blockIdx.x * per, q1 = min(n, q0 + per);
    adjoint_presum<F>(pos, g, ld, q0, q1, levels, log2_size, lv, gmax, headroom, acc, smem, sum_words);
  } else {
    adjoint_tile<F>(pos, g, ld, n, levels, log2_size, lv, gmax, headroom, acc, blockIdx.x - dense_blocks,
                    reinterpret_cast<float*>(smem));
  }
}

// H2's third kernel: each table float's fixed-point sum times 2^-s, rounded
// to f32 once (the int64 to double conversion is exact below 2^53 and
// rounds once above it; the multiply by a power of two is exact).
__global__ void __launch_bounds__(kThreads)
    hash_convert_kernel(const unsigned long long* __restrict__ acc, const uint32_t* __restrict__ gmax,
                        int headroom, int64_t level_floats, int64_t total, float* __restrict__ dtable) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int l = static_cast<int>(i / level_floats);
    const double inv = ldexp(1.0, -level_shift(gmax[l], headroom));
    dtable[i] = __double2float_rn(__dmul_rn(__ll2double_rn(static_cast<long long>(acc[i])), inv));
  }
}

bool make_levels(int levels, int log2_size, int features, const int* res, int dense_mask,
                 Levels& lv) {
  if (levels < 1 || levels > kMaxLevels || log2_size < 1 || log2_size > 30) return false;
  if (features != 1 && features != 2 && features != 4 && features != 8) return false;
  for (int l = 0; l < levels; ++l) {
    lv.res[l] = static_cast<float>(res[l]);
    lv.verts[l] = res[l] + 1;
    lv.presum_ofs[l] = 0;
  }
  lv.dense = static_cast<uint32_t>(dense_mask);
  lv.presum = 0;
  return true;
}

int tile_floats(int levels, int features) {
  return kTile * tile_stride(levels, features);
}

// The dense levels H2 pre-sums: from the coarsest, while their rows of
// 64-bit sums fit kSharedBytes. Returns the words they take.
int choose_presum(int levels, int features, Levels& lv) {
  int words = 0;
  const int budget = kSharedBytes / 8;  // the tiles' blocks use the same memory for g
  for (int l = 0; l < levels; ++l) {
    if (!((lv.dense >> l) & 1u)) continue;
    const int64_t rows = static_cast<int64_t>(lv.verts[l]) * lv.verts[l] * lv.verts[l];
    if (words + rows * features > budget) break;
    lv.presum |= 1u << l;
    lv.presum_ofs[l] = words;
    words += static_cast<int>(rows * features);
  }
  return words;
}

// ceil(log2(8 n)): a row's sum has at most 8 n terms
int headroom_bits(int n) {
  int bits = 0;
  while ((int64_t{1} << bits) < int64_t{8} * n) ++bits;
  return bits;
}

// a grid-stride kernel's blocks: enough for total items, at most a few waves
unsigned stride_blocks(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 1 ? 1 : (blocks > 1024 ? 1024 : blocks));
}

template <int F>
cudaError_t launch_lookup(const float* pos, const float* table, int n, int levels, int log2_size,
                          const Levels& lv, float* out, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
  const size_t smem = sizeof(float) * tile_floats(levels, F);
  hash_lookup_kernel<F><<<blocks, kThreads, smem, s>>>(pos, table, n, levels, log2_size, lv, out);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_adjoint(const float* pos, const float* g, int64_t ld, int n, int levels, int log2_size,
                           Levels& lv, float* dtable, unsigned long long* scratch, cudaStream_t s) {
  const int64_t total = (static_cast<int64_t>(levels) << log2_size) * F;
  uint32_t* gmax = reinterpret_cast<uint32_t*>(scratch);
  unsigned long long* acc = scratch + kMaxLevels;
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (kMaxLevels + total), s);
  if (err != cudaSuccess) return err;
  const int headroom = headroom_bits(n);
  hash_gmax_kernel<<<stride_blocks(static_cast<int64_t>(n) * levels * F), kThreads, 0, s>>>(g, ld, n, levels, F,
                                                                                             gmax);
  const int sum_words = choose_presum(levels, F, lv);
  const int dense_blocks = lv.presum ? (n + kDenseQueries - 1) / kDenseQueries : 0;
  const int tiles = (n + kTile - 1) / kTile;
  const size_t sum_bytes = sizeof(unsigned long long) * sum_words;
  const size_t tile_bytes = sizeof(float) * tile_floats(levels, F);
  const size_t smem = sum_bytes > tile_bytes ? sum_bytes : tile_bytes;
  if (smem > 48 * 1024) {  // above the default a kernel must opt in
    err = cudaFuncSetAttribute(hash_adjoint_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  hash_adjoint_kernel<F><<<static_cast<unsigned>(dense_blocks + tiles), kThreads, smem, s>>>(
      pos, g, ld, n, levels, log2_size, lv, gmax, headroom, acc, dense_blocks, sum_words);
  hash_convert_kernel<<<stride_blocks(total), kThreads, 0, s>>>(acc, gmax, headroom,
                                                                 static_cast<int64_t>(F) << log2_size, total, dtable);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nrc_hash_lookup(const float* pos, const float* table, int n, int levels,
                               int log2_size, int features, const int* res, int dense_mask,
                               float* out, void* stream) {
  Levels lv;
  if (!make_levels(levels, log2_size, features, res, dense_mask, lv)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (features) {
    case 1: return static_cast<int>(launch_lookup<1>(pos, table, n, levels, log2_size, lv, out, s));
    case 2: return static_cast<int>(launch_lookup<2>(pos, table, n, levels, log2_size, lv, out, s));
    case 4: return static_cast<int>(launch_lookup<4>(pos, table, n, levels, log2_size, lv, out, s));
    default: return static_cast<int>(launch_lookup<8>(pos, table, n, levels, log2_size, lv, out, s));
  }
}

// scratch: kMaxLevels + levels * 2^log2_size * features 64-bit words,
// device memory the caller owns (zeroed here, every launch)
extern "C" int nrc_hash_adjoint(const float* pos, const float* g, long long ld, int n, int levels,
                                int log2_size, int features, const int* res, int dense_mask,
                                float* dtable, void* scratch, void* stream) {
  Levels lv;
  if (!make_levels(levels, log2_size, features, res, dense_mask, lv) || n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t stride = static_cast<int64_t>(ld);
  unsigned long long* w = static_cast<unsigned long long*>(scratch);
  switch (features) {
    case 1: return static_cast<int>(launch_adjoint<1>(pos, g, stride, n, levels, log2_size, lv, dtable, w, s));
    case 2: return static_cast<int>(launch_adjoint<2>(pos, g, stride, n, levels, log2_size, lv, dtable, w, s));
    case 4: return static_cast<int>(launch_adjoint<4>(pos, g, stride, n, levels, log2_size, lv, dtable, w, s));
    default: return static_cast<int>(launch_adjoint<8>(pos, g, stride, n, levels, log2_size, lv, dtable, w, s));
  }
}
