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
// H2: w * g added into a zeroed table gradient. The same tile of 32 queries
// a block, g's rows staged through shared memory (g is the hash columns of
// K4's dX, read through its row stride: 32 coalesced rows), a warp a level.
// Dense levels whose rows fit a block's shared memory (the shipped level 0:
// 17^3 rows, 39 KB) go to blocks of their own, one for every kDenseQueries
// queries: each sums its queries' terms into a shared-memory copy of the
// level's rows (shared atomics) and adds each row it touched into the
// gradient once. A frame's training batch puts its 131,072 level-0 terms on
// about 990 rows, up to 967 on one; the pre-sum leaves at most one global
// atomic a row a block. Those blocks run beside the tiles' blocks, and H2's
// time is then that of the hashed levels' atomics (about 1.5 M vector
// atomics a batch, 0.021 ms). The atomics make the order of each row's sum
// change from run to run: H2 is held to its plain version by limits on the
// mean and largest difference (tools/bench_hash.py::CARD_LIMITS). A
// deterministic H2 (a stable radix sort of the (row, term) pairs, then each
// row summed in the plain version's order) took 0.30 ms a batch against
// 0.033 (PERF.md §6).

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
constexpr int kSharedBytes = 48 * 1024;  // a block's shared memory without opting in
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

// The vector forms of atomicAdd on global float2/float4 exist for sm_90 from
// CUDA 12.1 on.
#if !defined(__CUDACC_VER_MAJOR__) || __CUDACC_VER_MAJOR__ < 12 || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ < 1)
#error "hash_grid.cu needs CUDA 12.1 or later (atomicAdd on float2/float4)"
#endif

template <int N>
__device__ __forceinline__ void atomic_add_floats(float* p, const float (&r)[N]) {
  if constexpr (N == 1) {
    atomicAdd(p, r[0]);
  } else if constexpr (N == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(r[0], r[1]));
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      atomicAdd(reinterpret_cast<float4*>(p + k), make_float4(r[k], r[k + 1], r[k + 2], r[k + 3]));
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

// One (query, level) of H2: w * g added into the 8 corners' rows, an
// aligned x-corner pair with one vector atomic.
template <int F>
__device__ __forceinline__ void adjoint_level(const float (&p)[3], const float (&gl)[F], int l, float* dtable,
                                              int log2_size, const Levels& lv) {
  const uint32_t mask = (1u << log2_size) - 1u;
  const Cell c = cell_of(p, lv.res[l]);
  const bool dense = (lv.dense >> l) & 1u;
  float* level_rows = dtable + (static_cast<int64_t>(l) << log2_size) * F;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const XPair q = x_pair(c, j, dense, lv.verts[l], mask);
    float u0[F], u1[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      u0[f] = __fmul_rn(q.w0, gl[f]);
      u1[f] = __fmul_rn(q.w1, gl[f]);
    }
    if (q.idx1 == (q.idx0 ^ 1)) {
      float two[2 * F];
      const bool odd = q.idx0 & 1;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        two[f] = odd ? u1[f] : u0[f];
        two[F + f] = odd ? u0[f] : u1[f];
      }
      atomic_add_floats<2 * F>(level_rows + static_cast<int64_t>(q.idx0 & ~1) * F, two);
    } else {
      atomic_add_floats<F>(level_rows + static_cast<int64_t>(q.idx0) * F, u0);
      atomic_add_floats<F>(level_rows + static_cast<int64_t>(q.idx1) * F, u1);
    }
  }
}

// H2 on the levels not pre-summed: dtable[l, idx, f] += w * g[b, l * F + f]
// for the 8 corners of each (query, level), a block a tile of 32 queries.
// g's rows are ld floats apart.
template <int F>
__device__ __forceinline__ void adjoint_tile(const float* __restrict__ pos, const float* __restrict__ g,
                                             int64_t ld, int n, int levels, int log2_size, const Levels& lv,
                                             float* dtable, int tile_index, float* gtile) {
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
    adjoint_level<F>(p, gl, l, dtable, log2_size, lv);
  }
}

// H2 on the pre-summed dense levels: one block, queries [q0, q1).
template <int F>
__device__ __forceinline__ void adjoint_presum(const float* __restrict__ pos, const float* __restrict__ g,
                                               int64_t ld, int q0, int q1, int levels, int log2_size,
                                               const Levels& lv, float* dtable, float* sums, int sum_floats) {
  for (int i = threadIdx.x; i < sum_floats; i += kThreads) sums[i] = 0.0f;
  __syncthreads();
  for (int b = q0 + threadIdx.x; b < q1; b += kThreads) {
    float p[3];
    load_position(pos, b, p);
    for (int l = 0; l < levels; ++l) {
      if (!((lv.presum >> l) & 1u)) continue;
      const Cell c = cell_of(p, lv.res[l]);
      float* level_sums = sums + lv.presum_ofs[l];
      float gl[F];
#pragma unroll
      for (int f = 0; f < F; ++f) gl[f] = __ldg(g + static_cast<int64_t>(b) * ld + l * F + f);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const XPair q = x_pair(c, j, true, lv.verts[l], 0u);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          atomicAdd(level_sums + q.idx0 * F + f, __fmul_rn(q.w0, gl[f]));
          atomicAdd(level_sums + q.idx1 * F + f, __fmul_rn(q.w1, gl[f]));
        }
      }
    }
  }
  __syncthreads();
  // each row a term touched, added into the gradient once (a row whose
  // terms summed to zero adds nothing, as its terms would have)
  for (int l = 0; l < levels; ++l) {
    if (!((lv.presum >> l) & 1u)) continue;
    const int nrows = lv.verts[l] * lv.verts[l] * lv.verts[l];
    const float* level_sums = sums + lv.presum_ofs[l];
    float* level_rows = dtable + (static_cast<int64_t>(l) << log2_size) * F;
    for (int r = threadIdx.x; r < nrows; r += kThreads) {
      float v[F];
      bool any = false;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        v[f] = level_sums[r * F + f];
        any |= v[f] != 0.0f;
      }
      if (any) atomic_add_floats<F>(level_rows + static_cast<int64_t>(r) * F, v);
    }
  }
}

// H2: blocks [0, dense_blocks) pre-sum the dense levels over ranges of the
// queries, the others take a tile each of the remaining levels.
template <int F>
__global__ void __launch_bounds__(kThreads, 1)
    hash_adjoint_kernel(const float* __restrict__ pos, const float* __restrict__ g, int64_t ld, int n,
                        int levels, int log2_size, Levels lv, float* dtable, int dense_blocks,
                        int sum_floats) {
  extern __shared__ float smem[];
  if (static_cast<int>(blockIdx.x) < dense_blocks) {
    const int per = (n + dense_blocks - 1) / dense_blocks;
    const int q0 = blockIdx.x * per, q1 = min(n, q0 + per);
    adjoint_presum<F>(pos, g, ld, q0, q1, levels, log2_size, lv, dtable, smem, sum_floats);
  } else {
    adjoint_tile<F>(pos, g, ld, n, levels, log2_size, lv, dtable, blockIdx.x - dense_blocks, smem);
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

// The dense levels H2 pre-sums: from the coarsest, while their rows fit the
// shared memory a block has without opting in. Returns the floats they take.
int choose_presum(int levels, int features, Levels& lv) {
  int floats = 0;
  const int budget = kSharedBytes / 4;  // the tiles' blocks use the same memory for g
  for (int l = 0; l < levels; ++l) {
    if (!((lv.dense >> l) & 1u)) continue;
    const int64_t rows = static_cast<int64_t>(lv.verts[l]) * lv.verts[l] * lv.verts[l];
    if (floats + rows * features > budget) break;
    lv.presum |= 1u << l;
    lv.presum_ofs[l] = floats;
    floats += static_cast<int>(rows * features);
  }
  return floats;
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
                           Levels& lv, float* dtable, cudaStream_t s) {
  const int sum_floats = choose_presum(levels, F, lv);
  const int dense_blocks = lv.presum ? (n + kDenseQueries - 1) / kDenseQueries : 0;
  const int tiles = (n + kTile - 1) / kTile;
  const int smem_floats = sum_floats > tile_floats(levels, F) ? sum_floats : tile_floats(levels, F);
  hash_adjoint_kernel<F><<<static_cast<unsigned>(dense_blocks + tiles), kThreads, sizeof(float) * smem_floats, s>>>(
      pos, g, ld, n, levels, log2_size, lv, dtable, dense_blocks, sum_floats);
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

extern "C" int nrc_hash_adjoint(const float* pos, const float* g, long long ld, int n, int levels,
                                int log2_size, int features, const int* res, int dense_mask,
                                float* dtable, void* stream) {
  Levels lv;
  if (!make_levels(levels, log2_size, features, res, dense_mask, lv)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t stride = static_cast<int64_t>(ld);
  switch (features) {
    case 1: return static_cast<int>(launch_adjoint<1>(pos, g, stride, n, levels, log2_size, lv, dtable, s));
    case 2: return static_cast<int>(launch_adjoint<2>(pos, g, stride, n, levels, log2_size, lv, dtable, s));
    case 4: return static_cast<int>(launch_adjoint<4>(pos, g, stride, n, levels, log2_size, lv, dtable, s));
    default: return static_cast<int>(launch_adjoint<8>(pos, g, stride, n, levels, log2_size, lv, dtable, s));
  }
}
