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
// One thread per (query, level). It computes the level's cell from
// p = pos * res (one f32 multiply per axis), floor, frac and an int32 cast,
// then the 8 corners in the JAX order (corner bits x, y, z): the dense
// stride index over the (res + 1)^3 vertex grid, clamped to it, where the
// whole grid fits the table (ops/encodings.py::dense_levels), otherwise the
// uint32 hash x * 1 ^ y * 2654435761 ^ z * 805459861 masked to the table
// size; the trilinear weight (wx * wy) * wz. Every float operation is an
// _rn intrinsic and the file is built with -fmad=false, so the lookup is
// equal to its plain version bit for bit: the corners are summed in order
// 0..7 from 0, each term w * row[f] rounded before the add.
//
// What bounds it on an H100: bytes. The lookup writes B * L * F floats
// (16.4 MB at B = 128,000, L = 16, F = 2) and reads the positions; the table
// (4.19 MB at the shipped 16 x 2^15 x 2) stays in the 50 MB L2, so its 8
// row reads per (query, level) cost L2 bandwidth, not device memory. A warp
// covers two queries' 16 levels, so its stores are one contiguous run of
// 256 bytes. The adjoint reads the output gradient (the hash columns of K4's
// dX, through their row stride), recomputes the corners instead of reading
// saved ones (8 indices and weights a (query, level) would be 16.8 MB a
// training step at B = 16,384), and adds w * g into a zeroed table gradient
// with one vector atomic per corner (atomicAdd on float2/float4 is native on
// sm_90). The atomics make the order of each row's sum change from run to
// run: H2 is held to its plain version by limits on the mean and largest
// difference (tools/bench_hash.py::CARD_LIMITS). The coarse dense level
// takes 8 adds a query on a few thousand rows; a shared-memory pre-sum for it
// is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;     // ops/hash_cuda.py::MAX_LEVELS
constexpr uint32_t kPrimeY = 2654435761u;
constexpr uint32_t kPrimeZ = 805459861u;

struct Levels {
  float res[kMaxLevels];  // the level's resolution as f32
  int verts[kMaxLevels];  // res + 1 vertices an axis
  uint32_t dense;         // bit l set: level l is indexed densely
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

__device__ __forceinline__ Cell cell_of(const float* __restrict__ pos, int b, float res) {
  Cell c;
  axis(__ldg(pos + 3 * static_cast<int64_t>(b) + 0), res, c.x0, c.fx);
  axis(__ldg(pos + 3 * static_cast<int64_t>(b) + 1), res, c.y0, c.fy);
  axis(__ldg(pos + 3 * static_cast<int64_t>(b) + 2), res, c.z0, c.fz);
  return c;
}

// Row (within the level) and weight of corner k of a cell.
__device__ __forceinline__ void corner(const Cell& c, int k, bool dense, int verts, uint32_t mask,
                                       int& idx, float& w) {
  const int dx = k & 1, dy = (k >> 1) & 1, dz = (k >> 2) & 1;
  const int vx = c.x0 + dx, vy = c.y0 + dy, vz = c.z0 + dz;
  if (dense) {
    const int cx = min(max(vx, 0), verts - 1);
    const int cy = min(max(vy, 0), verts - 1);
    const int cz = min(max(vz, 0), verts - 1);
    idx = cx + verts * (cy + verts * cz);
  } else {
    const uint32_t h = static_cast<uint32_t>(vx) ^ (static_cast<uint32_t>(vy) * kPrimeY) ^
                       (static_cast<uint32_t>(vz) * kPrimeZ);
    idx = static_cast<int>(h & mask);
  }
  const float wx = dx ? c.fx : __fsub_rn(1.0f, c.fx);
  const float wy = dy ? c.fy : __fsub_rn(1.0f, c.fy);
  const float wz = dz ? c.fz : __fsub_rn(1.0f, c.fz);
  w = __fmul_rn(__fmul_rn(wx, wy), wz);
}

template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&r)[F]) {
  if constexpr (F == 1) {
    r[0] = __ldg(p);
  } else if constexpr (F == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    r[0] = v.x;
    r[1] = v.y;
  } else {
#pragma unroll
    for (int k = 0; k < F; k += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + k));
      r[k] = v.x;
      r[k + 1] = v.y;
      r[k + 2] = v.z;
      r[k + 3] = v.w;
    }
  }
}

template <int F>
__device__ __forceinline__ void store_row(float* __restrict__ p, const float (&r)[F]) {
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

// The vector forms of atomicAdd on global float2/float4 exist for sm_90 from
// CUDA 12.1 on.
#if !defined(__CUDACC_VER_MAJOR__) || __CUDACC_VER_MAJOR__ < 12 || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ < 1)
#error "hash_grid.cu needs CUDA 12.1 or later (atomicAdd on float2/float4)"
#endif

template <int F>
__device__ __forceinline__ void atomic_add_row(float* p, const float (&r)[F]) {
  if constexpr (F == 1) {
    atomicAdd(p, r[0]);
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(r[0], r[1]));
  } else {
#pragma unroll
    for (int k = 0; k < F; k += 4)
      atomicAdd(reinterpret_cast<float4*>(p + k), make_float4(r[k], r[k + 1], r[k + 2], r[k + 3]));
  }
}

// H1: out[b, l * F + f] = sum over the 8 corners of w * table[l, idx, f].
template <int F>
__global__ void __launch_bounds__(kThreads)
    hash_lookup_kernel(const float* __restrict__ pos, const float* __restrict__ table, int n,
                       int levels, int log2_size, Levels lv, float* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(n) * levels) return;
  const int b = static_cast<int>(t / levels);
  const int l = static_cast<int>(t - static_cast<int64_t>(b) * levels);
  const Cell c = cell_of(pos, b, lv.res[l]);
  const bool dense = (lv.dense >> l) & 1u;
  const uint32_t mask = (1u << log2_size) - 1u;
  const float* level_rows = table + (static_cast<int64_t>(l) << log2_size) * F;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int idx;
    float w;
    corner(c, k, dense, lv.verts[l], mask, idx, w);
    float row[F];
    load_row<F>(level_rows + static_cast<int64_t>(idx) * F, row);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w, row[f]));
  }
  store_row<F>(out + t * F, acc);
}

// H2: dtable[l, idx, f] += w * g[b, l * F + f] for the 8 corners of each
// (query, level). g's rows are ld floats apart.
template <int F>
__global__ void __launch_bounds__(kThreads)
    hash_adjoint_kernel(const float* __restrict__ pos, const float* __restrict__ g, int64_t ld,
                        int n, int levels, int log2_size, Levels lv, float* dtable) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(n) * levels) return;
  const int b = static_cast<int>(t / levels);
  const int l = static_cast<int>(t - static_cast<int64_t>(b) * levels);
  float gl[F];
#pragma unroll
  for (int f = 0; f < F; ++f) gl[f] = __ldg(g + b * ld + l * F + f);
  const Cell c = cell_of(pos, b, lv.res[l]);
  const bool dense = (lv.dense >> l) & 1u;
  const uint32_t mask = (1u << log2_size) - 1u;
  float* level_rows = dtable + (static_cast<int64_t>(l) << log2_size) * F;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int idx;
    float w;
    corner(c, k, dense, lv.verts[l], mask, idx, w);
    float upd[F];
#pragma unroll
    for (int f = 0; f < F; ++f) upd[f] = __fmul_rn(w, gl[f]);
    atomic_add_row<F>(level_rows + static_cast<int64_t>(idx) * F, upd);
  }
}

bool make_levels(int levels, int log2_size, int features, const int* res, int dense_mask,
                 Levels& lv) {
  if (levels < 1 || levels > kMaxLevels || log2_size < 1 || log2_size > 30) return false;
  if (features != 1 && features != 2 && features != 4 && features != 8) return false;
  for (int l = 0; l < levels; ++l) {
    lv.res[l] = static_cast<float>(res[l]);
    lv.verts[l] = res[l] + 1;
  }
  lv.dense = static_cast<uint32_t>(dense_mask);
  return true;
}

unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int nrc_hash_lookup(const float* pos, const float* table, int n, int levels,
                               int log2_size, int features, const int* res, int dense_mask,
                               float* out, void* stream) {
  Levels lv;
  if (!make_levels(levels, log2_size, features, res, dense_mask, lv)) return cudaErrorInvalidValue;
  const unsigned blocks = blocks_for(static_cast<int64_t>(n) * levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (features) {
    case 1: hash_lookup_kernel<1><<<blocks, kThreads, 0, s>>>(pos, table, n, levels, log2_size, lv, out); break;
    case 2: hash_lookup_kernel<2><<<blocks, kThreads, 0, s>>>(pos, table, n, levels, log2_size, lv, out); break;
    case 4: hash_lookup_kernel<4><<<blocks, kThreads, 0, s>>>(pos, table, n, levels, log2_size, lv, out); break;
    default: hash_lookup_kernel<8><<<blocks, kThreads, 0, s>>>(pos, table, n, levels, log2_size, lv, out); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nrc_hash_adjoint(const float* pos, const float* g, long long ld, int n, int levels,
                                int log2_size, int features, const int* res, int dense_mask,
                                float* dtable, void* stream) {
  Levels lv;
  if (!make_levels(levels, log2_size, features, res, dense_mask, lv)) return cudaErrorInvalidValue;
  const unsigned blocks = blocks_for(static_cast<int64_t>(n) * levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t stride = static_cast<int64_t>(ld);
  switch (features) {
    case 1: hash_adjoint_kernel<1><<<blocks, kThreads, 0, s>>>(pos, g, stride, n, levels, log2_size, lv, dtable); break;
    case 2: hash_adjoint_kernel<2><<<blocks, kThreads, 0, s>>>(pos, g, stride, n, levels, log2_size, lv, dtable); break;
    case 4: hash_adjoint_kernel<4><<<blocks, kThreads, 0, s>>>(pos, g, stride, n, levels, log2_size, lv, dtable); break;
    default: hash_adjoint_kernel<8><<<blocks, kThreads, 0, s>>>(pos, g, stride, n, levels, log2_size, lv, dtable); break;
  }
  return static_cast<int>(cudaGetLastError());
}
