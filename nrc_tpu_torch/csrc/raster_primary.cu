// R1: the tiled primary raster. Every pixel's first hit in (0, RT_MAX)
// against the candidate triangles binned to its screen tile.
//
// Stands where the JAX package's dense per-tile test stands:
//   nrc_raster_closest      <- nrc_tpu/ops/raster_primary.py::raster_closest_hit
// No TPU kernel stood there: on the TPU the test is XLA code over
// [tiles, tile^2, K] blocks, a group of tiles at a time.
//
// Inputs (ops/raster_primary.py): the binned triangle rows [S, 9]
// (p0 | e1 | e2), ids [S] (-1 in pad slots) and boxes [S] (the pixels of the
// triangle's padded box in the tile, a byte an edge: x0 | x1 << 8 | y0 << 16
// | y1 << 24), tile-major, each tile's candidates in ascending id at the
// front of its K slots; and the block table [B, 4], one row per chunk of
// kChunk slots of a tile: the chunk's first slot, its real candidates (0 for
// a chunk of pad slots, and for the pad rows the table is held with), the
// tile's screen origin. The rays are the frame's pixel-linear [W*H, 3]
// origins and directions; a pixel's lane is found from the origin, so no
// permutation is read. A pair is tested where the pixel is in the slot's
// box, as the plain version does.
//
// What bounds it on an H100: on 320x320 cornell_objects the tiles hold
// 207,977 real candidates, 53.2 M (pixel, candidate) pairs, but the boxes
// only 2.93 M of them (about 14 pixels a candidate), so the work is small
// and uneven: one tile holds 12,983 candidates, most a few hundred. The
// design:
// - split-K: a block takes one chunk of kChunk slots of a tile, so a
//   crowded tile spreads over many blocks and SMs;
// - the chunk's rows, ids and boxes and the tile's rays are staged once in
//   shared memory (rows component-major, padded by a word against bank
//   conflicts);
// - the block's pairs are the pixels of its candidates' boxes, numbered
//   candidate by candidate (an exclusive scan of the boxes' areas by one
//   warp); thread i takes pairs i, i + blockDim, ... and finds its
//   candidate by a binary search of the offsets, so every lane tests a
//   pair that counts. Two earlier designs gave a thread a pixel and looped
//   over the chunk: every pixel of the tile against every candidate
//   (0.171 ms), then a warp's 8 x 4 patch against the boxes with a ballot
//   (0.088 ms; most lanes idle for a box of 14 pixels), against W1's 0.058
//   for the same rays (NVIDIA H100 80GB HBM3, 700 W);
// - a pixel's hits meet in a 64-bit atomicMin on (bits of t) << 32 | id in
//   shared memory, then the chunks of a pixel in one such atomicMin in
//   global memory: t > 0, so its bits order as its value, and at equal t
//   the lower id wins, the first slot of the plain version's argmin. The
//   result does not depend on the order of the pairs or of the blocks. A
//   finishing pass turns the untouched ~0 into RT_MAX / -1 and writes t
//   and a 64-bit id.
// The test is Möller-Trumbore in the plain version's operation order
// (csrc/moller_trumbore.cuh, W1's), built with -fmad=false: t bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "moller_trumbore.cuh"

namespace {

constexpr int kChunk = 128;        // candidate slots a block takes; ops/raster_primary.py::CHUNK
constexpr int kMaxTile = 24;       // ops/raster_primary.py::TILES' largest edge
constexpr int kMaxThreads = 576;   // kMaxTile^2, a thread a pixel of the tile for the staging
constexpr int kRowStride = kChunk + 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;
static_assert(kChunk == 32 * 4, "the offsets' scan gives a lane of one warp 4 candidates");

using nrc_mt::kRtMax;
using nrc_mt::Ray;
using nrc_mt::tri_t;

// The threads a block of this tile runs: a whole number of warps.
__host__ __device__ inline int block_threads(int tile) { return (tile * tile + 31) / 32 * 32; }

// The pixels of a box (x0 | x1 << 8 | y0 << 16 | y1 << 24, inside the tile).
__device__ __forceinline__ int box_area(unsigned box) {
  return static_cast<int>(((box >> 8) & 255u) - (box & 255u) + 1u) *
         static_cast<int>((box >> 24) - ((box >> 16) & 255u) + 1u);
}

__global__ void __launch_bounds__(kMaxThreads)
raster_kernel(const float* __restrict__ org, const float* __restrict__ dir,
              const float* __restrict__ rows, const int* __restrict__ pids,
              const unsigned* __restrict__ boxes, const int4* __restrict__ blocks, int width,
              int tile, unsigned long long* __restrict__ best) {
  __shared__ float s_tri[9 * kRowStride];
  __shared__ int s_pid[kChunk];
  __shared__ unsigned s_box[kChunk];
  __shared__ int s_off[kChunk];  // the first pair of each candidate
  __shared__ int s_total;
  __shared__ float s_ray[6 * kMaxThreads];  // the tile's origins and directions, component-major
  __shared__ unsigned long long s_best[kMaxThreads];
  const int4 b = blocks[blockIdx.x];  // first slot, real candidates, x0, y0
  const int n = b.y;
  if (n <= 0) return;  // the same for the whole block
  const int tid = threadIdx.x;
  const float* src = rows + static_cast<size_t>(b.x) * 9;
  for (int i = tid; i < 9 * n; i += blockDim.x) {
    s_tri[(i % 9) * kRowStride + i / 9] = src[i];
  }
  for (int i = tid; i < n; i += blockDim.x) {
    s_pid[i] = pids[b.x + i];
    s_box[i] = boxes[b.x + i];
  }
  const int pixels = tile * tile;
  const int pix = (b.w + tid / tile) * width + b.z + tid % tile;  // this thread's pixel, row order
  if (tid < pixels) {
    for (int c = 0; c < 3; ++c) {
      s_ray[c * kMaxThreads + tid] = org[3 * pix + c];
      s_ray[(3 + c) * kMaxThreads + tid] = dir[3 * pix + c];
    }
    s_best[tid] = kEmpty;
  }
  __syncthreads();

  if (tid < 32) {  // the exclusive scan of the boxes' areas, 4 candidates a lane
    int area[4];
    int sum = 0;
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * tid + e;
      area[e] = i < n ? box_area(s_box[i]) : 0;
      sum += area[e];
    }
    int incl = sum;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (tid >= d) incl += v;
    }
    int off = incl - sum;
    for (int e = 0; e < 4; ++e) {
      s_off[4 * tid + e] = off;
      off += area[e];
    }
    if (tid == 31) s_total = incl;
  }
  __syncthreads();

  const int total = s_total;
  for (int p = tid; p < total; p += blockDim.x) {
    int lo = 0, hi = n - 1;  // the last candidate whose first pair is at or before p
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_off[mid] <= p) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const int k = lo;
    const unsigned box = s_box[k];
    const int x0 = static_cast<int>(box & 255u);
    const int w = static_cast<int>((box >> 8) & 255u) - x0 + 1;
    const int q = p - s_off[k];
    const int l = (static_cast<int>((box >> 16) & 255u) + q / w) * tile + x0 + q % w;
    Ray r;
    r.ox = s_ray[l];
    r.oy = s_ray[kMaxThreads + l];
    r.oz = s_ray[2 * kMaxThreads + l];
    r.dx = s_ray[3 * kMaxThreads + l];
    r.dy = s_ray[4 * kMaxThreads + l];
    r.dz = s_ray[5 * kMaxThreads + l];
    r.tn = 0.0f;
    r.tf = kRtMax;
    const float t = tri_t(r, kRtMax, s_pid[k], s_tri[k], s_tri[kRowStride + k],
                          s_tri[2 * kRowStride + k], s_tri[3 * kRowStride + k],
                          s_tri[4 * kRowStride + k], s_tri[5 * kRowStride + k],
                          s_tri[6 * kRowStride + k], s_tri[7 * kRowStride + k],
                          s_tri[8 * kRowStride + k]);
    if (t < kRtMax) {
      atomicMin(s_best + l, (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
                                static_cast<unsigned int>(s_pid[k]));
    }
  }
  __syncthreads();
  if (tid < pixels && s_best[tid] != kEmpty) atomicMin(best + pix, s_best[tid]);
}

__global__ void raster_finish_kernel(const unsigned long long* __restrict__ best, int n,
                                     float* __restrict__ t_out, long long* __restrict__ prim_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long v = best[i];
  const bool hit = v != kEmpty;
  t_out[i] = hit ? __uint_as_float(static_cast<unsigned int>(v >> 32)) : kRtMax;
  prim_out[i] = hit ? static_cast<long long>(static_cast<int>(v & 0xffffffffu)) : -1;
}

}  // namespace

// One raster over the whole W x H grid: best [W*H] is scratch, t_out [W*H]
// and prim_out [W*H] (int64) the result. Returns cudaGetLastError().
extern "C" int nrc_raster_closest(const float* org, const float* dir, const float* rows,
                                  const int* pids, const int* boxes, const int* blocks,
                                  int num_blocks, int width, int height, int tile,
                                  unsigned long long* best, float* t_out, long long* prim_out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = width * height;
  if (tile <= 0 || tile > kMaxTile) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(best, 0xff, sizeof(unsigned long long) * n, s);
  if (err != cudaSuccess) return err;
  if (num_blocks > 0) {
    raster_kernel<<<num_blocks, block_threads(tile), 0, s>>>(
        org, dir, rows, pids, reinterpret_cast<const unsigned*>(boxes),
        reinterpret_cast<const int4*>(blocks), width, tile, best);
  }
  raster_finish_kernel<<<(n + 255) / 256, 256, 0, s>>>(best, n, t_out, prim_out);
  return cudaGetLastError();
}
