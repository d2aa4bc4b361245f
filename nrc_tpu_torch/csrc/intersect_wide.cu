// Wide-BVH traversal, one thread per ray with its own stack.
//
// Stands where the JAX package's lockstep walk stands:
//   nrc_wbvh_closest <- nrc_tpu/ops/intersect_wide.py::intersect_wbvh
//   nrc_wbvh_any     <- nrc_tpu/ops/intersect_wide.py::occluded_wbvh
// No TPU kernel stood there: on the TPU the walk is an XLA while loop whose
// every step fetches one row per ray for all rays together and keeps a dense
// [N, D, B] stack updated by one-hot selects. On this card a ray is a thread:
// a data-dependent loop with a private stack, no lockstep and no selects.
//
// The table (ops/bvh_wide.py) holds W node rows, then the leaf rows, P floats
// each. Node row: component-major child boxes lox*B | loy*B | loz*B | hix*B |
// hiy*B | hiz*B, then B child metas as bit-cast int32 (meta >= 0: node row;
// meta < 0: leaf row W + ~meta; INT32_MIN: empty slot). Leaf row:
// component-major p0 | e1 | e2 columns of leaf_size triangles, then leaf_size
// primitive ids (-1 = padding).
//
// What it reproduces from the plain walk (ops/intersect_wide.py), so that the
// closest t agrees bit for bit: inv_d with 3e38 for |d| <= 1e-20; a dead ray
// (tmax <= tmin) reports no hit; a child is entered when max(near, tmin) <=
// min(far, min(tmax, best_t)), inclusive, tested once when its node is
// visited; empty slots are masked by meta, never by their inverted box;
// children are visited nearest first, ordered by the same Batcher network;
// Möller-Trumbore with |det| > 1e-12, u >= 0, v >= 0, u + v <= 1, tmin < t <
// cap in the plain version's operation order; a leaf's winner (lowest slot
// on ties) replaces the best only when t < cap. The file is built with
// -fmad=false and without --use_fast_math: no contraction into FMA, IEEE
// division. The any-hit entry stops at the first hit.
//
// What bounds it on an H100: bytes, and before that latency. A ray fetches
// one 4 P-byte row per step (640 bytes at B = leaf_size = 16), a few dozen
// steps per ray, each depending on the last; the table of the port's large
// scene (about 10 MB) stays in the 50 MB L2. The design keeps a whole step in
// registers: the row is read with 16-byte loads straight into the slab or
// triangle test, the B (key, meta) pairs are sorted by a fully unrolled
// network, and only the stack lives in local memory. The stack is flat: the
// hit children are pushed farthest first, so a pop takes the nearest, which
// visits rows in the same order as the plain walk's per-level child sets. It
// holds at most (B - 1) * D + 1 entries for a tree of D levels; the wrapper
// raises when that exceeds kMaxStack. Sorting rays for coherence, sharing a
// node fetch across a warp and a persistent ray queue are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStack = 256;     // ops/intersect_wide_cuda.py::MAX_STACK
constexpr int kMaxLeaf = 64;       // leaf_size bound, multiple of 4
constexpr float kRtMax = 3.0e38f;  // nrc_tpu.ops.intersect.RT_MAX
constexpr int kNone = INT32_MIN;   // empty child slot

#define NRC_CSWAP(i, j)                     \
  {                                         \
    const bool swap = key[j] < key[i];      \
    const float ki = key[i], kj = key[j];   \
    const int vi = val[i], vj = val[j];     \
    key[i] = swap ? kj : ki;                \
    key[j] = swap ? ki : kj;                \
    val[i] = swap ? vj : vi;                \
    val[j] = swap ? vi : vj;                \
  }

// Batcher odd-even mergesort networks (ops/intersect_wide.py::_batcher_network)
#define NRC_NET8                                                                    \
  NRC_CSWAP(0, 1) NRC_CSWAP(2, 3) NRC_CSWAP(0, 2) NRC_CSWAP(1, 3) NRC_CSWAP(1, 2)   \
  NRC_CSWAP(4, 5) NRC_CSWAP(6, 7) NRC_CSWAP(4, 6) NRC_CSWAP(5, 7) NRC_CSWAP(5, 6)   \
  NRC_CSWAP(0, 4) NRC_CSWAP(2, 6) NRC_CSWAP(2, 4) NRC_CSWAP(1, 5) NRC_CSWAP(3, 7)   \
  NRC_CSWAP(3, 5) NRC_CSWAP(1, 2) NRC_CSWAP(3, 4) NRC_CSWAP(5, 6)

#define NRC_NET16                                                                          \
  NRC_CSWAP(0, 1) NRC_CSWAP(2, 3) NRC_CSWAP(0, 2) NRC_CSWAP(1, 3) NRC_CSWAP(1, 2)          \
  NRC_CSWAP(4, 5) NRC_CSWAP(6, 7) NRC_CSWAP(4, 6) NRC_CSWAP(5, 7) NRC_CSWAP(5, 6)          \
  NRC_CSWAP(0, 4) NRC_CSWAP(2, 6) NRC_CSWAP(2, 4) NRC_CSWAP(1, 5) NRC_CSWAP(3, 7)          \
  NRC_CSWAP(3, 5) NRC_CSWAP(1, 2) NRC_CSWAP(3, 4) NRC_CSWAP(5, 6) NRC_CSWAP(8, 9)          \
  NRC_CSWAP(10, 11) NRC_CSWAP(8, 10) NRC_CSWAP(9, 11) NRC_CSWAP(9, 10) NRC_CSWAP(12, 13)   \
  NRC_CSWAP(14, 15) NRC_CSWAP(12, 14) NRC_CSWAP(13, 15) NRC_CSWAP(13, 14) NRC_CSWAP(8, 12) \
  NRC_CSWAP(10, 14) NRC_CSWAP(10, 12) NRC_CSWAP(9, 13) NRC_CSWAP(11, 15) NRC_CSWAP(11, 13) \
  NRC_CSWAP(9, 10) NRC_CSWAP(11, 12) NRC_CSWAP(13, 14) NRC_CSWAP(0, 8) NRC_CSWAP(4, 12)    \
  NRC_CSWAP(4, 8) NRC_CSWAP(2, 10) NRC_CSWAP(6, 14) NRC_CSWAP(6, 10) NRC_CSWAP(2, 4)       \
  NRC_CSWAP(6, 8) NRC_CSWAP(10, 12) NRC_CSWAP(1, 9) NRC_CSWAP(5, 13) NRC_CSWAP(5, 9)       \
  NRC_CSWAP(3, 11) NRC_CSWAP(7, 15) NRC_CSWAP(7, 11) NRC_CSWAP(3, 5) NRC_CSWAP(7, 9)       \
  NRC_CSWAP(11, 13) NRC_CSWAP(1, 2) NRC_CSWAP(3, 4) NRC_CSWAP(5, 6) NRC_CSWAP(7, 8)        \
  NRC_CSWAP(9, 10) NRC_CSWAP(11, 12) NRC_CSWAP(13, 14)

__device__ __forceinline__ float inv_component(float d) {
  return fabsf(d) > 1e-20f ? 1.0f / d : 3.0e38f;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tn, tf;
};

// Möller-Trumbore for one triangle of a leaf, in the operation order of
// ops/intersect_wide.py::_leaf_tri_t. Returns t, or kRtMax for no hit.
__device__ __forceinline__ float tri_t(const Ray& r, float cap, int pid, float p0x, float p0y,
                                       float p0z, float e1x, float e1y, float e1z, float e2x,
                                       float e2y, float e2z) {
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = (e1x * pvx + e1y * pvy) + e1z * pvz;
  const bool nondeg = fabsf(det) > 1e-12f;
  const float invd = nondeg ? 1.0f / det : 0.0f;
  const float tvx = r.ox - p0x;
  const float tvy = r.oy - p0y;
  const float tvz = r.oz - p0z;
  const float u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * invd;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = ((r.dx * qvx + r.dy * qvy) + r.dz * qvz) * invd;
  const float t = ((e2x * qvx + e2y * qvy) + e2z * qvz) * invd;
  const bool ok = nondeg && pid >= 0 && u >= 0.0f && v >= 0.0f && (u + v) <= 1.0f && t > r.tn &&
                  t < cap;
  return ok ? t : kRtMax;
}

template <int B, bool kAnyHit>
__global__ void __launch_bounds__(kThreads) wbvh_kernel(
    const float* __restrict__ org, const float* __restrict__ dir, const float* __restrict__ tmin,
    const float* __restrict__ tmax, const float* __restrict__ rows, int num_rays, int row_words,
    int num_nodes, int leaf_size, float* __restrict__ t_out, int* __restrict__ prim_out) {
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  if (ray >= num_rays) return;
  Ray r;
  r.ox = org[3 * ray + 0];
  r.oy = org[3 * ray + 1];
  r.oz = org[3 * ray + 2];
  r.dx = dir[3 * ray + 0];
  r.dy = dir[3 * ray + 1];
  r.dz = dir[3 * ray + 2];
  r.tn = tmin[ray];
  r.tf = tmax[ray];
  float best_t = kRtMax;
  int best = -1;

  if (!(r.tf <= r.tn)) {  // a dead ray (tmax <= tmin) reports no hit
    const float ix = inv_component(r.dx);
    const float iy = inv_component(r.dy);
    const float iz = inv_component(r.dz);
    int stack[kMaxStack];
    int sp = 0;
    stack[sp++] = 0;  // the root's row
    while (sp > 0) {
      const int entry = stack[--sp];
      const float cap = fminf(r.tf, best_t);
      if (entry >= 0) {
        // ---- node: slab-test the B children, sort by entry distance ------
        const float4* row = reinterpret_cast<const float4*>(rows + static_cast<size_t>(entry) * row_words);
        float key[B];
        int val[B];
#pragma unroll
        for (int g = 0; g < B / 4; ++g) {
          const float4 lx = row[0 * (B / 4) + g], ly = row[1 * (B / 4) + g], lz = row[2 * (B / 4) + g];
          const float4 hx = row[3 * (B / 4) + g], hy = row[4 * (B / 4) + g], hz = row[5 * (B / 4) + g];
          const float4 mf = row[6 * (B / 4) + g];
          const float lox[4] = {lx.x, lx.y, lx.z, lx.w}, loy[4] = {ly.x, ly.y, ly.z, ly.w};
          const float loz[4] = {lz.x, lz.y, lz.z, lz.w}, hix[4] = {hx.x, hx.y, hx.z, hx.w};
          const float hiy[4] = {hy.x, hy.y, hy.z, hy.w}, hiz[4] = {hz.x, hz.y, hz.z, hz.w};
          const int meta[4] = {__float_as_int(mf.x), __float_as_int(mf.y), __float_as_int(mf.z),
                               __float_as_int(mf.w)};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float t0x = (lox[k] - r.ox) * ix, t1x = (hix[k] - r.ox) * ix;
            const float t0y = (loy[k] - r.oy) * iy, t1y = (hiy[k] - r.oy) * iy;
            const float t0z = (loz[k] - r.oz) * iz, t1z = (hiz[k] - r.oz) * iz;
            const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
            const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
            const bool ok = fmaxf(tnear, r.tn) <= fminf(tfar, cap) && meta[k] != kNone;
            key[4 * g + k] = ok ? tnear : INFINITY;
            val[4 * g + k] = ok ? meta[k] : kNone;
          }
        }
        if constexpr (B == 8) {
          NRC_NET8
        } else {
          NRC_NET16
        }
        // farthest first, so that the next pop takes the nearest child
#pragma unroll
        for (int j = B - 1; j >= 0; --j) {
          if (val[j] != kNone) stack[sp++] = val[j];
        }
      } else {
        // ---- leaf: test its triangles, lowest slot wins a tie -------------
        const float* row = rows + static_cast<size_t>(num_nodes + ~entry) * row_words;
        const float4* row4 = reinterpret_cast<const float4*>(row);
        const int groups = leaf_size >> 2;
        float leaf_t = kRtMax;
        int leaf_prim = -1;
        for (int g = 0; g < groups; ++g) {
          float4 c[9];
#pragma unroll
          for (int k = 0; k < 9; ++k) c[k] = row4[k * groups + g];
          const float4 idf = row4[9 * groups + g];
          const int pid[4] = {__float_as_int(idf.x), __float_as_int(idf.y), __float_as_int(idf.z),
                              __float_as_int(idf.w)};
          const float t4[4] = {
              tri_t(r, cap, pid[0], c[0].x, c[1].x, c[2].x, c[3].x, c[4].x, c[5].x, c[6].x, c[7].x, c[8].x),
              tri_t(r, cap, pid[1], c[0].y, c[1].y, c[2].y, c[3].y, c[4].y, c[5].y, c[6].y, c[7].y, c[8].y),
              tri_t(r, cap, pid[2], c[0].z, c[1].z, c[2].z, c[3].z, c[4].z, c[5].z, c[6].z, c[7].z, c[8].z),
              tri_t(r, cap, pid[3], c[0].w, c[1].w, c[2].w, c[3].w, c[4].w, c[5].w, c[6].w, c[7].w, c[8].w)};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (t4[k] < leaf_t) {
              leaf_t = t4[k];
              leaf_prim = pid[k];
            }
          }
        }
        if (leaf_t < cap) {
          best_t = leaf_t;
          best = leaf_prim;
          if (kAnyHit) break;
        }
      }
    }
  }
  t_out[ray] = best_t;
  prim_out[ray] = best;
}

template <bool kAnyHit>
int launch(const float* org, const float* dir, const float* tmin, const float* tmax,
           const float* rows, int num_rays, int row_words, int num_nodes, int branch,
           int leaf_size, float* t_out, int* prim_out, void* stream) {
  // the 16-byte row loads need rows of whole float4s; the wrapper checks too
  if (row_words % 4 || leaf_size % 4 || leaf_size <= 0 || leaf_size > kMaxLeaf ||
      row_words < 7 * branch || row_words < 10 * leaf_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (num_rays + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (branch == 8) {
    wbvh_kernel<8, kAnyHit><<<blocks, kThreads, 0, s>>>(org, dir, tmin, tmax, rows, num_rays,
                                                       row_words, num_nodes, leaf_size, t_out,
                                                       prim_out);
  } else if (branch == 16) {
    wbvh_kernel<16, kAnyHit><<<blocks, kThreads, 0, s>>>(org, dir, tmin, tmax, rows, num_rays,
                                                        row_words, num_nodes, leaf_size, t_out,
                                                        prim_out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nrc_wbvh_closest(const float* org, const float* dir, const float* tmin,
                                const float* tmax, const float* rows, int num_rays, int row_words,
                                int num_nodes, int branch, int leaf_size, float* t_out,
                                int* prim_out, void* stream) {
  return launch<false>(org, dir, tmin, tmax, rows, num_rays, row_words, num_nodes, branch,
                       leaf_size, t_out, prim_out, stream);
}

extern "C" int nrc_wbvh_any(const float* org, const float* dir, const float* tmin,
                            const float* tmax, const float* rows, int num_rays, int row_words,
                            int num_nodes, int branch, int leaf_size, float* t_out, int* prim_out,
                            void* stream) {
  return launch<true>(org, dir, tmin, tmax, rows, num_rays, row_words, num_nodes, branch,
                      leaf_size, t_out, prim_out, stream);
}
