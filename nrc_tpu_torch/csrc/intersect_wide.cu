// Wide-BVH traversal: live rays compacted in the kernel, a group of B lanes
// per ray (B = the tree's branch), the group's stack in shared memory. The
// walk is instantiated with the triangle leaf test (W1/W2); the curve walks
// C1/C2 over round-cone segments have a design of their own
// (csrc/intersect_curves.cu).
//
// Stands where the JAX package's lockstep walk stands:
//   nrc_wbvh_closest        <- nrc_tpu/ops/intersect_wide.py::intersect_wbvh
//   nrc_wbvh_any            <- nrc_tpu/ops/intersect_wide.py::occluded_wbvh
// No TPU kernel stood there: on the TPU the walk is an XLA while loop whose
// every step fetches one row per ray for all rays together and keeps a dense
// [N, D, B] stack updated by one-hot selects.
//
// The table (ops/bvh_wide.py) holds W node rows, then the leaf rows, P floats
// each. Node row: component-major child boxes lox*B | loy*B | loz*B | hix*B |
// hiy*B | hiz*B, then B child metas as bit-cast int32 (meta >= 0: node row;
// meta < 0: leaf row W + ~meta; INT32_MIN: empty slot). Leaf row:
// component-major columns of leaf_size primitives, 9 floats each (a triangle's
// p0 | e1 | e2), then leaf_size primitive ids (-1 = padding).
//
// What it reproduces from the plain walk (ops/intersect_wide.py), so that the
// closest t agrees bit for bit: inv_d with 3e38 for |d| <= 1e-20; a dead ray
// (tmax <= tmin) reports no hit; a child is entered when max(near, tmin) <=
// min(far, min(tmax, best_t)), inclusive, tested once when its node is
// visited; empty slots are masked by meta, never by their inverted box;
// Möller-Trumbore with |det| > 1e-12, u >= 0, v >= 0, u + v <= 1, tmin < t <
// cap in the plain version's operation order; a leaf's winner (lowest slot on
// ties) replaces the best only when t < cap. The closest-hit entry visits
// the hit children nearest first, ties by slot (the plain walk's network
// orders equal keys its own way: only the winner between triangles at the
// same t can differ). The file is built with -fmad=false and without
// --use_fast_math: no contraction into FMA, IEEE division. The any-hit entry
// stops at the first hit.
//
// What bounds it on an H100: the latency of each ray's chain of dependent
// row fetches, not bytes. The 9.4 MB table of the port's large scene stays
// in the 50 MB L2 and a launch reads a few thousand distinct rows; a ray
// fetches one row per step, each step's address comes from the last, and a
// frame's launches hold a few thousand live rays among 25,600-102,400 lanes,
// so a launch lasts as long as its longest chains. The design shortens each
// step of a chain:
// - a block compacts the live rays of its span of kSpan = 32 lanes with
//   one ballot of its first warp (csrc/intersect_planes.cu compacts with a
//   ballot and a prefix); dead lanes write the miss and leave, and the grid
//   depends on the lane count alone (the frame's CUDA graph stays as it is);
// - B lanes walk one ray: at a node lane k reads child k's seven words (the
//   component-major row makes them seven coalesced reads of 4 B bytes) and
//   slab-tests it, a ballot gives the hit set, and only the hits are ordered,
//   by rank (count of nearer hits, ties by slot), not by a 16-key network; at
//   a leaf lane k tests triangles k, k + B, ... and shuffles give the (t,
//   slot) minimum, the lowest slot winning a tie;
// - the stack is the group's row of a shared-memory array (kStack entries;
//   a tree of D levels needs at most (B - 1) * D + 1, which the wrapper
//   checks): the nearest hit child goes straight to the next step, the
//   others are pushed farthest first;
// - a group whose ray is done takes the block's next live ray from a shared
//   counter, so that no group waits on another's slowest ray;
// - the any-hit entry pushes its hit children in slot order: any order finds
//   the same occlusion.
// Each choice was timed against its alternative on the card (a span of 64
// or 128 lanes, groups with fixed rays, the any-hit entry nearest first, the
// two groups of a warp in lockstep, registers capped for full occupancy):
// each alternative was slower.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "moller_trumbore.cuh"

namespace {

constexpr int kThreads = 128;        // a block: four warps
constexpr int kSpan = 32;            // lanes a block compacts: one ballot of warp 0
constexpr int kStack = 256;          // stack entries a group; ops/intersect_wide_cuda.py::MAX_STACK
constexpr int kMaxLeaf = 64;         // leaf_size bound, multiple of 4
constexpr float kRtMax = 3.0e38f;    // nrc_tpu.ops.intersect.RT_MAX
constexpr int kNone = INT32_MIN;     // empty child slot

__device__ __forceinline__ float inv_component(float d) {
  return fabsf(d) > 1e-20f ? 1.0f / d : 3.0e38f;
}

// The triangle test (csrc/moller_trumbore.cuh), shared with R1.
using nrc_mt::Ray;
using nrc_mt::tri_t;

// The leaf test as a type the walk is instantiated with: it reads a
// primitive's 9 component-major columns (stride leaf_size) from c.
struct TriLeaf {
  static __device__ __forceinline__ float test(const Ray& r, float cap, int pid, const float* c,
                                               int ls) {
    return tri_t(r, cap, pid, __ldg(c), __ldg(c + ls), __ldg(c + 2 * ls), __ldg(c + 3 * ls),
                 __ldg(c + 4 * ls), __ldg(c + 5 * ls), __ldg(c + 6 * ls), __ldg(c + 7 * ls),
                 __ldg(c + 8 * ls));
  }
};

// A ray in flight: what the B lanes of its group hold alike.
struct Walk {
  Ray r;
  float ix, iy, iz;
  float best_t;
  int best;
  int sp;     // entries on the group's stack
  int entry;  // the row of the next step
};

__device__ __forceinline__ void start_walk(Walk& w, int ray, const float* __restrict__ org,
                                           const float* __restrict__ dir, const float* __restrict__ tmin,
                                           const float* __restrict__ tmax) {
  w.r.ox = org[3 * ray + 0];
  w.r.oy = org[3 * ray + 1];
  w.r.oz = org[3 * ray + 2];
  w.r.dx = dir[3 * ray + 0];
  w.r.dy = dir[3 * ray + 1];
  w.r.dz = dir[3 * ray + 2];
  w.r.tn = tmin[ray];
  w.r.tf = tmax[ray];
  w.ix = inv_component(w.r.dx);
  w.iy = inv_component(w.r.dy);
  w.iz = inv_component(w.r.dz);
  w.best_t = kRtMax;
  w.best = -1;
  w.sp = 0;
  w.entry = 0;  // the root's row
}

// One step of a group's walk, lane k being the caller's slot: a node or a
// leaf row, then the next entry. Returns false once the ray is done; every
// lane of the group then holds its (best t, best primitive).
template <int B, bool kAnyHit, class Leaf>
__device__ __forceinline__ bool walk_step(Walk& w, const float* __restrict__ rows, int row_words,
                                          int num_nodes, int leaf_size, int k, unsigned gmask,
                                          int lane0, int* stack) {
  const Ray& r = w.r;
  const float cap = fminf(r.tf, w.best_t);
  if (w.entry >= 0) {
    // ---- node: lane k slab-tests child k -----------------------------------
    const float* row = rows + static_cast<size_t>(w.entry) * row_words + k;
    const float lox = __ldg(row + 0 * B), loy = __ldg(row + 1 * B), loz = __ldg(row + 2 * B);
    const float hix = __ldg(row + 3 * B), hiy = __ldg(row + 4 * B), hiz = __ldg(row + 5 * B);
    const int meta = __float_as_int(__ldg(row + 6 * B));
    const float t0x = (lox - r.ox) * w.ix, t1x = (hix - r.ox) * w.ix;
    const float t0y = (loy - r.oy) * w.iy, t1y = (hiy - r.oy) * w.iy;
    const float t0z = (loz - r.oz) * w.iz, t1z = (hiz - r.oz) * w.iz;
    const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    const bool ok = fmaxf(tnear, r.tn) <= fminf(tfar, cap) && meta != kNone;
    const unsigned hits = __ballot_sync(gmask, ok) >> lane0;
    if (hits) {
      const int h = __popc(hits);
      // rank among the hits: nearer ones first, ties by slot; the any-hit
      // entry takes slot order
      int rank = __popc(hits & ((1u << k) - 1u));
      if (!kAnyHit && h > 1) {
        rank = 0;
        for (unsigned m = hits; m; m &= m - 1u) {
          const int j = __ffs(m) - 1;
          const float kj = __shfl_sync(gmask, tnear, j, B);
          rank += (kj < tnear || (kj == tnear && j < k)) ? 1 : 0;
        }
      }
      // the nearest goes straight to the next step; the others onto the
      // stack, farthest first, so that a pop takes the nearest left
      const unsigned first = __ballot_sync(gmask, ok && rank == 0) >> lane0;
      w.entry = __shfl_sync(gmask, meta, __ffs(first) - 1, B);
      if (ok && rank > 0) stack[w.sp + h - 1 - rank] = meta;
      w.sp += h - 1;
      __syncwarp(gmask);
      return true;
    }
  } else {
    // ---- leaf: lane k tests primitives k, k + B, ... -------------------------
    const float* row = rows + static_cast<size_t>(num_nodes + ~w.entry) * row_words;
    float lt = kRtMax;
    int lp = -1;
    int ls = kMaxLeaf;  // above every slot
    for (int tri = k; tri < leaf_size; tri += B) {
      const float* c = row + tri;
      const int pid = __float_as_int(__ldg(c + 9 * leaf_size));
      const float t = Leaf::test(r, cap, pid, c, leaf_size);
      if (t < lt) {
        lt = t;
        lp = pid;
        ls = tri;
      }
    }
    const unsigned hit_lanes = __ballot_sync(gmask, lt < kRtMax) >> lane0;
    if (hit_lanes) {
      if (kAnyHit) {
        const int src = __ffs(hit_lanes) - 1;
        w.best_t = __shfl_sync(gmask, lt, src, B);
        w.best = __shfl_sync(gmask, lp, src, B);
        return false;
      }
      // the (t, slot) minimum over the group: lowest t, lowest slot on ties
#pragma unroll
      for (int off = B / 2; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(gmask, lt, off, B);
        const int os = __shfl_xor_sync(gmask, ls, off, B);
        const int op = __shfl_xor_sync(gmask, lp, off, B);
        if (ot < lt || (ot == lt && os < ls)) {
          lt = ot;
          ls = os;
          lp = op;
        }
      }
      if (lt < cap) {
        w.best_t = lt;
        w.best = lp;
      }
    }
  }
  if (w.sp == 0) return false;
  w.entry = stack[--w.sp];
  return true;
}

template <int B, bool kAnyHit, class Leaf>
__global__ void __launch_bounds__(kThreads) wbvh_kernel(
    const float* __restrict__ org, const float* __restrict__ dir, const float* __restrict__ tmin,
    const float* __restrict__ tmax, const float* __restrict__ rows, int num_rays, int row_words,
    int num_nodes, int leaf_size, float* __restrict__ t_out, int* __restrict__ prim_out) {
  constexpr int kGroups = kThreads / B;
  __shared__ int span_ray[kSpan];           // the span's live rays, in lane order
  __shared__ int stacks[kGroups * kStack];  // a row of kStack entries a group
  __shared__ int span_live;
  __shared__ int next_ray;
  const int lane = threadIdx.x & 31;

  // ---- 1. warp 0 compacts the span's live rays; dead lanes get the miss -----
  if (threadIdx.x < kSpan) {
    const int idx = blockIdx.x * kSpan + threadIdx.x;
    bool live = false;
    if (idx < num_rays) {
      live = !(tmax[idx] <= tmin[idx]);
      if (!live) {
        t_out[idx] = kRtMax;
        prim_out[idx] = -1;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (live) span_ray[__popc(ballot & ((1u << lane) - 1u))] = idx;
    if (lane == 0) {
      span_live = __popc(ballot);
      next_ray = 0;
    }
  }
  __syncthreads();
  const int total = span_live;
  if (total == 0) return;

  // ---- 2. a group of B lanes walks one live ray at a time -------------------
  const int g = threadIdx.x / B;
  const int k = threadIdx.x % B;
  const int lane0 = lane & ~(B - 1);  // the group's first lane in its warp
  const unsigned gmask = (B == 32 ? 0xffffffffu : (1u << B) - 1u) << lane0;
  int* stack = stacks + g * kStack;
  auto take = [&]() {  // the span's next ray for this group
    int v = 0;
    if (k == 0) v = atomicAdd(&next_ray, 1);
    return __shfl_sync(gmask, v, 0, B);
  };
  for (int q = take(); q < total; q = take()) {
    const int ray = span_ray[q];
    Walk w;
    start_walk(w, ray, org, dir, tmin, tmax);
    while (walk_step<B, kAnyHit, Leaf>(w, rows, row_words, num_nodes, leaf_size, k, gmask, lane0, stack)) {
    }
    if (k == 0) {
      t_out[ray] = w.best_t;
      prim_out[ray] = w.best;
    }
  }
}

template <bool kAnyHit, class Leaf>
int launch(const float* org, const float* dir, const float* tmin, const float* tmax,
           const float* rows, int num_rays, int row_words, int num_nodes, int branch,
           int leaf_size, float* t_out, int* prim_out, void* stream) {
  // the layout the wrapper checks (ops/intersect_wide_cuda.py::check_walkable)
  if (row_words % 4 || leaf_size % 4 || leaf_size <= 0 || leaf_size > kMaxLeaf ||
      row_words < 7 * branch || row_words < 10 * leaf_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (num_rays + kSpan - 1) / kSpan;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (branch == 8) {
    wbvh_kernel<8, kAnyHit, Leaf><<<blocks, kThreads, 0, s>>>(org, dir, tmin, tmax, rows, num_rays,
                                                       row_words, num_nodes, leaf_size, t_out,
                                                       prim_out);
  } else if (branch == 16) {
    wbvh_kernel<16, kAnyHit, Leaf><<<blocks, kThreads, 0, s>>>(org, dir, tmin, tmax, rows, num_rays,
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
  return launch<false, TriLeaf>(org, dir, tmin, tmax, rows, num_rays, row_words, num_nodes, branch,
                                leaf_size, t_out, prim_out, stream);
}

extern "C" int nrc_wbvh_any(const float* org, const float* dir, const float* tmin,
                            const float* tmax, const float* rows, int num_rays, int row_words,
                            int num_nodes, int branch, int leaf_size, float* t_out, int* prim_out,
                            void* stream) {
  return launch<true, TriLeaf>(org, dir, tmin, tmax, rows, num_rays, row_words, num_nodes, branch,
                               leaf_size, t_out, prim_out, stream);
}
