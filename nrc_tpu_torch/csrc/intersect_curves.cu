// C1/C2: the curve walks. The wide-BVH walk over round-cone curve segments,
// designed for the H100 from its readings on the cornell_hair frame.
//
// Stands where the JAX package's lockstep walk stands:
//   nrc_wbvh_curves_closest <- nrc_tpu/ops/intersect_wide.py::intersect_curves_wbvh
//   nrc_wbvh_curves_any     <- nrc_tpu/ops/intersect_wide.py::occluded_curves_wbvh
// No TPU kernel stood there: on the TPU the walk is an XLA while loop whose
// every step fetches one row per ray for all rays together.
//
// The table is the layout of csrc/intersect_wide.cu (ops/bvh_wide.py) at the
// curve tree's sizes (ops/curve_intersect.py::build_wide_curve_bvh): branch 8,
// leaf 8, rows of 80 words. Node row: child boxes lox*8 | loy*8 | loz*8 |
// hix*8 | hiy*8 | hiz*8, then 8 metas as bit-cast int32 (>= 0: node row;
// < 0: leaf row W + ~meta; INT32_MIN: empty slot). Leaf row: the columns
// pa | ba | ra, rb, m0 of 8 segments (ba = pb - pa, m0 = |ba|^2), then 8 ids
// (-1 = padding). Both kinds hold slot k's word c at c * 8 + k, so a lane
// reads its child or its segment with the same ten loads.
//
// What it reproduces from the plain walk (ops/intersect_wide.py::
// wide_traverse_plain with leaf="cone"), so that the closest hit agrees bit
// for bit: inv_d with 3e38 for |d| <= 1e-20; a dead ray (tmax <= tmin)
// reports no hit; a child is entered when max(near, tmin) <= min(far,
// min(tmax, best_t)), inclusive; empty slots are masked by meta; the
// round-cone test of _leaf_cone_t in its operation order (+ - * / and sqrt
// alone, correctly rounded here and on the CPU; the file is built with
// -fmad=false and without --use_fast_math); a leaf's best replaces the ray's
// only when t < cap. The closest-hit entry visits rows in the plain walk's
// order at every width, with the plain walk's cap at each row, so its t,
// its winner and its stack are the plain walk's: the culling is not
// conservative (a cone's rounded t can lie before its box's rounded entry),
// and another order can lose the closest cone. The any-hit entry stops at
// its first hit, and its cap is tmax throughout: any order finds the same
// occlusion.
//
// What bounds it on an H100: the latency of each ray's chain of dependent
// row fetches, and in the dense launches the instructions a step issues. The
// 20 MB table of cornell_hair stays in the 50 MB L2 (a launch after a 256 MiB
// read takes 8-10 % longer); a frame's launches hold 1,867-102,400 live rays
// among 25,600-102,400 lanes, and a sparse launch lasts as long as its
// longest chains (48-81 rows), at about a microsecond a dependent step
// (PERF.md §6). The design, each part timed on the card against its
// alternative (tools/bench_walk.py --curves --parent; PERF.md §6):
// - a block compacts the live rays of its span of lanes with one ballot of
//   its first warp: 16 lanes for C1 and 8 for C2 (8 or 32 for C1 and 32 for
//   C2 were slower); dead lanes write the miss and leave; the grid
//   depends on the lane count alone (the frame's CUDA graph stays as it is);
// - lanes lent to sparse spans: from the span's live count the block gives
//   each ray 8 E lanes, E = 4 (a warp a ray) when the span holds at most
//   kWide live rays, else E = 1 (Span). A wide step takes up to E entries,
//   the nearest hit child of the ray's last step and then pops from its
//   stack; sub-group s of 8 lanes loads entry s, lane k child or segment k,
//   so the rows of up to E entries are fetched at once. C1 goes wide at up
//   to 12 live rays of 16 (up to 8 or 16 was slower, and so were spans
//   of 8); every C2 ray gets 32 lanes (a
//   warp takes two rays in turn when its span of 8 holds more than four; 16
//   lanes for five to eight was slower);
// - the any-hit wide step tests all of its entries against tmax and pushes
//   the hit children of all its nodes;
// - the closest-hit wide step keeps the plain walk's order: the cones of
//   all its leaves are tested against the cap taken before the step, entry
//   s's boxes against that cap lowered by the least t of the entries before
//   it (a cone's t below the cap is the same whatever the cap), the first
//   node with a hit child ends the step's entries and the entries after it
//   go back onto the stack untested, and the (t, slot) minimum over the
//   entries taken, lowest entry then lowest slot on ties, updates the best:
//   a run of popped leaves and empty nodes, then one node, in one step;
// - one step for nodes and leaves: in a wide step a lane loads a node's
//   seven words or a leaf's ten and only the slab test and the cone test
//   part; a slot's meta or id decides whether it is tested at all;
// - the narrow step (E = 1) is W1's group step with the cone leaf: one
//   entry, the node or the leaf branch, then the nearest hit child or a pop;
// - the hit children are ranked by a loop over the hits, one shuffle each
//   (nearer first, ties by the group's slot order; slot order in the any-hit
//   entry): 8 E unrolled independent shuffles issued more instructions and
//   were slower; the nearest is carried to the next step, the others pushed
//   farthest first onto the ray's row of a shared-memory stack;
// - the stack: the block's kStackWords entries, cut into one row a ray (128
//   entries at E = 1, 512 at E = 4). A step of E entries can push 8 E - 1
//   (the closest hit's 7); a wide step is taken only while it leaves kStack1 entries
//   free, the row the narrow walk of a tree of D levels needs ((8 - 1) D + 1,
//   which the wrapper checks), and narrows otherwise;
// - a group whose ray is done takes the span's next live ray from a shared
//   counter.
// Tried and slower (PERF.md §6): the next rows copied into shared
// memory with cp.async while a step of leaves is tested (the entries it lets
// the next step pop, 20 copies of 16 bytes a row into a tagged slot), on
// every step at E = 1 and on wide steps only; the hit children ranked by
// 8 E unrolled independent shuffles. Tried and wrong: a closest-hit wide
// step that tests all its entries against one cap and pushes every node's
// hit children made 43 of 102,400 camera rays' t differ from the plain walk.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                 // a block: four warps
constexpr int kB = 8;                         // children a node row, segments a leaf row
constexpr int kRowWords = 80;                 // the words of a row the walk reads: 10 * kB
constexpr int kSubs = kThreads / kB;          // 8-lane sub-groups a block
constexpr int kStackWords = 2048;             // the block's stack entries, one row a ray
constexpr int kStack1 = kStackWords / kSubs;  // 128, a ray's row at E = 1; ops/intersect_wide_cuda.py::CURVE_STACK
constexpr float kRtMax = 3.0e38f;             // nrc_tpu.ops.intersect.RT_MAX
constexpr int kNone = INT32_MIN;              // an empty child slot; no entry

// a block's span, and the largest live count of a span at which its rays
// get 32 lanes (E = 4), by entry point; the wrapper's copy is
// ops/intersect_wide_cuda.py::CURVE_SPANS and CURVE_WIDE
template <bool kAnyHit>
struct Span {
  static constexpr int kLanes = kAnyHit ? 8 : 16;
  static constexpr int kWide = kAnyHit ? 8 : 12;
};

__device__ __forceinline__ float inv_component(float d) {
  return fabsf(d) > 1e-20f ? 1.0f / d : 3.0e38f;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tn, tf;
};

// The round-cone test for one curve segment, in the operation order of
// ops/intersect_wide.py::_leaf_cone_t: the lateral surface's quadratic (k2,
// k1, k0), its root accepted where the axial coordinate y lies inside (0,
// d2), and the end spheres at pa (radius ra) and pa + ba (rb); the smallest t
// in (tmin, cap), or kRtMax. The direction must be of unit length.
__device__ __forceinline__ float cone_t(const Ray& r, float cap, float pax, float pay, float paz, float bax,
                                        float bay, float baz, float ra, float rb, float m0) {
  const float oax = r.ox - pax;
  const float oay = r.oy - pay;
  const float oaz = r.oz - paz;
  const float obx = oax - bax;
  const float oby = oay - bay;
  const float obz = oaz - baz;
  const float rr = ra - rb;
  const float m1 = (bax * oax + bay * oay) + baz * oaz;
  const float m2 = (bax * r.dx + bay * r.dy) + baz * r.dz;
  const float m3 = (r.dx * oax + r.dy * oay) + r.dz * oaz;
  const float m5 = (oax * oax + oay * oay) + oaz * oaz;
  const float m6 = (obx * r.dx + oby * r.dy) + obz * r.dz;
  const float m7 = (obx * obx + oby * oby) + obz * obz;
  const float d2 = m0 - rr * rr;
  const float k2 = d2 - m2 * m2;
  const float k1 = (d2 * m3 - m1 * m2) + (m2 * rr) * ra;
  const float k0 = ((d2 * m5 - m1 * m1) + ((m1 * rr) * ra) * 2.0f) - (m0 * ra) * ra;
  const float h = k1 * k1 - k0 * k2;
  const bool ok2 = fabsf(k2) > 1e-20f;
  // h < 0 (or NaN) fails h >= 0 below whatever the root reads
  float t_body = (-sqrtf(h > 0.0f ? h : 0.0f) - k1) / (ok2 ? k2 : 1.0f);
  const float y = (m1 - ra * rr) + t_body * m2;
  const bool body_ok = h >= 0.0f && ok2 && y > 0.0f && y < d2 && t_body > r.tn && t_body < cap;
  t_body = body_ok ? t_body : kRtMax;
  const float h1 = (m3 * m3 - m5) + ra * ra;
  float t_ca = -m3 - sqrtf(h1 > 0.0f ? h1 : 0.0f);
  t_ca = (h1 >= 0.0f && t_ca > r.tn && t_ca < cap) ? t_ca : kRtMax;
  const float h2 = (m6 * m6 - m7) + rb * rb;
  float t_cb = -m6 - sqrtf(h2 > 0.0f ? h2 : 0.0f);
  t_cb = (h2 >= 0.0f && t_cb > r.tn && t_cb < cap) ? t_cb : kRtMax;
  return fminf(t_body, fminf(t_ca, t_cb));
}

// A ray in flight: what the lanes of its group hold alike.
struct Walk {
  Ray r;
  float ix, iy, iz;
  float best_t;
  int best;
  int sp;     // entries on the ray's stack row
  int entry;  // E = 1: the next row; E > 1: the last step's nearest hit child, taken first, or kNone
};

__device__ __forceinline__ size_t row_of(int e, int num_nodes) {
  return static_cast<size_t>(e >= 0 ? e : num_nodes + ~e);
}

// Lane k's slab test of child k's box: entered when max(near, tmin) <=
// min(far, cap), inclusive.
__device__ __forceinline__ bool slab(const Walk& w, float cap, float lox, float loy, float loz, float hix,
                                     float hiy, float hiz, float& tnear) {
  const Ray& r = w.r;
  const float t0x = (lox - r.ox) * w.ix, t1x = (hix - r.ox) * w.ix;
  const float t0y = (loy - r.oy) * w.iy, t1y = (hiy - r.oy) * w.iy;
  const float t0z = (loz - r.oz) * w.iz, t1z = (hiz - r.oz) * w.iz;
  tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return fmaxf(tnear, r.tn) <= fminf(tfar, cap);
}

// A hit child's rank among the group's hits: nearer ones first, ties by the
// group's slot order; the any-hit entry takes slot order.
template <int W, bool kAnyHit>
__device__ __forceinline__ int hit_rank(unsigned hits, float tnear, int gl, unsigned gmask) {
  int rank = __popc(hits & ((1u << gl) - 1u));
  if (!kAnyHit && (hits & (hits - 1u))) {
    rank = 0;
    for (unsigned mm = hits; mm; mm &= mm - 1u) {
      const int j = __ffs(mm) - 1;
      const float kj = __shfl_sync(gmask, tnear, j, W);
      rank += (kj < tnear || (kj == tnear && j < gl)) ? 1 : 0;
    }
  }
  return rank;
}

// The (t, slot) minimum of the leaves' hits over the group's W lanes, lowest
// t, lowest slot on ties; a best only below the cap.
template <int W>
__device__ __forceinline__ void leaf_min(Walk& w, float cap, float lt, int lp, int gl, unsigned gmask) {
  int ls = gl;
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(gmask, lt, off, W);
    const int os = __shfl_xor_sync(gmask, ls, off, W);
    const int op = __shfl_xor_sync(gmask, lp, off, W);
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

// One step of a dense span's ray (E = 1) by its group of 8 lanes, lane k:
// the entry's node or leaf row, then the next entry (the nearest hit child,
// or a pop). Returns false once the ray is done.
template <bool kAnyHit>
__device__ __forceinline__ bool narrow_step(Walk& w, const float* __restrict__ rows, int row_words, int num_nodes,
                                            int* stack, int k, unsigned gmask, int lane0) {
  const float cap = fminf(w.r.tf, w.best_t);  // the cap before the step
  const float* row = rows + row_of(w.entry, num_nodes) * row_words + k;
  float x[10];
  if (w.entry >= 0) {
    // ---- node: lane k slab-tests child k ----------------------------------------
#pragma unroll
    for (int j = 0; j < 7; ++j) x[j] = __ldg(row + j * kB);
    const int meta = __float_as_int(x[6]);
    float tnear = 0.0f;
    const bool ok = meta != kNone && slab(w, cap, x[0], x[1], x[2], x[3], x[4], x[5], tnear);
    const unsigned hits = __ballot_sync(gmask, ok) >> lane0;
    if (hits) {
      const int h = __popc(hits);
      const int rank = hit_rank<kB, kAnyHit>(hits, tnear, k, gmask);
      // the nearest goes straight to the next step; the others onto the
      // stack, farthest first, so that a pop takes the nearest left
      const unsigned first = __ballot_sync(gmask, ok && rank == 0) >> lane0;
      w.entry = __shfl_sync(gmask, meta, __ffs(first) - 1, kB);
      if (ok && rank > 0) stack[w.sp + h - 1 - rank] = meta;
      w.sp += h - 1;
      __syncwarp(gmask);
      return true;
    }
  } else {
    // ---- leaf: lane k tests segment k -------------------------------------------
#pragma unroll
    for (int j = 0; j < 10; ++j) x[j] = __ldg(row + j * kB);
    const int lp = __float_as_int(x[9]);
    const float lt = lp >= 0 ? cone_t(w.r, cap, x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7], x[8]) : kRtMax;
    const unsigned hit_lanes = __ballot_sync(gmask, lt < kRtMax) >> lane0;
    if (hit_lanes) {
      if (kAnyHit) {
        const int src = __ffs(hit_lanes) - 1;
        w.best_t = __shfl_sync(gmask, lt, src, kB);
        w.best = __shfl_sync(gmask, lp, src, kB);
        return false;
      }
      leaf_min<kB>(w, cap, lt, lp, k, gmask);
    }
  }
  if (w.sp == 0) return false;
  w.entry = stack[--w.sp];
  return true;
}

// One step of a sparse span's ray (E = 4) by its group of 8 E lanes,
// lane gl of the group: up to E entries, the carried child and pops, each a
// node or a leaf row, all against the cap before the step. Returns false
// once the ray is done; every lane of the group then holds its (best t,
// best segment).
template <int E, bool kAnyHit>
__device__ __forceinline__ bool wide_step(Walk& w, const float* __restrict__ rows, int row_words,
                                          int num_nodes, int* stack, int room, int gl, unsigned gmask,
                                          int lane0) {
  constexpr int W = kB * E;
  const int s = gl / kB;
  const int k = gl % kB;
  const float cap = fminf(w.r.tf, w.best_t);  // the cap before the step, for all of its entries
  __syncwarp(gmask);                        // the last step's pushes visible to the whole group

  // ---- 1. the step's entries: the carried child, then pops from the top ----
  const int c = w.entry != kNone ? 1 : 0;
  int m = min(E, c + w.sp);
  // a wide step leaves the narrow walk's kStack1 entries free: it pushes
  // at most kB m - 1 after popping m - c
  if (m > 1) m = max(1, min(m, (room - w.sp - c + 1) / (kB - 1)));
  if (m == 0) return false;
  const int my = s < c ? w.entry : (s < m ? stack[w.sp - 1 - (s - c)] : kNone);
  w.sp -= m - c;

  // ---- 2. its rows, a node's seven words and a leaf's ten ---------------------
  float x[10];
  if (my != kNone) {
    const float* src = rows + row_of(my, num_nodes) * row_words + k;
#pragma unroll
    for (int j = 0; j < 7; ++j) x[j] = __ldg(src + j * kB);
    if (my < 0) {
#pragma unroll
      for (int j = 7; j < 10; ++j) x[j] = __ldg(src + j * kB);
    }
  }

  // ---- 3. lane k: segment k of a leaf, occupied only, against the cap ------
  float lt = kRtMax;
  int lp = -1;
  if (my < 0 && my != kNone) {
    lp = __float_as_int(x[9]);
    if (lp >= 0) lt = cone_t(w.r, cap, x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7], x[8]);
  }
  if (kAnyHit) {
    const unsigned leaf_hits = __ballot_sync(gmask, lt < kRtMax) >> lane0;
    if (leaf_hits) {
      const int src = __ffs(leaf_hits) - 1;
      w.best_t = __shfl_sync(gmask, lt, src, W);
      w.best = __shfl_sync(gmask, lp, src, W);
      return false;
    }
  }

  // ---- 4. the closest hit in the plain walk's order: entry s against the cap
  // the leaves before it leave ---------------------------------------------------
  float sub_cap = cap;
  if (!kAnyHit) {
    float least = lt;  // the least t of the sub-group's leaf
#pragma unroll
    for (int off = kB / 2; off > 0; off >>= 1) least = fminf(least, __shfl_xor_sync(gmask, least, off, W));
#pragma unroll
    for (int j = 0; j + 1 < E; ++j) {
      const float before = __shfl_sync(gmask, least, j * kB, W);
      if (j < s) sub_cap = fminf(sub_cap, before);
    }
  }

  // ---- 5. lane k: child k of a node, occupied only ------------------------------
  bool ok = false;
  float tnear = 0.0f;
  int meta = kNone;
  if (my >= 0) {
    meta = __float_as_int(x[6]);
    if (meta != kNone) ok = slab(w, sub_cap, x[0], x[1], x[2], x[3], x[4], x[5], tnear);
  }
  unsigned hits = __ballot_sync(gmask, ok) >> lane0;
  if (!kAnyHit && hits) {
    // the plain walk takes the first node with a hit child to its children:
    // the entries after it go back onto the stack untested
    const int stop = (__ffs(hits) - 1) / kB;
    if (s > stop) {
      lt = kRtMax;
      ok = false;
    }
    hits = __ballot_sync(gmask, ok) >> lane0;
    w.sp += m - 1 - stop;
  }

  // ---- 6. the leaves: the (t, slot) minimum over the group's lanes ------------
  if (!kAnyHit && __ballot_sync(gmask, lt < kRtMax)) leaf_min<W>(w, cap, lt, lp, gl, gmask);

  // ---- 7. the hit children: the nearest carried, the others pushed -----------
  w.entry = kNone;
  if (hits) {
    const int h = __popc(hits);
    const int rank = hit_rank<W, kAnyHit>(hits, tnear, gl, gmask);
    const unsigned first = __ballot_sync(gmask, ok && rank == 0) >> lane0;
    w.entry = __shfl_sync(gmask, meta, __ffs(first) - 1, W);
    if (ok && rank > 0) stack[w.sp + h - 1 - rank] = meta;
    w.sp += h - 1;
  }
  return w.entry != kNone || w.sp > 0;
}

// The span's live rays walked by groups of 8 E lanes, each taking the next
// ray from the span's queue when its ray is done.
template <int E, bool kAnyHit>
__device__ __forceinline__ void walk_span(const float* __restrict__ org, const float* __restrict__ dir,
                                          const float* __restrict__ tmin, const float* __restrict__ tmax,
                                          const float* __restrict__ rows, int row_words, int num_nodes,
                                          float* __restrict__ t_out, int* __restrict__ prim_out,
                                          const int* span_ray, int total, int* next_ray, int* stacks) {
  constexpr int W = kB * E;
  constexpr int kRow = kStackWords / (kThreads / W);  // a ray's stack row
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x / W;
  const int gl = threadIdx.x % W;
  const int lane0 = lane & ~(W - 1);  // the group's first lane in its warp
  const unsigned gmask = (W == 32 ? 0xffffffffu : (1u << W) - 1u) << lane0;
  int* stack = stacks + g * kRow;
  auto take = [&]() {  // the span's next ray for this group
    int v = 0;
    if (gl == 0) v = atomicAdd(next_ray, 1);
    return __shfl_sync(gmask, v, 0, W);
  };
  for (int q = take(); q < total; q = take()) {
    const int ray = span_ray[q];
    Walk w;
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
    if (E == 1) {
      while (narrow_step<kAnyHit>(w, rows, row_words, num_nodes, stack, gl, gmask, lane0)) {
      }
    } else {
      while (wide_step<E, kAnyHit>(w, rows, row_words, num_nodes, stack, kRow - kStack1, gl, gmask, lane0)) {
      }
    }
    if (gl == 0) {
      t_out[ray] = w.best_t;
      prim_out[ray] = w.best;
    }
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) curves_kernel(
    const float* __restrict__ org, const float* __restrict__ dir, const float* __restrict__ tmin,
    const float* __restrict__ tmax, const float* __restrict__ rows, int num_rays, int row_words,
    int num_nodes, float* __restrict__ t_out, int* __restrict__ prim_out) {
  constexpr int kSpan = Span<kAnyHit>::kLanes;
  static_assert(kSpan <= 32 && kSpan % 4 == 0, "a span is one ballot of warp 0");
  __shared__ int stacks[kStackWords];                 // one row a ray
  __shared__ int span_ray[kSpan];                     // the span's live rays, in lane order
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
    const unsigned ballot = __ballot_sync(kSpan == 32 ? 0xffffffffu : (1u << kSpan) - 1u, live);
    if (live) span_ray[__popc(ballot & ((1u << lane) - 1u))] = idx;
    if (lane == 0) {
      span_live = __popc(ballot);
      next_ray = 0;
    }
  }
  __syncthreads();
  const int total = span_live;
  if (total == 0) return;

  // ---- 2. the lanes a ray gets follow the span's live count -------------------
  if (total <= Span<kAnyHit>::kWide) {
    walk_span<4, kAnyHit>(org, dir, tmin, tmax, rows, row_words, num_nodes, t_out, prim_out, span_ray, total,
                          &next_ray, stacks);
  } else {
    walk_span<1, kAnyHit>(org, dir, tmin, tmax, rows, row_words, num_nodes, t_out, prim_out, span_ray, total,
                          &next_ray, stacks);
  }
}

template <bool kAnyHit>
int launch(const float* org, const float* dir, const float* tmin, const float* tmax, const float* rows,
           int num_rays, int row_words, int num_nodes, int branch, int leaf_size, float* t_out, int* prim_out,
           void* stream) {
  // the layout the wrapper checks (ops/intersect_wide_cuda.py::check_curve_walkable)
  if (branch != kB || leaf_size != kB || row_words % 4 || row_words < kRowWords || num_nodes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kSpan = Span<kAnyHit>::kLanes;
  const int blocks = (num_rays + kSpan - 1) / kSpan;
  curves_kernel<kAnyHit><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      org, dir, tmin, tmax, rows, num_rays, row_words, num_nodes, t_out, prim_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nrc_wbvh_curves_closest(const float* org, const float* dir, const float* tmin,
                                       const float* tmax, const float* rows, int num_rays,
                                       int row_words, int num_nodes, int branch, int leaf_size,
                                       float* t_out, int* prim_out, void* stream) {
  return launch<false>(org, dir, tmin, tmax, rows, num_rays, row_words, num_nodes, branch, leaf_size, t_out,
                       prim_out, stream);
}

extern "C" int nrc_wbvh_curves_any(const float* org, const float* dir, const float* tmin,
                                   const float* tmax, const float* rows, int num_rays, int row_words,
                                   int num_nodes, int branch, int leaf_size, float* t_out, int* prim_out,
                                   void* stream) {
  return launch<true>(org, dir, tmin, tmax, rows, num_rays, row_words, num_nodes, branch, leaf_size, t_out,
                      prim_out, stream);
}
