// Brute-force ray-triangle intersection in the precomputed-plane
// (Baldwin-Weber) form: closest hit and any hit over every triangle of a
// [T, 24] plane table, for the rays whose t range is not empty.
//
// Replaces the TPU kernels of nrc_tpu/ops/intersect_pallas.py:
//   nrc_planes_closest  <- intersect_planes (_closest_kernel + _tile_hits)
//   nrc_planes_any      <- occluded_planes  (_anyhit_kernel + _tile_hits)
//
// Per triangle the table holds six planes of four coefficients (24 floats):
//   An = n.o + d0   Bn = n.d    t = -An / Bn
//   Au = a_u.o+b_u  Bu = a_u.d  u = Au + t*Bu
//   Av = a_v.o+b_v  Bv = a_v.d  v = Av + t*Bv
// A hit needs u >= 0, v >= 0, u + v <= 1 and tmin < t < tmax. Degenerate
// triangles have all-zero planes: t = NaN and every compare fails.
//
// What bounds it on an H100: arithmetic, not memory. A ray-triangle pair
// costs 39 float32 operations and a division (about 58 machine operations
// in the plain order), the rays are 32 bytes each and the table (1224 x 96 bytes
// for the Cornell box) stays in the L2. And most of what the frame asks for
// is no work at all: the integrator launches over all lanes at every bounce
// and marks a dead lane with an empty t range; over a Cornell FULL + train
// frame 16 % of the lanes are live, all of them at a wavefront's first
// bounce and a few per cent or less after the third.
//
// The design (measured on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md has
// the numbers and the variants that lost):
//
// 1. Compaction. A block owns a span of 128 consecutive lanes, one per
//    thread. It writes the miss result of every dead lane, and packs the
//    live rays (origin, direction, range) into shared memory in lane order
//    by a warp ballot and a prefix over the four warp counts. A span without
//    a live ray returns before it touches the table. 128 lanes keep a
//    25,600-lane launch at 200 blocks for the 132 SMs, and shared memory (5
//    to 9 KB) and registers allow nine blocks on an SM.
// 2. The register tile is the triangle. A warp holds 32 triangles, one per
//    lane with its 24 coefficients in registers, and streams the span's live
//    rays past them, two (closest hit) or four (any hit) in flight; the four
//    warps share out the table in groups of 32 triangles. A ray costs two
//    16-byte broadcast loads per 32 pairs, and a span with one live ray
//    still gives all 128 threads work, which one thread per ray cannot: that
//    form leaves a lone ray's thread 1224 dependent iterations. Two rays
//    per thread with the triangles in shared memory, the other tile,
//    measured slower than one ray per thread.
// 3. Divide only for candidates. -An / Bn lies between lo and hi exactly
//    when An + lo*Bn and An + hi*Bn differ in sign. A fused multiply-add
//    has the sign of its exact value or is zero, so with lo and hi the
//    range widened by 1e-6 (the rounded quotient is within 6e-8 of the
//    exact one) the test never rejects a pair whose t is inside: a zero or
//    NaN product falls through. Only if a lane of the warp passes does the
//    warp divide and test u and v. Triangles that are neighbours in the
//    table are neighbours in space, so groups are skipped whole: nearly all
//    of them for shadow rays (under 1 % of their pairs are candidates), about
//    half for closest hits (a third of all planes are crossed before the hit).
// 4. The exact path is the plain PyTorch version's arithmetic
//    (ops/intersect_cuda.py) in its order, the file built with -fmad=false
//    and without --use_fast_math (IEEE division, no flush to zero), so t and
//    the winners agree with it bit for bit. Built without that flag, so that
//    the sums contract into FMA (tools/bench_intersect.py does), it is 1.1x
//    faster and moves the winner of a few grazing rays in 100,000: too
//    little gained to give up the exact agreement. The tensor cores were
//    not taken either: their depth is 8 of which a plane uses 3 or 4,
//    float32 accuracy needs three TF32 products, and the result is about
//    290 tensor-core operations per pair against 36 on the CUDA cores.
// 5. The closest hit keeps, per warp, its best (t, triangle) for every ray
//    in shared memory, strict < within a warp (its triangles come in
//    ascending order) and smallest t then lowest triangle across lanes and
//    warps: ties go to the lowest triangle as in the TPU kernel. The best t
//    of any warp is the block's bound for that ray (<=, so that a tie at a
//    lower triangle of another warp still passes). An occluded ray's range
//    is closed for all warps.
// The results are written in their final types, int64 winners and one byte
// per ray into a torch.bool tensor.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = kThreads;            // lanes a block owns
constexpr int kPlanes = 6;                 // 6 planes x 4 coefficients per triangle
constexpr float kRtMax = 3.0e38f;          // nrc_tpu.ops.intersect.RT_MAX
constexpr unsigned kFullWarp = 0xffffffffu;
// the rounded quotient t lies within half an ulp (6e-8 t) of -An / Bn
constexpr float kRelMargin = 1.0e-6f;
constexpr float kAbsMargin = 1.0e-30f;

// The plain version's sums, in its order. -fmad=false keeps the compiler
// from fusing a product with the add that follows it.
__device__ __forceinline__ float dot_o(float4 p, float4 o) {
  return ((o.x * p.x + o.y * p.y) + o.z * p.z) + p.w;
}

__device__ __forceinline__ float dot_d(float4 p, float4 d) {
  return (d.x * p.x + d.y * p.y) + d.z * p.z;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) planes_kernel(
    const float* __restrict__ org, const float* __restrict__ dir,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const float4* __restrict__ planes, int num_rays, int num_tris,
    float* __restrict__ t_out, long long* __restrict__ prim_out,
    unsigned char* __restrict__ occ_out) {
  __shared__ float4 ray_o[kSpan];  // origin, tmin
  // direction, and the largest t that can still matter: at first the last
  // float below tmax, then the block's best t (closest hit), or tmin once
  // the ray is occluded (any hit)
  __shared__ float4 ray_d[kSpan];
  __shared__ float own_t[kAnyHit ? 1 : kWarps][kAnyHit ? 1 : kSpan];  // per warp: its best hit
  __shared__ int own_tri[kAnyHit ? 1 : kWarps][kAnyHit ? 1 : kSpan];
  __shared__ unsigned char occluded[kAnyHit ? kSpan : 1];
  __shared__ int ray_lane[kSpan];  // where the result goes
  __shared__ int warp_live[kWarps];

  constexpr int kRays = kAnyHit ? 4 : 2;  // rays in flight per thread
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // ---- 1. compact the span's live rays; dead lanes get the miss result ----
  const int idx = blockIdx.x * kSpan + threadIdx.x;
  bool live = false;
  if (idx < num_rays) {
    live = tmax[idx] > tmin[idx];
    if (!live) {
      if (kAnyHit) {
        occ_out[idx] = 0;
      } else {
        t_out[idx] = kRtMax;
        prim_out[idx] = -1;
      }
    }
  }
  const unsigned ballot = __ballot_sync(kFullWarp, live);
  if (lane == 0) warp_live[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_live[w];
    before += w < warp ? c : 0;
    total += c;
  }
  if (total == 0) return;  // the whole block: nothing touches the table
  if (live) {
    const int q = before + __popc(ballot & ((1u << lane) - 1u));
    const float tf = fminf(tmax[idx], kRtMax);
    ray_o[q] = make_float4(org[3 * idx + 0], org[3 * idx + 1], org[3 * idx + 2], tmin[idx]);
    ray_d[q] = make_float4(dir[3 * idx + 0], dir[3 * idx + 1], dir[3 * idx + 2],
                           nextafterf(tf, -kRtMax));
    if (kAnyHit) {
      occluded[q] = 0;
    } else {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        own_t[w][q] = kRtMax;
        own_tri[w][q] = -1;
      }
    }
    ray_lane[q] = idx;
  }
  __syncthreads();

  // ---- 2. a warp holds 32 triangles in registers, one per lane, and streams
  // the block's live rays past them; the warps share out the table ----
  const int num_groups = (num_tris + 31) / 32;
  for (int g = warp; g < num_groups; g += kWarps) {
    const int tri = g * 32 + lane;
    // a lane past the end of the table holds all-zero planes, like a
    // degenerate triangle: t is NaN and nothing hits
    float4 p[kPlanes];
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
      p[k] = tri < num_tris ? planes[static_cast<size_t>(tri) * kPlanes + k] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int q0 = 0; q0 < total; q0 += kRays) {
      int q[kRays];
      float4 o[kRays], d[kRays];
      float an[kRays], bn[kRays];
      bool maybe[kRays];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        q[r] = min(q0 + r, total - 1);  // past the end: the last ray again
        o[r] = ray_o[q[r]];
        d[r] = ray_d[q[r]];
        const float lo = o[r].w - fmaf(fabsf(o[r].w), kRelMargin, kAbsMargin);
        const float hi = d[r].w + fmaf(fabsf(d[r].w), kRelMargin, kAbsMargin);
        an[r] = dot_o(p[0], o[r]);
        bn[r] = dot_d(p[1], d[r]);
        // -An / Bn lies between lo and hi exactly when An + lo Bn and
        // An + hi Bn differ in sign; a fused multiply-add has the sign of
        // its exact value or is zero, and zero or NaN fall through
        const float below = fmaf(lo, bn[r], an[r]);
        const float above = fmaf(hi, bn[r], an[r]);
        maybe[r] = !(below * above > 0.f);
        any = any | maybe[r];
      }
      if (!__any_sync(kFullWarp, any)) continue;
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        if (!__any_sync(kFullWarp, maybe[r])) continue;
        const float t = -an[r] / bn[r];
        const float u = dot_o(p[2], o[r]) + t * dot_d(p[3], d[r]);
        const float v = dot_o(p[4], o[r]) + t * dot_d(p[5], d[r]);
        const bool ok = maybe[r] & (t > o[r].w) & (t <= d[r].w)
                        & (u >= 0.f) & (v >= 0.f) & (u + v <= 1.f);
        if (!__any_sync(kFullWarp, ok)) continue;
        if (kAnyHit) {
          if (lane == 0) {
            occluded[q[r]] = 1;
            reinterpret_cast<volatile float*>(&ray_d[q[r]])[3] = o[r].w;  // (tmin, tmin]: nothing passes
          }
        } else {
          // the smallest t of the 32 triangles, ties to the lowest triangle
          float best_t = ok ? t : kRtMax;
          int best = ok ? tri : 0x7fffffff;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const float other_t = __shfl_xor_sync(kFullWarp, best_t, off);
            const int other = __shfl_xor_sync(kFullWarp, best, off);
            if (other_t < best_t || (other_t == best_t && other < best)) {
              best_t = other_t;
              best = other;
            }
          }
          // the warp's triangles come in ascending order: strict <
          if (lane == 0 && best_t < own_t[warp][q[r]]) {
            own_t[warp][q[r]] = best_t;
            own_tri[warp][q[r]] = best;
            // a bound for every warp of the block (<=: a tie at a lower
            // triangle of another warp must still pass). Floats >= 0 order
            // as their bits do.
            if (best_t >= 0.f) {
              atomicMin(reinterpret_cast<int*>(&ray_d[q[r]]) + 3, __float_as_int(best_t));
            }
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // ---- 3. results, by lane index ----
  for (int q = threadIdx.x; q < total; q += kThreads) {
    const int out = ray_lane[q];
    if (kAnyHit) {
      occ_out[out] = occluded[q];
    } else {
      float best_t = kRtMax;
      int best = -1;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float t = own_t[w][q];
        const int b = own_tri[w][q];
        if (b >= 0 && (best < 0 || t < best_t || (t == best_t && b < best))) {
          best_t = t;
          best = b;
        }
      }
      t_out[out] = best_t;
      prim_out[out] = best;
    }
  }
}

}  // namespace

extern "C" int nrc_planes_closest(const float* org, const float* dir, const float* tmin,
                                  const float* tmax, const float* planes, int num_rays,
                                  int num_tris, float* t_out, long long* prim_out, void* stream) {
  const int blocks = (num_rays + kSpan - 1) / kSpan;
  planes_kernel<false><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      org, dir, tmin, tmax, reinterpret_cast<const float4*>(planes), num_rays, num_tris,
      t_out, prim_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nrc_planes_any(const float* org, const float* dir, const float* tmin,
                              const float* tmax, const float* planes, int num_rays,
                              int num_tris, unsigned char* occ_out, void* stream) {
  const int blocks = (num_rays + kSpan - 1) / kSpan;
  planes_kernel<true><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      org, dir, tmin, tmax, reinterpret_cast<const float4*>(planes), num_rays, num_tris,
      nullptr, nullptr, occ_out);
  return static_cast<int>(cudaGetLastError());
}
