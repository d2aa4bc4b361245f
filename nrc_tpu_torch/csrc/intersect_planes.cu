// Brute-force ray-triangle intersection in the precomputed-plane
// (Baldwin-Weber) form, one thread per ray.
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
// What bounds it on an H100: ~30 flops and one IEEE division per
// ray-triangle pair, no memory traffic beyond the rays (28 bytes each) and
// the table (1224 triangles x 96 bytes for the Cornell box, L2-resident).
// A block stages the table through shared memory in chunks of kTileTris
// triangles; every thread of the block reads the same triangle at the same
// time (a broadcast, no bank conflicts). The TPU kernel's matrix-unit dot
// products become scalar FMA-free arithmetic here.
//
// The arithmetic is written with __fmul_rn/__fadd_rn/__fdiv_rn in exactly
// the order of the plain PyTorch version (ops/intersect_cuda.py), so the
// two agree bit for bit: no contraction into FMA, IEEE division, no
// flush-to-zero (the file is built without --use_fast_math and with
// -fmad=false). The closest-hit loop keeps a strict `<` on t, which gives
// ties to the lowest triangle index as the TPU kernel does. A lane whose
// t-range is empty (an inactive ray, tmax <= tmin) cannot hit and skips the
// tests; a block stops as soon as all its lanes are done.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileTris = 256;     // 256 x 96 B = 24 KB of shared memory
constexpr int kPlaneFloat4 = 6;    // 6 planes x 4 coefficients per triangle
constexpr float kRtMax = 3.0e38f;  // nrc_tpu.ops.intersect.RT_MAX

__device__ __forceinline__ float dot_o(float4 p, float ox, float oy, float oz) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(ox, p.x), __fmul_rn(oy, p.y)),
                             __fmul_rn(oz, p.z)),
                   p.w);
}

__device__ __forceinline__ float dot_d(float4 p, float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, p.x), __fmul_rn(dy, p.y)), __fmul_rn(dz, p.z));
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) planes_kernel(
    const float* __restrict__ org, const float* __restrict__ dir,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const float4* __restrict__ planes, int num_rays, int num_tris,
    float* __restrict__ t_out, int* __restrict__ prim_out, int* __restrict__ occ_out) {
  __shared__ float4 tile[kTileTris * kPlaneFloat4];

  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray < num_rays;  // the ragged edge of the last block
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tn = 0.f, tf = 0.f;
  if (live) {
    ox = org[3 * ray + 0];
    oy = org[3 * ray + 1];
    oz = org[3 * ray + 2];
    dx = dir[3 * ray + 0];
    dy = dir[3 * ray + 1];
    dz = dir[3 * ray + 2];
    tn = tmin[ray];
    tf = tmax[ray];
  }
  bool done = !live || !(tf > tn);
  bool hit = false;
  float best_t = kRtMax;
  int best = -1;

  for (int base = 0; base < num_tris; base += kTileTris) {
    // also the barrier that keeps the previous chunk alive until all
    // lanes have finished reading it
    if (__syncthreads_and(done)) break;
    const int count = min(kTileTris, num_tris - base);
    const float4* src = planes + static_cast<size_t>(base) * kPlaneFloat4;
    for (int i = threadIdx.x; i < count * kPlaneFloat4; i += kThreads) tile[i] = src[i];
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < count; ++j) {
      const float4* p = tile + j * kPlaneFloat4;
      const float an = dot_o(p[0], ox, oy, oz);
      const float bn = dot_d(p[1], dx, dy, dz);
      const float au = dot_o(p[2], ox, oy, oz);
      const float bu = dot_d(p[3], dx, dy, dz);
      const float av = dot_o(p[4], ox, oy, oz);
      const float bv = dot_d(p[5], dx, dy, dz);
      const float t = __fdiv_rn(-an, bn);
      const float u = __fadd_rn(au, __fmul_rn(t, bu));
      const float v = __fadd_rn(av, __fmul_rn(t, bv));
      const bool ok = (u >= 0.f) & (v >= 0.f) & (__fadd_rn(u, v) <= 1.f) & (t > tn) & (t < tf);
      if (!ok) continue;
      if (kAnyHit) {
        hit = true;
        done = true;
        break;
      }
      if (t < best_t) {
        best_t = t;
        best = base + j;
      }
    }
  }
  if (!live) return;
  if (kAnyHit) {
    occ_out[ray] = hit ? 1 : 0;
  } else {
    t_out[ray] = best_t;
    prim_out[ray] = best;
  }
}

}  // namespace

extern "C" int nrc_planes_closest(const float* org, const float* dir, const float* tmin,
                                  const float* tmax, const float* planes, int num_rays,
                                  int num_tris, float* t_out, int* prim_out, void* stream) {
  const int blocks = (num_rays + kThreads - 1) / kThreads;
  planes_kernel<false><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      org, dir, tmin, tmax, reinterpret_cast<const float4*>(planes), num_rays, num_tris,
      t_out, prim_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nrc_planes_any(const float* org, const float* dir, const float* tmin,
                              const float* tmax, const float* planes, int num_rays,
                              int num_tris, int* occ_out, void* stream) {
  const int blocks = (num_rays + kThreads - 1) / kThreads;
  planes_kernel<true><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      org, dir, tmin, tmax, reinterpret_cast<const float4*>(planes), num_rays, num_tris,
      nullptr, nullptr, occ_out);
  return static_cast<int>(cudaGetLastError());
}
