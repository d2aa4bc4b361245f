// The triangle test of the walk (W1/W2, csrc/intersect_wide.cu) and of the
// primary raster (R1, csrc/raster_primary.cu): Möller-Trumbore for one ray
// and one triangle in the operation order of
// ops/intersect_wide.py::_leaf_tri_t, so that a file built with -fmad=false
// gives the plain version's t bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace nrc_mt {

constexpr float kRtMax = 3.0e38f;  // nrc_tpu.ops.intersect.RT_MAX

struct Ray {
  float ox, oy, oz, dx, dy, dz, tn, tf;
};

// t of the hit in (r.tn, cap), or kRtMax: |det| > 1e-12, u >= 0, v >= 0,
// u + v <= 1, and pid >= 0 (a pad slot never hits).
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

}  // namespace nrc_mt
