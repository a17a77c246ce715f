// Device helpers of the two march kernels (march_rays.cu, march_hier.cu):
// the float operations of the plain marches in volume/raycast.py, rounded
// as PyTorch rounds them there. The build uses -fmad=false, so every
// product and sum below rounds on its own, as the separate PyTorch
// operations do.
#pragma once

#include <cmath>

#include <cuda_runtime.h>

#include "gather2d.cuh"

namespace kinfu {

// torch.minimum / torch.maximum / torch.clamp(min=): a NaN operand gives
// NaN (x != x only for a NaN; the build has no fast math)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}

// volume/raycast.py::_floor_index: floor, NaN as -2^24, clamped to +-2^24
__device__ __forceinline__ int floor_clamped(float x) {
  return static_cast<int>(fminf(fmaxf(floorf(x), -16777216.0f), 16777216.0f));
}

// One ray: origin, direction and inverse voxel size (x, y, z), read once.
struct Ray {
  float o[3], d[3], inv_vs[3];

  // (org + dirs * t) * inv_vs along axis c: volume/raycast.py::_point, then
  // the voxel scale
  __device__ __forceinline__ float vox(int c, float t) const {
    return (o[c] + d[c] * t) * inv_vs[c];
  }
};

// The +,- front and -,+ back rules on two consecutive samples (both valid),
// and the front's linear refinement tcur + step * frac; a front or back
// event ends the ray, so the minimum with +inf is the event itself.
__device__ __forceinline__ bool crossing(float f_prev, float f_next, float tcur, float tnext,
                                         float step, float* hit, float* back) {
  const bool front = f_prev > 0.0f && f_next < 0.0f;
  const bool bk = f_prev < 0.0f && f_next > 0.0f;
  if (front) {
    const float frac = f_prev / nan_max(f_prev - f_next, 1e-30f);
    *hit = nan_min(*hit, tcur + step * frac);
  }
  if (bk) *back = nan_min(*back, tnext);
  return front || bk;
}

}  // namespace kinfu
