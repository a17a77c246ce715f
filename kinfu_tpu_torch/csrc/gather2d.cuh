// K6: the 2D indexed load shared by the kernels (build_face.cu,
// face_integrate.cu, resample_face.cu).
//
// Replaces kinfu_tpu/ops/tilegather.py::gather2d_multi (L193-233), the
// in-kernel gather out[i,j] = src[v[i,j], u[i,j]] of the TPU kernels. Its
// windows, the vrow+d split and the 128-lane chunks exist only because a
// Mosaic gather must fit in one vreg; on Hopper the gather is one load per
// thread, with the indices clipped into the source as the TPU helper's
// callers clip them (tilegather.py:251-259). Its plain version is PyTorch
// indexing of the clipped indices. `n` is the length of `src` in elements,
// which the checked build holds the load to (checked.cuh).
#pragma once

#include <cuda_runtime.h>

#include "checked.cuh"

namespace kinfu {

// src [rows, cols] row-major, n elements; (v, u) clipped into range.
template <typename T>
__device__ __forceinline__ T gather2d(const T* __restrict__ src, long long n, int rows,
                                      int cols, int v, int u) {
  v = min(max(v, 0), rows - 1);
  u = min(max(u, 0), cols - 1);
  return KINFU_AT(src, n, static_cast<long long>(v) * cols + u);
}

// src [rows, cols, nch] row-major, n elements, channel k; (v, u) clipped
// into range.
template <typename T>
__device__ __forceinline__ T gather2d_ch(const T* __restrict__ src, long long n, int rows,
                                         int cols, int nch, int v, int u, int k) {
  v = min(max(v, 0), rows - 1);
  u = min(max(u, 0), cols - 1);
  return KINFU_AT(src, n, (static_cast<long long>(v) * cols + u) * nch + k);
}

// Round half to even (jnp.rint / torch.round), clamped to +-2^24 before the
// conversion so that the cast is defined; any such value fails a bounds test.
__device__ __forceinline__ int rint_clamped(float x) {
  return static_cast<int>(fminf(fmaxf(rintf(x), -16777216.0f), 16777216.0f));
}

// float32(1 / 32767): the int16 TSDF scale, rounded as float32(1.0 / SHORTMAX).
constexpr float kInvShort = static_cast<float>(1.0 / 32767.0);
// "no event" / "outside the face" marker (1e30 as float32)
constexpr float kInf = 1e30f;

}  // namespace kinfu
