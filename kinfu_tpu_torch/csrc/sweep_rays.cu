// K4: the plane-sweep march of one cube face's rays through the TSDF.
//
// Replaces the Pallas kernel kinfu_tpu/ops/pallas_raycast.py::_sweep_kernel
// (L114-284; pallas_call in _sweep_face_rays at L465). One thread per face
// ray d' = ((j-c)/f, (i-c)/f, 1) marches every primed plane in order, one
// nearest-voxel sample per plane, reading the natural [Z, Y, X] volume
// through the face's signed axis permutation (no transpose and flip of the
// volume as at L689-691). Kept as semantics: the static 8x128-tile
// ownership (L397-403), the t_cover bound of the TPU kernel's row windows
// (L161), the [1, N-2] validity bounds, the NaN carry of the previous
// sample, the front (refined hit) / back / outward-exit rules (L254-273)
// and the early exit once a ray has resolved. Dropped, because they only
// skip work: the 8^3 occupancy pooling, the summed-area tables and the
// visit lists (L321-443). Plain version:
// ops/face_raycast.py::sweep_rays_plain; the build uses -fmad=false.
//
// Bound on this card: the distinct int16 voxels the rays sample before they
// resolve, 2 bytes each (48.2 M voxels, 0.030 ms, on the 640x480 orbit's +z
// view at 512^3; chip_smoke.py counts them with sweep_rays_work). Each ray
// reads one sample per plane, and neighbouring rays touch neighbouring rows
// only in the sweep direction's plane, so most loads are separate 32-byte
// sectors. The design does nothing about it yet.
#include <cmath>

#include <cuda_runtime.h>

#include "gather2d.cuh"

namespace {

// any pixel of the `tile`-wide tile holding p lies inside the padded cone
__device__ bool tile_owned(int p, int tile, float c, float inv_f, float own_tan) {
  const int q0 = (p / tile) * tile;
  for (int q = q0; q < q0 + tile; ++q) {
    if (fabsf((static_cast<float>(q) - c) * inv_f) <= own_tan) return true;
  }
  return false;
}

__global__ void sweep_rays_kernel(const short* __restrict__ tsdf,
                                  const float* __restrict__ prm, float* __restrict__ hit,
                                  float* __restrict__ back, int nZ, int nY, int nX,
                                  int ax0, int ax1, int ax2, int flip, int F) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= F || j >= F) return;
  const float ox = prm[0], oy = prm[1], oz = prm[2];
  const float vsx = prm[3], vsy = prm[4], vsz = prm[5];
  // the face focal is static in the JAX package, whose compiler multiplies
  // by its float32 reciprocal instead of dividing
  const float inv_f = 1.0f / prm[6], c = prm[7], t_cover = prm[8], own_tan = prm[9];
  float ht = kinfu::kInf, bt = kinfu::kInf;

  if (prm[10] != 0.0f && tile_owned(i, 8, c, inv_f, own_tan) &&
      tile_owned(j, 128, c, inv_f, own_tan)) {
    const int dims[3] = {nZ, nY, nX};
    const long long strides[3] = {static_cast<long long>(nY) * nX, nX, 1};
    const int Zp = dims[ax0], Yp = dims[ax1], Xp = dims[ax2];
    long long s0 = strides[ax0];
    const long long s1 = strides[ax1], s2 = strides[ax2];
    long long base = 0;
    if (flip) {
      base = (Zp - 1) * s0;
      s0 = -s0;
    }
    const float dy = (static_cast<float>(i) - c) * inv_f;
    const float dx = (static_cast<float>(j) - c) * inv_f;
    const float inv_vsx = 1.0f / vsx;
    const float inv_vsy = 1.0f / vsy;
    float fp = NAN;
    for (int zg = 0; zg < Zp; ++zg) {
      const float t_m = static_cast<float>(zg) * vsz - oz;
      const bool t_ok = t_m > 1e-6f && t_m <= t_cover;
      const float ts = fmaxf(t_m, 1e-6f);
      const float yv = (oy + dy * ts) * inv_vsy;
      const float xv = (ox + dx * ts) * inv_vsx;
      const int yi = kinfu::rint_clamped(yv);
      const int xi = kinfu::rint_clamped(xv);
      const bool valid = t_ok && zg >= 1 && zg < Zp - 1 && yi >= 1 && yi < Yp - 1 &&
                         xi >= 1 && xi < Xp - 1;
      float f_new = 0.0f;
      if (valid) {
        f_new = static_cast<float>(tsdf[base + zg * s0 + yi * s1 + xi * s2]) * kinfu::kInvShort;
      }
      // a NaN previous sample fails both comparisons (no event)
      const bool front = valid && fp > 0.0f && f_new < 0.0f;
      const bool bk = valid && fp < 0.0f && f_new > 0.0f;
      if (front) {
        const float denom = fp - f_new;
        const float frac = fp / (fabsf(denom) < 1e-30f ? 1e-30f : denom);
        ht = t_m - vsz + vsz * frac;
      }
      if (bk) bt = t_m;
      const bool exit_out = ((xi >= Xp - 1 && dx > 0.0f) || (xi <= 0 && dx < 0.0f) ||
                             (yi >= Yp - 1 && dy > 0.0f) || (yi <= 0 && dy < 0.0f)) &&
                            t_ok;
      if (!front && !bk && exit_out) bt = t_m;
      fp = valid ? f_new : NAN;
      if (ht < kinfu::kInf || bt < kinfu::kInf) break;  // resolved
    }
  }
  hit[static_cast<long long>(i) * F + j] = ht;
  back[static_cast<long long>(i) * F + j] = bt;
}

}  // namespace

extern "C" int kinfu_sweep_rays(const void* tsdf, const void* prm, void* hit, void* back,
                                int nZ, int nY, int nX, int ax0, int ax1, int ax2, int flip,
                                int F, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((F + block.x - 1) / block.x, (F + block.y - 1) / block.y);
  sweep_rays_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const short*>(tsdf), static_cast<const float*>(prm),
      static_cast<float*>(hit), static_cast<float*>(back), nZ, nY, nX, ax0, ax1, ax2, flip,
      F);
  return static_cast<int>(cudaGetLastError());
}
