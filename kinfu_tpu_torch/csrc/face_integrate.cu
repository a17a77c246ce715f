// K3: one cube face's TSDF + colour fusion sweep, in place.
//
// Replaces the Pallas kernel kinfu_tpu/ops/pallas_integrate.py::_kernel
// (L204-390; pallas_calls of _sweep_face at L545 and L558). One thread per
// voxel of the natural [Z, Y, X] volume. The thread maps its voxel to the
// face's primed coordinates through the signed axis permutation (axes,
// flip) instead of copying the volume through the prime/unprime transposes
// (L422-431); the per-plane gate and mip scalars come from a [Zp, 9] table
// that plain PyTorch computes on the device with the same _slab_geometry
// expressions (ops/face_integrate.py::plane_table). Where cover_ok holds,
// the TPU kernel's 3-window row gather (_window_gather, L121-147) reads
// exactly the face pixel that this direct load reads, and cover_ok is part
// of the plane gate. Ownership keeps the gt_x / gt_y tie-break (L316-323),
// the update math keeps the int16 truncation of t (L337-339) and the colour
// band of +-trunc/2 (L341-367). Plain version:
// ops/face_integrate.py::sweep_face_plain; the build uses -fmad=false so
// that both round every operation alike.
//
// Bound on this card: what the inputs need. A voxel it updates costs 4 bytes
// of TSDF and weight read and written, a voxel whose colour it mixes 4 more
// each way, and every voxel of an admitted plane ~24 float operations of
// projection and ownership; other voxels move no volume bytes. On the
// 640x480 orbit's +z view at 512^3 that is 18.75 M updated voxels, 0.24 M
// colour-mixed and 134 M projected: ~0.055 ms, set by the operations
// (chip_smoke.py counts them from sweep_face_plain). One thread per voxel
// of the whole volume is far from it; the design does nothing about it yet.
#include <cuda_runtime.h>

#include "gather2d.cuh"

namespace {

constexpr int kTableCols = 9;  // dz, dzs, au, bu, av, bv, row_off, width, slab_do

__global__ void face_integrate_kernel(short* __restrict__ tsdf, short* __restrict__ weight,
                                      int* __restrict__ color,
                                      const short* __restrict__ frange,
                                      const int* __restrict__ fcolor,
                                      const float* __restrict__ prm,
                                      const float* __restrict__ table, int nZ, int nY,
                                      int nX, int ax0, int ax1, int ax2, int flip,
                                      int gt_x, int gt_y, int F, int stack_rows) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(nZ) * nY * nX;
  if (n >= total || prm[11] == 0.0f) return;  // face gate off: volume unchanged
  const int nat[3] = {static_cast<int>(n / (static_cast<long long>(nY) * nX)),
                      static_cast<int>((n / nX) % nY), static_cast<int>(n % nX)};
  const int dims[3] = {nZ, nY, nX};
  const int j0 = nat[ax0];
  const int zp = flip ? dims[ax0] - 1 - j0 : j0;
  const int yp = nat[ax1];
  const int xp = nat[ax2];
  const float* T = table + static_cast<long long>(zp) * kTableCols;
  if (T[8] == 0.0f) return;  // plane gate (implies dz_ok and cover_ok)

  const float cx = prm[0], cy = prm[1], vsx = prm[3], vsy = prm[4];
  const float trunc_mm = prm[8], max_weight = prm[9];
  // the TPU kernel's operation order: (local * vs - c) + base * vs over
  // 128-lane chunks in x and 8-row strips in y
  const float dx = (static_cast<float>(xp & 127) * vsx - cx) + static_cast<float>(xp & ~127) * vsx;
  const float dy = (static_cast<float>(yp & 7) * vsy - cy) + static_cast<float>(yp & ~7) * vsy;
  const float dz = T[0], dzs = T[1];
  const float au = T[2], bu = T[3], av = T[4], bv = T[5];
  const int row_off = static_cast<int>(T[6]);
  const int width = static_cast<int>(T[7]);

  const float fF = static_cast<float>(F);
  const int u = static_cast<int>(fminf(fmaxf(rintf(au * static_cast<float>(xp) + bu), -1.0f), fF));
  const int v = static_cast<int>(fminf(fmaxf(rintf(av * static_cast<float>(yp) + bv), -1.0f), fF));
  if (u < 0 || u >= width || v < 0 || v >= width) return;

  const float adx = fabsf(dx), ady = fabsf(dy);
  const bool own_x = gt_x ? adx < dzs : adx <= dzs;
  const bool own_y = gt_y ? ady < dzs : ady <= dzs;
  if (!(own_x && own_y)) return;

  const float r_obs = static_cast<float>(kinfu::gather2d(frange, stack_rows, F, row_off + v, u));
  if (!(r_obs > 0.0f)) return;
  const float r_vox = sqrtf(dx * dx + dy * dy + dz * dz) * 1000.0f;
  const float sdf = r_obs - r_vox;
  if (!(sdf >= -trunc_mm)) return;
  // trunc_mm is static in the JAX package, whose compiler multiplies by the
  // float32 reciprocal instead of dividing
  const float tsdf_obs = fminf(sdf * (1.0f / trunc_mm), 1.0f);

  const float t_old = static_cast<float>(tsdf[n]) * kinfu::kInvShort;
  const float w_old = static_cast<float>(weight[n]);
  const float w_new = fminf(w_old + 1.0f, max_weight);
  const float t_new = (t_old * w_old + tsdf_obs) / (w_old + 1.0f);
  const float t_s = fminf(fmaxf(t_new * 32767.0f, -32767.0f), 32767.0f);
  tsdf[n] = static_cast<short>(truncf(t_s));
  weight[n] = static_cast<short>(w_new);

  if (sdf <= trunc_mm * 0.5f && sdf >= -trunc_mm * 0.5f) {
    const int c_old = color[n];
    const int c_obs = kinfu::gather2d(fcolor, stack_rows, F, row_off + v, u);
    int c_new = 0;
    for (int shift = 16; shift >= 0; shift -= 8) {
      const float o = static_cast<float>((c_old >> shift) & 0xFF);
      const float p = static_cast<float>((c_obs >> shift) & 0xFF);
      const float m = (w_new * o + p) / (w_new + 1.0f);
      c_new |= static_cast<int>(fminf(fmaxf(m, 0.0f), 255.0f)) << shift;
    }
    color[n] = c_new;
  }
}

}  // namespace

extern "C" int kinfu_face_integrate(void* tsdf, void* weight, void* color, const void* frange,
                                    const void* fcolor, const void* prm, const void* table,
                                    int nZ, int nY, int nX, int ax0, int ax1, int ax2,
                                    int flip, int gt_x, int gt_y, int F, int stack_rows,
                                    void* stream) {
  const long long total = static_cast<long long>(nZ) * nY * nX;
  const int block = 256;
  const long long grid = (total + block - 1) / block;
  face_integrate_kernel<<<static_cast<unsigned>(grid), block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<short*>(tsdf), static_cast<short*>(weight), static_cast<int*>(color),
      static_cast<const short*>(frange), static_cast<const int*>(fcolor),
      static_cast<const float*>(prm), static_cast<const float*>(table), nZ, nY, nX, ax0,
      ax1, ax2, flip, gt_x, gt_y, F, stack_rows);
  return static_cast<int>(cudaGetLastError());
}
