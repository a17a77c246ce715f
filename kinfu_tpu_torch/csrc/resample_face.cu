// K5: nearest-face-pixel resample of one face's (t, normal') onto the
// camera grid.
//
// Replaces the Pallas kernel kinfu_tpu/ops/pallas_raycast.py::_resample_kernel
// (L579-624; pallas_call in _resample_face at L644). One thread per camera
// pixel forms the primed direction A [lx, ly, 1], checks that it points
// forward, takes the nearest face pixel rint(f d'/d'z + c) and gathers t and
// the three normal channels through gather2d.cuh; +inf (1e30) and 0 outside
// the face or where the face gate is 0. Plain version:
// ops/face_raycast.py::resample_face_plain; the build uses -fmad=false.
//
// Bound on this card: tiny (0.3 M threads, 16 bytes gathered each at
// 640x480), launch-bound; the design does nothing beyond being right.
#include <cuda_runtime.h>

#include "gather2d.cuh"

namespace {

__global__ void resample_face_kernel(const float* __restrict__ t_f,
                                     const float* __restrict__ n_f,
                                     const float* __restrict__ prm, float* __restrict__ t_out,
                                     float* __restrict__ n_out, int h, int w, int F) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y * blockDim.y + threadIdx.y;
  if (u >= w || v >= h) return;
  const long long o = static_cast<long long>(v) * w + u;
  const float fx = prm[9], fy = prm[10], cx = prm[11], cy = prm[12];
  const float f = prm[14], c = prm[15];
  bool inb = false;
  int fu = 0, fv = 0;
  if (prm[13] != 0.0f) {
    // the focal lengths are static in the JAX package, whose compiler
    // multiplies by their float32 reciprocals instead of dividing
    const float lx = (static_cast<float>(u) - cx) * (1.0f / fx);
    const float ly = (static_cast<float>(v) - cy) * (1.0f / fy);
    const float dpx = prm[0] * lx + prm[1] * ly + prm[2];
    const float dpy = prm[3] * lx + prm[4] * ly + prm[5];
    const float dpz = prm[6] * lx + prm[7] * ly + prm[8];
    const bool fwd = dpz > 1e-6f;
    const float zs = fwd ? dpz : 1.0f;
    fu = kinfu::rint_clamped(f * dpx / zs + c);
    fv = kinfu::rint_clamped(f * dpy / zs + c);
    inb = fwd && fu >= 0 && fu < F && fv >= 0 && fv < F;
  }
  t_out[o] = inb ? kinfu::gather2d(t_f, F, F, fv, fu) : kinfu::kInf;
  for (int k = 0; k < 3; ++k) {
    n_out[o * 3 + k] = inb ? kinfu::gather2d_ch(n_f, F, F, 3, fv, fu, k) : 0.0f;
  }
}

}  // namespace

extern "C" int kinfu_resample_face(const void* t_f, const void* n_f, const void* prm,
                                   void* t_out, void* n_out, int h, int w, int F,
                                   void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  resample_face_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t_f), static_cast<const float*>(n_f),
      static_cast<const float*>(prm), static_cast<float*>(t_out), static_cast<float*>(n_out),
      h, w, F);
  return static_cast<int>(cudaGetLastError());
}
