// K2: the mip-stacked face image of one frame.
//
// Replaces the Pallas kernel kinfu_tpu/ops/facewarp.py::_build_face_kernel
// (L285-350, pallas_call at L384). One thread per pixel of the
// [stack_rows, size] stack: row r lies in mip level l (rows of a level are
// padded to a multiple of 8) and pixel (i, j) of level l samples the camera
// frame along the primed ray of face pixel (i<<l, j<<l). The colour is
// loaded as int32 directly (the TPU kernel gathers it as float32, L335-336).
// Plain version: ops/facewarp.py::build_face_plain; it must agree bit for
// bit, so every expression keeps the plain version's operation order and
// the build uses -fmad=false.
//
// Bound on this card: tiny (0.8 M threads, one 4-byte gather of depth and
// colour each, 2.5 MB out), launch-bound at the main path's shape; the
// design does nothing beyond being right.
#include <cuda_runtime.h>

#include "gather2d.cuh"

namespace {

__global__ void build_face_kernel(const float* __restrict__ depth,
                                  const int* __restrict__ col,
                                  const float* __restrict__ prm,
                                  short* __restrict__ range_out,
                                  int* __restrict__ color_out, int h, int w,
                                  int size, int levels, int stack_rows) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (j >= size || r >= stack_rows) return;
  const long long o = static_cast<long long>(r) * size + j;
  if (prm[13] == 0.0f) {  // face gate off: an empty stack
    range_out[o] = 0;
    color_out[o] = 0;
    return;
  }
  int lvl = levels - 1, off = 0;
  for (int l = 0; l < levels; ++l) {
    const int rows = ((size >> l) + 7) & ~7;
    if (r < off + rows) {
      lvl = l;
      break;
    }
    off += rows;
  }
  const float scale = static_cast<float>(1 << lvl);
  const float wl = static_cast<float>(size >> lvl);
  const float ii = static_cast<float>(r - off);
  const float jj = static_cast<float>(j);
  // the face focal and the camera focals are static in the JAX package,
  // whose compiler turns a division by them into a multiplication by the
  // float32 reciprocal; 1.0f / x is that reciprocal (IEEE division)
  const float inv_f = 1.0f / prm[14], c = prm[15];
  const float fx = prm[9], fy = prm[10], cx = prm[11], cy = prm[12];
  const float inv_fx = 1.0f / fx, inv_fy = 1.0f / fy;

  const float dpx = (jj * scale - c) * inv_f;
  const float dpy = (ii * scale - c) * inv_f;
  const float dcx = prm[0] * dpx + prm[1] * dpy + prm[2];
  const float dcy = prm[3] * dpx + prm[4] * dpy + prm[5];
  const float dcz = prm[6] * dpx + prm[7] * dpy + prm[8];
  const bool in_front = dcz > 1e-6f;
  const float zs = in_front ? dcz : 1.0f;
  const int u = kinfu::rint_clamped(dcx / zs * fx + cx);
  const int v = kinfu::rint_clamped(dcy / zs * fy + cy);
  const bool inb = in_front && u >= 0 && u < w && v >= 0 && v < h;
  const float d = kinfu::gather2d(depth, h, w, v, u);
  const int cval = kinfu::gather2d(col, h, w, v, u);

  // range of the ROUNDED pixel's ray: depth * ||K^-1 [u, v, 1]|| in mm
  const float lx = (static_cast<float>(u) - cx) * inv_fx;
  const float ly = (static_cast<float>(v) - cy) * inv_fy;
  const float lam = sqrtf(lx * lx + ly * ly + 1.0f);
  float r_mm = d * lam * 1000.0f;
  const bool valid = inb && d > 0.0f;
  r_mm = valid ? fminf(fmaxf(r_mm, 1.0f), 32767.0f) : 0.0f;
  const bool keep = ii < wl && jj < wl;  // level padding stays zero
  range_out[o] = keep ? static_cast<short>(static_cast<int>(r_mm)) : 0;
  color_out[o] = (keep && valid) ? cval : 0;
}

}  // namespace

extern "C" int kinfu_build_face(const void* depth, const void* col, const void* prm,
                                void* range_out, void* color_out, int h, int w,
                                int size, int levels, void* stream) {
  int stack_rows = 0;
  for (int l = 0; l < levels; ++l) stack_rows += ((size >> l) + 7) & ~7;
  const dim3 block(128, 1);
  const dim3 grid((size + block.x - 1) / block.x, stack_rows);
  build_face_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depth), static_cast<const int*>(col),
      static_cast<const float*>(prm), static_cast<short*>(range_out),
      static_cast<int*>(color_out), h, w, size, levels, stack_rows);
  return static_cast<int>(cudaGetLastError());
}
