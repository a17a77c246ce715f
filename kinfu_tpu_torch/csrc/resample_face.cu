// K5: the raycast's resample and composite over the six cube faces, in one
// launch: each camera pixel takes the face that owns its ray, that face's
// nearest face pixel, and writes the vertex, normal and valid flag of the
// composite in the volume frame.
//
// Replaces the Pallas kernel kinfu_tpu/ops/pallas_raycast.py::_resample_kernel
// (L579-624; pallas_call in _resample_face at L644), launched there once per
// face, together with the glue around it: the exact ownership test and the
// unprime of _face_pass (L690-718) and the fused step's composite over the
// faces (kinfu_tpu/ops/fused_step.py:132-144). Ownership is an exact
// partition of the camera rays (each face's primed ray is a signed
// permutation of the same three sums), so the composite keeps what the one
// owning face gives and a single pass over the camera grid does the work of
// the six resamples.
//
// Per camera pixel, one thread, for each face f in face order whose device
// gate is set (the parameter block and the gates are in shared memory):
//   d' = A_f [lx, ly, 1] element-wise, lx = (u - cx) * (1 / fx);
//   own: d'z > 0 and |d'x| (<, or <= when !gt_x) d'z, the same for y;
//   the nearest face pixel rint(f d'/d'z + c) of a forward ray (d'z > 1e-6),
//   gathered through gather2d.cuh: t and normal';
//   where t < 1e30: p' = org' + d' / max(d'z, 1e-9) * t, unprimed by the
//   face's signed permutation as an index and a sign: p[axis_i] =
//   sign_i (p'_i - off_i), n[axis_i] = sign_i n'_i; valid if any |n| > 0.
// A later owner overwrites an earlier one, as the face loop of the plain
// version does (it never happens: at most one face owns a ray). Pixels no
// gated face owns, or whose owner has no surface there, get zeros.
// Plain version: ops/face_raycast.py::resample_composite_plain; the build
// uses -fmad=false so every product and sum rounds as it does there.
//
// Parameter block, per face, f32[24]: A (9, row-major), org' (3), off (3),
// the natural axis of each primed axis (3), its sign (3), gt_x, gt_y, spare.
//
// Bound on this card: memory. The face fields are read once where an owned
// pixel samples them (16 bytes a face pixel), and the camera grid's vertex,
// normal and valid flag are written once (25 bytes a pixel): ~14 MB at
// 640x480 when one face covers the view, ~4 us at 3.35 TB/s. The six faces'
// fields arrive as six pointers, so nothing is stacked or copied first.
#include <cuda_runtime.h>

#include "gather2d.cuh"

namespace {

constexpr int kFaces = 6;
constexpr int kCols = 24;

struct FaceFields {
  const float* t[kFaces];
  const float* n[kFaces];
};

__global__ void resample_face_kernel(FaceFields faces, const float* __restrict__ prm,
                                     const unsigned char* __restrict__ gates,
                                     float* __restrict__ vertex, float* __restrict__ normal,
                                     unsigned char* __restrict__ valid, float fx, float fy,
                                     float cx, float cy, float focal, float centre, int h,
                                     int w, int F) {
  __shared__ float s_prm[kFaces * kCols];
  __shared__ int s_gate[kFaces];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < kFaces * kCols; i += blockDim.x * blockDim.y) s_prm[i] = prm[i];
  if (tid < kFaces) s_gate[tid] = gates[tid] != 0;
  __syncthreads();

  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y * blockDim.y + threadIdx.y;
  if (u >= w || v >= h) return;
  // the focal lengths are static in the JAX package, whose compiler
  // multiplies by their float32 reciprocals instead of dividing
  const float lx = (static_cast<float>(u) - cx) * (1.0f / fx);
  const float ly = (static_cast<float>(v) - cy) * (1.0f / fy);

  float pv[3] = {0.0f, 0.0f, 0.0f};
  float nv[3] = {0.0f, 0.0f, 0.0f};
  bool ok_any = false;
  for (int f = 0; f < kFaces; ++f) {
    if (!s_gate[f]) continue;
    const float* p = s_prm + f * kCols;
    const float d[3] = {p[0] * lx + p[1] * ly + p[2], p[3] * lx + p[4] * ly + p[5],
                        p[6] * lx + p[7] * ly + p[8]};
    const float adx = fabsf(d[0]), ady = fabsf(d[1]), dz = d[2];
    const bool own_x = p[21] != 0.0f ? adx < dz : adx <= dz;
    const bool own_y = p[22] != 0.0f ? ady < dz : ady <= dz;
    if (!(dz > 0.0f && own_x && own_y)) continue;

    const bool fwd = dz > 1e-6f;
    const float zs = fwd ? dz : 1.0f;
    const int fu = kinfu::rint_clamped(focal * d[0] / zs + centre);
    const int fv = kinfu::rint_clamped(focal * d[1] / zs + centre);
    if (!(fwd && fu >= 0 && fu < F && fv >= 0 && fv < F)) continue;
    const float t = kinfu::gather2d(faces.t[f], F, F, fv, fu);
    if (!(t < kinfu::kInf)) continue;

    const float dzc = fmaxf(dz, 1e-9f);
    bool nz = false;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int axis = static_cast<int>(p[15 + i]);
      const float sign = p[18 + i];
      const float q = p[9 + i] + d[i] / dzc * t - p[12 + i];
      const float n = sign * kinfu::gather2d_ch(faces.n[f], F, F, 3, fv, fu, i);
      pv[axis] = sign * q;
      nv[axis] = n;
      nz = nz || fabsf(n) > 0.0f;
    }
    ok_any = ok_any || nz;
  }
  const long long o = static_cast<long long>(v) * w + u;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    vertex[o * 3 + k] = pv[k];
    normal[o * 3 + k] = nv[k];
  }
  valid[o] = ok_any ? 1 : 0;
}

}  // namespace

extern "C" int kinfu_resample_face(const void* t_f, const void* n_f, const void* prm,
                                   const void* gates, void* vertex, void* normal, void* valid,
                                   float fx, float fy, float cx, float cy, float focal,
                                   float centre, int h, int w, int F, void* stream) {
  FaceFields faces;
  for (int f = 0; f < kFaces; ++f) {
    faces.t[f] = static_cast<const float* const*>(t_f)[f];
    faces.n[f] = static_cast<const float* const*>(n_f)[f];
  }
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  resample_face_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      faces, static_cast<const float*>(prm), static_cast<const unsigned char*>(gates),
      static_cast<float*>(vertex), static_cast<float*>(normal),
      static_cast<unsigned char*>(valid), fx, fy, cx, cy, focal, centre, h, w, F);
  return static_cast<int>(cudaGetLastError());
}
