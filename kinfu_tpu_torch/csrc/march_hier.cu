// M2: the two-level march, one thread per camera ray.
//
// Replaces no TPU kernel: the JAX package runs this march outside Pallas,
// as one lax.while_loop over all rays in lockstep whose condition,
// any(alive) & (k < max_iters), the device evaluates
// (kinfu_tpu/volume/raycast.py::march_hier, L299-447). Its plain PyTorch
// twin, volume/raycast.py::march_hier, tests that condition on the host
// once a loop step and compacts the live rays there; this kernel is the
// device form of the loop and makes no host read. Rays are independent and
// a dead ray changes nothing, so the lockstep loop's iteration index
// equals each live ray's own iteration count: a per-ray loop with the same
// bound, max_iters, gives the same events. The twin's compaction only
// saves work and has no counterpart here.
//
// Per ray, from t = t_start in coarse mode, while t < t_end, at most
// max_iters iterations, one read each:
//   coarse: the 8^3 occupancy cell that holds the sample at t (DDA over
//     build_occupancy's grid, the cell clamped into it) and the t where the
//     ray leaves that cell; an empty cell is skipped to
//     max(t_exit + 0.05 step, t + 0.25 step); an occupied one drops the ray
//     to fine steps from max(t - 2 step, t_start - step) until the step
//     that reaches that cell's exit (fine_until);
//   fine: the nearest-voxel sample at t + step, valid inside [1, dims-2];
//     the +,- front (refined hit) and the -,+ back event of two
//     consecutive valid samples end the ray.
// The twin reads both modes' indices from one concatenated table; the
// kernel reads the volume or the occupancy grid directly, so nothing is
// concatenated. The products 0.05 step, 0.25 step and 2 step are formed
// in double on the host and rounded to float32, as PyTorch rounds a
// Python scalar, and arrive as arguments.
//
// Bound on this card: bytes and latency, as M1 (march_rays.cu): one int16
// voxel or one occupancy byte per iteration of a live ray. The build uses
// -fmad=false.
#include <cuda_runtime.h>

#include "march.cuh"

namespace {

constexpr int kThreads = 256;

// The lengths in elements of the kernel's arrays, from the tensors the
// wrapper passes (checked.cuh); 0 for an array not passed.
struct Lens {
  long long tsdf, occ, org, dirs, t_start, t_end, inv_vs, hit, back;
};

// the float scalars of the loop, each a float32 rounded on the host
struct Steps {
  float step, skip, min_skip, back2;  // step, 0.05 step, 0.25 step, 2 step
};

__global__ void __launch_bounds__(kThreads)
march_hier_kernel(const short* __restrict__ tsdf, const unsigned char* __restrict__ occ,
                  const float* __restrict__ org, const float* __restrict__ dirs,
                  const float* __restrict__ t_start, const float* __restrict__ t_end,
                  const float* __restrict__ inv_vs, float* __restrict__ hit,
                  float* __restrict__ back, int n_rays, int Z, int Y, int X, int block,
                  int max_iters, Steps S, Lens L) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  kinfu::Ray r;
  float vs[3], safe[3];
  bool pos[3];
  for (int c = 0; c < 3; ++c) {
    r.o[c] = KINFU_AT(org, L.org, c);
    r.d[c] = KINFU_AT(dirs, L.dirs, 3LL * i + c);
    r.inv_vs[c] = KINFU_AT(inv_vs, L.inv_vs, c);
    vs[c] = 1.0f / r.inv_vs[c];  // an IEEE float32 divide: no fast math
    safe[c] = fabsf(r.d[c]) < 1e-12f ? 1e-12f : r.d[c];
    pos[c] = r.d[c] > 0.0f;
  }
  const int dims[3] = {X, Y, Z};
  const int cells[3] = {X / block, Y / block, Z / block};
  const float fblock = static_cast<float>(block);
  const float ts = KINFU_AT(t_start, L.t_start, i);
  const float te = KINFU_AT(t_end, L.t_end, i);

  float t = ts, f_prev = 0.0f, fine_until = -kinfu::kInf;
  bool v_prev = false, coarse = true, alive = t < te;
  float ht = kinfu::kInf, bt = kinfu::kInf;
  for (int it = 0; it < max_iters && alive; ++it) {
    const float tnext = t + S.step;
    float t_new;
    bool ended = false;
    if (coarse) {
      // the cell of the sample at t, and the t of its exit along each axis
      int cc[3];
      float t_exit = 0.0f;
      for (int c = 0; c < 3; ++c) {
        // p / block: a power of two, so the same as the twin's division
        const int cell = kinfu::floor_clamped(r.vox(c, t) / fblock);
        cc[c] = min(max(cell, 0), cells[c] - 1);
        const float bound_vox =
            static_cast<float>(static_cast<long long>(cell) + (pos[c] ? 1 : 0)) * fblock;
        const float t_ax = (bound_vox * vs[c] - r.o[c]) / safe[c];
        t_exit = c == 0 ? t_ax : kinfu::nan_min(t_exit, t_ax);
      }
      const long long ci = (static_cast<long long>(cc[2]) * cells[1] + cc[1]) * cells[0] + cc[0];
      if (KINFU_AT(occ, L.occ, ci)) {
        t_new = kinfu::nan_max(t - S.back2, ts - S.step);
        fine_until = t_exit;
        coarse = false;
      } else {
        t_new = kinfu::nan_max(t_exit + S.skip, t + S.min_skip);
      }
      f_prev = 0.0f;
      v_prev = false;
    } else {
      // the nearest voxel of the sample at t + step
      int idx[3];
      bool v_next = true;
      for (int c = 0; c < 3; ++c) {
        idx[c] = kinfu::rint_clamped(r.vox(c, tnext));
        v_next = v_next && idx[c] >= 1 && idx[c] < dims[c] - 1;
      }
      long long lin = (static_cast<long long>(idx[2]) * Y + idx[1]) * X + idx[0];
      lin = min(max(lin, 0LL), static_cast<long long>(Z) * Y * X - 1);
      const float f_next = static_cast<float>(KINFU_AT(tsdf, L.tsdf, lin)) * kinfu::kInvShort;
      ended = v_prev && v_next && kinfu::crossing(f_prev, f_next, t, tnext, S.step, &ht, &bt);
      t_new = tnext;
      coarse = tnext >= fine_until;
      f_prev = f_next;
      v_prev = v_next;
    }
    alive = !ended && t_new < te;
    t = t_new;
  }
  KINFU_AT(hit, L.hit, i) = ht;
  KINFU_AT(back, L.back, i) = bt;
}

}  // namespace

// lens: the nine arrays' lengths in elements, in argument order (int64)
extern "C" int kinfu_march_hier(const void* tsdf, const void* occ, const void* org,
                                const void* dirs, const void* t_start, const void* t_end,
                                const void* inv_vs, void* hit, void* back, int n_rays,
                                int Z, int Y, int X, int block, int max_iters,
                                float step, float skip, float min_skip, float back2,
                                const void* lens, void* stream) {
  const long long* n = static_cast<const long long*>(lens);
  const Lens L{n[0], n[1], n[2], n[3], n[4], n[5], n[6], n[7], n[8]};
  if (block <= 0 || Z % block || Y % block || X % block) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  march_hier_kernel<<<(n_rays + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const short*>(tsdf), static_cast<const unsigned char*>(occ),
      static_cast<const float*>(org), static_cast<const float*>(dirs),
      static_cast<const float*>(t_start), static_cast<const float*>(t_end),
      static_cast<const float*>(inv_vs), static_cast<float*>(hit), static_cast<float*>(back),
      n_rays, Z, Y, X, block, max_iters,
      Steps{step, skip, min_skip, back2}, L);
  return static_cast<int>(cudaGetLastError());
}
