// M1: the step march, one thread per camera ray.
//
// Replaces no TPU kernel: the JAX package runs this march outside Pallas,
// as one lax.while_loop over all rays in lockstep whose condition the
// device evaluates (kinfu_tpu/volume/raycast.py::march, L122-189). Its
// plain PyTorch twin, volume/raycast.py::march, tests that condition on
// the host once a loop step; this kernel is the device form of the loop
// and makes no host read. Rays are independent and a dead ray changes
// nothing, so the lockstep loop's step index equals each live ray's own
// step count: a per-ray loop with the same bound gives the same events.
//
// Per ray: samples on t_k = t_start + k * step from k = k_start (default
// 0), from an integer counter, never accumulated; nearest-voxel samples
// (rint, half to even) valid inside the global [1, dims-2] and inside the
// buffer's rows; while t_k < t_end and for at most max_steps steps: the
// +,- front with its linear refinement (the hit) and the -,+ back event,
// either of which ends the ray (events +inf when none).
//
// One entry serves the full volume (z0h = 0, local_z = Zg) and the Z-slab
// form of the sharded march (parallel/sharded.py::sharded_raycast): a
// halo-padded slab whose local row 0 is global row z0h, the global dims,
// and per-ray k_start and t_end from _local_t_interval.
//
// Bound on this card: bytes and latency. Each step of a live ray reads one
// int16 sample (2 bytes); the rays of a warp sample neighbouring voxels, so
// most of a step's loads share cache lines, but each step waits on its load
// before it can decide whether the ray goes on. The build uses
// -fmad=false: every product and sum rounds as the separate PyTorch
// operations of the twin do.
#include <cuda_runtime.h>

#include "march.cuh"

namespace {

constexpr int kThreads = 256;

// The lengths in elements of the kernel's arrays, from the tensors the
// wrapper passes (checked.cuh); 0 for an array not passed.
struct Lens {
  long long tsdf, org, dirs, t_start, t_end, k_start, inv_vs, hit, back;
};

struct Volume {
  const short* tsdf;
  long long n;
  int local_z, Zg, Y, X, z0h;

  // volume/raycast.py::_sample_nearest at ray parameter t: the value, and
  // whether the sample is valid
  __device__ __forceinline__ float sample(const kinfu::Ray& r, float t, bool* valid) const {
    const int xi = kinfu::rint_clamped(r.vox(0, t));
    const int yi = kinfu::rint_clamped(r.vox(1, t));
    const int zi = kinfu::rint_clamped(r.vox(2, t));
    const int zl = zi - z0h;
    *valid = xi >= 1 && xi < X - 1 && yi >= 1 && yi < Y - 1 && zi >= 1 && zi < Zg - 1 &&
             zl >= 0 && zl < local_z;
    long long lin = (static_cast<long long>(zl) * Y + yi) * X + xi;
    lin = min(max(lin, 0LL), static_cast<long long>(local_z) * Y * X - 1);
    return static_cast<float>(KINFU_AT(tsdf, n, lin)) * kinfu::kInvShort;
  }
};

__global__ void __launch_bounds__(kThreads)
march_rays_kernel(Volume vol, const float* __restrict__ org, const float* __restrict__ dirs,
                  const float* __restrict__ t_start, const float* __restrict__ t_end,
                  const int* __restrict__ k_start, const float* __restrict__ inv_vs,
                  float* __restrict__ hit, float* __restrict__ back, int n_rays,
                  int max_steps, float step, Lens L) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  kinfu::Ray r;
  for (int c = 0; c < 3; ++c) {
    r.o[c] = KINFU_AT(org, L.org, c);
    r.d[c] = KINFU_AT(dirs, L.dirs, 3LL * i + c);
    r.inv_vs[c] = KINFU_AT(inv_vs, L.inv_vs, c);
  }
  const float ts = KINFU_AT(t_start, L.t_start, i);
  const float te = KINFU_AT(t_end, L.t_end, i);
  int k = k_start ? KINFU_AT(k_start, L.k_start, i) : 0;
  // t_of(k): the float32 of k, times step, plus t_start
  auto t_of = [&](int kk) { return ts + static_cast<float>(kk) * step; };

  bool v_prev;
  float f_prev = vol.sample(r, t_of(k), &v_prev);
  bool alive = t_of(k) < te;
  float ht = kinfu::kInf, bt = kinfu::kInf;
  for (int s = 0; s < max_steps && alive; ++s) {
    const float tcur = t_of(k);
    const float tnext = t_of(k + 1);
    bool v_next;
    const float f_next = vol.sample(r, tnext, &v_next);
    const bool ended =
        v_prev && v_next && kinfu::crossing(f_prev, f_next, tcur, tnext, step, &ht, &bt);
    alive = !ended && tnext < te;
    ++k;
    f_prev = f_next;
    v_prev = v_next;
  }
  KINFU_AT(hit, L.hit, i) = ht;
  KINFU_AT(back, L.back, i) = bt;
}

}  // namespace

// lens: the nine arrays' lengths in elements, in argument order (int64);
// k_start may be null
extern "C" int kinfu_march_rays(const void* tsdf, const void* org, const void* dirs,
                                const void* t_start, const void* t_end, const void* k_start,
                                const void* inv_vs, void* hit, void* back, int n_rays,
                                int local_z, int Zg, int Y, int X, int z0h,
                                int max_steps, float step, const void* lens, void* stream) {
  const long long* n = static_cast<const long long*>(lens);
  const Lens L{n[0], n[1], n[2], n[3], n[4], n[5], n[6], n[7], n[8]};
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  const Volume vol{static_cast<const short*>(tsdf), L.tsdf, local_z, Zg, Y, X, z0h};
  march_rays_kernel<<<(n_rays + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      vol, static_cast<const float*>(org), static_cast<const float*>(dirs),
      static_cast<const float*>(t_start), static_cast<const float*>(t_end),
      static_cast<const int*>(k_start), static_cast<const float*>(inv_vs),
      static_cast<float*>(hit), static_cast<float*>(back), n_rays, max_steps, step, L);
  return static_cast<int>(cudaGetLastError());
}
