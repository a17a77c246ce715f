// K4: the plane-sweep march of one cube face's rays through the TSDF.
//
// Replaces the Pallas kernel kinfu_tpu/ops/pallas_raycast.py::_sweep_kernel
// (L114-284; pallas_call in _sweep_face_rays at L465). One thread per face
// ray d' = ((j-c)/f, (i-c)/f, 1) marches the primed planes in order, one
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
// view at 512^3; chip_smoke.py counts them with sweep_rays_work). What holds
// the march back is not bytes: each plane's sample decides whether the ray
// stops there, most face rays miss and cross the whole volume, and a warp
// runs as long as its longest ray. With kBatch loads in flight the time no
// longer follows kBatch (4, 8 and 16 measure alike), so it is set by
// instruction issue over the marched planes; the intervals are a small part.
//
// Design:
//   - Each ray marches only its interval [z_first, z_last]: z_first is the
//     first plane where its sample can be valid or an outward exit can fire,
//     z_last the plane where the exit fires (the ray resolves there at the
//     latest) or else its last valid plane. Every condition is monotone in
//     the plane index (t_m, and each axis's sample index, move one way), so
//     bisection on the march's own float expressions finds the interval
//     exactly. The valid planes are then one run [z_first, v_last]: before
//     it the march would carry fp = NaN and change nothing, inside it no exit
//     can fire, and past it only the exit at z_last. So the kernel samples
//     the run with the same expressions as before but without the per-plane
//     bounds and exit tests, and sets back = t at z_last for a ray that the
//     run left unresolved. Plain twin: ops/face_raycast.py::ray_plane_interval.
//   - The run goes kBatch planes at a time: their loads into registers, then
//     the front/back rules in plane order, breaking at the same plane as
//     before. kBatch loads are in flight per thread, at most kBatch - 1 read
//     past the plane that resolves the ray.
//   - A 32x8 block lies inside one 8x128 ownership tile, so its first warp
//     tests the tile once for the block.
//
// Shard form (_sweep_face_rays' dims_global, plane0, row0, L287-317, called
// from kinfu_tpu/parallel/sharded.py::_ray_face_local): the volume is one
// rank's halo-padded slab of a primed volume of Zg planes and Yg rows,
// whose local plane 0 is global plane plane0 and whose local row 0 is
// global row row0. A ray marches only the local planes, at their global
// t, and samples on the global grid; a sample is valid only inside the
// local rows and inside the global [1, N-2] bounds, and the outward exit
// tests the global dims. Events outside the buffer stay +inf for the
// caller's min across ranks. With plane0 = row0 = 0 and the local dims as
// the global ones, every expression is the unsharded one.
#include <cmath>

#include <cuda_runtime.h>

#include "gather2d.cuh"

namespace {

constexpr int kBatch = 8;
constexpr unsigned kFull = 0xffffffffu;

// the ray parameter of local plane z, whose global index is plane0 + z
struct Planes {
  int plane0;
  float vsz, oz;
  __device__ __forceinline__ float t(int z) const {
    return static_cast<float>(plane0 + z) * vsz - oz;
  }
};

// the global sample index along one primed axis at local plane z
__device__ __forceinline__ int axis_index(int z, const Planes& pl, float o, float d,
                                          float inv_vs) {
  const float ts = fmaxf(pl.t(z), 1e-6f);
  return kinfu::rint_clamped((o + d * ts) * inv_vs);
}

// first plane of [0, n) where `pred` holds, n if none; pred is false, then
// true, along the planes
template <class Pred>
__device__ int first_plane(int n, Pred pred) {
  int a = 0, b = n;
  while (a < b) {
    const int m = (a + b) >> 1;
    if (pred(m)) {
      b = m;
    } else {
      a = m + 1;
    }
  }
  return a;
}

// One primed axis of N global voxels whose valid samples lie in [lo, hi]
// (the global [1, N-2], or its rows held by the local buffer): the first
// local plane whose sample lies in [lo, hi] when the ray moves inward
// (*in_lo), the first past that range (*in_end) and the first of the outward
// exit of the global volume (*out), Zl if none; the sample is valid on
// [*in_lo, *in_end). Unsharded, hi + 1 = N - 1 and lo - 1 = 0, so *in_end is
// *out.
__device__ void axis_span(int Zl, int N, int lo, int hi, const Planes& pl, float o, float d,
                          float inv_vs, int* in_lo, int* in_end, int* out) {
  auto idx = [&](int z) { return axis_index(z, pl, o, d, inv_vs); };
  if (d > 0.0f) {
    *in_lo = first_plane(Zl, [&](int z) { return idx(z) >= lo; });
    *in_end = first_plane(Zl, [&](int z) { return idx(z) > hi; });
    *out = first_plane(Zl, [&](int z) { return idx(z) >= N - 1; });
  } else if (d < 0.0f) {
    *in_lo = first_plane(Zl, [&](int z) { return idx(z) <= hi; });
    *in_end = first_plane(Zl, [&](int z) { return idx(z) < lo; });
    *out = first_plane(Zl, [&](int z) { return idx(z) <= 0; });
  } else {  // the sample stays where it is and never exits
    const int i = idx(0);
    *in_lo = i >= lo && i <= hi ? 0 : Zl;
    *in_end = Zl;
    *out = Zl;
  }
}

// The lengths in elements of the kernel's arrays, from the tensors the
// wrapper passes (checked.cuh).
struct Lens {
  long long tsdf, prm, hit, back;
};

__global__ void __launch_bounds__(256)
sweep_rays_kernel(const short* __restrict__ tsdf, const float* __restrict__ prm,
                  float* __restrict__ hit, float* __restrict__ back, int nZ, int nY, int nX,
                  int ax0, int ax1, int ax2, int flip, int F, int Zg, int Yg, int plane0,
                  int row0, Lens L) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  auto P = [&](int k) { return KINFU_AT(prm, L.prm, k); };
  const float ox = P(0), oy = P(1), oz = P(2);
  const float vsx = P(3), vsy = P(4), vsz = P(5);
  // the face focal is static in the JAX package, whose compiler multiplies
  // by its float32 reciprocal instead of dividing
  const float inv_f = 1.0f / P(6), c = P(7), t_cover = P(8), own_tan = P(9);

  // any pixel of the block's 8-row tile and of its 128-column tile lies
  // inside the padded cone
  __shared__ bool s_owned;
  if (threadIdx.y == 0) {
    const int lane = threadIdx.x;
    const int q0 = (blockIdx.x * blockDim.x / 128) * 128;
    bool col = false;
    for (int q = q0 + lane; q < q0 + 128; q += 32) {
      col = col || fabsf((static_cast<float>(q) - c) * inv_f) <= own_tan;
    }
    const bool row =
        lane < 8 && fabsf((static_cast<float>(blockIdx.y * 8 + lane) - c) * inv_f) <= own_tan;
    const bool owned = __any_sync(kFull, col) && __any_sync(kFull, row);
    if (lane == 0) s_owned = owned;
  }
  __syncthreads();
  if (i >= F || j >= F) return;
  float ht = kinfu::kInf, bt = kinfu::kInf;

  if (P(10) != 0.0f && s_owned) {
    const int dims[3] = {nZ, nY, nX};
    const long long strides[3] = {static_cast<long long>(nY) * nX, nX, 1};
    // local primed dims; the lanes (primed x) are never sharded
    const int Zl = dims[ax0], Yl = dims[ax1], Xp = dims[ax2];
    long long s0 = strides[ax0];
    const long long s1 = strides[ax1], s2 = strides[ax2];
    // local row r of the buffer holds global row row0 + r
    long long base = -static_cast<long long>(row0) * s1;
    if (flip) {
      base += (Zl - 1) * s0;
      s0 = -s0;
    }
    const Planes pl{plane0, vsz, oz};
    const float dy = (static_cast<float>(i) - c) * inv_f;
    const float dx = (static_cast<float>(j) - c) * inv_f;
    const float inv_vsx = 1.0f / vsx;
    const float inv_vsy = 1.0f / vsy;

    // the interval: t_ok on [p_t, p_c), the global planes [1, Zg-2] on
    // [z_lo, z_end), each axis valid on [*_in, *_end), an exit from the first
    // plane of either axis's exit
    const int p_t = first_plane(Zl, [&](int z) { return pl.t(z) > 1e-6f; });
    const int p_c = first_plane(Zl, [&](int z) { return pl.t(z) > t_cover; });
    const int z_lo = max(1 - plane0, 0), z_end = min(Zg - 1 - plane0, Zl);
    int x_in, x_end, x_out, y_in, y_end, y_out;
    axis_span(Zl, Xp, 1, Xp - 2, pl, ox, dx, inv_vsx, &x_in, &x_end, &x_out);
    axis_span(Zl, Yg, max(row0, 1), min(row0 + Yl - 1, Yg - 2), pl, oy, dy, inv_vsy, &y_in,
              &y_end, &y_out);
    const int v_lo = max(max(p_t, z_lo), max(x_in, y_in));
    const int v_hi = min(min(p_c, z_end), min(x_end, y_end)) - 1;
    const int e = max(p_t, min(x_out, y_out));
    const bool exits = e < p_c;

    // the valid run [v_lo, v_hi], kBatch planes at a time: their loads, then
    // the front / back rules in plane order (no exit can fire before e, past
    // v_hi); fp is NaN at v_lo, whose previous plane is not valid
    float fp = NAN;
    bool done = false;
    for (int z0 = v_lo; z0 <= v_hi && !done; z0 += kBatch) {
      short raw[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int z = z0 + k;
        raw[k] = 0;
        if (z <= v_hi) {
          const float ts = fmaxf(pl.t(z), 1e-6f);
          const float yv = (oy + dy * ts) * inv_vsy;
          const float xv = (ox + dx * ts) * inv_vsx;
          // rint_clamped's clamp is idle here: the indices lie in [1, N-2]
          raw[k] = KINFU_AT(tsdf, L.tsdf,
                            base + z * s0 + __float2int_rn(yv) * s1 + __float2int_rn(xv) * s2);
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int z = z0 + k;
        if (done || z > v_hi) break;
        const float f_new = static_cast<float>(raw[k]) * kinfu::kInvShort;
        // a NaN previous sample fails both comparisons (no event)
        const bool front = fp > 0.0f && f_new < 0.0f;
        const bool bk = fp < 0.0f && f_new > 0.0f;
        if (front) {
          const float denom = fp - f_new;
          const float frac = fp / (fabsf(denom) < 1e-30f ? 1e-30f : denom);
          ht = pl.t(z) - vsz + vsz * frac;
        }
        if (bk) bt = pl.t(z);
        fp = f_new;
        done = front || bk;  // resolved
      }
    }
    // unresolved: the outward exit at e, whose sample is not valid
    if (!done && exits) bt = pl.t(e);
  }
  KINFU_AT(hit, L.hit, static_cast<long long>(i) * F + j) = ht;
  KINFU_AT(back, L.back, static_cast<long long>(i) * F + j) = bt;
}

}  // namespace

// lens: the four arrays' lengths in elements, in argument order (int64)
extern "C" int kinfu_sweep_rays(const void* tsdf, const void* prm, void* hit, void* back,
                                int nZ, int nY, int nX, int ax0, int ax1, int ax2, int flip,
                                int F, int Zg, int Yg, int plane0, int row0, const void* lens,
                                void* stream) {
  // a block must lie inside one 8x128 ownership tile
  if (F % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long* n = static_cast<const long long*>(lens);
  const Lens L{n[0], n[1], n[2], n[3]};
  const dim3 block(32, 8);
  const dim3 grid(F / block.x, F / block.y);
  sweep_rays_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const short*>(tsdf), static_cast<const float*>(prm),
      static_cast<float*>(hit), static_cast<float*>(back), nZ, nY, nX, ax0, ax1, ax2, flip,
      F, Zg, Yg, plane0, row0, L);
  return static_cast<int>(cudaGetLastError());
}
