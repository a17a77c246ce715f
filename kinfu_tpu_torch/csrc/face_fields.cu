// R1: the raycast's shading of the cube faces' hit fields, every face in one
// launch: for each face pixel, from K4's (hit, back) events, the hit
// parameter t, the unit normal' oriented toward the camera and the valid
// flag, with the 3x3 smoothing of t and the silhouette fill.
//
// Replaces no TPU kernel: the JAX package computes this in XLA outside its
// Pallas sweep (kinfu_tpu/ops/pallas_raycast.py::_face_fields, L482-576,
// the neighbours by jnp.roll), and the port ran it as plain torch, ~150
// launches a face (ops/face_raycast.py::face_fields_plain, the twin).
//
// Per face pixel p = (i, j), its neighbours taken modulo F on both axes as
// jnp.roll and torch.roll take them (a border pixel's neighbour lies on the
// opposite edge):
//   ok = hit < back and hit < 1e30; t = ok ? hit : 1e30;
//   wsum, tsum = the 3x3 sums of ok and of min(hit, 1e30) * ok, di outer and
//   dj inner from -1 to 1, starting from 0;
//   t_s = tsum / max(wsum, 1) * ok; v = org' + (dxr, dyr, 1) t_s, where
//   dxr = (j - c) * (1 / f) with the float32 reciprocal from the host;
//   n = (v(i, j+1) - v(i, j-1)) x (v(i+1, j) - v(i-1, j)), term by term as
//   torch.linalg.cross forms it; valid where ok holds at p and its four
//   neighbours, the larger central difference of t is under
//   0.05 max(t, 1e-6), and |n| > 1e-20; n normalised, flipped to face the
//   camera (n . (dxr, dyr, 1) <= 0) and zeroed where not valid;
//   nsum = the 3x3 sum of n; where |nsum| > 1e-20, nsum / |nsum| fills the
//   normal of a hit pixel without a valid one (the rim), and the t
//   (tsum / max(wsum, 1)) and normal of a pixel without a hit beside one
//   (the silhouette fill); valid = valid normal, rim or fill.
// A face whose rays all miss (a gated-off face: K4 writes 1e30) gives
// t = 1e30, n = 0 and valid = 0 everywhere, as the twin does.
//
// The outputs at p need hit and back within 3 pixels: nsum needs n at +-1,
// n needs v at +-1, v needs t_s, whose sums need ok at +-1. A block owns a
// kTileX x kTileY tile of one face (blockIdx.z) and stages it in shared
// memory, the halo shrinking by one a stage: ok, t and tz over the tile
// +-3, read from global memory once a block (the halo's re-reads hit L2);
// wsum, tsum and v over +-2; n over +-1; then the outputs on the tile; a
// barrier between stages.
//
// Bound on this card: memory. hit and back are read once and t, n and
// valid written once: 25 B a face pixel, 61 MB for six faces of 640 x 640,
// 0.018 ms at 3.35 TB/s. The faces' events arrive as pointers a face (the
// one-card step's six K4 outputs, a rank's views of its reduced events),
// so nothing is stacked or copied first.
// Plain version: ops/face_raycast.py::face_fields_plain; the build uses
// -fmad=false with IEEE division and square root, so every sum, product
// and quotient rounds as it does there (the 3-term norms may sum in
// another order there).
#include <cuda_runtime.h>

#include "checked.cuh"
#include "gather2d.cuh"

namespace {

constexpr int kMaxFaces = 6;
// columns of K5's parameter block a face; the primed camera origin is 9:12
constexpr int kCols = 24;
constexpr int kOrigin = 9;
// the output tile of a block, and its threads
constexpr int kTileX = 32;
constexpr int kTileY = 16;
constexpr int kThreads = 256;
// the staged regions: the tile with a halo of 3, 2 and 1 pixels
constexpr int kW3 = kTileX + 6, kH3 = kTileY + 6;
constexpr int kW2 = kTileX + 4, kH2 = kTileY + 4;
constexpr int kW1 = kTileX + 2, kH1 = kTileY + 2;

struct Events {
  const float* hit[kMaxFaces];
  const float* back[kMaxFaces];
};

// The lengths in elements of the kernel's arrays, from the tensors the
// wrapper passes (checked.cuh).
struct Lens {
  long long hit[kMaxFaces], back[kMaxFaces], prm, t, n, valid;
};

// k modulo F in [0, F); the division only where k lies outside
__device__ __forceinline__ int wrap(int k, int F) {
  if (static_cast<unsigned>(k) < static_cast<unsigned>(F)) return k;
  k %= F;
  return k < 0 ? k + F : k;
}

// torch.clamp(x, min=lo) and (x, max=hi): a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

// torch.maximum: NaN where either is NaN
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float ray_slope(int pix, float centre, float rf) {
  return (static_cast<float>(pix) - centre) * rf;
}

__global__ void __launch_bounds__(kThreads)
    face_fields_kernel(Events ev, const float* __restrict__ prm, float* __restrict__ t_out,
                       float* __restrict__ n_out, unsigned char* __restrict__ valid_out, int F,
                       float centre, float rf, Lens L) {
  __shared__ float s_ok[kH3 * kW3], s_t[kH3 * kW3], s_tz[kH3 * kW3];
  __shared__ float s_w[kH2 * kW2], s_tsum[kH2 * kW2], s_v[3][kH2 * kW2];
  __shared__ float s_n[3][kH1 * kW1];
  __shared__ unsigned char s_okn[kH1 * kW1];

  const int f = blockIdx.z;
  const int i0 = blockIdx.y * kTileY, j0 = blockIdx.x * kTileX;
  const int tid = threadIdx.x, nthr = blockDim.x;
  // face f's arrays, picked without indexing the parameter arrays at run
  // time (which would copy them into each thread's local memory)
  const float* hit = ev.hit[0];
  const float* back = ev.back[0];
  long long len_hit = L.hit[0], len_back = L.back[0];
#pragma unroll
  for (int q = 1; q < kMaxFaces; ++q) {
    if (q == f) {
      hit = ev.hit[q];
      back = ev.back[q];
      len_hit = L.hit[q];
      len_back = L.back[q];
    }
  }

  // ok, t and tz over the tile +-3
  for (int k = tid; k < kH3 * kW3; k += nthr) {
    const int r = k / kW3, c = k - r * kW3;
    const long long g = static_cast<long long>(wrap(i0 + r - 3, F)) * F + wrap(j0 + c - 3, F);
    const float h = KINFU_AT(hit, len_hit, g);
    const float b = KINFU_AT(back, len_back, g);
    const bool ok = h < b && h < kinfu::kInf;
    const float okf = ok ? 1.0f : 0.0f;
    s_ok[k] = okf;
    s_t[k] = ok ? h : kinfu::kInf;
    s_tz[k] = clamp_max(h, kinfu::kInf) * okf;
  }
  __syncthreads();

  // the 3x3 sums, t_s and the vertex over +-2
  const float org[3] = {KINFU_AT(prm, L.prm, f * kCols + kOrigin),
                        KINFU_AT(prm, L.prm, f * kCols + kOrigin + 1),
                        KINFU_AT(prm, L.prm, f * kCols + kOrigin + 2)};
  for (int k = tid; k < kH2 * kW2; k += nthr) {
    const int r = k / kW2, c = k - r * kW2;
    const int p3 = (r + 1) * kW3 + (c + 1);
    float wsum = 0.0f, tsum = 0.0f;
    for (int di = -1; di <= 1; ++di) {
      for (int dj = -1; dj <= 1; ++dj) {
        wsum = wsum + s_ok[p3 + di * kW3 + dj];
        tsum = tsum + s_tz[p3 + di * kW3 + dj];
      }
    }
    s_w[k] = wsum;
    s_tsum[k] = tsum;
    const float t_s = tsum / clamp_min(wsum, 1.0f) * s_ok[p3];
    s_v[0][k] = org[0] + ray_slope(wrap(j0 + c - 2, F), centre, rf) * t_s;
    s_v[1][k] = org[1] + ray_slope(wrap(i0 + r - 2, F), centre, rf) * t_s;
    s_v[2][k] = org[2] + t_s;
  }
  __syncthreads();

  // the normal over +-1
  for (int k = tid; k < kH1 * kW1; k += nthr) {
    const int r = k / kW1, c = k - r * kW1;
    const int p3 = (r + 2) * kW3 + (c + 2);
    const int p2 = (r + 1) * kW2 + (c + 1);
    const bool ok_r = s_ok[p3 + 1] != 0.0f && s_ok[p3 - 1] != 0.0f && s_ok[p3 + kW3] != 0.0f &&
                      s_ok[p3 - kW3] != 0.0f && s_ok[p3] != 0.0f;
    float du[3], dv[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      du[m] = s_v[m][p2 + 1] - s_v[m][p2 - 1];
      dv[m] = s_v[m][p2 + kW2] - s_v[m][p2 - kW2];
    }
    float n[3] = {du[1] * dv[2] - du[2] * dv[1], du[2] * dv[0] - du[0] * dv[2],
                  du[0] * dv[1] - du[1] * dv[0]};
    const float tmag = clamp_min(s_t[p3], 1e-6f);
    const float disc = maximum(fabsf(s_t[p3 + 1] - s_t[p3 - 1]),
                               fabsf(s_t[p3 + kW3] - s_t[p3 - kW3]));
    const float nn = sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    const bool ok_n = ok_r && disc < 0.05f * tmag && nn > 1e-20f;
    const float nc = clamp_min(nn, 1e-30f);
#pragma unroll
    for (int m = 0; m < 3; ++m) n[m] = n[m] / nc;
    const float dxr = ray_slope(wrap(j0 + c - 1, F), centre, rf);
    const float dyr = ray_slope(wrap(i0 + r - 1, F), centre, rf);
    const bool flip = n[0] * dxr + n[1] * dyr + n[2] * 1.0f > 0.0f;
    const float sign = 1.0f - 2.0f * (flip ? 1.0f : 0.0f);
    const float okn = ok_n ? 1.0f : 0.0f;
#pragma unroll
    for (int m = 0; m < 3; ++m) s_n[m][k] = n[m] * sign * okn;
    s_okn[k] = ok_n ? 1 : 0;
  }
  __syncthreads();

  // the rim and the silhouette fill on the tile; the outputs
  const long long face0 = static_cast<long long>(f) * F * F;
  for (int k = tid; k < kTileY * kTileX; k += nthr) {
    const int r = k / kTileX, c = k - r * kTileX;
    const int i = i0 + r, j = j0 + c;
    if (i >= F || j >= F) continue;
    const int p1 = (r + 1) * kW1 + (c + 1);
    const int p2 = (r + 2) * kW2 + (c + 2);
    const int p3 = (r + 3) * kW3 + (c + 3);
    float nsum[3] = {0.0f, 0.0f, 0.0f};
    for (int di = -1; di <= 1; ++di) {
      for (int dj = -1; dj <= 1; ++dj) {
#pragma unroll
        for (int m = 0; m < 3; ++m) nsum[m] = nsum[m] + s_n[m][p1 + di * kW1 + dj];
      }
    }
    const float nsn = sqrtf(nsum[0] * nsum[0] + nsum[1] * nsum[1] + nsum[2] * nsum[2]);
    const float nc = clamp_min(nsn, 1e-30f);
    const bool usable = nsn > 1e-20f;
    const bool ok = s_ok[p3] != 0.0f;
    const bool ok_n = s_okn[p1] != 0;
    const float wsum = s_w[p2];
    const bool rim = ok && !ok_n && usable;
    const bool fill = !ok && wsum > 0.5f && usable;
    const long long o = face0 + static_cast<long long>(i) * F + j;
    KINFU_AT(t_out, L.t, o) = fill ? s_tsum[p2] / clamp_min(wsum, 1.0f) : s_t[p3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      KINFU_AT(n_out, L.n, o * 3 + m) = rim || fill ? nsum[m] / nc : s_n[m][p1];
    }
    KINFU_AT(valid_out, L.valid, o) = ok_n || rim || fill ? 1 : 0;
  }
}

}  // namespace

// hit_f, back_f: host arrays of nf device pointers, each face's [F, F]
// events; prm: K5's parameter block f32[nf, 24]; t [nf, F, F], n
// [nf, F, F, 3], valid (uint8) [nf, F, F]; centre = (F - 1) / 2 and
// rf = float32(1 / focal). lens: the arrays' lengths in elements (int64):
// the nf hit fields, the nf back fields, then prm, t, n and valid.
extern "C" int kinfu_face_fields(const void* hit_f, const void* back_f, const void* prm,
                                 void* t, void* n, void* valid, float centre, float rf, int nf,
                                 int F, const void* lens, void* stream) {
  if (nf < 1 || nf > kMaxFaces || F < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long* len = static_cast<const long long*>(lens);
  Events ev = {};
  Lens L = {};
  for (int f = 0; f < nf; ++f) {
    ev.hit[f] = static_cast<const float* const*>(hit_f)[f];
    ev.back[f] = static_cast<const float* const*>(back_f)[f];
    L.hit[f] = len[f];
    L.back[f] = len[nf + f];
  }
  L.prm = len[2 * nf];
  L.t = len[2 * nf + 1];
  L.n = len[2 * nf + 2];
  L.valid = len[2 * nf + 3];
  const dim3 grid((F + kTileX - 1) / kTileX, (F + kTileY - 1) / kTileY, nf);
  face_fields_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ev, static_cast<const float*>(prm), static_cast<float*>(t), static_cast<float*>(n),
      static_cast<unsigned char*>(valid), F, centre, rf, L);
  return static_cast<int>(cudaGetLastError());
}
