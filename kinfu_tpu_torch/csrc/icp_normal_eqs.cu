// K1: one Gauss-Newton iteration of projective point-to-plane ICP: the
// association of every current pixel with the model maps and the normal
// equations A x = b of the iteration.
//
// Replaces the Pallas kernel kinfu_tpu/ops/pallas_icp.py::_kernel (L48-146;
// pallas_call in icp_normal_eqs_warped at L208, finished by L219-229). Per
// current pixel, in the TPU kernel's order of operations (L75-136):
// s = R v + t and m = R n term by term; the projection
// rint(s_x / z * fx + cx) with z = s_z where s_z > 0, else 1 (a true IEEE
// division); the bounds of the MODEL maps and a non-zero current normal;
// the model vertex d and normal q gathered there (gather2d.cuh); the
// squared gates |s - d|^2 <= dist^2 and |m x q|^2 <= sin^2; and the row
// e = [s x q, q, -(q . (s - d))]. Plain version:
// ops/icp_warped.py::icp_normal_eqs_warped_plain; the build uses -fmad=false
// so every product and sum rounds as it does there.
//
// The TPU kernel's 8-row VMEM blocks, its [36*8, 128] revisited accumulator,
// the channel split and the tilegather windows exist only for the TPU. Here
// one thread takes one pixel at a time (a grid-stride loop) and reads the
// interleaved [H, W, 3] maps directly. It keeps the 27 Gram terms that reach
// an output (A's upper triangle and b) in registers; the inlier count, the
// TPU kernel's G[7,7], is an integer. A pixel the gates reject adds exact
// zeros there (its row is multiplied by 0), so it is skipped.
//
// The reduction is deterministic, with no float atomics: each block reduces
// its threads with warp shuffles and then shared memory, in a fixed order,
// and writes its partial sums [nblocks, 27] and count [nblocks]. The block
// that takes the last ticket (an integer atomic after __threadfence) sums the
// partials in a fixed order, writes A (symmetric), b and the count, and
// resets the ticket to 0 for the next launch. One launch per iteration.
//
// Current maps may be a row shard (hc rows of the image, hc <= h): bounds
// and the gather use the model maps' h x w.
//
// Two forms of the one kernel body, chosen at compile time:
//   - the one-iteration form (kinfu_icp_normal_eqs) writes A, b and the
//     count, and nothing else: the row-shard form of a sharded step sums A
//     and b across shards before the solve;
//   - the finishing form also finishes the iteration in the last block, as
//     tracking/icp.py::finish_iteration does (kinfu_tpu/tracking/icp.py:
//     188-199): det by an LU with partial pivoting in f32 (LAPACK's
//     unblocked getf2: the first maximal pivot, the column scaled by the
//     pivot's reciprocal), good = |det| >= 1e-15 and det not NaN, the 6x6
//     solve with that LU (getrs: row swaps, unit-lower forward solve, upper
//     back solve), x = 0 where not good, Rodrigues with its series branch
//     (geometry/se3.py), compose, and the select of the pose and `ok` by
//     keep = ok & good. It reads the running pose and ok from a state block
//     f32[16] (R row-major 9, t 3, ok 1.0/0.0, the inlier count's int32
//     bits, 2 spare; none = the identity and ok) and writes the new ones and
//     the count to a state block; the next launch in stream order reads
//     what this one wrote. kinfu_icp_solve launches it for every iteration
//     of a coarse-to-fine ICP, with no host work between launches.
//
// Bound on this card: memory. Each pixel reads 24 bytes of current maps and
// gathers 24 bytes of model maps, 48 B/pixel: 14.7 MB at 640x480, 4.4 us at
// 3.35 TB/s (1.1 us at 320x240, 0.28 us at 160x120), ~26 us for the
// (4, 5, 10) iterations of a frame. Its ~150 flops a pixel are far under
// the float32 rate. At these sizes launch latency, not bandwidth, sets its
// time, and the finish (a few hundred flops in one thread) adds little.
#include <cfloat>

#include <cuda_runtime.h>

#include "gather2d.cuh"

namespace {

constexpr int kTerms = 27;  // A's upper triangle (21) and b (6)
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

// Sums g[] and n over the block in a fixed order into res[] and *res_n.
// Every thread of the block must call it.
__device__ __forceinline__ void block_reduce(float (&g)[kTerms], int n, float* s_g, int* s_n, float* res,
                             int* res_n) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) g[k] += __shfl_down_sync(0xffffffffu, g[k], off);
    n += __shfl_down_sync(0xffffffffu, n, off);
  }
  __syncthreads();  // s_g / res may still be read from an earlier call
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) s_g[warp * kTerms + k] = g[k];
    s_n[warp] = n;
  }
  __syncthreads();
  if (threadIdx.x < kTerms) {
    float s = 0.0f;
    for (int w = 0; w < nwarps; ++w) s += s_g[w * kTerms + threadIdx.x];
    res[threadIdx.x] = s;
  } else if (threadIdx.x == kTerms) {
    int c = 0;
    for (int w = 0; w < nwarps; ++w) c += s_n[w];
    *res_n = c;
  }
  __syncthreads();
}

// The finish of one Gauss-Newton iteration, in one thread: from the
// iteration's terms (A's upper triangle and b, in the order of `res`), its
// count and its start pose (r, t, ok_in), the state block `out`.
__device__ void finish_iteration(const float* res, int count, const float (&r)[9],
                                 const float (&t)[3], bool ok_in, float* out) {
  float a[6][6], x[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int c = i; c < 7; ++c, ++k) {
      if (c < 6) {
        a[i][c] = res[k];
        a[c][i] = res[k];
      } else {
        x[i] = res[k];
      }
    }
  }
  // getf2: LU with partial pivoting, in place. Every loop is unrolled and
  // every row swap is a select on a compile-time index, so the arrays stay
  // in registers.
  int piv[6];
  bool odd = false;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    int p = j;
    float amax = fabsf(a[j][j]), pval = a[j][j];
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      if (fabsf(a[i][j]) > amax) {
        amax = fabsf(a[i][j]);
        pval = a[i][j];
        p = i;
      }
    }
    piv[j] = p;
    if (pval != 0.0f) {
      if (p != j) {
#pragma unroll
        for (int i = j + 1; i < 6; ++i) {
          if (i == p) {
#pragma unroll
            for (int c = 0; c < 6; ++c) {
              const float s = a[j][c];
              a[j][c] = a[i][c];
              a[i][c] = s;
            }
          }
        }
        odd = !odd;
      }
      if (fabsf(a[j][j]) >= FLT_MIN) {
        const float rcp = 1.0f / a[j][j];
#pragma unroll
        for (int i = j + 1; i < 6; ++i) a[i][j] *= rcp;
      } else {
#pragma unroll
        for (int i = j + 1; i < 6; ++i) a[i][j] /= a[j][j];
      }
    }
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
#pragma unroll
      for (int c = j + 1; c < 6; ++c) a[i][c] -= a[i][j] * a[j][c];
    }
  }
  float det = a[0][0];
#pragma unroll
  for (int j = 1; j < 6; ++j) det *= a[j][j];
  if (odd) det = -det;
  const bool good = fabsf(det) >= 1e-15f && !isnan(det);

  // getrs with the same LU: row swaps, L (unit) forward, U back
  if (good) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
#pragma unroll
      for (int i = j + 1; i < 6; ++i) {
        if (i == piv[j]) {
          const float s = x[j];
          x[j] = x[i];
          x[i] = s;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (x[j] != 0.0f) {
#pragma unroll
        for (int i = j + 1; i < 6; ++i) x[i] -= x[j] * a[i][j];
      }
    }
#pragma unroll
    for (int j = 5; j >= 0; --j) {
      if (x[j] != 0.0f) {
        x[j] /= a[j][j];
#pragma unroll
        for (int i = 0; i < j; ++i) x[i] -= x[j] * a[i][j];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 6; ++j) x[j] = 0.0f;
  }

  // Rodrigues(x[0:3]) with the series forms near 0 (geometry/se3.py)
  const float wx = x[0], wy = x[1], wz = x[2];
  const float theta2 = wx * wx + wy * wy + wz * wz;
  const float theta = sqrtf(theta2);
  const bool small = theta2 < 1e-12f;
  const float sa = small ? 1.0f - theta2 * (1.0f / 6.0f) : sinf(theta) / theta;
  const float sb = small ? 0.5f - theta2 * (1.0f / 24.0f) : (1.0f - cosf(theta)) / theta2;
  const float K[3][3] = {{0.0f, -wz, wy}, {wz, 0.0f, -wx}, {-wy, wx, 0.0f}};
  float inc[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float kk = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
      inc[i][j] = ((i == j ? 1.0f : 0.0f) + sa * K[i][j]) + sb * kk;
    }
  }
  // compose(pose, (inc, x[3:6])) and the select by keep
  const bool keep = ok_in && good;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float nr = r[i * 3] * inc[0][j] + r[i * 3 + 1] * inc[1][j] + r[i * 3 + 2] * inc[2][j];
      out[i * 3 + j] = keep ? nr : r[i * 3 + j];
    }
    const float nt = (r[i * 3] * x[3] + r[i * 3 + 1] * x[4] + r[i * 3 + 2] * x[5]) + t[i];
    out[9 + i] = keep ? nt : t[i];
  }
  out[12] = keep ? 1.0f : 0.0f;
  reinterpret_cast<int*>(out)[13] = count;
}

// R, T: the iteration's start pose (R row-major); in the finishing form
// they may be null (the identity), `ok_in` is the start's ok (null: true)
// and `out` the state block the finish writes. At least 4 blocks a SM (64
// registers a thread): the 528 blocks of a 640x480 launch then run in one
// wave, and the finish's registers do not cost the pixel loop occupancy.
template <bool kFinish>
__global__ void __launch_bounds__(kMaxThreads, 4)
icp_normal_eqs_kernel(const float* R, const float* T, const float* ok_in, float* out,
                      const float* __restrict__ cv, const float* __restrict__ cn,
                      const float* __restrict__ pv, const float* __restrict__ pn,
                      float* partial_g, int* partial_n, unsigned int* ticket,
                      float* __restrict__ A, float* __restrict__ b, int* __restrict__ ninl,
                      float fx, float fy, float cx, float cy, float dist2, float sin2,
                      int hc, int h, int w) {
  __shared__ float s_g[kMaxWarps * kTerms];
  __shared__ int s_n[kMaxWarps];
  __shared__ float res[kTerms];
  __shared__ int res_n;
  __shared__ bool last;

  float r[9], tt[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = R != nullptr ? R[k] : (k % 4 == 0 ? 1.0f : 0.0f);
#pragma unroll
  for (int k = 0; k < 3; ++k) tt[k] = T != nullptr ? T[k] : 0.0f;
  const float t0 = tt[0], t1 = tt[1], t2 = tt[2];

  float g[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) g[k] = 0.0f;
  int n = 0;

  const long long npix = static_cast<long long>(hc) * w;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < npix;
       p += stride) {
    const float vx = cv[p * 3], vy = cv[p * 3 + 1], vz = cv[p * 3 + 2];
    const float nx = cn[p * 3], ny = cn[p * 3 + 1], nz = cn[p * 3 + 2];
    const bool ncur_ok = nx != 0.0f || ny != 0.0f || nz != 0.0f;

    const float sx = r[0] * vx + r[1] * vy + r[2] * vz + t0;
    const float sy = r[3] * vx + r[4] * vy + r[5] * vz + t1;
    const float sz = r[6] * vx + r[7] * vy + r[8] * vz + t2;

    const bool zok = sz > 0.0f;
    const float zs = zok ? sz : 1.0f;
    const int u = kinfu::rint_clamped(sx / zs * fx + cx);
    const int v = kinfu::rint_clamped(sy / zs * fy + cy);
    if (!(zok && u >= 0 && u < w && v >= 0 && v < h && ncur_ok)) continue;

    const float dx = kinfu::gather2d_ch(pv, h, w, 3, v, u, 0);
    const float dy = kinfu::gather2d_ch(pv, h, w, 3, v, u, 1);
    const float dz = kinfu::gather2d_ch(pv, h, w, 3, v, u, 2);
    const float qx = kinfu::gather2d_ch(pn, h, w, 3, v, u, 0);
    const float qy = kinfu::gather2d_ch(pn, h, w, 3, v, u, 1);
    const float qz = kinfu::gather2d_ch(pn, h, w, 3, v, u, 2);
    if (!(qx != 0.0f || qy != 0.0f || qz != 0.0f)) continue;

    const float ex = sx - dx, ey = sy - dy, ez = sz - dz;
    const float d2 = ex * ex + ey * ey + ez * ez;
    const float mx = r[0] * nx + r[1] * ny + r[2] * nz;
    const float my = r[3] * nx + r[4] * ny + r[5] * nz;
    const float mz = r[6] * nx + r[7] * ny + r[8] * nz;
    const float crx = my * qz - mz * qy;
    const float cry = mz * qx - mx * qz;
    const float crz = mx * qy - my * qx;
    const float s2 = crx * crx + cry * cry + crz * crz;
    if (!(d2 <= dist2 && s2 <= sin2)) continue;

    const float e[7] = {sy * qz - sz * qy, sz * qx - sx * qz, sx * qy - sy * qx, qx, qy, qz,
                        -(qx * ex + qy * ey + qz * ez)};
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int c = a; c < 7; ++c) g[k++] += e[a] * e[c];
    }
    ++n;
  }

  block_reduce(g, n, s_g, s_n, res, &res_n);
  if (threadIdx.x < kTerms) partial_g[blockIdx.x * kTerms + threadIdx.x] = res[threadIdx.x];
  if (threadIdx.x == 0) partial_n[blockIdx.x] = res_n;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block: every partial is visible; sum them in a fixed order
#pragma unroll
  for (int k = 0; k < kTerms; ++k) g[k] = 0.0f;
  n = 0;
  for (int blk = threadIdx.x; blk < gridDim.x; blk += blockDim.x) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) g[k] += __ldcg(partial_g + blk * kTerms + k);
    n += __ldcg(partial_n + blk);
  }
  block_reduce(g, n, s_g, s_n, res, &res_n);
  if (threadIdx.x < kTerms) {
    // term k is G[a][c], a <= c, in row-major order of the upper triangle
    int a = 0, k = threadIdx.x;
    while (k >= 7 - a) {
      k -= 7 - a;
      ++a;
    }
    const int c = a + k;
    if (c < 6) {
      A[a * 6 + c] = res[threadIdx.x];
      A[c * 6 + a] = res[threadIdx.x];
    } else {
      b[a] = res[threadIdx.x];
    }
  }
  if (threadIdx.x == 0) {
    *ninl = res_n;
    *ticket = 0u;
    if (kFinish) finish_iteration(res, res_n, r, tt, ok_in == nullptr || *ok_in != 0.0f, out);
  }
}

int blocks_for(int hc, int w, int threads, int max_blocks) {
  const long long want = (static_cast<long long>(hc) * w + threads - 1) / threads;
  return static_cast<int>(want < 1 ? 1 : (want > max_blocks ? max_blocks : want));
}

}  // namespace

extern "C" int kinfu_icp_normal_eqs(const void* R, const void* T, const void* cv,
                                    const void* cn, const void* pv, const void* pn,
                                    void* partial_g, void* partial_n, void* ticket, void* A,
                                    void* b, void* ninl, float fx, float fy, float cx,
                                    float cy, float dist2, float sin2, int hc, int h, int w,
                                    int nblocks, int threads, void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > kMaxThreads || nblocks < 1) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  icp_normal_eqs_kernel<false><<<nblocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R), static_cast<const float*>(T), nullptr, nullptr,
      static_cast<const float*>(cv), static_cast<const float*>(cn),
      static_cast<const float*>(pv), static_cast<const float*>(pn),
      static_cast<float*>(partial_g), static_cast<int*>(partial_n),
      static_cast<unsigned int*>(ticket), static_cast<float*>(A), static_cast<float*>(b),
      static_cast<int*>(ninl), fx, fy, cx, cy, dist2, sin2, hc, h, w);
  return static_cast<int>(cudaGetLastError());
}

// The whole coarse-to-fine ICP of a frame: for each level in the order
// given (coarsest first), iters[l] launches of the finishing form, each
// reading the state the one before wrote. Level l's current and model maps
// are maps[4l .. 4l+3] (cur vertex, cur normal, model vertex, model
// normal), its intrinsics intr[4l .. 4l+3] (fx, fy, cx, cy), its sizes
// dims[3l .. 3l+2] (current rows, model rows, width). The first launch
// starts from `start` (a state block; null: the identity and ok), every
// launch writes `state`; A, b and ninl hold the last iteration's system.
extern "C" int kinfu_icp_solve(int nlevels, const void* maps, const void* intr,
                               const void* dims, const void* iters, const void* start,
                               void* state, void* partial_g, void* partial_n, void* ticket,
                               void* A, void* b, void* ninl, float dist2, float sin2,
                               int max_blocks, int threads, void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > kMaxThreads || max_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const float* const* m = static_cast<const float* const*>(maps);
  const float* in = static_cast<const float*>(intr);
  const int* d = static_cast<const int*>(dims);
  const int* it = static_cast<const int*>(iters);
  const float* src = static_cast<const float*>(start);
  float* st = static_cast<float*>(state);
  for (int l = 0; l < nlevels; ++l) {
    const int hc = d[3 * l], h = d[3 * l + 1], w = d[3 * l + 2];
    const int nblocks = blocks_for(hc, w, threads, max_blocks);
    for (int i = 0; i < it[l]; ++i) {
      icp_normal_eqs_kernel<true><<<nblocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          src, src != nullptr ? src + 9 : nullptr, src != nullptr ? src + 12 : nullptr, st,
          m[4 * l], m[4 * l + 1], m[4 * l + 2], m[4 * l + 3], static_cast<float*>(partial_g),
          static_cast<int*>(partial_n), static_cast<unsigned int*>(ticket),
          static_cast<float*>(A), static_cast<float*>(b), static_cast<int*>(ninl),
          in[4 * l], in[4 * l + 1], in[4 * l + 2], in[4 * l + 3], dist2, sin2, hc, h, w);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      src = st;
    }
  }
  return static_cast<int>(cudaSuccess);
}
