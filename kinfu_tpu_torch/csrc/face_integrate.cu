// K3: one cube face's TSDF + colour fusion sweep, in place.
//
// Replaces the Pallas kernel kinfu_tpu/ops/pallas_integrate.py::_kernel
// (L204-390; pallas_calls of _sweep_face at L545 and L558). A thread maps its
// voxel of the natural [Z, Y, X] volume to the face's primed coordinates
// through the signed axis permutation (axes, flip) instead of copying the
// volume through the prime/unprime transposes (L422-431); the per-plane gate
// and mip scalars come from a [Zp, 9] table that plain PyTorch computes on the
// device with the same _slab_geometry expressions
// (ops/face_integrate.py::plane_table). Where cover_ok holds, the TPU
// kernel's 3-window row gather (_window_gather, L121-147) reads exactly the
// face pixel that this direct load reads, and cover_ok is part of the plane
// gate. Ownership keeps the gt_x / gt_y tie-break (L316-323), the update math
// keeps the int16 truncation of t (L337-339) and the colour band of
// +-trunc/2 (L341-367). Plain version: ops/face_integrate.py::sweep_face_plain;
// the build uses -fmad=false so that both round every operation alike.
//
// Bound on this card: what the inputs need. A voxel it updates costs 4 bytes
// of TSDF and weight read and written, a voxel whose colour it mixes 4 more
// each way, and every voxel of a plane's footprint ~24 float operations of
// projection and ownership; other voxels cost nothing. On the 640x480
// orbit's +z view at 512^3 the bytes of the 18.75 M updated voxels alone
// take ~0.045 ms (chip_smoke.py counts the voxels with sweep_face_plain and
// the footprint with plane_footprint). What holds the sweep above that is
// the work on footprint voxels that the data rejects: the footprint holds
// 72 M voxels there, most of the rest lie behind the observed surface, and
// only the face image can tell which. The time does not follow the loads in
// flight a lane (staging several voxels a lane did not move it), so it is
// set by instruction issue over the footprint, not by bytes.
//
// Design. The TPU kernel skipped slabs through a work list of active planes
// (L213-221, L491-527); here each block schedules only the voxels that can
// pass the exact tests:
//   - A per-plane footprint: from the plane's table row and the camera's
//     primed x, y, the rectangle [x_lo, x_hi] x [y_lo, y_hi] of primed
//     voxels whose face pixel can lie in [0, width), whose ownership test
//     can hold and whose face pixel's ray lies inside the camera image's
//     frustum (K2's parameter block rides in prm), one voxel wider on each
//     side (plane_footprint below and ops/face_integrate.py::plane_footprint,
//     its plain twin). The ownership cone alone is much wider than the
//     frustum. A plane whose gate is 0 has none. Inside it every test runs
//     exactly as before, so a footprint that were too small would show as a
//     bit difference.
//   - Work in natural coordinates, 32 voxels along natural x a step (a
//     warp's loads of tsdf and weight stay coalesced on all six faces). For
//     the +-z and +-y faces natural x is primed x: a slab is one plane, a work
//     item one row of its footprint, walked 32 voxels a step. For the +-x
//     faces natural x is the sweep axis: a slab is 32 planes, an item one
//     primed row of the union of their footprints, a lane one plane, and a
//     step one primed x. A row's table entries, dy, face row v and y
//     ownership are read and computed once (plane_row), the same expressions
//     as per voxel before.
//   - A grid sized to the card (blocks resident at once), each block
//     reading the face gate once, then counting each slab's rows and their
//     prefix sum in shared memory, then walking the rows grid-strided with
//     32-bit counters. A gated-off launch costs one read a block.
#include <cuda_runtime.h>

#include "gather2d.cuh"

namespace {

constexpr int kTableCols = 9;  // dz, dzs, au, bu, av, bv, row_off, width, slab_do
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// shared memory a block may take without opting in; a slab takes 20 bytes,
// so up to 2,457 slabs fit (a 512^3 volume's +-z sweep has 512)
constexpr size_t kSmemDefault = 48 * 1024;
// devices whose opt-in this process tracks, and the dynamic shared memory
// each has been opted in to so far (the kernel's attribute is a maximum)
constexpr int kMaxDevices = 64;
size_t g_smem_optin[kMaxDevices] = {};

struct Footprint {
  int x_lo, x_hi, y_lo, y_hi;  // primed, inclusive; empty when a hi < its lo
};

// The lengths in elements of the kernel's arrays, from the tensors the
// wrapper passes (checked.cuh).
struct Lens {
  long long tsdf, weight, color, frange, fcolor, prm, table;
};

__device__ __forceinline__ int lower_index(float v, int n) {
  return max(static_cast<int>(floorf(fminf(fmaxf(v, -2.0f), n + 2.0f))) - 1, 0);
}

__device__ __forceinline__ int upper_index(float v, int n) {
  return min(static_cast<int>(ceilf(fminf(fmaxf(v, -2.0f), n + 2.0f))) + 1, n - 1);
}

// The sweep's scalars, read once a thread.
struct Sweep {
  float cx, cy, vsx, vsy, f, trunc_mm, max_weight;
};

// Bounds of the primed tangents (x'/z', y'/z') of the camera image's rays:
// a face pixel can hold an observation only where K2 projects its ray into
// the image, half a pixel inside the corners taken here, and the image maps
// to a convex quadrilateral of the face, so its corners bound it. prm[12:14]
// is the image size, prm[16:32] K2's block (A row-major camera-from-primed,
// fx, fy, cx, cy, ...). ok is false where a corner ray is not in front of
// the face.
struct Frustum {
  float tx_lo, tx_hi, ty_lo, ty_hi;
  bool ok;
};

__device__ Frustum camera_frustum(const float* __restrict__ prm, long long n_prm) {
  auto a = [&](int k) { return KINFU_AT(prm, n_prm, 16 + k); };
  const float w = KINFU_AT(prm, n_prm, 12), h = KINFU_AT(prm, n_prm, 13);
  Frustum fr{INFINITY, -INFINITY, INFINITY, -INFINITY, true};
  for (int k = 0; k < 4; ++k) {
    const float lx = ((k & 1 ? w : -1.0f) - a(11)) / a(9);
    const float ly = ((k & 2 ? h : -1.0f) - a(12)) / a(10);
    // primed direction = A^T (lx, ly, 1)
    const float px = a(0) * lx + a(3) * ly + a(6);
    const float py = a(1) * lx + a(4) * ly + a(7);
    const float pz = a(2) * lx + a(5) * ly + a(8);
    fr.ok = fr.ok && pz > 0.0f;
    fr.tx_lo = fminf(fr.tx_lo, px / pz);
    fr.tx_hi = fmaxf(fr.tx_hi, px / pz);
    fr.ty_lo = fminf(fr.ty_lo, py / pz);
    fr.ty_hi = fmaxf(fr.ty_hi, py / pz);
  }
  return fr;
}

// The primed voxels of plane zp (row T of the table) that can pass the sweep's tests: the
// face pixel u = rint(au x + bu) lies in [0, width) only where au x + bu lies
// in [-0.5, width - 0.5]; the ownership |x vsx - cx| <= dzs only where x
// lies in [(cx - dzs) / vsx, (cx + dzs) / vsx] (au, vsx > 0); and the pixel
// holds an observation only where its ray's tangent lies in the frustum's
// bounds, which the voxel's tangent (x vsx - cx) / dzs misses by at most
// half a pixel of the plane's mip level, vsx / (2 au dzs), plus a margin of
// one level-0 face pixel, 1 / f. The same for y. Widened by one voxel on
// each side against rounding.
__device__ Footprint plane_footprint(const float* __restrict__ table, long long n_table, int zp,
                                     const Sweep& w, const Frustum& fr, int Xp, int Yp) {
  auto T = [&](int k) { return KINFU_AT(table, n_table, zp * kTableCols + k); };
  const Footprint none{0, -1, 0, -1};
  if (T(8) == 0.0f) return none;
  const float dzs = T(1), au = T(2), bu = T(3), av = T(4), bv = T(5), width = T(7);
  float x0 = fmaxf((-0.5f - bu) / au, (w.cx - dzs) / w.vsx);
  float x1 = fminf((width - 0.5f - bu) / au, (w.cx + dzs) / w.vsx);
  float y0 = fmaxf((-0.5f - bv) / av, (w.cy - dzs) / w.vsy);
  float y1 = fminf((width - 0.5f - bv) / av, (w.cy + dzs) / w.vsy);
  if (fr.ok) {
    const float dtx = 0.5f * w.vsx / (au * dzs) + 1.0f / w.f;
    const float dty = 0.5f * w.vsy / (av * dzs) + 1.0f / w.f;
    x0 = fmaxf(x0, (w.cx + dzs * (fr.tx_lo - dtx)) / w.vsx);
    x1 = fminf(x1, (w.cx + dzs * (fr.tx_hi + dtx)) / w.vsx);
    y0 = fmaxf(y0, (w.cy + dzs * (fr.ty_lo - dty)) / w.vsy);
    y1 = fminf(y1, (w.cy + dzs * (fr.ty_hi + dty)) / w.vsy);
  }
  const Footprint f{lower_index(x0, Xp), upper_index(x1, Xp), lower_index(y0, Yp),
                    upper_index(y1, Yp)};
  return (f.x_lo > f.x_hi || f.y_lo > f.y_hi) ? none : f;
}

// One primed row (plane zp, row yp): the plane's table entries and what the
// row alone decides. ok: the plane gate (implies dz_ok and cover_ok), the
// face row v in [0, width) and the y ownership hold.
struct Row {
  float dy, dz, dzs, au, bu;
  int row_off, width, v;
  bool ok;
};

__device__ __forceinline__ Row plane_row(const float* __restrict__ table, long long n_table,
                                         const Sweep& w, int zp, int yp, int gt_y, int F) {
  auto T = [&](int k) {
    return KINFU_AT(table, n_table, static_cast<long long>(zp) * kTableCols + k);
  };
  Row r;
  // the TPU kernel's operation order: (local * vs - c) + base * vs over
  // 8-row strips in y
  r.dy = (static_cast<float>(yp & 7) * w.vsy - w.cy) + static_cast<float>(yp & ~7) * w.vsy;
  r.dz = T(0);
  r.dzs = T(1);
  r.au = T(2);
  r.bu = T(3);
  const float av = T(4), bv = T(5);
  r.row_off = static_cast<int>(T(6));
  r.width = static_cast<int>(T(7));
  r.v = static_cast<int>(
      fminf(fmaxf(rintf(av * static_cast<float>(yp) + bv), -1.0f), static_cast<float>(F)));
  const float ady = fabsf(r.dy);
  const bool own_y = gt_y ? ady < r.dzs : ady <= r.dzs;
  r.ok = T(8) != 0.0f && r.v >= 0 && r.v < r.width && own_y;
  return r;
}

// One voxel of row r: natural linear index n, primed x xp.
__device__ __forceinline__ void fuse_voxel(short* __restrict__ tsdf, short* __restrict__ weight,
                                           int* __restrict__ color,
                                           const short* __restrict__ frange,
                                           const int* __restrict__ fcolor, const Lens& L,
                                           const Sweep& w, const Row& r, long long n, int xp,
                                           int gt_x, int F, int stack_rows) {
  // 128-lane chunks in x, as dy's 8-row strips
  const float dx =
      (static_cast<float>(xp & 127) * w.vsx - w.cx) + static_cast<float>(xp & ~127) * w.vsx;
  const int u = static_cast<int>(
      fminf(fmaxf(rintf(r.au * static_cast<float>(xp) + r.bu), -1.0f), static_cast<float>(F)));
  if (u < 0 || u >= r.width) return;
  const float adx = fabsf(dx);
  const bool own_x = gt_x ? adx < r.dzs : adx <= r.dzs;
  if (!own_x) return;

  const float r_obs =
      static_cast<float>(kinfu::gather2d(frange, L.frange, stack_rows, F, r.row_off + r.v, u));
  if (!(r_obs > 0.0f)) return;
  const float r_vox = sqrtf(dx * dx + r.dy * r.dy + r.dz * r.dz) * 1000.0f;
  const float sdf = r_obs - r_vox;
  if (!(sdf >= -w.trunc_mm)) return;
  // trunc_mm is static in the JAX package, whose compiler multiplies by the
  // float32 reciprocal instead of dividing
  const float tsdf_obs = fminf(sdf * (1.0f / w.trunc_mm), 1.0f);

  short& t_ref = KINFU_AT(tsdf, L.tsdf, n);
  short& w_ref = KINFU_AT(weight, L.weight, n);
  const float t_old = static_cast<float>(t_ref) * kinfu::kInvShort;
  const float w_old = static_cast<float>(w_ref);
  const float w_new = fminf(w_old + 1.0f, w.max_weight);
  const float t_new = (t_old * w_old + tsdf_obs) / (w_old + 1.0f);
  const float t_s = fminf(fmaxf(t_new * 32767.0f, -32767.0f), 32767.0f);
  t_ref = static_cast<short>(truncf(t_s));
  w_ref = static_cast<short>(w_new);

  if (sdf <= w.trunc_mm * 0.5f && sdf >= -w.trunc_mm * 0.5f) {
    int& c_ref = KINFU_AT(color, L.color, n);
    const int c_old = c_ref;
    const int c_obs = kinfu::gather2d(fcolor, L.fcolor, stack_rows, F, r.row_off + r.v, u);
    int c_new = 0;
    for (int shift = 16; shift >= 0; shift -= 8) {
      const float o = static_cast<float>((c_old >> shift) & 0xFF);
      const float p = static_cast<float>((c_obs >> shift) & 0xFF);
      const float m = (w_new * o + p) / (w_new + 1.0f);
      c_new |= static_cast<int>(fminf(fmaxf(m, 0.0f), 255.0f)) << shift;
    }
    c_ref = c_new;
  }
}

// Permutations (axes) taken: (0,1,2) +-z and (1,0,2) +-y, whose primed x is
// natural x; (2,0,1) +-x and, for a volume sharded along natural y, (2,1,0)
// +-x (kinfu_tpu/ops/facewarp.py:117-160), whose sweep axis is natural x.
__global__ void __launch_bounds__(kThreads)
face_integrate_kernel(short* __restrict__ tsdf, short* __restrict__ weight,
                      int* __restrict__ color, const short* __restrict__ frange,
                      const int* __restrict__ fcolor, const float* __restrict__ prm,
                      const float* __restrict__ table, int nZ, int nY, int nX, int ax0,
                      int ax1, int flip, int gt_x, int gt_y, int F, int stack_rows,
                      int n_slabs, Lens L) {
  auto P = [&](int k) { return KINFU_AT(prm, L.prm, k); };
  if (P(11) == 0.0f) return;  // face gate off: volume unchanged
  extern __shared__ int4 smem[];
  int4* s_rect = smem;  // per slab: first row, rows, first and last primed x
  unsigned* s_end = reinterpret_cast<unsigned*>(smem + n_slabs);  // rows of slabs 0..s
  __shared__ unsigned s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dims[3] = {nZ, nY, nX};
  const int Zp = dims[ax0], Yp = dims[ax1];
  const bool x_sweeps = ax0 == 2;
  const int Xp = dims[3 - ax0 - ax1];
  const Sweep w{P(0), P(1), P(3), P(4), P(6), P(8), P(9)};
  const Frustum fr = camera_frustum(prm, L.prm);

  // 1. each slab's rectangle: its plane's footprint, or the union of its
  // 32 planes' footprints
  if (!x_sweeps) {
    for (int s = threadIdx.x; s < n_slabs; s += kThreads) {
      const int zp = flip ? Zp - 1 - s : s;
      const Footprint f = plane_footprint(table, L.table, zp, w, fr, Xp, Yp);
      s_rect[s] = make_int4(f.y_lo, f.y_hi - f.y_lo + 1, f.x_lo, f.x_hi);
    }
  } else {
    for (int s = warp; s < n_slabs; s += kWarps) {
      const int x = s * 32 + lane;
      Footprint f{0, -1, 0, -1};
      if (x < nX) {
        f = plane_footprint(table, L.table, flip ? Zp - 1 - x : x, w, fr, Xp, Yp);
      }
      const bool any = f.x_lo <= f.x_hi;
      int x_lo = any ? f.x_lo : Xp, x_hi = any ? f.x_hi : -1;
      int y_lo = any ? f.y_lo : Yp, y_hi = any ? f.y_hi : -1;
      for (int d = 16; d > 0; d >>= 1) {
        x_lo = min(x_lo, __shfl_xor_sync(kFull, x_lo, d));
        x_hi = max(x_hi, __shfl_xor_sync(kFull, x_hi, d));
        y_lo = min(y_lo, __shfl_xor_sync(kFull, y_lo, d));
        y_hi = max(y_hi, __shfl_xor_sync(kFull, y_hi, d));
      }
      if (lane == 0) {
        s_rect[s] = x_hi < 0 ? make_int4(0, 0, 0, -1)
                             : make_int4(y_lo, y_hi - y_lo + 1, x_lo, x_hi);
      }
    }
  }
  __syncthreads();

  // 2. inclusive prefix of the row counts: a run of slabs a thread
  const int per = (n_slabs + kThreads - 1) / kThreads;
  const int s0 = min(static_cast<int>(threadIdx.x) * per, n_slabs);
  const int s1 = min(s0 + per, n_slabs);
  unsigned run = 0;
  for (int s = s0; s < s1; ++s) {
    run += static_cast<unsigned>(s_rect[s].y);
    s_end[s] = run;
  }
  unsigned incl = run;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  unsigned before = incl - run;
  for (int k = 0; k < warp; ++k) before += s_warp[k];
  for (int s = s0; s < s1; ++s) s_end[s] += before;
  __syncthreads();
  const unsigned total = s_end[n_slabs - 1];

  // 3. the rows, one a warp, grid-strided; a warp's rows only increase
  int s = 0;
  for (unsigned item = blockIdx.x * kWarps + warp; item < total; item += gridDim.x * kWarps) {
    while (s_end[s] <= item) ++s;
    const int4 rect = s_rect[s];
    const int a = rect.x + static_cast<int>(item - (s > 0 ? s_end[s - 1] : 0u));  // primed y
    if (!x_sweeps) {
      // the warp's plane and row: 32 voxels along natural x = primed x a step
      const int zp = flip ? Zp - 1 - s : s;
      const Row r = plane_row(table, L.table, w, zp, a, gt_y, F);
      if (!r.ok) continue;
      const long long row = ax0 == 0 ? static_cast<long long>(s) * nY + a
                                     : static_cast<long long>(a) * nY + s;
      for (int x = (rect.z & ~31) + lane; x <= rect.w; x += 32) {
        fuse_voxel(tsdf, weight, color, frange, fcolor, L, w, r, row * nX + x, x, gt_x, F,
                   stack_rows);
      }
    } else {
      // a lane a plane (natural x), the warp's row a = natural z and a step
      // along primed x b = natural y, or (axes (2,1,0)) a = natural y and
      // b = natural z
      const int x = s * 32 + lane;
      const Row r = plane_row(table, L.table, w,
                              flip ? Zp - 1 - min(x, nX - 1) : min(x, nX - 1), a, gt_y, F);
      const bool live = x < nX && r.ok;
      if (!__any_sync(kFull, live)) continue;
      for (int b = rect.z; b <= rect.w; ++b) {
        if (live) {
          const long long zy = ax1 == 0 ? static_cast<long long>(a) * nY + b
                                        : static_cast<long long>(b) * nY + a;
          fuse_voxel(tsdf, weight, color, frange, fcolor, L, w, r, zy * nX + x, b, gt_x, F,
                     stack_rows);
        }
      }
    }
  }
}

}  // namespace

// blocks: the persistent grid's size, or 0 for as many blocks as the SMs
// hold at once (the rows are grid-strided, so any size writes the same
// bits); lens: the seven arrays' lengths in elements, in argument order
// (int64)
extern "C" int kinfu_face_integrate(void* tsdf, void* weight, void* color, const void* frange,
                                    const void* fcolor, const void* prm, const void* table,
                                    int nZ, int nY, int nX, int ax0, int ax1, int ax2,
                                    int flip, int gt_x, int gt_y, int F, int stack_rows,
                                    int blocks, const void* lens, void* stream) {
  const long long* n = static_cast<const long long*>(lens);
  const Lens L{n[0], n[1], n[2], n[3], n[4], n[5], n[6]};
  const bool x_sweeps = ax0 == 2 && ((ax1 == 0 && ax2 == 1) || (ax1 == 1 && ax2 == 0));
  if (!(x_sweeps || (ax2 == 2 && ((ax0 == 0 && ax1 == 1) || (ax0 == 1 && ax1 == 0))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dims[3] = {nZ, nY, nX};
  const int n_slabs = x_sweeps ? (nX + 31) / 32 : dims[ax0];
  if (n_slabs < 1 || blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n_slabs) * (sizeof(int4) + sizeof(unsigned));
  int device = 0, sms = 0, per_sm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const bool opted = device >= 0 && device < kMaxDevices && smem <= g_smem_optin[device];
  if (err == cudaSuccess && smem > kSmemDefault && !opted) {
    // more planes than 48 KB schedule (a 6144-plane slab takes 120 KB): opt
    // in to the card's larger limit a block, as far as it goes, once a size
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess && smem + kWarps * sizeof(unsigned) > static_cast<size_t>(optin)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(face_integrate_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    }
    if (err == cudaSuccess && device >= 0 && device < kMaxDevices) {
      g_smem_optin[device] = smem;
    }
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, face_integrate_kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  face_integrate_kernel<<<blocks > 0 ? blocks : max(sms * per_sm, 1), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<short*>(tsdf), static_cast<short*>(weight), static_cast<int*>(color),
      static_cast<const short*>(frange), static_cast<const int*>(fcolor),
      static_cast<const float*>(prm), static_cast<const float*>(table), nZ, nY, nX, ax0, ax1,
      flip, gt_x, gt_y, F, stack_rows, n_slabs, L);
  return static_cast<int>(cudaGetLastError());
}
