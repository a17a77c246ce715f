// K2: the mip-stacked face images of one frame, all six cube faces in one
// launch.
//
// Replaces the Pallas kernel kinfu_tpu/ops/facewarp.py::_build_face_kernel
// (L285-350, pallas_call at L384), which the JAX package launches once per
// face. Face f's stack is [stack_rows, size]: mip level l occupies rows
// [off_l, off_l + rows_l) (rows_l = size>>l rounded up to a multiple of 8),
// its pixel (i, j) for i, j < size>>l samples the camera frame along the
// primed ray of face pixel (i<<l, j<<l), and every other pixel of the level
// is zero padding. Level l is therefore an exact subsample of level 0: the
// JAX package defines the mips as base[::1<<l, ::1<<l] (_stack_mips,
// facewarp.py:443-452), and j * 2^l is an exact integer in float32, so the
// level-l pixel has the bits of level-0 pixel (i<<l, j<<l).
//
// Design: one thread per level-0 face pixel (i, j) of one face, in 32x8
// tiles (neighbouring face pixels map through the face's homography to
// neighbouring camera pixels, so a warp's depth and colour loads fall in a
// few cache lines); blockIdx.z is the face. A thread computes the primed ray,
// the projection, the gather and the range once, writes level 0, and writes
// the same value to level l at (i>>l, j>>l) for every l where i and j are
// multiples of 2^l. The padding is written by the thread whose (i, j) is the
// padded pixel's position within its level, so there is no separate pass.
// Each block reduces its level-0 ranges and makes one integer atomicMax into
// r_max[f]: the stack's maximum range, which the fusion sweep's plane gate
// reads (an integer max is the same in any order). r_max is zeroed by one
// memset on the stream before the launch.
//
// A face whose gate (prm6[f, 13]) is 0 writes nothing: its r_max stays 0 and
// its stack is left as allocated. Nothing reads it: K3
// (csrc/face_integrate.cu) returns on the same gate before it reads any byte
// of the face, and the plane table and the footprints read only the
// parameter blocks. chip_smoke.py checks this on the card by filling a
// gated-off stack with a sentinel.
//
// Every expression keeps the plain version's operation order
// (ops/facewarp.py::build_face_plain), and the build uses -fmad=false, so the
// active faces' stacks agree bit for bit.
//
// Bound on this card: active faces x (the stack's bytes out, 6 B a stack
// pixel, + 8 B for each distinct camera pixel gathered) over 3.35 TB/s,
// against 40 float operations a level-0 pixel over 67 TFLOP/s;
// chip_smoke.py::bound computes it from the run's inputs. On the orbit (one
// live face of 1280 x 640, ~77k camera pixels read) that is ~5.5 MB,
// ~1.7 us; the kernel takes ~11 us there (PERF.md).
#include <cuda_runtime.h>

#include "gather2d.cuh"

namespace {

constexpr int kFaces = 6;
constexpr int kPrm = 16;
constexpr int kTileX = 32;
constexpr int kTileY = 8;

// Rows allocated to mip level l: size >> l rounded up to a multiple of 8.
__device__ __forceinline__ int level_rows(int size, int l) { return ((size >> l) + 7) & ~7; }

// The lengths in elements of the kernel's arrays, from the tensors the
// wrapper passes (checked.cuh).
struct Lens {
  long long depth, col, prm6, range, color, r_max;
};

// The level offsets are running sums in the loops below, not an array: a
// level table passed by value and indexed by the loop counter is copied to
// every thread's local memory (ptxas -v shows it as a stack frame), which
// made the kernel 7.6x slower on an H100.
__global__ void __launch_bounds__(kTileX * kTileY)
build_face_kernel(const float* __restrict__ depth, const int* __restrict__ col,
                  const float* __restrict__ prm6, short* __restrict__ range_out,
                  int* __restrict__ color_out, int* __restrict__ r_max, int h, int w,
                  int size, int levels, int stack_rows, Lens L) {
  const int f = blockIdx.z;
  // face f's parameter k
  auto prm = [&](int k) { return KINFU_AT(prm6, L.prm6, f * kPrm + k); };
  if (prm(13) == 0.0f) return;  // face gate off: no stack, r_max[f] stays 0
  const long long face_px = static_cast<long long>(stack_rows) * size;
  const long long face0 = f * face_px;
  const int j = blockIdx.x * kTileX + threadIdx.x;
  const int i = blockIdx.y * kTileY + threadIdx.y;

  int r_int = 0;
  if (i < size && j < size) {
    // the face focal and the camera focals are static in the JAX package,
    // whose compiler turns a division by them into a multiplication by the
    // float32 reciprocal; 1.0f / x is that reciprocal (IEEE division)
    const float inv_f = 1.0f / prm(14), c = prm(15);
    const float fx = prm(9), fy = prm(10), cx = prm(11), cy = prm(12);
    const float inv_fx = 1.0f / fx, inv_fy = 1.0f / fy;
    const float dpx = (static_cast<float>(j) - c) * inv_f;
    const float dpy = (static_cast<float>(i) - c) * inv_f;
    const float dcx = prm(0) * dpx + prm(1) * dpy + prm(2);
    const float dcy = prm(3) * dpx + prm(4) * dpy + prm(5);
    const float dcz = prm(6) * dpx + prm(7) * dpy + prm(8);
    const bool in_front = dcz > 1e-6f;
    const float zs = in_front ? dcz : 1.0f;
    const int u = kinfu::rint_clamped(dcx / zs * fx + cx);
    const int v = kinfu::rint_clamped(dcy / zs * fy + cy);
    const bool inb = in_front && u >= 0 && u < w && v >= 0 && v < h;
    const float d = kinfu::gather2d(depth, L.depth, h, w, v, u);
    const int cval = kinfu::gather2d(col, L.col, h, w, v, u);

    // range of the ROUNDED pixel's ray: depth * ||K^-1 [u, v, 1]|| in mm
    const float lx = (static_cast<float>(u) - cx) * inv_fx;
    const float ly = (static_cast<float>(v) - cy) * inv_fy;
    const float lam = sqrtf(lx * lx + ly * ly + 1.0f);
    float r_mm = d * lam * 1000.0f;
    const bool valid = inb && d > 0.0f;
    r_mm = valid ? fminf(fmaxf(r_mm, 1.0f), 32767.0f) : 0.0f;
    const short rv = static_cast<short>(static_cast<int>(r_mm));
    const int cv = valid ? cval : 0;
    r_int = rv;
    // level l holds this pixel at (i >> l, j >> l) where i and j are
    // multiples of 2^l and that position lies inside the level
    int off = 0;
    for (int l = 0; l < levels; ++l) {
      const int m = (1 << l) - 1, wl = size >> l;
      if ((i & m) || (j & m)) break;
      if ((i >> l) < wl && (j >> l) < wl) {
        const long long o = face0 + static_cast<long long>(off + (i >> l)) * size + (j >> l);
        KINFU_AT(range_out, L.range, o) = rv;
        KINFU_AT(color_out, L.color, o) = cv;
      }
      off += level_rows(size, l);
    }
  }
  // the padding of level l at position (i, j) within the level
  if (j < size) {
    int off = 0;
    for (int l = 0; l < levels; ++l) {
      const int wl = size >> l, rows = level_rows(size, l);
      if (i < rows && (i >= wl || j >= wl)) {
        const long long o = face0 + static_cast<long long>(off + i) * size + j;
        KINFU_AT(range_out, L.range, o) = 0;
        KINFU_AT(color_out, L.color, o) = 0;
      }
      off += rows;
    }
  }

  // the block's largest range, one atomic a block (ranges are >= 0)
  __shared__ int s_max[kTileY];
  r_int = __reduce_max_sync(0xffffffffu, r_int);
  if (threadIdx.x == 0) s_max[threadIdx.y] = r_int;
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    int m = 0;
    for (int k = 0; k < kTileY; ++k) m = max(m, s_max[k]);
    if (m > 0) atomicMax(&KINFU_AT(r_max, L.r_max, f), m);
  }
}

}  // namespace

// lens: the six arrays' lengths in elements, in argument order (int64)
extern "C" int kinfu_build_faces(const void* depth, const void* col, const void* prm6,
                                 void* range_out, void* color_out, void* r_max, int h, int w,
                                 int size, int levels, const void* lens, void* stream) {
  if (levels < 1 || size < 1 || (size >> (levels - 1)) < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int stack_rows = 0;
  for (int l = 0; l < levels; ++l) stack_rows += ((size >> l) + 7) & ~7;
  const long long* n = static_cast<const long long*>(lens);
  const Lens L{n[0], n[1], n[2], n[3], n[4], n[5]};
  if (L.r_max < kFaces) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(r_max, 0, kFaces * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // rows up to level 0's allocation (>= size), which also covers every
  // other level's rows
  const int rows0 = (size + 7) & ~7;
  const dim3 block(kTileX, kTileY);
  const dim3 grid((size + kTileX - 1) / kTileX, (rows0 + kTileY - 1) / kTileY, kFaces);
  build_face_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(depth), static_cast<const int*>(col),
      static_cast<const float*>(prm6), static_cast<short*>(range_out),
      static_cast<int*>(color_out), static_cast<int*>(r_max), h, w, size, levels, stack_rows, L);
  return static_cast<int>(cudaGetLastError());
}
