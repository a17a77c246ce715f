// S1: the streaming grid's shift, in place: new[z, y, x] = old[z + sz,
// y + sy, x + sx], zero where the source falls outside, for the TSDF, the
// weight and the colour, inside the arrays the state already holds.
//
// Replaces no TPU kernel: the JAX package shifts with a jnp.roll and a mask
// an axis outside any Pallas kernel (kinfu_tpu/volume/stream.py:24-47), and
// the port had one plain-torch gather and select into new tensors
// (volume/stream.py::shift_volume, the twin), which the graphed step then
// copied back into the state's tensors. The shift (sx, sy, sz) is an int32
// device vector, so the host never reads it: each launch reads its own
// component and returns at once when it is 0, which is every launch on a
// frame whose grid does not move.
//
// Zero-filled shifts along different axes commute, so one pass an axis
// gives the twin's bits: x, then y, then z, one launch each. A pass walks
// each line of its axis in the order that reads every voxel before it is
// overwritten: ascending for s > 0 (element k reads k + s > k, which no
// earlier step wrote), descending for s < 0. A shift of |s| >= n along an
// axis reads nothing and zeroes the volume, as the twin does.
//   - y and z: a thread a line, neighbouring threads on neighbouring x, so
//     each step's loads and stores are coalesced. The line is walked
//     kChunk elements a step: the chunk's sources are read into registers,
//     then its destinations written, which keeps kChunk loads in flight a
//     thread and is race-free for the same reason as one at a time. Where
//     X is even and the arrays aligned, a thread moves two voxels of x at
//     once (short2 / int2).
//   - x: the lines are contiguous. A block walks a row in chunks of
//     kRowChunk: every thread reads its elements of the chunk's sources
//     into registers, the block synchronises, then writes. Chunks go in
//     the walk's order, so a chunk's reads never see a later chunk's
//     writes, and the barrier keeps its writes after every read of the
//     chunk before it.
// The x launch also adds to the device counter counts[2] (int64): the
// calls, and the calls whose shift has a component other than 0.
//
// Bound on this card: memory. A nonzero component reads and writes the 8 B
// voxels once: 2.147 GB at 512^3, 0.641 ms at 3.35 TB/s. Two nonzero
// components cost two passes. A zero shift costs three launches that read
// 12 B and return.
// Plain version: volume/stream.py::shift_volume; the wrapper is
// volume/stream.py::shift_volume_.
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

// elements of a line a thread of the y and z passes moves a step
constexpr int kChunk = 4;
// threads of a block of the x pass, and elements of a row a thread holds
constexpr int kRowThreads = 128;
constexpr int kRowPer = 4;
constexpr int kRowChunk = kRowThreads * kRowPer;
// threads of a block of the y and z passes
constexpr int kLineThreads = 256;

// The lengths in elements of the kernel's arrays, from the tensors the
// wrapper passes (checked.cuh); those of the volume's arrays in the units
// a pass moves (two voxels for the paired passes).
struct Lens {
  long long tsdf, weight, color, shift, counts;
};

// Component `axis` (0 x, 1 y, 2 z) of the shift, clamped to [-n, n]: a
// shift of n or more along an axis of n voxels wipes it.
__device__ __forceinline__ int axis_shift(const int* shift, long long len, int axis, int n) {
  const int s = KINFU_AT(shift, len, axis);
  return s < -n ? -n : (s > n ? n : s);
}

// The y or z pass: line l = (a, u) of `lines` x `units` starts at
// a * outer + u and steps by `stride`; its element k becomes element
// k + s of the line, or zero.
template <typename TS, typename TC>
__global__ void shift_lines_kernel(TS* tsdf, TS* weight, TC* color, const int* shift, int axis,
                                   int n, long long lines, int units, long long outer,
                                   long long stride, Lens L) {
  const int s = axis_shift(shift, L.shift, axis, n);
  if (s == 0) return;
  const long long l = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= lines * units) return;
  const long long base = (l / units) * outer + l % units;
  const bool up = s > 0;
  TS t[kChunk], w[kChunk];
  TC c[kChunk];
  for (int k0 = 0; k0 < n; k0 += kChunk) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int k = up ? k0 + j : n - 1 - (k0 + j);
      const int src = k + s;
      t[j] = TS{};
      w[j] = TS{};
      c[j] = TC{};
      if (k0 + j < n && src >= 0 && src < n) {
        const long long i = base + src * stride;
        t[j] = KINFU_AT(tsdf, L.tsdf, i);
        w[j] = KINFU_AT(weight, L.weight, i);
        c[j] = KINFU_AT(color, L.color, i);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (k0 + j < n) {
        const long long i = base + (up ? k0 + j : n - 1 - (k0 + j)) * stride;
        KINFU_AT(tsdf, L.tsdf, i) = t[j];
        KINFU_AT(weight, L.weight, i) = w[j];
        KINFU_AT(color, L.color, i) = c[j];
      }
    }
  }
}

// The x pass, a block a row (grid-stride over the rows), and the counter.
__global__ void shift_rows_kernel(short* tsdf, short* weight, int* color, const int* shift,
                                  long long* counts, int X, long long rows, Lens L) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const bool moved = KINFU_AT(shift, L.shift, 0) != 0 || KINFU_AT(shift, L.shift, 1) != 0 ||
                       KINFU_AT(shift, L.shift, 2) != 0;
    KINFU_AT(counts, L.counts, 0) += 1;
    KINFU_AT(counts, L.counts, 1) += moved ? 1 : 0;
  }
  const int s = axis_shift(shift, L.shift, 0, X);
  if (s == 0) return;
  const bool up = s > 0;
  const int chunks = (X + kRowChunk - 1) / kRowChunk;
  short t[kRowPer], w[kRowPer];
  int c[kRowPer];
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const long long row = r * X;
    for (int q = 0; q < chunks; ++q) {
      const int c0 = (up ? q : chunks - 1 - q) * kRowChunk;
#pragma unroll
      for (int j = 0; j < kRowPer; ++j) {
        const int x = c0 + j * kRowThreads + static_cast<int>(threadIdx.x);
        const int src = x + s;
        t[j] = 0;
        w[j] = 0;
        c[j] = 0;
        if (x < X && src >= 0 && src < X) {
          t[j] = KINFU_AT(tsdf, L.tsdf, row + src);
          w[j] = KINFU_AT(weight, L.weight, row + src);
          c[j] = KINFU_AT(color, L.color, row + src);
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kRowPer; ++j) {
        const int x = c0 + j * kRowThreads + static_cast<int>(threadIdx.x);
        if (x < X) {
          KINFU_AT(tsdf, L.tsdf, row + x) = t[j];
          KINFU_AT(weight, L.weight, row + x) = w[j];
          KINFU_AT(color, L.color, row + x) = c[j];
        }
      }
    }
  }
}

// The y and z passes on arrays moved `units` of X at a time.
template <typename TS, typename TC>
cudaError_t shift_lines(void* tsdf, void* weight, void* color, const int* shift, int Z, int Y,
                        int units, Lens L, cudaStream_t stream) {
  const long long plane = static_cast<long long>(Y) * units;
  // y: lines (z, u), elements `units` apart; z: lines (y, u), `plane` apart
  const struct {
    int axis, n;
    long long lines, outer, stride;
  } passes[2] = {{1, Y, Z, plane, units}, {2, Z, Y, units, plane}};
  for (const auto& p : passes) {
    const long long threads = p.lines * units;
    const unsigned blocks = static_cast<unsigned>((threads + kLineThreads - 1) / kLineThreads);
    shift_lines_kernel<TS, TC><<<blocks, kLineThreads, 0, stream>>>(
        static_cast<TS*>(tsdf), static_cast<TS*>(weight), static_cast<TC*>(color), shift, p.axis,
        p.n, p.lines, units, p.outer, p.stride, L);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Blocks of the x pass: enough to fill every SM, fewer where there are
// fewer rows, so that a zero shift returns from few blocks.
unsigned row_blocks(long long rows) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const long long most = static_cast<long long>(sms) * (2048 / kRowThreads);
  return static_cast<unsigned>(rows < most ? rows : most);
}

bool aligned(const void* p, unsigned long long bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

}  // namespace

// lens: the arrays' lengths in elements (int64): tsdf, weight, color, shift,
// counts. Three launches on `stream`: x (with the counter), y, z.
extern "C" int kinfu_shift_volume(void* tsdf, void* weight, void* color, const void* shift,
                                  void* counts, int Z, int Y, int X, const void* lens,
                                  void* stream) {
  const long long* n = static_cast<const long long*>(lens);
  Lens L{n[0], n[1], n[2], n[3], n[4]};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sh = static_cast<const int*>(shift);
  const long long rows = static_cast<long long>(Z) * Y;
  if (rows > 0) {
    shift_rows_kernel<<<row_blocks(rows), kRowThreads, 0, st>>>(
        static_cast<short*>(tsdf), static_cast<short*>(weight), static_cast<int*>(color), sh,
        static_cast<long long*>(counts), X, rows, L);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || rows == 0 || X == 0) return static_cast<int>(err);
  if (X % 2 == 0 && aligned(tsdf, 4) && aligned(weight, 4) && aligned(color, 8)) {
    const Lens L2{L.tsdf / 2, L.weight / 2, L.color / 2, L.shift, L.counts};
    err = shift_lines<short2, int2>(tsdf, weight, color, sh, Z, Y, X / 2, L2, st);
  } else {
    err = shift_lines<short, int>(tsdf, weight, color, sh, Z, Y, X, L, st);
  }
  return static_cast<int>(err);
}
