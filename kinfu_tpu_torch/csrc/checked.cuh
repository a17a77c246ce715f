// Bounds-checked global memory access, for the checked build of the kernels.
//
// Every global load and store of the kernels goes through KINFU_AT(p, n, i):
// element i of the array p of n elements. The lengths come from the tensors
// the wrapper passes (their numel, ops/kernels.py::lengths), not from the
// kernel's own dims, so an output that a caller allocated too short is an
// out-of-range index too. In the normal build KINFU_AT(p, n, i) is p[i]. In
// the checked build (-DKINFU_CHECKED -lineinfo: ops/kernels.py::build with
// checked=True, which tools/sanitize.py loads) an index outside [0, n)
// prints the source file and line, the index and n, and traps: the launch
// ends with an error that the next synchronisation reports.
//
// This is the port's memory checker: compute-sanitizer exists on the card's
// machine but refuses the device ("Device not supported"), so its memcheck,
// racecheck, initcheck and synccheck cannot run there.
#pragma once

#include <cstdio>

#include <cuda_runtime.h>

namespace kinfu {

template <typename T>
__device__ __forceinline__ T& at(T* p, long long n, long long i, const char* file, int line) {
#ifdef KINFU_CHECKED
  if (i < 0 || i >= n) {
    printf("kinfu checked build: %s:%d: index %lld outside [0, %lld)\n", file, line, i, n);
    __trap();
  }
#endif
  return p[i];
}

}  // namespace kinfu

#define KINFU_AT(p, n, i) \
  (::kinfu::at((p), (n), static_cast<long long>(i), __FILE__, __LINE__))
