// A CPU stand-in for the pieces of the CUDA runtime that the port's
// kernels (gubernator_tpu_torch/csrc/*.cu) use, so that their device
// code can be compiled by g++ and run against the plain PyTorch
// versions on a machine with no card (tests/test_torch_kernels_emulated.py).
//
// A launch `k<<<grid, block, 0, stream>>>(args)` is rewritten by the
// test into `gt_emu_launch(grid, block, 0, stream, k, args)`, which
// runs every thread of every block one after another.  That is a valid
// schedule for these kernels: they use no shared memory, no barriers
// and no warp operations, and the threads of one launch write disjoint
// words (the atomic add aside, emulated below).  What it cannot show:
// races, alignment faults, and anything the GPU compiler does
// differently; the kernels are still held to the plain versions on the
// card by tests/test_torch_kernels.py and chip_smoke.py.
#pragma once

#include <cstdint>

struct alignas(16) int4 {
  int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};

#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(n)

typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }

inline dim3 blockIdx, threadIdx;

inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
  return uint64_t((unsigned __int128)a * b >> 64);
}

inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  const unsigned long long old = *p;
  *p = old + v;
  return old;
}

template <class Kernel, class... Args>
void gt_emu_launch(dim3 grid, dim3 block, int, cudaStream_t, Kernel kernel, Args... args) {
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned x = 0; x < grid.x; ++x)
      for (unsigned t = 0; t < block.x; ++t) {
        blockIdx = dim3(x, y);
        threadIdx = dim3(t);
        kernel(args...);
      }
}
