// A CPU stand-in for the pieces of the CUDA runtime that the port's
// kernels (gubernator_tpu_torch/csrc/*.cu) use, so that their device
// code can be compiled by g++ and run against the plain PyTorch
// versions on a machine with no card (tests/test_torch_kernels_emulated.py).
//
// A launch `k<<<grid, block, 0, stream>>>(args)` is rewritten by the
// test into `gt_emu_launch(grid, block, 0, stream, k, args)`, which
// runs every thread of every block one after another.  That is a valid
// schedule for those kernels: they use no shared memory, no barriers
// and no warp operations, and the threads of one launch write disjoint
// words (the atomic add aside, emulated below).
//
// A cooperative launch (cudaLaunchCooperativeKernel, the bucket-rounds
// kernel) runs every thread of the grid as a fiber (ucontext) on the
// calling thread: each fiber runs until it reaches a grid barrier
// (cooperative_groups::this_grid().sync()) or ends, then the next; when
// all have reached the barrier they go on, in order.  A fiber that ends
// while others wait at a barrier is a kernel fault (on a card the grid
// would hang) and fails the launch.  Shared memory is emulated as each
// thread's own (see __shared__ below).  The emulated device has
// GT_EMU_SMS streaming multiprocessors (default 4) with one resident
// block each, so a test picks the grid by the environment.
//
// What it cannot show: races, alignment faults, and anything the GPU
// compiler does differently; the kernels are still held to the plain
// versions on the card by tests/test_torch_kernels.py and chip_smoke.py.
#pragma once

#include <ucontext.h>

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <functional>
#include <memory>
#include <tuple>
#include <type_traits>
#include <utility>
#include <vector>

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
#define __launch_bounds__(...)
// A __shared__ array becomes each thread's own: valid for a kernel that
// keeps only per-thread data there (the bucket-rounds kernel's held
// rows), as no thread reads another's.
#define __shared__

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9,
       cudaErrorLaunchFailure = 719 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetLastError() { return 0; }

inline dim3 blockIdx, threadIdx, gridDim, blockDim;

inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
  return uint64_t((unsigned __int128)a * b >> 64);
}

template <class T>
inline T __ldcg(const T* p) {
  return *p;
}

inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  const unsigned long long old = *p;
  *p = old + v;
  return old;
}

template <class Kernel, class... Args>
void gt_emu_launch(dim3 grid, dim3 block, int, cudaStream_t, Kernel kernel, Args... args) {
  gridDim = grid;
  blockDim = block;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x)
        for (unsigned t = 0; t < block.x; ++t) {
          blockIdx = dim3(x, y, z);
          threadIdx = dim3(t);
          kernel(args...);
        }
}

// ---------------------------------------------------------------------
// The emulated device and cooperative launches.
// ---------------------------------------------------------------------
inline int gt_emu_sms() {
  const char* v = std::getenv("GT_EMU_SMS");
  return v && std::atoi(v) > 0 ? std::atoi(v) : 4;
}

// Each GT_EMU_SMS value is a device of its own (the kernels cache what
// they ask of a device by its number).
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = gt_emu_sms();
  return cudaSuccess;
}

inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr attr, int) {
  *value = attr == cudaDevAttrMultiProcessorCount ? gt_emu_sms() : 0;
  return cudaSuccess;
}

template <class Kernel>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, Kernel, int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}

namespace gt_emu {

struct Fiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  unsigned block = 0, thread = 0;
  bool done = false;
};

inline ucontext_t scheduler;
inline Fiber* current = nullptr;
inline std::function<void()> body;
constexpr size_t kStack = 256 << 10;

inline void run_fiber() {
  body();
  current->done = true;  // uc_link returns to the scheduler
}

// A grid barrier: back to the scheduler until every fiber is there.
inline void grid_sync() { swapcontext(&current->ctx, &scheduler); }

}  // namespace gt_emu

template <class... A, size_t... I>
void gt_emu_call(void (*kernel)(A...), void** args, std::index_sequence<I...>) {
  kernel(*static_cast<std::remove_reference_t<A>*>(args[I])...);
}

template <class... A>
cudaError_t cudaLaunchCooperativeKernel(void (*kernel)(A...), dim3 grid, dim3 block,
                                        void** args, size_t, cudaStream_t) {
  if (grid.x * grid.y > unsigned(gt_emu_sms())) return cudaErrorInvalidConfiguration;
  gridDim = grid;
  blockDim = block;
  const unsigned n = grid.x * grid.y * block.x;
  std::vector<gt_emu::Fiber> fibers(n);
  gt_emu::body = [&] { gt_emu_call(kernel, args, std::index_sequence_for<A...>{}); };
  for (unsigned f = 0; f < n; ++f) {
    gt_emu::Fiber& fb = fibers[f];
    fb.block = f / block.x;
    fb.thread = f % block.x;
    fb.stack.reset(new char[gt_emu::kStack]);
    getcontext(&fb.ctx);
    fb.ctx.uc_stack.ss_sp = fb.stack.get();
    fb.ctx.uc_stack.ss_size = gt_emu::kStack;
    fb.ctx.uc_link = &gt_emu::scheduler;
    makecontext(&fb.ctx, gt_emu::run_fiber, 0);
  }
  for (;;) {
    unsigned waiting = 0, ended = 0;
    for (gt_emu::Fiber& fb : fibers) {
      if (fb.done) continue;
      blockIdx = dim3(fb.block % grid.x, fb.block / grid.x);
      threadIdx = dim3(fb.thread);
      gt_emu::current = &fb;
      swapcontext(&gt_emu::scheduler, &fb.ctx);
      (fb.done ? ended : waiting) += 1;
    }
    if (waiting == 0) break;
    if (ended) return cudaErrorLaunchFailure;  // some threads left a barrier behind
  }
  gt_emu::current = nullptr;
  return cudaSuccess;
}
