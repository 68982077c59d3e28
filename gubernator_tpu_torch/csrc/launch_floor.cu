// Empty kernels that measure the fixed cost of a launch on the card:
// the floor under the device time of a kernel that moves few bytes (K3
// on the GLOBAL path's batches, K5, K6).  Not a kernel of any path;
// chip_smoke.py times them beside the bounds.
//   * gt_launch_floor(0, ...) — an empty kernel, launched as any plain
//     kernel;
//   * gt_launch_floor(1, ...) — an empty cooperative kernel whose only
//     work is one grid barrier, launched as K1-K3 and K9 are.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace gt {

__global__ void empty_kernel() {}

__global__ void empty_barrier_kernel() { cg::this_grid().sync(); }

}  // namespace gt

extern "C" {

// One empty launch of `blocks` blocks of `threads` threads on `stream`
// (`cooperative`: the one-barrier kernel, as a cooperative launch).
// Returns its CUDA error.
int gt_launch_floor(int32_t cooperative, int64_t blocks, int32_t threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!cooperative) {
    gt::empty_kernel<<<unsigned(blocks), unsigned(threads), 0, st>>>();
    return int(cudaGetLastError());
  }
  void* args[] = {nullptr};  // the kernel takes none
  return int(cudaLaunchCooperativeKernel(gt::empty_barrier_kernel, dim3(unsigned(blocks)),
                                         dim3(unsigned(threads)), args, 0, st));
}

}  // extern "C"
