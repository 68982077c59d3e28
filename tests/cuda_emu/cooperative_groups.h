// A CPU stand-in for the grid group of CUDA's cooperative groups: the
// grid barrier of a cooperative launch emulated by cuda_runtime.h.
#pragma once

#include "cuda_runtime.h"

namespace cooperative_groups {

struct grid_group {
  void sync() const { gt_emu::grid_sync(); }
};

inline grid_group this_grid() { return {}; }

}  // namespace cooperative_groups
