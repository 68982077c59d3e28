// Bucket-rounds kernels: one rate-limit batch against the bucket tables
// of every shard, on Hopper (sm_90a).
//
// Replaces the JAX package's main-path device programs:
//   * gt_bucket_rounds_dict (K1) — parallel/mesh.py::_rounds_packed_mesh
//     and _rounds_packed_wide_mesh, i.e. ops/buckets.py
//     apply_rounds_packed[_wide] -> apply_rounds_dict -> apply_rounds32
//     / apply_rounds -> apply_batch (_apply_compute + _commit_rows),
//     vmapped over S shards, plus the single-buffer wire decode
//     (unpack_dict_wire) as its prologue.  The launch-fused program
//     (_mesh_fused_packed_jit) is K launches of K1 in stream order.
//   * gt_bucket_rounds_cols (K2) — parallel/mesh.py::_rounds32_mesh_jit
//     and _rounds64_mesh_jit: the same rounds fed from per-lane value
//     columns (the fallback when a batch has more than 256 configs,
//     occ > 65535 or more than 255 rounds).
//
// What bounds it on this card: bytes.  Per lane it gathers a 32-byte
// hot row and a 32-byte cold row at a random slot, reads 12 bytes of
// wire (plus config-table words that stay in cache), writes 16 (narrow)
// or 32 (wide) bytes of output, and stores a 32-byte hot row (plus the
// cold row when its config changed) for the lanes that write.  A lane
// executes some 360-540 instructions, about half on the integer pipe
// (chip_smoke.py counts them in the SASS); at the card's issue and
// integer rates that is less time than the bytes take.  In practice
// each round waits on a chain of dependent loads (head, request, row)
// and on its grid barriers, and a warp whose lanes take different
// branches runs each branch in turn.
//
// Design: one cooperative launch runs every round of the batch, the
// rounds kernel of rounds.cuh fed by the dict wire (DictSource) or the
// per-lane columns (ColsSource) with the BucketOut sink; a lane
// evaluates only the branch it takes (bucket_rounds.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "bucket_rounds.cuh"
#include "rounds.cuh"

extern "C" {

// K1: dict-wire batch.  hot/cold i32[S, C, 8] (updated in place), wire
// i32[S, W] with W = 3P + 3072, out i32[S, 4, P] or (wide) i64[S, 4, P].
// One cooperative launch on `stream`; returns its CUDA error.
int gt_bucket_rounds_dict(int32_t* hot, int32_t* cold, int64_t S, int64_t C,
                          const int32_t* wire, int64_t P, int32_t n_rounds,
                          int64_t now_ms, int32_t wide, void* out, void* stream) {
  const int64_t W = 3 * P + 12 * gt::kTableRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide)
    return gt::run_rounds(hot, cold, S, C, gt::DictSource<true>{wire, P, W},
                          gt::BucketOut<true>{out, P, now_ms}, n_rounds, st);
  return gt::run_rounds(hot, cold, S, C, gt::DictSource<false>{wire, P, W},
                        gt::BucketOut<false>{out, P, now_ms}, n_rounds, st);
}

// K2: per-lane-column batch.  lanes i32[S, 6, P]; values i32[S, 5, P]
// or (wide) i64[S, 5, P]; the rest as K1.
int gt_bucket_rounds_cols(int32_t* hot, int32_t* cold, int64_t S, int64_t C,
                          const int32_t* lanes, const void* values, int64_t P,
                          int32_t n_rounds, int64_t now_ms, int32_t wide, void* out,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide)
    return gt::run_rounds(hot, cold, S, C, gt::ColsSource<true>{lanes, values, P},
                          gt::BucketOut<true>{out, P, now_ms}, n_rounds, st);
  return gt::run_rounds(hot, cold, S, C, gt::ColsSource<false>{lanes, values, P},
                        gt::BucketOut<false>{out, P, now_ms}, n_rounds, st);
}

// The lanes one K1/K2 launch holds in shared memory on the current device:
// resident threads x kHeldLanes (`dict`, `wide` pick the kernel).  Returns
// the CUDA error of the occupancy query.
int gt_bucket_rounds_held_lanes(int32_t dict, int32_t wide, int64_t* lanes) {
  using gt::BucketOut, gt::ColsSource, gt::DictSource, gt::launch_shape;
  int64_t blocks = 0;
  if (dict && wide) return launch_shape<DictSource<true>, BucketOut<true>>(0, blocks, *lanes);
  if (dict) return launch_shape<DictSource<false>, BucketOut<false>>(0, blocks, *lanes);
  if (wide) return launch_shape<ColsSource<true>, BucketOut<true>>(0, blocks, *lanes);
  return launch_shape<ColsSource<false>, BucketOut<false>>(0, blocks, *lanes);
}

}  // extern "C"
