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
// What bounds it on this card: memory, and latency more than bandwidth.
// Per lane it gathers a 32-byte hot row and a 32-byte cold row at a
// random slot, reads 12 bytes of wire (plus a config-table word that
// stays in cache), writes 16 (narrow) or 32 (wide) bytes of output,
// and scatters a 32-byte hot row (plus the cold row when its config
// changed) for the lanes that write.  The integer arithmetic per lane
// (a few hundred int64 operations, the 128-bit leak division only on
// the rare lanes whose product overflows int64) is far below the
// card's rate.
//
// Design.  Lanes interact only through their slot row: every lane of a
// round must read the PRE-round row, the round's single writer of a
// slot then stores its row, and round r+1 must see round r's writes.
// Each round is therefore two launches on one stream: a compute launch,
// one thread per lane over all S*P lanes, that gathers, evaluates,
// writes the lane's output and stages its new rows in a scratch record;
// then a commit launch that scatters the staged rows.  Stream order is
// the barrier between the two, so no grid-wide synchronisation is
// needed and every SM takes part; the staged record costs 64 bytes of
// scratch traffic per lane.  Row gathers and scatters are 16-byte
// vector accesses.

#include <cuda_runtime.h>

#include <cstdint>

#include "bucket_rounds.cuh"

namespace gt {

constexpr int kThreads = 256;

// One thread per lane of all S*P lanes (grid.y = shard).
template <class Source, bool WIDE>
__global__ void __launch_bounds__(kThreads)
round_compute(const int32_t* __restrict__ hot, const int32_t* __restrict__ cold,
              int64_t C, Source src, int64_t P, int32_t round, int32_t n_rounds,
              int64_t now, int32_t* __restrict__ stage, void* __restrict__ out) {
  const int64_t p = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (p < P)
    compute_lane(hot, cold, C, src, BucketOut<WIDE>{out, P, now}, blockIdx.y, p, P,
                 round, n_rounds, now, stage);
}

__global__ void __launch_bounds__(kThreads)
round_commit(int32_t* __restrict__ hot, int32_t* __restrict__ cold, int64_t C,
             int64_t P, const int32_t* __restrict__ stage) {
  const int64_t p = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (p < P) commit_lane(hot, cold, C, blockIdx.y, p, P, stage);
}

template <class Source, bool WIDE>
int run_rounds(int32_t* hot, int32_t* cold, int64_t S, int64_t C, Source src,
               int64_t P, int32_t n_rounds, int64_t now, int32_t* stage,
               void* out, cudaStream_t stream) {
  const dim3 grid(unsigned((P + kThreads - 1) / kThreads), unsigned(S));
  for (int32_t r = 0; r < n_rounds; ++r) {
    round_compute<Source, WIDE><<<grid, kThreads, 0, stream>>>(
        hot, cold, C, src, P, r, n_rounds, now, stage, out);
    round_commit<<<grid, kThreads, 0, stream>>>(hot, cold, C, P, stage);
  }
  return int(cudaGetLastError());
}

}  // namespace gt

extern "C" {

// K1: dict-wire batch.  hot/cold i32[S, C, 8] (updated in place), wire
// i32[S, W] with W = 3P + 3072, stage i32[S, P, 16] scratch, out
// i32[S, 4, P] or (wide) i64[S, 4, P].  Returns cudaGetLastError().
int gt_bucket_rounds_dict(int32_t* hot, int32_t* cold, int64_t S, int64_t C,
                          const int32_t* wire, int64_t P, int32_t n_rounds,
                          int64_t now_ms, int32_t wide, int32_t* stage,
                          void* out, void* stream) {
  const int64_t W = 3 * P + 12 * gt::kTableRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide)
    return gt::run_rounds<gt::DictSource<true>, true>(
        hot, cold, S, C, gt::DictSource<true>{wire, P, W}, P, n_rounds,
        now_ms, stage, out, st);
  return gt::run_rounds<gt::DictSource<false>, false>(
      hot, cold, S, C, gt::DictSource<false>{wire, P, W}, P, n_rounds, now_ms,
      stage, out, st);
}

// K2: per-lane-column batch.  lanes i32[S, 6, P]; values i32[S, 5, P]
// or (wide) i64[S, 5, P]; the rest as K1.
int gt_bucket_rounds_cols(int32_t* hot, int32_t* cold, int64_t S, int64_t C,
                          const int32_t* lanes, const void* values, int64_t P,
                          int32_t n_rounds, int64_t now_ms, int32_t wide,
                          int32_t* stage, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide)
    return gt::run_rounds<gt::ColsSource<true>, true>(
        hot, cold, S, C, gt::ColsSource<true>{lanes, values, P}, P, n_rounds,
        now_ms, stage, out, st);
  return gt::run_rounds<gt::ColsSource<false>, false>(
      hot, cold, S, C, gt::ColsSource<false>{lanes, values, P}, P, n_rounds,
      now_ms, stage, out, st);
}

}  // extern "C"
