// Compact-commit bucket kernel, on Hopper (sm_90a).
//
// Replaces the JAX package's single-round programs with a compacted
// commit:
//   * gt_bucket_compact (K10) — ops/buckets.py::apply_compact32 (narrow
//     per-lane columns) and apply_compact_packed (the single-buffer dict
//     wire): one round of a batch, every lane evaluated as
//     _apply_compute does, the narrow i32[4, P] output of
//     apply_rounds32, and a row scatter of only the lanes the host lists
//     in `wlane` (i32[Pw], -1 padded) instead of all P lanes.
//
// In both packages this is off the production path: the JAX stores
// measured the compact form slower than the per-lane commit on their
// TPU, and no port store calls it.  It is kept, and built, so that the
// question can be asked of this card (chip_smoke.py holds it against
// K1 on the same single-round batch).
//
// What bounds it on this card: memory, as K1.  Per lane it reads 12
// bytes of dict wire (44 of per-lane columns), gathers a 32-byte hot
// and a 32-byte cold row, writes 16 bytes of output; per `wlane` entry
// it reads 4 bytes and, for a write lane, scatters a 32-byte hot row
// (and the cold row where its config changed).
//
// Design.  The same two launches on one stream as one round of K1, with
// nothing forked: the compute launch runs compute_lane
// (bucket_rounds.cuh) with every lane put in round 0 — the JAX form
// ignores the wire's round ids — so each lane evaluates against the
// pre-batch rows, writes its output and stages its new rows; the commit
// launch then runs one thread per `wlane` entry, which stores the
// staged rows of the lane it names through commit_lane.  The staged
// record says whether the lane writes its hot row and its cold row
// (write lane, config changed, slot inside the table), which is exactly
// JAX's `wvalid` and `wvalid & cold_changed`.  The JAX quirks are kept:
// an entry below 0 writes nothing, an entry >= P stands for lane P - 1
// (its clip), and a repeated entry stores the same staged row twice
// (the same bytes).  The host lists each write lane once, and write
// slots are unique in a round, so no two threads store different rows
// to one slot.

#include <cuda_runtime.h>

#include <cstdint>

#include "bucket_rounds.cuh"

namespace gt {

constexpr int kCompactThreads = 256;

// A lane source whose every lane is in round 0 (the compact form reads
// no round ids).
template <class Source>
struct OneRound {
  Source src;

  __device__ void head(int64_t s, int64_t p, int32_t& slot, int32_t& rid) const {
    src.head(s, p, slot, rid);
    rid = 0;
  }
  __device__ void lane(int64_t s, int64_t p, int64_t now, Lane& q) const {
    src.lane(s, p, now, q);
  }
};

// One thread per lane of all S*P lanes (grid.y = shard).
template <class Source>
__global__ void __launch_bounds__(kCompactThreads)
compact_compute(const int32_t* __restrict__ hot, const int32_t* __restrict__ cold,
                int64_t C, Source src, int64_t P, int64_t now,
                int32_t* __restrict__ stage, int32_t* __restrict__ out) {
  const int64_t p = int64_t(blockIdx.x) * kCompactThreads + threadIdx.x;
  if (p < P)
    compute_lane(hot, cold, C, OneRound<Source>{src}, BucketOut<false>{out, P, now},
                 blockIdx.y, p, P, 0, 1, now, stage);
}

// One thread per `wlane` entry of shard blockIdx.y.
__global__ void __launch_bounds__(kCompactThreads)
compact_commit(int32_t* __restrict__ hot, int32_t* __restrict__ cold, int64_t C,
               int64_t P, const int32_t* __restrict__ wlane, int64_t Pw,
               const int32_t* __restrict__ stage) {
  const int64_t j = int64_t(blockIdx.x) * kCompactThreads + threadIdx.x;
  if (j >= Pw) return;
  const int64_t s = blockIdx.y;
  const int64_t w = wlane[s * Pw + j];
  if (w >= 0) commit_lane(hot, cold, C, s, w < P ? w : P - 1, P, stage);
}

template <class Source>
int run_compact(int32_t* hot, int32_t* cold, int64_t S, int64_t C, Source src, int64_t P,
                const int32_t* wlane, int64_t Pw, int64_t now, int32_t* stage, int32_t* out,
                cudaStream_t stream) {
  const dim3 grid(unsigned((P + kCompactThreads - 1) / kCompactThreads), unsigned(S));
  compact_compute<Source><<<grid, kCompactThreads, 0, stream>>>(hot, cold, C, src, P, now,
                                                                stage, out);
  int rc = int(cudaGetLastError());
  if (rc != 0 || Pw == 0) return rc;
  const dim3 wgrid(unsigned((Pw + kCompactThreads - 1) / kCompactThreads), unsigned(S));
  compact_commit<<<wgrid, kCompactThreads, 0, stream>>>(hot, cold, C, P, wlane, Pw, stage);
  return int(cudaGetLastError());
}

}  // namespace gt

extern "C" {

// K10: hot/cold i32[S, C, 8] (updated in place); with `dict` the lanes
// come from the wire i32[S, 3P + 3072] in `src`, else from per-lane
// columns: lanes i32[S, 6, P] in `src` and values i32[S, 5, P]; wlane
// i32[S, Pw]; stage i32[S, P, 16] scratch; out i32[S, 4, P].  Two
// launches on `stream` (one when Pw is 0).  Returns cudaGetLastError()
// of the first launch that failed, else 0.
int gt_bucket_compact(int32_t* hot, int32_t* cold, int64_t S, int64_t C, int32_t dict,
                      const int32_t* src, const void* values, int64_t P,
                      const int32_t* wlane, int64_t Pw, int64_t now_ms, int32_t* stage,
                      int32_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dict) {
    const int64_t W = 3 * P + 12 * gt::kTableRows;
    return gt::run_compact(hot, cold, S, C, gt::DictSource<false>{src, P, W}, P, wlane, Pw,
                           now_ms, stage, out, st);
  }
  return gt::run_compact(hot, cold, S, C, gt::ColsSource<false>{src, values, P}, P, wlane,
                         Pw, now_ms, stage, out, st);
}

}  // extern "C"
