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
// What bounds it on this card: bytes and instructions, as K1 (see
// bucket_rounds.cu).  Per lane it reads 12 bytes of dict wire (44 of
// per-lane columns), gathers a 32-byte hot and a 32-byte cold row,
// writes 16 bytes of output; per `wlane` entry it reads 4 bytes and
// marks its lane (4 bytes), and a write lane reads its mark and, where
// listed, scatters a 32-byte hot row (and the cold row where its config
// changed).
//
// Design.  One cooperative launch of K1's rounds kernel (rounds.cuh)
// with every lane in round 0 (OneRound: the JAX form ignores the wire's
// round ids) and the CompactOut sink: the read half evaluates each lane
// against the pre-batch rows and writes its output, a held writer keeps
// its new rows in shared memory across the grid barrier, and the write
// half stores them, with no staging buffer and no second launch.  While
// the read half's rows are in flight, its threads walk `wlane` and stamp
// the word of each listed lane in `mark` (i32[S * P], the wrapper's, one
// per device and stream) with this call's generation `gen`; the write
// half stores a writer's rows only where its word holds `gen`, read
// through L2 after the barrier that orders the stamps before it.  A word
// an earlier call stamped holds an older generation, so no call clears
// the marks.  That is JAX's `wvalid = (wlane >= 0) & writes[clip(wlane)]`:
// an entry below 0 marks nothing, an entry >= P marks lane P - 1 (its
// clip), a repeated entry marks its lane again (JAX stores the same row
// twice, the same bytes); a listed lane stores its hot row where it is a
// write lane and its cold row where its config changed.  A writer past
// the lanes the launch holds evaluates again in the write half, as in
// K1, and asks the same mark.  The host lists each write lane once, and
// write slots are unique in a round, so no two threads store different
// rows to one slot.

#include <cuda_runtime.h>

#include <cstdint>

#include "bucket_rounds.cuh"
#include "rounds.cuh"

namespace gt {

// A lane source whose every lane is in round 0 (the compact form reads
// no round ids).
template <class Source>
struct OneRound {
  static constexpr bool kDict = Source::kDict;
  Source src;

  __device__ void head(int64_t s, int64_t p, int32_t& slot, int32_t& rid) const {
    src.head(s, p, slot, rid);
    rid = 0;
  }
  __device__ void prefetch(int64_t s, int64_t p) const { src.prefetch(s, p); }
  __device__ void lane(int64_t s, int64_t p, int64_t now, Lane& q) const {
    src.lane(s, p, now, q);
  }
};

// K10's sink: K1's narrow output, and a writer stores only when `wlane`
// lists it.
struct CompactOut : BucketOut<false> {
  static constexpr bool kListed = true;
  const int32_t* wlane;  // i32[S, Pw]
  int32_t* mark;         // i32[S * P]
  int64_t Pw;
  int32_t gen;

  // Thread t of T stamps the lanes of its `wlane` entries (n = S * P).
  __device__ void mark_listed(int32_t t, int32_t T, int32_t n) const {
    const int64_t entries = int64_t(n / P) * Pw;
    for (int64_t j = t; j < entries; j += T) {
      const int32_t w = wlane[j];
      if (w >= 0) mark[(j / Pw) * P + (w < P ? w : P - 1)] = gen;
    }
  }
  __device__ bool listed(int64_t s, int64_t p) const { return __ldcg(mark + s * P + p) == gen; }
};

}  // namespace gt

extern "C" {

// K10: hot/cold i32[S, C, 8] (updated in place); with `dict` the lanes
// come from the wire i32[S, 3P + 3072] in `src`, else from per-lane
// columns: lanes i32[S, 6, P] in `src` and values i32[S, 5, P]; wlane
// i32[S, Pw]; mark i32[S * P], whose words never hold `gen` before the
// call (see above); out i32[S, 4, P].  One cooperative launch on
// `stream`; returns its CUDA error.
int gt_bucket_compact(int32_t* hot, int32_t* cold, int64_t S, int64_t C, int32_t dict,
                      const int32_t* src, const void* values, int64_t P,
                      const int32_t* wlane, int64_t Pw, int64_t now_ms, int32_t* mark,
                      int32_t gen, int32_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const gt::CompactOut sink{{out, P, now_ms}, wlane, mark, Pw, gen};
  if (dict) {
    const int64_t W = 3 * P + 12 * gt::kTableRows;
    return gt::run_rounds(hot, cold, S, C, gt::OneRound<gt::DictSource<false>>{{src, P, W}},
                          sink, 1, st);
  }
  return gt::run_rounds(hot, cold, S, C,
                        gt::OneRound<gt::ColsSource<false>>{{src, values, P}}, sink, 1, st);
}

}  // extern "C"
