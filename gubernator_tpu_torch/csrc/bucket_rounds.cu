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
// Design.  Lanes interact only through their slot row: every lane of a
// round must read the PRE-round row, the round's single writer of a slot
// then stores its row, and round r+1 must see round r's writes.  One
// cooperative launch runs every round of the batch: as many blocks as
// can be resident at once (never more than the lanes need), each thread
// owning the flattened (shard, lane) indices t, t + T, t + 2T, ... of
// the T threads.  A round is a read half — the round's lanes gather
// their rows (a held lane's by cp.async into shared memory, all of a
// thread's in flight together), evaluate only the branch they take and
// write their output, and a writer keeps its new rows in shared memory —
// a grid barrier, and a write half in which the writers store those
// rows; a second barrier separates the round from the next.  A thread
// reads the slot and round id of its first kHeld lanes once, into shared
// memory (kHeld: 2, or 3 for K2 wide); lanes past kHeld * T (a batch
// larger than the resident threads hold) are read again each round, and
// their writers evaluate again in the write half against their own slot's row, which no other lane of
// the round writes, so no lane's rows pass through device memory before
// they are stored.  Row loads bypass L1 (cp.async.cg, ld.global.cg):
// another SM's stores before a barrier must be seen after it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "bucket_rounds.cuh"

namespace cg = cooperative_groups;

namespace gt {

constexpr int kThreads = 256;
// Resident blocks of 256 threads a SM: 4 (at most 64 registers a
// thread) gives 32 warps, against the 24 of the two-launch kernels
// (74-76 registers), and 135,168 threads on 132 SMs, one for each lane
// of the one-shard headline's 131,072.  K2 wide, whose lanes read five
// 64-bit values, spills at 64 registers and takes 3 (80 registers, the
// 24 warps of before).
template <class Source, bool WIDE>
constexpr int kMinBlocks = !Source::kDict && WIDE ? 3 : 4;
// Lanes a thread holds across a round's barrier: two cover the main
// path's S * P = 262,144 lanes at 4 blocks a SM (270,336 held), three at
// K2 wide's 3 (304,128).  A held lane keeps its slot, round id and write
// flag (12 bytes) and its rows (48 bytes: the gathered rows, then the
// new ones) in its block's shared memory, 15 KB a block for each lane a
// thread holds; kept in registers, two lanes' rows spilled.
template <class Source, bool WIDE>
constexpr int kHeldLanes = kMinBlocks<Source, WIDE> == 3 ? 3 : 2;

// Lane i of the flattened [S, P] batch: shard and lane within it.
__device__ __forceinline__ void split(int32_t i, int32_t P, int32_t& s, int32_t& p) {
  s = i / P;
  p = i - s * P;
}

// Reads a lane's slot and round id; writes the all-zero output of a
// lane no round evaluates (slot < 0 or a round id outside [0,
// n_rounds)) and returns false for it.
template <class Source, class Sink>
__device__ __forceinline__ bool lane_head(const Source& src, const Sink& sink, int32_t i,
                                          int32_t P, int32_t n_rounds, int32_t& slot,
                                          int32_t& rid) {
  int32_t s, p;
  split(i, P, s, p);
  src.head(s, p, slot, rid);
  if (slot >= 0 && rid >= 0 && rid < n_rounds) return true;
  sink.zero(s, p);
  return false;
}

template <class Source, bool WIDE>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<Source, WIDE>))
bucket_rounds_kernel(int32_t* __restrict__ hot, int32_t* __restrict__ cold, int64_t C,
                     Source src, int32_t P, int32_t n, int32_t n_rounds, int64_t now,
                     void* __restrict__ out) {
  // The held lanes of the block's threads: [k][thread].
  constexpr int kHeld = kHeldLanes<Source, WIDE>;
  __shared__ int4 rows[kHeld][3][kThreads];  // hot words 0-3, 4-7, cold 0-3
  __shared__ int32_t slot[kHeld][kThreads], rid[kHeld][kThreads], flag[kHeld][kThreads];
  cg::grid_group grid = cg::this_grid();
  const BucketOut<WIDE> sink{out, P, now};
  const int tx = int(threadIdx.x);
  const int32_t T = int32_t(gridDim.x) * kThreads;
  const int32_t t = int32_t(blockIdx.x) * kThreads + tx;
  // Lane of the thread's k-th held lane, or -1; lanes from `excess` on
  // are not held.
  auto held = [&](int k) { return int64_t(t) + int64_t(k) * T < n ? t + k * T : -1; };
  const int64_t excess = int64_t(t) + int64_t(kHeld) * T;

#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    int32_t sl = -1, rd = -1;
    if (held(k) >= 0 && !lane_head(src, sink, held(k), P, n_rounds, sl, rd)) rd = -1;
    slot[k][tx] = sl;
    rid[k][tx] = rd;
  }
  for (int64_t i = excess; i < n; i += T) {
    int32_t sl, rd;
    lane_head(src, sink, int32_t(i), P, n_rounds, sl, rd);
  }

  for (int32_t r = 0; r < n_rounds; ++r) {
    // Read half: the round's lanes evaluate against the pre-round rows.
    // The held lanes' rows are all in flight before any is evaluated.
#pragma unroll 1
    for (int k = 0; k < kHeld; ++k) {
      if (rid[k][tx] != r) continue;
      int32_t s, p;
      split(held(k), P, s, p);
      src.prefetch(s, p);
      const int64_t row = table_row(C, s, slot[k][tx]);
      copy_async16(&rows[k][0][tx], reinterpret_cast<const int4*>(hot + row * 8));
      copy_async16(&rows[k][1][tx], reinterpret_cast<const int4*>(hot + row * 8 + 4));
      copy_async16(&rows[k][2][tx], reinterpret_cast<const int4*>(cold + row * 8));
    }
    copies_done();
#pragma unroll 1
    for (int k = 0; k < kHeld; ++k) {
      int32_t f = 0;
      if (rid[k][tx] == r) {
        int32_t s, p;
        split(held(k), P, s, p);
        Lane q;
        src.lane(s, p, now, q);
        Eval e;
        eval_words(rows[k][0][tx], rows[k][1][tx], rows[k][2][tx], q, now, e);
        sink.evaluated(s, p, q, e);
        f = write_flag(e, slot[k][tx], C);
        if (f) row_words(e, rows[k][0] + tx, rows[k][1] + tx, rows[k][2] + tx);
      }
      flag[k][tx] = f;
    }
    for (int64_t i = excess; i < n; i += T) {
      int32_t s, p, sl, rd;
      split(int32_t(i), P, s, p);
      src.head(s, p, sl, rd);
      if (rd != r || sl < 0) continue;
      Lane q;
      src.lane(s, p, now, q);
      Eval e;
      gather_eval(hot, cold, C, s, sl, q, now, e);
      sink.evaluated(s, p, q, e);
    }
    grid.sync();

    // Write half: the round's writers store their rows (write slots are
    // unique within a round).  A writer past the held lanes evaluates
    // again against its own slot's row, which no other lane of the round
    // writes.
#pragma unroll 1
    for (int k = 0; k < kHeld; ++k) {
      if (!flag[k][tx]) continue;
      int32_t s, p;
      split(held(k), P, s, p);
      store_rows(hot, cold, int64_t(s) * C + slot[k][tx], flag[k][tx], rows[k][0][tx],
                 rows[k][1][tx], rows[k][2][tx]);
    }
    for (int64_t i = excess; i < n; i += T) {
      int32_t s, p, sl, rd;
      split(int32_t(i), P, s, p);
      src.head(s, p, sl, rd);
      if (rd != r || sl < 0 || sl >= C) continue;
      Lane q;
      src.lane(s, p, now, q);
      if (!q.write) continue;
      Eval e;
      gather_eval(hot, cold, C, s, sl, q, now, e);
      const int32_t f = write_flag(e, sl, C);
      if (f) {
        int4 w0, w1, w2;
        row_words(e, &w0, &w1, &w2);
        store_rows(hot, cold, int64_t(s) * C + sl, f, w0, w1, w2);
      }
    }
    if (r + 1 < n_rounds) grid.sync();
  }
}

// Resident blocks of each instantiation on each device, asked once.
// Internal linkage: two builds of this library loaded in one process
// must not share it.
namespace {
std::atomic<int64_t> known_resident[4][16];
}

// Resident blocks of the kernel on the current device (SMs x blocks a
// SM).
template <class Source, bool WIDE>
int resident_blocks(int64_t& blocks) {
  constexpr int which = (Source::kDict ? 2 : 0) + (WIDE ? 1 : 0);
  int dev = 0;
  int rc = int(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  const bool cache = dev >= 0 && dev < 16;
  if (cache && (blocks = known_resident[which][dev].load()) > 0) return 0;
  int sms = 0, per_sm = 0;
  rc = int(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (rc == 0)
    rc = int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bucket_rounds_kernel<Source, WIDE>, kThreads, 0));
  blocks = int64_t(sms) * per_sm;
  if (rc == 0 && blocks < 1) rc = int(cudaErrorInvalidConfiguration);
  if (rc == 0 && cache) known_resident[which][dev].store(blocks);
  return rc;
}

template <class Source, bool WIDE>
int run_rounds(int32_t* hot, int32_t* cold, int64_t S, int64_t C, Source src, int64_t P,
               int32_t n_rounds, int64_t now, void* out, cudaStream_t stream) {
  auto kernel = bucket_rounds_kernel<Source, WIDE>;
  if (S * P > INT32_MAX) return int(cudaErrorInvalidValue);
  int32_t n = int32_t(S * P), P32 = int32_t(P);
  if (n == 0) return 0;
  int64_t resident = 0;
  const int rc = resident_blocks<Source, WIDE>(resident);
  if (rc != 0) return rc;
  const dim3 grid(unsigned(std::min(resident, (int64_t(n) + kThreads - 1) / kThreads)));
  // A grid that cannot be resident at once fails the launch
  // (cudaErrorCooperativeLaunchTooLarge); nothing falls back.
  void* args[] = {&hot, &cold, &C, &src, &P32, &n, &n_rounds, &now, &out};
  return int(cudaLaunchCooperativeKernel(kernel, grid, dim3(kThreads), args, 0, stream));
}

}  // namespace gt

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
    return gt::run_rounds<gt::DictSource<true>, true>(
        hot, cold, S, C, gt::DictSource<true>{wire, P, W}, P, n_rounds, now_ms, out, st);
  return gt::run_rounds<gt::DictSource<false>, false>(
      hot, cold, S, C, gt::DictSource<false>{wire, P, W}, P, n_rounds, now_ms, out, st);
}

// K2: per-lane-column batch.  lanes i32[S, 6, P]; values i32[S, 5, P]
// or (wide) i64[S, 5, P]; the rest as K1.
int gt_bucket_rounds_cols(int32_t* hot, int32_t* cold, int64_t S, int64_t C,
                          const int32_t* lanes, const void* values, int64_t P,
                          int32_t n_rounds, int64_t now_ms, int32_t wide, void* out,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide)
    return gt::run_rounds<gt::ColsSource<true>, true>(
        hot, cold, S, C, gt::ColsSource<true>{lanes, values, P}, P, n_rounds, now_ms, out,
        st);
  return gt::run_rounds<gt::ColsSource<false>, false>(
      hot, cold, S, C, gt::ColsSource<false>{lanes, values, P}, P, n_rounds, now_ms, out,
      st);
}

// The lanes one K1/K2 launch holds in shared memory on the current device:
// resident threads x kHeldLanes (`dict`, `wide` pick the kernel).  Returns
// the CUDA error of the occupancy query.
int gt_bucket_rounds_held_lanes(int32_t dict, int32_t wide, int64_t* lanes) {
  int64_t blocks = 0;
  int rc;
  if (dict)
    rc = wide ? gt::resident_blocks<gt::DictSource<true>, true>(blocks)
              : gt::resident_blocks<gt::DictSource<false>, false>(blocks);
  else
    rc = wide ? gt::resident_blocks<gt::ColsSource<true>, true>(blocks)
              : gt::resident_blocks<gt::ColsSource<false>, false>(blocks);
  const int held = dict ? (wide ? gt::kHeldLanes<gt::DictSource<true>, true>
                                 : gt::kHeldLanes<gt::DictSource<false>, false>)
                        : (wide ? gt::kHeldLanes<gt::ColsSource<true>, true>
                                : gt::kHeldLanes<gt::ColsSource<false>, false>);
  *lanes = blocks * gt::kThreads * held;
  return rc;
}

}  // extern "C"
