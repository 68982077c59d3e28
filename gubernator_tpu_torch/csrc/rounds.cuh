// The cooperative rounds kernel shared by the bucket-rounds kernels K1
// and K2 (bucket_rounds.cu), the GLOBAL answer rounds K3 (global_ops.cu)
// and the compact commit K10 (compact.cu): every round of one batch in
// one launch.
//
// Lanes interact only through their slot row: every lane of a round
// must read the PRE-round row, the round's single writer of a slot then
// stores its row, and round r+1 must see round r's writes.  One
// cooperative launch runs every round of the batch: as many blocks as
// can be resident at once (never more than the lanes need), each thread
// owning the flattened (shard, lane) indices t, t + T, t + 2T, ... of
// the T threads.  A round is a read half — the round's lanes gather
// their rows (a held lane's by cp.async into shared memory, all of a
// thread's in flight together; see below for K3), evaluate only the
// branch they take and
// write their output, and a writer keeps its new rows in shared memory —
// a grid barrier, and a write half in which the writers store those
// rows; a second barrier separates the round from the next.  A thread
// reads the slot and round id of its first kHeld lanes once, into shared
// memory (kHeld: 2, or 3 for K2 wide); lanes past kHeld * T (a batch
// larger than the resident threads
// hold) are read again each round, and their writers evaluate again in
// the write half against their own slot's row, which no other lane of
// the round writes, so no lane's rows pass through device memory before
// they are stored.  Row loads bypass L1 (cp.async.cg, ld.global.cg):
// another SM's stores before a barrier must be seen after it.
//
// The output goes through a Sink (bucket_rounds.cuh BucketOut for K1/K2,
// global_ops.cu AnswerOut for K3, compact.cu CompactOut for K10).  A
// Sink with kListed stores only the rows of the writers a list names:
// while the first round's rows are in flight its threads mark the
// listed lanes (`mark_listed`), and the write half asks `listed` of each
// writer, after the barrier that orders the marks before it.  A Sink
// with kFirstLook looks at each
// lane once, in the read half of the lane's own round, before the lane
// is evaluated (K3: the GLOBAL hit add and the replica answer); a lane
// it answers is neither evaluated nor a writer, and a lane it does not
// answer whose slot is < 0 gets the all-zero output.  The write half's
// second evaluation of a writer past the held lanes asks the Sink's
// side-effect-free `answered` instead, so the look never runs twice.
// Such a Sink's key (K3: the gslot) is read with a held lane's slot and
// round id, and its read half takes a held lane at a time: the lane's
// rows, request words and the Sink's words in flight together, then its
// evaluation: a lane's reads form a chain of two (its head and key,
// then everything else), which on the GLOBAL path's few-thousand-lane
// batches sets the time, not the bytes.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "bucket_rounds.cuh"

namespace gt {

namespace rounds_cg = cooperative_groups;

constexpr int kThreads = 256;
// Resident blocks of 256 threads a SM: 4 (at most 64 registers a
// thread) gives 32 warps and 135,168 threads on 132 SMs, one for each
// lane of the one-shard headline's 131,072.  The wide per-lane-column
// kernels (K2 wide, K3), whose lanes read five 64-bit values, spill at
// 64 registers and take 3 (80 registers, 24 warps).
template <class Source, class Sink>
constexpr int kMinBlocks = !Source::kDict && Sink::kWide ? 3 : 4;
// Lanes a thread holds across a round's barrier: two cover the main
// path's S * P = 262,144 lanes at 4 blocks a SM (270,336 held), three at
// 3 blocks (304,128); K3's, whose GLOBAL batches are some thousands of
// lanes, two (202,752).  A held lane keeps its slot, round id and write
// flag (12 bytes; K3 also its gslot) and its rows (48 bytes: the gathered
// rows, then the new ones) in its block's shared memory, 15 KB a block
// for each lane a thread holds; kept in registers, two lanes' rows
// spilled.
template <class Source, class Sink>
constexpr int kHeldLanes = kMinBlocks<Source, Sink> == 3 && !Sink::kFirstLook ? 3 : 2;

// Lane i of the flattened [S, P] batch: shard and lane within it.
__device__ __forceinline__ void split(int32_t i, int32_t P, int32_t& s, int32_t& p) {
  s = i / P;
  p = i - s * P;
}

// Reads a lane's slot and round id (and, with a first look, the key the
// Sink looks at, read beside them); writes the all-zero output of a lane
// no round runs (a round id outside [0, n_rounds), or slot < 0 for a Sink
// without a first look) and returns false for it.
template <class Source, class Sink>
__device__ __forceinline__ bool lane_head(const Source& src, const Sink& sink, int32_t i,
                                          int32_t P, int32_t n_rounds, int32_t& slot,
                                          int32_t& rid, int32_t& key) {
  int32_t s, p;
  split(i, P, s, p);
  src.head(s, p, slot, rid);
  if constexpr (Sink::kFirstLook) key = sink.key(s, p);
  if (rid >= 0 && rid < n_rounds && (Sink::kFirstLook || slot >= 0)) return true;
  sink.zero(s, p);
  return false;
}

// The first look at lane p of shard s, request q, in its round (Sinks
// with kFirstLook): true when the lane goes on to its bucket.
template <class Sink>
__device__ __forceinline__ bool look(const Sink& sink, int64_t s, int64_t p, int32_t slot,
                                     int32_t key, const Lane& q) {
  if (sink.first_look(s, p, key, q)) return false;
  if (slot >= 0) return true;
  sink.zero(s, p);
  return false;
}

template <class Source, class Sink>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<Source, Sink>))
bucket_rounds_kernel(int32_t* __restrict__ hot, int32_t* __restrict__ cold, int64_t C,
                     Source src, Sink sink_arg, int32_t P, int32_t n, int32_t n_rounds,
                     int64_t now) {
  static_assert(!(Sink::kFirstLook && Sink::kListed),
                "a Sink's list is marked in the read half of Sinks without a first look");
  // The Sink's lane count and time are set from the kernel's own 32-bit
  // P and now, so the compiler sees one value of each: copies it cannot
  // prove equal cost K1/K2 registers, and spills.
  Sink sink = sink_arg;
  sink.P = P;
  sink.now = now;
  // The held lanes of the block's threads: [k][thread].
  constexpr int kHeld = kHeldLanes<Source, Sink>;
  __shared__ int4 rows[kHeld][3][kThreads];  // hot words 0-3, 4-7, cold 0-3
  __shared__ int32_t slot[kHeld][kThreads], rid[kHeld][kThreads], flag[kHeld][kThreads];
  __shared__ int32_t key[Sink::kFirstLook ? kHeld : 1][kThreads];  // the Sink's, if any
  rounds_cg::grid_group grid = rounds_cg::this_grid();
  const int tx = int(threadIdx.x);
  const int32_t T = int32_t(gridDim.x) * kThreads;
  const int32_t t = int32_t(blockIdx.x) * kThreads + tx;
  // Lane of the thread's k-th held lane, or -1; lanes from `excess` on
  // are not held.
  auto held = [&](int k) { return int64_t(t) + int64_t(k) * T < n ? t + k * T : -1; };
  const int64_t excess = int64_t(t) + int64_t(kHeld) * T;

#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    int32_t sl = -1, rd = -1, ky = -1;
    if (held(k) >= 0 && !lane_head(src, sink, held(k), P, n_rounds, sl, rd, ky)) rd = -1;
    slot[k][tx] = sl;
    rid[k][tx] = rd;
    if constexpr (Sink::kFirstLook) key[k][tx] = ky;
  }
  for (int64_t i = excess; i < n; i += T) {
    int32_t sl, rd, ky;
    lane_head(src, sink, int32_t(i), P, n_rounds, sl, rd, ky);
  }

  for (int32_t r = 0; r < n_rounds; ++r) {
    // Read half: the round's lanes evaluate against the pre-round rows.
    if constexpr (Sink::kFirstLook) {
      // A lane at a time: its rows, its request and the Sink's words in
      // flight together, then its evaluation as soon as they are in.
#pragma unroll 1
      for (int k = 0; k < kHeld; ++k) {
        int32_t f = 0;
        if (rid[k][tx] == r) {
          int32_t s, p;
          split(held(k), P, s, p);
          const int32_t sl = slot[k][tx];
          if (sl >= 0) {
            const int64_t row = table_row(C, s, sl);
            copy_async16(&rows[k][0][tx], reinterpret_cast<const int4*>(hot + row * 8));
            copy_async16(&rows[k][1][tx], reinterpret_cast<const int4*>(hot + row * 8 + 4));
            copy_async16(&rows[k][2][tx], reinterpret_cast<const int4*>(cold + row * 8));
          }
          Lane q;
          src.lane(s, p, now, q);
          if (look(sink, s, p, sl, key[k][tx], q)) {
            copies_done();
            Eval e;
            eval_words(rows[k][0][tx], rows[k][1][tx], rows[k][2][tx], q, now, e);
            sink.evaluated(s, p, q, e);
            f = write_flag(e, sl, C);
            if (f) row_words(e, rows[k][0] + tx, rows[k][1] + tx, rows[k][2] + tx);
          }
        }
        flag[k][tx] = f;
      }
      copies_done();  // those of answered lanes, never read
    } else {
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
      // The list's marks go out while the rows are in flight, before the
      // barrier that orders them before the write half.
      if constexpr (Sink::kListed) {
        if (r == 0) sink.mark_listed(t, T, n);
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
    }
    for (int64_t i = excess; i < n; i += T) {
      int32_t s, p, sl, rd;
      split(int32_t(i), P, s, p);
      src.head(s, p, sl, rd);
      if (rd != r) continue;
      Lane q;
      if constexpr (Sink::kFirstLook) {
        src.lane(s, p, now, q);
        if (!look(sink, s, p, sl, sink.key(s, p), q)) continue;
      } else {
        if (sl < 0) continue;
        src.lane(s, p, now, q);
      }
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
      if constexpr (Sink::kListed) {
        if (!sink.listed(s, p)) continue;
      }
      store_rows(hot, cold, int64_t(s) * C + slot[k][tx], flag[k][tx], rows[k][0][tx],
                 rows[k][1][tx], rows[k][2][tx]);
    }
    for (int64_t i = excess; i < n; i += T) {
      int32_t s, p, sl, rd;
      split(int32_t(i), P, s, p);
      src.head(s, p, sl, rd);
      if (rd != r || sl < 0 || sl >= C) continue;
      if constexpr (Sink::kListed) {
        if (!sink.listed(s, p)) continue;
      }
      Lane q;
      src.lane(s, p, now, q);
      if (!q.write) continue;
      if constexpr (Sink::kFirstLook) {
        if (sink.answered(s, p)) continue;
      }
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
std::atomic<int64_t> known_resident[7][16];
}

// Resident blocks of the kernel on the current device (SMs x blocks a
// SM).
template <class Source, class Sink>
int resident_blocks(int64_t& blocks) {
  constexpr int which = Sink::kFirstLook ? 4
                       : Sink::kListed   ? 5 + (Source::kDict ? 1 : 0)
                                         : (Source::kDict ? 2 : 0) + (Sink::kWide ? 1 : 0);
  int dev = 0;
  int rc = int(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  const bool cache = dev >= 0 && dev < 16;
  if (cache && (blocks = known_resident[which][dev].load()) > 0) return 0;
  int sms = 0, per_sm = 0;
  rc = int(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (rc == 0)
    rc = int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bucket_rounds_kernel<Source, Sink>, kThreads, 0));
  blocks = int64_t(sms) * per_sm;
  if (rc == 0 && blocks < 1) rc = int(cudaErrorInvalidConfiguration);
  if (rc == 0 && cache) known_resident[which][dev].store(blocks);
  return rc;
}

// Blocks of the launch for n lanes and the lanes it holds across its
// barriers (resident threads x kHeldLanes) on the current device.
template <class Source, class Sink>
int launch_shape(int64_t n, int64_t& blocks, int64_t& held) {
  int64_t resident = 0;
  const int rc = resident_blocks<Source, Sink>(resident);
  blocks = std::min(resident, (n + kThreads - 1) / kThreads);
  held = resident * kThreads * kHeldLanes<Source, Sink>;
  return rc;
}

// Every round of one [S, P] batch as one cooperative launch on `stream`;
// returns its CUDA error.
template <class Source, class Sink>
int run_rounds(int32_t* hot, int32_t* cold, int64_t S, int64_t C, Source src, Sink sink,
               int32_t n_rounds, cudaStream_t stream) {
  auto kernel = bucket_rounds_kernel<Source, Sink>;
  if (S * sink.P > INT32_MAX) return int(cudaErrorInvalidValue);
  int32_t n = int32_t(S * sink.P), P32 = int32_t(sink.P);
  int64_t now = sink.now;
  if (n == 0) return 0;
  int64_t blocks = 0, held = 0;
  const int rc = launch_shape<Source, Sink>(n, blocks, held);
  if (rc != 0) return rc;
  // A grid that cannot be resident at once fails the launch
  // (cudaErrorCooperativeLaunchTooLarge); nothing falls back.
  void* args[] = {&hot, &cold, &C, &src, &sink, &P32, &n, &n_rounds, &now};
  return int(cudaLaunchCooperativeKernel(kernel, dim3(unsigned(blocks)), dim3(kThreads), args,
                                         0, stream));
}

}  // namespace gt
