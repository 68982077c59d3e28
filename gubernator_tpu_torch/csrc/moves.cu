// Tier moves of the two-tier bucket table, on Hopper (sm_90a).
//
// Replaces the JAX package's move program:
//   * gt_apply_moves (K9) — parallel/mesh.py::_moves_mesh_jit, i.e.
//     ops/buckets.py apply_moves vmapped over the shards: one drain
//     window of host-planned records, each copying a whole row pair (hot
//     and cold, 2 x 32 bytes) — a demotion front[src] -> back[dst], a
//     promotion back[src] -> front[dst] (kind 0) or front[src] ->
//     front[dst] (kind 1, a row demoted and promoted again inside the
//     window, which never reached the back table).
//
// What bounds it on this card: memory.  Per live record it reads 12
// bytes of record words and a 64-byte row pair and writes the row pair;
// there is no arithmetic.  The rows are scattered over tables far larger
// than L2, so each 32-byte row is its own sector.
//
// Design.  JAX evaluates every gather on the input tables before any
// scatter, and the host relies on it: within one window a front slot can
// be both a demotion's source and a promotion's destination (the slot
// was evicted, then given to a promoted key), and a kind-1 promotion
// reads a front slot that another record may overwrite.  One pass with a
// thread per record would race there: whether a thread reads the old or
// the new row depends on the schedule.  So the window is one cooperative
// launch with a grid barrier between its reads and its writes: every
// thread copies its quarters of the window into shared memory, the grid
// meets at the barrier, then every thread stores them.  The result is
// the same bytes for the records in any order, with no staging buffer
// and one launch's fixed cost; a design without the barrier would need
// the host to prove that no destination is a source, which a churning
// window does not give.
//
// A record is four 16-byte quarters (two of its hot row, two of its
// cold row); quarter q of the flat window is record q / 4's quarter
// q % 4, so neighbouring threads touch neighbouring bytes of a row and a
// warp's 16-byte loads and stores cover whole 32-byte sectors.  Of the T
// resident threads, thread t holds quarters t, t + T, t + 2T and t + 3T
// across the barrier in its block's shared memory, where cp.async puts
// them without passing through registers (in registers the 16 words
// spill at the 32 registers a thread has when the grid fills the card).
// At 4 blocks of 512 threads a SM (32 KB of shared memory each) a launch
// holds 1,081,344 quarters, the two-tier path's full window of ~250,000
// records with room; a thread decodes a quarter's record again after the
// barrier rather than keep its address live.  Only quarters past 4T go
// through device memory: gathered into `spill` before the barrier and
// stored after it by the same thread, so a window of any size still
// gives the same bytes.  The row loads need no L1 bypass: nothing is
// written before the barrier, and a thread reads back only its own spill
// words (cp.async.cg, which bypasses L1, is the 16-byte copy into shared
// memory).  512-thread blocks halve the blocks that meet at the barrier.
// A grid that cannot be resident fails the launch; nothing falls back.
//
// Records are flat (op = shard << 2 | kind, src, dst) over all shards:
// one device holds every shard, so there is no per-shard padding.  A
// record whose kind, shard, source or destination is out of range (the
// host's cancelled records carry src -1) does nothing.  Destinations
// are distinct within a window (the host's cancel_pending_demo), so no
// two threads write one row.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "bucket_rounds.cuh"  // copy_async16, copies_done

namespace cg = cooperative_groups;

namespace gt {

constexpr int kMoveThreads = 512;
constexpr int kHeldQuarters = 4;  // a thread's, in shared memory
constexpr int kPromoteBack = 0, kPromoteFront = 1, kDemote = 2;

struct MoveTables {
  int32_t* hot;  // front, [S, C, 8]
  int32_t* cold;
  int32_t* back_hot;  // back, [S, Cb, 8]
  int32_t* back_cold;
  int64_t S, C, Cb;
};

// Quarter `part` (0, 1: hot row; 2, 3: cold row) of record i: its
// source and destination words; false when the record is not live.
__device__ __forceinline__ bool move_quarter(const MoveTables& t, const int32_t* rec,
                                             int64_t N, int64_t i, int part,
                                             const int4** src_p, int4** dst_p) {
  const int32_t op = rec[i], src = rec[N + i], dst = rec[2 * N + i];
  const int64_t shard = op >> 2;
  const int kind = op & 3;
  const int64_t src_cap = kind == kPromoteBack ? t.Cb : t.C;
  const int64_t dst_cap = kind == kDemote ? t.Cb : t.C;
  if (kind > kDemote || shard < 0 || shard >= t.S || src < 0 || src >= src_cap ||
      dst < 0 || dst >= dst_cap)
    return false;
  const bool cold = part >= 2;
  const int64_t word = (part & 1) * 4;
  const int32_t* src_table = kind == kPromoteBack ? (cold ? t.back_cold : t.back_hot)
                                                  : (cold ? t.cold : t.hot);
  int32_t* dst_table = kind == kDemote ? (cold ? t.back_cold : t.back_hot)
                                       : (cold ? t.cold : t.hot);
  *src_p = reinterpret_cast<const int4*>(src_table + (shard * src_cap + src) * 8 + word);
  *dst_p = reinterpret_cast<int4*>(dst_table + (shard * dst_cap + dst) * 8 + word);
  return true;
}

// The window: the thread's held quarters into its block's shared memory
// (cp.async, all in flight together), quarters past 4T into spill
// (int4[4N - 4T]), the grid barrier, then the stores.
__global__ void __launch_bounds__(kMoveThreads, 4)
moves_kernel(MoveTables t, const int32_t* __restrict__ rec, int64_t N,
             int4* __restrict__ spill) {
  __shared__ int4 held[kHeldQuarters][kMoveThreads];  // 32 KB a block
  cg::grid_group grid = cg::this_grid();
  const int tx = int(threadIdx.x);
  const int64_t T = int64_t(gridDim.x) * kMoveThreads;
  const int64_t t0 = int64_t(blockIdx.x) * kMoveThreads + tx;
  const int64_t Q = 4 * N, excess = kHeldQuarters * T;
  const int4* src;
  int4* dst;
#pragma unroll
  for (int h = 0; h < kHeldQuarters; ++h) {
    const int64_t q = t0 + h * T;
    if (q < Q && move_quarter(t, rec, N, q >> 2, int(q & 3), &src, &dst))
      copy_async16(&held[h][tx], src);
  }
  for (int64_t q = excess + t0; q < Q; q += T)
    if (move_quarter(t, rec, N, q >> 2, int(q & 3), &src, &dst)) spill[q - excess] = *src;
  copies_done();
  grid.sync();
#pragma unroll
  for (int h = 0; h < kHeldQuarters; ++h) {
    const int64_t q = t0 + h * T;
    if (q < Q && move_quarter(t, rec, N, q >> 2, int(q & 3), &src, &dst)) *dst = held[h][tx];
  }
  for (int64_t q = excess + t0; q < Q; q += T)
    if (move_quarter(t, rec, N, q >> 2, int(q & 3), &src, &dst)) *dst = spill[q - excess];
}

// Resident blocks of moves_kernel on each device, asked once (internal
// linkage: two builds of this library in one process must not share it).
namespace {
std::atomic<int64_t> known_move_blocks[16];
}

// The launch for a window of N records on the current device: its
// blocks and the quarters past what it holds in shared memory (the
// spill words it needs).
int moves_shape(int64_t N, int64_t& blocks, int64_t& spill) {
  int dev = 0;
  int rc = int(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  const bool cache = dev >= 0 && dev < 16;
  int64_t resident = cache ? known_move_blocks[dev].load() : 0;
  if (resident < 1) {
    int sms = 0, per_sm = 0;
    rc = int(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    if (rc == 0)
      rc = int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, moves_kernel,
                                                             kMoveThreads, 0));
    resident = int64_t(sms) * per_sm;
    if (rc == 0 && resident < 1) rc = int(cudaErrorInvalidConfiguration);
    if (rc != 0) return rc;
    if (cache) known_move_blocks[dev].store(resident);
  }
  blocks = std::min(resident, (4 * N + kMoveThreads - 1) / kMoveThreads);
  spill = std::max<int64_t>(0, 4 * N - kHeldQuarters * kMoveThreads * blocks);
  return 0;
}

}  // namespace gt

extern "C" {

// K9: front hot/cold i32[S, C, 8] and back hot/cold i32[S, Cb, 8], in
// place, from records i32[3, N] (op = shard << 2 | kind, src, dst);
// spill i32[n_spill, 4] holds the 16-byte quarters past what the launch
// keeps in shared memory (gt_apply_moves_spill says how many; null when
// 0).  One cooperative launch on `stream`; returns its CUDA error
// (cudaErrorInvalidValue, and no launch, when spill is too short).
int gt_apply_moves(int32_t* hot, int32_t* cold, int64_t S, int64_t C, int32_t* back_hot,
                   int32_t* back_cold, int64_t Cb, const int32_t* records, int64_t N,
                   void* spill, int64_t n_spill, void* stream) {
  if (N == 0) return 0;
  int64_t blocks = 0, need = 0;
  const int rc = gt::moves_shape(N, blocks, need);
  if (rc != 0) return rc;
  if (n_spill < need) return int(cudaErrorInvalidValue);
  gt::MoveTables t{hot, cold, back_hot, back_cold, S, C, Cb};
  int4* sp = static_cast<int4*>(spill);
  void* args[] = {&t, &records, &N, &sp};
  return int(cudaLaunchCooperativeKernel(gt::moves_kernel, dim3(unsigned(blocks)),
                                         dim3(gt::kMoveThreads), args, 0,
                                         static_cast<cudaStream_t>(stream)));
}

// The 16-byte quarters of a window of N records that spill on the
// current device (0 while the launch holds every quarter in shared
// memory).  Returns the CUDA error of the occupancy query.
int gt_apply_moves_spill(int64_t N, int64_t* quarters) {
  int64_t blocks = 0;
  *quarters = 0;
  return N > 0 ? gt::moves_shape(N, blocks, *quarters) : 0;
}

}  // extern "C"
