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
// the new row depends on the schedule.  So the window runs as two
// launches on one stream: the first gathers every live record's source
// row pair into a staging buffer (64 bytes per record), the second
// writes the staged rows to their destinations.  Stream order is the
// barrier between them, so the result is the same bytes for the records
// in any order.  The staging costs one extra write and read of 64 bytes
// per record, and the second launch's fixed cost; a one-launch design
// would need the host to prove that no destination is a source, which a
// churning window does not give.
//
// Each launch runs four threads per record, each moving one 16-byte
// quarter (two of the hot row, two of the cold): neighbouring threads
// touch neighbouring bytes of a row, and the loads are 16-byte vectors.
// Records are flat (op = shard << 2 | kind, src, dst) over all shards:
// one device holds every shard, so there is no per-shard padding.  A
// record whose kind, shard, source or destination is out of range (the
// host's cancelled records carry src -1) does nothing.  Destinations
// are distinct within a window (the host's cancel_pending_demo), so no
// two threads write one row.

#include <cuda_runtime.h>

#include <cstdint>

namespace gt {

constexpr int kMoveThreads = 256;
constexpr int kPromoteBack = 0, kPromoteFront = 1, kDemote = 2;

struct MoveTables {
  int32_t* hot;  // front, [S, C, 8]
  int32_t* cold;
  int32_t* back_hot;  // back, [S, Cb, 8]
  int32_t* back_cold;
  int64_t S, C, Cb;
};

// Record i's source and destination as int32 word offsets of the
// quarter `part` (0, 1: hot; 2, 3: cold) in their tables, and the tables
// themselves; false when the record is not live.
__device__ __forceinline__ bool move_quarter(const MoveTables& t, const int32_t* rec,
                                             int64_t N, int64_t i, int part,
                                             const int32_t** src_p, int32_t** dst_p) {
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
  *src_p = src_table + (shard * src_cap + src) * 8 + word;
  *dst_p = dst_table + (shard * dst_cap + dst) * 8 + word;
  return true;
}

// Launch 1: every live record's source row pair into stage[i] (16
// int32 words: hot row, then cold row).
__global__ void __launch_bounds__(kMoveThreads)
moves_gather_kernel(MoveTables t, const int32_t* __restrict__ rec, int64_t N,
                    int32_t* __restrict__ stage) {
  const int64_t q = int64_t(blockIdx.x) * kMoveThreads + threadIdx.x;
  if (q >= 4 * N) return;
  const int64_t i = q >> 2;
  const int part = int(q & 3);
  const int32_t* src;
  int32_t* dst;
  if (!move_quarter(t, rec, N, i, part, &src, &dst)) return;
  reinterpret_cast<int4*>(stage + i * 16)[part] = *reinterpret_cast<const int4*>(src);
}

// Launch 2: the staged row pairs to their destinations.
__global__ void __launch_bounds__(kMoveThreads)
moves_scatter_kernel(MoveTables t, const int32_t* __restrict__ rec, int64_t N,
                     const int32_t* __restrict__ stage) {
  const int64_t q = int64_t(blockIdx.x) * kMoveThreads + threadIdx.x;
  if (q >= 4 * N) return;
  const int64_t i = q >> 2;
  const int part = int(q & 3);
  const int32_t* src;
  int32_t* dst;
  if (!move_quarter(t, rec, N, i, part, &src, &dst)) return;
  *reinterpret_cast<int4*>(dst) = reinterpret_cast<const int4*>(stage + i * 16)[part];
}

inline unsigned move_blocks(int64_t n) {
  return unsigned((4 * n + kMoveThreads - 1) / kMoveThreads);
}

}  // namespace gt

extern "C" {

// K9: front hot/cold i32[S, C, 8] and back hot/cold i32[S, Cb, 8], in
// place, from records i32[3, N] (op = shard << 2 | kind, src, dst);
// stage i32[N, 16] is scratch.  Two launches on `stream`.  Returns
// cudaGetLastError() of the first launch that failed, else 0.
int gt_apply_moves(int32_t* hot, int32_t* cold, int64_t S, int64_t C, int32_t* back_hot,
                   int32_t* back_cold, int64_t Cb, const int32_t* records, int64_t N,
                   int32_t* stage, void* stream) {
  if (N == 0) return 0;
  const gt::MoveTables t{hot, cold, back_hot, back_cold, S, C, Cb};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gt::moves_gather_kernel<<<gt::move_blocks(N), gt::kMoveThreads, 0, st>>>(t, records, N,
                                                                          stage);
  int rc = int(cudaGetLastError());
  if (rc != 0) return rc;
  gt::moves_scatter_kernel<<<gt::move_blocks(N), gt::kMoveThreads, 0, st>>>(t, records, N,
                                                                           stage);
  return int(cudaGetLastError());
}

}  // extern "C"
