// GLOBAL-plane kernels: replica answers, the owner sync and replica
// commits, on Hopper (sm_90a).
//
// Replaces the JAX package's GLOBAL device programs:
//   * gt_global_answer_rounds (K3) — parallel/mesh.py::_answer_rounds_jit
//     (and _answer_jit, its one-round case), i.e. ops/global_ops.py
//     answer_batch vmapped over S inside a loop over rounds: lanes whose
//     replica entry is live answer from the rep_* columns, the others run
//     the bucket evaluation, and every GLOBAL lane adds its hits to ghits.
//   * gt_global_sync (K4) — parallel/mesh.py::_get_sync_fn, i.e.
//     ops/global_ops.py global_sync under shard_map: the psum of ghits,
//     the owner's apply of the summed hits, the psum broadcast of the
//     owner's answer into every shard's replica columns, and the packed
//     i64[S, 8, G] result.  On one device the shard axis is a tensor
//     dimension, so each psum is a loop over S inside one thread.
//   * gt_set_replica (K5) — parallel/mesh.py::_set_replica_jit, i.e.
//     ops/global_ops.py set_replica vmapped over S.
//   * gt_clear_gslots (K6) — parallel/mesh.py::_clear_jit, i.e.
//     ops/global_ops.py clear_gslots vmapped over S.
//
// What bounds them on this card: memory.  K3 is K2 (bucket_rounds.cu)
// plus, per lane, a gslot word, one 8-byte rep_expire read, the rep_*
// reads of a cached lane and an 8-byte atomic add — on the GLOBAL path's
// 2,048-lane batches well under a microsecond of bytes, so what it pays
// is its launch, its grid barriers and each lane's chain of dependent
// reads (round id and gslot, then replica words or rows, then the
// evaluation); K4 reads ghits and
// the replica columns of every shard once, writes them once, and writes
// 64 bytes of packed result per (shard, gslot); K5 and K6 scatter a few
// words per gslot into every shard, where what they pay is their launch
// and, per store, the dependent read of its index.  A lane that reaches
// its bucket runs
// the evaluation of bucket_rounds.cuh, several hundred instructions
// (see bucket_rounds.cu).
//
// Design.
//   * K3 is one cooperative launch for every round of the batch: the
//     rounds kernel of rounds.cuh (K2's, with its grid barriers between
//     a round's reads and its writers' stores and between rounds, held
//     lanes in shared memory and no staging) fed by the wide per-lane
//     columns and the AnswerOut sink.  The sink's first look runs once
//     per lane, in the read half of the lane's round: it adds a GLOBAL
//     lane's hits to ghits and answers a lane whose replica entry is
//     live from the rep_* columns, so that lane is not evaluated and
//     writes no row.  To keep each lane's chain of dependent reads short,
//     a held lane's gslot is read with its slot and round id when the
//     launch starts, and in its round its rows (cp.async), its request
//     words and its replica words are in flight together, the lane
//     evaluated as soon as they are in (the K1/K2 sink instead puts all
//     of a thread's held lanes' rows in flight first).  The replica
//     columns do not change inside the launch, so
//     whether a lane was answered (`answered`, which the write half asks
//     for writers past the held lanes) does not depend on when it is
//     asked.  Hits go into ghits with a 64-bit atomicAdd on the two's-
//     complement bits: integer addition commutes, so duplicate gslots
//     and negative hits give the JAX program's bits in any order.  A
//     grid that cannot be resident fails the launch; nothing falls back.
//   * K4 is one launch, one thread per gslot.  Each gslot has one owner
//     shard and its key one slot there, so the owner row a thread reads
//     and writes belongs to no other thread; the thread sums ghits over
//     the shards, evaluates the owner lane, commits its row, and writes
//     the broadcast and the packed result of every shard.  Masked lanes
//     (non-owner shards, inactive gslots) are not evaluated: the JAX
//     program's outputs for a lane with slot -1 are zeros, written here
//     directly.
//   * K5 is one thread per updated gslot, which writes its five words in
//     every shard.
//   * K6 is one plain launch of a thread per (column, shard, entry) of
//     the clear list: the entry is the fastest index (grid x), the shard
//     and the column are grid y and z, so a thread makes one index load
//     (shared through L1/L2 with the 6 S threads of the same entry) and
//     one store, and the stores of a clear spread over every SM (a
//     1,024-entry clear at S = 8 is 192 blocks).  The stores hand the
//     list over sorted, so a warp writes consecutive words of one column
//     of one shard wherever the gslots are adjacent, and clear a batch's
//     recycled gslots with one launch (parallel/mesh.py `_clear_gslots`).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "bucket_rounds.cuh"
#include "rounds.cuh"

namespace gt {

constexpr int kGThreads = 256;

// Replica columns of every shard, [S, G] each.
struct GCols {
  int32_t* rep_status;
  int64_t* rep_limit;
  int64_t* rep_remaining;
  int64_t* rep_reset;
  int64_t* rep_expire;
  int64_t* ghits;
  int64_t G;
};

// Output of K3: out i64[S, 5, P] = status | removed << 1 | cached << 2,
// limit, remaining, reset_time, new_expire.  Its first look at a lane
// adds a GLOBAL lane's hits to ghits and answers a lane whose replica
// entry is live from the rep_* columns, which keeps it off the bucket.
struct AnswerOut {
  int64_t* out;
  const int32_t* gslot;
  GCols gc;
  int64_t P, now;
  static constexpr bool kFirstLook = true;
  static constexpr bool kListed = false;  // every writer stores
  static constexpr bool kWide = true;     // i64 values and output

  __device__ void put(int64_t s, int64_t p, int64_t row0, int64_t limit, int64_t rem,
                      int64_t reset, int64_t nexp) const {
    int64_t* o = out + s * 5 * P + p;
    o[0] = row0;
    o[P] = limit;
    o[2 * P] = rem;
    o[3 * P] = reset;
    o[4 * P] = nexp;
  }

  // The lane's gslot: what the first look reads first.
  __device__ int32_t key(int64_t s, int64_t p) const { return gslot[s * P + p]; }

  // The lane's replica entry in the [S, G] columns (an out-of-range
  // gslot reads the last, as JAX's clamped gather), or -1 for a lane
  // that is not GLOBAL.
  __device__ int64_t entry(int64_t s, int64_t gs) const {
    return gs < 0 ? -1 : s * gc.G + (gs < gc.G ? gs : gc.G - 1);
  }

  // Adds the hits of lane p of shard s, request q, with gslot `gs`
  // (out-of-range gslots drop theirs, as JAX's mode="drop") and answers
  // it when its replica entry is live.  A lane that is not GLOBAL reads
  // nothing; the replica words of a GLOBAL lane are read at once, before
  // the test.
  __device__ bool first_look(int64_t s, int64_t p, int64_t gs, const Lane& q) const {
    const int64_t g = entry(s, gs);
    if (g < 0) return false;
    const int64_t expire = gc.rep_expire[g], limit = gc.rep_limit[g];
    const int64_t remaining = gc.rep_remaining[g], reset = gc.rep_reset[g];
    const int32_t status = gc.rep_status[g];
    if (gs < gc.G)
      atomicAdd(reinterpret_cast<unsigned long long*>(gc.ghits + s * gc.G + gs),
                static_cast<unsigned long long>(q.hits));
    if (expire < now) return false;
    put(s, p, int64_t(status) | 4, limit, remaining, reset, 0);
    return true;
  }

  // Whether first_look answered the lane, without its side effects.
  __device__ bool answered(int64_t s, int64_t p) const {
    const int64_t g = entry(s, key(s, p));
    return g >= 0 && gc.rep_expire[g] >= now;
  }

  __device__ void zero(int64_t s, int64_t p) const { put(s, p, 0, 0, 0, 0, 0); }

  // The response's limit of an evaluated lane is the request's own.
  __device__ void evaluated(int64_t s, int64_t p, const Lane& q, const Eval& e) const {
    put(s, p, e.row0, q.limit, e.remaining, e.reset_time, e.new_expire);
  }
};

// K4, one thread per gslot.  cfg i64[8, G] = owner_slot, owner_shard,
// algorithm, behavior, limit, duration, greg_expire, greg_duration;
// dirty u8[S, G]; out i64[S, 8, G].
__global__ void __launch_bounds__(kGThreads)
sync_kernel(int32_t* __restrict__ hot, int32_t* __restrict__ cold, int64_t S,
            int64_t C, GCols gc, const int64_t* __restrict__ cfg,
            const uint8_t* __restrict__ dirty, int64_t now,
            int64_t* __restrict__ out) {
  const int64_t G = gc.G;
  const int64_t g = int64_t(blockIdx.x) * kGThreads + threadIdx.x;
  if (g >= G) return;
  uint64_t total_u = 0;  // psum(ghits): two's-complement sum, as int64 wraps
  for (int64_t s = 0; s < S; ++s) total_u += uint64_t(gc.ghits[s * G + g]);
  const int64_t total = int64_t(total_u);
  const int64_t owner_slot = cfg[g];
  const int64_t owner = cfg[G + g];
  const bool owned = owner >= 0 && owner < S;
  const bool any_dirty = owned && dirty[owner * G + g] != 0;
  const bool apply = owned && (total > 0 || any_dirty) && owner_slot >= 0;

  int64_t b_status = 0, b_limit = 0, b_rem = 0, b_reset = 0, removed = 0, nexp = 0;
  if (apply) {
    Lane q;
    q.algo = int32_t(cfg[2 * G + g]);
    q.behavior = int32_t(cfg[3 * G + g]);
    q.hits = total;
    q.limit = cfg[4 * G + g];
    q.duration = cfg[5 * G + g];
    q.greg_expire = cfg[6 * G + g];
    q.greg_duration = cfg[7 * G + g];
    q.occ = 0;
    q.exists = true;  // the kernel re-validates expiry
    q.write = true;
    Eval e;
    gather_eval(hot, cold, C, owner, owner_slot, q, now, e);
    b_status = e.row0 & 1;
    removed = (e.row0 >> 1) & 1;
    b_limit = q.limit;
    b_rem = e.remaining;
    b_reset = e.reset_time;
    nexp = e.new_expire;
    const int32_t flag = write_flag(e, owner_slot, C);
    if (flag) {
      int4 w0, w1, w2;
      row_words(e, &w0, &w1, &w2);
      store_rows(hot, cold, owner * C + owner_slot, flag, w0, w1, w2);
    }
  }
  for (int64_t s = 0; s < S; ++s) {
    const int64_t i = s * G + g;
    int64_t rs, rl, rr, rt, re;
    if (apply) {
      rs = int64_t(int32_t(b_status));
      rl = b_limit;
      rr = b_rem;
      rt = b_reset;
      re = b_reset;  // a replica entry expires at ResetTime
      gc.rep_status[i] = int32_t(rs);
      gc.rep_limit[i] = rl;
      gc.rep_remaining[i] = rr;
      gc.rep_reset[i] = rt;
      gc.rep_expire[i] = re;
    } else {
      rs = gc.rep_status[i];
      rl = gc.rep_limit[i];
      rr = gc.rep_remaining[i];
      rt = gc.rep_reset[i];
      re = gc.rep_expire[i];
    }
    gc.ghits[i] = 0;
    const bool mine = apply && s == owner;
    int64_t* o = out + s * 8 * G + g;
    o[0] = (mine ? removed : 0) | (apply ? 2 : 0);
    o[G] = mine ? nexp : 0;
    o[2 * G] = total;
    o[3 * G] = rs;
    o[4 * G] = rl;
    o[5 * G] = rr;
    o[6 * G] = rt;
    o[7 * G] = re;
  }
}

// K5: upd i64[5, M] = gslot, status, limit, remaining, reset.  Valid
// gslots are unique (the host dedups); out-of-range ones are dropped.
__global__ void __launch_bounds__(kGThreads)
set_replica_kernel(GCols gc, int64_t S, const int64_t* __restrict__ upd, int64_t M) {
  const int64_t m = int64_t(blockIdx.x) * kGThreads + threadIdx.x;
  if (m >= M) return;
  const int64_t g = upd[m];
  if (g < 0 || g >= gc.G) return;
  const int32_t status = int32_t(upd[M + m]);
  const int64_t limit = upd[2 * M + m], rem = upd[3 * M + m], reset = upd[4 * M + m];
  for (int64_t s = 0; s < S; ++s) {
    const int64_t i = s * gc.G + g;
    gc.rep_status[i] = status;
    gc.rep_limit[i] = limit;
    gc.rep_remaining[i] = rem;
    gc.rep_reset[i] = reset;
    gc.rep_expire[i] = reset;
  }
}

// K6: zero the six columns at idx i64[K] (>= 0; >= G is padding,
// dropped): entry k of the list (grid x), shard blockIdx.y, column
// blockIdx.z (0 rep_status, 1-5 the i64 columns in GCols order).
__global__ void __launch_bounds__(kGThreads)
clear_kernel(GCols gc, const int64_t* __restrict__ idx, int32_t K) {
  const int32_t k = int32_t(blockIdx.x * blockDim.x + threadIdx.x);
  if (k >= K) return;
  const uint64_t g = uint64_t(idx[k]);
  if (g >= uint64_t(gc.G)) return;
  const int64_t i = int64_t(blockIdx.y) * gc.G + int64_t(g);
  switch (blockIdx.z) {
    case 0: gc.rep_status[i] = 0; break;
    case 1: gc.rep_limit[i] = 0; break;
    case 2: gc.rep_remaining[i] = 0; break;
    case 3: gc.rep_reset[i] = 0; break;
    case 4: gc.rep_expire[i] = 0; break;
    default: gc.ghits[i] = 0;
  }
}

inline unsigned blocks(int64_t n) { return unsigned((n + kGThreads - 1) / kGThreads); }

}  // namespace gt

extern "C" {

// K3: all rounds of one dataclass-path batch.  hot/cold i32[S, C, 8] and
// the replica columns (rep_status i32[S, G], the rest i64[S, G]) are
// updated in place; lanes i32[S, 6, P] (slot, exists | write << 1,
// algorithm, behavior, occ, round_id), values i64[S, 5, P] (hits, limit,
// duration, greg_expire, greg_duration), gslot i32[S, P], out
// i64[S, 5, P].  One cooperative launch on `stream`; returns its CUDA
// error.
int gt_global_answer_rounds(int32_t* hot, int32_t* cold, int64_t S, int64_t C,
                            const int32_t* lanes, const int64_t* values,
                            const int32_t* gslot, int64_t P, int32_t* rep_status,
                            int64_t* rep_limit, int64_t* rep_remaining,
                            int64_t* rep_reset, int64_t* rep_expire, int64_t* ghits,
                            int64_t G, int32_t n_rounds, int64_t now_ms, int64_t* out,
                            void* stream) {
  const gt::GCols gc{rep_status, rep_limit, rep_remaining, rep_reset, rep_expire, ghits, G};
  return gt::run_rounds(hot, cold, S, C, gt::ColsSource<true>{lanes, values, P},
                        gt::AnswerOut{out, gslot, gc, P, now_ms}, n_rounds,
                        static_cast<cudaStream_t>(stream));
}

// K3's launch for n lanes on the current device: its blocks (of 256
// threads) and the lanes it holds across its barriers.  Returns the CUDA
// error of the occupancy query.
int gt_global_answer_launch_shape(int64_t n, int64_t* blocks, int64_t* held) {
  return gt::launch_shape<gt::ColsSource<true>, gt::AnswerOut>(n, *blocks, *held);
}

// K4: one GLOBAL sync.  cfg i64[8, G], dirty u8[S, G], out i64[S, 8, G];
// state and replica columns in place.
int gt_global_sync(int32_t* hot, int32_t* cold, int64_t S, int64_t C,
                   int32_t* rep_status, int64_t* rep_limit, int64_t* rep_remaining,
                   int64_t* rep_reset, int64_t* rep_expire, int64_t* ghits,
                   int64_t G, const int64_t* cfg, const uint8_t* dirty,
                   int64_t now_ms, int64_t* out, void* stream) {
  if (G == 0) return 0;
  const gt::GCols gc{rep_status, rep_limit, rep_remaining, rep_reset, rep_expire, ghits, G};
  gt::sync_kernel<<<gt::blocks(G), gt::kGThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hot, cold, S, C, gc, cfg, dirty, now_ms, out);
  return int(cudaGetLastError());
}

// K5: replica commit of M updates (upd i64[5, M]) into every shard.
int gt_set_replica(int32_t* rep_status, int64_t* rep_limit, int64_t* rep_remaining,
                   int64_t* rep_reset, int64_t* rep_expire, int64_t* ghits,
                   int64_t S, int64_t G, const int64_t* upd, int64_t M, void* stream) {
  if (M == 0) return 0;
  const gt::GCols gc{rep_status, rep_limit, rep_remaining, rep_reset, rep_expire, ghits, G};
  gt::set_replica_kernel<<<gt::blocks(M), gt::kGThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(gc, S, upd, M);
  return int(cudaGetLastError());
}

// K6: clear K gslots (idx i64[K]) in every shard: one plain launch of
// 6 S K threads (blocks of K rounded up to a warp, at most 256).
int gt_clear_gslots(int32_t* rep_status, int64_t* rep_limit, int64_t* rep_remaining,
                    int64_t* rep_reset, int64_t* rep_expire, int64_t* ghits,
                    int64_t S, int64_t G, const int64_t* idx, int64_t K, void* stream) {
  if (K == 0 || S == 0) return 0;
  if (K > INT32_MAX || S > 65535) return int(cudaErrorInvalidValue);
  const gt::GCols gc{rep_status, rep_limit, rep_remaining, rep_reset, rep_expire, ghits, G};
  const int64_t threads = std::min<int64_t>(gt::kGThreads, (K + 31) / 32 * 32);
  const dim3 grid(unsigned((K + threads - 1) / threads), unsigned(S), 6);
  gt::clear_kernel<<<grid, unsigned(threads), 0, static_cast<cudaStream_t>(stream)>>>(
      gc, idx, int32_t(K));
  return int(cudaGetLastError());
}

}  // extern "C"
