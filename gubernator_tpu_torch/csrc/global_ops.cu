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
// reads of a cached lane and an 8-byte atomic add; K4 reads ghits and
// the replica columns of every shard once, writes them once, and writes
// 64 bytes of packed result per (shard, gslot); K5 and K6 scatter a few
// words per gslot into every shard.  The integer work is far below the
// card's rate.
//
// Design.
//   * K3 runs each round as the compute + commit launch pair of K1/K2,
//     through the same compute_lane / commit_lane (stream order is the
//     barrier between a round's reads and its writes); only its output
//     sink differs, which first looks at each lane for the replica
//     answer and the hit accumulation.  The replica columns do not change inside the program, so
//     a lane's `cached` test does not depend on the round.  Hits go into
//     ghits with a 64-bit atomicAdd on the two's-complement bits: integer
//     addition commutes, so duplicate gslots and negative hits give the
//     JAX program's bits in any order.
//   * K4 is one launch, one thread per gslot.  Each gslot has one owner
//     shard and its key one slot there, so the owner row a thread reads
//     and writes belongs to no other thread; the thread sums ghits over
//     the shards, evaluates the owner lane, commits its row, and writes
//     the broadcast and the packed result of every shard.  Masked lanes
//     (non-owner shards, inactive gslots) are not evaluated: the JAX
//     program's outputs for a lane with slot -1 are zeros, written here
//     directly.
//   * K5 and K6 are one thread per updated gslot.

#include <cuda_runtime.h>

#include <cstdint>

#include "bucket_rounds.cuh"

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

  __device__ void put(int64_t s, int64_t p, int64_t row0, int64_t limit, int64_t rem,
                      int64_t reset, int64_t nexp) const {
    int64_t* o = out + s * 5 * P + p;
    o[0] = row0;
    o[P] = limit;
    o[2 * P] = rem;
    o[3 * P] = reset;
    o[4 * P] = nexp;
  }

  __device__ bool first_look(int64_t s, int64_t p, const Lane& q) const {
    const int64_t gs = gslot[s * P + p];
    if (gs < 0) return false;
    const int64_t G = gc.G;
    if (gs < G)  // out-of-range gslots drop their hits, as JAX's mode="drop"
      atomicAdd(reinterpret_cast<unsigned long long*>(gc.ghits + s * G + gs),
                static_cast<unsigned long long>(q.hits));
    const int64_t g = s * G + (gs < G ? gs : G - 1);  // JAX's clamped gather
    if (gc.rep_expire[g] < now) return false;
    put(s, p, int64_t(gc.rep_status[g]) | 4, gc.rep_limit[g], gc.rep_remaining[g],
        gc.rep_reset[g], 0);
    return true;
  }

  __device__ void zero(int64_t s, int64_t p) const { put(s, p, 0, 0, 0, 0, 0); }

  // The response's limit of an evaluated lane is the request's own.
  __device__ void evaluated(int64_t s, int64_t p, const Lane& q, const Eval& e) const {
    put(s, p, e.row0, q.limit, e.remaining, e.reset_time, e.new_expire);
  }
};

// Compute step of round `round` for lane p of shard s (K3).
__global__ void __launch_bounds__(kGThreads)
answer_compute(const int32_t* __restrict__ hot, const int32_t* __restrict__ cold,
               int64_t C, ColsSource<true> src, AnswerOut sink, int64_t P, int32_t round,
               int32_t n_rounds, int64_t now, int32_t* __restrict__ stage) {
  const int64_t p = int64_t(blockIdx.x) * kGThreads + threadIdx.x;
  if (p < P)
    compute_lane(hot, cold, C, src, sink, blockIdx.y, p, P, round, n_rounds, now, stage);
}

__global__ void __launch_bounds__(kGThreads)
answer_commit(int32_t* __restrict__ hot, int32_t* __restrict__ cold, int64_t C,
              int64_t P, const int32_t* __restrict__ stage) {
  const int64_t p = int64_t(blockIdx.x) * kGThreads + threadIdx.x;
  if (p < P) commit_lane(hot, cold, C, blockIdx.y, p, P, stage);
}

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
    q.algo = cfg[2 * G + g];
    q.behavior = cfg[3 * G + g];
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
      int4 w[3];
      row_words(e, w);
      store_rows(hot, cold, owner * C + owner_slot, flag, w);
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

// K6: zero the six columns at idx i64[K] (>= 0; >= G is padding, dropped).
__global__ void __launch_bounds__(kGThreads)
clear_kernel(GCols gc, int64_t S, const int64_t* __restrict__ idx, int64_t K) {
  const int64_t k = int64_t(blockIdx.x) * kGThreads + threadIdx.x;
  if (k >= K) return;
  const int64_t g = idx[k];
  if (g < 0 || g >= gc.G) return;
  for (int64_t s = 0; s < S; ++s) {
    const int64_t i = s * gc.G + g;
    gc.rep_status[i] = 0;
    gc.rep_limit[i] = 0;
    gc.rep_remaining[i] = 0;
    gc.rep_reset[i] = 0;
    gc.rep_expire[i] = 0;
    gc.ghits[i] = 0;
  }
}

inline unsigned blocks(int64_t n) { return unsigned((n + kGThreads - 1) / kGThreads); }

}  // namespace gt

extern "C" {

// K3: all rounds of one dataclass-path batch.  hot/cold i32[S, C, 8] and
// the replica columns (rep_status i32[S, G], the rest i64[S, G]) are
// updated in place; lanes i32[S, 6, P] (slot, exists | write << 1,
// algorithm, behavior, occ, round_id), values i64[S, 5, P] (hits, limit,
// duration, greg_expire, greg_duration), gslot i32[S, P], stage
// i32[S, P, 16] scratch, out i64[S, 5, P].  Returns cudaGetLastError().
int gt_global_answer_rounds(int32_t* hot, int32_t* cold, int64_t S, int64_t C,
                            const int32_t* lanes, const int64_t* values,
                            const int32_t* gslot, int64_t P, int32_t* rep_status,
                            int64_t* rep_limit, int64_t* rep_remaining,
                            int64_t* rep_reset, int64_t* rep_expire, int64_t* ghits,
                            int64_t G, int32_t n_rounds, int64_t now_ms,
                            int32_t* stage, int64_t* out, void* stream) {
  if (P == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const gt::GCols gc{rep_status, rep_limit, rep_remaining, rep_reset, rep_expire, ghits, G};
  const gt::ColsSource<true> src{lanes, values, P};
  const gt::AnswerOut sink{out, gslot, gc, P, now_ms};
  const dim3 grid(gt::blocks(P), unsigned(S));
  for (int32_t r = 0; r < n_rounds; ++r) {
    gt::answer_compute<<<grid, gt::kGThreads, 0, st>>>(
        hot, cold, C, src, sink, P, r, n_rounds, now_ms, stage);
    gt::answer_commit<<<grid, gt::kGThreads, 0, st>>>(hot, cold, C, P, stage);
  }
  return int(cudaGetLastError());
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

// K6: clear K gslots (idx i64[K]) in every shard.
int gt_clear_gslots(int32_t* rep_status, int64_t* rep_limit, int64_t* rep_remaining,
                    int64_t* rep_reset, int64_t* rep_expire, int64_t* ghits,
                    int64_t S, int64_t G, const int64_t* idx, int64_t K, void* stream) {
  if (K == 0) return 0;
  const gt::GCols gc{rep_status, rep_limit, rep_remaining, rep_reset, rep_expire, ghits, G};
  gt::clear_kernel<<<gt::blocks(K), gt::kGThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(gc, S, idx, K);
  return int(cudaGetLastError());
}

}  // extern "C"
