// Per-lane token/leaky bucket evaluation and the round steps shared by
// the bucket-rounds kernels (bucket_rounds.cu) and the GLOBAL-plane
// kernels (global_ops.cu).
//
// A line-by-line transcription of the JAX package's
// ops/buckets.py::_apply_compute (one lane instead of a vector of
// lanes; see that module for the reference citations of every path).
// All arithmetic is int64 on int32 storage:
//   * jnp `//` floors and C++ `/` truncates, so every division here
//     goes through fdiv() (divisor always >= 1) or, for the fixed-point
//     scale, an arithmetic shift (floor as well);
//   * the leaky leak elapsed*limit/duration is exact: an int64 fast
//     form where the product fits, else a 128-bit product divided by
//     shift-subtract (the JAX package's _muldiv128).  JAX picks one
//     branch for the whole batch with lax.cond; both are exact, so the
//     per-lane choice gives the same bits.
#pragma once

#include <cstdint>

namespace gt {

constexpr int kLeakyScaleBits = 20;
constexpr int64_t kLeakyScale = int64_t(1) << kLeakyScaleBits;
constexpr int64_t kI32Max = (int64_t(1) << 31) - 1;
constexpr int64_t kTokenBucket = 0;   // Algorithm.TOKEN_BUCKET
constexpr int64_t kGregorian = 4;     // Behavior.DURATION_IS_GREGORIAN
constexpr int64_t kResetRemaining = 8;  // Behavior.RESET_REMAINING
constexpr int64_t kUnder = 0, kOver = 1;  // Status

// Row layout (ops/buckets.py BucketState): hot = flags, remaining lo/hi,
// stamp lo/hi, expire lo/hi, spare; cold = limit lo/hi, duration lo/hi,
// 4 spare words.
enum { kHotFlags = 0, kHotRem = 1, kHotStamp = 3, kHotExp = 5 };
enum { kColdLim = 0, kColdDur = 2 };

// Staging record of one lane between a round's compute and its commit
// (16 words): new hot row, new cold row values, commit flags.
constexpr int kStageWords = 16;
constexpr int kStageFlag = 12;  // bit0 write hot row, bit1 write cold row

__device__ __forceinline__ int64_t compose64(int32_t lo, int32_t hi) {
  return (int64_t(hi) << 32) | int64_t(uint32_t(lo));
}
__device__ __forceinline__ int32_t lo32(int64_t v) { return int32_t(uint32_t(uint64_t(v))); }
__device__ __forceinline__ int32_t hi32(int64_t v) { return int32_t(v >> 32); }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }
__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// Floor division for a positive divisor (jnp `//`).
__device__ __forceinline__ int64_t fdiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
// floor(v / LEAKY_SCALE): arithmetic right shift floors.
__device__ __forceinline__ int64_t fscale(int64_t v) { return v >> kLeakyScaleBits; }

// Exact (floor(a*b/d), a*b mod d) for 0 <= a, b < 2**63, 1 <= d < 2**63
// with a quotient that fits int64 (the JAX package's _muldiv128): the
// 128-bit product in two words, then 128 steps of shift-subtract.
__device__ __forceinline__ void muldiv128(uint64_t a, uint64_t b, uint64_t d,
                                          int64_t& q_out, int64_t& r_out) {
  if (d < 1) d = 1;
  uint64_t lo = a * b;
  uint64_t hi = __umul64hi(a, b);
  uint64_t r = 0, q = 0;
  for (int i = 0; i < 128; ++i) {
    uint64_t top = hi >> 63;
    hi = (hi << 1) | (lo >> 63);
    lo <<= 1;
    r = (r << 1) | top;
    uint64_t take = r >= d ? 1 : 0;
    if (take) r -= d;
    q = (q << 1) | take;
  }
  q_out = int64_t(q);
  r_out = int64_t(r);
}

// Exact (floor(el*lim/rn), floor((el*lim mod rn) * SCALE / rn)) for
// 0 <= el <= rn, lim >= 0, rn >= 1 (ops/buckets.py _leak_amounts).
__device__ __forceinline__ void leak_amounts(int64_t el, int64_t lim, int64_t rn,
                                             int64_t& whole, int64_t& frac) {
  const int64_t qL = lim / rn;  // operands >= 0: truncation == floor
  const int64_t rL = lim % rn;
  const int64_t max64 = INT64_MAX;
  const bool ok = (rL == 0 || el <= max64 / imax(rL, 1)) && rn < (int64_t(1) << 43);
  if (ok) {
    const int64_t prod = el * rL;
    whole = el * qL + prod / rn;
    frac = ((prod % rn) * kLeakyScale) / rn;
  } else {
    int64_t lr, unused;
    muldiv128(uint64_t(el), uint64_t(lim), uint64_t(rn), whole, lr);
    muldiv128(uint64_t(lr), uint64_t(kLeakyScale), uint64_t(rn), frac, unused);
  }
}

// One lane's request, values widened to int64.
struct Lane {
  int64_t algo, behavior, hits, limit, duration, greg_expire, greg_duration, occ;
  bool exists, write;
};

// Response and new state of one VALID lane (slot >= 0).
struct Eval {
  int64_t row0;  // status | removed << 1
  int64_t remaining, reset_time, new_expire, pre_expire;
  int32_t hot[8];
  int64_t limit, duration;  // new cold row values
  bool write_hot, write_cold;
};

__device__ __forceinline__ void eval_lane(const int32_t* hg, const int32_t* cg,
                                          const Lane& q, int64_t now, Eval& e) {
  const int64_t g_flags = hg[kHotFlags];
  const int64_t g_algo = g_flags & 3;
  const int64_t g_status = (g_flags >> 2) & 1;
  const int64_t g_limit = compose64(cg[kColdLim], cg[kColdLim + 1]);
  const int64_t g_rem = compose64(hg[kHotRem], hg[kHotRem + 1]);
  const int64_t g_dur = compose64(cg[kColdDur], cg[kColdDur + 1]);
  const int64_t g_stamp = compose64(hg[kHotStamp], hg[kHotStamp + 1]);
  const int64_t g_exp = compose64(hg[kHotExp], hg[kHotExp + 1]);

  // Expiry-as-miss: a slot at exactly its expiry is still live.
  const bool live = q.exists && g_exp >= now;
  const bool exist = live && g_algo == q.algo;  // algo switch => recreate
  const bool is_tok = q.algo == kTokenBucket;
  const bool greg = (q.behavior & kGregorian) != 0;
  const bool reset_b = (q.behavior & kResetRemaining) != 0;
  const int64_t hits = q.hits, limit = q.limit, duration = q.duration, occ = q.occ;
  const int64_t hs = imax(hits, 1);
  // Pre-hit remaining of occurrence `occ` of a uniform duplicate group.
  auto occ_rem = [&](int64_t base) {
    const int64_t taken = imin(occ, fdiv(base, hs));
    return hits > 0 ? base - hits * taken : base;
  };

  // ---------------- token bucket, existing item ----------------
  const bool tok_reset = live && is_tok && reset_b;
  int64_t t_rem0 = imax(g_rem + (limit - g_limit), 0);
  const bool dur_changed = g_dur != duration;
  const int64_t exp_from_cfg = greg ? q.greg_expire : g_stamp + duration;
  const bool dur_expired = dur_changed && exp_from_cfg < now;
  const int64_t t_exp = dur_changed ? exp_from_cfg : g_exp;
  const bool tok_exist = exist && is_tok && !reset_b && !dur_expired;
  const bool do_hit = hits > 0;
  t_rem0 = occ_rem(t_rem0);
  const bool can_take = do_hit && hits <= t_rem0;
  const int64_t t_rem1 = can_take ? t_rem0 - hits : t_rem0;
  const int64_t t_resp_status = (do_hit && (t_rem0 == 0 || hits > t_rem0)) ? kOver : g_status;
  const int64_t t_new_status = (do_hit && t_rem0 == 0) ? kOver : g_status;

  // ---------------- token bucket, fresh create ----------------
  const int64_t c_exp_tok = greg ? q.greg_expire : now + duration;
  const int64_t remc = occ_rem(limit);
  const bool c_over = hits > remc;
  const int64_t c_rem_tok = c_over ? remc : remc - hits;
  const int64_t c_status_store = (occ > 0 && do_hit && remc == 0) ? kOver : kUnder;

  // ---------------- leaky bucket, existing item ----------------
  const bool lky_exist = exist && !is_tok;
  int64_t l_rem = (lky_exist && reset_b) ? limit * kLeakyScale : g_rem;
  const int64_t rate_num = greg ? q.greg_duration : duration;
  const int64_t dur_eff = greg ? q.greg_expire - now : duration;
  const int64_t lim_safe = imax(limit, 1);
  const int64_t rn = imax(rate_num, 1);
  const int64_t el_c = imin(imax(now - g_stamp, 0), rn);
  int64_t leak_whole, leak_frac;
  leak_amounts(el_c, imax(limit, 0), rn, leak_whole, leak_frac);
  const bool do_leak = leak_whole > 0;
  if (do_leak) l_rem += leak_whole * kLeakyScale + leak_frac;
  const int64_t l_stamp = do_leak ? now : g_stamp;
  if (fscale(l_rem) > limit) l_rem = limit * kLeakyScale;
  const int64_t rem_int0 = fscale(l_rem);
  const int64_t l_reset = now + fdiv(rate_num, lim_safe);
  const int64_t rem_int = occ_rem(rem_int0);
  const int64_t l_rem_base = l_rem - (rem_int0 - rem_int) * kLeakyScale;
  const bool at_zero = rem_int == 0;
  const bool exact = !at_zero && rem_int == hits;
  const bool overflow = !at_zero && !exact && hits > rem_int;
  const bool take = exact || (!at_zero && !overflow && hits > 0);
  const int64_t l_rem_f = take ? l_rem_base - hits * kLeakyScale : l_rem_base;
  const int64_t l_resp_rem = exact ? 0 : (take ? fscale(l_rem_f) : rem_int);
  const int64_t l_resp_status = (at_zero || overflow) ? kOver : kUnder;
  const int64_t take64 = take ? 1 : 0;
  const int64_t taken_cnt = (hits > 0 ? fdiv(rem_int0 - rem_int, hs) : 0) + take64;
  const bool drained_exactly =
      hits > 0 && taken_cnt > 0 && (rem_int - hits * take64 == 0);
  const bool any_plain = (taken_cnt - (drained_exactly ? 1 : 0)) >= 1;
  const int64_t l_exp = any_plain ? now + dur_eff : g_exp;

  // ---------------- leaky bucket, fresh create ----------------
  const bool lc_over_all = hits > limit;
  int64_t remlc = occ_rem(limit);
  if (lc_over_all && occ > 0) remlc = 0;
  const bool lc_take = hits > 0 && hits <= remlc;
  const bool lc_over = hits > remlc;
  const int64_t lc_rem = lc_over_all ? 0 : (remlc - hits * (lc_take ? 1 : 0)) * kLeakyScale;
  const int64_t lc_resp_rem = lc_take ? remlc - hits : (lc_over_all ? 0 : remlc);
  const int64_t lc_exp = now + dur_eff;
  const int64_t lc_reset = now + fdiv(dur_eff, lim_safe);

  // ---------------- merge the five paths ----------------
  int64_t status, rem, reset, n_limit, n_rem, n_dur, n_stamp, n_exp, n_status;
  if (is_tok && tok_reset) {
    status = kUnder; rem = limit; reset = 0;
    n_limit = g_limit; n_rem = g_rem; n_dur = g_dur; n_stamp = g_stamp;
    n_exp = 0; n_status = kUnder;
  } else if (is_tok && tok_exist) {
    status = t_resp_status; rem = can_take ? t_rem1 : t_rem0; reset = t_exp;
    n_limit = limit; n_rem = t_rem1; n_dur = g_dur; n_stamp = g_stamp;
    n_exp = t_exp; n_status = t_new_status;
  } else if (is_tok) {
    status = c_over ? kOver : kUnder; rem = c_rem_tok; reset = c_exp_tok;
    n_limit = limit; n_rem = c_rem_tok; n_dur = duration; n_stamp = now;
    n_exp = c_exp_tok; n_status = c_status_store;
  } else if (lky_exist) {
    status = l_resp_status; rem = l_resp_rem; reset = l_reset;
    n_limit = limit; n_rem = l_rem_f; n_dur = duration; n_stamp = l_stamp;
    n_exp = l_exp; n_status = kUnder;
  } else {
    status = lc_over ? kOver : kUnder; rem = lc_resp_rem; reset = lc_reset;
    n_limit = limit; n_rem = lc_rem; n_dur = dur_eff; n_stamp = now;
    n_exp = lc_exp; n_status = kUnder;
  }

  e.row0 = status | (int64_t(tok_reset ? 1 : 0) << 1);
  e.remaining = rem;
  e.reset_time = reset;
  e.new_expire = n_exp;
  e.pre_expire = g_exp;
  e.hot[0] = int32_t((q.algo & 3) | ((n_status & 1) << 2));
  e.hot[1] = lo32(n_rem);
  e.hot[2] = hi32(n_rem);
  e.hot[3] = lo32(n_stamp);
  e.hot[4] = hi32(n_stamp);
  e.hot[5] = lo32(n_exp);
  e.hot[6] = hi32(n_exp);
  e.hot[7] = 0;
  e.limit = n_limit;
  e.duration = n_dur;
  e.write_hot = q.write;
  e.write_cold = q.write && (n_limit != g_limit || n_dur != g_dur);
}

// Narrow time encoding (ops/buckets.py apply_rounds32): delta from now;
// -1 = absolute 0; -2 = unrepresentable and equal to the lane's own
// pre-round stored expiry; otherwise clipped to [0, 2**31).
__device__ __forceinline__ int32_t narrow_time(int64_t v, int64_t now, int64_t pre) {
  if (v == 0) return -1;
  const int64_t d = v - now;
  if (d >= 0 && d <= kI32Max) return int32_t(d);
  if (v == pre) return -2;
  return int32_t(imin(imax(d, 0), kI32Max));
}

constexpr int64_t kTableRows = 256;

// Single-buffer dict wire of one shard (ops/buckets.py pack_dict_wire):
// slot[P], occ|flags<<16|cfg<<24 [P], round_id[P], then the table.
template <bool WIDE>
struct DictSource {
  const int32_t* wire;
  int64_t P, W;

  __device__ void head(int64_t s, int64_t p, int32_t& slot, int32_t& rid) const {
    const int32_t* w = wire + s * W;
    slot = w[p];
    rid = w[2 * P + p];
  }

  __device__ void lane(int64_t s, int64_t p, int64_t now, Lane& q) const {
    const int32_t* w = wire + s * W;
    const int32_t meta = w[P + p];
    const int32_t fl = (meta >> 16) & 0xFF;
    const int64_t cfg = (meta >> 24) & 0xFF;
    const int32_t* t = w + 3 * P;
    auto value = [&](int k) -> int64_t {
      const int32_t lo = t[(2 + 2 * k) * kTableRows + cfg];
      if (!WIDE) return int64_t(lo);  // the narrow wire's int32 cast
      return compose64(lo, t[(3 + 2 * k) * kTableRows + cfg]);
    };
    q.algo = t[cfg];
    q.behavior = t[kTableRows + cfg];
    q.hits = value(0);
    q.limit = value(1);
    q.duration = value(2);
    const int64_t delta = value(3);
    q.greg_duration = value(4);
    q.greg_expire = (WIDE && q.greg_duration == 0) ? 0 : now + delta;
    q.occ = meta & 0xFFFF;
    q.exists = (fl & 1) != 0;
    q.write = (fl & 2) != 0;
  }
};

// Per-lane-column wire (ops/buckets.py bucket_rounds_cols_plain):
// lanes i32[S, 6, P] = slot, exists|write<<1, algorithm, behavior, occ,
// round_id; values [S, 5, P] = hits, limit, duration, greg_expire,
// greg_duration as i32 (greg_expire a delta from now) or, WIDE, i64.
template <bool WIDE>
struct ColsSource {
  const int32_t* lanes;
  const void* values;
  int64_t P;

  __device__ void head(int64_t s, int64_t p, int32_t& slot, int32_t& rid) const {
    slot = lanes[(s * 6 + 0) * P + p];
    rid = lanes[(s * 6 + 5) * P + p];
  }

  __device__ void lane(int64_t s, int64_t p, int64_t now, Lane& q) const {
    const int32_t fl = lanes[(s * 6 + 1) * P + p];
    q.algo = lanes[(s * 6 + 2) * P + p];
    q.behavior = lanes[(s * 6 + 3) * P + p];
    q.occ = lanes[(s * 6 + 4) * P + p];
    auto value = [&](int k) -> int64_t {
      const int64_t i = (s * 5 + k) * P + p;
      return WIDE ? static_cast<const int64_t*>(values)[i]
                  : int64_t(static_cast<const int32_t*>(values)[i]);
    };
    q.hits = value(0);
    q.limit = value(1);
    q.duration = value(2);
    q.greg_expire = WIDE ? value(3) : now + value(3);
    q.greg_duration = value(4);
    q.exists = (fl & 1) != 0;
    q.write = (fl & 2) != 0;
  }
};

// Output of the bucket-rounds kernels (K1, K2): out [S, 4, P] narrow
// i32 or wide i64 (row0, remaining, reset_time, new_expire).  Every
// lane that reaches a slot is evaluated.
template <bool WIDE>
struct BucketOut {
  void* out;
  int64_t P, now;
  static constexpr bool kFirstLook = false;

  __device__ bool first_look(int64_t, int64_t, const Lane&) const { return false; }

  __device__ void put(int64_t s, int64_t p, int64_t row0, int64_t rem, int64_t reset,
                      int64_t nexp, int64_t pre) const {
    if (WIDE) {
      int64_t* o = static_cast<int64_t*>(out) + s * 4 * P + p;
      o[0] = row0;
      o[P] = rem;
      o[2 * P] = reset;
      o[3 * P] = nexp;
    } else {
      int32_t* o = static_cast<int32_t*>(out) + s * 4 * P + p;
      o[0] = int32_t(row0);
      o[P] = int32_t(imin(imax(rem, 0), kI32Max));
      o[2 * P] = narrow_time(reset, now, pre);
      o[3 * P] = narrow_time(nexp, now, pre);
    }
  }
  __device__ void zero(int64_t s, int64_t p) const { put(s, p, 0, 0, 0, 0, 0); }
  __device__ void evaluated(int64_t s, int64_t p, const Lane&, const Eval& e) const {
    put(s, p, e.row0, e.remaining, e.reset_time, e.new_expire, e.pre_expire);
  }
};

// Gather the rows of `slot` in shard s (an out-of-range slot reads row
// C - 1, as JAX's clamped gather) and evaluate lane q against them.
__device__ __forceinline__ void gather_eval(const int32_t* __restrict__ hot,
                                            const int32_t* __restrict__ cold, int64_t C,
                                            int64_t s, int64_t slot, const Lane& q,
                                            int64_t now, Eval& e) {
  const int64_t row = s * C + (slot < C ? slot : C - 1);
  const int4* hp = reinterpret_cast<const int4*>(hot + row * 8);
  const int4 h0 = hp[0], h1 = hp[1];
  const int4 c0 = reinterpret_cast<const int4*>(cold + row * 8)[0];
  const int32_t hg[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  const int32_t cg[4] = {c0.x, c0.y, c0.z, c0.w};
  eval_lane(hg, cg, q, now, e);
}

// Which rows an evaluated lane writes (bit0 hot, bit1 cold); a lane
// whose slot is out of range drops its write.
__device__ __forceinline__ int32_t write_flag(const Eval& e, int64_t slot, int64_t C) {
  const bool in_table = slot < C;
  return (e.write_hot && in_table ? 1 : 0) | (e.write_cold && in_table ? 2 : 0);
}

// The new rows of an evaluated lane as 16-byte words: the hot row (2),
// the cold row's limit and duration (1).
__device__ __forceinline__ void row_words(const Eval& e, int4 w[3]) {
  w[0] = make_int4(e.hot[0], e.hot[1], e.hot[2], e.hot[3]);
  w[1] = make_int4(e.hot[4], e.hot[5], e.hot[6], e.hot[7]);
  w[2] = make_int4(lo32(e.limit), hi32(e.limit), lo32(e.duration), hi32(e.duration));
}

// Store the rows `flag` names at table row `row` (the cold row's spare
// words zeroed).
__device__ __forceinline__ void store_rows(int32_t* __restrict__ hot,
                                           int32_t* __restrict__ cold, int64_t row,
                                           int32_t flag, const int4* w) {
  if (flag & 1) {
    int4* hp = reinterpret_cast<int4*>(hot + row * 8);
    hp[0] = w[0];
    hp[1] = w[1];
  }
  if (flag & 2) {
    int4* cp = reinterpret_cast<int4*>(cold + row * 8);
    cp[0] = w[2];
    cp[1] = make_int4(0, 0, 0, 0);
  }
}

// Compute step of round `round` for lane p of shard s: every lane of
// the round evaluates against the pre-round rows, writes its output
// through `sink` and stages its new rows.  A lane of another round
// stages nothing; in round 0, lanes that no round will evaluate
// (padding) write the all-zero output, as does a lane of the round with
// slot -1.  A Sink with kFirstLook sees each lane of the round before
// its slot is read, and answers it itself (no evaluation, no write)
// when first_look returns true.
template <class Source, class Sink>
__device__ __forceinline__ void compute_lane(
    const int32_t* __restrict__ hot, const int32_t* __restrict__ cold, int64_t C,
    const Source& src, const Sink& sink, int64_t s, int64_t p, int64_t P,
    int32_t round, int32_t n_rounds, int64_t now, int32_t* __restrict__ stage) {
  int32_t* st = stage + (s * P + p) * kStageWords;
  int32_t slot, rid;
  src.head(s, p, slot, rid);
  Lane q;
  if (Sink::kFirstLook && rid == round) {
    src.lane(s, p, now, q);
    if (sink.first_look(s, p, q)) {
      st[kStageFlag] = 0;
      return;
    }
  }
  if (rid != round || slot < 0) {
    st[kStageFlag] = 0;
    const bool never_runs = rid < 0 || rid >= n_rounds;
    if (rid == round || (never_runs && round == 0)) sink.zero(s, p);
    return;
  }
  if (!Sink::kFirstLook) src.lane(s, p, now, q);
  Eval e;
  gather_eval(hot, cold, C, s, slot, q, now, e);
  sink.evaluated(s, p, q, e);
  const int32_t flag = write_flag(e, slot, C);
  if (flag) {
    int4 w[3];
    row_words(e, w);
    int4* sp = reinterpret_cast<int4*>(st);
    sp[0] = w[0];
    sp[1] = w[1];
    sp[2] = w[2];
    sp[3] = make_int4(flag, slot, 0, 0);
  } else {
    st[kStageFlag] = 0;
  }
}

// Commit step: scatter the staged rows of the round's writers.  Write
// slots are unique within a round, so the stores never collide.
__device__ __forceinline__ void commit_lane(int32_t* __restrict__ hot,
                                            int32_t* __restrict__ cold, int64_t C,
                                            int64_t s, int64_t p, int64_t P,
                                            const int32_t* __restrict__ stage) {
  const int4* sp = reinterpret_cast<const int4*>(stage + (s * P + p) * kStageWords);
  const int4 tail = sp[3];
  if (tail.x) store_rows(hot, cold, s * C + tail.y, tail.x, sp);
}

}  // namespace gt
