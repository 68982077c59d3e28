// Per-lane token/leaky bucket evaluation and the round steps shared by
// the bucket-rounds kernels (bucket_rounds.cu), the GLOBAL-plane kernels
// (global_ops.cu) and the compact commit (compact.cu).
//
// The JAX package's ops/buckets.py::_apply_compute, one lane instead of
// a vector of lanes (see that module for the reference citations of
// every path).  The vector form computes all five paths of every lane
// and selects; here a lane computes only the path it takes.  All
// arithmetic is int64 on int32 storage:
//   * jnp `//` floors and C++ `/` truncates, so every division goes
//     through fdiv() (divisor always >= 1) or, for the fixed-point
//     scale, an arithmetic shift (floor as well); both operands below
//     2**32 take a 32-bit division;
//   * the leaky leak elapsed*limit/duration is exact: an int64 form
//     where the product fits (its divisions in 32 bits, in double below
//     2**53, else int64), else a 128-bit product divided by a corrected
//     double-precision quotient or, for limits of 2**52 and more, by
//     shift-subtract (the JAX package's _muldiv128).  JAX picks one
//     branch for the whole batch with lax.cond; every form is exact, so
//     the per-lane choice gives the same bits.
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
// launches (K10; 16 words): new hot row, new cold row values,
// commit flags.
constexpr int kStageWords = 16;
constexpr int kStageFlag = 12;  // bit0 write hot row, bit1 write cold row

__device__ __forceinline__ int64_t compose64(int32_t lo, int32_t hi) {
  return (int64_t(hi) << 32) | int64_t(uint32_t(lo));
}
__device__ __forceinline__ int32_t lo32(int64_t v) { return int32_t(uint32_t(uint64_t(v))); }
__device__ __forceinline__ int32_t hi32(int64_t v) { return int32_t(v >> 32); }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }
__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// Floor division for a positive divisor (jnp `//`): a 32-bit division
// where both operands lie in [0, 2**32), else the int64 one (truncating)
// corrected to the floor.
__device__ __forceinline__ int64_t fdiv(int64_t a, int64_t b) {
  if (((uint64_t(a) | uint64_t(b)) >> 32) == 0) return int64_t(uint32_t(a) / uint32_t(b));
  const int64_t q = a / b;
  return (q * b != a && a < 0) ? q - 1 : q;
}
// floor(v / LEAKY_SCALE): arithmetic right shift floors.
__device__ __forceinline__ int64_t fscale(int64_t v) { return v >> kLeakyScaleBits; }

// Exact (x / d, x % d) for x >= 0, d >= 1.  Below 2**32 a 32-bit
// division; below 2**53 the truncated double quotient: both operands are
// exact doubles, and a quotient k + f with 0 < f < 1 lies at least 1/d
// below k + 1, more than half the doubles' spacing there (k * d < 2**53),
// so it never rounds up to k + 1; else int64.
__device__ __forceinline__ void udivmod(uint64_t x, uint64_t d, uint64_t& q, uint64_t& r) {
  if (((x | d) >> 32) == 0)
    q = uint32_t(x) / uint32_t(d);
  else if (((x | d) >> 53) == 0)
    q = uint64_t(double(x) / double(d));
  else
    q = x / d;
  r = x - q * d;
}

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

// Exact (floor(a*b/d), a*b mod d) for a <= d, b < 2**63, 1 <= d <
// 2**63.  The quotient is at most b; where b < 2**52 the double-precision
// quotient is within 3 of it and is corrected on the 128-bit remainder,
// else the shift-subtract loop.  (A month's Gregorian duration as the
// reference reports it is about 1.7e18 ms, so every monthly leaky lane
// comes here.)
__device__ __forceinline__ void muldiv(uint64_t a, uint64_t b, uint64_t d, int64_t& q_out,
                                       int64_t& r_out) {
  if ((b >> 52) != 0) {
    muldiv128(a, b, d, q_out, r_out);
    return;
  }
  uint64_t q = uint64_t(double(a) * double(b) / double(d));
  const uint64_t lo = a * b, qlo = q * d;
  // a*b - q*d as a signed 128-bit number (rhi, rlo)
  int64_t rhi = int64_t(__umul64hi(a, b) - __umul64hi(q, d) - (lo < qlo ? 1 : 0));
  uint64_t rlo = lo - qlo;
  while (rhi < 0) {
    --q;
    rlo += d;
    rhi += rlo < d ? 1 : 0;
  }
  while (rhi > 0 || rlo >= d) {
    ++q;
    rhi -= rlo < d ? 1 : 0;
    rlo -= d;
  }
  q_out = int64_t(q);
  r_out = int64_t(rlo);
}

// Exact (floor(el*lim/rn), floor((el*lim mod rn) * SCALE / rn)) for
// 0 <= el <= rn, lim >= 0, rn >= 1 (ops/buckets.py _leak_amounts): with
// lim = qL*rn + rL, el*lim/rn = el*qL + el*rL/rn, exact in int64 where
// el*rL fits (the JAX package's `el <= INT64_MAX / rL`, here read off the
// 128-bit product) and rn < 2**43, else the 128-bit division (muldiv).
__device__ __forceinline__ void leak_amounts(int64_t el, int64_t lim, int64_t rn,
                                             int64_t& whole, int64_t& frac) {
  uint64_t qL, rL;
  udivmod(uint64_t(lim), uint64_t(rn), qL, rL);
  const uint64_t prod = uint64_t(el) * rL;
  if (__umul64hi(uint64_t(el), rL) == 0 && (prod >> 63) == 0 && rn < (int64_t(1) << 43)) {
    uint64_t pq, pr, fq, fr;
    udivmod(prod, uint64_t(rn), pq, pr);
    udivmod(pr << kLeakyScaleBits, uint64_t(rn), fq, fr);
    whole = el * int64_t(qL) + int64_t(pq);
    frac = int64_t(fq);
  } else {
    int64_t lr, unused;
    muldiv(uint64_t(el), uint64_t(lim), uint64_t(rn), whole, lr);
    muldiv(uint64_t(lr), uint64_t(kLeakyScale), uint64_t(rn), frac, unused);
  }
}

// Pre-hit remaining of occurrence `occ` of a uniform duplicate group of
// lanes taking `hits` each: base - hits * min(occ, floor(base / hits)).
// The first occurrence of a group over base >= 0 takes nothing (the
// floor is >= 0, so the min is 0) and skips the division.
__device__ __forceinline__ int64_t occ_rem(int64_t base, int64_t hits, int64_t occ) {
  if (hits <= 0 || (occ == 0 && base >= 0)) return base;
  return base - hits * imin(occ, fdiv(base, hits));
}

// One lane's request: values widened to int64; the algorithm, behavior
// and occurrence are int32 on every wire (K4's int64 config columns hold
// the same small values).
struct Lane {
  int64_t hits, limit, duration, greg_expire, greg_duration;
  int32_t algo, behavior, occ;
  bool exists, write;
};

// The stored row a lane reads, widened.
struct Row {
  int32_t algo, status;
  int64_t limit, rem, dur, stamp, exp;
};

// What a lane's branch decides: its response and its slot's new row.
struct Step {
  int64_t status, rem, reset;
  int64_t n_limit, n_rem, n_dur, n_stamp, n_exp, n_status;
};

// Response and new state of one VALID lane (slot >= 0).
struct Eval {
  int64_t row0;  // status | removed << 1
  int64_t remaining, reset_time, new_expire, pre_expire;
  int32_t hot[8];
  int64_t limit, duration;  // new cold row values
  bool write_hot, write_cold;
};

// Token bucket, RESET_REMAINING on a live slot: answer the full limit,
// leave the row's values and free the slot (expiry 0).
__device__ __forceinline__ void token_reset(const Row& g, const Lane& q, Step& o) {
  o.status = kUnder;
  o.rem = q.limit;
  o.reset = 0;
  o.n_limit = g.limit;
  o.n_rem = g.rem;
  o.n_dur = g.dur;
  o.n_stamp = g.stamp;
  o.n_exp = 0;
  o.n_status = kUnder;
}

// Token bucket, existing item, whose expiry after a duration change is
// `t_exp`.
__device__ __forceinline__ void token_exist(const Row& g, const Lane& q, int64_t t_exp,
                                            Step& o) {
  const int64_t hits = q.hits;
  const int64_t rem0 = occ_rem(imax(g.rem + (q.limit - g.limit), 0), hits, q.occ);
  const bool do_hit = hits > 0;
  const bool can_take = do_hit && hits <= rem0;
  const int64_t rem1 = can_take ? rem0 - hits : rem0;
  o.status = (do_hit && (rem0 == 0 || hits > rem0)) ? kOver : g.status;
  o.rem = rem1;
  o.reset = t_exp;
  o.n_limit = q.limit;
  o.n_rem = rem1;
  o.n_dur = g.dur;
  o.n_stamp = g.stamp;
  o.n_exp = t_exp;
  o.n_status = (do_hit && rem0 == 0) ? kOver : g.status;
}

// Token bucket, fresh create.
__device__ __forceinline__ void token_create(const Lane& q, int64_t now, bool greg, Step& o) {
  const int64_t exp = greg ? q.greg_expire : now + q.duration;
  const int64_t remc = occ_rem(q.limit, q.hits, q.occ);
  const bool over = q.hits > remc;
  const int64_t rem = over ? remc : remc - q.hits;
  o.status = over ? kOver : kUnder;
  o.rem = rem;
  o.reset = exp;
  o.n_limit = q.limit;
  o.n_rem = rem;
  o.n_dur = q.duration;
  o.n_stamp = now;
  o.n_exp = exp;
  o.n_status = (q.occ > 0 && q.hits > 0 && remc == 0) ? kOver : kUnder;
}

// Leaky bucket, existing item: leak since the stamp, then take.
__device__ __forceinline__ void leaky_exist(const Row& g, const Lane& q, int64_t now, bool greg,
                                            bool reset_b, Step& o) {
  const int64_t hits = q.hits, limit = q.limit;
  int64_t l_rem = reset_b ? limit * kLeakyScale : g.rem;
  const int64_t rate_num = greg ? q.greg_duration : q.duration;
  const int64_t dur_eff = greg ? q.greg_expire - now : q.duration;
  const int64_t rn = imax(rate_num, 1);
  const int64_t el = imin(imax(now - g.stamp, 0), rn);
  int64_t whole, frac;
  leak_amounts(el, imax(limit, 0), rn, whole, frac);
  const bool do_leak = whole > 0;
  if (do_leak) l_rem += whole * kLeakyScale + frac;
  if (fscale(l_rem) > limit) l_rem = limit * kLeakyScale;
  const int64_t rem_int0 = fscale(l_rem);
  const int64_t rem_int = occ_rem(rem_int0, hits, q.occ);
  const int64_t rem_base = l_rem - (rem_int0 - rem_int) * kLeakyScale;
  const bool at_zero = rem_int == 0;
  const bool exact = !at_zero && rem_int == hits;
  const bool overflow = !at_zero && !exact && hits > rem_int;
  const bool take = exact || (!at_zero && !overflow && hits > 0);
  const int64_t rem_f = take ? rem_base - hits * kLeakyScale : rem_base;
  const int64_t take64 = take ? 1 : 0;
  const int64_t taken = (hits > 0 ? fdiv(rem_int0 - rem_int, hits) : 0) + take64;
  const bool drained = hits > 0 && taken > 0 && rem_int - hits * take64 == 0;
  o.status = (at_zero || overflow) ? kOver : kUnder;
  o.rem = exact ? 0 : (take ? fscale(rem_f) : rem_int);
  o.reset = now + fdiv(rate_num, imax(limit, 1));
  o.n_limit = limit;
  o.n_rem = rem_f;
  o.n_dur = q.duration;
  o.n_stamp = do_leak ? now : g.stamp;
  o.n_exp = taken - (drained ? 1 : 0) >= 1 ? now + dur_eff : g.exp;
  o.n_status = kUnder;
}

// Leaky bucket, fresh create.
__device__ __forceinline__ void leaky_create(const Lane& q, int64_t now, bool greg, Step& o) {
  const int64_t hits = q.hits, limit = q.limit;
  const int64_t dur_eff = greg ? q.greg_expire - now : q.duration;
  const bool over_all = hits > limit;
  const int64_t rem = (over_all && q.occ > 0) ? 0 : occ_rem(limit, hits, q.occ);
  const bool take = hits > 0 && hits <= rem;
  o.status = hits > rem ? kOver : kUnder;
  o.rem = take ? rem - hits : (over_all ? 0 : rem);
  o.reset = now + fdiv(dur_eff, imax(limit, 1));
  o.n_limit = limit;
  o.n_rem = over_all ? 0 : (rem - hits * (take ? 1 : 0)) * kLeakyScale;
  o.n_dur = dur_eff;
  o.n_stamp = now;
  o.n_exp = now + dur_eff;
  o.n_status = kUnder;
}

// Evaluate lane q against its slot's rows: the five paths of the JAX
// package's _apply_compute (token reset, token existing, token create,
// leaky existing, leaky create), of which a lane computes only the one
// it takes.
__device__ __forceinline__ void eval_lane(const int32_t* hg, const int32_t* cg,
                                          const Lane& q, int64_t now, Eval& e) {
  Row g;
  g.algo = hg[kHotFlags] & 3;
  g.status = (hg[kHotFlags] >> 2) & 1;
  g.limit = compose64(cg[kColdLim], cg[kColdLim + 1]);
  g.rem = compose64(hg[kHotRem], hg[kHotRem + 1]);
  g.dur = compose64(cg[kColdDur], cg[kColdDur + 1]);
  g.stamp = compose64(hg[kHotStamp], hg[kHotStamp + 1]);
  g.exp = compose64(hg[kHotExp], hg[kHotExp + 1]);

  // Expiry-as-miss: a slot at exactly its expiry is still live.
  const bool live = q.exists && g.exp >= now;
  const bool exist = live && g.algo == q.algo;  // algo switch => recreate
  const bool greg = (q.behavior & kGregorian) != 0;
  const bool reset_b = (q.behavior & kResetRemaining) != 0;
  const bool removed = live && reset_b && q.algo == kTokenBucket;
  Step o;
  if (q.algo == kTokenBucket) {
    if (removed) {
      token_reset(g, q, o);
    } else {
      // An existing item whose duration changed takes the expiry the new
      // duration gives it, and is recreated if that has passed.
      bool tok_exist = exist && !reset_b;
      int64_t t_exp = g.exp;
      if (tok_exist && g.dur != q.duration) {
        t_exp = greg ? q.greg_expire : g.stamp + q.duration;
        tok_exist = t_exp >= now;
      }
      if (tok_exist)
        token_exist(g, q, t_exp, o);
      else
        token_create(q, now, greg, o);
    }
  } else if (exist) {
    leaky_exist(g, q, now, greg, reset_b, o);
  } else {
    leaky_create(q, now, greg, o);
  }

  e.row0 = o.status | (int64_t(removed ? 1 : 0) << 1);
  e.remaining = o.rem;
  e.reset_time = o.reset;
  e.new_expire = o.n_exp;
  e.pre_expire = g.exp;
  e.hot[0] = int32_t((q.algo & 3) | ((o.n_status & 1) << 2));
  e.hot[1] = lo32(o.n_rem);
  e.hot[2] = hi32(o.n_rem);
  e.hot[3] = lo32(o.n_stamp);
  e.hot[4] = hi32(o.n_stamp);
  e.hot[5] = lo32(o.n_exp);
  e.hot[6] = hi32(o.n_exp);
  e.hot[7] = 0;
  e.limit = o.n_limit;
  e.duration = o.n_dur;
  e.write_hot = q.write;
  e.write_cold = q.write && (o.n_limit != g.limit || o.n_dur != g.dur);
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

// Memory helpers of the bucket-rounds kernel: a 16-byte copy from device
// memory into shared memory that bypasses L1 (cp.async.cg, so a row
// another SM stored before a grid barrier is read afresh), the wait for
// all of a thread's copies, and a non-binding prefetch into L2.  Built
// for the CPU (the tests' stand-in runtime), a plain copy and no-ops.
__device__ __forceinline__ void copy_async16(int4* smem, const int4* gmem) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
#else
  *smem = *gmem;
#endif
}
__device__ __forceinline__ void copies_done() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
#endif
}

constexpr int64_t kTableRows = 256;

// Single-buffer dict wire of one shard (ops/buckets.py pack_dict_wire):
// slot[P], occ|flags<<16|cfg<<24 [P], round_id[P], then the table.
template <bool WIDE>
struct DictSource {
  static constexpr bool kDict = true;
  const int32_t* wire;
  int64_t P, W;

  __device__ void head(int64_t s, int64_t p, int32_t& slot, int32_t& rid) const {
    const int32_t* w = wire + s * W;
    slot = w[p];
    rid = w[2 * P + p];
  }

  // Start bringing the lane's request words toward the SM.
  __device__ void prefetch(int64_t s, int64_t p) const { prefetch_l2(wire + s * W + P + p); }

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
  static constexpr bool kDict = false;
  const int32_t* lanes;
  const void* values;
  int64_t P;

  __device__ void head(int64_t s, int64_t p, int32_t& slot, int32_t& rid) const {
    slot = lanes[(s * 6 + 0) * P + p];
    rid = lanes[(s * 6 + 5) * P + p];
  }

  // Start bringing the lane's request words toward the SM.
  __device__ void prefetch(int64_t s, int64_t p) const {
    for (int k = 1; k < 5; ++k) prefetch_l2(lanes + (s * 6 + k) * P + p);
    for (int k = 0; k < 5; ++k)
      prefetch_l2(static_cast<const char*>(values) + ((s * 5 + k) * P + p) * (WIDE ? 8 : 4));
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

// Output of the bucket-rounds kernels (K1, K2) and the compact commit
// (K10): out [S, 4, P] narrow i32 or wide i64 (row0, remaining,
// reset_time, new_expire).  Every lane that reaches a slot is evaluated
// (no first look: rounds.cuh).
template <bool WIDE>
struct BucketOut {
  void* out;
  int64_t P, now;
  static constexpr bool kFirstLook = false;
  static constexpr bool kWide = WIDE;

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

// Evaluate lane q against a hot row (words 0-3, 4-7) and the first half
// of a cold row.
__device__ __forceinline__ void eval_words(int4 h0, int4 h1, int4 c0, const Lane& q,
                                           int64_t now, Eval& e) {
  const int32_t hg[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  const int32_t cg[4] = {c0.x, c0.y, c0.z, c0.w};
  eval_lane(hg, cg, q, now, e);
}

// Table row of `slot` in shard s: an out-of-range slot reads row C - 1,
// as JAX's clamped gather.
__device__ __forceinline__ int64_t table_row(int64_t C, int64_t s, int64_t slot) {
  return s * C + (slot < C ? slot : C - 1);
}

// Gather the rows of `slot` in shard s and evaluate lane q against them.
__device__ __forceinline__ void gather_eval(const int32_t* __restrict__ hot,
                                            const int32_t* __restrict__ cold, int64_t C,
                                            int64_t s, int64_t slot, const Lane& q,
                                            int64_t now, Eval& e) {
  const int64_t row = table_row(C, s, slot);
  // Loads through L2 only: the bucket-rounds kernel rewrites rows that
  // other SMs read after the round's grid barrier.
  const int4* hp = reinterpret_cast<const int4*>(hot + row * 8);
  eval_words(__ldcg(hp), __ldcg(hp + 1), __ldcg(reinterpret_cast<const int4*>(cold + row * 8)),
             q, now, e);
}

// Which rows an evaluated lane writes (bit0 hot, bit1 cold); a lane
// whose slot is out of range drops its write.
__device__ __forceinline__ int32_t write_flag(const Eval& e, int64_t slot, int64_t C) {
  const bool in_table = slot < C;
  return (e.write_hot && in_table ? 1 : 0) | (e.write_cold && in_table ? 2 : 0);
}

// The new rows of an evaluated lane as 16-byte words: the hot row (w0,
// w1), the cold row's limit and duration (w2).
__device__ __forceinline__ void row_words(const Eval& e, int4* w0, int4* w1, int4* w2) {
  *w0 = make_int4(e.hot[0], e.hot[1], e.hot[2], e.hot[3]);
  *w1 = make_int4(e.hot[4], e.hot[5], e.hot[6], e.hot[7]);
  *w2 = make_int4(lo32(e.limit), hi32(e.limit), lo32(e.duration), hi32(e.duration));
}

// Store the rows `flag` names at table row `row` (the cold row's spare
// words zeroed).
__device__ __forceinline__ void store_rows(int32_t* __restrict__ hot,
                                           int32_t* __restrict__ cold, int64_t row,
                                           int32_t flag, int4 w0, int4 w1, int4 w2) {
  if (flag & 1) {
    int4* hp = reinterpret_cast<int4*>(hot + row * 8);
    hp[0] = w0;
    hp[1] = w1;
  }
  if (flag & 2) {
    int4* cp = reinterpret_cast<int4*>(cold + row * 8);
    cp[0] = w2;
    cp[1] = make_int4(0, 0, 0, 0);
  }
}

// The two-launch round of K10 (a compute launch, then a commit launch on
// the same stream).  Compute step of round `round` for lane p of shard
// s: every lane of the round evaluates against the pre-round rows,
// writes its output through `sink` and stages its new rows.  A lane of
// another round stages nothing; in round 0, lanes that no round will
// evaluate (padding) write the all-zero output, as does a lane of the
// round with slot -1.
template <class Source, class Sink>
__device__ __forceinline__ void compute_lane(
    const int32_t* __restrict__ hot, const int32_t* __restrict__ cold, int64_t C,
    const Source& src, const Sink& sink, int64_t s, int64_t p, int64_t P,
    int32_t round, int32_t n_rounds, int64_t now, int32_t* __restrict__ stage) {
  int32_t* st = stage + (s * P + p) * kStageWords;
  int32_t slot, rid;
  src.head(s, p, slot, rid);
  if (rid != round || slot < 0) {
    st[kStageFlag] = 0;
    const bool never_runs = rid < 0 || rid >= n_rounds;
    if (rid == round || (never_runs && round == 0)) sink.zero(s, p);
    return;
  }
  Lane q;
  src.lane(s, p, now, q);
  Eval e;
  gather_eval(hot, cold, C, s, slot, q, now, e);
  sink.evaluated(s, p, q, e);
  const int32_t flag = write_flag(e, slot, C);
  if (flag) {
    int4* sp = reinterpret_cast<int4*>(st);
    row_words(e, sp, sp + 1, sp + 2);
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
  if (tail.x) store_rows(hot, cold, s * C + tail.y, tail.x, sp[0], sp[1], sp[2]);
}

}  // namespace gt
