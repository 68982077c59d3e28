"""Plain NumPy reference of Gubernator's rate-limit semantics.

This is the benchmark's yardstick for `correct`: the token and leaky
bucket algorithms of the upstream service (algorithms.go), with the
Gregorian intervals of interval.go, applied hit by hit in each key's own
order.  It imports nothing of the program under test: every value the
program derives (Gregorian expiry and duration, the leaky bucket's
fixed-point remainder, created and expiry instants) is worked out again
here from the inputs the benchmark hands both sides.

Keys are independent, so the state machine runs hit by hit along each
key's sequence and vectorised across keys: step j applies the j-th hit of
every key that has one.

Integer widths: every quantity is int64, as the upstream service keeps
it.  `dtype=np.int32` computes the same in 32 bits; it is the control
that must come out as not correct (see control.py).
"""

from __future__ import annotations

import calendar
import datetime as dt
from dataclasses import dataclass

import numpy as np

TOKEN, LEAKY = 0, 1
UNDER, OVER = 0, 1
# Behavior bits (gubernator.proto).
GREGORIAN = 4
RESET_REMAINING = 8
# Gregorian duration enum (interval.go).
G_MINUTES, G_HOURS, G_DAYS, G_WEEKS, G_MONTHS, G_YEARS = range(6)
# The leaky bucket's remainder is kept in units of 2**-20 of a hit, so a
# partial leak is exact in integers (the JAX package and the port alike).
LEAKY_SCALE_BITS = 20


def _utc(ms: int) -> dt.datetime:
    return dt.datetime.fromtimestamp(ms / 1000.0, tz=dt.timezone.utc)


def _secs(d: dt.datetime) -> int:
    return calendar.timegm(d.utctimetuple())


def gregorian(now_ms: int, enum: int) -> "tuple[int, int] | None":
    """(expire_ms, duration) of the Gregorian interval holding `now_ms`,
    or None where the upstream service answers an error (weeks, unknown).

    expire: the next interval boundary less one nanosecond, in whole
    milliseconds.  duration: minutes to days in milliseconds; months and
    years as upstream's GregorianDuration computes them, the end in
    nanoseconds less the beginning in milliseconds (operator precedence
    in interval.go), which the leak rate then uses."""
    now = _utc(now_ms)
    if enum == G_MINUTES:
        begin = now.replace(second=0, microsecond=0)
        end = begin + dt.timedelta(minutes=1)
    elif enum == G_HOURS:
        begin = now.replace(minute=0, second=0, microsecond=0)
        end = begin + dt.timedelta(hours=1)
    elif enum == G_DAYS:
        begin = now.replace(hour=0, minute=0, second=0, microsecond=0)
        end = begin + dt.timedelta(days=1)
    elif enum == G_MONTHS:
        begin = now.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
        y, m = (begin.year + 1, 1) if begin.month == 12 else (begin.year, begin.month + 1)
        end = begin.replace(year=y, month=m)
    elif enum == G_YEARS:
        begin = now.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
        end = begin.replace(year=begin.year + 1)
    else:
        return None
    expire = _secs(end) * 1000 - 1
    fixed = {G_MINUTES: 60_000, G_HOURS: 3_600_000, G_DAYS: 86_400_000}
    if enum in fixed:
        return expire, fixed[enum]
    return expire, (_secs(end) * 1_000_000_000 - 1) - _secs(begin) * 1000


@dataclass
class Hits:
    """One lane per hit, in any order: `key` (a dense id per distinct
    key), `seq` (the hit's place in its key's order, any increasing
    int64), and the request's fields."""

    key: np.ndarray
    seq: np.ndarray
    algorithm: np.ndarray
    behavior: np.ndarray
    hits: np.ndarray
    limit: np.ndarray
    duration: np.ndarray
    now: np.ndarray


@dataclass
class Answers:
    """The expected answer of every lane of a Hits, in its lane order,
    and the state of every key after its last hit (`exists` False where
    the last hit removed the bucket)."""

    status: np.ndarray
    limit: np.ndarray
    remaining: np.ndarray
    reset_time: np.ndarray
    state: dict


STATE_FIELDS = ("exists", "algorithm", "status", "limit", "remaining", "duration",
                "stamp", "expire_at")


def _resolve_gregorian(h: Hits) -> "tuple[np.ndarray, np.ndarray]":
    """Per lane (expire, duration) of its Gregorian interval (0 for lanes
    without the behavior); raises on an interval upstream rejects."""
    ge = np.zeros(len(h.key), np.int64)
    gd = np.zeros(len(h.key), np.int64)
    greg = (h.behavior & GREGORIAN) != 0
    if greg.any():
        # One (instant, interval) pair per distinct value of now * 8 + enum.
        pair = np.where(greg, h.now * 8 + h.duration, -1)
        vals, inv = np.unique(pair, return_inverse=True)
        for j, v in enumerate(vals.tolist()):
            if v < 0:
                continue
            got = gregorian(v // 8, v % 8)
            if got is None:
                raise ValueError(f"Gregorian duration {v % 8} is not supported")
            sel = inv == j
            ge[sel], gd[sel] = got
    return ge, gd


def _leak(elapsed, limit, rate, scale):
    """(whole, fraction) of elapsed * limit / rate hits, the fraction in
    units of 1/scale, exact (Python integers where int64 would wrap)."""
    whole = np.zeros(len(elapsed), np.int64)
    frac = np.zeros(len(elapsed), np.int64)
    for i in np.nonzero(elapsed > 0)[0].tolist():
        p = int(elapsed[i]) * int(limit[i])
        r = int(rate[i])
        whole[i] = p // r
        frac[i] = (p % r) * scale // r
    return whole, frac


def _step(st, k, q, scale, wrap):
    """Apply one hit to each key in `k` (dense ids, distinct) with the
    request columns `q`; returns the answers and updates `st` in place."""
    g = {f: st[f][k] for f in STATE_FIELDS}
    a, beh, hits, lim = q["algorithm"], q["behavior"], q["hits"], q["limit"]
    dur, now, ge, gd = q["duration"], q["now"], q["ge"], q["gd"]
    greg = (beh & GREGORIAN) != 0
    reset_b = (beh & RESET_REMAINING) != 0
    is_tok = a == TOKEN
    live = g["exists"] & (g["expire_at"] >= now)
    same = live & (g["algorithm"] == a)
    do_hit = hits > 0

    # token bucket
    tok_reset = live & is_tok & reset_b
    dur_changed = g["duration"] != dur
    exp_cfg = np.where(greg, ge, g["stamp"] + dur)
    tok_exist = same & is_tok & ~reset_b & ~(dur_changed & (exp_cfg < now))
    t_exp = np.where(dur_changed, exp_cfg, g["expire_at"])
    t_rem0 = np.maximum(g["remaining"] + (lim - g["limit"]), 0)
    t_take = do_hit & (hits <= t_rem0)
    t_rem1 = np.where(t_take, t_rem0 - hits, t_rem0)
    t_status = np.where(do_hit & ((t_rem0 == 0) | (hits > t_rem0)), OVER, g["status"])
    t_store_status = np.where(do_hit & (t_rem0 == 0), OVER, g["status"])
    c_exp = np.where(greg, ge, now + dur)
    c_over = hits > lim
    c_rem = np.where(c_over, lim, lim - hits)

    # leaky bucket
    lky_exist = same & ~is_tok
    rate = np.where(greg, gd, dur)
    dur_eff = np.where(greg, ge - now, dur)
    lim1 = np.maximum(lim, 1)
    rn = np.maximum(rate, 1)
    l_rem = np.where(reset_b, lim * scale, g["remaining"])
    el = np.where(lky_exist, np.minimum(np.maximum(now - g["stamp"], 0), rn), 0)
    whole, frac = _leak(el, np.maximum(lim, 0), rn, scale)
    leaked = whole > 0
    l_rem = np.where(leaked, l_rem + whole * scale + frac, l_rem)
    l_stamp = np.where(leaked, now, g["stamp"])
    l_rem = np.where(l_rem // scale > lim, lim * scale, l_rem)
    rem_int = l_rem // scale
    at_zero = rem_int == 0
    exact = ~at_zero & (rem_int == hits)
    overflow = ~at_zero & ~exact & (hits > rem_int)
    take = exact | (~at_zero & ~overflow & do_hit)
    l_rem_f = np.where(take, l_rem - hits * scale, l_rem)
    l_resp = np.where(exact, 0, np.where(take, l_rem_f // scale, rem_int))
    l_status = np.where(at_zero | overflow, OVER, UNDER)
    l_exp = np.where(take & ~exact, now + dur_eff, g["expire_at"])
    lc_take = do_hit & (hits <= lim)
    lc_over_all = hits > lim
    lc_rem = np.where(lc_over_all, 0, (lim - hits * lc_take) * scale)
    lc_resp = np.where(lc_take, lim - hits, np.where(lc_over_all, 0, lim))

    def pick(tr, te, tc, le, lc):
        return np.where(is_tok, np.where(tok_reset, tr, np.where(tok_exist, te, tc)),
                        np.where(lky_exist, le, lc))

    status = pick(UNDER, t_status, np.where(c_over, OVER, UNDER), l_status,
                  np.where(lc_over_all, OVER, UNDER))
    remaining = pick(lim, t_rem1, c_rem, l_resp, lc_resp)
    reset_time = pick(0, t_exp, c_exp, now + rate // lim1, now + dur_eff // lim1)

    new = {
        "exists": ~(is_tok & tok_reset),
        "algorithm": a,
        "status": pick(UNDER, t_store_status, UNDER, UNDER, UNDER),
        "limit": lim,
        "remaining": pick(0, t_rem1, c_rem, l_rem_f, lc_rem),
        "duration": pick(0, g["duration"], dur, dur, dur_eff),
        "stamp": pick(0, g["stamp"], now, l_stamp, now),
        "expire_at": pick(0, t_exp, c_exp, l_exp, now + dur_eff),
    }
    for f, v in new.items():
        st[f][k] = wrap(v) if f != "exists" else v
    return status, wrap(remaining), wrap(reset_time)


def evaluate(h: Hits, dtype=np.int64) -> Answers:
    """Every lane's answer and each key's final state, applying each
    key's hits in `seq` order from an empty table (a key absent from
    the table is created by its first hit)."""
    n = len(h.key)
    ge, gd = _resolve_gregorian(h)
    if dtype == np.int64:
        def wrap(v):
            return np.asarray(v, np.int64)
    else:
        bits = np.iinfo(dtype).bits

        def wrap(v):  # two's-complement wrap to the narrower width
            return np.asarray(v, np.int64).astype(dtype).astype(np.int64)
    scale = np.int64(1) << LEAKY_SCALE_BITS
    if dtype != np.int64 and bits < 64:
        ge, gd = wrap(ge), wrap(gd)
    cols = {"algorithm": h.algorithm, "behavior": h.behavior, "hits": h.hits,
            "limit": h.limit, "duration": h.duration, "now": h.now, "ge": ge, "gd": gd}
    cols = {f: np.asarray(v, np.int64) for f, v in cols.items()}
    cols = {f: (wrap(v) if f in ("limit", "now", "ge", "gd", "duration") else v)
            for f, v in cols.items()}
    order = np.lexsort((h.seq, h.key))
    keys_sorted = h.key[order]
    n_keys = int(h.key.max()) + 1 if n else 0
    starts = np.searchsorted(keys_sorted, np.arange(n_keys))
    counts = np.bincount(keys_sorted, minlength=n_keys)
    st = {f: np.zeros(n_keys, bool if f == "exists" else np.int64) for f in STATE_FIELDS}
    out = {f: np.zeros(n, np.int64) for f in ("status", "limit", "remaining", "reset_time")}
    alive = np.nonzero(counts > 0)[0]
    j = 0
    while alive.size:
        lanes = order[starts[alive] + j]
        q = {f: v[lanes] for f, v in cols.items()}
        status, remaining, reset_time = _step(st, alive, q, scale, wrap)
        out["status"][lanes] = status
        out["limit"][lanes] = q["limit"]
        out["remaining"][lanes] = remaining
        out["reset_time"][lanes] = reset_time
        j += 1
        alive = alive[counts[alive] > j]
    return Answers(status=out["status"], limit=out["limit"], remaining=out["remaining"],
                   reset_time=out["reset_time"], state=st)
