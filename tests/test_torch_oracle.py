"""The port's plain bucket evaluation against the sequential oracle.

The cases tests/test_algorithms.py pins (expiry at the exact ms, a
non-representable leaky rate, a huge limit, duplicate keys in a batch,
padding lanes, algorithm switches, RESET_REMAINING, Gregorian
durations) run through a port ShardStore on the CPU, whose columnar
launches reach `bucket_rounds_dict_plain` (the dict wire, K1's plain
version) or, with the wide wire forced, `bucket_rounds_cols_plain`
(K2's).  Every lane's answer must equal tests/oracle.py's, applied lane
by lane in order (tolerance 0), except where test_algorithms pins the
kernel's exact integer leak against the oracle's float64 one: there the
port must give the pinned exact value and stay within one token of the
oracle.
"""

import random

import numpy as np
import pytest

from gubernator_tpu.types import RateLimitRequest as JaxRequest
from gubernator_tpu_torch.models.shard import GregResolver, ShardStore
from gubernator_tpu_torch.ops import buckets
from gubernator_tpu_torch.types import Algorithm, Behavior, has_behavior
from gubernator_tpu_torch.utils import gregorian

from . import oracle

T0 = 1_573_430_430_000  # 2019-11-11T00:00:30Z
SECOND = 1000
TOKEN, LEAKY = int(Algorithm.TOKEN_BUCKET), int(Algorithm.LEAKY_BUCKET)
RESET, GREG = int(Behavior.RESET_REMAINING), int(Behavior.DURATION_IS_GREGORIAN)


def mk(name="t", key="account:1234", hits=1, limit=10, duration=SECOND, algo=TOKEN,
       behavior=0):
    return JaxRequest(name=name, unique_key=key, hits=hits, limit=limit,
                      duration=duration, algorithm=algo, behavior=behavior)


class Runner:
    """A port ShardStore beside an oracle cache; `batch` sends one
    columnar batch through the chosen wire and returns the port's
    (status, limit, remaining, reset_time) and the oracle's per lane."""

    def __init__(self, wire, monkeypatch, capacity=64):
        self.store = ShardStore(capacity=capacity, device="cpu")
        self.cache = oracle.OracleCache()
        self.wire = wire
        self.calls = {"dict": 0, "cols": 0}
        for name, kind in (("bucket_rounds_dict_plain", "dict"),
                           ("bucket_rounds_cols_plain", "cols")):
            fn = getattr(buckets, name)

            def counted(*a, _fn=fn, _kind=kind, **kw):
                self.calls[_kind] += 1
                return _fn(*a, **kw)

            monkeypatch.setattr(buckets, name, counted)

    def batch(self, reqs, now):
        n = len(reqs)
        ge = np.zeros(n, np.int64)
        gd = np.zeros(n, np.int64)
        resolver = GregResolver(now)
        for i, r in enumerate(reqs):
            if has_behavior(r.behavior, Behavior.DURATION_IS_GREGORIAN):
                got = resolver.resolve(int(r.duration))
                assert not isinstance(got, gregorian.GregorianError)
                ge[i], gd[i] = got
        out = self.store.apply_columns(
            [r.hash_key() for r in reqs],
            np.array([r.algorithm for r in reqs], np.int32),
            np.array([r.behavior for r in reqs], np.int32),
            np.array([r.hits for r in reqs], np.int64),
            np.array([r.limit for r in reqs], np.int64),
            np.array([r.duration for r in reqs], np.int64),
            now, ge, gd, force_wire=None if self.wire == "dict" else "wide")
        got = [tuple(int(out[f][i]) for f in ("status", "limit", "remaining", "reset_time"))
               for i in range(n)]
        want = []
        for r in reqs:
            w = oracle.apply(self.cache, r, now)
            want.append((int(w.status), int(w.limit), int(w.remaining), int(w.reset_time)))
        return got, want

    def same(self, reqs, now):
        got, want = self.batch(reqs, now)
        assert got == want, (reqs, got, want)
        return got


def _expiry_exact_ms(run):
    run.same([mk(name="edge", hits=2, limit=2)], T0)
    got = run.same([mk(name="edge", hits=1, limit=2)], T0 + 1000)  # now == ExpireAt
    assert got[0][0] == 1  # OVER_LIMIT: still the drained bucket
    got = run.same([mk(name="edge", hits=1, limit=2)], T0 + 1001)
    assert got[0][0] == 0 and got[0][2] == 1


def _nonrepresentable_leaky_rate(run):
    req = mk(name="nr", hits=30, limit=30, algo=LEAKY)
    run.same([req], T0)
    got, want = run.batch([mk(name="nr", hits=0, limit=30, algo=LEAKY)], T0 + 500)
    # Exact leak 500*30/1000 = 15; the oracle's float64 path gives 14.
    assert got[0][2] == 15 and want[0][2] == 14
    assert got[0][:2] == want[0][:2]


def _huge_limit(run):
    month = 30 * 24 * 3600 * 1000
    big = 2**42
    run.same([mk(name="huge", hits=big, limit=big, duration=month, algo=LEAKY)], T0)
    got, want = run.batch([mk(name="huge", hits=0, limit=big, duration=month, algo=LEAKY)],
                          T0 + month // 2)
    # elapsed * limit overflows int64: the 128-bit muldiv keeps it exact.
    assert got[0][2] == big // 2
    assert got[0][:2] == want[0][:2] and abs(got[0][2] - want[0][2]) <= 1


def _duplicate_keys(run):
    got = run.same([mk(name="dup", hits=3, limit=10, duration=9000) for _ in range(4)], T0)
    assert [g[2] for g in got] == [7, 4, 1, 1]


def _padding_lanes(run):
    for key in ("K0", "K1", "K0"):
        run.same([mk(name="p", key=key, hits=1, limit=10, duration=9000)], T0)
    got = run.same([mk(name="p", key="K1", hits=1, limit=10, duration=9000)], T0)
    assert got[0][2] == 8


def _algorithm_switches(run):
    rng = random.Random(99)
    now = T0
    for _ in range(120):
        reqs = [mk(name="sw", key=f"k{rng.randrange(4)}", hits=rng.choice([0, 1, 2]),
                   limit=rng.choice([10, 10, 100, 200]), duration=5000,
                   algo=rng.choice([TOKEN, LEAKY]))
                for _ in range(rng.choice([1, 1, 3]))]
        run.same(reqs, now)
        now += rng.choice([0, 3, 50, 700])


def _reset_remaining(run):
    want = [99, 98, 100, 99]
    for behavior, remaining in zip([0, 0, RESET, 0], want):
        got = run.same([mk(name="rr", limit=100, duration=9000, behavior=behavior)], T0)
        assert got[0][2] == remaining
    # A RESET lane and a plain lane of one key in one batch.
    run.same([mk(name="rr", limit=100, duration=9000, behavior=RESET),
              mk(name="rr", hits=5, limit=100, duration=9000)], T0 + 10)


def _gregorian(run):
    now = T0
    for hits, sleep in ((1, 0), (1, 0), (58, 0), (1, 61 * SECOND), (0, 0)):
        run.same([mk(name="greg", key="account:12345", hits=hits, limit=60,
                     duration=gregorian.GREGORIAN_MINUTES, behavior=GREG)], now)
        now += sleep
    now = T0
    for hits, sleep in ((1, 500), (1, SECOND), (1, 0)):
        run.same([mk(name="gregl", key="account:12345", hits=hits, limit=60,
                     duration=gregorian.GREGORIAN_MINUTES, algo=LEAKY, behavior=GREG)], now)
        now += sleep


CASES = {
    "expiry_exact_ms": _expiry_exact_ms,
    "nonrepresentable_leaky_rate": _nonrepresentable_leaky_rate,
    "huge_limit": _huge_limit,
    "duplicate_keys": _duplicate_keys,
    "padding_lanes": _padding_lanes,
    "algorithm_switches": _algorithm_switches,
    "reset_remaining": _reset_remaining,
    "gregorian": _gregorian,
}


@pytest.mark.parametrize("wire", ["dict", "cols"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_rounds_match_the_oracle(case, wire, monkeypatch):
    run = Runner(wire, monkeypatch, capacity=2 if case == "padding_lanes" else 64)
    CASES[case](run)
    # Every launch of the case reached the wire's plain version.
    other = "cols" if wire == "dict" else "dict"
    assert run.calls[wire] > 0 and run.calls[other] == 0, run.calls
