"""The plain reference against the port on the CPU: whole tiny runs of
each traffic mix, and request by request over the semantics the
reference covers beyond the mixes (clock advance, hits 0 to 5, limit and
algorithm changes, RESET_REMAINING, every Gregorian interval)."""

import datetime as dt
import time

import numpy as np
import pytest

from portbench import bench, reference
from portbench.tests import tiny


@pytest.mark.parametrize("entry", ["json", "columns"])
@pytest.mark.parametrize("mix", tiny.MIXES)
def test_port_matches_reference(mix, entry):
    config, m = tiny.cell(mix)
    m["entry"] = entry
    w, check, _ = bench.run_cell({"name": mix}, config, m, 2**31 + 7, 1.0, False,
                                 device="cpu", t_start=time.perf_counter(), log=lambda *a: None)
    assert w.lanes > 0 and w.requests > 0 and w.failed == 0
    assert check.correct, check.numbers
    # The clock moved inside the window, and hot keys went over their limit.
    assert w.clock_moves > 0 and w.over_lanes > 0


def _service(now):
    from gubernator_tpu_torch.service import ServiceConfig, V1Service
    from gubernator_tpu_torch.utils.clock import Clock

    clock = Clock()
    clock.freeze(now)
    return V1Service(ServiceConfig(cache_size=4096, clock=clock, device="cpu")), clock


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_semantics_request_by_request(seed):
    from gubernator_tpu_torch.service import IngressColumns

    rng = np.random.default_rng(seed)
    now = 1_700_000_000_000 + int(rng.integers(0, 400)) * 86_400_000
    svc, clock = _service(now)
    lanes = {f: [] for f in ("key", "algorithm", "behavior", "hits", "limit", "duration", "now")}
    got = {f: [] for f in ("status", "limit", "remaining", "reset_time")}
    try:
        for _ in range(150):
            clock.advance(int(rng.choice([0, 0, 7, 500, 3_000, 70_000])))
            n = int(rng.integers(2, 7))
            key = rng.integers(0, 10, n)
            greg = rng.random(n) < 0.3
            algo = rng.integers(0, 2, n)
            duration = np.where(greg, rng.choice([0, 1, 2, 4, 5], n),
                                rng.choice([1_000, 60_000, 3_600_000], n))
            beh = np.where(greg, 4, 0) | np.where(rng.random(n) < 0.05, 8, 0)
            hits = rng.choice([0, 1, 1, 1, 2, 5], n)
            limit = rng.choice([3, 5, 10, 1_000_000], n)
            cols = IngressColumns(
                names=["t"] * n, unique_keys=[str(k) for k in key],
                algorithm=algo.astype(np.int32), behavior=beh.astype(np.int32),
                hits=hits.astype(np.int64), limit=limit.astype(np.int64),
                duration=duration.astype(np.int64))
            res = svc.get_rate_limits_columns(cols)
            assert not res.overrides
            for f in got:
                got[f].append(np.asarray(getattr(res, f), np.int64))
            for f, v in (("key", key), ("algorithm", algo), ("behavior", beh), ("hits", hits),
                         ("limit", limit), ("duration", duration),
                         ("now", np.full(n, clock.now_ms()))):
                lanes[f].append(np.asarray(v, np.int64))
    finally:
        svc.close()
    cat = {f: np.concatenate(v) for f, v in lanes.items()}
    want = reference.evaluate(reference.Hits(seq=np.arange(len(cat["key"])), **cat))
    for f in got:
        assert np.array_equal(np.concatenate(got[f]), getattr(want, f)), f


def test_gregorian_matches_the_port():
    from gubernator_tpu_torch.utils import gregorian as port

    rng = np.random.default_rng(5)
    for ms in rng.integers(1_600_000_000_000, 1_800_000_000_000, 200).tolist():
        now = dt.datetime.fromtimestamp(ms / 1000.0, tz=dt.timezone.utc)
        for enum in (0, 1, 2, 4, 5):
            assert reference.gregorian(ms, enum) == (port.gregorian_expiration(now, enum),
                                                      port.gregorian_duration(now, enum))
    assert reference.gregorian(1_700_000_000_000, 3) is None  # weeks: an error upstream


def test_reference_answers_a_hand_worked_leaky_sequence():
    # limit 4 an hour: 900,000 ms a hit leaks back; three hits, then
    # 450,000 ms later half a hit has leaked (remaining stays 1).
    now = 1_700_000_000_000
    h = reference.Hits(key=np.zeros(4, np.int64), seq=np.arange(4),
                       algorithm=np.ones(4, np.int64), behavior=np.zeros(4, np.int64),
                       hits=np.array([1, 1, 1, 0]), limit=np.full(4, 4),
                       duration=np.full(4, 3_600_000),
                       now=np.array([now, now, now, now + 450_000]))
    a = reference.evaluate(h)
    assert a.remaining.tolist() == [3, 2, 1, 1]
    assert a.state["remaining"][0] == 1 * (1 << 20)  # no whole hit leaked: untouched
