"""The served path's own measurement: the per-request waterfall
(`service.admit`, `batch.window`, `request.flush`, `request.answer`),
the flush's split (`queue.backstop`, `queue.concat`,
`prepare.plan_lock_wait`), each mesh plan's C++ timings (the
`prepare.planner` and `*.table_lock_wait` stages of
`take_pipeline_stats`), the phases' histograms
(`saturation.phase_quantile`) and the profiler ranges `profiling.scope`
opens while a torch profiler runs.  CPU stores; every wait is bounded."""

import ctypes
import json
import threading
import time

import numpy as np
import pytest
import torch

from gubernator_tpu_torch import native, saturation
from gubernator_tpu_torch.config import BehaviorConfig
from gubernator_tpu_torch.parallel.mesh import MeshBucketStore
from gubernator_tpu_torch.service import IngressColumns, ServiceConfig, V1Service
from gubernator_tpu_torch.types import Algorithm
from gubernator_tpu_torch.utils.clock import Clock

NOW = 1_700_000_000_000
LANES = 16  # above the express lane's 4: every request takes the window
LEGS = ("service.admit", "batch.window", "request.flush", "request.answer")


@pytest.fixture
def fresh_saturation():
    saturation.reset()
    yield
    saturation.reset()


def _service(wait_s: float) -> V1Service:
    clock = Clock()
    clock.freeze(NOW)
    return V1Service(ServiceConfig(
        cache_size=8192, clock=clock, device="cpu",
        behaviors=BehaviorConfig(batch_wait_s=wait_s, global_sync_wait_s=3600.0)))


def _cols(tag: str, n: int = LANES) -> IngressColumns:
    return IngressColumns(
        names=["wf"] * n, unique_keys=[f"{tag}_{i}" for i in range(n)],
        algorithm=np.full(n, int(Algorithm.LEAKY_BUCKET), np.int32),
        behavior=np.zeros(n, np.int32), hits=np.ones(n, np.int64),
        limit=np.full(n, 10, np.int64), duration=np.full(n, 5_000, np.int64))


def _call(svc: V1Service, cols: IngressColumns, timeout: float = 30.0) -> float:
    """One async request; the caller's wall time from the call to its
    callback, in s."""
    done = threading.Event()
    got = {}

    def cb(result, exc):
        got["t"] = time.monotonic()
        got["exc"] = exc
        done.set()

    t0 = time.monotonic()
    svc.get_rate_limits_columns_async(cols, cb)
    assert done.wait(timeout), "no answer"
    assert got["exc"] is None, got["exc"]
    return got["t"] - t0


def _sums() -> dict:
    return {p: (saturation.phase_totals(p) or (0, 0.0, 0))[1] for p in LEGS}


def test_async_requests_observe_each_leg_once_and_tile_the_caller_time(fresh_saturation):
    """N async requests give N observations of each leg.  One at a time,
    each request's admit + window + flush + answer lies within the
    caller's wall time and covers at least 90% of it.  The legs follow
    one another but for service.admit's last step: batch.window starts
    at the batcher submit, inside _submit_columns, so the two share the
    time from the submit to _submit_columns' return (microseconds, or
    the GIL's switch interval on a loaded host), which the test stamps
    on both sides and counts once."""
    svc = _service(0.05)
    stamps = {}
    submit, submit_columns = svc.columnar_batcher.submit, svc._submit_columns

    def stamped_submit(*a, **kw):
        fut = submit(*a, **kw)
        stamps["submit"] = fut._submit_t
        return fut

    def stamped_submit_columns(*a, **kw):
        try:
            return submit_columns(*a, **kw)
        finally:
            stamps["returned"] = time.monotonic()

    svc.columnar_batcher.submit = stamped_submit
    svc._submit_columns = stamped_submit_columns
    try:
        n = 12
        for i in range(n):
            before = _sums()
            wall = _call(svc, _cols(f"seq{i}"))
            after = _sums()
            legs = {p: after[p] - before[p] for p in LEGS}
            assert all(v > 0 for v in legs.values()), legs
            total = sum(legs.values()) - (stamps["returned"] - stamps["submit"])
            assert 0.9 * wall <= total <= wall + 2e-4, (i, wall, legs, stamps)
        # Concurrent requests: one observation of each leg per request.
        saturation.reset()
        done, lock, errs = [0], threading.Lock(), []

        def cb(result, exc):
            with lock:
                done[0] += 1
                if exc is not None:
                    errs.append(exc)

        m = 24
        for i in range(m):
            svc.get_rate_limits_columns_async(_cols(f"par{i}"), cb)
        t_end = time.monotonic() + 30
        while done[0] < m and time.monotonic() < t_end:
            time.sleep(0.005)
        assert done[0] == m and not errs
        for p in LEGS:
            assert saturation.phase_totals(p)[0] == m, p
        count, _, lanes = saturation.phase_totals("service.admit")
        assert lanes == m * LANES
    finally:
        svc.close()


def test_queue_wait_is_the_backstop_plus_the_concatenation(fresh_saturation):
    """Each flush chunk observes queue.wait once and its two parts once;
    the parts sum to it (they share their boundary instant)."""
    svc = _service(0.002)
    try:
        for i in range(6):
            _call(svc, _cols(f"q{i}"))
        wait = saturation.phase_totals("queue.wait")
        backstop = saturation.phase_totals("queue.backstop")
        concat = saturation.phase_totals("queue.concat")
        assert wait[0] == backstop[0] == concat[0] >= 6
        assert backstop[1] + concat[1] == pytest.approx(wait[1], rel=1e-9, abs=1e-12)
    finally:
        svc.close()


def _store() -> MeshBucketStore:
    return MeshBucketStore(capacity_per_shard=4096, device="cpu")


def _apply(store: MeshBucketStore, tag: str, n: int = 256):
    cols = _cols(tag, n)
    keys = [f"wf_{k}" for k in cols.unique_keys]
    return store.apply_columns_async(keys, cols.algorithm, cols.behavior, cols.hits,
                                     cols.limit, cols.duration, NOW).result()


def test_planner_counter_counts_each_batch():
    """After a batch take_pipeline_stats reports the plan's C++ timings
    beside the five dispatch stages, whose spans are unchanged: one
    observation per plan and per finish, inside prepare's span."""
    store = _store()
    store.take_pipeline_stats()
    _apply(store, "plan")
    stats, _, _ = store.take_pipeline_stats()
    assert {"prepare", "stage", "launch", "fetch", "commit"} <= set(stats)
    assert stats["prepare.planner"][0] == stats["prepare"][0] == 1
    assert stats["prepare.planner"][1] > 0
    assert stats["prepare.table_lock_wait"][0] == 1
    assert stats["commit.table_lock_wait"][0] == stats["commit"][0] == 1
    assert stats["prepare.plan_lock_wait"][0] == stats["prepare"][0] == 1
    # The planner and the plan-lock wait lie inside prepare's span.
    assert stats["prepare.plan_lock_wait"][1] < stats["prepare"][1]
    assert stats["prepare.planner"][1] < stats["prepare"][1]
    assert stats["prepare.planner"][2] == stats["prepare.planner"][1]  # one plan


def test_planner_stages_are_each_stores_own():
    """Two mesh stores in one process: each store's planner stages count
    only its own plans, so its prepare.planner count is its prepare's."""
    a, b = _store(), _store()
    a.take_pipeline_stats()
    b.take_pipeline_stats()
    for i in range(3):
        _apply(a, f"a{i}")
    _apply(b, "b0")
    sa, _, _ = a.take_pipeline_stats()
    sb, _, _ = b.take_pipeline_stats()
    for stats, plans in ((sa, 3), (sb, 1)):
        assert stats["prepare"][0] == plans
        assert stats["prepare.planner"][0] == plans
        assert stats["prepare.table_lock_wait"][0] == plans
        assert stats["commit.table_lock_wait"][0] == plans
        assert stats["prepare.planner"][1] < stats["prepare"][1]


def _pthread():
    libc = ctypes.CDLL(None)
    libc.pthread_mutex_lock.argtypes = [ctypes.c_void_p]
    libc.pthread_mutex_unlock.argtypes = [ctypes.c_void_p]
    return libc


def test_table_lock_wait_is_counted_only_under_contention(monkeypatch):
    """A plan that finds a shard's table lock held waits, and the wait
    is counted (prepare.table_lock_wait); with nothing else holding the
    locks the waits stay exactly 0.  The test holds the lock through
    the table's mutex, the first member of the C++ Table (a pthread
    mutex under libstdc++)."""
    store = _store()
    _apply(store, "warm")
    store.take_pipeline_stats()
    _apply(store, "quiet")
    stats, _, _ = store.take_pipeline_stats()
    assert stats["prepare.table_lock_wait"] == (1, 0.0, 0.0)
    assert stats["commit.table_lock_wait"] == (1, 0.0, 0.0)

    libc = _pthread()
    table = ctypes.c_void_p(store.tables[0]._ptr)
    out, planning = {}, threading.Event()
    real_plan = native.NativeMeshPlanner.plan_grouped

    def plan_grouped(self, *a):
        planning.set()
        return real_plan(self, *a)

    monkeypatch.setattr(native.NativeMeshPlanner, "plan_grouped", plan_grouped)
    assert libc.pthread_mutex_lock(table) == 0
    try:
        t = threading.Thread(target=lambda: out.setdefault("r", _apply(store, "busy")))
        t.start()
        assert planning.wait(30)
        time.sleep(0.1)  # the plan is blocked on shard 0's lock
    finally:
        assert libc.pthread_mutex_unlock(table) == 0
    t.join(timeout=30)
    assert not t.is_alive() and "r" in out
    stats, _, _ = store.take_pipeline_stats()
    assert stats["prepare.table_lock_wait"][0] == 1
    assert stats["prepare.table_lock_wait"][1] > 0
    # The wait is left out of the planner's own time.
    assert stats["prepare.planner"][1] < stats["prepare.table_lock_wait"][1]


def test_phase_quantile_reads_every_observation(fresh_saturation):
    """The histogram keeps every observation since reset(), far past the
    2,048-sample ring: its p50 and p95 lie within 2% of numpy's."""
    rng = np.random.default_rng(7)
    vals = rng.lognormal(mean=np.log(2e-3), sigma=1.0, size=100_000)
    for v in vals.tolist():
        saturation.observe_phase("test.waterfall", v)
    st = saturation._phases["test.waterfall"]
    assert st.count == len(vals) and len(st._buf) == saturation.PHASE_RING
    for q in (0.5, 0.95):
        want = float(np.percentile(vals, q * 100))
        assert saturation.phase_quantile("test.waterfall", q) == pytest.approx(want, rel=0.02)
    assert saturation.phase_quantile("no.such.phase", 0.95) is None
    assert saturation.phase_totals("no.such.phase") is None


def _user_ranges(path) -> list:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [ev for ev in events
            if ev.get("cat") == "user_annotation" and ev.get("ph") == "X"]


def _inside(a, b) -> bool:
    """Range a lies within range b on one thread."""
    return (a["tid"] == b["tid"] and b["ts"] <= a["ts"]
            and a["ts"] + a["dur"] <= b["ts"] + b["dur"] + 1e-3)


def test_profiler_trace_holds_the_flush_ranges_nested(tmp_path, fresh_saturation):
    """Under a torch profiler of the host (every thread), the exported
    chrome trace holds batcher.flush containing dispatch.prepare
    containing prepare.planner as user_annotation ranges, beside
    service.admit and the flush's queue.backstop and queue.concat."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    svc = _service(0.002)
    try:
        _call(svc, _cols("warm"))
        prof = profile(activities=[ProfilerActivity.CPU],
                       experimental_config=_ExperimentalConfig(profile_all_threads=True))
        prof.start()
        try:
            for i in range(3):
                _call(svc, _cols(f"traced{i}"))
        finally:
            prof.stop()
        path = tmp_path / "trace.json"
        prof.export_chrome_trace(str(path))
    finally:
        svc.close()
    ranges = _user_ranges(path)
    by = {}
    for ev in ranges:
        by.setdefault(ev["name"], []).append(ev)
    for name in ("service.admit", "queue.backstop", "queue.concat",
                 "prepare.plan_lock_wait"):
        assert by.get(name), (name, sorted(by))
    nested = [(f, p, q) for f in by["batcher.flush"] for p in by["dispatch.prepare"]
              for q in by["prepare.planner"] if _inside(p, f) and _inside(q, p)]
    assert len(nested) >= 3


def test_no_profiler_opens_no_range(monkeypatch, fresh_saturation):
    """Without a profiler the scopes never enter record_function; with
    one running they do."""
    import torch.autograd.profiler as ap

    entered = []
    real = ap.record_function

    class Spy(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(ap, "record_function", Spy)
    svc = _service(0.002)
    try:
        for i in range(3):
            _call(svc, _cols(f"off{i}"))
        assert entered == []
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            _call(svc, _cols("on"))
        assert "service.admit" in entered and "batcher.flush" in entered
    finally:
        svc.close()
