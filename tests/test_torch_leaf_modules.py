"""The serving tier's leaf modules against the JAX package's, tolerance 0.

`utils/batch_window.py` (the coalescing window), `tracing.py` (spans,
batch traces, the flight-recorder rings and sampling) and
`saturation.py` (phase reservoirs and accumulators) are copies in the
port: the same call sequences must give the same flush partitions, the
same recorded spans and events (seeded span ids; times and thread names
aside) and the same snapshots.  Every wait has its own bound.
"""

import random
import threading
import time

import pytest

from gubernator_tpu import saturation as jsat
from gubernator_tpu import tracing as jtr
from gubernator_tpu.utils.batch_window import BatchWindow as JaxWindow
from gubernator_tpu_torch import saturation as tsat
from gubernator_tpu_torch import tracing as ttr
from gubernator_tpu_torch.utils.batch_window import BatchWindow as TorchWindow


# ---------------------------------------------------------------------
# BatchWindow
# ---------------------------------------------------------------------
def _drive_window(cls, items, limit, weigh=None, stop_early=False):
    """Submit `items` from one thread, wait (bounded) until every item
    was flushed, stop, and return the flushed batches.  The 0.5 s window
    is far longer than the submissions take, so every flush but the
    last is the lane limit's and the last is the window's: the
    partition is deterministic."""
    flushed = []
    lock = threading.Lock()
    n_items = len(items)

    def flush(batch):
        with lock:
            flushed.append(list(batch))

    w = cls(flush, 0.5, limit, weigh=weigh)
    try:
        if stop_early:
            w.stop(timeout_s=5.0)
        for it in items:
            w.submit(it)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            with lock:
                if sum(len(b) for b in flushed) == n_items:
                    break
            time.sleep(0.01)
    finally:
        w.stop(timeout_s=5.0)
    assert not (w._worker is not None and w._worker.is_alive())
    return flushed


@pytest.mark.parametrize("case", ["limit", "weighted", "after_stop"])
def test_batch_window_partitions_match(case):
    """Flushes on the lane limit (weighted or not), the window's wait
    and, after stop(), inline per submission: JAX's partition."""
    if case == "limit":
        items, kw = list(range(23)), dict(limit=5)
    elif case == "weighted":
        rng = random.Random(5)
        items = [rng.randint(1, 9) for _ in range(30)]
        kw = dict(limit=20, weigh=lambda x: x)
    else:
        items, kw = list(range(7)), dict(limit=3, stop_early=True)
    out = {}
    for name, cls in (("jax", JaxWindow), ("torch", TorchWindow)):
        out[name] = _drive_window(cls, items, **kw)
    assert out["torch"] == out["jax"]
    assert [x for b in out["torch"] for x in b] == items
    if case == "limit":
        assert [len(b) for b in out["torch"]] == [5, 5, 5, 5, 3]
    if case == "after_stop":
        assert out["torch"] == [[i] for i in items]


def test_batch_window_flushes_a_partial_batch_after_its_wait():
    for cls in (JaxWindow, TorchWindow):
        got = []
        done = threading.Event()
        w = cls(lambda b: (got.append(list(b)), done.set()), 0.02, 100)
        try:
            t0 = time.monotonic()
            w.submit("a")
            w.submit("b")
            assert done.wait(5.0)
            assert time.monotonic() - t0 >= 0.015
        finally:
            w.stop(timeout_s=5.0)
        assert got == [["a", "b"]]


@pytest.mark.parametrize("adaptive,rate,cap", [(False, 0.0, None), (True, 0.0, None),
                                               (True, 1e6, None), (True, 10.0, 0.001),
                                               (False, 0.0, 0.0002)])
def test_batch_window_effective_wait(adaptive, rate, cap):
    waits = []
    for cls in (JaxWindow, TorchWindow):
        w = cls(lambda b: None, 0.0005, 1000, lazy=True, adaptive=adaptive, cap_s=cap)
        w._rate = rate
        waits.append(w.effective_wait_s())
        w.stop(timeout_s=1.0)
    assert waits[0] == waits[1]


# ---------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------
@pytest.fixture
def traced():
    """Both tracing modules at a seeded sample rate, rings cleared."""
    saved = (jtr.sample_rate(), ttr.sample_rate())
    for mod in (jtr, ttr):
        mod.reset()
    try:
        yield
    finally:
        jtr.set_sample_rate(saved[0])
        ttr.set_sample_rate(saved[1])
        for mod in (jtr, ttr):
            mod.reset()
            mod._tls.rng = None


def _span_shape(s):
    return (s["name"], s["trace_id"], s["span_id"], s["parent_id"],
            [(l["trace_id"], l["span_id"]) for l in s["links"]],
            {k: v for k, v in s["attrs"].items()})


def _trace_script(mod, seed, rate):
    """One seeded sequence of tracing calls: ingress spans (sampled at
    `rate`), a batch trace with window and stage spans, events, a
    traceparent round trip.  Returns what the recorder holds."""
    mod.set_sample_rate(rate)
    mod._tls.rng = random.Random(seed)
    rec = mod.Recorder(span_capacity=16, event_capacity=4, name="t")
    mod.bind_recorder(rec)
    try:
        decisions = []
        links = []
        for i in range(12):
            sp = mod.ingress_span("http", f"/v1/r{i}",
                                  traceparent=None if i % 3 else
                                  "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01")
            decisions.append(bool(sp))
            with sp:
                cur = mod.current()
                if cur is not None:
                    links.append(cur)
            sp.end(status=200)
        bt = mod.new_batch(links)
        if bt is not None:
            mod.record_span("batch.window", bt.ctx, start_ns=1, end_ns=2,
                            links=bt.links, lanes=len(links))
            for stage in ("prepare", "stage", "launch", "fetch", "commit"):
                mod.stage_span(stage, 0.001, bt)
        for k in range(6):
            mod.record_event("note", k=k)
        parsed = mod.parse_traceparent(
            mod.format_traceparent(mod.SpanContext(0xABC, 0xDEF)))
        return (decisions, [_span_shape(s) for s in rec.spans()],
                [(e["kind"], e.get("k")) for e in rec.events()], parsed,
                mod.sampled(), mod.enabled())
    finally:
        mod.bind_recorder(None)


@pytest.mark.parametrize("rate", [0.0, 0.5, 1.0])
def test_tracing_ring_and_sampling_match(traced, rate):
    j = _trace_script(jtr, 17, rate)
    t = _trace_script(ttr, 17, rate)
    assert t == j
    decisions, spans, events = t[0], t[1], t[2]
    if rate == 0.0:
        assert not any(decisions) and spans == []
    if rate == 1.0:
        assert all(decisions)
        # 12 ingress + window + 5 stages = 18 spans in a 16-slot ring:
        # the two oldest are gone.
        assert len(spans) == 16 and spans[-1][0] == "dispatch.commit"
    assert [e[1] for e in events] == [2, 3, 4, 5]  # 4-slot event ring


def test_stage_spans_parent_under_the_batch(traced):
    for mod in (jtr, ttr):
        mod.set_sample_rate(1.0)
        mod._tls.rng = random.Random(3)
        root = mod.ingress_span("grpc", "/v1/x")
        with root:
            links = mod.request_links(object())
        bt = mod.new_batch(links)
        mod.stage_batch_trace(bt)
        assert mod.take_batch_trace() is bt and mod.take_batch_trace() is None
        mod.stage_span("launch", 0.002, bt, fused=1)
        (s,) = [s for s in mod.spans_snapshot(root.ctx.trace_hex)
                if s["name"] == "dispatch.launch"]
        assert s["parent_id"] == bt.ctx.span_hex
        assert s["links"] == [{"trace_id": root.ctx.trace_hex,
                               "span_id": root.ctx.span_hex}]
        assert 1_900_000 <= s["dur_ns"] <= 2_100_000


# ---------------------------------------------------------------------
# saturation
# ---------------------------------------------------------------------
@pytest.fixture
def fresh_saturation():
    for mod in (jsat, tsat):
        mod.reset()
    yield
    for mod in (jsat, tsat):
        mod.reset()


def _saturation_script(mod, seed):
    rng = random.Random(seed)
    for _ in range(3000):  # past the 2048-sample ring
        mod.observe_phase(rng.choice(["batch.window", "dispatch.launch", "custom.phase"]),
                          rng.random() * 0.01)
    for _ in range(50):
        mod.lane_util.add(rng.randint(1, 64), 64)
        mod.observe_queue_depth(rng.randint(0, 5000))
        mod.note_express(rng.choice(["bypass", "windowed", "scalar"]), rng.randint(1, 4))
    return (mod.phase_snapshot(), mod.lane_util.take(), mod.lane_util.take(),
            mod.queue_depth_snapshot(), mod.express_snapshot(), mod.express.take(),
            [mod.percentile(sorted(v), q) for v in ([1, 2, 3, 4], [7], list(range(100)))
             for q in (0.0, 0.5, 0.99, 1.0)])


def test_saturation_reservoirs_match(fresh_saturation):
    j = _saturation_script(jsat, 8)
    t = _saturation_script(tsat, 8)
    assert t == j
    assert t[0]["batch.window"]["n_samples"] <= tsat.PHASE_RING
    assert t[2] == (0, 0, 0)  # take() drained


def test_busy_fraction_matches(fresh_saturation):
    clock = iter([0.0, 2.0, 5.0])
    clock2 = iter([0.0, 2.0, 5.0])
    j = jsat.BusyFraction(time_fn=lambda: next(clock))
    t = tsat.BusyFraction(time_fn=lambda: next(clock2))
    for b in (j, t):
        b.add(0.5)
        b.add(0.25)
    assert t.take() == j.take() == (0.75, 2.0)
    assert t.take() == j.take() == (0.0, 3.0)
