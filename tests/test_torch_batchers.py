"""The port's serving tier (batchers, express lane, ingress gate, async
columns path, tracing) against the JAX V1Service, tolerance 0.

Both services own every key (the JAX one is its ring's only peer), run
on frozen clocks and the CPU, and get the same BehaviorConfig.
Concurrent callers own disjoint keys, so each caller's answers do not
depend on how a window coalesced the requests: they must be the JAX
service's, and so must the final per-key state.  Every wait has a bound
(futures, events and joins time out) and every service is closed in a
`finally`.
"""

import threading

import numpy as np
import pytest

from gubernator_tpu import saturation as jsat
from gubernator_tpu import tracing as jtr
from gubernator_tpu.config import BehaviorConfig as JaxBehaviors
from gubernator_tpu.service import IngressColumns as JaxColumns
from gubernator_tpu.service import ServiceConfig as JaxConfig
from gubernator_tpu.service import V1Service as JaxService
from gubernator_tpu.types import GetRateLimitsRequest as JaxRequests
from gubernator_tpu.types import PeerInfo
from gubernator_tpu.types import RateLimitRequest as JaxRequest
from gubernator_tpu.utils.clock import Clock as JaxClock
from gubernator_tpu_torch import saturation as tsat
from gubernator_tpu_torch import tracing as ttr
from gubernator_tpu_torch.config import BehaviorConfig
from gubernator_tpu_torch.service import (
    IngressColumns,
    IngressShedError,
    ServiceConfig,
    V1Service,
)
from gubernator_tpu_torch.types import Behavior, GetRateLimitsRequest, RateLimitRequest
from gubernator_tpu_torch.utils.clock import Clock

NOW = 1_573_430_400_000
G, NB = int(Behavior.GLOBAL), int(Behavior.NO_BATCHING)
WAIT_S = 30.0  # bound of every wait on a callback or a thread


class Pair:
    """A JAX and a port service on the same behaviors (close() both)."""

    def __init__(self, cache=4096, **beh):
        beh.setdefault("global_sync_wait_s", 3600.0)
        self.jclock, self.tclock = JaxClock(), Clock()
        self.jclock.freeze(NOW)
        self.tclock.freeze(NOW)
        self.j = JaxService(JaxConfig(cache_size=cache, clock=self.jclock,
                                      behaviors=JaxBehaviors(**beh),
                                      advertise_address="127.0.0.1:9999"))
        self.j.set_peers([PeerInfo(grpc_address="127.0.0.1:9999", is_owner=True)])
        self.t = V1Service(ServiceConfig(cache_size=cache, clock=self.tclock, device="cpu",
                                         behaviors=BehaviorConfig(**beh)))

    def sides(self):
        return (("jax", self.j, JaxColumns, JaxRequest, JaxRequests),
                ("torch", self.t, IngressColumns, RateLimitRequest, GetRateLimitsRequest))

    def advance(self, ms):
        self.jclock.advance(ms)
        self.tclock.advance(ms)

    def close(self):
        try:
            self.j.close()
        finally:
            self.t.close()


@pytest.fixture
def pair_factory():
    made = []

    def make(**kw):
        p = Pair(**kw)
        made.append(p)
        return p

    try:
        yield make
    finally:
        for p in made:
            p.close()


def _resps(res, n):
    return [_key(res.response_at(i)) for i in range(n)]


def _key(r):
    return (r.status, r.limit, r.remaining, r.reset_time, r.error)


def _cols(names, keys, algo, beh, hits, limit, duration):
    n = len(keys)
    return dict(
        names=list(names) if not isinstance(names, str) else [names] * n,
        unique_keys=list(keys),
        algorithm=np.broadcast_to(np.asarray(algo, np.int32), (n,)).copy(),
        behavior=np.broadcast_to(np.asarray(beh, np.int32), (n,)).copy(),
        hits=np.broadcast_to(np.asarray(hits, np.int64), (n,)).copy(),
        limit=np.broadcast_to(np.asarray(limit, np.int64), (n,)).copy(),
        duration=np.broadcast_to(np.asarray(duration, np.int64), (n,)).copy(),
    )


def _call(svc, Cols, cols, mode):
    """One column request, sync or async (bounded wait); the answers."""
    n = len(cols["names"])
    if mode == "sync":
        return _resps(svc.get_rate_limits_columns(Cols(**cols)), n)
    box, done = [], threading.Event()
    svc.get_rate_limits_columns_async(Cols(**cols),
                                      lambda r, e: (box.append((r, e)), done.set()))
    assert done.wait(WAIT_S), "async callback never fired"
    res, exc = box[0]
    assert exc is None, exc
    return _resps(res, n)


def _caller_script(c, steps, rng_seed):
    """Caller c's requests: column requests of 1-60 lanes over its own
    Zipf keys (some NO_BATCHING, some 1-4 lanes for the express lane)."""
    rng = np.random.default_rng(rng_seed + c)
    out = []
    for _ in range(steps):
        n = int(rng.choice([1, 2, 4, 12, 60]))
        keys = [f"c{c}_{int(k) % 40}" for k in rng.zipf(1.4, n)]
        beh = np.where(rng.random(n) < 0.2, NB, 0)
        out.append(_cols("callers", keys, rng.integers(0, 2, n), beh,
                         rng.integers(0, 3, n), rng.choice([8, 50], n), 60_000))
    return out


def _state(store):
    cols = store.snapshot_columns(NOW)
    return {k: tuple(int(np.asarray(getattr(cols, f))[i]) for f in
                     ("algorithm", "status", "limit", "remaining", "duration", "stamp",
                      "expire_at"))
            for i, k in enumerate(cols.keys)}


@pytest.mark.parametrize("mode", ["sync", "async", "mixed"])
def test_concurrent_disjoint_callers(pair_factory, mode):
    p = pair_factory()
    callers, steps = 8, 10
    scripts = [_caller_script(c, steps, 100) for c in range(callers)]
    answers = {}
    for name, svc, Cols, _, _ in p.sides():
        got = [None] * callers
        errors = []

        def run(c):
            try:
                m = mode if mode != "mixed" else ("sync" if c % 2 else "async")
                got[c] = [_call(svc, Cols, cols, m) for cols in scripts[c]]
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(c,)) for c in range(callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S * 4)
        assert not any(t.is_alive() for t in threads), "a caller hung"
        assert not errors, errors
        answers[name] = got
    assert answers["torch"] == answers["jax"]
    assert _state(p.t.store) == _state(p.j.store)


@pytest.mark.parametrize("express", [True, False])
def test_no_batching_and_express(pair_factory, express):
    """1- and 4-lane requests, NO_BATCHING and BATCHING, sequentially: a
    shallow queue's BATCHING request takes the express bypass (the
    port's CPU store answers it from the host slot), NO_BATCHING
    launches at once; both give the JAX service's answers."""
    p = pair_factory(express=express)
    for mod in (jsat, tsat):
        mod.reset()
    rng = np.random.default_rng(7)
    for step in range(40):
        n = int(rng.choice([1, 4]))
        beh = NB if step % 2 else 0
        cols = _cols("ex", [f"e{int(k)}" for k in rng.integers(0, 6, n)],
                     rng.integers(0, 2, n), beh, 1, 12, 30_000)
        want = _call(p.j, JaxColumns, cols, "sync" if step % 3 else "async")
        got = _call(p.t, IngressColumns, cols, "sync" if step % 3 else "async")
        assert got == want, step
        p.advance(int(rng.choice([0, 500])))
    tx, jx = tsat.express_snapshot(), jsat.express_snapshot()
    assert tx["lanes"]["bypass"] == jx["lanes"]["bypass"]
    assert (tx["lanes"]["bypass"] > 0) == express
    assert p.t.store.scalar_applies == p.j.store.scalar_applies
    assert (p.t.store.scalar_applies > 0) == express


def test_single_lane_requests_coalesce_and_answer_as_jax(pair_factory):
    """Single-lane dataclass requests from 16 threads at once (the
    columnar window for plain lanes, the LocalBatcher for GLOBAL ones)."""
    p = pair_factory(express=False)
    answers = {}
    for name, svc, _, Req, Reqs in p.sides():
        got = [None] * 16

        def run(c):
            got[c] = []
            for k in range(6):
                beh = G if c % 4 == 0 else 0
                r = Req(name="one", unique_key=f"s{c}_{k % 3}", hits=1, limit=5,
                        duration=60_000, algorithm=c % 2, behavior=beh)
                resp = svc.get_rate_limits(Reqs(requests=[r])).responses[0]
                got[c].append(_key(resp))

        threads = [threading.Thread(target=run, args=(c,)) for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S * 2)
        assert not any(t.is_alive() for t in threads)
        answers[name] = got
    assert answers["torch"] == answers["jax"]
    assert p.t.global_mgr.run_once() == p.j.global_mgr.run_once()
    for a, b in zip(p.j.store.gcols, p.t.store.gcols):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_ingress_shed_at_a_small_queue(pair_factory):
    """GUBER_INGRESS_QUEUE_LANES=10, express off, a 0.3 s window: three
    async 6-lane requests back to back; the first is admitted, the next
    two shed with the JAX service's per-lane error text."""
    p = pair_factory(ingress_queue_lanes=10, express=False, batch_wait_s=0.3)
    results = {}
    for name, svc, Cols, _, _ in p.sides():
        boxes = [[] for _ in range(3)]
        events = [threading.Event() for _ in range(3)]
        for i in range(3):
            cols = _cols("shed", [f"q{i}_{k}" for k in range(6)], 0, 0, 1, 5, 60_000)
            svc.get_rate_limits_columns_async(
                Cols(**cols), lambda r, e, i=i: (boxes[i].append((r, e)), events[i].set()))
        assert all(ev.wait(WAIT_S) for ev in events)
        results[name] = [_resps(b[0][0], 6) for b in boxes]
        results[name + "_shed"] = svc.debug_status()["ingress"]["shedLanes"]
    assert results["torch"] == results["jax"]
    assert results["torch_shed"] == results["jax_shed"] == 12
    assert not results["torch"][0][0][4]
    assert "ingress queue saturated (6 lanes queued, cap 10)" in results["torch"][1][0][4]
    assert IngressShedError(6, 10).http_status == 429


def test_close_drains_the_windows(pair_factory):
    """Requests waiting in a 1 s window when close() runs are flushed and
    answered (not dropped); a request after close gets the JAX service's
    closed-batcher error per lane."""
    p = pair_factory(express=False, batch_wait_s=1.0)
    results = {}
    for name, svc, Cols, _, _ in p.sides():
        boxes = [[] for _ in range(3)]
        events = [threading.Event() for _ in range(3)]
        for i in range(3):
            cols = _cols("drain", [f"d{i}_{k}" for k in range(5)], 0, 0, 2, 9, 60_000)
            svc.get_rate_limits_columns_async(
                Cols(**cols), lambda r, e, i=i: (boxes[i].append((r, e)), events[i].set()))
        svc.close()
        assert all(ev.wait(WAIT_S) for ev in events)
        assert all(b[0][1] is None for b in boxes)
        after = _resps(svc.get_rate_limits_columns(
            Cols(**_cols("drain", ["late1", "late2"], 0, 0, 1, 9, 60_000))), 2)
        results[name] = ([_resps(b[0][0], 5) for b in boxes], after)
    assert results["torch"] == results["jax"]
    assert results["torch"][0][0][0] == (0, 9, 7, NOW + 60_000, "")
    assert "local batcher is closed" in results["torch"][1][0][4]


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_global_and_batched_lanes_share_a_key(pair_factory, mode):
    """A column request with GLOBAL lanes and more than four batched
    lanes, one key in both groups.  The batched lanes wait out the
    window (no express bypass at this width); the GLOBAL lanes' route
    runs store.apply at once, so they evaluate first.  A 50 ms window
    keeps that order whatever the host's scheduling; the answers, the
    replica columns and the sync must be the JAX service's."""
    p = pair_factory(batch_wait_s=0.05)
    rng = np.random.default_rng(21)
    for step in range(6):
        n = 11
        keys = ["shared"] + [f"b{int(k)}" for k in rng.integers(0, 6, n - 4)] + \
            ["shared", "g1", "g2"]
        beh = np.array([0] * (n - 3) + [G, G, G | NB], np.int32)
        cols = _cols("mix", keys, rng.integers(0, 2, n), beh, rng.integers(1, 3, n),
                     20, 30_000)
        assert (beh == 0).sum() > 4
        want = _call(p.j, JaxColumns, cols, mode)
        got = _call(p.t, IngressColumns, cols, mode)
        assert got == want, step
        assert p.t.global_mgr.run_once() == p.j.global_mgr.run_once()
        for a, b in zip(p.j.store.gcols, p.t.store.gcols):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        p.advance(400)
    reqs = [dict(name="mix", unique_key=k, hits=1, limit=20, duration=30_000,
                 algorithm=0, behavior=b) for k, b in (("shared", 0), ("shared", G))]
    want = [_key(r) for r in p.j.get_rate_limits(
        JaxRequests(requests=[JaxRequest(**r) for r in reqs])).responses]
    got = [_key(r) for r in p.t.get_rate_limits(
        GetRateLimitsRequest(requests=[RateLimitRequest(**r) for r in reqs])).responses]
    assert got == want


def test_failed_launch_gives_per_lane_errors(pair_factory, monkeypatch):
    """A flush whose launch raises is not re-run anywhere else: its lanes
    carry the JAX service's error text.  A NO_BATCHING launch that raises
    fails the request, as in the JAX service."""
    p = pair_factory(express=False)

    def boom(*a, **kw):
        raise RuntimeError("launch failed")

    out = {}
    for name, svc, Cols, _, _ in p.sides():
        monkeypatch.setattr(svc.store, "apply_columns_async", boom)
        cols = _cols("f", [f"f{k}" for k in range(6)], 0, 0, 1, 5, 1000)
        out[name] = _call(svc, Cols, cols, "sync")
        with pytest.raises(RuntimeError, match="launch failed"):
            svc.get_rate_limits_columns(Cols(**_cols("f", ["a", "b"], 0, NB, 1, 5, 1000)))
    assert out["torch"] == out["jax"]
    assert out["torch"][0][4] == "while applying rate limit 'f_f0' - 'launch failed'"


def test_trace_spans_of_a_sampled_request(pair_factory):
    """At GUBER_TRACE_SAMPLE=1 a request opened with an ingress span
    gets a batch.window span (linking the request) and the five
    dispatch.* stage spans parented under it, as in the JAX service."""
    p = pair_factory()
    saved = (jtr.sample_rate(), ttr.sample_rate())
    names = {}
    try:
        for (name, svc, Cols, _, _), mod in zip(p.sides(), (jtr, ttr)):
            mod.reset()
            mod.set_sample_rate(1.0)
            root = mod.ingress_span("grpc", "/pb.gubernator.V1/GetRateLimits")
            with root:
                _call(svc, Cols, _cols("tr", [f"t{k}" for k in range(8)], 0, 0, 1, 5,
                                       60_000), "sync")
            root.end()
            spans = mod.spans_snapshot(root.ctx.trace_hex)
            (window,) = [s for s in spans if s["name"] == "batch.window"]
            assert {"trace_id": root.ctx.trace_hex, "span_id": root.ctx.span_hex} in \
                window["links"]
            stages = [s for s in spans if s["name"].startswith("dispatch.")]
            assert all(s["parent_id"] == window["span_id"] for s in stages)
            names[name] = sorted(s["name"] for s in spans)
    finally:
        jtr.set_sample_rate(saved[0])
        ttr.set_sample_rate(saved[1])
        jtr.reset()
        ttr.reset()
    assert names["torch"] == names["jax"]
    assert names["torch"] == sorted(
        ["batch.window", "ingress.grpc"]
        + [f"dispatch.{s}" for s in ("prepare", "stage", "launch", "fetch", "commit")])


def test_debug_status_and_queued_lanes(pair_factory):
    p = pair_factory()
    cols = _cols("st", [f"s{k}" for k in range(30)], 0, 0, 1, 5, 60_000)
    _call(p.j, JaxColumns, cols, "sync")
    _call(p.t, IngressColumns, cols, "sync")
    st, sj = p.t.debug_status(), p.j.debug_status()
    assert st["occupancy"] == sj["occupancy"]
    for sec, keys in (("ingress", ("queuedLanes", "capLanes", "shedLanes", "windowWaitS")),
                      ("dispatch", ("inflight",)),
                      ("express", ("enabled", "queueDepth", "maxLanes"))):
        assert {k: st[sec][k] for k in keys} == {k: sj[sec][k] for k in keys}, sec
    assert p.t.ingress_queued_lanes() == p.j.ingress_queued_lanes() == 0
