"""A mix's `behavior` parameter: a mix without it sends byte for byte
what it sent before the parameter existed, NO_BATCHING reaches every
lane on every path, a name a one-node run cannot hold raises, and a
NO_BATCHING run dispatches every request at once, never through the
coalescing window."""

import hashlib
import threading
import time

import numpy as np
import pytest

from portbench import bench, traffic
from portbench.tests import tiny

SEED = 2**31 + 7


def digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(str(arrays[k].dtype).encode())
        h.update(arrays[k].tobytes())
    return h.hexdigest()


LANE = ('{"name":"c2","unique_key":"%s","hits":1,"limit":10,"duration":5000,'
        '"algorithm":"LEAKY_BUCKET"}')


def test_a_mix_without_behavior_sends_what_it_sent():
    # Written out from the generator before `behavior` existed.
    mix = traffic.load(tiny.ROOT, "leaky1m-batched-128c")
    assert "behavior" not in mix
    small = dict(mix, flows=2, lanes_per_request=3, keys=40, script_requests=1, fill_lanes=40)
    t = traffic.build(small, 5)
    bodies = bench.Requests(t)._bodies  # noqa: SLF001 — the bodies as sent
    assert bodies == [
        [('{"requests":[%s]}' % ",".join(LANE % k for k in ("0", "0", "2"))).encode()],
        [('{"requests":[%s]}' % ",".join(LANE % k for k in ("3", "13", "3"))).encode()]]
    assert t.fill[0].tolist() == [9, 38, 7, 5, 2, 6, 34, 24, 26, 31, 8, 32, 11, 20, 23, 29, 15,
                                  1, 35, 27, 30, 0, 25, 14, 22, 28, 13, 36, 37, 18, 33, 10, 39, 4,
                                  17, 16, 3, 21, 12, 19]
    want = {"algorithm": (np.int32, 1), "behavior": (np.int32, 0), "hits": (np.int64, 1),
            "limit": (np.int64, 10), "duration": (np.int64, 5000)}
    assert set(t.columns) == set(want)
    for f, (dtype, v) in want.items():
        assert t.columns[f].dtype == dtype and t.columns[f].tolist() == [v] * 3, f

    # The cell at its own size: sha256 of what the generator gave
    # before `behavior` existed.
    t = traffic.build(mix, SEED)
    h = hashlib.sha256()
    for ids in t.fill:
        h.update(ids.tobytes())
    assert (len(t.fill), h.hexdigest()) == (
        20, "ff3e2a46b79776f8b8afb8da3b9fc126428920383c88103dc4ddafcdfeb59ed7")
    assert digest(t.columns) == "a92742a9f37a18dff2a9589ec322ccda5178066cee6d25609cf745fa721b92b4"
    assert digest(traffic.columns(mix, len(t.fill[0]))) == (
        "7ccf976758044523c03210c2419677461b57a68bbaed54301a7ef84a9a19362c")
    hits = traffic.reference_hits(t, [(-1, 0), (0, 0), (1, 3)])
    assert digest({f: getattr(hits, f) for f in ("key", "seq", "now", "algorithm", "behavior",
                                                  "hits", "limit", "duration")}) == (
        "8b8722dba7f53214f52de13a1cef04640c3da87f18dec0a72c948e99ded9726d")
    t.scripts = t.scripts[:2]  # two flows' bodies: 3 MB
    h = hashlib.sha256()
    for script in bench.Requests(t)._bodies:  # noqa: SLF001
        for body in script:
            h.update(body)
    assert h.hexdigest() == "18cb3d4f812e703c652f5596de1210e98e3dacd1e62ff5055496a192d87b37a2"


@pytest.mark.parametrize("entry", ["json", "columns"])
def test_no_batching_reaches_every_lane(entry):
    _, mix = tiny.cell("token1k-nobatch-1c")
    mix.update(entry=entry, lanes_per_request=3)
    assert mix["behavior"] == ["NO_BATCHING"]
    t = traffic.build(mix, SEED)
    req = bench.Requests(t)
    fill = req.make(-1, 0)
    assert len(fill) == 20 and (np.asarray(fill.behavior) == 1).all()
    for c in range(t.flows):
        for i in range(3):
            cols = req.make(c, i)
            assert len(cols) == 3 and (np.asarray(cols.behavior) == 1).all()
    hits = traffic.reference_hits(t, [(-1, 0), (0, 0), (3, 2)])
    assert len(hits.behavior) == 26 and (hits.behavior == 1).all()


def test_a_no_batching_body_names_the_behavior():
    _, mix = tiny.cell("token1k-nobatch-1c")
    t = traffic.build(mix, SEED)
    key = int(t.ids(0, 0)[0])
    assert bench.Requests(t)._bodies[0][0] == (  # noqa: SLF001 — the body as sent
        '{"requests":[{"name":"c1","unique_key":"%d","hits":1,"limit":10,"duration":5000,'
        '"algorithm":"TOKEN_BUCKET","behavior":"NO_BATCHING"}]}' % key).encode()


@pytest.mark.parametrize("behavior", [["GLOBAL"], ["NO_BATCHING", "MULTI_REGION"],
                                      ["NO_BATCH"], "NO_BATCHING", ["DURATION_IS_GREGORIAN"],
                                      ["NO_BATCHING", "NO_BATCHING"]])
def test_a_behavior_one_node_cannot_hold_raises(behavior):
    _, mix = tiny.cell("token1k-nobatch-1c")
    mix["behavior"] = behavior
    with pytest.raises(ValueError, match="'behavior'"):
        traffic.build(mix, SEED)


def test_no_batching_requests_dispatch_at_once(monkeypatch):
    from gubernator_tpu_torch import saturation

    entry_threads, apply_threads = [], []
    build = bench.build_service

    def counted(*a, **kw):
        svc, clock = build(*a, **kw)
        enter, apply = svc.get_rate_limits_columns_async, svc.store.apply_columns_async

        def entry(*a2, **kw2):
            entry_threads.append(threading.current_thread().name)
            return enter(*a2, **kw2)

        def store_apply(*a2, **kw2):
            apply_threads.append(threading.current_thread().name)
            return apply(*a2, **kw2)

        svc.get_rate_limits_columns_async = entry
        svc.store.apply_columns_async = store_apply
        return svc, clock

    monkeypatch.setattr(bench, "build_service", counted)
    config, m = tiny.cell("token1k-nobatch-1c")
    w, check, _ = bench.run_cell({"name": "x"}, config, m, SEED, 1.0, False, device="cpu",
                                 t_start=time.perf_counter(), log=lambda *a: None)
    assert check.correct and w.requests > 0
    # No flush of the columnar batcher (the service's own count of
    # windowed dispatches, since the window opened) ...
    assert saturation.express_snapshot()["dispatches"]["windowed"] == 0
    assert saturation.phase_totals("batch.window") is None
    # ... and one store launch a request, made on the caller's thread.
    assert len(apply_threads) == len(entry_threads) > w.requests
    assert sorted(apply_threads) == sorted(entry_threads)
    assert set(apply_threads) == {"MainThread", "portbench-issuer-0"}
