"""The metric arithmetic: the rate over the whole window, the p95 over
all requests, the roofline's bytes from the requests, the trace
reduction, and BENCHMARK.json's metrics each with a reader."""

import importlib.util
import json
import os
import re
import time

import numpy as np
import pytest

from portbench import bench, roofline, trace
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def reader(name):
    path = os.path.join(tiny.ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"m_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def window(**kw):
    base = dict(seconds=2.0, t0=0.0, t1=2.0, latencies_s=np.zeros(0), lanes=0, requests=0,
                failed=0, rows=0, wide_lanes=0)
    base.update(kw)
    return bench.Window(**base)


def test_rate_is_all_lanes_over_all_the_window():
    assert reader("service.checks_per_s")(window(lanes=3_000, seconds=2.0), {}) == 1_500.0
    assert reader("service.checks_per_s")(window(), {}) is None


def test_card_time_is_the_busy_union_over_all_checks_of_the_window():
    w = window(lanes=2_000_000, trace={"busy_s": 0.003, "window_s": 2.0, "ops": {}})
    assert reader("device_ms_per_mcheck")(w, {}) == pytest.approx(1.5)
    assert reader("device_ms_per_mcheck")(window(lanes=5), {}) is None


def test_p95_is_over_every_request():
    lat = np.arange(1, 101) / 1e3  # 1..100 ms
    assert reader("service.request_p95_ms")(window(latencies_s=lat), {}) == pytest.approx(95.05)


def test_roofline_bytes_count_lanes_and_distinct_rows_once():
    assert roofline.window_bytes(lanes=10, wide_lanes=2, rows=4) == 10 * 28 + 2 * 16 + 4 * 96
    w = window(lanes=1_000, wide_lanes=0, rows=500,
               trace={"ops": {"void gt::bucket_rounds_kernel<x>": 1e-3, "Memcpy": 5.0},
                      "busy_s": 1.0, "window_s": 2.0})
    want = (1_000 * 28 + 500 * 96) / 3.35e12 / 1e-3 * 100
    assert reader("kernels.bucket_rounds_roofline")(w, {}) == pytest.approx(want)
    assert reader("device.idle_pct")(w, {}) == pytest.approx(50.0)
    assert reader("kernels.bucket_rounds_roofline")(window(lanes=1), {}) is None


def test_trace_reduction_unions_device_time_and_names_gaps():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 100, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 20, "dur": 50},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.submit", "ts": 30, "dur": 5},
    ]
    r = trace.reduce(ev, 200e-6)
    assert r["busy_s"] == pytest.approx(35e-6)
    assert r["ops"] == {"k1": pytest.approx(30e-6), "Memcpy HtoD": pytest.approx(10e-6)}
    assert r["idle_gaps"][0] == ["aten__copy__x1__portbench.submit_x1", pytest.approx(85e-6)]
    assert len(r["idle_gaps"]) == 2  # 15..100 and 120..200


def test_window_counts_what_was_answered_inside_it():
    config, m = tiny.cell("leaky1m-batched-128c")
    w, check, _ = bench.run_cell({"name": "x"}, config, m, 11, 1.0, False, device="cpu",
                                 t_start=time.perf_counter(), log=lambda *a: None)
    assert check.correct
    assert w.lanes == 20 * w.requests  # every request of the window answered in full
    assert len(w.latencies_s) == w.requests and w.seconds >= 1.0
    assert w.rows <= w.lanes


def test_every_metric_has_a_reader_and_valid_names():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    cells = {c["name"] for c in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert callable(reader(m["name"]))
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e
    for c in b["workloads"]:
        assert os.path.exists(os.path.join(tiny.ROOT, "portbench", "traffic",
                                           f"{c['traffic']}.json"))


def test_own_spans_name_gaps_on_the_trace_clock():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.MARK, "ts": 1_000, "dur": 1},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1_000, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1_500, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 1_010, "dur": 400},
    ]
    # perf_counter 7.0 s is the mark; the planner ran 7.0001 .. 7.0004 s.
    spans = [("pipeline.prepare", 7.0001, 7.0004), ("flow.send", 7.0002, 7.00021)]
    r = trace.reduce(ev, 600e-6, spans, 7.0)
    assert r["idle_gaps"][0][0] == "pipeline.prepare_x1__flow.send_x1"
    assert r["idle_gaps"][0][1] == pytest.approx(490e-6)
