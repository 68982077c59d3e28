"""The readers of the served path's own spans and counters: a value from
a synthetic window and the port's phases, nothing without them; the
trace reduction leaves the card's busy time alone when the program's
ranges are in the trace; a tiny CPU run gives every reader something to
read."""

import importlib.util
import os
import time

import numpy as np
import pytest

from portbench import bench, trace
from portbench.tests import tiny

READERS = ("service.admit_ms_per_klane", "service.window_wait_p95_ms", "service.answer_p95_ms",
           "service.backstop_wait_s_per_s", "pipeline.plan_lock_wait_s_per_s",
           "pipeline.table_lock_wait_s_per_s", "pipeline.planner_ms_per_klane")


def reader(name):
    path = os.path.join(tiny.ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"w_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def window(**kw):
    base = dict(seconds=2.0, t0=0.0, t1=2.0, latencies_s=np.zeros(0), lanes=0, requests=0,
                failed=0, rows=0, wide_lanes=0)
    base.update(kw)
    return bench.Window(**base)


@pytest.fixture
def phases():
    from gubernator_tpu_torch import saturation

    saturation.reset()
    yield saturation
    saturation.reset()


@pytest.mark.parametrize("name,want", [
    ("service.admit_ms_per_klane", 0.5),  # 4 x 1 ms over 8,000 lanes
    ("service.window_wait_p95_ms", 100.0),
    ("service.answer_p95_ms", 20.0),
    ("service.backstop_wait_s_per_s", 0.01 * 50 / 2.0),  # mean 10 ms x 50 chunks / 2 s
    ("pipeline.plan_lock_wait_s_per_s", 0.002 / 2.0),
    ("pipeline.table_lock_wait_s_per_s", 0.004 / 2.0),
    ("pipeline.planner_ms_per_klane", 60.0 * 1e3 / 100_000 * 1e3 / 1e3),
])
def test_each_reader_reads_its_span_or_counter(phases, name, want):
    """A value from the window's stages and the port's phases; None
    without them (the parent's program has neither)."""
    read = reader(name)
    assert read(window(), {}) is None  # no phase, no stage
    for _ in range(4):
        phases.observe_phase("service.admit", 0.001, lanes=2_000)
        phases.observe_phase("batch.window", 0.1)
        phases.observe_phase("request.answer", 0.02)
        phases.observe_phase("queue.backstop", 0.01)
    stages = {"prepare": (50, 3.0, 0.1), "prepare.plan_lock_wait": (50, 0.002, 0.001),
              "prepare.table_lock_wait": (50, 0.004, 0.002),
              "prepare.planner": (50, 0.06, 0.002)}
    w = window(lanes=100_000, stages=stages)
    assert read(w, {}) == pytest.approx(want, rel=0.011)
    phases.reset()
    assert read(window(lanes=100_000), {}) is None


def test_program_ranges_leave_the_busy_time_alone():
    """The program's ranges reach the trace as user_annotation events on
    the host and gpu_user_annotation events on the card's timeline;
    neither is a card operation, so busy_s, and with it
    device_ms_per_mcheck, is unchanged."""
    ops = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 100, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 200, "dur": 30},
    ]
    ranges = [
        {"ph": "X", "cat": "user_annotation", "name": "batcher.flush", "ts": 0, "dur": 400},
        {"ph": "X", "cat": "user_annotation", "name": "dispatch.prepare", "ts": 10, "dur": 80},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "dispatch.launch", "ts": 95, "dur": 200},
    ]
    plain = trace.reduce(ops, 500e-6)
    traced = trace.reduce(ops + ranges, 500e-6)
    assert traced["busy_s"] == plain["busy_s"] == pytest.approx(40e-6)
    assert traced["ops"] == plain["ops"]
    w = window(lanes=1_000_000, trace=traced)
    assert reader("device_ms_per_mcheck")(w, {}) == pytest.approx(0.04)


def test_a_tiny_run_gives_every_reader_a_value():
    config, m = tiny.cell("leaky1m-batched-128c")
    w, check, _ = bench.run_cell({"name": "x"}, config, m, 2**31 + 5, 1.0, False, device="cpu",
                                 t_start=time.perf_counter(), log=lambda *a: None)
    assert check.correct
    for name in READERS:
        v = reader(name)(w, {})
        assert v is not None and v >= 0.0, name
    assert reader("pipeline.planner_ms_per_klane")(w, {}) > 0.0
    # The planner and the waits lie inside prepare.
    inside = sum(w.stages[k][1] for k in ("prepare.planner", "prepare.table_lock_wait",
                                          "prepare.plan_lock_wait"))
    assert inside <= w.stages["prepare"][1]
