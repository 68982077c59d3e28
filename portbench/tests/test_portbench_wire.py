"""The readers of the store pipeline's wire counters: the right ratio
from a synthetic window, nothing without the counters (the parent's
program has none), and a value from a tiny CPU run."""

import importlib.util
import os
import time

import numpy as np
import pytest

from portbench import bench
from portbench.tests import tiny


def reader(name):
    path = os.path.join(tiny.ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"wire_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def window(**kw):
    base = dict(seconds=2.0, t0=0.0, t1=2.0, latencies_s=np.zeros(0), lanes=0, requests=0,
                failed=0, rows=0, wide_lanes=0)
    base.update(kw)
    return bench.Window(**base)


# Two flushes of 23,448 and 25,607 live lanes over 8 shards of 3,072 and
# 3,328 padded lanes: the dict wire i32[8, 3P + 3,072] up, i32[8, 4, P]
# down.
LANES = 23_448 + 25_607
SLOTS = 8 * (3_072 + 3_328)
UP = sum(8 * (3 * p + 3_072) * 4 for p in (3_072, 3_328))
DOWN = sum(8 * 4 * p * 4 for p in (3_072, 3_328))
STAGES = {"prepare": (2, 0.1, 0.06), "wire.lanes": (2, LANES, 25_607),
          "wire.slots": (2, SLOTS, 8 * 3_328), "wire.up_bytes": (2, UP, 8 * 13_056 * 4),
          "wire.down_bytes": (2, DOWN, 8 * 4 * 3_328 * 4)}


@pytest.mark.parametrize("name,want", [
    ("pipeline.wire_fill_pct", 100.0 * LANES / SLOTS),
    ("pipeline.copy_bytes_per_lane", (UP + DOWN) / LANES),
])
def test_each_reader_reads_the_wire_counters(name, want):
    read = reader(name)
    assert read(window(), {}) is None
    assert read(window(lanes=LANES, stages={"prepare": (2, 0.1, 0.06)}), {}) is None
    assert read(window(lanes=LANES, stages=STAGES), {}) == pytest.approx(want, rel=1e-12)


def test_a_tiny_run_gives_both_readers_a_value():
    config, m = tiny.cell("leaky1m-batched-128c")
    w, check, _ = bench.run_cell({"name": "x"}, config, m, 2**31 + 11, 1.0, False, device="cpu",
                                 t_start=time.perf_counter(), log=lambda *a: None)
    assert check.correct
    fill = reader("pipeline.wire_fill_pct")(w, {})
    per_lane = reader("pipeline.copy_bytes_per_lane")(w, {})
    assert fill is not None and 0.0 < fill <= 100.0
    # At least a live lane's 12 bytes up and 16 down, narrow.
    assert per_lane is not None and per_lane >= 28.0
    assert 0 < w.stages["wire.lanes"][0] == w.stages["wire.slots"][0]
