"""Reduction of a torch.profiler trace of the measured window to the
numbers the benchmark reports: the device's busy seconds (the union of
every kernel, copy and set on the card), the time of each device
operation by name, and the longest idle gaps named by what the host was
doing meanwhile."""

from __future__ import annotations

import json
import re
from collections import Counter, defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def clean(name: str, width: int = 64) -> str:
    """A name the ledger keeps: letters, digits, `_`, `.`, `-` only."""
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)[:width]


def union_s(intervals) -> float:
    """Length in seconds of the union of (start_us, end_us) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def gaps(intervals, lo: float, hi: float):
    """The idle (start_us, end_us) gaps between merged busy intervals
    inside [lo, hi]."""
    out, cursor = [], lo
    for s, e in sorted(intervals):
        if s > cursor:
            out.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(s, e) for s, e in out if e > s]


MARK = "portbench.window"


def reduce(events, window_s: float, spans=(), t_mark: float = 0.0) -> dict:
    """{busy_s, window_s, ops: {name: s}, device_ops, idle_gaps} of a
    chrome-trace event list.  `spans` are the benchmark's own host spans
    (label, start, end) on the perf_counter clock, which read `t_mark`
    at the trace's MARK event; they name the idle gaps first."""
    dev, host, own = [], [], []
    mark = next((float(ev["ts"]) for ev in events if ev.get("name") == MARK), None)
    if mark is not None:
        own = [(mark + (s - t_mark) * 1e6, mark + (e - t_mark) * 1e6, n) for n, s, e in spans]
    ops = defaultdict(float)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        s, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((s, s + d))
            ops[ev["name"]] += d / 1e6
        elif cat in HOST_CATS:
            host.append((s, s + d, ev["name"]))
    busy = union_s(dev)
    idle = []
    if dev:
        lo = min(s for s, _, _ in host) if host else min(s for s, _ in dev)
        lo = min(lo, min(s for s, _ in dev))
        hi = lo + window_s * 1e6
        idle = sorted(gaps(dev, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    named = [[_name(s, e, own) or _name(s, e, host) or "host_no_span", (e - s) / 1e6]
             for s, e in idle]
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy, "window_s": window_s, "ops": dict(ops),
            "device_ops": [[clean(n), v] for n, v in top], "idle_gaps": named}


def load(path: str):
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _name(s: float, e: float, host) -> str:
    """The two host spans' names that cover most of the gap [s, e], each
    with the number of its spans there ('' when none overlaps)."""
    if not host:
        return ""
    hs = np.array([h[0] for h in host])
    he = np.array([h[1] for h in host])
    cover, count = Counter(), Counter()
    for i in np.nonzero((hs < e) & (he > s))[0]:
        name = host[i][2]
        cover[name] += min(host[i][1], e) - max(host[i][0], s)
        count[name] += 1
    return "__".join(f"{clean(n, 40)}_x{count[n]}" for n, _ in cover.most_common(2))
