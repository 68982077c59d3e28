"""Saturation & SLO observability plane (USE-method instrumentation).

The spans of tracing.py can say where ONE sampled request lost its time; this
module aggregates the same signals ALWAYS-ON, so the operator questions
("where do the p99 milliseconds go", "how full is the bucket table",
"are we burning the error budget") have live answers without sampling:

* **Latency attribution** — per-phase duration reservoirs covering the
  whole request waterfall (`PHASES`): ingress parse -> batch-window
  wait -> queue wait -> the five dispatch pipeline stages -> peer-wire
  RTT -> response encode.  Each observation also feeds the
  `gubernator_latency_attribution_seconds{phase}` histogram of the
  registered metrics sink; `GET /debug/latency` serves ceil-rank
  percentile snapshots straight from the reservoirs.

* **SLO engine** — `SloEngine` turns per-request ingress latency into
  multi-window (5m / 1h) error-budget burn rates against
  `GUBER_LATENCY_TARGET_MS`; a fast burn (Google SRE's 14.4x on the
  short window) trips the flight recorder's auto-dump path
  (`tracing.record_event("slo-fast-burn")`).

* **Hot-key sketch** — `HotKeySketch`, a count-min sketch + top-K
  tracker fed from the owner-code hashes `hash_ring.get_batch_codes`
  ALREADY computes (zero extra hashing on the hot path), served at
  `GET /debug/hotkeys` — the detection half of the ROADMAP item-5
  hot-key defense.

* **Saturation accumulators** — per-launch lane utilization (fill vs
  pow2 pad), dispatcher busy fraction, and ingress-queue depth
  samples, drained per metrics scrape like the dispatch-stage gauges.

Reservoirs/accumulators are MODULE-GLOBAL, like the tracing flight
recorder: one daemon per process in production, and in-process
multi-daemon tests share one plane exactly as they share one span ring.
Everything here is host-side arithmetic on data the hot path already
produced — the plane adds ZERO device programs (pinned by counting
dispatches, tests/test_observability.py).
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import tracing

# ---------------------------------------------------------------------
# Shared ceil-rank percentiles (the bench.py p99 bugfix lives here so
# every percentile site — bench rows, /debug/latency, queue-depth
# snapshots — indexes the same way).
# ---------------------------------------------------------------------


def percentile_rank(n: int, q: float) -> int:
    """0-based index of the q-quantile in a sorted n-sample list, by
    the NEAREST-RANK definition: 1-based rank ceil(q*n).  The previous
    bench.py form `min(n-1, int(n*q))` floor-indexed — at small n it
    lands a rank off the nearest-rank tail value, so gate verdicts on
    thin tails were judged against the wrong sample."""
    if n <= 0:
        raise ValueError("percentile of an empty sample")
    return min(n - 1, max(0, math.ceil(q * n) - 1))


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    return sorted_vals[percentile_rank(len(sorted_vals), q)]


# ---------------------------------------------------------------------
# Latency attribution: per-phase reservoirs
# ---------------------------------------------------------------------

# The request waterfall, in flight order.  Snapshots list phases in
# this order so a /debug/latency reader sees the pipeline shape.
PHASES = (
    "ingress.parse",     # wire bytes -> IngressColumns (gateway)
    "batch.window",      # submit -> coalescing-window flush (batchers)
    "express.submit",    # express bypass: submit -> dispatch staged
                         # (replaces batch.window + queue.wait for
                         # express lanes — the express-vs-batched split)
    "queue.wait",        # flush -> dispatch submit (backstop + concat)
    "dispatch.prepare",  # slot-table planning (pipeline stage 1)
    "dispatch.stage",    # wire pack + H2D upload start (stage 2)
    "dispatch.launch",   # ticket-ordered jit call (stage 3)
    "dispatch.fetch",    # device->host readback
    "dispatch.commit",   # decode + table commit
    "peer.rpc",          # forwarded-hop round trip (peer_client)
    "response.encode",   # ColumnarResult -> wire bytes (gateway)
    "ingress.total",     # whole-request wall time (GetRateLimits)
)

PHASE_RING = 2048  # recent samples kept per phase


class _PhaseStats:
    """One phase's reservoir: a ring of recent durations plus lifetime
    count/sum.  A small lock per observation — observations happen per
    BATCH or per REQUEST, not per lane, so contention is negligible."""

    __slots__ = ("_buf", "_lock", "count", "sum_s", "max_s")

    def __init__(self):
        self._buf: List[float] = []
        self._lock = threading.Lock()
        self.count = 0
        self.sum_s = 0.0
        self.max_s = 0.0

    def observe(self, dt_s: float) -> None:
        with self._lock:
            self.count += 1
            self.sum_s += dt_s
            if dt_s > self.max_s:
                self.max_s = dt_s
            if len(self._buf) >= PHASE_RING:
                self._buf[self.count % PHASE_RING] = dt_s
            else:
                self._buf.append(dt_s)

    def snapshot(self) -> Optional[dict]:
        with self._lock:
            if not self.count:
                return None
            vals = sorted(self._buf)
            return {
                "count": self.count,
                "sum_ms": round(self.sum_s * 1000.0, 3),
                "max_ms": round(self.max_s * 1000.0, 3),
                "p50_ms": round(percentile(vals, 0.50) * 1000.0, 3),
                "p90_ms": round(percentile(vals, 0.90) * 1000.0, 3),
                "p99_ms": round(percentile(vals, 0.99) * 1000.0, 3),
                "n_samples": len(vals),
            }


_phases: Dict[str, _PhaseStats] = {p: _PhaseStats() for p in PHASES}
# Prometheus sink: (histogram, {phase: child}) of the most recently
# constructed Metrics instance.  Last-wins, like the tracing rings —
# production runs one daemon per process; in-process test clusters
# share the plane.
_sink: Optional[list] = None
_sink_lock = threading.Lock()


def register_sink(histogram) -> None:
    """Attach a prometheus Histogram (labeled by `phase`) that every
    observe_phase ALSO feeds — metrics.py calls this at Metrics init."""
    global _sink
    with _sink_lock:
        _sink = [histogram, {}]


def observe_phase(phase: str, dt_s: float) -> None:
    """Record one completed phase interval.  Called from the hot path
    (per batch / per request): one lock, one ring write, one histogram
    observe."""
    st = _phases.get(phase)
    if st is None:  # unknown phase: record rather than drop
        st = _phases.setdefault(phase, _PhaseStats())
    st.observe(dt_s)
    sink = _sink
    if sink is not None:
        child = sink[1].get(phase)
        if child is None:
            try:
                child = sink[1][phase] = sink[0].labels(phase=phase)
            except Exception:  # noqa: BLE001 — a dead registry must not fail requests
                return
        child.observe(dt_s)


def phase_snapshot() -> Dict[str, dict]:
    """{phase: {count, sum_ms, max_ms, p50/p90/p99_ms, n_samples}} for
    every phase that has observations, in waterfall order."""
    out: Dict[str, dict] = {}
    for p in list(_phases):
        snap = _phases[p].snapshot()
        if snap is not None:
            out[p] = snap
    return out


# ---------------------------------------------------------------------
# Saturation accumulators (drained per metrics scrape)
# ---------------------------------------------------------------------
class LaneUtil:
    """Per-launch lane utilization: real lanes vs the pow2-padded shape
    the program actually scattered.  take() drains the deltas since the
    last scrape (the dispatch-stage gauge convention)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lanes = 0
        self._padded = 0
        self._launches = 0

    def add(self, lanes: int, padded: int) -> None:
        with self._lock:
            self._lanes += int(lanes)
            self._padded += int(padded)
            self._launches += 1

    def take(self) -> Tuple[int, int, int]:
        with self._lock:
            out = (self._lanes, self._padded, self._launches)
            self._lanes = self._padded = self._launches = 0
        return out


class BusyFraction:
    """Busy-seconds accumulator for the dispatcher (batch-window flush
    worker): take() returns (busy_s, elapsed_s) since the last take, so
    the scrape renders a utilization fraction."""

    def __init__(self, time_fn=time.monotonic):
        self._lock = threading.Lock()
        self._time = time_fn
        self._busy = 0.0
        self._last_take = time_fn()

    def add(self, dt_s: float) -> None:
        with self._lock:
            self._busy += dt_s

    def take(self) -> Tuple[float, float]:
        with self._lock:
            now = self._time()
            out = (self._busy, max(now - self._last_take, 1e-9))
            self._busy = 0.0
            self._last_take = now
        return out


class _DepthRing:
    """Lock-free ring of ingress-queue depth samples (one per admit),
    the tracing._Ring trick: itertools.count + slot store are atomic
    under the GIL."""

    CAP = 4096

    def __init__(self):
        self._buf: List[Optional[int]] = [None] * self.CAP
        self._seq = itertools.count()

    def record(self, depth: int) -> None:
        self._buf[next(self._seq) % self.CAP] = depth

    def snapshot(self) -> dict:
        vals = sorted(v for v in list(self._buf) if v is not None)
        if not vals:
            return {"n_samples": 0}
        return {
            "n_samples": len(vals),
            "p50": percentile(vals, 0.50),
            "p99": percentile(vals, 0.99),
            "max": vals[-1],
        }


class ExpressStats:
    """Express-vs-batched lane accounting (the millisecond
    express lane).  Each dispatch notes which path its lanes took:

      * ``bypass``   — batcher shallow-queue bypass (direct dispatch,
                       no coalescing window)
      * ``scalar``   — the host-side singleton slot (ops/scalar.py;
                       also counted as whichever submit path fed it)
      * ``native``   — NO_BATCHING frames served by the native ingress
                       express queue (gt_ingress_*)
      * ``windowed`` — lanes that rode a coalesced batch: a Python
                       window flush OR the native ring's bulk path
                       (the pump feeds both into this denominator)

    `take()` drains per-scrape deltas for the gubernator_express_*
    counters; `snapshot()` serves cumulative counts + the hit rate at
    /debug/latency and /debug/status."""

    PATHS = ("bypass", "scalar", "native", "windowed")

    def __init__(self):
        self._lock = threading.Lock()
        self._lanes = {p: 0 for p in self.PATHS}
        self._dispatches = {p: 0 for p in self.PATHS}
        self._delta_lanes = {p: 0 for p in self.PATHS}

    def note(self, path: str, lanes: int) -> None:
        with self._lock:
            self._lanes[path] = self._lanes.get(path, 0) + int(lanes)
            self._dispatches[path] = self._dispatches.get(path, 0) + 1
            self._delta_lanes[path] = (
                self._delta_lanes.get(path, 0) + int(lanes)
            )

    def take(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._delta_lanes)
            self._delta_lanes = {p: 0 for p in self.PATHS}
        return out

    def snapshot(self) -> dict:
        with self._lock:
            express = (
                self._lanes.get("bypass", 0) + self._lanes.get("native", 0)
            )
            windowed = self._lanes.get("windowed", 0)
            total = express + windowed
            return {
                "lanes": dict(self._lanes),
                "dispatches": dict(self._dispatches),
                "hitRate": round(express / total, 4) if total else 0.0,
            }


lane_util = LaneUtil()
dispatcher_busy = BusyFraction()
_queue_depths = _DepthRing()
express = ExpressStats()


def note_express(path: str, lanes: int) -> None:
    """Record one express/batched dispatch (see ExpressStats)."""
    express.note(path, lanes)


def express_snapshot() -> dict:
    return express.snapshot()


def observe_queue_depth(depth: int) -> None:
    _queue_depths.record(depth)


def queue_depth_snapshot() -> dict:
    return _queue_depths.snapshot()


# ---------------------------------------------------------------------
# SLO engine: multi-window error-budget burn rates
# ---------------------------------------------------------------------
class SloEngine:
    """Latency-SLO accounting: each ingress request is GOOD (answered
    under `target_ms`) or BAD; the error budget is `1 - objective` of
    requests, and the burn rate over a window is

        burn = (bad / total in window) / (1 - objective)

    (1.0 = burning the budget exactly as fast as it accrues; the SRE
    fast-burn page threshold is 14.4x over 5 minutes).  Counts live in
    10-second buckets covering one hour, so the 5m and 1h windows read
    from the same ring.  `target_ms <= 0` disables the engine: observe
    degrades to one comparison, every gauge reads 0."""

    BUCKET_S = 10
    N_BUCKETS = 360  # 1 hour
    WINDOWS = {"5m": 300, "1h": 3600}
    FAST_BURN = 14.4          # page-level burn on the short window
    FAST_WINDOW_S = 300
    # Volume floor for the fast-burn trip: a page-level verdict from a
    # handful of requests is noise shaped like an incident (one bad
    # warmup request after a restart would read burn=100) — the same
    # thin-tail rule the bench gate's min_samples enforces.
    FAST_MIN_TOTAL = 100
    CHECK_INTERVAL_S = 1.0    # fast-burn evaluation cadence
    TRIP_MIN_INTERVAL_S = 30.0

    def __init__(self, target_ms: float, objective: float = 0.99,
                 time_fn=time.monotonic):
        self.target_ms = float(target_ms)
        self.objective = min(max(float(objective), 0.0), 0.9999)
        self.enabled = self.target_ms > 0
        self._time = time_fn
        self._lock = threading.Lock()
        self._good = np.zeros(self.N_BUCKETS, dtype=np.int64)
        self._bad = np.zeros(self.N_BUCKETS, dtype=np.int64)
        self._epoch = np.full(self.N_BUCKETS, -1, dtype=np.int64)
        self._next_check = 0.0
        self._last_trip = -float("inf")

    def observe(self, dt_s: float) -> Optional[bool]:
        """Record one request; returns True (good) / False (bad), or
        None when the engine is disabled."""
        if not self.enabled:
            return None
        good = dt_s * 1000.0 <= self.target_ms
        now = self._time()
        trip_burn = None
        with self._lock:
            i = self._slot(now)
            (self._good if good else self._bad)[i] += 1
            if now >= self._next_check:
                self._next_check = now + self.CHECK_INTERVAL_S
                w_good, w_bad = self._window_counts(now, self.FAST_WINDOW_S)
                total = w_good + w_bad
                burn = (
                    (w_bad / total) / max(1.0 - self.objective, 1e-9)
                    if total >= self.FAST_MIN_TOTAL else 0.0
                )
                if (burn >= self.FAST_BURN
                        and now - self._last_trip >= self.TRIP_MIN_INTERVAL_S):
                    self._last_trip = now
                    trip_burn = burn
        if trip_burn is not None:
            # The flight recorder's auto-dump path: a fast burn is the same "the
            # service is losing its SLO" signal a breaker trip is —
            # dump the flight recorder.  OUTSIDE the engine lock: the
            # dump JSON-serializes and logs, and every ingress request
            # takes this lock — a slow log handler must not convoy the
            # whole service at the very moment it is burning.
            tracing.record_event(
                "slo-fast-burn", burn_rate=round(trip_burn, 2),
                window_s=self.FAST_WINDOW_S,
                target_ms=self.target_ms,
                objective=self.objective,
            )
        return good

    def _slot(self, now: float) -> int:
        """Bucket index for `now`, zeroing the slot if its epoch is
        stale (the ring wrapped past it).  Lock held."""
        epoch = int(now // self.BUCKET_S)
        i = epoch % self.N_BUCKETS
        if self._epoch[i] != epoch:
            self._epoch[i] = epoch
            self._good[i] = 0
            self._bad[i] = 0
        return i

    def _window_counts(self, now: float, window_s: int) -> Tuple[int, int]:
        epoch = int(now // self.BUCKET_S)
        lo = epoch - (window_s // self.BUCKET_S) + 1
        live = (self._epoch >= lo) & (self._epoch <= epoch)
        return int(self._good[live].sum()), int(self._bad[live].sum())

    def _burn_locked(self, now: float, window_s: int) -> float:
        good, bad = self._window_counts(now, window_s)
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / max(1.0 - self.objective, 1e-9)

    def burn_rate(self, window_s: int) -> float:
        if not self.enabled:
            return 0.0
        with self._lock:
            return self._burn_locked(self._time(), window_s)

    def snapshot(self) -> dict:
        out = {
            "enabled": self.enabled,
            "target_ms": self.target_ms,
            "objective": self.objective,
        }
        if not self.enabled:
            return out
        with self._lock:
            now = self._time()
            for name, w in self.WINDOWS.items():
                good, bad = self._window_counts(now, w)
                out[f"burn_rate_{name}"] = round(
                    self._burn_locked(now, w), 4
                )
                out[f"good_{name}"] = good
                out[f"bad_{name}"] = bad
        return out


# ---------------------------------------------------------------------
# Hot-key detection: count-min sketch + top-K
# ---------------------------------------------------------------------

# Odd 64-bit multipliers deriving d independent row indices from the
# ONE fnv1 hash the ring already computed (Dietzfelbinger-style
# multiply-shift; u64 wraparound is the intended arithmetic).
_CMS_SALTS = np.array(
    [0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
     0x27D4EB2F165667C5],
    dtype=np.uint64,
)


class HotKeySketch:
    """Count-min sketch over per-lane key hashes plus an exact top-K
    candidate list.  update() is fully vectorized over a batch; key
    STRINGS are materialized only for the handful of lanes whose
    estimate crosses the current top-K floor, so the hot path never
    builds per-lane Python objects.  Counts decay by halving every
    `decay_s` seconds — the sketch answers "hot NOW", not "hot ever"."""

    def __init__(self, width: int = 8192, depth: int = 4, topk: int = 16,
                 decay_s: float = 30.0, time_fn=time.monotonic):
        self.width = int(width)
        self.depth = min(int(depth), len(_CMS_SALTS))
        self.topk = int(topk)
        self.decay_s = float(decay_s)
        self._time = time_fn
        self._lock = threading.Lock()
        self._tab = np.zeros((self.depth, self.width), dtype=np.int64)
        self._salts = _CMS_SALTS[: self.depth]
        self._top: Dict[int, list] = {}  # hash -> [est, key_str]
        self._last_decay = time_fn()
        self.total_lanes = 0
        self.batches = 0

    def update(self, hashes: np.ndarray, keys) -> None:
        """Fold one batch: `hashes` u64[n] (the ring lookup's fnv1
        values), `keys` indexable by lane (list or PackedKeys)."""
        n = len(hashes)
        if n == 0:
            return
        hs = np.ascontiguousarray(hashes, dtype=np.uint64)
        with self._lock:
            now = self._time()
            if now - self._last_decay >= self.decay_s:
                self._last_decay = now
                self._tab >>= 1
                for rec in self._top.values():
                    rec[0] >>= 1
            uh, first, counts = np.unique(
                hs, return_index=True, return_counts=True
            )
            idx = ((uh[None, :] * self._salts[:, None])
                   >> np.uint64(17)) % np.uint64(self.width)
            for r in range(self.depth):
                np.add.at(self._tab[r], idx[r].astype(np.intp), counts)
            est = self._tab[
                np.arange(self.depth)[:, None], idx.astype(np.intp)
            ].min(axis=0)
            self.total_lanes += n
            self.batches += 1
            # Top-K maintenance: only candidates at/above the current
            # floor materialize a key string.  While the list is still
            # filling the floor is 0, so bound the candidate scan to
            # the K largest estimates — a 1000-unique batch must not
            # loop 1000 lanes in Python.
            if len(self._top) >= self.topk:
                floor = min(rec[0] for rec in self._top.values())
                cand = np.nonzero(est >= floor)[0]
                if cand.size > self.topk:
                    # Uniform traffic concentrates estimates near the
                    # floor: without this cap, ~every unique hash would
                    # qualify and loop in Python per batch.
                    cand = cand[np.argsort(est[cand])[-self.topk:]]
            else:
                cand = np.argsort(est)[max(0, est.size - self.topk):]
            for j in cand:
                h = int(uh[j])
                rec = self._top.get(h)
                if rec is not None:
                    rec[0] = int(est[j])
                else:
                    self._top[h] = [int(est[j]), str(keys[int(first[j])])]
            if len(self._top) > self.topk:
                keep = sorted(
                    self._top.items(), key=lambda kv: kv[1][0], reverse=True
                )[: self.topk]
                self._top = dict(keep)

    def snapshot(self) -> dict:
        with self._lock:
            top = sorted(
                ({"key": rec[1], "estimate": int(rec[0])}
                 for rec in self._top.values()),
                key=lambda d: d["estimate"], reverse=True,
            )
            return {
                "topk": top,
                "total_lanes": self.total_lanes,
                "batches": self.batches,
                "width": self.width,
                "depth": self.depth,
                "decay_s": self.decay_s,
            }


# ---------------------------------------------------------------------
def reset() -> None:
    """Test hook: clear every module-global reservoir/accumulator."""
    global _phases, lane_util, dispatcher_busy, _queue_depths, express
    _phases = {p: _PhaseStats() for p in PHASES}
    lane_util = LaneUtil()
    dispatcher_busy = BusyFraction()
    _queue_depths = _DepthRing()
    express = ExpressStats()
