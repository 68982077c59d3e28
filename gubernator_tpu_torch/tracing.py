"""Request tracing + flight recorder (Dapper, Sigelman et al. 2010).

The system has three layers of concurrency machinery — the columnar
coalescer, the PREPARE/STAGE/LAUNCH/FETCH/COMMIT dispatch pipeline and
the batched peer hop — and aggregate gauges cannot say WHERE one slow
request lost its time.  This module adds:

* **Spans** — monotonic-ns intervals with a 128-bit trace id / 64-bit
  span id, W3C `traceparent` interop at the edges.  Context is
  per-thread (`current()`); sampling is decided ONCE per request at
  ingress (`GUBER_TRACE_SAMPLE`, a 0..1 rate).  When tracing is off —
  or the request lost the sampling dice roll — every entry point
  returns the shared `_NOOP` singleton: no allocation, no id
  generation, one float compare on the hot path.

* **Span links, not nesting, for batches.**  Coalescing means one
  device dispatch / one peer RPC carries MANY traces; a batch gets its
  own trace (the `batch.window` span) and every per-stage span LINKS
  the member lanes' contexts (the Dapper/OpenTelemetry span-link rule
  for fan-in).  `/debug/traces?trace_id=X` therefore matches spans
  whose own id is X *or* that link X.

* **Flight recorder** — a lock-free ring buffer of the last N spans
  and N events.  CPython makes `next(itertools.count())` and a list
  slot assignment atomic, so writers never take a lock and a reader's
  snapshot is at worst one record torn-at-the-edges (it sorts by
  sequence number and drops holes).  Dumped via the gateway's
  `GET /debug/traces` / `GET /debug/events` and automatically (to the
  structured log, rate-limited) on breaker-open / ingress-shed /
  injected-fault events.

Cross-daemon: the peer hop carries a sparse trace-context column (lane
ranges -> trace/span ids) in both columnar encodings, so a forwarded
check produces ONE trace spanning both daemons (wire.py).
"""

from __future__ import annotations

import itertools
import json
import os
import random
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

from .utils.logging import category_logger

logger = category_logger("tracing")

# Sampling rate (0..1).  0 disables tracing entirely: every hook
# degrades to a single comparison and the wire carries no trace bytes
# (the GUBER_TRACE_SAMPLE=0 wire-parity contract).
_SAMPLE: float = 0.0
# Bench-only "compiled out" switch: the overhead gate compares the
# sample-rate-0 guards against this fully-disabled baseline.
_FORCE_DISABLED: bool = False

def _env_ring(default: int = 4096) -> int:
    """GUBER_TRACE_RING, warn-and-default on garbage — module import
    must never raise (every layer imports this module)."""
    v = os.environ.get("GUBER_TRACE_RING", "")
    if not v:
        return default
    try:
        return max(int(v), 1)
    except ValueError:
        import warnings

        warnings.warn(
            f"GUBER_TRACE_RING must be an integer, got {v!r}; "
            f"using {default}",
            stacklevel=2,
        )
        return default


SPAN_RING_CAPACITY = _env_ring()
EVENT_RING_CAPACITY = 1024

_tls = threading.local()


def _env_sample() -> float:
    """Import-time env default.  Out-of-range/unparsable values fall
    back to 0 (OFF) with a warning — the safe direction; clamping 5 to
    1.0 would be the 100%-sampling surprise config.setup_daemon_config
    loudly rejects.  Import time cannot raise, so warn-and-disable is
    the library-embedding equivalent of that validation."""
    v = os.environ.get("GUBER_TRACE_SAMPLE", "")
    if not v:
        return 0.0
    try:
        rate = float(v)
    except ValueError:
        rate = -1.0
    if not 0.0 <= rate <= 1.0:
        import warnings

        warnings.warn(
            f"GUBER_TRACE_SAMPLE must be a float in [0, 1], got {v!r}; "
            "tracing disabled",
            stacklevel=2,
        )
        return 0.0
    return rate


def set_sample_rate(rate: float) -> None:
    global _SAMPLE
    _SAMPLE = min(max(float(rate), 0.0), 1.0)


def sample_rate() -> float:
    return _SAMPLE


def force_disable(flag: bool) -> None:
    """Bench hook: behave as if the module did not exist (the
    'tracing-compiled-out' baseline of the overhead gate)."""
    global _FORCE_DISABLED
    _FORCE_DISABLED = bool(flag)


def enabled() -> bool:
    """One branch — THE hot-path guard every layer uses."""
    return _SAMPLE > 0.0 and not _FORCE_DISABLED


def sampled() -> bool:
    """Roll the sampling dice for work that is not an ingress request
    (the GlobalManager's sync ticks): same rate, same single-compare
    fast path when tracing is off."""
    return enabled() and _rng().random() < _SAMPLE


def _rng() -> random.Random:
    r = getattr(_tls, "rng", None)
    if r is None:
        r = _tls.rng = random.Random(os.urandom(16))
    return r


class SpanContext:
    """An active (trace, span) pair — what propagates."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id

    @property
    def trace_hex(self) -> str:
        return format(self.trace_id, "032x")

    @property
    def span_hex(self) -> str:
        return format(self.span_id, "016x")

    def __repr__(self) -> str:  # debugging only
        return f"SpanContext({self.trace_hex}, {self.span_hex})"


def current() -> Optional[SpanContext]:
    """The calling thread's active span context (None = no sampled
    trace on this thread)."""
    return getattr(_tls, "ctx", None)


# ---------------------------------------------------------------------
# W3C traceparent (https://www.w3.org/TR/trace-context/)
# ---------------------------------------------------------------------
def format_traceparent(ctx: SpanContext) -> str:
    return f"00-{ctx.trace_hex}-{ctx.span_hex}-01"


def parse_traceparent(value: str) -> Optional[Tuple[int, int, bool]]:
    """-> (trace_id, span_id, sampled_flag) or None on any malformed
    input (a bad header must never fail the request)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_hex, span_hex, flags = parts
    if len(version) != 2 or len(trace_hex) != 32 or len(span_hex) != 16:
        return None
    if version == "ff":
        return None
    try:
        trace_id = int(trace_hex, 16)
        span_id = int(span_hex, 16)
        sampled = bool(int(flags, 16) & 0x01)
    except ValueError:
        return None
    if trace_id == 0 or span_id == 0:
        return None
    return trace_id, span_id, sampled


# ---------------------------------------------------------------------
# Flight recorder: lock-free rings
# ---------------------------------------------------------------------
class _Ring:
    """Fixed-capacity ring written without locks.  `next()` on an
    itertools.count and a list-slot store are each atomic under the
    GIL; a reader snapshot copies the slot list, sorts by sequence and
    tolerates the (rare) slot being overwritten mid-copy."""

    def __init__(self, capacity: int):
        self._cap = max(int(capacity), 1)
        self._buf: List[Optional[tuple]] = [None] * self._cap
        self._seq = itertools.count()

    def record(self, item: dict) -> None:
        i = next(self._seq)
        self._buf[i % self._cap] = (i, item)

    def snapshot(self) -> List[dict]:
        entries = [e for e in list(self._buf) if e is not None]
        entries.sort(key=lambda e: e[0])
        return [item for _, item in entries]

    def clear(self) -> None:
        self._buf = [None] * self._cap


# Event kinds that trigger an automatic flight-recorder dump to the
# structured log (rate-limited so an open breaker can't storm it).
# global-send-failed: a GLOBAL broadcast/hit-forward send exhausted its
# retry budget — the same lost-progress signal a breaker trip is.
# slo-fast-burn: the SLO engine (saturation.py) measured a page-level
# error-budget burn on its short window — dump while the evidence of
# WHERE the latency went is still in the ring.
# reshard-aborted: an ownership transfer failed/was fenced and its
# lanes degraded to reset-on-move (reshard.py) — the state-loss moment
# the recorder exists to preserve.
_DUMP_KINDS = frozenset({"breaker-open", "shed", "fault",
                         "global-send-failed", "slo-fast-burn",
                         "reshard-aborted", "recompile-storm",
                         "audit-violation", "snapshot-rejected"})
_DUMP_MIN_INTERVAL_S = 5.0

# Every live Recorder (weakly — a closed service's recorder must not be
# pinned by this registry).  Module-level snapshots/reset operate on
# the union, which preserves the one-global-ring semantics bare-store
# users had before per-service recorders existed.
_recorders: "weakref.WeakSet[Recorder]" = weakref.WeakSet()


class Recorder:
    """One flight recorder: a span ring + event ring + the auto-dump
    rate limiter, keyed per daemon/service instance so co-resident
    daemons' incidents do not interleave.  Threads owned by a service
    bind its recorder via `bind_recorder`; unbound threads fall back to the module default,
    and readers MERGE (spans_snapshot/events_snapshot take an explicit
    recorder list), so spans recorded off an unbound helper thread are
    never lost to a per-service view.

    `dump_hooks` is the incident trigger surface: callables
    `(trigger_kind, fields) -> None` invoked on EVERY _DUMP_KINDS event
    BEFORE the log dump's rate limit — the black box (blackbox.py) does
    its own coalescing/rate limiting and must see every trigger."""

    __slots__ = ("name", "_spans", "_events", "dump_hooks", "_last_dump",
                 "_dump_lock", "__weakref__")

    def __init__(self, span_capacity: int = 0, event_capacity: int = 0,
                 name: str = ""):
        self.name = name
        self._spans = _Ring(span_capacity or SPAN_RING_CAPACITY)
        self._events = _Ring(event_capacity or EVENT_RING_CAPACITY)
        self.dump_hooks: List = []
        self._last_dump = 0.0
        self._dump_lock = threading.Lock()
        _recorders.add(self)

    def spans(self) -> List[dict]:
        return self._spans.snapshot()

    def events(self) -> List[dict]:
        return self._events.snapshot()

    def clear(self) -> None:
        self._spans.clear()
        self._events.clear()

    def _auto_dump(self, trigger: str, fields: dict) -> None:
        # Hooks BEFORE the rate limit: the black box coalesces trigger
        # storms itself and must count every one; each hook is fenced —
        # diagnostics must never fail the path that fired the event.
        for hook in list(self.dump_hooks):
            try:
                hook(trigger, fields)
            except Exception:  # noqa: BLE001
                logger.exception("flight-recorder dump hook failed")
        now = time.monotonic()
        with self._dump_lock:
            if now - self._last_dump < _DUMP_MIN_INTERVAL_S:
                return
            self._last_dump = now
        try:
            payload = {
                "trigger": trigger,
                "events": self._events.snapshot()[-20:],
                "spans": self._spans.snapshot()[-50:],
            }
            logger.warning(
                "flight-recorder dump trigger=%s %s",
                trigger,
                json.dumps(payload, separators=(",", ":"), default=str),
            )
        except Exception:  # noqa: BLE001 — diagnostics must never fail the path
            logger.exception("flight-recorder dump failed")


_DEFAULT = Recorder(name="process")
# Back-compat aliases: library code and tests reach for the module
# rings directly (tracing._spans.record(...)); they are the DEFAULT
# recorder's rings.
_spans = _DEFAULT._spans
_events = _DEFAULT._events


def default_recorder() -> Recorder:
    return _DEFAULT


def bind_recorder(rec: Optional[Recorder]) -> None:
    """Bind `rec` as this thread's flight recorder (None = back to the
    module default).  Service-owned threads (gateway workers, pools,
    the auditor, the native pump) bind their service's recorder so
    incidents are attributable per daemon."""
    _tls.recorder = rec


def current_recorder() -> Recorder:
    return getattr(_tls, "recorder", None) or _DEFAULT


def all_recorders() -> List[Recorder]:
    return list(_recorders)


def record_span(
    name: str,
    ctx: SpanContext,
    parent_id: int = 0,
    start_ns: int = 0,
    end_ns: int = 0,
    links: Sequence[SpanContext] = (),
    **attrs,
) -> None:
    """Append one COMPLETED span to the flight recorder.  `wall_ns`
    stamps the span's END on the wall clock (time.time_ns) — spans'
    start_ns are MONOTONIC and therefore incomparable across daemons;
    the wall stamp is what lets scripts/trace_collect.py order one
    trace's spans from several processes and measure hop latencies
    (NTP-grade skew applies, which is fine for hop-scale deltas)."""
    current_recorder()._spans.record(
        {
            "name": name,
            "trace_id": ctx.trace_hex,
            "span_id": ctx.span_hex,
            "parent_id": format(parent_id, "016x") if parent_id else "",
            "start_ns": start_ns,
            "dur_ns": max(end_ns - start_ns, 0),
            "wall_ns": time.time_ns(),
            "thread": threading.current_thread().name,
            "links": [
                {"trace_id": l.trace_hex, "span_id": l.span_hex}
                for l in links
            ],
            "attrs": attrs,
        }
    )


def record_event(kind: str, **fields) -> None:
    """Append one event; breaker-open / shed / fault events also dump
    the recorder to the log (the 'automatic on failure' contract) —
    cheap enough to call unconditionally from failure paths even when
    tracing is sampled out, since failures are rare by definition."""
    fields["kind"] = kind
    fields["ts_ns"] = time.monotonic_ns()
    rec = current_recorder()
    rec._events.record(fields)
    if kind in _DUMP_KINDS:
        rec._auto_dump(kind, fields)


def spans_snapshot(trace_id_hex: str = "", since_ns: int = 0,
                   limit: int = 0,
                   recorders: "Optional[Sequence[Recorder]]" = None
                   ) -> List[dict]:
    """Recorded spans, optionally filtered to one trace: a span matches
    when its own trace_id is the target OR it links the target (the
    batch span-link rule — a coalesced dispatch's stage spans belong to
    every lane's trace).  `since_ns` keeps only spans whose wall-clock
    end stamp is strictly newer (the incremental-poll cursor
    scripts/trace_collect.py advances per daemon); `limit` keeps the
    OLDEST N after filtering — the pagination order: a poller whose
    cursor tracks the max wall_ns it received gets the NEXT window on
    its next poll instead of skipping everything between its cursor
    and a newest-N slice.

    `recorders` restricts the read to an explicit recorder list (the
    gateway passes [service recorder, default] so a daemon's view is
    its own work plus unbound-thread spillover); None reads the union
    of every live recorder — the pre-refactor whole-process view."""
    spans: List[dict] = []
    for rec in (recorders if recorders is not None else all_recorders()):
        spans.extend(rec._spans.snapshot())
    if trace_id_hex:
        want = trace_id_hex.lower().lstrip("0x")
        want = want.zfill(32)
        spans = [
            s
            for s in spans
            if s["trace_id"] == want
            or any(l["trace_id"] == want for l in s["links"])
        ]
    if since_ns:
        spans = [s for s in spans if s.get("wall_ns", 0) > since_ns]
    if limit and len(spans) > limit:
        # Ring order is record order, which tracks wall order closely
        # but not exactly (wall_ns is stamped inside record_span);
        # sort by wall stamp so the oldest-N window and the caller's
        # max-wall cursor agree.  A page never ends MID-TIE: concurrent
        # record_span calls can stamp identical wall_ns, and cutting
        # between two equal stamps would let the poller's strict
        # `since >` cursor skip the tied remainder forever — so the
        # page extends through every span sharing the boundary stamp
        # (limit is a soft cap, exceeded only by the tie count).
        spans = sorted(spans, key=lambda s: s.get("wall_ns", 0))
        cut = spans[limit - 1].get("wall_ns", 0)
        spans = [s for s in spans if s.get("wall_ns", 0) <= cut]
    return spans


def events_snapshot(
    recorders: "Optional[Sequence[Recorder]]" = None,
) -> List[dict]:
    """Recorded events, merged across `recorders` (None = every live
    recorder) in monotonic-stamp order — ts_ns is process-monotonic, so
    cross-recorder merge order is exact."""
    recs = recorders if recorders is not None else all_recorders()
    if len(recs) == 1:
        return recs[0]._events.snapshot()
    events: List[dict] = []
    for rec in recs:
        events.extend(rec._events.snapshot())
    events.sort(key=lambda e: e.get("ts_ns", 0))
    return events


def reset() -> None:
    """Test hook: clear every live recorder's rings and this thread's
    context/binding."""
    for rec in all_recorders():
        rec.clear()
    _tls.ctx = None
    _tls.staged = None
    _tls.emitted = None
    _tls.recorder = None


# ---------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------
class _NoopSpan:
    """Shared do-nothing span: the zero-alloc disabled/unsampled path.
    Every method is a no-op; `bool(_NOOP)` is False so callers can
    branch on it."""

    __slots__ = ()
    ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def activate(self):
        return self

    def deactivate(self):
        pass

    def end(self, **attrs):
        pass

    def traceparent(self):
        return None

    def __bool__(self):
        return False


_NOOP = _NoopSpan()


class _Span:
    """A live sampled span.  Context-manager use (sync paths) pairs
    activate/deactivate with end; async paths call them explicitly —
    activate/deactivate on the submitting thread, end() from whatever
    completion thread finishes the request."""

    __slots__ = ("name", "ctx", "parent_id", "start_ns", "attrs", "links",
                 "_prev", "_prev_set", "_ended")

    def __init__(self, name: str, ctx: SpanContext, parent_id: int = 0,
                 links: Sequence[SpanContext] = (), **attrs):
        self.name = name
        self.ctx = ctx
        self.parent_id = parent_id
        self.links = tuple(links)
        self.attrs = attrs
        self.start_ns = time.monotonic_ns()
        self._prev = None
        self._prev_set = False
        self._ended = False

    def activate(self) -> "_Span":
        self._prev = getattr(_tls, "ctx", None)
        self._prev_set = True
        _tls.ctx = self.ctx
        _tls.emitted = format_traceparent(self.ctx)
        return self

    def deactivate(self) -> None:
        if self._prev_set:
            _tls.ctx = self._prev
            self._prev = None
            self._prev_set = False

    def traceparent(self) -> str:
        return format_traceparent(self.ctx)

    def end(self, **attrs) -> None:
        if self._ended:  # exactly-once: async finish paths can race
            return
        self._ended = True
        if attrs:
            self.attrs.update(attrs)
        record_span(
            self.name, self.ctx, parent_id=self.parent_id,
            start_ns=self.start_ns, end_ns=time.monotonic_ns(),
            links=self.links, **self.attrs,
        )

    def __enter__(self) -> "_Span":
        return self.activate()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.deactivate()
        if exc_type is not None:
            self.attrs["error"] = str(exc)
        self.end()
        return False


def ingress_span(edge: str, name: str, traceparent: Optional[str] = None,
                 **attrs):
    """Root/continuation span for one ingress request.  The ONE place
    the sampling dice is rolled — and the LOCAL rate always decides:
    an upstream `traceparent` contributes the trace id and parent span
    (so sampled requests still correlate with the caller's ids), but
    its sampled flag neither forces nor suppresses recording here.
    Headers arrive from untrusted clients: honoring flag=01 would let
    any caller stamp itself into 100% sampling (recorder flooding,
    trace bytes on every peer RPC — the overhead the bench gate
    bounds), and honoring flag=00 would let a proxy blind an operator
    running at sample 1.0."""
    if not enabled() or _rng().random() >= _SAMPLE:
        return _NOOP
    parent = parse_traceparent(traceparent) if traceparent else None
    if parent is not None:
        trace_id, parent_span, _flag = parent
    else:
        trace_id, parent_span = _rng().getrandbits(128) or 1, 0
    ctx = SpanContext(trace_id, _rng().getrandbits(64) or 1)
    return _Span(f"ingress.{edge}", ctx, parent_id=parent_span,
                 path=name, **attrs)


def take_emitted_traceparent() -> Optional[str]:
    """The traceparent the most recent ingress span on THIS thread
    emitted (survives span end — the stdlib gateway reads it after
    handle_request returns to stamp the response header)."""
    tp = getattr(_tls, "emitted", None)
    _tls.emitted = None
    return tp


# ---------------------------------------------------------------------
# Batch traces (the span-link machinery for coalesced work)
# ---------------------------------------------------------------------
class BatchTrace:
    """One coalesced unit of work (a window flush / device dispatch)
    carrying links to the member lanes' contexts.  `ctx` is the batch's
    own trace: the window span uses it directly and the per-stage
    dispatch spans parent under it."""

    __slots__ = ("ctx", "links")

    def __init__(self, links: Sequence[SpanContext]):
        self.ctx = SpanContext(
            _rng().getrandbits(128) or 1, _rng().getrandbits(64) or 1
        )
        self.links = tuple(links)


def new_batch(links: Sequence[SpanContext]) -> Optional[BatchTrace]:
    """BatchTrace for `links`, or None when there is nothing to link
    (the unsampled fast path: callers pass the None straight through)."""
    if not links or not enabled():
        return None
    return BatchTrace(links)


def stage_batch_trace(bt: Optional[BatchTrace]) -> None:
    """Hand a BatchTrace to the store pipeline through thread-local
    storage: apply_columns_async runs synchronously on the calling
    thread, and threading an argument through its (stable) signature
    would touch every store implementation."""
    _tls.staged = bt


def take_batch_trace() -> Optional[BatchTrace]:
    bt = getattr(_tls, "staged", None)
    _tls.staged = None
    return bt


def stage_span(stage: str, dur_s: float, bt: Optional[BatchTrace],
               **attrs) -> None:
    """One completed dispatch-pipeline stage span
    (dispatch.prepare/stage/launch/fetch/commit), parented under the
    batch's window span and linked to every member lane."""
    if bt is None:
        return
    end = time.monotonic_ns()
    record_span(
        f"dispatch.{stage}",
        SpanContext(bt.ctx.trace_id, _rng().getrandbits(64) or 1),
        parent_id=bt.ctx.span_id,
        start_ns=end - int(dur_s * 1e9),
        end_ns=end,
        links=bt.links,
        **attrs,
    )


def batch_span(name: str, bt: Optional[BatchTrace], start_ns: int,
               end_ns: int, **attrs) -> None:
    """One completed child span of a batch trace (the GlobalManager's
    global.collective / global.broadcast / global.hits legs), parented
    under the batch root and carrying its links."""
    if bt is None:
        return
    record_span(
        name,
        SpanContext(bt.ctx.trace_id, _rng().getrandbits(64) or 1),
        parent_id=bt.ctx.span_id,
        start_ns=start_ns,
        end_ns=end_ns,
        links=bt.links,
        **attrs,
    )


def request_links(cols) -> List[SpanContext]:
    """Links for a dispatch built from `cols`: the thread's ambient
    context (local ingress) plus any wire trace-context column a peer
    frame/proto carried (cols.trace_ctx: (lane_lo, lane_hi, trace_id,
    span_id) ranges)."""
    if not enabled():
        return []
    links: List[SpanContext] = []
    cur = current()
    if cur is not None:
        links.append(cur)
    entries = getattr(cols, "trace_ctx", None)
    if entries:
        seen = {(cur.trace_id, cur.span_id)} if cur is not None else set()
        for _lo, _hi, tid, sid in entries:
            if (tid, sid) not in seen:
                seen.add((tid, sid))
                links.append(SpanContext(tid, sid))
    return links


def links_to_entries(
    links: Sequence[SpanContext], lo: int, hi: int
) -> List[Tuple[int, int, int, int]]:
    """Wire trace-context entries covering lanes [lo, hi) for every
    linked context (peer_client packs these into the frame trailer /
    proto column)."""
    return [(lo, hi, l.trace_id, l.span_id) for l in links]


# Module init: honor the environment (daemons call set_sample_rate from
# their parsed config as well; library users get the env default).
set_sample_rate(_env_sample())
