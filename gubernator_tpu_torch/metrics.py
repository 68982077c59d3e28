"""Prometheus metrics with reference name parity.

Metric names match the reference exactly so dashboards/alerts port
unchanged: gubernator_cache_size + gubernator_cache_access_count
(cache.go:88-92,205-218), gubernator_grpc_request_counts +
gubernator_grpc_request_duration (grpc_stats.go:45-59),
gubernator_async_durations + gubernator_broadcast_durations
(global.go:40-56).

The port of the JAX package's metrics.py: every family and label under
the same name (`scripts/check_metrics_parity.py`), the
`gubernator_xla_*` families included, which here count the port's
kernel builds and first launches (telemetry.py).  Device memory is the
CUDA caching allocator's, sampled per scrape.  This is the only module of
the port that imports prometheus_client.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    Summary,
    generate_latest,
)

from . import audit as audit_mod
from . import profiling, saturation, telemetry, tracing

try:  # OpenMetrics exposition carries trace exemplars; text 0.0.4 cannot
    from prometheus_client.openmetrics.exposition import (
        CONTENT_TYPE_LATEST as OPENMETRICS_CONTENT_TYPE,
    )
    from prometheus_client.openmetrics.exposition import (
        generate_latest as openmetrics_latest,
    )
except ImportError:  # pragma: no cover — ancient prometheus_client
    OPENMETRICS_CONTENT_TYPE = ""
    openmetrics_latest = None


class Metrics:
    def __init__(self):
        self.registry = CollectorRegistry()
        # Serializes collect-on-scrape refresh + render: two racing
        # scrapers must never interleave a take_pipeline_stats drain
        # with another's clear()+set() (a drained-but-not-yet-rendered
        # sample would silently vanish).  Held by the gateway /metrics
        # handler around the whole observe_*+render sequence.
        self.scrape_lock = threading.Lock()
        self.cache_size = Gauge(
            "gubernator_cache_size",
            "The number of items in LRU Cache which holds the rate limits.",
            registry=self.registry,
        )
        self.cache_access_count = Counter(
            "gubernator_cache_access_count",
            "Cache access counts.",
            ["type"],
            registry=self.registry,
        )
        self.request_counts = Counter(
            "gubernator_grpc_request_counts",
            "The count of gRPC requests.",
            ["status", "method"],
            registry=self.registry,
        )
        self.request_duration = Summary(
            "gubernator_grpc_request_duration",
            "The timings of gRPC requests in seconds.",
            ["method"],
            registry=self.registry,
        )
        # Histogram twin of request_duration, bucketed for latency SLOs
        # and carrying TRACE EXEMPLARS (tracing.py): each bucket
        # remembers one recent trace id, rendered on the OpenMetrics
        # exposition so a dashboard latency spike links straight to a
        # recorded trace.  The Summary above keeps reference name
        # parity; this is the observability extension.
        self.request_duration_hist = Histogram(
            "gubernator_request_duration_seconds",
            "RPC latency histogram with trace exemplars.",
            ["method"],
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5, 5.0),
            registry=self.registry,
        )
        self.build_info = Gauge(
            "gubernator_build_info",
            "Constant 1, labeled with the daemon build version, the "
            "store's device type, and its shard count.",
            ["version", "backend", "mesh"],
            registry=self.registry,
        )
        self.async_durations = Summary(
            "gubernator_async_durations",
            "The duration of GLOBAL async sends in seconds.",
            registry=self.registry,
        )
        self.broadcast_durations = Summary(
            "gubernator_broadcast_durations",
            "The duration of GLOBAL broadcasts to peers in seconds.",
            registry=self.registry,
        )
        # -- peer fault tolerance (faults.py) --------------------------
        self.circuit_state = Gauge(
            "gubernator_circuit_breaker_state",
            "Per-peer circuit breaker state (0 closed, 1 half-open, 2 open).",
            ["peer"],
            registry=self.registry,
        )
        self.circuit_transitions = Counter(
            "gubernator_circuit_breaker_transitions",
            "Circuit breaker state transitions per peer.",
            ["peer", "to"],
            registry=self.registry,
        )
        self.peer_retries = Counter(
            "gubernator_peer_retry_count",
            "Retries of peer sends after a transport failure, by loop.",
            ["op"],  # forward | global_hits | global_broadcast | multi_region
            registry=self.registry,
        )
        self.degraded_evals = Counter(
            "gubernator_degraded_local_evals",
            "Forwarded keys served by degraded local evaluation because "
            "the owner's circuit breaker was open.",
            registry=self.registry,
        )
        # -- columnar peer hop (wire.py, peer_client.py) ---------------
        self.peer_columns_batches = Counter(
            "gubernator_peer_columns_batches",
            "Forwarded peer batches by negotiated wire encoding "
            "(columns = zero-dataclass fast path, classic = per-request "
            "JSON/protobuf fallback to a pre-columns peer).",
            ["encoding"],
            registry=self.registry,
        )
        # -- public columnar ingress (wire.py, gateway/grpc edges) -----
        self.ingress_columns_batches = Counter(
            "gubernator_ingress_columns_batches",
            "Public GetRateLimits batches served from the columnar "
            "ingress path by wire encoding (frame = GUBC kind-5 on the "
            "HTTP gateway, proto = V1/GetRateLimitsColumns over gRPC).",
            ["encoding"],
            registry=self.registry,
        )
        # -- native service loop (host_runtime.cpp gt_ingress_*) -------
        self.native_ingress_batches = Counter(
            "gubernator_native_ingress_batches",
            "Coalesced batches the native ingress service loop handed "
            "to the Python pump (stat = frames/lanes/batches/fallbacks; "
            "fallbacks = kind-5 frames that took the Python path for "
            "semantics the fast lane does not serve).",
            ["stat"],
            registry=self.registry,
        )
        # -- millisecond express lane (architecture.md "Express lane") -
        self.express_lanes = Counter(
            "gubernator_express_lanes_total",
            "Ingress lanes by dispatch path (bypass = batcher "
            "shallow-queue bypass, scalar = host-side small-batch "
            "slot, native = NO_BATCHING frames on the native express "
            "queue, windowed = lanes that rode a coalesced batch — a "
            "window flush or the native ring's bulk path).",
            ["path"],
            registry=self.registry,
        )
        self.express_hit_ratio = Gauge(
            "gubernator_express_hit_ratio",
            "Fraction of batcher/native ingress lanes that took an "
            "express path (bypass + native over those plus windowed), "
            "cumulative since start.",
            registry=self.registry,
        )
        self.readback_retries = Counter(
            "gubernator_readback_retries_total",
            "Device->host readbacks retried (the JAX package's CPU "
            "readback flake; a CUDA readback is never retried, so 0).",
            registry=self.registry,
        )
        self.ingress_acceptor_requests = Gauge(
            "gubernator_ingress_acceptor_requests",
            "Requests parsed per native acceptor loop (GUBER_ACCEPTORS "
            "SO_REUSEPORT sharding + the GUBER_UDS_PATH lane; the "
            "fairness surface — all acceptors of a loaded group must "
            "show progress).",
            ["acceptor", "transport"],
            registry=self.registry,
        )
        self.ingress_acceptor_conns = Gauge(
            "gubernator_ingress_acceptor_conns",
            "Connections accepted per native acceptor loop (cumulative).",
            ["acceptor", "transport"],
            registry=self.registry,
        )
        self.ingress_acceptor_frames = Gauge(
            "gubernator_ingress_acceptor_frames",
            "Kind-5 ingress frames consumed by the native fast lane per "
            "acceptor loop (cumulative).",
            ["acceptor", "transport"],
            registry=self.registry,
        )
        self.ingress_acceptor_lanes = Gauge(
            "gubernator_ingress_acceptor_lanes",
            "Rate-limit check lanes consumed by the native fast lane "
            "per acceptor loop (cumulative).",
            ["acceptor", "transport"],
            registry=self.registry,
        )
        # -- columnar GLOBAL replication plane (service.GlobalManager) -
        self.global_broadcast_batches = Counter(
            "gubernator_global_broadcast_batches",
            "GLOBAL broadcast sends by negotiated wire encoding "
            "(columns = encode-once GlobalsColumns fast path, classic "
            "= per-item JSON/protobuf fallback to a pre-columns peer).",
            ["encoding"],
            registry=self.registry,
        )
        self.global_fanout_concurrency = Gauge(
            "gubernator_global_fanout_concurrency",
            "Concurrent peer sends of the last GLOBAL broadcast "
            "fan-out (bounded by GUBER_GLOBAL_FANOUT).",
            registry=self.registry,
        )
        self.global_requeued_hits = Counter(
            "gubernator_global_requeued_hits",
            "Aggregated GLOBAL hit lanes (one per key) requeued into "
            "the next sync tick after an unroutable owner or a "
            "provably-unapplied send failure (the pre-columns sender "
            "silently dropped these).",
            registry=self.registry,
        )
        self.global_dropped_hits = Counter(
            "gubernator_global_dropped_hits",
            "Aggregated GLOBAL hit lanes dropped: timeout-shaped send "
            "failures that may have applied server-side (requeueing "
            "would double-count) or requeue-carry overflow.",
            registry=self.registry,
        )
        # -- multi-region federation plane (federation.py) -------------
        self.region_batches = Counter(
            "gubernator_region_batches",
            "Cross-region hit batches sent by negotiated wire encoding "
            "(columns = encode-once RegionColumns fast path, classic = "
            "per-item GetPeerRateLimits fallback to a pre-federation "
            "peer or GUBER_REGION_COLUMNS=0).",
            ["encoding"],
            registry=self.registry,
        )
        self.region_carry_keys = Gauge(
            "gubernator_region_carry_keys",
            "Distinct keys in the federation requeue carry, summed over "
            "destination regions (bounded at federation.REGION_CARRY_MAX "
            "per region; the region_slack audit invariant checks it).",
            registry=self.registry,
        )
        self.region_requeued_hits = Counter(
            "gubernator_region_requeued_hits",
            "Aggregated cross-region hit lanes (one per key) requeued "
            "into a destination region's next flush after a "
            "provably-unapplied send failure (breaker fast-fail, "
            "connection-level not-ready, unroutable owner).",
            registry=self.registry,
        )
        self.region_dropped_hits = Counter(
            "gubernator_region_dropped_hits",
            "Aggregated cross-region hit lanes dropped counted: "
            "timeout-shaped send failures that may have applied "
            "remotely (re-sending would double-count), requeue-carry "
            "overflow, or a destination region leaving the membership.",
            registry=self.registry,
        )
        # -- bounded ingress queue (service._IngressGate) --------------
        self.ingress_shed = Counter(
            "gubernator_ingress_shed_total",
            "Lanes shed by the bounded ingress queue "
            "(GUBER_INGRESS_QUEUE_LANES) with a 429-style error.",
            registry=self.registry,
        )
        # -- overlapped dispatch pipeline (models/shard.py) ------------
        self.dispatch_inflight = Gauge(
            "gubernator_dispatch_inflight",
            "Columnar batches dispatched to the device but not yet "
            "resolved (the dispatch pipeline's depth at scrape time).",
            registry=self.registry,
        )
        self.dispatch_inflight_hwm = Gauge(
            "gubernator_dispatch_inflight_hwm",
            "High-water mark of the dispatch pipeline depth since the "
            "previous scrape.",
            registry=self.registry,
        )
        self.dispatch_stage_seconds = Gauge(
            "gubernator_dispatch_stage_seconds",
            "Per-stage dispatch pipeline timings since the previous "
            "scrape (prepare/stage/launch/fetch/commit; stat = "
            "count/sum/max).  Cleared and rebuilt per scrape like the "
            "circuit-breaker gauges, so a quiet store reports nothing "
            "rather than a stale distribution.",
            ["stage", "stat"],
            registry=self.registry,
        )
        # -- saturation & SLO observability plane (saturation.py) ------
        self.latency_attribution = Histogram(
            "gubernator_latency_attribution_seconds",
            "Per-phase latency attribution across the request "
            "waterfall (ingress parse -> batch-window wait -> queue "
            "wait -> dispatch prepare/stage/launch/fetch/commit -> "
            "peer-wire RTT -> response encode).  Always-on; the same "
            "observations back GET /debug/latency's percentile "
            "snapshots.",
            ["phase"],
            buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                     0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0),
            registry=self.registry,
        )
        # This instance becomes the plane's histogram sink (last-wins,
        # like the tracing flight recorder: one daemon per process in
        # production).
        saturation.register_sink(self.latency_attribution)
        self.occupancy_slots = Gauge(
            "gubernator_occupancy_slots",
            "Mapped bucket-table slots per shard and tier, read from "
            "the host tables the existing dispatch readbacks maintain "
            "(ZERO extra device programs — pinned by a dispatch-count "
            "test).",
            ["shard", "tier"],
            registry=self.registry,
        )
        self.occupancy_capacity = Gauge(
            "gubernator_occupancy_capacity",
            "Bucket-table slot capacity per shard and tier.",
            ["shard", "tier"],
            registry=self.registry,
        )
        self.occupancy_evictions = Counter(
            "gubernator_occupancy_evictions",
            "LRU evictions per shard (capacity pressure; an eviction "
            "under load is reference-grade state loss).",
            ["shard"],
            registry=self.registry,
        )
        self.ingress_queue_lanes = Gauge(
            "gubernator_ingress_queue_lanes",
            "Lanes currently queued in the bounded ingress gates "
            "(sum of the local and columnar batchers) at scrape time; "
            "GET /debug/status carries the admit-time depth "
            "distribution.",
            registry=self.registry,
        )
        self.batch_window_wait_seconds = Gauge(
            "gubernator_batch_window_wait_seconds",
            "EFFECTIVE coalescing-window wait the next ingress flush "
            "will use (the adaptive window's current estimate; upper-"
            "bounded by GUBER_BATCH_WAIT).",
            registry=self.registry,
        )
        self.lane_utilization = Gauge(
            "gubernator_lane_utilization",
            "Per-launch lane utilization since the previous scrape: "
            "stat=lanes (real), stat=padded (pow2-padded shape "
            "scattered), stat=ratio (fill fraction), stat=launches.  "
            "Cleared per scrape.",
            ["stat"],
            registry=self.registry,
        )
        self.dispatcher_busy_ratio = Gauge(
            "gubernator_dispatcher_busy_ratio",
            "Fraction of wall time the ingress dispatcher (batch-"
            "window flush worker) spent flushing since the previous "
            "scrape — the USE utilization signal for the host "
            "dispatch tier.",
            registry=self.registry,
        )
        self.slo_latency_target_ms = Gauge(
            "gubernator_slo_latency_target_ms",
            "Configured ingress latency SLO target "
            "(GUBER_LATENCY_TARGET_MS; 0 = SLO engine disabled).",
            registry=self.registry,
        )
        self.slo_burn_rate = Gauge(
            "gubernator_slo_burn_rate",
            "Error-budget burn rate per window (bad-fraction / "
            "budget-fraction; 1.0 burns the budget exactly at accrual "
            "rate, >=14.4 on the 5m window trips the flight-recorder "
            "dump).",
            ["window"],
            registry=self.registry,
        )
        self.slo_requests = Counter(
            "gubernator_slo_requests",
            "Ingress requests judged against the latency SLO target.",
            ["verdict"],  # good | bad
            registry=self.registry,
        )
        self._slo_good = self.slo_requests.labels(verdict="good")
        self._slo_bad = self.slo_requests.labels(verdict="bad")
        self.hotkey_lanes = Counter(
            "gubernator_hotkey_lanes",
            "Lanes folded into the hot-key count-min sketch "
            "(hash_ring owner-code hashes; GET /debug/hotkeys serves "
            "the top-K).",
            registry=self.registry,
        )
        self.hotkey_topk = Gauge(
            "gubernator_hotkey_topk",
            "Decayed count-min estimates of the current hot-key "
            "top-K (bounded cardinality; rebuilt per scrape).",
            ["key"],
            registry=self.registry,
        )
        # -- elastic membership / resharding (reshard.py) --------------
        self.reshard_transfers = Counter(
            "gubernator_reshard_transfers",
            "Ownership-transfer batches by outcome: started (drained "
            "and sent), committed (merge-applied by the new owner), "
            "aborted (reinstalled locally after a send failure, "
            "unsupported peer, or epoch fence — the bounded "
            "reset-on-move fallback), fenced (receive-side dead-epoch "
            "rejections).",
            ["result"],
            registry=self.registry,
        )
        self.reshard_lanes = Counter(
            "gubernator_reshard_lanes",
            "Transferred counter lanes by direction: out (drained and "
            "committed at a new owner), in (merge-committed here), "
            "rejected (received but not owned under the current ring).",
            ["direction"],
            registry=self.registry,
        )
        self.reshard_handoff_seconds = Gauge(
            "gubernator_reshard_handoff_seconds",
            "Wall time of the last drain->transfer handoff pass "
            "(set per scrape).",
            registry=self.registry,
        )
        self.ring_generation = Gauge(
            "gubernator_ring_generation",
            "Monotonic membership-change counter of this daemon's peer "
            "ring (bumped by every set_peers that changes membership).",
            registry=self.registry,
        )
        # -- XLA / device telemetry plane (telemetry.py) ---------------
        self.xla_compiles = Counter(
            "gubernator_xla_compiles",
            "Device program builds and first launches since start, by "
            "label (build:<library> for an nvcc or g++ build, "
            "first-launch:<kernel> for a kernel's first launch).",
            ["program"],
            registry=self.registry,
        )
        self.xla_compile_seconds = Counter(
            "gubernator_xla_compile_seconds",
            "Cumulative build wall seconds per label (first launches "
            "count no time).",
            ["program"],
            registry=self.registry,
        )
        self.xla_steady_recompiles = Counter(
            "gubernator_xla_steady_recompiles",
            "Builds and first launches AFTER startup warmup completed; "
            "a burst fires the recompile-storm flight-recorder dump.",
            ["program"],
            registry=self.registry,
        )
        self.xla_program_runs = Gauge(
            "gubernator_xla_program_runs",
            "Per-program launch timings since the previous scrape "
            "(stat = count/sum/max seconds; enqueue wall time).  "
            "Cleared per scrape like the dispatch-stage gauges.",
            ["program", "stat"],
            registry=self.registry,
        )
        self.device_memory_bytes = Gauge(
            "gubernator_device_memory_bytes",
            "Memory of the store's CUDA device sampled at scrape time "
            "(stat = bytes_in_use/peak_bytes_in_use from the caching "
            "allocator, bytes_limit the card's total).",
            ["device", "stat"],
            registry=self.registry,
        )
        self.device_live_buffers = Gauge(
            "gubernator_device_live_buffers",
            "Live buffers per device at scrape time (the caching "
            "allocator keeps no count: 0).",
            ["device"],
            registry=self.registry,
        )
        # -- durability plane (snapshot.py) ----------------------------
        self.snapshot_writes = Counter(
            "gubernator_snapshot_writes",
            "Crash-safe snapshot dumps by result: ok (gathered, "
            "encoded, fsync'd, atomically renamed) or error (counted "
            "and logged; the serving path and shutdown never fail on a "
            "failed dump).",
            ["result"],
            registry=self.registry,
        )
        self.snapshot_restores = Counter(
            "gubernator_snapshot_restores",
            "Boot-time snapshot restores by result: ok (merge-"
            "committed), absent (no file — cold start), rejected "
            "(corrupt/truncated/wrong-version/checksum — LOUD cold "
            "start with a snapshot-rejected flight-recorder dump).",
            ["result"],
            registry=self.registry,
        )
        self.snapshot_lanes = Counter(
            "gubernator_snapshot_lanes",
            "Bucket lanes crossing the durability plane by direction: "
            "saved (gathered into a completed dump) or restored "
            "(merge-committed at boot).",
            ["direction"],
            registry=self.registry,
        )
        self.snapshot_age_seconds = Gauge(
            "gubernator_snapshot_age_seconds",
            "Seconds since the last successful snapshot dump (set per "
            "scrape; -1 = no successful dump yet / plane disabled).  "
            "The staleness-slack contract bounds over-admission after "
            "a crash by the hits admitted inside this window.",
            registry=self.registry,
        )
        # -- cost observatory (profiling.py) ---------------------------
        self.tenant_cost = Gauge(
            "gubernator_tenant_cost",
            "Per-tenant cost attribution, TOP-K ONLY (tenant = the "
            "rate-limit name; cardinality bounded at GUBER_TENANT_TOPK "
            "label values, rebuilt per scrape so departed tenants drop "
            "off).  stat = hits/lanes/over_limit/shed/ingress_bytes "
            "(exact accumulators) plus lane_time_seconds/queue_seconds "
            "(proportional shares: tenant lanes x the process-wide "
            "per-lane cost).",
            ["tenant", "stat"],
            registry=self.registry,
        )
        self.tenant_other = Gauge(
            "gubernator_tenant_other",
            "The `other` rollup of every tenant outside the top-K "
            "(same stats as gubernator_tenant_cost; rows + other == "
            "totals exactly — the ledger conserves on eviction).",
            ["stat"],
            registry=self.registry,
        )
        self.tenant_total = Gauge(
            "gubernator_tenant_total",
            "Whole-daemon tenant-ledger totals (the conservation "
            "denominator: hits here reconcile against the audit "
            "ledger's ingress_hits + peer_ingress_hits at quiesce).",
            ["stat"],
            registry=self.registry,
        )
        self.profile_samples = Counter(
            "gubernator_profile_samples",
            "Stack samples folded by the continuous host profiler "
            "(GUBER_PROFILE_HZ ticks x threads; GET /debug/pprof "
            "serves the collapsed windows).",
            registry=self.registry,
        )
        self.profile_hz = Gauge(
            "gubernator_profile_hz",
            "Configured host-profiler sampling rate (0 = the plane is "
            "compiled out, GUBER_PROFILE=0).",
            registry=self.registry,
        )
        # -- conservation audit (audit.py) -----------------------------
        self.audit_violations = Counter(
            "gubernator_audit_violations_total",
            "Conservation-audit invariant violations (device/forward/"
            "global/reshard hit conservation, GLOBAL carry slack, "
            "negative remaining).  Any increment is a double-commit or "
            "lost-hits class bug; each also dumps the flight recorder.",
            ["invariant"],
            registry=self.registry,
        )
        self.audit_checks = Counter(
            "gubernator_audit_checks_total",
            "Conservation-audit reconciliation passes completed.",
            registry=self.registry,
        )
        self.audit_ledger = Gauge(
            "gubernator_audit_ledger",
            "Conservation-ledger counters (baseline-relative deltas "
            "the audit reconciles), exported for dashboards; the "
            "invariant verdicts live in "
            "gubernator_audit_violations_total.",
            ["entry"],
            registry=self.registry,
        )
        # -- incident black box (blackbox.py) --------------------------
        self.blackbox_frames = Counter(
            "gubernator_blackbox_frames",
            "Wire frames captured by the incident black box's traffic "
            "tap, by wire plane (ring eviction does not decrement — "
            "this counts everything that passed the tap).",
            ["wire"],
            registry=self.registry,
        )
        self.blackbox_ring_bytes = Gauge(
            "gubernator_blackbox_ring_bytes",
            "Current bytes held in each black-box capture ring "
            "(byte-budgeted: GUBER_BLACKBOX_MB split across wires).",
            ["wire"],
            registry=self.registry,
        )
        self.blackbox_bundles = Counter(
            "gubernator_blackbox_bundles",
            "Incident bundles written (trigger-coalesced and "
            "rate-limited; retention-pruned bundles still count).",
            registry=self.registry,
        )
        self.blackbox_last_trigger_age = Gauge(
            "gubernator_blackbox_last_trigger_age_seconds",
            "Seconds since the last black-box trigger (auto-dump event "
            "or POST /debug/incident); -1 = never triggered.",
            registry=self.registry,
        )
        # SloEngine (saturation.py), attached by the owning V1Service;
        # observe_latency judges GetRateLimits requests against it.
        self.slo = None

    @contextmanager
    def observe_rpc(self, method: str):
        """Count + time one RPC by fully-qualified method name — the
        per-RPC tagging of the reference's stats handler
        (grpc_stats.go:95-118).  Status label is the WIRE outcome: "0"
        unless the handler raised (an unhealthy HealthCheck payload is
        still a successful RPC)."""
        start = time.perf_counter()
        status = "0"
        try:
            yield
        except BaseException:
            status = "1"
            raise
        finally:
            dt = time.perf_counter() - start
            self.request_counts.labels(status=status, method=method).inc()
            self.request_duration.labels(method=method).observe(dt)
            self.observe_latency(method, dt)

    def observe_latency(self, method: str, dt: float, ctx=None) -> None:
        """Histogram observation with a trace exemplar — shared by the
        sync observe_rpc (ambient per-thread context) and the async
        gateway finish path (which passes its span's context explicitly:
        completion threads have no ambient one)."""
        if method == "/pb.gubernator.V1/GetRateLimits":
            # SLO + attribution accounting for the public ingress RPC:
            # the whole-request wall time is the waterfall's root row,
            # and the SLO engine judges it against the latency target.
            saturation.observe_phase("ingress.total", dt)
            if self.slo is not None:
                good = self.slo.observe(dt)
                if good is not None:
                    (self._slo_good if good else self._slo_bad).inc()
        hist = self.request_duration_hist.labels(method=method)
        if ctx is None and tracing.enabled():
            ctx = tracing.current()
        if ctx is not None:
            try:
                hist.observe(dt, exemplar={"trace_id": ctx.trace_hex})
                return
            except (TypeError, ValueError):  # pragma: no cover
                pass  # prometheus_client without exemplar support
        hist.observe(dt)

    def render(self) -> bytes:
        return generate_latest(self.registry)

    def render_negotiated(self, accept: str) -> "tuple[str, bytes]":
        """(content_type, payload) honoring the scraper's Accept
        header: `application/openmetrics-text` gets the OpenMetrics
        exposition — the only format that carries the trace exemplars —
        everyone else the classic text format."""
        if "application/openmetrics-text" in (accept or "") and (
            openmetrics_latest is not None
        ):
            return OPENMETRICS_CONTENT_TYPE, openmetrics_latest(self.registry)
        return "text/plain; version=0.0.4", self.render()

    def set_build_info(self, store) -> None:
        """Pin the build-info series: version from the package, backend
        and mesh from the store's `describe_topology` (device type,
        shard count)."""
        from . import __version__

        describe = getattr(store, "describe_topology", None)
        backend, mesh = ("unknown", "none")
        if describe is not None:
            try:
                backend, mesh = describe()
            except Exception:  # noqa: BLE001 — labels must never fail startup
                pass
        self.build_info.labels(
            version=__version__, backend=backend, mesh=mesh
        ).set(1)

    def observe_cache(self, store) -> None:
        """Refresh cache gauges from a ShardStore/MeshBucketStore."""
        self.cache_size.set(store.size())
        tables = getattr(store, "tables", None) or [store.table]
        hits = sum(t.hits for t in tables)
        misses = sum(t.misses for t in tables)
        # Counters are monotonic: set via inc of the delta.
        self._bump(self.cache_access_count.labels(type="hit"), hits)
        self._bump(self.cache_access_count.labels(type="miss"), misses)

    def observe_peers(self, peers) -> None:
        """Refresh the per-peer breaker state gauge from live
        PeerClients (collect-on-scrape, like observe_cache).  Rebuilt
        from scratch each scrape: a peer that left the cluster must
        drop off the gauge, not freeze at its last state forever."""
        self.circuit_state.clear()
        for p in peers:
            breaker = getattr(p, "breaker", None)
            info = getattr(p, "info", None)
            if breaker is None or info is None:
                continue
            self.circuit_state.labels(peer=info.grpc_address).set(
                breaker.state_code
            )

    def observe_dispatch(self, store) -> None:
        """Refresh the dispatch-pipeline gauges from a store
        (collect-on-scrape).  Per-stage series are cleared first — the
        stats are deltas since the last scrape (the PR 1 breaker-gauge
        convention), so departed stages drop off instead of freezing."""
        take = getattr(store, "take_pipeline_stats", None)
        if take is None:
            return
        stats, depth, hwm = take()
        self.dispatch_inflight.set(depth)
        self.dispatch_inflight_hwm.set(hwm)
        self.dispatch_stage_seconds.clear()
        for stage, (count, total_s, max_s) in stats.items():
            lab = self.dispatch_stage_seconds.labels
            lab(stage=stage, stat="count").set(count)
            lab(stage=stage, stat="sum").set(total_s)
            lab(stage=stage, stat="max").set(max_s)

    def observe_saturation(self, service) -> None:
        """Refresh the saturation/SLO plane gauges (collect-on-scrape,
        under the gateway's scrape lock like every other observer).
        Everything read here is host-side state the dispatch path
        already maintains — the scrape launches no device program."""
        store = service.store
        occupancy = getattr(store, "occupancy_stats", None)
        self.occupancy_slots.clear()
        self.occupancy_capacity.clear()
        if occupancy is not None:
            for row in occupancy():
                sh = str(row["shard"])
                slots, caps = self.occupancy_slots, self.occupancy_capacity
                slots.labels(shard=sh, tier="front").set(row["used"])
                caps.labels(shard=sh, tier="front").set(row["capacity"])
                self._bump(
                    self.occupancy_evictions.labels(shard=sh),
                    row["evictions"],
                )
                if "back_used" in row:
                    slots.labels(shard=sh, tier="back").set(row["back_used"])
                    caps.labels(shard=sh, tier="back").set(
                        row["back_capacity"]
                    )
        self.ingress_queue_lanes.set(service.ingress_queued_lanes())
        self.batch_window_wait_seconds.set(
            service.columnar_batcher._window.effective_wait_s()
        )
        lanes, padded, launches = saturation.lane_util.take()
        self.lane_utilization.clear()
        lab = self.lane_utilization.labels
        lab(stat="lanes").set(lanes)
        lab(stat="padded").set(padded)
        lab(stat="launches").set(launches)
        if padded:
            lab(stat="ratio").set(lanes / padded)
        busy, elapsed = saturation.dispatcher_busy.take()
        self.dispatcher_busy_ratio.set(min(busy / elapsed, 1.0))
        # Express lane: per-path lane deltas since the last scrape plus
        # the cumulative hit rate (saturation.ExpressStats).
        for path, lanes in saturation.express.take().items():
            if lanes:
                self.express_lanes.labels(path=path).inc(lanes)
        self.express_hit_ratio.set(
            saturation.express.snapshot()["hitRate"]
        )
        # Readback retry counter (models/shard.py): delta against the
        # cumulative module total, the native-shed pattern.
        from .models import shard as _shard

        retries = _shard.readback_retries_total()
        prev = getattr(self, "_readback_retries_seen", 0)
        if retries > prev:
            self.readback_retries.inc(retries - prev)
            self._readback_retries_seen = retries
        slo = self.slo
        if slo is not None:
            self.slo_latency_target_ms.set(slo.target_ms if slo.enabled else 0)
            for name, w in slo.WINDOWS.items():
                self.slo_burn_rate.labels(window=name).set(slo.burn_rate(w))
        sketch = getattr(service, "hotkeys", None)
        if sketch is not None:
            snap = sketch.snapshot()
            self._bump(self.hotkey_lanes, snap["total_lanes"])
            self.hotkey_topk.clear()
            for row in snap["topk"]:
                self.hotkey_topk.labels(key=row["key"]).set(row["estimate"])
        # Elastic membership: ring generation + last handoff wall time
        # (the counters are incremented live by the ReshardManager).
        self.ring_generation.set(getattr(service, "ring_generation", 0))
        mgr = getattr(service, "reshard", None)
        if mgr is not None:
            self.reshard_handoff_seconds.set(mgr.last_handoff_seconds)
        # Durability plane: snapshot staleness (the slack-contract
        # numerator; counters are incremented live by SnapshotManager).
        snaps = getattr(service, "snapshots", None)
        if snaps is not None:
            self.snapshot_age_seconds.set(
                time.time() - snaps.last_save_unix
                if snaps.last_save_unix else -1.0
            )

    def observe_native_ingress(self, service) -> None:
        """Refresh the native-service-loop families (collect-on-scrape,
        under the scrape lock like every observer): per-acceptor
        counters from the epoll edges (the REUSEPORT fairness surface)
        and the pump's batch/fallback/shed totals.  Native sheds feed
        the SAME gubernator_ingress_shed_total the Python gate
        increments — one overload signal regardless of which tier
        declined the work — via a delta so the two sources compose."""
        for edge in getattr(service, "native_edges", ()):
            try:
                rows = edge.acceptor_stats()
            except (OSError, AttributeError):
                continue
            for i, row in enumerate(rows):
                transport = "uds" if row["uds"] else "tcp"
                lab = {"acceptor": str(i), "transport": transport}
                self.ingress_acceptor_conns.labels(**lab).set(row["accepted"])
                self.ingress_acceptor_requests.labels(**lab).set(
                    row["requests"]
                )
                self.ingress_acceptor_frames.labels(**lab).set(
                    row["ingressFrames"]
                )
                self.ingress_acceptor_lanes.labels(**lab).set(
                    row["ingressLanes"]
                )
        pump = getattr(service, "native_ingress", None)
        if pump is None:
            return
        stats = pump.stats()
        for stat in ("frames", "lanes", "batches", "fallbacks"):
            self._bump(
                self.native_ingress_batches.labels(stat=stat), stats[stat]
            )
        shed = stats["shedLanes"]
        prev = getattr(self, "_native_shed_seen", 0)
        if shed > prev:
            self.ingress_shed.inc(shed - prev)
            self._native_shed_seen = shed

    def observe_telemetry(self, device=None) -> None:
        """Refresh the device telemetry families from the process-global
        telemetry plane (collect-on-scrape, under the scrape lock like
        every observer).  Per-program launch timings are drained per
        scrape; build counters bump to the cumulative plane totals; the
        memory of `device` (the store's) is sampled here from the CUDA
        caching allocator."""
        if not telemetry.enabled():
            return
        for label, row in telemetry.compile_snapshot().items():
            self._bump(self.xla_compiles.labels(program=label), row["count"])
            self._bump(
                self.xla_compile_seconds.labels(program=label),
                row["total_s"],
            )
            self._bump(
                self.xla_steady_recompiles.labels(program=label),
                row["steady_recompiles"],
            )
        self.xla_program_runs.clear()
        for label, (count, total_s, max_s) in telemetry.take_exec_stats().items():
            lab = self.xla_program_runs.labels
            lab(program=label, stat="count").set(count)
            lab(program=label, stat="sum").set(total_s)
            lab(program=label, stat="max").set(max_s)
        self.device_memory_bytes.clear()
        self.device_live_buffers.clear()
        for row in telemetry.device_snapshot(device):
            dev = row["device"]
            for stat in ("bytes_in_use", "peak_bytes_in_use",
                         "bytes_limit", "live_bytes"):
                if stat in row:
                    self.device_memory_bytes.labels(
                        device=dev, stat=stat
                    ).set(row[stat])
            self.device_live_buffers.labels(device=dev).set(
                row.get("live_buffers", 0)
            )

    def observe_cost(self, service) -> None:
        """Refresh the cost-observatory families from the service's
        tenant ledger and the process-global profiler (collect-on-
        scrape, under the scrape lock like every observer).  Per-tenant
        series are REBUILT each scrape from the top-K — the cardinality
        bound the Zipf test pins (<= K tenant label values + the one
        `other` rollup, under any number of distinct names)."""
        tenants = getattr(service, "tenants", None)
        if tenants is not None:
            snap = tenants.snapshot()
            stat_keys = (
                ("hits", "hits"), ("lanes", "lanes"),
                ("overLimit", "over_limit"), ("shed", "shed"),
                ("ingressBytes", "ingress_bytes"),
                ("laneTimeS", "lane_time_seconds"),
                ("queueS", "queue_seconds"),
            )
            self.tenant_cost.clear()
            for row in snap["topk"]:
                for src, stat in stat_keys:
                    self.tenant_cost.labels(
                        tenant=row["tenant"], stat=stat
                    ).set(row[src])
            for family, doc in (
                (self.tenant_other, snap["other"]),
                (self.tenant_total, snap["totals"]),
            ):
                family.clear()
                for src, stat in stat_keys:
                    family.labels(stat=stat).set(doc[src])
        self._bump(self.profile_samples, profiling.sample_count())
        self.profile_hz.set(profiling.hz() if profiling.enabled() else 0)

    def observe_audit(self, service) -> None:
        """Refresh the conservation-ledger gauge from the service's
        auditor (collect-on-scrape; violation/check counters are
        incremented LIVE by the auditor thread at detection time)."""
        auditor = getattr(service, "auditor", None)
        if auditor is None:
            return
        self.audit_ledger.clear()
        for entry, value in auditor.deltas().items():
            self.audit_ledger.labels(entry=entry).set(value)
        for entry, value in audit_mod.gauges_snapshot().items():
            self.audit_ledger.labels(entry=entry).set(value)

    def observe_blackbox(self, service) -> None:
        """Refresh the incident-black-box families from the service's
        BlackBox (collect-on-scrape: the tap itself never touches
        prometheus — one branch + ring append per frame)."""
        bb = getattr(service, "blackbox", None)
        if bb is None:
            return
        for wire_name, ring in bb.rings.items():
            _n, nbytes, frames_total = ring.stats()
            self._bump(self.blackbox_frames.labels(wire=wire_name),
                       frames_total)
            self.blackbox_ring_bytes.labels(wire=wire_name).set(nbytes)
        self._bump(self.blackbox_bundles, bb.bundles_written)
        snap_age = bb.snapshot().get("lastTriggerAgeS")
        self.blackbox_last_trigger_age.set(
            -1 if snap_age is None else snap_age
        )

    def _bump(self, counter, absolute: float) -> None:
        current = counter._value.get()  # noqa: SLF001
        if absolute > current:
            counter.inc(absolute - current)
