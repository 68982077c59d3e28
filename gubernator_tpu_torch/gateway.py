"""HTTP/JSON gateway — the client-facing edge of one node.

The port of the JAX package's gateway.py: the reference's grpc-gateway
mux (daemon.go:194-239) — POST /v1/GetRateLimits (JSON or a GUBC
kind-5 frame), GET /v1/HealthCheck, the receiving half of the peer data
plane (PeersV1: POST /v1/peer.GetPeerRateLimits,
/v1/peer.UpdatePeerGlobals, /v1/peer.TransferOwnership,
/v1/peer.UpdateRegionColumns) and the debug routes and GET /metrics —
answered byte for byte like a JAX node.  Errors render
grpc-gateway style: {"code": N, "message": "..."}.  Two edges share
`handle_request`: the stdlib `GatewayServer` (TLS when configured) and
the C++ epoll `NativeGatewayServer`, whose `NativeIngressPump` takes
kind-5 frames natively and dispatches them a coalesced batch at a
time.

Every GUBC frame in and out of either edge is tapped into the node's
incident black box (blackbox.py; the native pump rebuilds the frames of
each take), and POST /debug/incident asks it for a bundle (403, 409 or
202, as on a JAX node).  The port's own route, which a JAX node answers
404: GET /debug/launches (each CUDA kernel's launches in the process;
POST returns them and sets them to 0).
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import ssl
import threading
import time
from functools import partial
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

import numpy as np

from . import audit as audit_mod
from . import native as _native
from . import profiling
from . import saturation
from . import telemetry
from . import tracing
from . import wire
from .config import (
    INGRESS_COLUMNS_MAX_LANES,
    MAX_BATCH_SIZE,
    PEER_COLUMNS_MAX_LANES,
)
from .service import (
    ApiError, ColumnarBatcher, ColumnarResult, IngressColumns, V1Service,
)
from .types import Algorithm, RateLimitRequest, UpdatePeerGlobal, _parse_behavior



_GRPC_CODES = {"InvalidArgument": 3, "OutOfRange": 11, "Internal": 13,
               "FailedPrecondition": 9}

_STATUS_NAMES = ("UNDER_LIMIT", "OVER_LIMIT")


class LazyIngressColumns:
    """IngressColumns twin built from the native JSON parse
    (native.parse_json_batch): kernel-ready columns + PACKED hash keys
    + per-lane validation codes, with name/unique_key strings
    materialized lazily — the hot path never creates 2n string objects
    per batch."""

    __slots__ = ("_pj", "algorithm", "behavior", "hits", "limit",
                 "duration", "_names", "_uks")

    def __init__(self, pj):
        self._pj = pj
        self.algorithm = pj.algo
        self.behavior = pj.behavior
        self.hits = pj.hits
        self.limit = pj.limit
        self.duration = pj.duration
        self._names = None
        self._uks = None

    def __len__(self) -> int:
        return self._pj.n

    @property
    def prevalidated(self):
        """(PackedKeys hash keys, err codes u8[n]: 1 empty unique_key,
        2 empty name) — lets the service skip its per-lane validation
        and hash-key loop (service.py _route_columns)."""
        return self._pj.hash_keys, self._pj.err

    @property
    def names(self):
        if self._names is None:
            self._names = [self._pj.name_at(i) for i in range(self._pj.n)]
        return self._names

    @property
    def unique_keys(self):
        if self._uks is None:
            self._uks = [
                self._pj.unique_key_at(i) for i in range(self._pj.n)
            ]
        return self._uks

    def request_at(self, i: int) -> RateLimitRequest:
        return RateLimitRequest(
            name=self._pj.name_at(i),
            unique_key=self._pj.unique_key_at(i),
            hits=int(self.hits[i]),
            limit=int(self.limit[i]),
            duration=int(self.duration[i]),
            algorithm=int(self.algorithm[i]),
            behavior=int(self.behavior[i]),
        )


def parse_body_native(raw: bytes):
    """Native parse of a /v1/GetRateLimits body; None hands it to
    json.loads + parse_columns (exotic JSON, bad enum values — the
    Python path owns the exact error behavior)."""
    pj = _native.parse_json_batch(raw)
    if pj is None or (pj.err >= 3).any():
        return None
    return LazyIngressColumns(pj)


def render_result_native(result: ColumnarResult):
    """Native response rendering; overrides pre-render in Python (they
    carry metadata/errors), forwarded lanes pre-render their
    metadata.owner straight from the arrays (no per-lane dataclass)."""
    ov = None
    if result.overrides:
        ov = {
            i: json.dumps(r.to_json(), separators=(",", ":")).encode("utf-8")
            for i, r in result.overrides.items()
        }
    if result.owner_of is not None:
        ov = ov or {}
        owner_json = [json.dumps(a) for a in result.owner_addrs]
        status, limit = result.status, result.limit
        remaining, reset = result.remaining, result.reset_time
        for i in np.nonzero(result.owner_of >= 0)[0]:
            i = int(i)
            if i in ov:
                continue
            ov[i] = (
                '{"status":"%s","limit":"%d","remaining":"%d",'
                '"resetTime":"%d","metadata":{"owner":%s}}'
                % (
                    _STATUS_NAMES[status[i]], limit[i], remaining[i],
                    reset[i], owner_json[result.owner_of[i]],
                )
            ).encode("utf-8")
    return _native.render_json(
        result.status, result.limit, result.remaining, result.reset_time,
        ov or {},
    )


def parse_columns(items: list) -> IngressColumns:
    """Parse a JSON `requests` array straight into ingress columns (no
    per-request dataclasses — the gateway's half of the zero-dataclass
    hot path)."""
    n = len(items)
    names: list = [""] * n
    uks: list = [""] * n
    algo = np.zeros(n, dtype=np.int32)
    behavior = np.zeros(n, dtype=np.int32)
    hits = np.zeros(n, dtype=np.int64)
    limit = np.zeros(n, dtype=np.int64)
    duration = np.zeros(n, dtype=np.int64)
    for i, d in enumerate(items):
        names[i] = d.get("name", "")
        uks[i] = d.get("uniqueKey") or d.get("unique_key") or ""
        v = d.get("hits")
        if v:
            hits[i] = int(v)
        v = d.get("limit")
        if v:
            limit[i] = int(v)
        v = d.get("duration")
        if v:
            duration[i] = int(v)
        v = d.get("algorithm")
        if v:
            # Same validation as the dataclass path (_parse_enum): an
            # out-of-range value must fail identically at every batch size.
            if isinstance(v, str) and v in Algorithm.__members__:
                algo[i] = int(Algorithm[v])
            else:
                algo[i] = int(Algorithm(int(v)))
        v = d.get("behavior")
        if v:
            behavior[i] = v if isinstance(v, int) else _parse_behavior(v)
    return IngressColumns(
        names=names, unique_keys=uks, algorithm=algo, behavior=behavior,
        hits=hits, limit=limit, duration=duration,
    )


def render_columns(result: ColumnarResult) -> dict:
    """Serialize a ColumnarResult to the gateway JSON payload directly
    from the arrays."""
    status = result.status
    limit = result.limit
    remaining = result.remaining
    reset = result.reset_time
    ov = result.overrides
    owner_of = result.owner_of
    out = []
    for i in range(result.n):
        r = ov.get(i)
        if r is not None:
            out.append(r.to_json())
        else:
            d = {
                "status": _STATUS_NAMES[status[i]],
                "limit": str(limit[i]),
                "remaining": str(remaining[i]),
                "resetTime": str(reset[i]),
            }
            if owner_of is not None and owner_of[i] >= 0:
                d["metadata"] = {"owner": result.owner_addrs[owner_of[i]]}
            out.append(d)
    return {"responses": out}


def handle_request(service: V1Service, method: str, path: str, raw: bytes,
                   headers=None):
    """Transport-independent request handler: the single routing +
    metrics + error surface behind BOTH edges (the stdlib ThreadingHTTP
    server below and the native epoll edge, NativeGatewayServer).
    Returns (http_status, content_type, body_bytes).  `headers` (any
    mapping with .get, or None) feeds traceparent extraction; the
    native edge passes None — its requests root fresh traces."""
    # Per-service flight recorder + incident black box: bind this
    # node's recorder for the handler's duration (co-resident nodes keep
    # their rings apart), and tap every GUBC frame at the edge, both
    # directions (bb.tap sniffs the frame magic, so JSON bodies cost one
    # length/prefix check each way).
    tracing.bind_recorder(service.recorder)
    bb = service.blackbox
    if raw:
        bb.tap("in", "", raw)
    status, ctype, body = _handle_request(service, method, path, raw, headers)
    if body:
        bb.tap("out", "", body)
    return status, ctype, body


def _handle_request(service: V1Service, method: str, path: str, raw: bytes,
                    headers=None):
    try:
        if method == "GET":
            # /healthz is an alias so stock k8s liveness/readiness
            # probes work without a rewrite rule; the payload includes
            # breakerOpenCount (peers currently fast-failed by their
            # circuit breaker, faults.py).
            if path in ("/v1/HealthCheck", "/healthz"):
                with service.metrics.observe_rpc("/pb.gubernator.V1/HealthCheck"):
                    hc = service.health_check()
                return 200, "application/json", _json_bytes(hc.to_json())
            if path == "/metrics":
                # Collect-on-scrape: refresh every observer's families
                # from the live state, then render.  The whole refresh
                # and render run under the scrape lock: two racing
                # scrapers must not interleave one's take_pipeline_stats
                # drain with the other's clear()/set().
                m = service.metrics
                with m.scrape_lock:
                    m.observe_cache(service.store)
                    m.observe_dispatch(service.store)
                    m.observe_saturation(service)
                    m.observe_telemetry(getattr(service.store, "device", None))
                    m.observe_audit(service)
                    m.observe_cost(service)
                    m.observe_native_ingress(service)
                    m.observe_blackbox(service)
                    m.observe_peers(
                        service.get_peer_list()
                        + list(service.get_region_picker().peers())
                    )
                    ctype, payload = m.render_negotiated(
                        headers.get("Accept", "") if headers else ""
                    )
                return 200, ctype, payload
            qpath = urlsplit(path).path
            if qpath in ("/debug/traces", "/debug/events"):
                return _debug_dump(service, path)
            if qpath == "/debug/status":
                # The cluster-status surface: one JSON doc per daemon
                # (scripts/cluster_status.py polls these).
                return 200, "application/json", _json_bytes(
                    service.debug_status()
                )
            if qpath == "/debug/latency":
                # Live per-phase percentile snapshots from the always-on
                # attribution reservoirs (saturation.py).  `express` is
                # the express-vs-batched split: per-path lane counts +
                # hit rate, with the bypass's own submit wall under
                # phases["express.submit"] beside the windowed path's
                # batch.window/queue.wait.
                return 200, "application/json", _json_bytes({
                    "phases": saturation.phase_snapshot(),
                    "express": saturation.express_snapshot(),
                    "slo": service.slo.snapshot(),
                })
            if qpath == "/debug/hotkeys":
                return 200, "application/json", _json_bytes(
                    service.hotkeys.snapshot()
                )
            if qpath == "/debug/device":
                # Device telemetry (telemetry.py): kernel builds and
                # first launches, per-program launch timings, the
                # store's CUDA memory.
                doc = telemetry.snapshot()
                doc["devices"] = telemetry.device_snapshot(
                    getattr(service.store, "device", None))
                return 200, "application/json", _json_bytes(doc)
            if qpath == "/debug/audit":
                # Conservation audit (audit.py): ledger deltas +
                # invariant verdicts; the soak harness's pass/fail gate.
                return 200, "application/json", _json_bytes(
                    service.auditor.snapshot()
                )
            if qpath == "/debug/tenants":
                # Cost observatory (profiling.py): per-tenant cost
                # ledger — top-K exact rows + the `other` rollup;
                # scripts/cluster_status.py --tenants aggregates these
                # fleet-wide.
                return 200, "application/json", _json_bytes(
                    service.tenants.snapshot()
                )
            if qpath == "/debug/pprof":
                return _debug_pprof(path)
            if qpath == "/debug/launches":
                return _debug_launches(reset=False)
            return 404, "application/json", _json_bytes(
                {"code": 5, "message": f"no handler for {path}"}
            )
        if method != "POST":
            return 404, "application/json", _json_bytes(
                {"code": 5, "message": f"no handler for {method} {path}"}
            )
        if path == "/debug/launches":
            return _debug_launches(reset=True)
        tp = headers.get("traceparent") if headers else None
        if path == "/v1/GetRateLimits":
            # Span OUTSIDE the metrics timer: observe_rpc's exit hook
            # attaches a trace exemplar from the still-active context.
            with tracing.ingress_span("http", path, tp):
                with service.metrics.observe_rpc("/pb.gubernator.V1/GetRateLimits"):
                    if service.serves_ingress_columns and wire.is_ingress_frame(raw):
                        # Columnar front door: GUBC kind-5 frame in,
                        # kind-6 frame out (no JSON either way).  With
                        # the knob off this branch is never reached —
                        # the frame falls into json.loads below and
                        # 400s exactly like a pre-columns build, which
                        # is the client's version probe.
                        t_parse = time.perf_counter()
                        with profiling.scope("ingress.parse"):
                            cols = _decode_ingress_frame_or_400(raw)
                        saturation.observe_phase(
                            "ingress.parse", time.perf_counter() - t_parse
                        )
                        result = service.get_rate_limits_columns(
                            cols, max_lanes=INGRESS_COLUMNS_MAX_LANES
                        )
                        t_enc = time.perf_counter()
                        with profiling.scope("response.encode"):
                            rendered = wire.encode_ingress_result_frame(result)
                        saturation.observe_phase(
                            "response.encode", time.perf_counter() - t_enc
                        )
                        service.metrics.ingress_columns_batches.labels(
                            encoding="frame"
                        ).inc()
                        return 200, wire.COLUMNS_CONTENT_TYPE, rendered
                    t_parse = time.perf_counter()
                    with profiling.scope("ingress.parse"):
                        cols = parse_body_native(raw) if raw else None
                        native = cols is not None
                        if not native:
                            body = json.loads(raw) if raw else {}
                            cols = parse_columns(body.get("requests", []))
                    saturation.observe_phase(
                        "ingress.parse", time.perf_counter() - t_parse
                    )
                    result = service.get_rate_limits_columns(cols)
                    t_enc = time.perf_counter()
                    with profiling.scope("response.encode"):
                        rendered = (
                            render_result_native(result) if native else None
                        )
                        if rendered is None:
                            rendered = _json_bytes(render_columns(result))
                    saturation.observe_phase(
                        "response.encode", time.perf_counter() - t_enc
                    )
            return 200, "application/json", rendered
        if path == "/v1/peer.GetPeerRateLimits":
            # Body parsing happens INSIDE the metrics span on BOTH
            # gateway paths: a malformed peer body counts as a
            # status="1" request in request_counts here exactly like on
            # the async edge (architecture.md "Columnar pipeline: the
            # peer hop" documents the parity rule).
            with tracing.ingress_span("http", path, tp):
                with service.metrics.observe_rpc(
                    "/pb.gubernator.PeersV1/GetPeerRateLimits"
                ):
                    if service.serves_peer_columns and wire.is_columns_frame(raw):
                        # Columnar peer hop: binary frame in, frame out.
                        result = service.get_peer_rate_limits_columns(
                            _decode_frame_or_400(raw),
                            max_lanes=PEER_COLUMNS_MAX_LANES,
                        )
                        return (200, wire.COLUMNS_CONTENT_TYPE,
                                wire.encode_result_frame(result))
                    body = json.loads(raw) if raw else {}
                    cols = parse_columns(body.get("requests", []))
                    result = service.get_peer_rate_limits_columns(cols)
            # PeersV1 response field is rate_limits (peers.proto:42-45).
            return 200, "application/json", _json_bytes(
                {"rateLimits": render_columns(result)["responses"]}
            )
        if path == "/debug/profile":
            return _debug_profile(raw)
        if path == "/debug/incident":
            return _debug_incident(service, raw)
        if (path == "/v1/peer.UpdateRegionColumns"
                and service.serves_region_columns):
            # Cross-region federation receive (federation.py): GUBC
            # region frame in, ONE columnar apply.  A node with the
            # plane off (GUBER_REGION_COLUMNS=0) never reaches here: it
            # falls through to the 404 below, what a pre-federation
            # build answers, which is the sender's version probe (sticky
            # classic fallback to the per-item GetPeerRateLimits path).
            with service.metrics.observe_rpc(
                "/pb.gubernator.PeersV1/UpdateRegionColumns"
            ):
                if not wire.is_region_frame(raw):
                    raise ApiError(
                        "InvalidArgument",
                        "UpdateRegionColumns expects a GUBC region frame",
                    )
                try:
                    cols = wire.decode_region_frame(raw)
                except ValueError as e:
                    raise ApiError(
                        "InvalidArgument", f"invalid region frame: {e}"
                    ) from e
                applied = service.update_region_columns(cols)
            return 200, "application/json", _json_bytes(
                {"applied": applied}
            )
        if path == "/v1/peer.TransferOwnership" and service.serves_reshard:
            # Ownership-transfer receive (elastic membership): GUBC
            # transfer frame in, ONE batched merge-commit.  A daemon
            # with the plane off (GUBER_RESHARD=0) never reaches here —
            # it falls through to the 404 below, exactly what a
            # pre-reshard build answers, which is the sender's version
            # probe (sticky classic fallback).
            with service.metrics.observe_rpc(
                "/pb.gubernator.PeersV1/TransferOwnership"
            ):
                if not wire.is_transfer_frame(raw):
                    raise ApiError(
                        "InvalidArgument",
                        "TransferOwnership expects a GUBC transfer frame",
                    )
                try:
                    cols = wire.decode_transfer_frame(raw)
                except ValueError as e:
                    raise ApiError(
                        "InvalidArgument", f"invalid transfer frame: {e}"
                    ) from e
                committed, rejected = service.transfer_ownership(cols)
            return 200, "application/json", _json_bytes(
                {"committed": committed, "rejected": rejected}
            )
        if path == "/v1/peer.UpdatePeerGlobals":
            with service.metrics.observe_rpc(
                "/pb.gubernator.PeersV1/UpdatePeerGlobals"
            ):
                if service.serves_global_columns and wire.is_globals_frame(raw):
                    # Columnar GLOBAL broadcast: GUBC globals frame in,
                    # ONE batched replica commit.  A daemon with the
                    # plane off never reaches here — the json.loads
                    # below rejects the frame exactly like a
                    # pre-columns build (the sender's version answer).
                    try:
                        cols = wire.decode_globals_frame(raw)
                    except ValueError as e:
                        raise ApiError(
                            "InvalidArgument", f"invalid globals frame: {e}"
                        ) from e
                    service.update_peer_globals_columns(cols)
                    return 200, "application/json", b"{}"
                body = json.loads(raw) if raw else {}
                updates = [
                    UpdatePeerGlobal.from_json(u)
                    for u in body.get("globals", [])
                ]
                service.update_peer_globals(updates)
            return 200, "application/json", b"{}"
        return 404, "application/json", _json_bytes(
            {"code": 5, "message": f"no handler for {path}"}
        )
    except Exception as e:  # noqa: BLE001
        return _error_triplet(e)


def _json_bytes(payload) -> bytes:
    return json.dumps(payload).encode("utf-8")


def _debug_dump(service, path: str):
    """GET /debug/traces[?trace_id=<32-hex>][&since=<wall-ns>]
    [&limit=<n>] and GET /debug/events: dump the flight recorder
    (tracing.py).  The trace filter matches a span's own trace id OR
    its links — the batch span-link rule, so a lane's trace finds the
    coalesced window/stage spans it rode.  `since` filters on each
    span's wall-clock end stamp (wall_ns) so a stitcher
    (scripts/trace_collect.py) can poll incrementally instead of
    re-reading the whole ring; `limit` keeps the OLDEST N after the
    filter (pagination order — the poller's next `since` cursor picks
    up exactly where this page ended).  Reads across EVERY live
    recorder: per-service recorders exist so incident bundles stay
    attributable per daemon (blackbox.py snapshots only its service's
    ring), but the debug READ surface keeps the one-ring view — a
    cross-daemon trace in a co-resident cluster must be visible from
    ANY daemon's debug port (the two-daemon trace-stitching contract)."""
    recorders = None
    parts = urlsplit(path)
    if parts.path == "/debug/events":
        return 200, "application/json", _json_bytes(
            {"events": tracing.events_snapshot(recorders=recorders)}
        )
    q = parse_qs(parts.query)
    trace_id = (q.get("trace_id") or [""])[0]

    def _int_q(name: str) -> int:
        try:
            return max(int((q.get(name) or ["0"])[0]), 0)
        except ValueError:
            return 0

    return 200, "application/json", _json_bytes(
        {
            "sampleRate": tracing.sample_rate(),
            "spans": tracing.spans_snapshot(
                trace_id, since_ns=_int_q("since"), limit=_int_q("limit"),
                recorders=recorders,
            ),
        }
    )


def _debug_launches(reset: bool):
    """The port's own diagnostic (a JAX node answers 404): each CUDA
    kernel's launches in this process, `ops._kernels.LAUNCHES`.  POST
    returns the counts and sets them to 0, so a caller can count the
    launches of one stretch of traffic in a daemon it runs as another
    process."""
    from .ops import _kernels

    counts = dict(_kernels.LAUNCHES)
    if reset:
        _kernels.reset_launch_counts()
    return 200, "application/json", _json_bytes({"launches": counts})


def _debug_pprof(path: str):
    """GET /debug/pprof?seconds=N[&format=collapsed|json][&top=N]: the
    continuous host profiler's window (profiling.py).  Default output
    is flamegraph collapsed text ('phase;frame;...;frame count' lines —
    pipe into flamegraph.pl / speedscope); format=json serves the
    top-N + phase/program attribution view the integration gate
    asserts against (>= 80% of samples on a loaded daemon must
    attribute to a named phase)."""
    q = parse_qs(urlsplit(path).query)

    def _int_q(name: str, default: int) -> int:
        try:
            return int((q.get(name) or [str(default)])[0])
        except ValueError:
            return default

    seconds = _int_q("seconds", 10)
    if (q.get("format") or ["collapsed"])[0] == "json":
        return 200, "application/json", _json_bytes(
            profiling.profile_snapshot(seconds, top=_int_q("top", 30))
        )
    return (200, "text/plain; charset=utf-8",
            profiling.collapsed(seconds).encode("utf-8"))


_profile_state = {"thread": None, "dirs": [], "run_id": "", "log_dir": ""}
_profile_seq = itertools.count(1)
_profile_lock = threading.Lock()


def _debug_incident(service, raw: bytes):
    """POST /debug/incident [{"reason": "..."}]: operator-requested
    incident bundle (blackbox.py) — freeze the wire rings + debug
    surfaces into an on-disk bundle exactly as an auto-dump trigger
    would, but exempt from the writer's rate limit.  403 when the
    black box is disabled (GUBER_BLACKBOX=0 must not let callers
    re-arm capture), 409 when no bundle directory is configured (the
    rings run but there is nowhere to freeze them), 202 otherwise —
    the write happens off-thread (evidence collection must not park a
    gateway worker)."""
    from . import blackbox as blackbox_mod

    bb = service.blackbox
    if not (blackbox_mod.enabled() and bb._on):  # noqa: SLF001
        raise ApiError(
            "InvalidArgument",
            "incident capture requires the black box enabled "
            "(GUBER_BLACKBOX=1)",
            http_status=403,
        )
    if not bb.path:
        return 409, "application/json", _json_bytes(
            {
                "code": 9,
                "message": "no bundle directory configured "
                           "(GUBER_BLACKBOX_DIR)",
            }
        )
    body = json.loads(raw) if raw else {}
    if not isinstance(body, dict):
        raise ApiError("InvalidArgument", "body must be a JSON object")
    doc = bb.trigger_manual(str(body.get("reason", "")))
    return 202, "application/json", _json_bytes(doc)


# Retention cap on profile dumps this daemon created: a client looping
# POST /debug/profile must not fill the temp filesystem of a long-lived
# daemon (each dump is a multi-MB TensorBoard trace).
PROFILE_KEEP = 5


def _debug_profile(raw: bytes):
    """POST /debug/profile {"durationMs": N}: run an on-demand
    torch.profiler trace (CPU, and CUDA when a card is present) for N ms
    (default 1000, cap 60s) in the background, writing a Chrome-trace
    JSON (`device_trace.json`, chrome://tracing or Perfetto) to a fresh
    mkdtemp-created directory (mode 0700, unpredictable name — the
    caller must NOT choose the path, and a predictable fixed path in
    /tmp could be pre-planted by another local user).  Gated on tracing
    being enabled (GUBER_TRACE_SAMPLE > 0) — a daemon with
    observability off must not let callers start device-wide profiles.
    One at a time; answers 202 immediately (a profile must not park a
    gateway worker for its whole duration)."""
    if not tracing.enabled():
        raise ApiError(
            "InvalidArgument",
            "profiling requires tracing enabled (GUBER_TRACE_SAMPLE > 0)",
            http_status=403,
        )
    body = json.loads(raw) if raw else {}
    if not isinstance(body, dict):
        raise ApiError("InvalidArgument", "body must be a JSON object")
    try:
        duration_s = min(max(float(body.get("durationMs", 1000)) / 1000.0, 0.01), 60.0)
    except (TypeError, ValueError):
        raise ApiError("InvalidArgument", "durationMs must be a number") from None
    with _profile_lock:
        t = _profile_state["thread"]
        if t is not None and t.is_alive():
            # Concurrent-run guard: the second caller learns WHICH run
            # holds the device (its id + artifact path) instead of just
            # a refusal — two operators racing a profile can converge
            # on the same artifact.
            return 409, "application/json", _json_bytes(
                {
                    "code": 10,
                    "message": "a device profile is already running",
                    "runId": _profile_state["run_id"],
                    "logDir": _profile_state["log_dir"],
                }
            )
        import shutil
        import tempfile

        log_dir = tempfile.mkdtemp(prefix="gubernator-profile-")
        run_id = f"profile-{next(_profile_seq)}"
        _profile_state["run_id"] = run_id
        _profile_state["log_dir"] = log_dir
        _profile_state["dirs"].append(log_dir)
        while len(_profile_state["dirs"]) > PROFILE_KEEP:
            shutil.rmtree(_profile_state["dirs"].pop(0), ignore_errors=True)

        def run():
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            try:
                time.sleep(duration_s)
            finally:
                try:
                    prof.stop()
                    prof.export_chrome_trace(
                        os.path.join(log_dir, "device_trace.json"))
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass
            # Cost-observatory pairing: the continuous host profiler's
            # window covering the SAME interval lands beside the device
            # trace, so one call yields device trace + host flamegraph
            # for the same seconds (collapsed text, flamegraph.pl /
            # speedscope ready).
            if profiling.enabled():
                try:
                    with open(
                        os.path.join(log_dir, "host_profile.collapsed"),
                        "w",
                    ) as f:
                        f.write(
                            profiling.collapsed(max(int(duration_s), 1))
                        )
                except OSError:
                    pass

        t = threading.Thread(target=run, daemon=True, name="debug-profile")
        _profile_state["thread"] = t
        t.start()
    host_seconds = max(int(duration_s), 1)
    return 202, "application/json", _json_bytes(
        {
            "runId": run_id, "logDir": log_dir,
            "durationMs": duration_s * 1000.0,
            # Written when the run completes (the 202 answers before the
            # trace finishes); the live equivalent is the pprof URL.
            "hostProfile": (
                f"{log_dir}/host_profile.collapsed"
                if profiling.enabled() else None
            ),
            "hostPprof": f"/debug/pprof?seconds={host_seconds}",
        }
    )


def _decode_frame_or_400(raw: bytes):
    """Frame decode for the peer endpoint: a malformed/truncated frame
    is the CLIENT's fault — surface it as a 400 (ApiError), not a 500,
    on both gateway paths."""
    try:
        return wire.decode_columns_frame(raw)
    except ValueError as e:
        raise ApiError("InvalidArgument", f"invalid columns frame: {e}") from e


def _decode_ingress_frame_or_400(raw: bytes):
    """Public-ingress twin of _decode_frame_or_400 (kind-5 frames,
    untrusted-client validation inside the decode)."""
    try:
        return wire.decode_ingress_frame(raw)
    except ValueError as e:
        raise ApiError("InvalidArgument", f"invalid columns frame: {e}") from e


def _error_triplet(e: BaseException):
    """Map a handler exception to (status, content_type, body) — the
    same arms as handle_request's except clauses, shared with the async
    path so the two edges answer errors identically."""
    if isinstance(e, ApiError):
        return e.http_status, "application/json", _json_bytes(
            {"code": _GRPC_CODES.get(e.code, 2), "message": e.message}
        )
    if isinstance(e, (json.JSONDecodeError, UnicodeDecodeError)):
        # UnicodeDecodeError: json.loads auto-detects utf-16/32 from a
        # leading NUL and raises it for binary garbage — a malformed
        # REQUEST, not a server fault (and the columns-negotiation
        # probe relies on old peers answering 4xx to non-JSON bodies).
        return 400, "application/json", _json_bytes(
            {"code": 3, "message": f"invalid JSON: {e}"}
        )
    return 500, "application/json", _json_bytes(
        {"code": 13, "message": str(e)}
    )


def handle_request_async(service: V1Service, method: str, path: str,
                         raw: bytes, respond, headers=None) -> None:
    """Async twin of handle_request for the device-bound POST paths:
    parse + submit on the calling thread, deliver via
    respond(status, content_type, body) exactly once from a completion
    thread.  Everything else (GET, globals push, unknown paths) answers
    synchronously — those never wait on a device round.  Used by the
    native epoll edge so its workers return to the ingress queue
    instead of parking one thread per in-flight request."""
    if method != "POST" or path not in (
        "/v1/GetRateLimits", "/v1/peer.GetPeerRateLimits"
    ):
        respond(*handle_request(service, method, path, raw, headers))
        return
    # Recorder binding + black-box edge taps, the handle_request
    # discipline: request on the submitting worker here, response in
    # finish() where the rendered triplet exists.
    tracing.bind_recorder(service.recorder)
    bb = service.blackbox
    if raw:
        bb.tap("in", "", raw)
    rpc = (
        "/pb.gubernator.V1/GetRateLimits"
        if path == "/v1/GetRateLimits"
        else "/pb.gubernator.PeersV1/GetPeerRateLimits"
    )
    metrics = service.metrics
    start = time.perf_counter()
    # Ingress span, async form: active on THIS thread only while the
    # request is parsed/submitted (that is where routing captures the
    # context into batch links and peer forwards); ended exactly once
    # by finish(), from whichever completion thread delivers.
    span = tracing.ingress_span(
        "http", path, headers.get("traceparent") if headers else None
    )
    span.activate()
    # Exactly-once guard: an inline callback that raised must not
    # re-enter through the outer except and answer the same token
    # twice.  The check-then-set is LOCKED: a
    # completion thread and the submitting thread can race into
    # finish() concurrently (e.g. a drainer callback firing while the
    # submit path converts a late exception), and an unlocked flag
    # would let both pass the check and double-respond / double-count.
    finished = [False]
    finished_lock = threading.Lock()

    def finish(status_label: str, triplet) -> None:
        with finished_lock:
            if finished[0]:
                return
            finished[0] = True
        # Manual observe_rpc: the span covers parse -> response-ready,
        # like the sync context manager covers parse -> render.
        dt = time.perf_counter() - start
        metrics.request_counts.labels(status=status_label, method=rpc).inc()
        metrics.request_duration.labels(method=rpc).observe(dt)
        metrics.observe_latency(rpc, dt, ctx=span.ctx if span else None)
        span.end(status=status_label)
        if triplet[2]:
            bb.tap("out", "", triplet[2])
        respond(*triplet)

    try:
        if path == "/v1/GetRateLimits":
            ingress_frame = (
                service.serves_ingress_columns and wire.is_ingress_frame(raw)
            )
            t_parse = time.perf_counter()
            if ingress_frame:
                # Columnar front door, async edge: the native worker
                # hands ready column buffers (gt_frame_parse ran with
                # the GIL released) to the submit path and returns to
                # the ingress queue; the kind-6 response renders on the
                # completion thread straight from the result arrays.
                with profiling.scope("ingress.parse"):
                    cols = _decode_ingress_frame_or_400(raw)
                native = False
            else:
                with profiling.scope("ingress.parse"):
                    cols = parse_body_native(raw) if raw else None
                    native = cols is not None
                    if cols is None:
                        body = json.loads(raw) if raw else {}
                        cols = parse_columns(body.get("requests", []))
            saturation.observe_phase(
                "ingress.parse", time.perf_counter() - t_parse
            )

            def cb(result, exc):
                # Guarded like the sync catch-all: a render failure on a
                # completion thread must become a 500, not a swallowed
                # exception that leaves the client hanging.
                try:
                    if exc is not None:
                        finish("1", _error_triplet(exc))
                        return
                    t_enc = time.perf_counter()
                    if ingress_frame:
                        with profiling.scope("response.encode"):
                            rendered = wire.encode_ingress_result_frame(result)
                        saturation.observe_phase(
                            "response.encode", time.perf_counter() - t_enc
                        )
                        metrics.ingress_columns_batches.labels(
                            encoding="frame"
                        ).inc()
                        finish("0", (200, wire.COLUMNS_CONTENT_TYPE, rendered))
                        return
                    with profiling.scope("response.encode"):
                        rendered = (
                            render_result_native(result) if native else None
                        )
                        if rendered is None:  # native render unavailable/cap
                            rendered = _json_bytes(render_columns(result))
                    saturation.observe_phase(
                        "response.encode", time.perf_counter() - t_enc
                    )
                    finish("0", (200, "application/json", rendered))
                except Exception as e:  # noqa: BLE001
                    finish("1", _error_triplet(e))

            service.get_rate_limits_columns_async(
                cols, cb,
                max_lanes=(
                    INGRESS_COLUMNS_MAX_LANES if ingress_frame
                    else MAX_BATCH_SIZE
                ),
            )
        else:
            frame = service.serves_peer_columns and wire.is_columns_frame(raw)
            if frame:
                cols = _decode_frame_or_400(raw)
            else:
                body = json.loads(raw) if raw else {}
                cols = parse_columns(body.get("requests", []))

            def cb(result, exc):
                try:
                    if exc is not None:
                        finish("1", _error_triplet(exc))
                        return
                    if frame:
                        finish("0", (200, wire.COLUMNS_CONTENT_TYPE,
                                     wire.encode_result_frame(result)))
                        return
                    finish("0", (200, "application/json", _json_bytes(
                        {"rateLimits": render_columns(result)["responses"]}
                    )))
                except Exception as e:  # noqa: BLE001
                    finish("1", _error_triplet(e))

            service.get_peer_rate_limits_columns_async(
                cols, cb,
                max_lanes=PEER_COLUMNS_MAX_LANES if frame else MAX_BATCH_SIZE,
            )
    except Exception as e:  # noqa: BLE001 — parse/submit errors, before
        finish("1", _error_triplet(e))  # any callback was registered
    finally:
        # Submit done: drop the context from this worker thread (the
        # span itself stays open until finish()).
        span.deactivate()


_HTTP_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
                 500: "Internal Server Error"}


class NativeIngressPump:
    """Batch-granularity control of the native ingress service loop
    (host_runtime.cpp gt_ingress_*, architecture.md "Native service
    loop").

    Gateway workers feed kind-5 frames into the native ring without
    ever copying their bytes into Python (HttpEdge.next(ingress=...));
    this pump is the ONLY Python in the steady-state hot path: one
    take per coalesced batch (zero-copy column views), the
    batch-granularity observability folds (audit ledger, tenant
    ledger, hot-key sketch, phase attribution — the saturation,
    audit and cost planes stay honest), one store dispatch, and one complete that hands the
    result arrays back to C++ for the per-frame kind-6 response fill
    and socket write.

    Lanes needing Python semantics never reach here — the native
    submit falls back to the ordinary gateway path for them (slow
    behavior bits, validation errors, remote owners, sampled traces,
    malformed frames), so correctness is identical with the pump on or
    off; the pump only removes interpreter time from the
    already-columnar common case."""

    # Behavior bits that demand the Python router (GLOBAL replica
    # path, MULTI_REGION hit queueing, Gregorian resolution — and
    # NO_BATCHING direct dispatch when the express lane is off): any
    # lane carrying one makes the whole frame fall back.  With
    # GUBER_EXPRESS on, NO_BATCHING moves out of
    # the fallback mask and into the native EXPRESS queue instead
    # (frames jump the ring, never the Python path — the bit means
    # "skip coalescing waits", which the native loop satisfies
    # directly).
    FALLBACK_BEHAVIOR = 1 | 2 | 4 | 16
    EXPRESS_FALLBACK_BEHAVIOR = 2 | 4 | 16
    EXPRESS_MASK = 1  # Behavior.NO_BATCHING

    #: Overlapping dispatches in flight (the store pipeline overlaps
    #: host work behind device compute underneath this bound; 6 keeps
    #: the device fed through a host-side hiccup without queueing work
    #: past any useful deadline — the native ring's shed bound still
    #: caps total admitted lanes).
    DEPTH = 6
    #: Take/dispatch threads.  Two, like the headline bench loop: the
    #: PREPARE of take N+1 (the C++ mesh plan, under `_plan_lock`)
    #: overlaps take N's STAGE/LAUNCH (store lock) — on one thread the
    #: two stages serialize and the ~equal-cost halves each idle while
    #: the other runs.
    N_PUMPS = 2

    def __init__(self, service: V1Service):
        from concurrent.futures import ThreadPoolExecutor

        from . import native as _nat

        self.service = service
        self.batcher = _nat.IngressBatcher()
        self._sem = threading.Semaphore(self.DEPTH)
        self._stopped = threading.Event()
        self._threads: list = []
        self._done_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="native-ingress-done",
            initializer=tracing.bind_recorder,
            initargs=(getattr(service, "recorder", None),),
        )
        self._ring_lock = threading.Lock()
        self._ring = None
        self._eligible = False
        self._enable_at = 0.0
        self._shed_seen = 0
        self._express_seen = 0
        self._lanes_seen = 0
        # The set_peers hook: the service pushes ring snapshots here.
        service.native_ingress = self

    @property
    def active(self) -> bool:
        """Whether workers should offer frames to the native lane.
        Sampled tracing turns it off wholesale — the Python path owns
        span creation — which keeps GUBER_TRACE_SAMPLE>0 semantics
        those of the Python frame path at the cost of the fast lane."""
        return (
            not self._stopped.is_set()
            and not tracing.enabled()
            and not getattr(self.service, "_closed", False)
        )

    def stats(self) -> dict:
        return self.batcher.stats()

    # -- ring push (service.set_peers -> update_ring) ------------------
    def update_ring(self) -> None:
        """Recompute and push the native route snapshot: sorted vnode
        hashes + per-vnode self bits off the live picker (the
        ownership-code pass of hash_ring.get_batch_codes reduced to
        the one question the fast lane asks).  During a reshard
        double-dispatch window the lane DISABLES — moved keys owe the
        old owner a peek only the Python router performs — and
        re-enables when the window closes."""
        from .parallel import hash_ring as _hr

        svc = self.service
        with svc._peer_mutex:
            picker = svc.local_picker
            handoff_until = (
                svc._handoff_deadline if svc._prev_picker is not None else 0.0
            )
            vh = np.array(picker._vnode_hashes, dtype=np.uint64, copy=True)
            codes = np.array(picker._vnode_code, dtype=np.int32, copy=True)
            ids = list(picker._code_ids)
            self_codes = []
            for c, pid in enumerate(ids):
                peer = picker.get_by_peer_id(pid)
                info = getattr(peer, "info", None)
                if info is not None and info.is_owner:
                    self_codes.append(c)
            hash_fn = picker.hash_fn
        if hash_fn is _hr._fnv1a_str:
            variant = 1
        elif hash_fn is _hr._fnv1_str:
            variant = 0
        else:
            variant = -1  # custom hash: the native route cannot mirror it
        vself = (
            np.isin(codes, np.asarray(self_codes, dtype=np.int32))
            .astype(np.uint8)
            if codes.size else np.zeros(0, np.uint8)
        )
        now = time.monotonic()
        enabled = (
            variant >= 0
            and bool(ids)
            and handoff_until <= now
            and not self._stopped.is_set()
        )
        with self._ring_lock:
            self._ring = (vh, vself, bool(ids) and len(self_codes) == len(ids),
                          max(variant, 0))
            # Eligibility WITHOUT the window: what the deadline re-push
            # may enable (a custom hash_fn or empty ring stays off).
            self._eligible = variant >= 0 and bool(ids)
            self._enable_at = handoff_until if handoff_until > now else 0.0
            self._push(enabled)

    def _push(self, enabled: bool) -> None:
        # _ring_lock held.
        vh, vself, all_self, variant = self._ring
        b = self.service.conf.behaviors
        express = bool(getattr(b, "express", False))
        self.batcher.set_ring(
            vh, vself, all_self=all_self, enabled=enabled,
            cap_lanes=getattr(b, "ingress_queue_lanes", 0),
            max_frame_lanes=INGRESS_COLUMNS_MAX_LANES,
            behavior_mask=(
                self.EXPRESS_FALLBACK_BEHAVIOR if express
                else self.FALLBACK_BEHAVIOR
            ),
            hash_variant=variant,
            express_mask=self.EXPRESS_MASK if express else 0,
        )

    # -- pump loop ------------------------------------------------------
    def start(self) -> "NativeIngressPump":
        for i in range(self.N_PUMPS):
            t = threading.Thread(
                target=self._run, daemon=True, name=f"native-ingress-pump-{i}"
            )
            t.start()
            self._threads.append(t)
        return self

    def _run(self) -> None:
        batcher = self.batcher
        tracing.bind_recorder(self.service.recorder)
        bb = self.service.blackbox
        while not self._stopped.is_set():
            with self._ring_lock:
                # Check-and-push under ONE lock hold: a set_peers that
                # opens a NEW window between a read and the push must
                # not be re-enabled over; and the re-push honors the
                # SAME eligibility update_ring derived (a custom
                # hash_fn or empty ring stays disabled).
                if self._enable_at and time.monotonic() >= self._enable_at:
                    self._enable_at = 0.0
                    self._push(
                        self._eligible and not self._stopped.is_set()
                    )
            with profiling.scope("epoll.wait"):
                # A take holds at most one batcher launch's lanes; one
                # K1 launch takes it whole (lanes past what the
                # cooperative grid holds re-read each round).
                tb = batcher.take(ColumnarBatcher.MAX_LANES, timeout_ms=200)
            # Overload-signal parity with the Python gate: native sheds
            # happen entirely in C++, so the pump surfaces them into the
            # flight recorder (the automatic-dump trigger shedding
            # exists for) and samples the ring depth for /debug/status.
            st = batcher.stats()
            saturation.observe_queue_depth(st["pendingLanes"])
            # Express-lane attribution: NO_BATCHING frames served by
            # the native express queue (counted in C++ at submit), and
            # the ring's BULK lanes into the batched denominator — the
            # hit-rate gauge must reflect the native edge's coalesced
            # traffic, not just the batchers' windows.
            xl = st.get("expressLanes", 0)
            tl = st.get("lanes", 0)
            d_express = xl - self._express_seen
            d_bulk = (tl - self._lanes_seen) - d_express
            if d_express > 0:
                saturation.note_express("native", d_express)
            if d_bulk > 0:
                saturation.note_express("windowed", d_bulk)
            self._express_seen = xl
            self._lanes_seen = tl
            shed = st["shedLanes"]
            if shed > self._shed_seen:
                tracing.record_event(
                    "shed", lanes=shed - self._shed_seen,
                    queued=st["pendingLanes"],
                    cap=getattr(
                        self.service.conf.behaviors,
                        "ingress_queue_lanes", 0,
                    ),
                )
                self._shed_seen = shed
            if tb is None:
                if batcher.stopped:
                    return
                continue
            # Black-box native tap, BEFORE _submit: the batch's zero-copy
            # views die at complete()/fail(), and this is the only point
            # where the coalesced frames' bytes can still be rebuilt
            # (express-lane singles answered in C++ never surface here:
            # capture slack).
            bb.tap_taken(tb)
            self._sem.acquire()
            try:
                args = self._submit(tb)
            except BaseException as e:  # noqa: BLE001
                self._sem.release()
                self._fail(tb, e)
                continue
            self._done_pool.submit(self._complete, *args)

    def _submit(self, tb):
        """One batch through the funnel's batch-granularity duties:
        conservation ledger, tenant fold, hot-key sketch (riding the
        hashes the native route already computed — zero extra
        hashing), phase attribution, then ONE columnar dispatch."""
        svc = self.service
        audit_mod.note("ingress_hits", int(tb.hits.sum()))
        tenant_ctx = svc.tenants.fold_admit(tb)
        svc.hotkeys.update(tb.hashes, tb.hash_keys)
        nf = max(tb.n_frames, 1)
        saturation.observe_phase("ingress.parse", tb.parse_ns_total / 1e9 / nf)
        for age_us in tb.frame_age_us:
            saturation.observe_phase("batch.window", float(age_us) / 1e6)
        t0 = time.perf_counter()
        handle = svc.store.apply_columns_async(
            tb.hash_keys, tb.algorithm, tb.behavior, tb.hits, tb.limit,
            tb.duration, svc.clock.now_ms(),
        )
        return tb, handle, tenant_ctx, t0

    def _complete(self, tb, handle, tenant_ctx, t0) -> None:
        svc = self.service
        m = svc.metrics
        rpc = "/pb.gubernator.V1/GetRateLimits"
        try:
            try:
                out = handle.result()
                nf = tb.n_frames
                # Host copies of everything needed past complete(): the
                # batch's views die inside it, and the native fill reads
                # the result arrays during the call (np.array copies:
                # `limit` is the taken batch's own column, a view).
                ages_s = tb.frame_age_us.astype(np.float64) / 1e6
                result = ColumnarResult(
                    n=tb.n,
                    status=np.array(out["status"], dtype=np.int32),
                    limit=np.array(out["limit"], dtype=np.int64),
                    remaining=np.array(out["remaining"], dtype=np.int64),
                    reset_time=np.array(out["reset_time"], dtype=np.int64),
                    overrides={},
                )
                svc.tenants.fold_outcome(tenant_ctx, result)
                t_enc = time.perf_counter()
                with profiling.scope("response.encode"):
                    self.batcher.complete(
                        tb, result.status, result.limit, result.remaining,
                        result.reset_time,
                    )
                saturation.observe_phase(
                    "response.encode",
                    (time.perf_counter() - t_enc) / max(nf, 1),
                )
                dt_disp = time.perf_counter() - t0
                m.ingress_columns_batches.labels(encoding="frame").inc(nf)
                m.request_counts.labels(status="0", method=rpc).inc(nf)
                duration = m.request_duration.labels(method=rpc)
                for age in ages_s:
                    dt = float(age) + dt_disp
                    duration.observe(dt)
                    m.observe_latency(rpc, dt)
            except BaseException as e:  # noqa: BLE001
                self._fail(tb, e)
        finally:
            self._sem.release()

    def _fail(self, tb, exc: BaseException) -> None:
        nf = tb.n_frames
        status, ctype, body = _error_triplet(exc)
        self.batcher.fail(
            tb, status, _HTTP_REASONS.get(status, "Error"), ctype, body
        )
        self.service.metrics.request_counts.labels(
            status="1", method="/pb.gubernator.V1/GetRateLimits"
        ).inc(nf)

    def stop(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        # Detach from the service FIRST: nothing may read batcher stats
        # across the free below.
        if getattr(self.service, "native_ingress", None) is self:
            self.service.native_ingress = None
        # Wake the pump + 503 queued frames; in-flight dispatches
        # complete through the done pool.  The batcher is NOT freed
        # here: gateway workers may still be blocked in
        # edge.next(ingress=...) and a submit against freed memory is a
        # use-after-free — a stopped batcher answers every submit with
        # the fallback code instead.  NativeGatewayServer.close calls
        # release() once its workers are joined.
        self.batcher.stop()
        for t in self._threads:
            t.join(timeout=15.0)
        self._done_pool.shutdown(wait=True)

    def release(self) -> None:
        """Free the native batcher.  Only safe after every thread that
        could submit into it (the gateway workers) has exited."""
        if all(not t.is_alive() for t in self._threads):
            self.batcher.free()


class NativeGatewayServer:
    """The C++ epoll edge (host_runtime.cpp gt_http_*): one native
    thread owns accept/read/frame/write for every connection; N Python
    workers pull parsed requests (GIL released while blocked) and run
    the same handle_request path as the stdlib gateway.  Replaces the
    measured ~1.1 ms/request Python HTTP layer and the thread-per-
    connection model that convoys at 100-way concurrency.  No TLS — the daemon selects the stdlib gateway when
    TLS is configured."""

    # Workers only parse + SUBMIT (handle_request_async): the device
    # round completes through the service's drainer pool and responds
    # from there, so in-flight requests are bounded by the native
    # ingress queue, not this pool — a handful of workers keeps the
    # submit path fed even on a 1-core host.
    N_WORKERS = 4

    def __init__(self, service: V1Service, listen_address: str = "127.0.0.1:0",
                 n_workers: "Optional[int]" = None, acceptors: int = 1,
                 uds_path: str = ""):
        from . import native as _nat

        self.service = service
        if n_workers is not None and n_workers < 1:
            # Fail at startup: 0/negative would accept-but-never-serve.
            raise ValueError(
                f"native_workers must be >= 1, got {n_workers}"
            )
        self.n_workers = self.N_WORKERS if n_workers is None else n_workers
        self._edge = _nat.HttpEdge(  # raises if unavailable
            listen_address, acceptors=acceptors, uds_path=uds_path,
        )
        self._host = listen_address.partition(":")[0] or "127.0.0.1"
        self._threads: list = []
        self._stopped = threading.Event()
        # The native ingress service loop (NativeIngressPump): attached
        # by the daemon when the fast lane is on.  Workers hand kind-5
        # tokens to its batcher via edge.next(ingress=...); close()
        # stops it BEFORE the edge so staged responses never touch a
        # freed server.
        self.pump: "Optional[NativeIngressPump]" = None
        # The service's list of live edges (the /metrics scrape reads
        # their acceptor stats).
        service.native_edges = getattr(service, "native_edges", [])
        service.native_edges.append(self._edge)
        # Responses not yet handed back to the C++ edge: free() must
        # wait for this to reach zero — async completions outlive the
        # worker threads, and edge.respond on freed memory is a
        # use-after-free (shutdown() alone is safe: respond after
        # shutdown is an explicit no-op C++-side).
        self._pending = 0
        self._pending_cv = threading.Condition()

    @property
    def address(self) -> str:
        return f"{self._host}:{self._edge.port}"

    def start(self) -> None:
        for i in range(self.n_workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"native-gw-{i}")
            t.start()
            self._threads.append(t)

    def _worker(self) -> None:
        from .native import FAST_LANE

        edge, service = self._edge, self.service
        while not self._stopped.is_set():
            # The native fast lane: when the pump is attached, a kind-5
            # ingress frame is validated/hashed/routed/enqueued INSIDE
            # edge.next (one GIL-released native call) and this worker
            # never sees its bytes — Python's per-frame cost is the
            # token round trip.  Fallback reasons fall through to the
            # unchanged path below.
            pump = self.pump
            ingress = pump.batcher if pump is not None and pump.active else None
            # Cost profiler: time blocked in the native queue pull (the
            # GIL is released inside edge.next) folds as epoll.wait —
            # the "GIL-idle in epoll" answer, distinct from parse work.
            with profiling.scope("epoll.wait"):
                got = edge.next(timeout_ms=200, ingress=ingress)
            if got is None:
                if edge.stopped:
                    return
                continue
            if got is FAST_LANE:
                continue
            token, method, path, body = got
            if getattr(service, "_closed", False):
                edge.respond(token, 503, b'{"code": 14, "message": "shutting down"}')
                continue
            with self._pending_cv:
                self._pending += 1
            handle_request_async(
                service, method, path, body, partial(self._respond, token)
            )

    def _respond(self, token: int, status: int, ctype: str,
                 payload: bytes) -> None:
        try:
            self._edge.respond(token, status, payload,
                               reason=_HTTP_REASONS.get(status, "Error"),
                               content_type=ctype)
        finally:
            with self._pending_cv:
                self._pending -= 1
                if self._pending == 0:
                    self._pending_cv.notify_all()

    def close(self) -> None:
        # Teardown order matters (use-after-free):
        # shutdown stops traffic but keeps the native server allocated;
        # the workers — possibly mid-device-round, about to respond() —
        # are joined BEFORE free() releases it.  A worker stuck past the
        # join timeout leaks the server instead of crashing into freed
        # memory.  The pump stops FIRST: its completions stage
        # responses into the edge, so it must drain while the server is
        # still allocated (respond-after-shutdown is a C++-side no-op).
        self._stopped.set()
        if self.pump is not None:
            self.pump.stop()
        self._edge.shutdown()
        deadline = time.monotonic() + 30.0
        for t in self._threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.1))
        # Async completions (service drainer / forward pool) may still
        # owe edge.respond calls after the workers exit; free() only
        # when none remain (a stuck completion leaks the edge instead
        # of crashing into freed memory, same policy as a stuck worker).
        with self._pending_cv:
            self._pending_cv.wait_for(
                lambda: self._pending == 0,
                timeout=max(deadline - time.monotonic(), 0.1),
            )
            drained = self._pending == 0
        workers_done = all(not t.is_alive() for t in self._threads)
        if self.pump is not None and workers_done:
            # Workers are out of edge.next: no submit can reach the
            # batcher anymore.
            self.pump.release()
        # Off the service's list before the native server frees: no
        # reader may reach a freed edge.
        edges = getattr(self.service, "native_edges", None)
        if edges is not None and self._edge in edges:
            edges.remove(self._edge)
        if drained and workers_done:
            self._edge.free()


class _GatewayHTTPServer(ThreadingHTTPServer):
    # socketserver's default listen backlog of 5 resets connections under
    # a concurrent client burst; the reference edge accepts thousands of
    # in-flight requests and bounds load at the request level instead
    # (1000-item cap, gubernator.go:118-121).
    request_queue_size = 128


class GatewayServer:
    def __init__(
        self,
        service: V1Service,
        listen_address: str = "127.0.0.1:0",
        tls_context: Optional[ssl.SSLContext] = None,
    ):
        self.service = service
        host, _, port = listen_address.partition(":")
        handler = _make_handler(service)
        self.httpd = _GatewayHTTPServer((host or "127.0.0.1", int(port or 0)), handler)
        self.httpd.daemon_threads = True
        if tls_context is not None:
            self.httpd.socket = tls_context.wrap_socket(self.httpd.socket, server_side=True)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def _make_handler(service: V1Service):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: N802 — silence stdlib logging
            pass

        def _send_bytes(self, status: int, content_type: str, body: bytes,
                        traceparent: "Optional[str]" = None) -> None:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            if traceparent:
                # W3C trace-context emission: the client learns the
                # trace id its request was sampled under.
                self.send_header("traceparent", traceparent)
            self.end_headers()
            self.wfile.write(body)

        def _refuse_if_closed(self) -> bool:
            """A closed daemon must refuse — keep-alive handler threads
            outlive server shutdown, but the reference's gRPC server
            kills streams on Close (daemon.go:254-274)."""
            if getattr(service, "_closed", False):
                self.close_connection = True
                try:
                    self.connection.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                return True
            return False

        def _read_raw(self) -> bytes:
            length = int(self.headers.get("Content-Length", "0"))
            return self.rfile.read(length) if length else b""

        def do_GET(self):  # noqa: N802
            if self._refuse_if_closed():
                return
            status, ctype, body = handle_request(
                service, "GET", self.path, b"", self.headers
            )
            self._send_bytes(status, ctype, body)

        def do_POST(self):  # noqa: N802
            if self._refuse_if_closed():
                return
            status, ctype, body = handle_request(
                service, "POST", self.path, self._read_raw(), self.headers
            )
            self._send_bytes(
                status, ctype, body,
                traceparent=tracing.take_emitted_traceparent(),
            )

    return Handler
