"""Peer transport client: lazy connections, columnar forward
coalescing, error LRU.

Parity with peer_client.go: per-peer request queue drained into one
GetPeerRateLimits call when BatchLimit is reached or the BatchWait
window closes (peer_client.go:272-312); NO_BATCHING bypasses the queue
(:143-152); last-error LRU with 5-minute TTL surfaced via HealthCheck
(:206-235); graceful shutdown drains in-flight requests (:351-385).

The forward queue is COLUMNAR (the peer half of the zero-dataclass
hot path, wire.py "columnar peer hop"): submissions accumulate lanes
into numpy-backed column buffers instead of per-request dataclasses,
the adaptive BatchWindow flushes them as ONE columnar RPC per <=
batch_limit lanes, and every waiter gets back a slice of the shared
decoded response arrays.  Wire encoding negotiates per peer: proto
columns (gRPC) / the binary frame (HTTP) first; a peer that answers
UNIMPLEMENTED / HTTP 400 is remembered as classic-only and served the
per-request encoding from then on.

Default transport is gRPC against the peer's PeersV1 service — the
same data plane as the reference (lazy channel = the reference's lazy
`connect()`, peer_client.go:87-132).  An HTTP fallback speaks the
peer's gateway, used when TLS is configured with insecure_skip_verify
(gRPC channel credentials cannot skip verification) or on request.

The PyTorch port's copy of the JAX package's peer_client.py.  The
request bytes on both transports are the JAX client's
(tests/test_torch_peer_client.py).  `grpc` and the generated pb
modules are imported at the first gRPC call, not with the module: a
node that speaks HTTP to its peers needs neither.  The service hands
every client its incident black box (`blackbox=`, blackbox.py), which
taps each peer frame sent and received.  `update_region_columns` takes a batch with the
federation plane's RegionBatch surface (`frame`, `columns_pb`,
`classic_pb_chunks`, `classic_json_chunks`, `total_hits`), as
federation.py's sender builds it.
"""

from __future__ import annotations

import http.client
import json
import ssl
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import audit
from . import faults as faults_mod
from . import profiling
from . import saturation
from . import tracing
from . import wire
from .config import MAX_BATCH_SIZE, PEER_COLUMNS_MAX_LANES, BehaviorConfig
from .faults import CircuitBreaker, FaultPlan
from .utils.batch_window import BatchWindow
from .proto import PEERS_V1_SERVICE
from .wire import pc_pb, peers_pb
from .types import (
    Behavior,
    GetRateLimitsRequest,
    GetRateLimitsResponse,
    PeerInfo,
    RateLimitRequest,
    RateLimitResponse,
    UpdatePeerGlobal,
    has_behavior,
)

ERR_CLOSING = "grpc: the client connection is closing"



def _grpc():
    """The grpc module, imported at the first gRPC call."""
    import grpc

    return grpc


def _not_ready_codes():
    """Only connection-level failures count as "not ready" (the
    reference's IsNotReady checks the connecting state machine,
    peer_client.go:405-412).  DEADLINE_EXCEEDED is deliberately NOT
    here: a timed-out RPC may still have executed server-side (Python
    gRPC handlers run to completion after the client deadline), so
    retrying it would double-count hits."""
    return (_grpc().StatusCode.UNAVAILABLE,)


class PeerError(Exception):
    def __init__(self, message: str, not_ready: bool = False,
                 circuit_open: bool = False, http_status: int = 0):
        super().__init__(message)
        self.not_ready = not_ready
        # The call never left this host: the peer's circuit breaker was
        # open.  Routers degrade to local evaluation instead of
        # retrying (faults.py; service._forward_one).
        self.circuit_open = circuit_open
        # HTTP transport only: the peer's status code (0 = not an HTTP
        # status failure).  The columns negotiation reads it — a 400 to
        # a columns frame means "old peer, speak JSON".
        self.http_status = http_status


def is_not_ready(err: Exception) -> bool:
    """Reference `IsNotReady` (peer_client.go:405-412)."""
    return isinstance(err, PeerError) and err.not_ready


def is_circuit_open(err: Exception) -> bool:
    """True when the failure is a breaker fast-fail — the RPC was never
    attempted, so degraded local evaluation is safe (no double-count
    risk) and retrying the same peer is pointless until the breaker's
    half-open probe succeeds."""
    return isinstance(err, PeerError) and err.circuit_open


class PeerClient:
    LAST_ERR_TTL_S = 300.0  # peer_client.go:77 (5 minute TTL)
    LAST_ERR_MAX = 100  # bounded LRU like the reference (peer_client.go:77)

    def __init__(
        self,
        info: PeerInfo,
        behaviors: Optional[BehaviorConfig] = None,
        tls_context: Optional[ssl.SSLContext] = None,
        channel_credentials: "Optional[grpc.ChannelCredentials]" = None,
        transport: str = "",  # "" = auto, "grpc", "http"
        metrics: object = None,  # Optional[Metrics]: breaker transition counts
        faults: Optional[FaultPlan] = None,  # None = honor faults.install()
        blackbox: object = None,  # Optional[BlackBox]: wire traffic tap
    ):
        self.info = info
        self.behaviors = behaviors or BehaviorConfig()
        self.tls_context = tls_context
        self.channel_credentials = channel_credentials
        self.faults = faults
        self._metrics = metrics
        # Incident black box (blackbox.py): _http_roundtrip taps every
        # outbound GUBC frame + its response here — the one choke point
        # ALL HTTP peer traffic (forward, globals, transfer, region,
        # and fault-injected redeliveries) flows through.
        self.blackbox = blackbox
        self.breaker = CircuitBreaker(
            failure_threshold=self.behaviors.circuit_threshold,
            open_interval_s=self.behaviors.circuit_open_interval_s,
            on_transition=self._on_breaker_transition,
        )
        if not transport:
            # insecure_skip_verify TLS has no gRPC equivalent: the ssl
            # context fallback is the only transport that can honor it.
            transport = (
                "http"
                if tls_context is not None and channel_credentials is None
                else "grpc"
            )
        self.transport = transport
        self._conn_lock = threading.Lock()
        self._conn: Optional[http.client.HTTPConnection] = None
        self._channel: "Optional[grpc.Channel]" = None
        self._rpc_get_peer_rate_limits = None
        self._rpc_get_peer_rate_limits_columns = None
        self._rpc_update_peer_globals = None
        self._rpc_update_peer_globals_columns = None
        self._rpc_transfer_ownership = None
        self._rpc_update_region_columns = None
        self._shutdown = threading.Event()
        self._err_lock = threading.Lock()
        self._last_err: Dict[str, float] = {}  # message -> expiry timestamp
        # Columnar wire negotiation: None = untried (probe columns
        # first), True = peer speaks columns, False = classic only
        # (config opt-out, or the peer answered UNIMPLEMENTED / 400 to
        # the probe).  Sticky for the client's lifetime — a peer that
        # upgrades in place re-negotiates when churn rebuilds the
        # client (service.set_peers).
        self._columnar: Optional[bool] = (
            None if self.behaviors.peer_columns else False
        )
        # Whether the peer accepts the frame trace-context trailer
        # (HTTP transport only; gRPC needs no probe — proto3 unknown
        # fields are skipped).  None = untried: the first SAMPLED frame
        # probes; a peer that answers "length mismatch" predates the
        # trailer and is resent the same frame without it.
        self._trace_frames: Optional[bool] = None
        # GLOBAL broadcast encoding negotiation, independent of the
        # forward-hop flag above (its own GUBER_GLOBAL_COLUMNS knob):
        # None = untried (probe columns first), True = peer takes the
        # columnar broadcast, False = classic per-item only.  Sticky for
        # the client's lifetime, like _columnar.
        self._globals_columnar: Optional[bool] = (
            None if getattr(self.behaviors, "global_columns", True) else False
        )
        # Multi-region federation negotiation (federation.py), on its
        # own GUBER_REGION_COLUMNS knob: None = untried (the first
        # region send probes the columnar encoding), True = peer takes
        # RegionColumns, False = classic per-item GetPeerRateLimits
        # only (pre-federation peer, or its knob is off) — sticky for
        # the client's lifetime like the other planes.
        self._region_columnar: Optional[bool] = (
            None if getattr(self.behaviors, "region_columns", True) else False
        )
        # Ownership-transfer plane negotiation (reshard.py), on its own
        # GUBER_RESHARD knob: None = untried (the first transfer
        # probes), True = peer accepts transfers, False = no transfer
        # surface (pre-reshard peer, or its knob is off) — sticky for
        # the client's lifetime like the other planes; churn rebuilds
        # the client and re-negotiates.
        self._transfer_supported: Optional[bool] = (
            None if getattr(self.behaviors, "reshard", True) else False
        )
        # Per-RPC lane caps.  The operator's GUBER_BATCH_LIMIT keeps
        # meaning on both encodings: it is the classic per-RPC cap
        # verbatim, and the columnar cap scales with it (16.384x at the
        # default 1000) bounded by what the protocol allows.
        self._classic_cap = min(self.behaviors.batch_limit, MAX_BATCH_SIZE)
        self._columns_cap = max(
            1, PEER_COLUMNS_MAX_LANES * self._classic_cap // MAX_BATCH_SIZE
        )
        # Lazy worker: idle peers (never forwarded to) spawn no thread.
        # Items are ((names, uks, algo, beh, hits, limit, dur), fut)
        # COLUMN sub-batches; the limit counts LANES (weigh) and the
        # window adapts its wait to the arrival rate (batch_window.py).
        # A columns-capable peer accepts PEER_COLUMNS_MAX_LANES per
        # RPC, so the window coalesces up to the columnar cap per flush
        # (the whole point of the columnar hop: concurrent ingress
        # batches to one owner merge into ONE RPC); _send_batch chunks
        # down to what the negotiated encoding allows, and a peer that
        # negotiates down to classic shrinks the window itself
        # (_mark_classic) so flushes stop out-sizing its RPCs.
        self._window = BatchWindow(
            self._send_batch,
            self.behaviors.batch_wait_s,
            self._columns_cap
            if self.behaviors.peer_columns
            else self._classic_cap,
            lazy=True,
            adaptive=True,
            weigh=lambda item: len(item[0][0]),
        )

    # ------------------------------------------------------------------
    def get_peer_rate_limit(
        self, req: RateLimitRequest, timeout_s: Optional[float] = None,
        trace_ctx=None,
    ) -> RateLimitResponse:
        """One rate limit from the owning peer; batched unless the
        request asks NO_BATCHING (peer_client.go:141-154).  The batched
        path rides the columnar coalescer as a 1-lane sub-batch.
        `trace_ctx` carries the submitting request's span context when
        the caller runs on a pool thread with no ambient one
        (service._forward_one) — forward_columns falls back to
        tracing.current() otherwise."""
        if has_behavior(req.behavior, Behavior.NO_BATCHING):
            resp = self.get_peer_rate_limits(
                GetRateLimitsRequest(requests=[req]), timeout_s=timeout_s
            )
            return resp.responses[0]
        fut = self.forward_columns(
            (
                [req.name],
                [req.unique_key],
                np.array([int(req.algorithm)], np.int32),
                np.array([int(req.behavior)], np.int32),
                np.array([int(req.hits)], np.int64),
                np.array([int(req.limit)], np.int64),
                np.array([int(req.duration)], np.int64),
            ),
            trace_ctx=trace_ctx,
        )
        timeout = timeout_s if timeout_s is not None else self.behaviors.batch_timeout_s
        rc, lo, _hi = fut.result(timeout=timeout + 1.0)
        return rc.response_at(lo)

    def forward_columns(self, cols: "wire.PeerColumns",
                        trace_ctx=None) -> Future:
        """Submit a column sub-batch to the per-owner coalescing window
        (peer_client.go:272-312 sendQueue, columnar).  The future
        resolves to (result: service.ColumnarResult, lo, hi) — this
        sub-batch's slice of the shared flushed batch — or raises the
        transport/breaker failure.  `trace_ctx` (a tracing.SpanContext)
        rides the sub-batch so the flushed RPC can carry the wire
        trace-context column and link its peer.rpc span."""
        if self._shutdown.is_set():
            raise PeerError(ERR_CLOSING, not_ready=True)
        fut: Future = Future()
        if trace_ctx is None and tracing.enabled():
            trace_ctx = tracing.current()
        if trace_ctx is not None:
            fut._trace_ctx = trace_ctx  # read back at flush (same Future)
        self._window.submit((cols, fut))
        return fut

    def send_columns_direct(self, cols: "wire.PeerColumns",
                            timeout_s: Optional[float] = None,
                            trace_ctx=None):
        """One columnar GetPeerRateLimits RPC, no window (the
        NO_BATCHING group forward).  Returns service.ColumnarResult."""
        if self._shutdown.is_set():
            raise PeerError(ERR_CLOSING, not_ready=True)
        trace = None
        if trace_ctx is not None and tracing.enabled():
            trace = tracing.links_to_entries([trace_ctx], 0, len(cols[0]))
        return self._send_columns(
            cols,
            timeout_s if timeout_s is not None else self.behaviors.batch_timeout_s,
            trace=trace,
        )

    def get_peer_rate_limits(
        self, req: GetRateLimitsRequest, timeout_s: Optional[float] = None,
        _draining: bool = False,
    ) -> GetRateLimitsResponse:
        """Owner-authoritative batch (PeersV1.GetPeerRateLimits).
        `_draining` lets the shutdown drain flush already-queued
        requests through the still-open connection
        (peer_client.go:351-385) after new requests are refused."""
        n = len(req.requests)

        def _count_check(got: int) -> None:
            # Runs inside the _guarded_call region: a peer that
            # consistently returns the wrong number of rate limits
            # (version skew, corruption) trips its breaker like any
            # transport failure would.
            if got != n:
                msg = (
                    f"GetPeerRateLimits to peer {self.info.grpc_address} "
                    f"returned {got} rate limits for {n} requests"
                )
                self._set_last_err(msg)
                raise PeerError(msg)

        hits = sum(int(r.hits) for r in req.requests)
        audit.note("forward_admitted_hits", hits)
        if self.transport == "http":
            body = self._post(
                "/v1/peer.GetPeerRateLimits", req.to_json(), timeout_s,
                check=lambda b: _count_check(len(b.get("rateLimits", []))),
                wire_hits=hits,
            )
            resp = GetRateLimitsResponse.from_json(
                {"responses": body.get("rateLimits", [])}
            )
        else:
            m = self._grpc_call(
                "GetPeerRateLimits",
                wire.peer_rate_limits_req_to_pb(req),
                timeout_s,
                allow_closing=_draining,
                check=lambda m: _count_check(len(m.rate_limits)),
                wire_hits=hits,
            )
            resp = wire.peer_rate_limits_resp_from_pb(m)
        return resp

    def update_peer_globals(
        self, updates: Sequence[UpdatePeerGlobal], timeout_s: Optional[float] = None
    ) -> None:
        """PeersV1.UpdatePeerGlobals, classic per-item encoding (the
        legacy dataclass API; the GlobalManager's fan-out sends
        update_peer_globals_batch, which negotiates the columnar
        encoding and caches each encode across peers)."""
        if self.transport == "http":
            payload = {"globals": [u.to_json() for u in updates]}
            self._post("/v1/peer.UpdatePeerGlobals", payload, timeout_s)
        else:
            self._grpc_call(
                "UpdatePeerGlobals", wire.update_globals_req_to_pb(updates), timeout_s
            )

    def update_peer_globals_batch(
        self, batch: "wire.BroadcastBatch", timeout_s: Optional[float] = None,
        trace_ctx=None,
    ) -> None:
        """One GLOBAL broadcast send from a pre-encoded BroadcastBatch
        (encode-once fan-out: every peer reuses the same cached wire
        bytes).  Encoding negotiates per peer like the forward hop:
        proto columns (gRPC UpdatePeerGlobalsColumns) / the GUBC
        globals frame (HTTP, same /v1/peer.UpdatePeerGlobals path)
        first; a peer that answers UNIMPLEMENTED / 4xx is remembered as
        classic-only and resent the per-item encoding inside the same
        guarded call — the probe is breaker- and health-neutral.
        `trace_ctx` links the per-peer peer.rpc client span into the
        tick's global.sync trace (tracing.py)."""
        if self._shutdown.is_set():
            raise PeerError(ERR_CLOSING, not_ready=True)
        t0 = time.monotonic_ns()
        rpc_err: Optional[Exception] = None
        try:
            if self.transport == "http":
                self._guarded_call(
                    "UpdatePeerGlobals",
                    lambda: self._post_globals_inner(batch, timeout_s),
                )
            else:
                self._guarded_call(
                    "UpdatePeerGlobals",
                    lambda: self._grpc_globals_inner(batch, timeout_s),
                )
        except Exception as e:  # noqa: BLE001 — re-raised below
            rpc_err = e
            raise
        finally:
            if trace_ctx is not None:
                bt = tracing.new_batch([trace_ctx])
                if bt is not None:
                    attrs = dict(
                        peer=self.info.grpc_address,
                        op="UpdatePeerGlobals",
                        items=len(batch),
                        encoding=(
                            "columns" if self._globals_columnar else "classic"
                        ),
                    )
                    if rpc_err is not None:
                        attrs["error"] = str(rpc_err)
                    tracing.record_span(
                        "peer.rpc", bt.ctx,
                        start_ns=t0, end_ns=time.monotonic_ns(),
                        links=bt.links, **attrs,
                    )
        if self._metrics is not None:
            self._metrics.global_broadcast_batches.labels(
                encoding="columns" if self._globals_columnar else "classic"
            ).inc()

    def _grpc_globals_inner(self, batch: "wire.BroadcastBatch",
                            timeout_s: Optional[float]) -> None:
        """Columnar UpdatePeerGlobals over gRPC, falling back to the
        classic per-item message on UNIMPLEMENTED (the method never
        executed, so the classic resend cannot double-apply)."""
        grpc = _grpc()
        timeout = (
            timeout_s if timeout_s is not None else self.behaviors.batch_timeout_s
        )
        try:
            _get_rl, upd, _get_cols, upd_cols = self._ensure_channel()
            if self._globals_columnar is not False:
                try:
                    upd_cols(batch.columns_pb(), timeout=timeout)
                    self._globals_columnar = True
                    return
                except grpc.RpcError as e:
                    code = e.code() if hasattr(e, "code") else None
                    if code == grpc.StatusCode.UNIMPLEMENTED:
                        self._globals_columnar = False
                    else:
                        raise
            upd(batch.classic_pb(), timeout=timeout)
        except grpc.RpcError as e:
            raise self._wrap_grpc_error("UpdatePeerGlobals", e) from e
        except ValueError as e:
            raise self._wrap_value_error("UpdatePeerGlobals", e) from e

    def _post_globals_inner(self, batch: "wire.BroadcastBatch",
                            timeout_s: Optional[float]) -> None:
        """Columnar UpdatePeerGlobals over HTTP: the GUBC globals frame
        against the same /v1/peer.UpdatePeerGlobals path (the receiver
        sniffs the magic).  An old peer rejects the frame — 4xx from
        its JSON parse, or the pre-columns gateway's 500 naming the
        codec failure — which proves it was not applied, so the classic
        per-item JSON resend inside this same guarded call is safe and
        the probe stays breaker/health-neutral."""
        if self._globals_columnar is not False:
            try:
                self._http_roundtrip(
                    "/v1/peer.UpdatePeerGlobals", batch.frame(), timeout_s,
                    wire.COLUMNS_CONTENT_TYPE,
                )
                self._globals_columnar = True
                return
            except PeerError as e:
                rejected = e.http_status in (400, 404, 415) or (
                    e.http_status == 500 and "codec can't decode" in str(e)
                )
                if not rejected:
                    raise
                self._globals_columnar = False
                # A benign version probe, not a peer failure: it must
                # not leave HealthCheck unhealthy for 5 minutes.
                self._clear_last_err(str(e))
        self._http_roundtrip(
            "/v1/peer.UpdatePeerGlobals", batch.classic_json_bytes(),
            timeout_s, "application/json",
        )

    # ------------------------------------------------------------------
    def update_region_columns(
        self, batch, timeout_s: Optional[float] = None, trace_ctx=None,
    ) -> None:
        """One cross-region hit send from a pre-encoded
        federation.RegionBatch (encode-once fan-out: every region's
        owner reuses the same cached wire bytes).  Encoding negotiates
        per peer like the other planes: proto columns (gRPC
        UpdateRegionColumns) / the GUBC kind-7 frame (HTTP,
        /v1/peer.UpdateRegionColumns) first; a peer that answers
        UNIMPLEMENTED / 404 is remembered as classic-only and resent
        the per-item GetPeerRateLimits encoding — the exact
        pre-federation wire — inside the same guarded call, so the
        probe is breaker- and health-neutral.

        Conservation accounting (audit.py): the batch's hits are noted
        `region_admitted_hits` once per logical send here, and
        `region_wire_hits` once per delivery that reached the peer
        (the guarded call's wire counter) — a FaultPlan DUPLICATE
        delivery doubles the wire side and trips region_conservation."""
        if self._shutdown.is_set():
            raise PeerError(ERR_CLOSING, not_ready=True)
        hits = batch.total_hits()
        audit.note("region_admitted_hits", hits)
        t0 = time.monotonic_ns()
        rpc_err: Optional[Exception] = None
        try:
            if self.transport == "http":
                self._guarded_call(
                    "UpdateRegionColumns",
                    lambda: self._post_region_inner(batch, timeout_s),
                    wire_hits=hits, wire_counter="region_wire_hits",
                )
            else:
                self._guarded_call(
                    "UpdateRegionColumns",
                    lambda: self._grpc_region_inner(batch, timeout_s),
                    wire_hits=hits, wire_counter="region_wire_hits",
                )
        except Exception as e:  # noqa: BLE001 — re-raised below
            rpc_err = e
            raise
        finally:
            if trace_ctx is not None:
                bt = tracing.new_batch([trace_ctx])
                if bt is not None:
                    attrs = dict(
                        peer=self.info.grpc_address,
                        op="UpdateRegionColumns",
                        lanes=len(batch),
                        encoding=(
                            "columns" if self._region_columnar else "classic"
                        ),
                    )
                    if rpc_err is not None:
                        attrs["error"] = str(rpc_err)
                    tracing.record_span(
                        "peer.rpc", bt.ctx,
                        start_ns=t0, end_ns=time.monotonic_ns(),
                        links=bt.links, **attrs,
                    )
        if self._metrics is not None:
            self._metrics.region_batches.labels(
                encoding="columns" if self._region_columnar else "classic"
            ).inc()

    def _grpc_region_inner(self, batch, timeout_s: Optional[float]) -> None:
        """Columnar UpdateRegionColumns over gRPC, falling back to the
        classic per-item GetPeerRateLimits chunks on UNIMPLEMENTED (the
        method never executed, so the classic resend cannot
        double-apply).  A classic chunk train that fails AFTER a chunk
        applied is no longer retry-safe: the error is re-shaped
        timeout-like (not_ready=False) so the sender drops counted
        instead of requeueing a partially-applied batch."""
        grpc = _grpc()
        timeout = (
            timeout_s if timeout_s is not None else self.behaviors.batch_timeout_s
        )
        bb = self.blackbox
        if bb is not None and bb.live():
            # Canonical kind-7 frame of the proto send (see the
            # _grpc_columns_inner tap): per delivery, so a DUPLICATE
            # re-delivery records twice.
            bb.tap("out", self.info.grpc_address, batch.frame())
        try:
            get_rl, _upd, _get_cols, _upd_cols = self._ensure_channel()
            with self._conn_lock:
                rpc = self._rpc_update_region_columns
            if rpc is None:  # torn down by a concurrent reset
                raise PeerError(ERR_CLOSING, not_ready=True)
            if self._region_columnar is not False:
                try:
                    rpc(batch.columns_pb(), timeout=timeout)
                    self._region_columnar = True
                    return
                except grpc.RpcError as e:
                    code = e.code() if hasattr(e, "code") else None
                    if code == grpc.StatusCode.UNIMPLEMENTED:
                        self._region_columnar = False
                    else:
                        raise
            applied_any = False
            try:
                for m in batch.classic_pb_chunks(self._classic_cap):
                    get_rl(m, timeout=timeout)
                    applied_any = True
            except grpc.RpcError as e:
                err = self._wrap_grpc_error("UpdateRegionColumns", e)
                if applied_any:
                    err.not_ready = False
                raise err from e
        except PeerError:
            raise
        except grpc.RpcError as e:
            raise self._wrap_grpc_error("UpdateRegionColumns", e) from e
        except ValueError as e:
            raise self._wrap_value_error("UpdateRegionColumns", e) from e

    def _post_region_inner(self, batch, timeout_s: Optional[float]) -> None:
        """Region send over HTTP: the GUBC kind-7 frame against
        /v1/peer.UpdateRegionColumns.  An old peer (or
        GUBER_REGION_COLUMNS=0) has no handler on that path — 404,
        provably unapplied — so the classic per-item JSON resend to
        /v1/peer.GetPeerRateLimits inside this same guarded call is
        safe and the probe stays breaker/health-neutral.  Same
        partial-apply rule as the gRPC twin: a chunk-train failure
        after an applied chunk presents timeout-shaped."""
        if self._region_columnar is not False:
            try:
                self._http_roundtrip(
                    "/v1/peer.UpdateRegionColumns", batch.frame(), timeout_s,
                    wire.COLUMNS_CONTENT_TYPE,
                )
                self._region_columnar = True
                return
            except PeerError as e:
                rejected = e.http_status in (400, 404, 415, 501) or (
                    e.http_status == 500 and "codec can't decode" in str(e)
                )
                if not rejected:
                    raise
                self._region_columnar = False
                # A benign version probe, not a peer failure: it must
                # not leave HealthCheck unhealthy for 5 minutes.
                self._clear_last_err(str(e))
        applied_any = False
        try:
            for body in batch.classic_json_chunks(self._classic_cap):
                self._http_roundtrip(
                    "/v1/peer.GetPeerRateLimits", body, timeout_s,
                    "application/json",
                )
                applied_any = True
        except PeerError as e:
            if applied_any:
                e.not_ready = False
            raise

    # ------------------------------------------------------------------
    def transfer_ownership(
        self, cols, timeout_s: Optional[float] = None
    ) -> str:
        """Ship one ownership-transfer batch (reshard.TransferColumns)
        to this peer — the new owner of the batch's keys after a ring
        delta.  Returns:

          * "ok"          — the peer merge-committed the batch.
          * "unsupported" — the peer has no transfer surface
            (pre-reshard build or GUBER_RESHARD=0).  Sticky per client
            and breaker/health-neutral: a version answer, not a fault.
          * "fenced"      — the peer's ring changed again and it
            rejected this dead-epoch batch (FAILED_PRECONDITION / 409).
            Also breaker/health-neutral — the fence is the protocol
            working, not the peer failing.

        Raises PeerError on real transport failures (breaker-counted).
        The receive-side commit is monotone/idempotent, so retrying a
        timeout-shaped failure can never double-count."""
        if self._shutdown.is_set():
            raise PeerError(ERR_CLOSING, not_ready=True)
        if self._transfer_supported is False:
            return "unsupported"
        if self.transport == "http":
            return self._guarded_call(
                "TransferOwnership",
                lambda: self._post_transfer_inner(cols, timeout_s),
            )
        return self._guarded_call(
            "TransferOwnership",
            lambda: self._grpc_transfer_inner(cols, timeout_s),
        )

    def _grpc_transfer_inner(self, cols, timeout_s: Optional[float]) -> str:
        grpc = _grpc()
        timeout = (
            timeout_s if timeout_s is not None else self.behaviors.batch_timeout_s
        )
        try:
            self._ensure_channel()
            with self._conn_lock:
                rpc = self._rpc_transfer_ownership
            if rpc is None:  # torn down by a concurrent reset
                raise PeerError(ERR_CLOSING, not_ready=True)
            try:
                rpc(wire.transfer_cols_to_pb(cols), timeout=timeout)
                self._transfer_supported = True
                return "ok"
            except grpc.RpcError as e:
                code = e.code() if hasattr(e, "code") else None
                if code == grpc.StatusCode.UNIMPLEMENTED:
                    # The method never executed: remember and let the
                    # caller fall back to classic (pre-reshard)
                    # semantics; the probe is breaker/health-neutral.
                    self._transfer_supported = False
                    return "unsupported"
                if code == grpc.StatusCode.FAILED_PRECONDITION:
                    return "fenced"
                raise
        except grpc.RpcError as e:
            raise self._wrap_grpc_error("TransferOwnership", e) from e
        except ValueError as e:
            raise self._wrap_value_error("TransferOwnership", e) from e

    def _post_transfer_inner(self, cols, timeout_s: Optional[float]) -> str:
        """Transfer over HTTP: the GUBC transfer frame against
        /v1/peer.TransferOwnership.  An old peer (or GUBER_RESHARD=0)
        has no handler on that path — 404, provably unapplied — and a
        receiver that fenced the epoch answers 409; both are remembered
        /returned without counting against breaker or health."""
        try:
            self._http_roundtrip(
                "/v1/peer.TransferOwnership",
                wire.encode_transfer_frame(cols),
                timeout_s, wire.COLUMNS_CONTENT_TYPE,
            )
            self._transfer_supported = True
            return "ok"
        except PeerError as e:
            if e.http_status in (400, 404, 415, 501):
                self._transfer_supported = False
                self._clear_last_err(str(e))
                return "unsupported"
            if e.http_status == 409:
                self._clear_last_err(str(e))
                return "fenced"
            raise

    # ------------------------------------------------------------------
    def _send_batch(self, batch: List[tuple]) -> None:
        """peer_client.go:316-348 sendQueue, columnar: concatenate the
        queued column sub-batches and send ONE columnar RPC per chunk.
        The chunk cap is what the peer is KNOWN to accept: a confirmed
        columns speaker takes PEER_COLUMNS_MAX_LANES; an unconfirmed or
        classic peer takes MAX_BATCH_SIZE (the probe that discovers an
        old peer falls back to the classic encoding inside the same
        call, so the probe chunk must already satisfy the classic cap).
        Waiters get (shared result, lo, hi) slices."""
        cap = (
            self._columns_cap if self._columnar is True
            else self._classic_cap
        )
        chunk: List[tuple] = []
        lanes = 0
        for item in batch:
            n = len(item[0][0])
            if chunk and lanes + n > cap:
                self._send_chunk(chunk)
                chunk, lanes = [], 0
                # A probe chunk may just have confirmed columns
                # support; later chunks of the same flush coalesce up
                # to the full columnar cap right away.
                cap = (
                    self._columns_cap if self._columnar is True
                    else self._classic_cap
                )
            chunk.append(item)
            lanes += n
        if chunk:
            self._send_chunk(chunk)

    def _mark_classic(self) -> None:
        """The peer negotiated down to the classic encoding: remember,
        and shrink the coalescing window to the classic per-RPC cap so
        future flushes are ONE RPC each — without this, a 16k-lane
        window against a classic peer becomes a train of sequential
        chunk RPCs whose late waiters outlive their timeout budget."""
        self._columnar = False
        self._window.limit = self._classic_cap

    def _classic_resend(self, cols: "wire.PeerColumns", send_chunk):
        """Downgraded resend shared by both transports: re-chunk a
        (possibly columnar-cap-sized) batch to the classic per-RPC cap
        and send each chunk with `send_chunk(sub) -> ColumnarResult`,
        concatenating the results lane-aligned."""
        n_total = len(cols[0])
        cap = self._classic_cap
        parts = []
        for lo in range(0, n_total, cap):
            parts.append(
                send_chunk(
                    wire.peer_columns_slice(cols, lo, min(lo + cap, n_total))
                )
            )
        return wire.concat_results(parts)

    def _trace_entries(self, chunk: List[tuple]):
        """Wire trace-context entries for a chunk: one lane-range entry
        per SAMPLED sub-batch (all lanes of one ingress submission share
        its context).  Returns (entries | None, link contexts)."""
        if not tracing.enabled():
            return None, ()
        entries, links, lo = [], [], 0
        for c, fut in chunk:
            hi = lo + len(c[0])
            ctx = getattr(fut, "_trace_ctx", None)
            if ctx is not None:
                entries.append((lo, hi, ctx.trace_id, ctx.span_id))
                links.append(ctx)
            lo = hi
        return (entries or None), links

    def _send_chunk(self, chunk: List[tuple]) -> None:
        try:
            if len(chunk) == 1:
                cols = chunk[0][0]
            else:
                cols = (
                    [s for c, _ in chunk for s in c[0]],
                    [s for c, _ in chunk for s in c[1]],
                    *(
                        np.concatenate([c[i] for c, _ in chunk])
                        for i in range(2, 7)
                    ),
                )
            trace, links = self._trace_entries(chunk)
            t0 = time.monotonic_ns()
            rpc_err = None
            try:
                with profiling.scope("peer.rpc"):
                    rc = self._send_columns(
                        cols, self.behaviors.batch_timeout_s, _draining=True,
                        trace=trace,
                    )
            except Exception as e:  # noqa: BLE001 — re-raised below
                rpc_err = e
                raise
            finally:
                # Always-on attribution: the forwarded hop's round trip
                # is one of the waterfall's phases (saturation.py).
                saturation.observe_phase(
                    "peer.rpc", (time.monotonic_ns() - t0) / 1e9
                )
                bt = tracing.new_batch(links)
                if bt is not None:
                    # The client half of the cross-daemon hop: one span
                    # for the RPC, linked to every sampled sub-batch it
                    # coalesced (one RPC carries many traces — link,
                    # not nest).  A failed RPC stamps the error — the
                    # span must not read as a completed round trip.
                    attrs = dict(
                        peer=self.info.grpc_address,
                        lanes=len(cols[0]),
                        encoding="columns" if self._columnar else "classic",
                    )
                    if rpc_err is not None:
                        attrs["error"] = str(rpc_err)
                    tracing.record_span(
                        "peer.rpc", bt.ctx,
                        start_ns=t0, end_ns=time.monotonic_ns(),
                        links=links, **attrs,
                    )
        except Exception as e:  # noqa: BLE001
            for _, fut in chunk:
                if not fut.done():
                    fut.set_exception(e)
            return
        lo = 0
        for c, fut in chunk:
            hi = lo + len(c[0])
            if not fut.done():
                fut.set_result((rc, lo, hi))
            lo = hi

    def _send_columns(self, cols: "wire.PeerColumns",
                      timeout_s: Optional[float], _draining: bool = False,
                      trace=None):
        """One columnar GetPeerRateLimits over the configured transport
        (negotiating the encoding, see _columnar).  Returns a decoded
        service.ColumnarResult of exactly len(cols) lanes.  `trace`
        (wire.TraceEntry list) rides the columnar encodings only — the
        classic fallback drops it, pre-columns peers never see trace
        bytes."""
        n = len(cols[0])

        def _count_check(rc) -> None:
            # Inside the _guarded_call region: a wrong-count reply
            # trips the breaker like any transport failure.
            if rc.n != n:
                msg = (
                    f"GetPeerRateLimits to peer {self.info.grpc_address} "
                    f"returned {rc.n} rate limits for {n} requests"
                )
                self._set_last_err(msg)
                raise PeerError(msg)

        # Conservation ledger (audit.py): hits ADMITTED to the forward
        # wire, counted once per logical batch send; the per-delivery
        # twin (forward_wire_hits) is counted inside the guarded call.
        hits = int(cols[4].sum())
        audit.note("forward_admitted_hits", hits)
        if self.transport == "http":
            if self._shutdown.is_set() and not _draining:
                raise PeerError(ERR_CLOSING, not_ready=True)
            rc = self._guarded_call(
                "GetPeerRateLimits",
                lambda: self._post_columns_inner(cols, timeout_s, trace),
                _count_check,
                wire_hits=hits,
            )
        else:
            if self._shutdown.is_set() and not _draining:
                raise PeerError(ERR_CLOSING, not_ready=True)
            rc = self._guarded_call(
                "GetPeerRateLimits",
                lambda: self._grpc_columns_inner(cols, timeout_s, trace),
                _count_check,
                wire_hits=hits,
            )
        if self._metrics is not None:
            self._metrics.peer_columns_batches.labels(
                encoding="columns" if self._columnar else "classic"
            ).inc()
        return rc

    # ------------------------------------------------------------------
    # gRPC transport (lazy channel = peer_client.go:87-132 connect())
    # ------------------------------------------------------------------
    def _ensure_channel(self):
        """Returns (get_peer_rate_limits, update_peer_globals,
        get_peer_rate_limits_columns, update_peer_globals_columns)
        stubs, building the channel lazily.  The stubs are captured and
        returned under the lock: _reset_channel may null the attributes
        concurrently (a racing thread observing a torn state must not
        see None)."""
        grpc = _grpc()
        with self._conn_lock:
            if self._channel is None:
                target = self.info.grpc_address
                options = [("grpc.max_receive_message_length", 1024 * 1024)]
                if self.channel_credentials is not None:
                    self._channel = grpc.secure_channel(
                        target, self.channel_credentials, options=options
                    )
                else:
                    self._channel = grpc.insecure_channel(target, options=options)
                self._rpc_get_peer_rate_limits = self._channel.unary_unary(
                    f"/{PEERS_V1_SERVICE}/GetPeerRateLimits",
                    request_serializer=peers_pb.GetPeerRateLimitsReq.SerializeToString,
                    response_deserializer=peers_pb.GetPeerRateLimitsResp.FromString,
                )
                self._rpc_get_peer_rate_limits_columns = self._channel.unary_unary(
                    f"/{PEERS_V1_SERVICE}/GetPeerRateLimitsColumns",
                    request_serializer=pc_pb.PeerColumnsReq.SerializeToString,
                    response_deserializer=pc_pb.PeerColumnsResp.FromString,
                )
                self._rpc_update_peer_globals = self._channel.unary_unary(
                    f"/{PEERS_V1_SERVICE}/UpdatePeerGlobals",
                    request_serializer=peers_pb.UpdatePeerGlobalsReq.SerializeToString,
                    response_deserializer=peers_pb.UpdatePeerGlobalsResp.FromString,
                )
                self._rpc_update_peer_globals_columns = self._channel.unary_unary(
                    f"/{PEERS_V1_SERVICE}/UpdatePeerGlobalsColumns",
                    request_serializer=pc_pb.GlobalsColumnsReq.SerializeToString,
                    response_deserializer=peers_pb.UpdatePeerGlobalsResp.FromString,
                )
                self._rpc_transfer_ownership = self._channel.unary_unary(
                    f"/{PEERS_V1_SERVICE}/TransferOwnership",
                    request_serializer=pc_pb.TransferColumnsReq.SerializeToString,
                    response_deserializer=pc_pb.TransferResp.FromString,
                )
                self._rpc_update_region_columns = self._channel.unary_unary(
                    f"/{PEERS_V1_SERVICE}/UpdateRegionColumns",
                    request_serializer=pc_pb.RegionColumnsReq.SerializeToString,
                    response_deserializer=pc_pb.RegionColumnsResp.FromString,
                )
            return (
                self._rpc_get_peer_rate_limits,
                self._rpc_update_peer_globals,
                self._rpc_get_peer_rate_limits_columns,
                self._rpc_update_peer_globals_columns,
            )

    # ------------------------------------------------------------------
    # Fault-tolerance wrap: every transport call passes the breaker gate
    # then the installed fault plan (faults.py) before touching the wire.
    # ------------------------------------------------------------------
    def _on_breaker_transition(self, state: str) -> None:
        if self._metrics is not None:
            self._metrics.circuit_transitions.labels(
                peer=self.info.grpc_address, to=state
            ).inc()
        if state == "open":
            # Flight-recorder event + automatic dump (tracing.py): the
            # recorder's last-N spans are exactly the context a breaker
            # trip needs preserved before traffic moves on.
            tracing.record_event(
                "breaker-open", peer=self.info.grpc_address
            )

    def _breaker_gate(self, op: str) -> None:
        """Raise the circuit-open fast-fail, or reserve the call slot
        (every non-raising return MUST be paired with exactly one
        breaker.record_success/record_failure)."""
        if not self.breaker.allow():
            raise PeerError(
                f"{op} to peer {self.info.grpc_address} rejected: "
                f"circuit breaker open",
                not_ready=True,
                circuit_open=True,
            )

    def _fault_check(self, op: str) -> bool:
        """Consult the fault plan (instance-level, else the process-wide
        installed one).  An injected ERROR/DROP raises the same
        PeerError shape a real transport failure would — downstream
        retry/breaker/health behavior is exercised for real.  Returns
        True when a DUPLICATE rule fired: the guarded call delivers the
        transport call twice (byzantine re-delivery chaos)."""
        fp = self.faults if self.faults is not None else faults_mod.active()
        if fp is None:
            return False
        act = fp.intercept(self.info.grpc_address, op)
        if act is None:
            return False
        if act.kind == faults_mod.DELAY:
            time.sleep(act.delay_s)
            return False
        if act.kind == faults_mod.DUPLICATE:
            tracing.record_event(
                "fault", op=op, peer=self.info.grpc_address,
                kind_detail=act.kind,
            )
            return True
        msg = f"{op} to peer {self.info.grpc_address} failed: {act.message}"
        self._set_last_err(msg)
        tracing.record_event(
            "fault", op=op, peer=self.info.grpc_address, kind_detail=act.kind
        )
        raise PeerError(msg, not_ready=act.not_ready)

    def _attempt(self, fn, wire_hits: int,
                 wire_counter: str = "forward_wire_hits"):
        """One transport delivery, conservation-accounted: the attempt
        counts its hits into the audit ledger when it REACHED the peer —
        a normal return, or a failure past the point of no return (a
        timeout-ambiguous error: the RPC may have applied server-side).
        Provably-unapplied failures (connection-level not_ready, the
        breaker's own fast-fail) never left this host, so they don't
        count — which is exactly why a legitimate retry/re-pick after
        one keeps `wire <= admitted` intact while a DUPLICATE delivery
        breaks it.  `wire_counter` names the ledger counter (the
        forward hop and the region plane keep separate pairs)."""
        try:
            out = fn()
        except BaseException as e:
            if wire_hits and not (
                isinstance(e, PeerError) and e.not_ready
            ):
                audit.note(wire_counter, wire_hits)
            raise
        if wire_hits:
            audit.note(wire_counter, wire_hits)
        return out

    def _guarded_call(self, op: str, fn, check=None, wire_hits: int = 0,
                      wire_counter: str = "forward_wire_hits"):
        """The breaker protocol, shared by BOTH transports: gate ->
        injected-fault check -> fn() -> optional reply check -> record.
        Every non-raising _breaker_gate() pairs with exactly one
        record_success/record_failure (the half-open probe slot,
        faults.CircuitBreaker).  `check` runs INSIDE the guarded region
        so a structurally bad reply (wrong response count) counts as a
        breaker failure like any transport error, instead of resetting
        the failure streak before the caller notices.  `wire_hits` is
        the batch's hit total for the conservation ledger (audit.py):
        counted once per delivery that reached the peer, into
        `wire_counter`."""
        self._breaker_gate(op)
        try:
            dup = self._fault_check(op)
            out = (
                fn() if not wire_hits
                else self._attempt(fn, wire_hits, wire_counter)
            )
            if dup:
                # The injected re-delivery: the duplicate's OWN failure
                # is swallowed (a dropped duplicate is a clean network
                # again) and its result discarded — but its hits reached
                # the peer, which the ledger must see.
                try:
                    self._attempt(fn, wire_hits, wire_counter)
                except Exception:  # noqa: BLE001 — duplicate lost in flight
                    pass
            if check is not None:
                check(out)
        except BaseException:
            self.breaker.record_failure()
            raise
        self.breaker.record_success()
        return out

    def _grpc_call(self, method: str, request, timeout_s: Optional[float],
                   allow_closing: bool = False, check=None,
                   wire_hits: int = 0):
        if self._shutdown.is_set() and not allow_closing:
            raise PeerError(ERR_CLOSING, not_ready=True)
        return self._guarded_call(
            method, lambda: self._grpc_inner(method, request, timeout_s),
            check, wire_hits=wire_hits,
        )

    def _grpc_inner(self, method: str, request, timeout_s: Optional[float]):
        grpc = _grpc()
        try:
            get_rl, update_g, _, _ = self._ensure_channel()
            rpc = get_rl if method == "GetPeerRateLimits" else update_g
            timeout = (
                timeout_s if timeout_s is not None else self.behaviors.batch_timeout_s
            )
            return rpc(request, timeout=timeout)
        except grpc.RpcError as e:
            raise self._wrap_grpc_error(method, e) from e
        except ValueError as e:
            raise self._wrap_value_error(method, e) from e

    def _grpc_columns_inner(self, cols: "wire.PeerColumns",
                            timeout_s: Optional[float], trace=None):
        """Columnar GetPeerRateLimits over gRPC: proto columns against
        the peer's GetPeerRateLimitsColumns method; an UNIMPLEMENTED
        answer from an untried peer downgrades to the classic
        per-request encoding (same guarded call — the negotiation miss
        is not a breaker failure).  The trace column rides as a proto3
        field old receivers skip as unknown — no trace negotiation on
        this transport."""
        grpc = _grpc()
        timeout = (
            timeout_s if timeout_s is not None else self.behaviors.batch_timeout_s
        )
        bb = self.blackbox
        if bb is not None and bb.live():
            # gRPC carries proto columns, not GUBC bytes — capture the
            # canonical frame encoding of the same columns so the ring
            # stays replayable.  Tapped here (per delivery, inside the
            # guarded call) so a DUPLICATE re-delivery records twice.
            bb.tap("out", self.info.grpc_address,
                   wire.encode_columns_frame(cols, trace=trace))
        try:
            get_rl, _upd, get_cols, _ = self._ensure_channel()
            if self._columnar is not False:
                try:
                    m = get_cols(
                        wire.peer_columns_req_to_pb(cols, trace=trace),
                        timeout=timeout,
                    )
                    self._columnar = True
                    return wire.result_from_peer_columns_pb(m)
                except grpc.RpcError as e:
                    code = e.code() if hasattr(e, "code") else None
                    if code == grpc.StatusCode.UNIMPLEMENTED:
                        # Old (or in-place downgraded, even after a
                        # confirmed columnar run) peer: UNIMPLEMENTED
                        # means the method never executed, so the
                        # classic resend below cannot double-count.
                        self._mark_classic()
                    else:
                        raise
            return self._classic_resend(
                cols,
                lambda sub: wire.result_from_classic_peer_pb(
                    get_rl(wire.peer_columns_to_classic_pb(sub), timeout=timeout)
                ),
            )
        except grpc.RpcError as e:
            raise self._wrap_grpc_error("GetPeerRateLimits", e) from e
        except ValueError as e:
            raise self._wrap_value_error("GetPeerRateLimits", e) from e

    def _wrap_grpc_error(self, method: str, e: "grpc.RpcError") -> "PeerError":
        grpc = _grpc()
        code = e.code() if hasattr(e, "code") else None
        msg = f"{method} to peer {self.info.grpc_address} failed: {code}: {e.details() if hasattr(e, 'details') else e}"
        self._set_last_err(msg)
        # Drop the channel so the next call redials immediately
        # instead of sitting in gRPC's reconnect backoff (the lazy
        # reconnect of peer_client.go:87-132; a restarted peer at
        # the same address must be reachable right away).
        if code == grpc.StatusCode.UNAVAILABLE:
            self._reset_channel()
        return PeerError(msg, not_ready=code in _not_ready_codes())

    def _wrap_value_error(self, method: str, e: ValueError) -> "PeerError":
        """Two ValueError sources meet here: grpc's bare "Cannot invoke
        RPC: Channel closed!" from a shutdown racing a call (presented
        as the closing error, not a crash), and a reply that failed to
        decode (mismatched column lengths, corrupt payload) — a peer
        failure that must be recorded like any other so HealthCheck
        surfaces the misbehaving peer."""
        if "closed" in str(e).lower():
            return PeerError(ERR_CLOSING, not_ready=True)
        msg = f"{method} to peer {self.info.grpc_address} failed: {e}"
        self._set_last_err(msg)
        return PeerError(msg)

    def _reset_channel(self) -> None:
        with self._conn_lock:
            if self._channel is not None:
                self._channel.close()
                self._channel = None
                self._rpc_get_peer_rate_limits = None
                self._rpc_update_peer_globals = None
                self._rpc_get_peer_rate_limits_columns = None
                self._rpc_update_peer_globals_columns = None
                self._rpc_transfer_ownership = None
                self._rpc_update_region_columns = None

    # ------------------------------------------------------------------
    # HTTP/JSON fallback transport (the peer's gateway surface)
    # ------------------------------------------------------------------
    def _post(self, path: str, payload: dict, timeout_s: Optional[float],
              check=None, wire_hits: int = 0) -> dict:
        op = path.rpartition(".")[2]  # /v1/peer.GetPeerRateLimits -> op
        return self._guarded_call(
            op, lambda: self._post_inner(path, payload, timeout_s), check,
            wire_hits=wire_hits,
        )

    def _post_inner(self, path: str, payload: dict, timeout_s: Optional[float]) -> dict:
        body = self._http_roundtrip(
            path, json.dumps(payload).encode("utf-8"), timeout_s,
            "application/json",
        )
        return json.loads(body) if body else {}

    def _post_columns_inner(self, cols: "wire.PeerColumns",
                            timeout_s: Optional[float], trace=None):
        """Columnar GetPeerRateLimits over HTTP: the binary frame
        against the same /v1/peer.GetPeerRateLimits path (the receiver
        sniffs the magic).  An old peer answers 400 (its JSON parse
        fails) — remember and resend as classic per-request JSON inside
        the same guarded call.

        Trace trailer negotiation: the first SAMPLED frame to an
        untried peer probes with the trailer attached.  A columns-
        capable peer that predates it rejects the frame as a length
        mismatch (400, provably not applied) — remember trailer-free
        and resend the SAME frame without it, still inside this guarded
        call, so the probe is breaker- and health-neutral like the
        columns probe itself.  Unsampled traffic never probes: with
        GUBER_TRACE_SAMPLE=0 the wire is byte-identical to pre-trace."""
        if self._columnar is not False:
            with_trace = bool(trace) and self._trace_frames is not False
            frame = wire.encode_columns_frame(
                cols, trace=trace if with_trace else None
            )
            try:
                body = self._http_roundtrip(
                    "/v1/peer.GetPeerRateLimits", frame, timeout_s,
                    wire.COLUMNS_CONTENT_TYPE,
                )
            except PeerError as e:
                if (
                    with_trace
                    and e.http_status == 400
                    and "length mismatch" in str(e)
                ):
                    # Columns peer that predates the trace trailer: the
                    # decode rejected the frame before applying it, so
                    # the trailer-free resend cannot double-count.
                    self._trace_frames = False
                    self._clear_last_err(str(e))
                    return self._post_columns_inner(cols, timeout_s)
                # Downgrade when the frame was provably REJECTED, not
                # applied (safe to resend classic): a 4xx, or the old
                # gateway's 500 — pre-columns builds map the
                # UnicodeDecodeError json.loads raises on the frame's
                # binary columns to a 500 whose body names the codec
                # failure, so that exact shape is a version answer too.
                rejected = e.http_status in (400, 404, 415) or (
                    e.http_status == 500 and "codec can't decode" in str(e)
                )
                if rejected:
                    self._mark_classic()
                    # A benign version probe, not a peer failure: it
                    # must not leave HealthCheck unhealthy for 5 min.
                    self._clear_last_err(str(e))
                else:
                    raise
            else:
                if with_trace:
                    self._trace_frames = True
                if wire.is_columns_frame(body):
                    self._columnar = True
                    try:
                        return wire.decode_result_frame(body)
                    except ValueError as e:
                        msg = (
                            f"GetPeerRateLimits to peer "
                            f"{self.info.grpc_address} returned a "
                            f"malformed columns frame: {e}"
                        )
                        self._set_last_err(msg)
                        raise PeerError(msg) from e
                # 200 with a non-frame body: the peer ANSWERED (it may
                # well have applied the batch), so re-sending would
                # double-count every hit.  Fail this batch, and speak
                # classic from now on (whatever rewrote the response —
                # proxy, exotic build — clearly doesn't pass frames).
                self._mark_classic()
                msg = (
                    f"GetPeerRateLimits to peer {self.info.grpc_address} "
                    f"answered a columns frame with a non-frame 200 body"
                )
                self._set_last_err(msg)
                raise PeerError(msg)
        def _send_json_chunk(sub):
            body = self._http_roundtrip(
                "/v1/peer.GetPeerRateLimits",
                json.dumps(
                    wire.peer_columns_to_classic_json(sub)
                ).encode("utf-8"),
                timeout_s, "application/json",
            )
            return wire.result_from_classic_peer_json(
                json.loads(body) if body else {}
            )

        return self._classic_resend(cols, _send_json_chunk)

    def _http_roundtrip(self, path: str, data: bytes,
                        timeout_s: Optional[float], content_type: str) -> bytes:
        """One POST over the persistent peer connection; returns the
        raw response body.  Non-200 raises PeerError carrying the
        status (the columns negotiation reads it)."""
        timeout = timeout_s if timeout_s is not None else self.behaviors.batch_timeout_s
        host = self.info.http_address or self.info.grpc_address
        bb = self.blackbox
        if bb is not None:
            # Outbound tap BEFORE the send: a frame that times out or
            # double-delivers (FaultPlan DUPLICATE re-invokes this) is
            # exactly the evidence an incident bundle needs.
            bb.tap("out", host, data)
        with self._conn_lock:
            # not_ready marks a failure as provably-unapplied (safe to
            # retry/requeue).  That holds only until the request body
            # has been DELIVERED: a timeout while waiting for the
            # response may have executed server-side — the same reason
            # DEADLINE_EXCEEDED is excluded from _NOT_READY_CODES on
            # the gRPC transport — so post-send failures must not
            # present as retry-safe.  One exception: RemoteDisconnected
            # on a REUSED connection is the keep-alive expiry race (the
            # peer closed the idle socket before the request arrived —
            # the urllib3 retry rule), which stays retry-safe.
            fresh_conn = self._conn is None
            sent = False
            try:
                if self._conn is None:
                    hostname, _, port = host.partition(":")
                    if self.tls_context is not None:
                        self._conn = http.client.HTTPSConnection(
                            hostname, int(port or 443), timeout=timeout,
                            context=self.tls_context,
                        )
                    else:
                        self._conn = http.client.HTTPConnection(
                            hostname, int(port or 80), timeout=timeout
                        )
                self._conn.request(
                    "POST", path, body=data,
                    headers={"Content-Type": content_type},
                )
                sent = True
                r = self._conn.getresponse()
                body = r.read()
                if r.status != 200:
                    raise PeerError(
                        f"peer returned HTTP {r.status}: {body[:200]!r}",
                        http_status=r.status,
                    )
                if bb is not None:
                    bb.tap("in", host, body)
                return body
            except PeerError as e:
                self._set_last_err(str(e))
                self._reset_conn()
                raise
            except (OSError, http.client.HTTPException) as e:
                msg = f"connect to peer {host} failed: {e}"
                self._set_last_err(msg)
                self._reset_conn()
                retry_safe = not sent or (
                    not fresh_conn
                    and isinstance(e, http.client.RemoteDisconnected)
                )
                raise PeerError(msg, not_ready=retry_safe) from e

    def _reset_conn(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    # ------------------------------------------------------------------
    def _set_last_err(self, msg: str) -> None:
        """Error LRU with TTL (peer_client.go:206-220); messages include
        the peer address for HealthCheck reporting.  Bounded at
        LAST_ERR_MAX entries: a flood of distinct error messages evicts
        the oldest instead of growing without bound between
        get_last_err() calls (reference uses a fixed-size LRU)."""
        with self._err_lock:
            key = f"{msg} (peer: {self.info.grpc_address})"
            # Re-inserting moves the key to the end: recency order.
            self._last_err.pop(key, None)
            self._last_err[key] = time.monotonic() + self.LAST_ERR_TTL_S
            while len(self._last_err) > self.LAST_ERR_MAX:
                self._last_err.pop(next(iter(self._last_err)))

    def _clear_last_err(self, msg: str) -> None:
        with self._err_lock:
            self._last_err.pop(f"{msg} (peer: {self.info.grpc_address})", None)

    def get_last_err(self) -> List[str]:
        now = time.monotonic()
        with self._err_lock:
            self._last_err = {m: t for m, t in self._last_err.items() if t > now}
            return list(self._last_err.keys())

    # ------------------------------------------------------------------
    def shutdown(self, timeout_s: float = 5.0) -> None:
        """Drain in-flight batches, then close (peer_client.go:351-385)."""
        self._shutdown.set()
        self._window.stop(timeout_s=timeout_s)
        with self._conn_lock:
            self._reset_conn()
            if self._channel is not None:
                self._channel.close()
                self._channel = None
