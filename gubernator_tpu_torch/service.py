"""V1Service — the service core (reference V1Instance, gubernator.go),
on the port's columnar path.

The port of the JAX package's service.py.  Each lane of a GetRateLimits
batch is routed by the consistent-hash ring (set_peers):

* Keys this node owns evaluate through the JAX service's coalescing
  windows: a `ColumnarBatcher` merges concurrent column submissions
  inside one BatchWait window into one store launch (each caller reads
  its slice of the shared handle), a `LocalBatcher` does the same for
  single GLOBAL lanes on the dataclass path, NO_BATCHING lanes dispatch
  at once, and under the express lane (GUBER_EXPRESS) small submissions
  to a shallow queue skip the window.  The ingress gate bounds the
  lanes queued in both windows (GUBER_INGRESS_QUEUE_LANES) and sheds
  past it.
* Keys another node owns are forwarded to it through the batching
  PeerClient (peer_client.py), one columnar sub-batch per owner riding
  that peer's window; an owner whose circuit breaker is open degrades
  the lanes to local evaluation (`_degrade_local`, stamped
  `degraded`), a not-ready owner is re-picked with jittered backoff.
* GLOBAL lanes take the store's dataclass path (`apply`): the owner's
  lanes evaluate, another owner's answer from the replica columns.  A
  GlobalManager syncs them on an interval, broadcasts the owners'
  answers to every peer and forwards the summed hits of remote-owner
  keys to their owners.
* A membership change bumps the ring generation and fingerprint (the
  transfer epoch fence), opens the double-dispatch window (a read of a
  moved key also peeks its old owner with zero hits and merges
  monotonically) and schedules the handoff: the old owner drains the
  moved keys' rows (K7) and transfers them to their new owners, which
  merge-commit them (K8; reshard.py).

`get_rate_limits_columns_async` submits on the caller's thread and
calls back from a drainer thread once every launch's readback and every
forward is in.  The store is a MeshBucketStore built from the sizes, or
the one given as `ServiceConfig.store` (a ShardStore for a one-shard
deployment, which answers GLOBAL lanes as local ones and has no GLOBAL
sync; the service then runs no GlobalManager).  With a Store SPI
(`persist_store`) every lane takes the dataclass path, as the store's
callbacks need.  Persistence: a Loader (`loader`) is loaded at boot and
saved at close; a snapshot file (`snapshot_path`) is restored at boot
and written at close and every `behaviors.snapshot_interval_s`
(snapshot.py).  The owner side of the peer API is here too:
`get_peer_rate_limits[_columns][_async]`, `update_peer_globals[_columns]`
(one batched replica commit) and `transfer_ownership` (the epoch fence,
the lanes this node owns, then one merge-commit).  The gateway
(gateway.py) reads the members built here: the flight recorder, the SLO
engine, the hot-key sketch, the tenant ledger, the conservation auditor
and the native ingress pump's hook.  `metrics` is the config's
`Metrics` or a new one (metrics.py), never None.

MULTI_REGION lanes queue their hits toward the other regions
(`multi_region_mgr`, federation.py) and `update_region_columns` applies
another region's batch through the columnar peer receive.  The
incident black box (blackbox.py) taps every peer client's frames and
writes bundles on the flight recorder's dump triggers.  A
service never given a ring owns every key, where a JAX service answers
"unable to pick a peer; pool is empty"; once `set_peers` has run, an
empty ring answers that as JAX's does (the replay's service, fed
`set_peers([])`, gives JAX's bytes).  Responses are the JAX
V1Service's (tests/test_torch_service.py, tests/test_torch_batchers.py,
tests/test_torch_gateway.py, tests/test_torch_cluster.py).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from functools import partial
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence

import numpy as np

from . import audit as audit_mod
from . import blackbox as blackbox_mod
from . import profiling
from . import saturation
from . import snapshot as snapshot_mod
from . import telemetry
from . import tracing
from . import wire
from .config import MAX_BATCH_SIZE, PEER_COLUMNS_MAX_LANES, BehaviorConfig
from .faults import Backoff
from .federation import FederationManager
from .models.shard import GregResolver
from .parallel.global_mgr import GlobalsColumns, HitColumns
from .parallel.hash_ring import ReplicatedConsistentHash
from .parallel.mesh import MeshBucketStore
from .parallel.region import RegionPicker
from .peer_client import PeerClient, PeerError, is_circuit_open, is_not_ready
from .reshard import ReshardManager, TransferColumns
from .types import (
    Behavior,
    GetRateLimitsRequest,
    GetRateLimitsResponse,
    HealthCheckResponse,
    PeerInfo,
    RateLimitRequest,
    RateLimitResponse,
    UpdatePeerGlobal,
    has_behavior,
)
from .utils import gregorian
from .utils.batch_window import BatchWindow
from .utils.clock import DEFAULT_CLOCK, Clock
from .utils.interval import Interval
from .utils.logging import category_logger

HEALTHY = "healthy"
UNHEALTHY = "unhealthy"
N_SHARDS = 8  # the JAX service's shard count on an 8-device mesh
ERR_BATCHER_CLOSED = "local batcher is closed"
ERR_EMPTY_KEY = "field 'unique_key' cannot be empty"
ERR_EMPTY_NAME = "field 'namespace' cannot be empty"

if TYPE_CHECKING:  # metrics.py imports prometheus_client: only a service needs it
    from .metrics import Metrics

logger = category_logger("gubernator")


class ApiError(Exception):
    """Request-level error (maps to a gRPC status / HTTP error)."""

    def __init__(self, code: str, message: str, http_status: int = 400):
        super().__init__(message)
        self.code = code
        self.message = message
        self.http_status = http_status


class IngressShedError(ApiError):
    """The bounded ingress queue is full and this submission was SHED
    (429 semantics).  An error, not an OVER_LIMIT status: OVER_LIMIT
    answers about the client's rate limit; this is the node declining
    to queue more work than it can serve inside any useful deadline.
    Callers retry with backoff, as after a 429."""

    def __init__(self, queued_lanes: int, cap: int):
        super().__init__(
            "ResourceExhausted",
            f"ingress queue saturated ({queued_lanes} lanes queued, "
            f"cap {cap}); retry with backoff",
            http_status=429,
        )


class _IngressGate:
    """Lane accounting for the bounded ingress queue
    (GUBER_INGRESS_QUEUE_LANES): admit at submit, release at flush.
    cap <= 0 disables the bound.  `track` keeps the counting on with
    the bound off: the express bypass reads `queued` as its
    shallow-queue signal."""

    def __init__(self, cap: int, metrics: Optional[Metrics], track: bool = False):
        self.cap = cap
        self.track = track
        self.metrics = metrics
        self._queued = 0
        self._mu = threading.Lock()

    @property
    def queued(self) -> int:
        return self._queued

    def admit(self, lanes: int) -> None:
        """Reserve `lanes` or raise IngressShedError (counted)."""
        if self.cap <= 0 and not self.track:
            return
        with self._mu:
            if self.cap > 0 and self._queued + lanes > self.cap:
                queued = self._queued
                shed = True
            else:
                self._queued += lanes
                shed = False
                queued = self._queued
        # Post-admit depth (a shed samples the at-capacity depth).
        saturation.observe_queue_depth(queued)
        if shed:
            if self.metrics is not None:
                self.metrics.ingress_shed.inc(lanes)
            tracing.record_event("shed", lanes=lanes, queued=queued, cap=self.cap)
            raise IngressShedError(queued, self.cap)

    def release(self, lanes: int) -> None:
        if self.cap <= 0 and not self.track:
            return
        with self._mu:
            self._queued = max(self._queued - lanes, 0)


@dataclass
class ServiceConfig:
    """Library-user config (reference Config, config.go:66-104)."""

    # Any store of the port (a MeshBucketStore, a ShardStore for a
    # one-shard deployment); built from the sizes when None.
    store: object = None
    cache_size: int = 50_000  # total slots, split evenly over 8 shards
    # Two-tier table: > 0 adds a device-resident back tier of this many
    # extra slots (total capacity = cache_size + back_cache_size; the
    # small front takes every kernel lane, see MeshBucketStore).
    back_cache_size: int = 0
    # GLOBAL key table (gslots); None = the cache size clamped to
    # [4096, 65536] (GLOBAL keys share the reference's cache).
    global_cache_size: Optional[int] = None
    # Windows, ingress bound, express lane, GLOBAL sync interval
    # (None = sized from the measured sync cost), snapshot interval.
    behaviors: BehaviorConfig = field(default_factory=BehaviorConfig)
    clock: Clock = field(default_factory=lambda: DEFAULT_CLOCK)
    # Device of the store built from the sizes: None = the current CUDA
    # device (raises without one); "cpu" runs the plain versions.
    device: object = None
    persist_store: object = None  # Store SPI (store.py)
    loader: object = None  # Loader SPI (store.py)
    # Durability plane (snapshot.py): the snapshot file ("" = disabled,
    # every restart a full reset), restored at boot with one
    # merge-commit and written on close() and every
    # behaviors.snapshot_interval_s seconds (0 = on close() only).
    snapshot_path: str = ""
    # This node's address (its id in the ring) and data center.
    advertise_address: str = ""
    data_center: str = ""
    # Prometheus families (metrics.py); None = a new Metrics of its own.
    metrics: Optional[Metrics] = None
    # ssl.SSLContext of the PeerClients' HTTP transport (mTLS peer data
    # plane, daemon.go:102-106 -> peer_client.go:87-132).
    peer_tls_context: object = None
    # grpc.ChannelCredentials of the gRPC peer transport (None: an
    # insecure channel, or with peer_tls_context set the HTTP transport,
    # the only one that can skip verification).
    peer_channel_credentials: object = None
    # A faults.FaultPlan handed to every PeerClient this service creates
    # (None: the clients honor the process-wide faults.install() plan).
    fault_plan: object = None
    # Incident black box (blackbox.py): directory incident bundles are
    # written to ("" = rings still run, no bundles).  Env:
    # GUBER_BLACKBOX_DIR.
    blackbox_dir: str = ""


class _ExpressPolicy:
    """The express-lane bypass rule, shared by both batchers: a
    submission of n lanes skips the coalescing window when the lane is
    enabled (GUBER_EXPRESS), n <= GUBER_EXPRESS_MAX_LANES, fewer than
    GUBER_EXPRESS_QUEUE_DEPTH lanes are queued at its batcher, and at
    most MAX_DEPTH batches are unresolved in the store's pipeline
    (commits are FIFO, so a bypass behind a deep pipeline would wait out
    every older readback anyway).  The bypass changes when a batch
    launches, never what it computes.  Sampled requests keep the window,
    whose flush records their batch.window span."""

    MAX_DEPTH = 2

    __slots__ = ("enabled", "queue_depth", "max_lanes")

    def __init__(self, behaviors: BehaviorConfig):
        self.enabled = bool(behaviors.express)
        self.queue_depth = int(behaviors.express_queue_depth)
        self.max_lanes = int(behaviors.express_max_lanes)

    def window_cap_s(self, behaviors: BehaviorConfig) -> Optional[float]:
        """Latency mode's ceiling on the window: half the
        GUBER_LATENCY_TARGET_MS budget (the other half pays for the
        launch and readback).  None when the lane or the target is off."""
        target_ms = float(behaviors.latency_target_ms or 0.0)
        if not self.enabled or target_ms <= 0:
            return None
        return target_ms / 2000.0

    def bypass_ok(self, n: int, gate: _IngressGate, store) -> bool:
        if not self.enabled or n > self.max_lanes:
            return False
        if gate.queued + n > self.queue_depth:
            return False
        return store.pipeline_depth() <= self.MAX_DEPTH


class LocalBatcher:
    """Ingress window for single-lane requests on the dataclass path
    (GLOBAL lanes, Store SPI deployments): concurrent submissions inside
    one BatchWait window (config.go:107-109) coalesce into ONE
    `store.apply`.  Under the express lane a shallow queue's submission
    evaluates at once on the caller's thread."""

    def __init__(self, store, behaviors: BehaviorConfig, clock: Clock,
                 metrics: Optional[Metrics] = None):
        self.store = store
        self.clock = clock
        self._express = _ExpressPolicy(behaviors)
        self._gate = _IngressGate(behaviors.ingress_queue_lanes, metrics,
                                  track=self._express.enabled)
        self._window = BatchWindow(
            self._flush, behaviors.batch_wait_s, behaviors.batch_limit,
            cap_s=self._express.window_cap_s(behaviors),
        )

    def submit(self, req: RateLimitRequest) -> Future:
        fut: Future = Future()
        if self._window.stopped:
            fut.set_exception(PeerError(ERR_BATCHER_CLOSED))
            return fut
        if tracing.current() is None and self._express.bypass_ok(1, self._gate, self.store):
            return self._submit_express(req, fut)
        try:
            self._gate.admit(1)
        except IngressShedError as e:
            fut.set_exception(e)
            return fut
        # The flush measures the window wait from this instant.
        fut._submit_t = time.monotonic()
        # A submit racing past the stopped check is still flushed:
        # stop() drains the queue after joining the worker.
        self._window.submit((req, fut))
        return fut

    def _submit_express(self, req: RateLimitRequest, fut: Future) -> Future:
        """The store.apply a one-element flush would run, on the
        caller's thread, minus the window."""
        try:
            self._gate.admit(1)
        except IngressShedError as e:
            fut.set_exception(e)
            return fut
        t0 = time.monotonic()
        try:
            resp = self.store.apply([req], self.clock.now_ms())[0]
            if not fut.done():
                fut.set_result(resp)
        except Exception as e:  # noqa: BLE001 — the caller's future carries it
            if not fut.done():
                fut.set_exception(e)
        finally:
            self._gate.release(1)
        saturation.note_express("bypass", 1)
        saturation.observe_phase("express.submit", time.monotonic() - t0)
        return fut

    def _flush(self, batch) -> None:
        self._gate.release(len(batch))
        saturation.note_express("windowed", len(batch))
        t_flush = time.monotonic()
        for _, fut in batch:
            st = getattr(fut, "_submit_t", None)
            if st is not None:
                saturation.observe_phase("batch.window", t_flush - st)
                # Queue-residency pool (profiling.py): one lane waited
                # this long; tenants take proportional shares.
                profiling.note_queue_wait(1, t_flush - st)
        try:
            resps = self.store.apply([r for r, _ in batch], self.clock.now_ms())
            for (_, fut), resp in zip(batch, resps):
                if not fut.done():
                    fut.set_result(resp)
        except Exception as e:  # noqa: BLE001 — every waiter gets the error
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)

    def stop(self) -> None:
        self._window.stop()


@dataclass
class IngressColumns:
    """A GetRateLimits batch as parallel columns (the zero-dataclass
    ingress representation)."""

    names: List[str]
    unique_keys: List[str]
    algorithm: np.ndarray  # i32[n]
    behavior: np.ndarray  # i32[n]
    hits: np.ndarray  # i64[n]
    limit: np.ndarray  # i64[n]
    duration: np.ndarray  # i64[n]
    # Wire trace-context column of a peer batch (tracing.py):
    # (lane_lo, lane_hi, trace_id, span_id) ranges, or None.
    trace_ctx: Optional[list] = None

    def __len__(self) -> int:
        return len(self.names)

    def request_at(self, i: int) -> RateLimitRequest:
        return RateLimitRequest(
            name=self.names[i],
            unique_key=self.unique_keys[i],
            hits=int(self.hits[i]),
            limit=int(self.limit[i]),
            duration=int(self.duration[i]),
            algorithm=int(self.algorithm[i]),
            behavior=int(self.behavior[i]),
        )


@dataclass
class ColumnarResult:
    """Column-form GetRateLimits responses: arrays for the evaluated
    lanes plus sparse per-lane overrides (validation and other errors,
    GLOBAL lanes).  A forwarded lane's owner rides `owner_of` (an index
    per lane into `owner_addrs`, -1 = local); a one-node service never
    sets it, but the wire's kind-6 frame carries the columns."""

    n: int
    status: np.ndarray
    limit: np.ndarray
    remaining: np.ndarray
    reset_time: np.ndarray
    overrides: Dict[int, RateLimitResponse] = field(default_factory=dict)
    owner_addrs: List[str] = field(default_factory=list)
    owner_of: Optional[np.ndarray] = None  # i32[n], -1 = local lane

    @classmethod
    def empty(cls, n: int) -> "ColumnarResult":
        z = np.zeros(n, dtype=np.int64)
        return cls(
            n=n, status=np.zeros(n, dtype=np.int32), limit=z,
            remaining=z.copy(), reset_time=z.copy(),
        )

    def set_owner(self, lanes, addr: str) -> None:
        """Annotate `lanes` (index array) as forwarded to `addr`."""
        if self.owner_of is None:
            self.owner_of = np.full(self.n, -1, dtype=np.int32)
        try:
            k = self.owner_addrs.index(addr)
        except ValueError:
            self.owner_addrs.append(addr)
            k = len(self.owner_addrs) - 1
        self.owner_of[lanes] = k

    def owner_at(self, i: int) -> Optional[str]:
        if self.owner_of is None or self.owner_of[i] < 0:
            return None
        return self.owner_addrs[self.owner_of[i]]

    def response_at(self, i: int) -> RateLimitResponse:
        ov = self.overrides.get(i)
        if ov is not None:
            return ov
        owner = self.owner_at(i)
        return RateLimitResponse(
            status=int(self.status[i]),
            limit=int(self.limit[i]),
            remaining=int(self.remaining[i]),
            reset_time=int(self.reset_time[i]),
            metadata={"owner": owner} if owner is not None else {},
        )

    def to_response(self) -> GetRateLimitsResponse:
        return GetRateLimitsResponse(
            responses=[self.response_at(i) for i in range(self.n)]
        )


@dataclass
class _ColumnsPlan:
    """What `_submit_columns` left in flight, consumed by the blocking
    `_finalize_columns` or by the callback-driven `_ColumnsJoin`."""

    pendings: list  # [(batcher Future | (handle, lo, hi), fast lane idx)]
    slow_idx: list  # GLOBAL lanes, for the dataclass router
    slow_fn: Optional[Callable[[], list]]  # their blocking resolver
    hash_keys: object  # List[str] or native.PackedKeys
    # Forwarded lanes: owner addr -> forward future, owner addr -> [lane].
    group_futs: Dict[str, Future] = field(default_factory=dict)
    remote_groups: Dict[str, list] = field(default_factory=dict)
    # Handoff double-dispatch peeks, one grouped zero-hit read per
    # previous owner of moved lanes, merged monotonically after the
    # primary legs: ("remote", forward future, lanes) or ("local",
    # (handle, lo, hi), lanes); best-effort.
    peeks: list = field(default_factory=list)
    # Tenant-ledger fold context (profiling.py): computed once at
    # admission, reused by the shed and outcome folds.
    tenant_ctx: object = None


def _lane_response(out: dict, lo: int) -> RateLimitResponse:
    """One lane of a resolved columnar launch as a dataclass response."""
    return RateLimitResponse(
        status=int(out["status"][lo]),
        limit=int(out["limit"][lo]),
        remaining=int(out["remaining"][lo]),
        reset_time=int(out["reset_time"][lo]),
    )


class _SingleLaneWait:
    """One single-lane BATCHING request riding the columnar coalescer:
    .result() resolves the SHARED handle (concurrent waiters overlap
    their readbacks) and builds this lane's response."""

    __slots__ = ("_fut",)

    def __init__(self, fut: Future):
        self._fut = fut

    def result(self) -> RateLimitResponse:
        handle, lo, _hi = self._fut.result()
        return _lane_response(handle.result(), lo)


def _attach_done(fut: Future, fn) -> None:
    """add_done_callback that cannot re-raise into the attacher: on an
    already-resolved future the callback runs inline, and an exception
    from it can only come from the consumer's delivery (already
    attempted), so re-raising would deliver twice."""
    try:
        fut.add_done_callback(fn)
    except Exception:  # noqa: BLE001 — logged; delivery was attempted
        logger.exception("async delivery callback failed")


def _deliver_future(callback, fut) -> None:
    """Bridge a Future to callback(result, exc), calling it once."""
    try:
        value, exc = fut.result(), None
    except Exception as e:  # noqa: BLE001 — handed to the callback
        value, exc = None, e
    callback(value, exc)


def _cols_to_requests(sub) -> List[RateLimitRequest]:
    """Materialize a forwarded column sub-batch as dataclasses — the
    FAILURE legs only (degraded local eval, per-item re-pick): the fast
    path never calls this."""
    names, uks, algo, beh, hits, limit, duration = sub
    return [
        RateLimitRequest(
            name=names[i],
            unique_key=uks[i],
            hits=int(hits[i]),
            limit=int(limit[i]),
            duration=int(duration[i]),
            algorithm=int(algo[i]),
            behavior=int(beh[i]),
        )
        for i in range(len(names))
    ]


def _merge_group_result(result, idxs, addr, resps) -> None:
    """Merge one owner-group forward outcome into `result` — the
    shared body of the blocking _finalize_columns and the async
    _ColumnsJoin.  ("cols", rc, lo, hi) scatters the decoded response
    arrays (zero-dataclass); a list is the fallback legs' per-lane
    dataclasses; an Exception converts per lane."""
    if isinstance(resps, Exception):
        for i in idxs:
            result.overrides[int(i)] = RateLimitResponse(
                error=f"while fetching rate limit from peer - '{resps}'"
            )
        return
    if isinstance(resps, tuple):
        _tag, rc, lo, hi = resps
        idx = np.asarray(idxs, dtype=np.int64)
        sl = slice(lo, hi)
        result.status[idx] = rc.status[sl]
        result.limit[idx] = rc.limit[sl]
        result.remaining[idx] = rc.remaining[sl]
        result.reset_time[idx] = rc.reset_time[sl]
        result.set_owner(idx, addr)
        for lane, r in rc.overrides.items():
            if lo <= lane < hi:
                r.metadata.setdefault("owner", addr)
                result.overrides[int(idxs[lane - lo])] = r
        return
    for i, r in zip(idxs, resps):
        result.overrides[int(i)] = r


def _merge_peek_result(result, lanes, payload) -> None:
    """Monotone-merge one resolved zero-hit peek group (the handoff
    double-dispatch, architecture.md "Membership & resharding") into
    the result arrays: status = max (OVER_LIMIT wins), remaining = min,
    reset_time = max — never more permissive than either side, so bulk
    columnar reads cannot observe a reset bucket mid-transfer.  Lanes
    that resolved as overrides (errors, fallback legs) and peek lanes
    that themselves errored are left untouched; payload None (a failed
    peek — the old owner dying is exactly when this runs) leaves every
    primary answer standing."""
    if payload is None:
        return
    kind, data = payload
    m = len(lanes)
    keep = np.fromiter(
        (int(i) not in result.overrides for i in lanes), bool, count=m
    )
    if kind == "remote":
        rc, lo, hi = data
        if rc.overrides:
            keep &= np.fromiter(
                ((lo + j) not in rc.overrides for j in range(m)),
                bool, count=m,
            )
        st = np.asarray(rc.status[lo:hi])
        rem = np.asarray(rc.remaining[lo:hi])
        rst = np.asarray(rc.reset_time[lo:hi])
        lim = np.asarray(rc.limit[lo:hi])
    else:
        out, sl = data
        st = np.asarray(out["status"][sl])
        rem = np.asarray(out["remaining"][sl])
        rst = np.asarray(out["reset_time"][sl])
        lim = np.asarray(out["limit"][sl])
    # Consumption evidence only: a REMOTE peek cannot be residency-
    # filtered at the sender, so a key already forgotten at the old
    # owner answers as a fresh bucket (remaining == limit, UNDER) —
    # merging that would only inflate reset_time.  An untouched
    # genuine bucket is skipped identically (nothing to carry).
    keep &= (rem < lim) | (st > 0)
    if not keep.any():
        return
    idx = np.asarray(lanes, dtype=np.int64)[keep]
    result.status[idx] = np.maximum(result.status[idx], st[keep])
    result.remaining[idx] = np.minimum(result.remaining[idx], rem[keep])
    result.reset_time[idx] = np.maximum(result.reset_time[idx], rst[keep])


def _merge_fast_result(result, hash_keys, fast_idx, out, sl, exc) -> None:
    """Scatter one resolved launch into `result`, or turn a failure into
    per-lane errors (shared by _resolve_fast and _ColumnsJoin)."""
    if exc is not None:
        for i in fast_idx:
            result.overrides[int(i)] = RateLimitResponse(
                error=f"while applying rate limit '{hash_keys[int(i)]}' - '{exc}'"
            )
        return
    if fast_idx.size == result.n:
        result.status = np.asarray(out["status"][sl], dtype=np.int32)
        result.limit = np.asarray(out["limit"][sl], dtype=np.int64)
        result.remaining = np.asarray(out["remaining"][sl], dtype=np.int64)
        result.reset_time = np.asarray(out["reset_time"][sl], dtype=np.int64)
    else:
        result.status[fast_idx] = out["status"][sl]
        result.limit[fast_idx] = out["limit"][sl]
        result.remaining[fast_idx] = out["remaining"][sl]
        result.reset_time[fast_idx] = out["reset_time"][sl]


class _HandleDrainer:
    """Resolves columnar handles off the request thread: a pool blocks
    on handle.result() (the readback) and fires callbacks.  One parked
    thread per unresolved launch, not per request: a register() that
    finds no idle worker spawns one, up to MAX_THREADS."""

    MIN_THREADS = 2
    MAX_THREADS = 32

    def __init__(self):
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._stopped = False
        self._threads: list = []
        self._idle = 0

    def start(self) -> None:
        with self._cv:
            for _ in range(self.MIN_THREADS):
                self._spawn()

    def _spawn(self) -> None:
        # _cv held.
        t = threading.Thread(target=self._run, daemon=True,
                             name=f"columns-drain-{len(self._threads)}")
        t.start()
        self._threads.append(t)

    def register(self, handle, cb) -> None:
        """cb(value, exc) fires exactly once from a drainer thread (or
        inline with the closed-batcher error after stop)."""
        with self._cv:
            if not self._stopped:
                self._q.append((handle, cb))
                if len(self._q) > self._idle and len(self._threads) < self.MAX_THREADS:
                    self._spawn()
                self._cv.notify()
                return
        cb(None, PeerError(ERR_BATCHER_CLOSED))

    def _run(self) -> None:
        while True:
            with self._cv:
                self._idle += 1
                while not self._q and not self._stopped:
                    self._cv.wait()
                self._idle -= 1
                if not self._q:
                    return  # stopped and drained
                handle, cb = self._q.popleft()
            value, exc = None, None
            try:
                value = handle.result()
            except Exception as e:  # noqa: BLE001 — handed to the callback
                exc = e
            try:
                cb(value, exc)
            except Exception:  # noqa: BLE001 — a callback must not kill the pool
                logger.exception("columns drainer callback failed")

    def stop(self, timeout_s: float = 30.0) -> None:
        """Resolve everything registered (workers drain the queue before
        exiting), then join."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
            threads = list(self._threads)
        deadline = time.monotonic() + timeout_s
        for t in threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.1))


class _ColumnsJoin:
    """Completion join for one async columnar request: counts down the
    plan's sub-completions (fast dispatch handles via the drainer,
    owner-group forwards, the slow-lane route) and fires the callback
    exactly once from whichever completion thread finishes last.  The
    merge logic is the same _merge_fast_result / override-merge the
    blocking _finalize_columns uses."""

    def __init__(self, svc, plan, result, callback):
        self.svc = svc
        self.plan = plan
        self.result = result
        self.callback = callback
        self._lock = threading.Lock()
        self._remaining = 0
        self._failure: "Optional[Exception]" = None
        self._fast_outs: list = []  # (fast_idx, out, slice, exc)
        self._group_res: dict = {}  # addr -> resps | Exception
        self._slow_resps: "Optional[list]" = None
        self._peek_res: list = []  # (lanes, payload | None)

    def start(self) -> None:
        svc, plan = self.svc, self.plan
        parts = (
            len(plan.pendings)
            + len(plan.group_futs)
            + (1 if plan.slow_idx else 0)
            + len(plan.peeks)
        )
        if parts == 0:
            self._finish()
            return
        self._remaining = parts
        drainer = svc._get_drainer()
        if plan.slow_idx:
            # slow_fn runs _route / store.apply, which block on (and for
            # _route, submit to) _forward_pool — the slow pool keeps the
            # outer task off the pool its inner tasks need.
            _attach_done(
                svc._slow_pool.submit(plan.slow_fn), self._on_slow
            )
        for addr, fut in plan.group_futs.items():
            _attach_done(fut, partial(self._on_group, addr))
        for pending, fast_idx in plan.pendings:
            if isinstance(pending, Future):
                _attach_done(
                    pending, partial(self._on_dispatched, fast_idx, drainer)
                )
            else:
                handle, lo, hi = pending
                drainer.register(
                    handle, partial(self._on_out, fast_idx, slice(lo, hi))
                )
        for kind, payload, lanes in plan.peeks:
            # Handoff peeks: window flushes resolve every forward
            # future (result or exception) and the drainer resolves
            # every handle, so the countdown can never hang on one.
            if kind == "remote":
                _attach_done(payload, partial(self._on_peek_remote, lanes))
            else:
                handle, lo, hi = payload
                drainer.register(
                    handle,
                    partial(self._on_peek_local, lanes, slice(lo, hi)),
                )

    # -- sub-completion handlers (any thread) --------------------------
    def _on_dispatched(self, fast_idx, drainer, fut) -> None:
        try:
            handle, lo, hi = fut.result()
        except Exception as e:  # noqa: BLE001
            self._on_out(fast_idx, None, None, e)
            return
        drainer.register(handle, partial(self._on_out, fast_idx, slice(lo, hi)))

    def _on_out(self, fast_idx, sl, out, exc) -> None:
        with self._lock:
            self._fast_outs.append((fast_idx, out, sl, exc))
        self._countdown()

    def _on_group(self, addr, fut) -> None:
        try:
            resps = fut.result()
        except Exception as e:  # noqa: BLE001 — _forward_group_columns
            resps = e  # converts internally; this is pool-failure defensive
        with self._lock:
            self._group_res[addr] = resps
        self._countdown()

    def _on_slow(self, fut) -> None:
        try:
            self._slow_resps = fut.result()
        except Exception as e:  # noqa: BLE001
            # The sync path propagates a slow-route failure to the
            # caller (a 500 at the edge); same contract here.
            with self._lock:
                self._failure = e
        self._countdown()

    def _on_peek_remote(self, lanes, fut) -> None:
        try:
            rc, lo, hi = fut.result()
            payload = ("remote", (rc, lo, hi))
        except Exception:  # noqa: BLE001 — peek is best-effort
            payload = None
        with self._lock:
            self._peek_res.append((lanes, payload))
        self._countdown()

    def _on_peek_local(self, lanes, sl, out, exc) -> None:
        payload = None if exc is not None else ("local", (out, sl))
        with self._lock:
            self._peek_res.append((lanes, payload))
        self._countdown()

    def _countdown(self) -> None:
        with self._lock:
            self._remaining -= 1
            if self._remaining > 0:
                return
        self._finish()

    def _finish(self) -> None:
        result, err = self.result, self._failure
        if err is None:
            try:
                plan = self.plan
                if self._slow_resps is not None:
                    for i, r in zip(plan.slow_idx, self._slow_resps):
                        result.overrides[int(i)] = r
                for addr, resps in self._group_res.items():
                    _merge_group_result(
                        result, plan.remote_groups[addr], addr, resps
                    )
                for fast_idx, out, sl, exc in self._fast_outs:
                    if isinstance(exc, IngressShedError):
                        # Tenant shed attribution, async twin of
                        # _resolve_fast's.
                        self.svc.tenants.fold_shed(plan.tenant_ctx, fast_idx)
                    _merge_fast_result(
                        result, plan.hash_keys, fast_idx, out, sl, exc
                    )
                for lanes, payload in self._peek_res:
                    _merge_peek_result(result, lanes, payload)
                self.svc.tenants.fold_outcome(plan.tenant_ctx, result)
            except Exception as e:  # noqa: BLE001
                result, err = None, e
        self.callback(result if err is None else None, err)


class ColumnarBatcher:
    """Ingress coalescer for column-form submissions: concurrent
    requests inside one BatchWait window (config.go:107-109) merge into
    ONE store launch; each caller gets a slice of the shared handle.
    The flush thread only launches; waiters resolve the handle
    themselves, so readbacks overlap across callers (ColumnarPipeline).
    NO_BATCHING lanes never come here."""

    # Lane budget of one flush (one launch at most this wide).
    MAX_LANES = 64_000
    # Overload backstop, not a pacing gate: the flush worker blocks only
    # when this many of its own launches are unresolved.
    MAX_INFLIGHT = 8

    def __init__(self, store, behaviors: BehaviorConfig, clock: Clock,
                 metrics: Optional[Metrics] = None):
        self.store = store
        self.clock = clock
        self._express = _ExpressPolicy(behaviors)
        self._gate = _IngressGate(behaviors.ingress_queue_lanes, metrics,
                                  track=self._express.enabled)
        self._own_inflight: deque = deque()
        # _flush can run on two threads at once (a worker stuck past
        # stop()'s join timeout while stop drains): guard the backstop.
        self._inflight_lock = threading.Lock()
        self._window = BatchWindow(
            self._flush, behaviors.batch_wait_s, self.MAX_LANES,
            weigh=lambda item: len(item[0][0]),
            cap_s=self._express.window_cap_s(behaviors),
        )

    def submit(self, keys, algo, behavior, hits, limit, duration,
               greg_expire, greg_duration, trace_links=None) -> Future:
        fut: Future = Future()
        if self._window.stopped:
            fut.set_exception(PeerError(ERR_BATCHER_CLOSED))
            return fut
        n = len(keys)
        if not trace_links and self._express.bypass_ok(n, self._gate, self.store):
            return self._submit_express(keys, algo, behavior, hits, limit, duration,
                                        greg_expire, greg_duration, fut)
        try:
            self._gate.admit(n)
        except IngressShedError as e:
            fut.set_exception(e)
            return fut
        fut._submit_t = time.monotonic()
        if trace_links:
            # The flush joins every submission's links into the
            # batch.window span and the stage spans.
            fut._trace_links = trace_links
            fut._trace_t = time.monotonic_ns()
        ge = np.zeros(n, np.int64) if greg_expire is None else greg_expire
        gd = np.zeros(n, np.int64) if greg_duration is None else greg_duration
        self._window.submit(((keys, algo, behavior, hits, limit, duration, ge, gd), fut))
        return fut

    def _submit_express(self, keys, algo, behavior, hits, limit, duration,
                        greg_expire, greg_duration, fut: Future) -> Future:
        """Launch now on the caller's thread (no window): the store call a
        one-submission flush would make.  On a CPU store a small batch
        may take the host scalar slot; on the card it launches K1."""
        n = len(keys)
        try:
            self._gate.admit(n)
        except IngressShedError as e:
            fut.set_exception(e)
            return fut
        t0 = time.monotonic()
        try:
            ge = np.zeros(n, np.int64) if greg_expire is None else greg_expire
            gd = np.zeros(n, np.int64) if greg_duration is None else greg_duration
            handle = self.store.apply_columns_async(
                keys, algo, behavior, hits, limit, duration, self.clock.now_ms(), ge, gd)
            if not fut.done():
                fut.set_result((handle, 0, n))
        except Exception as e:  # noqa: BLE001 — the caller's future carries it
            if not fut.done():
                fut.set_exception(e)
        finally:
            self._gate.release(n)
        saturation.note_express("bypass", n)
        saturation.observe_phase("express.submit", time.monotonic() - t0)
        return fut

    def _flush(self, batch) -> None:
        lanes = sum(len(item[0][0]) for item in batch)
        self._gate.release(lanes)
        saturation.note_express("windowed", lanes)
        t_flush = time.monotonic()
        for item, fut in batch:
            st = getattr(fut, "_submit_t", None)
            if st is not None:
                saturation.observe_phase("batch.window", t_flush - st)
                # Queue-residency pool: this submission's lanes waited
                # out the window; tenants take proportional shares.
                profiling.note_queue_wait(len(item[0]), t_flush - st)
        # The window admits the submission that crosses the lane limit,
        # so one flush can overshoot MAX_LANES by a submission: re-chunk.
        chunk, lanes = [], 0
        for item in batch:
            n = len(item[0][0])
            if chunk and lanes + n > self.MAX_LANES:
                self._flush_chunk(chunk)
                chunk, lanes = [], 0
            chunk.append(item)
            lanes += n
        if chunk:
            self._flush_chunk(chunk)
        saturation.dispatcher_busy.add(time.monotonic() - t_flush)

    def _flush_chunk(self, batch) -> None:
        t_chunk = time.monotonic()
        try:
            # Backstop: wait on the oldest unresolved launch only when
            # the pipeline is pathologically deep.
            oldest = None
            with self._inflight_lock:
                while self._own_inflight and self._own_inflight[0].done:
                    self._own_inflight.popleft()
                if len(self._own_inflight) >= self.MAX_INFLIGHT:
                    oldest = self._own_inflight.popleft()
            if oldest is not None:
                oldest.result()
            if len(batch) == 1:
                (cols, _fut), = batch
                keys, arrays = cols[0], cols[1:]
            else:
                from .native import PackedKeys

                if all(isinstance(c[0], PackedKeys) for c, _ in batch):
                    # Packed keys coalesce without per-lane strings.
                    keys = PackedKeys.concat([c[0] for c, _ in batch])
                else:
                    keys = []
                    for c, _ in batch:
                        keys.extend(c[0])
                arrays = tuple(np.concatenate([c[i] for c, _ in batch]) for i in range(1, 8))
            algo, beh, hits, limit, duration, ge, gd = arrays
            # queue.wait: flush start -> launch submit (the backstop wait
            # plus the concatenation).
            saturation.observe_phase("queue.wait", time.monotonic() - t_chunk)
            bt = self._batch_trace(batch)
            if bt is not None:
                tracing.stage_batch_trace(bt)
            try:
                handle = self.store.apply_columns_async(
                    keys, algo, beh, hits, limit, duration, self.clock.now_ms(), ge, gd)
            finally:
                # A store that raised before taking the staged trace must
                # not leak it into this thread's next launch.
                tracing.take_batch_trace()
            with self._inflight_lock:
                self._own_inflight.append(handle)
                while self._own_inflight and self._own_inflight[0].done:
                    self._own_inflight.popleft()
            lo = 0
            for c, fut in batch:
                hi = lo + len(c[0])
                if not fut.done():
                    fut.set_result((handle, lo, hi))
                lo = hi
        except Exception as e:  # noqa: BLE001 — every waiter gets the error
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)

    def _batch_trace(self, batch):
        """Join the chunk's sampled submissions into one BatchTrace and
        record its batch.window span (from the earliest member's submit:
        the span covers the coalescing wait).  None when no member was
        sampled."""
        if not tracing.enabled():
            return None
        links, seen, t0 = [], set(), None
        for _, fut in batch:
            for ctx in getattr(fut, "_trace_links", ()):
                if (ctx.trace_id, ctx.span_id) not in seen:
                    seen.add((ctx.trace_id, ctx.span_id))
                    links.append(ctx)
            ts = getattr(fut, "_trace_t", None)
            if ts is not None and (t0 is None or ts < t0):
                t0 = ts
        bt = tracing.new_batch(links)
        if bt is not None:
            now = time.monotonic_ns()
            tracing.record_span(
                "batch.window", bt.ctx,
                start_ns=t0 if t0 is not None else now, end_ns=now,
                links=bt.links,
                lanes=sum(len(item[0][0]) for item in batch),
                submissions=len(batch),
            )
        return bt

    def stop(self) -> None:
        self._window.stop()
        with self._inflight_lock:
            self._own_inflight.clear()


class V1Service:
    def __init__(self, conf: ServiceConfig):
        from .metrics import Metrics

        self.conf = conf
        self.clock = conf.clock
        self.metrics = conf.metrics or Metrics()
        self.store = conf.store or MeshBucketStore(
            capacity_per_shard=max(conf.cache_size // N_SHARDS, 1),
            device=conf.device,
            g_capacity=(conf.global_cache_size if conf.global_cache_size is not None
                        else min(max(4096, conf.cache_size), 65536)),
            store=conf.persist_store,
            # Ceil division: any nonzero back_cache_size enables the back
            # tier (as the JAX service sizes it).
            back_capacity_per_shard=-(-conf.back_cache_size // N_SHARDS)
            if conf.back_cache_size > 0 else 0,
        )
        # gubernator_build_info: the store's topology is fixed for the
        # service's lifetime.
        self.metrics.set_build_info(self.store)
        self._closed = False
        self._started_monotonic = time.monotonic()
        # Membership: the ring set_peers installs (empty before it: the
        # node then owns every key), its generation and fingerprint (the
        # transfer epoch fence), the previous ring kept for the
        # double-dispatch window, and the manager that runs the handoff
        # and dropped peers' shutdowns on one bounded pool.  The ring
        # fields are guarded by _peer_mutex.
        self.local_picker = ReplicatedConsistentHash()
        self.region_picker = RegionPicker()
        self._peer_mutex = threading.RLock()
        # True until the first set_peers: only a service never given a
        # ring owns every key; a ring set empty answers "pool is empty".
        self._ringless = True
        self.ring_generation = 0
        self.ring_hash = 0
        self._prev_picker: Optional[ReplicatedConsistentHash] = None
        self._handoff_deadline = 0.0  # monotonic; 0 = no window
        self.reshard = ReshardManager(self)
        self._health = HealthCheckResponse(status=HEALTHY)
        # Per-service flight recorder: threads this service owns bind it.
        self.recorder = tracing.Recorder(
            name=conf.advertise_address or f"service-{id(self):x}")
        # Incident black box (blackbox.py): the per-wire traffic rings
        # and the triggered bundle writer.  Hooked into BOTH this
        # service's recorder and the process-default recorder: events
        # recorded by unbound threads still trigger bundles.
        self.blackbox = blackbox_mod.BlackBox(
            self,
            path=conf.blackbox_dir or "",
            budget_mb=conf.behaviors.blackbox_mb,
            retain=conf.behaviors.blackbox_retain,
            enabled=conf.behaviors.blackbox,
        )
        self.recorder.dump_hooks.append(self.blackbox.on_trigger)
        tracing.default_recorder().dump_hooks.append(self.blackbox.on_trigger)
        # Native service loop attachments (gateway.NativeIngressPump and
        # NativeGatewayServer register themselves; set_peers pushes the
        # ring to the pump).
        self.native_ingress = None
        self.native_edges: list = []
        # Peer forwards (the owner groups, single-lane forwards, handoff
        # peeks) run on this pool.  Async GLOBAL lanes and declined
        # single-lane shapes block on the dataclass router, which
        # submits its forwards to the forward pool and waits: they run
        # on a pool of their own, never on a drainer (outer tasks on the
        # forward pool could fill it and wait on inner tasks queued
        # behind them).
        self._forward_pool = ThreadPoolExecutor(
            max_workers=64, thread_name_prefix="peer-forward",
            initializer=tracing.bind_recorder, initargs=(self.recorder,))
        self._slow_pool = ThreadPoolExecutor(
            max_workers=128, thread_name_prefix="columns-slow",
            initializer=tracing.bind_recorder, initargs=(self.recorder,))
        self._drainer: Optional[_HandleDrainer] = None
        self._drainer_lock = threading.Lock()
        # Jittered backoff shared by the forward re-pick loop and the
        # GLOBAL plane's send loops.
        self._retry_backoff = Backoff(
            base_s=conf.behaviors.retry_backoff_base_s,
            max_s=conf.behaviors.retry_backoff_max_s,
        )
        if conf.loader is not None:
            # Loader SPI over the columnar commit (store.go:49-58 call
            # pattern): the whole load() stream merges in one row gather
            # and one row scatter.
            items = list(conf.loader.load())
            if items:
                self.store.commit_transfer(snapshot_mod.items_to_columns(items),
                                           self.clock.now_ms())
        # Restore the last snapshot before serving (a corrupt file is a
        # loud cold start), then run the save cadence.
        self.snapshots = snapshot_mod.SnapshotManager(
            self, path=conf.snapshot_path,
            interval_s=conf.behaviors.snapshot_interval_s)
        self.snapshots.restore()
        self.snapshots.start()
        self.local_batcher = LocalBatcher(self.store, conf.behaviors, self.clock,
                                          metrics=self.metrics)
        self.columnar_batcher = ColumnarBatcher(self.store, conf.behaviors, self.clock,
                                                metrics=self.metrics)
        # The express lane's host scalar slot is a service policy (bare
        # stores keep it off); the store serves it only on the CPU.
        if conf.behaviors.express and conf.behaviors.express_scalar:
            self.store.scalar_fast_path = True
            self.store.scalar_max_lanes = int(conf.behaviors.express_max_lanes)
        # Saturation & SLO plane: the latency-SLO burn engine
        # (GUBER_LATENCY_TARGET_MS; off at 0) and the hot-key sketch
        # served at GET /debug/hotkeys.
        b = conf.behaviors
        self.slo = saturation.SloEngine(b.latency_target_ms, b.slo_objective)
        # The SLO engine judges every GetRateLimits through
        # metrics.observe_latency.
        self.metrics.slo = self.slo
        self.hotkeys = saturation.HotKeySketch()
        # Cost observatory: the per-tenant cost ledger, folded beside
        # every audit ingress note.  The host sampler is process-wide
        # (profiling.set_enabled / ensure_started).
        self.tenants = profiling.TenantLedger(topk=b.tenant_topk)
        # Always-on conservation audit (audit.py), armed here.
        self.auditor = audit_mod.Auditor(
            metrics=self.metrics, interval_s=b.audit_interval_s,
            enabled=b.audit, recorder=self.recorder)
        self.auditor.start()
        # A store without a GLOBAL sync (a ShardStore) gets no sync ticks.
        self.global_mgr = GlobalManager(self) if hasattr(self.store, "sync_globals") else None
        self.multi_region_mgr = FederationManager(self)

    # ------------------------------------------------------------------
    @property
    def advertise_address(self) -> str:
        return self.conf.advertise_address

    @property
    def serves_peer_columns(self) -> bool:
        """Whether this node advertises the columnar peer encodings (the
        gateway's frame sniff on /v1/peer.GetPeerRateLimits); off under
        GUBER_PEER_COLUMNS=0 and for stores without columns."""
        return self.conf.behaviors.peer_columns and self.store.supports_columns

    @property
    def serves_ingress_columns(self) -> bool:
        """Whether this node advertises the public columnar ingress (the
        kind-5 frame sniff on /v1/GetRateLimits); off under
        GUBER_INGRESS_COLUMNS=0, where a frame answers 400 as a
        pre-columns build does."""
        return self.conf.behaviors.ingress_columns and self.store.supports_columns

    @property
    def serves_global_columns(self) -> bool:
        """Whether this node speaks the columnar GLOBAL plane (the
        globals-frame sniff and the batched replica commit); off under
        GUBER_GLOBAL_COLUMNS=0 and for stores without the batched
        commit."""
        return self.conf.behaviors.global_columns and hasattr(
            self.store, "set_replica_batch")

    @property
    def serves_reshard(self) -> bool:
        """Whether this node serves /v1/peer.TransferOwnership; off under
        GUBER_RESHARD=0 (the route then answers 404, as a pre-reshard
        build does)."""
        return self.conf.behaviors.reshard and hasattr(self.store, "commit_transfer")

    @property
    def serves_region_columns(self) -> bool:
        """Whether this node speaks the columnar inter-region wire: the
        one rule both edges consult (gRPC UpdateRegionColumns
        registration, the gateway's path gate), so negotiation cannot
        differ by transport.  False under GUBER_REGION_COLUMNS=0 (the
        pre-federation interop mode: senders see UNIMPLEMENTED / 404 and
        fall back sticky to the classic per-item GetPeerRateLimits
        encoding, which this node serves like any peer receive) and for
        stores without columns."""
        return self.conf.behaviors.region_columns and self.store.supports_columns

    def get_peer(self, key: str) -> PeerClient:
        """Owner peer for a key (gubernator.go:440-449)."""
        with self._peer_mutex:
            if self.local_picker.size() == 0:
                raise PeerError("unable to pick a peer; pool is empty")
            owner_id = self.local_picker.get(key)
            return self.local_picker.get_by_peer_id(owner_id)

    def get_peer_list(self) -> List[PeerClient]:
        with self._peer_mutex:
            return list(self.local_picker.peers())

    def get_region_picker(self) -> RegionPicker:
        return self.region_picker

    def set_peers(self, peer_infos: Sequence[PeerInfo]) -> None:
        """Rebuild pickers, reusing existing clients by address; drain
        dropped peers through the bounded reshard pool
        (gubernator.go:357-437).  A MEMBERSHIP change additionally bumps
        the ring generation + fingerprint, opens the double-dispatch
        handoff window (the previous ring is retained so reads can peek
        the old owner), and — when the reshard plane is on — schedules
        the columnar state handoff: moved resident keys drain off the
        device and ship to their new owners (reshard.py)."""
        local = [p for p in peer_infos if not p.data_center or p.data_center == self.conf.data_center]
        regional = [p for p in peer_infos if p.data_center and p.data_center != self.conf.data_center]

        with self._peer_mutex:
            self._ringless = False
            old_clients = {
                c.info.grpc_address: c
                for c in list(self.local_picker.peers()) + list(self.region_picker.peers())
                if isinstance(c, PeerClient)
            }
            old_ids = set(self.local_picker.peer_ids())
            new_local = self.local_picker.new()
            for info in local:
                client = old_clients.pop(info.grpc_address, None)
                if client is None:
                    client = PeerClient(
                        info, self.conf.behaviors,
                        tls_context=self.conf.peer_tls_context,
                        channel_credentials=self.conf.peer_channel_credentials,
                        metrics=self.metrics,
                        faults=self.conf.fault_plan,
                        blackbox=self.blackbox,
                    )
                client.info = info
                new_local.add(info.grpc_address, client)
            new_region = self.region_picker.new()
            for info in regional:
                client = old_clients.pop(info.grpc_address, None)
                if client is None:
                    client = PeerClient(
                        info, self.conf.behaviors,
                        tls_context=self.conf.peer_tls_context,
                        channel_credentials=self.conf.peer_channel_credentials,
                        metrics=self.metrics,
                        faults=self.conf.fault_plan,
                        blackbox=self.blackbox,
                    )
                client.info = info
                new_region.add(client)
            prev_picker = self.local_picker
            self.local_picker = new_local
            self.region_picker = new_region
            new_ids = set(new_local.peer_ids())
            # Ring delta only on a real MEMBERSHIP change: re-pushes of
            # the same list (discovery heartbeats, is_owner restamps)
            # must not bump the epoch or churn a handoff.
            membership_changed = new_ids != old_ids
            handoff = False
            if membership_changed:
                self.ring_generation += 1
                self.ring_hash = new_local.fingerprint()
                if old_ids and self.serves_reshard:
                    # Not the bootstrap call (and the reshard plane is
                    # on — GUBER_RESHARD=0 must be exactly the legacy
                    # metadata-only behavior, peeks included): open the
                    # double-dispatch window against the OLD ring.
                    # (prev_picker holds
                    # the surviving clients by reference — they are
                    # reused in the new picker — and shut-down dropped
                    # clients fast-fail, which the peek path tolerates.)
                    self._prev_picker = prev_picker
                    self._handoff_deadline = (
                        time.monotonic()
                        + getattr(self.conf.behaviors, "reshard_handoff_s", 2.0)
                    )
                    handoff = True
                elif (
                    self.serves_reshard
                    and self.snapshots.restored_ring_hash
                    and self.snapshots.restored_ring_hash != self.ring_hash
                ):
                    # BOOTSTRAP call, but the restored snapshot was
                    # saved under a DIFFERENT membership (snapshot.py
                    # ring fencing): the restore kept every key, so
                    # drain the ones this daemon no longer owns and ship
                    # them through the ordinary transfer path.  No
                    # double-dispatch window — there is no previous
                    # picker; the handoff itself is the ordinary
                    # drain -> transfer pass against the new ring.
                    self.snapshots.restored_ring_hash = None
                    handoff = True
            gen, rh = self.ring_generation, self.ring_hash

        # Native service loop (gateway.NativeIngressPump): push the new
        # ring snapshot so the GIL-free route check tracks membership —
        # a membership change with a double-dispatch window DISABLES
        # the fast lane until the window closes (moved keys owe the old
        # owner a peek only the Python router performs).
        pump = getattr(self, "native_ingress", None)
        if pump is not None:
            pump.update_ring()

        # Handoff FIRST, then dropped-peer shutdowns: both ride the
        # same bounded FIFO pool, and a delta dropping several peers
        # must not park every worker in blocking client drains while
        # the state transfer waits out its double-dispatch window.
        if handoff and self.serves_reshard and not self._closed:
            self.reshard.schedule_handoff(new_local, rh, gen)
        # Shutdown dropped peers without blocking — through the bounded
        # drain pool, tracked so close() can't race a half-shutdown
        # client (previously one unbounded daemon thread per peer).
        for client in old_clients.values():
            self.reshard.submit_shutdown(client)

    # ------------------------------------------------------------------
    def get_rate_limits(self, req: GetRateLimitsRequest) -> GetRateLimitsResponse:
        """gubernator.go:116-227 for a node that owns every key."""
        if len(req.requests) > MAX_BATCH_SIZE:
            raise ApiError(
                "OutOfRange",
                f"Requests.RateLimits list too large; max size is '{MAX_BATCH_SIZE}'",
            )
        return self._route(req.requests)

    def get_rate_limits_columns(
        self, cols: IngressColumns, max_lanes: int = MAX_BATCH_SIZE
    ) -> ColumnarResult:
        """Column-form GetRateLimits: same routing/validation semantics
        as get_rate_limits (gubernator.go:116-227), but locally-owned
        plain lanes flow straight into the store's columnar kernel path
        with no per-request dataclasses.  GLOBAL / MULTI_REGION /
        remotely-owned lanes fall back to the dataclass path lane-wise.

        `max_lanes` is the ingress-encoding cap: classic (per-request
        JSON/pb) requests keep the reference's MAX_BATCH_SIZE; the
        columnar frame/proto edges pass INGRESS_COLUMNS_MAX_LANES — a
        columnar client's frame coalesces many callers' checks, exactly
        like a forwarded peer batch."""
        if len(cols) > max_lanes:
            raise ApiError(
                "OutOfRange",
                f"Requests.RateLimits list too large; max size is '{max_lanes}'",
            )
        return self._route_columns(cols)

    def _route_columns(self, cols: IngressColumns) -> ColumnarResult:
        n = len(cols)
        result = ColumnarResult.empty(n)
        if n == 0:
            return result
        store_columnar = getattr(self.store, "supports_columns", False)
        if n == 1 or not store_columnar:
            # Single-item requests ride the dataclass path: its
            # LocalBatcher coalesces concurrent single-key clients into
            # one dispatch (the routing policy lives HERE so the HTTP
            # and gRPC edges cannot diverge).
            resp = self._route([cols.request_at(i) for i in range(n)])
            result.overrides = dict(enumerate(resp.responses))
            return result
        plan = self._submit_columns(cols, result)
        if plan is None:
            return result
        return self._finalize_columns(plan, result)

    def _submit_columns(self, cols, result) -> "Optional[_ColumnsPlan]":
        """Phase 1 of the columnar route: validation, ownership, and
        EVERY dispatch/forward submission — no blocking on device rounds
        or peer RPCs.  Returns the plan _finalize_columns (sync) or
        _ColumnsJoin (async) completes.  Shared by both so the two entry
        points cannot diverge."""
        n = len(cols)
        # Conservation ledger (audit.py): hits entering the public
        # front door on the columnar path (sync + async edges both
        # funnel here; the dataclass router counts in _route).
        audit_mod.note("ingress_hits", int(cols.hits.sum()))
        # Tenant cost ledger (profiling.py): the SAME admission fold —
        # every audit ingress note has a tenant fold beside it, so the
        # two ledgers reconcile exactly at quiesce (the soak asserts).
        tenant_ctx = self.tenants.fold_admit(cols)
        beh = cols.behavior
        # GLOBAL lanes need the replica-cache/dataclass path; MULTI_REGION
        # lanes stay columnar when locally owned (their only extra duty is
        # async hit queueing, handled below).
        slow = (beh & int(Behavior.GLOBAL)) != 0
        fast = np.logical_not(slow)

        # Validation (gubernator.go:142-152) + hash keys in one pass.
        # The native JSON edge precomputes both (gateway
        # LazyIngressColumns.prevalidated): packed hash keys flow to
        # the planner with zero per-lane Python.
        pre = getattr(cols, "prevalidated", None)
        if pre is not None:
            hash_keys, errc = pre
            for i in np.nonzero(errc)[0]:
                i = int(i)
                result.overrides[i] = RateLimitResponse(
                    error=ERR_EMPTY_KEY if errc[i] == 1 else ERR_EMPTY_NAME)
                fast[i] = slow[i] = False
        else:
            hash_keys = [""] * n
            for i in range(n):
                if not cols.unique_keys[i]:
                    result.overrides[i] = RateLimitResponse(error=ERR_EMPTY_KEY)
                    fast[i] = slow[i] = False
                elif not cols.names[i]:
                    result.overrides[i] = RateLimitResponse(error=ERR_EMPTY_NAME)
                    fast[i] = slow[i] = False
                else:
                    hash_keys[i] = f"{cols.names[i]}_{cols.unique_keys[i]}"

        # Ownership: the single-self-peer daemon (the common standalone
        # topology) owns everything; multi-peer rings resolve owners in
        # one vectorized pass.  Plain remote lanes group by owner for
        # ONE forwarded RPC per owner (the batch-sized analogue of the
        # reference's per-item forward window); GLOBAL remote lanes
        # keep the replica-cache dataclass path.
        remote_groups: Dict[str, list] = {}  # owner addr -> [lane idx]
        remote_peers: Dict[str, PeerClient] = {}
        peek_plan: list = []  # [(prev owner PeerClient, lane idx array)]
        with self._peer_mutex:
            pp = self._handoff_prev_picker()  # handoff window: old ring
            psize = self.local_picker.size()
            # A service never given a ring owns every key.
            single_owner = psize == 0 and self._ringless
            if psize == 1 and pp is None:
                # The single-self shortcut is disabled during a handoff
                # window: a just-scaled-in ring still owes moved lanes
                # the double-dispatch peek at their old owner.
                (only,) = self.local_picker.peers()
                single_owner = only.info.is_owner
            if psize == 0 and not single_owner:
                # A ring set empty: every valid lane answers JAX's error.
                for i in range(n):
                    if i not in result.overrides:
                        result.overrides[i] = RateLimitResponse(
                            error=(
                                f"while finding peer that owns rate limit "
                                f"'{hash_keys[i]}' - 'unable to pick a peer; pool is empty'"
                            )
                        )
                return None
            grouped_mask = np.zeros(n, dtype=bool)
            if not single_owner and psize >= 1:
                # Vectorized ownership: one batch hash + searchsorted,
                # then one mask pass PER DISTINCT OWNER (not per lane)
                # — the ring hands back integer owner codes, so no
                # per-lane Python objects are touched here.  Works on
                # plain string lists and PackedKeys alike.
                valid = fast | slow  # validation-error lanes: both False
                all_valid = bool(valid.all())
                if all_valid:
                    keys_for_ring = hash_keys
                elif isinstance(hash_keys, list):
                    keys_for_ring = [
                        hash_keys[int(i)] for i in np.nonzero(valid)[0]
                    ]
                else:  # PackedKeys (native edge / peer frame decode)
                    keys_for_ring = hash_keys.subset(np.nonzero(valid)[0])
                codes, code_ids = self.local_picker.get_batch_codes(
                    keys_for_ring, sketch=self.hotkeys
                )
                if all_valid:
                    lane_code = codes
                else:
                    lane_code = np.full(n, -1, dtype=np.int32)
                    lane_code[valid] = codes
                if pp is not None and pp.size():
                    # Handoff window: lanes whose owner moved between
                    # the two rings double-dispatch COLUMNAR-natively —
                    # routing stays on the fast path under the NEW
                    # ring, and one grouped zero-hit peek per PREVIOUS
                    # owner merges monotonically at finalize
                    # (_merge_peek_result), so bulk reads never observe
                    # a reset bucket mid-transfer and never pay per-
                    # lane dataclass legs.  One extra vectorized ring
                    # pass + one extra RPC/dispatch per prev-owner per
                    # batch, only while the window is open.  GLOBAL
                    # lanes keep replica semantics; Gregorian lanes
                    # skip the peek (their duration column is an enum a
                    # raw zero-hit batch cannot carry safely).
                    pcodes, pids = pp.get_batch_codes(keys_for_ring)
                    moved_sel = (
                        np.asarray(code_ids, dtype=object)[codes]
                        != np.asarray(pids, dtype=object)[pcodes]
                    )
                    if moved_sel.any():
                        valid_idx = (
                            np.arange(n) if all_valid
                            else np.nonzero(valid)[0]
                        )
                        beh_v = np.asarray(beh)[valid_idx]
                        mv = (
                            moved_sel
                            & ((beh_v & int(Behavior.GLOBAL)) == 0)
                            & (
                                (beh_v
                                 & int(Behavior.DURATION_IS_GREGORIAN))
                                == 0
                            )
                        )
                        for pc in np.unique(pcodes[mv]):
                            prev_peer = pp.get_by_peer_id(pids[int(pc)])
                            if prev_peer is None:
                                continue
                            breaker = getattr(prev_peer, "breaker", None)
                            if (
                                breaker is not None
                                and breaker.is_open
                                and not prev_peer.info.is_owner
                            ):
                                # A dead old owner: the peek would only
                                # fast-fail — skip it outright.
                                continue
                            lanes = valid_idx[mv & (pcodes == pc)]
                            if lanes.size:
                                peek_plan.append((prev_peer, lanes))
                for c, pid in enumerate(code_ids):
                    peer = self.local_picker.get_by_peer_id(pid)
                    if peer is not None and peer.info.is_owner:
                        continue
                    lanes = np.nonzero(lane_code == c)[0]
                    if not lanes.size:
                        continue
                    fast[lanes] = False
                    if peer is not None:
                        # Plain remote lanes: group-forward.  A None
                        # peer (churn mid-resolve) stays on the
                        # dataclass router, which re-picks; GLOBAL
                        # lanes keep the replica-cache path.
                        plain = lanes[np.logical_not(slow[lanes])]
                        if plain.size:
                            addr = peer.info.grpc_address
                            remote_groups[addr] = plain
                            remote_peers[addr] = peer
                            grouped_mask[plain] = True
                    slow[lanes] = True

        self._queue_mr_fast(cols, beh, fast, hash_keys)
        pendings = self._dispatch_fast(cols, beh, fast, hash_keys, result)

        # Plain remote lanes: ONE forwarded columnar sub-batch per
        # owner, submitted in parallel while the local fast dispatch is
        # in flight (the batch-sized analogue of the per-item forward,
        # gubernator.go:195-210).  The lanes travel as COLUMN subsets —
        # no per-lane dataclasses — and concurrent ingress batches to
        # the same owner coalesce in the PeerClient window.  A group
        # containing any NO_BATCHING lane sends direct (window
        # bypassed), preserving the per-request opt-out.
        group_futs = {}
        for addr, idxs in remote_groups.items():
            idx = np.asarray(idxs, dtype=np.int64)
            sub = (
                [cols.names[int(i)] for i in idxs],
                [cols.unique_keys[int(i)] for i in idxs],
                np.asarray(cols.algorithm[idx], dtype=np.int32),
                np.asarray(beh[idx], dtype=np.int32),
                np.asarray(cols.hits[idx], dtype=np.int64),
                np.asarray(cols.limit[idx], dtype=np.int64),
                np.asarray(cols.duration[idx], dtype=np.int64),
            )
            direct = bool((beh[idx] & int(Behavior.NO_BATCHING)).any())
            group_futs[addr] = self._forward_pool.submit(
                self._forward_group_columns, remote_peers[addr], sub, direct,
                # Captured HERE: the forward runs on a pool thread with
                # no ambient context; the peer hop carries this as the
                # wire trace-context column (tracing.py).
                tracing.current(),
            )

        # Handoff double-dispatch: submit the grouped zero-hit peeks
        # (one per previous owner) alongside the in-flight primary
        # legs.  Local groups (the previous owner is THIS daemon,
        # draining away) dispatch one batched device read; remote
        # groups ride the peer's coalescing window.  Strictly
        # best-effort: a submit failure simply drops the peek.
        peeks: list = []
        for prev_peer, lanes in peek_plan:
            idx = np.asarray(lanes, dtype=np.int64)
            zero_hits = np.zeros(idx.size, np.int64)
            try:
                if prev_peer.info.is_owner:
                    if isinstance(hash_keys, list):
                        keys_sel = [hash_keys[int(i)] for i in idx]
                    else:
                        keys_sel = hash_keys.subset(idx)
                    # Peeks OBSERVE, they must not create: drop lanes
                    # with no resident bucket here — nothing to peek,
                    # and a zero-hit shadow bucket would later ride the
                    # transfer plane as noise.  resident_mask iterates
                    # plain lists and PackedKeys alike.
                    res = self.store.resident_mask(keys_sel)
                    if not res.all():
                        idx = idx[res]
                        if not idx.size:
                            continue
                        keys_sel = (
                            [k for k, r in zip(keys_sel, res) if r]
                            if isinstance(keys_sel, list)
                            else keys_sel.subset(np.nonzero(res)[0])
                        )
                        zero_hits = np.zeros(idx.size, np.int64)
                    handle = self.store.apply_columns_async(
                        keys_sel,
                        np.asarray(cols.algorithm[idx], dtype=np.int32),
                        np.asarray(beh[idx], dtype=np.int32),
                        zero_hits,
                        np.asarray(cols.limit[idx], dtype=np.int64),
                        np.asarray(cols.duration[idx], dtype=np.int64),
                        self.clock.now_ms(),
                    )
                    peeks.append(("local", (handle, 0, idx.size), idx))
                else:
                    sub = (
                        [cols.names[int(i)] for i in idx],
                        [cols.unique_keys[int(i)] for i in idx],
                        np.asarray(cols.algorithm[idx], dtype=np.int32),
                        np.asarray(beh[idx], dtype=np.int32),
                        zero_hits,
                        np.asarray(cols.limit[idx], dtype=np.int64),
                        np.asarray(cols.duration[idx], dtype=np.int64),
                    )
                    peeks.append(
                        ("remote", prev_peer.forward_columns(sub), idx)
                    )
            except Exception:  # noqa: BLE001 — peek is best-effort
                continue

        # Remaining slow lanes (GLOBAL remote/local specials) ride the
        # dataclass router.
        slow_idx = [
            int(i)
            for i in np.nonzero(np.logical_and(slow, ~grouped_mask))[0]
        ]
        slow_reqs = [cols.request_at(i) for i in slow_idx]
        return _ColumnsPlan(
            pendings=pendings,
            group_futs=group_futs,
            remote_groups=remote_groups,
            slow_idx=slow_idx,
            slow_fn=(
                # _counted: these lanes' hits were already noted by the
                # funnel above — the dataclass router must not re-note
                # the GLOBAL subset into the ingress ledger.
                (lambda: self._route(slow_reqs, _counted=True).responses)
                if slow_idx else None
            ),
            hash_keys=hash_keys,
            peeks=peeks,
            tenant_ctx=tenant_ctx,
        )

    def _finalize_columns(self, plan: "_ColumnsPlan", result) -> ColumnarResult:
        """Phase 2, blocking form: resolve every submission from phase 1
        and merge into `result` (the async twin is _ColumnsJoin).  The
        handoff peeks merge LAST — they adjust the arrays the primary
        merges populate."""
        if plan.slow_idx:
            resps = plan.slow_fn()
            for i, r in zip(plan.slow_idx, resps):
                result.overrides[int(i)] = r
        for addr, fut in plan.group_futs.items():
            _merge_group_result(
                result, plan.remote_groups[addr], addr, fut.result()
            )
        self._resolve_fast(
            plan.pendings, plan.hash_keys, result,
            tenant_ctx=plan.tenant_ctx,
        )
        for kind, payload, lanes in plan.peeks:
            data = None
            try:
                if kind == "remote":
                    rc, lo, hi = payload.result(
                        timeout=self.conf.behaviors.batch_timeout_s + 1.0
                    )
                    data = ("remote", (rc, lo, hi))
                else:
                    handle, lo, hi = payload
                    data = ("local", (handle.result(), slice(lo, hi)))
            except Exception:  # noqa: BLE001 — peek is best-effort
                data = None
            _merge_peek_result(result, lanes, data)
        # Tenant cost ledger: per-tenant OVER_LIMIT attribution from
        # the resolved arrays (admission was folded at submit).
        self.tenants.fold_outcome(plan.tenant_ctx, result)
        return result

    # -- shared fast-lane halves of the two columnar entry points ------
    def _resolve_greg_fast(self, cols, beh, fast, result):
        """Gregorian precompute for fast lanes (slow lanes redo it in
        prepare_requests; cheap, memoized per duration).  Mutates `fast`
        for error lanes; returns (greg_expire, greg_duration) or Nones."""
        n = len(cols)
        greg_lanes = fast & ((beh & int(Behavior.DURATION_IS_GREGORIAN)) != 0)
        if not greg_lanes.any():
            return None, None
        greg_expire = np.zeros(n, dtype=np.int64)
        greg_duration = np.zeros(n, dtype=np.int64)
        resolver = GregResolver(self.clock.now_ms())
        for i in np.nonzero(greg_lanes)[0]:
            cached = resolver.resolve(int(cols.duration[i]))
            if isinstance(cached, gregorian.GregorianError):
                result.overrides[int(i)] = RateLimitResponse(error=str(cached))
                fast[i] = False
                continue
            greg_expire[i], greg_duration[i] = cached
        return greg_expire, greg_duration

    def _queue_mr_fast(self, cols, beh, fast, hash_keys) -> None:
        """MULTI_REGION fast lanes owe the cross-region hit queue
        (gubernator.go:343-345): aggregate per key first, so the queue
        sees one request per unique key, not one per lane."""
        mr = fast & ((beh & int(Behavior.MULTI_REGION)) != 0)
        if not mr.any():
            return
        agg: Dict[str, RateLimitRequest] = {}
        for i in np.nonzero(mr)[0]:
            k = hash_keys[int(i)]
            cur = agg.get(k)
            if cur is None:
                agg[k] = cols.request_at(int(i))
            else:
                cur.hits += int(cols.hits[i])
        for r in agg.values():
            self.multi_region_mgr.queue_hits(r)

    def _dispatch_fast(self, cols, beh, fast, hash_keys, result):
        """Dispatch the fast lanes (Gregorian precompute included).
        Batching behavior is per request, as in the reference
        (proto/gubernator.proto:74-78): lanes flagged NO_BATCHING
        dispatch immediately, the rest coalesce through the window —
        a mixed batch splits into one direct and one windowed dispatch.
        Returns a list of (pending, idx) pairs for _resolve_fast."""
        greg_expire, greg_duration = self._resolve_greg_fast(cols, beh, fast, result)
        fast_idx = np.nonzero(fast)[0]
        if not fast_idx.size:
            return []
        n = len(cols)
        # Span handles for the dispatch (tracing.py): the ambient
        # ingress context plus any wire trace-context column a peer
        # batch carried; [] on unsampled traffic (one branch).
        links = tracing.request_links(cols)

        def dispatch(idx, direct):
            full = idx.size == n
            sl = slice(None) if full else idx
            if full:
                keys_sel = hash_keys
            elif isinstance(hash_keys, list):
                keys_sel = [hash_keys[i] for i in idx]
            else:
                keys_sel = hash_keys.subset(idx)  # PackedKeys, no per-lane Python
            args = (
                keys_sel, cols.algorithm[sl], beh[sl], cols.hits[sl],
                cols.limit[sl], cols.duration[sl],
                None if greg_expire is None else greg_expire[sl],
                None if greg_duration is None else greg_duration[sl],
            )
            if direct:
                bt = tracing.new_batch(links)
                if bt is not None:
                    tracing.stage_batch_trace(bt)
                try:
                    handle = self.store.apply_columns_async(
                        *args[:6], self.clock.now_ms(), *args[6:]
                    )
                finally:
                    tracing.take_batch_trace()
                return (handle, 0, idx.size), idx
            return (
                self.columnar_batcher.submit(*args, trace_links=links),
                idx,
            )

        nb = (beh[fast_idx] & int(Behavior.NO_BATCHING)) != 0
        if not nb.any():
            return [dispatch(fast_idx, False)]
        if nb.all():
            return [dispatch(fast_idx, True)]
        return [dispatch(fast_idx[nb], True), dispatch(fast_idx[~nb], False)]

    def _resolve_fast(self, pendings, hash_keys, result,
                      tenant_ctx=None) -> None:
        """Block on each fast dispatch and scatter its arrays into the
        result; a dispatch failure (e.g. shutdown race) converts to
        per-lane errors instead of failing lanes already computed."""
        for pending, fast_idx in pendings:
            out, sl, exc = None, None, None
            try:
                handle, lo, hi = (
                    pending.result() if isinstance(pending, Future) else pending
                )
                out = handle.result()
                sl = slice(lo, hi)
            except Exception as e:  # noqa: BLE001
                exc = e
            if isinstance(exc, IngressShedError):
                # Tenant cost ledger: the bounded ingress gate refused
                # these lanes — attribute the shed to their tenants
                # (ROADMAP item 2's "one tenant's burst sheds itself").
                self.tenants.fold_shed(tenant_ctx, fast_idx)
            _merge_fast_result(result, hash_keys, fast_idx, out, sl, exc)

    def _route(self, requests: Sequence[RateLimitRequest],
               _counted: bool = False) -> GetRateLimitsResponse:
        n = len(requests)
        # Conservation ledger: the dataclass router is the other public
        # front-door funnel (get_rate_limits, single-lane and
        # non-columnar fallbacks of the columnar entries).  `_counted`
        # marks lanes the columnar funnel already noted (its GLOBAL/
        # slow subset routes through here) — noting them twice would
        # overstate front-door hits by the GLOBAL fraction.
        if not _counted:
            audit_mod.note(
                "ingress_hits", sum(int(r.hits) for r in requests)
            )
        # Tenant cost ledger: the dataclass router's admission fold
        # (lanes the columnar funnel already folded arrive _counted).
        tenant_names = (
            None if _counted else self.tenants.fold_requests(requests)
        )
        out: List[Optional[RateLimitResponse]] = [None] * n
        local: List[int] = []
        global_remote: List[int] = []
        owner_by_idx: Dict[int, str] = {}
        forwards: List[tuple] = []  # (idx, req, peer)
        peeks: Dict[int, Future] = {}  # handoff double-dispatch legs
        with self._peer_mutex:
            # A service never given a ring owns every key.
            alone = self.local_picker.size() == 0 and self._ringless

        for i, r in enumerate(requests):
            # Validation (gubernator.go:142-152; note the reference's
            # 'namespace' wording for an empty name).
            if not r.unique_key:
                out[i] = RateLimitResponse(error=ERR_EMPTY_KEY)
                continue
            if not r.name:
                out[i] = RateLimitResponse(error=ERR_EMPTY_NAME)
                continue
            if alone:
                local.append(i)
                continue
            key = r.hash_key()
            peer, err = self._pick_ready_peer(key)
            if peer is None:
                out[i] = RateLimitResponse(
                    error=f"while finding peer that owns rate limit '{key}' - '{err}'"
                )
                continue
            if not has_behavior(r.behavior, Behavior.GLOBAL):
                # Handoff window (elastic membership): a lane whose
                # ownership moved between the previous and current ring
                # DOUBLE-DISPATCHES — the hit is served by the new
                # owner (the normal legs below) plus a concurrent
                # zero-hit peek at the old owner, merged monotonically
                # at the end, so the read can never observe a reset
                # bucket while the state transfer is in flight.
                prev = self._handoff_peek_peer(key, peer)
                if prev is not None:
                    peeks[i] = self._forward_pool.submit(
                        self._peek_one, r, prev
                    )
            if peer.info.is_owner:
                local.append(i)
                if has_behavior(r.behavior, Behavior.MULTI_REGION):
                    self.multi_region_mgr.queue_hits(r)
            elif has_behavior(r.behavior, Behavior.GLOBAL):
                global_remote.append(i)
                owner_by_idx[i] = peer.info.grpc_address
            else:
                forwards.append((i, r, peer))

        now = self.clock.now_ms()

        if local:
            # Whole-batch requests evaluate directly (they ARE the
            # batch); single-item requests with BATCHING ride the
            # ingress window so concurrent clients share one dispatch.
            local_reqs = [requests[i] for i in local]
            if len(local_reqs) > 1 or any(
                has_behavior(r.behavior, Behavior.NO_BATCHING) for r in local_reqs
            ):
                if len(local_reqs) == 1 and self._single_columnar_eligible(
                    local_reqs[0]
                ):
                    # Single NO_BATCHING lane: direct columnar dispatch
                    # (no window).  Same eligibility as the batched
                    # rider; keeps the latency-optimized flag FASTER
                    # than the windowed path, not slower (the object
                    # path's per-request dataclass machinery costs more
                    # than the 500 µs window it skips).
                    i = local[0]
                    try:
                        out[i] = self._submit_single_local(
                            local_reqs[0], direct=True
                        ).result()
                    except Exception as e:  # noqa: BLE001
                        key = local_reqs[0].hash_key()
                        out[i] = RateLimitResponse(
                            error=f"while applying rate limit '{key}' - '{e}'"
                        )
                else:
                    resps = self.store.apply(local_reqs, now)
                    for i, resp in zip(local, resps):
                        out[i] = resp
            else:
                futs = [
                    (i, self._submit_single_local(r))
                    for i, r in zip(local, local_reqs)
                ]
                for i, fut in futs:
                    # Per-item error conversion, like the forward path
                    # (_forward_one): a batcher failure must not 500 the
                    # whole GetRateLimits call.
                    try:
                        # No timeout: the flush ALWAYS resolves every
                        # future (result or exception), and a timeout
                        # here would report an error for hits that the
                        # late flush still applies device-side.
                        out[i] = fut.result()
                    except Exception as e:  # noqa: BLE001
                        key = requests[i].hash_key()
                        out[i] = RateLimitResponse(
                            error=f"while applying rate limit '{key}' - '{e}'"
                        )
        if global_remote:
            resps = self.store.apply(
                [requests[i] for i in global_remote], now, remote_global=True
            )
            for i, resp in zip(global_remote, resps):
                resp.metadata = {"owner": owner_by_idx.get(i, "")}
                out[i] = resp

        if forwards:
            futures = {
                i: self._forward_pool.submit(
                    self._forward_one, r, p, tracing.current()
                )
                for i, r, p in forwards
            }
            for i, fut in futures.items():
                out[i] = fut.result()

        for i, fut in peeks.items():
            try:
                peek = fut.result(
                    timeout=self.conf.behaviors.batch_timeout_s + 1.0
                )
            except Exception:  # noqa: BLE001 — peek is best-effort
                peek = None
            if out[i] is not None:
                out[i] = self._merge_handoff(out[i], peek)

        if tenant_names is not None:
            self.tenants.fold_outcome_responses(tenant_names, out)
        return GetRateLimitsResponse(
            responses=[r if r is not None else RateLimitResponse() for r in out]
        )

    def _single_columnar_eligible(self, r: RateLimitRequest) -> bool:
        return not has_behavior(r.behavior, Behavior.GLOBAL) and self.store.supports_columns

    def _submit_single_local(self, r: RateLimitRequest, direct: bool = False):
        """One lane: through the columnar coalescer when eligible (its
        flush only launches; waiters resolve the shared handle, so
        concurrent single-key callers overlap their readbacks), at once
        with `direct` (NO_BATCHING).  GLOBAL lanes and Store SPI
        deployments take the LocalBatcher's dataclass window."""
        if not self._single_columnar_eligible(r):
            return self.local_batcher.submit(r)
        ge_arr = gd_arr = None
        if has_behavior(r.behavior, Behavior.DURATION_IS_GREGORIAN):
            cached = GregResolver(self.clock.now_ms()).resolve(int(r.duration))
            if isinstance(cached, gregorian.GregorianError):
                done: Future = Future()
                done.set_result(RateLimitResponse(error=str(cached)))
                return done
            ge_arr = np.array([cached[0]], np.int64)
            gd_arr = np.array([cached[1]], np.int64)
        cols = (
            [r.hash_key()],
            np.array([int(r.algorithm)], np.int32),
            np.array([int(r.behavior)], np.int32),
            np.array([int(r.hits)], np.int64),
            np.array([int(r.limit)], np.int64),
            np.array([int(r.duration)], np.int64),
        )
        cur = tracing.current()
        links = [cur] if cur is not None else None
        if direct:
            bt = tracing.new_batch(links or [])
            if bt is not None:
                tracing.stage_batch_trace(bt)
            try:
                handle = self.store.apply_columns_async(*cols, self.clock.now_ms(), ge_arr, gd_arr)
            finally:
                tracing.take_batch_trace()
            fut: Future = Future()
            fut.set_result((handle, 0, 1))
        else:
            fut = self.columnar_batcher.submit(*cols, ge_arr, gd_arr, trace_links=links)
        return _SingleLaneWait(fut)

    def _pick_ready_peer(self, key: str):
        """GetPeer for routing; the not-ready re-pick loop
        (gubernator.go:154-162) lives in _forward_one, where readiness
        is actually observed."""
        try:
            return self.get_peer(key), None
        except PeerError as e:
            return None, e

    def _forward_group_columns(self, peer: PeerClient, sub, direct: bool,
                               trace_ctx=None):
        """Forward a whole owner-group as ONE columnar sub-batch
        (riding the peer's coalescing window; `direct` bypasses it for
        NO_BATCHING groups).  Fast outcome: ("cols", result, lo, hi) —
        this group's slice of the shared decoded response arrays,
        scattered zero-dataclass by _merge_group_result.  Failure legs
        keep the dataclass route: an owner with an open circuit breaker
        degrades the whole group to local evaluation; a not-ready peer
        degrades to the per-item forward path, which owns the re-pick
        retry loop (gubernator.go:154-162); other failures convert per
        lane."""
        try:
            if direct:
                rc = peer.send_columns_direct(
                    sub, timeout_s=self.conf.behaviors.batch_timeout_s,
                    trace_ctx=trace_ctx,
                )
                return ("cols", rc, 0, len(sub[0]))
            fut = peer.forward_columns(sub, trace_ctx=trace_ctx)
            rc, lo, hi = fut.result(
                timeout=self.conf.behaviors.batch_timeout_s + 1.0
            )
            return ("cols", rc, lo, hi)
        except Exception as e:  # noqa: BLE001
            if is_circuit_open(e):
                # The RPC never left this host (breaker fast-fail), so
                # local evaluation cannot double-count.
                return self._degrade_local(_cols_to_requests(sub), peer)
            if is_not_ready(e):
                return [
                    self._forward_one(r, peer) for r in _cols_to_requests(sub)
                ]
            return [
                RateLimitResponse(
                    error=(
                        f"while fetching rate limit '{nm}_{uk}' from peer - '{e}'"
                    )
                )
                for nm, uk in zip(sub[0], sub[1])
            ]

    def _degrade_local(
        self, reqs: Sequence[RateLimitRequest], peer: PeerClient
    ) -> List[RateLimitResponse]:
        """The owner's circuit breaker is open: serve the hit from the
        LOCAL shard instead of blocking the batch window behind a dead
        peer.  Documented degraded semantics (architecture.md "Fault
        tolerance"): during the open window each surviving daemon
        enforces the key's full limit against its own share of the
        traffic, so OVER_LIMIT is still enforced (per daemon) and state
        converges back to owner-authoritative once the breaker's
        half-open probe re-closes it.  Responses are stamped
        degraded=true so callers/tests can observe the mode.

        Singles ride _submit_single_local (the windowed columnar
        coalescer): under exactly the load this path absorbs — a whole
        batch window's waiters failing over at once — one raw
        store.apply per waiter would serialize N device rounds at one
        store-lock hold each (the ThunderingHeard ceiling the coalescer
        exists to avoid).  Groups are already one batched apply."""
        if len(reqs) == 1:
            try:
                resps = [self._submit_single_local(reqs[0]).result()]
            except Exception as e:  # noqa: BLE001 (per-item, like _forward_one)
                resps = [
                    RateLimitResponse(
                        error=(
                            f"while applying rate limit "
                            f"'{reqs[0].hash_key()}' - '{e}'"
                        )
                    )
                ]
        else:
            resps = self.store.apply(list(reqs), self.clock.now_ms())
        for resp in resps:
            resp.metadata = {
                "owner": peer.info.grpc_address,
                "degraded": "true",
            }
        self.metrics.degraded_evals.inc(len(resps))
        return resps

    def _forward_one(self, r: RateLimitRequest, peer: PeerClient,
                     trace_ctx=None) -> RateLimitResponse:
        """Forward to the owner (the BATCHING leg, gubernator.go:195-210),
        retrying with a re-pick + jittered backoff when the peer is not
        ready (budget: behaviors.forward_retry_limit).  An owner whose
        circuit breaker was already open serves degraded local
        evaluation instead; a breaker that opens MID-retry keeps the
        error path — this request already burned its budget observing
        real failures, and the caller sees the same not-connected error
        the reference returns (the NEXT request gets the fast degraded
        path).  `trace_ctx` is the SUBMITTING request's span context:
        this runs on a forward-pool thread with no ambient context, so
        the router captures it at submit time — without it a
        single-lane forwarded request's trace would end at the ingress
        span instead of crossing the wire."""
        key = r.hash_key()
        attempts = 0
        budget = self.conf.behaviors.forward_retry_limit
        while True:
            try:
                resp = peer.get_peer_rate_limit(r, trace_ctx=trace_ctx)
                resp.metadata = {"owner": peer.info.grpc_address}
                return resp
            except Exception as e:  # noqa: BLE001
                if is_circuit_open(e):
                    if attempts == 0:
                        return self._degrade_local([r], peer)[0]
                    return RateLimitResponse(
                        error=(
                            "GetPeer() keeps returning peers that are not connected "
                            f"for '{key}' - '{e}'"
                        )
                    )
                if is_not_ready(e):
                    attempts += 1
                    if attempts > budget:
                        return RateLimitResponse(
                            error=(
                                "GetPeer() keeps returning peers that are not connected "
                                f"for '{key}' - '{e}'"
                            )
                        )
                    self.metrics.peer_retries.labels(op="forward").inc()
                    self._retry_backoff.sleep(attempts - 1)
                    try:
                        peer = self.get_peer(key)
                    except PeerError as pe:
                        return RateLimitResponse(
                            error=f"while finding peer that owns rate limit '{key}' - '{pe}'"
                        )
                    continue
                return RateLimitResponse(
                    error=f"while fetching rate limit '{key}' from peer - '{e}'"
                )

    # -- double-dispatch reads during a handoff window -----------------
    def _handoff_prev_picker(self):
        """The previous ring's picker while the double-dispatch window
        is open, else None (and the reference is dropped once the
        window lapses, so steady state pays one None check).  Caller
        holds _peer_mutex."""
        if self._prev_picker is None:
            return None
        if time.monotonic() >= self._handoff_deadline:
            self._prev_picker = None
            return None
        return self._prev_picker

    def _handoff_peek_peer(self, key: str, cur_peer: PeerClient):
        """The OLD owner to peek for `key` during the handoff window —
        None when no window is open, ownership didn't move, or the old
        owner is the current one."""
        if self._prev_picker is None:  # unlocked fast path (benign race)
            return None
        with self._peer_mutex:
            pp = self._handoff_prev_picker()
            if pp is None or pp.size() == 0:
                return None
            try:
                prev = pp.get_by_peer_id(pp.get(key))
            except RuntimeError:
                return None
        if prev is None or prev is cur_peer:
            return None
        pinfo = getattr(prev, "info", None)
        if pinfo is not None and pinfo.grpc_address == cur_peer.info.grpc_address:
            return None
        breaker = getattr(prev, "breaker", None)
        if (
            breaker is not None and breaker.is_open
            and not (pinfo is not None and pinfo.is_owner)
        ):
            # A dead old owner (breaker open): the peek would only
            # fast-fail — skip it so churn against unreachable peers
            # never taxes the request path.
            return None
        return prev

    def _peek_one(self, r: RateLimitRequest, prev_peer):
        """Zero-hit read at the PREVIOUS owner: the second leg of the
        double-dispatch.  hits=0 never consumes budget, so the peek
        cannot double-count — it only observes the bucket the transfer
        hasn't landed yet.  Best-effort: any failure (old owner dying
        is exactly when this runs) returns None and the primary answer
        stands."""
        r0 = replace(r, hits=0)
        try:
            if prev_peer.info.is_owner:
                # The previous owner is THIS daemon (we are draining
                # away): read our own store — only if the bucket is
                # actually resident (peeks observe, never create).
                mask_fn = getattr(self.store, "resident_mask", None)
                if mask_fn is not None and not mask_fn([r0.hash_key()])[0]:
                    return None
                return self.store.apply([r0], self.clock.now_ms())[0]
            return prev_peer.get_peer_rate_limit(r0)
        except Exception:  # noqa: BLE001 — peek is strictly best-effort
            return None

    @staticmethod
    def _merge_handoff(primary: RateLimitResponse,
                       peek: Optional[RateLimitResponse]) -> RateLimitResponse:
        """Monotone merge of a double-dispatched read (the documented
        rule, architecture.md "Membership & resharding"): status = max
        (OVER_LIMIT wins), remaining = min, reset_time = max.  Both
        sides answered about the same limit config; the merged view is
        never more permissive than either — so no request observes a
        reset bucket mid-handoff.  Error answers on either side leave
        the primary untouched."""
        if peek is None or peek.error or primary.error:
            return primary
        if int(peek.remaining) >= int(peek.limit) and int(peek.status) == 0:
            # No consumption evidence: the old owner answered a
            # fresh/untouched bucket (it may have already forgotten the
            # key post-ACK) — nothing to carry, and merging would only
            # inflate reset_time.
            return primary
        primary.status = max(int(primary.status), int(peek.status))
        primary.remaining = min(int(primary.remaining), int(peek.remaining))
        primary.reset_time = max(int(primary.reset_time), int(peek.reset_time))
        if primary.metadata:
            primary.metadata.setdefault("handoff", "true")
        else:
            primary.metadata = {"handoff": "true"}
        return primary

    def _peer_send(self, op: str, fn: Callable[[], object]) -> bool:
        """Host-tier peer send (GLOBAL hits/broadcast fan-out,
        multi-region push) with jittered-backoff retries on not-ready
        failures, replacing the bare try/except-pass hot loops that
        were dominated by network timeouts under failure.  Circuit-open
        fast-fails are skipped immediately (the breaker's open interval
        IS the backoff across ticks); budgets come from
        behaviors.global_send_retries.  Returns success."""
        ok, _ = self._peer_send_ex(op, fn)
        return ok

    def _peer_send_ex(self, op: str, fn: Callable[[], object]):
        """_peer_send returning (success, last_error): the GLOBAL
        requeue accounting reads the failure SHAPE — a breaker
        fast-fail / connection-level not-ready provably never applied
        (safe to requeue the hits), a timeout-shaped failure may have
        applied server-side (requeueing would double-count)."""
        budget = self.conf.behaviors.global_send_retries
        attempt = 0
        while True:
            try:
                fn()
                return True, None
            except Exception as e:  # noqa: BLE001 (logged-and-continue in ref)
                if is_circuit_open(e) or not is_not_ready(e) or attempt >= budget:
                    return False, e
                self.metrics.peer_retries.labels(op=op).inc()
                self._retry_backoff.sleep(attempt)
                attempt += 1

    # ------------------------------------------------------------------
    # Async columnar ingress
    # ------------------------------------------------------------------
    def _get_drainer(self) -> _HandleDrainer:
        """The handle drainer, started at the first async request."""
        with self._drainer_lock:
            if self._drainer is None:
                d = _HandleDrainer()
                d.start()
                self._drainer = d
            return self._drainer

    def get_rate_limits_columns_async(self, cols: IngressColumns, callback: Callable,
                                      max_lanes: int = MAX_BATCH_SIZE) -> None:
        """Async twin of get_rate_limits_columns: submits everything on
        the calling thread (validation, launches, no readback wait), then
        calls callback(result, exc) exactly once from a completion
        thread."""
        try:
            if len(cols) > max_lanes:
                raise ApiError(
                    "OutOfRange",
                    f"Requests.RateLimits list too large; max size is '{max_lanes}'",
                )
            n = len(cols)
            result = ColumnarResult.empty(n)
            if n == 0:
                callback(result, None)
                return
            if n == 1 or not self.store.supports_columns:
                if n == 1 and self._try_single_async(cols, callback):
                    return
                # The dataclass router blocks: run it on the slow pool.
                fut = self._slow_pool.submit(self.get_rate_limits_columns, cols)
                _attach_done(fut, partial(_deliver_future, callback))
                return
            plan = self._submit_columns(cols, result)
        except Exception as e:  # noqa: BLE001 — handed to the callback
            callback(None, e)
            return
        if plan is None:
            callback(result, None)
            return
        _ColumnsJoin(self, plan, result, callback).start()

    def _try_single_async(self, cols: IngressColumns, callback) -> bool:
        """Completion of one async lane without a parked thread on a
        node that owns every key: the same _submit_single_local rider
        the sync path uses, completed by the drainer (columnar) or the
        LocalBatcher's flush (dataclass).  Returns False to decline
        (other rings, validation wording, a GLOBAL NO_BATCHING lane),
        leaving it to the sync router."""
        if not self.store.supports_columns:
            return False
        with self._peer_mutex:
            # This node must own every key: no ring (a service never
            # given one), or a ring of this node alone.  Other rings
            # take the sync router, which forwards.
            if self.local_picker.size() > 1:
                return False
            if self.local_picker.size() == 0 and not self._ringless:
                return False
            if self.local_picker.size() == 1:
                (only,) = self.local_picker.peers()
                if not only.info.is_owner:
                    return False
        r = cols.request_at(0)
        if not r.unique_key or not r.name:
            return False
        if has_behavior(r.behavior, Behavior.GLOBAL) and has_behavior(r.behavior, Behavior.NO_BATCHING):
            # Sync parity: this shape takes store.apply with no window.
            return False
        result = ColumnarResult.empty(1)

        def deliver_resp(resp: RateLimitResponse) -> None:
            if resp.status == 1 and not resp.error:
                self.tenants.fold_outcome_responses([r.name], [resp])
            result.overrides[0] = resp
            callback(result, None)

        def to_error(e: BaseException) -> RateLimitResponse:
            return RateLimitResponse(error=f"while applying rate limit '{r.hash_key()}' - '{e}'")

        if has_behavior(r.behavior, Behavior.MULTI_REGION):
            self.multi_region_mgr.queue_hits(r)
        # This lane bypasses both router funnels: note it here.
        audit_mod.note("ingress_hits", int(r.hits))
        self.tenants.fold_one(
            r.name, int(r.hits),
            len(r.name) + len(r.unique_key) + profiling.NUMERIC_LANE_BYTES)

        try:
            w = self._submit_single_local(
                r, direct=has_behavior(r.behavior, Behavior.NO_BATCHING))
        except Exception as e:  # noqa: BLE001 — per-lane error, as the sync router
            deliver_resp(to_error(e))
            return True
        if isinstance(w, _SingleLaneWait):
            drainer = self._get_drainer()

            def on_out(lo, out, exc):
                deliver_resp(to_error(exc) if exc is not None else _lane_response(out, lo))

            def on_dispatched(fut):
                try:
                    handle, lo, _hi = fut.result()
                except Exception as e:  # noqa: BLE001 — per-lane error
                    deliver_resp(to_error(e))
                    return
                drainer.register(handle, partial(on_out, lo))

            _attach_done(w._fut, on_dispatched)
        else:
            # LocalBatcher future (GLOBAL lane) or a resolved Gregorian
            # error: resolves on the flush thread; delivered once,
            # outside the try.
            def on_done(fut):
                try:
                    resp = fut.result()
                except Exception as e:  # noqa: BLE001 — per-lane error
                    resp = to_error(e)
                deliver_resp(resp)

            _attach_done(w, on_done)
        return True

    # ------------------------------------------------------------------
    # The owner side of the peer API (PeersV1)
    # ------------------------------------------------------------------
    def get_peer_rate_limits(self, req: GetRateLimitsRequest) -> GetRateLimitsResponse:
        """Owner-authoritative batch (gubernator.go:275-292); never
        re-forwards."""
        if len(req.requests) > MAX_BATCH_SIZE:
            raise ApiError(
                "OutOfRange",
                f"'PeerRequest.rate_limits' list too large; max size is '{MAX_BATCH_SIZE}'",
            )
        audit_mod.note("peer_ingress_hits", sum(int(r.hits) for r in req.requests))
        tenant_names = self.tenants.fold_requests(list(req.requests))
        resps = self.store.apply(list(req.requests), self.clock.now_ms())
        for r in req.requests:
            if has_behavior(r.behavior, Behavior.MULTI_REGION):
                self.multi_region_mgr.queue_hits(r)
        self.tenants.fold_outcome_responses(tenant_names, resps)
        return GetRateLimitsResponse(responses=resps)

    def get_peer_rate_limits_columns(
        self, cols: IngressColumns, max_lanes: int = MAX_BATCH_SIZE
    ) -> ColumnarResult:
        """Column-form PeersV1 receive: every lane is owned here (the
        sender routed it), so non-GLOBAL lanes go straight to the
        columnar kernel through the shared window, where concurrent
        peers' batches merge into one launch; GLOBAL lanes take the
        dataclass path.  `max_lanes` is the encoding's cap
        (PEER_COLUMNS_MAX_LANES for a frame)."""
        n = len(cols)
        if n > max_lanes:
            raise ApiError(
                "OutOfRange",
                f"'PeerRequest.rate_limits' list too large; max size is '{max_lanes}'",
            )
        result = ColumnarResult.empty(n)
        if n == 0:
            return result
        if not self.store.supports_columns:
            req = GetRateLimitsRequest(requests=[cols.request_at(i) for i in range(n)])
            result.overrides = dict(enumerate(self.get_peer_rate_limits(req).responses))
            return result
        audit_mod.note("peer_ingress_hits", int(cols.hits.sum()))
        return self._finalize_columns(self._submit_peer_columns(cols, result), result)

    def _submit_peer_columns(self, cols, result) -> _ColumnsPlan:
        """Phase 1 of the PeersV1 columnar receive (shared by the sync
        and async entry points).  A frame-decoded batch hands its hash
        keys over packed: the sender's ingress validated them."""
        tenant_ctx = self.tenants.fold_admit(cols)
        beh = np.asarray(cols.behavior, dtype=np.int32)
        slow = (beh & int(Behavior.GLOBAL)) != 0
        fast = np.logical_not(slow)
        pre = getattr(cols, "prevalidated", None)
        if pre is not None:
            hash_keys, _errc = pre
        else:
            hash_keys = [f"{nm}_{uk}" for nm, uk in zip(cols.names, cols.unique_keys)]
        # MULTI_REGION queueing covers every lane here (the reference
        # queues after applying each forwarded request,
        # gubernator.go:340-341), GLOBAL+MULTI_REGION lanes too.
        self._queue_mr_fast(cols, beh, np.ones(len(cols), dtype=bool), hash_keys)
        pendings = self._dispatch_fast(cols, beh, fast, hash_keys, result)
        slow_idx = [int(i) for i in np.nonzero(slow)[0]]
        slow_reqs = [cols.request_at(i) for i in slow_idx]
        return _ColumnsPlan(
            pendings=pendings,
            slow_idx=slow_idx,
            slow_fn=((lambda: self.store.apply(slow_reqs, self.clock.now_ms()))
                     if slow_idx else None),
            hash_keys=hash_keys,
            tenant_ctx=tenant_ctx,
        )

    def get_peer_rate_limits_columns_async(self, cols: IngressColumns, callback: Callable,
                                           max_lanes: int = MAX_BATCH_SIZE) -> None:
        """Async twin of get_peer_rate_limits_columns (the other
        launch-bound endpoint a native-edge worker must not block on)."""
        try:
            if len(cols) > max_lanes:
                raise ApiError(
                    "OutOfRange",
                    f"'PeerRequest.rate_limits' list too large; max size is '{max_lanes}'",
                )
            n = len(cols)
            result = ColumnarResult.empty(n)
            if n == 0:
                callback(result, None)
                return
            if not self.store.supports_columns:
                fut = self._slow_pool.submit(self.get_peer_rate_limits_columns, cols)
                _attach_done(fut, partial(_deliver_future, callback))
                return
            audit_mod.note("peer_ingress_hits", int(cols.hits.sum()))
            plan = self._submit_peer_columns(cols, result)
        except Exception as e:  # noqa: BLE001 — handed to the callback
            callback(None, e)
            return
        _ColumnsJoin(self, plan, result, callback).start()

    def update_peer_globals(self, updates: Sequence[UpdatePeerGlobal]) -> None:
        """gubernator.go:259-272.  With the columnar GLOBAL plane on,
        even a classic (per-item) broadcast commits as ONE batched
        replica commit; GUBER_GLOBAL_COLUMNS=0 keeps one commit an
        item."""
        now = self.clock.now_ms()
        if updates and self.serves_global_columns:
            self.store.set_replica_batch(GlobalsColumns.from_updates(list(updates)), now)
            return
        for u in updates:
            self.store.set_replica(u, now)

    def update_peer_globals_columns(self, cols: GlobalsColumns) -> None:
        """Columnar receive of a GLOBAL broadcast: one batched replica
        commit (one K6 launch where gslots recycle, then K5), capped
        like the peer hop."""
        if len(cols) > PEER_COLUMNS_MAX_LANES:
            raise ApiError(
                "OutOfRange",
                f"'UpdatePeerGlobals' columns list too large; "
                f"max size is '{PEER_COLUMNS_MAX_LANES}'",
            )
        now = self.clock.now_ms()
        batch = getattr(self.store, "set_replica_batch", None)
        if batch is not None:
            batch(cols, now)
            return
        for u in cols.to_updates():
            self.store.set_replica(u, now)

    def update_region_columns(self, cols) -> int:
        """The receive side of the federation plane: one cross-region
        hit batch (RegionColumnsReq or the GUBC region frame) applied
        here through the same columnar receive a classic per-item
        GetPeerRateLimits send lands in, so both encodings behave alike
        and only the wire differs (on the card: K1, or K2 for many
        configs).

        The sender stripped MULTI_REGION (applying must not queue the
        hits toward other regions again); any lane still flagged is
        stripped here too, since an echo loop between two regions is
        worse than one misbehaving sender.  Ledger (audit.py): the
        batch's hits note `region_recv_hits`, the lanes that applied
        without error `region_applied_hits`.  Returns the applied lane
        count."""
        n = len(cols)
        if n > PEER_COLUMNS_MAX_LANES:
            raise ApiError(
                "OutOfRange",
                f"'UpdateRegionColumns' columns list too large; "
                f"max size is '{PEER_COLUMNS_MAX_LANES}'",
            )
        if n == 0:
            return 0
        hits = np.asarray(cols.hits, dtype=np.int64)
        audit_mod.note("region_recv_hits", int(hits.sum()))
        beh = np.asarray(cols.behavior, dtype=np.int32)
        mr = int(Behavior.MULTI_REGION)
        if bool((beh & mr).any()):
            beh = beh & ~np.int32(mr)
        ic = IngressColumns(
            names=list(cols.names),
            unique_keys=list(cols.unique_keys),
            algorithm=np.asarray(cols.algorithm, dtype=np.int32),
            behavior=beh,
            hits=hits,
            limit=np.asarray(cols.limit, dtype=np.int64),
            duration=np.asarray(cols.duration, dtype=np.int64),
        )
        result = self.get_peer_rate_limits_columns(ic, max_lanes=PEER_COLUMNS_MAX_LANES)
        errored = [i for i, r in result.overrides.items() if getattr(r, "error", "")]
        applied = n - len(errored)
        applied_hits = int(hits.sum()) - sum(int(hits[i]) for i in errored)
        if applied_hits > 0:
            audit_mod.note("region_applied_hits", applied_hits)
        return applied

    def transfer_ownership(self, cols: TransferColumns) -> "tuple[int, int]":
        """Receive side of an ownership transfer (reshard.py): fence the
        epoch, drop the lanes this node does not own under its current
        ring, then merge-commit the rest with one row gather (K7) and
        one row write (K8).  Returns (committed, rejected)."""
        n = len(cols)
        if n > PEER_COLUMNS_MAX_LANES:
            raise ApiError(
                "OutOfRange",
                f"'TransferOwnership' columns list too large; "
                f"max size is '{PEER_COLUMNS_MAX_LANES}'",
            )
        if n == 0:
            return 0, 0
        audit_mod.note("reshard_received_lanes", n)
        with self._peer_mutex:
            cur_hash = self.ring_hash
            picker = self.local_picker
            psize = picker.size()
        if cols.ring_hash and cur_hash and cols.ring_hash != cur_hash:
            # Epoch fence: the batch was routed under a ring this node no
            # longer runs; the sender sees a non-retryable answer.
            self.reshard.note_fenced(n)
            raise ApiError(
                "FailedPrecondition",
                f"transfer fenced: batch ring {cols.ring_hash:#018x} != "
                f"current ring {cur_hash:#018x}",
                http_status=409,
            )
        keep = np.arange(n)
        if psize > 1:
            codes, code_ids = picker.get_batch_codes(cols.keys)
            own = np.zeros(len(code_ids), dtype=bool)
            for c, pid in enumerate(code_ids):
                peer = picker.get_by_peer_id(pid)
                own[c] = peer is not None and peer.info.is_owner
            keep = np.nonzero(own[codes])[0]
        elif psize == 1:
            (only,) = picker.peers()
            if not only.info.is_owner:
                keep = np.zeros(0, dtype=np.int64)
        committed = 0
        if keep.size:
            sub = cols if keep.size == n else cols.subset(keep)
            committed = self.store.commit_transfer(sub, self.clock.now_ms())
        rejected = n - int(keep.size)
        self.reshard.note_received(committed, rejected)
        return committed, rejected

    # ------------------------------------------------------------------
    def health_check(self) -> HealthCheckResponse:
        """gubernator.go:295-333: unhealthy while any peer client holds
        a recent error (its message joins the peers' errors), with the
        count of open breakers.  A service never given a ring counts
        itself as its one peer."""
        from . import __version__

        errs: List[str] = []
        breaker_open = 0
        with self._peer_mutex:
            for peer in list(self.local_picker.peers()) + list(self.region_picker.peers()):
                errs.extend(peer.get_last_err())
                if peer.breaker.is_open:
                    breaker_open += 1
            self._health.status = UNHEALTHY if errs else HEALTHY
            self._health.message = "|".join(errs)
            self._health.peer_count = self.local_picker.size() or int(self._ringless)
            self._health.breaker_open_count = breaker_open
            return HealthCheckResponse(
                status=self._health.status,
                message=self._health.message,
                peer_count=self._health.peer_count,
                breaker_open_count=self._health.breaker_open_count,
                version=__version__,
            )

    def ingress_queued_lanes(self) -> int:
        """Lanes admitted into the bounded ingress gates (both batchers
        share the GUBER_INGRESS_QUEUE_LANES budget, counted apart)."""
        return self.local_batcher._gate.queued + self.columnar_batcher._gate.queued

    _BREAKER_NAMES = {0: "closed", 1: "half-open", 2: "open"}

    def debug_status(self) -> dict:
        """GET /debug/status: health, peers, table occupancy, ingress
        queue, pipeline depth, SLO burn, express lane, hot keys, tenants,
        profiler, ring and resharding counters, audit, device telemetry
        snapshots and the federation plane's `region` section.
        Host-side state only: no launch.  The `blackbox` section is
        what scripts/cluster_status.py's blackbox column reads."""
        from . import __version__

        hc = self.health_check()
        with self._peer_mutex:
            peer_list = list(self.local_picker.peers()) + list(self.region_picker.peers())
            region_rings = {dc: list(ring.peers())
                            for dc, ring in self.region_picker.regions.items()}
            handoff_active = self._handoff_prev_picker() is not None
            ring = {
                "generation": self.ring_generation,
                "hash": format(self.ring_hash, "016x"),
                "handoffActive": handoff_active,
                "handoffRemainingS": (
                    round(max(self._handoff_deadline - time.monotonic(), 0.0), 3)
                    if handoff_active else 0.0),
                "reshardEnabled": self.serves_reshard,
            }
        peers = [{"peer": p.info.grpc_address, "isOwner": bool(p.info.is_owner),
                  "breaker": self._BREAKER_NAMES.get(p.breaker.state_code, "closed")}
                 for p in peer_list]
        store = self.store
        shards = store.occupancy_stats()
        used_total = sum(r["used"] for r in shards)
        cap_total = sum(r["capacity"] for r in shards)
        b = self.conf.behaviors
        return {
            "version": __version__,
            "uptimeS": round(time.monotonic() - self._started_monotonic, 1),
            "health": {"status": hc.status, "message": hc.message,
                       "peerCount": hc.peer_count,
                       "breakerOpenCount": hc.breaker_open_count},
            "peers": peers,
            "occupancy": {
                "used": used_total,
                "capacity": cap_total,
                "evictions": sum(r["evictions"] for r in shards),
                "ratio": round(used_total / cap_total, 4) if cap_total else 0.0,
                "shards": shards,
            },
            "ingress": {
                "queuedLanes": self.ingress_queued_lanes(),
                "capLanes": b.ingress_queue_lanes,
                "shedLanes": int(self.metrics.ingress_shed._value.get()),  # noqa: SLF001
                "depth": saturation.queue_depth_snapshot(),
                "windowWaitS": round(self.columnar_batcher._window.effective_wait_s(), 6),
            },
            "dispatch": {
                "inflight": int(store.pipeline_depth()),
                "deviceDispatches": int(store.device_dispatches),
            },
            "slo": self.slo.snapshot(),
            "express": {
                "enabled": bool(b.express),
                "queueDepth": int(b.express_queue_depth),
                "maxLanes": int(b.express_max_lanes),
                "scalarApplies": int(store.scalar_applies),
                **saturation.express_snapshot(),
            },
            "hotkeys": self.hotkeys.snapshot()["topk"][:5],
            "tenants": self.tenants.snapshot(top=5),
            "profile": {
                "enabled": profiling.enabled(),
                "hz": profiling.hz(),
                "samples": profiling.sample_count(),
            },
            "ring": {**ring, "reshard": self.reshard.snapshot()},
            "audit": {
                "enabled": self.auditor.enabled,
                "checks": self.auditor.checks,
                "violations": dict(self.auditor.violations),
                "violationTotal": sum(self.auditor.violations.values()),
            },
            # The JAX key: builds and first launches stand for compiles.
            "xla": {
                "enabled": telemetry.enabled(),
                "compiles": telemetry.compile_count(),
                "steadyRecompiles": telemetry.steady_recompile_count(),
            },
            "snapshot": self.snapshots.snapshot(),
            # Incident black box: ring fill, bundle counts, last-trigger
            # age.
            "blackbox": self.blackbox.snapshot(),
            # The federation plane: this node's data center, the
            # accumulator and carry, and each other region's peers and
            # open breakers.
            "region": {
                **self.multi_region_mgr.snapshot(),
                "regions": {
                    dc: {"peers": len(plist),
                         "breakerOpen": sum(1 for p in plist if p.breaker.is_open)}
                    for dc, plist in region_rings.items()
                },
            },
        }

    def close(self) -> None:
        """Stop the windows (each flushes what it holds), resolve every
        registered handle, stop the GLOBAL sync, the region flushes and
        the membership pool, resolve every in-flight batch, then (in the
        JAX service's order) stop the snapshot cadence, write the
        shutdown snapshot, hand the Loader every item and shut the peer
        clients down."""
        if self._closed:
            return
        self._closed = True
        # The native ingress pump first: its in-flight launches resolve
        # against a live store, and its queued frames get their 503s.
        pump = self.native_ingress
        if pump is not None:
            pump.stop()
        self.local_batcher.stop()
        self.columnar_batcher.stop()
        with self._drainer_lock:
            drainer = self._drainer
        if drainer is not None:
            drainer.stop()
        if self.global_mgr is not None:
            self.global_mgr.stop()
        self.multi_region_mgr.stop()
        self.auditor.stop()
        # The membership pool before the peers and the store: an
        # in-flight handoff or dropped-peer shutdown finishes (or
        # aborts) rather than race the teardown below.
        self.reshard.close(timeout_s=5.0)
        self._forward_pool.shutdown(wait=False)
        self._slow_pool.shutdown(wait=False)
        self.store._drain_all()
        self.snapshots.stop()
        self.snapshots.save_now("close")
        # The black box after the final snapshot (still capturable
        # evidence); the default recorder's hook goes first, or a closed
        # service would write bundles on other nodes' triggers.
        try:
            tracing.default_recorder().dump_hooks.remove(self.blackbox.on_trigger)
        except ValueError:
            pass
        self.blackbox.close()
        if self.conf.loader is not None:
            self.conf.loader.save(self.store.snapshot_items())
        for peer in self.get_peer_list() + list(self.region_picker.peers()):
            peer.shutdown(timeout_s=1.0)


class GlobalManager:
    """Host-tier GLOBAL pipelines (global.go:32-243) on top of the
    device-tier sync: every GlobalSyncWait, run the store's sync
    (ops/global_ops.py global_sync on the device, K4); fan out the resulting owner broadcasts (UpdatePeerGlobals) to
    every peer daemon and forward aggregated hits for remotely-owned
    keys (GetPeerRateLimits) to their owner daemons.

    Both legs are COLUMNAR and CONCURRENT (architecture.md "GLOBAL
    plane"): the sync emits column batches, the broadcast is encoded
    once (wire.BroadcastBatch) and fanned to all peers through a
    bounded pool — tick wall-time stops scaling as peers x RTT — and
    aggregated hits ride the columnar GetPeerRateLimits path as
    per-owner sub-batches.  Hits whose send provably never applied
    (unroutable owner, breaker fast-fail, connection-level not-ready)
    requeue into the next tick instead of being dropped."""

    # Requeue-carry bound (distinct keys): hits for a peer that stays
    # down accumulate here between ticks; past the cap new keys drop
    # (counted in gubernator_global_dropped_hits) — matching the
    # reference's bounded-loss posture under prolonged partition.
    HIT_CARRY_MAX = 16_384

    # Auto-sizing policy: one sync pass should cost <= 10% of its
    # window, clamped to [5 ms, 1 s]; the estimator is the minimum over
    # the last SYNC_COST_SAMPLES work ticks (a sync's true cost is its
    # least-contended run; an average lets one outlier pin the window).
    SYNC_OVERHEAD_TARGET = 0.1
    SYNC_WAIT_MIN_S = 0.005
    SYNC_WAIT_MAX_S = 1.0
    SYNC_WAIT_FALLBACK_S = 0.1
    SYNC_COST_SAMPLES = 8

    @classmethod
    def window_for_cost(cls, cost_s: float) -> float:
        """The sync window this policy derives from a measured per-sync
        cost (single source of truth for the service, the bench suite,
        and the tests)."""
        return min(
            max(cost_s / cls.SYNC_OVERHEAD_TARGET, cls.SYNC_WAIT_MIN_S),
            cls.SYNC_WAIT_MAX_S,
        )

    def __init__(self, service: V1Service):
        self.service = service
        self._stopped = False
        configured = service.conf.behaviors.global_sync_wait_s
        self._auto = configured is None
        self.sync_wait_s = (
            self.SYNC_WAIT_FALLBACK_S if configured is None else configured
        )
        self.measured_sync_cost_s: Optional[float] = None
        self._sync_cost_samples: "deque[float]" = deque(
            maxlen=self.SYNC_COST_SAMPLES
        )
        self._last_sync_cost_s: Optional[float] = None
        # Requeued hit lanes awaiting the next tick: hash_key ->
        # [name, unique_key, algorithm, behavior, hits, limit,
        # duration], hits summed on merge.  Tick-thread-only state (the
        # Interval serializes run_once), so no lock.
        self._hit_carry: Dict[str, list] = {}
        # Bounded fan-out pool, created on first use (idle daemons and
        # non-GLOBAL deployments spawn no threads).
        self._fanout_pool: "Optional[ThreadPoolExecutor]" = None
        self._interval = Interval(self.sync_wait_s, self._tick)
        self._interval.next()

    def _tick(self) -> None:
        try:
            did_work = self.run_once()
            if did_work and self._auto and self._last_sync_cost_s is not None:
                self._observe_sync_cost(self._last_sync_cost_s)
        except Exception:  # noqa: BLE001 — logged; the next tick retries
            logger.exception("GLOBAL sync failed")
        finally:
            if not self._stopped:
                self._interval.next()

    def _observe_sync_cost(self, cost_s: float) -> None:
        self._sync_cost_samples.append(cost_s)
        self.measured_sync_cost_s = min(self._sync_cost_samples)
        self.sync_wait_s = self.window_for_cost(self.measured_sync_cost_s)
        self._interval.duration_s = self.sync_wait_s

    def run_once(self) -> bool:
        """One sync pass; returns whether the sync produced host-tier
        work (the auto-tuner's signal that GLOBAL is in real use).

        Only the store sync (device collective + decode) counts as
        "sync cost" for window sizing — the peer fan-out legs below are
        dominated by network timeouts under failure, and a dead peer
        must not inflate the window for every healthy peer."""
        svc = self.service
        t0 = time.perf_counter()
        t0_ns = time.monotonic_ns()
        res = svc.store.sync_globals(svc.clock.now_ms())
        # The store reports the in-lock cost of the pass (kernel +
        # decode/commit).  The wall time around the call also holds the
        # drain-then-lock wait, serving backpressure rather than sync
        # cost, which under load would inflate the auto window.  Fall
        # back to wall time only for stores that don't report.
        cost = getattr(svc.store, "last_sync_cost_s", None)
        self._last_sync_cost_s = (
            cost if cost is not None else (time.perf_counter() - t0)
        )
        did_work = bool(res.broadcast_cols or res.remote_hit_cols)
        if res.remote_hit_cols is not None and len(res.remote_hit_cols):
            # Conservation ledger (audit.py): GLOBAL hits AGGREGATED by
            # this tick's collective — new lanes only, BEFORE the carry
            # merge below (requeued lanes were counted the tick they
            # first aggregated; counting them again would mask a
            # double-send).
            audit_mod.note(
                "global_agg_hits", int(res.remote_hit_cols.hits.sum())
            )
        # global.sync batch trace per WORK tick: child
        # spans for the collective and the two fan-out legs, with the
        # per-peer peer.rpc client spans span-linked to the tick's ctx.
        tick = (
            tracing.BatchTrace(())
            if (did_work or self._hit_carry) and tracing.sampled()
            else None
        )
        tracing.batch_span(
            "global.collective", tick, t0_ns, time.monotonic_ns(),
            broadcasts=res.broadcast_count,
            hit_lanes=(
                0 if res.remote_hit_cols is None else len(res.remote_hit_cols)
            ),
        )
        hit_cols = self._take_carry_merged(res.remote_hit_cols)
        if hit_cols is not None and len(hit_cols):
            self._forward_hits(hit_cols, tick)
        if res.broadcast_cols is not None and len(res.broadcast_cols):
            self._broadcast(res.broadcast_cols, tick)
        if tick is not None:
            tracing.record_span(
                "global.sync", tick.ctx,
                start_ns=t0_ns, end_ns=time.monotonic_ns(),
                broadcasts=res.broadcast_count,
            )
        return did_work

    # ------------------------------------------------------------------
    def _get_fanout_pool(self) -> "ThreadPoolExecutor":
        # Tick-thread-only (like _hit_carry): no lock needed.
        if self._fanout_pool is None:
            self._fanout_pool = ThreadPoolExecutor(
                max_workers=max(
                    1, getattr(self.service.conf.behaviors, "global_fanout", 8)
                ),
                thread_name_prefix="global-fanout",
            )
        return self._fanout_pool

    def _broadcast(self, bcols, tick) -> None:
        """Encode the sync pass's broadcasts ONCE (wire.BroadcastBatch
        caches every encoding) and fan them out to all peers
        CONCURRENTLY through the bounded pool.  Per-peer breaker /
        backoff semantics ride unchanged inside each send
        (service._peer_send -> PeerClient._guarded_call); a peer that
        exhausts its budget triggers the flight-recorder dump path."""
        svc = self.service
        peers = [
            p for p in svc.get_peer_list()
            if not p.info.is_owner  # exclude ourselves (global.go:223-226)
        ]
        if not peers:
            return
        t0 = time.perf_counter()
        t0_ns = time.monotonic_ns()
        # Chunk at the receive-side lane cap (a full 65536-gslot table
        # going dirty in one tick outsizes one RPC); each chunk is
        # still ONE encoded batch shared by every peer.
        batches = [
            wire.BroadcastBatch(bcols.slice(lo, lo + PEER_COLUMNS_MAX_LANES))
            for lo in range(0, len(bcols), PEER_COLUMNS_MAX_LANES)
        ]
        pool = self._get_fanout_pool()
        svc.metrics.global_fanout_concurrency.set(
            min(len(peers), getattr(svc.conf.behaviors, "global_fanout", 8))
        )
        ctx = tick.ctx if tick is not None else None
        timeout = svc.conf.behaviors.global_timeout_s

        def send_all(peer) -> bool:
            ok = True
            for batch in batches:
                ok = svc._peer_send(
                    "global_broadcast",
                    partial(
                        peer.update_peer_globals_batch, batch,
                        timeout_s=timeout, trace_ctx=ctx,
                    ),
                ) and ok
            return ok

        futs = [(peer, pool.submit(send_all, peer)) for peer in peers]
        for peer, fut in futs:
            if not fut.result():
                # Flight-recorder dump (tracing._DUMP_KINDS): a peer
                # that missed a broadcast serves stale replicas until
                # the next successful tick — preserve the context.
                tracing.record_event(
                    "global-send-failed", op="global_broadcast",
                    peer=peer.info.grpc_address, items=len(bcols),
                )
        svc.metrics.broadcast_durations.observe(time.perf_counter() - t0)
        tracing.batch_span(
            "global.broadcast", tick, t0_ns, time.monotonic_ns(),
            items=len(bcols), peers=len(peers),
        )

    def _forward_hits(self, cols: "HitColumns", tick) -> None:
        """Forward aggregated hits to their remote owners as columnar
        sub-batches over the existing GetPeerRateLimits columnar path
        (sendHits, global.go:120-160), one concurrent send per owner.
        BUGFIX vs the pre-columns sender: an unroutable owner (pool
        churn mid-tick) or a provably-unapplied send failure requeues
        the lanes into the next tick instead of silently dropping
        them."""
        svc = self.service
        t0 = time.perf_counter()
        t0_ns = time.monotonic_ns()
        by_owner: Dict[str, list] = {}
        clients: Dict[str, PeerClient] = {}
        requeue: list = []
        for i in range(len(cols)):
            try:
                peer = svc.get_peer(cols.hash_key_at(i))
            except PeerError:
                requeue.append(i)
                continue
            addr = peer.info.grpc_address
            by_owner.setdefault(addr, []).append(i)
            clients[addr] = peer
        pool = self._get_fanout_pool()
        ctx = tick.ctx if tick is not None else None
        futs = {
            addr: pool.submit(
                self._send_hits, clients[addr], cols.subset(lanes), ctx
            )
            for addr, lanes in by_owner.items()
        }
        dropped = 0
        for addr, fut in futs.items():
            rq_rel, dr = fut.result()
            lanes = by_owner[addr]
            requeue.extend(lanes[j] for j in rq_rel)
            dropped += dr
            if rq_rel or dr:
                tracing.record_event(
                    "global-send-failed", op="global_hits", peer=addr,
                    requeued=len(rq_rel), dropped=dr,
                )
        if requeue:
            self._requeue_hits(cols, requeue)
        if dropped:
            svc.metrics.global_dropped_hits.inc(dropped)
        # Carry size is the documented GLOBAL bounded-loss slack; the
        # audit's global_slack invariant checks it against HIT_CARRY_MAX.
        audit_mod.set_gauge(audit_mod.GLOBAL_CARRY_GAUGE, len(self._hit_carry))
        svc.metrics.async_durations.observe(time.perf_counter() - t0)
        tracing.batch_span(
            "global.hits", tick, t0_ns, time.monotonic_ns(),
            lanes=len(cols), owners=len(by_owner),
        )

    def _send_hits(self, peer: PeerClient, sub: "HitColumns", ctx):
        """Send one owner's hit columns, chunked at the columnar lane
        cap (the client re-chunks classic-negotiated sends itself).
        Returns (lanes to requeue, lanes dropped): a chunk whose
        failure provably never applied — breaker fast-fail or a
        connection-level not-ready error — requeues; a timeout-shaped
        failure may have applied server-side, so requeueing would
        double-count and the chunk drops (counted)."""
        svc = self.service
        n = len(sub)
        pc = sub.peer_columns()
        timeout = svc.conf.behaviors.global_timeout_s
        requeue: list = []
        dropped = 0
        for lo in range(0, n, PEER_COLUMNS_MAX_LANES):
            hi = min(lo + PEER_COLUMNS_MAX_LANES, n)
            chunk = wire.peer_columns_slice(pc, lo, hi)
            t0_ns = time.monotonic_ns()
            ok, err = svc._peer_send_ex(
                "global_hits",
                partial(
                    peer.send_columns_direct, chunk,
                    timeout_s=timeout, trace_ctx=ctx,
                ),
            )
            if ctx is not None:
                bt = tracing.new_batch([ctx])
                if bt is not None:
                    attrs = dict(
                        peer=peer.info.grpc_address,
                        op="GetPeerRateLimits", leg="global_hits",
                        lanes=hi - lo,
                    )
                    if not ok:
                        attrs["error"] = str(err)
                    tracing.record_span(
                        "peer.rpc", bt.ctx,
                        start_ns=t0_ns, end_ns=time.monotonic_ns(),
                        links=bt.links, **attrs,
                    )
            chunk_hits = int(sub.hits[lo:hi].sum())
            if ok:
                # Conservation ledger: GLOBAL hits DELIVERED owner-ward
                # (sent + dropped must stay <= aggregated).
                audit_mod.note("global_sent_hits", chunk_hits)
                continue
            if is_circuit_open(err) or is_not_ready(err):
                requeue.extend(range(lo, hi))
            else:
                audit_mod.note("global_dropped_hits", chunk_hits)
                dropped += hi - lo
        return requeue, dropped

    def _requeue_hits(self, cols: "HitColumns", lanes) -> None:
        """Fold failed lanes into the carry (hits summed per key),
        bounded at HIT_CARRY_MAX distinct keys."""
        carry = self._hit_carry
        dropped = 0
        for i in lanes:
            hk = cols.hash_key_at(i)
            cur = carry.get(hk)
            if cur is not None:
                cur[4] += int(cols.hits[i])
                continue
            if len(carry) >= self.HIT_CARRY_MAX:
                dropped += 1
                audit_mod.note("global_dropped_hits", int(cols.hits[i]))
                continue
            carry[hk] = [
                cols.names[i], cols.unique_keys[i],
                int(cols.algorithm[i]), int(cols.behavior[i]),
                int(cols.hits[i]), int(cols.limit[i]),
                int(cols.duration[i]),
            ]
        requeued = len(lanes) - dropped
        if requeued:
            self.service.metrics.global_requeued_hits.inc(requeued)
        if dropped:
            self.service.metrics.global_dropped_hits.inc(dropped)

    def _take_carry_merged(
        self, new_cols: "Optional[HitColumns]"
    ) -> "Optional[HitColumns]":
        """Previous ticks' requeued hits merged with this tick's
        accumulator output: hits sum per key, config fields take the
        newest lane (last-writer-wins, like the gtable mirror)."""
        if not self._hit_carry:
            return new_cols
        carry, self._hit_carry = self._hit_carry, {}
        if new_cols is not None:
            for i in range(len(new_cols)):
                hk = new_cols.hash_key_at(i)
                cur = carry.get(hk)
                if cur is None:
                    carry[hk] = [
                        new_cols.names[i], new_cols.unique_keys[i],
                        int(new_cols.algorithm[i]), int(new_cols.behavior[i]),
                        int(new_cols.hits[i]), int(new_cols.limit[i]),
                        int(new_cols.duration[i]),
                    ]
                else:
                    cur[2] = int(new_cols.algorithm[i])
                    cur[3] = int(new_cols.behavior[i])
                    cur[4] += int(new_cols.hits[i])
                    cur[5] = int(new_cols.limit[i])
                    cur[6] = int(new_cols.duration[i])
        vals = list(carry.values())
        n = len(vals)
        return HitColumns(
            names=[v[0] for v in vals],
            unique_keys=[v[1] for v in vals],
            algorithm=np.fromiter((v[2] for v in vals), np.int32, count=n),
            behavior=np.fromiter((v[3] for v in vals), np.int32, count=n),
            hits=np.fromiter((v[4] for v in vals), np.int64, count=n),
            limit=np.fromiter((v[5] for v in vals), np.int64, count=n),
            duration=np.fromiter((v[6] for v in vals), np.int64, count=n),
        )

    def stop(self) -> None:
        self._stopped = True
        self._interval.stop()
        if self._fanout_pool is not None:
            self._fanout_pool.shutdown(wait=False)
