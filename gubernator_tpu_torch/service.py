"""V1Service — the service core of one node (reference V1Instance,
gubernator.go), on the port's columnar path.

The port of the JAX package's service.py for a single node that owns
every key: the serving tier of one daemon without peers.  Every local
evaluation goes through the JAX service's coalescing windows: a
`ColumnarBatcher` merges concurrent column submissions inside one
BatchWait window into one store launch (each caller reads its slice of
the shared handle), a `LocalBatcher` does the same for single GLOBAL
lanes on the dataclass path, NO_BATCHING lanes dispatch at once, and
under the express lane (GUBER_EXPRESS) small submissions to a shallow
queue skip the window.  The ingress gate bounds the lanes queued in
both windows (GUBER_INGRESS_QUEUE_LANES) and sheds past it.
`get_rate_limits_columns_async` submits on the caller's thread and
calls back from a drainer thread once the launch's readback is in.

GLOBAL lanes take the store's dataclass path (`apply`) and a
GlobalManager syncs them on an interval.  The store is a
MeshBucketStore built from the sizes, or the one given as
`ServiceConfig.store` (a ShardStore for a one-shard deployment, which
answers GLOBAL lanes as local ones and has no GLOBAL sync; the service
then runs no GlobalManager).  With a Store SPI (`persist_store`) every
lane takes the dataclass path, as the store's callbacks need.
Persistence: a Loader (`loader`) is loaded at boot and saved at close;
a snapshot file (`snapshot_path`) is restored at boot and written at
close and every `behaviors.snapshot_interval_s` (snapshot.py).

Membership is one node: `set_peers` takes a list naming this node
alone (its ring fingerprint fences transfers; a list naming any other
peer raises NotImplementedError until the peer client is ported).  A
service that was never given a list owns every key too.  The owner
side of the peer API is here: `get_peer_rate_limits[_columns][_async]`
(lanes owned here go to the columnar kernel through the shared
window), `update_peer_globals[_columns]` (one batched replica commit)
and `transfer_ownership` (the epoch fence, then one merge-commit).
The gateway (gateway.py) reads the members built here: the flight
recorder, the SLO engine, the hot-key sketch, the tenant ledger, the
conservation auditor and the native ingress pump's hook.  `metrics` is
the config's `Metrics` or a new one (metrics.py), never None: the
gateway's /metrics route and the gRPC interceptor read it, and the SLO
engine gets its latency samples through it.

Not here (they need peers): forwarding, the handoff peek, MULTI_REGION,
the sending half of resharding, and the GlobalManager's broadcast and
hit-forward legs.  Responses are the JAX V1Service's
(tests/test_torch_service.py, tests/test_torch_batchers.py,
tests/test_torch_gateway.py).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from functools import partial
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence

import numpy as np

from . import audit as audit_mod
from . import profiling
from . import saturation
from . import snapshot as snapshot_mod
from . import telemetry
from . import tracing
from .config import MAX_BATCH_SIZE, PEER_COLUMNS_MAX_LANES, BehaviorConfig
from .models.shard import GregResolver
from .parallel.global_mgr import GlobalsColumns
from .parallel.hash_ring import ReplicatedConsistentHash
from .parallel.mesh import MeshBucketStore
from .parallel.region import RegionPicker
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


class _SelfPeer:
    """This node as the one member of its ring.  The JAX service keeps
    a PeerClient there; a node that is its only peer never sends to
    it, so the port keeps what the ring's readers ask: the PeerInfo."""

    __slots__ = ("info",)

    def __init__(self, info: PeerInfo):
        self.info = info


class BatcherClosedError(Exception):
    """A submission to a stopped batcher.  The JAX service raises its
    peer client's PeerError with this text; the port has no peer client
    yet."""

    def __init__(self):
        super().__init__(ERR_BATCHER_CLOSED)


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
    """Library-user config (reference Config, config.go:66-104), the
    fields of one node without peers."""

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
    # Peer transport credentials (an ssl.SSLContext for the HTTP
    # transport, grpc.ChannelCredentials for gRPC), stored for the peer
    # clients of slice A2; a node alone dials no peer.
    peer_tls_context: object = None
    peer_channel_credentials: object = None
    # A faults.FaultPlan for the peer clients (slice A2) and the
    # incident black box's bundle directory (slice A6): the port has
    # neither plane yet, so any value but None / "" raises.
    fault_plan: object = None
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
            fut.set_exception(BatcherClosedError())
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
        cb(None, BatcherClosedError())

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
    """Completion join of one async columnar request: counts down the
    plan's parts (each launch's handle through the drainer, the GLOBAL
    lanes' route) and fires the callback once, from whichever
    completion thread finishes last."""

    def __init__(self, svc, plan: _ColumnsPlan, result, callback):
        self.svc = svc
        self.plan = plan
        self.result = result
        self.callback = callback
        self._lock = threading.Lock()
        self._remaining = 0
        self._failure: Optional[Exception] = None
        self._fast_outs: list = []  # (fast_idx, out, slice, exc)
        self._slow_resps: Optional[list] = None

    def start(self) -> None:
        svc, plan = self.svc, self.plan
        parts = len(plan.pendings) + (1 if plan.slow_idx else 0)
        if parts == 0:
            self._finish()
            return
        self._remaining = parts
        drainer = svc._get_drainer()
        if plan.slow_idx:
            _attach_done(svc._slow_pool.submit(plan.slow_fn), self._on_slow)
        for pending, fast_idx in plan.pendings:
            if isinstance(pending, Future):
                _attach_done(pending, partial(self._on_dispatched, fast_idx, drainer))
            else:
                handle, lo, hi = pending
                drainer.register(handle, partial(self._on_out, fast_idx, slice(lo, hi)))

    def _on_dispatched(self, fast_idx, drainer, fut) -> None:
        try:
            handle, lo, hi = fut.result()
        except Exception as e:  # noqa: BLE001 — per-lane errors at the merge
            self._on_out(fast_idx, None, None, e)
            return
        drainer.register(handle, partial(self._on_out, fast_idx, slice(lo, hi)))

    def _on_out(self, fast_idx, sl, out, exc) -> None:
        with self._lock:
            self._fast_outs.append((fast_idx, out, sl, exc))
        self._countdown()

    def _on_slow(self, fut) -> None:
        try:
            self._slow_resps = fut.result()
        except Exception as e:  # noqa: BLE001 — the sync path raises it too
            with self._lock:
                self._failure = e
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
                for fast_idx, out, sl, exc in self._fast_outs:
                    if isinstance(exc, IngressShedError):
                        # Tenant shed attribution (the _resolve_fast twin).
                        self.svc.tenants.fold_shed(plan.tenant_ctx, fast_idx)
                    _merge_fast_result(result, plan.hash_keys, fast_idx, out, sl, exc)
                self.svc.tenants.fold_outcome(plan.tenant_ctx, result)
            except Exception as e:  # noqa: BLE001 — handed to the callback
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
            fut.set_exception(BatcherClosedError())
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
        if conf.fault_plan is not None:
            raise NotImplementedError(
                "ServiceConfig.fault_plan drives the peer clients' fault "
                "injection (faults.py), which comes with slice A2 (peers)")
        if conf.blackbox_dir:
            raise NotImplementedError(
                "ServiceConfig.blackbox_dir needs the incident black box "
                "(blackbox.py), which comes with slice A6")
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
        # Membership: the ring of this node alone once set_peers ran
        # (empty before it: the node owns every key either way).  The
        # ring fields are guarded by _peer_mutex.
        self.local_picker = ReplicatedConsistentHash()
        self.region_picker = RegionPicker()
        self._peer_mutex = threading.RLock()
        self.ring_generation = 0
        self.ring_hash = 0
        self._prev_picker = None  # the handoff window's old ring (none yet)
        self._handoff_deadline = 0.0
        self.reshard = ReshardManager(self)
        # Per-service flight recorder: threads this service owns bind it.
        self.recorder = tracing.Recorder(
            name=conf.advertise_address or f"service-{id(self):x}")
        # Native service loop attachments (gateway.NativeIngressPump and
        # NativeGatewayServer register themselves; set_peers pushes the
        # ring to the pump).
        self.native_ingress = None
        self.native_edges: list = []
        # Async GLOBAL lanes and declined single-lane shapes block on the
        # dataclass router: they run on this pool, never on a drainer.
        self._slow_pool = ThreadPoolExecutor(
            max_workers=128, thread_name_prefix="columns-slow",
            initializer=tracing.bind_recorder, initargs=(self.recorder,))
        self._drainer: Optional[_HandleDrainer] = None
        self._drainer_lock = threading.Lock()
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
        """Whether this node serves /v1/peer.UpdateRegionColumns.  The
        port has no federation plane yet, so it never does: the route
        falls through to 404, as on a JAX node with
        GUBER_REGION_COLUMNS=0."""
        return False

    def get_peer_list(self) -> list:
        with self._peer_mutex:
            return list(self.local_picker.peers())

    def get_region_picker(self) -> RegionPicker:
        return self.region_picker

    def set_peers(self, peer_infos: Sequence[PeerInfo]) -> None:
        """Install the ring (gubernator.go:357-437) for a node that is
        its only peer.  A membership change bumps the ring generation
        and fingerprint (the transfer epoch fence); a re-push of the
        same list changes nothing.  The native ingress pump gets the new
        ring.  A list naming another peer, or a peer of another data
        center, raises NotImplementedError: peers come with the peer
        client (peer_client.py)."""
        infos = list(peer_infos)
        for info in infos:
            if not info.is_owner or (info.data_center
                                     and info.data_center != self.conf.data_center):
                raise NotImplementedError(
                    f"peer {info.grpc_address!r} is not this node: peers come "
                    "with the peer client (peer_client.py), not ported yet")
        if len(infos) > 1:
            raise NotImplementedError(
                "a ring of more than this node needs the peer client "
                "(peer_client.py), not ported yet")
        with self._peer_mutex:
            old_ids = set(self.local_picker.peer_ids())
            new_local = self.local_picker.new()
            for info in infos:
                new_local.add(info.grpc_address, _SelfPeer(info))
            self.local_picker = new_local
            if set(new_local.peer_ids()) != old_ids:
                self.ring_generation += 1
                self.ring_hash = new_local.fingerprint()
        pump = self.native_ingress
        if pump is not None:
            pump.update_ring()

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
        """Column-form GetRateLimits: same validation and semantics as
        get_rate_limits with no per-request dataclasses for the plain
        lanes.  `max_lanes` is the ingress-encoding cap
        (INGRESS_COLUMNS_MAX_LANES for a columnar frame)."""
        if len(cols) > max_lanes:
            raise ApiError(
                "OutOfRange",
                f"Requests.RateLimits list too large; max size is '{max_lanes}'",
            )
        n = len(cols)
        result = ColumnarResult.empty(n)
        if n == 0:
            return result
        if n == 1 or not self.store.supports_columns:
            # Single-lane requests ride the router: its batchers coalesce
            # concurrent single-key callers into one launch.
            resp = self._route([cols.request_at(i) for i in range(n)])
            result.overrides = dict(enumerate(resp.responses))
            return result
        return self._finalize_columns(self._submit_columns(cols, result), result)

    def _submit_columns(self, cols: IngressColumns, result: ColumnarResult) -> _ColumnsPlan:
        """Phase 1 of the columnar route: validation and every launch
        submission, no blocking on a readback (shared by the blocking
        and the async entry points)."""
        n = len(cols)
        # Conservation ledger and tenant ledger: hits entering the public
        # front door on the columnar path (the dataclass router notes
        # its own in _route).
        audit_mod.note("ingress_hits", int(cols.hits.sum()))
        tenant_ctx = self.tenants.fold_admit(cols)
        beh = np.asarray(cols.behavior, dtype=np.int32)
        # GLOBAL lanes take the dataclass router (replica answers, hit
        # accumulation); the rest launch columnar.
        slow = (beh & int(Behavior.GLOBAL)) != 0
        fast = ~slow
        # Validation (gubernator.go:142-152; note the reference's
        # 'namespace' wording for an empty name).  The native JSON parse
        # and the frame decode hand the hash keys over packed, with a
        # validation code per lane (gateway LazyIngressColumns,
        # wire.FrameIngressColumns).
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
        pendings = self._dispatch_fast(cols, beh, fast, hash_keys, result)
        slow_idx = [int(i) for i in np.nonzero(slow)[0]]
        slow_reqs = [cols.request_at(i) for i in slow_idx]
        return _ColumnsPlan(
            pendings=pendings,
            slow_idx=slow_idx,
            # _counted: the funnel above noted these lanes' hits already.
            slow_fn=((lambda: self._route(slow_reqs, _counted=True).responses)
                     if slow_idx else None),
            hash_keys=hash_keys,
            tenant_ctx=tenant_ctx,
        )

    def _finalize_columns(self, plan: _ColumnsPlan, result: ColumnarResult) -> ColumnarResult:
        """Phase 2, blocking: the GLOBAL lanes' route (store.apply drains
        every launched batch first), then every launch's readback."""
        if plan.slow_idx:
            for i, r in zip(plan.slow_idx, plan.slow_fn()):
                result.overrides[int(i)] = r
        self._resolve_fast(plan.pendings, plan.hash_keys, result, plan.tenant_ctx)
        # Tenant ledger: per-tenant OVER_LIMIT from the resolved arrays.
        self.tenants.fold_outcome(plan.tenant_ctx, result)
        return result

    def _resolve_greg_fast(self, cols, beh, fast, result):
        """Gregorian precompute for the lanes that carry
        DURATION_IS_GREGORIAN; an invalid duration becomes that lane's
        error (and leaves `fast`).  Returns (greg_expire, greg_duration)
        or Nones."""
        greg_lanes = fast & ((beh & int(Behavior.DURATION_IS_GREGORIAN)) != 0)
        if not greg_lanes.any():
            return None, None
        n = len(cols)
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

    def _dispatch_fast(self, cols, beh, fast, hash_keys, result):
        """Launch the plain lanes.  Batching is per lane, as in the
        reference (proto/gubernator.proto:74-78): NO_BATCHING lanes
        launch at once, the rest go through the window, so a mixed
        request splits into one direct and one windowed launch.  Returns
        [(pending, lane idx)] for _resolve_fast / _ColumnsJoin."""
        greg_expire, greg_duration = self._resolve_greg_fast(cols, beh, fast, result)
        fast_idx = np.nonzero(fast)[0]
        if not fast_idx.size:
            return []
        n = len(cols)
        # Span links of the ambient request ([] when unsampled).
        links = tracing.request_links(cols)

        def dispatch(idx, direct):
            full = idx.size == n
            sl = slice(None) if full else idx
            if full:
                keys_sel = hash_keys
            elif isinstance(hash_keys, list):
                keys_sel = [hash_keys[i] for i in idx]
            else:
                keys_sel = hash_keys.subset(idx)  # PackedKeys, no per-lane strings
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
                        *args[:6], self.clock.now_ms(), *args[6:])
                finally:
                    tracing.take_batch_trace()
                return (handle, 0, idx.size), idx
            return self.columnar_batcher.submit(*args, trace_links=links), idx

        nb = (beh[fast_idx] & int(Behavior.NO_BATCHING)) != 0
        if not nb.any():
            return [dispatch(fast_idx, False)]
        if nb.all():
            return [dispatch(fast_idx, True)]
        return [dispatch(fast_idx[nb], True), dispatch(fast_idx[~nb], False)]

    def _resolve_fast(self, pendings, hash_keys, result, tenant_ctx=None) -> None:
        """Block on each launch and scatter its arrays into the result;
        a failed launch becomes per-lane errors."""
        for pending, fast_idx in pendings:
            out, sl, exc = None, None, None
            try:
                handle, lo, hi = pending.result() if isinstance(pending, Future) else pending
                out = handle.result()
                sl = slice(lo, hi)
            except Exception as e:  # noqa: BLE001 — per-lane errors, batch survives
                exc = e
            if isinstance(exc, IngressShedError):
                # Tenant ledger: the ingress gate refused these lanes.
                self.tenants.fold_shed(tenant_ctx, fast_idx)
            _merge_fast_result(result, hash_keys, fast_idx, out, sl, exc)

    def _route(self, requests: Sequence[RateLimitRequest],
               _counted: bool = False) -> GetRateLimitsResponse:
        """The dataclass router of a node that owns every key: a
        multi-lane request (or a NO_BATCHING lane) is its own batch; a
        single BATCHING lane rides a window.  `_counted` marks lanes the
        columnar funnel already noted in the audit and tenant ledgers."""
        n = len(requests)
        if not _counted:
            audit_mod.note("ingress_hits", sum(int(r.hits) for r in requests))
        tenant_names = None if _counted else self.tenants.fold_requests(requests)
        out: List[Optional[RateLimitResponse]] = [None] * n
        local: List[int] = []
        for i, r in enumerate(requests):
            if not r.unique_key:
                out[i] = RateLimitResponse(error=ERR_EMPTY_KEY)
            elif not r.name:
                out[i] = RateLimitResponse(error=ERR_EMPTY_NAME)
            else:
                local.append(i)
        if local:
            local_reqs = [requests[i] for i in local]
            if len(local_reqs) > 1 or has_behavior(local_reqs[0].behavior, Behavior.NO_BATCHING):
                if len(local_reqs) == 1 and self._single_columnar_eligible(local_reqs[0]):
                    # One NO_BATCHING lane: a direct columnar launch.
                    i = local[0]
                    try:
                        out[i] = self._submit_single_local(local_reqs[0], direct=True).result()
                    except Exception as e:  # noqa: BLE001 — per-lane error
                        out[i] = RateLimitResponse(
                            error=f"while applying rate limit '{local_reqs[0].hash_key()}' - '{e}'")
                else:
                    resps = self.store.apply(local_reqs, self.clock.now_ms())
                    for i, resp in zip(local, resps):
                        out[i] = resp
            else:
                i = local[0]
                try:
                    # No timeout: the flush always resolves the future,
                    # and a timeout would report an error for hits the
                    # late flush still applies.
                    out[i] = self._submit_single_local(local_reqs[0]).result()
                except Exception as e:  # noqa: BLE001 — per-lane error
                    out[i] = RateLimitResponse(
                        error=f"while applying rate limit '{local_reqs[0].hash_key()}' - '{e}'")
        if tenant_names is not None:
            self.tenants.fold_outcome_responses(tenant_names, out)
        return GetRateLimitsResponse(
            responses=[r if r is not None else RateLimitResponse() for r in out])

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
        _ColumnsJoin(self, plan, result, callback).start()

    def _try_single_async(self, cols: IngressColumns, callback) -> bool:
        """Completion of one async lane without a parked thread: the
        same _submit_single_local rider the sync path uses, completed by
        the drainer (columnar) or the LocalBatcher's flush (dataclass).
        Returns False to decline (validation wording, a GLOBAL
        NO_BATCHING lane), leaving it to the sync router."""
        if not self.store.supports_columns:
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

    def transfer_ownership(self, cols: TransferColumns) -> "tuple[int, int]":
        """Receive side of an ownership transfer (reshard.py): fence the
        epoch, then merge-commit the lanes with one row gather (K7) and
        one row write (K8).  Returns (committed, rejected); this node
        owns every key of its one-node ring, so none is rejected."""
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
        # set_peers admits no peer but this node, so it owns every key;
        # lanes owned elsewhere are rejected once peers exist.
        committed = self.store.commit_transfer(cols, self.clock.now_ms())
        rejected = 0
        self.reshard.note_received(committed, rejected)
        return committed, rejected

    # ------------------------------------------------------------------
    def health_check(self) -> HealthCheckResponse:
        """gubernator.go:295-333 for a node that is its only peer (no
        transport to fail, no breaker to open); a service never given a
        ring counts itself as its one peer."""
        from . import __version__

        with self._peer_mutex:
            peer_count = self.local_picker.size() or 1
        return HealthCheckResponse(status=HEALTHY, peer_count=peer_count,
                                   version=__version__)

    def ingress_queued_lanes(self) -> int:
        """Lanes admitted into the bounded ingress gates (both batchers
        share the GUBER_INGRESS_QUEUE_LANES budget, counted apart)."""
        return self.local_batcher._gate.queued + self.columnar_batcher._gate.queued

    _BREAKER_NAMES = {0: "closed", 1: "half-open", 2: "open"}

    def debug_status(self) -> dict:
        """GET /debug/status: health, peers, table occupancy, ingress
        queue, pipeline depth, SLO burn, express lane, hot keys, tenants,
        profiler, ring and resharding counters, audit, device telemetry
        and snapshots.  Host-side state only: no launch.  The JAX
        document's `blackbox` and `region` sections wait for their
        modules."""
        from . import __version__

        hc = self.health_check()
        with self._peer_mutex:
            peer_list = list(self.local_picker.peers()) + list(self.region_picker.peers())
            ring = {
                "generation": self.ring_generation,
                "hash": format(self.ring_hash, "016x"),
                "handoffActive": False,
                "handoffRemainingS": 0.0,
                "reshardEnabled": self.serves_reshard,
            }
        peers = [{"peer": p.info.grpc_address, "isOwner": bool(p.info.is_owner),
                  "breaker": "closed"} for p in peer_list]
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
        }

    def close(self) -> None:
        """Stop the windows (each flushes what it holds), resolve every
        registered handle, stop the GLOBAL sync, resolve every in-flight
        batch, then (in the JAX service's order) stop the snapshot
        cadence, write the shutdown snapshot and hand the Loader every
        item."""
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
        self.auditor.stop()
        self.reshard.close(timeout_s=5.0)
        self._slow_pool.shutdown(wait=False)
        self.store._drain_all()
        self.snapshots.stop()
        self.snapshots.save_now("close")
        if self.conf.loader is not None:
            self.conf.loader.save(self.store.snapshot_items())


class GlobalManager:
    """The host tier of the GLOBAL plane (global.go:32-243): every
    GlobalSyncWait, run the store's sync (ops/global_ops.py global_sync
    on the device).

    The port's service has no peers yet, so the legs that need them are
    not here: the broadcast fan-out (a one-node daemon sends its
    broadcasts to no peer, as the JAX service's fan-out skips itself),
    the remote-hit forward and its requeue carry.  A sync that returns
    hits for a remote owner raises NotImplementedError: no path of the
    port's service can make one (it never marks an owner remote)."""

    # Auto-sizing policy: one sync pass should cost <= 10% of its
    # window, clamped to [5 ms, 1 s]; the estimator is the minimum over
    # the last SYNC_COST_SAMPLES work ticks (a sync's true cost is its
    # least-contended run; an average lets one outlier pin the window).
    SYNC_OVERHEAD_TARGET = 0.1
    SYNC_WAIT_MIN_S = 0.005
    SYNC_WAIT_MAX_S = 1.0
    SYNC_WAIT_FALLBACK_S = 0.1
    SYNC_COST_SAMPLES = 8
    # Cap of the remote-hit requeue carry (audit.py's global_slack
    # bound); the carry itself comes with the peer legs.
    HIT_CARRY_MAX = 16_384

    @classmethod
    def window_for_cost(cls, cost_s: float) -> float:
        """The sync window this policy derives from a measured per-sync
        cost."""
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
        self._sync_cost_samples: "deque[float]" = deque(maxlen=self.SYNC_COST_SAMPLES)
        self._last_sync_cost_s: Optional[float] = None
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
        """One sync pass; returns whether it produced host-tier work (the
        auto-tuner's signal that GLOBAL is in real use).  Only the store
        sync's in-lock cost counts as sync cost."""
        svc = self.service
        t0 = time.perf_counter()
        res = svc.store.sync_globals(svc.clock.now_ms())
        cost = svc.store.last_sync_cost_s
        self._last_sync_cost_s = cost if cost is not None else time.perf_counter() - t0
        if res.remote_hit_cols is not None and len(res.remote_hit_cols):
            raise NotImplementedError(
                "forwarding GLOBAL hits to a remote owner needs the peer "
                "transport (ROADMAP: GlobalManager peer legs)")
        return bool(res.broadcast_cols or res.remote_hit_cols)

    def stop(self) -> None:
        self._stopped = True
        self._interval.stop()
