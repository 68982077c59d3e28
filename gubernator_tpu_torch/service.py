"""V1Service — the service core of one node (reference V1Instance,
gubernator.go), on the port's columnar path.

The port of the JAX package's service.py for a single node with no
peers: every valid lane is owned locally.  Plain lanes are evaluated
through the store's `apply_columns`; GLOBAL lanes take the store's
dataclass path (`apply`) as the JAX service routes them for a daemon
that owns every key, and a GlobalManager syncs them on an interval.
The store is a MeshBucketStore built from the sizes, or the one given
as `ServiceConfig.store` (a ShardStore for a one-shard deployment,
which answers GLOBAL lanes as local ones and has no GLOBAL sync, as in
the JAX package; the service then runs no GlobalManager).  With a
Store SPI (`persist_store`) every lane takes the dataclass path, as the
store's callbacks need.  Persistence: a Loader
(`loader`) is loaded at boot and saved at close; a snapshot file
(`snapshot_path`) is restored at boot and written at close and on an
interval (snapshot.py).  Responses are the JAX V1Service's
(tests/test_torch_service.py and tests/test_torch_persist.py hold them
to it).
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from . import snapshot as snapshot_mod
from .config import MAX_BATCH_SIZE
from .models.shard import GregResolver
from .parallel.mesh import MeshBucketStore
from .types import (
    Behavior,
    GetRateLimitsRequest,
    GetRateLimitsResponse,
    HealthCheckResponse,
    RateLimitRequest,
    RateLimitResponse,
)
from .utils import gregorian
from .utils.clock import DEFAULT_CLOCK, Clock
from .utils.interval import Interval

log = logging.getLogger(__name__)

HEALTHY = "healthy"
N_SHARDS = 8  # the JAX service's shard count on an 8-device mesh
ERR_EMPTY_KEY = "field 'unique_key' cannot be empty"
ERR_EMPTY_NAME = "field 'namespace' cannot be empty"


class ApiError(Exception):
    """Request-level error (maps to a gRPC status / HTTP error)."""

    def __init__(self, code: str, message: str, http_status: int = 400):
        super().__init__(message)
        self.code = code
        self.message = message
        self.http_status = http_status


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
    # GLOBAL sync interval; None = sized from the measured sync cost.
    global_sync_wait_s: Optional[float] = None
    clock: Clock = field(default_factory=lambda: DEFAULT_CLOCK)
    # Device of the store built from the sizes: None = the current CUDA
    # device (raises without one); "cpu" runs the plain versions.
    device: object = None
    persist_store: object = None  # Store SPI (store.py)
    loader: object = None  # Loader SPI (store.py)
    # Durability plane (snapshot.py): the snapshot file ("" = disabled,
    # every restart a full reset), restored at boot with one merge-commit
    # and written on close() and every snapshot_interval_s seconds (0 =
    # on close() only).  The JAX service reads the interval from its
    # BehaviorConfig, which the port has not yet.
    snapshot_path: str = ""
    snapshot_interval_s: float = 0.0


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
    lanes plus sparse per-lane overrides (validation and other errors)."""

    n: int
    status: np.ndarray
    limit: np.ndarray
    remaining: np.ndarray
    reset_time: np.ndarray
    overrides: Dict[int, RateLimitResponse] = field(default_factory=dict)

    @classmethod
    def empty(cls, n: int) -> "ColumnarResult":
        z = np.zeros(n, dtype=np.int64)
        return cls(
            n=n, status=np.zeros(n, dtype=np.int32), limit=z,
            remaining=z.copy(), reset_time=z.copy(),
        )

    def response_at(self, i: int) -> RateLimitResponse:
        ov = self.overrides.get(i)
        if ov is not None:
            return ov
        return RateLimitResponse(
            status=int(self.status[i]),
            limit=int(self.limit[i]),
            remaining=int(self.remaining[i]),
            reset_time=int(self.reset_time[i]),
        )

    def to_response(self) -> GetRateLimitsResponse:
        return GetRateLimitsResponse(
            responses=[self.response_at(i) for i in range(self.n)]
        )


class V1Service:
    def __init__(self, conf: ServiceConfig):
        self.conf = conf
        self.clock = conf.clock
        self.store = conf.store or MeshBucketStore(
            capacity_per_shard=max(conf.cache_size // N_SHARDS, 1),
            device=conf.device,
            # GLOBAL keys share the reference's cache: a GLOBAL key table
            # of the cache size, clamped to [4096, 65536].
            g_capacity=min(max(4096, conf.cache_size), 65536),
            store=conf.persist_store,
            # Ceil division: any nonzero back_cache_size enables the back
            # tier (as the JAX service sizes it).
            back_capacity_per_shard=-(-conf.back_cache_size // N_SHARDS)
            if conf.back_cache_size > 0 else 0,
        )
        self._closed = False
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
            self, path=conf.snapshot_path, interval_s=conf.snapshot_interval_s)
        self.snapshots.restore()
        self.snapshots.start()
        # A store without a GLOBAL sync (a ShardStore) gets no sync ticks.
        self.global_mgr = GlobalManager(self) if hasattr(self.store, "sync_globals") else None

    # ------------------------------------------------------------------
    def get_rate_limits(self, req: GetRateLimitsRequest) -> GetRateLimitsResponse:
        """gubernator.go:116-227 for a node that owns every key."""
        if len(req.requests) > MAX_BATCH_SIZE:
            raise ApiError(
                "OutOfRange",
                f"Requests.RateLimits list too large; max size is '{MAX_BATCH_SIZE}'",
            )
        cols = IngressColumns(
            names=[r.name for r in req.requests],
            unique_keys=[r.unique_key for r in req.requests],
            algorithm=np.array([int(r.algorithm) for r in req.requests], np.int32),
            behavior=np.array([int(r.behavior) for r in req.requests], np.int32),
            hits=np.array([int(r.hits) for r in req.requests], np.int64),
            limit=np.array([int(r.limit) for r in req.requests], np.int64),
            duration=np.array([int(r.duration) for r in req.requests], np.int64),
        )
        # Every valid lane evaluates in one batch (the JAX service's
        # whole-batch store call), NO_BATCHING or not.
        return self._evaluate(cols, dataclass_call=True).to_response()

    def get_rate_limits_columns(
        self, cols: IngressColumns, max_lanes: int = MAX_BATCH_SIZE
    ) -> ColumnarResult:
        """Column-form GetRateLimits: same validation and semantics as
        get_rate_limits with no per-request dataclasses.  `max_lanes`
        is the ingress-encoding cap (INGRESS_COLUMNS_MAX_LANES for a
        columnar frame)."""
        if len(cols) > max_lanes:
            raise ApiError(
                "OutOfRange",
                f"Requests.RateLimits list too large; max size is '{max_lanes}'",
            )
        # NO_BATCHING lanes dispatch before the batched ones, as the
        # JAX service's direct dispatch overtakes its coalescing window.
        return self._evaluate(cols, dataclass_call=False)

    def _evaluate(self, cols: IngressColumns, dataclass_call: bool) -> ColumnarResult:
        n = len(cols)
        result = ColumnarResult.empty(n)
        if n == 0:
            return result
        beh = np.asarray(cols.behavior, dtype=np.int32)
        fast = np.ones(n, dtype=bool)
        hash_keys: List[str] = [""] * n
        for i in range(n):
            # Validation (gubernator.go:142-152; note the reference's
            # 'namespace' wording for an empty name).
            if not cols.unique_keys[i]:
                result.overrides[i] = RateLimitResponse(error=ERR_EMPTY_KEY)
                fast[i] = False
            elif not cols.names[i]:
                result.overrides[i] = RateLimitResponse(error=ERR_EMPTY_NAME)
                fast[i] = False
            else:
                hash_keys[i] = f"{cols.names[i]}_{cols.unique_keys[i]}"
        # GLOBAL lanes take the store's dataclass path (replica answers,
        # hit accumulation).  The JAX service's dataclass entry point
        # sends every locally owned lane of a multi-lane request there,
        # so a dataclass call holding a GLOBAL lane does too; its column
        # entry point sends only the GLOBAL lanes, after launching the
        # others.
        # A store with a Store SPI has no columnar path: every lane goes
        # to apply, as the JAX service routes it.
        slow = fast & ((beh & int(Behavior.GLOBAL)) != 0)
        if (slow.any() and dataclass_call) or not self.store.supports_columns:
            slow = fast.copy()
        fast &= ~slow
        slow_idx = np.nonzero(slow)[0]
        greg_expire, greg_duration = self._resolve_gregorian(cols, beh, fast, result)
        fast_idx = np.nonzero(fast)[0]
        groups = [fast_idx] if fast_idx.size else []
        if not dataclass_call and fast_idx.size:
            nb = (beh[fast_idx] & int(Behavior.NO_BATCHING)) != 0
            groups = [g for g in (fast_idx[nb], fast_idx[~nb]) if g.size]
        now = self.clock.now_ms()
        handles = []
        for idx in groups:
            handles.append((idx, self.store.apply_columns_async(
                [hash_keys[i] for i in idx],
                cols.algorithm[idx], beh[idx], cols.hits[idx], cols.limit[idx],
                cols.duration[idx], now,
                None if greg_expire is None else greg_expire[idx],
                None if greg_duration is None else greg_duration[idx],
            )))
        if slow_idx.size:
            # apply() drains the launched columnar batches first.
            resps = self.store.apply([cols.request_at(int(i)) for i in slow_idx], now)
            for i, r in zip(slow_idx, resps):
                result.overrides[int(i)] = r
        for idx, handle in handles:
            try:
                out = handle.result()
            except Exception as e:  # noqa: BLE001 — per-lane errors, batch survives
                for i in idx:
                    result.overrides[int(i)] = RateLimitResponse(
                        error=f"while applying rate limit '{hash_keys[i]}' - '{e}'"
                    )
                continue
            result.status[idx] = out["status"]
            result.limit[idx] = out["limit"]
            result.remaining[idx] = out["remaining"]
            result.reset_time[idx] = out["reset_time"]
        return result

    def _resolve_gregorian(self, cols, beh, fast, result):
        """Gregorian precompute for the lanes that carry
        DURATION_IS_GREGORIAN; an invalid duration becomes that lane's
        error.  Returns (greg_expire, greg_duration) or Nones."""
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

    # ------------------------------------------------------------------
    def health_check(self) -> HealthCheckResponse:
        """gubernator.go:295-333 for a node that is its only peer."""
        from . import __version__

        return HealthCheckResponse(status=HEALTHY, peer_count=1, version=__version__)

    def close(self) -> None:
        """Stop the GLOBAL sync, resolve every in-flight batch, then (in
        the JAX service's order) stop the snapshot cadence, write the
        shutdown snapshot and hand the Loader every item."""
        if self._closed:
            return
        self._closed = True
        if self.global_mgr is not None:
            self.global_mgr.stop()
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
        configured = service.conf.global_sync_wait_s
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
            log.exception("GLOBAL sync failed")
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
