"""V1Service — the service core of one node (reference V1Instance,
gubernator.go), on the port's columnar path.

The port of the JAX package's service.py for a single node with no
peers: every valid lane is owned locally and evaluated through
`MeshBucketStore.apply_columns`, both for the dataclass entry point
(`get_rate_limits`) and the column one (`get_rate_limits_columns`).
Responses are the JAX V1Service's (tests/test_torch_service.py holds
them to it).  GLOBAL lanes answer with a per-lane error until the GLOBAL
plane is ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

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

HEALTHY = "healthy"
N_SHARDS = 8  # the JAX service's shard count on an 8-device mesh
ERR_GLOBAL_NOT_PORTED = "behavior GLOBAL is not supported by the PyTorch port yet"
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

    store: Optional[MeshBucketStore] = None  # built from the sizes when None
    cache_size: int = 50_000  # total slots, split evenly over 8 shards
    clock: Clock = field(default_factory=lambda: DEFAULT_CLOCK)
    # Device of the store built from the sizes: None = the current CUDA
    # device (raises without one); "cpu" runs the plain versions.
    device: object = None


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
        )
        self._closed = False

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
        return self._evaluate(cols, split_no_batching=False).to_response()

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
        return self._evaluate(cols, split_no_batching=True)

    def _evaluate(self, cols: IngressColumns, split_no_batching: bool) -> ColumnarResult:
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
            elif beh[i] & int(Behavior.GLOBAL):
                result.overrides[i] = RateLimitResponse(error=ERR_GLOBAL_NOT_PORTED)
                fast[i] = False
            else:
                hash_keys[i] = f"{cols.names[i]}_{cols.unique_keys[i]}"
        greg_expire, greg_duration = self._resolve_gregorian(cols, beh, fast, result)
        fast_idx = np.nonzero(fast)[0]
        if not fast_idx.size:
            return result
        groups = [fast_idx]
        if split_no_batching:
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
        """Resolve every in-flight batch."""
        if self._closed:
            return
        self._closed = True
        self.store._drain_all()
