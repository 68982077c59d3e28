"""The one-shard bucket store (`ShardStore`) and the host side shared
with the sharded store: request columns, padding, Gregorian precompute,
the narrow-output decode and the overlapped dispatch pipeline of the
columnar path (with its express scalar slot), the request preparation
and round planner of the dataclass path, and the Store SPI's round
planner, resolver and item <-> row conversions.

The port of the JAX package's models/shard.py, without its reshard
surface (`resident_keys`, `resident_mask`, `drain_keys`,
`forget_keys`).  Where the JAX package threads donated
device buffers through jitted calls, the port launches kernels on one
CUDA stream that update the state tensors in place: the wire goes up
from a pinned host buffer with a non-blocking copy, the packed result
comes back into a pinned buffer with a CUDA event recorded behind it,
and a handle's `result()` waits on that event before the C++ commit.

Each stage reports its time to `_observe_stage` (saturation.py's
`dispatch.<stage>` reservoirs and `take_pipeline_stats`), and a batch a
batcher staged a trace for (tracing.stage_batch_trace) records one
`dispatch.<stage>` span a stage.
"""

from __future__ import annotations

import datetime as _dt
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import audit
from .. import native
from .. import profiling
from .. import saturation
from .. import telemetry
from .. import tracing
from ..ops import buckets
from ..ops import scalar as scalar_ops
from ..types import (
    Algorithm,
    Behavior,
    RateLimitRequest,
    RateLimitResponse,
    has_behavior,
)
from ..reshard import TransferColumns, merge_transfer_rows
from ..utils import gregorian
from .slot_table import SlotTable

# Batches of up to 1,024 lanes a shard pad to 64, 256 or 1,024 lanes, as
# the JAX package does, so small batches share a shape and fuse.  Larger
# ones pad to the next multiple of 256 lanes, where the JAX package
# doubles to keep its compiled programs few: the port's kernels take
# any P and compile nothing per shape, and every padding lane costs the
# dict wire 12 bytes up and the narrow result 16 bytes down.
_PAD_MIN = 64
_PAD_COARSE_MAX = 1024
_PAD_STEP = 256


def pad_size(n: int) -> int:
    p = _PAD_MIN
    while p < n and p < _PAD_COARSE_MAX:
        p <<= 2
    if n <= p:
        return p
    return -(-n // _PAD_STEP) * _PAD_STEP


@dataclass
class _Prepared:
    """A request resolved host-side, ready for kernel dispatch.

    gslot / cached_hint are used by the GLOBAL path (parallel/mesh.py):
    cached_hint lanes answer from the replica columns, touch no local
    bucket state, and scatter-add their hits — so they bypass the
    round-uniqueness rules entirely.
    """

    pos: int
    slot: int
    exists: bool
    req: RateLimitRequest
    key: str
    greg_expire: int = 0
    greg_duration: int = 0
    resolved: bool = False
    gslot: int = -1
    cached_hint: bool = False


class GregResolver:
    """Memoized Gregorian expiry/duration for one batch timestamp
    (the host analogue of algorithms.go:90-95,140-145).  `resolve`
    returns (expire_ms, duration_ms) or the GregorianError the
    reference surfaces as a per-request error."""

    def __init__(self, now_ms: int):
        self.now_ms = now_ms
        self._now_dt: Optional[_dt.datetime] = None
        self._cache: Dict[int, object] = {}

    def resolve(self, duration: int):
        if self._now_dt is None:
            self._now_dt = _dt.datetime.fromtimestamp(
                self.now_ms / 1000.0, tz=_dt.timezone.utc
            )
        cached = self._cache.get(duration)
        if cached is None:
            try:
                cached = (
                    gregorian.gregorian_expiration(self._now_dt, duration),
                    gregorian.gregorian_duration(self._now_dt, duration),
                )
            except gregorian.GregorianError as e:
                cached = e
            self._cache[duration] = cached
        return cached


def prepare_requests(
    requests: Sequence[RateLimitRequest],
    now_ms: int,
    responses: List[Optional[RateLimitResponse]],
    positions: Optional[Sequence[int]] = None,
) -> List[_Prepared]:
    """Precompute per-request host-side values (hash key, Gregorian
    expiry/duration).  Requests with invalid Gregorian durations get
    error responses directly (reference returns the error per-request).
    `positions` gives each request's index in `responses` (default: its
    own index)."""
    greg = GregResolver(now_ms)
    prepared: List[_Prepared] = []

    for i, req in enumerate(requests):
        pos = positions[i] if positions is not None else i
        p = _Prepared(pos=pos, slot=-1, exists=False, req=req, key=req.hash_key())
        if has_behavior(req.behavior, Behavior.DURATION_IS_GREGORIAN):
            cached = greg.resolve(req.duration)
            if isinstance(cached, gregorian.GregorianError):
                responses[pos] = RateLimitResponse(error=str(cached))
                continue
            p.greg_expire, p.greg_duration = cached
        prepared.append(p)
    return prepared


def plan_grouped_python(table, prepared: Sequence[_Prepared], now_ms: int):
    """Full-plan twin of the C++ gt_batch_plan_grouped driven one key
    at a time through a slot table's lookup_or_assign: uniform
    duplicate groups (same key, identical config, no RESET_REMAINING)
    collapse into round 0 with per-lane occurrence indices and a
    single scattering (write) lane; everything else takes
    the round scheme from round 1 with the same chaining/deferral rules
    as RoundPlanner.  Mutates each _Prepared's slot/exists; returns
    (round_id, occ, write, n_rounds) arrays aligned to `prepared`.

    Used by the mesh store's dataclass path: ALL rounds of ALL shards
    run in one answer-kernel call (ops/global_ops.py answer_rounds).
    """
    n = len(prepared)
    round_id = np.zeros(n, dtype=np.int32)
    occ = np.zeros(n, dtype=np.int32)
    write = np.zeros(n, dtype=bool)

    groups: "Dict[str, List[int]]" = {}
    for j, p in enumerate(prepared):
        if p.cached_hint:
            # Replica-cache lane: no local state touched; hits
            # accumulate by scatter-add, so no round/uniqueness rules.
            p.slot, p.exists, p.resolved = -1, False, True
            continue
        groups.setdefault(p.key, []).append(j)

    used0: set = set()
    slow: List[int] = []
    # Last key to write each slot in scheduled device order: round-0
    # groups seed it; slow lanes consult it for BOTH exists-chaining
    # and slot-takeover detection.
    slot_owner: Dict[int, str] = {}
    for key, lanes in groups.items():
        f = prepared[lanes[0]]
        uniform = not has_behavior(f.req.behavior, Behavior.RESET_REMAINING)
        for j in lanes[1:]:
            if not uniform:
                break
            q = prepared[j]
            uniform = (
                q.req.algorithm == f.req.algorithm
                and q.req.behavior == f.req.behavior
                and q.req.hits == f.req.hits
                and q.req.limit == f.req.limit
                and q.req.duration == f.req.duration
                and q.greg_expire == f.greg_expire
                and q.greg_duration == f.greg_duration
            )
        ev_before = table.evictions
        slot, exists = table.lookup_or_assign(key, now_ms)
        evicted = table.evictions != ev_before
        for j in lanes:
            prepared[j].slot = slot
            prepared[j].exists = exists
            prepared[j].resolved = True
        # An eviction may have stolen a slot from a key with earlier
        # lanes in this batch; the slow path's deferral orders it.
        if uniform and not evicted and slot not in used0:
            used0.add(slot)
            slot_owner[slot] = key
            for o, j in enumerate(lanes):
                occ[j] = o
                write[j] = o + 1 == len(lanes)
        else:
            slow.extend(lanes)

    if not slow:
        return round_id, occ, write, 1

    slow.sort()
    rnd = 1
    pending = slow
    while pending:
        seen: set = set()
        used: set = set()
        deferred: List[int] = []
        for j in pending:
            p = prepared[j]
            if p.key in seen:
                deferred.append(j)
                continue
            owner = slot_owner.get(p.slot)
            if owner is not None and owner != p.key:
                # The captured slot was taken over by ANOTHER key's
                # create (mid-batch eviction) scheduled before this
                # lane.  Running here — with either exists value —
                # would corrupt the new owner's device state.
                # Re-resolve: the table no longer maps this key, so it
                # gets a fresh slot (or evicts a different one).
                p.slot, p.exists = table.lookup_or_assign(p.key, now_ms)
            if p.slot in used:  # eviction collision: defer as-is
                deferred.append(j)
                seen.add(p.key)
                continue
            round_id[j] = rnd
            write[j] = True
            if slot_owner.get(p.slot) == p.key:
                p.exists = True  # chained: device state authoritative
            slot_owner[p.slot] = p.key
            seen.add(p.key)
            used.add(p.slot)
        pending = deferred
        rnd += 1
    return round_id, occ, write, rnd


def build_round_arrays(chunk: Sequence[_Prepared], padded: int) -> Tuple[np.ndarray, ...]:
    """Columnize one round of prepared requests into kernel input arrays."""
    slot = np.full(padded, -1, dtype=np.int32)
    exists = np.zeros(padded, dtype=bool)
    algo = np.zeros(padded, dtype=np.int32)
    behavior = np.zeros(padded, dtype=np.int32)
    hits = np.zeros(padded, dtype=np.int64)
    limit = np.zeros(padded, dtype=np.int64)
    duration = np.zeros(padded, dtype=np.int64)
    greg_expire = np.zeros(padded, dtype=np.int64)
    greg_duration = np.zeros(padded, dtype=np.int64)
    for i, p in enumerate(chunk):
        slot[i] = p.slot
        exists[i] = p.exists
        algo[i] = int(p.req.algorithm)
        behavior[i] = int(p.req.behavior)
        hits[i] = p.req.hits
        limit[i] = p.req.limit
        duration[i] = p.req.duration
        greg_expire[i] = p.greg_expire
        greg_duration[i] = p.greg_duration
    return slot, exists, algo, behavior, hits, limit, duration, greg_expire, greg_duration


class RoundPlanner:
    """Splits a prepared request stream into kernel rounds (the Store
    SPI path of MeshBucketStore.apply, one planner per shard).

    A round must have unique keys AND unique slots (the scatter is
    race-free only then).  Duplicates are skipped-and-deferred to a later
    round so the k-th request for a key observes the (k-1)-th's committed
    state — the vectorized equivalent of the reference's mutex
    serialization (gubernator.go:336-337).  Cross-key order is NOT
    preserved (matching the reference's arbitrary goroutine fan-out
    order, gubernator.go:131-218).  A slot collision can only happen when
    LRU eviction under capacity pressure reuses a slot already scheduled
    in the current round; the colliding request keeps its captured
    (slot, exists) and runs next round, preserving sequential
    evict-then-create semantics.
    """

    def __init__(self, table, prepared: Sequence[_Prepared], now_ms: int,
                 resolver=None):
        self.table = table
        self.queue = deque(prepared)
        self.now_ms = now_ms
        # Pluggable (slot, exists) resolution — the Store SPI path wraps
        # the table lookup with store.get / remove side effects.
        self.resolver = resolver or (lambda p: table.lookup_or_assign(p.key, now_ms))

    def next_chunk(self) -> List[_Prepared]:
        cur: List[_Prepared] = []
        seen_keys: set = set()
        used_slots: set = set()
        deferred: deque = deque()
        while self.queue:
            p = self.queue.popleft()
            if p.cached_hint:
                # Replica-cache lane: no local state touched, hit
                # accumulation is scatter-add (duplicate-safe) — exempt
                # from key/slot uniqueness.
                p.slot, p.exists, p.resolved = -1, False, True
                cur.append(p)
                continue
            if p.key in seen_keys:
                deferred.append(p)  # k-th occurrence waits for commit
                continue
            if not p.resolved:
                p.slot, p.exists = self.resolver(p)
                p.resolved = True
            if p.slot in used_slots:
                # Eviction collision: defer as-is; same-key successors
                # must stay behind it.
                deferred.append(p)
                seen_keys.add(p.key)
                continue
            cur.append(p)
            seen_keys.add(p.key)
            used_slots.add(p.slot)
        self.queue = deferred
        return cur


def make_store_resolver(table, algo_mirror, store, inject_fn, now_ms: int):
    """Slot resolution wrapped with the reference's Store call pattern:
    cache miss -> store.get -> inject (algorithms.go:26-33); cached item
    with switched algorithm -> store.remove + re-get
    (algorithms.go:54-62,196-204).  `algo_mirror` is the shard's host
    copy of each slot's algorithm."""

    def resolve(p):
        slot, exists = table.lookup_or_assign(p.key, now_ms)
        req = p.req
        if exists and algo_mirror[slot] != int(req.algorithm):
            # Algorithm switch: reference removes from cache AND store,
            # then re-reads the store on the retry pass.
            store.remove(p.key)
            item, ok = store.get(req)
            if ok and item is not None and int(item.algorithm) == int(req.algorithm):
                inject_fn(slot, item)
                return slot, True
            return slot, False
        if not exists:
            item, ok = store.get(req)
            if ok and item is not None and int(item.algorithm) != int(req.algorithm):
                # c.Add + failed type-cast -> remove both + re-get.
                store.remove(p.key)
                item, ok = store.get(req)
            if ok and item is not None:
                inject_fn(slot, item)
                # An already-expired store item is recreated by the
                # kernel's expiry check rather than resurrected (as in
                # the JAX package; the reference trusts store items
                # without re-checking ExpireAt for one request).
                return slot, True
        return slot, exists

    return resolve


def item_to_rows(item) -> "buckets.BucketRows":
    """One SPI CacheItem as a one-lane BucketRows (numpy)."""
    from ..store import LeakyBucketItem

    v = item.value
    if isinstance(v, LeakyBucketItem):
        return buckets.BucketRows(
            algo=np.array([int(Algorithm.LEAKY_BUCKET)], np.int32),
            limit=np.array([v.limit], np.int64),
            remaining=np.array([int(v.remaining * buckets.LEAKY_SCALE)], np.int64),
            duration=np.array([v.duration], np.int64),
            stamp=np.array([v.updated_at], np.int64),
            expire_at=np.array([item.expire_at], np.int64),
            status=np.array([0], np.int32),
        )
    return buckets.BucketRows(
        algo=np.array([int(Algorithm.TOKEN_BUCKET)], np.int32),
        limit=np.array([v.limit], np.int64),
        remaining=np.array([v.remaining], np.int64),
        duration=np.array([v.duration], np.int64),
        stamp=np.array([v.created_at], np.int64),
        expire_at=np.array([item.expire_at], np.int64),
        status=np.array([int(v.status)], np.int32),
    )


def _rows_to_items(keys, rows):
    """Gathered rows as SPI CacheItems (store.go:11-24)."""
    from ..store import CacheItem, LeakyBucketItem, TokenBucketItem

    algo = np.asarray(rows.algo)
    limit = np.asarray(rows.limit)
    remaining = np.asarray(rows.remaining)
    duration = np.asarray(rows.duration)
    stamp = np.asarray(rows.stamp)
    expire = np.asarray(rows.expire_at)
    status = np.asarray(rows.status)
    items = []
    for i, key in enumerate(keys):
        if algo[i] == int(Algorithm.LEAKY_BUCKET):
            value = LeakyBucketItem(
                limit=int(limit[i]),
                duration=int(duration[i]),
                remaining=remaining[i] / buckets.LEAKY_SCALE,
                updated_at=int(stamp[i]),
            )
        else:
            value = TokenBucketItem(
                limit=int(limit[i]),
                duration=int(duration[i]),
                remaining=int(remaining[i]),
                created_at=int(stamp[i]),
                status=int(status[i]),
            )
        items.append(
            CacheItem(algorithm=int(algo[i]), key=key, value=value, expire_at=int(expire[i]))
        )
    return items


class _Columns:
    """Request fields as contiguous arrays (one entry per lane)."""

    __slots__ = ("algo", "behavior", "hits", "limit", "duration",
                 "greg_expire", "greg_duration")


_I32_MAX = (1 << 31) - 1


def make_columns(algorithm, behavior, hits, limit, duration, n,
                 greg_expire=None, greg_duration=None) -> _Columns:
    """Coerce caller-provided arrays into contiguous columns."""
    cols = _Columns()
    cols.algo = np.ascontiguousarray(algorithm, dtype=np.int32)
    cols.behavior = np.ascontiguousarray(behavior, dtype=np.int32)
    cols.hits = np.ascontiguousarray(hits, dtype=np.int64)
    cols.limit = np.ascontiguousarray(limit, dtype=np.int64)
    cols.duration = np.ascontiguousarray(duration, dtype=np.int64)
    z = np.zeros(n, dtype=np.int64)
    cols.greg_expire = (
        z if greg_expire is None else np.ascontiguousarray(greg_expire, np.int64)
    )
    cols.greg_duration = (
        z if greg_duration is None else np.ascontiguousarray(greg_duration, np.int64)
    )
    return cols


def narrow_ok(cols: _Columns, now_ms: int) -> bool:
    """True when every value column fits the int32 output deltas (the
    narrow kernel's precondition)."""
    hi = _I32_MAX
    for a in (cols.hits, cols.limit, cols.duration):
        if a.size and (int(a.min()) < 0 or int(a.max()) > hi):
            return False
    mask = cols.greg_duration != 0
    if mask.any():
        d = cols.greg_expire[mask] - now_ms
        if int(d.min()) < 0 or int(d.max()) > hi or int(cols.greg_duration.max()) > hi:
            return False
    return True


def decode_narrow(table, keys, slots, pn, now_ms: int, passthrough_exp):
    """Decode one narrow packed result (i32[4, n]) in Python: -2
    keep-sentinel lanes take the slot table's expiry while the slot
    still maps the lane's key, else the plan-time snapshot
    `passthrough_exp`.  The mesh store decodes in C++
    (gt_mesh_finish_narrow) with the same rule."""
    te = passthrough_exp
    sent = np.nonzero(pn[2] == -2)[0]
    if sent.size:
        te = passthrough_exp.copy()
        cur = table.get_expire_bulk(slots)
        for j in sent:
            if table.get_slot(keys[j]) == slots[j]:
                te[j] = cur[j]
    return buckets.unpack_output32(pn, now_ms, te)


def _readback(out: torch.Tensor) -> Callable[[], np.ndarray]:
    """Start the device->host copy of a packed result and return the
    blocking fetch.  On the card the copy lands in a pinned buffer
    behind a recorded event; a CPU result is already complete."""
    if out.device.type != "cuda":
        return out.numpy
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def fetch() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return fetch


def readback_retries_total() -> int:
    """Readbacks retried (gubernator_readback_retries_total).  The JAX
    package retries a jax CPU readback flake once; a CUDA readback has
    no such flake and is never retried, so the count stays 0."""
    return 0


class _SharedFetch:
    """One readback for a fused launch group: the K batches' results
    ride one stacked tensor, copied once; each handle reads its slice."""

    __slots__ = ("_fetch", "_lock", "_np")

    def __init__(self, fetch):
        self._fetch = fetch
        self._lock = threading.Lock()
        self._np = None

    def get(self, i: int) -> np.ndarray:
        with self._lock:
            if self._np is None:
                self._np = self._fetch()
                self._fetch = None
            return self._np[i]


def resolve_device(device=None) -> torch.device:
    """A store's device: `device` when given, else the current CUDA
    device.  Never falls back to the CPU: callers who want the CPU (the
    tests) ask for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`; on the card through a pinned
    buffer with a non-blocking copy on the current stream."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


@dataclass
class _Staged:
    """A prepared batch between the stage and launch steps: its inputs
    are already on the device.  `launch` runs it alone; same-`fuse_key`
    neighbours waiting at the launch gate launch as one group.

    An express batch (ops/scalar.py) has `scalar` instead of a kernel:
    a host closure that evaluates its lanes and writes their rows in
    place, returning the packed output the ordinary commit decodes.  It
    runs at the batch's launch turn under the store lock, never fuses,
    and commits in ticket order like any batch."""

    kernel: Optional[Callable]  # ops/buckets.py bucket_rounds_dict or bucket_rounds_cols
    args: tuple  # the kernel's arguments after (hot, cold)
    fuse_key: object = None  # None = not fuse-eligible (per-lane-column wire)
    wide: bool = False
    scalar: Optional[Callable] = None

    def launch(self, state) -> torch.Tensor:
        """Apply the batch to `state` in place; returns the packed output."""
        return self.kernel(state.hot, state.cold, *self.args)


class ColumnsHandle:
    """Deferred result of one pipelined columnar batch.  Commits apply
    strictly in dispatch order — result() drains every older in-flight
    batch — but the readback waits run outside the ordering lock."""

    def __init__(self, store, commit_fn, limit_col, hits_col=None):
        self._store = store
        self._fetch_fn: Optional[Callable] = None  # set by the launch
        self._commit_fn = commit_fn
        self._fetched = None
        self._fetch_lock = threading.Lock()
        self._launched = threading.Event()
        self._launch_exc: Optional[BaseException] = None
        self._exc: Optional[BaseException] = None
        self._limit = limit_col
        # The batch's hits: the commit decode notes the granted ones in
        # the conservation ledger (audit.py applied_hits).
        self._hits = hits_col
        self._value = None
        self.ticket = -1  # plan-order reservation (set by the pipeline)
        self.done = False
        # tracing.BatchTrace of the submitting batcher (None when the
        # batch carried no sampled lanes): its stage spans parent under
        # the batch's window span.
        self._trace = None

    def _launch_ok(self, fetch_fn) -> None:
        self._fetch_fn = fetch_fn
        self._launched.set()

    def _launch_fail(self, exc: BaseException) -> None:
        self._launch_exc = exc
        self._launched.set()

    def _fetch(self):
        """Blocking readback; idempotent, safe from any thread.  Returns
        None when the handle already resolved."""
        with self._fetch_lock:
            if self.done:
                return None
            if self._fetched is None:
                self._launched.wait()
                if self._launch_exc is not None:
                    raise self._launch_exc
                self._fetched = self._fetch_fn()
                self._fetch_fn = None
            return self._fetched

    def _do_resolve(self) -> None:
        try:
            t0 = time.perf_counter()
            with profiling.scope("dispatch.fetch"):
                packed_np = self._fetch()
            dt = time.perf_counter() - t0
            self._store._observe_stage("fetch", dt)
            tracing.stage_span("fetch", dt, self._trace)
            t1 = time.perf_counter()
            with profiling.scope("dispatch.commit"):
                status, remaining, reset = self._commit_fn(packed_np)
            dt = time.perf_counter() - t1
            self._store._observe_stage("commit", dt)
            tracing.stage_span("commit", dt, self._trace)
        except Exception as e:  # noqa: BLE001 — surfaced at result()
            self._finish(exc=e)
            return
        # Conservation ledger, from the decode the commit produced: hits
        # GRANTED (UNDER_LIMIT lanes) and the negative-remaining tripwire.
        hits, self._hits = self._hits, None  # may view a caller's buffer
        if hits is not None:
            st = np.asarray(status)
            n = min(len(hits), len(st))
            audit.note("applied_hits", int(np.asarray(hits[:n])[st[:n] == 0].sum()))
            neg = int((np.asarray(remaining) < 0).sum())
            if neg:
                audit.note("negative_remaining", neg)
        self._value = {
            "status": status,
            "limit": self._limit,
            "remaining": remaining,
            "reset_time": reset,
        }
        self._finish()

    def _finish(self, exc: Optional[BaseException] = None) -> None:
        # Drop the closures: they pin the planner and the device output.
        self._exc = exc
        self._commit_fn = None
        with self._fetch_lock:
            self._fetched = None
            self.done = True

    def result(self) -> dict:
        if not self.done:
            try:
                self._fetch()  # overlap readbacks across waiter threads
            except Exception:  # noqa: BLE001
                pass  # the ordered drain records it as this handle's outcome
            self._store._drain_until(self)
        if self._exc is not None:
            raise self._exc
        return self._value


def _drained_locked(fn):
    """Run a mutator with the pipeline drained and the plan and store
    locks held (ColumnarPipeline._drain_then_lock): it must observe every
    in-flight columnar batch's commits, and no new batch may plan
    against the state it mutates."""

    def wrapper(self, *args, **kwargs):
        self._drain_then_lock()
        try:
            return fn(self, *args, **kwargs)
        finally:
            self._unlock_drained()

    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def tables_get_slots(tables, keys) -> Tuple[np.ndarray, np.ndarray]:
    """(shard i32[n], slot i32[n]) of each key in a store's per-shard
    slot tables, slot -1 where the key is not mapped: one C++ call over
    native tables, key by key in the Python SlotTable of a one-shard
    store."""
    if isinstance(tables[0], native.NativeSlotTable):
        return native.mesh_get_slots(tables, keys)
    (table,) = tables
    slot = np.fromiter((-1 if (s := table.get_slot(k)) is None else s for k in keys),
                       np.int32, count=len(keys))
    return np.zeros_like(slot), slot


def tables_lookup_or_assign(tables, keys, now_ms: int):
    """(shard i32[n], slot i32[n], exists bool[n]): each key's
    `lookup_or_assign` in its shard's table, key by key in order."""
    if isinstance(tables[0], native.NativeSlotTable):
        return native.mesh_lookup_or_assign(tables, keys, now_ms)
    (table,) = tables
    slot = np.empty(len(keys), np.int32)
    exists = np.zeros(len(keys), bool)
    for j, k in enumerate(keys):
        slot[j], exists[j] = table.lookup_or_assign(k, now_ms)
    return np.zeros_like(slot), slot, exists


def tables_set_expire(tables, shard, slot, expire) -> None:
    """Set the table expiry of (shard[i], slot[i]) to expire[i], in
    order."""
    if isinstance(tables[0], native.NativeSlotTable):
        native.mesh_set_expire(tables, shard, slot, expire)
        return
    (table,) = tables
    for j in range(len(slot)):
        table.set_expire(int(slot[j]), int(expire[j]))


class ColumnarPipeline:
    """Mixin: the overlapped dispatch pipeline for columnar batches.

      1. PREPARE — slot-table planning under `_plan_lock`; the batch's
         position in plan order is its TICKET, and the `_inflight` FIFO
         is the commit order.
      2. STAGE — pack the wire and start its upload (no locks).
      3. LAUNCH — in ticket order, under `_lock`: the kernel launch.
         Consecutive same-shape batches already staged at the gate
         launch as one group (K launches in stream order, one readback).
      4. FETCH (no locks) and COMMIT (FIFO under `_drain_lock`).

    Locks, in acquisition order: `_plan_lock`, `_drain_lock`, `_lock`.
    Batch N+1's prepare overlaps batch N's commit; the C++ slot tables
    carry their own per-table mutex and per-slot pending-write counts
    keep in-flight slots from being evicted.
    """

    # Largest launch group; groups are 1, 2 or 4 batches.
    MAX_FUSE = 4
    # Store topology in the telemetry labels of its launches.
    _PROGRAM_KIND = "shard"

    def _init_pipeline(self) -> None:
        self._inflight: "deque[ColumnsHandle]" = deque()
        self._drain_lock = threading.Lock()
        self._plan_lock = threading.Lock()
        self._launch_cv = threading.Condition()
        self._next_ticket = 0
        self._next_launch = 0
        self._launch_gate: Dict[int, tuple] = {}  # ticket -> (_Staged, handle)
        self._launch_aborted: set = set()  # tombstoned tickets
        # Launch groups issued by this store (a fused group counts once).
        self.device_dispatches = 0
        # Express scalar applies (ops/scalar.py): batches answered by
        # the host slot, counted apart (a scalar apply launches nothing).
        self.scalar_applies = 0
        # The express slot's switch, off at the store level: a service
        # turns it on; bare stores launch every batch.
        self.scalar_fast_path = False
        # Widest batch the express slot serves (a service sets it from
        # GUBER_EXPRESS_MAX_LANES).  Its lanes apply one after another in
        # submission order (the semantics the rounds and duplicate groups
        # reproduce), so the cap bounds the host loop's cost, not
        # correctness.
        self.scalar_max_lanes = 4
        # Kernel launches of the persistence plane: one row gather per
        # snapshot_columns, gather + scatter per commit_transfer.
        self.transfer_drain_dispatches = 0
        self.transfer_commit_dispatches = 0
        # Per-stage (count, total s, max s) since the last
        # take_pipeline_stats, and the in-flight depth's high-water mark.
        self._stage_stats: Dict[str, list] = {}
        self._stats_lock = threading.Lock()
        self._depth_hwm = 0

    # -- observability -------------------------------------------------
    def _observe_stage(self, stage: str, dt: float) -> None:
        # The five dispatch stages are phases dispatch.<stage>; a part
        # of one (prepare.planner, ...) is a phase of its own name.
        saturation.observe_phase(stage if "." in stage else f"dispatch.{stage}", dt)
        with self._stats_lock:
            st = self._stage_stats.setdefault(stage, [0, 0.0, 0.0])
            st[0] += 1
            st[1] += dt
            st[2] = max(st[2], dt)

    def _tally(self, *counts: Tuple[str, int]) -> None:
        """Counts beside the stage timings (`wire.*`: lanes or bytes),
        each kept as (times, sum, max) and drained by take_pipeline_stats
        together; not seconds, so they feed no phase."""
        with self._stats_lock:
            for name, value in counts:
                st = self._stage_stats.setdefault(name, [0, 0, 0])
                st[0] += 1
                st[1] += value
                st[2] = max(st[2], value)

    def pipeline_depth(self) -> int:
        """Batches dispatched but not yet resolved."""
        return len(self._inflight)

    def occupancy_stats(self) -> List[dict]:
        """Per-shard occupancy from the host slot tables (no launch):
        used and capacity slots, evictions, and with a back tier its
        used rows and capacity."""
        back_cap = int(getattr(self, "back_capacity_per_shard", 0) or 0)
        out = []
        for s, t in enumerate(self._tables()):
            row = {"shard": s, "used": len(t), "capacity": int(t.capacity),
                   "evictions": int(t.evictions)}
            if back_cap:
                # tier_stats: (total, back_keys, demotions, promotions,
                # back_evictions).
                row["back_used"] = int(t.tier_stats[1])
                row["back_capacity"] = back_cap
            out.append(row)
        return out

    def take_pipeline_stats(self):
        """Drain the per-stage aggregates since the last call:
        ({stage: (count, total_s, max_s)}, depth, depth high-water mark).
        The stages are the five dispatch stages and parts of them:
        `prepare.plan_lock_wait` (the acquire of `_plan_lock`, inside
        `prepare`) and, on a mesh store, each plan's C++ timings
        (`prepare.planner`, `prepare.table_lock_wait` and
        `commit.table_lock_wait`).  Beside them, counts of each batch
        that launches a kernel, (batches, sum, max): `wire.lanes` (live
        lanes), `wire.slots` (the lane slots shipped, shards x padded
        lanes) and `wire.up_bytes` (the wire's tensors); and of each
        readback, `wire.down_bytes` (a fused group's shared readback
        counts once)."""
        with self._stats_lock:
            out = {k: tuple(v) for k, v in self._stage_stats.items()}
            self._stage_stats.clear()
            hwm = self._depth_hwm
            self._depth_hwm = len(self._inflight)
        return out, len(self._inflight), hwm

    def _padded_lanes(self, prep) -> int:
        """Lanes one launch of `prep` covers (the mesh pads per shard)."""
        return prep.padded

    # -- the dispatch stages -------------------------------------------
    def _submit_pipelined(self, keys, cols, now_ms: int,
                          force_wire: Optional[str] = None) -> ColumnsHandle:
        bt = tracing.take_batch_trace()  # staged by the batcher (if sampled)
        t0 = time.perf_counter()
        # Conservation ledger: hits entering the launch pipeline (the
        # earlier-layer twin of applied_hits at commit).
        audit.note("dispatched_hits", int(cols.hits.sum()))
        # The express slot is decided before the plan, which it pins to
        # the wide decode.
        use_scalar = force_wire is None and self._scalar_eligible(cols)
        with profiling.scope("prepare.plan_lock_wait"):
            t_lock = time.perf_counter()
            self._plan_lock.acquire()
            lock_wait = time.perf_counter() - t_lock
        try:
            with profiling.scope("dispatch.prepare"):
                prep = self._prepare_columns(keys, cols, now_ms,
                                             "wide" if use_scalar else force_wire)
                handle = ColumnsHandle(self, prep.commit, cols.limit, cols.hits)
                handle._trace = bt
                handle.ticket = self._next_ticket
                self._next_ticket += 1
                self._inflight.append(handle)
                with self._stats_lock:
                    self._depth_hwm = max(self._depth_hwm, len(self._inflight))
        finally:
            self._plan_lock.release()
        dt = time.perf_counter() - t0
        self._observe_stage("prepare", dt)
        self._observe_stage("prepare.plan_lock_wait", lock_wait)
        tracing.stage_span("prepare", dt, bt, ticket=handle.ticket, lanes=len(keys))
        saturation.lane_util.add(len(keys), self._padded_lanes(prep))
        try:
            t1 = time.perf_counter()
            with profiling.scope("dispatch.stage"):
                staged = self._stage_scalar(prep) if use_scalar else self._stage_columns(prep)
            dt = time.perf_counter() - t1
            self._observe_stage("stage", dt)
            tracing.stage_span("stage", dt, bt)
            if staged.scalar is None:
                up = sum(a.nbytes for a in staged.args if isinstance(a, torch.Tensor))
                self._tally(("wire.lanes", len(keys)),
                            ("wire.slots", self._padded_lanes(prep)), ("wire.up_bytes", up))
        except BaseException as e:
            self._abort_launch_turn(handle, e)
            raise
        self._launch_in_order(handle, staged)
        return handle

    def _retire_aborted_locked(self) -> None:
        """Advance past tombstoned tickets; `_launch_cv` held."""
        while self._next_launch in self._launch_aborted:
            self._launch_aborted.discard(self._next_launch)
            self._next_launch += 1
        self._launch_aborted = {
            t for t in self._launch_aborted if t > self._next_launch
        }

    def _abort_launch_turn(self, group_or_handle, exc: BaseException) -> None:
        """Mark the handle(s) failed and retire their launch turns
        without blocking, so a failed stage never wedges younger
        tickets."""
        handles = (
            [h for _, h in group_or_handle]
            if isinstance(group_or_handle, list) else [group_or_handle]
        )
        for h in handles:
            h._launch_fail(exc)
        with self._launch_cv:
            for h in handles:
                self._launch_gate.pop(h.ticket, None)
                self._launch_aborted.add(h.ticket)
            self._retire_aborted_locked()
            self._launch_cv.notify_all()

    def _launch_in_order(self, handle: ColumnsHandle, staged: _Staged) -> None:
        ticket = handle.ticket
        group = None
        try:
            with self._launch_cv:
                if self._next_launch != ticket:
                    self._launch_gate[ticket] = (staged, handle)
                    while (self._next_launch != ticket
                           and not handle._launched.is_set()):
                        self._launch_cv.wait(0.1)
                    self._launch_gate.pop(ticket, None)
                    if handle._launched.is_set():
                        return  # an older launcher took it into its group
                group = [(staged, handle)]
                if staged.fuse_key is not None:
                    avail = []
                    nt = ticket + 1
                    while (len(avail) < self.MAX_FUSE - 1
                           and nt in self._launch_gate
                           and self._launch_gate[nt][0].fuse_key == staged.fuse_key):
                        avail.append(nt)
                        nt += 1
                    take = 3 if len(avail) >= 3 else (1 if avail else 0)
                    for t2 in avail[:take]:
                        group.append(self._launch_gate.pop(t2))
        except BaseException as e:  # interrupt mid-wait/collect
            self._abort_launch_turn(group or handle, e)
            raise
        exc: Optional[BaseException] = None
        t0 = time.perf_counter()
        try:
            with self._lock, profiling.scope("dispatch.launch"):
                self._launch_group(group)
        except BaseException as e:  # noqa: BLE001
            exc = e
        dt = time.perf_counter() - t0
        self._observe_stage("launch", dt)
        # Lane-time pool (profiling.py): these lanes rode a launch of
        # this wall cost, the tenant ledger's proportional share.
        profiling.note_lane_time(sum(len(h._limit) for _, h in group), dt)
        for _, h in group:
            # One launch span per batch (each batch of a group sees it).
            tracing.stage_span("launch", dt, h._trace, fused=len(group))
        if exc is not None:
            for _, h in group:
                h._launch_fail(exc)
        with self._launch_cv:
            self._next_launch = ticket + len(group)
            self._retire_aborted_locked()
            self._launch_cv.notify_all()
        if exc is not None:
            raise exc

    def _fused_launch_fn(self, k: int, wide: bool):
        """Hook: the K-batch launch for this store."""
        raise NotImplementedError

    def _pre_launch(self) -> None:
        """Hook: device work that must precede the group's launches (the
        mesh store drains its queued tier moves here)."""

    def _scalar_eligible(self, cols) -> bool:
        """Hook: whether this batch takes the express scalar slot
        instead of a launch (stores with one override)."""
        return False

    def _stage_scalar(self, prep) -> _Staged:
        raise NotImplementedError

    def _launch_group(self, group) -> None:
        """Launch (ticket order, under `_lock`).  A multi-batch group
        writes one stacked result, read back once.  An express batch
        (always alone: it never fuses) runs its host closure instead:
        the plain versions it follows ran synchronously, so the rows are
        final when it reads them."""
        if len(group) == 1 and group[0][0].scalar is not None:
            staged, h = group[0]
            packed = staged.scalar()
            self.scalar_applies += 1
            saturation.note_express("scalar", len(h._limit))
            h._launch_ok(lambda: packed)
            return
        self._pre_launch()
        self.device_dispatches += 1
        with telemetry.program(self._program_label(group)):
            if len(group) == 1:
                staged, h = group[0]
                out = staged.launch(self.state)
                self._tally(("wire.down_bytes", out.nbytes))
                h._launch_ok(_readback(out))
                return
            stacked = self._fused_launch_fn(len(group), group[0][0].wide)(
                self.state, [s for s, _ in group])
        self._tally(("wire.down_bytes", stacked.nbytes))
        shared = _SharedFetch(_readback(stacked))
        for i, (_, h) in enumerate(group):
            h._launch_ok(lambda i=i: shared.get(i))

    def _program_label(self, group) -> str:
        """Telemetry label of one launch group (the JAX package's
        program identity): store topology, solo or fused-K, and wire
        width."""
        shape = "solo" if len(group) == 1 else f"fused{len(group)}"
        width = "wide" if group[0][0].wide else "narrow"
        return f"{self._PROGRAM_KIND}:dispatch:{shape}:{width}"

    # -- host <-> device transfers and the row plane (both stores) -----
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return upload(a, self.device)

    def _read_rows(self, lanes: np.ndarray) -> buckets.BucketRows:
        """The rows at host lanes i32[2, M] (shard, slot), one row-gather
        launch, as host BucketRows."""
        return buckets.cols_to_rows(*self._gather_cols(lanes))

    def _gather_cols(self, lanes: np.ndarray, back: bool = False):
        """Host (c32, c64) of the front rows (or with `back`, the back
        tier's rows) at host lanes i32[2, M], one row-gather launch."""
        dev_lanes = self._upload(np.ascontiguousarray(lanes, np.int32))
        if back:
            c32, c64 = buckets.read_back_rows(self.back, dev_lanes)
        else:
            c32, c64 = buckets.gather_rows(self.state.hot, self.state.cold, dev_lanes)
        f32, f64 = _readback(c32), _readback(c64)
        return f32(), f64()

    def _write_rows(self, lanes: np.ndarray, c32: np.ndarray, c64: np.ndarray) -> None:
        """Write rows at host lanes i32[2, M] (distinct), one row-scatter
        launch."""
        buckets.write_rows(
            self.state.hot, self.state.cold,
            self._upload(np.ascontiguousarray(lanes, np.int32)),
            self._upload(np.ascontiguousarray(c32, np.int32)),
            self._upload(np.ascontiguousarray(c64, np.int64)))

    # -- Store SPI and the persistence plane (both stores) --------------
    def _tables(self) -> list:
        """Hook: the store's slot table of each shard, in shard order."""
        raise NotImplementedError

    def _mirror(self) -> np.ndarray:
        """The host algorithm mirror as [S, C] (a view: a ShardStore
        keeps its one shard's as [C])."""
        return self.algo_mirror.reshape(len(self._tables()), -1)

    def _store_resolver(self, s: int, now_ms: int):
        return make_store_resolver(
            self._tables()[s], self._mirror()[s], self.store,
            lambda slot, item: self._inject(s, slot, item), now_ms,
        )

    def _inject(self, s: int, slot: int, item) -> None:
        """Write a store item's row at (s, slot): one row-scatter launch
        with one lane, in stream order before the round's launch."""
        rows = item_to_rows(item)
        self._mirror()[s, slot] = int(rows.algo[0])
        self._write_rows(np.array([[s], [slot]], np.int32), *buckets.rows_to_cols(rows))
        self._tables()[s].set_expire(slot, item.expire_at)

    def _fire_store_callbacks(self, chunks, cached, removed) -> None:
        """store.remove for removed lanes, store.on_change with the
        lane's row after the round for the others (the deferred
        s.OnChange, algorithms.go:64-68), shard-major in chunk order.
        `chunks` holds each shard's round, `cached` and `removed` are
        bool [S, P] (replica-cache answers never touch the store).  One
        row gather serves every shard."""
        live = [[] for _ in chunks]
        for s, chunk in enumerate(chunks):
            live[s] = [(i, p) for i, p in enumerate(chunk)
                       if not cached[s, i] and p.slot >= 0 and not removed[s, i]]
        lanes = [(s, p.slot) for s in range(len(chunks)) for _, p in live[s]]
        rows = self._read_rows(np.array(lanes, np.int32).T) if lanes else None
        at = 0
        for s, chunk in enumerate(chunks):
            for i, p in enumerate(chunk):
                if not cached[s, i] and p.slot >= 0 and removed[s, i]:
                    self.store.remove(p.key)
            if not live[s]:
                continue
            n = len(live[s])
            items = _rows_to_items([p.key for _, p in live[s]],
                                   buckets.BucketRows(*(f[at:at + n] for f in rows)))
            at += n
            for (_, p), item in zip(live[s], items):
                self.store.on_change(p.req, item)

    @_drained_locked
    def snapshot_columns(self, now_ms: int) -> TransferColumns:
        """Durability dump (snapshot.py): every resident key's full row,
        gathered with one row-gather launch.  The tables keep their keys;
        a mesh's owner-side GLOBAL buckets are included (they restore as
        ordinary rows).  Warmup keys stay out of the file."""
        keys = [k for t in self._tables() for k in t.keys()
                if not k.startswith("__warmup__")]
        return self._gather_transfer_locked(keys, now_ms)

    # -- resharding: the sending half of the handoff (reshard.py) -------
    @_drained_locked
    def resident_keys(self) -> List[str]:
        """Every key resident in the (front) slot tables, shard by shard:
        the ring-delta scan of a handoff.  Back-tier rows do not migrate
        (the cold tail; a stale row at the old owner ages out of the
        FIFO).  No launch; under the plan lock, as the tables' key
        enumeration is a size-then-fill marshal."""
        return [k for t in self._tables() for k in t.keys()]

    def resident_mask(self, keys) -> np.ndarray:
        """bool[n]: which keys map to a slot now (the handoff peek's
        observe-don't-create filter: a zero-hit launch for an absent key
        would mint a bucket that later rides a transfer).  Plain lists
        and PackedKeys alike; guarded lookups, no plan lock."""
        if not len(keys):
            return np.zeros(0, dtype=bool)
        return tables_get_slots(self._tables(), keys)[1] >= 0

    @_drained_locked
    def drain_keys(self, keys, now_ms: int, remove: bool = True) -> TransferColumns:
        """The rows of moved keys, with one row-gather launch (K7),
        atomically with respect to launches (pipeline drained, plan lock
        held).  With `remove` the keys also leave the tables (and a
        two-tier table's back tier); the handoff passes remove=False and
        calls forget_keys() once the transfer is acknowledged, so the old
        owner's copy stays readable for the double-dispatch peek.  Keys
        no longer resident, and a mesh's GLOBAL keys (they move through
        their own replication plane), are skipped; expired rows are not
        shipped."""
        return self._gather_transfer_locked(keys, now_ms, remove=remove,
                                            skip_global=True)

    @_drained_locked
    def forget_keys(self, keys) -> None:
        """Drop keys from the tables (no launch: a freed slot's stale row
        is overwritten on reassignment).  The handoff calls it once a
        transfer is acknowledged."""
        tables = self._tables()
        if len(tables) == 1:
            for k in keys:
                tables[0].remove(k)
            return
        shard, _slot = tables_get_slots(tables, keys)
        for k, s in zip(keys, shard.tolist()):
            tables[s].remove(k)

    def _gather_transfer_locked(self, keys, now_ms: int, remove: bool = False,
                                skip_global: bool = False) -> TransferColumns:
        """The rows of `keys` at their owner shards (keys no longer
        mapped are skipped, and with `skip_global` a mesh's GLOBAL keys),
        shard-major and in key order within a shard as the JAX stores
        lay them out, minus rows already expired.  With `remove` every
        found key leaves its table, expired or not."""
        gtable = getattr(self, "gtable", None)
        if skip_global and gtable is not None and gtable._key_to_gslot:  # noqa: SLF001
            gkeys = gtable._key_to_gslot  # noqa: SLF001
            keys = [k for k in keys if k not in gkeys]
        shard, slot = tables_get_slots(self._tables(), keys)
        found = np.nonzero(slot >= 0)[0]
        if not found.size:
            return TransferColumns.empty()
        self._pre_launch()  # land queued tier moves before reading rows
        order = found[np.argsort(shard[found], kind="stable")]
        rows = self._read_rows(np.stack([shard[order], slot[order]]))
        self.transfer_drain_dispatches += 1
        self.device_dispatches += 1
        if remove:
            tables = self._tables()
            for i in order.tolist():
                tables[int(shard[i])].remove(keys[i])
        live = np.nonzero(rows.expire_at >= now_ms)[0]
        return TransferColumns(
            keys=[keys[i] for i in order[live].tolist()],
            algorithm=rows.algo[live].astype(np.int32),
            status=rows.status[live].astype(np.int32),
            limit=rows.limit[live].astype(np.int64),
            remaining=rows.remaining[live].astype(np.int64),
            duration=rows.duration[live].astype(np.int64),
            stamp=rows.stamp[live].astype(np.int64),
            expire_at=rows.expire_at[live].astype(np.int64),
        )

    @_drained_locked
    def commit_transfer(self, cols: TransferColumns, now_ms: int) -> int:
        """Commit a batch of full rows (a snapshot restore, a Loader's
        items): assign slots for the whole batch in the host tables,
        gather the current rows (one launch), merge monotonically on the
        host (reshard.merge_transfer_rows: an idempotent min/max, so a
        re-delivered or late batch cannot double-count), and scatter the
        merged rows back (one launch).  Returns the lanes committed."""
        if len(cols) == 0:
            return 0
        # Dead rows (already expired) are not worth a slot.
        fresh = np.nonzero(np.asarray(cols.expire_at) >= now_ms)[0].tolist()
        # Duplicate keys keep the LAST lane, at the first one's place
        # (dict semantics, as the JAX stores order them).
        seen: Dict[str, int] = dict(zip([cols.keys[j] for j in fresh], fresh))
        if not seen:
            return 0
        idx = np.fromiter(seen.values(), dtype=np.int64, count=len(seen))
        tables = self._tables()
        shard_ix, slot_ix, exists_ix = tables_lookup_or_assign(tables, list(seen), now_ms)
        # The lookups may have queued promotions of back-tier keys: land
        # them before reading front rows.
        self._pre_launch()
        lanes = np.stack([shard_ix, slot_ix])
        cur = self._read_rows(lanes)
        merged = merge_transfer_rows(
            {"algo": cur.algo, "status": cur.status, "limit": cur.limit,
             "remaining": cur.remaining, "stamp": cur.stamp,
             "expire_at": cur.expire_at},
            cols, idx, now_ms, exists_ix,
        )
        c32, c64 = buckets.rows_to_cols(buckets.BucketRows(**merged))
        # A batch with more keys for a shard than its capacity evicts
        # keys of its own: the table maps their slot to the later key,
        # so the later lane is the one written.
        keep = buckets.last_lane_per_slot(shard_ix, slot_ix)
        self._write_rows(lanes[:, keep], c32[:, keep], c64[:, keep])
        self.transfer_commit_dispatches += 2
        self.device_dispatches += 2
        # Host mirrors: the algorithm (switch detection) and the table
        # expiry (planning, eviction), lane by lane.
        self._mirror()[shard_ix, slot_ix] = merged["algo"]
        tables_set_expire(tables, shard_ix, slot_ix, merged["expire_at"])
        return int(idx.size)

    def _drain_until(self, handle: ColumnsHandle) -> None:
        with self._drain_lock:
            if handle.done:
                return
            while self._inflight:
                h = self._inflight.popleft()
                h._do_resolve()
                if h is handle:
                    return
            if not handle.done:
                handle._do_resolve()

    def _drain_all(self) -> None:
        with self._drain_lock:
            while self._inflight:
                self._inflight.popleft()._do_resolve()

    def _drain_then_lock(self) -> None:
        """Acquire the plan + store locks with the pipeline empty (for
        mutators that read or replace the state wholesale).  Release
        with `_unlock_drained`."""
        self._plan_lock.acquire()
        while True:
            self._drain_all()
            self._lock.acquire()
            if not self._inflight:
                return
            self._lock.release()

    def _unlock_drained(self) -> None:
        self._lock.release()
        self._plan_lock.release()


def express_lane(hot, cold, slot: int, exists, occ, cols: _Columns, i: int,
                 now_ms: int):
    """Lane i of `cols` through the express slot (ops/scalar.py) against
    row `slot` of the writable views `hot`/`cold`; returns its packed
    wide output (status | removed << 1, remaining, reset_time,
    new_expire).  Exists is the planner's claim, except that a later
    occurrence of an analytic duplicate group (occ > 0) shares the first
    occurrence's claim: the earlier occurrence's write made the row
    live.  Round 1+ lanes of one key already carry exists=True, and a
    mid-batch slot takeover (another key, occ == 0, exists=False) must
    keep creating."""
    st, rem, reset, n_exp, removed = scalar_ops.apply_one(
        hot[slot], cold[slot],
        exists=bool(exists) or int(occ) > 0,
        algorithm=int(cols.algo[i]),
        behavior=int(cols.behavior[i]),
        hits=int(cols.hits[i]),
        limit=int(cols.limit[i]),
        duration=int(cols.duration[i]),
        greg_expire=int(cols.greg_expire[i]),
        greg_duration=int(cols.greg_duration[i]),
        now_ms=now_ms,
    )
    return st | (int(removed) << 1), rem, reset, n_exp


def _pad(src: np.ndarray, padded: int, dtype) -> np.ndarray:
    out = np.zeros(padded, dtype=dtype)
    out[: len(src)] = src
    return out


@dataclass
class _ShardPrep:
    """Output of ShardStore's prepare stage: the plan columns plus the
    commit closure, handed to the unlocked stage step."""

    cols: _Columns
    now_ms: int
    force_wire: Optional[str]
    n: int
    padded: int
    n_rounds: int
    narrow: bool
    slot_col: np.ndarray
    rid_col: np.ndarray
    ex_col: np.ndarray
    occ_col: np.ndarray
    wr_col: np.ndarray
    commit: Callable


class ShardStore(ColumnarPipeline):
    """Bucket table of one shard on one device (the JAX package's
    ShardStore, the store its bench.py headlines and its service takes
    for a one-shard deployment).

    The state is a BucketState with S = 1 (hot/cold int32 [1, C, 8]),
    so the mesh store's kernels serve it unchanged: the columnar path
    plans in the C++ runtime (native.NativeBatchPlanner) and launches
    K1 on the dict wire, or K2 on per-lane columns (narrow, or wide
    under `force_wire="wide"` or with wide values) when the batch has
    more than 256 configs, an occurrence index above 65535 or more than
    255 rounds; same-shape dict batches staged together launch as one
    group.  Small batches on a CPU store take the express scalar slot
    when `scalar_fast_path` is on (ops/scalar.py).

    `store` is the optional persistence SPI (store.py): get() fulfils
    misses, on_change() observes every applied request, remove() fires
    on removals (algorithms.go:26-33,64-68,176-177).  With it, or with
    `use_native=False` (the Python SlotTable), `apply` runs one round
    per K2 launch with the host callbacks between rounds, and the
    columnar path is unavailable.  `device=None` is the current CUDA
    device (raises without one); "cpu" runs the plain versions.
    """

    def __init__(self, capacity: int = 50_000, device=None, store=None,
                 use_native: bool = True):
        self.capacity = capacity
        self.device = resolve_device(device)
        # The C++ runtime resolves keys and plans rounds; the Python
        # SlotTable is its twin for the per-round path.
        self._native = use_native
        self.table = native.NativeSlotTable(capacity) if use_native else SlotTable(capacity)
        self.store = store
        # Guards the state tensors: launches serialise on it.
        self._lock = threading.RLock()
        self.state = buckets.init_state(1, capacity, self.device)
        # Each slot's algorithm on the host, for the Store SPI's
        # algorithm-switch detection.
        self.algo_mirror = np.zeros(capacity, dtype=np.int32)
        self._init_pipeline()

    def describe_topology(self) -> Tuple[str, str]:
        """(device type, mesh shape): one shard is a 1-wide mesh."""
        return self.device.type, "1"

    # ------------------------------------------------------------------
    def apply(self, requests: Sequence[RateLimitRequest],
              now_ms: int) -> List[RateLimitResponse]:
        """Evaluate a batch; responses come back in request order."""
        responses: List[Optional[RateLimitResponse]] = [None] * len(requests)
        if self._native and self.store is None:
            # Rides the columnar pipeline.
            self._apply_native(requests, now_ms, responses)
            return [r if r is not None else RateLimitResponse() for r in responses]
        # Store SPI or Python table: host callbacks between rounds need
        # the lock across the whole batch.
        self._drain_then_lock()
        try:
            prepared = prepare_requests(requests, now_ms, responses)
            resolver = self._store_resolver(0, now_ms) if self.store is not None else None
            planner = RoundPlanner(self.table, prepared, now_ms, resolver=resolver)
            while True:
                chunk = planner.next_chunk()
                if not chunk:
                    break
                self._run_round(chunk, now_ms, responses)
            return [r if r is not None else RateLimitResponse() for r in responses]
        finally:
            self._unlock_drained()

    def _apply_native(self, requests, now_ms: int, responses) -> None:
        """The dataclass batch as columns through the pipeline; an
        invalid Gregorian duration is its lane's error."""
        greg = GregResolver(now_ms)
        keep: List[int] = []
        ge: List[int] = []
        gd: List[int] = []
        for i, req in enumerate(requests):
            e = d = 0
            if has_behavior(req.behavior, Behavior.DURATION_IS_GREGORIAN):
                cached = greg.resolve(req.duration)
                if isinstance(cached, gregorian.GregorianError):
                    responses[i] = RateLimitResponse(error=str(cached))
                    continue
                e, d = cached
            keep.append(i)
            ge.append(e)
            gd.append(d)
        if not keep:
            return
        reqs = [requests[i] for i in keep]
        m = len(reqs)
        cols = make_columns(
            np.fromiter((r.algorithm for r in reqs), np.int32, count=m),
            np.fromiter((r.behavior for r in reqs), np.int32, count=m),
            np.fromiter((r.hits for r in reqs), np.int64, count=m),
            np.fromiter((r.limit for r in reqs), np.int64, count=m),
            np.fromiter((r.duration for r in reqs), np.int64, count=m),
            m, np.asarray(ge, np.int64), np.asarray(gd, np.int64),
        )
        status, remaining, reset = self._run_columns([r.hash_key() for r in reqs], cols,
                                                     now_ms)
        for j, i in enumerate(keep):
            responses[i] = RateLimitResponse(
                status=int(status[j]), limit=int(cols.limit[j]),
                remaining=int(remaining[j]), reset_time=int(reset[j]),
            )

    def _run_columns(self, keys, cols: _Columns, now_ms: int):
        """One pipelined batch: (status, remaining, reset_time) arrays
        aligned to keys."""
        r = self._submit_pipelined(keys, cols, now_ms).result()
        return r["status"], r["remaining"], r["reset_time"]

    def _prepare_columns(self, keys, cols: _Columns, now_ms: int,
                         force_wire: Optional[str] = None) -> _ShardPrep:
        """Stage 1 (under `_plan_lock`): the C++ grouped plan, the
        pass-through expiry snapshot and the padded plan columns."""
        n = len(keys)
        planner = native.NativeBatchPlanner(self.table, keys, now_ms)
        round_id, slots, exists, occ, write, n_rounds = planner.plan_grouped(
            cols, int(Behavior.RESET_REMAINING))
        padded = pad_size(n)
        slot_col = _pad(slots, padded, np.int32)
        slot_col[n:] = -1
        rid_col = _pad(round_id, padded, np.int32)
        ex_col = _pad(exists, padded, bool)
        occ_col = _pad(occ, padded, np.int32)
        wr_col = _pad(write, padded, bool)
        narrow = narrow_ok(cols, now_ms) and force_wire != "wide"
        # Snapshot the pass-through expiry now: the -2 keep-sentinel
        # means "the kernel left this slot's pre-batch expiry unchanged",
        # and pre-batch is defined at plan time.  A later pipelined
        # batch's plan can evict or reassign these slots (zeroing their
        # expiry) before this batch commits.
        passthrough_exp = self.table.get_expire_bulk(slots) if narrow else None

        def commit(packed_np):
            packed_np = packed_np.reshape(4, -1)[:, :n]
            with self._lock:
                if narrow:
                    status, removed, remaining, reset, new_exp = decode_narrow(
                        self.table, keys, slots, packed_np, now_ms, passthrough_exp)
                else:
                    status, removed, remaining, reset, new_exp = buckets.unpack_output(
                        packed_np)
                planner.commit_plan(new_exp, removed)
                self.algo_mirror[slots] = cols.algo
                return status, remaining, reset

        return _ShardPrep(
            cols=cols, now_ms=now_ms, force_wire=force_wire, n=n, padded=padded,
            n_rounds=n_rounds, narrow=narrow, slot_col=slot_col, rid_col=rid_col,
            ex_col=ex_col, occ_col=occ_col, wr_col=wr_col, commit=commit,
        )

    def _stage_columns(self, prep: _ShardPrep) -> _Staged:
        """Stage 2 (no locks): encode the wire and start its upload.  The
        dict wire (K1) is fuse-eligible; the per-lane columns (K2)
        launch alone."""
        cols, now_ms, padded = prep.cols, prep.now_ms, prep.padded
        n_rounds, narrow = prep.n_rounds, prep.narrow
        dict_enc = None
        if (prep.force_wire is None and n_rounds <= 255
                and int(prep.occ_col.max(initial=0)) <= 65535):
            # Values ride the wire's 256-row i64 table, so wide batches
            # (monthly Gregorian, big limits) stay on it; only the
            # output widens.
            dict_enc = buckets.build_config_dict(cols, now_ms)
        if dict_enc is not None:
            cfg_idx, table = dict_enc
            wire = buckets.pack_dict_wire(
                prep.slot_col[None], prep.ex_col[None], prep.wr_col[None],
                _pad(cfg_idx, padded, np.uint8)[None], prep.occ_col[None],
                prep.rid_col[None], table)
            return _Staged(
                kernel=buckets.bucket_rounds_dict,
                args=(self._upload(wire), n_rounds, now_ms, not narrow),
                fuse_key=("dict", narrow, wire.shape[1]), wide=not narrow,
            )
        # K2's per-lane columns: narrow values are i32 with the Gregorian
        # expiry as a delta from now (0 where unused), wide ones i64
        greg = (np.where(cols.greg_duration != 0, cols.greg_expire - now_ms, 0) if narrow
                else cols.greg_expire)
        vdtype = np.int32 if narrow else np.int64
        flags = prep.ex_col.astype(np.int32) | (prep.wr_col.astype(np.int32) << 1)
        lanes = np.stack([prep.slot_col, flags, _pad(cols.algo, padded, np.int32),
                          _pad(cols.behavior, padded, np.int32), prep.occ_col,
                          prep.rid_col])[None]
        values = np.stack([_pad(v, padded, vdtype) for v in (
            cols.hits, cols.limit, cols.duration, greg, cols.greg_duration)])[None]
        return _Staged(
            kernel=buckets.bucket_rounds_cols,
            args=(self._upload(lanes), self._upload(values), n_rounds, now_ms, not narrow),
            wide=not narrow,
        )

    def _fused_launch_fn(self, k: int, wide: bool):
        """K same-shape dict-wire batches: K launches of K1 in stream
        order into one stacked [K, 4, P] result."""

        def run(state, group):
            return buckets.apply_rounds_packed_fused(
                state, [s.args[0] for s in group], [s.args[1] for s in group],
                [s.args[2] for s in group], wide)

        return run

    # -- express scalar slot (ops/scalar.py) ---------------------------
    def _scalar_eligible(self, cols) -> bool:
        """Small batches of a CPU store take the host slot when the
        switch is on; never on the card, whose batches take K1."""
        if not self.scalar_fast_path:
            return False
        if not 1 <= len(cols.hits) <= self.scalar_max_lanes:
            return False
        if not (self._native and self.store is None):
            return False
        return scalar_ops.device_is_cpu(self.device)

    def _stage_scalar(self, prep: _ShardPrep) -> _Staged:
        """Express stage: capture the plan's rows and return the host
        closure, which returns a packed [4, n] wide output."""
        cols = prep.cols
        n = prep.n
        slots = prep.slot_col[:n].copy()
        exists = prep.ex_col[:n].copy()
        occ = prep.occ_col[:n].copy()
        now_ms = prep.now_ms

        def run():
            hot = scalar_ops.shard_view(self.state.hot, 0)
            cold = scalar_ops.shard_view(self.state.cold, 0)
            packed = np.zeros((4, n), dtype=np.int64)
            for i in range(n):
                packed[:, i] = express_lane(hot, cold, int(slots[i]), exists[i], occ[i],
                                            cols, i, now_ms)
            return packed

        return _Staged(kernel=None, args=(), scalar=run)

    @property
    def supports_columns(self) -> bool:
        """Whether the columnar path is usable: the C++ runtime and no
        Store SPI."""
        return self._native and self.store is None

    def apply_columns(self, keys, algorithm, behavior, hits, limit, duration,
                      now_ms: int, greg_expire=None, greg_duration=None,
                      force_wire=None) -> dict:
        """Columnar bulk API: a dict of numpy arrays (status, limit,
        remaining, reset_time) aligned with `keys` (full hash keys);
        Gregorian lanes carry their precomputed expiry and duration."""
        return self.apply_columns_async(
            keys, algorithm, behavior, hits, limit, duration, now_ms,
            greg_expire, greg_duration, force_wire=force_wire).result()

    def apply_columns_async(self, keys, algorithm, behavior, hits, limit, duration,
                            now_ms: int, greg_expire=None, greg_duration=None,
                            force_wire=None) -> ColumnsHandle:
        """Pipelined apply_columns: returns once the batch is launched;
        `handle.result()` blocks on its readback.  `force_wire="wide"`
        forces the wide per-lane-column wire (a test and debugging aid)."""
        if force_wire not in (None, "wide"):
            raise ValueError(f"unknown force_wire {force_wire!r}")
        cols = self._make_columns(algorithm, behavior, hits, limit, duration, len(keys),
                                  greg_expire, greg_duration)
        return self._submit_pipelined(keys, cols, now_ms, force_wire)

    def _make_columns(self, algorithm, behavior, hits, limit, duration, n,
                      greg_expire, greg_duration) -> _Columns:
        if not self.supports_columns:
            raise RuntimeError(
                "apply_columns requires the native host runtime and no Store SPI")
        return make_columns(algorithm, behavior, hits, limit, duration, n,
                            greg_expire, greg_duration)

    # ------------------------------------------------------------------
    # Store SPI and the persistence plane (ColumnarPipeline's, at
    # shard 0: row gather K7, row scatter K8)
    # ------------------------------------------------------------------
    def _tables(self) -> list:
        return [self.table]

    @_drained_locked
    def load_item(self, item) -> None:
        """Loader.Load path: place one persisted item (gubernator.go:78-90)."""
        slot, _ = self.table.lookup_or_assign(item.key, 0)
        self._inject(0, slot, item)

    @_drained_locked
    def snapshot_items(self):
        """Loader.Save path (gubernator.go:93-111): every mapped slot as
        a CacheItem, after the in-flight batches committed."""
        keys = self.table.keys()
        if not keys:
            return []
        return _rows_to_items(keys, self._read_rows(np.stack(tables_get_slots([self.table],
                                                                              keys))))

    def _run_round(self, chunk: List[_Prepared], now_ms: int, responses) -> None:
        """One round: one K2 launch (the one-shard apply_batch), the
        table commit, the responses, then the Store callbacks."""
        b = len(chunk)
        arrays = build_round_arrays(chunk, pad_size(b))
        out = buckets.apply_batch(self.state, buckets.make_batch(*arrays), now_ms)
        self.table.commit(arrays[0][:b], out.new_expire[:b], out.removed[:b],
                          keys=[p.key for p in chunk])
        for i, p in enumerate(chunk):
            self.algo_mirror[p.slot] = int(p.req.algorithm)
            responses[p.pos] = RateLimitResponse(
                status=int(out.status[i]), limit=int(p.req.limit),
                remaining=int(out.remaining[i]), reset_time=int(out.reset_time[i]),
            )
        if self.store is not None:
            self._fire_store_callbacks([chunk], np.zeros((1, b), bool), out.removed[None, :b])

    # ------------------------------------------------------------------
    def size(self) -> int:
        return len(self.table)

    def load_state_numpy(self, hot, cold, entries, algo_mirror=None) -> None:
        """Replace this store's state with a JAX ShardStore's: `hot` and
        `cold` its [C, 8] rows (`np.asarray(store.state.hot)`; [1, C, 8]
        is taken too), `entries` its table's (keys, slots, expire), and
        `algo_mirror` its i32 [C] slot algorithms (zeros when not given).
        The keys are mapped in `entries`' order, which becomes the
        table's LRU order.  Afterwards both stores answer the next batch
        identically."""
        hot, cold = (np.asarray(a, np.int32).reshape(1, -1, 8) for a in (hot, cold))
        state = buckets.state_from_numpy(hot, cold, self.device)
        if state.hot.shape != self.state.hot.shape:
            raise ValueError(
                f"state shape {tuple(state.hot.shape)} != {tuple(self.state.hot.shape)}")
        mirror = np.zeros_like(self.algo_mirror)
        if algo_mirror is not None:
            mirror[:] = algo_mirror
        keys, slots, expire = entries
        self._drain_then_lock()
        try:
            table = (native.NativeSlotTable(self.capacity) if self._native
                     else SlotTable(self.capacity))
            table.commit(np.asarray(slots, np.int32), np.asarray(expire, np.int64),
                         np.zeros(len(keys), np.uint8), list(keys))
            self.table = table
            self.state = state
            self.algo_mirror = mirror
        finally:
            self._unlock_drained()
