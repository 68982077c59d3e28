"""Host side of the bucket stores: request columns, padding, Gregorian
precompute, the narrow-output decode and the overlapped dispatch
pipeline of the columnar path, the request preparation and round
planner of the dataclass path (`MeshBucketStore.apply`), and the Store
SPI's round planner, resolver and item <-> row conversions.

The port of the JAX package's models/shard.py (the parts the mesh
store's columnar and dataclass paths run).  Where the JAX package threads donated
device buffers through jitted calls, the port launches kernels on one
CUDA stream that update the state tensors in place: the wire goes up
from a pinned host buffer with a non-blocking copy, the packed result
comes back into a pinned buffer with a CUDA event recorded behind it,
and a handle's `result()` waits on that event before the C++ commit.
"""

from __future__ import annotations

import datetime as _dt
import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import buckets
from ..types import (
    Algorithm,
    Behavior,
    RateLimitRequest,
    RateLimitResponse,
    has_behavior,
)
from ..utils import gregorian

# Batches pad to a small set of bucket sizes (64, 256, 1024, then powers
# of two), as the JAX package does, so both stores plan identical
# padded shapes.
_PAD_MIN = 64
_PAD_COARSE_MAX = 1024
_PAD_MAX = 1 << 20


def pad_size(n: int) -> int:
    p = _PAD_MIN
    while p < n and p < _PAD_COARSE_MAX:
        p <<= 2
    while p < n and p < _PAD_MAX:
        p <<= 1
    if n <= p:
        return p
    return ((n + _PAD_MAX - 1) // _PAD_MAX) * _PAD_MAX


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
) -> List[_Prepared]:
    """Precompute per-request host-side values (hash key, Gregorian
    expiry/duration).  Requests with invalid Gregorian durations get
    error responses directly (reference returns the error per-request)."""
    greg = GregResolver(now_ms)
    prepared: List[_Prepared] = []

    for pos, req in enumerate(requests):
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
    at a time through a slot table's lookup_or_assign: uniform duplicate groups (same key, identical config, no
    RESET_REMAINING) collapse into round 0 with per-lane occurrence
    indices and a single scattering (write) lane; everything else takes
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


@dataclass
class _Staged:
    """A prepared batch between the stage and launch steps: its inputs
    are already on the device.  `launch` runs it alone; same-`fuse_key`
    neighbours waiting at the launch gate launch as one group."""

    kernel: Callable  # ops/buckets.py bucket_rounds_dict or bucket_rounds_cols
    args: tuple  # the kernel's arguments after (hot, cold)
    fuse_key: object = None  # None = not fuse-eligible (per-lane-column wire)
    wide: bool = False

    def launch(self, state) -> torch.Tensor:
        """Apply the batch to `state` in place; returns the packed output."""
        return self.kernel(state.hot, state.cold, *self.args)


class ColumnsHandle:
    """Deferred result of one pipelined columnar batch.  Commits apply
    strictly in dispatch order — result() drains every older in-flight
    batch — but the readback waits run outside the ordering lock."""

    def __init__(self, store, commit_fn, limit_col):
        self._store = store
        self._fetch_fn: Optional[Callable] = None  # set by the launch
        self._commit_fn = commit_fn
        self._fetched = None
        self._fetch_lock = threading.Lock()
        self._launched = threading.Event()
        self._launch_exc: Optional[BaseException] = None
        self._exc: Optional[BaseException] = None
        self._limit = limit_col
        self._value = None
        self.ticket = -1  # plan-order reservation (set by the pipeline)
        self.done = False

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
            packed_np = self._fetch()
            status, remaining, reset = self._commit_fn(packed_np)
        except Exception as e:  # noqa: BLE001 — surfaced at result()
            self._finish(exc=e)
            return
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

    def _submit_pipelined(self, keys, cols, now_ms: int,
                          force_wire: Optional[str] = None) -> ColumnsHandle:
        with self._plan_lock:
            prep = self._prepare_columns(keys, cols, now_ms, force_wire)
            handle = ColumnsHandle(self, prep.commit, cols.limit)
            handle.ticket = self._next_ticket
            self._next_ticket += 1
            self._inflight.append(handle)
        try:
            staged = self._stage_columns(prep)
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
        try:
            with self._lock:
                self._launch_group(group)
        except BaseException as e:  # noqa: BLE001
            exc = e
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

    def _launch_group(self, group) -> None:
        """Launch (ticket order, under `_lock`).  A multi-batch group
        writes one stacked result, read back once."""
        self._pre_launch()
        self.device_dispatches += 1
        if len(group) == 1:
            staged, h = group[0]
            h._launch_ok(_readback(staged.launch(self.state)))
            return
        stacked = self._fused_launch_fn(len(group), group[0][0].wide)(
            self.state, [s for s, _ in group])
        shared = _SharedFetch(_readback(stacked))
        for i, (_, h) in enumerate(group):
            h._launch_ok(lambda i=i: shared.get(i))

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
