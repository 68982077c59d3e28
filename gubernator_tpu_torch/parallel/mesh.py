"""Sharded bucket store on one device: key ownership = shard.

The port of the JAX package's parallel/mesh.py MeshBucketStore.  Where
the JAX store lays S shards over a device mesh, this store keeps them as
the leading dimension of the state tensors on one device: hot/cold
int32 [S, C, 8], and the GLOBAL replica columns [S, G].  Keys map to
shards by the static shardmap `fnv1a(key) % S`.

Two request paths:

* the columnar path (`apply_columns[_async]`): each shard plans its
  rounds in its own C++ slot table and one kernel launch
  (ops/buckets.py bucket_rounds_dict, or bucket_rounds_cols for the
  per-lane-column fallback) applies every shard's lanes;
* the dataclass path (`apply`), which also serves Behavior.GLOBAL: a
  GLOBAL lane at a non-owner shard answers from that shard's replica
  columns while they are live, else from its own bucket, and adds its
  hits to the shard's accumulator; `sync_globals` sums the accumulators
  at each key's owner, applies them there and broadcasts the owner's
  answer into every shard's replica columns (ops/global_ops.py);
  `set_replica_batch` commits another daemon's broadcast.

With a Store SPI object (`store=`), `apply` runs one round per kernel
launch instead, so the store's callbacks can run between rounds: a
miss asks `store.get` and injects the item's row (ops/buckets.py
write_rows, one lane), and after each round `store.remove` /
`store.on_change` see the lanes' rows (ops/buckets.py gather_rows).
The columnar path is then unavailable (`supports_columns` is False).

The persistence plane: `snapshot_columns` gathers every resident key's
row with one row-gather launch (snapshot.py dumps it), and
`commit_transfer` restores a batch of rows (a snapshot file, a
Loader's items) with one row gather, the host's monotone merge
(reshard.py) and one row scatter; `snapshot_items` feeds Loader.save.

The two-tier table (`back_capacity_per_shard > 0`): a small front
table takes every kernel lane, and its LRU evictions demote live rows
into a device-resident back tier ([S, Cb, 8], FIFO) instead of dropping
them; a later lookup promotes the row again.  The C++ tables queue the
row moves while planning, and `_drain_moves` applies each window with
one tier-move launch (ops/buckets.py apply_moves) before any launch that
reads front rows: the columnar launch (`_pre_launch`), the dataclass
path after planning, the GLOBAL sync after owner-slot resolution, and
the persistence plane's gathers and commits.  `snapshot_items` reads the
back rows too (ops/buckets.py read_back_rows); `snapshot_columns` does
not, as in the JAX store.

The JAX store serialises its sync collective across stores with a
process-wide lock (`_SYNC_COLLECTIVE_LOCK`) because two interleaved
rendezvous on a shared virtual CPU mesh can deadlock; one device has no
rendezvous, so the port has no such lock.

Small batches of a CPU store take the express scalar slot when
`scalar_fast_path` is on (ops/scalar.py, as ShardStore).

`measure_sync_cost_s` times K4 alone, back to back, on a store with no
live GLOBAL key (a benchmark utility, as in the JAX store).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..models.shard import (
    ColumnarPipeline,
    ColumnsHandle,
    RoundPlanner,
    _drained_locked,
    _readback,
    _rows_to_items,
    _Staged,
    build_round_arrays,
    express_lane,
    make_columns,
    narrow_ok,
    pad_size,
    plan_grouped_python,
    prepare_requests,
    resolve_device,
)
from ..ops import buckets, global_ops
from ..ops import scalar as scalar_ops
from ..types import (
    Behavior,
    RateLimitRequest,
    RateLimitResponse,
    UpdatePeerGlobal,
    has_behavior,
)
from ..utils import hashing
from .global_mgr import GlobalKeyTable, GlobalsColumns, HitColumns


def shard_of_key(key: str, n_shards: int) -> int:
    """Static shardmap: fnv1a-64 of the hash key, modulo shard count."""
    return hashing.hash_string_64(key) % n_shards


def _pad_pow2(n: int, floor: int = 8) -> int:
    """Pow2 size buckets (>= floor) for variable-length index arrays, so
    the replica commits see the JAX store's padded shapes."""
    m = floor
    while m < n:
        m <<= 1
    return m


def _locked(fn):
    """Run a mutator under the store lock (launches and state swaps
    serialise on it)."""

    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


@dataclass
class _MeshPrep:
    """Output of the prepare stage: the mesh plan plus the commit
    closure, handed to the unlocked stage step."""

    cols: object
    now_ms: int
    force_wire: Optional[str]
    padded: int
    n_rounds: int
    narrow: bool
    mp: object  # native.NativeMeshPlanner
    pos: np.ndarray
    commit: object


@dataclass
class SyncResult:
    """Host-tier work produced by one GLOBAL sync, in column form:
    `broadcast_cols` are the authoritative statuses of keys a local shard
    owns (the UpdatePeerGlobals fan-out), `remote_hit_cols` the summed
    hits of keys a remote daemon owns (the GetPeerRateLimits forward).
    The dataclass views materialize lazily."""

    broadcast_cols: Optional[GlobalsColumns] = None
    remote_hit_cols: Optional[HitColumns] = None
    # False only for the empty early return (no active gslots, nothing
    # dirty): such passes ran no kernel, so observers tuning windows
    # from sync cost must ignore them.
    did_work: bool = True

    @property
    def broadcasts(self) -> List[UpdatePeerGlobal]:
        if self.broadcast_cols is None:
            return []
        return self.broadcast_cols.to_updates()

    @property
    def remote_hits(self) -> List[RateLimitRequest]:
        if self.remote_hit_cols is None:
            return []
        return self.remote_hit_cols.to_requests()

    @property
    def broadcast_count(self) -> int:
        return 0 if self.broadcast_cols is None else len(self.broadcast_cols)


@dataclass
class _AnswerPrep:
    """A dataclass-path batch between planning and the answer kernel."""

    responses: list
    by_shard: list
    n_rounds: int
    lanes: np.ndarray  # i32[S, 6, P]
    values: np.ndarray  # i64[S, 5, P]
    gslot: np.ndarray  # i32[S, P]


@dataclass
class _SyncPrep:
    """A sync between owner-slot resolution and the sync kernel."""

    active: list
    cfg: np.ndarray  # i64[8, G], SyncConfig.pack()


class MeshBucketStore(ColumnarPipeline):
    """Bucket tables for S shards on one device.

    `apply(..., home_shard=s)` models the reference's ingress topology:
    the request arrived at peer s, which may not own the key.  GLOBAL
    requests at a non-owner answer locally (replica cache or as-if-owner
    fallback, gubernator.go:231-255) and sync their hits at the next
    `sync_globals()`.  Non-GLOBAL requests always route to the owner.
    """

    _PROGRAM_KIND = "mesh"

    def __init__(self, capacity_per_shard: int = 50_000, n_shards: int = 8,
                 device=None, g_capacity: int = 4096, store=None,
                 back_capacity_per_shard: int = 0):
        """back_capacity_per_shard > 0 enables the two-tier table: the
        front (capacity_per_shard) takes every kernel lane, front LRU
        evictions demote live rows into a back tier of this many rows
        per shard, and later lookups promote them back.  Total capacity
        is front + back per shard; state is lost only when the back
        tier wraps (FIFO).  Not with a Store SPI, whose resolver injects
        rows mid-round.

        Sizing contract: the front must hold one batch's per-shard
        working set (unique keys) with room to spare; a batch whose
        unique keys exceed it exhausts the pending-write guard and takes
        the planner's all-pending fallback (the loss a single-tier table
        of that size would have).  The tiers pay off when the churn is
        across batches."""
        if back_capacity_per_shard > 0 and store is not None:
            raise ValueError("two-tier table is incompatible with a Store SPI")
        self.device = resolve_device(device)
        self.store = store  # Store SPI (store.py), or None
        self.n_shards = n_shards
        self.capacity_per_shard = capacity_per_shard
        self.g_capacity = g_capacity
        # Guards the state tensors: launches (and wholesale state loads)
        # serialise on it, the role of the reference's cache mutex held
        # per batch.
        self._lock = threading.RLock()
        self._init_pipeline()
        self.back_capacity_per_shard = back_capacity_per_shard
        self.tables = self._new_tables()
        self.state = buckets.init_state(n_shards, capacity_per_shard, self.device)
        self.back = (buckets.init_back(n_shards, back_capacity_per_shard, self.device)
                     if back_capacity_per_shard > 0 else None)
        # Tier-move launches (one per drain window that moved rows).
        self.move_dispatches = 0
        # Each slot's algorithm on the host: the Store resolver detects
        # algorithm switches with it.
        self.algo_mirror = np.zeros((n_shards, capacity_per_shard), dtype=np.int32)
        self.gtable = GlobalKeyTable(g_capacity)
        self.dirty = np.zeros((n_shards, g_capacity), dtype=bool)
        self.gcols = global_ops.init_global_columns(n_shards, g_capacity, self.device)
        # Kernel launches made by replica-batch commits (one per
        # broadcast, plus one clear when it recycled gslots).
        self.replica_commit_dispatches = 0
        # In-lock seconds of the last sync that did work (GlobalManager
        # sizes its window from it).
        self.last_sync_cost_s: Optional[float] = None
        self._sync_gen: Optional[list] = None

    def _new_tables(self) -> list:
        tables = [native.NativeSlotTable(self.capacity_per_shard)
                  for _ in range(self.n_shards)]
        if self.back_capacity_per_shard > 0:
            for t in tables:
                t.enable_back(self.back_capacity_per_shard)
        return tables

    def size(self) -> int:
        return sum(len(t) for t in self.tables)

    def _tables(self) -> list:
        return self.tables

    def _drain_moves(self) -> None:
        """Apply every queued tier move (caller holds the store lock).

        Planning queues promotions and demotions in the C++ tables; this
        takes them and applies the whole window, every shard, with one
        tier-move launch, so the rows are in their new homes before any
        launch that reads front rows.  No launch when nothing is queued
        (the steady state of front-resident traffic)."""
        if self.back is None:
            return
        records = buckets.moves_to_records([t.take_moves() for t in self.tables])
        if not records.shape[1]:
            return
        buckets.apply_moves(self.state, self.back, self._upload(records))
        self.move_dispatches += 1

    def _padded_lanes(self, prep) -> int:
        # The mesh pads per shard: one launch covers S * padded lanes.
        return prep.padded * self.n_shards

    def _pre_launch(self) -> None:
        # Tier moves queued by the group's plans must land before its
        # launches read front rows.  One drain covers the group: moves
        # queued by a later plan are safe to apply early, since the
        # pending-write guard keeps every in-flight batch's slots out of
        # the mover's reach.
        self._drain_moves()

    @property
    def supports_columns(self) -> bool:
        """Whether the columnar path is usable: not with a Store SPI,
        whose callbacks run between the rounds of the dataclass path."""
        return self.store is None

    # ------------------------------------------------------------------
    # Dataclass path (GLOBAL lanes included)
    # ------------------------------------------------------------------
    @_drained_locked
    def apply(
        self,
        requests: Sequence[RateLimitRequest],
        now_ms: int,
        home_shard: Optional[int] = None,
        remote_global: bool = False,
    ) -> List[RateLimitResponse]:
        """Evaluate a batch across all shards; responses in request order.

        remote_global=True marks every GLOBAL request's authoritative
        owner as a REMOTE daemon: the key is answered locally from its
        replica entry or fallback bucket, hits accumulate on the device,
        and sync_globals() surfaces the totals for the host to forward.
        One kernel call runs every round of every shard; with a Store
        SPI, one kernel call per round (`_run_round`)."""
        responses, by_shard = self._route_requests(requests, now_ms, home_shard, remote_global)
        if self.store is None:
            prep = self._plan_answer(responses, by_shard, now_ms)
            if prep.n_rounds:
                packed = self._launch_answer(prep, *self._stage_answer(prep), now_ms)
                self._decode_commit_respond(_readback(packed)(), prep)
        else:
            # The Store SPI needs host callbacks between rounds (get and
            # inject while planning, remove / on_change after), so it
            # keeps the interleaved loop.
            planners = [
                RoundPlanner(self.tables[s], by_shard[s], now_ms,
                             resolver=self._store_resolver(s, now_ms))
                for s in range(self.n_shards)
            ]
            while True:
                chunks = [pl.next_chunk() for pl in planners]
                if not any(chunks):
                    break
                self._run_round(chunks, now_ms, responses)
        return [r if r is not None else RateLimitResponse() for r in responses]

    def _prepare_apply(self, requests, now_ms: int, home_shard=None,
                       remote_global: bool = False) -> _AnswerPrep:
        """Host half of `apply` without a Store SPI (store lock held):
        route, then plan every shard's rounds.  n_rounds 0 = nothing to
        launch (every request failed validation)."""
        routed = self._route_requests(requests, now_ms, home_shard, remote_global)
        return self._plan_answer(*routed, now_ms)

    def _route_requests(self, requests, now_ms: int, home_shard=None,
                        remote_global: bool = False):
        """Validate, route each lane to a shard and register GLOBAL keys;
        returns (responses, by_shard)."""
        responses: List[Optional[RateLimitResponse]] = [None] * len(requests)
        prepared = prepare_requests(requests, now_ms, responses)
        S = self.n_shards
        by_shard: List[list] = [[] for _ in range(S)]
        evicted: List[int] = []
        for p in prepared:
            owner = shard_of_key(p.key, S)
            target = owner
            if has_behavior(p.req.behavior, Behavior.GLOBAL):
                owner_mark = -1 if remote_global else owner
                g, ev = self.gtable.lookup_or_assign(p.key, owner_mark)
                if ev is not None:
                    evicted.append(ev)
                self.gtable.update_config(g, p.req, p.greg_expire, p.greg_duration)
                non_owner = remote_global or (home_shard is not None and home_shard != owner)
                if non_owner:
                    # Non-owner: answer locally, sync hits later
                    # (gubernator.go:231-255).
                    p.gslot = g
                    target = owner if remote_global else home_shard
                    if self.gtable.rep_expire[g] >= now_ms:
                        p.cached_hint = True
                else:
                    # The owner applies directly and owes a broadcast
                    # (getRateLimit's QueueUpdate, gubernator.go:339-341).
                    self.dirty[owner, g] = True
            by_shard[target].append(p)
        if evicted:
            # One clear for the batch's recycled gslots, where the JAX
            # store clears each as its lane evicts it: the same bytes, as
            # nothing on the device reads the replica columns before the
            # answer kernel, a clear only writes zeros, and
            # lookup_or_assign resets the host mirror at once.
            self._clear_gslots(evicted)
        return responses, by_shard

    def _plan_answer(self, responses, by_shard, now_ms: int) -> _AnswerPrep:
        """Plan every shard's rounds and build the answer kernel's input
        arrays."""
        S = self.n_shards
        empty = np.zeros((S, 0))
        if not any(by_shard):
            return _AnswerPrep(responses, by_shard, 0, empty, empty, empty)
        plans = []
        n_rounds = 1
        for s in range(S):
            rid, occ, wr, nr = plan_grouped_python(self.tables[s], by_shard[s], now_ms)
            plans.append((rid, occ, wr))
            n_rounds = max(n_rounds, nr)
        self._drain_moves()  # tier moves queued by the planning
        padded = pad_size(max(len(c) for c in by_shard))
        lanes = np.zeros((S, 6, padded), np.int32)
        lanes[:, 0] = -1
        values = np.zeros((S, 5, padded), np.int64)
        gslot = np.full((S, padded), -1, np.int32)
        for s, chunk in enumerate(by_shard):
            m = len(chunk)
            if not m:
                continue
            (slot, exists, algo, behavior, hits, limit, duration, greg_expire,
             greg_duration) = build_round_arrays(chunk, m)
            rid, occ, wr = plans[s]
            lanes[s, :, :m] = (slot, exists | (wr << 1), algo, behavior, occ, rid)
            values[s, :, :m] = (hits, limit, duration, greg_expire, greg_duration)
            gslot[s, :m] = [p.gslot for p in chunk]
        return _AnswerPrep(responses, by_shard, n_rounds, lanes, values, gslot)

    def _stage_answer(self, prep: _AnswerPrep):
        """Upload the answer kernel's inputs."""
        return self._upload(prep.lanes), self._upload(prep.values), self._upload(prep.gslot)

    def _launch_answer(self, prep: _AnswerPrep, lanes, values, gslot, now_ms: int):
        """The answer kernel over every round of every shard; returns the
        packed i64[S, 5, P] (readback still to do)."""
        self.device_dispatches += 1
        return global_ops.answer_rounds(
            self.state.hot, self.state.cold, self.gcols, lanes, values, gslot,
            prep.n_rounds, now_ms)

    def _decode_commit_respond(self, packed_np: np.ndarray, prep: _AnswerPrep) -> None:
        """Decode the packed [S, 5, P] answers, fill the responses and
        commit the write lanes' new expiries into the slot tables (a
        replica-answered lane touched no bucket and commits nothing)."""
        row0 = packed_np[:, 0]
        out_status = (row0 & 1).astype(np.int32)
        out_removed = ((row0 >> 1) & 1).astype(bool)
        cached_np = ((row0 >> 2) & 1).astype(bool)
        out_limit = packed_np[:, 1]
        out_rem = packed_np[:, 2]
        out_reset = packed_np[:, 3]
        out_exp = packed_np[:, 4]
        write = (prep.lanes[:, 1] & 2) != 0
        for s, chunk in enumerate(prep.by_shard):
            if not chunk:
                continue
            commit_slots, commit_exp, commit_rm, commit_keys = [], [], [], []
            for i, p in enumerate(chunk):
                if write[s, i] and not cached_np[s, i] and p.slot >= 0:
                    commit_slots.append(p.slot)
                    commit_exp.append(out_exp[s, i])
                    commit_rm.append(out_removed[s, i])
                    commit_keys.append(p.key)
                    self.algo_mirror[s, p.slot] = int(p.req.algorithm)
                prep.responses[p.pos] = RateLimitResponse(
                    status=int(out_status[s, i]),
                    limit=int(out_limit[s, i]) if cached_np[s, i] else int(p.req.limit),
                    remaining=int(out_rem[s, i]),
                    reset_time=int(out_reset[s, i]),
                )
            self.tables[s].commit(commit_slots, commit_exp, commit_rm, commit_keys)

    # ------------------------------------------------------------------
    # Store SPI (persistence): one round per launch, callbacks between
    # ------------------------------------------------------------------
    def _run_round(self, chunks, now_ms: int, responses) -> None:
        """One round of every shard's chunk: one answer-kernel launch
        with n_rounds 1 (the JAX store's _answer_jit form: every lane
        writes, occurrence 0), the decode and commit, then the store
        callbacks."""
        S = self.n_shards
        padded = pad_size(max(max(len(c) for c in chunks), 1))
        lanes = np.zeros((S, 6, padded), np.int32)
        lanes[:, 0] = -1
        values = np.zeros((S, 5, padded), np.int64)
        gslot = np.full((S, padded), -1, np.int32)
        for s, chunk in enumerate(chunks):
            m = len(chunk)
            if not m:
                continue
            (slot, exists, algo, behavior, hits, limit, duration, greg_expire,
             greg_duration) = build_round_arrays(chunk, m)
            lanes[s, :4, :m] = (slot, exists | 2, algo, behavior)  # occ 0, round 0
            values[s, :, :m] = (hits, limit, duration, greg_expire, greg_duration)
            gslot[s, :m] = [p.gslot for p in chunk]
        prep = _AnswerPrep(responses, chunks, 1, lanes, values, gslot)
        packed_np = _readback(self._launch_answer(prep, *self._stage_answer(prep), now_ms))()
        self._decode_commit_respond(packed_np, prep)
        row0 = packed_np[:, 0]
        self._fire_store_callbacks(chunks, ((row0 >> 2) & 1) == 1, ((row0 >> 1) & 1) == 1)

    @_drained_locked
    def snapshot_items(self):
        """Loader.Save path (gubernator.go:93-111): every resident key as
        a CacheItem, shard by shard (a two-tier table's front keys, then
        its back keys, as the JAX store lists them), with one row gather
        for the fronts and one for the back tiers."""
        self._drain_moves()  # pending promotions leave front rows stale
        front = [t.entries() for t in self.tables]
        back = ([t.back_entries()[:2] for t in self.tables] if self.back is not None
                else [([], np.empty(0, np.int32))] * self.n_shards)

        def gather(entries, read):
            lanes = np.concatenate(
                [np.stack([np.full(len(k), s, np.int32), slots])
                 for s, (k, slots) in enumerate(entries)], axis=1)
            if not lanes.shape[1]:
                return None
            return buckets.cols_to_rows(*read(lanes))

        front_rows = gather(front, self._gather_cols)
        back_rows = gather(back, lambda lanes: self._gather_cols(lanes, back=True))
        items = []
        at = {"front": 0, "back": 0}
        for s in range(self.n_shards):
            for tier, keys, rows in (("front", front[s][0], front_rows),
                                     ("back", back[s][0], back_rows)):
                if keys:
                    n, i = len(keys), at[tier]
                    items.extend(_rows_to_items(
                        keys, buckets.BucketRows(*(f[i:i + n] for f in rows))))
                    at[tier] = i + n
        return items

    # ------------------------------------------------------------------
    # GLOBAL replication
    # ------------------------------------------------------------------
    def set_replica(self, update: UpdatePeerGlobal, now_ms: int) -> None:
        """Receive side of UpdatePeerGlobals (gubernator.go:259-272) for
        one update: a 1-lane `set_replica_batch`."""
        self.set_replica_batch(GlobalsColumns.from_updates([update]), now_ms)

    def _clear_gslots(self, gslots: List[int]) -> None:
        """Zero every shard's replica rows of recycled gslots with one
        clear: the sorted unique list, padded to a power of two with G."""
        ev = sorted(set(gslots))
        idx = np.full(_pad_pow2(len(ev)), self.g_capacity, np.int64)
        idx[: len(ev)] = ev
        global_ops.clear_gslots(self.gcols, idx)

    @_locked
    def set_replica_batch(self, cols: GlobalsColumns, now_ms: int) -> None:
        """Batched receive side of UpdatePeerGlobals: store the owner
        daemon's statuses in every shard's replica columns, expiring at
        ResetTime, with one kernel launch (plus one clear when assigning
        the keys recycled gslots)."""
        n = len(cols)
        if n == 0:
            return
        gslots = np.empty(n, dtype=np.int64)
        evicted: List[int] = []
        for i, k in enumerate(cols.keys):
            g, ev = self.gtable.lookup_or_assign(k, -1)
            if ev is not None:
                evicted.append(ev)
            gslots[i] = g
        # Keep only lanes whose key STILL maps to its gslot (a later
        # assignment in this batch may have recycled it), and for
        # duplicate keys the LAST lane.
        keep = np.fromiter(
            (self.gtable._key_to_gslot.get(k) == int(g)  # noqa: SLF001
             for k, g in zip(cols.keys, gslots)),
            dtype=bool, count=n,
        )
        idx = np.nonzero(keep)[0]
        if idx.size > 1:
            _, last_rev = np.unique(gslots[idx][::-1], return_index=True)
            idx = idx[(idx.size - 1) - last_rev]
        if evicted:
            # Zero recycled rows BEFORE the scatter: a gslot evicted and
            # reassigned within this batch gets its new values next.
            self._clear_gslots(evicted)
            self.replica_commit_dispatches += 1
        if not idx.size:
            return
        m = idx.size
        pad = _pad_pow2(m)
        gsel = np.full(pad, -1, np.int64)
        gsel[:m] = gslots[idx]

        def col(a, dtype):
            out = np.zeros(pad, dtype)
            out[:m] = np.asarray(a, dtype=dtype)[idx]
            return out

        reset = col(cols.reset_time, np.int64)
        global_ops.set_replica(
            self.gcols, gsel, col(cols.status, np.int32), col(cols.limit, np.int64),
            col(cols.remaining, np.int64), reset)
        self.replica_commit_dispatches += 1
        # Host mirror: rep_expire gates the replica-cache hint; the
        # algorithm keeps the broadcast's authoritative value.
        self.gtable.rep_expire[gsel[:m]] = reset[:m]
        self.gtable.algorithm[gsel[:m]] = np.asarray(cols.algorithm, dtype=np.int32)[idx]

    @_drained_locked
    def sync_globals(self, now_ms: int) -> SyncResult:
        """Run one GLOBAL sync: sum every shard's accumulated hits, apply
        them at each key's owner shard, broadcast the owner's answer into
        every shard's replica columns (one kernel launch, one readback).

        The SyncResult carries what the host tier fans out: the
        authoritative statuses of locally owned keys and the summed hits
        of keys a remote daemon owns.  Sets `last_sync_cost_s` to the
        time spent inside the lock (resolution, kernel, readback,
        decode/commit), not the drain wait before it."""
        t0 = time.perf_counter()
        prep = self._prepare_sync(now_ms)
        if prep is None:
            return SyncResult(did_work=False)
        packed = self._launch_sync(*self._stage_sync(prep), now_ms)
        res = self._finish_sync(prep, _readback(packed)())
        self.last_sync_cost_s = time.perf_counter() - t0
        return res

    def _prepare_sync(self, now_ms: int) -> Optional[_SyncPrep]:
        """Resolve every active gslot's owner slot and pack the sync
        config; None when nothing is active or dirty."""
        active = self.gtable.active_gslots()
        if not active and not self.dirty.any():
            return None
        # Owner-slot fast path: a shard whose table reports an unchanged
        # mapping generation since the end of the last sync cannot have
        # moved, evicted or removed any key, so its resolved gslots
        # (owner_slot >= 0) are still valid; only unresolved gslots and
        # shards with mapping churn pay the per-key verification.
        gens = [t.generation for t in self.tables]
        last = self._sync_gen
        shard_clean = [last is not None and last[o] == g for o, g in enumerate(gens)]
        # Assigning one key can evict another's slot, so iterate to a
        # fixed point (bounded), then drop still-unstable entries.
        gt = self.gtable
        for _ in range(3):
            changed = False
            for g in active:
                o = int(gt.owner_shard[g])
                if o < 0:
                    continue  # a remote daemon owns it: no local slot
                if shard_clean[o] and gt.owner_slot[g] >= 0:
                    continue
                key = gt.key_of(g)
                slot = self.tables[o].get_slot(key)
                if slot is None:
                    slot, _ = self.tables[o].lookup_or_assign(key, now_ms)
                    changed = True
                    shard_clean[o] = False  # the assignment may have evicted
                gt.owner_slot[g] = slot
            if not changed:
                break
        for g in active:
            o = int(gt.owner_shard[g])
            if o < 0 or (shard_clean[o] and gt.owner_slot[g] >= 0):
                continue
            if self.tables[o].get_slot(gt.key_of(g)) != int(gt.owner_slot[g]):
                gt.owner_slot[g] = -1
        # The resolution may have promoted demoted GLOBAL keys: their
        # rows must be in the front table before the sync reads them.
        self._drain_moves()
        cfg = global_ops.SyncConfig(
            owner_slot=gt.owner_slot, owner_shard=gt.owner_shard,
            algorithm=gt.algorithm, behavior=gt.behavior, limit=gt.limit,
            duration=gt.duration, greg_expire=gt.greg_expire,
            greg_duration=gt.greg_duration,
        ).pack()
        return _SyncPrep(active=active, cfg=cfg)

    def _stage_sync(self, prep: _SyncPrep):
        """Upload the sync kernel's inputs."""
        return self._upload(prep.cfg), self._upload(self.dirty)

    def _launch_sync(self, cfg, dirty, now_ms: int):
        """The sync kernel; returns the packed i64[S, 8, G]."""
        self.device_dispatches += 1
        return global_ops.global_sync(self.state.hot, self.state.cold, self.gcols,
                                      cfg, dirty, now_ms)

    def _finish_sync(self, prep: _SyncPrep, packed_np: np.ndarray) -> SyncResult:
        """Decode the packed sync result: commit the owners' applies into
        their slot tables and build the host-tier columns."""
        gt = self.gtable
        out_rm = (packed_np[:, 0] & 1).astype(bool)
        out_exp = packed_np[:, 1]
        # broadcast results are identical in every shard: read shard 0
        applied_np = ((packed_np[0, 0] >> 1) & 1).astype(bool)
        totals_np = packed_np[0, 2]
        rep_status = packed_np[0, 3]
        rep_limit = packed_np[0, 4]
        rep_remaining = packed_np[0, 5]
        rep_reset = packed_np[0, 6]
        gt.rep_expire[:] = packed_np[0, 7]

        result = SyncResult()
        act = np.fromiter(prep.active, dtype=np.int64, count=len(prep.active))
        owner_np = gt.owner_shard[act]
        # Remote daemons' keys with summed hits (sendHits,
        # global.go:120-160), as wire-ready columns.
        rsel = act[(owner_np < 0) & (totals_np[act] > 0)]
        if rsel.size:
            rsel = rsel[gt.templated(rsel)]
        if rsel.size:
            result.remote_hit_cols = gt.hit_columns(rsel, totals_np)
        local = act[owner_np >= 0]
        sel = local[applied_np[local] & (gt.owner_slot[local] >= 0)]
        sel_shard = gt.owner_shard[sel]
        for o in np.unique(sel_shard):
            o = int(o)
            idx = sel[sel_shard == o]
            if self.store is not None:
                self._sync_store_callbacks(o, idx, out_exp, out_rm, totals_np)
            else:
                self.tables[o].commit(
                    gt.owner_slot[idx], out_exp[o, idx], out_rm[o, idx],
                    [gt.key_of(int(g)) for g in idx],
                )
            # Commit-removals unmapped their keys: invalidate now so the
            # generation snapshot below cannot let a clean shard skip
            # re-resolving them next pass.
            gt.owner_slot[idx[out_rm[o, idx]]] = -1
        if sel.size:
            result.broadcast_cols = GlobalsColumns(
                keys=[gt.key_of(int(g)) for g in sel],
                algorithm=gt.algorithm[sel].astype(np.int32),
                status=rep_status[sel].astype(np.int32),
                limit=np.asarray(rep_limit[sel], dtype=np.int64),
                remaining=np.asarray(rep_remaining[sel], dtype=np.int64),
                reset_time=np.asarray(rep_reset[sel], dtype=np.int64),
            )
        # Snapshot AFTER our own commits (which may bump generations).
        self._sync_gen = [t.generation for t in self.tables]
        self.dirty[:] = False
        return result

    def _sync_store_callbacks(self, o, idx, out_exp, out_rm, totals_np) -> None:
        """The owner-side apply of summed GLOBAL hits under a Store SPI:
        key by key, as JAX's, commit the key's slot, then store.remove
        for a removed bucket or store.on_change with its request (the
        gslot's template with the summed hits) and its row (one row
        gather a key; algorithms.go:64-68,38-40)."""
        gt = self.gtable
        for g in idx.tolist():
            k, slot = gt.key_of(g), int(gt.owner_slot[g])
            self.tables[o].commit([slot], [out_exp[o, g]], [out_rm[o, g]], [k])
            req = gt.request_template(g, int(totals_np[g]))
            if out_rm[o, g]:
                self.store.remove(k)
            elif req is not None:
                rows = self._read_rows(np.array([[o], [slot]], np.int32))
                self.store.on_change(req, _rows_to_items([k], rows)[0])

    # ------------------------------------------------------------------
    def measure_sync_cost_s(self, now_ms: int, iters: int = 6) -> float:
        """BENCHMARK UTILITY: device-only steady-state cost (seconds) of
        ONE GLOBAL sync kernel (K4) on this store.  Applies the
        calibration request (`__synccal__`), resolves the owner slots
        and runs one full sync (the warm launch, with its readback and
        host commit), then launches K4 `iters` times back to back and
        ends with one small readback.  Only the launches are timed: the
        host legs of `sync_globals` (resolution, decode, commit) are
        not, as the JAX store times only its sync program.

        Do NOT call on a store serving GLOBAL traffic: the timed raw
        syncs drain device-side hit accumulations without the host
        commit/broadcast legs (the serving tuner instead times its real
        sync passes in situ, service.GlobalManager).  Refuses
        (RuntimeError) if the store tracks GLOBAL keys beyond its own
        calibration key, once before any work and again under the store
        lock after the pipeline drains, so a key registered by a racing
        serving thread cannot slip past.  The store lock stands for the
        JAX store's `_SYNC_COLLECTIVE_LOCK`: it serialises every launch
        on this store's state."""
        req = RateLimitRequest(
            name="__synccal__", unique_key="__synccal__", hits=1,
            limit=1_000_000, duration=60_000, behavior=Behavior.GLOBAL,
        )
        cal_key = req.hash_key()

        def _guard():
            live = [
                k
                for k in (self.gtable.key_of(g) for g in self.gtable.active_gslots())
                if k is not None and k != cal_key
            ]
            if live:
                raise RuntimeError(
                    "measure_sync_cost_s would drain device-side GLOBAL hit "
                    "accumulations without the host commit/broadcast legs; "
                    f"refusing with {len(live)} live GLOBAL key(s), e.g. {live[:3]}"
                )

        _guard()  # fast fail before any device work
        self.apply([req], now_ms)
        self._drain_then_lock()
        try:
            _guard()  # authoritative: under the lock, pipeline drained
            prep = self._prepare_sync(now_ms)  # owner slots, resolved once
            cfg, dirty = self._stage_sync(prep)
            # The warm launch is the full sync: its readback and commit
            # are what the JAX store's first sync does (only the
            # calibration key can be active, so its host legs lose
            # nothing).
            self._finish_sync(prep, _readback(self._launch_sync(cfg, dirty, now_ms))())
            dirty = self._upload(self.dirty)
            hot, cold, gcols = self.state.hot, self.state.cold, self.gcols
            t0 = time.perf_counter()
            for _ in range(iters):
                packed = global_ops.global_sync(hot, cold, gcols, cfg, dirty, now_ms)
            packed[:1, :1, :1].cpu()  # one small blocking readback
            return (time.perf_counter() - t0) / iters
        finally:
            self._unlock_drained()

    # ------------------------------------------------------------------
    def apply_columns(
        self, keys, algorithm, behavior, hits, limit, duration, now_ms: int,
        greg_expire=None, greg_duration=None, force_wire=None,
    ) -> dict:
        """Columnar bulk API: returns a dict of numpy arrays
        (status/limit/remaining/reset_time) aligned with `keys`."""
        return self.apply_columns_async(
            keys, algorithm, behavior, hits, limit, duration, now_ms,
            greg_expire, greg_duration, force_wire=force_wire,
        ).result()

    def apply_columns_async(
        self, keys, algorithm, behavior, hits, limit, duration, now_ms: int,
        greg_expire=None, greg_duration=None, force_wire=None,
    ) -> ColumnsHandle:
        """Pipelined apply_columns: returns once the batch's kernels are
        launched; `handle.result()` blocks on its one readback.
        `force_wire="wide"` forces the per-lane-column wire with wide
        output (a test and debugging aid, as in the JAX store)."""
        if force_wire not in (None, "wide"):
            raise ValueError(f"unknown force_wire {force_wire!r}")
        cols = make_columns(
            algorithm, behavior, hits, limit, duration, len(keys),
            greg_expire, greg_duration,
        )
        if self.store is not None:
            raise RuntimeError("apply_columns is not available with a Store SPI")
        if (cols.behavior & int(Behavior.GLOBAL)).any():
            raise ValueError("GLOBAL lanes must take the dataclass path (apply)")
        return self._submit_pipelined(keys, cols, now_ms, force_wire)

    def _prepare_columns(self, keys, cols, now_ms: int,
                         force_wire: Optional[str] = None) -> _MeshPrep:
        """Stage 1 (under `_plan_lock`): hash/bucket every key, plan
        each shard's rounds into padded [S, P] arrays.  The commit is
        one C++ call (decode, slot-table commit, original-order
        scatter)."""
        n = len(keys)
        mp = native.NativeMeshPlanner(self.tables, keys, now_ms)
        padded = pad_size(max(int(mp.counts.max()) if n else 1, 1))
        n_rounds = mp.plan_grouped(cols, int(Behavior.RESET_REMAINING), padded)
        narrow = narrow_ok(cols, now_ms) and force_wire != "wide"

        # The JAX store also writes each lane's algorithm into its
        # algo_mirror here; only the Store SPI reads the mirror, and a
        # store with one has no columnar path.
        def commit(packed_np):
            if narrow:
                return mp.finish_narrow(packed_np, now_ms)
            return mp.finish_wide(packed_np)

        return _MeshPrep(
            cols=cols, now_ms=now_ms, force_wire=force_wire,
            padded=padded, n_rounds=n_rounds, narrow=narrow,
            mp=mp, pos=mp.pos[:n], commit=commit,
        )

    def _stage_columns(self, prep: _MeshPrep) -> _Staged:
        """Stage 2 (no locks): encode the wire and start its upload."""
        cols, now_ms, padded = prep.cols, prep.now_ms, prep.padded
        mp, pos, n_rounds, narrow = prep.mp, prep.pos, prep.n_rounds, prep.narrow
        S = self.n_shards
        dict_enc = None
        if prep.force_wire is None and n_rounds <= 255:
            # Values live in the dict wire's 256-row i64 table, so wide
            # batches (monthly/yearly Gregorian) stay on it too — only
            # the output width switches.
            dict_enc = buckets.build_config_dict(cols, now_ms)
        if dict_enc is not None and int(mp.occ.max()) <= 65535:
            cfg_full, cfg_table = dict_enc
            cfg_a = np.zeros((S, padded), dtype=np.uint8)
            cfg_a.reshape(-1)[pos] = cfg_full
            wire = buckets.pack_dict_wire(
                mp.slot, mp.exists, mp.write, cfg_a, mp.occ, mp.rid, cfg_table
            )
            return _Staged(
                kernel=buckets.bucket_rounds_dict,
                args=(self._upload(wire), n_rounds, now_ms, not narrow),
                fuse_key=("dict", narrow, wire.shape[1]), wide=not narrow,
            )

        # Per-lane-column wire: more than 256 configs, occ > 65535 or
        # more than 255 rounds (or forced wide).
        def scatter(col, dtype):
            a = np.zeros((S, padded), dtype=dtype)
            a.reshape(-1)[pos] = col
            return a

        vdt = np.int32 if narrow else np.int64
        if narrow:
            ge = np.where(cols.greg_duration != 0, cols.greg_expire - now_ms, 0)
        else:
            ge = cols.greg_expire
        lanes = np.stack([
            mp.slot, mp.exists.astype(np.int32) | (mp.write.astype(np.int32) << 1),
            scatter(cols.algo, np.int32), scatter(cols.behavior, np.int32),
            mp.occ, mp.rid,
        ], axis=1).astype(np.int32)
        values = np.stack([
            scatter(cols.hits, vdt), scatter(cols.limit, vdt),
            scatter(cols.duration, vdt), scatter(ge, vdt),
            scatter(cols.greg_duration, vdt),
        ], axis=1)
        return _Staged(
            kernel=buckets.bucket_rounds_cols,
            args=(self._upload(lanes), self._upload(values), n_rounds, now_ms,
                  not narrow),
            wide=not narrow,
        )

    def _fused_launch_fn(self, k: int, wide: bool):
        """K same-shape dict-wire batches: K launches in stream order,
        each seeing the state the previous one left, writing into one
        stacked [K, S, 4, P] result."""

        def run(state, group):
            S, W = group[0].args[0].shape
            P = (W - buckets.DICT_WIRE_TABLE_WORDS) // 3
            out = torch.empty((k, S, 4, P), device=self.device,
                              dtype=torch.int64 if wide else torch.int32)
            for i, staged in enumerate(group):
                staged.kernel(state.hot, state.cold, *staged.args, out=out[i])
            return out

        return run

    # -- express scalar slot (ops/scalar.py) ---------------------------
    def _scalar_eligible(self, cols) -> bool:
        """ShardStore._scalar_eligible for S shards: each lane of a small
        batch lives in one shard, evaluated on the host through that
        shard's view.  Not with a Store SPI, nor with a back tier (its
        plans queue tier moves that only a launch drains), nor on the
        card."""
        if not self.scalar_fast_path:
            return False
        if not 1 <= len(cols.hits) <= self.scalar_max_lanes:
            return False
        if self.store is not None or self.back is not None:
            return False
        return scalar_ops.device_is_cpu(self.device)

    def _stage_scalar(self, prep: _MeshPrep) -> _Staged:
        """Express stage: locate each lane's (shard, row) in the mesh plan
        and return the host closure; its packed [S, 4, P] wide output
        feeds the unchanged wide commit (mp.finish_wide).  Lanes apply
        in submission order (see express_lane for the exists rule)."""
        cols, mp, padded = prep.cols, prep.mp, prep.padded
        pos = prep.pos.copy()
        now_ms = prep.now_ms
        S = self.n_shards

        def run():
            packed = np.zeros((S, 4, padded), dtype=np.int64)
            for i in range(len(pos)):
                s, j = divmod(int(pos[i]), padded)
                packed[s, :, j] = express_lane(
                    scalar_ops.shard_view(self.state.hot, s),
                    scalar_ops.shard_view(self.state.cold, s), int(mp.slot[s, j]),
                    mp.exists[s, j], mp.occ[s, j], cols, i, now_ms)
            return packed

        return _Staged(kernel=None, args=(), scalar=run)

    # ------------------------------------------------------------------
    def load_state_numpy(self, hot, cold, entries, algo_mirror=None, back=None) -> None:
        """Replace this store's state with another store's: `hot` and
        `cold` are [S, C, 8] arrays (for example the JAX store's
        `np.asarray(store.state.hot)`), `entries` holds each shard's
        (keys, slots, expire) key map, committed into fresh tables, and
        `algo_mirror` the i32 [S, C] slot algorithms (zeros when not
        given).  A two-tier store also takes `back` = (back_hot,
        back_cold, back_entries, cursors): the back tier's [S, Cb, 8]
        arrays, each shard's (keys, back_slots, expire) back map (the
        JAX table's `back_entries()`) and its FIFO allocation cursor.
        The JAX table does not expose its cursor; below the back tier's
        first wrap it equals the shard's demotion count (`tier_stats`).
        The back map's iteration order after the load may differ from
        the source table's.  Afterwards both stores answer the next
        batch identically."""
        if len(entries) != self.n_shards:
            raise ValueError(f"need {self.n_shards} shard entries, got {len(entries)}")
        if (back is None) != (self.back is None):
            raise ValueError("back is required exactly when the store has a back tier")
        state = buckets.state_from_numpy(hot, cold, self.device)
        if state.hot.shape != self.state.hot.shape:
            raise ValueError(
                f"state shape {tuple(state.hot.shape)} != {tuple(self.state.hot.shape)}"
            )
        back_state = None
        if back is not None:
            back_hot, back_cold, back_entries, cursors = back
            back_state = buckets.BackState(*buckets.state_from_numpy(
                back_hot, back_cold, self.device))
            if back_state.hot.shape != self.back.hot.shape:
                raise ValueError(f"back shape {tuple(back_state.hot.shape)} != "
                                 f"{tuple(self.back.hot.shape)}")
            if len(back_entries) != self.n_shards or len(cursors) != self.n_shards:
                raise ValueError(f"need {self.n_shards} back entries and cursors")
        mirror = np.zeros_like(self.algo_mirror)
        if algo_mirror is not None:
            mirror[:] = algo_mirror
        self._drain_then_lock()
        try:
            self.tables = self._new_tables()
            for table, (keys, slots, expire) in zip(self.tables, entries):
                n = len(keys)
                table.commit(slots, expire, np.zeros(n, np.uint8), keys)
            if back_state is not None:
                for table, (keys, slots, expire), cursor in zip(
                        self.tables, back_entries, cursors):
                    table.load_back(keys, slots, expire, int(cursor))
                self.back = back_state
            self.state = state
            self.algo_mirror = mirror
            self._sync_gen = None  # fresh slot tables: verify every owner slot
        finally:
            self._unlock_drained()

    def load_global_state(self, gcols, gtable, dirty) -> None:
        """Replace this store's GLOBAL state with another store's:
        `gcols` the six replica columns as [S, G] arrays in
        GlobalColumns order (for example the JAX store's
        `[np.asarray(c) for c in store.gcols]`), `gtable` the key table's
        state as keyword arguments of GlobalKeyTable.load, `dirty` the
        bool [S, G] owner-dirty marks.  With load_state_numpy for the
        buckets, both stores then answer the next GLOBAL batch and sync
        identically."""
        cols = global_ops.global_columns_from_numpy(gcols, self.device)
        if cols.rep_status.shape != self.gcols.rep_status.shape:
            raise ValueError(
                f"replica columns {tuple(cols.rep_status.shape)} != "
                f"{tuple(self.gcols.rep_status.shape)}")
        dirty = np.array(dirty, dtype=bool)
        if dirty.shape != self.dirty.shape:
            raise ValueError(f"dirty must be {self.dirty.shape}, got {dirty.shape}")
        self._drain_then_lock()
        try:
            table = GlobalKeyTable(self.g_capacity)
            table.load(**gtable)
            self.gtable = table
            self.gcols = cols
            self.dirty = dirty
            self._sync_gen = None  # fresh slot tables: verify every owner slot
        finally:
            self._unlock_drained()

    def describe_topology(self) -> "tuple[str, str]":
        """(device type, shard count): the store's build-info labels."""
        return self.device.type, str(self.n_shards)

    @_drained_locked
    def load_item(self, item) -> None:
        """Loader.Load path (gubernator.go:78-90), routed to the owner
        shard: one single-lane row scatter."""
        s = shard_of_key(item.key, self.n_shards)
        slot, _ = self.tables[s].lookup_or_assign(item.key, 0)
        # A promotion queued by the lookup would otherwise overwrite the
        # injected row at the next drain.
        self._drain_moves()
        self._inject(s, slot, item)

    def warmup(self, now_ms: int, warm_shapes: Optional[Sequence[int]] = None) -> None:
        """Launch every kernel of the serving path once before traffic,
        so the kernels' library load (the first launch builds or loads
        it) and each kernel's first launch happen at startup rather than
        inside a client's deadline.  Nothing compiles per shape: one
        launch of each kernel covers every batch size.  Reserved
        `__warmup__` keys with a 1 ms duration recycle at the next
        eviction scan and stay out of snapshots.

        Launches: a GLOBAL lane (answer rounds, K3), the GLOBAL sync
        (K4), a one-lane replica commit (K5), with a back tier one empty
        tier-move window (K9), and per shape of `warm_shapes` (lane
        counts) two dict-wire batches (K1) and two wide per-lane-column
        batches (K2), one of distinct keys and one of a key repeated."""
        req = RateLimitRequest(
            name="__warmup__", unique_key="__warmup__", hits=0, limit=1,
            duration=1, behavior=Behavior.GLOBAL,
        )
        self.apply([req], now_ms)
        self.sync_globals(now_ms)
        # reset_time in the past: the replica row never answers.
        self.set_replica_batch(
            GlobalsColumns(
                keys=[req.hash_key()],
                algorithm=np.zeros(1, np.int32),
                status=np.zeros(1, np.int32),
                limit=np.ones(1, np.int64),
                remaining=np.zeros(1, np.int64),
                reset_time=np.full(1, now_ms - 1, np.int64),
            ),
            now_ms,
        )
        if self.back is not None:
            with self._lock:
                noop = np.full((3, 1), -1, np.int32)  # one record, not live
                buckets.apply_moves(self.state, self.back, self._upload(noop))
                self.move_dispatches += 1
        if self.store is not None:
            return
        # Each shape twice, distinct keys and one key repeated, as the
        # JAX warmup does: the tables then count the same hits and
        # misses as a JAX daemon's (gubernator_cache_access_count).
        for lanes in sorted({max(int(n), 1) for n in (warm_shapes or (1,))}):
            for keys in ([f"__warmup__:{i}" for i in range(lanes)],
                         ["__warmup__:0"] * lanes):
                for wire in (None, "wide"):
                    self.apply_columns(
                        keys,
                        np.zeros(lanes, np.int32), np.zeros(lanes, np.int32),
                        np.zeros(lanes, np.int64), np.ones(lanes, np.int64),
                        np.ones(lanes, np.int64), now_ms, force_wire=wire,
                    )

    @_drained_locked
    def check_consistency(self) -> None:
        """Invariant sweep over the host tier (the JAX store's test and
        debug check): every shard's key->slot map must be a bijection
        onto in-range slots and sized consistently, and a two-tier
        table's back map likewise, with no key in both tiers.  Raises
        AssertionError on corruption."""
        for s, t in enumerate(self.tables):
            keys, slots = t.entries()
            assert len(set(keys)) == len(keys), f"shard {s}: a key mapped twice"
            assert len(set(slots.tolist())) == len(slots), f"shard {s}: slot aliasing"
            assert len(keys) == len(t), f"shard {s}: size {len(t)} != mapped keys {len(keys)}"
            assert all(t.get_slot(k) == int(c) for k, c in zip(keys, slots)), (
                f"shard {s}: key map and slot list disagree")
            assert ((slots >= 0) & (slots < self.capacity_per_shard)).all(), (
                f"shard {s}: slot out of range")
            if self.back is None:
                continue
            bkeys, bslots, _ = t.back_entries()
            assert len(set(bslots.tolist())) == len(bslots), f"shard {s}: back slot aliasing"
            assert ((bslots >= 0) & (bslots < self.back_capacity_per_shard)).all(), (
                f"shard {s}: back slot out of range")
            assert t.tier_stats[:2] == (len(keys) + len(bkeys), len(bkeys)), (
                f"shard {s}: tier sizes disagree")
            assert not set(keys) & set(bkeys), f"shard {s}: a key in both tiers"
