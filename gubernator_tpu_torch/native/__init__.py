"""ctypes loader for the port's C++ host runtime (host_runtime.cpp).

The runtime is compiled with g++ at first use into the port's build
directory (utils/build.py), never beside the JAX package's sources.
Unlike the JAX package there is no pure-Python twin: the columnar path
needs the runtime, so a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Tuple

import numpy as np

from ..utils.build import build_library

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "host_runtime.cpp")
CXX_CMD = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC"]

_lib = None
_lib_lock = threading.Lock()


def build(log: "list | None" = None) -> str:
    """Compile the runtime if its library is absent; returns the path."""
    return build_library("host_runtime", [SOURCE], CXX_CMD, log=log)


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    c = ctypes
    p = c.c_void_p
    lib.gt_table_new.restype = p
    lib.gt_table_new.argtypes = [c.c_int64]
    lib.gt_table_free.argtypes = [p]
    lib.gt_table_len.restype = c.c_int64
    lib.gt_table_len.argtypes = [p]
    lib.gt_table_evictions.restype = c.c_int64
    lib.gt_table_evictions.argtypes = [p]
    lib.gt_table_generation.restype = c.c_uint64
    lib.gt_table_generation.argtypes = [p]
    lib.gt_table_lookup_or_assign.argtypes = [
        p, c.c_char_p, c.c_int64, c.c_int64,
        c.POINTER(c.c_int32), c.POINTER(c.c_uint8),
    ]
    lib.gt_table_get_slot.restype = c.c_int32
    lib.gt_table_get_slot.argtypes = [p, c.c_char_p, c.c_int64]
    lib.gt_table_get_expire.argtypes = [p, p, c.c_int64, p]
    lib.gt_table_commit_keys.argtypes = [p, p, p, p, p, p, c.c_int64]
    lib.gt_table_set_expire.argtypes = [p, c.c_int32, c.c_int64]
    lib.gt_table_keys_size.argtypes = [p, c.POINTER(c.c_int64), c.POINTER(c.c_int64)]
    lib.gt_table_keys.argtypes = [p, p, p, c.c_char_p]
    lib.gt_table_enable_back.argtypes = [p, c.c_int64]
    lib.gt_table_tier_stats.argtypes = [p, p]
    lib.gt_table_starved_evictions.restype = c.c_int64
    lib.gt_table_starved_evictions.argtypes = [p]
    lib.gt_table_move_counts.argtypes = [p, c.POINTER(c.c_int64), c.POINTER(c.c_int64)]
    lib.gt_table_take_moves.restype = c.c_int32
    lib.gt_table_take_moves.argtypes = [p, c.c_int64, c.c_int64, p, p, p, p, p]
    lib.gt_table_back_size.argtypes = [p, c.POINTER(c.c_int64), c.POINTER(c.c_int64)]
    lib.gt_table_back_keys.argtypes = [p, p, p, p, c.c_char_p]
    lib.gt_table_load_back.argtypes = [p, p, p, p, p, c.c_int64, c.c_int64]
    lib.gt_mesh_get_slots.argtypes = [p, c.c_int64, p, p, c.c_int64, p, p]
    lib.gt_mesh_lookup_or_assign.argtypes = [p, c.c_int64, p, p, c.c_int64, c.c_int64,
                                             p, p, p]
    lib.gt_mesh_set_expire.argtypes = [p, p, p, p, c.c_int64]
    lib.gt_fnv1_batch.argtypes = [p, p, c.c_int64, c.c_int32, p]
    lib.gt_batch_begin.restype = p
    lib.gt_batch_begin.argtypes = [p, p, p, c.c_int64, c.c_int64]
    lib.gt_batch_plan_grouped.restype = c.c_int64
    lib.gt_batch_plan_grouped.argtypes = [
        p,  # batch
        p, p,  # algo, behavior
        p, p, p,  # hits, limit, duration
        p, p,  # greg_expire, greg_duration
        c.c_int32,  # reset mask
        p, p, p,  # round_id, slot, exists
        p, p,  # occ, write
    ]
    lib.gt_batch_commit_plan.argtypes = [p, p, p]
    lib.gt_batch_free.argtypes = [p]
    lib.gt_mesh_begin.restype = p
    lib.gt_mesh_begin.argtypes = [
        p, c.c_int64,  # tables[S], S
        p, p, c.c_int64, c.c_int64,  # keys, offsets, n, now
        p,  # counts[S] out
    ]
    lib.gt_mesh_plan_grouped.restype = c.c_int64
    lib.gt_mesh_plan_grouped.argtypes = [
        p,  # mesh plan
        p, p,  # algo, behavior
        p, p, p,  # hits, limit, duration
        p, p,  # greg_expire, greg_duration
        c.c_int32, c.c_int64,  # reset mask, P
        p, p, p,  # slot, rid, exists
        p, p, p,  # occ, write, pos
    ]
    lib.gt_mesh_finish_narrow.argtypes = [p, p, c.c_int64, p, p, p]
    lib.gt_mesh_finish_wide.argtypes = [p, p, p, p, p]
    lib.gt_mesh_free.argtypes = [p]
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded runtime (built on first call); raises on failure."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _load()
    return _lib


def pack_keys(keys) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate utf-8 keys into (bytes buffer, offsets[n+1])."""
    bs = [k.encode("utf-8") if isinstance(k, str) else k for k in keys]
    offsets = np.zeros(len(bs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in bs], out=offsets[1:])
    return np.frombuffer(b"".join(bs), dtype=np.uint8), offsets


class PackedKeys:
    """Hash keys kept in PACKED form (one utf-8 buffer + offsets[n+1]),
    so a large batch reaches the planner without one Python string per
    lane."""

    __slots__ = ("buf", "offsets")

    def __init__(self, buf: np.ndarray, offsets: np.ndarray):
        self.buf = buf
        self.offsets = offsets

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> str:
        return bytes(self.buf[self.offsets[i]:self.offsets[i + 1]]).decode("utf-8")


def as_packed(keys) -> Tuple[np.ndarray, np.ndarray]:
    """(buf, offsets) for either a PackedKeys or a list of strings."""
    if isinstance(keys, PackedKeys):
        return keys.buf, keys.offsets
    return pack_keys(keys)


def fnv1_batch(keys, variant_1a: bool = True) -> np.ndarray:
    """FNV-1a (default) or FNV-1 64-bit hashes of many keys (uint64)."""
    lib = get_lib()
    out = np.empty(max(len(keys), 1), dtype=np.uint64)
    buf, offsets = as_packed(keys)
    lib.gt_fnv1_batch(
        buf.ctypes.data, offsets.ctypes.data, len(keys),
        1 if variant_1a else 0, out.ctypes.data,
    )
    return out[: len(keys)]


class NativeSlotTable:
    """Key -> slot table of one shard: strict expiry (cache.go:151),
    same-slot recycling on expiry (cache.go:138-163), LRU eviction at
    capacity (cache.go:115-130); with `enable_back`, the front of a
    two-tier table whose evictions demote live rows to a FIFO back tier
    and whose lookups promote them again."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._lib = get_lib()
        self.capacity = capacity
        self._ptr = self._lib.gt_table_new(capacity)

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.gt_table_free(ptr)
            self._ptr = None

    def __len__(self) -> int:
        return int(self._lib.gt_table_len(self._ptr))

    # -- counters (eviction, mapping generation) ---------------------
    @property
    def generation(self) -> int:
        """Key->slot mapping-change counter (Table::map_generation);
        unchanged across two reads == no mapping changed between them."""
        return int(self._lib.gt_table_generation(self._ptr))

    @property
    def evictions(self) -> int:
        """LRU evictions so far (plan_grouped_python reads it around
        every lookup)."""
        return int(self._lib.gt_table_evictions(self._ptr))

    # ------------------------------------------------------------------
    def get_slot(self, key: str) -> "int | None":
        b = key.encode("utf-8")
        s = self._lib.gt_table_get_slot(self._ptr, b, len(b))
        return None if s < 0 else int(s)

    def lookup_or_assign(self, key: str, now_ms: int) -> Tuple[int, bool]:
        """(slot, exists) for `key`, assigning a free or LRU-evicted slot
        to a new key; exists is False for a new or expired entry."""
        b = key.encode("utf-8")
        slot = ctypes.c_int32()
        exists = ctypes.c_uint8()
        self._lib.gt_table_lookup_or_assign(
            self._ptr, b, len(b), now_ms, ctypes.byref(slot), ctypes.byref(exists)
        )
        return int(slot.value), bool(exists.value)

    def get_expire_bulk(self, slots) -> np.ndarray:
        slots = np.ascontiguousarray(slots, dtype=np.int32)
        out = np.empty(max(len(slots), 1), dtype=np.int64)
        self._lib.gt_table_get_expire(
            self._ptr, slots.ctypes.data, len(slots), out.ctypes.data
        )
        return out[: len(slots)]

    def set_expire(self, slot: int, expire_ms: int) -> None:
        self._lib.gt_table_set_expire(self._ptr, slot, expire_ms)

    def entries(self) -> Tuple[List[str], np.ndarray]:
        """(keys, slots i32) of every mapped key, in the hash map's
        iteration order (the order a snapshot's lanes follow)."""
        count = ctypes.c_int64()
        total = ctypes.c_int64()
        self._lib.gt_table_keys_size(self._ptr, ctypes.byref(count), ctypes.byref(total))
        n, nb = int(count.value), int(total.value)
        if n == 0:
            return [], np.empty(0, np.int32)
        slots = np.empty(n, dtype=np.int32)
        offsets = np.empty(n + 1, dtype=np.int64)
        buf = ctypes.create_string_buffer(max(nb, 1))
        self._lib.gt_table_keys(self._ptr, slots.ctypes.data, offsets.ctypes.data, buf)
        raw = buf.raw[:nb]
        return [raw[offsets[i]:offsets[i + 1]].decode("utf-8") for i in range(n)], slots

    def keys(self) -> List[str]:
        return self.entries()[0]

    # -- two-tier back tier --------------------------------------------
    def enable_back(self, back_capacity: int) -> None:
        """Turn on the back tier: front LRU evictions demote rows to a
        FIFO back table instead of dropping them; lookups promote them
        back.  Device moves queue in the table until take_moves."""
        self._lib.gt_table_enable_back(self._ptr, back_capacity)

    @property
    def tier_stats(self) -> Tuple[int, int, int, int, int]:
        """(total_keys, back_keys, demotions, promotions, back_evictions)."""
        out = (ctypes.c_int64 * 5)()
        self._lib.gt_table_tier_stats(self._ptr, out)
        return tuple(int(x) for x in out)

    @property
    def starved_evictions(self) -> int:
        """Evictions that found every front slot pending (an in-flight
        write or a queued promotion) and fell back to a lower rung."""
        return int(self._lib.gt_table_starved_evictions(self._ptr))

    def move_counts(self) -> Tuple[int, int]:
        """(queued promotions, queued demotions) of this drain window."""
        n_promo, n_demo = ctypes.c_int64(), ctypes.c_int64()
        self._lib.gt_table_move_counts(self._ptr, ctypes.byref(n_promo),
                                       ctypes.byref(n_demo))
        return int(n_promo.value), int(n_demo.value)

    def take_moves(self):
        """Drain the queued device moves: (promo_kind, promo_src,
        promo_dst, demo_src, demo_dst) i32 arrays.  The caller MUST
        apply them (ops/buckets.py apply_moves) before any other launch
        touches the front rows."""
        while True:
            n_promo, n_demo = self.move_counts()
            arrays = [np.empty(max(n, 1), np.int32)
                      for n in (n_promo,) * 3 + (n_demo,) * 2]
            if self._lib.gt_table_take_moves(
                    self._ptr, n_promo, n_demo, *[a.ctypes.data for a in arrays]) == 0:
                break  # else a concurrent plan queued more: size again
        pk, ps, pd, ds, dd = arrays
        return pk[:n_promo], ps[:n_promo], pd[:n_promo], ds[:n_demo], dd[:n_demo]

    def back_entries(self) -> Tuple[List[str], np.ndarray, np.ndarray]:
        """(keys, back_slots i32, expire i64) of every back-tier row, in
        the hash map's iteration order."""
        count = ctypes.c_int64()
        total = ctypes.c_int64()
        self._lib.gt_table_back_size(self._ptr, ctypes.byref(count), ctypes.byref(total))
        n, nb = int(count.value), int(total.value)
        if n == 0:
            return [], np.empty(0, np.int32), np.empty(0, np.int64)
        slots = np.empty(n, dtype=np.int32)
        expire = np.empty(n, dtype=np.int64)
        offsets = np.empty(n + 1, dtype=np.int64)
        buf = ctypes.create_string_buffer(max(nb, 1))
        self._lib.gt_table_back_keys(self._ptr, slots.ctypes.data, expire.ctypes.data,
                                     offsets.ctypes.data, buf)
        raw = buf.raw[:nb]
        keys = [raw[offsets[i]:offsets[i + 1]].decode("utf-8") for i in range(n)]
        return keys, slots, expire

    def load_back(self, keys, slots, expire, cursor: int) -> None:
        """Map `keys` to back slots `slots` with their expiries, in
        order, and set the FIFO cursor (a fresh table with its back tier
        enabled; MeshBucketStore.load_state_numpy)."""
        slots = np.ascontiguousarray(slots, dtype=np.int32)
        expire = np.ascontiguousarray(expire, dtype=np.int64)
        buf, offsets = pack_keys(keys)
        self._lib.gt_table_load_back(
            self._ptr, slots.ctypes.data, expire.ctypes.data,
            buf.ctypes.data if len(buf) else None, offsets.ctypes.data,
            len(slots), cursor)

    def commit(self, slots, new_expire_ms, removed, keys) -> None:
        """Key-guarded commit (gt_table_commit_keys): an unmapped slot
        is mapped to its lane's key; a slot owned by another key is
        left alone."""
        slots = np.ascontiguousarray(slots, dtype=np.int32)
        expire = np.ascontiguousarray(new_expire_ms, dtype=np.int64)
        rm = np.ascontiguousarray(removed, dtype=np.uint8)
        buf, offsets = pack_keys(keys)
        self._lib.gt_table_commit_keys(
            self._ptr, slots.ctypes.data, expire.ctypes.data, rm.ctypes.data,
            buf.ctypes.data if len(buf) else None, offsets.ctypes.data,
            len(slots),
        )


def _table_ptrs(tables):
    return (ctypes.c_void_p * len(tables))(*[t._ptr for t in tables])


def mesh_get_slots(tables, keys) -> Tuple[np.ndarray, np.ndarray]:
    """(shard i32[n], slot i32[n]) of each key: its shard by the static
    shardmap and its slot there, -1 when the key is not mapped."""
    buf, offsets = as_packed(keys)
    n = len(offsets) - 1
    shard = np.empty(max(n, 1), np.int32)
    slot = np.empty(max(n, 1), np.int32)
    tables[0]._lib.gt_mesh_get_slots(
        _table_ptrs(tables), len(tables), buf.ctypes.data if n else None,
        offsets.ctypes.data, n, shard.ctypes.data, slot.ctypes.data)
    return shard[:n], slot[:n]


def mesh_lookup_or_assign(tables, keys, now_ms: int):
    """(shard i32[n], slot i32[n], exists bool[n]): each key's shard and
    `lookup_or_assign` there, key by key in order."""
    buf, offsets = as_packed(keys)
    n = len(offsets) - 1
    shard = np.empty(max(n, 1), np.int32)
    slot = np.empty(max(n, 1), np.int32)
    exists = np.empty(max(n, 1), np.uint8)
    tables[0]._lib.gt_mesh_lookup_or_assign(
        _table_ptrs(tables), len(tables), buf.ctypes.data if n else None,
        offsets.ctypes.data, n, now_ms, shard.ctypes.data, slot.ctypes.data,
        exists.ctypes.data)
    return shard[:n], slot[:n], exists[:n].astype(bool)


def mesh_set_expire(tables, shard, slot, expire) -> None:
    """Set the table expiry of (shard[i], slot[i]) to expire[i], in
    order."""
    shard = np.ascontiguousarray(shard, np.int32)
    slot = np.ascontiguousarray(slot, np.int32)
    expire = np.ascontiguousarray(expire, np.int64)
    tables[0]._lib.gt_mesh_set_expire(
        _table_ptrs(tables), shard.ctypes.data, slot.ctypes.data,
        expire.ctypes.data, len(shard))


class NativeBatchPlanner:
    """Round planner of one slot table (ShardStore's columnar path): the
    whole key batch resolved and split into kernel rounds in C++
    (gt_batch_*), committed back after the launch.  The planner borrows
    the packed key buffer, so it keeps it alive until freed."""

    def __init__(self, table: NativeSlotTable, keys, now_ms: int):
        self._lib = table._lib
        self._table = table
        self.n = len(keys)
        self._buf, self._offsets = as_packed(keys)
        self._ptr = self._lib.gt_batch_begin(
            table._ptr, self._buf.ctypes.data if self.n else None,
            self._offsets.ctypes.data, self.n, now_ms,
        )

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.gt_batch_free(ptr)
            self._ptr = None

    def plan_grouped(self, cols, reset_mask: int):
        """Grouped full plan (gt_batch_plan_grouped): uniform duplicate
        groups collapse into round 0 with per-lane occurrence indices;
        the rest take rounds 1+.  `cols` holds contiguous algo and
        behavior (i32) and hits, limit, duration, greg_expire,
        greg_duration (i64) aligned with the keys.  Returns (round_id,
        slot, exists, occ, write, n_rounds)."""
        n = max(self.n, 1)
        round_id = np.zeros(n, dtype=np.int32)
        slots = np.empty(n, dtype=np.int32)
        exists = np.empty(n, dtype=np.uint8)
        occ = np.zeros(n, dtype=np.int32)
        write = np.empty(n, dtype=np.uint8)
        n_rounds = self._lib.gt_batch_plan_grouped(
            self._ptr,
            cols.algo.ctypes.data, cols.behavior.ctypes.data,
            cols.hits.ctypes.data, cols.limit.ctypes.data,
            cols.duration.ctypes.data,
            cols.greg_expire.ctypes.data, cols.greg_duration.ctypes.data,
            reset_mask,
            round_id.ctypes.data, slots.ctypes.data, exists.ctypes.data,
            occ.ctypes.data, write.ctypes.data,
        )
        m = self.n
        return (round_id[:m], slots[:m], exists[:m].astype(bool),
                occ[:m], write[:m].astype(bool), int(n_rounds))

    def commit_plan(self, new_expire_ms, removed) -> None:
        """Fold the launch's outputs (in the keys' order) back into the
        table; the last write of a key wins."""
        expire = np.ascontiguousarray(new_expire_ms, dtype=np.int64)
        rm = np.ascontiguousarray(removed, dtype=np.uint8)
        self._lib.gt_batch_commit_plan(self._ptr, expire.ctypes.data, rm.ctypes.data)


class NativeMeshPlanner:
    """Whole-mesh columnar planning in single C++ calls: shard-bucket
    (fnv1a % S), per-shard grouped round planning into padded [S, P]
    arrays, and post-launch decode + slot-table commit + original-order
    response scatter (gt_mesh_*).

    Lifecycle (plan under the store's `_plan_lock`; finish from the
    FIFO resolver — the per-table C++ mutex makes a finish safe against
    the NEXT batch's concurrent plan):
        mp = NativeMeshPlanner(tables, keys, now_ms)   # begin: counts
        n_rounds = mp.plan_grouped(cols, reset_mask, P)
        ... kernel launch ...
        status, remaining, reset = mp.finish_narrow(packed_np, now_ms)
    """

    __slots__ = ("_lib", "_tables", "_ptr", "n", "counts", "padded",
                 "pos", "slot", "rid", "exists", "occ", "write",
                 "_keepalive")

    def __init__(self, tables, keys, now_ms: int):
        self._lib = tables[0]._lib
        self._tables = tables  # keep tables (and their C ptrs) alive
        S = len(tables)
        buf, offsets = as_packed(keys)
        self.n = len(offsets) - 1
        self.counts = np.zeros(S, dtype=np.int64)
        ptrs = (ctypes.c_void_p * S)(*[t._ptr for t in tables])
        self._keepalive = (buf, offsets, ptrs)
        self._ptr = self._lib.gt_mesh_begin(
            ptrs, S, buf.ctypes.data if self.n else None,
            offsets.ctypes.data, self.n, now_ms, self.counts.ctypes.data,
        )

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.gt_mesh_free(ptr)
            self._ptr = None

    def plan_grouped(self, cols, reset_mask: int, padded: int) -> int:
        """Plan every shard into padded [S, P] row-major arrays; returns
        n_rounds.  Padding lanes keep slot=-1 / zeros."""
        S = len(self.counts)
        self.padded = padded
        self.slot = np.full((S, padded), -1, dtype=np.int32)
        self.rid = np.zeros((S, padded), dtype=np.int32)
        self.exists = np.zeros((S, padded), dtype=np.uint8)
        self.occ = np.zeros((S, padded), dtype=np.int32)
        self.write = np.zeros((S, padded), dtype=np.uint8)
        self.pos = np.zeros(max(self.n, 1), dtype=np.int64)
        n_rounds = self._lib.gt_mesh_plan_grouped(
            self._ptr,
            cols.algo.ctypes.data, cols.behavior.ctypes.data,
            cols.hits.ctypes.data, cols.limit.ctypes.data,
            cols.duration.ctypes.data,
            cols.greg_expire.ctypes.data, cols.greg_duration.ctypes.data,
            reset_mask, padded,
            self.slot.ctypes.data, self.rid.ctypes.data,
            self.exists.ctypes.data, self.occ.ctypes.data,
            self.write.ctypes.data, self.pos.ctypes.data,
        )
        return int(n_rounds)

    def finish_narrow(self, packed_np, now_ms: int):
        """Decode + commit a narrow i32[S, 4, P] result; returns
        (status i32[n], remaining i64[n], reset_time i64[n]) in
        ORIGINAL lane order."""
        packed_np = np.ascontiguousarray(packed_np, dtype=np.int32)
        status = np.empty(max(self.n, 1), dtype=np.int32)
        remaining = np.empty(max(self.n, 1), dtype=np.int64)
        reset = np.empty(max(self.n, 1), dtype=np.int64)
        self._lib.gt_mesh_finish_narrow(
            self._ptr, packed_np.ctypes.data, now_ms,
            status.ctypes.data, remaining.ctypes.data, reset.ctypes.data,
        )
        return status[: self.n], remaining[: self.n], reset[: self.n]

    def finish_wide(self, packed_np):
        """Decode + commit a wide i64[S, 4, P] result (absolute values)."""
        packed_np = np.ascontiguousarray(packed_np, dtype=np.int64)
        status = np.empty(max(self.n, 1), dtype=np.int32)
        remaining = np.empty(max(self.n, 1), dtype=np.int64)
        reset = np.empty(max(self.n, 1), dtype=np.int64)
        self._lib.gt_mesh_finish_wide(
            self._ptr, packed_np.ctypes.data,
            status.ctypes.data, remaining.ctypes.data, reset.ctypes.data,
        )
        return status[: self.n], remaining[: self.n], reset[: self.n]
