"""ctypes loader for the port's C++ host runtime (host_runtime.cpp).

The runtime is compiled with g++ at first use into the port's build
directory (utils/build.py), never beside the JAX package's sources.
Unlike the JAX package there is no pure-Python twin: the columnar path
needs the runtime, so a failed build raises.

Bound here: the slot tables and the planners (the store layer), and the
HTTP edge — the native JSON parse and render (`parse_json_batch`,
`render_json`), the GUBC kind-5 frame parse (`parse_ingress_frame`),
the epoll HTTP/1.1 edge (`HttpEdge`) and the native ingress ring
(`IngressBatcher`, `IngressTakenBatch`), the JAX package's bindings.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Tuple

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
    lib.gt_table_stats.argtypes = [p, p]
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
    lib.gt_table_remove.argtypes = [p, c.c_char_p, c.c_int64]
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
    lib.gt_mesh_times.argtypes = [p, p]
    lib.gt_json_parse.restype = p
    lib.gt_json_parse.argtypes = [c.c_char_p, c.c_int64]
    lib.gt_json_n.restype = c.c_int64
    lib.gt_json_n.argtypes = [p]
    lib.gt_json_hk_bytes.restype = c.c_int64
    lib.gt_json_hk_bytes.argtypes = [p]
    lib.gt_json_fill.argtypes = [p] + [p] * 10
    lib.gt_json_free.argtypes = [p]
    lib.gt_json_render.restype = c.c_int64
    lib.gt_json_render.argtypes = [
        p, p, p, p, c.c_int64,
        p, c.c_int64, c.c_char_p, p, c.c_char_p,
        c.c_int64,
    ]
    lib.gt_frame_parse.restype = p
    lib.gt_frame_parse.argtypes = [
        c.c_char_p, c.c_int64, c.c_int32, p,
    ]
    lib.gt_frame_fill.argtypes = [p] + [p] * 3
    lib.gt_frame_free.argtypes = [p]
    lib.gt_http_start.restype = p
    lib.gt_http_start.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_char_p]
    lib.gt_http_port.restype = c.c_int
    lib.gt_http_port.argtypes = [p]
    lib.gt_http_acceptor_count.restype = c.c_int
    lib.gt_http_acceptor_count.argtypes = [p]
    lib.gt_http_acceptor_stats.argtypes = [p, p]
    lib.gt_http_next.restype = c.c_int
    lib.gt_http_next.argtypes = [p, c.c_int64, p]
    lib.gt_http_respond.argtypes = [
        p, c.c_uint64, c.c_int, c.c_char_p, c.c_char_p,
        c.c_char_p, c.c_int64,
    ]
    lib.gt_http_shutdown.argtypes = [p]
    lib.gt_http_free.argtypes = [p]
    lib.gt_ingress_new.restype = p
    lib.gt_ingress_new.argtypes = []
    lib.gt_ingress_set_ring.argtypes = [
        p, p, p, c.c_int64,  # vh, vself, nv
        c.c_int32, c.c_int32,                           # all_self, enabled
        c.c_int64, c.c_int64,                # cap_lanes, max_frame_lanes
        c.c_int32, c.c_int32,                # behavior_mask, hash_variant
        c.c_int32,                           # express_mask
    ]
    lib.gt_ingress_submit.restype = c.c_int
    lib.gt_ingress_submit.argtypes = [p, p, c.c_uint64]
    lib.gt_ingress_take.restype = c.c_int
    lib.gt_ingress_take.argtypes = [
        p, c.c_int64, c.c_int64,
        c.POINTER(p), p,
    ]
    lib.gt_ingress_complete.argtypes = [p] + [p] * 4
    lib.gt_ingress_fail.argtypes = [
        p, c.c_int, c.c_char_p, c.c_char_p, c.c_char_p, c.c_int64,
    ]
    lib.gt_ingress_stop.argtypes = [p]
    lib.gt_ingress_stats.argtypes = [p, p]
    lib.gt_ingress_free.argtypes = [p]
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

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    @staticmethod
    def concat(parts: "List[PackedKeys]") -> "PackedKeys":
        """Concatenate packed key batches without materializing
        strings (the ColumnarBatcher's multi-submission coalesce)."""
        bufs = [p.buf for p in parts]
        offs = [parts[0].offsets]
        base = int(parts[0].offsets[-1])
        for p in parts[1:]:
            offs.append(p.offsets[1:] + base)
            base += int(p.offsets[-1])
        return PackedKeys(np.concatenate(bufs), np.concatenate(offs))

    def subset(self, idx) -> "PackedKeys":
        """Vectorized selection of lanes `idx` (no per-lane Python)."""
        idx = np.asarray(idx, dtype=np.int64)
        o = self.offsets
        starts = o[idx]
        lens = o[idx + 1] - starts
        new_off = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=new_off[1:])
        total = int(new_off[-1])
        pos = np.repeat(starts - new_off[:-1], lens) + np.arange(total, dtype=np.int64)
        return PackedKeys(self.buf[pos], new_off)


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

    # -- counters (hits, misses, eviction, mapping generation) -------
    @property
    def _stats(self) -> Tuple[int, int, int]:
        out = np.zeros(3, dtype=np.int64)
        self._lib.gt_table_stats(self._ptr, out.ctypes.data)
        return int(out[0]), int(out[1]), int(out[2])

    @property
    def hits(self) -> int:
        """Lookups that found a live row (a promotion from the back tier
        included)."""
        return self._stats[0]

    @property
    def misses(self) -> int:
        """Lookups that created a row or recycled an expired one."""
        return self._stats[1]

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

    def remove(self, key: str) -> None:
        """Drop `key`: its front slot is freed and, in two-tier mode, its
        back row too, with its queued demotion cancelled."""
        b = key.encode("utf-8")
        self._lib.gt_table_remove(self._ptr, b, len(b))

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

    Each plan times itself (`times()`, gt_mesh_times): the seconds
    inside gt_mesh_begin (hashing and bucketing every key) and
    gt_mesh_plan_grouped (each shard's plan) with the waits for a
    shard's table lock left out, and those waits in plan and in finish
    (a finish of batch N holds a shard's lock while batch N+1 plans).
    A lock is tried first and the clock read only when it is held
    elsewhere, so an uncontended lock adds nothing.
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

    def times(self):
        """(planner, plan's table-lock waits, finish's table-lock waits)
        of this plan so far, in s."""
        out = np.zeros(3, dtype=np.int64)
        self._lib.gt_mesh_times(self._ptr, out.ctypes.data)
        return tuple(v / 1e9 for v in out.tolist())


# ---------------------------------------------------------------------
# The HTTP edge: JSON and GUBC frame parsers, the JSON renderer, the
# epoll HTTP/1.1 edge and the native ingress ring (host_runtime.cpp
# gt_json_*, gt_frame_*, gt_http_*, gt_ingress_*).
# ---------------------------------------------------------------------
class ParsedJson:
    """Result of the native GetRateLimits JSON parse (gt_json_parse):
    kernel-ready columns + packed hash keys + validation codes +
    (offset, len) spans of each name/unique_key in the body."""

    __slots__ = ("n", "algo", "behavior", "hits", "limit", "duration",
                 "err", "hash_keys", "nspan", "ukspan", "body")

    def __init__(self, n, algo, behavior, hits, limit, duration, err,
                 hash_keys, nspan, ukspan, body):
        self.n = n
        self.algo = algo
        self.behavior = behavior
        self.hits = hits
        self.limit = limit
        self.duration = duration
        self.err = err
        self.hash_keys = hash_keys
        self.nspan = nspan
        self.ukspan = ukspan
        self.body = body

    def name_at(self, i: int) -> str:
        off, ln = self.nspan[2 * i], self.nspan[2 * i + 1]
        return self.body[off:off + ln].decode("utf-8")

    def unique_key_at(self, i: int) -> str:
        off, ln = self.ukspan[2 * i], self.ukspan[2 * i + 1]
        return self.body[off:off + ln].decode("utf-8")


def parse_json_batch(body: bytes) -> Optional[ParsedJson]:
    """Parse a /v1/GetRateLimits body natively; None means "use the
    Python parse" (escape sequences in keys, floats, behavior flag
    lists, malformed JSON — anything beyond the common wire shape).
    The Python parse is the JSON semantics, not a device fallback."""
    lib = get_lib()
    h = lib.gt_json_parse(body, len(body))
    if not h:
        return None
    try:
        n = int(lib.gt_json_n(h))
        hkb = int(lib.gt_json_hk_bytes(h))
        algo = np.empty(n, dtype=np.int32)
        behavior = np.empty(n, dtype=np.int32)
        hits = np.empty(n, dtype=np.int64)
        limit = np.empty(n, dtype=np.int64)
        duration = np.empty(n, dtype=np.int64)
        err = np.empty(n, dtype=np.uint8)
        hk = np.empty(hkb, dtype=np.uint8)
        hkoff = np.empty(n + 1, dtype=np.int64)
        nspan = np.empty(2 * n, dtype=np.int64)
        ukspan = np.empty(2 * n, dtype=np.int64)
        lib.gt_json_fill(
            h, algo.ctypes.data, behavior.ctypes.data, hits.ctypes.data,
            limit.ctypes.data, duration.ctypes.data, err.ctypes.data,
            hk.ctypes.data, hkoff.ctypes.data, nspan.ctypes.data,
            ukspan.ctypes.data,
        )
    finally:
        lib.gt_json_free(h)
    return ParsedJson(n, algo, behavior, hits, limit, duration, err,
                      PackedKeys(hk, hkoff), nspan, ukspan, body)


class _GtFrameInfo(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int64) for name in (
        "n", "name_off_pos", "name_blob_pos", "uk_off_pos", "uk_blob_pos",
        "algo_pos", "beh_pos", "hits_pos", "limit_pos", "dur_pos",
        "trace_pos", "trace_count", "hk_bytes",
    )]


_INGRESS_FRAME_KIND = 5  # wire._FRAME_KIND_INGRESS_REQ


def parse_ingress_frame(raw: bytes):
    """Parse a public GUBC ingress frame (kind 5) natively: one
    GIL-released pass validates the frame, slices every column (numpy
    views of `raw`, zero-copy numerics), builds the packed hash keys
    and stamps per-lane validation codes — the wire.decode_ingress_frame
    fast path.  None means "use the Python decode" (a malformed frame
    whose exact error wording the Python path owns)."""
    lib = get_lib()
    info = _GtFrameInfo()
    h = lib.gt_frame_parse(raw, len(raw), _INGRESS_FRAME_KIND,
                           ctypes.byref(info))
    if not h:
        return None
    try:
        n = int(info.n)
        hk = np.empty(max(int(info.hk_bytes), 1), dtype=np.uint8)
        hkoff = np.empty(n + 1, dtype=np.int64)
        err = np.empty(max(n, 1), dtype=np.uint8)
        lib.gt_frame_fill(h, hk.ctypes.data, hkoff.ctypes.data,
                          err.ctypes.data)
    finally:
        lib.gt_frame_free(h)
    from .. import wire  # deferred: wire imports this package lazily

    no = np.frombuffer(raw, np.uint32, n + 1, int(info.name_off_pos))
    uo = np.frombuffer(raw, np.uint32, n + 1, int(info.uk_off_pos))
    nb = raw[int(info.name_blob_pos):int(info.name_blob_pos) + int(no[-1] if n else 0)]
    ub = raw[int(info.uk_blob_pos):int(info.uk_blob_pos) + int(uo[-1] if n else 0)]
    try:
        # Untrusted-edge parity with wire._check_utf8_blobs: invalid
        # UTF-8 must 400 here, not 500 later inside a slow-lane decode.
        nb.decode("utf-8")
        ub.decode("utf-8")
    except UnicodeDecodeError:
        return None  # the Python decode owns the exact error wording
    trace_ctx = None
    if info.trace_count > 0:
        trace_ctx, _ = wire.unpack_trace_entries(raw, int(info.trace_pos))
    return wire.FrameIngressColumns(
        n, nb, no, ub, uo,
        np.frombuffer(raw, np.int32, n, int(info.algo_pos)),
        np.frombuffer(raw, np.int32, n, int(info.beh_pos)),
        np.frombuffer(raw, np.int64, n, int(info.hits_pos)),
        np.frombuffer(raw, np.int64, n, int(info.limit_pos)),
        np.frombuffer(raw, np.int64, n, int(info.dur_pos)),
        trace_ctx=trace_ctx,
        err=err[:n],
        packed=PackedKeys(hk[:int(info.hk_bytes)], hkoff),
    )


def render_json(status, limit, remaining, reset, overrides: dict) -> Optional[bytes]:
    """Build the GetRateLimits response body natively; `overrides` maps
    lane index -> pre-rendered JSON bytes (error / forwarded lanes)."""
    lib = get_lib()
    n = len(status)
    status = np.ascontiguousarray(status, dtype=np.int32)
    limit = np.ascontiguousarray(limit, dtype=np.int64)
    remaining = np.ascontiguousarray(remaining, dtype=np.int64)
    reset = np.ascontiguousarray(reset, dtype=np.int64)
    if overrides:
        items = sorted(overrides.items())
        ov_idx = np.asarray([i for i, _ in items], dtype=np.int64)
        bufs = [b for _, b in items]
        ov_off = np.zeros(len(bufs) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in bufs], out=ov_off[1:])
        ov_buf = b"".join(bufs)
    else:
        ov_idx = np.empty(0, dtype=np.int64)
        ov_off = np.zeros(1, dtype=np.int64)
        ov_buf = b""
    n_ov = len(ov_idx)
    # Single-pass render into a worst-case buffer (<=129 bytes per
    # plain lane; see gt_json_render).
    cap = 32 + n * 160 + len(ov_buf) + n_ov * 2
    out = ctypes.create_string_buffer(cap)
    size = lib.gt_json_render(
        status.ctypes.data, limit.ctypes.data, remaining.ctypes.data,
        reset.ctypes.data, n, ov_idx.ctypes.data, n_ov, ov_buf,
        ov_off.ctypes.data, out, cap,
    )
    if size < 0:
        return None  # cap overflow (cannot happen by construction)
    return out.raw[:size]


class _GtHttpReq(ctypes.Structure):
    _fields_ = [
        ("token", ctypes.c_uint64),
        ("method", ctypes.c_int32),
        ("path_len", ctypes.c_int32),
        ("body_len", ctypes.c_int64),
        ("path", ctypes.c_char_p),
        ("body", ctypes.POINTER(ctypes.c_char)),
    ]


_HTTP_METHODS = {0: "GET", 1: "POST"}


#: Sentinel next() returns when the native fast lane consumed the
#: request (gt_ingress_submit took ownership — no Python handling).
FAST_LANE = object()

_INGRESS_SNIFF = b"GUBC\x01\x05"  # magic + version + kind-5


class HttpEdge:
    """ctypes wrapper over the C++ epoll HTTP server (gt_http_*).

    `acceptors` native epoll threads share the TCP port via
    SO_REUSEPORT (1 = the classic single loop); `uds_path` adds an
    AF_UNIX listener speaking the same protocol.  Python workers call
    next() (GIL released while blocked in the native wait) and answer
    with respond().  See gateway.NativeGatewayServer for the worker
    loop."""

    def __init__(self, listen_address: str = "127.0.0.1:0",
                 acceptors: int = 1, uds_path: str = ""):
        lib = get_lib()
        self._lib = lib
        host, _, port = listen_address.partition(":")
        # gt_http_start takes a dotted-quad (AF_INET): resolve hostnames
        # here so 'localhost:1051' etc. keep working like the stdlib
        # gateway.  IPv6 listen addresses are not supported by this edge.
        import socket as _socket

        host_ip = _socket.gethostbyname(host or "127.0.0.1")
        self._ptr = lib.gt_http_start(
            host_ip.encode(), int(port or 0), int(acceptors),
            uds_path.encode(),
        )
        if not self._ptr:
            raise OSError(
                f"gt_http_start failed to bind {listen_address}"
                + (f" / uds {uds_path}" if uds_path else "")
            )
        self.port = int(lib.gt_http_port(self._ptr))
        self.acceptors = int(lib.gt_http_acceptor_count(self._ptr))
        self.uds_path = uds_path
        self.stopped = False
        self._freed = False
        self._stop_lock = threading.Lock()

    def acceptor_stats(self):
        """Per-acceptor counters: list of dicts {uds, accepted,
        requests, ingressFrames, ingressLanes, wakeups, conns} — the
        gubernator_ingress_acceptor_* metric source and the fairness
        tests' oracle.  A freed edge reads as empty, never a crash."""
        if self._ptr is None:
            return []
        n = self.acceptors
        out = np.zeros(n * 7, dtype=np.int64)
        self._lib.gt_http_acceptor_stats(self._ptr, out.ctypes.data)
        keys = ("uds", "accepted", "requests", "ingressFrames",
                "ingressLanes", "wakeups", "conns")
        return [
            dict(zip(keys, (int(v) for v in out[i * 7:(i + 1) * 7])))
            for i in range(n)
        ]

    def next(self, timeout_ms: int = 200, ingress=None):
        """Blocks up to timeout_ms for one parsed request.  Returns
        (token, method, path, body_bytes), None (timeout/stopping), or
        FAST_LANE when `ingress` (an IngressBatcher) consumed the
        request natively — a POST /v1/GetRateLimits whose body sniffs
        as a kind-5 frame goes through gt_ingress_submit WITHOUT
        copying the body into Python; any fallback reason (malformed,
        slow lanes, remote owners, disabled) falls through to the
        ordinary copy-out so the Python path serves it unchanged.
        The copied body means the token may be answered from any
        thread at any later time."""
        if self.stopped:
            return None
        req = _GtHttpReq()
        rc = self._lib.gt_http_next(self._ptr, timeout_ms, ctypes.byref(req))
        if rc != 1:
            return None
        if (
            ingress is not None
            and req.method == 1
            and req.body_len >= 10
            and ctypes.string_at(req.body, 6) == _INGRESS_SNIFF
            and req.path == b"/v1/GetRateLimits"
        ):
            if self._lib.gt_ingress_submit(
                self._ptr, ingress._ptr, req.token
            ) == 0:
                return FAST_LANE
        method = _HTTP_METHODS.get(req.method, "OTHER")
        path = req.path.decode("utf-8", "replace") if req.path else ""
        body = ctypes.string_at(req.body, req.body_len) if req.body_len else b""
        return req.token, method, path, body

    def respond(self, token: int, status: int, body: bytes,
                reason: str = "OK", content_type: str = "application/json"):
        self._lib.gt_http_respond(
            self._ptr, token, status, reason.encode(), content_type.encode(),
            body, len(body),
        )

    def shutdown(self) -> None:
        """Phase 1: stop traffic (closes sockets, joins the native
        epoll thread).  The HttpServer stays ALLOCATED: workers still
        blocked in next() or about to respond() keep valid memory.
        Callers must join their workers, then call free()."""
        with self._stop_lock:
            if self.stopped:
                return
            self.stopped = True
        self._lib.gt_http_shutdown(self._ptr)

    def free(self) -> None:
        """Phase 2: release the native server.  Only safe after every
        worker thread using this edge has exited."""
        with self._stop_lock:
            if self._freed or self._ptr is None:
                return
            self._freed = True
        self._lib.gt_http_free(self._ptr)
        self._ptr = None


class _GtTakenInfo(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("n_frames", ctypes.c_int64),
        ("algo", ctypes.POINTER(ctypes.c_int32)),
        ("beh", ctypes.POINTER(ctypes.c_int32)),
        ("hits", ctypes.POINTER(ctypes.c_int64)),
        ("limit", ctypes.POINTER(ctypes.c_int64)),
        ("duration", ctypes.POINTER(ctypes.c_int64)),
        ("hk", ctypes.POINTER(ctypes.c_uint8)),
        ("hkoff", ctypes.POINTER(ctypes.c_int64)),
        ("hk_bytes", ctypes.c_int64),
        ("hashes", ctypes.POINTER(ctypes.c_uint64)),
        ("name_blob", ctypes.POINTER(ctypes.c_uint8)),
        ("name_off", ctypes.POINTER(ctypes.c_int64)),
        ("name_bytes", ctypes.c_int64),
        ("uk_blob", ctypes.POINTER(ctypes.c_uint8)),
        ("uk_off", ctypes.POINTER(ctypes.c_int64)),
        ("uk_bytes", ctypes.c_int64),
        ("frame_lanes", ctypes.POINTER(ctypes.c_int64)),
        ("frame_age_us", ctypes.POINTER(ctypes.c_int64)),
        ("parse_ns_total", ctypes.c_int64),
    ]


def _view(ptr, n, dtype):
    """Zero-copy numpy view over a C pointer (no ownership)."""
    if n == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
        shape=((n * np.dtype(dtype).itemsize),),
    ).view(dtype)


class IngressTakenBatch:
    """One coalesced batch from the native ingress ring: contiguous
    kernel-ready column arrays spanning every taken frame, as ZERO-COPY
    numpy views of C++-owned buffers.  Valid ONLY until
    IngressBatcher.complete()/fail() releases the handle — the pump is
    the sole owner and must not let views escape the dispatch round.

    Quacks like wire.FrameIngressColumns where the batch-granularity
    folds need it (len, .hits/.behavior/..., `_nb`/`_no`/`_uo` name
    columns for the tenant fold, packed hash keys + ring hashes for
    the hot-key sketch)."""

    __slots__ = ("_ptr", "n", "n_frames", "algorithm", "behavior", "hits",
                 "limit", "duration", "hash_keys", "hashes", "frame_lanes",
                 "frame_age_us", "parse_ns_total", "_nb", "_no", "_ub",
                 "_uo", "trace_ctx")

    def __init__(self, ptr, info: _GtTakenInfo):
        self._ptr = ptr
        n = int(info.n)
        self.n = n
        self.n_frames = int(info.n_frames)
        self.algorithm = _view(info.algo, n, np.int32)
        self.behavior = _view(info.beh, n, np.int32)
        self.hits = _view(info.hits, n, np.int64)
        self.limit = _view(info.limit, n, np.int64)
        self.duration = _view(info.duration, n, np.int64)
        self.hash_keys = PackedKeys(
            _view(info.hk, int(info.hk_bytes), np.uint8),
            _view(info.hkoff, n + 1, np.int64),
        )
        self.hashes = _view(info.hashes, n, np.uint64)
        self._nb = _view(info.name_blob, int(info.name_bytes), np.uint8)
        self._no = _view(info.name_off, n + 1, np.int64)
        self._ub = _view(info.uk_blob, int(info.uk_bytes), np.uint8)
        self._uo = _view(info.uk_off, n + 1, np.int64)
        self.frame_lanes = _view(info.frame_lanes, self.n_frames, np.int64)
        self.frame_age_us = _view(info.frame_age_us, self.n_frames, np.int64)
        self.parse_ns_total = int(info.parse_ns_total)
        self.trace_ctx = None  # fast lane never carries sampled frames

    def __len__(self) -> int:
        return self.n

    def _name_at(self, i: int) -> str:
        return bytes(self._nb[self._no[i]:self._no[i + 1]]).decode("utf-8")

    def _uk_at(self, i: int) -> str:
        return bytes(self._ub[self._uo[i]:self._uo[i + 1]]).decode("utf-8")


class IngressBatcher:
    """The native ingress ring (gt_ingress_*): gateway workers submit
    kind-5 frames GIL-free; the NativeIngressPump takes coalesced
    batches, dispatches them at batch granularity, and completes them
    back into native kind-6 response fills.  See host_runtime.cpp
    'Native ingress service loop' for the full contract."""

    STAT_KEYS = ("frames", "lanes", "batches", "shedFrames", "shedLanes",
                 "fallbacks", "pendingFrames", "pendingLanes",
                 "expressFrames", "expressLanes")

    def __init__(self):
        lib = get_lib()
        self._lib = lib
        self._ptr = lib.gt_ingress_new()
        self.stopped = False

    def set_ring(self, vnode_hashes, vnode_self, *, all_self: bool,
                 enabled: bool, cap_lanes: int, max_frame_lanes: int,
                 behavior_mask: int, hash_variant: int = 0,
                 express_mask: int = 0) -> None:
        vh = np.ascontiguousarray(vnode_hashes, dtype=np.uint64)
        vs = np.ascontiguousarray(vnode_self, dtype=np.uint8)
        self._lib.gt_ingress_set_ring(
            self._ptr, vh.ctypes.data, vs.ctypes.data, len(vh),
            1 if all_self else 0, 1 if enabled else 0,
            int(cap_lanes), int(max_frame_lanes), int(behavior_mask),
            int(hash_variant), int(express_mask),
        )

    def disable(self) -> None:
        """Fast path off (every submit falls back to Python) without
        touching the rest of the config."""
        self.set_ring(
            np.zeros(0, np.uint64), np.zeros(0, np.uint8),
            all_self=False, enabled=False, cap_lanes=0,
            max_frame_lanes=0, behavior_mask=0,
        )

    def take(self, max_lanes: int, timeout_ms: int = 200):
        """Block (GIL released) for one coalesced batch; None on
        timeout or shutdown (check .stopped)."""
        tb = ctypes.c_void_p()
        info = _GtTakenInfo()
        rc = self._lib.gt_ingress_take(
            self._ptr, int(max_lanes), int(timeout_ms),
            ctypes.byref(tb), ctypes.byref(info),
        )
        if rc == -1:
            self.stopped = True
            return None
        if rc != 1:
            return None
        return IngressTakenBatch(tb, info)

    def complete(self, tb: IngressTakenBatch, status, limit, remaining,
                 reset_time) -> None:
        """Native response fill: per-frame kind-6 encode + write.
        Consumes the handle — the batch's views die here.  A handle
        already consumed is a no-op (an error in post-complete
        bookkeeping must never double-answer or crash)."""
        if tb._ptr is None:
            return
        status = np.ascontiguousarray(status, dtype=np.int32)
        limit = np.ascontiguousarray(limit, dtype=np.int64)
        remaining = np.ascontiguousarray(remaining, dtype=np.int64)
        reset_time = np.ascontiguousarray(reset_time, dtype=np.int64)
        ptr, tb._ptr = tb._ptr, None
        self._lib.gt_ingress_complete(
            ptr, status.ctypes.data, limit.ctypes.data,
            remaining.ctypes.data, reset_time.ctypes.data,
        )

    def fail(self, tb: IngressTakenBatch, status: int, reason: str,
             content_type: str, body: bytes) -> None:
        """Error fill: every frame of the batch answers `body`.
        Consumes the handle; a handle already consumed is a no-op —
        passing a freed batch into the native fill would be a
        use-after-free, and its frames were already answered."""
        if tb._ptr is None:
            return
        ptr, tb._ptr = tb._ptr, None
        self._lib.gt_ingress_fail(
            ptr, int(status), reason.encode(), content_type.encode(),
            body, len(body),
        )

    def stop(self) -> None:
        """Wake the pump and 503 any still-queued frames."""
        self.stopped = True
        self._lib.gt_ingress_stop(self._ptr)

    def stats(self) -> dict:
        out = np.zeros(10, dtype=np.int64)
        if self._ptr:  # freed batchers read as all-zero, never crash
            self._lib.gt_ingress_stats(self._ptr, out.ctypes.data)
        return dict(zip(self.STAT_KEYS, (int(v) for v in out)))

    def free(self) -> None:
        ptr, self._ptr = self._ptr, None
        if ptr:
            self._lib.gt_ingress_free(ptr)
