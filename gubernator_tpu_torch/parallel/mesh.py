"""Sharded bucket store on one device: key ownership = shard.

The port of the JAX package's parallel/mesh.py MeshBucketStore, columnar
path only.  Where the JAX store lays S shards over a device mesh, this
store keeps them as the leading dimension of the state tensors on one
device: hot/cold int32 [S, C, 8].  Keys map to shards by the static
shardmap `fnv1a(key) % S`; each shard plans its rounds in its own C++
slot table, and one kernel launch (ops/buckets.py bucket_rounds_dict,
or bucket_rounds_cols for the per-lane-column fallback) applies every
shard's lanes.

Not ported yet: GLOBAL lanes and their sync, the dataclass `apply`
path, the two-tier table, the Store SPI, snapshots and resharding.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import native
from ..models.shard import (
    ColumnarPipeline,
    ColumnsHandle,
    _Staged,
    make_columns,
    narrow_ok,
    pad_size,
)
from ..ops import buckets
from ..types import Behavior
from ..utils import hashing


def shard_of_key(key: str, n_shards: int) -> int:
    """Static shardmap: fnv1a-64 of the hash key, modulo shard count."""
    return hashing.hash_string_64(key) % n_shards


def resolve_device(device=None) -> torch.device:
    """The store's device: `device` when given, else the current CUDA
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


class MeshBucketStore(ColumnarPipeline):
    """Bucket tables for S shards on one device."""

    def __init__(self, capacity_per_shard: int = 50_000, n_shards: int = 8,
                 device=None):
        self.device = resolve_device(device)
        self.n_shards = n_shards
        self.capacity_per_shard = capacity_per_shard
        # Guards the state tensors: launches (and wholesale state loads)
        # serialise on it, the role of the reference's cache mutex held
        # per batch.
        self._lock = threading.RLock()
        self._init_pipeline()
        self.tables = [native.NativeSlotTable(capacity_per_shard)
                       for _ in range(n_shards)]
        self.state = buckets.init_state(n_shards, capacity_per_shard, self.device)

    def size(self) -> int:
        return sum(len(t) for t in self.tables)

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
        if (cols.behavior & int(Behavior.GLOBAL)).any():
            raise ValueError("GLOBAL lanes are not supported by the port yet")
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

        def commit(packed_np):
            if narrow:
                return mp.finish_narrow(packed_np, now_ms)
            return mp.finish_wide(packed_np)

        return _MeshPrep(
            cols=cols, now_ms=now_ms, force_wire=force_wire,
            padded=padded, n_rounds=n_rounds, narrow=narrow,
            mp=mp, pos=mp.pos[:n], commit=commit,
        )

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor; on the card through a pinned
        buffer with a non-blocking copy on the current stream."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

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

    # ------------------------------------------------------------------
    def load_state_numpy(self, hot, cold, entries) -> None:
        """Replace this store's state with another store's: `hot` and
        `cold` are [S, C, 8] arrays (for example the JAX store's
        `np.asarray(store.state.hot)`), `entries` holds each shard's
        (keys, slots, expire) key map, committed into fresh tables.
        Afterwards both stores answer the next batch identically."""
        if len(entries) != self.n_shards:
            raise ValueError(f"need {self.n_shards} shard entries, got {len(entries)}")
        state = buckets.state_from_numpy(hot, cold, self.device)
        if state.hot.shape != self.state.hot.shape:
            raise ValueError(
                f"state shape {tuple(state.hot.shape)} != {tuple(self.state.hot.shape)}"
            )
        self._drain_then_lock()
        try:
            self.tables = [native.NativeSlotTable(self.capacity_per_shard)
                           for _ in range(self.n_shards)]
            for table, (keys, slots, expire) in zip(self.tables, entries):
                n = len(keys)
                table.commit(slots, expire, np.zeros(n, np.uint8), keys)
            self.state = state
        finally:
            self._unlock_drained()
