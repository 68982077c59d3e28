"""Durability plane: crash-safe columnar snapshots of the bucket state.

The port of the JAX package's snapshot.py.  The file format is that
package's byte for byte, so a snapshot written by a JAX daemon restores
into the port and one written by the port restores into a JAX daemon:

  * DUMP — `store.snapshot_columns` resolves every resident key's slot
    on the host and gathers the full bucket rows with one row-gather
    kernel (ops/buckets.py gather_rows), producing a
    `reshard.TransferColumns` batch, which is encoded into the
    versioned, CRC-checked format below.  The gather runs with the
    store's pipeline drained and its locks held; the encode and the
    file I/O run outside every store lock.
  * CRASH SAFETY — a snapshot is written to a same-directory temp
    file, fsync'd, and renamed over the previous one (then the
    directory is fsync'd): a reader sees the old complete file or the
    new complete file, never a torn one.
  * RESTORE — at boot, `store.commit_transfer` replays the file: one
    row gather of the current rows, the monotone merge
    (reshard.merge_transfer_rows), one row scatter.  The merge never
    un-spends a hit admitted after the snapshot was taken.
  * RING FENCING — the header carries a membership fingerprint.  The
    port's service has no ring yet and writes 0 (unfenced); a fenced
    file is still decoded, and `read_snapshot(expected_ring=...)`
    rejects one whose fingerprint differs.

Corrupt, truncated, bit-flipped or wrong-version files are rejected
loudly at boot (logged, `restore_result == "rejected"`) and the daemon
starts cold — never a partial or garbage restore.

File format v1 (little-endian; frozen, changing any byte requires a
version bump):

  offset  size  field
  0       4     magic "GUBS"
  4       1     version (1)
  5       1     reserved (0)
  6       4     u32 n (lanes)
  10      8     i64 saved_at_ms (daemon clock at the gather)
  18      8     u64 ring_hash (membership fingerprint; 0 = unfenced)
  26      4     u32 key_bytes (total packed key bytes)
  30      4*n   u32[n] key END offsets into the key blob
  ..      kb    key blob (utf-8, concatenated)
  ..      4*n   i32[n] algorithm
  ..      4*n   i32[n] status
  ..      8*n   i64[n] limit
  ..      8*n   i64[n] remaining
  ..      8*n   i64[n] duration
  ..      8*n   i64[n] stamp
  ..      8*n   i64[n] expire_at
  tail    4     u32 crc32 (zlib) of every preceding byte
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time
import zlib
from typing import Optional, Tuple

import numpy as np

from . import tracing
from .reshard import TransferColumns

logger = logging.getLogger(__name__)

SNAPSHOT_MAGIC = b"GUBS"
SNAPSHOT_VERSION = 1
_HEADER = struct.Struct("<4sBBIqQI")  # magic ver rsvd n saved_at ring kb
_CRC = struct.Struct("<I")


class SnapshotError(ValueError):
    """A snapshot file that must not be restored (corrupt, truncated,
    wrong version, checksum mismatch, or — under strict fencing — a
    wrong ring fingerprint)."""


def encode_snapshot(cols: TransferColumns, saved_at_ms: int,
                    ring_hash: int = 0) -> bytes:
    """TransferColumns -> the on-disk byte layout (checksum included)."""
    n = len(cols)
    key_bytes = [k.encode("utf-8") for k in cols.keys]
    offsets = np.cumsum(
        np.fromiter((len(b) for b in key_bytes), np.uint32, count=n),
        dtype=np.uint32,
    ) if n else np.zeros(0, np.uint32)
    blob = b"".join(key_bytes)
    parts = [
        _HEADER.pack(
            SNAPSHOT_MAGIC, SNAPSHOT_VERSION, 0, n,
            int(saved_at_ms), int(ring_hash) & 0xFFFFFFFFFFFFFFFF,
            len(blob),
        ),
        offsets.tobytes(),
        blob,
        np.ascontiguousarray(cols.algorithm, np.int32).tobytes(),
        np.ascontiguousarray(cols.status, np.int32).tobytes(),
        np.ascontiguousarray(cols.limit, np.int64).tobytes(),
        np.ascontiguousarray(cols.remaining, np.int64).tobytes(),
        np.ascontiguousarray(cols.duration, np.int64).tobytes(),
        np.ascontiguousarray(cols.stamp, np.int64).tobytes(),
        np.ascontiguousarray(cols.expire_at, np.int64).tobytes(),
    ]
    body = b"".join(parts)
    return body + _CRC.pack(zlib.crc32(body) & 0xFFFFFFFF)


def decode_snapshot(raw: bytes,
                    expected_ring: Optional[int] = None
                    ) -> Tuple[TransferColumns, dict]:
    """Bytes -> (TransferColumns, meta).  Raises SnapshotError on any
    defect; `expected_ring` (strict fencing) additionally rejects a
    FENCED file (nonzero ring_hash) whose membership fingerprint does
    not match — an unfenced file (ring_hash 0) is accepted anywhere,
    the TransferColumns convention."""
    if len(raw) < _HEADER.size + _CRC.size:
        raise SnapshotError(f"truncated snapshot ({len(raw)} bytes)")
    magic, version, _rsvd, n, saved_at, ring_hash, kb = _HEADER.unpack_from(
        raw, 0
    )
    if magic != SNAPSHOT_MAGIC:
        raise SnapshotError(f"bad magic {magic!r}")
    if version != SNAPSHOT_VERSION:
        raise SnapshotError(f"unsupported snapshot version {version}")
    total = _HEADER.size + 4 * n + kb + (4 + 4 + 8 * 5) * n + _CRC.size
    if len(raw) != total:
        raise SnapshotError(
            f"truncated snapshot ({len(raw)} bytes, expected {total})"
        )
    (crc,) = _CRC.unpack_from(raw, total - _CRC.size)
    if zlib.crc32(raw[: total - _CRC.size]) & 0xFFFFFFFF != crc:
        raise SnapshotError("checksum mismatch (bit rot or torn write)")
    if (expected_ring is not None and ring_hash != 0
            and ring_hash != (int(expected_ring) & 0xFFFFFFFFFFFFFFFF)):
        raise SnapshotError(
            f"ring fingerprint mismatch (file {ring_hash:016x}, "
            f"expected {int(expected_ring) & 0xFFFFFFFFFFFFFFFF:016x})"
        )
    pos = _HEADER.size
    offsets = np.frombuffer(raw, np.uint32, count=n, offset=pos)
    pos += 4 * n
    blob = raw[pos: pos + kb]
    if n and int(offsets[-1]) != kb:
        raise SnapshotError("key blob length mismatch")
    pos += kb

    def arr(dtype, width):
        nonlocal pos
        a = np.frombuffer(raw, dtype, count=n, offset=pos)
        pos += width * n
        return a

    algorithm = arr(np.int32, 4)
    status = arr(np.int32, 4)
    limit = arr(np.int64, 8)
    remaining = arr(np.int64, 8)
    duration = arr(np.int64, 8)
    stamp = arr(np.int64, 8)
    expire_at = arr(np.int64, 8)
    keys = []
    lo = 0
    try:
        for hi in offsets:
            keys.append(blob[lo:hi].decode("utf-8"))
            lo = int(hi)
    except UnicodeDecodeError as e:
        raise SnapshotError(f"invalid utf-8 in key blob: {e}") from None
    cols = TransferColumns(
        keys=keys,
        algorithm=algorithm.copy(),
        status=status.copy(),
        limit=limit.copy(),
        remaining=remaining.copy(),
        duration=duration.copy(),
        stamp=stamp.copy(),
        expire_at=expire_at.copy(),
        ring_hash=int(ring_hash),
    )
    meta = {
        "version": version,
        "lanes": n,
        "saved_at_ms": int(saved_at),
        "ring_hash": int(ring_hash),
        "bytes": total,
    }
    return cols, meta


def write_snapshot(path: str, cols: TransferColumns, saved_at_ms: int,
                   ring_hash: int = 0) -> int:
    """Crash-safe write: encode, write to a same-directory temp file,
    fsync, atomic rename over `path`, fsync the directory.  A reader
    (or a restart after `kill -9` at ANY instant of this sequence) sees
    either the previous complete snapshot or the new complete snapshot
    — never a torn file.  Returns the byte size written."""
    raw = encode_snapshot(cols, saved_at_ms, ring_hash)
    d = os.path.dirname(os.path.abspath(path)) or "."
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:
        dirfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
    except OSError:  # pragma: no cover — exotic fs without dir fsync
        pass
    return len(raw)


def read_snapshot(path: str, expected_ring: Optional[int] = None
                  ) -> Tuple[TransferColumns, dict]:
    """Load + verify one snapshot file (see decode_snapshot)."""
    with open(path, "rb") as f:
        raw = f.read()
    return decode_snapshot(raw, expected_ring=expected_ring)


# ---------------------------------------------------------------------
# Loader-SPI bridge: the reference's CacheItem stream over the columnar
# path, so persistence backends written against store.go work unchanged
# while the device work stays one gather and one scatter per batch.
# ---------------------------------------------------------------------
def columns_to_items(cols: TransferColumns):
    """TransferColumns -> List[store.CacheItem] (Loader.save feed)."""
    from .models.shard import _rows_to_items
    from .ops import buckets

    rows = buckets.BucketRows(
        algo=cols.algorithm, limit=cols.limit, remaining=cols.remaining,
        duration=cols.duration, stamp=cols.stamp, expire_at=cols.expire_at,
        status=cols.status,
    )
    return _rows_to_items(cols.keys, rows)


def items_to_columns(items) -> TransferColumns:
    """Iterable[store.CacheItem] -> TransferColumns (Loader.load feed:
    the whole stream commits through store.commit_transfer: one row
    gather and one row scatter instead of one scatter per item)."""
    from .ops.buckets import LEAKY_SCALE
    from .store import LeakyBucketItem
    from .types import Algorithm

    items = list(items)
    n = len(items)
    cols = TransferColumns.empty()
    if n == 0:
        return cols
    keys, algo, status, limit, remaining, duration, stamp, expire = (
        [], np.empty(n, np.int32), np.zeros(n, np.int32),
        np.empty(n, np.int64), np.empty(n, np.int64),
        np.empty(n, np.int64), np.empty(n, np.int64), np.empty(n, np.int64),
    )
    for i, item in enumerate(items):
        v = item.value
        keys.append(item.key)
        expire[i] = int(item.expire_at)
        if isinstance(v, LeakyBucketItem):
            algo[i] = int(Algorithm.LEAKY_BUCKET)
            remaining[i] = int(v.remaining * LEAKY_SCALE)
            stamp[i] = int(v.updated_at)
        else:
            algo[i] = int(item.algorithm)
            remaining[i] = int(v.remaining)
            stamp[i] = int(v.created_at)
            status[i] = int(v.status)
        limit[i] = int(v.limit)
        duration[i] = int(v.duration)
    return TransferColumns(
        keys=keys, algorithm=algo, status=status, limit=limit,
        remaining=remaining, duration=duration, stamp=stamp,
        expire_at=expire,
    )


class SnapshotManager:
    """Dump/restore orchestration for one V1Service: restore at boot,
    save on close() and every `interval_s` seconds.  Disabled entirely
    (every method an early return) when no path is configured."""

    def __init__(self, service, path: str = "", interval_s: float = 0.0):
        self.service = service
        self.path = path or ""
        self.interval_s = max(float(interval_s or 0.0), 0.0)
        # A custom store without the columnar gather/commit pair cannot
        # ride this plane; its persistence is the Loader.
        self.enabled = bool(self.path) and hasattr(
            service.store, "snapshot_columns"
        ) and hasattr(service.store, "commit_transfer")
        # Host-side counters.
        self.saves_ok = 0
        self.saves_failed = 0
        self.restored_lanes = 0
        self.saved_lanes = 0
        self.restore_result = "disabled" if not self.enabled else "pending"
        self.last_save_unix = 0.0
        self.last_save_bytes = 0
        self.last_save_seconds = 0.0
        self.last_restore_seconds = 0.0
        # Ring fingerprint the restored file was saved under (None =
        # nothing restored, or unfenced).
        self.restored_ring_hash: Optional[int] = None
        self._save_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _sweep_orphan_temps(self) -> None:
        """Remove stale `.{name}.tmp.{pid}` siblings a crash mid-write
        left behind (each process writes a pid-suffixed temp and only
        unlinks its own on a caught exception, so `kill -9` orphans
        it).  Boot-time only: this daemon owns the path, so any temp
        here is dead."""
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        prefix = f".{os.path.basename(self.path)}.tmp."
        try:
            names = os.listdir(d)
        except OSError:
            return
        for name in names:
            if name.startswith(prefix):
                try:
                    os.unlink(os.path.join(d, name))
                    logger.info("removed orphaned snapshot temp %s", name)
                except OSError:  # pragma: no cover — raced/forbidden
                    pass

    # -- restore (boot) ------------------------------------------------
    def restore(self) -> int:
        """Load + verify + one merge-commit (`store.commit_transfer`).
        Any defect is a loud cold start, never a partial restore.
        Returns the lanes committed."""
        if not self.enabled:
            return 0
        self._sweep_orphan_temps()
        if not os.path.exists(self.path):
            self.restore_result = "absent"
            return 0
        t0 = time.perf_counter()
        try:
            cols, meta = read_snapshot(self.path)
        except (SnapshotError, OSError) as e:
            self.restore_result = "rejected"
            tracing.record_event(
                "snapshot-rejected", path=self.path, reason=str(e)
            )
            logger.warning(
                "snapshot %s REJECTED (cold start): %s", self.path, e
            )
            return 0
        now_ms = self.service.clock.now_ms()
        committed = self.service.store.commit_transfer(cols, now_ms)
        if committed > len(cols):
            # A commit that mints lanes breaks snapshot conservation.
            tracing.record_event(
                "audit-violation", invariant="snapshot_restore",
                excess=committed - len(cols),
            )
            logger.warning(
                "snapshot restore VIOLATION: committed %d lanes from a "
                "%d-lane file", committed, len(cols),
            )
        self.last_restore_seconds = time.perf_counter() - t0
        self.restored_lanes = committed
        self.restore_result = "ok"
        self.restored_ring_hash = meta["ring_hash"] or None
        logger.info(
            "restored %d/%d snapshot lanes from %s "
            "(saved_at_ms=%d ring=%016x, %.1fms)",
            committed, meta["lanes"], self.path, meta["saved_at_ms"],
            meta["ring_hash"], self.last_restore_seconds * 1e3,
        )
        return committed

    # -- save (interval / close) ---------------------------------------
    def save_now(self, reason: str = "interval") -> bool:
        """One dump: the gather (one kernel launch, under the store's
        drain-then-lock envelope), then encode + crash-safe write outside
        every store lock.  Serialized against concurrent saves; returns
        success."""
        if not self.enabled:
            return False
        with self._save_lock:
            t0 = time.perf_counter()
            try:
                now_ms = self.service.clock.now_ms()
                cols = self.service.store.snapshot_columns(now_ms)
                # No ring yet: every file is unfenced (ring_hash 0).
                size = write_snapshot(self.path, cols, now_ms, ring_hash=0)
            except Exception as e:  # noqa: BLE001 — a failed dump must
                # never take the serving path (or shutdown) down.
                self.saves_failed += 1
                logger.warning(
                    "snapshot save (%s) to %s failed: %s",
                    reason, self.path, e,
                )
                return False
            self.last_save_seconds = time.perf_counter() - t0
            self.last_save_unix = time.time()
            self.last_save_bytes = size
            self.saves_ok += 1
            self.saved_lanes += len(cols)
            logger.debug(
                "snapshot save (%s): %d lanes, %d bytes, %.1fms",
                reason, len(cols), size, self.last_save_seconds * 1e3,
            )
            return True

    def start(self) -> None:
        """Start the background cadence (no-op when disabled or
        interval 0 = shutdown-only snapshots)."""
        if not self.enabled or self.interval_s <= 0 or self._thread:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="snapshot-writer"
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.save_now("interval")
            except Exception:  # noqa: BLE001 — the writer must never die
                logger.exception("snapshot interval save failed")

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
            self._thread = None

    def snapshot(self) -> dict:
        """The counters, as the JAX daemon's /debug/status "snapshot"
        section shows them."""
        return {
            "enabled": self.enabled,
            "path": self.path,
            "intervalS": self.interval_s,
            "savesOk": self.saves_ok,
            "savesFailed": self.saves_failed,
            "savedLanes": self.saved_lanes,
            "restore": self.restore_result,
            "restoredLanes": self.restored_lanes,
            "lastSaveUnix": self.last_save_unix,
            "lastSaveBytes": self.last_save_bytes,
            "lastSaveSeconds": round(self.last_save_seconds, 4),
            "lastRestoreSeconds": round(self.last_restore_seconds, 4),
        }
