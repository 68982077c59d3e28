"""Columnar state handoff: the transfer batch, its monotone merge, the
ring fingerprint and the receive side of the resharding manager.

The part of the JAX package's reshard.py that one node needs:
`TransferColumns`, one batch of full bucket rows in column form (what
`MeshBucketStore.snapshot_columns` gathers and `commit_transfer`
commits, the row payload of a snapshot file and of a transfer frame);
`merge_transfer_rows`, the monotone merge a commit applies against the
rows already resident; `ring_fingerprint`, the epoch a transfer is
fenced on; and `ReshardManager`'s receive-side bookkeeping
(`V1Service.transfer_ownership`).  The sending half (the drain ->
transfer handoff a ring change schedules) comes with the peer client.

Merge semantics (architecture.md "Membership & resharding"): for a live
resident row of the same algorithm, the side with the lower remaining
keeps its (remaining, stamp) pair, status and expire merge max; an
expired or algorithm-switched resident row is overwritten by the
incoming row wholesale.  min/max are idempotent and order-free, so a
re-delivered batch or a late snapshot restore cannot double-count a
hit.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from . import audit
from .utils import hashing


def ring_fingerprint(peer_ids: Sequence[str], replicas: int = 512) -> int:
    """Order-independent 64-bit identity of a ring MEMBERSHIP — the
    shared epoch stamp for transfer fencing.  Computed identically on
    every daemon from the peer-id strings (gRPC addresses) alone, so no
    coordination is needed for two daemons to agree on "the same ring".
    XOR-fold of per-peer FNV-1 hashes (order-free), mixed with the
    vnode count (a replicas change moves ownership without changing
    membership, so it must change the epoch too)."""
    h = hashing.fnv1_64(f"replicas={replicas}".encode("utf-8"))
    for pid in peer_ids:
        h ^= hashing.fnv1_64(pid.encode("utf-8"))
    return h & 0xFFFFFFFFFFFFFFFF


@dataclass
class TransferColumns:
    """One ownership-transfer batch in column form: lane i of every
    column is one moved key's FULL device bucket row (the BucketRows
    shape, ops/buckets.py) — enough state for the new owner to continue
    the bucket exactly where the old owner left it."""

    keys: List[str]
    algorithm: np.ndarray  # i32[n]
    status: np.ndarray  # i32[n]
    limit: np.ndarray  # i64[n]
    remaining: np.ndarray  # i64[n]
    duration: np.ndarray  # i64[n]
    stamp: np.ndarray  # i64[n]  (token created_at / leaky updated_at)
    expire_at: np.ndarray  # i64[n]
    # Destination-epoch fence: ring_fingerprint of the ring this batch
    # was routed under.  0 = unfenced (accepted anywhere; tests only).
    ring_hash: int = 0

    def __len__(self) -> int:
        return len(self.keys)

    @classmethod
    def empty(cls, ring_hash: int = 0) -> "TransferColumns":
        return cls(
            keys=[],
            algorithm=np.zeros(0, np.int32),
            status=np.zeros(0, np.int32),
            limit=np.zeros(0, np.int64),
            remaining=np.zeros(0, np.int64),
            duration=np.zeros(0, np.int64),
            stamp=np.zeros(0, np.int64),
            expire_at=np.zeros(0, np.int64),
            ring_hash=ring_hash,
        )

    def subset(self, idx) -> "TransferColumns":
        """Lane subset (receiver-side ownership filtering / sender-side
        chunking)."""
        idx = np.asarray(idx, dtype=np.int64)
        return TransferColumns(
            keys=[self.keys[int(i)] for i in idx],
            algorithm=self.algorithm[idx],
            status=self.status[idx],
            limit=self.limit[idx],
            remaining=self.remaining[idx],
            duration=self.duration[idx],
            stamp=self.stamp[idx],
            expire_at=self.expire_at[idx],
            ring_hash=self.ring_hash,
        )

    def slice(self, lo: int, hi: int) -> "TransferColumns":
        return TransferColumns(
            keys=self.keys[lo:hi],
            algorithm=self.algorithm[lo:hi],
            status=self.status[lo:hi],
            limit=self.limit[lo:hi],
            remaining=self.remaining[lo:hi],
            duration=self.duration[lo:hi],
            stamp=self.stamp[lo:hi],
            expire_at=self.expire_at[lo:hi],
            ring_hash=self.ring_hash,
        )


def merge_transfer_rows(cur, incoming: TransferColumns, idx, now_ms: int,
                        exists: np.ndarray):
    """Monotone merge of incoming transferred rows against the
    receiver's CURRENT device rows (both as parallel arrays; `cur` is a
    dict of gathered columns aligned with `idx` lanes of `incoming`).

    live = the receiver already holds an unexpired row of the same
    algorithm for the key (it admitted traffic during the handoff
    window).  For live lanes the SIDE with the lower `remaining` wins
    and contributes BOTH its remaining and its stamp — the pair moves
    together, because a field-wise min(remaining)/max(stamp) mix would
    fabricate a state that never existed (a stale low remaining paired
    with a fresh stamp denies a leaky bucket all leak credit accrued
    since the stale drain).  status/expire merge max.  Equal remaining
    keeps the current side, so duplicate delivery (transfer retries)
    is a no-op and interleavings converge.  Dead/absent lanes take the
    incoming row wholesale.  Returns the merged column dict to
    scatter."""
    inc_algo = incoming.algorithm[idx]
    live = (
        exists
        & (cur["expire_at"] >= now_ms)
        & (cur["algo"] == inc_algo)
    )
    # Which side supplies the (remaining, stamp) pair: the incoming row
    # when the lane is dead/absent, or when it is STRICTLY more
    # consumed than the resident one.
    take_inc = np.logical_not(live) | (
        incoming.remaining[idx] < cur["remaining"]
    )
    out = {
        "algo": inc_algo.astype(np.int32),
        "limit": incoming.limit[idx].astype(np.int64),
        "duration": incoming.duration[idx].astype(np.int64),
        "remaining": np.where(
            take_inc, incoming.remaining[idx], cur["remaining"]
        ).astype(np.int64),
        "stamp": np.where(
            take_inc, incoming.stamp[idx], cur["stamp"]
        ).astype(np.int64),
        "status": np.where(
            live,
            np.maximum(cur["status"], incoming.status[idx]),
            incoming.status[idx],
        ).astype(np.int32),
        "expire_at": np.where(
            live,
            np.maximum(cur["expire_at"], incoming.expire_at[idx]),
            incoming.expire_at[idx],
        ).astype(np.int64),
    }
    return out


class ReshardManager:
    """The receive side of the state-migration plane: counters of the
    transfers this node accepted or fenced, served in /debug/status.
    The JAX manager also runs the sender's drain -> transfer handoff and
    dropped peers' shutdowns on a bounded pool; the port has no peers
    yet, so nothing is ever submitted and `wait_idle` finds no task."""

    def __init__(self, service):
        self.service = service
        self._lock = threading.Lock()
        self._tasks: List[Future] = []
        self._closed = False
        self.transfers_started = 0
        self.transfers_committed = 0
        self.transfers_aborted = 0
        self.transfers_fenced_in = 0  # receive-side epoch rejections
        self.lanes_moved = 0
        self.lanes_received = 0
        self.lanes_rejected = 0  # receive-side not-owned-here lanes
        self.last_handoff_seconds = 0.0

    # -- receive-side bookkeeping (V1Service.transfer_ownership) -------
    def note_received(self, committed: int, rejected: int) -> None:
        self.lanes_received += committed
        self.lanes_rejected += rejected
        audit.note("reshard_committed_lanes", committed)
        audit.note("reshard_rejected_lanes", rejected)
        m = self.service.metrics
        if m is not None:
            if committed:
                m.reshard_lanes.labels(direction="in").inc(committed)
            if rejected:
                m.reshard_lanes.labels(direction="rejected").inc(rejected)

    def note_fenced(self, lanes: int) -> None:
        self.transfers_fenced_in += 1
        m = self.service.metrics
        if m is not None:
            m.reshard_transfers.labels(result="fenced").inc()

    def snapshot(self) -> dict:
        """The /debug/status "reshard" section."""
        return {
            "transfersStarted": self.transfers_started,
            "transfersCommitted": self.transfers_committed,
            "transfersAborted": self.transfers_aborted,
            "transfersFencedIn": self.transfers_fenced_in,
            "lanesMoved": self.lanes_moved,
            "lanesReceived": self.lanes_received,
            "lanesRejected": self.lanes_rejected,
            "lastHandoffSeconds": round(self.last_handoff_seconds, 4),
        }

    def wait_idle(self, timeout_s: float = 10.0) -> bool:
        """Block until every tracked task finished (tests + close())."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            tasks = list(self._tasks)
        for t in tasks:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            try:
                t.result(timeout=remaining)
            except Exception:  # noqa: BLE001 — task errors logged at site
                pass
        return True

    def close(self, timeout_s: float = 10.0) -> None:
        with self._lock:
            self._closed = True
        self.wait_idle(timeout_s)
