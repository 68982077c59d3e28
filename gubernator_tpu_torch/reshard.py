"""Elastic membership: live resharding with columnar state handoff.

A ring change used to be metadata-only (`V1Service.set_peers` rebuilt
the pickers, mirroring gubernator.go:357-437) — every device-resident
counter whose ownership moved was silently orphaned, so a scale-out
event was a cluster-wide rate-limit reset.  This module makes
membership changes *stateful*:

  * On a ring delta, the old owner DRAINS the moved keys off the
    device (one mesh-wide gather program per drain batch — the snapshot
    readback in reverse, `MeshBucketStore.drain_keys`) and
    ships them to each new owner as a TransferColumns batch (GUBC
    frame kind 4 / proto `TransferColumnsReq`, wire.py).  The gather
    does not remove the keys: the local copy is forgotten only after
    the transfer is ACKED (`forget_keys`), so it stays readable — the
    double-dispatch peek target — for the whole in-flight window.
  * The new owner commits the batch through the batched replica-commit
    playbook (`MeshBucketStore.commit_transfer`: one gather + one
    scatter, O(1) device programs per batch) with MONOTONE merge
    semantics, so duplicate delivery and concurrent traffic can never
    double-count a hit.
  * Epoch fencing: every transfer frame is stamped with the
    destination ring's fingerprint (`ring_fingerprint`, an
    order-independent FNV-1 fold of the membership).  A receiver whose
    ring has since changed again rejects the batch (FailedPrecondition
    — "a late transfer from a dead epoch"), and the sender aborts
    instead of committing state under the wrong ring.
  * During the handoff window reads DOUBLE-DISPATCH: the routing
    daemon serves the hit from the key's NEW owner and issues a
    zero-hit peek at the OLD owner, merging monotonically (see
    V1Service._merge_handoff) so no request observes a reset bucket
    while the transfer is in flight.

Merge semantics (the documented monotone rule, architecture.md
"Membership & resharding"): for a live resident row of the same
algorithm, remaining = min, status = max (OVER_LIMIT wins), stamp /
reset / expire = max; an expired or algorithm-switched resident row is
overwritten by the incoming row wholesale.  min/max are idempotent and
order-free, which is what makes transfer retries and the
double-dispatch window safe.

Documented slack (the exactly-once contract the chaos oracle pins,
tests/test_reshard_chaos.py): hits admitted by the NEW owner against a
fresh bucket *during* the handoff window are not reflected in the
transferred row (and vice versa: hits the old owner admits between the
drain gather and the transfer ACK never reach the new owner), so a key
may over-admit by at most min(hits-before-drain, hits-during-window).
If a transfer ABORTS (frames dropped past the retry budget, epoch
fenced, unsupported peer), the local copy was never removed — reads
still peek it for the rest of the window — but the new owner starts
the key fresh, so the key over-admits by at most the old owner's
consumption: exactly the behavior of a membership change without a handoff, now bounded to the
failure case and counted
(gubernator_reshard_transfers{result="aborted"} + a `reshard-aborted`
flight-recorder event).  An old owner that DIES mid-transfer loses its
unshipped consumption the same way.  Hits are never double-counted in
any path: the commit merge is idempotent (min/max), a timeout-shaped
send failure leaves both copies but only the current ring's owner
takes hits, and the peek leg is zero-hit by construction.

The PyTorch port's copy of the JAX package's reshard.py.  Its device
programs are the stores' row gather (K7: `drain_keys`,
`snapshot_columns`) and row scatter (K8: `commit_transfer`); the
transfer batch, the merge and the fingerprint are the JAX bytes
(tests/test_torch_reshard.py, tests/test_torch_cluster.py).
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import audit
from . import tracing
from .utils import hashing

log = logging.getLogger("gubernator.reshard")

# Lane cap per transfer RPC: ride the columnar peer-hop bound (a
# transfer is the same wire weight class as a coalesced forward).
TRANSFER_MAX_LANES = 16384


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
    """The sender side of the state-migration plane, plus the bounded
    membership maintenance pool.

    One small pool serves both membership duties set_peers used to do
    inline or on unbounded daemon threads: shutting down dropped peers'
    clients (tracked, so close() can't race a half-shutdown client) and
    running the drain -> transfer handoff for a ring delta.  Handoffs
    are generation-checked: a newer set_peers supersedes an in-flight
    handoff between batches."""

    POOL_WORKERS = 4

    def __init__(self, service):
        self.service = service
        self._pool = ThreadPoolExecutor(
            max_workers=self.POOL_WORKERS, thread_name_prefix="reshard"
        )
        self._lock = threading.Lock()
        self._tasks: List[Future] = []
        self._closed = False
        # Host-side counters (exported as gubernator_reshard_* via the
        # per-scrape observe pass and served raw in /debug/status).
        self.transfers_started = 0
        self.transfers_committed = 0
        self.transfers_aborted = 0
        self.transfers_fenced_in = 0  # receive-side epoch rejections
        self.lanes_moved = 0
        self.lanes_received = 0
        self.lanes_rejected = 0  # receive-side not-owned-here lanes
        self.last_handoff_seconds = 0.0

    # -- bounded submission -------------------------------------------
    def _submit(self, fn, *args) -> Optional[Future]:
        with self._lock:
            if self._closed:
                return None
            try:
                fut = self._pool.submit(fn, *args)
            except RuntimeError:  # pool shut down under us
                return None
            self._tasks.append(fut)
            # Completed futures retire lazily; the list stays bounded
            # by churn rate, not daemon lifetime.
            if len(self._tasks) > 64:
                self._tasks = [t for t in self._tasks if not t.done()]
            return fut

    def submit_shutdown(self, client) -> None:
        """Shut a dropped peer's client down off the caller's thread —
        through the bounded pool, TRACKED, so `close()` drains them
        instead of racing a half-shutdown client (gubernator.go:398-428
        drains dropped peers in the background too, but bounded)."""
        if self._submit(self._safe_shutdown, client) is None:
            # Closing/closed: shut down inline — the client must not
            # leak its window thread just because we are.
            self._safe_shutdown(client)

    @staticmethod
    def _safe_shutdown(client) -> None:
        try:
            client.shutdown()
        except Exception as e:  # noqa: BLE001 — best-effort teardown
            log.debug("dropped-peer shutdown failed: %s", e)

    # -- handoff ------------------------------------------------------
    def schedule_handoff(self, picker, ring_hash: int, generation: int) -> None:
        """Queue the drain -> transfer pass for a ring delta (called by
        V1Service.set_peers AFTER the new picker is installed, outside
        the peer mutex)."""
        self._submit(self._run_handoff, picker, ring_hash, generation)

    def _current_generation(self) -> int:
        return self.service.ring_generation

    def _run_handoff(self, picker, ring_hash: int, generation: int) -> None:
        svc = self.service
        store = svc.store
        t0 = time.monotonic()
        did_work = False
        try:
            if self._current_generation() != generation or self._closed:
                # Superseded before we even started (membership churn
                # queues handoffs faster than they run): the newest
                # handoff owns whatever still resides here — stale ones
                # must cost one integer compare, not a table scan.
                return
            # Warmup keys ("__warmup__*") are synthetic compile fodder,
            # resident on EVERY daemon by construction — shipping them
            # would be pure churn (and under a frozen test clock they
            # never expire out of the live filter).
            keys = [
                k for k in store.resident_keys()
                if not k.startswith("__warmup__")
            ]
            if not keys:
                return
            codes, code_ids = picker.get_batch_codes(keys)
            moved: Dict[str, List[str]] = {}
            for c, pid in enumerate(code_ids):
                peer = picker.get_by_peer_id(pid)
                if peer is None or peer.info.is_owner:
                    continue  # stays local (or churned away mid-pass)
                sel = np.nonzero(codes == c)[0]
                if sel.size:
                    moved[pid] = [keys[int(i)] for i in sel]
            if not moved:
                return
            did_work = True
            n_total = sum(len(v) for v in moved.values())
            log.info(
                "reshard gen=%d: %d resident keys moved to %d new owner(s)",
                generation, n_total, len(moved),
            )
            for pid, mkeys in moved.items():
                for lo in range(0, len(mkeys), TRANSFER_MAX_LANES):
                    if self._current_generation() != generation or self._closed:
                        # A newer ring superseded this handoff: stop
                        # between batches — nothing drained yet for this
                        # chunk, so nothing is lost; the newer handoff
                        # re-routes what still resides here.
                        return
                    self._transfer_chunk(
                        picker, pid, mkeys[lo:lo + TRANSFER_MAX_LANES],
                        ring_hash,
                    )
        except Exception as e:  # noqa: BLE001 — a handoff failure must
            # never take the serving path down; it degrades to the
            # no-handoff reset behavior for the affected keys, counted.
            log.warning("reshard handoff gen=%d failed: %s", generation, e)
            self._abort(None, 0, f"handoff-error: {e}")
        finally:
            if did_work:
                # Superseded/no-op passes cost an integer compare and
                # would rewrite the gauge to ~0, hiding the wall time
                # of the last REAL drain->transfer pass.
                self.last_handoff_seconds = time.monotonic() - t0

    def _transfer_chunk(self, picker, pid: str, keys: List[str],
                        ring_hash: int) -> None:
        """Gather -> send -> forget-on-ack.  The gather does NOT remove
        the keys: the old owner's copy stays readable (the
        double-dispatch peek target) for the whole in-flight window,
        and only a successful ACK forgets it — so an aborted transfer
        loses nothing locally, and a timeout-shaped failure (the RPC
        may have applied server-side) leaves both copies, which the
        monotone merge + current-ring routing keep from ever
        double-counting."""
        svc = self.service
        cols = svc.store.drain_keys(keys, svc.clock.now_ms(), remove=False)
        if len(cols) == 0:
            return
        cols.ring_hash = ring_hash
        self.transfers_started += 1
        self._count("started")
        # Conservation ledger (audit.py): acked lanes must never exceed
        # drained lanes (reshard_out) — counted at the two distinct
        # points of the gather -> send -> forget-on-ack protocol.
        audit.note("reshard_drained_lanes", len(cols))
        peer = picker.get_by_peer_id(pid)
        if peer is None:
            self._abort(cols, len(cols), f"peer {pid} gone from ring")
            return
        ok, err = svc._peer_send_ex(  # noqa: SLF001 — shared retry envelope
            "TransferOwnership",
            lambda: self._send_one(peer, cols),
        )
        if ok:
            svc.store.forget_keys(cols.keys)
            self.transfers_committed += 1
            self.lanes_moved += len(cols)
            self._count("committed")
            audit.note("reshard_acked_lanes", len(cols))
            if self.service.metrics is not None:
                self.service.metrics.reshard_lanes.labels(
                    direction="out"
                ).inc(len(cols))
        else:
            self._abort(cols, len(cols), str(err))

    def _send_one(self, peer, cols: TransferColumns) -> None:
        """One transfer send; raises on transport failure.  A peer that
        negotiated down to classic (no transfer surface) or fenced the
        epoch raises a terminal ValueError so the retry envelope stops
        — both are deterministic answers, not transient faults."""
        status = peer.transfer_ownership(cols)
        if status == "unsupported":
            raise ValueError(
                f"peer {peer.info.grpc_address} does not speak the "
                "transfer plane (classic fallback: moved keys reset "
                "there, pre-reshard semantics)"
            )
        if status == "fenced":
            raise ValueError(
                f"peer {peer.info.grpc_address} fenced the transfer "
                "(its ring changed again; dead-epoch batch)"
            )

    def _abort(self, cols: Optional[TransferColumns], lanes: int,
               reason: str) -> None:
        """Abort leg: the local copy was never removed (gather-only
        drain), so nothing is reinstalled — the keys stay readable at
        the old owner for the rest of the double-dispatch window, after
        which they behave as a change without a handoff does (fresh buckets at the
        new owner) — bounded to this failure case and counted."""
        self.transfers_aborted += 1
        self._count("aborted")
        # Flight-recorder event + automatic dump (tracing.py): an
        # aborted transfer is exactly the state-loss moment the
        # recorder exists to preserve — same rate-limited path as
        # breaker-open.
        tracing.record_event("reshard-aborted", lanes=lanes, reason=reason)
        log.warning("reshard transfer aborted (%d lanes): %s", lanes, reason)

    def _count(self, result: str) -> None:
        m = self.service.metrics
        if m is not None:
            m.reshard_transfers.labels(result=result).inc()

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
        self._pool.shutdown(wait=False)
