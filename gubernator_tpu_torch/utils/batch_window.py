"""Shared batching-window worker (the reference's Interval-drained
queue shape, peer_client.go:272-312): the first enqueued item opens a
`wait_s` window; the batch flushes when `limit` items collect or the
window closes.  Used by the peer-forward client (PeerClient) and the
ingress-local coalescer (service.LocalBatcher) so the drain semantics
live in exactly one place.

Two extensions over the reference shape:

* `weigh` — items can count for more than one unit against `limit`
  (the columnar peer coalescer submits whole multi-lane sub-batches;
  the limit bounds LANES per flush, not submissions).

* `adaptive` — the window sizes itself to the measured arrival rate:
  effective wait = min(wait_s, limit / rate), where rate is an EMA of
  lanes/second measured across flush cycles (idle gaps included, so a
  traffic lull decays the estimate).  At high arrival rates the batch
  fills long before wait_s anyway, so shrinking the wait cuts the
  latency of the LAST window of a burst — the one that would otherwise
  sit out the full wait with a partial batch — while a trickle still
  gets the full wait_s of coalescing.  `wait_s` is the upper bound
  always.

* `cap_s` — a latency-SLO HARD CEILING on the effective wait
  (GUBER_LATENCY_TARGET_MS binding, architecture.md "Express lane"):
  when set, occupancy mode yields to latency mode — whatever wait the
  static/adaptive sizing picked is clamped to `cap_s`, so no
  submission can spend more than the configured slice of its latency
  budget coalescing.  None (the default) keeps the occupancy-driven
  window untouched.

`stop()` joins the worker FIRST and then drains + flushes anything
still queued — including items that raced past a closing check into
the queue — so no submitted item is ever silently dropped.
"""

from __future__ import annotations

import threading
import time
from queue import Empty, Queue
from typing import Callable, List, Optional


class BatchWindow:
    # EMA smoothing for the adaptive arrival-rate estimate: 0.5 tracks
    # a rate step within ~2 flush cycles without pinning to one
    # outlier window.
    RATE_EMA = 0.5

    def __init__(
        self,
        flush: Callable[[List], None],
        wait_s: float,
        limit: int,
        lazy: bool = False,
        adaptive: bool = False,
        weigh: Optional[Callable[[object], int]] = None,
        cap_s: Optional[float] = None,
    ):
        self._flush = flush
        self.wait_s = wait_s
        self.limit = limit
        self.adaptive = adaptive
        self.cap_s = cap_s
        self._weigh = weigh
        self._rate: float = 0.0  # EMA weighted-items/s (adaptive only)
        self._last_flush_t: Optional[float] = None
        self._queue: "Queue" = Queue()
        self._stopped = threading.Event()
        self._worker: "threading.Thread | None" = None
        self._worker_lock = threading.Lock()
        if not lazy:
            self._ensure_worker()

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set()

    def submit(self, item) -> None:
        """Enqueue one item.  Items enqueued before (or racing with, or
        even after) stop() are still flushed: a post-stop submit drains
        the queue itself, since no worker remains to do it."""
        self._ensure_worker()
        self._queue.put(item)
        if self._stopped.is_set():
            self._drain_flush()

    def _ensure_worker(self) -> None:
        if self._stopped.is_set():
            return
        with self._worker_lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(target=self._run, daemon=True)
                self._worker.start()

    def _weight(self, item) -> int:
        return 1 if self._weigh is None else self._weigh(item)

    def effective_wait_s(self) -> float:
        """The wait the NEXT window will use (exposed for tests/metrics)."""
        if not self.adaptive or self._rate <= 0:
            wait = self.wait_s
        else:
            wait = min(self.wait_s, self.limit / self._rate)
        if self.cap_s is not None:
            wait = min(wait, self.cap_s)
        return wait

    def _run(self) -> None:
        while not self._stopped.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except Empty:
                continue
            t_first = time.monotonic()
            batch = [first]
            count = self._weight(first)
            deadline = t_first + self.effective_wait_s()
            while count < self.limit:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except Empty:
                    break
                batch.append(item)
                count += self._weight(item)
            if self.adaptive:
                now = time.monotonic()
                # Rate over the whole inter-flush period (idle time
                # between windows included), so the estimate decays
                # when traffic pauses instead of freezing at burst
                # level.
                span = now - (self._last_flush_t
                              if self._last_flush_t is not None else t_first)
                self._last_flush_t = now
                inst = count / max(span, 1e-6)
                self._rate = (
                    inst if self._rate == 0.0
                    else (1 - self.RATE_EMA) * self._rate + self.RATE_EMA * inst
                )
            self._flush(batch)

    def stop(self, timeout_s: float = 5.0) -> None:
        """Stop the worker, then drain-and-flush every leftover item."""
        self._stopped.set()
        worker = self._worker
        if worker is not None and worker.is_alive():
            worker.join(timeout=timeout_s)
        self._drain_flush()

    def _drain_flush(self) -> None:
        leftovers = []
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except Empty:
                break
        if leftovers:
            self._flush(leftovers)
