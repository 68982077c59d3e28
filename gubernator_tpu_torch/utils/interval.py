"""Re-armable interval timer (reference `Interval`, interval.go:27-70).

`next()` arms the timer; `on_tick` fires once ~duration later.  Calls to
`next()` while armed coalesce (the reference's 1-buffered channel with
non-blocking send).  Paces the host-tier GLOBAL and multi-region
pipelines; the peer-client batch window is inlined in its queue loop.
"""

from __future__ import annotations

import threading
from typing import Callable


class Interval:
    def __init__(self, duration_s: float, on_tick: Callable[[], None]):
        self.duration_s = duration_s
        self._on_tick = on_tick
        self._armed = threading.Event()
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stopped.is_set():
            if not self._armed.wait(timeout=0.05):
                continue
            self._armed.clear()
            if self._stopped.wait(timeout=self.duration_s):
                return
            try:
                self._on_tick()
            except Exception:  # noqa: BLE001 — timer thread must survive
                pass

    def next(self) -> None:
        """Arm the next tick; ignored if one is already pending
        (interval.go:63-70)."""
        self._armed.set()

    def stop(self) -> None:
        self._stopped.set()
        self._thread.join(timeout=1.0)
