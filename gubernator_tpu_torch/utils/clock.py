"""Freezable millisecond clock.

The reference freezes time in tests via holster `clock.Freeze`/`Advance`
(functional_test.go:108-167 et al.).  Because our kernels take `now_ms`
as an explicit argument, freezing is just swapping the source the service
layer reads from.
"""

from __future__ import annotations

import datetime as _dt
import threading
import time


class Clock:
    """Wall clock by default; freeze()/advance() for deterministic tests."""

    def __init__(self):
        self._lock = threading.Lock()
        self._frozen_ms: "int | None" = None

    def now_ms(self) -> int:
        """Milliseconds since epoch (reference `MillisecondNow`, cache.go:133-135)."""
        with self._lock:
            if self._frozen_ms is not None:
                return self._frozen_ms
        return time.time_ns() // 1_000_000

    def now_dt(self) -> _dt.datetime:
        """Timezone-aware datetime view of now (for Gregorian math)."""
        return _dt.datetime.fromtimestamp(self.now_ms() / 1000.0, tz=_dt.timezone.utc)

    def freeze(self, at_ms: "int | None" = None) -> None:
        with self._lock:
            self._frozen_ms = at_ms if at_ms is not None else time.time_ns() // 1_000_000

    def advance(self, delta_ms: int) -> None:
        with self._lock:
            if self._frozen_ms is None:
                raise RuntimeError("advance() requires a frozen clock")
            self._frozen_ms += delta_ms

    def unfreeze(self) -> None:
        with self._lock:
            self._frozen_ms = None

    @property
    def frozen(self) -> bool:
        with self._lock:
            return self._frozen_ms is not None


# Process-default clock, shared by daemon components unless overridden.
DEFAULT_CLOCK = Clock()
