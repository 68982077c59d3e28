"""Device telemetry: kernel builds and first launches, rebuild-storm
detection, per-program launch timings, device memory sampling.

The port of the JAX package's telemetry.py.  The JAX module counts XLA
backend compiles through a `jax.monitoring` listener; the port's device
programs are hand-written CUDA kernels built once per source digest,
so its "compiles" are the events that cost the same kind of time:

* **Builds** — `utils/build.py` reports every library build it runs
  (the nvcc kernel library, the g++ host runtime) with its wall time,
  labelled `build:<name>`.  A library already built for these sources
  is loaded, not built, and reports nothing.

* **First launches** — `ops/_kernels.py` reports the first launch of
  each kernel in the process (module load and the occupancy query ride
  it), labelled `first-launch:<kernel>`, counted without a duration.

After `mark_steady()` any further build or first launch counts as a
steady-state recompile per label, and a burst of them
(`GUBER_XLA_STORM` inside `GUBER_XLA_STORM_WINDOW` seconds) records a
`recompile-storm` flight-recorder event, as in the JAX module.

* **Launch timings** — `program(label)` times the launch call at the
  pipeline's launch site (host wall of the enqueue, not device
  completion), aggregated per label and drained per scrape.

`device_snapshot(device)` samples the CUDA caching allocator of the
store's device (`torch.cuda.memory_allocated`, `memory_reserved`,
`max_memory_allocated`, and `mem_get_info`'s free and total bytes) —
the JAX module's `memory_stats()` / `live_arrays()` sample.  A CPU
store gives no device row, as a JAX CPU host reports no device memory.
Sampling happens per debug request only, never on the hot path.

State is MODULE-GLOBAL like the tracing flight recorder and the
saturation plane.  `GUBER_XLA_TELEMETRY=0` disables everything:
`program()` returns a shared no-op context and the notes return at once.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List

from . import profiling, tracing
from .utils.logging import category_logger

logger = category_logger("telemetry")

_UNLABELED = "unlabeled"


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name, "")
    if not v:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    try:
        return int(v) if v else default
    except ValueError:
        return default


def _env_duration(name: str, default_s: float) -> float:
    """Go-duration env knob (the GUBER_* convention: '60s', '2m'; a
    bare number means ms), warn-free fallback on garbage — module
    import must never raise."""
    v = os.environ.get(name, "")
    if not v:
        return default_s
    try:
        from .config import parse_duration

        return parse_duration(v)
    except Exception:  # noqa: BLE001 — import-time safety
        return default_s


_ENABLED: bool = _env_flag("GUBER_XLA_TELEMETRY", True)
# Rebuild-storm trip: >= STORM_THRESHOLD steady-state builds or first
# launches within STORM_WINDOW_S seconds fires the flight-recorder dump.
STORM_THRESHOLD = max(_env_int("GUBER_XLA_STORM", 3), 1)
STORM_WINDOW_S = max(_env_duration("GUBER_XLA_STORM_WINDOW", 60.0), 0.001)
_STORM_MIN_INTERVAL_S = 30.0  # between storm events (dump rate limit)

_lock = threading.Lock()
_tls = threading.local()

# label -> [count, total_s, max_s] (cumulative, process lifetime)
_compiles: Dict[str, list] = {}
# label -> count of compiles AFTER mark_steady() (shape churn)
_steady_recompiles: Dict[str, int] = {}
# label -> [count, total_s, max_s] execution (enqueue) wall; drained
# per metrics scrape (the dispatch-stage gauge convention)
_exec_stats: Dict[str, list] = {}
# label -> count of programs created: builds (`build:<name>`) and
# first launches (`first-launch:<kernel>`), the port's counterpart of
# the JAX program caches' creations
_programs_created: Dict[str, int] = {}
_steady = False
_recent_steady_compiles: "deque[float]" = deque()
_storms = 0
_last_storm = [-float("inf")]


def set_enabled(flag: bool) -> None:
    """Process-wide switch (the daemon applies its parsed
    GUBER_XLA_TELEMETRY at startup, like tracing.set_sample_rate)."""
    global _ENABLED
    _ENABLED = bool(flag)


def set_storm(threshold: int, window_s: float) -> None:
    """Process-wide storm-trip parameters (the daemon applies its
    parsed GUBER_XLA_STORM / GUBER_XLA_STORM_WINDOW at startup — the
    config-file -> env -> default precedence every other knob honors;
    the module-level env read only covers library embeddings)."""
    global STORM_THRESHOLD, STORM_WINDOW_S
    STORM_THRESHOLD = max(int(threshold), 1)
    STORM_WINDOW_S = max(float(window_s), 0.001)


def enabled() -> bool:
    return _ENABLED


def note_program_created(label: str) -> None:
    """One device program came into being: a library build
    (`utils/build.py`) or a kernel's first launch (`ops/_kernels.py`),
    counted so the program population is visible beside the compile
    counters."""
    if not _ENABLED:
        return
    with _lock:
        _programs_created[label] = _programs_created.get(label, 0) + 1


def note_compile(label: str, dur_s: float) -> None:
    """One build or first launch (`utils/build.py`, `ops/_kernels.py`):
    counted and timed per label; after mark_steady() it is a
    steady-state recompile and feeds the storm trip."""
    if not _ENABLED:
        return
    now = time.monotonic()
    storm = None
    with _lock:
        st = _compiles.setdefault(label, [0, 0.0, 0.0])
        st[0] += 1
        st[1] += dur_s
        st[2] = max(st[2], dur_s)
        if _steady:
            _steady_recompiles[label] = _steady_recompiles.get(label, 0) + 1
            _recent_steady_compiles.append(now)
            while (_recent_steady_compiles
                   and now - _recent_steady_compiles[0] > STORM_WINDOW_S):
                _recent_steady_compiles.popleft()
            if (len(_recent_steady_compiles) >= STORM_THRESHOLD
                    and now - _last_storm[0] >= _STORM_MIN_INTERVAL_S):
                _last_storm[0] = now
                globals()["_storms"] = _storms + 1
                storm = len(_recent_steady_compiles)
    if storm is not None:
        # Outside the telemetry lock: the dump serializes and logs.
        tracing.record_event(
            "recompile-storm", compiles=storm, window_s=STORM_WINDOW_S,
            label=label,
        )
        logger.warning(
            "recompile storm: %d steady-state builds or first launches in "
            "%.0fs (last label %s)", storm, STORM_WINDOW_S, label,
        )


_launched: set = set()


def note_launch(kernel: str) -> None:
    """A kernel launched; its first launch in the process counts as a
    compile event labelled `first-launch:<kernel>`."""
    if kernel in _launched or not _ENABLED:
        return
    with _lock:
        if kernel in _launched:
            return
        _launched.add(kernel)
    label = f"first-launch:{kernel}"
    note_program_created(label)
    note_compile(label, 0.0)


# ---------------------------------------------------------------------
# Program label scopes (the launch-site hook)
# ---------------------------------------------------------------------
class _NoopProgram:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopProgram()


class _Program:
    __slots__ = ("label", "_prev", "_t0")

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        self._prev = getattr(_tls, "program", None)
        _tls.program = self.label
        if profiling.enabled():
            # Mirror the label into the cost-profiler's cross-thread
            # registry (thread-locals are invisible to the sampler):
            # samples taken during this launch carry program identity.
            profiling.set_program(self.label)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        _tls.program = self._prev
        # Unconditional (unlike the enter-side mirror): if the profiler
        # was toggled off mid-launch, a conditional restore would park
        # this label in the cross-thread registry forever and every
        # later sample of this thread would carry it.
        profiling.set_program(self._prev)
        with _lock:
            st = _exec_stats.setdefault(self.label, [0, 0.0, 0.0])
            st[0] += 1
            st[1] += dt
            st[2] = max(st[2], dt)
        return False


def program(label: str):
    """Label scope for one launch: aggregates the call's wall time
    (host enqueue, not device completion) under `label` and tags the
    profiler's samples of the thread.  The disabled path is one branch
    returning a shared no-op."""
    if not _ENABLED:
        return _NOOP
    return _Program(label)


# ---------------------------------------------------------------------
# Warmup fencing
# ---------------------------------------------------------------------
def begin_warmup() -> None:
    """Re-open the warmup window (daemon startup; each daemon start in
    one process re-opens it)."""
    global _steady
    with _lock:
        _steady = False


def mark_steady() -> None:
    """Warmup complete: from here on every backend compile counts as a
    steady-state recompile (shape churn)."""
    global _steady
    with _lock:
        _steady = True
        _recent_steady_compiles.clear()


def is_steady() -> bool:
    return _steady


# ---------------------------------------------------------------------
# Read side
# ---------------------------------------------------------------------
def compile_count() -> int:
    with _lock:
        return sum(st[0] for st in _compiles.values())


def steady_recompile_count() -> int:
    with _lock:
        return sum(_steady_recompiles.values())


def compile_snapshot() -> Dict[str, dict]:
    with _lock:
        return {
            label: {
                "count": st[0],
                "total_s": round(st[1], 6),
                "max_s": round(st[2], 6),
                "steady_recompiles": _steady_recompiles.get(label, 0),
            }
            for label, st in sorted(_compiles.items())
        }


def take_exec_stats() -> Dict[str, tuple]:
    """Drain per-program execution aggregates accumulated since the
    last call: {label: (count, total_s, max_s)}."""
    with _lock:
        out = {k: tuple(v) for k, v in _exec_stats.items()}
        _exec_stats.clear()
    return out


def snapshot() -> dict:
    """The GET /debug/device document (minus live device stats, which
    device_snapshot() adds — they cost a live-buffer walk)."""
    with _lock:
        exec_view = {
            label: {
                "count": st[0],
                "total_s": round(st[1], 6),
                "max_s": round(st[2], 6),
            }
            for label, st in sorted(_exec_stats.items())
        }
        storms = _storms
        created = dict(sorted(_programs_created.items()))
    return {
        "enabled": _ENABLED,
        "steady": _steady,
        "compiles": compile_snapshot(),
        "compileTotal": compile_count(),
        "steadyRecompiles": steady_recompile_count(),
        "recompileStorms": storms,
        "stormThreshold": STORM_THRESHOLD,
        "stormWindowS": STORM_WINDOW_S,
        "programRuns": exec_view,
        # Builds and first launches (note_program_created); the port's
        # fused launch groups reuse K1 and create no program.
        "programsCreated": created,
    }


def device_snapshot(device=None) -> List[dict]:
    """Memory of the CUDA device `device` (the store's), read from the
    caching allocator and `mem_get_info`: [] when the plane is off, the
    device is not a CUDA device, or no card is present."""
    if not _ENABLED or device is None:
        return []
    try:
        import torch

        dev = torch.device(device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return []
        free, total = torch.cuda.mem_get_info(dev)
        return [{
            "device": str(dev),
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(dev),
            "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
            "bytes_reserved": int(torch.cuda.memory_reserved(dev)),
            "bytes_free": int(free),
            "bytes_limit": int(total),
        }]
    except Exception as e:  # noqa: BLE001 — diagnostics must never raise
        logger.warning("device snapshot failed: %s", e)
        return []


def reset(steady: bool = False) -> None:
    """Test hook: clear every aggregate (mirrors tracing.reset)."""
    global _steady, _storms
    with _lock:
        _compiles.clear()
        _steady_recompiles.clear()
        _exec_stats.clear()
        _recent_steady_compiles.clear()
        _programs_created.clear()
        _steady = steady
        _storms = 0
        _last_storm[0] = -float("inf")
        _launched.clear()
    _tls.program = None
