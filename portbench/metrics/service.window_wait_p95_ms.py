"""95th percentile of `batch.window` (a request's submit to its flush,
timed by the port for every request), in ms: the port's histogram of
every observation (`saturation.phase_quantile`, within 1%).  The span is
not the window: it runs from the `saturation.reset()` before the
profiler's start to this reading, after the profiler's stop, the drain
and the service's close, so it also holds the requests sent while the
profiler starts and stops.  Nothing from a port without the histogram."""


def read(w, cell):
    from gubernator_tpu_torch import saturation

    quantile = getattr(saturation, "phase_quantile", None)
    v = quantile("batch.window", 0.95) if quantile else None
    return None if v is None else v * 1e3
