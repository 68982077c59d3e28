"""95th percentile of `request.answer` (the launch's handle handed to a
request to its callback: the drainer's wake, the readback, the commits
in order, the merge), in ms: the port's histogram of every request
(`saturation.phase_quantile`, within 1%).  The span is not the window:
it runs from the `saturation.reset()` before the profiler's start to
this reading, after the profiler's stop, the drain and the service's
close, so it also holds the requests sent while the profiler starts and
stops.  Nothing from a port without the phase."""


def read(w, cell):
    from gubernator_tpu_torch import saturation

    quantile = getattr(saturation, "phase_quantile", None)
    v = quantile("request.answer", 0.95) if quantile else None
    return None if v is None else v * 1e3
