"""The service's admission of a request (`service.admit`: the caller's
thread inside `_submit_columns`, timed by the port for every request),
in ms per thousand lanes admitted: its seconds over the lanes counted
beside it.  The span is not the window: it runs from the
`saturation.reset()` before the profiler's start to this reading, after
the profiler's stop, the drain and the service's close, so it also holds
the requests sent while the profiler starts and stops.  Nothing from a
port without the phase."""


def read(w, cell):
    from gubernator_tpu_torch import saturation

    totals = getattr(saturation, "phase_totals", lambda p: None)("service.admit")
    if not totals or not totals[2]:
        return None
    return totals[1] * 1e3 / (totals[2] / 1e3)
