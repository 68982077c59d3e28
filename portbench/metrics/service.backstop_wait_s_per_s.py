"""Seconds the flush thread waited on its oldest launch
(`queue.backstop`, once MAX_INFLIGHT launches are unresolved) per second
of the window: the port's mean wait a flush chunk times the chunks the
store prepared in the window (`take_pipeline_stats`' prepare count),
over the window's seconds.  The mean's span is not the window: it runs
from the `saturation.reset()` before the profiler's start to this
reading, after the profiler's stop, the drain and the service's close.
Nothing from a port without the phase."""


def read(w, cell):
    from gubernator_tpu_torch import saturation

    totals = getattr(saturation, "phase_totals", lambda p: None)("queue.backstop")
    chunks = w.stages.get("prepare", (0, 0.0, 0.0))[0]
    if not totals or not chunks:
        return None
    return totals[1] / totals[0] * chunks / w.seconds
