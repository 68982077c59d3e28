"""Checks answered without error in the window over its seconds: all the
work over all the time of the window.  Per layer: on a shared host the
rate spreads too widely between runs to bound (PERF.md)."""


def read(w, cell):
    return w.lanes / w.seconds if w.lanes else None
