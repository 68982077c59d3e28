"""Card time per million checks, in ms: the union of every kernel, copy
and set on the card in the window (the profiler's trace) over the
checks answered without error in it.  What each check costs the card."""


def read(w, cell):
    if w.trace is None or w.trace["busy_s"] <= 0 or not w.lanes:
        return None
    return w.trace["busy_s"] * 1e3 / (w.lanes / 1e6)
