"""The share of the traced window in which no operation ran on the
card, in %: 100 less the union of every kernel, copy and set."""


def read(w, cell):
    if w.trace is None or w.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - w.trace["busy_s"] / w.trace["window_s"])
