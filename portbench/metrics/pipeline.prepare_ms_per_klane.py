"""The store pipeline's prepare stage (the C++ planner under the plan
lock) in ms per thousand lanes answered in the window."""


def read(w, cell):
    total = w.stages.get("prepare", (0, 0.0, 0.0))[1]
    return total * 1e3 / (w.lanes / 1e3) if total and w.lanes else None
