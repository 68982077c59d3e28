"""Seconds the store pipeline spent in its prepare stage (the planner
and the wait for its plan lock, summed over the threads that prepare)
per second of the window: near or above 1, prepare sets the pace."""


def read(w, cell):
    total = w.stages.get("prepare", (0, 0.0, 0.0))[1]
    return total / w.seconds if total else None
