"""Seconds spent acquiring the store's plan lock (`prepare.plan_lock_wait`
of `take_pipeline_stats`, inside prepare) per second of the window,
summed over the threads that prepare.  Nothing from a port without the
stage."""


def read(w, cell):
    st = w.stages.get("prepare.plan_lock_wait")
    return st[1] / w.seconds if st and st[0] else None
