"""Seconds the C++ mesh planner waited for a shard's table lock while
planning (`prepare.table_lock_wait` of `take_pipeline_stats`: a finish
of an older batch held it) per second of the window.  Nothing from a
port without the counter."""


def read(w, cell):
    st = w.stages.get("prepare.table_lock_wait")
    return st[1] / w.seconds if st and st[0] else None
