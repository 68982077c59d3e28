"""The rate-limit rounds kernel's (K1/K2) share of its roofline, in %:
the least time the card needs for the window's bytes (roofline.py,
counted from the benchmark's own requests) over the kernel's device time
in the profiler trace.  Nothing without a trace or a launch."""

from portbench import roofline

KERNEL = "bucket_rounds"


def read(w, cell):
    if w.trace is None:
        return None
    dev_s = sum(s for name, s in w.trace["ops"].items() if KERNEL in name)
    if dev_s <= 0 or not w.lanes:
        return None
    nbytes = roofline.window_bytes(w.lanes, w.wide_lanes, w.rows)
    return roofline.bound_s(nbytes) / dev_s * 100.0
