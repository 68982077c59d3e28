"""Seconds from process start to the window's first timed request: the
kernels built or loaded, the service and its store, the warm-up
launches, the key-table fill and the lead requests."""


def read(w, cell):
    return w.setup_s
