"""Kernel launches of the port (`ops/_kernels.LAUNCHES`, every kernel) in
the window per thousand lanes answered."""


def read(w, cell):
    n = sum(w.launches.values())
    return n / (w.lanes / 1e3) if n and w.lanes else None
