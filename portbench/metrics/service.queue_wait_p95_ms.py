"""95th percentile of the service's `queue.wait` reservoir (a flush's
start to its launch submission, saturation.py) over the window, in ms."""

import numpy as np


def read(w, cell):
    if not w.queue_wait_s:
        return None
    return float(np.percentile(np.asarray(w.queue_wait_s), 95) * 1e3)
