"""95th percentile of the latency of every request answered in the
window, from the moment its flow sent it to the moment the answer
arrived, in ms (numpy's linear interpolation between order statistics)."""

import numpy as np


def read(w, cell):
    if not len(w.latencies_s):
        return None
    return float(np.percentile(w.latencies_s, 95) * 1e3)
