"""Lanes answered in the window over the flushes the store prepared in
it (`take_pipeline_stats`' prepare count): how much the coalescing
window merges."""


def read(w, cell):
    count = w.stages.get("prepare", (0, 0.0, 0.0))[0]
    return w.lanes / count if count and w.lanes else None
