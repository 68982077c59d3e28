"""Bytes the store pipeline copied between host and card in the window
per live lane: the wires uploaded (`wire.up_bytes`) plus the results
read back (`wire.down_bytes`, a fused group's once) over the live lanes
of the batches launched (`wire.lanes`), all of `take_pipeline_stats`.
Nothing from a port without the counter."""


def read(w, cell):
    lanes = w.stages.get("wire.lanes")
    up, down = w.stages.get("wire.up_bytes"), w.stages.get("wire.down_bytes")
    return (up[1] + down[1]) / lanes[1] if lanes and up and down and lanes[1] else None
