"""Live lanes over the lane slots the store pipeline shipped in the
window (`wire.lanes` over `wire.slots` of `take_pipeline_stats`: each
launched batch's shards x padded lanes), in %: how little of the wire
and the result is padding.  Nothing from a port without the counter."""


def read(w, cell):
    lanes, slots = w.stages.get("wire.lanes"), w.stages.get("wire.slots")
    return 100.0 * lanes[1] / slots[1] if lanes and slots and slots[1] else None
