"""The C++ mesh planner's own time (`prepare.planner` of
`take_pipeline_stats`: inside gt_mesh_begin and gt_mesh_plan_grouped,
its table-lock waits left out) in ms per thousand lanes answered in the
window; the rest of `pipeline.prepare_ms_per_klane` is the plan-lock
wait, the table-lock waits and prepare's Python.  Nothing from a port
without the counter."""


def read(w, cell):
    st = w.stages.get("prepare.planner")
    return st[1] * 1e3 / (w.lanes / 1e3) if st and st[0] and w.lanes else None
