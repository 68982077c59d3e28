"""The control of the correctness check: the plain reference put in the
program's place and computed in 32-bit integers, one width below the
int64 the configuration states.  Its answers and final state go through
the same comparison as a run's (`bench.compare_answers`, `bench.Check`),
and it must come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --requests-per-flow 160

The lanes are those of a run of the cell at its own size: the set-up
fill, then `--requests-per-flow` requests of each flow, each at its
epoch's instant (a run answers about that many).  Prints one JSON line
per seed with the numbers compared, each beside its limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import bench, reference, traffic as traffic_mod  # noqa: E402


def control_check(mix: dict, seed: int, requests_per_flow: int) -> "bench.Check":
    """The check of a run in which each flow was answered
    `requests_per_flow` requests after the fill, with the int32
    reference's answers and state in the program's place."""
    traffic = traffic_mod.build(mix, seed)
    reqs = [(-1, i) for i in range(len(traffic.fill))]
    reqs += [(c, i) for c in range(traffic.flows) for i in range(requests_per_flow)]
    hits = traffic_mod.reference_hits(traffic, reqs)
    want = reference.evaluate(hits)
    low = reference.evaluate(hits, dtype=np.int32)
    got = {f: getattr(low, f) for f in bench.ANSWER_FIELDS}
    name = traffic.params["name"]
    state = {f"{name}_{i}": [low.state[f][i] for f in reference.STATE_FIELDS[1:]]
             for i in np.nonzero(low.state["exists"])[0].tolist()}
    bad = np.zeros(len(hits.key), bool)
    return bench.Check(bench.compare_answers(traffic, hits, got, bad, state, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests-per-flow", type=int, required=True)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench_json = json.load(f)
    cell = next(w for w in bench_json["workloads"] if w["name"] == args.workload)
    mix = traffic_mod.load(ROOT, cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        check = control_check(mix, seed, args.requests_per_flow)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": check.correct,
                          "check": {k: {"value": v, "limit": lim}
                                    for k, (v, lim) in check.numbers.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
