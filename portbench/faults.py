"""Faults planted under the timed path, for the check that the
comparison catches them: each wraps the rate-limit rounds kernels
(`gubernator_tpu_torch.ops.buckets.bucket_rounds_dict` / `_cols`, the
entry K1 and K2 are launched through) so a run drives the service as
usual while the kernel answers wrong.

    python3 portbench/faults.py --workload <cell> --seeds 1,2,3 --seconds 10

runs the cell on the card once for each fault and seed, at the cell's own
size, and prints one JSON line per run with the numbers compared, each
beside its limit.  (No cell spans chips, so there is no exchange between
chips to leave out.)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _state_unchanged(orig, kind):
    def run(hot, cold, *args, **kw):
        h0, c0 = hot.clone(), cold.clone()
        out = orig(hot, cold, *args, **kw)
        hot.copy_(h0)
        cold.copy_(c0)
        return out
    return run


def _half_left_out(orig, kind):
    def run(hot, cold, first, *args, **kw):
        from gubernator_tpu_torch.ops import buckets

        first = first.clone()
        if kind == "dict":
            p = (first.shape[1] - buckets.DICT_WIRE_TABLE_WORDS) // 3
            first[:, :p // 2] = -1  # half of every shard's lanes: no slot
        else:
            first[:, 0, :first.shape[2] // 2] = -1
        return orig(hot, cold, first, *args, **kw)
    return run


def _answer_altered(orig, kind):
    def run(hot, cold, *args, **kw):
        out = orig(hot, cold, *args, **kw)
        out[0, 1] += 1  # shard 0's remaining, where the kernel writes it
        return out
    return run


FAULTS = {
    "state_unchanged": _state_unchanged,
    "half_left_out": _half_left_out,
    "answer_altered": _answer_altered,
}


@contextlib.contextmanager
def planted(fault: str):
    """The rounds kernels broken by `fault` for the duration."""
    from gubernator_tpu_torch.ops import buckets

    saved = {}
    for kind in ("dict", "cols"):
        name = f"bucket_rounds_{kind}"
        saved[name] = getattr(buckets, name)
        setattr(buckets, name, FAULTS[fault](saved[name], kind))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(buckets, name, fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", default=",".join(FAULTS))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("faults.py: no CUDA device", file=sys.stderr)
        return 2
    from portbench import bench, run

    cell, _, config, mix, _ = run.load_cell(args.workload)
    for fault in args.faults.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            with planted(fault):
                w, check, _ = bench.run_cell(cell, config, mix, seed, args.seconds, False,
                                             device=None, t_start=time.perf_counter(),
                                             log=lambda *a: None)
            print(json.dumps({"workload": args.workload, "fault": fault, "seed": seed,
                              "requests": w.requests, "correct": check.correct,
                              "check": {k: {"value": v, "limit": lim}
                                        for k, (v, lim) in check.numbers.items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
