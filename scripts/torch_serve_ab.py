"""Phase 11 of chip_smoke.py (the serving tier at the service: BASELINE
config 2 from 32 callers, 16 requests of 1,000 leaky lanes each, half
async, then NO_BATCHING, async, GLOBAL and traced legs, every answer
held to a CPU replay) of two checkouts on one card, in turns.

    python3 scripts/torch_serve_ab.py BASE_DIR [--runs 3] [--out FILE]

BASE_DIR is another checkout of this repository (for example the
parent commit unpacked with `git archive`).  Each run is a process of
its own in its checkout, running that checkout's chip_smoke.py
(`device_phase`, then `serve_phase`), so each side builds its own
kernels and host runtime from its own sources at its first run.  Three
sides: the base, this checkout, and this checkout with the sampling
profiler and its scopes off (`GUBER_PROFILE=0`).  Round r runs base,
this, this-unprofiled for even r and the reverse for odd r.

Per run it reads leg (a)'s checks/s, request latency p50 and max and
the pipeline's prepare total from the `[serve] (a)` lines.  Last, it
times this checkout's per-request tenant ledger folds (`fold_admit` and
`fold_outcome` on one 1,000-lane request, on the host) and prints one
JSON object with every number; `--out` also writes it to FILE.  Needs
a CUDA card and nvcc.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHILD = ("import torch, chip_smoke as c; c.device_phase(torch); c.serve_phase(torch)")
RE_A = re.compile(r"\[serve\] \(a\) BASELINE.*?: (\d+) checks/s, request latency p50 "
                  r"([\d.]+) ms, max ([\d.]+) ms")
RE_PREP = re.compile(r"\[serve\] \(a\) stage prepare: (\d+) x, total ([\d.]+) ms")


def run_side(cwd, profile, timeout_s):
    env = dict(os.environ)
    if not profile:
        env["GUBER_PROFILE"] = "0"
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", CHILD], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=timeout_s)
    wall = time.perf_counter() - t0
    out = p.stdout + p.stderr
    if p.returncode != 0:
        raise SystemExit(f"phase 11 in {cwd} exited {p.returncode}:\n{out[-4000:]}")
    a, prep = RE_A.search(out), RE_PREP.search(out)
    if a is None or prep is None:
        raise SystemExit(f"no [serve] (a) lines in {cwd}'s output:\n{out[-4000:]}")
    return {"checks_per_s": int(a.group(1)), "p50_ms": float(a.group(2)),
            "max_ms": float(a.group(3)), "prepare_n": int(prep.group(1)),
            "prepare_total_ms": float(prep.group(2)), "process_s": round(wall, 3)}


def fold_timing(reps=200):
    """Host time of one 1,000-lane request's tenant folds (ms)."""
    from gubernator_tpu_torch.profiling import TenantLedger
    from gubernator_tpu_torch.service import ColumnarResult, IngressColumns

    rng = np.random.RandomState(11)
    n = 1_000
    cols = IngressColumns(["serve2"] * n, [str(k) for k in rng.randint(0, 1_000_000, n)],
                          np.ones(n, np.int32), np.zeros(n, np.int32), np.ones(n, np.int64),
                          np.full(n, 1_000_000, np.int64), np.full(n, 3_600_000, np.int64))
    result = ColumnarResult.empty(n)
    led = TenantLedger()
    led.fold_outcome(led.fold_admit(cols), result)  # builds the host runtime
    times = {"fold_admit": [], "fold_outcome": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        ctx = led.fold_admit(cols)
        t1 = time.perf_counter()
        led.fold_outcome(ctx, result)
        t2 = time.perf_counter()
        times["fold_admit"].append((t1 - t0) * 1e3)
        times["fold_outcome"].append((t2 - t1) * 1e3)
    return {k: {"p50_ms": float(np.percentile(v, 50)), "mean_ms": float(np.mean(v))}
            for k, v in times.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base_dir")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    sides = [("base", os.path.abspath(args.base_dir), True), ("this", ROOT, True),
             ("this_unprofiled", ROOT, False)]
    runs = {name: [] for name, _, _ in sides}
    for r in range(args.runs):
        for name, cwd, profile in (sides if r % 2 == 0 else sides[::-1]):
            row = run_side(cwd, profile, args.timeout)
            runs[name].append(row)
            print(f"[serve-ab] round {r} {name}: {json.dumps(row)}", flush=True)
    summary = {name: {"checks_per_s": [x["checks_per_s"] for x in rows],
                      "median_checks_per_s": float(np.median([x["checks_per_s"] for x in rows]))}
               for name, rows in runs.items()}
    folds = fold_timing()
    print(f"[serve-ab] per-request tenant folds (host, 1,000 lanes): {json.dumps(folds)}")
    doc = {"device": smi, "runs": runs, "summary": summary, "folds": folds}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
