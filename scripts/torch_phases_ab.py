"""Phases 12-15 of chip_smoke.py (the edge over sockets, the daemon as a
process, the four-node cluster, the two regions) of two checkouts on
one card, in turns.

    python3 scripts/torch_phases_ab.py BASE_DIR [--order BTTB] [--logs DIR] [--out FILE]

BASE_DIR is another checkout of this repository (for example the
parent commit unpacked with `git archive`).  Each run is a process of
its own in its checkout, running that checkout's chip_smoke.py
(`device_phase`, `build_phase`, then `edge_phase`, `daemon_phase`,
`cluster_phase`, `federation_phase`), so each side builds its own
kernels and host runtime from its own sources at its first run.
`--order` names the runs in turn: B the base, T this checkout (default
BTTB).  Each run's log goes to DIR/phases_ab_<i>_<side>.log (DIR is
the current directory unless `--logs` names another).

Per run it reads the checks/s of the edge's (a) (frames through the
native pump) and (b) (JSON on the stdlib gateway), the daemon's (a)
(ColumnsV1Client) and (b) (gRPC) and its startup, the cluster's (a)
and (c), and the regions' (b) and (c), and prints one JSON object with
every number; `--out` also writes it to FILE.  Needs a CUDA card and
nvcc.
"""

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = ("import torch, gc, chip_smoke as c; smi, _ = c.device_phase(torch); c.build_phase(); "
         "c.edge_phase(torch); gc.collect(); c.daemon_phase(torch); gc.collect(); "
         "c.cluster_phase(torch, smi); gc.collect(); c.federation_phase(torch, smi)")
METRICS = {
    "edge_a": r"\[edge\] \(a\) BASELINE.*?: (\d+) checks/s",
    "edge_b": r"\[edge\] \(b\) .*?: (\d+) checks/s",
    "daemon_startup_s": r"\[daemon\] startup ([\d.]+) s",
    "daemon_a": r"\[daemon\] \(a\) .*?: (\d+) checks/s",
    "daemon_b": r"\[daemon\] \(b\) .*?: (\d+) checks/s",
    "cluster_a": r"\[cluster\].*?\(a\) BASELINE.*?: (\d+) checks/s",
    "cluster_c": r"\[cluster\].*?\(c\) 32 x .*?: (\d+) checks/s",
    "federation_b": r"\[federation\].*?\(b\) \d+ ColumnsV1Clients.*?: (\d+) checks/s",
    "federation_c": r"\[federation\].*?\(c\) config 5 storm.*?: (\d+) checks/s",
}


def run(side, cwd, log_path):
    with open(log_path, "w") as log:
        rc = subprocess.run([sys.executable, "-c", CHILD], cwd=cwd, stdout=log,
                            stderr=subprocess.STDOUT).returncode
    text = open(log_path).read()
    out = {"side": side, "rc": rc}
    for name, pat in METRICS.items():
        m = re.search(pat, text)
        out[name] = float(m.group(1)) if m else None
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("base", help="another checkout of this repository")
    p.add_argument("--order", default="BTTB", help="B = the base, T = this checkout")
    p.add_argument("--logs", default=".", help="directory for each run's log")
    p.add_argument("--out", default="", help="also write the JSON object here")
    args = p.parse_args(argv)
    if set(args.order) - {"B", "T"}:
        p.error("--order takes B and T only")
    os.makedirs(args.logs, exist_ok=True)
    runs = []
    for i, side in enumerate(args.order):
        cwd = os.path.abspath(args.base) if side == "B" else ROOT
        log_path = os.path.abspath(os.path.join(args.logs, f"phases_ab_{i}_{side}.log"))
        runs.append(run("base" if side == "B" else "this", cwd, log_path))
        print(json.dumps(runs[-1]), flush=True)
    doc = json.dumps({"runs": runs})
    print(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
