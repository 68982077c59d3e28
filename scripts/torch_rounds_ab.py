"""K1/K2 (gubernator_tpu_torch/csrc/bucket_rounds.cu) of two checkouts
on one card, on the same seeded batches: device time per call, warm
and with L2 flushed, in turns (base, this, this, base).

    python3 scripts/torch_rounds_ab.py BASE_DIR [--out FILE]

BASE_DIR is another checkout of this repository (for example the
parent commit unpacked with `git archive`).  Each side builds its own
kernel library from its own sources and is timed in a process of its
own by this checkout's chip_smoke.device_ms; the batches are made once,
here, with chip_smoke.py's seeded generators.  Needs a CUDA card and
nvcc.  Prints one line per side and case and, last, a JSON object with
every number; `--out` also writes it to FILE.  chip_smoke.py counts the
kernels' SASS instructions and bounds.

The cases are the main path's shapes (S = 8 shards x 262,144 slots,
32,768 lanes a shard: one round, five rounds that reuse half the slots
of the round before, K2's per-lane columns narrow and wide, half token
and half leaky key groups, all token, all leaky, and half and half with
the two-tier path's Gregorian configs) and the one-shard path's (S = 1
x 300,000 slots, 131,072 lanes: K1, K2 narrow and wide).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

NOW = cs.NOW
ITERS = 20

# The timing child: run inside one checkout (its cwd), reads the cases
# from argv[1], times them with the chip_smoke.py at argv[3], prints
# {case: [warm_ms, flushed_ms]} as JSON.
CHILD = r'''
import importlib.util, json, sys
import numpy as np
import torch
from gubernator_tpu_torch.ops import buckets

spec = importlib.util.spec_from_file_location("ab_chip_smoke", sys.argv[3])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
# the cooperative kernel, and the compute and commit kernels of the
# two-launch design
KERNELS = ("bucket_rounds_kernel", "round_compute", "round_commit")
ITERS = int(sys.argv[2])
cases = np.load(sys.argv[1])
out = {}
for name in sorted({k.split("/")[0] for k in cases.files}):
    a = {k.split("/")[1]: torch.tensor(cases[k], device="cuda") for k in cases.files
         if k.startswith(name + "/")}
    nr, wide = int(a["meta"][0]), bool(a["meta"][1])
    hot, cold = a["hot"].clone(), a["cold"].clone()
    if "wire" in a:
        def run():
            buckets.bucket_rounds_dict(hot, cold, a["wire"], nr, NOW, wide)
    else:
        def run():
            buckets.bucket_rounds_cols(hot, cold, a["lanes"], a["values"], nr, NOW, wide)
    out[name] = [cs.device_ms(torch, name, run, ITERS, cold, KERNELS) for cold in (False, True)]
print(json.dumps(out))
'''.replace("NOW", str(NOW))


def one_shard_case(seed, kind, wide, C=cs.SHARD_C, P=cs.BATCH):
    """A one-shard batch: chip_smoke's seeded state, configs and
    grouped plan with S = 1, one round."""
    from gubernator_tpu_torch.ops import buckets

    rng = np.random.default_rng(seed)
    hot, cold = cs.random_state(rng, C, wide, shards=1)
    n_cfg = 12 if kind == "dict" else 300
    cfgs = cs.random_configs(rng, n_cfg, wide)
    plan = cs.random_plan(rng, C, P, 1, shards=1)
    cfg = rng.integers(0, n_cfg, (1, P))
    cfg[0] = cfg[0][plan["grp"][0] % P]
    if kind == "dict":
        table = [np.concatenate([c, np.zeros(256 - n_cfg, np.int64)]) for c in cfgs]
        return hot, cold, (buckets.pack_dict_wire(plan["slot"], plan["ex"], plan["wr"], cfg,
                                                  plan["occ"], plan["rid"], table),), 1
    vals = [c[cfg] for c in cfgs]
    if wide:
        vals[5] = np.where(vals[6] != 0, NOW + vals[5], 0)
    lanes = np.stack([plan["slot"], plan["ex"] | (plan["wr"] << 1), vals[0], vals[1],
                      plan["occ"], plan["rid"]], axis=1).astype(np.int32)
    values = np.stack(vals[2:7], axis=1).astype(np.int64 if wide else np.int32)
    return hot, cold, (lanes, values), 1


def two_config_case(seed, gregorian, mix=(0, 1)):
    """S = 8 x 262,144 slots, 32,768 lanes a shard, one round, key
    groups taking the configs `mix` in turn (0 token, 1 leaky; limit
    1,000,000, hits 1): with `gregorian` the two-tier path's configs
    (token daily, leaky monthly Gregorian, the wide output), else an
    hour each (narrow)."""
    from gubernator_tpu_torch.models.shard import GregResolver
    from gubernator_tpu_torch.ops import buckets
    from gubernator_tpu_torch.utils import gregorian as greg

    rng = np.random.default_rng(seed)
    hot, cold = cs.random_state(rng, cs.C_FULL, gregorian)
    plan = cs.random_plan(rng, cs.C_FULL, 32_768, 1)
    table = [np.zeros(256, np.int64) for _ in range(7)]
    table[0][1] = 1  # config 1 leaky
    table[2][:2], table[3][:2] = 1, 1_000_000
    if gregorian:
        for k, d in enumerate((greg.GREGORIAN_DAYS, greg.GREGORIAN_MONTHS)):
            ge, gd = GregResolver(NOW).resolve(d)
            table[1][k], table[4][k], table[5][k], table[6][k] = 4, d, ge - NOW, gd
    else:
        table[4][:2] = 3_600_000
    cfg = np.asarray(mix)[plan["grp"] % len(mix)]
    return hot, cold, (buckets.pack_dict_wire(plan["slot"], plan["ex"], plan["wr"], cfg,
                                              plan["occ"], plan["rid"], table),), 1


def cases():
    """{name: (hot, cold, args, n_rounds, wide)}"""
    out = {"K1 S=8 token+leaky": (*two_config_case(102, False), False),
           "K1 S=8 token": (*two_config_case(102, False, (0,)), False),
           "K1 S=8 leaky": (*two_config_case(102, False, (1,)), False),
           "K1 S=8 Gregorian token+leaky": (*two_config_case(103, True), True)}
    for name, (seed, rounds, reuse, kind, wide) in {
            "K1 S=8 1 round": (100, 1, 0.0, "dict", False),
            "K1 S=8 5 rounds": (101, 5, 0.5, "dict", False),
            "K2 S=8 1 round": (100, 1, 0.0, "cols", False),
            "K2 S=8 wide 1 round": (104, 1, 0.0, "cols", True)}.items():
        *case, nr = cs.make_case(seed, cs.C_FULL, 32_768, rounds, wide, kind,
                                 12 if kind == "dict" else 300, reuse)
        out[name] = (*case, nr, wide)
    for name, (kind, wide) in {"K1 S=1": ("dict", False), "K2 S=1 narrow": ("cols", False),
                               "K2 S=1 wide": ("cols", True)}.items():
        out[name] = (*one_shard_case(7, kind, wide), wide)
    return out


def save_cases(path, cs_):
    arrays = {}
    for name, (hot, cold, args, nr, wide) in cs_.items():
        arrays[f"{name}/hot"], arrays[f"{name}/cold"] = hot, cold
        keys = ("wire",) if len(args) == 1 else ("lanes", "values")
        for k, a in zip(keys, args):
            arrays[f"{name}/{k}"] = a
        arrays[f"{name}/meta"] = np.array([nr, int(wide)], np.int64)
    np.savez(path, **arrays)


def time_side(checkout, case_file):
    r = subprocess.run([sys.executable, "-c", CHILD, case_file, str(ITERS),
                        os.path.join(ROOT, "chip_smoke.py")], cwd=checkout,
                       capture_output=True, text=True, timeout=1200)
    if r.returncode != 0:
        raise RuntimeError(f"{checkout}: timing failed:\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", help="the other checkout")
    ap.add_argument("--out", help="also write the JSON result here")
    opts = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    sides = {"base": os.path.abspath(opts.base), "this": ROOT}
    result = {"card": smi, "ms": {"base": [], "this": []}}
    with tempfile.TemporaryDirectory() as d:
        case_file = os.path.join(d, "cases.npz")
        save_cases(case_file, cases())
        for side in ("base", "this", "this", "base"):
            ms = time_side(sides[side], case_file)
            result["ms"][side].append(ms)
            for name, (warm, flushed) in sorted(ms.items()):
                print(f"[ab] {side} {name}: device {warm} ms warm, {flushed} ms L2 flushed",
                      flush=True)
    line = json.dumps(result)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
