"""K1/K2 (gubernator_tpu_torch/csrc/bucket_rounds.cu), K3 and K6
(csrc/global_ops.cu), K9 (csrc/moves.cu) and K10 (csrc/compact.cu) of
two checkouts on one card, on the same seeded inputs: device time per
call, warm and with L2 flushed, in turns (base, this, this, base).

    python3 scripts/torch_rounds_ab.py BASE_DIR [--out FILE] [--only K6,K10]

BASE_DIR is another checkout of this repository (for example the
parent commit unpacked with `git archive`).  Each side builds its own
kernel library from its own sources and is timed in a process of its
own by this checkout's chip_smoke.device_profile and queued_ms: per
call the summed time of the kernels, the span from its first kernel's
start to its last one's end, the number of kernels, and the time a call
takes on the card when calls are queued back to back; the inputs are
made once, here,
with chip_smoke.py's seeded generators.  Needs a CUDA card and nvcc.
Prints one line per side and case and, last, a JSON object with every
number; `--out` also writes it to FILE.  chip_smoke.py counts the
kernels' SASS instructions and bounds.

The cases are the main path's shapes (S = 8 shards x 262,144 slots,
32,768 lanes a shard: one round, five rounds that reuse half the slots
of the round before, K2's per-lane columns narrow and wide, half token
and half leaky key groups, all token, all leaky, and half and half with
the two-tier path's Gregorian configs), the one-shard path's (S = 1 x
300,000 slots, 131,072 lanes: K1, K2 narrow and wide), the GLOBAL
path's (K3 on S = 8 x 65,536 slots and gslots, 2,048 lanes a shard, in
1 and 5 rounds, with every shard's lanes live or, as the path's skewed
batches, one shard's and the rest padding) and the two-tier path's (K9
on a seeded window of ~226,000 records over 8 x 32,768 front and 217,232 back
slots), K6 on clear lists of the GLOBAL path's table (65,536 gslots x
8 shards: 1,024 and 2,048 sorted entries, as the stores hand them over,
and 1,024 in any order) and K10 on the one-shard headline's batch (a
Zipf plan of the C++ planner, every write lane listed, dict wire and
per-lane columns); and the paths' own inputs, made by running
chip_smoke.py's GLOBAL and two-tier phases here: K3 on the GLOBAL path's
step-by-step batch and K9 on the two-tier path's largest window.
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
# {case: [[warm ms, span ms, kernels a call], [the same L2 flushed],
# queued ms]} as JSON.
CHILD = r'''
import importlib.util, json, sys
import numpy as np
import torch
from gubernator_tpu_torch.ops import _kernels, buckets, global_ops

spec = importlib.util.spec_from_file_location("ab_chip_smoke", sys.argv[3])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
# the cooperative kernels, and the kernels of the two-launch designs
KERNELS = ("bucket_rounds_kernel", "round_compute", "round_commit", "answer_compute",
           "answer_commit", "moves_kernel", "moves_gather_kernel", "moves_scatter_kernel",
           "compact_compute", "compact_commit", "clear_kernel")
ITERS = int(sys.argv[2])
cases = np.load(sys.argv[1])
out = {}
for name in sorted({k.split("/")[0] for k in cases.files}):
    a = {k.split("/")[1]: torch.tensor(cases[k], device="cuda") for k in cases.files
         if k.startswith(name + "/")}
    kind, nr, wide, now = (int(x) for x in a["meta"])
    t = {k: v.clone() for k, v in a.items()}
    if kind == 0:
        def run():
            buckets.bucket_rounds_dict(t["hot"], t["cold"], a["wire"], nr, now, bool(wide))
    elif kind == 1:
        def run():
            buckets.bucket_rounds_cols(t["hot"], t["cold"], a["lanes"], a["values"], nr, now,
                                       bool(wide))
    elif kind == 2:
        g = global_ops.GlobalColumns(*[t[f"g{i}"] for i in range(6)])
        def run():
            global_ops.answer_rounds(t["hot"], t["cold"], g, a["lanes"], a["values"],
                                     a["gslot"], nr, now)
    elif kind == 3:
        def run():
            _kernels.apply_moves(t["hot"], t["cold"], t["back_hot"], t["back_cold"],
                                 a["records"])
    elif kind == 4:
        def run():
            if "wire" in a:
                buckets.compact_dict(t["hot"], t["cold"], a["wire"], a["wlane"], now)
            else:
                buckets.compact_cols(t["hot"], t["cold"], a["lanes"], a["values"], a["wlane"],
                                     now)
    else:
        g = global_ops.GlobalColumns(*[t[f"g{i}"] for i in range(6)])
        def run():
            _kernels.clear_gslots(g, a["idx"])
    out[name] = [cs.device_profile(torch, run, ITERS, cold, KERNELS) for cold in (False, True)]
    out[name].append(cs.queued_ms(torch, run, ITERS))
print(json.dumps(out))
'''

DICT, COLS, ANSWER, MOVES, COMPACT, CLEAR = range(6)


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


def answer_case(seed, n_rounds, one_shard):
    """chip_smoke.global_case's answer batch at the GLOBAL path's shape;
    with `one_shard` only shard 0's lanes are live and the rest are the
    host's padding (slot -1, round 0, gslot -1), as on the path's skewed
    batches."""
    hot, cold, gc, (lanes, values, gslot, nr) = cs.global_case(
        "answer", seed, cs.C_GLOBAL, cs.G_FULL, cs.GLOBAL_BATCH, n_rounds)
    if one_shard:
        lanes[1:], values[1:], gslot[1:] = 0, 0, -1
        lanes[1:, 0] = -1
    arrays = dict(hot=hot, cold=cold, lanes=lanes, values=values, gslot=gslot)
    arrays.update({f"g{i}": c for i, c in enumerate(gc)})
    return arrays, (ANSWER, nr, 1, NOW)


def cases():
    """{name: (arrays, (kind, n_rounds, wide, now))}"""
    def rounds(hot, cold, args, nr, wide):
        keys = ("wire",) if len(args) == 1 else ("lanes", "values")
        return (dict(hot=hot, cold=cold, **dict(zip(keys, args))),
                (DICT if len(args) == 1 else COLS, nr, int(wide), NOW))

    out = {"K1 S=8 token+leaky": rounds(*two_config_case(102, False), False),
           "K1 S=8 token": rounds(*two_config_case(102, False, (0,)), False),
           "K1 S=8 leaky": rounds(*two_config_case(102, False, (1,)), False),
           "K1 S=8 Gregorian token+leaky": rounds(*two_config_case(103, True), True)}
    for name, (seed, n, reuse, kind, wide) in {
            "K1 S=8 1 round": (100, 1, 0.0, "dict", False),
            "K1 S=8 5 rounds": (101, 5, 0.5, "dict", False),
            "K2 S=8 1 round": (100, 1, 0.0, "cols", False),
            "K2 S=8 wide 1 round": (104, 1, 0.0, "cols", True)}.items():
        out[name] = rounds(*cs.make_case(seed, cs.C_FULL, 32_768, n, wide, kind,
                                         12 if kind == "dict" else 300, reuse), wide)
    for name, (kind, wide) in {"K1 S=1": ("dict", False), "K2 S=1 narrow": ("cols", False),
                               "K2 S=1 wide": ("cols", True)}.items():
        out[name] = rounds(*one_shard_case(7, kind, wide), wide)
    for name, (seed, n, one) in {"K3 1 round, one shard live": (110, 1, True),
                                 "K3 5 rounds, one shard live": (111, 5, True),
                                 "K3 1 round, every shard live": (112, 1, False),
                                 "K3 5 rounds, every shard live": (113, 5, False)}.items():
        out[name] = answer_case(seed, n, one)
    hot, cold, back_hot, back_cold, records = cs.moves_case(
        100, cs.TT_FRONT, cs.TT_BACK, cs.TT_MOVES, cs.TT_MOVES)
    out["K9 full window"] = (dict(hot=hot, cold=cold, back_hot=back_hot, back_cold=back_cold,
                                  records=records), (MOVES, 0, 0, NOW))
    for name, (seed, K) in {"K6 1024 sorted": (100, 1024), "K6 1024 unsorted": (101, 1024),
                            "K6 2048 sorted": (102, 2048)}.items():
        _, _, gc, (idx,) = cs.global_case("clear", seed, 8, cs.G_FULL, K)
        out[name] = (dict(idx=idx, **{f"g{i}": c for i, c in enumerate(gc)}),
                     (CLEAR, 0, 0, NOW))
    for kind in ("dict", "cols"):
        hot, cold, args, wlane = cs.zipf_compact_case(100, cs.SHARD_C, cs.BATCH, cs.SHARD_KEYS,
                                                      kind)
        keys = ("wire",) if kind == "dict" else ("lanes", "values")
        out[f"K10 headline batch {kind}"] = (
            dict(hot=hot, cold=cold, wlane=wlane, **dict(zip(keys, args))),
            (COMPACT, 1, 0, NOW))
    return out


PATH_CASES = ("K3 the GLOBAL path's batch", "K9 the two-tier path's window")


def path_cases():
    """The GLOBAL path's step-by-step K3 batch (a skewed 2,048-lane
    batch) and the two-tier path's largest K9 window, from chip_smoke.py's
    phases 6 and 9 run here on the card, with the card store's state at
    the phase's end (as its phase 8 times them)."""
    import torch

    def np_(t):
        return t.cpu().numpy()

    card, _, (answer_inputs, _, _), summary = cs.global_phase(torch)
    prep, staged, _ = answer_inputs
    arrays = dict(hot=np_(card.state.hot), cold=np_(card.state.cold),
                  **dict(zip(("lanes", "values", "gslot"), map(np_, staged))))
    arrays.update({f"g{i}": np_(c) for i, c in enumerate(card.gcols)})
    out = {PATH_CASES[0]: (arrays, (ANSWER, prep.n_rounds, 1, summary["now"]))}
    tstore, _, _, calls = cs.two_tier_phase(torch)
    out[PATH_CASES[1]] = (
        dict(hot=np_(tstore.state.hot), cold=np_(tstore.state.cold),
             back_hot=np_(tstore.back.hot), back_cold=np_(tstore.back.cold),
             records=np_(calls.records)), (MOVES, 0, 0, NOW))
    return out


def save_cases(path, cs_):
    arrays = {}
    for name, (arrs, meta) in cs_.items():
        for k, a in arrs.items():
            arrays[f"{name}/{k}"] = a
        arrays[f"{name}/meta"] = np.array(meta, np.int64)
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
    ap.add_argument("--only", help="comma-separated name prefixes of the cases to time")
    opts = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    sides = {"base": os.path.abspath(opts.base), "this": ROOT}
    result = {"card": smi, "ms": {"base": [], "this": []}}
    with tempfile.TemporaryDirectory() as d:
        case_file = os.path.join(d, "cases.npz")
        keep = tuple(opts.only.split(",")) if opts.only else ("",)
        chosen = {k: v for k, v in cases().items() if k.startswith(keep)}
        if any(name.startswith(keep) for name in PATH_CASES):
            chosen.update({k: v for k, v in path_cases().items() if k.startswith(keep)})
        save_cases(case_file, chosen)
        for side in ("base", "this", "this", "base"):
            ms = time_side(sides[side], case_file)
            result["ms"][side].append(ms)
            for name, ((warm, span, per_call), (flushed, fspan, _), queued) in sorted(
                    ms.items()):
                print(f"[ab] {side} {name}: device {warm} ms warm (span {span}), {flushed} ms "
                      f"L2 flushed (span {fspan}), {per_call} kernels a call; queued "
                      f"{queued} ms a call", flush=True)
    line = json.dumps(result)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
