"""The benchmark of gubernator_tpu_torch on NVIDIA cards: one run of one
cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration and its traffic
mix are looked up by name in BENCHMARK.json; see portbench/README.md.
The last line of standard output is the run's result as one JSON object;
standard error ends with each number of the correctness check beside its
limit.  Exits non-zero, printing no result, without the cards the cell
asks for, without the port, or when the process has loaded JAX.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One process with few threads: steadier host timings.
THREADS = 2
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(THREADS)
# Every build and kernel cache at a fixed place inside the checkout (the
# port builds its own kernels into gubernator_tpu_torch/_build/).
_CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "cuda")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_cell(name: str):
    """(cell, config entry, config file, traffic mix, metrics) of `name`."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    from portbench import traffic

    return cell, entry, config, traffic.load(ROOT, cell["traffic"]), bench


def metrics_for(bench: dict, cell: dict, kind: str) -> list:
    return [m for m in bench[kind] if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(name: str):
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell, _, config, mix, bench = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(THREADS)
    log(f"[threads] torch {torch.get_num_threads()}, OMP_NUM_THREADS "
        f"{os.environ['OMP_NUM_THREADS']}, MKL_NUM_THREADS {os.environ['MKL_NUM_THREADS']}")
    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.cuda.reset_peak_memory_stats()

    from portbench import bench as bench_mod

    window, check, peak = bench_mod.run_cell(
        cell, config, mix, args.seed % (1 << 64), args.seconds, bool(args.trace),
        device=None, t_start=T_START, log=log)

    bad = bench_mod.forbidden_modules()
    if bad:
        log(f"portbench: this process loaded {', '.join(bad)}; the port may not")
        return 3

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, cell, kind):
        v = reader(m["name"])(window, cell)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]), "memory_peak_bytes": peak}
    out = {"correct": check.correct, "attempted": window.requests, "failed": window.failed,
           "metrics": metrics, "device": device}
    if args.trace:
        t = window.trace
        device["busy_s"], device["window_s"] = t["busy_s"], t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    out["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in check.numbers.items()}
    log(f"[window] {window.requests} requests, {window.lanes} lanes in "
        f"{window.seconds:.3f} s; failed {window.failed}")
    for k, (v, lim) in check.numbers.items():
        log(f"check {k} {v} limit {lim}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
