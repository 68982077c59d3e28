"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no `ok` line):

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc builds the bucket-rounds kernels and g++ the host
              runtime, from this checkout's sources, in parallel;
3. kernels  — each kernel (dict wire K1, per-lane columns K2), narrow
              and wide, against its plain PyTorch version on the same
              card and inputs: small seeded cases plus one batch at the
              main path's size; outputs and state bytes must be
              identical (tolerance 0: all integer);
4. service  — a V1Service on the card answers token, leaky, validation
              and duplicate-key requests exactly as one on the CPU;
5. main     — the columnar path at full size: the "leaky bucket, 1M
              unique keys, Zipf" deployment (BASELINE.json configs[1],
              bench_full.py config 2) on an 8-shard store of 2,097,152
              slots, 131,072-lane batches two in flight, plus one
              monthly-Gregorian (wide) batch and one batch with more than
              256 configs (K2); every answer and the final state must
              equal the same traffic through a store on the plain
              versions (CPU);
6. numbers  — kernel time per launch at the main path's shapes, the
              plain version's, and the memory bound, as one JSON line.

The last line is `{"ok": true, "device": {...}}`.  Exits 2 without a
CUDA device.
"""

import json
import subprocess
import sys
import threading
import time

import numpy as np

S = 8
C_FULL = 262_144  # slots per shard: 2,097,152 in all
BATCH = 131_072
N_KEYS = 1_000_000
NOW = 1_700_000_000_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------
# phase 1 and 2
# ---------------------------------------------------------------------
def device_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch.cuda: {name}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    return smi, name


def build_phase():
    from gubernator_tpu_torch import native
    from gubernator_tpu_torch.ops import _kernels

    logs = {"kernels": [], "host_runtime": []}
    errors = []

    def run(name, fn):
        try:
            fn(log=logs[name])
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=("kernels", _kernels.build)),
               threading.Thread(target=run, args=("host_runtime", native.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    log(f"[build] kernels and host runtime built in {time.perf_counter() - t0:.1f} s")
    for line in "".join(logs["kernels"]).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build] ptxas: {line.strip()}")


# ---------------------------------------------------------------------
# seeded kernel inputs (numpy), shapes as the mesh store plans them
# ---------------------------------------------------------------------
def _split(v):
    v = np.asarray(v, np.int64)
    return (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32), (v >> 32).astype(np.int32)


def random_state(rng, C, wide):
    n = S * C
    algo = rng.integers(0, 2, n)
    limit = np.where(rng.random(n) < 0.8, rng.integers(0, 200, n),
                     rng.integers(0, 2**40 if wide else 200, n))
    duration = rng.choice([1000, 30_000, 60_000, 3_600_000], n)
    rem = (rng.random(n) * (limit + 1)).astype(np.int64)
    rem = np.where(algo == 1, rem * (1 << 20) + rng.integers(0, 1 << 20, n), rem)
    stamp = NOW - rng.integers(0, 2 * 3_600_000, n)
    expire = NOW + rng.integers(-60_000, 3_600_000, n)
    pick = rng.random(n)
    expire = np.select([pick < 0.05, pick < 0.1, pick < 0.15, pick < 0.2],
                       [NOW, NOW - 1, 0, NOW + (1 << 40)], expire)
    hot = np.zeros((n, 8), np.int32)
    cold = np.zeros((n, 8), np.int32)
    hot[:, 0] = algo | (rng.integers(0, 2, n) << 2)
    hot[:, 1], hot[:, 2] = _split(rem)
    hot[:, 3], hot[:, 4] = _split(stamp)
    hot[:, 5], hot[:, 6] = _split(expire)
    cold[:, 0], cold[:, 1] = _split(limit)
    cold[:, 2], cold[:, 3] = _split(duration)
    return hot.reshape(S, C, 8), cold.reshape(S, C, 8)


def random_configs(rng, k, wide):
    """k configs (algo, behavior, hits, limit, duration, greg_expire
    delta, greg_duration); wide ones add >2**31 values and durations
    that take the 128-bit leak division."""
    algo = rng.integers(0, 2, k)
    behavior = np.where(rng.random(k) < 0.15, 8, 0)
    hits = rng.choice([0, 1, 1, 1, 2, 3, 5, 50], k)
    limit = rng.choice([0, 1, 5, 10, 30, 100, 199], k)
    duration = rng.choice([1000, 30_000, 60_000, 3_600_000], k)
    greg = rng.random(k) < 0.2
    behavior = np.where(greg, behavior | 4, behavior)
    gd = np.where(greg, 86_400_000, 0)
    ge = np.where(greg, rng.integers(0, 86_400_000, k), 0)
    if wide:
        big = rng.random(k) < 0.4
        limit = np.where(big, 2**42, limit)
        hits = np.where(big & (rng.random(k) < 0.5), 2**41, hits)
        duration = np.where(big & (rng.random(k) < 0.5), 2**44, duration)
        ge = np.where(greg & (rng.random(k) < 0.5), 2**33, ge)
    return [np.asarray(c, np.int64) for c in (algo, behavior, hits, limit, duration, ge, gd)]


def random_plan(rng, C, P, rounds):
    """Per-shard lanes as the grouped planner emits them: unique slots
    per (round, shard), uniform groups with consecutive occ and one
    writer, 20% padding, lanes shuffled."""
    cols = {k: np.zeros((S, P), np.int64) for k in ("slot", "ex", "wr", "occ", "rid", "grp")}
    cols["slot"][:] = -1
    used = int(P * 0.8)
    for s in range(S):
        sizes = rng.choice([1, 1, 1, 2, 3, 5], used)
        ends = np.cumsum(sizes)
        g = int(np.searchsorted(ends, used)) + 1
        sizes = sizes[:g]
        sizes[-1] -= ends[g - 1] - used
        ends = np.cumsum(sizes)
        grid = rng.integers(0, rounds, g)
        slots = np.empty(g, np.int64)
        for r in range(rounds):  # unique within a round, reused across rounds
            sel = grid == r
            slots[sel] = rng.choice(C, int(sel.sum()), replace=False)
        gid = np.repeat(np.arange(g), sizes)
        first = np.repeat(ends[:g] - sizes, sizes)
        occ = np.arange(used) - first
        lanes = rng.permutation(P)[:used]
        cols["slot"][s, lanes] = slots[gid]
        cols["ex"][s, lanes] = (rng.random(g) < 0.8)[gid]
        cols["wr"][s, lanes] = occ == sizes[gid] - 1
        cols["occ"][s, lanes] = occ
        cols["rid"][s, lanes] = grid[gid]
        cols["grp"][s, lanes] = gid
    return cols


def make_case(seed, C, P, rounds, wide, kind, n_cfg):
    """Kernel inputs for one seeded case: (hot, cold, args) where args
    follow (hot, cold) in bucket_rounds_dict / bucket_rounds_cols."""
    from gubernator_tpu_torch.ops import buckets

    rng = np.random.default_rng(seed)
    hot, cold = random_state(rng, C, wide)
    cfgs = random_configs(rng, n_cfg, wide)
    plan = random_plan(rng, C, P, rounds)
    cfg = rng.integers(0, n_cfg, (S, P))
    # lanes of one group share one config
    for s in range(S):
        cfg[s] = cfg[s][plan["grp"][s] % P]
    n_rounds = int(plan["rid"].max()) + 1
    if kind == "dict":
        table = [np.concatenate([c, np.zeros(256 - n_cfg, np.int64)]) for c in cfgs]
        wire = buckets.pack_dict_wire(plan["slot"], plan["ex"], plan["wr"], cfg,
                                      plan["occ"], plan["rid"], table)
        return hot, cold, (wire,), n_rounds
    vals = [c[cfg] for c in cfgs]
    if wide:  # absolute greg_expire on the wide per-lane wire
        vals[5] = np.where(vals[6] != 0, NOW + vals[5], 0)
    lanes = np.stack([plan["slot"], plan["ex"] | (plan["wr"] << 1), vals[0], vals[1],
                      plan["occ"], plan["rid"]], axis=1).astype(np.int32)
    values = np.stack(vals[2:7], axis=1).astype(np.int64 if wide else np.int32)
    return hot, cold, (lanes, values), n_rounds


# ---------------------------------------------------------------------
# phase 3: kernels against their plain versions on the card
# ---------------------------------------------------------------------
KERNELS = {
    "dict": ("bucket_rounds_dict", "gubernator_tpu/parallel/mesh.py:179"),
    "cols": ("bucket_rounds_cols", "gubernator_tpu/parallel/mesh.py:158"),
}


def run_kernel(torch, dev, kind, hot, cold, args, n_rounds, wide, plain):
    from gubernator_tpu_torch.ops import buckets

    h = torch.tensor(hot, device=dev)  # copies: the case is reused
    c = torch.tensor(cold, device=dev)
    targs = [torch.tensor(a, device=dev) for a in args]
    if kind == "cols":
        fn = buckets.bucket_rounds_cols_plain if plain else buckets.bucket_rounds_cols
        out = fn(h, c, *targs, n_rounds, NOW, wide)
    elif plain:
        out = buckets.bucket_rounds_dict_plain(h, c, *targs, n_rounds, NOW, wide)
    else:
        # into slice 1 of a stacked result, as a fused launch group writes
        P = (targs[0].shape[1] - buckets.DICT_WIRE_TABLE_WORDS) // 3
        stacked = torch.zeros((2, S, 4, P), device=dev,
                              dtype=torch.int64 if wide else torch.int32)
        out = buckets.bucket_rounds_dict(h, c, *targs, n_rounds, NOW, wide, out=stacked[1])
    return out.cpu().numpy(), h.cpu().numpy(), c.cpu().numpy()


def max_abs_err(a, b):
    return max(int(np.abs(x.astype(np.int64) - y.astype(np.int64)).max()) for x, y in zip(a, b))


def kernel_phase(torch, dev="cuda", full=(C_FULL, 32_768)):
    from gubernator_tpu_torch.ops import _kernels

    errs = {k: 0 for k in KERNELS}
    n = 0
    for kind in KERNELS:
        for wide in (False, True):
            cases = [(seed, 512, 256, 1 + seed % 3, 12 if kind == "dict" else 300)
                     for seed in range(6)]
            cases.append((100, *full, 1, 12 if kind == "dict" else 300))
            for seed, C, P, rounds, n_cfg in cases:
                hot, cold, args, nr = make_case(seed, C, P, rounds, wide, kind, n_cfg)
                got = run_kernel(torch, dev, kind, hot, cold, args, nr, wide, plain=False)
                want = run_kernel(torch, dev, kind, hot, cold, args, nr, wide, plain=True)
                err = max_abs_err(got, want)
                if err != 0 or any(g.tobytes() != w.tobytes() for g, w in zip(got, want)):
                    raise AssertionError(
                        f"{kind} wide={wide} seed={seed} C={C} P={P}: kernel != plain "
                        f"(max abs err {err})")
                errs[kind] = max(errs[kind], err)
                n += 1
    log(f"[kernels] {n} cases, kernel == plain bit for bit "
        f"(launches {dict(_kernels.LAUNCHES)})")
    return errs


# ---------------------------------------------------------------------
# phase 4: service on the card against the service on the CPU
# ---------------------------------------------------------------------
def service_phase(devices=("cuda", "cpu")):
    from gubernator_tpu_torch.service import IngressColumns, ServiceConfig, V1Service
    from gubernator_tpu_torch.types import (
        Algorithm, GetRateLimitsRequest, RateLimitRequest, Status)
    from gubernator_tpu_torch.utils.clock import Clock

    svcs = []
    for device in devices:
        clock = Clock()
        clock.freeze(NOW)
        svcs.append((V1Service(ServiceConfig(cache_size=4096, clock=clock, device=device)), clock))

    def req(key, hits=1, limit=5, algo=Algorithm.TOKEN_BUCKET, name="smoke"):
        return RateLimitRequest(name=name, unique_key=key, hits=hits, limit=limit,
                                duration=10_000, algorithm=algo)

    steps = [[req("tok")] for _ in range(6)]  # drained to OVER_LIMIT
    steps.append([req(f"leaky{i}", hits=2, limit=4, algo=Algorithm.LEAKY_BUCKET)
                  for i in range(4)])
    steps.append([req("ok"), req("")])  # empty unique_key
    answers = []
    for svc, clock in svcs:
        got = []
        for reqs in steps:
            got.append(svc.get_rate_limits(GetRateLimitsRequest(requests=reqs)).responses)
            clock.advance(300)
        cols = IngressColumns(
            names=["dup"] * 6, unique_keys=["a", "b", "a", "a", "c", "b"],
            algorithm=np.array([0, 1, 0, 0, 1, 1], np.int32),
            behavior=np.zeros(6, np.int32), hits=np.full(6, 2, np.int64),
            limit=np.full(6, 5, np.int64), duration=np.full(6, 10_000, np.int64))
        r = svc.get_rate_limits_columns(cols)
        got.append([r.response_at(i) for i in range(6)])
        svc.close()
        answers.append(got)
    gpu, cpu = answers
    if gpu != cpu:
        raise AssertionError(f"service on the card != service on the CPU:\n{gpu}\n{cpu}")
    assert gpu[5][0].status == Status.OVER_LIMIT, gpu[5]
    assert gpu[7][1].error == "field 'unique_key' cannot be empty", gpu[7]
    assert gpu[8][3].status == Status.OVER_LIMIT, gpu[8]  # third "a" of the batch
    log("[service] card == CPU on token drain, leaky, validation and duplicate keys")


# ---------------------------------------------------------------------
# phase 5: the main path at full size
# ---------------------------------------------------------------------
def zipf_ids(rng, n_keys, batch, hot_frac=0.1, hot_traffic=0.8):
    """bench_full.py's Zipf stand-in: 80% of traffic on 10% of keys."""
    hot = rng.randint(0, max(int(n_keys * hot_frac), 1), size=batch)
    cold = rng.randint(0, n_keys, size=batch)
    return np.where(rng.random(batch) < hot_traffic, hot, cold)


def main_traffic():
    """The main path's batches: (name, keys, columns, now, greg)."""
    from gubernator_tpu_torch import native
    from gubernator_tpu_torch.models.shard import GregResolver
    from gubernator_tpu_torch.utils import gregorian

    rng = np.random.RandomState(2)
    batches = []
    for i in range(10):
        ids = zipf_ids(rng, N_KEYS, BATCH)
        keys = native.PackedKeys(*native.pack_keys([f"c2:{k}" for k in ids]))
        cols = dict(
            algorithm=np.ones(BATCH, np.int32),  # LEAKY
            behavior=np.zeros(BATCH, np.int32),  # BATCHING
            hits=np.ones(BATCH, np.int64),
            limit=np.full(BATCH, 1_000_000, np.int64),
            duration=np.full(BATCH, 3_600_000, np.int64),
        )
        batches.append(("warm" if i < 2 else "timed", keys, cols, NOW + 10 * i))
    # The first instant of December 2023: a whole month to the reset,
    # more than an int32 delta of milliseconds, so the wide output.
    now = 1_701_388_800_000
    ids = zipf_ids(rng, N_KEYS, BATCH)
    ge, gd = GregResolver(now).resolve(gregorian.GREGORIAN_MONTHS)
    assert ge - now > (1 << 31) - 1, ge - now
    keys = native.PackedKeys(*native.pack_keys([f"c2m:{k}" for k in ids]))
    batches.append(("monthly", keys, dict(
        algorithm=np.ones(BATCH, np.int32),
        behavior=np.full(BATCH, 4, np.int32),  # DURATION_IS_GREGORIAN
        hits=np.ones(BATCH, np.int64),
        limit=np.full(BATCH, 1_000_000, np.int64),
        duration=np.full(BATCH, gregorian.GREGORIAN_MONTHS, np.int64),
        greg_expire=np.full(BATCH, ge, np.int64),
        greg_duration=np.full(BATCH, gd, np.int64)), now))
    now += 10
    ids = zipf_ids(rng, N_KEYS, BATCH)
    keys = native.PackedKeys(*native.pack_keys([f"c2:{k}" for k in ids]))
    batches.append(("configs", keys, dict(
        algorithm=np.ones(BATCH, np.int32),
        behavior=np.zeros(BATCH, np.int32),
        hits=np.ones(BATCH, np.int64),
        limit=(1_000_000 + ids % 400).astype(np.int64),  # 400 configs: K2
        duration=np.full(BATCH, 3_600_000, np.int64)), now))
    return batches


def drive(store, items):
    """Dispatch `items` through the store with two batches in flight
    (batch i+1 is dispatched before batch i is read back); returns the
    answers and each batch's dispatch-to-answer latency in seconds."""
    answers, lat = [], []
    pending = None

    def finish(p):
        answers.append(p[0].result())
        lat.append(time.perf_counter() - p[1])

    for _, keys, cols, now in items:
        t = time.perf_counter()
        h = store.apply_columns_async(keys, now_ms=now, **cols)
        if pending is not None:
            finish(pending)
        pending = (h, t)
    finish(pending)
    return answers, lat


def main_phase(torch, dev="cuda"):
    from gubernator_tpu_torch.ops import _kernels
    from gubernator_tpu_torch.parallel.mesh import MeshBucketStore

    t0 = time.perf_counter()
    batches = main_traffic()
    log(f"[main] traffic made in {time.perf_counter() - t0:.1f} s: "
        f"{len(batches)} batches of {BATCH} lanes over {N_KEYS} keys")
    store = MeshBucketStore(capacity_per_shard=C_FULL, n_shards=S, device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    warm = [b for b in batches if b[0] == "warm"]
    timed = [b for b in batches if b[0] == "timed"]
    extra = [b for b in batches if b[0] not in ("warm", "timed")]
    answers, _ = drive(store, warm)
    t0 = time.perf_counter()
    got, lat = drive(store, timed)
    timed_s = time.perf_counter() - t0
    answers += got
    answers += drive(store, extra)[0]
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    lats = np.array(lat) * 1e3
    log(f"[main] launches on the main path: {launches}")
    log(f"[main] {len(timed)} timed batches in {timed_s:.3f} s: "
        f"{len(timed) * BATCH / timed_s:.0f} checks/s, batch latency "
        f"p50 {np.percentile(lats, 50):.2f} ms, p99 {np.percentile(lats, 99):.2f} ms; "
        f"peak device memory {peak / 2**20:.1f} MiB")
    for kname, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {kname} was not launched on the main path")

    # the same traffic through a store on the plain versions
    t0 = time.perf_counter()
    ref = MeshBucketStore(capacity_per_shard=C_FULL, n_shards=S, device="cpu")
    for (name, keys, cols, now), got in zip(batches, answers):
        want = ref.apply_columns(keys, now_ms=now, **cols)
        for f in ("status", "limit", "remaining", "reset_time"):
            if not np.array_equal(np.asarray(got[f]), np.asarray(want[f])):
                raise AssertionError(f"main path batch {name}: {f} differs from the plain store")
    for a, b in ((store.state.hot, ref.state.hot), (store.state.cold, ref.state.cold)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("main path: final state differs from the plain store")
    over = sum(int((a["status"] == 1).sum()) for a in answers)
    log(f"[main] answers and final state == plain store (CPU) for all {len(batches)} "
        f"batches ({over} OVER_LIMIT lanes), checked in {time.perf_counter() - t0:.1f} s")
    return store, batches, launches


# ---------------------------------------------------------------------
# phase 6: kernel numbers at the main path's shapes
# ---------------------------------------------------------------------
def time_launches(torch, fn, iters):
    fn()  # warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def numbers_phase(torch, store, batches, launches, errs):
    """Plan and stage one more main-path batch of each kind on the
    store, one step at a time (the host breakdown of a batch), then
    time the kernel and its plain version on those inputs against a
    copy of the store's state."""
    from gubernator_tpu_torch.models.shard import make_columns
    from gubernator_tpu_torch.ops import buckets

    rows = []
    picks = {"dict": batches[-3], "cols": batches[-1]}  # a timed batch; the K2 batch
    for kind, (kname, replaces) in KERNELS.items():
        name, keys, cols, now = picks[kind]
        c = make_columns(cols["algorithm"], cols["behavior"], cols["hits"],
                         cols["limit"], cols["duration"], len(keys))
        hot0, cold0 = store.state.hot.clone(), store.state.cold.clone()
        hot, cold = hot0.clone(), cold0.clone()
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        prep = store._prepare_columns(keys, c, now + 1000)
        t.append(time.perf_counter())
        staged = store._stage_columns(prep)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = staged.kernel(hot, cold, *staged.args)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out_np = out.cpu().numpy()
        t.append(time.perf_counter())
        prep.commit(out_np)
        t.append(time.perf_counter())
        steps = np.diff(t) * 1e3
        log(f"[breakdown] {kname} one batch, host clock: plan {steps[0]:.1f} ms, "
            f"pack+upload {steps[1]:.1f} ms, kernel+sync {steps[2]:.2f} ms, "
            f"readback {steps[3]:.2f} ms, decode+commit {steps[4]:.1f} ms")
        assert staged.kernel.__name__ == kname, (staged.kernel.__name__, kname)
        changed_cold = int((cold != cold0).any(dim=2).sum())
        ms = time_launches(torch, lambda: staged.kernel(hot, cold, *staged.args), 20)
        plain = (buckets.bucket_rounds_dict_plain if kind == "dict"
                 else buckets.bucket_rounds_cols_plain)
        plain_ms = time_launches(torch, lambda: plain(hot, cold, *staged.args), 3)
        # bytes the function must move: inputs once, outputs once, a
        # hot+cold row gathered per valid lane, a hot row scattered per
        # writing lane, a cold row per changed config
        args = staged.args
        if kind == "dict":
            wire = args[0]
            P = (wire.shape[1] - buckets.DICT_WIRE_TABLE_WORDS) // 3
            slot = wire[:, :P]
            write = ((wire[:, P:2 * P] >> 17) & 1) == 1
            in_bytes = wire.numel() * 4
        else:
            lanes, values = args[0], args[1]
            slot = lanes[:, 0]
            write = ((lanes[:, 1] >> 1) & 1) == 1
            in_bytes = lanes.numel() * 4 + values.numel() * values.element_size()
        valid = slot >= 0
        n_valid = int(valid.sum())
        n_write = int((valid & write).sum())
        nbytes = (in_bytes + out.numel() * out.element_size() + 64 * n_valid
                  + 32 * n_write + 32 * changed_cold)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({
            "name": kname, "route": "cuda",
            "source": "gubernator_tpu_torch/csrc/bucket_rounds.cu",
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[kind], "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
            "bound_ms": round(bound_ms, 5), "bound_by": "bytes", "library_ms": None,
        })
        log(f"[numbers] {kname} ({name} batch, S={slot.shape[0]} P={slot.shape[1]}, "
            f"{'wide' if staged.wide else 'narrow'}, rounds {args[-3]}): "
            f"{ms:.4f} ms/launch, plain {plain_ms:.2f} ms, bound {bound_ms:.5f} ms "
            f"({nbytes} bytes: {n_valid} lanes, {n_write} writers, "
            f"{changed_cold} cold rows)")
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    _, name = device_phase(torch)
    build_phase()
    errs = kernel_phase(torch)
    service_phase()
    store, batches, launches = main_phase(torch)
    rows = numbers_phase(torch, store, batches, launches, errs)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
