"""One run of one cell: set-up, the measured window, the check.

The system under test is the port's one-node service
(`gubernator_tpu_torch.service.V1Service`), driven through its columnar
entry `get_rate_limits_columns_async` by closed-loop flows: each flow
waits for its answer before it sends again, as the app servers that call
a rate limiter do.  An issuer thread sends for all flows, a new request
object for every send: an HTTP caller's JSON body parsed by the port's
native edge parser, or an IngressColumns.  The service's clock is frozen and moves between
epochs only, when no request is in flight (traffic.py).

Set-up (counted in `setup_s`): the key strings, the service and its
store, the kernels built or loaded from the checkout's build directory,
the warm-up launches, the key-table fill, and a lead of requests that
brings the pipeline to its steady state.  The window then measures for
the given seconds; afterwards the flows stop, every request still in
flight is awaited, and each answer and the store's final state are
compared with the plain reference (reference.py) at each hit's instant.
"""

from __future__ import annotations

import gc
import os
import queue
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from portbench import reference, trace as trace_mod, traffic as traffic_mod

# A request still unanswered this long after the window closed is lost.
DRAIN_S = 60.0
FORBIDDEN = ("jax", "jaxlib", "flax", "gubernator_tpu")


def forbidden_modules() -> List[str]:
    """Top-level module names loaded in this process that the benchmark
    may not load (JAX and the JAX package), compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class Sent:
    """One request a flow issued: its place in the flow's sequence, when
    it was sent and answered (perf_counter s), and what came back."""

    flow: int
    index: int
    t_sent: float
    t_done: float = 0.0
    result: object = None
    error: Optional[BaseException] = None
    lanes: Optional[np.ndarray] = None  # its key ids, filled in for the check


def behavior_field(p: dict) -> str:
    """A JSON lane's `behavior` as an HTTP caller writes it, by its name;
    nothing for BATCHING (0)."""
    names = traffic_mod.behavior_names(p)
    return ',"behavior":"%s"' % names[0] if names else ""


class Requests:
    """Each request as the service takes it, a new object for every send.
    Entry "columns": an IngressColumns whose key strings are made once,
    in set-up.  Entry "json": the /v1/GetRateLimits JSON body an HTTP
    caller sends, made once, parsed at each send by the port's native
    edge parser (gateway.parse_body_native)."""

    def __init__(self, traffic: "traffic_mod.Traffic"):
        from gubernator_tpu_torch.service import IngressColumns

        self._cls = IngressColumns
        self.traffic = traffic
        p = traffic.params
        self.name = p["name"]
        self.entry = p["entry"]
        if self.entry == "json":
            lane = ('{"name":"%s","unique_key":"%%d","hits":%d,"limit":%d,"duration":%d,'
                    '"algorithm":"%s"%s}' % (self.name, int(p["hits"]), int(p["limit"]),
                                             int(p["duration_ms"]),
                                             {"token": "TOKEN_BUCKET",
                                              "leaky": "LEAKY_BUCKET"}[p["algorithm"]],
                                             behavior_field(p)))
            self._bodies = [[('{"requests":[%s]}' % ",".join(lane % i for i in ids.tolist()))
                             .encode() for ids in s] for s in traffic.scripts]
        else:
            self._keys = [[list(map(str, ids.tolist())) for ids in s] for s in traffic.scripts]

    def make(self, flow: int, index: int):
        if flow < 0:
            keys = list(map(str, self.traffic.fill[index].tolist()))
            cols = traffic_mod.columns(self.traffic.params, len(keys))
            return self._cls(names=[self.name] * len(keys), unique_keys=keys, **cols)
        if self.entry == "json":
            from gubernator_tpu_torch.gateway import parse_body_native

            script = self._bodies[flow]
            cols = parse_body_native(script[index % len(script)])
            if cols is None:
                raise RuntimeError("the native edge parser refused a request body")
            return cols
        script = self._keys[flow]
        keys = list(script[index % len(script)])
        cols = {f: v.copy() for f, v in self.traffic.columns.items()}
        return self._cls(names=[self.name] * len(keys), unique_keys=keys, **cols)


class Flows:
    """Closed-loop flows driven by `issuers` threads.  A flow is queued
    when it may send; an issuer sends its next request; the service's
    callback records the answer and queues the flow again.  A flow that
    has sent its epoch's requests waits for the others; once all are
    answered the service's clock moves to the next epoch's instant
    (traffic.now_of) and every flow is queued again."""

    def __init__(self, svc, clock, requests: Requests, issuers: int):
        self.svc = svc
        self.clock = clock
        self.requests = requests
        self.traffic = requests.traffic
        self.epoch_requests = int(self.traffic.params["epoch_requests"])
        n = self.traffic.flows
        self.sent: List[List[Sent]] = [[] for _ in range(n)]
        self._ready: "queue.SimpleQueue" = queue.SimpleQueue()
        self._stopping = False
        self._lock = threading.Lock()
        self._answered = 0
        self._idle = threading.Condition(self._lock)
        self._in_flight = 0
        self._waiting = 0  # flows done with the epoch
        self.epochs = 0  # clock moves so far
        # (label, start, end) of each send while the window is traced.
        self.spans: Optional[list] = None
        self._threads = [threading.Thread(target=self._issue, name=f"portbench-issuer-{i}",
                                          daemon=True) for i in range(issuers)]

    def start(self) -> None:
        self.clock.freeze(self.traffic.now_of(0, 0))
        for t in self._threads:
            t.start()
        for c in range(self.traffic.flows):
            self._ready.put(c)

    @property
    def answered(self) -> int:
        return self._answered

    def _issue(self) -> None:
        while True:
            c = self._ready.get()
            if c is None:
                return
            self._send(c)

    def _send(self, c: int) -> None:
        with self._lock:
            if self._stopping:
                return
            self._in_flight += 1
        rec = Sent(flow=c, index=len(self.sent[c]), t_sent=0.0)
        self.sent[c].append(rec)
        cols = self.requests.make(c, rec.index)
        rec.t_sent = time.perf_counter()
        self.svc.get_rate_limits_columns_async(cols, self._done_cb(rec))
        spans = self.spans
        if spans is not None:
            spans.append(("flow.send", rec.t_sent, time.perf_counter()))

    def _done_cb(self, rec: Sent):
        def done(result, exc):
            rec.t_done = time.perf_counter()
            rec.result, rec.error = result, exc
            with self._lock:
                self._answered += 1
                self._in_flight -= 1
                if self._stopping:
                    self._idle.notify_all()
                    return
                if (rec.index + 1) % self.epoch_requests:
                    go = (rec.flow,)
                else:
                    self._waiting += 1
                    if self._waiting < self.traffic.flows:
                        return
                    # Every flow is done with the epoch: nothing in flight.
                    self._waiting = 0
                    self.epochs += 1
                    self.clock.freeze(self.traffic.now_of(0, rec.index + 1))
                    go = range(self.traffic.flows)
            for c in go:
                self._ready.put(c)
        return done

    def wait_answered(self, n: int, timeout: float) -> bool:
        t_end = time.perf_counter() + timeout
        while self._answered < n:
            if time.perf_counter() > t_end:
                return False
            time.sleep(0.002)
        return True

    def stop(self, timeout: float) -> bool:
        """Stop sending and wait for every request in flight; True when
        none is left unanswered."""
        with self._lock:
            self._stopping = True
            t_end = time.perf_counter() + timeout
            while self._in_flight:
                left = t_end - time.perf_counter()
                if left <= 0:
                    break
                self._idle.wait(left)
            done = self._in_flight == 0
        for _ in self._threads:
            self._ready.put(None)
        for t in self._threads:
            t.join(timeout=10)
        return done


def build_service(config: dict, now_ms: int, device):
    """The port's one-node service as the daemon would build it from the
    configuration's GUBER_* settings, on `device`, its clock frozen at
    `now_ms`, its kernels launched once: (service, clock)."""
    from gubernator_tpu_torch.config import setup_daemon_config
    from gubernator_tpu_torch.service import ServiceConfig, V1Service
    from gubernator_tpu_torch.utils.clock import Clock

    conf = setup_daemon_config(env=dict(config["env"]))
    clock = Clock()
    clock.freeze(now_ms)
    svc = V1Service(ServiceConfig(
        cache_size=conf.cache_size, back_cache_size=conf.back_cache_size,
        global_cache_size=conf.global_cache_size, behaviors=conf.behaviors,
        clock=clock, device=device))
    svc.store.warmup(now_ms, conf.warmup_shapes)
    return svc, clock


def fill_table(svc, requests: Requests, in_flight: int = 4) -> List[Sent]:
    """The set-up fill: every fill request through the same entry,
    `in_flight` at a time, in order of sending."""
    sent: List[Sent] = []
    sem = threading.Semaphore(in_flight)
    all_done = threading.Event()
    left = [len(requests.traffic.fill)]
    lock = threading.Lock()

    def cb(rec):
        def done(result, exc):
            rec.t_done = time.perf_counter()
            rec.result, rec.error = result, exc
            sem.release()
            with lock:
                left[0] -= 1
                if not left[0]:
                    all_done.set()
        return done

    if not left[0]:
        return sent
    for i in range(left[0]):
        cols = requests.make(-1, i)
        sem.acquire()
        rec = Sent(flow=-1, index=i, t_sent=time.perf_counter())
        sent.append(rec)
        svc.get_rate_limits_columns_async(cols, cb(rec), max_lanes=len(cols))
    if not all_done.wait(DRAIN_S * 5):
        raise RuntimeError("the set-up fill did not finish")
    for rec in sent:
        if rec.error is not None:
            raise RuntimeError(f"fill request {rec.index} failed: {rec.error!r}")
    return sent


def launches() -> Dict[str, int]:
    from gubernator_tpu_torch.ops import _kernels

    return dict(_kernels.LAUNCHES)


def queue_wait_samples() -> List[float]:
    """The service's `queue.wait` reservoir (saturation.py), in s."""
    from gubernator_tpu_torch import saturation

    st = saturation._phases.get("queue.wait")  # noqa: SLF001 — the program's counter
    if st is None:
        return []
    with st._lock:  # noqa: SLF001
        return list(st._buf)  # noqa: SLF001


ROW_FIELDS = ("algo", "status", "limit", "remaining", "duration", "stamp", "expire_at")


def read_state(store):
    """Every key the store holds with its row as the store keeps it:
    {hash_key: (algo, status, limit, remaining, duration, stamp,
    expire_at)}.  Read with the pipeline drained."""
    from gubernator_tpu_torch.ops import buckets

    out = {}
    store._drain_then_lock()  # noqa: SLF001 — the state under test, read once
    try:
        keys, lanes = [], []
        for s, t in enumerate(store.tables):
            k, slots = t.entries()
            keys.extend(k)
            lanes.append(np.stack([np.full(len(k), s, np.int32), np.asarray(slots, np.int32)]))
        if keys:
            rows = buckets.cols_to_rows(*store._gather_cols(  # noqa: SLF001
                np.concatenate(lanes, axis=1)))
            table = np.stack([np.asarray(getattr(rows, f), np.int64) for f in ROW_FIELDS],
                             axis=1)
            for i, k in enumerate(keys):
                if not k.startswith("__warmup__"):
                    out[k] = table[i]
    finally:
        store._unlock_drained()  # noqa: SLF001
    return out


@dataclass
class Window:
    """What the measured window saw, for the metrics."""

    seconds: float
    t0: float
    t1: float
    latencies_s: np.ndarray
    lanes: int  # lanes of the requests answered in the window
    requests: int
    failed: int
    rows: int  # distinct keys of each answered request, summed
    wide_lanes: int  # lanes whose answer needs 64-bit words
    stages: Dict[str, tuple] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    queue_wait_s: List[float] = field(default_factory=list)
    trace: Optional[dict] = None
    setup_s: float = 0.0
    clock_moves: int = 0  # epochs begun inside the window
    over_lanes: int = 0  # lanes of the whole run answered over the limit


@dataclass
class Check:
    """The numbers compared, each with its limit."""

    numbers: Dict[str, tuple]

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.numbers.values())


ANSWER_FIELDS = ("status", "limit", "remaining", "reset_time")


def answers_of(recs: List[Sent]) -> "tuple[dict, np.ndarray]":
    """The program's answers in lane order, and a mask of lanes that
    came back with an error or not at all."""
    parts = {f: [] for f in ANSWER_FIELDS}
    bad = []
    for rec in recs:
        res = rec.result
        if res is None or rec.error is not None:
            n = len(rec.lanes)
            for f in parts:
                parts[f].append(np.zeros(n, np.int64))
            bad.append(np.ones(n, bool))
            continue
        b = np.zeros(res.n, bool)
        cols = {f: np.array(getattr(res, f), np.int64) for f in parts}
        # Lanes answered outside the columns (a one-lane request takes
        # the service's per-request path) carry their own response.
        for i, r in res.overrides.items():
            if r.error:
                b[i] = True
            for f in parts:
                cols[f][i] = int(getattr(r, f))
        for f in parts:
            parts[f].append(cols[f])
        bad.append(b)
    cat = {f: (np.concatenate(v) if v else np.zeros(0, np.int64)) for f, v in parts.items()}
    return cat, (np.concatenate(bad) if bad else np.zeros(0, bool))


def wide_lane_count(hits, want_reset, mask) -> int:
    """Lanes under `mask` whose answer's reset delta needs 64 bits."""
    return int(((want_reset[mask] - hits.now[mask]) > (1 << 31) - 1).sum())


def host_cpu() -> dict:
    """This process's CPU seconds (every thread: time.process_time), its
    context switches, the machine's /proc/stat ticks, and each thread's
    CPU seconds by thread id (/proc/self/task)."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": time.process_time(), "user_s": ru.ru_utime, "sys_s": ru.ru_stime,
           "vcsw": ru.ru_nvcsw, "ivcsw": ru.ru_nivcsw, "threads": {},
           "names": {t.native_id: t.name for t in threading.enumerate()}}
    try:
        with open("/proc/stat") as f:
            t = [int(x) for x in f.readline().split()[1:9]]
        out["machine_ticks"], out["machine_idle"], out["steal"] = sum(t), t[3] + t[4], t[7]
        tck = os.sysconf("SC_CLK_TCK")
        for tid in os.listdir("/proc/self/task"):
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            out["threads"][int(tid)] = (int(fields[11]) + int(fields[12])) / tck
    except (OSError, ValueError, IndexError):
        pass
    return out


def log_host_cpu(log, a: dict, b: dict, seconds: float, lanes: int) -> None:
    """The window's host CPU between readings `a` and `b` of host_cpu."""
    d = {k: b[k] - a[k] for k in ("cpu_s", "user_s", "sys_s", "vcsw", "ivcsw")}
    log(f"[cpu] process {d['cpu_s']:.3f} s in {seconds:.3f} s "
        f"({d['cpu_s'] / seconds:.3f} cores; user {d['user_s']:.3f}, sys {d['sys_s']:.3f}); "
        f"{d['cpu_s'] / max(lanes, 1) * 1e6:.4f} s a million checks; context switches "
        f"voluntary {d['vcsw']}, involuntary {d['ivcsw']}")
    if "machine_ticks" in a and "machine_ticks" in b:
        all_t = max(b["machine_ticks"] - a["machine_ticks"], 1)
        log(f"[cpu] machine: busy {100 * (1 - (b['machine_idle'] - a['machine_idle']) / all_t):.2f}%"
            f" of {os.cpu_count()} cores, steal {100 * (b['steal'] - a['steal']) / all_t:.3f}%")
    names = {**a["names"], **b["names"]}
    per = sorted(((v - a["threads"].get(tid, 0.0), names.get(tid, f"native-{tid}"))
                  for tid, v in b.get("threads", {}).items()), reverse=True)
    log("[cpu] threads: " + ", ".join(f"{n} {s:.2f}" for s, n in per[:8]))


def _profiler(trace: bool, card: bool):
    """A torch.profiler over the window: on the card always, recording
    the card's operations (the end-to-end `device_ms_per_mcheck` reads
    them), and the host's too when tracing; None off the card."""
    if not card:
        return None
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA]
    if trace:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


# Calls into each layer that a traced window labels, so the trace can say
# what the host was doing while the card idled: (owner, method, label).
LAYER_CALLS = (
    ("svc", "_submit_columns", "service.submit"),
    ("batcher", "_flush_chunk", "service.flush"),
    ("store", "_prepare_columns", "pipeline.prepare"),
    ("store", "_stage_columns", "pipeline.stage"),
)


def annotate_layers(svc, spans: list):
    """Time the calls of LAYER_CALLS on this service's objects into
    `spans` as (label, start, end) on the perf_counter clock; returns the
    function that takes the wrappers away."""
    owners = {"svc": svc, "batcher": svc.columnar_batcher, "store": svc.store}
    undo = []
    for owner, attr, label in LAYER_CALLS:
        obj = owners[owner]
        fn = getattr(obj, attr, None)
        if fn is None:
            continue

        def wrapped(*a, _fn=fn, _label=label, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                spans.append((_label, t, time.perf_counter()))

        setattr(obj, attr, wrapped)
        undo.append((obj, attr))
    return lambda: [delattr(o, a) for o, a in undo]


def run_cell(cell: dict, config: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float, log=None):
    """One run: returns (Window, Check, memory peak bytes).  `device`
    None is the current CUDA device, "cpu" the plain versions (tests)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t_gen = time.perf_counter()
    traffic = traffic_mod.build(mix, seed)
    requests = Requests(traffic)
    log(f"[setup] requests built: {sum(len(t) for t in traffic.fill)} fill lanes, "
        f"{sum(len(t) for s in traffic.scripts for t in s)} script lanes over "
        f"{traffic.flows} flows, {time.perf_counter() - t_gen:.3f} s")
    t_svc = time.perf_counter()
    svc, clock = build_service(config, traffic.now_ms, device)
    log(f"[setup] service built and warmed: {time.perf_counter() - t_svc:.3f} s")
    try:
        t_fill = time.perf_counter()
        fill_sent = fill_table(svc, requests)
        log(f"[setup] key-table fill: {sum(len(t) for t in traffic.fill)} keys in "
            f"{time.perf_counter() - t_fill:.3f} s")
        flows = Flows(svc, clock, requests, int(mix["issuers"]))
        t_lead = time.perf_counter()
        flows.start()
        lead = int(mix["lead_requests"]) * traffic.flows
        if not flows.wait_answered(lead, DRAIN_S * 5):
            raise RuntimeError("the lead requests did not finish")
        t_led = time.perf_counter()
        store = svc.store
        from gubernator_tpu_torch import saturation

        saturation.reset()  # the window's own queue.wait samples
        # The set-up's objects (the prebuilt key strings above all) are
        # the benchmark's, not the service's: keep the collector from
        # scanning them again and again inside the window.
        gc.collect()
        gc.freeze()
        gc0 = [st["collections"] for st in gc.get_stats()]
        prof = _profiler(trace, device is None)
        spans, t_mark = [], 0.0
        if prof is not None:
            prof.start()
        if trace and prof is not None:
            import torch

            # A mark on both clocks: the trace's and perf_counter.
            with torch.profiler.record_function(trace_mod.MARK):
                t_mark = time.perf_counter()
            flows.spans = spans
            unannotate = annotate_layers(svc, spans)
        # The window opens here: the counts start with it.
        store.take_pipeline_stats()
        launches0, epochs0 = launches(), flows.epochs
        cpu0 = host_cpu()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        log(f"[setup] lead: {lead} requests in {t_led - t_lead:.3f} s; collector and profiler "
            f"{t0 - t_led:.3f} s; set-up {setup_s:.3f} s")
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        t1 = time.perf_counter()
        # The counts end with the window, before the profiler's stop.
        stages, _, _ = store.take_pipeline_stats()
        launches1, epochs1 = launches(), flows.epochs
        qw = queue_wait_samples()
        if prof is not None:
            prof.stop()
        cpu1 = host_cpu()
        gcs = [st["collections"] - c for st, c in zip(gc.get_stats(), gc0)]
        if trace and prof is not None:
            flows.spans = None
            unannotate()
        drained = flows.stop(DRAIN_S)
        gc.unfreeze()
        if device is None:
            import torch

            torch.cuda.synchronize()
            peak = int(torch.cuda.max_memory_allocated())
        else:
            peak = 0
        state = read_state(store)
    finally:
        svc.close()
    trace_out = None
    if prof is not None:
        import tempfile

        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            trace_out = trace_mod.reduce(trace_mod.load(path), t1 - t0, spans, t_mark)
        finally:
            os.remove(path)

    recs = list(fill_sent) + [r for rs in flows.sent for r in rs]
    for rec in recs:
        rec.lanes = traffic.ids(rec.flow, rec.index)
    hits = traffic_mod.reference_hits(traffic, [(r.flow, r.index) for r in recs])
    got, bad = answers_of(recs)
    t_ref = time.perf_counter()
    want = reference.evaluate(hits)
    numbers = compare_answers(traffic, hits, got, bad, state, want)
    numbers["requests_unanswered"] = (0 if drained else
                                      sum(1 for r in recs if r.result is None
                                          and r.error is None), 0)
    log(f"[check] reference over {len(hits.key)} lanes: {time.perf_counter() - t_ref:.3f} s; "
        f"lanes over the limit {int((want.status == reference.OVER).sum())}, "
        f"clock moves {flows.epochs} ({epochs1 - epochs0} in the window)")

    # The window: requests answered in [t0, t1].
    lane_at, n_lanes, lat, rows, failed, requests_n = 0, 0, [], 0, 0, 0
    in_window = np.zeros(len(hits.key), bool)
    for rec in recs:
        n = len(rec.lanes)
        if rec.flow >= 0 and t0 <= rec.t_done <= t1:
            requests_n += 1
            lat.append(rec.t_done - rec.t_sent)
            ok = rec.error is None and rec.result is not None
            if ok and not any(r.error for r in rec.result.overrides.values()):
                n_lanes += n
                rows += len(np.unique(rec.lanes))
                in_window[lane_at:lane_at + n] = True
            else:
                failed += 1
        lane_at += n
    wide = wide_lane_count(hits, want.reset_time, in_window)
    done_t = np.array([r.t_done for r in recs if r.flow >= 0 and t0 <= r.t_done <= t1])
    slices = np.histogram(done_t, bins=max(int(round((t1 - t0) / 5)), 1), range=(t0, t1))[0]
    log(f"[diag] requests a 5 s slice: {slices.tolist()}")
    prep = stages.get("prepare", (0, 0.0, 0.0))
    log_host_cpu(log, cpu0, cpu1, t1 - t0, n_lanes)
    log(f"[diag] flushes {prep[0]}, lanes a flush {n_lanes / max(prep[0], 1):.1f}, prepare "
        f"{prep[1]:.3f} s, gc collections by generation {gcs}")
    window = Window(
        seconds=t1 - t0, t0=t0, t1=t1, latencies_s=np.asarray(lat), lanes=n_lanes,
        requests=requests_n, failed=failed, rows=rows, wide_lanes=wide, stages=stages,
        launches={k: launches1[k] - launches0.get(k, 0) for k in launches1},
        queue_wait_s=qw, trace=trace_out, setup_s=setup_s, clock_moves=epochs1 - epochs0,
        over_lanes=int((want.status == reference.OVER).sum()))
    return window, Check(numbers), peak


def compare_answers(traffic, hits, got, bad, state, want) -> Dict[str, tuple]:
    """The numbers compared, each with its limit: lanes where the answers
    `got` (or their error mask `bad`) differ from the reference's `want`,
    and keys whose row in `state` ({hash key: row}) differs from the
    reference's final state, or that the reference holds and `state`
    lacks."""
    diff = bad.copy()
    for f in ANSWER_FIELDS:
        diff |= got[f] != getattr(want, f)
    name = traffic.params["name"]
    st = want.state
    keys_wrong = seen = 0
    for k, row in state.items():
        pre, _, raw = k.rpartition("_")
        i = int(raw) if pre == name and raw.isdigit() else -1
        if not 0 <= i < len(st["exists"]) or not st["exists"][i]:
            keys_wrong += 1
            continue
        seen += 1
        ref = [int(st[f][i]) for f in reference.STATE_FIELDS[1:]]
        if [int(x) for x in row] != ref:
            keys_wrong += 1
    live = int(st["exists"][np.unique(hits.key)].sum())
    return {"lanes_wrong": (int(diff.sum()), 0), "keys_wrong": (keys_wrong, 0),
            "keys_missing": (live - seen, 0)}
