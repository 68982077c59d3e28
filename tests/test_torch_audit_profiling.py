"""The port's conservation audit (audit.py) and cost observatory
(profiling.py) against the JAX package's.

The same seeded traffic — JSON and GUBC kind-5 requests through the
gateway, the native ingress pump, the peer receive routes (columns,
transfer, a fenced transfer), a snapshot written at close and restored
at boot — goes through a JAX node and a port node on one frozen clock.
Afterwards the two conservation ledgers, the auditors' verdicts, the
tenant ledgers' counts and the hot-key sketches must be equal
(tolerance 0).  The time-based tenant shares (lane time, queue
residency) are wall-clock measurements and are not compared.
"""

import json
import socket

import numpy as np
import pytest

from gubernator_tpu import audit as jaudit
from gubernator_tpu import gateway as jgw
from gubernator_tpu import profiling as jprof
from gubernator_tpu import wire as jwire
from gubernator_tpu.config import BehaviorConfig as JBehaviors
from gubernator_tpu.reshard import TransferColumns
from gubernator_tpu.service import ServiceConfig as JConfig
from gubernator_tpu.service import V1Service as JService
from gubernator_tpu.types import PeerInfo as JPeer
from gubernator_tpu.utils.clock import Clock
from gubernator_tpu_torch import audit as taudit
from gubernator_tpu_torch import gateway as tgw
from gubernator_tpu_torch import profiling as tprof
from gubernator_tpu_torch.config import BehaviorConfig as TBehaviors
from gubernator_tpu_torch.service import ServiceConfig as TConfig
from gubernator_tpu_torch.service import V1Service as TService
from gubernator_tpu_torch.types import PeerInfo as TPeer

NOW = 1_573_430_400_000
ADDR = "127.0.0.1:9999"
TIME_KEYS = ("laneTimeS", "queueS", "laneTimeSPerLane", "queueSPerLane")


@pytest.fixture(autouse=True)
def _unsampled():
    """The native fast lane turns off while tracing samples (both
    packages' module-global rate): hold it at 0 here."""
    from gubernator_tpu import tracing as jtracing
    from gubernator_tpu_torch import tracing as ttracing

    jtracing.set_sample_rate(0.0)
    ttracing.set_sample_rate(0.0)
    yield


def _nodes(clock, snapshot_dir):
    # A 50 ms window: a request's GLOBAL lanes (the dataclass router)
    # then finish before its batched lanes' window flushes on both
    # services, so a key in both groups answers in one order on both
    # (with the 500 µs default that order follows the host's load).
    kw = dict(global_sync_wait_s=3600.0, audit_interval_s=3600.0, tenant_topk=4,
              batch_wait_s=0.05)
    js = JService(JConfig(cache_size=2048, clock=clock, advertise_address=ADDR,
                          behaviors=JBehaviors(**kw),
                          snapshot_path=str(snapshot_dir / "jax.snap")))
    ts = TService(TConfig(cache_size=2048, clock=clock, advertise_address=ADDR,
                          behaviors=TBehaviors(**kw), device="cpu",
                          snapshot_path=str(snapshot_dir / "port.snap")))
    js.set_peers([JPeer(grpc_address=ADDR, is_owner=True)])
    ts.set_peers([TPeer(grpc_address=ADDR, is_owner=True)])
    return js, ts


def _cols(rng, n, names=("acct", "api", "web", "cdn", "db", "mq")):
    return ([str(rng.choice(names)) for _ in range(n)],
            [f"k{int(k)}" for k in rng.zipf(1.4, n) % 60],
            rng.integers(0, 2, n).astype(np.int32),
            rng.choice([0, 0, 0, 1, 2], n).astype(np.int32),
            rng.integers(0, 5, n).astype(np.int64),
            rng.choice([3, 10, 100], n).astype(np.int64),
            np.full(n, 60_000, np.int64))


def _traffic(seed):
    """[(path, body)] of JSON, frames and peer frames."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(12):
        cols = _cols(rng, int(rng.choice([1, 4, 30])))
        if k % 3 == 0:
            out.append(("/v1/GetRateLimits", json.dumps(
                jwire.peer_columns_to_classic_json(cols)).encode()))
        elif k % 3 == 1:
            out.append(("/v1/GetRateLimits", jwire.encode_ingress_frame(cols)))
        else:
            cols[3][:] = 0
            out.append(("/v1/peer.GetPeerRateLimits", jwire.encode_columns_frame(cols)))
    return out


def _transfer(n, ring_hash):
    return TransferColumns(
        keys=[f"acct_t{i}" for i in range(n)], algorithm=np.zeros(n, np.int32),
        status=np.zeros(n, np.int32), limit=np.full(n, 50, np.int64),
        remaining=np.full(n, 20, np.int64), duration=np.full(n, 60_000, np.int64),
        stamp=np.full(n, NOW, np.int64), expire_at=np.full(n, NOW + 60_000, np.int64),
        ring_hash=ring_hash)


def _pump_frames(gw, svc, frames):
    srv = gw.NativeGatewayServer(svc, "127.0.0.1:0")
    pump = gw.NativeIngressPump(svc).start()
    pump.update_ring()
    srv.pump = pump
    srv.start()
    try:
        host, _, port = srv.address.partition(":")
        with socket.create_connection((host, int(port)), timeout=30) as s:
            for body in frames:
                s.sendall(b"POST /v1/GetRateLimits HTTP/1.1\r\nHost: x\r\n"
                          + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
                data = b""
                while b"\r\n\r\n" not in data:
                    data += s.recv(65536)
                head, _, rest = data.partition(b"\r\n\r\n")
                clen = int([ln for ln in head.split(b"\r\n")
                            if ln.lower().startswith(b"content-length")][0].split(b":")[1])
                while len(rest) < clen:
                    rest += s.recv(65536)
                assert head.split(b" ")[1] == b"200"
        assert pump.stats()["frames"] == len(frames)
    finally:
        srv.close()


def _tenants(doc):
    def strip(row):
        return {k: v for k, v in row.items() if k not in TIME_KEYS}

    return {**{k: v for k, v in doc.items() if k not in TIME_KEYS},
            "topk": [strip(r) for r in doc["topk"]], "other": strip(doc["other"]),
            "totals": strip(doc["totals"])}


@pytest.mark.parametrize("seed", [0, 1])
def test_ledgers_after_a_seeded_run_equal_jax(seed, tmp_path):
    clock = Clock()
    clock.freeze(NOW)
    jaudit.reset()
    taudit.reset()
    js, ts = _nodes(clock, tmp_path)
    try:
        for path, body in _traffic(seed):
            a = jgw.handle_request(js, "POST", path, body)
            b = tgw.handle_request(ts, "POST", path, body)
            assert a == b, path
            clock.advance(400)
        raw = jwire.encode_transfer_frame(_transfer(25, js.ring_hash))
        fenced = jwire.encode_transfer_frame(_transfer(5, js.ring_hash ^ 3))
        for body in (raw, fenced):
            assert (jgw.handle_request(js, "POST", "/v1/peer.TransferOwnership", body)
                    == tgw.handle_request(ts, "POST", "/v1/peer.TransferOwnership", body))
        # Frames without slow lanes: every one takes the native fast lane.
        rng = np.random.default_rng(seed + 50)
        frames = [jwire.encode_ingress_frame(c[:3] + (np.zeros(20, np.int32),) + c[4:])
                  for c in (_cols(rng, 20) for _ in range(3))]
        _pump_frames(jgw, js, frames)
        _pump_frames(tgw, ts, frames)
        assert taudit.ledger_snapshot() == jaudit.ledger_snapshot()
        assert _tenants(ts.tenants.snapshot()) == _tenants(js.tenants.snapshot())
        assert ts.hotkeys.snapshot() == js.hotkeys.snapshot()
        assert ts.auditor.check_now() == js.auditor.check_now() == []
        assert ts.auditor.check_now() == js.auditor.check_now() == []
        ja, ta = js.auditor.snapshot(), ts.auditor.snapshot()
        assert ta["ledger"] == ja["ledger"] and ta["violations"] == ja["violations"] == {}
        assert ta["invariants"] == ja["invariants"] and ta["checks"] == ja["checks"]
    finally:
        js.close()
        ts.close()
    # The close wrote a snapshot on both; a boot restores it.
    assert taudit.ledger_snapshot() == jaudit.ledger_snapshot()
    assert taudit.ledger_snapshot()["snapshot_saved_lanes"] > 0
    js, ts = _nodes(clock, tmp_path)
    try:
        assert taudit.ledger_snapshot() == jaudit.ledger_snapshot()
        assert taudit.ledger_snapshot()["snapshot_committed_lanes"] > 0
    finally:
        js.close()
        ts.close()


def test_tenant_ledger_folds_equal_jax():
    """The ledger alone, fed the same column batches, requests and
    outcomes: rows, the `other` rollup and the totals agree, and
    conservation (rows + other == totals) holds."""
    from gubernator_tpu.service import ColumnarResult as JResult
    from gubernator_tpu.service import IngressColumns as JCols
    from gubernator_tpu_torch.service import ColumnarResult as TResult
    from gubernator_tpu_torch.service import IngressColumns as TCols

    rng = np.random.default_rng(7)
    jl, tl = jprof.TenantLedger(topk=3), tprof.TenantLedger(topk=3)
    names = [f"tenant{i}" for i in range(9)]
    for _ in range(20):
        cols = _cols(rng, int(rng.integers(1, 40)), names=names)
        kw = dict(names=cols[0], unique_keys=cols[1], algorithm=cols[2], behavior=cols[3],
                  hits=cols[4], limit=cols[5], duration=cols[6])
        jctx, tctx = jl.fold_admit(JCols(**kw)), tl.fold_admit(TCols(**kw))
        n = len(cols[0])
        status = rng.integers(0, 2, n).astype(np.int32)
        z = np.zeros(n, np.int64)
        jl.fold_outcome(jctx, JResult(n=n, status=status, limit=z, remaining=z, reset_time=z))
        tl.fold_outcome(tctx, TResult(n=n, status=status, limit=z, remaining=z, reset_time=z))
        shed = np.nonzero(rng.random(n) < 0.1)[0]
        jl.fold_shed(jctx, shed)
        tl.fold_shed(tctx, shed)
        nm = str(rng.choice(names))
        jl.fold_one(nm, 3, 40)
        tl.fold_one(nm, 3, 40)
    jd, td = _tenants(jl.snapshot()), _tenants(tl.snapshot())
    assert td == jd
    for stat in ("hits", "lanes", "overLimit", "shed", "ingressBytes"):
        assert sum(r[stat] for r in td["topk"]) + td["other"][stat] == td["totals"][stat]


def test_profiler_scopes_cover_the_dispatch_stages():
    """The port's pipeline runs each dispatch stage inside
    profiling.scope, so the sampler attributes its samples."""
    seen = set()
    real = tprof.scope

    def spy(tag):
        seen.add(tag)
        return real(tag)

    clock = Clock()
    clock.freeze(NOW)
    ts = TService(TConfig(cache_size=1024, clock=clock, device="cpu",
                          behaviors=TBehaviors(global_sync_wait_s=3600.0)))
    tprof.scope = spy
    try:
        body = json.dumps({"requests": [{"name": "a", "uniqueKey": f"k{i}", "hits": "1",
                                         "limit": "5", "duration": "1000"}
                                        for i in range(8)]}).encode()
        assert tgw.handle_request(ts, "POST", "/v1/GetRateLimits", body)[0] == 200
    finally:
        tprof.scope = real
        ts.close()
    assert {"ingress.parse", "response.encode", "dispatch.prepare", "dispatch.stage",
            "dispatch.launch", "dispatch.fetch", "dispatch.commit"} <= seen


def test_telemetry_counts_builds_and_first_launches(tmp_path):
    """Device telemetry: a library build and each kernel's first launch
    count as compile events; after mark_steady() they are steady-state
    recompiles.  A CPU store has no device memory to sample."""
    from gubernator_tpu_torch import telemetry
    from gubernator_tpu_torch.ops import _kernels
    from gubernator_tpu_torch.utils import build

    telemetry.reset()
    saved = dict(_kernels.LAUNCHES)
    try:
        _kernels._finish("gather_rows", 0)
        _kernels._finish("gather_rows", 0)
        snap = telemetry.compile_snapshot()
        assert snap["first-launch:gather_rows"]["count"] == 1
        telemetry.mark_steady()
        _kernels._finish("write_rows", 0)
        assert telemetry.steady_recompile_count() == 1
        src = tmp_path / "probe.cpp"
        src.write_text(f'extern "C" int probe_{id(src) % 997}() {{ return 7; }}\n')
        build.build_library("telemetry_probe", [str(src)],
                            ["g++", "-O0", "-shared", "-fPIC"])
        snap = telemetry.snapshot()
        assert snap["compiles"]["build:telemetry_probe"]["count"] == 1
        assert snap["compileTotal"] == 3 and snap["steadyRecompiles"] == 2
        with telemetry.program("mesh:dispatch:solo:narrow"):
            pass
        assert telemetry.take_exec_stats()["mesh:dispatch:solo:narrow"][0] == 1
        assert telemetry.device_snapshot("cpu") == [] and telemetry.device_snapshot(None) == []
    finally:
        _kernels.LAUNCHES.update(saved)
        telemetry.reset()


def test_queue_wait_pool_weighs_submissions_by_lanes():
    """The columnar batcher feeds the queue-residency pool one entry a
    submission, weighted by its lanes, as the JAX batcher does: a
    1-lane and a 1,000-lane submission put 1,001 lanes in the pool."""
    clock = Clock()
    clock.freeze(NOW)
    kw = dict(global_sync_wait_s=3600.0, express=False, batch_wait_s=0.05)
    js = JService(JConfig(cache_size=4096, clock=clock, behaviors=JBehaviors(**kw)))
    ts = TService(TConfig(cache_size=4096, clock=clock, device="cpu",
                          behaviors=TBehaviors(**kw)))
    rng = np.random.default_rng(3)
    subs = []
    for n in (1, 1000, 7):
        names, keys, algo, _, *rest = _cols(rng, n)
        subs.append(([f"{a}_{b}" for a, b in zip(names, keys)], algo,
                     np.zeros(n, np.int32), *rest))
    try:
        for svc, prof in ((js, jprof), (ts, tprof)):
            prof.reset()
            futs = [svc.columnar_batcher.submit(*c, None, None) for c in subs]
            for f in futs:
                f.result(timeout=60)[0].result()
            assert prof.queue_time.lanes == sum(len(c[0]) for c in subs) == 1008
    finally:
        js.close()
        ts.close()
