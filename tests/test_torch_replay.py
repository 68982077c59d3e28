"""Incident replay and the scripts' port-side entry points, against JAX.

* The acceptance oracle of tests/test_blackbox.py on both packages: a
  seeded FaultPlan DUPLICATE on a live two-node cluster (port nodes on
  the plain versions, or JAX nodes) trips forward_conservation, whose
  auto-dump writes a bundle.  The port's replay (scripts/torch_replay.py
  on the CPU) and the JAX replay (scripts/replay.py) of that bundle give
  byte-identical reports, twice each, and both reproduce the violation;
  `--to-test` emits a module that compiles.
* The replay's CLI: the JAX script's output and exit codes; `--smoke`.
* A ring set empty answers as a JAX node's does ("pool is empty"): the
  replay's service is one.
* scripts/torch_check_metrics_parity.py against the JAX script.
* The soak smoke's status invariants on a port cluster (slow, as the
  JAX twin).

Every wait and join has a bound.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from gubernator_tpu import blackbox as jbb
from gubernator_tpu import faults as jfaults
from gubernator_tpu import gateway as jgw
from gubernator_tpu import tracing as jtracing
from gubernator_tpu import wire as jwire
from gubernator_tpu.cluster import Cluster as JCluster
from gubernator_tpu.config import BehaviorConfig as JBehaviors
from gubernator_tpu.service import ServiceConfig as JConfig
from gubernator_tpu.service import V1Service as JService
from gubernator_tpu.types import RateLimitRequest as JRequest
from gubernator_tpu.types import GetRateLimitsRequest as JGetRequest
from gubernator_tpu.utils.clock import Clock
from gubernator_tpu_torch import blackbox as tbb
from gubernator_tpu_torch import faults as tfaults
from gubernator_tpu_torch import gateway as tgw
from gubernator_tpu_torch import tracing as ttracing
from gubernator_tpu_torch.cluster import Cluster as TCluster
from gubernator_tpu_torch.config import BehaviorConfig as TBehaviors
from gubernator_tpu_torch.service import ServiceConfig as TConfig
from gubernator_tpu_torch.service import V1Service as TService
from gubernator_tpu_torch.types import GetRateLimitsRequest as TGetRequest
from gubernator_tpu_torch.types import RateLimitRequest as TRequest
from tests.test_torch_blackbox import _script, _wait_bundles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
NOW = 1_573_430_400_000
TIMEOUT = 30.0


@pytest.fixture(autouse=True)
def _clean():
    for tr, bb, fl in ((ttracing, tbb, tfaults), (jtracing, jbb, jfaults)):
        tr.reset()
        bb.force_disable(False)
        bb.set_enabled(True)
        fl.uninstall()
    yield
    for tr, bb, fl in ((ttracing, tbb, tfaults), (jtracing, jbb, jfaults)):
        tr.reset()
        bb.force_disable(False)
        fl.uninstall()


def _dump(report) -> str:
    return json.dumps(report, sort_keys=True)


def _violation_bundle(bbmod, path, timeout_s=30.0):
    """The first bundle under `path` whose triggers list audit-violation."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        for e in bbmod.list_bundles(path):
            b = os.path.join(path, e)
            try:
                m = json.loads(open(os.path.join(b, "manifest.json"), "rb").read())
            except OSError:
                continue
            if "audit-violation" in [t["kind"] for t in m["triggers"]]:
                return b
        time.sleep(0.02)
    raise AssertionError(f"no audit-violation bundle under {path}: {bbmod.list_bundles(path)}")


# ---------------------------------------------------------------------
# The seeded incident on either package's cluster
# ---------------------------------------------------------------------
def _jax_cluster(n):
    """JAX Cluster.start(n) without the warmup compiles (its daemons'
    programs compile at their first use instead)."""
    from gubernator_tpu.cluster import fast_test_behaviors
    from gubernator_tpu.config import DaemonConfig
    from gubernator_tpu.daemon import Daemon

    cl = JCluster()
    for _ in range(n):
        conf = DaemonConfig(listen_address="127.0.0.1:0", grpc_listen_address="127.0.0.1:0",
                            cache_size=4096, global_cache_size=256,
                            behaviors=fast_test_behaviors(), peer_discovery_type="static")
        conf.warmup_shapes = []
        cl.daemons.append(Daemon(conf).start())
    cl.peers = [d.peer_info for d in cl.daemons]
    for d in cl.daemons:
        d.set_peers(cl.peers)
    return cl


def _incident(kind, tmp_path):
    """tests/test_blackbox.py's scenario: FaultPlan(seed=11) duplicates
    every GetPeerRateLimits, the auditor is armed, node 0 forwards a
    probe of hits 3; returns (node 0's bundle, node 1's manual bundle,
    the manual POST's status)."""
    if kind == "torch":
        cl, faults, bbmod, gw = TCluster().start(2, device="cpu"), tfaults, tbb, tgw
        Req, GetReq, tracing = TRequest, TGetRequest, ttracing
    else:
        cl, faults, bbmod, gw = _jax_cluster(2), jfaults, jbb, jgw
        Req, GetReq, tracing = JRequest, JGetRequest, jtracing
    plan = faults.FaultPlan(seed=11)
    plan.duplicate(op="GetPeerRateLimits")
    try:
        for i, d in enumerate(cl.daemons):
            # Node 1 gets its directory at the manual POST: the cluster's
            # nodes share the process's default recorder, whose triggers
            # reach every box.
            d.service.blackbox.path = str(tmp_path / f"{kind}-d{i}") if i == 0 else ""
            # No rate limit: the DUPLICATE's "fault" trigger may write a
            # bundle before the audit runs (a slow forward on a loaded
            # box); the violation then writes its own.
            d.service.blackbox.coalesce_s = 0.05
            d.service.blackbox.min_interval_s = 0.0
        svc0 = cl.daemons[0].service
        # This thread checks as node 0's audit thread does: its events
        # go to node 0's recorder (and so to node 0's box).
        tracing.bind_recorder(svc0.recorder)
        auditor = svc0.auditor
        auditor.arm()
        auditor.check_now()  # the seed pass
        faults.install(plan)
        me = svc0.advertise_address
        cand = [hashlib.md5(str(i).encode()).hexdigest() for i in range(64)]
        reqs = [Req(name="bb", unique_key=uk, hits=3, limit=1000, duration=60_000)
                for uk in cand
                if svc0.get_peer(Req(name="bb", unique_key=uk).hash_key()).info.grpc_address != me]
        assert reqs, "no remotely-owned keys in the probe range"
        svc0.get_rate_limits(GetReq(requests=reqs))
        found = auditor.check_now()
        assert "forward_conservation" in [v["invariant"] for v in found]
        faults.uninstall()
        bundle = _violation_bundle(bbmod, str(tmp_path / f"{kind}-d0"))
        svc1 = cl.daemons[1].service
        svc1.blackbox.coalesce_s = 0.02  # manual triggers skip the rate limit
        svc1.blackbox.path = str(tmp_path / f"{kind}-d1")
        st, _, _ = gw.handle_request(svc1, "POST", "/debug/incident", b'{"reason": "peer side"}')
        manual = _wait_bundles(bbmod, str(tmp_path / f"{kind}-d1"), 1)[-1]
        return bundle, manual, st
    finally:
        tracing.bind_recorder(None)
        faults.uninstall()
        cl.stop()


@pytest.mark.parametrize("kind", ["torch", "jax"])
def test_seeded_incident_replays_alike_across_packages(tmp_path, capsys, kind):
    bundle, manual, st = _incident(kind, tmp_path)
    assert st == 202
    for b in (bundle, manual):
        for fsck in ("torch_blackbox_fsck", "blackbox_fsck"):
            assert _script(fsck).main([b]) == 0
    capsys.readouterr()
    manifest = json.loads(open(os.path.join(bundle, "manifest.json"), "rb").read())
    assert "audit-violation" in [t["kind"] for t in manifest["triggers"]], manifest["triggers"]
    assert "manual" in [t["kind"] for t in json.loads(open(os.path.join(
        manual, "manifest.json"), "rb").read())["triggers"]]
    # The duplicated delivery is in the capture, as the same frames for
    # either loader.
    frames = tbb.load_bundle(bundle).frames["peer"]
    assert [r[2:] for r in frames] == [r[2:] for r in jbb.load_bundle(bundle).frames["peer"]]
    peer_out = [r[5] for r in frames if r[2] == "out"]
    assert any(a == b for a, b in zip(peer_out, peer_out[1:])), "no duplicated forward frame"

    t_replay, j_replay = _script("torch_replay"), _script("replay")
    port = [t_replay.replay_bundle(bundle, device="cpu") for _ in range(2)]
    ref = [j_replay.replay_bundle(bundle) for _ in range(2)]
    assert _dump(port[0]) == _dump(port[1]) == _dump(ref[0]) == _dump(ref[1])
    first = port[0]
    assert first["violations"].get("forward_conservation", 0) >= 1
    assert first["bundleViolations"].get("forward_conservation", 0) >= 1
    assert first["reproducesBundleViolations"] is True
    # The peer side's bundle replays alike too (its inbound forwards).
    assert _dump(t_replay.replay_bundle(manual, device="cpu")) == _dump(
        j_replay.replay_bundle(manual))
    # --to-test: the emitted regression file is a valid pytest module
    # pinned to this bundle.
    out = tmp_path / "test_incident_regression.py"
    t_replay.emit_test(bundle, str(out), device="cpu")
    src = out.read_text()
    compile(src, str(out), "exec")
    assert "def test_" in src and os.path.basename(bundle) in src and "'cpu'" in src


def _synthetic_bundle(path, dup=True):
    """The --smoke incident: an ingress frame and a forward delivered
    twice (the DUPLICATE signature)."""
    from gubernator_tpu_torch import wire

    bb = tbb.BlackBox(service=None, path=str(path), budget_mb=4)
    one = lambda n: np.full(1, n, np.int64)  # noqa: E731
    bb.tap("in", "", wire.encode_ingress_frame((
        ["smoke"], ["k1"], np.zeros(1, np.int32), np.zeros(1, np.int32), one(1), one(10),
        one(60_000))))
    bb.tap("in", "", wire.encode_columns_frame((
        ["smoke"], ["k3"], np.zeros(1, np.int32), np.zeros(1, np.int32), one(2), one(10),
        one(60_000))))
    forward = wire.encode_columns_frame((
        ["smoke"], ["k2"], np.zeros(1, np.int32), np.zeros(1, np.int32), one(3), one(10),
        one(60_000)))
    bb.tap("out", "peer-b", forward)
    if dup:
        bb.tap("out", "peer-b", forward)
    out = bb.write_bundle([{"kind": "manual", "wallNs": 1, "monoNs": 1, "fields": {}}])
    bb.close()
    return out


def test_replay_cli_matches_jax(tmp_path, capsys):
    bundle = _synthetic_bundle(tmp_path / "bb")
    runs = {}
    for name, extra in (("torch_replay", ["--device", "cpu"]), ("replay", [])):
        out = []
        for argv in ([bundle, "--twice", "--json"], [bundle], [bundle, "--pace", "original"],
                     [str(tmp_path / "nope")]):
            rc = _script(name).main(argv + extra)
            o = capsys.readouterr()
            # the script's own words; the services' log lines carry
            # clock stamps and a rate limit
            said = [ln for ln in o.err.splitlines() if ln.startswith("replay")]
            out.append((rc, o.out, said))
        runs[name] = out
    assert runs["torch_replay"] == runs["replay"]
    assert [r[0] for r in runs["replay"]] == [0, 0, 0, 2]
    report = json.loads(runs["replay"][0][1])
    assert report["violations"].get("forward_conservation", 0) >= 1
    assert report["driven"] == {"public": 1, "peer": 1}
    with open(os.path.join(bundle, "wire-peer.gfl"), "r+b") as f:
        f.truncate(20)
    for name, extra in (("torch_replay", ["--device", "cpu"]), ("replay", [])):
        assert _script(name).main([bundle] + extra) == 1
    capsys.readouterr()


def test_replay_smoke_exits_zero():
    out = subprocess.run([sys.executable, os.path.join(SCRIPTS, "torch_replay.py"), "--smoke",
                          "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "replay-smoke: OK" in out.stdout


def test_replay_on_cuda_never_falls_back(tmp_path):
    """The replay's default device is the card; without one it raises
    instead of running on the CPU."""
    bundle = _synthetic_bundle(tmp_path / "bb", dup=False)
    replay = _script("torch_replay")
    if torch.cuda.is_available():
        assert _dump(replay.replay_bundle(bundle)) == _dump(
            replay.replay_bundle(bundle, device="cpu"))
    else:
        # (a CPU-only torch build raises AssertionError at its first
        # CUDA call, others RuntimeError)
        for kw in ({}, {"device": "cuda"}):
            with pytest.raises((RuntimeError, AssertionError)):
                replay.replay_bundle(bundle, **kw)


# ---------------------------------------------------------------------
# A ring set empty (the replay's service) answers as on a JAX node
# ---------------------------------------------------------------------
def _frame(n, beh=0):
    rng = np.random.default_rng(n)
    return jwire.encode_ingress_frame((
        [f"n{i % 3}" for i in range(n)], [f"k{int(k)}" for k in rng.integers(0, 9, n)],
        rng.integers(0, 2, n).astype(np.int32), np.full(n, beh, np.int32),
        np.ones(n, np.int64), np.full(n, 10, np.int64), np.full(n, 60_000, np.int64)))


EMPTY_RING_REQUESTS = [
    ("json", b'{"requests":[{"name":"a","uniqueKey":"b","hits":1,"limit":5,"duration":1000},'
             b'{"name":"","uniqueKey":"c","hits":1,"limit":5,"duration":1000}]}'),
    ("json-one", b'{"requests":[{"name":"a","uniqueKey":"b","hits":1,"limit":5,"duration":1000}]}'),
    ("frame", _frame(12)),
    ("frame-global", _frame(6, beh=2)),
    ("frame-no-batching", _frame(5, beh=1)),
]


@pytest.mark.parametrize("edge", ["sync", "async"])
def test_empty_ring_answers_like_jax(edge):
    clock = Clock()
    clock.freeze(NOW)
    kw = dict(audit=False, blackbox=False, snapshot_interval_s=0.0, global_sync_wait_s=3600.0)
    js = JService(JConfig(cache_size=4096, clock=clock, behaviors=JBehaviors(**kw)))
    ts = TService(TConfig(cache_size=4096, clock=clock, behaviors=TBehaviors(**kw), device="cpu"))
    lone = TService(TConfig(cache_size=4096, clock=clock, behaviors=TBehaviors(**kw), device="cpu"))
    js.set_peers([])
    ts.set_peers([])
    try:
        for name, body in EMPTY_RING_REQUESTS:
            got = []
            for gw, svc in ((jgw, js), (tgw, ts), (tgw, lone)):
                if edge == "sync":
                    st, ct, out = gw.handle_request(svc, "POST", "/v1/GetRateLimits", body)
                else:
                    done, box = threading.Event(), []

                    def respond(*a, box=box, done=done):
                        box.append(a)
                        done.set()

                    gw.handle_request_async(svc, "POST", "/v1/GetRateLimits", body, respond)
                    assert done.wait(TIMEOUT), name
                    st, ct, out = box[0]
                got.append((st, ct, bytes(out)))
            assert got[0] == got[1], (name, got[0][2][:300], got[1][2][:300])
            assert b"pool is empty" in got[1][2] or name == "json" and b"cannot be empty" in got[1][2]
            # A service never given a ring owns every key: no such error.
            assert got[2][0] == 200 and b"pool is empty" not in got[2][2], name
        assert js.health_check().peer_count == ts.health_check().peer_count == 0
        assert lone.health_check().peer_count == 1
    finally:
        for s in (js, ts, lone):
            s.close()


# ---------------------------------------------------------------------
# scripts/torch_check_metrics_parity.py
# ---------------------------------------------------------------------
@pytest.mark.parametrize("case", ["ok", "missing", "unexpected"])
def test_metrics_parity_script_matches_jax(capsys, case):
    out = []
    for name in ("torch_check_metrics_parity", "check_metrics_parity"):
        mod = _script(name)
        if case == "missing":
            mod.EXTENSIONS = mod.EXTENSIONS | {"gubernator_not_exported"}
            mod.GOLDEN = mod.REFERENCE_PARITY | mod.EXTENSIONS
        elif case == "unexpected":
            mod.EXTENSIONS = mod.EXTENSIONS - {"gubernator_blackbox_frames"}
            mod.GOLDEN = mod.REFERENCE_PARITY | mod.EXTENSIONS
        rc = mod.main()
        out.append((rc, capsys.readouterr().out))
    assert out[0] == out[1]
    assert out[0][0] == (0 if case == "ok" else 1), out[0]
    t, j = (_script(n) for n in ("torch_check_metrics_parity", "check_metrics_parity"))
    assert (t.REFERENCE_PARITY, t.EXTENSIONS) == (j.REFERENCE_PARITY, j.EXTENSIONS)


# ---------------------------------------------------------------------
# The soak smoke on a port cluster (tests/test_soak_smoke.py's twin)
# ---------------------------------------------------------------------
def _fetch(addr, path):
    with urllib.request.urlopen(f"http://{addr}{path}", timeout=10) as r:
        return json.loads(r.read())


@pytest.mark.slow
def test_soak_smoke_status_invariants():
    from gubernator_tpu_torch.client import V1Client
    from gubernator_tpu_torch.cluster import fast_test_behaviors
    from gubernator_tpu_torch.types import Algorithm, Behavior

    shapes = [(1, 0), (1, int(Behavior.NO_BATCHING)), (50, 0), (200, 0),
              (4, int(Behavior.GLOBAL))]
    beh = fast_test_behaviors()
    beh.batch_timeout_s = 30.0
    beh.latency_target_ms = 30_000.0
    cl = TCluster().start_with(["", ""], behaviors=beh, device="cpu")
    daemons = list(cl.daemons)
    stop = threading.Event()
    lock = threading.Lock()
    stats = {"requests": 0, "errors": []}

    def worker(wid):
        client = V1Client(cl.daemons[wid % 2].gateway.address, timeout_s=60.0)
        i = 0
        while not stop.is_set():
            lanes, b = shapes[(wid + i) % len(shapes)]
            reqs = [TRequest(name="smoke", unique_key=f"w{wid % 3}k{(i + j) % 40}", hits=1,
                             limit=100_000_000, duration=120_000,
                             algorithm=(Algorithm.TOKEN_BUCKET if j % 2 == 0
                                        else Algorithm.LEAKY_BUCKET),
                             behavior=b)
                    for j in range(lanes)]
            try:
                resp = client.get_rate_limits(TGetRequest(requests=reqs))
                with lock:
                    stats["requests"] += 1
                    stats["errors"].extend([r.error for r in resp.responses if r.error][:2])
            except Exception as e:  # noqa: BLE001
                with lock:
                    stats["errors"].append(f"{type(e).__name__}: {e}")
            i += 1

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(6)]
    for t in threads:
        t.start()
    polls, last_evictions, violations = 0, {}, []
    try:
        t0 = time.time()
        while time.time() - t0 < 20:
            time.sleep(2.0)
            for d in cl.daemons:
                addr = d.gateway.address
                doc = _fetch(addr, "/debug/status")
                polls += 1
                h = doc["health"]
                if h["status"] != "healthy" or h["breakerOpenCount"]:
                    violations.append(f"{addr}: {h}")
                ing = doc["ingress"]
                if ing["shedLanes"] or (ing["capLanes"] and ing["queuedLanes"] > ing["capLanes"]):
                    violations.append(f"{addr}: ingress {ing}")
                occ = doc["occupancy"]
                if occ["used"] > occ["capacity"] or occ["evictions"] < last_evictions.get(addr, 0):
                    violations.append(f"{addr}: occupancy {occ}")
                last_evictions[addr] = occ["evictions"]
                assert doc["slo"]["enabled"] is True and "burn_rate_5m" in doc["slo"]
                assert doc["audit"]["enabled"] is True
                assert doc["blackbox"]["enabled"] is True
                if doc["audit"]["violationTotal"]:
                    violations.append(f"{addr}: audit {doc['audit']['violations']}")
            if violations:
                break
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        alive = [t.name for t in threads if t.is_alive()]
        lat = _fetch(cl.daemons[0].gateway.address, "/debug/latency")
        cl.stop()
    assert not alive, alive
    assert not violations, violations[:5]
    for d in daemons:
        assert d.service.auditor.checks > 0, "auditor thread never ran"
        assert d.service.auditor.check_now() == []
    assert polls >= 4 and stats["requests"] > 50
    assert not stats["errors"], stats["errors"][:5]
    assert "dispatch.launch" in lat["phases"] and "ingress.total" in lat["phases"]
