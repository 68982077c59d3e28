"""The port's daemon (gubernator_tpu_torch/daemon.py) against the JAX
package's, byte for byte.

A port daemon (`GUBER_TORCH_DEVICE=cpu`, the kernels' plain versions)
and a JAX daemon (the CPU mesh of tests/conftest.py) are built from the
same GUBER_* environment with `setup_daemon_config`, hold one frozen
clock (the `Daemon(conf, clock=)` seam), advertise the same address and
discover themselves statically.  They take the same seeded requests
over real sockets: JSON bodies, GUBC kind-5 and kind-1 frames and
HealthCheck over HTTP (the native edge with its ingress pump, or the
stdlib gateway, plain or over TLS with self-signed certificates), and
V1 and PeersV1 over gRPC, plain and over TLS, as serialized bytes.
Every answer must be the same bytes (tolerance 0).  Snapshots written
at close() restore into the other package's daemon, a file pool picks
up a rewritten peers file naming the node itself, and the server binary
starts, answers and stops on SIGTERM as a subprocess.

Every socket operation, wait and join has a bound.
"""

import http.client
import json
import os
import shutil
import signal
import ssl
import subprocess
import sys
import threading
import time

import grpc
import numpy as np
import pytest

from gubernator_tpu import config as jcfg
from gubernator_tpu import wire as jwire
from gubernator_tpu.daemon import Daemon as JDaemon
from gubernator_tpu.parallel.global_mgr import GlobalsColumns
from gubernator_tpu.proto import gubernator_pb2 as pb
from gubernator_tpu.reshard import TransferColumns
from gubernator_tpu.types import GetRateLimitsRequest, RateLimitRequest
from gubernator_tpu.utils.clock import Clock
from gubernator_tpu_torch import config as tcfg
from gubernator_tpu_torch.daemon import Daemon as TDaemon

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = 1_573_430_400_000
ADDR = "127.0.0.1:9999"
G, NB, GREG = 2, 1, 4
TIMEOUT = 30.0
V1 = "/pb.gubernator.V1/"
PEERS = "/pb.gubernator.PeersV1/"


# ---------------------------------------------------------------------
# Two daemons, one clock
# ---------------------------------------------------------------------
def daemon_env(tmp_path, mode="native", **extra):
    env = {
        "GUBER_HTTP_ADDRESS": "127.0.0.1:0",
        "GUBER_GRPC_ADDRESS": "127.0.0.1:0",
        "GUBER_ADVERTISE_ADDRESS": ADDR,
        "GUBER_CACHE_SIZE": "4096",
        "GUBER_GLOBAL_SYNC_WAIT": "3600s",
        "GUBER_TRACE_SAMPLE": "0",
    }
    if mode == "native":
        env["GUBER_NATIVE_HTTP"] = "1"
    elif mode == "tls":
        env["GUBER_TLS_AUTO"] = "1"
    env.update(extra)
    return env


def start_pair(env_j, env_t=None, clock=None):
    """(JAX daemon, port daemon, clock): both from `setup_daemon_config`
    with no warmup shapes, on one frozen clock."""
    if clock is None:
        clock = Clock()
        clock.freeze(NOW)
    jconf = jcfg.setup_daemon_config(env=env_j)
    tconf = tcfg.setup_daemon_config(env={**(env_t or env_j), "GUBER_TORCH_DEVICE": "cpu"})
    jconf.warmup_shapes = []
    tconf.warmup_shapes = []
    jd = JDaemon(jconf, clock=clock).start()
    try:
        td = TDaemon(tconf, clock=clock).start()
    except BaseException:
        jd.close()
        raise
    return jd, td, clock


@pytest.fixture(autouse=True)
def _unsampled():
    """The daemons apply GUBER_TRACE_SAMPLE process-wide; leave both
    packages' rate at 0 for the next file."""
    yield
    from gubernator_tpu import tracing as jtracing
    from gubernator_tpu_torch import tracing as ttracing

    jtracing.set_sample_rate(0.0)
    ttracing.set_sample_rate(0.0)


# ---------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------
class Ends:
    """A daemon's HTTP and gRPC ends, with its CA under TLS."""

    def __init__(self, daemon):
        self.d = daemon
        tls = daemon.conf.tls
        self.ctx = None
        self.channel = None
        if tls is not None and tls.enabled:
            self.ctx = ssl.create_default_context(cafile=tls.ca_file)
            with open(tls.ca_file, "rb") as f:
                creds = grpc.ssl_channel_credentials(root_certificates=f.read())
            self.channel = grpc.secure_channel(daemon.grpc.address, creds)
        else:
            self.channel = grpc.insecure_channel(daemon.grpc.address)

    def http(self, path, raw=b"", method="POST", headers=None):
        host, _, port = self.d.gateway.address.rpartition(":")
        if self.ctx is not None:
            conn = http.client.HTTPSConnection(host, int(port), timeout=TIMEOUT,
                                               context=self.ctx)
        else:
            conn = http.client.HTTPConnection(host, int(port), timeout=TIMEOUT)
        try:
            conn.request(method, path, body=raw if method == "POST" else None,
                         headers=headers or {})
            r = conn.getresponse()
            return r.status, r.getheader("Content-Type"), r.read()
        finally:
            conn.close()

    def rpc(self, method, raw):
        try:
            return "ok", self.channel.unary_unary(method)(raw, timeout=TIMEOUT)
        except grpc.RpcError as e:
            return "error", e.code(), e.details()

    def close(self):
        self.channel.close()


def both_http(a, b, path, raw=b"", method="POST", what=""):
    x, y = a.http(path, raw, method), b.http(path, raw, method)
    assert x == y, (what or path, x[:2], y[:2], x[2][:300], y[2][:300])
    return y


def both_rpc(a, b, method, raw, what=""):
    x, y = a.rpc(method, raw), b.rpc(method, raw)
    assert x == y, (what or method, x, y)
    return y


# ---------------------------------------------------------------------
# Seeded traffic
# ---------------------------------------------------------------------
def _lane(rng, prefix="k"):
    d = {"name": str(rng.choice(["acct", "api"])),
         "uniqueKey": f"{prefix}{int(rng.integers(40))}",
         "hits": str(int(rng.integers(0, 4))), "limit": str(int(rng.choice([5, 20, 1000]))),
         "duration": str(int(rng.choice([2_000, 60_000]))),
         "algorithm": str(rng.choice(["TOKEN_BUCKET", "LEAKY_BUCKET"]))}
    r = rng.random()
    if r < 0.1:
        d["behavior"], d["uniqueKey"] = "GLOBAL", "g" + d["uniqueKey"]
    elif r < 0.18:
        d["behavior"] = NB
    elif r < 0.24:
        d["behavior"], d["duration"] = GREG, str(int(rng.choice([1, 2])))
    elif r < 0.27:
        d["uniqueKey"] = ""
    return d


def json_bodies(seed, steps=4, prefix="k"):
    rng = np.random.default_rng(seed)
    return [json.dumps({"requests": [_lane(rng, prefix) for _ in range(int(rng.choice([1, 4, 30])))]}
                       ).encode() for _ in range(steps)]


def frame_cols(seed, n, prefix="f", beh=0):
    rng = np.random.default_rng(seed)
    return ([str(rng.choice(["acct", "api"])) for _ in range(n)],
            [f"{prefix}{int(k)}" for k in rng.integers(0, 40, n)],
            rng.integers(0, 2, n).astype(np.int32), np.full(n, beh, np.int32),
            rng.integers(0, 4, n).astype(np.int64),
            rng.choice([5, 20, 1000], n).astype(np.int64), np.full(n, 60_000, np.int64))


def v1_request(seed, n, prefix="r"):
    rng = np.random.default_rng(seed)
    return GetRateLimitsRequest(requests=[
        RateLimitRequest(name="acct", unique_key=f"{prefix}{int(rng.integers(30))}",
                         hits=int(rng.integers(0, 3)), limit=10, duration=60_000,
                         algorithm=int(rng.integers(0, 2)))
        for _ in range(n)])


def exchange(jd, td, clock, seed=0, grpc_too=True):
    """The seeded traffic on both daemons; every answer compared.
    Returns the (HTTP, gRPC) requests sent, by method, for the metric
    counts."""
    a, b = Ends(jd), Ends(td)
    try:
        for k, raw in enumerate(json_bodies(seed)):
            both_http(a, b, "/v1/GetRateLimits", raw, what=f"json {k}")
            clock.advance(300)
        for k, n in enumerate((3, 50)):
            raw = jwire.encode_ingress_frame(frame_cols(seed + k, n))
            _, ctype, _ = both_http(a, b, "/v1/GetRateLimits", raw, what=f"frame {k}")
            assert ctype == jwire.COLUMNS_CONTENT_TYPE
            clock.advance(700)
        raw = jwire.encode_columns_frame(frame_cols(seed + 7, 20, prefix="p"))
        both_http(a, b, "/v1/peer.GetPeerRateLimits", raw)
        both_http(a, b, "/v1/HealthCheck", method="GET")
        if not grpc_too:
            return
        req = v1_request(seed, 12)
        both_rpc(a, b, V1 + "GetRateLimits",
                 jwire.get_rate_limits_req_to_pb(req).SerializeToString())
        cols = frame_cols(seed + 11, 40, prefix="c")
        both_rpc(a, b, V1 + "GetRateLimitsColumns",
                 jwire.peer_columns_req_to_pb(cols).SerializeToString())
        both_rpc(a, b, V1 + "HealthCheck", pb.HealthCheckReq().SerializeToString())
        too_many = v1_request(seed, 1001)
        assert both_rpc(a, b, V1 + "GetRateLimits",
                        jwire.get_rate_limits_req_to_pb(too_many).SerializeToString()
                        )[1] == grpc.StatusCode.OUT_OF_RANGE
        both_rpc(a, b, PEERS + "GetPeerRateLimits",
                 jwire.peer_rate_limits_req_to_pb(v1_request(seed + 1, 9)).SerializeToString())
        both_rpc(a, b, PEERS + "GetPeerRateLimitsColumns",
                 jwire.peer_columns_req_to_pb(frame_cols(seed + 12, 25, prefix="c"))
                 .SerializeToString())
        n = 16
        rng = np.random.default_rng(seed + 13)
        gcols = GlobalsColumns(
            keys=[f"acct_gk{i}" for i in range(n)],
            algorithm=rng.integers(0, 2, n).astype(np.int32),
            status=rng.integers(0, 2, n).astype(np.int32), limit=np.full(n, 100, np.int64),
            remaining=rng.integers(0, 100, n).astype(np.int64),
            reset_time=np.full(n, clock.now_ms() + 60_000, np.int64))
        both_rpc(a, b, PEERS + "UpdatePeerGlobalsColumns",
                 jwire.globals_cols_to_pb(gcols).SerializeToString())
        both_rpc(a, b, PEERS + "UpdatePeerGlobals",
                 jwire.update_globals_req_to_pb(jwire.BroadcastBatch(gcols).updates())
                 .SerializeToString())
        assert jd.service.ring_hash == td.service.ring_hash != 0
        tcols = TransferColumns(
            keys=[f"acct_t{i}" for i in range(8)], algorithm=np.zeros(8, np.int32),
            status=np.zeros(8, np.int32), limit=np.full(8, 50, np.int64),
            remaining=np.arange(8, dtype=np.int64), duration=np.full(8, 60_000, np.int64),
            stamp=np.full(8, clock.now_ms() - 1_000, np.int64),
            expire_at=np.full(8, clock.now_ms() + 59_000, np.int64),
            ring_hash=td.service.ring_hash)
        both_rpc(a, b, PEERS + "TransferOwnership",
                 jwire.transfer_cols_to_pb(tcols).SerializeToString())
        # A GLOBAL sync on both; the GLOBAL and transferred keys answer
        # alike afterwards.
        jd.service.global_mgr.run_once()
        td.service.global_mgr.run_once()
        for k, raw in enumerate(json_bodies(seed + 100, steps=2)):
            both_http(a, b, "/v1/GetRateLimits", raw, what=f"after sync {k}")
        body = json.dumps({"requests": [
            {"name": "acct", "uniqueKey": f"t{i}", "hits": "1", "limit": "50",
             "duration": "60000"} for i in range(8)]}).encode()
        both_http(a, b, "/v1/GetRateLimits", body)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["native", "stdlib", "tls"])
def test_daemons_answer_alike(tmp_path, mode):
    jd, td, clock = start_pair(daemon_env(tmp_path, mode))
    try:
        assert td.service.ring_generation == jd.service.ring_generation == 1
        assert [p.info.grpc_address for p in td.service.get_peer_list()] == [ADDR]
        assert (getattr(td.gateway, "pump", None) is not None) == (mode == "native")
        exchange(jd, td, clock, seed={"native": 0, "stdlib": 1, "tls": 2}[mode])
        # The federation receive answers an empty batch alike.
        t, j = Ends(td), Ends(jd)
        try:
            got = t.rpc(PEERS + "UpdateRegionColumns", b"")
            assert got == j.rpc(PEERS + "UpdateRegionColumns", b"")
            assert got[0] == "ok"
        finally:
            t.close()
            j.close()
    finally:
        jd.close()
        td.close()


def test_native_edge_refuses_tls_alike(tmp_path):
    env = daemon_env(tmp_path, "tls", GUBER_NATIVE_HTTP="1")
    for cfg, cls, extra in ((jcfg, JDaemon, {}), (tcfg, TDaemon, {"GUBER_TORCH_DEVICE": "cpu"})):
        conf = cfg.setup_daemon_config(env={**env, **extra})
        conf.warmup_shapes = []
        with pytest.raises(RuntimeError, match="incompatible with TLS"):
            cls(conf).start()


def test_snapshot_restores_into_the_other_package(tmp_path):
    """Each daemon writes its snapshot at close(); the files are the same
    bytes, and each restores into the other package's daemon, which then
    answer alike."""
    jsnap, tsnap = str(tmp_path / "j.snap"), str(tmp_path / "t.snap")
    env = daemon_env(tmp_path, "stdlib")
    jd, td, clock = start_pair({**env, "GUBER_SNAPSHOT": jsnap},
                               {**env, "GUBER_SNAPSHOT": tsnap})
    try:
        exchange(jd, td, clock, seed=5, grpc_too=False)
    finally:
        jd.close()
        td.close()
    assert jd.service.snapshots.saves_ok == td.service.snapshots.saves_ok == 1
    with open(jsnap, "rb") as f, open(tsnap, "rb") as g:
        jbytes, tbytes = f.read(), g.read()
    assert len(tbytes) > 64 and tbytes == jbytes
    # Swap the files: the JAX daemon boots from the port's, and back.
    os.replace(jsnap, str(tmp_path / "from_jax.snap"))
    shutil.copy(tsnap, jsnap)
    shutil.copy(str(tmp_path / "from_jax.snap"), tsnap)
    clock.advance(1_000)
    jd, td, clock = start_pair({**env, "GUBER_SNAPSHOT": jsnap},
                               {**env, "GUBER_SNAPSHOT": tsnap}, clock=clock)
    try:
        assert jd.service.snapshots.restore_result == td.service.snapshots.restore_result == "ok"
        assert td.service.snapshots.restored_lanes == jd.service.snapshots.restored_lanes > 0
        a, b = Ends(jd), Ends(td)
        try:
            for k, raw in enumerate(json_bodies(5, steps=4)):
                both_http(a, b, "/v1/GetRateLimits", raw, what=f"restored {k}")
        finally:
            a.close()
            b.close()
    finally:
        jd.close()
        td.close()


def _wait(pred, timeout_s=TIMEOUT):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_file_pool_picks_up_a_rewritten_peers_file(tmp_path):
    """File discovery: no file at boot (no ring yet: a JAX node then
    answers "pool is empty" where the port owns every key, a difference
    the peers slice settles, so no request is sent before the file
    exists), then a file naming the node itself, then a rewrite that
    names it with its HTTP address too; both daemons pick up each
    version and answer alike."""
    path = tmp_path / "peers.json"
    env = daemon_env(tmp_path, "stdlib", GUBER_PEER_DISCOVERY_TYPE="file",
                     GUBER_PEERS_FILE=str(path))
    jd, td, clock = start_pair(env)
    try:
        assert jd.service.ring_generation == td.service.ring_generation == 0
        a, b = Ends(jd), Ends(td)
        try:
            tmp = tmp_path / "peers.tmp"
            tmp.write_text(json.dumps([{"grpcAddress": ADDR}]))
            os.replace(tmp, path)
            assert _wait(lambda: jd.service.ring_generation == td.service.ring_generation == 1)
            assert jd.service.ring_hash == td.service.ring_hash != 0
            both_http(a, b, "/v1/GetRateLimits", json_bodies(8, steps=1)[0])
            # A rewrite (new mtime, new content) naming the node itself.
            http_addr = "127.0.0.1:9998"
            time.sleep(0.02)
            tmp.write_text(json.dumps([{"grpcAddress": ADDR, "httpAddress": http_addr}]))
            os.utime(tmp, (time.time() + 5, time.time() + 5))
            os.replace(tmp, path)

            def picked(d):
                return [p.info.http_address for p in d.service.get_peer_list()] == [http_addr]

            assert _wait(lambda: picked(jd) and picked(td))
            assert jd.service.ring_generation == td.service.ring_generation == 1
            both_http(a, b, "/v1/GetRateLimits", json_bodies(9, steps=1)[0])
        finally:
            a.close()
            b.close()
    finally:
        jd.close()
        td.close()


def test_discovery_of_other_kinds_is_refused(tmp_path):
    """make_pool refuses what JAX's refuses, with the same error: an
    unknown kind, member-list and etcd without an advertised PeerInfo,
    and k8s outside a cluster with no kubeconfig."""
    from gubernator_tpu.peers import make_pool as jmake
    from gubernator_tpu_torch.peers import make_pool as tmake

    env = daemon_env(tmp_path, "stdlib")
    jconf = jcfg.setup_daemon_config(env=env)
    tconf = tcfg.setup_daemon_config(env=env)
    old = {k: os.environ.pop(k, None) for k in ("KUBERNETES_SERVICE_HOST", "KUBECONFIG")}
    os.environ["KUBECONFIG"] = str(tmp_path / "no-kubeconfig")
    try:
        for kind in ("etcd", "member-list", "k8s", "consul"):
            errs = []
            for make, conf in ((jmake, jconf), (tmake, tconf)):
                with pytest.raises((ValueError, RuntimeError)) as e:
                    make(kind, conf, on_update=lambda peers: None)
                errs.append((type(e.value).__name__, str(e.value)))
            assert errs[0] == errs[1], kind
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


# ---------------------------------------------------------------------
# The server binary
# ---------------------------------------------------------------------
def _server(args, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "gubernator_tpu_torch.cmd.server", *args],
        cwd=ROOT, env=dict(env or os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _read_line(proc, timeout_s):
    box = []
    t = threading.Thread(target=lambda: box.append(proc.stdout.readline()), daemon=True)
    t.start()
    t.join(timeout_s)
    return box[0] if box else ""


def test_server_binary_starts_answers_and_stops_on_sigterm(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "gubernator_tpu_torch.cmd.server", "-version"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.startswith("gubernator-tpu-torch ")
    snap = tmp_path / "s.snap"
    cfg = tmp_path / "server.env"
    cfg.write_text("\n".join([
        "GUBER_HTTP_ADDRESS=127.0.0.1:0", "GUBER_GRPC_ADDRESS=127.0.0.1:0",
        "GUBER_CACHE_SIZE=1024", "GUBER_WARMUP_SHAPES=1", f"GUBER_SNAPSHOT={snap}",
        "GUBER_TORCH_DEVICE=cpu", "GUBER_NATIVE_HTTP=1", ""]))
    env = {k: v for k, v in os.environ.items() if not k.startswith("GUBER_")}
    proc = _server(["-config", str(cfg)], env)
    try:
        line = _read_line(proc, 90)
        assert "listening on http://" in line, (line, proc.poll())
        addr = line.split("http://")[1].split()[0]
        from gubernator_tpu_torch.client import V1Client
        from gubernator_tpu_torch.types import GetRateLimitsRequest as TReq
        from gubernator_tpu_torch.types import RateLimitRequest as TLane

        c = V1Client(addr, timeout_s=TIMEOUT)
        try:
            resp = c.get_rate_limits(TReq(requests=[
                TLane(name="bin", unique_key="k", hits=1, limit=3, duration=60_000)]))
            assert resp.responses[0].remaining == 2
            assert c.health_check().status == "healthy"
            assert "gubernator_grpc_request_counts" in c.metrics_text()
        finally:
            c.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
    assert snap.exists() and snap.stat().st_size > 0


def test_server_binary_without_a_card_fails_loudly(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = tmp_path / "server.env"
    cfg.write_text("GUBER_HTTP_ADDRESS=127.0.0.1:0\nGUBER_CACHE_SIZE=1024\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("GUBER_")}
    proc = _server(["-config", str(cfg)], env)
    try:
        _, err = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode != 0
    assert "no CUDA device" in err
