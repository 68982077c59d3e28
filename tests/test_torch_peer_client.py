"""The port's PeerClient (gubernator_tpu_torch/peer_client.py) against
the JAX package's, over real sockets.

For each transport (HTTP, gRPC), plain and over TLS, four daemons take
the same calls: two JAX nodes and two port nodes
(`GUBER_TORCH_DEVICE=cpu`), one frozen clock, one advertised address
(so one ring fingerprint).  A JAX client and a port client each call a
node of each package: the port client against a JAX node's receiving
half, the JAX client against a port node, and each against its own
package's node.  The calls cover the windowed forward, a direct
columnar send, single lanes (batched and NO_BATCHING), the classic
batch, the GLOBAL broadcast (the columnar batch and the classic list),
an ownership transfer (committed, then fenced) and a region batch (each
package's RegionBatch, in the columnar encoding against either node).
Every result of the port client equals the JAX client's on the same
package's node, tolerance 0.  On the plain transports a loopback proxy
in front of each node records what reaches it: the request bytes of
the two clients are the same, call by call.

Every socket operation, wait and join has a bound.
"""

import dataclasses
import http.client
import http.server
import json
import threading
from concurrent import futures

import grpc
import numpy as np
import pytest

from gubernator_tpu import config as jcfg
from gubernator_tpu import peer_client as jpc
from gubernator_tpu import types as jtypes
from gubernator_tpu import wire as jwire
from gubernator_tpu.daemon import Daemon as JDaemon
from gubernator_tpu.federation import RegionBatch as JRegionBatch
from gubernator_tpu.federation import RegionColumns
from gubernator_tpu.parallel.global_mgr import GlobalsColumns
from gubernator_tpu.reshard import TransferColumns as JTransfer
from gubernator_tpu.utils.clock import Clock
from gubernator_tpu_torch import config as tcfg
from gubernator_tpu_torch import peer_client as tpc
from gubernator_tpu_torch import types as ttypes
from gubernator_tpu_torch import wire as twire
from gubernator_tpu_torch.daemon import Daemon as TDaemon
from gubernator_tpu_torch.federation import RegionBatch as TRegionBatch
from gubernator_tpu_torch.federation import RegionColumns as TRegionColumns
from gubernator_tpu_torch.parallel.global_mgr import GlobalsColumns as TGlobalsColumns
from gubernator_tpu_torch.reshard import TransferColumns as TTransfer

NOW = 1_573_430_400_000
ADDR = "127.0.0.1:9999"
TIMEOUT = 30.0


# ---------------------------------------------------------------------
# Nodes and recording proxies
# ---------------------------------------------------------------------
def _env(tls):
    env = {
        "GUBER_HTTP_ADDRESS": "127.0.0.1:0",
        "GUBER_GRPC_ADDRESS": "127.0.0.1:0",
        "GUBER_ADVERTISE_ADDRESS": ADDR,
        "GUBER_CACHE_SIZE": "4096",
        "GUBER_GLOBAL_SYNC_WAIT": "3600s",
        "GUBER_TRACE_SAMPLE": "0",
        "GUBER_BATCH_TIMEOUT": "10s",
    }
    if tls:
        env["GUBER_TLS_AUTO"] = "1"
    return env


def _start(kind, tls, clock):
    if kind == "jax":
        conf = jcfg.setup_daemon_config(env=_env(tls))
        cls = JDaemon
    else:
        conf = tcfg.setup_daemon_config(env={**_env(tls), "GUBER_TORCH_DEVICE": "cpu"})
        cls = TDaemon
    conf.warmup_shapes = []
    return cls(conf, clock=clock).start()


class _HttpRecorder:
    """An HTTP/1.1 keep-alive proxy that records (path, content type,
    body) of each request and relays it to `target`."""

    def __init__(self, target):
        self.seen = []
        rec = self
        host, _, port = target.rpartition(":")

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):  # noqa: N802 — stdlib name
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                ctype = self.headers.get("Content-Type")
                rec.seen.append((self.path, ctype, body))
                conn = http.client.HTTPConnection(host, int(port), timeout=TIMEOUT)
                try:
                    conn.request("POST", self.path, body=body,
                                 headers={"Content-Type": ctype})
                    r = conn.getresponse()
                    out, status, rtype = r.read(), r.status, r.getheader("Content-Type")
                finally:
                    conn.close()
                self.send_response(status)
                self.send_header("Content-Type", rtype or "application/octet-stream")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.address = f"127.0.0.1:{self.server.server_address[1]}"
        self._t = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._t.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self._t.join(timeout=TIMEOUT)


class _GrpcRecorder:
    """A gRPC server that records (method, request bytes) of each call
    and relays the bytes to `target`."""

    def __init__(self, target):
        self.seen = []
        self._up = grpc.insecure_channel(target)
        rec = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, details):
                method = details.method

                def relay(raw, context):
                    rec.seen.append((method, raw))
                    try:
                        return rec._up.unary_unary(method)(raw, timeout=TIMEOUT)
                    except grpc.RpcError as e:
                        context.abort(e.code(), e.details())

                return grpc.unary_unary_rpc_method_handler(relay)

        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self.server.add_generic_rpc_handlers((Handler(),))
        port = self.server.add_insecure_port("127.0.0.1:0")
        self.server.start()
        self.address = f"127.0.0.1:{port}"

    def close(self):
        self.server.stop(grace=None).wait(timeout=TIMEOUT)
        self._up.close()


# ---------------------------------------------------------------------
# The calls
# ---------------------------------------------------------------------
def _cols(seed, n, prefix):
    rng = np.random.default_rng(seed)
    return ([str(rng.choice(["acct", "api"])) for _ in range(n)],
            [f"{prefix}{int(k)}" for k in rng.integers(0, 30, n)],
            rng.integers(0, 2, n).astype(np.int32), np.zeros(n, np.int32),
            rng.integers(0, 4, n).astype(np.int64),
            rng.choice([5, 20, 1000], n).astype(np.int64), np.full(n, 60_000, np.int64))


def _result(rc):
    return (rc.n, np.asarray(rc.status).tolist(), np.asarray(rc.limit).tolist(),
            np.asarray(rc.remaining).tolist(), np.asarray(rc.reset_time).tolist(),
            sorted((i, dataclasses.asdict(r)) for i, r in rc.overrides.items()),
            [rc.owner_at(i) for i in range(rc.n)])


def _calls(pkg, client, node, clock):
    """The call sequence through `client` (a PeerClient of `pkg`) to
    `node`; returns every result in comparable form."""
    types = jtypes if pkg == "jax" else ttypes
    wire = jwire if pkg == "jax" else twire
    gcols_cls = GlobalsColumns if pkg == "jax" else TGlobalsColumns
    transfer_cls = JTransfer if pkg == "jax" else TTransfer
    out = []
    fut = client.forward_columns(_cols(1, 50, "f"))
    rc, lo, hi = fut.result(timeout=TIMEOUT)
    out.append(("forward", _result(rc), lo, hi))
    out.append(("direct", _result(client.send_columns_direct(_cols(2, 40, "d")))))
    for beh in (0, 1):  # batched, NO_BATCHING
        r = types.RateLimitRequest(name="acct", unique_key=f"one{beh}", hits=2, limit=10,
                                   duration=60_000, behavior=beh)
        out.append(("single", dataclasses.asdict(client.get_peer_rate_limit(r))))
    req = types.GetRateLimitsRequest(requests=[
        types.RateLimitRequest(name="acct", unique_key=f"c{i % 7}", hits=1, limit=5,
                               duration=60_000, algorithm=i % 2)
        for i in range(12)])
    out.append(("classic", [dataclasses.asdict(r)
                            for r in client.get_peer_rate_limits(req).responses]))
    n = 12
    rng = np.random.default_rng(3)
    gcols = gcols_cls(
        keys=[f"acct_g{i}" for i in range(n)],
        algorithm=rng.integers(0, 2, n).astype(np.int32),
        status=rng.integers(0, 2, n).astype(np.int32), limit=np.full(n, 100, np.int64),
        remaining=rng.integers(0, 100, n).astype(np.int64),
        reset_time=np.full(n, clock.now_ms() + 60_000, np.int64))
    batch = wire.BroadcastBatch(gcols)
    client.update_peer_globals_batch(batch)
    client.update_peer_globals(batch.updates()[:5])
    tcols = transfer_cls(
        keys=[f"acct_t{i}" for i in range(8)], algorithm=np.zeros(8, np.int32),
        status=np.zeros(8, np.int32), limit=np.full(8, 50, np.int64),
        remaining=np.arange(8, dtype=np.int64), duration=np.full(8, 60_000, np.int64),
        stamp=np.full(8, clock.now_ms() - 1_000, np.int64),
        expire_at=np.full(8, clock.now_ms() + 59_000, np.int64),
        ring_hash=node.service.ring_hash)
    out.append(("transfer", client.transfer_ownership(tcols)))
    tcols.ring_hash = 12345
    out.append(("fenced", client.transfer_ownership(tcols)))
    m = 10
    rcols = (RegionColumns if pkg == "jax" else TRegionColumns)(
        origin="dc-b", names=["acct"] * m, unique_keys=[f"r{i}" for i in range(m)],
        algorithm=np.zeros(m, np.int32), behavior=np.zeros(m, np.int32),
        hits=np.full(m, 2, np.int64), limit=np.full(m, 20, np.int64),
        duration=np.full(m, 60_000, np.int64))
    rbatch = (JRegionBatch if pkg == "jax" else TRegionBatch)(rcols)
    client.update_region_columns(rbatch)
    out.append(("region", client._region_columnar))  # noqa: SLF001
    # What the node now holds for the keys the calls touched.
    body = json.dumps({"requests": [
        {"name": "acct", "uniqueKey": k, "hits": "0", "limit": "1000", "duration": "60000"}
        for k in ["f1", "d2", "one0", "one1", "c3", "t5", "r4"]]}).encode()
    out.append(("read", node.service.get_rate_limits(
        types.GetRateLimitsRequest.from_json(json.loads(body))).to_json()))
    out.append(("health", client.get_last_err() == [], client.breaker.state))
    return out


def _client(pkg, node, transport, tls, address):
    mod = jpc if pkg == "jax" else tpc
    types = jtypes if pkg == "jax" else ttypes
    beh = (jcfg if pkg == "jax" else tcfg).BehaviorConfig(batch_timeout_s=10.0)
    info = types.PeerInfo(grpc_address=address, http_address=address)
    kw = {}
    if tls:
        import ssl

        ca = node.conf.tls.ca_file
        if transport == "http":
            kw["tls_context"] = ssl.create_default_context(cafile=ca)
        else:
            with open(ca, "rb") as f:
                kw["channel_credentials"] = grpc.ssl_channel_credentials(
                    root_certificates=f.read())
    return mod.PeerClient(info, beh, transport=transport, **kw)


@pytest.fixture(autouse=True)
def _unsampled():
    yield
    from gubernator_tpu import tracing as jtracing
    from gubernator_tpu_torch import tracing as ttracing

    jtracing.set_sample_rate(0.0)
    ttracing.set_sample_rate(0.0)


@pytest.mark.parametrize("tls", [False, True], ids=["plain", "tls"])
@pytest.mark.parametrize("transport", ["http", "grpc"])
def test_clients_alike_against_both_nodes(transport, tls):
    clock = Clock()
    clock.freeze(NOW)
    # node kind -> [node for the JAX client, node for the port client]
    nodes = {}
    proxies = []
    clients = []
    try:
        for kind in ("jax", "torch"):
            nodes[kind] = [_start(kind, tls, clock), _start(kind, tls, clock)]
        results = {}
        seen = {}
        for kind, pair in nodes.items():
            for pkg, node in zip(("jax", "torch"), pair):
                target = (node.gateway.address if transport == "http"
                          else node.grpc.address)
                if tls:
                    rec = None
                    address = target
                else:
                    rec = (_HttpRecorder(target) if transport == "http"
                           else _GrpcRecorder(target))
                    proxies.append(rec)
                    address = rec.address
                client = _client(pkg, node, transport, tls, address)
                clients.append(client)
                results[(kind, pkg)] = _calls(pkg, client, node, clock)
                if rec is not None:
                    seen[(kind, pkg)] = list(rec.seen)
        for kind in ("jax", "torch"):
            a, b = results[(kind, "jax")], results[(kind, "torch")]
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x == y, (kind, x[0], str(x)[:500], str(y)[:500])
            if not tls:
                assert seen[(kind, "jax")] == seen[(kind, "torch")], kind
                assert len(seen[(kind, "torch")]) >= 9
        # Both nodes answered the same results to the same calls; each
        # took the region batch in its columnar encoding.
        assert results[("jax", "torch")] == results[("torch", "torch")]
        for kind in ("jax", "torch"):
            assert [x for x in results[(kind, "torch")] if x[0] == "region"] == [("region", True)]
        assert ("transfer", "ok") in results[("torch", "torch")]
        assert ("fenced", "fenced") in results[("torch", "torch")]
    finally:
        for c in clients:
            c.shutdown(timeout_s=5.0)
        for p in proxies:
            p.close()
        for pair in nodes.values():
            for d in pair:
                d.close()
