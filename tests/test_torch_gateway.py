"""The port's HTTP edge (gubernator_tpu_torch/gateway.py) against the
JAX package's, byte for byte.

A port node (`device="cpu"`, the kernels' plain versions) and a JAX
node with the same configuration, both holding one frozen clock and a
ring of themselves alone, take the same requests: JSON bodies, GUBC
kind-5 frames, the peer API's receiving routes (a kind-1 columns frame
and its classic JSON, a globals frame and classic globals, a transfer
frame, a fenced transfer) and HealthCheck.  Every answer must have the
same status, content type and body (tolerance 0), through
`handle_request`, `handle_request_async`, the stdlib `GatewayServer`
and the native `NativeGatewayServer` with its ingress pump.  The debug
routes answer 200 with the same keys.

GET /metrics answers 200 with the same families (their values are
held to JAX's in tests/test_torch_metrics.py).  Known differences,
pinned here: POST /debug/incident answers 404 on the port (no black box
yet), and /debug/status has no `blackbox` section.

Every socket operation has a timeout, and no test orders on a sleep.
"""

import json
import socket
import sys
import threading
import time

import numpy as np
import pytest

from gubernator_tpu import gateway as jgw
from gubernator_tpu import wire as jwire
from gubernator_tpu.config import BehaviorConfig as JBehaviors
from gubernator_tpu.parallel.global_mgr import GlobalsColumns
from gubernator_tpu.reshard import TransferColumns
from gubernator_tpu.service import ServiceConfig as JConfig
from gubernator_tpu.service import V1Service as JService
from gubernator_tpu.types import PeerInfo as JPeer
from gubernator_tpu.utils.clock import Clock
from gubernator_tpu_torch import gateway as tgw
from gubernator_tpu_torch import wire as twire
from gubernator_tpu_torch.config import BehaviorConfig as TBehaviors
from gubernator_tpu_torch.service import ServiceConfig as TConfig
from gubernator_tpu_torch.service import V1Service as TService
from gubernator_tpu_torch.types import PeerInfo as TPeer

NOW = 1_573_430_400_000
ADDR = "127.0.0.1:9999"
G, NB, GREG, RESET = 2, 1, 4, 8
TIMEOUT = 30.0


def _services(cache_size=4096, **behaviors):
    """(JAX node, port node, the clock both hold)."""
    clock = Clock()
    clock.freeze(NOW)
    kw = dict(global_sync_wait_s=3600.0, **behaviors)
    js = JService(JConfig(cache_size=cache_size, clock=clock, advertise_address=ADDR,
                          behaviors=JBehaviors(**kw)))
    ts = TService(TConfig(cache_size=cache_size, clock=clock, advertise_address=ADDR,
                          behaviors=TBehaviors(**kw), device="cpu"))
    js.set_peers([JPeer(grpc_address=ADDR, is_owner=True)])
    ts.set_peers([TPeer(grpc_address=ADDR, is_owner=True)])
    return js, ts, clock


@pytest.fixture(autouse=True)
def _unsampled():
    """The native fast lane turns off while tracing samples (both
    packages' module-global rate): hold it at 0 here."""
    from gubernator_tpu import tracing as jtracing
    from gubernator_tpu_torch import tracing as ttracing

    jtracing.set_sample_rate(0.0)
    ttracing.set_sample_rate(0.0)
    yield


@pytest.fixture
def nodes():
    js, ts, clock = _services()
    try:
        yield js, ts, clock
    finally:
        js.close()
        ts.close()


def _lane(rng, key_space=40, prefix="k"):
    algo = rng.choice(["TOKEN_BUCKET", "LEAKY_BUCKET", 0, 1, "1"])
    d = {"name": rng.choice(["acct", "api"]), "uniqueKey": f"{prefix}{rng.integers(key_space)}",
         "hits": str(rng.integers(0, 4)), "limit": str(rng.choice([5, 20, 1000])),
         "duration": str(rng.choice([2_000, 60_000])), "algorithm": algo}
    r = rng.random()
    if r < 0.08:
        d["behavior"] = "GLOBAL"
        d["uniqueKey"] = "g" + d["uniqueKey"]
    elif r < 0.14:
        d["behavior"] = NB
    elif r < 0.18:
        d["behavior"], d["duration"] = GREG, str(rng.choice([1, 2, 99]))
    elif r < 0.22:
        d["behavior"] = "RESET_REMAINING"
    elif r < 0.25:
        d["uniqueKey"] = ""
    elif r < 0.28:
        d["name"] = ""
    elif r < 0.30:
        d["uniqueKey"] += "\\u00e9"  # an escape: the Python parse takes the body
    return d


def _json_bodies(seed, steps=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        n = int(rng.choice([1, 2, 5, 30]))
        out.append(json.dumps({"requests": [_lane(rng) for _ in range(n)]})
                   .replace("\\\\u00e9", "\\u00e9").encode())
    return out


def _frame_cols(seed, n, prefix="f", beh=None):
    rng = np.random.default_rng(seed)
    names = [str(rng.choice(["acct", "api"])) for _ in range(n)]
    keys = [f"{prefix}{int(k)}" for k in rng.integers(0, 40, n)]
    return (names, keys, rng.integers(0, 2, n).astype(np.int32),
            np.full(n, 0 if beh is None else beh, np.int32),
            rng.integers(0, 4, n).astype(np.int64),
            rng.choice([5, 20, 1000], n).astype(np.int64),
            np.full(n, 60_000, np.int64))


def _same(a, b, what):
    assert a[0] == b[0], (what, a, b)
    assert a[1] == b[1], (what, a[1], b[1])
    assert a[2] == b[2], (what, a[2][:300], b[2][:300])


def _both(js, ts, method, path, raw=b"", what=""):
    a = jgw.handle_request(js, method, path, raw)
    b = tgw.handle_request(ts, method, path, raw)
    _same(a, b, what or path)
    return b


def _both_async(js, ts, method, path, raw):
    got = []
    for gw, svc in ((jgw, js), (tgw, ts)):
        box, done = [], threading.Event()
        gw.handle_request_async(svc, method, path, raw,
                                lambda *t: (box.append(t), done.set()))
        assert done.wait(TIMEOUT), "async answer never came"
        got.append(box[0])
    _same(got[0], got[1], f"async {path}")
    return got[1]


@pytest.mark.parametrize("seed", range(3))
def test_json_bodies_answer_alike(nodes, seed):
    js, ts, clock = nodes
    for k, raw in enumerate(_json_bodies(seed)):
        if k % 2:
            _both_async(js, ts, "POST", "/v1/GetRateLimits", raw)
        else:
            _both(js, ts, "POST", "/v1/GetRateLimits", raw, f"step {k}")
        clock.advance(int(np.random.default_rng(seed + k).choice([0, 300, 2_500])))
    # A GLOBAL sync on both, then the GLOBAL keys answer alike.
    js.global_mgr.run_once()
    ts.global_mgr.run_once()
    for raw in _json_bodies(seed + 100, steps=3):
        _both(js, ts, "POST", "/v1/GetRateLimits", raw)


def test_json_errors_answer_alike(nodes):
    js, ts, _ = nodes
    too_many = json.dumps({"requests": [{"name": "a", "uniqueKey": "b"}] * 1001}).encode()
    for raw in (b"{not json", b"\x00\x01garbage", b"", b"{}", b'{"requests": []}',
                b'{"requests": [{"name": "a", "uniqueKey": "b", "algorithm": "NOPE"}]}',
                b'{"requests": [{"name": "a", "uniqueKey": "b", "algorithm": 7}]}',
                b'{"requests": [{"name": "a", "uniqueKey": "b", "behavior": "NOPE"}]}',
                b'{"requests": [{"name": "a", "uniqueKey": "b", "hits": 1.5}]}',
                b'{"requests": [{"name": "a", "uniqueKey": "b", "hits": "99999999999999999999"}]}',
                too_many):
        _both(js, ts, "POST", "/v1/GetRateLimits", raw, raw[:40])
        _both_async(js, ts, "POST", "/v1/GetRateLimits", raw)


@pytest.mark.parametrize("seed", range(3))
def test_native_json_render_matches_the_python_render(seed):
    """gt_json_render (the native path's body) and render_columns (the
    Python path's) say the same thing lane for lane: zeros, negative and
    int64-extreme values quoted as strings, error lanes, owner metadata;
    and both equal the JAX gateway's renders byte for byte."""
    from gubernator_tpu.service import ColumnarResult as JResult
    from gubernator_tpu.types import RateLimitResponse as JResp
    from gubernator_tpu_torch.service import ColumnarResult as TResult
    from gubernator_tpu_torch.types import RateLimitResponse as TResp

    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    big = np.iinfo(np.int64)
    arrays = dict(status=rng.integers(0, 2, n).astype(np.int32),
                  limit=rng.choice([0, 1, big.max, 10**12], n).astype(np.int64),
                  remaining=rng.choice([0, -1, big.min, big.max, 7], n).astype(np.int64),
                  reset_time=rng.choice([0, NOW, big.max], n).astype(np.int64))
    tr = TResult(n=n, **arrays)
    jr = JResult(n=n, **{k: v.copy() for k, v in arrays.items()})
    for i in rng.choice(n, min(n, 2), replace=False):
        tr.overrides[int(i)] = TResp(error="field 'namespace' cannot be empty")
        jr.overrides[int(i)] = JResp(error="field 'namespace' cannot be empty")
    if n > 3:
        tr.set_owner(np.arange(1, n, 3), "10.0.0.9:81")
        jr.set_owner(np.arange(1, n, 3), "10.0.0.9:81")
    native = tgw.render_result_native(tr)
    python = tgw._json_bytes(tgw.render_columns(tr))
    assert json.loads(native) == json.loads(python)
    assert native == jgw.render_result_native(jr)
    assert python == jgw._json_bytes(jgw.render_columns(jr))


def test_ingress_frames_answer_alike(nodes):
    js, ts, clock = nodes
    for k in range(6):
        cols = _frame_cols(k, int(np.random.default_rng(k).choice([1, 3, 50])))
        if k == 2:  # empty names and keys: per-lane errors
            cols[0][0], cols[1][-1] = "", ""
        if k == 3:  # slow lanes in a frame take the Python router
            cols[3][:] = G
        raw = jwire.encode_ingress_frame(cols)
        assert raw == twire.encode_ingress_frame(cols)
        if k % 2:
            b = _both_async(js, ts, "POST", "/v1/GetRateLimits", raw)
        else:
            b = _both(js, ts, "POST", "/v1/GetRateLimits", raw, f"frame {k}")
        assert b[1] == twire.COLUMNS_CONTENT_TYPE
        clock.advance(700)
    good = jwire.encode_ingress_frame(_frame_cols(9, 4))
    for bad in (good[:-5], good[:11], good + b"zz"):
        assert _both(js, ts, "POST", "/v1/GetRateLimits", bad)[0] == 400


def test_ingress_frames_off_answer_400_alike():
    js, ts, _ = _services(ingress_columns=False)
    try:
        raw = jwire.encode_ingress_frame(_frame_cols(0, 3))
        assert _both(js, ts, "POST", "/v1/GetRateLimits", raw)[0] == 400
    finally:
        js.close()
        ts.close()


def test_peer_rate_limits_answer_alike(nodes):
    js, ts, clock = nodes
    for k in range(4):
        cols = _frame_cols(20 + k, 30, prefix="p", beh=G if k == 3 else None)
        raw = jwire.encode_columns_frame(cols)
        if k % 2:
            b = _both_async(js, ts, "POST", "/v1/peer.GetPeerRateLimits", raw)
        else:
            b = _both(js, ts, "POST", "/v1/peer.GetPeerRateLimits", raw)
        assert b[0] == 200 and b[1] == twire.COLUMNS_CONTENT_TYPE
        classic = json.dumps(jwire.peer_columns_to_classic_json(cols)).encode()
        _both(js, ts, "POST", "/v1/peer.GetPeerRateLimits", classic)
        _both_async(js, ts, "POST", "/v1/peer.GetPeerRateLimits", classic)
        clock.advance(500)
    assert _both(js, ts, "POST", "/v1/peer.GetPeerRateLimits", raw[:-4])[0] == 400


def test_update_peer_globals_answer_alike(nodes):
    """A globals frame (one batched replica commit, gslots recycled on a
    small table) and a classic JSON broadcast; the replicas then answer
    GLOBAL requests of a non-owner's keys alike."""
    js, ts, clock = nodes
    rng = np.random.default_rng(5)
    n = 64
    cols = GlobalsColumns(
        keys=[f"acct_gk{i}" for i in range(n)], algorithm=rng.integers(0, 2, n).astype(np.int32),
        status=rng.integers(0, 2, n).astype(np.int32),
        limit=np.full(n, 100, np.int64), remaining=rng.integers(0, 100, n).astype(np.int64),
        reset_time=np.full(n, NOW + 60_000, np.int64))
    raw = jwire.encode_globals_frame(cols)
    assert raw == twire.encode_globals_frame(cols)
    assert _both(js, ts, "POST", "/v1/peer.UpdatePeerGlobals", raw)[2] == b"{}"
    classic = jwire.BroadcastBatch(cols).classic_json_bytes()
    _both(js, ts, "POST", "/v1/peer.UpdatePeerGlobals", classic)
    assert _both(js, ts, "POST", "/v1/peer.UpdatePeerGlobals", raw[:-3])[0] == 400
    body = json.dumps({"requests": [
        {"name": "acct", "uniqueKey": f"gk{i}", "hits": "0", "limit": "100",
         "duration": "60000", "behavior": "GLOBAL"} for i in range(0, n, 3)]}).encode()
    _both(js, ts, "POST", "/v1/GetRateLimits", body)


def _transfer(n, ring_hash, seed=0):
    rng = np.random.default_rng(seed)
    return TransferColumns(
        keys=[f"acct_t{i}" for i in range(n)], algorithm=rng.integers(0, 2, n).astype(np.int32),
        status=np.zeros(n, np.int32), limit=np.full(n, 50, np.int64),
        remaining=rng.integers(0, 50, n).astype(np.int64), duration=np.full(n, 60_000, np.int64),
        stamp=np.full(n, NOW - 1_000, np.int64), expire_at=np.full(n, NOW + 59_000, np.int64),
        ring_hash=ring_hash)


def test_transfer_ownership_answers_alike(nodes):
    js, ts, _ = nodes
    assert ts.ring_hash == js.ring_hash != 0
    raw = jwire.encode_transfer_frame(_transfer(200, js.ring_hash))
    b = _both(js, ts, "POST", "/v1/peer.TransferOwnership", raw)
    assert json.loads(b[2]) == {"committed": 200, "rejected": 0}
    fenced = jwire.encode_transfer_frame(_transfer(10, js.ring_hash ^ 1, seed=1))
    b = _both(js, ts, "POST", "/v1/peer.TransferOwnership", fenced)
    assert b[0] == 409
    unfenced = jwire.encode_transfer_frame(_transfer(10, 0, seed=2))
    _both(js, ts, "POST", "/v1/peer.TransferOwnership", unfenced)
    assert _both(js, ts, "POST", "/v1/peer.TransferOwnership", b"{}")[0] == 400
    assert _both(js, ts, "POST", "/v1/peer.TransferOwnership", raw[:-1])[0] == 400
    body = json.dumps({"requests": [
        {"name": "acct", "uniqueKey": f"t{i}", "hits": "1", "limit": "50",
         "duration": "60000", "algorithm": int(i % 2)} for i in range(0, 200, 7)]}).encode()
    _both(js, ts, "POST", "/v1/GetRateLimits", body)
    assert ts.reshard.snapshot() == js.reshard.snapshot()


def test_transfer_off_answers_404_alike():
    js, ts, _ = _services(reshard=False)
    try:
        raw = jwire.encode_transfer_frame(_transfer(3, js.ring_hash))
        assert _both(js, ts, "POST", "/v1/peer.TransferOwnership", raw)[0] == 404
    finally:
        js.close()
        ts.close()


def test_health_and_unknown_routes_answer_alike(nodes):
    js, ts, _ = nodes
    for path in ("/v1/HealthCheck", "/healthz"):
        b = _both(js, ts, "GET", path)
        assert json.loads(b[2])["peerCount"] == 1
    for method, path in (("GET", "/nope"), ("POST", "/nope"), ("PUT", "/v1/GetRateLimits"),
                         ("GET", "/debug/nope")):
        assert _both(js, ts, method, path)[0] == 404


def test_region_columns_route_falls_through_alike():
    """The port has no federation plane: the route answers as a JAX node
    whose region plane is off (GUBER_REGION_COLUMNS=0)."""
    js, ts, _ = _services(region_columns=False)
    try:
        assert not ts.serves_region_columns
        assert _both(js, ts, "POST", "/v1/peer.UpdateRegionColumns", b"GUBC\x01\x07")[0] == 404
    finally:
        js.close()
        ts.close()


def test_routes_the_port_does_not_serve_yet(nodes):
    """The documented difference: no incident bundle.  GET /metrics is
    served since the daemon slice, with JAX's content type and
    families."""
    js, ts, _ = nodes
    a = jgw.handle_request(js, "GET", "/metrics", b"")
    b = tgw.handle_request(ts, "GET", "/metrics", b"")
    assert a[:2] == b[:2] == (200, "text/plain; version=0.0.4")

    def families(page):
        return {line.split()[2] for line in page.decode().splitlines()
                if line.startswith("# TYPE ") and not line.split()[2].endswith("_created")}

    assert families(b[2]) == families(a[2])
    assert tgw.handle_request(ts, "POST", "/debug/incident", b"{}") == (
        404, "application/json", b'{"code": 5, "message": "no handler for /debug/incident"}')


def test_debug_routes_have_the_same_keys(nodes):
    js, ts, _ = nodes
    _both(js, ts, "POST", "/v1/GetRateLimits", _json_bodies(0, steps=1)[0])
    for path in ("/debug/status", "/debug/latency", "/debug/hotkeys", "/debug/device",
                 "/debug/audit", "/debug/tenants", "/debug/traces", "/debug/events",
                 "/debug/traces?trace_id=00&limit=3"):
        a = jgw.handle_request(js, "GET", path, b"")
        b = tgw.handle_request(ts, "GET", path, b"")
        assert a[0] == b[0] == 200 and a[1] == b[1], path
        ka, kb = set(json.loads(a[2])), set(json.loads(b[2]))
        if path == "/debug/status":
            assert ka - kb == {"blackbox"} and not kb - ka
            sa, sb = json.loads(a[2]), json.loads(b[2])
            for sec in ("health", "occupancy", "ring", "audit", "express", "xla", "region"):
                assert set(sa[sec]) == set(sb[sec]), sec
            assert sb["peers"] == sa["peers"]
            assert sb["ring"]["hash"] == sa["ring"]["hash"]
            assert sb["occupancy"] == sa["occupancy"]
        else:
            assert ka == kb, path
    a = jgw.handle_request(js, "GET", "/debug/pprof?seconds=1&format=json", b"")
    b = tgw.handle_request(ts, "GET", "/debug/pprof?seconds=1&format=json", b"")
    assert a[0] == b[0] == 200 and set(json.loads(a[2])) == set(json.loads(b[2]))
    # The profile route refuses while tracing is off, on both.
    _both(js, ts, "POST", "/debug/profile", b'{"durationMs": 10}')


# ---------------------------------------------------------------------
# Over sockets
# ---------------------------------------------------------------------
def _read_response(s):
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = s.recv(65536)
        if not chunk:
            raise ConnectionError(f"EOF mid-headers: {data!r}")
        data += chunk
    head, _, rest = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    headers = {}
    for line in head.split(b"\r\n")[1:]:
        k, _, v = line.partition(b":")
        headers[k.strip().lower().decode()] = v.strip().decode()
    clen = int(headers.get("content-length", "0"))
    while len(rest) < clen:
        chunk = s.recv(65536)
        if not chunk:
            raise ConnectionError("EOF mid-body")
        rest += chunk
    return status, headers.get("content-type", ""), rest[:clen]


def _request(s, method, path, body=b""):
    s.sendall(f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Length: {len(body)}\r\n\r\n"
              .encode() + body)
    return _read_response(s)


def _connect(addr):
    host, _, port = addr.partition(":")
    s = socket.create_connection((host, int(port)), timeout=TIMEOUT)
    s.settimeout(TIMEOUT)
    return s


def _sequence():
    """A request script: JSON, frames (native and slow), peer routes."""
    seq = [("POST", "/v1/GetRateLimits", b) for b in _json_bodies(7, steps=5)]
    for k in range(4):
        beh = [None, None, G, NB][k]
        seq.append(("POST", "/v1/GetRateLimits",
                    jwire.encode_ingress_frame(_frame_cols(30 + k, 20, beh=beh))))
    seq.append(("POST", "/v1/peer.GetPeerRateLimits",
                jwire.encode_columns_frame(_frame_cols(40, 25, prefix="p"))))
    seq += [("GET", "/v1/HealthCheck", b""), ("GET", "/nope", b"")]
    return seq


def _serve(gw, svc, native, pump=False):
    if native:
        srv = gw.NativeGatewayServer(svc, "127.0.0.1:0")
        if pump:
            p = gw.NativeIngressPump(svc).start()
            p.update_ring()
            srv.pump = p
    else:
        srv = gw.GatewayServer(svc, "127.0.0.1:0")
    srv.start()
    return srv


@pytest.mark.parametrize("edge", ["stdlib", "native", "native_pump"])
def test_edges_answer_alike_over_sockets(edge):
    js, ts, _ = _services()
    servers = []
    try:
        native, pump = edge != "stdlib", edge == "native_pump"
        for gw, svc in ((jgw, js), (tgw, ts)):
            servers.append(_serve(gw, svc, native, pump))
        got = []
        for srv in servers:
            with _connect(srv.address) as s:
                got.append([_request(s, m, p, b) for m, p, b in _sequence()])
        for k, (a, b) in enumerate(zip(*got)):
            assert a == b, (edge, k, a[2][:200], b[2][:200])
        if pump:
            st = servers[1].pump.stats()
            assert st["frames"] >= 1 and st["fallbacks"] >= 1, st
            assert st == servers[0].pump.stats()
    finally:
        for srv in servers:
            srv.close()
        js.close()
        ts.close()


def test_native_frame_takes_the_same_answers_on_either_path():
    """The same kind-5 frames answered by the native fast lane (pump on)
    and by the Python frame path (pump off) are the same bytes."""
    answers = []
    for pump in (True, False):
        _, ts, clock = _services()
        srv = _serve(tgw, ts, native=True, pump=pump)
        try:
            with _connect(srv.address) as s:
                answers.append([_request(s, "POST", "/v1/GetRateLimits",
                                         twire.encode_ingress_frame(_frame_cols(k, 40)))
                                for k in range(5)])
            if pump:
                assert srv.pump.stats()["frames"] == 5
        finally:
            srv.close()
            ts.close()
    assert answers[0] == answers[1]


@pytest.mark.parametrize("pump", [False, True])
def test_native_edge_concurrency_above_the_worker_pool(pump):
    """24 connections x 4 requests against 4 workers, all in flight at
    once: every request answered, every hit counted once."""
    _, ts, _ = _services()
    srv = _serve(tgw, ts, native=True, pump=pump)
    n_clients, per_client, lanes = 24, 4, 4
    errs = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the Python threads finely
    try:
        assert srv.n_workers == 4

        def client(c):
            try:
                with _connect(srv.address) as s:
                    for _ in range(per_client):
                        cols = (["acct"] * lanes, ["shared"] * lanes,
                                np.zeros(lanes, np.int32), np.zeros(lanes, np.int32),
                                np.ones(lanes, np.int64), np.full(lanes, 100_000, np.int64),
                                np.full(lanes, 60_000, np.int64))
                        body = (twire.encode_ingress_frame(cols) if c % 2 else json.dumps(
                            {"requests": [{"name": "acct", "uniqueKey": "shared", "hits": "1",
                                           "limit": "100000", "duration": "60000"}] * lanes}
                        ).encode())
                        status, _, rbody = _request(s, "POST", "/v1/GetRateLimits", body)
                        assert status == 200, rbody
            except Exception as e:  # noqa: BLE001 — raised on the main thread
                errs.append(e)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a client did not finish"
        assert not errs, errs
        with _connect(srv.address) as s:
            status, _, rbody = _request(s, "POST", "/v1/GetRateLimits", json.dumps(
                {"requests": [{"name": "acct", "uniqueKey": "shared", "hits": "0",
                               "limit": "100000", "duration": "60000"}]}).encode())
        assert status == 200
        rem = int(json.loads(rbody)["responses"][0]["remaining"])
        assert rem == 100_000 - n_clients * per_client * lanes
        if pump:
            assert srv.pump.stats()["frames"] == n_clients // 2 * per_client
    finally:
        sys.setswitchinterval(switch)
        srv.close()
        ts.close()


@pytest.mark.parametrize("body_kind", ["json", "frame"])
def test_native_edge_half_closed_socket(body_kind):
    """shutdown(SHUT_WR) right after the request: the edge frames and
    serves it and writes the answer on the open half."""
    js, ts, _ = _services()
    servers = [_serve(jgw, js, native=True, pump=True), _serve(tgw, ts, native=True, pump=True)]
    try:
        body = (twire.encode_ingress_frame(_frame_cols(3, 6)) if body_kind == "frame" else
                json.dumps({"requests": [{"name": "acct", "uniqueKey": "half", "hits": "4",
                                          "limit": "10", "duration": "60000"}]}).encode())
        got = []
        for srv in servers:
            with _connect(srv.address) as s:
                s.sendall(b"POST /v1/GetRateLimits HTTP/1.1\r\nHost: x\r\n"
                          + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
                s.shutdown(socket.SHUT_WR)
                got.append(_read_response(s))
        assert got[0] == got[1] and got[1][0] == 200
    finally:
        for srv in servers:
            srv.close()
        js.close()
        ts.close()


def test_native_shed_answers_alike():
    """A frame past the ingress bound is shed by the native loop with the
    same 429 as a JAX node's; a frame within it is served."""
    js, ts, _ = _services(ingress_queue_lanes=16)
    servers = [_serve(jgw, js, native=True, pump=True), _serve(tgw, ts, native=True, pump=True)]
    try:
        got = []
        for srv in servers:
            with _connect(srv.address) as s:
                got.append([_request(s, "POST", "/v1/GetRateLimits",
                                     twire.encode_ingress_frame(_frame_cols(k, n)))
                            for k, n in ((1, 40), (2, 8))])
        assert got[0] == got[1]
        assert [g[0] for g in got[1]] == [429, 200]
        assert servers[1].pump.stats()["shedFrames"] == 1
    finally:
        for srv in servers:
            srv.close()
        js.close()
        ts.close()


def test_pump_ring_follows_set_peers():
    """The native fast lane serves once set_peers installed the ring of
    this node, exactly as on a JAX node; a membership change with
    another peer opens the double-dispatch window, which turns the lane
    off until the window closes; a service closing stops it."""
    clock = Clock()
    clock.freeze(NOW)
    ts = TService(TConfig(cache_size=1024, clock=clock, device="cpu",
                          behaviors=TBehaviors(global_sync_wait_s=3600.0,
                                               reshard_handoff_s=30.0)))
    srv = _serve(tgw, ts, native=True, pump=True)
    try:
        frame = twire.encode_ingress_frame(_frame_cols(1, 8))
        with _connect(srv.address) as s:
            assert _request(s, "POST", "/v1/GetRateLimits", frame)[0] == 200
            assert srv.pump.stats()["frames"] == 0  # no ring yet: the Python path
            ts.set_peers([TPeer(grpc_address=ADDR, is_owner=True)])
            assert _request(s, "POST", "/v1/GetRateLimits", frame)[0] == 200
            assert srv.pump.stats()["frames"] == 1
        assert srv.pump._enable_at == 0.0  # noqa: SLF001 — no window
        # Another peer (a closed loopback port: nothing is sent to it
        # here but the handoff's transfer, which fails and aborts).
        ts.set_peers([TPeer(grpc_address=ADDR, is_owner=True),
                      TPeer(grpc_address="127.0.0.1:1")])
        assert ts.ring_generation == 2 and len(ts.get_peer_list()) == 2
        assert ts.debug_status()["ring"]["handoffActive"] is True
        assert srv.pump._enable_at > time.monotonic()  # noqa: SLF001 — lane off
        assert ts.reshard.wait_idle(timeout_s=30.0)
    finally:
        srv.close()
        ts.close()


def test_debug_launches_is_the_ports_own_route(nodes):
    """GET /debug/launches answers each CUDA kernel's launch count in the
    process (a JAX node: 404); POST answers them and sets them to 0."""
    from gubernator_tpu_torch.ops import _kernels

    js, ts, _ = nodes
    assert jgw.handle_request(js, "GET", "/debug/launches", b"")[0] == 404
    saved = dict(_kernels.LAUNCHES)
    try:
        _kernels.reset_launch_counts()
        _kernels.LAUNCHES["gather_rows"] = 2
        st, ctype, body = tgw.handle_request(ts, "GET", "/debug/launches", b"")
        assert (st, ctype) == (200, "application/json")
        assert json.loads(body)["launches"] == dict(_kernels.LAUNCHES)
        got = tgw.handle_request(ts, "POST", "/debug/launches", b"")
        assert json.loads(got[2])["launches"]["gather_rows"] == 2
        assert not any(_kernels.LAUNCHES.values())
    finally:
        _kernels.LAUNCHES.update(saved)
