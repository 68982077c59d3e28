"""Peers and resharding: port, JAX and mixed clusters answer alike.

Three three-node clusters run one after another on the same fixed
loopback ports, so that their rings and `owner` metadata agree: all
JAX, all port (`GUBER_TORCH_DEVICE=cpu`, the kernels' plain versions),
and mixed (a JAX node between two port nodes).  Every node holds one
frozen clock and takes the same seeded requests, one at a time, over
real sockets (JSON bodies and GUBC kind-5 frames to the stdlib gateway,
V1 over gRPC).  Each phase's answers must be the same bytes as the
all-JAX cluster's (gRPC replies compared as deterministic
serializations of the decoded message: a map field's order on the wire
is not fixed).

* Forwarding: lanes owned elsewhere go to their owner in one columnar
  sub-batch per owner (single lanes through the peer window), local
  lanes evaluate here, NO_BATCHING lanes go direct.
* GLOBAL: hits at every node, each node's sync run by hand twice (hits
  forwarded to the owners, the owners' broadcasts), then every node's
  zero-hit read.
* A fourth node joins: every old owner drains the keys it no longer
  owns and transfers them; afterwards each key's row lives on its
  owner under the four-node ring only, with the same bytes.  Then
  reads inside the double-dispatch window (`reshard_handoff_s` > 0).
* A FaultPlan partitions one peer from node 0: the not-ready re-pick,
  the breaker opening, `degraded` answers from the local store,
  `gubernator_circuit_breaker_state`, an unhealthy HealthCheck.

Every socket operation, wait and join has a bound.
"""

import http.client
import json
import os
import random
import socket
import time

import grpc
import numpy as np
import pytest

from gubernator_tpu import config as jcfg
from gubernator_tpu import faults as jfaults
from gubernator_tpu import wire as jwire
from gubernator_tpu.daemon import Daemon as JDaemon
from gubernator_tpu.proto import gubernator_pb2 as pb
from gubernator_tpu.types import GetRateLimitsRequest, RateLimitRequest
from gubernator_tpu.utils.clock import Clock
from gubernator_tpu_torch import config as tcfg
from gubernator_tpu_torch import faults as tfaults
from gubernator_tpu_torch.daemon import Daemon as TDaemon

NOW = 1_573_430_400_000
TIMEOUT = 30.0
GLOBAL, NB = 2, 1
V1 = "/pb.gubernator.V1/"


def _free_ports(n):
    """n free ports outside the kernel's ephemeral range: no socket
    bound to port 0 elsewhere (another test's server) can take one
    between the clusters, which would then share it (gRPC servers bind
    with SO_REUSEPORT)."""
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        lo, hi = (int(x) for x in f.read().split())
    pool = [p for p in range(10_000, 65_000) if not lo <= p <= hi]
    rng = random.Random(os.getpid())
    out = []
    while len(out) < n:
        p = rng.choice(pool)
        if p in out:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", p))
            except OSError:
                continue
        out.append(p)
    return out


# Four nodes' (HTTP, gRPC) ports, shared by every cluster of the module.
PORTS = _free_ports(8)
NODES = [(f"127.0.0.1:{PORTS[2 * i]}", f"127.0.0.1:{PORTS[2 * i + 1]}") for i in range(4)]


def _env(i):
    http_addr, grpc_addr = NODES[i]
    return {
        "GUBER_HTTP_ADDRESS": http_addr,
        "GUBER_GRPC_ADDRESS": grpc_addr,
        "GUBER_CACHE_SIZE": "4096",
        "GUBER_GLOBAL_SYNC_WAIT": "3600s",
        "GUBER_TRACE_SAMPLE": "0",
        "GUBER_BATCH_TIMEOUT": "10s",
        "GUBER_GLOBAL_TIMEOUT": "10s",
        "GUBER_CIRCUIT_THRESHOLD": "2",
        "GUBER_CIRCUIT_OPEN_INTERVAL": "600s",
        "GUBER_FORWARD_RETRY_LIMIT": "1",
        "GUBER_RETRY_BACKOFF_BASE": "1ms",
        "GUBER_RETRY_BACKOFF_MAX": "2ms",
        "GUBER_RESHARD_HANDOFF": "0",
    }


def _start(kind, i, clock):
    if kind == "jax":
        conf = jcfg.setup_daemon_config(env=_env(i))
        cls = JDaemon
    else:
        conf = tcfg.setup_daemon_config(env={**_env(i), "GUBER_TORCH_DEVICE": "cpu"})
        cls = TDaemon
    conf.warmup_shapes = []
    return cls(conf, clock=clock).start()


class _Ends:
    def __init__(self, daemon):
        self.d = daemon
        self.channel = grpc.insecure_channel(daemon.grpc.address)

    def http(self, path, raw=b"", method="POST"):
        host, _, port = self.d.gateway.address.rpartition(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=TIMEOUT)
        try:
            conn.request(method, path, body=raw if method == "POST" else None)
            r = conn.getresponse()
            return r.status, r.getheader("Content-Type"), r.read()
        finally:
            conn.close()

    def rpc(self, method, raw, resp_cls):
        try:
            out = self.channel.unary_unary(method)(raw, timeout=TIMEOUT)
        except grpc.RpcError as e:
            return "error", e.code(), e.details()
        return "ok", resp_cls.FromString(out).SerializeToString(deterministic=True)

    def close(self):
        self.channel.close()


# ---------------------------------------------------------------------
# Seeded traffic
# ---------------------------------------------------------------------
def _keys(rng, n, space=240, prefix="k"):
    return [f"{int(k)}{prefix}" for k in rng.integers(0, space, n)]


def _json_body(rng, n, beh_nb=0.1, owned=()):
    """n seeded lanes, then one lane for each unique key in `owned`."""
    lanes = []
    for uk in _keys(rng, n):
        lane = {"name": str(rng.choice(["acct", "api"])), "uniqueKey": uk,
                "hits": str(int(rng.integers(0, 4))), "limit": str(int(rng.choice([5, 20, 1000]))),
                "duration": "60000",
                "algorithm": str(rng.choice(["TOKEN_BUCKET", "LEAKY_BUCKET"]))}
        if rng.random() < beh_nb:
            lane["behavior"] = NB
        lanes.append(lane)
    for uk in owned:
        lanes.append({"name": "acct", "uniqueKey": uk, "hits": "1", "limit": "20",
                      "duration": "60000"})
    return json.dumps({"requests": lanes}).encode()


def _owned_by(daemon, addr, n):
    """The first n unique keys "{j}p" whose "acct" lane `addr` owns.  The
    ports, and so the ring, are the module's: every cluster gets the
    same keys."""
    out = []
    j = 0
    while len(out) < n:
        if daemon.service.get_peer(f"acct_{j}p").info.grpc_address == addr:
            out.append(f"{j}p")
        j += 1
    return out


def _frame_cols(rng, n):
    return ([str(rng.choice(["acct", "api"])) for _ in range(n)], _keys(rng, n),
            rng.integers(0, 2, n).astype(np.int32), np.zeros(n, np.int32),
            rng.integers(0, 4, n).astype(np.int64),
            rng.choice([5, 20, 1000], n).astype(np.int64), np.full(n, 60_000, np.int64))


def _v1(rng, n):
    return GetRateLimitsRequest(requests=[
        RateLimitRequest(name="acct", unique_key=uk, hits=int(rng.integers(0, 3)),
                         limit=10, duration=60_000, algorithm=int(rng.integers(0, 2)))
        for uk in _keys(rng, n)])


def _traffic(ends, rng, clock, steps, out, tag):
    """Seeded requests to the nodes in turn, one at a time; each answer
    appended to `out`."""
    for s in range(steps):
        e = ends[s % len(ends)]
        kind = s % 4
        if kind == 0:
            out.append((tag, s, e.http("/v1/GetRateLimits", _json_body(rng, 30))))
        elif kind == 1:
            out.append((tag, s, e.http("/v1/GetRateLimits", _json_body(rng, 1, beh_nb=0.5))))
        elif kind == 2:
            raw = jwire.encode_ingress_frame(_frame_cols(rng, 60))
            out.append((tag, s, e.http("/v1/GetRateLimits", raw)))
        else:
            raw = jwire.get_rate_limits_req_to_pb(_v1(rng, 25)).SerializeToString()
            out.append((tag, s, e.rpc(V1 + "GetRateLimits", raw, pb.GetRateLimitsResp)))
        clock.advance(250)


def _global_body(nodes_hits, i, read=False):
    return json.dumps({"requests": [
        {"name": "glob", "uniqueKey": f"{k}g", "hits": "0" if read else str(nodes_hits[k]),
         "limit": "1000", "duration": "60000", "behavior": "GLOBAL"}
        for k in range(16)]}).encode()


def _rows(daemon, now):
    cols = daemon.service.store.snapshot_columns(now)
    return {k: (int(cols.algorithm[i]), int(cols.status[i]), int(cols.limit[i]),
                int(cols.remaining[i]), int(cols.duration[i]), int(cols.stamp[i]),
                int(cols.expire_at[i]))
            for i, k in enumerate(cols.keys)}


def _run_cluster(kinds):
    """One cluster of `kinds` (three nodes; the fourth, joining, is a
    port node unless every node is JAX): every phase's answers."""
    clock = Clock()
    clock.freeze(NOW)
    rng = np.random.default_rng(2024)
    res = {"forward": [], "global": [], "join": [], "window": [], "partition": []}
    daemons = []
    ends = []
    try:
        for i, kind in enumerate(kinds):
            daemons.append(_start(kind, i, clock))
        infos = [d.peer_info for d in daemons]
        for d in daemons:
            d.set_peers(infos)
        for d in daemons:
            assert d.service.reshard.wait_idle(timeout_s=TIMEOUT)
        ends = [_Ends(d) for d in daemons]

        # (a) forwarding
        _traffic(ends, rng, clock, 16, res["forward"], "forward")

        # (b) GLOBAL: hits at every node, two rounds of syncs, reads.
        for i, e in enumerate(ends):
            hits = [int(h) for h in rng.integers(1, 5, 16)]
            res["global"].append(("hits", i, e.http("/v1/GetRateLimits", _global_body(hits, i))))
        for _ in range(2):
            for d in daemons:
                d.service.global_mgr.run_once()
        for i, e in enumerate(ends):
            res["global"].append(("read", i, e.http("/v1/GetRateLimits",
                                                    _global_body(None, i, read=True))))

        # (c) a fourth node joins; the double-dispatch window is open.
        joiner = _start("jax" if set(kinds) == {"jax"} else "torch", 3, clock)
        daemons.append(joiner)
        ends.append(_Ends(joiner))
        for d in daemons:
            d.service.conf.behaviors.reshard_handoff_s = 600.0
        infos = [d.peer_info for d in daemons]
        # The joiner learns the ring first: a transfer reaching it under
        # its old ring would be fenced (409) and abort.
        for d in [joiner] + daemons[:3]:
            d.set_peers(infos)
        for d in daemons:
            assert d.service.reshard.wait_idle(timeout_s=TIMEOUT)
            assert d.service.reshard.transfers_aborted == 0
        now = clock.now_ms()
        rows = [_rows(d, now) for d in daemons]
        owners = {}
        for k in set().union(*rows):
            if k.startswith("glob_") or k.startswith("__warmup__"):
                continue
            owners[k] = daemons[0].service.get_peer(k).info.grpc_address
        res["owners"] = owners
        res["resident"] = {k: [addr for d, addr in zip(daemons, [n[1] for n in NODES])
                               if d.service.store.resident_mask([k])[0]]
                           for k in owners}
        res["join"].append(("rows", rows))
        res["join"].append(("owners", sorted(owners.items())))
        res["join"].append(("moved", [d.service.reshard.lanes_moved for d in daemons],
                            [d.service.reshard.lanes_received for d in daemons]))
        for i, d in enumerate(daemons):
            assert d.service.debug_status()["ring"]["handoffActive"] is True
        _traffic(ends, rng, clock, 8, res["window"], "window")
        for d in daemons:
            # Close the window before the partition: its peeks would
            # share the partitioned peer's window with the forwards.
            with d.service._peer_mutex:  # noqa: SLF001
                d.service._handoff_deadline = time.monotonic()  # noqa: SLF001

        # (d) node 0 partitioned from node 2.  Each batch carries a lane
        # node 2 owns, whatever the ring: the first opens the breaker,
        # the second meets it open and degrades.
        part_keys = _owned_by(daemons[0], NODES[2][1], 2)
        plan = (jfaults if kinds[0] == "jax" else tfaults).FaultPlan(seed=5)
        plan.partition(NODES[2][1])
        for p in daemons[0].service.get_peer_list():
            if p.info.grpc_address == NODES[2][1]:
                p.faults = plan
        for s in range(4):
            body = (_json_body(rng, 1, beh_nb=0.0) if s % 2 else
                    _json_body(rng, 12, beh_nb=0.0, owned=[part_keys[s // 2]]))
            res["partition"].append(("req", s, ends[0].http("/v1/GetRateLimits", body)))
        res["partition"].append(("health", ends[0].http("/v1/HealthCheck", method="GET")))
        st, _, page = ends[0].http("/metrics", method="GET")
        res["partition"].append(("breaker", st, sorted(
            line for line in page.decode().splitlines()
            if line.startswith("gubernator_circuit_breaker_state{"))))
        res["partition"].append(("status", [
            (p["peer"], p["breaker"]) for p in daemons[0].service.debug_status()["peers"]]))
    finally:
        for e in ends:
            e.close()
        for d in daemons:
            d.close()
    return res


@pytest.fixture(scope="module")
def clusters():
    out = {}
    for name, kinds in (("jax", ["jax"] * 3), ("torch", ["torch"] * 3),
                        ("mixed", ["torch", "jax", "torch"])):
        out[name] = _run_cluster(kinds)
    yield out
    from gubernator_tpu import tracing as jtracing
    from gubernator_tpu_torch import tracing as ttracing

    jtracing.set_sample_rate(0.0)
    ttracing.set_sample_rate(0.0)


def _same(clusters, name, phase):
    ref, got = clusters["jax"][phase], clusters[name][phase]
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert a == b, (phase, a[:2], str(a)[:600], str(b)[:600])


@pytest.mark.parametrize("name", ["torch", "mixed"])
def test_forwarded_and_local_lanes_match_jax(clusters, name):
    _same(clusters, name, "forward")
    owners = set()
    for _tag, _s, ans in clusters[name]["forward"]:
        if ans[0] == 200 and ans[1] == "application/json":
            for r in json.loads(ans[2])["responses"]:
                owners.add(r.get("metadata", {}).get("owner"))
    # Lanes answered here and lanes forwarded to each other node.
    assert {n[1] for n in NODES[:3]} <= owners


@pytest.mark.parametrize("name", ["torch", "mixed"])
def test_global_plane_after_sync_matches_jax(clusters, name):
    _same(clusters, name, "global")
    reads = [json.loads(a[2][2])["responses"] for a in clusters[name]["global"]
             if a[0] == "read"]
    # Every node reads the owner's counter after the syncs.
    for r in reads[1:]:
        assert [x["remaining"] for x in r] == [x["remaining"] for x in reads[0]]
    assert any(x["remaining"] != "1000" for x in reads[0])


@pytest.mark.parametrize("name", ["torch", "mixed"])
def test_joining_node_takes_its_rows(clusters, name):
    _same(clusters, name, "join")
    c = clusters[name]
    for k, owner in c["owners"].items():
        assert c["resident"][k] == [owner], k
    moved, received = next(x for x in c["join"] if x[0] == "moved")[1:]
    assert sum(moved) == received[3] > 0


@pytest.mark.parametrize("name", ["torch", "mixed"])
def test_reads_inside_the_handoff_window_match_jax(clusters, name):
    _same(clusters, name, "window")


@pytest.mark.parametrize("name", ["torch", "mixed"])
def test_partitioned_peer_matches_jax(clusters, name):
    _same(clusters, name, "partition")
    part = clusters[name]["partition"]
    bodies = [json.loads(a[2][2]) for a in part if a[0] == "req"]
    meta = [r.get("metadata", {}) for b in bodies for r in b["responses"]]
    assert any(m.get("degraded") == "true" for m in meta)
    health = json.loads(next(a for a in part if a[0] == "health")[1][2])
    assert health["status"] == "unhealthy"
    breaker = next(a for a in part if a[0] == "breaker")[2]
    assert f'gubernator_circuit_breaker_state{{peer="{NODES[2][1]}"}} 2.0' in breaker
    assert (NODES[2][1], "open") in next(a for a in part if a[0] == "status")[1]
