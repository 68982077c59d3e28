"""The federation plane: the port against the JAX package, tolerance 0.

Two tiers, as in tests/test_federation.py:

* The FederationManager over a fake service and fake region owners
  (no device, no sockets), run once on each package with the same
  script: aggregation and flush, the batch-limit kick, encode-once
  across regions, requeue then exactly-once delivery, a timeout-shaped
  drop, the carry bound, a departed region, the unset data centre and
  unroutable keys.  Every batch's frame bytes, each run_once answer,
  the `region` snapshot and the audit ledger's counts must be the same.
* Two-region daemon pairs (one node a region, real sockets, flushes run
  by hand under a 3,600 s window) of JAX/JAX, port/port and both mixed
  pairs: the region frame bytes the sender puts on the wire, the remote
  `remaining`, the ledger and the region families of `/metrics` on
  each side, classic interop in both
  directions (GUBER_REGION_COLUMNS=0 on either side), a partition's
  carry delivered once after the heal, and the seeded DUPLICATE that
  `region_conservation` catches.  Each pair's record must equal the
  JAX/JAX pair's.

Every wait is bounded, and only counts that thread timing cannot move
are compared.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from gubernator_tpu import audit as jaudit
from gubernator_tpu import config as jconfig
from gubernator_tpu import daemon as jdaemon
from gubernator_tpu import faults as jfaults
from gubernator_tpu import federation as jfed
from gubernator_tpu import metrics as jmetrics
from gubernator_tpu import peer_client as jpc
from gubernator_tpu import types as jtypes
from gubernator_tpu.cluster import fast_test_behaviors as jfast
from gubernator_tpu.parallel import region as jregion
from gubernator_tpu.utils.clock import Clock
from gubernator_tpu_torch import audit as taudit
from gubernator_tpu_torch import config as tconfig
from gubernator_tpu_torch import daemon as tdaemon
from gubernator_tpu_torch import faults as tfaults
from gubernator_tpu_torch import federation as tfed
from gubernator_tpu_torch import metrics as tmetrics
from gubernator_tpu_torch import peer_client as tpc
from gubernator_tpu_torch import types as ttypes
from gubernator_tpu_torch.cluster import fast_test_behaviors as tfast
from gubernator_tpu_torch.parallel import region as tregion

PKG = {
    "jax": SimpleNamespace(audit=jaudit, config=jconfig, daemon=jdaemon, faults=jfaults,
                           fed=jfed, metrics=jmetrics, pc=jpc, types=jtypes, fast=jfast,
                           region=jregion),
    "torch": SimpleNamespace(audit=taudit, config=tconfig, daemon=tdaemon, faults=tfaults,
                             fed=tfed, metrics=tmetrics, pc=tpc, types=ttypes, fast=tfast,
                             region=tregion),
}
REGION_COUNTERS = ("region_agg_hits", "region_sent_hits", "region_dropped_hits",
                   "region_admitted_hits", "region_wire_hits", "region_recv_hits",
                   "region_applied_hits")
T0 = 1_700_000_000_000
WAIT_S = 10.0


def _ledger(P):
    snap = P.audit.ledger_snapshot()
    return {c: snap[c] for c in REGION_COUNTERS}


def _delta(after, before):
    return {c: after[c] - before[c] for c in REGION_COUNTERS}


def _snap(mgr):
    s = dict(mgr.snapshot())
    s.pop("lastFlushAgeS")
    return s


# ----------------------------------------------------------------------
# The manager tier: one script, run on each package
# ----------------------------------------------------------------------
class FakePeer:
    """A region owner that records update_region_columns sends; a script
    of exceptions makes it fail first."""

    def __init__(self, P, addr, dc, script=()):
        self.info = P.types.PeerInfo(grpc_address=addr, http_address=f"h-{addr}",
                                     data_center=dc)
        self.batches = []
        self.script = list(script)

    def update_region_columns(self, batch, timeout_s=None, trace_ctx=None):
        if self.script:
            raise self.script.pop(0)
        self.batches.append(batch)


class FakeService:
    def __init__(self, P, peers, data_center="dc-a", batch_limit=1000):
        beh = P.config.BehaviorConfig(multi_region_sync_wait_s=3600.0,
                                      multi_region_batch_limit=batch_limit,
                                      multi_region_timeout_s=5.0)
        self.conf = SimpleNamespace(behaviors=beh, data_center=data_center)
        self.metrics = P.metrics.Metrics()
        self._rp = P.region.RegionPicker()
        for p in peers:
            self._rp.add(p)

    def get_region_picker(self):
        return self._rp

    def _peer_send_ex(self, op, fn):
        try:
            fn()
            return True, None
        except Exception as e:  # noqa: BLE001 — classified by the caller
            return False, e


def _mr(P, key, hits=1):
    return P.types.RateLimitRequest(name="mr", unique_key=key, hits=hits, limit=1000,
                                    duration=60_000, behavior=int(P.types.Behavior.MULTI_REGION))


def _frames(peer):
    return [(b.frame(), b.cols.origin, list(b.cols.unique_keys), b.cols.hits.tolist(),
             b.cols.behavior.tolist()) for b in peer.batches]


def _not_ready(P):
    return P.pc.PeerError("injected", not_ready=True)


def sc_aggregation(P, mgr, svc, peers, out):
    for _ in range(3):
        mgr.queue_hits(_mr(P, "a", hits=2))
    mgr.queue_hits(_mr(P, "b"))
    out["runs"] = [mgr.run_once(), mgr.run_once()]


def sc_encode_once(P, mgr, svc, peers, out):
    mgr.queue_hits(_mr(P, "a", hits=2))
    out["runs"] = [mgr.run_once()]
    out["shared"] = peers[0].batches[0] is peers[1].batches[0]


def sc_requeue(P, mgr, svc, peers, out):
    mgr.queue_hits(_mr(P, "a", hits=3))
    out["runs"] = [mgr.run_once()]
    out["carry_after_fail"] = mgr.snapshot()["carryKeyTotal"]
    mgr.queue_hits(_mr(P, "a", hits=2))
    out["runs"].append(mgr.run_once())


def sc_timeout_drop(P, mgr, svc, peers, out):
    mgr.queue_hits(_mr(P, "a", hits=4))
    out["runs"] = [mgr.run_once()]


def sc_carry_bound(P, mgr, svc, peers, out):
    for i in range(4):
        mgr.queue_hits(_mr(P, f"k{i}"))
    out["runs"] = [mgr.run_once()]
    out["gauge"] = P.audit.gauges_snapshot()[P.audit.REGION_CARRY_GAUGE]


def sc_departed(P, mgr, svc, peers, out):
    mgr.queue_hits(_mr(P, "a", hits=3))
    out["runs"] = [mgr.run_once()]
    svc._rp.remove(peers[0])
    out["runs"].append(mgr.run_once())


def sc_unset_dc(P, mgr, svc, peers, out):
    mgr.queue_hits(_mr(P, "a", hits=3))
    out["runs"] = [mgr.run_once()]


def sc_unroutable(P, mgr, svc, peers, out):
    mgr.queue_hits(_mr(P, "a", hits=2))
    real_pick = svc._rp.pick
    svc._rp.pick = lambda dc, k: None
    out["runs"] = [mgr.run_once()]
    out["carry_unroutable"] = mgr.snapshot()["carryKeyTotal"]
    svc._rp.pick = real_pick
    out["runs"].append(mgr.run_once())


def sc_batch_limit(P, mgr, svc, peers, out):
    for i in range(3):
        mgr.queue_hits(_mr(P, f"k{i}"))
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline and not peers[0].batches:
        time.sleep(0.01)
    # The kick's flush thread holds the flush lock until it is done.
    with mgr._flush_lock:  # noqa: SLF001
        pass


# name -> (scenario, peers as (addr, dc, script kind), service kwargs)
SCENARIOS = {
    "aggregation": (sc_aggregation, [("b:81", "dc-b", None)], {}),
    "batch_limit": (sc_batch_limit, [("b:81", "dc-b", None)], {"batch_limit": 3}),
    "encode_once": (sc_encode_once, [("b:81", "dc-b", None), ("c:81", "dc-c", None)], {}),
    "requeue": (sc_requeue, [("b:81", "dc-b", "not_ready")], {}),
    "timeout_drop": (sc_timeout_drop, [("b:81", "dc-b", "deadline")], {}),
    "carry_bound": (sc_carry_bound, [("b:81", "dc-b", "not_ready")], {}),
    "departed": (sc_departed, [("b:81", "dc-b", "not_ready")], {}),
    "unset_dc": (sc_unset_dc, [], {"data_center": ""}),
    "unroutable": (sc_unroutable, [("b:81", "dc-b", None)], {}),
}


def _run_manager(kind, name, monkeypatch):
    P = PKG[kind]
    fn, peer_specs, kw = SCENARIOS[name]
    if name == "carry_bound":
        monkeypatch.setattr(P.fed, "REGION_CARRY_MAX", 2)
    scripts = {None: [], "not_ready": [_not_ready(P)],
               "deadline": [P.pc.PeerError("deadline", not_ready=False)]}
    peers = [FakePeer(P, a, dc, scripts[s]) for a, dc, s in peer_specs]
    svc = FakeService(P, peers, **kw)
    before = _ledger(P)
    mgr = P.fed.FederationManager(svc)
    out = {}
    try:
        fn(P, mgr, svc, peers, out)
    finally:
        mgr.stop()
    out["ledger"] = _delta(_ledger(P), before)
    out["snapshot"] = _snap(mgr)
    out["frames"] = [_frames(p) for p in peers]
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_manager_matches_jax(name, monkeypatch):
    ref = _run_manager("jax", name, monkeypatch)
    got = _run_manager("torch", name, monkeypatch)
    assert got == ref
    # The scenario did what its name says (the JAX tier's own checks).
    led, snap, frames = got["ledger"], got["snapshot"], got["frames"]
    if name == "aggregation":
        ((frame, origin, keys, hits, beh),) = frames[0]
        assert sorted(zip(keys, hits)) == [("a", 6), ("b", 1)]
        assert origin == "dc-a" and not any(b & int(ttypes.Behavior.MULTI_REGION) for b in beh)
        assert led["region_agg_hits"] == led["region_sent_hits"] == 7
        assert got["runs"] == [True, False]
    elif name == "batch_limit":
        assert len(frames[0]) == 1 and len(frames[0][0][2]) == 3
    elif name == "encode_once":
        assert got["shared"] is True
    elif name == "requeue":
        assert got["carry_after_fail"] == 1 and frames[0][0][3] == [5]
        assert led["region_sent_hits"] == led["region_agg_hits"] == 5
        assert led["region_dropped_hits"] == 0 and snap["carryKeyTotal"] == 0
    elif name == "timeout_drop":
        assert snap["droppedHits"] == led["region_dropped_hits"] == 4
        assert led["region_sent_hits"] == 0
    elif name == "carry_bound":
        assert snap["carryKeyTotal"] == 2 and snap["droppedHits"] == 2
        assert got["gauge"] == 2
    elif name == "departed":
        assert snap["carryKeyTotal"] == 0 and led["region_dropped_hits"] == 3
    elif name == "unset_dc":
        assert got["runs"] == [False] and snap["flushes"] == 0
        assert all(v == 0 for v in led.values())
    elif name == "unroutable":
        assert got["runs"] == [False, True] and got["carry_unroutable"] == 1
        assert frames[0][0][3] == [2] and led["region_sent_hits"] == 2


# ----------------------------------------------------------------------
# The daemon tier: two regions, one node each
# ----------------------------------------------------------------------
def _daemon(kind, dc, clock, region_columns=True, native_http=None):
    P = PKG[kind]
    beh = P.fast()
    beh.multi_region_sync_wait_s = 3600.0
    beh.global_sync_wait_s = 3600.0
    beh.region_columns = region_columns
    kw = {"device": "cpu"} if kind == "torch" else {}
    conf = P.config.DaemonConfig(listen_address="127.0.0.1:0", grpc_listen_address="127.0.0.1:0",
                                 cache_size=4096, global_cache_size=256, data_center=dc,
                                 behaviors=beh, peer_discovery_type="static",
                                 warmup_shapes=[], native_http=native_http, **kw)
    return P.daemon.Daemon(conf, clock=clock).start()


def _hit(d, kind, key, hits):
    P = PKG[kind]
    resp = d.service.get_rate_limits(P.types.GetRateLimitsRequest(requests=[_mr(P, key, hits)]))
    return [(r.status, r.limit, r.remaining, r.error) for r in resp.responses]


def _remaining_on(d, kind, key):
    P = PKG[kind]
    resp = d.service.get_peer_rate_limits(P.types.GetRateLimitsRequest(requests=[
        P.types.RateLimitRequest(name="mr", unique_key=key, hits=0, limit=1000,
                                 duration=60_000)]))
    return resp.responses[0].remaining, resp.responses[0].error


def _tap(d, key):
    """Record the bytes of every region batch the sender's owner client
    for `key` is handed (the frame and the RegionColumnsReq)."""
    client = d.service.get_region_picker().pick("dc-b", f"mr_{key}")
    sent = []
    real = client.update_region_columns

    def tapped(batch, *a, **kw):
        sent.append((batch.frame(),
                     batch.columns_pb().SerializeToString(deterministic=True)))
        return real(batch, *a, **kw)

    client.update_region_columns = tapped
    return client, sent


REGION_FAMILIES = ("gubernator_region_batches", "gubernator_region_carry_keys",
                   "gubernator_region_requeued_hits", "gubernator_region_dropped_hits",
                   "gubernator_peer_retries")


def _region_metrics(d):
    """The node's region families on its /metrics page."""
    from prometheus_client.parser import text_string_to_metric_families

    out = {}
    for fam in text_string_to_metric_families(d.service.metrics.render().decode()):
        if fam.name in REGION_FAMILIES:
            for smp in fam.samples:
                if not smp.name.endswith("_created"):
                    out[(smp.name, tuple(sorted(smp.labels.items())))] = smp.value
    return out


def _audits(pair):
    out = []
    for d in pair:
        d.service.auditor.check_now()
        snap = d.service.auditor.snapshot()
        out.append(dict(snap["violations"]))
    return out


def _step(pair, kinds, key, hits, fn=None):
    """Hits at the sender, one flush, and what each side saw."""
    a, b = pair
    before = (_ledger(PKG[kinds[0]]), _ledger(PKG[kinds[1]]))
    ans = _hit(a, kinds[0], key, hits)
    ran = fn() if fn else a.service.multi_region_mgr.run_once()
    after = (_ledger(PKG[kinds[0]]), _ledger(PKG[kinds[1]]))
    send = _delta(after[0], before[0])
    recv = _delta(after[1], before[1])
    return {
        "answer": ans,
        "ran": ran,
        "sender": {c: send[c] for c in REGION_COUNTERS[:5]},
        "receiver": {c: recv[c] for c in REGION_COUNTERS[5:]},
        "remote": _remaining_on(b, kinds[1], key),
        "carry": a.service.multi_region_mgr.snapshot()["carryKeyTotal"],
    }


def _pair_record(kinds, mode):
    columns = COLUMNS[mode]
    clock = Clock()
    clock.freeze(T0)
    a = _daemon(kinds[0], "dc-a", clock, columns[0])
    b = _daemon(kinds[1], "dc-b", clock, columns[1])
    rec = {}
    try:
        peers = [a.peer_info, b.peer_info]
        a.set_peers(peers)
        b.set_peers(peers)
        Pa = PKG[kinds[0]]
        if mode == "columns":
            client, sent = _tap(a, "e2e")
            rec["e2e"] = _step((a, b), kinds, "e2e", 5)
            rec["e2e_wire"] = list(sent)
            rec["e2e_columnar"] = client._region_columnar  # noqa: SLF001
            st = a.service.debug_status()["region"]
            st.pop("lastFlushAgeS")
            rec["status"] = st
            rec["audit_e2e"] = _audits((a, b))

            # A partition toward the other region carries the flush; the
            # heal delivers the carried hits once.
            plan = Pa.faults.FaultPlan(seed=23)
            rule = plan.partition(b.peer_info.grpc_address, op="UpdateRegionColumns")
            Pa.faults.install(plan)
            try:
                rec["carry_1"] = _step((a, b), kinds, "carry", 3)
                plan.heal(rule.peer)
                rec["carry_2"] = _step((a, b), kinds, "carry", 2)
            finally:
                Pa.faults.uninstall()
            rec["audit_carry"] = _audits((a, b))
        elif mode == "dup":
            # The seeded DUPLICATE on a fresh pair: the wire side
            # doubles, the sending node's auditor fires
            # region_conservation (its first check only seeds).
            client, sent = _tap(a, "dup")
            a.service.auditor.check_now()
            plan = Pa.faults.FaultPlan(seed=17)
            plan.duplicate(op="UpdateRegionColumns")
            Pa.faults.install(plan)
            try:
                rec["dup"] = _step((a, b), kinds, "dup", 4)
            finally:
                Pa.faults.uninstall()
            rec["dup_wire"] = list(sent)
            a.service.auditor.check_now()
            rec["dup_violations"] = a.service.auditor.snapshot()["violations"].get(
                "region_conservation", 0)
        else:
            client, sent = _tap(a, "iop")
            rec["iop_1"] = _step((a, b), kinds, "iop", 4)
            rec["iop_columnar"] = client._region_columnar  # noqa: SLF001
            rec["iop_breaker_open"] = client.breaker.is_open
            rec["iop_health"] = a.service.health_check().status
            rec["iop_2"] = _step((a, b), kinds, "iop", 1)
            rec["iop_wire"] = list(sent)
            rec["audit_iop"] = _audits((a, b))
        rec["metrics"] = [_region_metrics(a), _region_metrics(b)]
    finally:
        a.close()
        b.close()
    return rec


COMBOS = {"torch": ("torch", "torch"), "torch_to_jax": ("torch", "jax"),
          "jax_to_torch": ("jax", "torch")}
COLUMNS = {"columns": (True, True), "dup": (True, True), "classic_receiver": (True, False),
           "classic_sender": (False, True)}


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for mode in COLUMNS:
        out[("jax", mode)] = _pair_record(("jax", "jax"), mode)
        for name, kinds in COMBOS.items():
            out[(name, mode)] = _pair_record(kinds, mode)
    return out


@pytest.mark.parametrize("name", sorted(COMBOS))
def test_region_pair_columnar_wire_matches_jax(pairs, name):
    ref, got = pairs[("jax", "columns")], pairs[(name, "columns")]
    assert got == ref
    e2e = got["e2e"]
    assert got["e2e_columnar"] is True and len(got["e2e_wire"]) == 1
    assert e2e["remote"] == (995, "")
    assert all(v == 5 for v in e2e["sender"].values() if v) and e2e["sender"]["region_sent_hits"] == 5
    assert e2e["receiver"] == {"region_recv_hits": 5, "region_applied_hits": 5}
    assert got["status"]["dataCenter"] == "dc-a" and got["status"]["sentHits"] == 5
    assert got["status"]["regions"] == {"dc-b": {"peers": 1, "breakerOpen": 0}}
    assert got["audit_e2e"] == [{}, {}]
    # The partition carried 3 hits; the heal delivered 3 + 2 once.
    assert got["carry_1"]["carry"] == 1 and got["carry_1"]["remote"] == (1000, "")
    assert got["carry_2"]["carry"] == 0 and got["carry_2"]["remote"] == (995, "")
    assert got["audit_carry"] == [{}, {}]


@pytest.mark.parametrize("name", sorted(COMBOS))
def test_region_pair_duplicate_is_caught_as_in_jax(pairs, name):
    ref, got = pairs[("jax", "dup")], pairs[(name, "dup")]
    assert got == ref
    assert len(got["dup_wire"]) == 1 and got["dup"]["remote"] == (992, "")
    dup = got["dup"]
    assert dup["sender"]["region_admitted_hits"] == 4
    assert dup["sender"]["region_wire_hits"] == 8
    assert got["dup_violations"] >= 1


@pytest.mark.parametrize("cname", ["classic_receiver", "classic_sender"])
@pytest.mark.parametrize("name", sorted(COMBOS))
def test_region_pair_classic_interop_matches_jax(pairs, name, cname):
    ref, got = pairs[("jax", cname)], pairs[(name, cname)]
    assert got == ref
    assert got["iop_columnar"] is False and got["iop_breaker_open"] is False
    assert got["iop_health"] == "healthy"
    assert got["iop_1"]["remote"] == (996, "") and got["iop_2"]["remote"] == (995, "")
    # The classic wire enters the receiver through the peer door, not
    # the region receive.
    assert got["iop_1"]["receiver"]["region_recv_hits"] == 0
    assert got["audit_iop"] == [{}, {}]


# ----------------------------------------------------------------------
# The two edges: HTTP /v1/peer.UpdateRegionColumns and gRPC PeersV1
# ----------------------------------------------------------------------
def _edge_answers(kind, region_columns, native_http):
    import http.client

    import grpc

    from gubernator_tpu import wire as jwire
    from gubernator_tpu.proto import peers_columns_pb2 as pcpb

    clock = Clock()
    clock.freeze(T0)
    d = _daemon(kind, "dc-b", clock, region_columns, native_http)
    rc = jfed.RegionColumns.from_requests("dc-a", [
        _mr(PKG["jax"], f"edge{i}", hits=i + 1) for i in range(5)])
    frame = jwire.encode_region_frame(rc)
    bodies = {
        "frame": frame,
        "not_region": jwire.encode_ingress_frame(rc.peer_columns()),
        "json": b'{"requests": []}',
        "truncated": frame[:-3],
    }
    out = {}
    channel = grpc.insecure_channel(d.grpc.address)
    try:
        host, _, port = d.gateway.address.rpartition(":")
        for name, raw in bodies.items():
            conn = http.client.HTTPConnection(host, int(port), timeout=WAIT_S)
            try:
                conn.request("POST", "/v1/peer.UpdateRegionColumns", body=raw)
                r = conn.getresponse()
                out[("http", name)] = (r.status, r.getheader("Content-Type"), r.read())
            finally:
                conn.close()
        req = jwire.region_cols_to_pb(rc).SerializeToString()
        try:
            raw = channel.unary_unary("/pb.gubernator.PeersV1/UpdateRegionColumns")(
                req, timeout=WAIT_S)
            out["grpc"] = ("ok", pcpb.RegionColumnsResp.FromString(raw).applied)
        except grpc.RpcError as e:
            out["grpc"] = ("error", e.code(), e.details())
        out["rows"] = [_remaining_on(d, kind, f"edge{i}") for i in range(5)]
    finally:
        channel.close()
        d.close()
    return out


@pytest.mark.parametrize("region_columns,native_http", [(True, None), (False, None), (True, True)],
                         ids=["on", "off", "on-native"])
def test_region_edges_answer_as_jax(region_columns, native_http):
    """The stdlib gateway and the native epoll edge (which hands the
    route to the same handler) answer the region route as a JAX node's,
    and PeersV1 over gRPC too, with the plane on and off."""
    ref = _edge_answers("jax", region_columns, native_http)
    got = _edge_answers("torch", region_columns, native_http)
    assert got == ref
    if region_columns:
        assert got[("http", "frame")][0] == 200 and got["grpc"] == ("ok", 5)
        assert got[("http", "not_region")][0] == got[("http", "truncated")][0] == 400
        # Each batch applied once over each edge: hits i + 1, twice.
        assert got["rows"] == [(1000 - 2 * (i + 1), "") for i in range(5)]
    else:
        assert got[("http", "frame")][0] == 404 and got["grpc"][0] == "error"
