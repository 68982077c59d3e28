"""The port's Prometheus families (gubernator_tpu_torch/metrics.py)
against the JAX package's and the golden lists of
scripts/check_metrics_parity.py.

* The families a port `Metrics` registers are exactly the script's
  REFERENCE_PARITY | EXTENSIONS (parsed from the file, which imports the
  JAX package when run), with the JAX family's type and label names.
* A port daemon and a JAX daemon take the same seeded traffic
  (tests/test_torch_daemon.py's exchange, one frozen clock); their
  `GET /metrics` pages carry the same deterministic values: cache size,
  cache hits and misses, request counts by method and status, columnar
  batches, occupancy, ring generation, and the snapshot counters of a
  save at close() and of restores that find a good file, no file and a
  corrupt one.
  Each node's own peer client reports its closed circuit breaker (0).
* The C++ table and the Python SlotTable count hits, misses and
  evictions as the JAX ones do, op for op.
* `ServiceConfig.metrics` is never None on a running service, the
  fields of later slices raise, and the telemetry warmup window behaves
  as JAX's.
"""

import ast
import os

import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from gubernator_tpu import gateway as jgw
from gubernator_tpu import metrics as jmetrics
from gubernator_tpu import telemetry as jtel
from gubernator_tpu_torch import gateway as tgw
from gubernator_tpu_torch import metrics as tmetrics
from gubernator_tpu_torch import telemetry as ttel
from gubernator_tpu_torch.service import ServiceConfig as TConfig
from gubernator_tpu_torch.service import V1Service as TService
from tests.test_torch_daemon import Ends, daemon_env, exchange, start_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parity_sets():
    """REFERENCE_PARITY | EXTENSIONS of scripts/check_metrics_parity.py,
    read from its source."""
    tree = ast.parse(open(os.path.join(ROOT, "scripts", "check_metrics_parity.py")).read())
    sets = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            name = node.targets[0].id
            if name in ("REFERENCE_PARITY", "EXTENSIONS"):
                sets[name] = set(ast.literal_eval(node.value.args[0]))
    assert set(sets) == {"REFERENCE_PARITY", "EXTENSIONS"}
    return sets["REFERENCE_PARITY"] | sets["EXTENSIONS"]


def _shapes(m):
    """{family name: (type, label names)} of a Metrics instance."""
    out = {}
    for v in vars(m).values():
        name = getattr(v, "_name", None)
        if name is not None and hasattr(v, "_labelnames"):
            out[name] = (v._type, tuple(v._labelnames))
    return out


def test_families_equal_the_parity_script_and_jax():
    tm, jm = tmetrics.Metrics(), jmetrics.Metrics()
    exported = {fam.name for fam in tm.registry.collect()}
    assert exported == parity_sets()
    assert _shapes(tm) == _shapes(jm)
    assert len(_shapes(tm)) == len(exported)


# Families whose values a run's traffic fixes (the rest are times,
# rates or process-wide samplers).
DETERMINISTIC = (
    "gubernator_cache_size", "gubernator_cache_access_count",
    "gubernator_grpc_request_counts", "gubernator_ingress_columns_batches",
    "gubernator_occupancy_slots", "gubernator_occupancy_capacity",
    "gubernator_occupancy_evictions", "gubernator_ring_generation",
    "gubernator_ingress_shed", "gubernator_ingress_queue_lanes",
    "gubernator_snapshot_writes", "gubernator_snapshot_restores",
    "gubernator_snapshot_lanes", "gubernator_audit_violations",
    "gubernator_peer_retry_count",
    "gubernator_reshard_transfers", "gubernator_reshard_lanes",
)


def values(text, families=DETERMINISTIC):
    """{(sample name, labels): value} of `families`, from an exposition
    page (`_created` samples are times)."""
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name not in families:
            continue
        for s in fam.samples:
            if not s.name.endswith("_created"):
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def registry_values(m):
    from prometheus_client import generate_latest

    return values(generate_latest(m.registry).decode())


def scrape(ends):
    status, ctype, body = ends.http("/metrics", method="GET")
    assert status == 200 and ctype.startswith("text/plain")
    return body.decode()


def test_daemon_metrics_equal_jax(tmp_path):
    jsnap, tsnap = str(tmp_path / "j.snap"), str(tmp_path / "t.snap")
    env = daemon_env(tmp_path, "native")
    jd, td, clock = start_pair({**env, "GUBER_SNAPSHOT": jsnap},
                               {**env, "GUBER_SNAPSHOT": tsnap})
    try:
        exchange(jd, td, clock, seed=3)
        a, b = Ends(jd), Ends(td)
        try:
            jpage, tpage = scrape(a), scrape(b)
        finally:
            a.close()
            b.close()
        jv, tv = values(jpage), values(tpage)
        assert tv == jv
        # Each node's own PeerClient has a breaker (closed, 0).
        breaker = ("gubernator_circuit_breaker_state",)
        assert values(jpage, breaker) == {
            ("gubernator_circuit_breaker_state", (("peer", "127.0.0.1:9999"),)): 0.0}
        assert values(tpage, breaker) == values(jpage, breaker)
        hits = tv[("gubernator_cache_access_count_total", (("type", "hit"),))]
        misses = tv[("gubernator_cache_access_count_total", (("type", "miss"),))]
        assert hits > 0 and misses > 0
        assert sum(v for (n, lab), v in tv.items()
                   if n == "gubernator_grpc_request_counts_total") > 10
        assert tv[("gubernator_snapshot_restores_total", (("result", "absent"),))] == 1
        assert td.service.conf.metrics is td.service.metrics
    finally:
        jd.close()
        td.close()
    # The save at close(), counted on both.
    jv, tv = registry_values(jd.service.metrics), registry_values(td.service.metrics)
    assert tv == jv
    assert tv[("gubernator_snapshot_writes_total", (("result", "ok"),))] == 1
    assert tv[("gubernator_snapshot_lanes_total", (("direction", "saved"),))] > 0
    # Restores: a good file, then no file, then a corrupt one.
    for case in ("ok", "absent", "rejected"):
        for p in (jsnap, tsnap):
            if case == "absent":
                os.remove(p)
            elif case == "rejected":
                with open(p, "wb") as f:
                    f.write(b"GUBS-not-a-snapshot")
        jd, td, clock = start_pair({**env, "GUBER_SNAPSHOT": jsnap},
                                   {**env, "GUBER_SNAPSHOT": tsnap}, clock=clock)
        try:
            jv, tv = registry_values(jd.service.metrics), registry_values(td.service.metrics)
            assert tv == jv, case
            assert tv[("gubernator_snapshot_restores_total", (("result", case),))] == 1
            if case == "ok":
                assert tv[("gubernator_snapshot_lanes_total",
                           (("direction", "restored"),))] > 0
        finally:
            jd.close()
            td.close()


def _families(page):
    return {f.name for f in text_string_to_metric_families(page.decode())
            if not f.name.endswith("_created")}


def test_metrics_route_negotiates_like_jax(tmp_path):
    """Classic text by default, OpenMetrics when the scraper asks for
    it, with the same content types and families as JAX's route."""
    jd, td, _ = start_pair(daemon_env(tmp_path, "stdlib"))
    try:
        for accept in ("", "text/plain", "application/openmetrics-text; version=1.0.0"):
            hdr = {"Accept": accept}
            a = jgw.handle_request(jd.service, "GET", "/metrics", b"", hdr)
            b = tgw.handle_request(td.service, "GET", "/metrics", b"", hdr)
            assert a[:2] == b[:2], accept
            if "openmetrics" in accept:
                assert b[1].startswith("application/openmetrics-text")
                assert b[2].endswith(b"# EOF\n")
            else:
                assert _families(b[2]) == _families(a[2])
    finally:
        jd.close()
        td.close()


def _table_ops(seed, n_ops=3000):
    rng = np.random.default_rng(seed)
    now = 1_000
    for _ in range(n_ops):
        now += int(rng.integers(0, 40))
        yield (f"k{int(rng.zipf(1.3)) % 300}", now, now + int(rng.integers(1, 400)))


@pytest.mark.parametrize("kind", ["native", "native_two_tier", "python"])
def test_table_hits_and_misses_equal_jax(kind):
    if kind == "python":
        from gubernator_tpu.models.slot_table import SlotTable as J
        from gubernator_tpu_torch.models.slot_table import SlotTable as T
    else:
        from gubernator_tpu.native import NativeSlotTable as J
        from gubernator_tpu_torch.native import NativeSlotTable as T
    j, t = J(64), T(64)
    if kind == "native_two_tier":
        j.enable_back(96)
        t.enable_back(96)
    for step, (key, now, expire) in enumerate(_table_ops(hash(kind) % 1000)):
        js, je = j.lookup_or_assign(key, now)
        ts, te = t.lookup_or_assign(key, now)
        assert (ts, te) == (js, je), step
        j.set_expire(js, expire)
        t.set_expire(ts, expire)
        assert (t.hits, t.misses, t.evictions) == (j.hits, j.misses, j.evictions), step
    assert t.hits > 0 and t.misses > 0 and t.evictions > 0


def test_service_metrics_and_later_slices():
    from gubernator_tpu_torch.utils.clock import Clock

    own = tmetrics.Metrics()
    svc = TService(TConfig(cache_size=64, device="cpu", metrics=own))
    try:
        assert svc.metrics is own and own.slo is svc.slo
    finally:
        svc.close()
    svc = TService(TConfig(cache_size=64, device="cpu"))
    try:
        assert isinstance(svc.metrics, tmetrics.Metrics)
    finally:
        svc.close()
    with pytest.raises(NotImplementedError, match="A6"):
        TService(TConfig(cache_size=64, device="cpu", blackbox_dir="/nonexistent"))
    # The fault plan and the peer credentials reach every peer client.
    from gubernator_tpu_torch import faults as tfaults
    from gubernator_tpu_torch.types import PeerInfo as TPeer

    plan = tfaults.FaultPlan(seed=1)
    svc = TService(TConfig(cache_size=64, device="cpu", clock=Clock(), fault_plan=plan,
                           peer_tls_context="ctx", peer_channel_credentials="creds"))
    try:
        svc.set_peers([TPeer(grpc_address="127.0.0.1:9999", is_owner=True),
                       TPeer(grpc_address="127.0.0.1:1")])
        for p in svc.get_peer_list():
            assert p.faults is plan
            assert (p.tls_context, p.channel_credentials) == ("ctx", "creds")
    finally:
        svc.close()


def test_telemetry_warmup_window_matches_jax():
    """begin_warmup / is_steady / mark_steady / note_program_created as
    JAX's; on the port a build after mark_steady() is a steady-state
    rebuild, one before it is not."""
    try:
        for tel in (jtel, ttel):
            tel.reset(steady=True)
            tel.begin_warmup()
            assert not tel.is_steady()
            tel.note_program_created("build:x")
            tel.mark_steady()
            assert tel.is_steady()
            assert tel.snapshot()["steady"] is True
            assert tel.snapshot()["programsCreated"] == {"build:x": 1}
        ttel.reset(steady=True)
        ttel.begin_warmup()
        ttel.note_compile("build:x", 0.5)
        ttel.mark_steady()
        assert ttel.steady_recompile_count() == 0
        ttel.note_compile("build:x", 0.25)
        assert ttel.steady_recompile_count() == 1
        ttel.note_launch("k_first")
        assert ttel.snapshot()["programsCreated"] == {"first-launch:k_first": 1}
    finally:
        jtel.reset()
        ttel.reset()
