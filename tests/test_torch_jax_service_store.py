"""The JAX V1Service over the port's stores (the store hooks' milestone).

The JAX package's service takes any store (`ServiceConfig(store=...)`).
Here it runs over each of the port's store forms on the CPU (a
MeshBucketStore with and without a back tier, a ShardStore, and the
mesh and one-shard stores with a Store SPI; a two-tier table with a
Store SPI is refused by both packages) beside a JAX service over the
matching JAX store.  The same seeded traffic goes through
`get_rate_limits`, `get_rate_limits_columns` and
`get_rate_limits_columns_async`; every answer must be identical
(tolerance 0), and so must the hooks the JAX service reads from its
store: `occupancy_stats`, `pipeline_depth`, `describe_topology`, the
stage counts of `take_pipeline_stats`, the batches launched, and the
Store SPI's calls.

Batches staged at the same time may meet at a store's launch gate and
launch as one fused group, whose launch stage counts once; whether two
batches meet depends on thread timing (a request's NO_BATCHING lanes
launch at once beside its windowed ones), on either package.  So the
launch stage is held by the batches launched (the sum of the groups'
sizes, counted at `_launch_group`), which no timing can move; every
other stage count is compared as it is.

The JAX batcher stages its sampled batch traces in the JAX package's
tracing module, which the port store does not read: spans are not
compared here (tests/test_torch_batchers.py holds the port service's).
"""

import threading

import numpy as np
import pytest

from gubernator_tpu import store as jspi
from gubernator_tpu.config import BehaviorConfig
from gubernator_tpu.models.shard import ShardStore as JaxShard
from gubernator_tpu.parallel.mesh import MeshBucketStore as JaxMesh
from gubernator_tpu.service import IngressColumns as JaxColumns
from gubernator_tpu.service import ServiceConfig as JaxConfig
from gubernator_tpu.service import V1Service as JaxService
from gubernator_tpu.types import Behavior, GetRateLimitsRequest, PeerInfo, RateLimitRequest
from gubernator_tpu.utils.clock import Clock
from gubernator_tpu_torch import store as tspi
from gubernator_tpu_torch.models.shard import ShardStore
from gubernator_tpu_torch.parallel.mesh import MeshBucketStore

NOW = 1_573_430_400_000
G, NB = int(Behavior.GLOBAL), int(Behavior.NO_BATCHING)
RESET, GREG = int(Behavior.RESET_REMAINING), int(Behavior.DURATION_IS_GREGORIAN)

FORMS = ["mesh", "mesh_two_tier", "shard", "mesh_spi", "shard_spi"]


def _stores(form):
    """(JAX store, port store, JAX MockStore or None, port MockStore or None)."""
    spi = form.endswith("_spi")
    js, ts = (jspi.MockStore(), tspi.MockStore()) if spi else (None, None)
    if form.startswith("mesh"):
        back = 32 if form == "mesh_two_tier" else 0
        C = 16 if back else 64
        return (JaxMesh(capacity_per_shard=C, g_capacity=4096, store=js,
                        back_capacity_per_shard=back),
                MeshBucketStore(capacity_per_shard=C, g_capacity=4096, store=ts,
                                back_capacity_per_shard=back, device="cpu"),
                js, ts)
    return (JaxShard(capacity=256, store=js), ShardStore(capacity=256, store=ts, device="cpu"),
            js, ts)


def _service(store):
    clock = Clock()
    clock.freeze(NOW)
    svc = JaxService(JaxConfig(store=store, clock=clock,
                               behaviors=BehaviorConfig(global_sync_wait_s=3600.0),
                               advertise_address="127.0.0.1:9999"))
    svc.set_peers([PeerInfo(grpc_address="127.0.0.1:9999", is_owner=True)])
    return svc, clock


def _traffic(seed, steps=6):
    """Seeded steps of (kind, payload): dataclass requests, column
    requests and async column requests.  Keys of GLOBAL lanes never
    appear in the same request's batched lanes (their relative order is
    the window's, tests/test_torch_batchers.py)."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        for kind in ("requests", "columns", "async"):
            n = int(rng.choice([1, 3, 9, 40]))
            keys = [f"k{int(k)}" for k in rng.zipf(1.3, n) % 150]
            beh = rng.choice([0, 0, 0, NB, RESET, GREG], n).astype(np.int32)
            dur = np.where(beh == GREG, 1, rng.choice([2_000, 60_000], n)).astype(np.int64)
            glob = rng.random(n) < 0.15
            beh[glob] = G
            keys = [f"g{k}" if g else k for k, g in zip(keys, glob)]
            cols = dict(
                names=["a1"] * n, unique_keys=keys,
                algorithm=rng.integers(0, 2, n).astype(np.int32), behavior=beh,
                hits=rng.integers(0, 4, n).astype(np.int64),
                limit=rng.choice([5, 20, 1000], n).astype(np.int64), duration=dur)
            out.append((kind, cols, int(rng.choice([0, 0, 300, 2_500]))))
    return out


def _answers(svc, clock, traffic):
    got = []
    for kind, cols, advance in traffic:
        n = len(cols["names"])
        if kind == "requests":
            reqs = [RateLimitRequest(name=cols["names"][i], unique_key=cols["unique_keys"][i],
                                     hits=int(cols["hits"][i]), limit=int(cols["limit"][i]),
                                     duration=int(cols["duration"][i]),
                                     algorithm=int(cols["algorithm"][i]),
                                     behavior=int(cols["behavior"][i])) for i in range(n)]
            resps = svc.get_rate_limits(GetRateLimitsRequest(requests=reqs)).responses
        elif kind == "columns":
            res = svc.get_rate_limits_columns(JaxColumns(**cols))
            resps = [res.response_at(i) for i in range(n)]
        else:
            box, done = [], threading.Event()
            svc.get_rate_limits_columns_async(
                JaxColumns(**cols), lambda r, e: (box.append((r, e)), done.set()))
            assert done.wait(30.0), "async callback never fired"
            res, exc = box[0]
            assert exc is None, exc
            resps = [res.response_at(i) for i in range(n)]
        got.append([(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in resps])
        clock.advance(advance)
    return got


def _count_launched(store):
    """Count the batches each launch group carries (both packages'
    stores launch a group through `_launch_group(group)`)."""
    counts = {"batches": 0, "groups": 0}
    launch = store._launch_group

    def counted(group):
        counts["groups"] += 1
        counts["batches"] += len(group)
        return launch(group)

    store._launch_group = counted
    return counts


@pytest.mark.parametrize("form", FORMS)
def test_jax_service_answers_over_port_stores(form):
    jstore, tstore, jmock, tmock = _stores(form)
    jlaunched, tlaunched = _count_launched(jstore), _count_launched(tstore)
    jsvc, jclock = _service(jstore)
    tsvc, tclock = _service(tstore)
    try:
        traffic = _traffic(seed=FORMS.index(form) + 40)
        want = _answers(jsvc, jclock, traffic)
        got = _answers(tsvc, tclock, traffic)
        for step, (a, b) in enumerate(zip(want, got)):
            assert b == a, (form, step)
        assert tstore.occupancy_stats() == jstore.occupancy_stats()
        assert tstore.pipeline_depth() == jstore.pipeline_depth() == 0
        jstats, _, _ = jstore.take_pipeline_stats()
        tstats, depth, _ = tstore.take_pipeline_stats()
        # Every stage but the launch counts once a batch; the launch
        # counts once a group, so both sides are held by the batches
        # their groups carried.
        for stats, launched in ((jstats, jlaunched), (tstats, tlaunched)):
            assert stats.get("launch", (0,))[0] == launched["groups"]
            stats["launch"] = (launched["batches"],)
        # The port also times its plan-lock acquire and counts its C++
        # planner and its wire's lanes and bytes (take_pipeline_stats);
        # the JAX store has none of them.
        port_only = {"prepare.plan_lock_wait", "prepare.planner",
                     "prepare.table_lock_wait", "commit.table_lock_wait",
                     "wire.lanes", "wire.slots", "wire.up_bytes", "wire.down_bytes"}
        assert set(tstats) - set(jstats) <= port_only
        assert ({k: v[0] for k, v in tstats.items() if k not in port_only}
                == {k: v[0] for k, v in jstats.items()})
        if "prepare" in tstats:
            assert tstats["prepare.plan_lock_wait"][0] == tstats["prepare"][0]
        assert tlaunched["batches"] == jlaunched["batches"] == tstats.get("prepare", (0,))[0]
        assert depth == 0
        if form.startswith("mesh"):
            assert tstore.describe_topology() == jstore.describe_topology() == ("cpu", "8")
        if tmock is not None:
            assert tmock.called == jmock.called
            assert sorted(tmock.cache_items) == sorted(jmock.cache_items)
        st, sj = tsvc.debug_status(), jsvc.debug_status()
        assert st["occupancy"] == sj["occupancy"]
        assert st["dispatch"]["inflight"] == sj["dispatch"]["inflight"] == 0
    finally:
        jsvc.close()
        tsvc.close()


def test_two_tier_with_a_store_spi_is_refused_by_both():
    with pytest.raises(ValueError, match="Store SPI"):
        JaxMesh(capacity_per_shard=8, back_capacity_per_shard=8, store=jspi.MockStore())
    with pytest.raises(ValueError, match="Store SPI"):
        MeshBucketStore(capacity_per_shard=8, back_capacity_per_shard=8,
                        store=tspi.MockStore(), device="cpu")


@pytest.mark.parametrize("back", [0, 16])
def test_mesh_load_item_and_warmup_match(back, monkeypatch):
    """load_item routes an item to its owner shard with one row write;
    warmup launches every serving kernel (a dict-wire and a
    per-lane-column batch per shape, of distinct keys and of a key
    repeated) on reserved keys that stay out of snapshots.  Both stores
    must end with the same rows and the same table hits and misses."""
    from gubernator_tpu_torch.ops import buckets, global_ops

    calls = {}
    for mod, names in ((buckets, ("bucket_rounds_dict", "bucket_rounds_cols", "apply_moves")),
                       (global_ops, ("answer_rounds", "global_sync", "set_replica"))):
        for name in names:
            def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **kw)

            monkeypatch.setattr(mod, name, counted)
    jstore = JaxMesh(capacity_per_shard=32, g_capacity=4096, back_capacity_per_shard=back)
    tstore = MeshBucketStore(capacity_per_shard=32, g_capacity=4096,
                             back_capacity_per_shard=back, device="cpu")
    items = []
    for i in range(6):
        algo = i % 2
        value = (jspi.TokenBucketItem(limit=10, duration=60_000, remaining=7 - i,
                                      created_at=NOW) if algo == 0 else
                 jspi.LeakyBucketItem(limit=10, duration=60_000, remaining=3.5,
                                      updated_at=NOW))
        items.append(jspi.CacheItem(algorithm=algo, key=f"load_{i}", value=value,
                                    expire_at=NOW + 60_000))
    for it in items:
        jstore.load_item(it)
        tval = (tspi.TokenBucketItem(**vars(it.value)) if it.algorithm == 0
                else tspi.LeakyBucketItem(**vars(it.value)))
        tstore.load_item(tspi.CacheItem(algorithm=it.algorithm, key=it.key, value=tval,
                                        expire_at=it.expire_at))
    jstore.warmup(NOW, [1, 5])
    tstore.warmup(NOW, [1, 5])
    assert calls == {"answer_rounds": 1, "global_sync": 1, "set_replica": 1,
                     "bucket_rounds_dict": 4, "bucket_rounds_cols": 4,
                     **({"apply_moves": 1} if back else {})}
    jcols, tcols = jstore.snapshot_columns(NOW), tstore.snapshot_columns(NOW)
    assert tcols.keys == jcols.keys and sorted(tcols.keys) == sorted(i.key for i in items)
    for f in ("algorithm", "status", "limit", "remaining", "duration", "stamp", "expire_at"):
        np.testing.assert_array_equal(getattr(tcols, f), np.asarray(getattr(jcols, f)), f)
    assert tstore.occupancy_stats() == jstore.occupancy_stats()
    assert [(t.hits, t.misses) for t in tstore.tables] == [
        (t.hits, t.misses) for t in jstore.tables]
