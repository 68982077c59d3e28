"""The port's V1Service against the JAX V1Service.

The JAX service is built as tests/test_columnar.py builds it (one
self-owning peer, frozen clock); the port's runs on the CPU with the
same cache size, so both have S = 8 shards of the same capacity.  The
same requests go through `get_rate_limits` and
`get_rate_limits_columns` on both, and every response must be identical
(tolerance 0: all integer), field by field, `limit` echo included.
"""

import numpy as np
import pytest

from gubernator_tpu.config import BehaviorConfig
from gubernator_tpu.service import IngressColumns as JaxColumns
from gubernator_tpu.service import ServiceConfig as JaxConfig
from gubernator_tpu.service import V1Service as JaxService
from gubernator_tpu.types import PeerInfo
from gubernator_tpu.utils.clock import Clock as JaxClock
from gubernator_tpu_torch.service import (
    ApiError,
    IngressColumns,
    ServiceConfig,
    V1Service,
)
from gubernator_tpu_torch.types import (
    Algorithm,
    Behavior,
    GetRateLimitsRequest,
    RateLimitRequest,
    Status,
)
from gubernator_tpu_torch.utils.clock import Clock

NOW = 1_573_430_400_000


@pytest.fixture
def services():
    jclock = JaxClock()
    jclock.freeze(NOW)
    # GLOBAL syncs run only when a test calls run_once on both.
    jsvc = JaxService(JaxConfig(cache_size=4096, clock=jclock,
                                behaviors=BehaviorConfig(global_sync_wait_s=3600.0),
                                advertise_address="127.0.0.1:9999"))
    jsvc.set_peers([PeerInfo(grpc_address="127.0.0.1:9999", is_owner=True)])
    tclock = Clock()
    tclock.freeze(NOW)
    tsvc = V1Service(ServiceConfig(cache_size=4096, clock=tclock, device="cpu",
                                   global_sync_wait_s=3600.0))
    yield jsvc, tsvc, jclock, tclock
    jsvc.close()
    tsvc.close()


def _jax_requests(reqs):
    from gubernator_tpu.types import GetRateLimitsRequest as JReq
    from gubernator_tpu.types import RateLimitRequest as JR

    return JReq(requests=[JR(**vars(r)) for r in reqs])


def _same(jresps, tresps):
    assert len(jresps) == len(tresps)
    for a, b in zip(jresps, tresps):
        assert (a.status, a.limit, a.remaining, a.reset_time, a.error) == (
            b.status, b.limit, b.remaining, b.reset_time, b.error)


def both_requests(svcs, reqs):
    jsvc, tsvc = svcs[0], svcs[1]
    a = jsvc.get_rate_limits(_jax_requests(reqs)).responses
    b = tsvc.get_rate_limits(GetRateLimitsRequest(requests=reqs)).responses
    _same(a, b)
    return b


def both_columns(svcs, names, keys, algo, beh, hits, limit, duration):
    jsvc, tsvc = svcs[0], svcs[1]
    n = len(names)
    arrs = dict(
        algorithm=np.asarray(algo, np.int32) * np.ones(n, np.int32),
        behavior=np.asarray(beh, np.int32) * np.ones(n, np.int32),
        hits=np.asarray(hits, np.int64) * np.ones(n, np.int64),
        limit=np.asarray(limit, np.int64) * np.ones(n, np.int64),
        duration=np.asarray(duration, np.int64) * np.ones(n, np.int64),
    )
    a = jsvc.get_rate_limits_columns(JaxColumns(names=list(names), unique_keys=list(keys), **arrs))
    b = tsvc.get_rate_limits_columns(IngressColumns(names=list(names), unique_keys=list(keys), **arrs))
    _same([a.response_at(i) for i in range(n)], [b.response_at(i) for i in range(n)])
    return [b.response_at(i) for i in range(n)]


def advance(svcs, ms):
    svcs[2].advance(ms)
    svcs[3].advance(ms)


def req(key, hits=1, limit=5, duration=10_000, algo=Algorithm.TOKEN_BUCKET,
        behavior=0, name="svc"):
    return RateLimitRequest(name=name, unique_key=key, hits=hits, limit=limit,
                            duration=duration, algorithm=algo, behavior=behavior)


def test_token_bucket_drains_to_over_limit(services):
    for _ in range(6):
        r = both_requests(services, [req("drain", hits=1, limit=5)])
    assert r[0].status == Status.OVER_LIMIT
    advance(services, 10_001)
    r = both_requests(services, [req("drain", hits=1, limit=5)])
    assert r[0].status == Status.UNDER_LIMIT and r[0].remaining == 4


def test_leaky_bucket_and_limit_echo(services):
    reqs = [req(f"l{i}", hits=2, limit=4 + i, algo=Algorithm.LEAKY_BUCKET)
            for i in range(6)]
    for step in range(4):
        r = both_requests(services, reqs)
        advance(services, 1_500)
    assert [x.limit for x in r] == [4 + i for i in range(6)]
    names = ["lc"] * 8
    keys = [f"k{i % 3}" for i in range(8)]  # duplicates in one batch
    for _ in range(3):
        both_columns(services, names, keys, Algorithm.LEAKY_BUCKET, 0, 1,
                     np.arange(8) + 2, 4000)
        advance(services, 700)


def test_validation_errors_and_gregorian_errors(services):
    reqs = [req("ok"), req(""), req("x", name=""),
            req("g", behavior=Behavior.DURATION_IS_GREGORIAN, duration=99),
            req("d", behavior=Behavior.DURATION_IS_GREGORIAN, duration=1)]
    r = both_requests(services, reqs)
    assert r[1].error == "field 'unique_key' cannot be empty"
    assert r[2].error == "field 'namespace' cannot be empty"
    assert r[3].error != "" and r[4].error == ""
    r = both_columns(services, ["a", "a", "", "a"], ["1", "", "3", "4"], 0, 0, 1, 5, 1000)
    assert r[1].error and r[2].error and not r[0].error


def test_reset_remaining_and_no_batching(services):
    keys = ["r1", "r2", "r1", "r3"]
    both_columns(services, ["rr"] * 4, keys, 0, 0, 2, 10, 60_000)
    beh = np.array([Behavior.RESET_REMAINING, 0, Behavior.NO_BATCHING, 0])
    both_columns(services, ["rr"] * 4, keys, 0, beh, 3, 10, 60_000)
    # r1 was removed by the RESET lane above, so this RESET finds no live
    # bucket and creates one (hits 1); the next lane takes 4 more.
    r = both_requests(services, [req("r1", behavior=Behavior.RESET_REMAINING, limit=10),
                                 req("r1", hits=4, limit=10)])
    assert r[1].remaining == 5


def test_mixed_batch_columns_and_requests(services):
    rng = np.random.default_rng(3)
    for step in range(5):
        n = 40
        keys = [f"m{k}" for k in rng.integers(0, 25, n)]
        algo = rng.integers(0, 2, n)
        hits = rng.integers(0, 4, n)
        limit = rng.choice([3, 8, 20], n)
        both_columns(services, ["mix"] * n, keys, algo, 0, hits, limit, 5000)
        reqs = [req(keys[i], hits=int(hits[i]), limit=int(limit[i]), algo=int(algo[i]),
                    duration=5000, name="mix") for i in range(n)]
        both_requests(services, reqs)
        advance(services, 900)


def test_global_lane_gets_not_ported_error(services):
    """GLOBAL lanes, which the port once refused with a not-ported
    error, now answer as the JAX service's do: mixed batches with
    duplicate GLOBAL and plain lanes through both entry points, a
    GLOBAL sync (run_once) on both services after every step, and the
    replica columns and sync results compared too."""
    jsvc, tsvc = services[0], services[1]
    G, NB = int(Behavior.GLOBAL), int(Behavior.NO_BATCHING)
    rng = np.random.default_rng(11)
    for step in range(4):
        n = 12
        keys = [f"g{k}" for k in rng.integers(0, 5, n)]
        beh = rng.choice([0, G, G, G | NB, NB], n)
        hits = rng.integers(0, 4, n)
        algo = rng.integers(0, 2, n)
        r = both_columns(services, ["gl"] * n, keys, algo, beh, hits, 6, 4000)
        assert all(not x.error for x in r)
        reqs = [req(keys[i], hits=int(hits[i]), limit=6, duration=4000,
                    algo=int(algo[i]), behavior=int(beh[i]), name="gl")
                for i in range(n)]
        both_requests(services, reqs)
        both_requests(services, [req("solo", behavior=G, limit=3)])
        assert jsvc.global_mgr.run_once() == tsvc.global_mgr.run_once()
        for a, b in zip(jsvc.store.gcols, tsvc.store.gcols):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        advance(services, 700)
    r = both_requests(services, [req("solo", behavior=G, limit=3, hits=0)])
    assert r[0].remaining == 0 and not r[0].error


def test_batch_cap_and_health(services):
    jsvc, tsvc = services[0], services[1]
    with pytest.raises(ApiError):
        tsvc.get_rate_limits(GetRateLimitsRequest(requests=[req(f"k{i}") for i in range(1001)]))
    h = tsvc.health_check()
    assert h.status == jsvc.health_check().status == "healthy"
    assert h.peer_count == 1
