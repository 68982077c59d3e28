"""The port's clients (gubernator_tpu_torch/client.py) and CLI against
the JAX package's.

Each package's clients drive its own daemon (tests/test_torch_daemon.py
builds the pair: one frozen clock, the same address, static discovery
of itself) with the same seeded checks, and the port's clients also
drive the JAX daemon: every answer must be the same.  `V1Client` over
HTTP and HTTPS, `ColumnsV1Client` (GUBC frames from many concurrent
callers, pipelined on two connections), `GrpcV1Client` via
`dial_v1_server` (V1 GetRateLimits, GetRateLimitsColumns, HealthCheck,
plain and over TLS with the daemon's channel credentials), the
helpers, and the CLI as a subprocess.

Every socket operation, future and join has a bound.
"""

import datetime
import os
import ssl
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from gubernator_tpu import client as jclient
from gubernator_tpu import grpc_server as jgrpc
from gubernator_tpu import types as jtypes
from gubernator_tpu_torch import client as tclient
from gubernator_tpu_torch import grpc_server as tgrpc
from gubernator_tpu_torch import types as ttypes
from tests.test_torch_daemon import ADDR, daemon_env, frame_cols, start_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 30.0


def _requests(types, seed, n, prefix="c"):
    rng = np.random.default_rng(seed)
    return types.GetRateLimitsRequest(requests=[
        types.RateLimitRequest(
            name=str(rng.choice(["acct", "api"])), unique_key=f"{prefix}{int(rng.integers(25))}",
            hits=int(rng.integers(0, 3)), limit=int(rng.choice([4, 50])), duration=60_000,
            algorithm=int(rng.integers(0, 2)),
            behavior=int(rng.choice([0, 0, 0, 1])))
        for _ in range(n)])


def _json(resp):
    return [r.to_json() for r in resp.responses]


def _result(r):
    """A ColumnarResult as plain lists (overrides by lane)."""
    return ([int(x) for x in r.status], [int(x) for x in r.limit],
            [int(x) for x in r.remaining], [int(x) for x in r.reset_time],
            {i: o.to_json() for i, o in sorted(r.overrides.items())})


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jd, td, clock = start_pair(daemon_env(tmp_path_factory.mktemp("client"), "native"))
    try:
        yield jd, td, clock
    finally:
        jd.close()
        td.close()


def test_v1_client_answers_alike(pair):
    jd, td, clock = pair
    jc = jclient.V1Client(jd.gateway.address, timeout_s=TIMEOUT)
    tc = tclient.V1Client(td.gateway.address, timeout_s=TIMEOUT)
    cross = tclient.V1Client(jd.gateway.address, timeout_s=TIMEOUT)
    try:
        for k in range(4):
            a = jc.get_rate_limits(_requests(jtypes, k, 6, "v"))
            b = tc.get_rate_limits(_requests(ttypes, k, 6, "v"))
            assert _json(b) == _json(a), k
            clock.advance(400)
        # The port's client on the JAX daemon: fresh keys on each side.
        a = cross.get_rate_limits(_requests(ttypes, 9, 6, "x"))
        b = tc.get_rate_limits(_requests(ttypes, 9, 6, "x"))
        assert _json(b) == _json(a)
        assert tc.health_check() == tclient.V1Client(td.gateway.address).health_check()
        assert tc.health_check().to_json() == jc.health_check().to_json()
        assert "gubernator_cache_access_count" in tc.metrics_text()
    finally:
        for c in (jc, tc, cross):
            c.close()


def test_columns_client_coalesces_and_answers_alike(pair):
    """64 concurrent callers, each on its own keys, through each
    package's ColumnsV1Client: every Future's answer alike, and the
    blocking get_rate_limits drop-in and submit_columns too."""
    jd, td, clock = pair
    jc = jclient.ColumnsV1Client(jd.gateway.address, timeout_s=TIMEOUT)
    tc = tclient.ColumnsV1Client(td.gateway.address, timeout_s=TIMEOUT)
    try:
        rng = np.random.default_rng(4)
        lanes = [(f"acct", f"cc{c}_{int(rng.integers(5))}", int(rng.integers(0, 3)),
                  int(rng.choice([3, 30])), int(rng.integers(0, 2))) for c in range(64)]

        def run(client):
            def one(lane):
                name, key, hits, limit, algo = lane
                return client.check(name, key, hits=hits, limit=limit, duration=60_000,
                                    algorithm=algo).result(TIMEOUT).to_json()

            with ThreadPoolExecutor(16) as pool:
                return list(pool.map(one, lanes))

        assert run(tc) == run(jc)
        assert _json(tc.get_rate_limits(_requests(ttypes, 5, 7, "cg"))) == _json(
            jc.get_rate_limits(_requests(jtypes, 5, 7, "cg")))
        cols = frame_cols(6, 20, prefix="cs")
        (a, alo, ahi) = jc.submit_columns(cols).result(TIMEOUT)
        (b, blo, bhi) = tc.submit_columns(cols).result(TIMEOUT)
        assert (blo, bhi) == (alo, ahi) == (0, 20)
        assert _result(b) == _result(a)
        assert tc._columnar is True
    finally:
        jc.close()
        tc.close()


def test_grpc_client_answers_alike(pair):
    jd, td, clock = pair
    jc = jclient.dial_v1_server(jd.grpc.address, timeout_s=TIMEOUT)
    tc = tclient.dial_v1_server(td.grpc.address, timeout_s=TIMEOUT)
    try:
        assert _json(tc.get_rate_limits(_requests(ttypes, 7, 9, "g"))) == _json(
            jc.get_rate_limits(_requests(jtypes, 7, 9, "g")))
        cols = frame_cols(8, 30, prefix="gc")
        assert _result(tc.get_rate_limits_columns(cols)) == _result(
            jc.get_rate_limits_columns(cols))
        assert tc.health_check().to_json() == jc.health_check().to_json()
    finally:
        jc.close()
        tc.close()


def test_clients_over_tls(tmp_path):
    """HTTPS and gRPC over TLS: each daemon's self-signed CA, the port's
    `tls.client_context` and `grpc_server.channel_credentials`."""
    from gubernator_tpu import tls as jtls
    from gubernator_tpu_torch import tls as ttls

    jd, td, clock = start_pair(daemon_env(tmp_path, "tls"))
    try:
        jt, tt = jd.conf.tls, td.conf.tls
        assert tt.server_ctx is not None and tt.client_ctx is not None
        jc = jclient.V1Client(jd.gateway.address, timeout_s=TIMEOUT,
                              tls_context=jtls.client_context(ca_file=jt.ca_file))
        tc = tclient.V1Client(td.gateway.address, timeout_s=TIMEOUT,
                              tls_context=ttls.client_context(ca_file=tt.ca_file))
        jg = jclient.dial_v1_server(jd.grpc.address, jgrpc.channel_credentials(jt), TIMEOUT)
        tg = tclient.dial_v1_server(td.grpc.address, tgrpc.channel_credentials(tt), TIMEOUT)
        try:
            assert _json(tc.get_rate_limits(_requests(ttypes, 10, 5, "t"))) == _json(
                jc.get_rate_limits(_requests(jtypes, 10, 5, "t")))
            assert _json(tg.get_rate_limits(_requests(ttypes, 11, 5, "t"))) == _json(
                jg.get_rate_limits(_requests(jtypes, 11, 5, "t")))
            assert tg.health_check().to_json() == jg.health_check().to_json()
            # A client that does not trust the CA is refused.
            plain = tclient.V1Client(td.gateway.address, timeout_s=TIMEOUT,
                                     tls_context=ssl.create_default_context())
            with pytest.raises(ssl.SSLError):
                plain.get_rate_limits(_requests(ttypes, 12, 1, "t"))
            plain.close()
        finally:
            for c in (jc, tc, jg, tg):
                c.close()
    finally:
        jd.close()
        td.close()


def test_helpers_match_jax():
    assert tclient.to_timestamp(datetime.timedelta(seconds=1.5)) == jclient.to_timestamp(
        datetime.timedelta(seconds=1.5)) == 1500
    assert tclient.from_unix_milliseconds(1_573_430_400_000) == jclient.from_unix_milliseconds(
        1_573_430_400_000)
    assert tclient.from_timestamp(0) > datetime.timedelta(days=365 * 50)
    s = tclient.random_string("id-", 12)
    assert s.startswith("id-") and len(s) == 15
    peers = [ttypes.PeerInfo(grpc_address=ADDR)]
    assert tclient.random_peer(peers) is peers[0]
    tclient.sleep_until_reset(ttypes.RateLimitResponse(reset_time=0))  # past: no wait


@pytest.mark.parametrize("columns", [False, True])
def test_cli_drives_the_daemon(pair, columns):
    jd, td, clock = pair
    args = [sys.executable, "-m", "gubernator_tpu_torch.cmd.cli", td.gateway.address,
            "--limits", "40", "--concurrency", "4"] + (["--columns"] if columns else [])
    before = td.service.store.size()
    out = subprocess.run(args, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=90)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith("done: 40 requests")
    assert td.service.store.size() >= before + 40
