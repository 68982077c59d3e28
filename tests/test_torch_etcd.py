"""etcd discovery: the port's EtcdPool against the JAX package's.

Both pools run the same scripted events against a fresh in-process fake
etcd (tests/fake_etcd.py, which decodes with the JAX package's pb
modules, so the port's copies are held to the same wire): registration
through each package's `peers.make_pool("etcd", ...)` (with a 1 s
lease), other peers put
and deleted beside a malformed value, a lease revoked server-side
(keepalive loss, then re-registration with a fresh lease), and close
(delete and revoke).  The sequence of peer lists `on_update` receives,
the keys after each step, the leases granted and the leases revoked
must be the same.  A TLS server with token auth takes each package's
`credentials_from_config` and login.  Every wait is bounded.
"""

import json
import time

import pytest

from gubernator_tpu import config as jconfig
from gubernator_tpu import etcd_pool as jetcd
from gubernator_tpu import peers as jpeers
from gubernator_tpu import types as jtypes
from gubernator_tpu_torch import config as tconfig
from gubernator_tpu_torch import etcd_pool as tetcd
from gubernator_tpu_torch import peers as tpeers
from gubernator_tpu_torch import types as ttypes

from .fake_etcd import FakeEtcd

MOD = {"jax": (jconfig, jetcd, jpeers, jtypes), "torch": (tconfig, tetcd, tpeers, ttypes)}
PREFIX = "/gubernator/peers/"


def wait_until(fn, timeout_s=10.0, every_s=0.02, msg="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(every_s)
    raise AssertionError(f"timed out waiting for {msg}")


class RecordingEtcd(FakeEtcd):
    """The fake etcd, recording every lease it grants and revokes."""

    def __init__(self, **kw):
        self.granted, self.revoked = [], []
        super().__init__(**kw)

    def _do_grant(self, req, ctx):
        resp = super()._do_grant(req, ctx)
        self.granted.append(int(resp.ID))
        return resp

    def _do_revoke(self, req, ctx):
        self.revoked.append(int(req.ID))
        return super()._do_revoke(req, ctx)


def _lists(updates):
    """The peer lists on_update received, consecutive repeats merged
    (a watch response may carry one event or several)."""
    out = []
    for u in updates:
        cur = sorted((p.grpc_address, p.http_address, p.data_center) for p in u)
        if not out or out[-1] != cur:
            out.append(cur)
    return out


def _run(kind):
    config, etcd, peers, types = MOD[kind]
    server = RecordingEtcd()
    updates = []
    rec = {}
    pool = None
    try:
        conf = config.setup_daemon_config(env={
            "GUBER_PEER_DISCOVERY_TYPE": "etcd",
            "GUBER_ETCD_ENDPOINTS": server.address,
            "GUBER_ETCD_ADVERTISE_ADDRESS": "10.0.0.1:81",
        })
        assert etcd.credentials_from_config(conf) is None
        advertise = types.PeerInfo(grpc_address="127.0.0.1:9", http_address="10.0.0.1:80",
                                   data_center="dc-east")
        # make_pool's own pool, with a 1 s lease (a keepalive every
        # 1/3 s) and a short backoff so that the keepalive loss below
        # shows at once.
        real = etcd.EtcdPool
        fast = lambda **kw: real(**kw, lease_ttl_s=1, backoff_s=0.05)  # noqa: E731
        etcd.EtcdPool = fast
        try:
            pool = peers.make_pool("etcd", conf, updates.append, advertise=advertise)
        finally:
            etcd.EtcdPool = real
        assert isinstance(pool, real)
        want = [("10.0.0.1:81", "10.0.0.1:80", "dc-east")]
        wait_until(lambda: _lists(updates)[-1:] == [want], msg="self registered")
        rec["keys_0"] = server.keys()

        client = etcd.EtcdClient([server.address])
        try:
            client.put(PREFIX + "bogus", b"not json{{")
            client.put(PREFIX + "10.0.0.2:81", json.dumps(
                {"grpcAddress": "10.0.0.2:81", "httpAddress": "10.0.0.2:80",
                 "dataCenter": "dc-west"}).encode())
            wait_until(lambda: len(_lists(updates)[-1]) == 2, msg="second peer")
            client.delete(PREFIX + "10.0.0.2:81")
            wait_until(lambda: len(_lists(updates)[-1]) == 1, msg="second peer gone")
        finally:
            client.close()
        rec["keys_1"] = server.keys()

        # Keepalive loss: the lease is revoked server-side, the key goes,
        # and the pool registers again under a fresh lease.
        old = pool._lease_id  # noqa: SLF001
        server.revoke_lease(old)
        wait_until(lambda: pool._lease_id != old  # noqa: SLF001
                   and PREFIX + "10.0.0.1:81" in server.keys(), msg="re-registered")
        wait_until(lambda: _lists(updates)[-1:] == [want], msg="self back")
        rec["keys_2"] = server.keys()
        pool.close()
        rec["keys_closed"] = server.keys()
        pool = None
        rec["granted"], rec["revoked"] = list(server.granted), list(server.revoked)
        rec["lists"] = _lists(updates)
    finally:
        if pool is not None:
            pool.close()
        server.stop()
    return rec


def test_etcd_pool_matches_jax_on_scripted_events():
    ref = _run("jax")
    got = _run("torch")
    assert got == ref
    assert got["keys_0"] == [PREFIX + "10.0.0.1:81"]
    assert got["keys_1"] == got["keys_2"] == [PREFIX + "10.0.0.1:81", PREFIX + "bogus"]
    assert got["keys_closed"] == [PREFIX + "bogus"]
    # Registration, re-registration; close revokes the second lease.
    assert len(got["granted"]) == 2 and got["revoked"] == got["granted"][1:]
    addrs = [[p[0] for p in lst] for lst in got["lists"]]
    assert ["10.0.0.1:81", "10.0.0.2:81"] in addrs


@pytest.fixture
def tls_server(tmp_path):
    import grpc

    from gubernator_tpu import tls as gtls

    ca_crt, ca_key = gtls.self_ca(str(tmp_path))
    crt, key = gtls.self_cert(str(tmp_path), ca_crt, ca_key, name="etcd")
    with open(key, "rb") as f:
        key_pem = f.read()
    with open(crt, "rb") as f:
        crt_pem = f.read()
    s = RecordingEtcd(tls_creds=grpc.ssl_server_credentials([(key_pem, crt_pem)]),
                      auth_users={"guber": "s3cret"})
    s.ca_file = ca_crt
    yield s
    s.stop()


@pytest.mark.parametrize("kind", ["jax", "torch"])
def test_tls_and_auth_register_as_jax(tls_server, kind):
    config, etcd, peers, types = MOD[kind]
    conf = config.setup_daemon_config(env={
        "GUBER_PEER_DISCOVERY_TYPE": "etcd",
        "GUBER_ETCD_ENDPOINTS": f"localhost:{tls_server.port}",
        "GUBER_ETCD_TLS_CA": tls_server.ca_file,
        "GUBER_ETCD_USER": "guber",
        "GUBER_ETCD_PASSWORD": "s3cret",
    })
    assert etcd.credentials_from_config(conf) is not None
    updates = []
    pool = peers.make_pool("etcd", conf, updates.append,
                           advertise=types.PeerInfo(grpc_address="10.1.0.1:81"))
    try:
        wait_until(lambda: updates and len(updates[-1]) == 1, msg="peer update")
        assert updates[-1][0].grpc_address == "10.1.0.1:81"
        assert tls_server.keys() == [PREFIX + "10.1.0.1:81"]
    finally:
        pool.close()
    conf.etcd_password = "wrong"
    with pytest.raises(Exception):
        peers.make_pool("etcd", conf, lambda *_: None,
                        advertise=types.PeerInfo(grpc_address="10.1.0.2:81"))
