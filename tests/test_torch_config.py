"""The port's config.py against the JAX package's, tolerance 0.

Every GUBER_* variable the JAX package's `setup_daemon_config` parses
goes through both, alone and all together, and from an env file; the
resulting DaemonConfig and BehaviorConfig must be equal field by field
(the JAX config's `devices` against the port's `device` aside: one
names JAX devices, the other a torch device).  Every bad value JAX
rejects must be rejected by the port with the same error text.
"""

import dataclasses

import pytest

from gubernator_tpu import config as jcfg
from gubernator_tpu_torch import config as tcfg

VALID = {
    "GUBER_HTTP_ADDRESS": "0.0.0.0:8080",
    "GUBER_GRPC_ADDRESS": "0.0.0.0:8081",
    "GUBER_GRPC_MAX_CONN_AGE_SEC": "30",
    "GUBER_ADVERTISE_ADDRESS": "10.0.0.1:8081",
    "GUBER_GRPC_ADVERTISE_ADDRESS": "10.0.0.2:8081",
    "GUBER_CACHE_SIZE": "2097152",
    "GUBER_BACK_CACHE_SIZE": "1000000",
    "GUBER_GLOBAL_CACHE_SIZE": "8192",
    "GUBER_NATIVE_HTTP": "on",
    "GUBER_NATIVE_WORKERS": "6",
    "GUBER_ACCEPTORS": "4",
    "GUBER_UDS_PATH": "/run/guber.sock",
    "GUBER_DATA_CENTER": "us-east",
    "GUBER_WARMUP_SHAPES": "1, 64,4096",
    "GUBER_DEBUG": "yes",
    "GUBER_PEER_DISCOVERY_TYPE": "etcd",
    "GUBER_PEERS_FILE": "/etc/peers",
    "GUBER_MEMBERLIST_ADDRESS": "0.0.0.0:7946",
    "GUBER_MEMBERLIST_KNOWN_NODES": "a:7946, b:7946,",
    "GUBER_MEMBERLIST_NODE_NAME": "node-1",
    "GUBER_ETCD_ENDPOINTS": "e1:2379, e2:2379",
    "GUBER_ETCD_KEY_PREFIX": "/g/",
    "GUBER_ETCD_ADVERTISE_ADDRESS": "10.0.0.3:81",
    "GUBER_ETCD_USER": "u",
    "GUBER_ETCD_PASSWORD": "p",
    "GUBER_ETCD_TLS_ENABLE": "true",
    "GUBER_ETCD_TLS_CERT": "c.pem",
    "GUBER_ETCD_TLS_KEY": "k.pem",
    "GUBER_ETCD_TLS_CA": "ca.pem",
    "GUBER_ETCD_TLS_SKIP_VERIFY": "1",
    "GUBER_K8S_NAMESPACE": "rl",
    "GUBER_K8S_POD_IP": "10.1.1.1",
    "GUBER_K8S_POD_PORT": "1051",
    "GUBER_K8S_ENDPOINTS_SELECTOR": "app=gubernator",
    "GUBER_K8S_WATCH_MECHANISM": "pods",
    "GUBER_BATCH_TIMEOUT": "1s",
    "GUBER_BATCH_WAIT": "500us",
    "GUBER_BATCH_LIMIT": "800",
    "GUBER_INGRESS_QUEUE_LANES": "4096",
    "GUBER_PEER_COLUMNS": "false",
    "GUBER_INGRESS_COLUMNS": "0",
    "GUBER_NATIVE_INGRESS": "no",
    "GUBER_GLOBAL_TIMEOUT": "250ms",
    "GUBER_GLOBAL_SYNC_WAIT": "50",
    "GUBER_GLOBAL_BATCH_LIMIT": "999",
    "GUBER_GLOBAL_COLUMNS": "FALSE",
    "GUBER_GLOBAL_FANOUT": "3",
    "GUBER_MULTI_REGION_TIMEOUT": "1m30s",
    "GUBER_MULTI_REGION_SYNC_WAIT": "1.5h",
    "GUBER_MULTI_REGION_BATCH_LIMIT": "0",
    "GUBER_REGION_COLUMNS": "true",
    "GUBER_CIRCUIT_THRESHOLD": "2",
    "GUBER_CIRCUIT_OPEN_INTERVAL": "3s",
    "GUBER_FORWARD_RETRY_LIMIT": "7",
    "GUBER_RETRY_BACKOFF_BASE": "10ms",
    "GUBER_RETRY_BACKOFF_MAX": "2s",
    "GUBER_GLOBAL_SEND_RETRIES": "0",
    "GUBER_XLA_TELEMETRY": "0",
    "GUBER_XLA_STORM": "5",
    "GUBER_XLA_STORM_WINDOW": "30s",
    "GUBER_PROFILE": "false",
    "GUBER_PROFILE_HZ": "99.5",
    "GUBER_TENANT_TOPK": "1024",
    "GUBER_AUDIT": "0",
    "GUBER_AUDIT_INTERVAL": "2500",
    "GUBER_RESHARD": "0",
    "GUBER_RESHARD_HANDOFF": "0",
    "GUBER_SNAPSHOT": "/var/lib/guber.snap",
    "GUBER_SNAPSHOT_INTERVAL": "15s",
    "GUBER_BLACKBOX": "0",
    "GUBER_BLACKBOX_MB": "4096",
    "GUBER_BLACKBOX_RETAIN": "1",
    "GUBER_BLACKBOX_DIR": "/var/lib/bb",
    "GUBER_TRACE_SAMPLE": "0.25",
    "GUBER_EXPRESS": "0",
    "GUBER_EXPRESS_QUEUE_DEPTH": "1000000",
    "GUBER_EXPRESS_MAX_LANES": "64",
    "GUBER_EXPRESS_SCALAR": "false",
    "GUBER_LATENCY_TARGET_MS": "7.5",
    "GUBER_SLO_OBJECTIVE": "0.999",
    "GUBER_GOSSIP_SEED": "42",
    "GUBER_STATIC_PEERS": "a:81|a:80, b:81,",
    "GUBER_TLS_CA": "ca.pem",
    "GUBER_TLS_CA_KEY": "ca.key",
    "GUBER_TLS_CERT": "s.pem",
    "GUBER_TLS_KEY": "s.key",
    "GUBER_TLS_AUTO": "true",
    "GUBER_TLS_CLIENT_AUTH": "require-and-verify",
    "GUBER_TLS_CLIENT_AUTH_CA_CERT": "cca.pem",
    "GUBER_TLS_CLIENT_AUTH_CERT": "cc.pem",
    "GUBER_TLS_CLIENT_AUTH_KEY": "cc.key",
    "GUBER_TLS_INSECURE_SKIP_VERIFY": "yes",
}

# Alternative spellings: opt-out words, the other enum values, the
# bounds of every range check, and the discovery modes' requirements.
VARIANTS = [
    {"GUBER_SNAPSHOT": "off"},
    {"GUBER_SNAPSHOT": " 0 "},
    {"GUBER_BLACKBOX_DIR": "no"},
    {"GUBER_NATIVE_HTTP": "0"},
    {"GUBER_K8S_WATCH_MECHANISM": "endpoints"},
    {"GUBER_PEER_DISCOVERY_TYPE": "k8s", "GUBER_K8S_ENDPOINTS_SELECTOR": "app=g"},
    {"GUBER_PEER_DISCOVERY_TYPE": "member-list", "GUBER_MEMBERLIST_KNOWN_NODES": "a:1"},
    {"GUBER_PEER_DISCOVERY_TYPE": "file"},
    {"GUBER_ACCEPTORS": "64"},
    {"GUBER_PROFILE_HZ": "1"},
    {"GUBER_TENANT_TOPK": "1"},
    {"GUBER_EXPRESS_MAX_LANES": "1", "GUBER_EXPRESS_QUEUE_DEPTH": "1"},
    {"GUBER_TRACE_SAMPLE": "1"},
    {"GUBER_BATCH_WAIT": "2µs", "GUBER_BATCH_TIMEOUT": "1ns"},
    {"GUBER_MULTI_REGION_BATCH_LIMIT": "1000", "GUBER_BATCH_LIMIT": "1000"},
    {"GUBER_TLS_CERT": "only.pem"},
    {"GUBER_K8S_POD_PORT": ""},
    {"OTHER_VAR": "ignored", "GUBER_CACHE_SIZE": "7"},
]

BAD = [
    {"GUBER_ACCEPTORS": "0"},
    {"GUBER_ACCEPTORS": "65"},
    {"GUBER_PEER_DISCOVERY_TYPE": "dns"},
    {"GUBER_K8S_WATCH_MECHANISM": "nodes"},
    {"GUBER_PEER_DISCOVERY_TYPE": "k8s"},
    {"GUBER_PEER_DISCOVERY_TYPE": "member-list"},
    {"GUBER_BATCH_LIMIT": "1001"},
    {"GUBER_BATCH_WAIT": "5 ms"},
    {"GUBER_BATCH_TIMEOUT": "1d"},
    {"GUBER_GLOBAL_BATCH_LIMIT": "5000"},
    {"GUBER_GLOBAL_FANOUT": "0"},
    {"GUBER_MULTI_REGION_TIMEOUT": "0s"},
    {"GUBER_MULTI_REGION_SYNC_WAIT": "0"},
    {"GUBER_MULTI_REGION_BATCH_LIMIT": "-1"},
    {"GUBER_MULTI_REGION_BATCH_LIMIT": "1001"},
    {"GUBER_CIRCUIT_THRESHOLD": "0"},
    {"GUBER_XLA_STORM": "0"},
    {"GUBER_XLA_STORM_WINDOW": "0ms"},
    {"GUBER_PROFILE_HZ": "fast"},
    {"GUBER_PROFILE_HZ": "5000"},
    {"GUBER_TENANT_TOPK": "0"},
    {"GUBER_AUDIT_INTERVAL": "0"},
    {"GUBER_RESHARD_HANDOFF": "-5ms"},
    {"GUBER_SNAPSHOT_INTERVAL": "-1s"},
    {"GUBER_BLACKBOX_MB": "0"},
    {"GUBER_BLACKBOX_RETAIN": "2000"},
    {"GUBER_TRACE_SAMPLE": "5"},
    {"GUBER_TRACE_SAMPLE": "half"},
    {"GUBER_EXPRESS_QUEUE_DEPTH": "0"},
    {"GUBER_EXPRESS_MAX_LANES": "65"},
    {"GUBER_LATENCY_TARGET_MS": "soon"},
    {"GUBER_LATENCY_TARGET_MS": "-1"},
    {"GUBER_SLO_OBJECTIVE": "99"},
    {"GUBER_SLO_OBJECTIVE": "x"},
    {"GUBER_CACHE_SIZE": "big"},
]


def _plain(obj):
    """A config object as nested plain values, for comparison across
    the two packages' classes."""
    if dataclasses.is_dataclass(obj):
        skip = {"devices", "device", "server_ctx", "client_ctx", "store", "loader",
                "fault_plan"}
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.name not in skip}
    if isinstance(obj, list):
        return [_plain(x) for x in obj]
    return obj


def _same(env=None, config_file=""):
    j = jcfg.setup_daemon_config(config_file=config_file, env=env)
    t = tcfg.setup_daemon_config(config_file=config_file, env=env)
    assert _plain(t) == _plain(j)
    assert {f.name for f in dataclasses.fields(t)} - {"device"} == (
        {f.name for f in dataclasses.fields(j)} - {"devices"})
    return t


@pytest.mark.parametrize("var", sorted(VALID))
def test_each_variable_parses_as_in_jax(var):
    env = {var: VALID[var]}
    if var == "GUBER_PEER_DISCOVERY_TYPE":
        env = {var: "static"}
    _same(env)


@pytest.mark.parametrize("env", [VALID, {}] + VARIANTS,
                         ids=["all", "empty"] + [f"variant{i}" for i in range(len(VARIANTS))])
def test_environments_parse_as_in_jax(env):
    t = _same(env)
    assert t.behaviors == tcfg.BehaviorConfig(**_plain(t.behaviors))


@pytest.mark.parametrize("env", BAD, ids=[",".join(f"{k}={v}" for k, v in e.items())
                                          for e in BAD])
def test_bad_values_raise_jax_errors(env):
    with pytest.raises(ValueError) as jerr:
        jcfg.setup_daemon_config(env=env)
    with pytest.raises(ValueError) as terr:
        tcfg.setup_daemon_config(env=env)
    assert str(terr.value) == str(jerr.value)


def test_env_file_and_precedence(tmp_path):
    path = tmp_path / "guber.env"
    path.write_text("# comment\n\nGUBER_CACHE_SIZE = 1234\nGUBER_BATCH_WAIT=2ms\n"
                    "NOT_GUBER=1\n")
    t = _same({"GUBER_BATCH_WAIT": "3ms"}, config_file=str(path))
    assert t.cache_size == 1234 and t.behaviors.batch_wait_s == pytest.approx(0.003)
    bad = tmp_path / "bad.env"
    bad.write_text("GUBER_CACHE_SIZE\n")
    with pytest.raises(ValueError) as jerr:
        jcfg.from_env_file(str(bad))
    with pytest.raises(ValueError) as terr:
        tcfg.from_env_file(str(bad))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("text", ["300ms", "1m30s", "1.5h", "250", "2us", "7µs",
                                  "3μs", "10ns", "", "5x", "1h 2m", "ms"])
def test_parse_duration(text):
    try:
        want = jcfg.parse_duration(text)
    except ValueError as e:
        with pytest.raises(ValueError) as terr:
            tcfg.parse_duration(text)
        assert str(terr.value) == str(e)
        return
    assert tcfg.parse_duration(text) == want


def test_limits_and_watch_mechanism():
    assert tcfg.MAX_BATCH_SIZE == jcfg.MAX_BATCH_SIZE
    assert tcfg.INGRESS_COLUMNS_MAX_LANES == jcfg.INGRESS_COLUMNS_MAX_LANES
    from gubernator_tpu.k8s_pool import watch_mechanism_from_string as jw
    from gubernator_tpu_torch.k8s_pool import watch_mechanism_from_string as tw

    for m in ("", "endpoints", "pods"):
        assert tw(m) == jw(m)
    with pytest.raises(ValueError) as jerr:
        jw("nodes")
    with pytest.raises(ValueError) as terr:
        tw("nodes")
    assert str(terr.value) == str(jerr.value)
