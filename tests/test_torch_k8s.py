"""k8s discovery: the port's K8sPool against the JAX package's.

Both pools, built by each package's `peers.make_pool("k8s", ...)`, take
the same scripted events from a fresh fake API server each
(tests/test_k8s.py `FakeK8sApi`: chunked LIST, WATCH streams, 410 Gone,
bookmarks), in endpoints mode and in pods mode.  At every checkpoint
both hand `on_update` the same peer list (addresses and IsOwner).  A
checkpoint waits on a condition variable that `on_update` signals, with
a bound, never on a fixed sleep.
"""

import threading
import time

import pytest

from gubernator_tpu import config as jconfig
from gubernator_tpu import k8s_pool as jk8s
from gubernator_tpu import peers as jpeers
from gubernator_tpu_torch import config as tconfig
from gubernator_tpu_torch import k8s_pool as tk8s
from gubernator_tpu_torch import peers as tpeers

from .test_k8s import FakeK8sApi, endpoints_obj, pod_obj

MOD = {"jax": (jconfig, jk8s, jpeers), "torch": (tconfig, tk8s, tpeers)}
WAIT_S = 10.0


class Updates:
    """on_update's lists, with a wait for the next one that holds."""

    def __init__(self):
        self._cond = threading.Condition()
        self.lists = []

    def __call__(self, peers):
        with self._cond:
            self.lists.append([(p.grpc_address, p.is_owner) for p in peers])
            self._cond.notify_all()

    def wait(self, pred, what):
        with self._cond:
            assert self._cond.wait_for(lambda: self.lists and pred(self.lists[-1]),
                                       timeout=WAIT_S), what
            return self.lists[-1]


def _watching(api):
    """Bounded wait until the pool's WATCH stream is open: the fake
    pushes an event only to the streams open when it is emitted."""
    deadline = time.monotonic() + WAIT_S
    while api.n_watchers() != 1:
        assert time.monotonic() < deadline, "watch never opened"
        time.sleep(0.005)


def _addrs(*ips):
    return lambda last: [a for a, _ in last] == [f"{ip}:81" for ip in ips]


def _pool(kind, api, mechanism, updates, monkeypatch):
    config, k8s, peers = MOD[kind]
    conf = config.setup_daemon_config(env={
        "GUBER_PEER_DISCOVERY_TYPE": "k8s",
        "GUBER_K8S_ENDPOINTS_SELECTOR": "app=gubernator",
        "GUBER_K8S_POD_IP": "10.0.0.1",
        "GUBER_K8S_POD_PORT": "81",
        "GUBER_K8S_WATCH_MECHANISM": mechanism,
    })
    monkeypatch.setattr(k8s.K8sApiClient, "auto",
                        classmethod(lambda cls: cls(api_url=api.url)))
    pool = peers.make_pool("k8s", conf, updates)
    pool.backoff_s = 0.05
    assert isinstance(pool, k8s.K8sPool)
    return pool


def _endpoints_run(kind, monkeypatch):
    api = FakeK8sApi()
    updates = Updates()
    seen = []
    pool = None
    try:
        api.emit("endpoints", "ADDED", endpoints_obj("guber", ["10.0.0.1"]))
        pool = _pool(kind, api, "endpoints", updates, monkeypatch)
        seen.append(updates.wait(_addrs("10.0.0.1"), "initial list"))
        _watching(api)
        api.emit("endpoints", "MODIFIED", endpoints_obj("guber", ["10.0.0.1", "10.0.0.2"]))
        seen.append(updates.wait(_addrs("10.0.0.1", "10.0.0.2"), "scale-up"))
        n = len(updates.lists)
        for _ in range(3):
            api.emit_bookmark("endpoints")
        # A stream that ends server-side: the pool relists.
        api.emit("endpoints", "MODIFIED", endpoints_obj("guber", ["10.0.0.1", "10.0.0.9"]))
        api.kill_watchers()
        seen.append(updates.wait(_addrs("10.0.0.1", "10.0.0.9"), "relist"))
        # Bookmarks carried no membership: every update since is a real
        # list of this scale.
        assert all(len(lst) == 2 for lst in updates.lists[n:])
        # A watch from a compacted version answers 410 Gone: relist.
        api.compact(api.rv + 2)
        api.kill_watchers()
        for ips in (["10.0.0.1", "10.0.0.3"], ["10.0.0.1", "10.0.0.3", "10.0.0.4"]):
            api.emit("endpoints", "MODIFIED", endpoints_obj("guber", ips))
        seen.append(updates.wait(_addrs("10.0.0.1", "10.0.0.3", "10.0.0.4"), "410 relist"))
        _watching(api)
        api.emit("endpoints", "DELETED", endpoints_obj("guber", []))
        seen.append(updates.wait(lambda last: last == [], "deletion"))
    finally:
        if pool is not None:
            pool.close()
        api.stop()
    return seen


def _pods_run(kind, monkeypatch):
    api = FakeK8sApi()
    updates = Updates()
    seen = []
    pool = None
    try:
        for i in range(6):
            api.emit("pods", "ADDED", pod_obj(f"p{i}", f"10.0.0.{i + 1}",
                                             ready=i != 2, running=i != 4))
        pool = _pool(kind, api, "pods", updates, monkeypatch)
        ready = ["10.0.0.1", "10.0.0.2", "10.0.0.4", "10.0.0.6"]
        seen.append(updates.wait(_addrs(*ready), "ready and running pods"))
        _watching(api)
        api.emit("pods", "MODIFIED", pod_obj("p2", "10.0.0.3"))
        seen.append(updates.wait(_addrs(*sorted(ready + ["10.0.0.3"])), "pod ready"))
        api.emit("pods", "DELETED", pod_obj("p0", "10.0.0.1"))
        seen.append(updates.wait(_addrs("10.0.0.2", "10.0.0.3", "10.0.0.4", "10.0.0.6"),
                                 "pod deleted"))
    finally:
        if pool is not None:
            pool.close()
        api.stop()
    return seen


@pytest.mark.parametrize("mode", ["endpoints", "pods"])
def test_k8s_pool_matches_jax(mode, monkeypatch):
    run = _endpoints_run if mode == "endpoints" else _pods_run
    ref = run("jax", monkeypatch)
    got = run("torch", monkeypatch)
    assert got == ref
    # The pod IP is this node's: it is the owner.
    if mode == "endpoints":
        assert got[0] == [("10.0.0.1:81", True)]
    else:
        assert got[-1][0] == ("10.0.0.2:81", False)


def test_watch_mechanism_parse_matches_jax():
    for m in ("", "endpoints", "pods"):
        assert tk8s.watch_mechanism_from_string(m) == jk8s.watch_mechanism_from_string(m)
    for bad in ("nodes", "Pods"):
        with pytest.raises(ValueError) as je:
            jk8s.watch_mechanism_from_string(bad)
        with pytest.raises(ValueError) as te:
            tk8s.watch_mechanism_from_string(bad)
        assert str(te.value) == str(je.value)
