"""Member-list gossip: the port's gossip.py against the JAX package's.

The two packages speak one wire, so a cluster may mix them.  Held here:

* a mixed cluster of GossipPools (port and JAX nodes in turn, two data
  centres) converges, and every pool hands `on_update` the same peer
  list, `data_center` and `http_address` included;
* the SWIM state machine on a scripted, seeded stream of updates
  (suspicion, refutation by a higher incarnation, death, leave, a
  rejoin over a stale LEFT): both packages' member tables, incarnations
  and piggyback queues agree after every update, and the seeded probe
  order is the same;
* a graceful leave in each direction reaches the other package;
* the version-skew cases of tests/test_gossip.py on a port node, with
  the same acks as a JAX node's.

Nodes bind 127.0.0.1:0.  Every wait is bounded.
"""

import json
import random
import socket
import time

import pytest

from gubernator_tpu import gossip as jg
from gubernator_tpu.types import PeerInfo as JPeerInfo
from gubernator_tpu_torch import gossip as tg
from gubernator_tpu_torch.types import PeerInfo as TPeerInfo

FAST = dict(probe_interval_s=0.05, probe_timeout_s=0.1, suspect_timeout_s=0.3,
            sync_interval_s=0.2)
QUIET = dict(probe_interval_s=3600, sync_interval_s=3600)
MOD = {"jax": (jg, JPeerInfo), "torch": (tg, TPeerInfo)}


def wait_until(fn, timeout_s=10.0, every_s=0.02, msg="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(every_s)
    raise AssertionError(f"timed out waiting for {msg}")


def _peers(update):
    return [(p.grpc_address, p.http_address, p.data_center) for p in update]


def test_mixed_pool_cluster_converges_to_the_same_peer_lists():
    kinds = ["torch", "jax", "torch", "jax"]
    dcs = ["", "", "dc-east", "dc-east"]
    updates = {i: [] for i in range(4)}
    pools = []
    try:
        for i, kind in enumerate(kinds):
            mod, PI = MOD[kind]
            seeds = [pools[1 if i != 1 else 0].address] if pools else []
            pools.append(mod.GossipPool(
                advertise=PI(grpc_address=f"127.0.0.1:{9300 + i}",
                             http_address=f"127.0.0.1:{9400 + i}", data_center=dcs[i]),
                member_list_address="127.0.0.1:0",
                on_update=lambda peers, i=i: updates[i].append(peers),
                known_nodes=seeds, node_name=f"mix{i}", seed=i, **FAST))
        want = [(f"127.0.0.1:{9300 + i}", f"127.0.0.1:{9400 + i}", dcs[i]) for i in range(4)]
        for i in range(4):
            wait_until(lambda i=i: updates[i] and _peers(updates[i][-1]) == want,
                       msg=f"pool {i} sees all four peers")
        # Each package's pool hands its own PeerInfo type.
        assert all(isinstance(p, TPeerInfo) for p in updates[0][-1])
        assert all(isinstance(p, JPeerInfo) for p in updates[1][-1])
    finally:
        for p in pools:
            p.close()


def _quiet_pair():
    return jg.Gossip("127.0.0.1:0", name="me", seed=7, **QUIET), \
        tg.Gossip("127.0.0.1:0", name="me", seed=7, **QUIET)


def _table(node):
    with node._lock:  # noqa: SLF001
        members = sorted((m.name, m.host, m.port, m.incarnation, m.state,
                          json.dumps(m.meta, sort_keys=True))
                         for m in node._members.values() if m.name != "me")  # noqa: SLF001
        # This node's own updates carry its bound port, which differs
        # between the two nodes.
        queue = [(json.dumps(dict(u, addr=u["addr"][:1]) if u["name"] == "me" else u,
                             sort_keys=True), n)
                 for u, n in node._piggyback]  # noqa: SLF001
        return members, queue, node._me.incarnation, node._me.state  # noqa: SLF001


def _script(seed, n=60):
    """A seeded stream of updates about five other members and about
    this node itself: joins, suspicions, deaths, leaves, refutations
    and stale rumours."""
    rng = random.Random(seed)
    names = [f"n{i}" for i in range(5)] + ["me"]
    inc = {nm: 1 for nm in names}
    out = []
    for _ in range(n):
        nm = rng.choice(names)
        state = rng.choice(["alive", "alive", "suspect", "dead", "left"])
        step = rng.choice([-1, 0, 0, 1, 2])
        inc[nm] = max(0, inc[nm] + step)
        u = {"s": state, "name": nm, "addr": ["127.0.0.1", 20000 + names.index(nm)],
             "inc": inc[nm]}
        if state == "alive":
            u["meta"] = {"grpcAddress": f"10.0.0.{names.index(nm)}:81",
                         "dataCenter": rng.choice(["", "dc-east"])}
        out.append(u)
    return out


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_swim_state_machine_matches_jax_on_a_seeded_script(seed):
    """Suspicion and refutation, death, leave and rejoin: both packages'
    tables, incarnations and piggyback queues agree after each update,
    and this node refutes every rumour about itself."""
    j, t = _quiet_pair()
    try:
        refuted = 0
        for u in _script(seed):
            before = t._me.incarnation  # noqa: SLF001
            j._handle_update(dict(u))  # noqa: SLF001
            t._handle_update(dict(u))  # noqa: SLF001
            assert _table(t) == _table(j), u
            refuted += t._me.incarnation > before  # noqa: SLF001
        assert refuted > 0
        # The local suspicion path (a probe that timed out) agrees too.
        for node in (j, t):
            for m in node.members():
                if m.name != "me":
                    node._suspect(m)  # noqa: SLF001
        assert _table(t) == _table(j)
        # Seeded probe order: the same targets in the same order.
        order = [[(m.name if m else None) for m in
                  (n._next_probe_target() for _ in range(12))] for n in (j, t)]  # noqa: SLF001
        assert order[0] == order[1]
    finally:
        j.close()
        t.close()


@pytest.mark.parametrize("leaver", ["torch", "jax"])
def test_graceful_leave_reaches_the_other_package(leaver):
    other = "jax" if leaver == "torch" else "torch"
    a = MOD[other][0].Gossip("127.0.0.1:0", name="stay", **FAST)
    b = MOD[leaver][0].Gossip("127.0.0.1:0", name="go", **FAST)
    try:
        b.join([a.address])
        wait_until(lambda: len(a.members()) == 2 and len(b.members()) == 2, msg="join")
        b.leave()
        b.close()
        wait_until(lambda: {m.name for m in a.members()} == {"stay"}, msg="leave seen")
    finally:
        a.close()
        b.close()


def _skew_exchange(mod):
    node = mod.Gossip("127.0.0.1:0", name="skew", **QUIET)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.bind(("127.0.0.1", 0))
        s.settimeout(5.0)
        port = s.getsockname()[1]
        addr = ("127.0.0.1", node.port)
        s.sendto(json.dumps({"t": "mesh-scan", "v": 2, "depth": 3}).encode(), addr)
        s.sendto(json.dumps({
            "t": "ping", "v": 2, "seq": 7, "hmac": "ab12",
            "g": [{"s": "alive", "name": "future-node", "addr": ["127.0.0.1", port],
                   "inc": 1, "meta": {"grpc_address": "127.0.0.1:9"}, "shard_epoch": 42},
                  {"s": "draining", "name": "x", "addr": ["127.0.0.1", 1], "inc": 1}],
        }).encode(), addr)
        ports = {port: "sender", node.port: "node"}

        def recv():
            raw = s.recvfrom(65536)[0].decode()
            for p, name in ports.items():  # the ports differ from run to run
                raw = raw.replace(f", {p}]", f', "{name}"]')
            return json.loads(raw)

        ack_v2 = recv()
        wait_until(lambda: any(m.name == "future-node" for m in node.members()),
                   msg="future-node joined")
        # An old node's packet carries no version stamp at all.
        s.sendto(json.dumps({"t": "ping", "seq": 3}).encode(), addr)
        ack_v0 = recv()
        names = sorted(m.name for m in node.members())
        return ack_v2, ack_v0, names
    finally:
        node.close()
        s.close()


def test_version_skew_is_tolerated_as_in_jax():
    ref = _skew_exchange(jg)
    got = _skew_exchange(tg)
    assert got == ref
    ack_v2, ack_v0, names = got
    assert (ack_v2["t"], ack_v2["seq"], ack_v0["t"], ack_v0["seq"]) == ("ack", 7, "ack", 3)
    assert names == ["future-node", "skew"]
