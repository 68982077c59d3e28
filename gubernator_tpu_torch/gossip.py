"""SWIM gossip membership — the member-list discovery backend.

The port of the JAX package's gossip.py (host code, no device), with
the same wire: a port node and a JAX node gossip in one cluster.  Every
random draw (probe order, indirect-probe helpers, push-pull partner)
comes from the node's own `random.Random(seed)`, so a test can replay
a probe schedule.

The reference's `memberlist.go` delegates the actual membership protocol
to hashicorp/memberlist (SWIM: Scalable Weakly-consistent Infection-style
Process-group Membership) and only adapts its join/leave/update events
into `[]PeerInfo` pushes (`memberlist.go:160-233`).  That library does
not exist here, so this module implements the protocol itself over
stdlib sockets:

  * failure detection — periodic randomized probe (UDP ping -> ack) with
    indirect probes through k peers on timeout, then suspicion, then
    death (the SWIM probe cycle);
  * dissemination — membership updates (alive / suspect / dead / left)
    piggybacked on every protocol packet, each retransmitted a bounded
    number of times (infection-style broadcast);
  * refutation — a node that hears itself suspected or declared dead
    bumps its incarnation number and gossips a fresh alive;
  * anti-entropy — TCP push-pull of the full member table on join and
    periodically with a random peer, so partitions and missed gossip
    converge (memberlist's TCP state sync).

Node metadata carries the advertised `PeerInfo` as JSON, exactly like
the reference stuffs marshaled PeerInfo into node meta
(`memberlist.go:126-139`).  `GossipPool` at the bottom is the
`MemberListPool` equivalent: same config surface
(advertise/address/known-nodes/node-name, `memberlist.go:44-66`), same
300ms join retry (`memberlist.go:135-142`), and an `on_update` callback
receiving the full peer list on every membership change
(`memberlist.go:223-233`).
"""

from __future__ import annotations

import json
import logging
import random
import socket
import socketserver
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import faults as faults_mod
from .types import PeerInfo

log = logging.getLogger("gubernator.gossip")

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"
LEFT = "left"

# How many piggybacked updates fit in one packet, and how many times each
# update is retransmitted (hashicorp scales this by log(n); a constant is
# plenty at rate-limiter cluster sizes).
MAX_PIGGYBACK = 8
RETRANSMIT = 5

# Gossip wire version, stamped on every UDP packet and push-pull frame.
# INTEROP CONTRACT (see README "Peer discovery"): this JSON/UDP wire is
# NOT hashicorp/memberlist-compatible — a node here cannot join a
# reference cluster's port-7946 gossip (memberlist.go:68-151 uses
# msgpack framing + gob/JSON node meta).  Membership migration between
# the two therefore goes through the static/etcd/k8s backends, not
# mixed gossip.  Within THIS wire, compatibility is by tolerance:
# receivers ignore unknown top-level message types, unknown update
# states, and unknown fields (version skew between nodes must never
# break membership — pinned by tests/test_gossip.py version-skew tests).
# Bump only for semantic changes; never gate handling on an exact match.
WIRE_VERSION = 1


@dataclass
class Member:
    name: str
    host: str
    port: int
    incarnation: int = 0
    state: str = ALIVE
    meta: dict = field(default_factory=dict)
    state_at: float = 0.0  # monotonic time of the last state change

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def to_update(self) -> dict:
        u = {
            "s": self.state,
            "name": self.name,
            "addr": [self.host, self.port],
            "inc": self.incarnation,
        }
        if self.state == ALIVE:
            u["meta"] = self.meta
        return u


class Gossip:
    """One SWIM node: UDP probe/gossip plane + TCP push-pull plane."""

    def __init__(
        self,
        bind_address: str,
        name: str = "",
        meta: Optional[dict] = None,
        on_change: Optional[Callable[[List[Member]], None]] = None,
        probe_interval_s: float = 1.0,
        probe_timeout_s: float = 0.5,
        suspect_timeout_s: float = 3.0,
        sync_interval_s: float = 10.0,
        k_indirect: int = 3,
        seed: Optional[int] = None,
        faults: Optional["faults_mod.FaultPlan"] = None,
    ):
        host, _, port = bind_address.partition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port or 7946)
        self.meta = dict(meta or {})
        self.on_change = on_change
        # Probe-order / helper-pick / sync-pick RNG.  Seeded, the SWIM
        # probe schedule replays deterministically, so chaos tests of
        # suspect/confirm transitions are reproducible (faults.py).
        # None seeds from the system.
        self._rng = random.Random(seed)
        # Fault-injection hook (faults.FaultPlan, op "gossip.probe"):
        # None = honor the process-wide faults.install() plan.
        self.faults = faults
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.suspect_timeout_s = suspect_timeout_s
        self.sync_interval_s = sync_interval_s
        self.k_indirect = k_indirect

        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._seq = 0
        self._acks: Dict[int, threading.Event] = {}
        self._piggyback: List[List] = []  # [update, transmits_left]
        self._probe_ring: List[str] = []

        # The gossip plane needs the SAME port on UDP (probe/gossip) and
        # TCP (push-pull).  With port 0 the kernel picks the UDP port
        # first and the TCP bind can lose a race against an unrelated
        # process, so retry with a fresh ephemeral pair.
        for attempt in range(16):
            self._udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._udp.bind((self.host, self.port))
            port = self._udp.getsockname()[1]  # resolve port 0
            try:
                self._tcp = socketserver.ThreadingTCPServer(
                    (self.host, port), _PushPullHandler, bind_and_activate=False
                )
                self._tcp.allow_reuse_address = True
                self._tcp.daemon_threads = True
                self._tcp.server_bind()
                self._tcp.server_activate()
                break
            except OSError:
                self._udp.close()
                if self.port != 0 or attempt == 15:
                    raise
        self.port = port
        self.name = name or f"{self.host}:{self.port}"

        self._me = Member(
            name=self.name, host=self.host, port=self.port,
            incarnation=1, meta=self.meta, state_at=time.monotonic(),
        )
        self._members: Dict[str, Member] = {self.name: self._me}
        self._tcp.gossip = self  # type: ignore[attr-defined]

        self._threads = [
            threading.Thread(target=self._udp_loop, daemon=True),
            threading.Thread(target=self._tcp.serve_forever, daemon=True,
                             kwargs={"poll_interval": 0.1}),
            threading.Thread(target=self._probe_loop, daemon=True),
            threading.Thread(target=self._sync_loop, daemon=True),
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------
    # Public surface
    # ------------------------------------------------------------------
    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def members(self) -> List[Member]:
        """Alive + suspect members (suspects are still members until the
        suspicion timeout expires, as in SWIM)."""
        with self._lock:
            return [
                Member(**{**m.__dict__}) for m in self._members.values()
                if m.state in (ALIVE, SUSPECT)
            ]

    def join(self, seeds: Sequence[str], timeout_s: float = 10.0) -> int:
        """Push-pull with each seed until one answers; retry every 300ms
        until the deadline (memberlist.go:135-142).  Returns how many
        seeds answered."""
        deadline = time.monotonic() + timeout_s
        while not self._stop.is_set():
            joined = 0
            for seed in seeds:
                h, _, p = seed.partition(":")
                try:
                    self._push_pull((h, int(p or 7946)))
                    joined += 1
                except OSError as e:
                    log.debug("join %s failed: %s", seed, e)
            if joined:
                return joined
            if time.monotonic() >= deadline:
                raise TimeoutError(f"unable to join any of {list(seeds)}")
            time.sleep(0.3)
        return 0

    def set_meta(self, meta: dict) -> None:
        """Update advertised metadata: bump incarnation, gossip alive
        (memberlist UpdateNode)."""
        with self._lock:
            self.meta = dict(meta)
            self._me.meta = self.meta
            self._me.incarnation += 1
            self._queue_update(self._me.to_update())
        self._notify()

    def leave(self) -> None:
        """Broadcast a graceful leave before shutdown."""
        with self._lock:
            self._me.state = LEFT
            self._me.incarnation += 1
            update = self._me.to_update()
            self._queue_update(update)
            targets = [m for m in self._members.values()
                       if m.state == ALIVE and m.name != self.name]
        # Push the leave explicitly in every datagram — the piggyback
        # queue carries only RETRANSMIT credits, so in clusters larger
        # than that the later targets would receive an empty packet and
        # only learn of the departure via the probe/suspect/dead cycle.
        payload = json.dumps({"t": "gossip", "g": [update]}).encode()
        for m in targets:
            try:
                self._udp.sendto(payload, m.addr)
            except OSError:
                pass

    def close(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        try:
            self._tcp.shutdown()
            self._tcp.server_close()
        except OSError:
            pass
        try:
            # Unblock the UDP recv loop (send to the actual bound
            # address — loopback would miss a socket bound elsewhere).
            self._udp.sendto(b"{}", self._udp.getsockname())
        except OSError:
            pass
        self._udp.close()

    # ------------------------------------------------------------------
    # Wire helpers
    # ------------------------------------------------------------------
    def _send(self, addr: Tuple[str, int], msg: dict) -> None:
        msg = dict(msg, v=WIRE_VERSION)
        with self._lock:
            gossip = []
            for entry in self._piggyback[:MAX_PIGGYBACK]:
                gossip.append(entry[0])
                entry[1] -= 1
            self._piggyback = [e for e in self._piggyback if e[1] > 0]
        if gossip:
            msg["g"] = gossip
        try:
            self._udp.sendto(json.dumps(msg).encode(), addr)
        except OSError:
            pass

    def _queue_update(self, update: dict) -> None:
        # Replace any queued update about the same node: the newest state
        # supersedes older gossip.
        self._piggyback = [e for e in self._piggyback if e[0]["name"] != update["name"]]
        self._piggyback.append([update, RETRANSMIT])

    # ------------------------------------------------------------------
    # UDP plane
    # ------------------------------------------------------------------
    def _udp_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, addr = self._udp.recvfrom(65536)
            except OSError:
                return
            try:
                msg = json.loads(data.decode())
            except (UnicodeDecodeError, json.JSONDecodeError):
                continue
            for update in msg.get("g", []):
                self._handle_update(update)
            t = msg.get("t")
            if t == "ping":
                self._send(addr, {"t": "ack", "seq": msg.get("seq", 0)})
            elif t == "ack":
                ev = self._acks.get(msg.get("seq", 0))
                if ev is not None:
                    ev.set()
            elif t == "ping-req":
                # Probe the target on behalf of the asker (SWIM indirect).
                # Must NOT block this loop: _ping waits for an ack that
                # only this loop can deliver.
                target = tuple(msg.get("target", ()))
                if len(target) == 2:
                    threading.Thread(
                        target=self._indirect_probe,
                        args=(addr, target, msg.get("seq", 0)),
                        daemon=True,
                    ).start()

    def _indirect_probe(self, asker: Tuple[str, int], target: Tuple[str, int], seq: int) -> None:
        if self._ping(target):
            self._send(asker, {"t": "ack", "seq": seq})

    def _ping(self, addr: Tuple[str, int], timeout_s: Optional[float] = None) -> bool:
        # Fault-injection point (faults.OP_GOSSIP_PROBE): a DROP/ERROR
        # rule makes the ping count as lost — the caller proceeds to
        # indirect probe / suspicion exactly as if the packet vanished
        # on the wire.  DELAY models a slow link, so it EATS the ack
        # budget: an injected delay >= the probe timeout is a timed-out
        # probe (returned lost immediately, no real sleep — chaos tests
        # of latency-induced suspicion stay deterministic-fast), and a
        # smaller delay leaves only the remainder for the ack wait.
        timeout = timeout_s or self.probe_timeout_s
        fp = self.faults if self.faults is not None else faults_mod.active()
        if fp is not None:
            # DUPLICATE rules are aimed at hit-carrying data-plane RPCs
            # (a duplicated ping is indistinguishable from a ping);
            # excluded BEFORE matching so a probe can't burn the rule's
            # fired_count/rate accounting.
            act = fp.intercept(
                f"{addr[0]}:{addr[1]}", faults_mod.OP_GOSSIP_PROBE,
                exclude=(faults_mod.DUPLICATE,),
            )
            if act is not None:
                if act.kind != faults_mod.DELAY:
                    return False
                if act.delay_s >= timeout:
                    return False
                time.sleep(act.delay_s)
                timeout -= act.delay_s
        with self._lock:
            self._seq += 1
            seq = self._seq
        ev = threading.Event()
        self._acks[seq] = ev
        try:
            self._send(addr, {"t": "ping", "seq": seq})
            return ev.wait(timeout)
        finally:
            self._acks.pop(seq, None)

    # ------------------------------------------------------------------
    # Probe cycle
    # ------------------------------------------------------------------
    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            self._expire_suspects()
            target = self._next_probe_target()
            if target is None:
                continue
            if self._ping(target.addr):
                continue
            # Indirect probe through k random other members.
            with self._lock:
                others = [
                    m for m in self._members.values()
                    if m.state == ALIVE and m.name not in (self.name, target.name)
                ]
            helpers = self._rng.sample(others, min(self.k_indirect, len(others)))
            with self._lock:
                self._seq += 1
                seq = self._seq
            ev = threading.Event()
            self._acks[seq] = ev
            try:
                for h in helpers:
                    self._send(
                        h.addr,
                        {"t": "ping-req", "seq": seq, "target": list(target.addr)},
                    )
                if helpers and ev.wait(self.probe_timeout_s * 2):
                    continue
            finally:
                self._acks.pop(seq, None)
            self._suspect(target)

    def _next_probe_target(self) -> Optional[Member]:
        """Randomized round-robin over the membership (SWIM's shuffled
        ring gives bounded detection time)."""
        with self._lock:
            while self._probe_ring:
                name = self._probe_ring.pop()
                m = self._members.get(name)
                if m is not None and m.state in (ALIVE, SUSPECT) and name != self.name:
                    return m
            names = [
                n for n, m in self._members.items()
                if m.state in (ALIVE, SUSPECT) and n != self.name
            ]
            self._rng.shuffle(names)
            self._probe_ring = names
            if not self._probe_ring:
                return None
            return self._members.get(self._probe_ring.pop())

    def _suspect(self, target: Member) -> None:
        changed = False
        with self._lock:
            m = self._members.get(target.name)
            if m is not None and m.state == ALIVE:
                m.state = SUSPECT
                m.state_at = time.monotonic()
                self._queue_update(m.to_update())
                changed = True
        if changed:
            log.debug("%s: suspect %s", self.name, target.name)

    def _expire_suspects(self) -> None:
        now = time.monotonic()
        expired = []
        with self._lock:
            for m in self._members.values():
                if m.state == SUSPECT and now - m.state_at > self.suspect_timeout_s:
                    m.state = DEAD
                    m.state_at = now
                    self._queue_update(m.to_update())
                    expired.append(m.name)
        if expired:
            log.debug("%s: dead %s", self.name, expired)
            self._notify()

    # ------------------------------------------------------------------
    # Update dissemination
    # ------------------------------------------------------------------
    def _handle_update(self, u: dict) -> None:
        try:
            state = u["s"]
            name = u["name"]
            inc = int(u["inc"])
            host, port = u["addr"]
        except (KeyError, ValueError, TypeError):
            return
        changed = False
        with self._lock:
            if name == self.name:
                # Refute rumors about ourselves (SWIM refutation).  LEFT
                # must be refuted too: a restarted node that reuses its
                # name hears its own stale leave echoed back in push-pull
                # state and must out-increment it to become visible again.
                if state in (SUSPECT, DEAD, LEFT) and inc >= self._me.incarnation:
                    self._me.incarnation = inc + 1
                    self._queue_update(self._me.to_update())
                return
            m = self._members.get(name)
            if state == ALIVE:
                if m is None:
                    m = Member(
                        name=name, host=host, port=int(port), incarnation=inc,
                        state=ALIVE, meta=u.get("meta", {}), state_at=time.monotonic(),
                    )
                    self._members[name] = m
                    self._queue_update(m.to_update())
                    changed = True
                elif inc > m.incarnation:
                    revived = m.state != ALIVE
                    meta_changed = u.get("meta", m.meta) != m.meta
                    m.incarnation = inc
                    m.state = ALIVE
                    m.host, m.port = host, int(port)
                    m.meta = u.get("meta", m.meta)
                    m.state_at = time.monotonic()
                    self._queue_update(m.to_update())
                    changed = revived or meta_changed
            elif state == SUSPECT:
                if m is not None and m.state == ALIVE and inc >= m.incarnation:
                    m.state = SUSPECT
                    m.incarnation = inc
                    m.state_at = time.monotonic()
                    self._queue_update(m.to_update())
            elif state in (DEAD, LEFT):
                if m is not None and m.state in (ALIVE, SUSPECT) and inc >= m.incarnation:
                    m.state = state
                    m.incarnation = inc
                    m.state_at = time.monotonic()
                    self._queue_update(m.to_update())
                    changed = True
        if changed:
            self._notify()

    def _notify(self) -> None:
        if self.on_change is None:
            return
        try:
            self.on_change(self.members())
        except Exception:  # noqa: BLE001 — a bad callback must not kill the protocol
            log.exception("on_change callback failed")

    # ------------------------------------------------------------------
    # TCP push-pull (anti-entropy)
    # ------------------------------------------------------------------
    def _state_snapshot(self) -> List[dict]:
        with self._lock:
            return [m.to_update() for m in self._members.values()]

    def merge_state(self, updates: Sequence[dict]) -> None:
        for u in updates:
            self._handle_update(u)

    def _push_pull(self, addr: Tuple[str, int]) -> None:
        with socket.create_connection(addr, timeout=2.0) as sock:
            f = sock.makefile("rw", encoding="utf-8")
            f.write(json.dumps(
                {"t": "push-pull", "v": WIRE_VERSION, "m": self._state_snapshot()}
            ) + "\n")
            f.flush()
            line = f.readline()
        if line:
            msg = json.loads(line)
            self.merge_state(msg.get("m", []))

    def _sync_loop(self) -> None:
        while not self._stop.wait(self.sync_interval_s):
            with self._lock:
                others = [m for m in self._members.values()
                          if m.state == ALIVE and m.name != self.name]
            if not others:
                continue
            pick = self._rng.choice(others)
            try:
                self._push_pull(pick.addr)
            except (OSError, json.JSONDecodeError):
                continue


class _PushPullHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        gossip: Gossip = self.server.gossip  # type: ignore[attr-defined]
        try:
            line = self.rfile.readline()
            if not line:
                return
            msg = json.loads(line)
            self.wfile.write(
                (json.dumps({
                    "t": "push-pull", "v": WIRE_VERSION,
                    "m": gossip._state_snapshot(),
                }) + "\n").encode()
            )
            gossip.merge_state(msg.get("m", []))
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            return


# ----------------------------------------------------------------------
# The discovery pool (MemberListPool equivalent)
# ----------------------------------------------------------------------
class GossipPool:
    """member-list discovery backend (reference MemberListPool,
    memberlist.go:38-151): gossip node metadata = advertised PeerInfo;
    every membership change pushes the full `[]PeerInfo` (self included)
    through `on_update`, mirroring the event handler's peers-map rebuild
    (memberlist.go:160-233)."""

    def __init__(
        self,
        advertise: PeerInfo,
        member_list_address: str,
        on_update: Callable[[List[PeerInfo]], None],
        known_nodes: Sequence[str] = (),
        node_name: str = "",
        join_timeout_s: float = 10.0,
        probe_interval_s: float = 1.0,
        probe_timeout_s: float = 0.5,
        suspect_timeout_s: float = 3.0,
        sync_interval_s: float = 10.0,
        seed: Optional[int] = None,
        faults: Optional["faults_mod.FaultPlan"] = None,
    ):
        self.on_update = on_update
        self.gossip = Gossip(
            bind_address=member_list_address,
            name=node_name,
            meta=advertise.to_json(),
            on_change=self._on_change,
            probe_interval_s=probe_interval_s,
            probe_timeout_s=probe_timeout_s,
            suspect_timeout_s=suspect_timeout_s,
            sync_interval_s=sync_interval_s,
            seed=seed,
            faults=faults,
        )
        # Normalize seeds (default port 7946) BEFORE the self-filter: a
        # portless seed naming this host would otherwise pass the string
        # compare and "join" by push-pulling with ourselves.
        def norm(s: str) -> str:
            h, _, p = s.partition(":")
            return f"{h}:{p or 7946}"

        seeds = [norm(s) for s in known_nodes if s]
        seeds = [s for s in seeds if s != self.gossip.address]
        if seeds:
            try:
                self.gossip.join(seeds, timeout_s=join_timeout_s)
            except TimeoutError:
                self.gossip.close()
                raise
        self._on_change(self.gossip.members())

    @property
    def address(self) -> str:
        """host:port of the gossip plane (for seeding other nodes)."""
        return self.gossip.address

    def _on_change(self, members: List[Member]) -> None:
        peers = []
        for m in members:
            if m.meta.get("grpcAddress") or m.meta.get("grpc_address"):
                peers.append(PeerInfo.from_json(m.meta))
        peers.sort(key=lambda p: p.grpc_address)
        try:
            self.on_update(peers)
        except Exception:  # noqa: BLE001
            log.exception("on_update callback failed")

    def close(self) -> None:
        """Graceful leave then shutdown (memberlist.go:153-158)."""
        try:
            self.gossip.leave()
            time.sleep(0.05)  # let the leave datagrams flush
        finally:
            self.gossip.close()
