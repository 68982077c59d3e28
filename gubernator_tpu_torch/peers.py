"""Peer discovery pools.

The reference ships three backends (etcd lease+watch, memberlist gossip,
k8s informer — etcd.go / memberlist.go / kubernetes.go), all pushing
`[]PeerInfo` through an OnUpdate callback.  The port of the JAX
package's peers.py keeps its config surface (GUBER_PEER_DISCOVERY_TYPE):

  * static      — fixed list in DaemonConfig.peers
  * file        — a watched JSON file of PeerInfo entries; editing the
                  file is the membership event
  * member-list — SWIM gossip (gossip.py)
  * etcd        — lease registration and a prefix watch (etcd_pool.py)
  * k8s         — Endpoints or Pods list and watch (k8s_pool.py)
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Callable, List, Optional

from .types import PeerInfo

log = logging.getLogger("gubernator.peers")

OnUpdate = Callable[[List[PeerInfo]], None]


class StaticPool:
    """Fixed peer list, delivered once."""

    def __init__(self, peers: List[PeerInfo], on_update: OnUpdate):
        on_update(peers)

    def close(self) -> None:
        pass


class FilePool:
    """Watches a JSON file ([{"grpcAddress": ...}, ...]) by mtime poll;
    pushes the parsed list on change."""

    def __init__(self, path: str, on_update: OnUpdate, poll_s: float = 0.5):
        self.path = path
        self.on_update = on_update
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._mtime = 0.0
        self._last_peers: "Optional[List[PeerInfo]]" = None
        try:
            # A torn/invalid file at construction is transient the same
            # way it is mid-poll: log and let the first tick retry
            # rather than failing daemon startup.
            self._load()
        except (OSError, ValueError) as e:
            log.warning("initial peers-file load failed, will retry: %s", e)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _load(self) -> None:
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            return
        if mtime == self._mtime:
            return
        with open(self.path) as f:
            data = json.load(f)
        if not isinstance(data, list):
            raise ValueError("peers file must be a JSON array of objects")
        peers = []
        for p in data:
            if not isinstance(p, dict):
                raise ValueError(f"peer entry must be a JSON object, got {p!r}")
            peers.append(PeerInfo.from_json(p))
        # Record the mtime only AFTER the content fully validated: a
        # poll landing on a half-written (or JSON-valid-but-wrong-shape)
        # file must retry on the next tick, not mark the content as
        # seen and drop the update forever.
        self._mtime = mtime
        if peers == self._last_peers:
            # Touched-but-unchanged file (config management rewrites,
            # atomic-replace deploy loops): membership didn't change,
            # so don't push a spurious update downstream — set_peers
            # would rebuild the pickers for nothing, and membership
            # no-ops must never look like ring churn to the resharding
            # plane.
            return
        self._last_peers = peers
        self.on_update(peers)

    def _run(self) -> None:
        while not self._stop.wait(timeout=self.poll_s):
            try:
                self._load()
            except (OSError, ValueError) as e:
                # JSONDecodeError is a ValueError; shape errors raise
                # ValueError explicitly above.
                log.debug("peers-file poll failed, retrying: %s", e)
                continue

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


def make_pool(kind: str, conf, on_update: OnUpdate, advertise: Optional[PeerInfo] = None):
    """daemon.go:163-192 discovery switch.  `advertise` is this daemon's
    own PeerInfo, required by the backends that register or gossip
    themselves (member-list, etcd).  Each backend's module is imported
    here, when it is chosen: etcd's pulls in grpc."""
    if kind == "static":
        return StaticPool(conf.peers, on_update)
    if kind == "file":
        return FilePool(conf.peers_file, on_update)
    if kind == "etcd":
        from .etcd_pool import EtcdPool, credentials_from_config

        if not advertise:
            raise ValueError("etcd discovery requires an advertise PeerInfo")
        if conf.etcd_advertise_address:
            advertise = PeerInfo(
                grpc_address=conf.etcd_advertise_address,
                http_address=advertise.http_address,
                data_center=advertise.data_center,
            )
        return EtcdPool(
            advertise=advertise,
            on_update=on_update,
            endpoints=conf.etcd_endpoints,
            key_prefix=conf.etcd_key_prefix,
            credentials=credentials_from_config(conf),
            username=getattr(conf, "etcd_user", ""),
            password=getattr(conf, "etcd_password", ""),
        )
    if kind == "member-list":
        from .gossip import GossipPool

        if not advertise:
            raise ValueError("member-list discovery requires an advertise PeerInfo")
        # Default bind: advertise_host:7946 (config.go:315) — binding
        # loopback would gossip an unreachable address to remote peers.
        adv_host = advertise.grpc_address.partition(":")[0]
        return GossipPool(
            advertise=advertise,
            member_list_address=conf.member_list_address or f"{adv_host}:7946",
            on_update=on_update,
            known_nodes=conf.member_list_known_nodes,
            node_name=conf.member_list_node_name,
            seed=getattr(conf, "gossip_seed", None),
            faults=getattr(conf, "fault_plan", None),
        )
    if kind == "k8s":
        from .k8s_pool import K8sPool

        return K8sPool(
            on_update=on_update,
            namespace=conf.k8s_namespace,
            selector=conf.k8s_selector,
            pod_ip=conf.k8s_pod_ip,
            pod_port=conf.k8s_pod_port,
            mechanism=conf.k8s_mechanism,
        )
    raise ValueError(f"unknown peer discovery type '{kind}'")
