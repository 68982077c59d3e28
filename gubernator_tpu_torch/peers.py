"""Peer discovery pools.

The reference ships three backends (etcd lease+watch, memberlist gossip,
k8s informer — etcd.go / memberlist.go / kubernetes.go), all pushing
`[]PeerInfo` through an OnUpdate callback.  The port of the JAX
package's peers.py keeps its config surface (GUBER_PEER_DISCOVERY_TYPE)
with the two zero-dependency pools:

  * static  — fixed list in DaemonConfig.peers
  * file    — a watched JSON file of PeerInfo entries; editing the file
              is the membership event

`member-list`, `etcd` and `k8s` come with slice A5 (gossip.py,
etcd_pool.py, k8s_pool.py): `make_pool` raises NotImplementedError for
them.
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
    own PeerInfo, which the backends that register or gossip themselves
    need (slice A5)."""
    if kind == "static":
        return StaticPool(conf.peers, on_update)
    if kind == "file":
        return FilePool(conf.peers_file, on_update)
    if kind in ("etcd", "member-list", "k8s"):
        raise NotImplementedError(
            f"'{kind}' peer discovery comes with slice A5 (gossip.py, "
            "etcd_pool.py, k8s_pool.py), not ported yet")
    raise ValueError(f"unknown peer discovery type '{kind}'")
