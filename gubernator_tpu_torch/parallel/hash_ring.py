"""Replicated consistent-hash ring: key -> owner peer.

Parity with the reference `ReplicatedConsistentHash`
(replicated_hash.go:36-119): 512 virtual nodes per peer, vnode hash =
hash_fn(str(replica_index) + hex(md5(peer_key))), sorted ring with
binary search, wrap-around at the top.  Default hash is FNV-1 64
(replicated_hash.go:31), selectable to FNV-1a — both pinned by the
reference's distribution test (replicated_hash_test.go:40-86), which we
reproduce exactly.

TPU-native addition: `get_batch` resolves whole key batches via
numpy `searchsorted` over the vnode array instead of per-key binary
search loops — the host-side analogue of vectorizing the kernel.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..utils import hashing

DEFAULT_REPLICAS = 512  # replicated_hash.go:29

HashFn = Callable[[str], int]


def _fnv1_str(s: str) -> int:
    return hashing.fnv1_64(s.encode("utf-8"))


def _fnv1a_str(s: str) -> int:
    return hashing.fnv1a_64(s.encode("utf-8"))


class ReplicatedConsistentHash:
    """Maps keys to peer ids (strings).  The service layer owns the
    peer-id -> transport-client mapping."""

    def __init__(self, hash_fn: Optional[HashFn] = None, replicas: int = DEFAULT_REPLICAS):
        self.hash_fn: HashFn = hash_fn or _fnv1_str
        self.replicas = replicas
        self._peers: Dict[str, object] = {}
        self._vnode_hashes = np.zeros(0, dtype=np.uint64)
        self._vnode_owner: List[str] = []
        # Integer owner codes per vnode (peer insertion order), so
        # get_batch_codes resolves a whole batch with one fancy index —
        # no per-lane owner-id string handling (service.py
        # _submit_columns routing).
        self._vnode_code = np.zeros(0, dtype=np.int32)
        self._code_ids: List[str] = []

    def new(self) -> "ReplicatedConsistentHash":
        """Fresh empty picker with the same config (replicated_hash.go:61-67)."""
        return ReplicatedConsistentHash(self.hash_fn, self.replicas)

    def size(self) -> int:
        return len(self._peers)

    def peers(self) -> List[object]:
        return list(self._peers.values())

    def peer_ids(self) -> List[str]:
        return list(self._peers.keys())

    def get_by_peer_id(self, peer_id: str):
        return self._peers.get(peer_id)

    def add(self, peer_id: str, peer: object = None) -> None:
        """Add a peer; vnode key construction mirrors replicated_hash.go:78-91."""
        self._peers[peer_id] = peer if peer is not None else peer_id
        md5_hex = hashlib.md5(peer_id.encode("utf-8")).hexdigest()
        new_hashes = np.array(
            [self.hash_fn(f"{i}{md5_hex}") for i in range(self.replicas)], dtype=np.uint64
        )
        owners = [peer_id] * self.replicas
        all_hashes = np.concatenate([self._vnode_hashes, new_hashes])
        all_owners = self._vnode_owner + owners
        order = np.argsort(all_hashes, kind="stable")
        self._vnode_hashes = all_hashes[order]
        self._vnode_owner = [all_owners[i] for i in order]
        self._code_ids = list(self._peers.keys())
        codes = {pid: c for c, pid in enumerate(self._code_ids)}
        self._vnode_code = np.fromiter(
            (codes[o] for o in self._vnode_owner), np.int32,
            count=len(self._vnode_owner),
        )

    def get(self, key: str) -> str:
        """Owner peer id for a key (replicated_hash.go:104-119)."""
        if not self._peers:
            raise RuntimeError("unable to pick a peer; pool is empty")
        h = np.uint64(self.hash_fn(key))
        idx = int(np.searchsorted(self._vnode_hashes, h, side="left"))
        if idx == len(self._vnode_owner):
            idx = 0
        return self._vnode_owner[idx]

    def get_batch(self, keys: Sequence[str]) -> List[str]:
        """Vectorized owner lookup for a whole batch of keys.  The two
        stock hash functions hash the whole batch in the C++ runtime
        (native.fnv1_batch); custom hash_fns fall back per key."""
        if not self._peers:
            raise RuntimeError("unable to pick a peer; pool is empty")
        if self.hash_fn in (_fnv1_str, _fnv1a_str):
            from .. import native

            hs = native.fnv1_batch(keys, variant_1a=self.hash_fn is _fnv1a_str)
        else:
            hs = np.array([self.hash_fn(k) for k in keys], dtype=np.uint64)
        idxs = np.searchsorted(self._vnode_hashes, hs, side="left")
        n = len(self._vnode_owner)
        return [self._vnode_owner[i if i < n else 0] for i in idxs]

    def fingerprint(self) -> int:
        """Order-independent 64-bit identity of this ring's MEMBERSHIP
        (+ vnode count): the epoch stamp ownership transfers are fenced
        on (reshard.ring_fingerprint).  Two daemons that were handed
        the same peer list compute the same fingerprint with no
        coordination."""
        from ..reshard import ring_fingerprint

        return ring_fingerprint(sorted(self._peers.keys()), self.replicas)

    def get_batch_codes(self, keys, sketch=None) -> "tuple[np.ndarray, List[str]]":
        """Fully vectorized owner lookup: (codes i32[n], id_list) where
        codes index id_list (one entry per peer, insertion order).
        `keys` may be a list of strings or a native.PackedKeys — either
        way no per-lane Python objects are created here.

        `sketch` (saturation.HotKeySketch) piggybacks on the hashes
        this lookup computes anyway: hot-key detection costs zero
        extra hashing on the routing hot path."""
        if not self._peers:
            raise RuntimeError("unable to pick a peer; pool is empty")
        if self.hash_fn in (_fnv1_str, _fnv1a_str):
            from .. import native

            hs = native.fnv1_batch(keys, variant_1a=self.hash_fn is _fnv1a_str)
        else:
            hs = np.array([self.hash_fn(k) for k in keys], dtype=np.uint64)
        if sketch is not None:
            sketch.update(hs, keys)
        idxs = np.searchsorted(self._vnode_hashes, hs, side="left")
        idxs[idxs == len(self._vnode_owner)] = 0
        return self._vnode_code[idxs], self._code_ids


def fnv1_hash() -> HashFn:
    return _fnv1_str


def fnv1a_hash() -> HashFn:
    return _fnv1a_str
