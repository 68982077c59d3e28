"""Region picker: data-center name -> per-region peer picker.

Parity with region_picker.go:7-95: `get_clients(key)` returns the owner
peer for the key in EVERY region (the MULTI_REGION fan-out set), and
`pick(dc, key)` the owner within one region.

Regions are INDEPENDENT rings: adding or removing a peer in one region
rebuilds only that region's ring, so ownership in every other region is
untouched (the per-region reshard-independence rule the federation
plane composes with — tests/test_region_picker.py pins it).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .hash_ring import ReplicatedConsistentHash


class RegionPicker:
    def __init__(self, template: Optional[ReplicatedConsistentHash] = None):
        self._template = template or ReplicatedConsistentHash()
        self.regions: Dict[str, ReplicatedConsistentHash] = {}

    def new(self) -> "RegionPicker":
        return RegionPicker(self._template.new())

    def add(self, peer) -> None:
        """peer must expose .info (PeerInfo); grouped by data_center
        (region_picker.go:88-95)."""
        dc = peer.info.data_center
        ring = self.regions.get(dc)
        if ring is None:
            ring = self._template.new()
            self.regions[dc] = ring
        ring.add(peer.info.grpc_address, peer)

    def remove(self, peer) -> None:
        """Drop one peer, rebuilding ONLY its region's ring (the rings
        have no point remove; other regions' ownership is untouched by
        construction).  A region whose last peer leaves disappears from
        `regions` entirely — `pick` answers None and `get_clients`
        skips it, never a phantom entry."""
        dc = peer.info.data_center
        ring = self.regions.get(dc)
        if ring is None:
            return
        addr = peer.info.grpc_address
        survivors = [
            p for p in ring.peers()
            if p is not None and p.info.grpc_address != addr
        ]
        if len(survivors) == ring.size():
            return  # not a member
        if not survivors:
            del self.regions[dc]
            return
        rebuilt = self._template.new()
        for p in survivors:
            rebuilt.add(p.info.grpc_address, p)
        self.regions[dc] = rebuilt

    def region_names(self) -> List[str]:
        """Data-center names with at least one peer (insertion order)."""
        return [dc for dc, ring in self.regions.items() if ring.size() > 0]

    def get_clients(self, key: str) -> List[object]:
        """Owner peer for the key in each region (region_picker.go:47-59):
        exactly ONE owner per non-empty region, never None — a ring
        whose mapped peer departed (or an emptied region) is skipped
        instead of emitting a None the send loop would have to guard
        (the pre-fix behavior crashed the MULTI_REGION flush)."""
        out = []
        for ring in self.regions.values():
            if ring.size() == 0:
                continue
            owner = ring.get_by_peer_id(ring.get(key))
            if owner is not None:
                out.append(owner)
        return out

    def pick(self, dc: str, key: str):
        """Owner peer for the key within one region, or None when the
        region is unknown/empty (callers treat None as unroutable and
        requeue — federation._run_locked)."""
        ring = self.regions.get(dc)
        if ring is None or ring.size() == 0:
            return None
        return ring.get_by_peer_id(ring.get(key))

    def peers(self) -> List[object]:
        out = []
        for ring in self.regions.values():
            out.extend(ring.peers())
        return out
