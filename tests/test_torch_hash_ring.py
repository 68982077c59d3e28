"""The port's ring (parallel/hash_ring.py, parallel/region.py) and
ring fingerprint (reshard.py) against the JAX package's: the same
seeded peer sets and keys give the same vnode hashes, owners, owner
codes and fingerprints (tolerance 0).  The native ingress route mirrors
the FNV variants and the vnode layout, so these must be bit-identical.
"""

import numpy as np
import pytest

from gubernator_tpu.parallel import hash_ring as jring
from gubernator_tpu.parallel.region import RegionPicker as JRegion
from gubernator_tpu.reshard import ring_fingerprint as jfp
from gubernator_tpu.types import PeerInfo as JPeer
from gubernator_tpu_torch import native as tnative
from gubernator_tpu_torch.parallel import hash_ring as tring
from gubernator_tpu_torch.parallel.region import RegionPicker as TRegion
from gubernator_tpu_torch.reshard import ring_fingerprint as tfp
from gubernator_tpu_torch.types import PeerInfo as TPeer


def _peers(rng, n):
    return [f"10.{int(rng.integers(0, 255))}.{i}.{int(rng.integers(1, 255))}:"
            f"{int(rng.integers(1024, 65535))}" for i in range(n)]


def _keys(rng, n):
    # Index-leading and suffix-varying keys, multi-byte utf-8 among them.
    return [f"{int(k)}user" if k % 3 else f"name_é{int(k)}" for k in rng.integers(0, 10**9, n)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("variant", ["fnv1", "fnv1a"])
def test_ring_owners_vnodes_and_codes(seed, variant):
    rng = np.random.default_rng(seed)
    peers = _peers(rng, int(rng.integers(1, 6)))
    replicas = int(rng.choice([1, 7, 512]))
    jh = jring.fnv1_hash() if variant == "fnv1" else jring.fnv1a_hash()
    th = tring.fnv1_hash() if variant == "fnv1" else tring.fnv1a_hash()
    j = jring.ReplicatedConsistentHash(jh, replicas)
    t = tring.ReplicatedConsistentHash(th, replicas)
    for p in peers:
        j.add(p)
        t.add(p)
    assert np.array_equal(t._vnode_hashes, j._vnode_hashes)
    assert t._vnode_owner == j._vnode_owner
    assert np.array_equal(t._vnode_code, j._vnode_code)
    keys = _keys(rng, 300)
    assert t.get_batch(keys) == j.get_batch(keys) == [j.get(k) for k in keys]
    assert [t.get(k) for k in keys[:40]] == [j.get(k) for k in keys[:40]]
    tc, tids = t.get_batch_codes(keys)
    jc, jids = j.get_batch_codes(keys)
    assert np.array_equal(tc, jc) and tids == jids
    # Packed keys route like strings.
    pc, _ = t.get_batch_codes(tnative.PackedKeys(*tnative.pack_keys(keys)))
    assert np.array_equal(pc, jc)
    assert t.fingerprint() == j.fingerprint()
    assert t.new().size() == 0 and t.new().replicas == replicas


@pytest.mark.parametrize("seed", range(4))
def test_ring_fingerprint(seed):
    rng = np.random.default_rng(seed + 10)
    peers = _peers(rng, int(rng.integers(0, 6)))
    for replicas in (1, 512):
        assert tfp(peers, replicas) == jfp(peers, replicas)
        assert tfp(list(reversed(peers)), replicas) == jfp(peers, replicas)


def test_region_picker():
    rng = np.random.default_rng(3)
    infos = [(p, f"dc{i % 3}") for i, p in enumerate(_peers(rng, 7))]

    class Peer:
        def __init__(self, info):
            self.info = info

    j, t = JRegion(), TRegion()
    for addr, dc in infos:
        j.add(Peer(JPeer(grpc_address=addr, data_center=dc)))
        t.add(Peer(TPeer(grpc_address=addr, data_center=dc)))
    keys = _keys(rng, 50)
    for k in keys:
        assert ([p.info.grpc_address for p in t.get_clients(k)]
                == [p.info.grpc_address for p in j.get_clients(k)])
        for dc in ("dc0", "dc1", "dc2"):
            assert t.pick(dc, k).info.grpc_address == j.pick(dc, k).info.grpc_address
    assert sorted(t.regions) == sorted(j.regions)
