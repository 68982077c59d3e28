"""The stores' resharding surface against the JAX stores.

`resident_keys`, `resident_mask`, `drain_keys` (gather only, and with
`remove`) and `forget_keys` of the port's MeshBucketStore (single-tier
and two-tier) and ShardStore against a JAX store of the same kind, on
state made by the same seeded traffic (columnar batches, a GLOBAL
dataclass batch on the mesh, whose GLOBAL keys a drain skips).  The
transfer columns, the tables (keys, slots, tier stats, back entries)
and the state bytes must be identical, and so must the answers of the
traffic after them (a freed slot is reused in the same order).  The
C++ table's `remove` matches the JAX table's call by call in two-tier
mode: a removed key leaves the back tier and its queued demotion is
cancelled.
"""

import random

import numpy as np
import pytest

from gubernator_tpu import native as jnative
from gubernator_tpu.models.shard import ShardStore as JaxShard
from gubernator_tpu.parallel.mesh import MeshBucketStore as JaxStore
from gubernator_tpu.types import RateLimitRequest as JaxRequest
from gubernator_tpu_torch import native
from gubernator_tpu_torch.models.shard import ShardStore
from gubernator_tpu_torch.parallel.mesh import MeshBucketStore
from gubernator_tpu_torch.types import Behavior, RateLimitRequest
from tests.test_torch_shard_store import same_store
from tests.test_torch_two_tier import T0, Pair, TablePair

FIELDS = ("status", "limit", "remaining", "reset_time")
TRANSFER = ("algorithm", "status", "limit", "remaining", "duration", "stamp", "expire_at")


def _batch(rng, n, n_keys, prefix="r"):
    ids = rng.integers(0, n_keys, n)
    keys = [f"rs_{prefix}{i}" for i in ids]
    return keys, dict(
        algorithm=(ids % 2).astype(np.int32), behavior=np.zeros(n, np.int32),
        hits=rng.choice([0, 1, 2], n).astype(np.int64), limit=np.full(n, 20, np.int64),
        duration=rng.choice([500, 60_000], n).astype(np.int64))


def _cols(j, t, keys, cols, now):
    a = j.apply_columns(keys, now_ms=now, **cols)
    b = t.apply_columns(keys, now_ms=now, **cols)
    for f in FIELDS:
        assert np.array_equal(np.asarray(a[f]), np.asarray(b[f])), f


def _same_transfer(a, b):
    assert a.keys == b.keys
    for f in TRANSFER:
        assert np.asarray(getattr(a, f)).tobytes() == np.asarray(getattr(b, f)).tobytes(), f
    return b


def _check(j, t, check):
    assert j.resident_keys() == t.resident_keys()
    check()


def _surface(j, t, check, now, seed):
    """The four calls on both stores, then traffic over the freed slots."""
    rng = np.random.default_rng(seed)
    _check(j, t, check)
    res = t.resident_keys()
    probe = res[::3] + [f"rs_absent{i}" for i in range(5)]
    assert j.resident_mask(probe).tolist() == t.resident_mask(probe).tolist()
    assert t.resident_mask(probe).sum() == len(res[::3])
    assert t.resident_mask([]).shape == (0,)
    # Gather only (the handoff's drain): the tables keep every key.
    moved = res[1::2] + ["rs_absent0"]
    _same_transfer(j.drain_keys(moved, now, remove=False),
                   t.drain_keys(moved, now, remove=False))
    _check(j, t, check)
    # The handoff's forget after an acknowledged transfer.
    j.forget_keys(moved[: len(moved) // 2])
    t.forget_keys(moved[: len(moved) // 2])
    _check(j, t, check)
    # A drain with remove: rows out, keys gone (expired rows too).
    gone = res[::4] + ["rs_absent1"]
    got = _same_transfer(j.drain_keys(gone, now + 1_000, remove=True),
                         t.drain_keys(gone, now + 1_000, remove=True))
    assert len(got) > 0
    _check(j, t, check)
    # GLOBAL keys stay: they move through their own replication plane.
    assert t.resident_mask(gone).tolist() == [k.startswith("rs_g") for k in gone]
    # New keys take the freed slots in the same order.
    for i in range(3):
        _cols(j, t, *_batch(rng, 64, 400, prefix="n"), now + 2_000 + i)
        check()


@pytest.mark.parametrize("back", [0, 64], ids=["single_tier", "two_tier"])
def test_mesh_store_surface_matches_jax(back):
    if back:
        pair = Pair(16, back)
        j, t = pair.j, pair.t
        check = pair.check
    else:
        j = JaxStore(capacity_per_shard=64, g_capacity=4096)
        t = MeshBucketStore(capacity_per_shard=64, g_capacity=4096, device="cpu")

        def check():
            assert np.asarray(j.state.hot).tobytes() == t.state.hot.numpy().tobytes()
            assert np.asarray(j.state.cold).tobytes() == t.state.cold.numpy().tobytes()
            for jt, tt in zip(j.tables, t.tables, strict=True):
                keys, slots = tt.entries()
                assert jt.keys() == keys
                assert [jt.get_slot(k) for k in keys] == slots.tolist()
    rng = np.random.default_rng(7)
    for i in range(6):
        _cols(j, t, *_batch(rng, 96, 300), T0 + 100 * i)
    # GLOBAL keys owned here: resident, but never drained.
    greqs = [RateLimitRequest(name="rs", unique_key=f"g{i}", hits=1, limit=50,
                              duration=60_000, behavior=Behavior.GLOBAL) for i in range(6)]
    a = j.apply([JaxRequest(**vars(r)) for r in greqs], T0 + 700)
    b = t.apply(greqs, T0 + 700)
    assert [(x.status, x.remaining) for x in a] == [(x.status, x.remaining) for x in b]
    gkeys = [r.hash_key() for r in greqs]
    assert t.resident_mask(gkeys).all()
    assert len(t.drain_keys(gkeys, T0 + 800, remove=False)) == 0
    _surface(j, t, check, T0 + 800, seed=8)


def test_shard_store_surface_matches_jax():
    j, t = JaxShard(capacity=512), ShardStore(capacity=512, device="cpu")
    rng = np.random.default_rng(9)
    for i in range(6):
        _cols(j, t, *_batch(rng, 96, 300), T0 + 100 * i)
    _surface(j, t, lambda: same_store(j, t), T0 + 800, seed=10)


def test_packed_keys_resident_mask():
    t = MeshBucketStore(capacity_per_shard=32, g_capacity=4096, device="cpu")
    keys = [f"rs_p{i}" for i in range(40)]
    t.apply_columns(keys, np.zeros(40, np.int32), np.zeros(40, np.int32),
                    np.ones(40, np.int64), np.full(40, 5, np.int64),
                    np.full(40, 60_000, np.int64), T0)
    probe = keys[::2] + ["rs_x", "rs_y"]
    packed = native.PackedKeys(*native.as_packed(probe))
    assert t.resident_mask(packed).tolist() == t.resident_mask(probe).tolist() == \
        [True] * 20 + [False, False]


def test_table_remove_cancels_a_queued_demotion():
    pair = TablePair(1, 4)
    sa, _ = pair.lookup_or_assign("a", T0)
    pair.set_expire(sa, T0 + 60_000)
    pair.lookup_or_assign("b", T0)  # demotes "a": one queued demotion
    assert pair.move_counts() == (0, 1)
    pair.remove("a")  # leaves the back tier, its demotion cancelled
    keys, _, _ = pair.t.back_entries()  # pair.check() compared them with JAX's
    assert "a" not in keys and pair.tier_stats[1] == 0
    pk, ps, pd, ds, dd = pair.take_moves()
    assert int((ds >= 0).sum()) == 0
    assert pair.lookup_or_assign("a", T0)[1] is False
    pair.remove("a")  # a front key: its slot is freed
    pair.remove("missing")
    assert pair.get_slot("a") is None


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_table_random_ops_with_remove_match_jax(seed):
    rng = random.Random(seed)
    pair = TablePair(rng.choice([1, 2, 3]), rng.choice([1, 2, 5]))
    for _ in range(500):
        k, now = f"k{rng.randrange(10)}", T0 + rng.randrange(50)
        r = rng.random()
        if r < 0.65:
            slot, _ = pair.lookup_or_assign(k, now)
            pair.set_expire(slot, now + rng.randrange(-10, 100))
        elif r < 0.85:
            pair.remove(k)
        else:
            pair.take_moves()


def test_single_tier_table_remove_matches_jax():
    j, t = jnative.NativeSlotTable(4), native.NativeSlotTable(4)
    rng = random.Random(5)
    for _ in range(300):
        k = f"k{rng.randrange(8)}"
        if rng.random() < 0.7:
            a, b = j.lookup_or_assign(k, T0), t.lookup_or_assign(k, T0)
            assert a == b
            j.set_expire(a[0], T0 + 60_000)
            t.set_expire(b[0], T0 + 60_000)
        else:
            j.remove(k)
            t.remove(k)
        assert j.keys() == t.keys()
        assert j.generation == t.generation


def test_store_spi_global_sync_calls_match_jax():
    """The owner-side apply of summed GLOBAL hits under a Store SPI: key
    by key, store.on_change with the gslot's request template (or
    store.remove), as the JAX store's sync does."""
    from tests.test_torch_persist import StorePair, _items

    st = StorePair()
    now = T0
    reqs = [RateLimitRequest(name="rs", unique_key=f"g{i % 5}", hits=1 + i % 3, limit=8,
                             duration=60_000, algorithm=i % 2, behavior=Behavior.GLOBAL)
            for i in range(12)]
    for lo in range(0, 12, 4):
        st.apply(reqs[lo:lo + 4], now)
        a, b = st.j.sync_globals(now), st.t.sync_globals(now)
        assert st.js.called == st.ts.called
        assert _items(st.js) == _items(st.ts)
        assert (a.broadcast_cols is None) == (b.broadcast_cols is None)
        now += 100
    assert st.ts.called["OnChange()"] > 0
