"""The port's two-tier (front/back) bucket table against the JAX
package's.

The cases of tests/test_two_tier.py, the columnar churn over shifting
key windows with two batches in flight, a GLOBAL key demoted by churn
and then synced, the carry-over of a two-tier state, the service's
`back_cache_size`, and the plain tier move (ops/buckets.py
apply_moves_plain) against the JAX `apply_moves` on seeded records.
Each store case drives a JAX MeshBucketStore (8-device virtual CPU
mesh, tests/conftest.py) and a port store (`device="cpu"`) from empty
with the same seeded traffic.  Everything is integer, so the tolerance
is 0: answers, front and back state bytes, `tier_stats`, each table's
entries and back entries (in the same order) and `snapshot_items`
must be identical.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_moves
from gubernator_tpu import native as jnative
from gubernator_tpu.ops import buckets as jbuckets
from gubernator_tpu.parallel.mesh import MeshBucketStore as JaxStore
from gubernator_tpu.parallel.mesh import _moves_mesh_jit
from gubernator_tpu.types import RateLimitRequest as JaxRequest
from gubernator_tpu_torch import native
from gubernator_tpu_torch.ops import buckets
from gubernator_tpu_torch.parallel.mesh import MeshBucketStore, shard_of_key
from gubernator_tpu_torch.service import ServiceConfig, V1Service
from gubernator_tpu_torch.types import Algorithm, Behavior, RateLimitRequest

T0 = 1_573_430_430_000
S = 8


def mk(key, hits=1, limit=10, duration=60_000, algo=Algorithm.TOKEN_BUCKET, behavior=0):
    return RateLimitRequest(name="tt", unique_key=key, hits=hits, limit=limit,
                            duration=duration, algorithm=algo, behavior=behavior)


# ---------------------------------------------------------------------
# the slot table's two-tier mode (tests/test_two_tier.py's table cases)
# ---------------------------------------------------------------------
class TablePair:
    """A JAX and a port NativeSlotTable given the same calls; every
    call's result must be identical, and after each call the tier
    stats, queued move counts and back entries."""

    def __init__(self, front, back):
        self.j, self.t = jnative.NativeSlotTable(front), native.NativeSlotTable(front)
        self.j.enable_back(back)
        self.t.enable_back(back)

    def __getattr__(self, name):
        def call(*args):
            a, b = getattr(self.j, name)(*args), getattr(self.t, name)(*args)
            if name == "take_moves":
                for x, y in zip(a, b, strict=True):
                    assert x.tobytes() == y.tobytes(), (name, x, y)
            else:
                assert a == b, (name, args, a, b)
            self.check()
            return b
        return call

    @property
    def tier_stats(self):
        assert self.j.tier_stats == self.t.tier_stats
        return self.t.tier_stats

    def check(self):
        assert self.j.tier_stats == self.t.tier_stats
        assert self.j.move_counts() == self.t.move_counts()
        (jk, js, je), (tk, ts, te) = self.j.back_entries(), self.t.back_entries()
        assert jk == tk and js.tobytes() == ts.tobytes() and je.tobytes() == te.tobytes()
        assert self.j.keys() == self.t.keys()


def case_demote_promote_records(t):
    s1, _ = t.lookup_or_assign("a", T0)
    t.set_expire(s1, T0 + 60_000)  # only live rows demote
    s2, _ = t.lookup_or_assign("b", T0)
    t.set_expire(s2, T0 + 60_000)
    s3, e3 = t.lookup_or_assign("c", T0)  # evicts "a": demoted
    assert s3 == s1 and e3 is False
    assert t.move_counts() == (0, 1)
    s4, e4 = t.lookup_or_assign("a", T0)  # promoted back, "b" demoted
    assert e4 is True
    assert t.move_counts() == (1, 2)
    pk, ps, pd, ds, dd = t.take_moves()
    assert pk[0] == 1 and pd[0] == s4  # re-promoted inside the window
    assert t.tier_stats == (3, 1, 2, 1, 0)


def case_expired_rows_drop(t):
    s, _ = t.lookup_or_assign("x", T0)
    t.set_expire(s, T0 + 10)
    t.lookup_or_assign("y", T0 + 1000)  # x expired: dropped
    assert t.move_counts() == (0, 0) and t.tier_stats[1] == 0


def case_back_fifo_eviction(t):
    for k in "abcd":
        s, _ = t.lookup_or_assign(k, T0)
        t.set_expire(s, T0 + 60_000)
    assert t.tier_stats[1] == 2 and t.tier_stats[4] == 1  # "a" fell off
    assert t.lookup_or_assign("a", T0)[1] is False


def case_fifo_wrap_during_promotion(t):
    sa, _ = t.lookup_or_assign("a", T0)
    t.set_expire(sa, T0 + 60_000)
    sb, _ = t.lookup_or_assign("b", T0)
    t.set_expire(sb, T0 + 50_000)
    t.take_moves()
    sa2, ea = t.lookup_or_assign("a", T0)  # promote a, demote b
    assert ea is True
    assert t.get_expire_bulk([sa2])[0] == T0 + 60_000
    keys, _, exp = t.back_entries()
    assert keys == ["b"] and exp[0] == T0 + 50_000
    assert t.lookup_or_assign("b", T0)[1] is True


def case_back_capacity_one(t):
    sa, _ = t.lookup_or_assign("a", T0)
    t.set_expire(sa, T0 + 60_000)
    sb, _ = t.lookup_or_assign("b", T0)
    t.set_expire(sb, T0 + 50_000)
    t.take_moves()
    sa2, ea = t.lookup_or_assign("a", T0)  # b has nowhere to go
    assert ea is True and t.get_expire_bulk([sa2])[0] == T0 + 60_000
    assert t.lookup_or_assign("b", T0)[1] is False  # lost, not corrupted


def case_starved_fallback(t):
    for k in ("ka", "kb", "kc", "kd"):  # kc, kd demote ka, kb
        s, _ = t.lookup_or_assign(k, T0)
        t.set_expire(s, T0 + 60_000)
    t.take_moves()
    sa, ea = t.lookup_or_assign("ka", T0)
    sb, eb = t.lookup_or_assign("kb", T0)
    assert ea and eb
    se, ee = t.lookup_or_assign("ke", T0)  # every slot awaits a promotion
    assert ee is False
    pk, ps, pd, ds, dd = t.take_moves()
    assert int((ps >= 0).sum()) == 1  # the evicted promotion was cancelled
    assert all(int(s) < 0 or int(d) != se for s, d in zip(ds, dd))
    assert t.lookup_or_assign("ka" if se == sa else "kb", T0)[1] is False


# case: (front, back, steps, starved evictions: lookups that found every
# front slot awaiting a promotion)
TABLE_CASES = {
    "demote_promote_records": (2, 8, case_demote_promote_records, 0),
    "expired_rows_drop": (1, 4, case_expired_rows_drop, 0),
    "back_fifo_eviction": (1, 2, case_back_fifo_eviction, 0),
    "fifo_wrap_during_promotion": (1, 2, case_fifo_wrap_during_promotion, 1),
    "back_capacity_one": (1, 1, case_back_capacity_one, 1),
    "starved_fallback": (2, 8, case_starved_fallback, 1),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_table_case_matches_jax(case):
    front, back, fn, starved = TABLE_CASES[case]
    pair = TablePair(front, back)
    fn(pair)
    assert pair.t.starved_evictions == starved


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_random_ops_match_jax(seed):
    rng = random.Random(seed)
    pair = TablePair(rng.choice([1, 2, 3]), rng.choice([1, 2, 5]))
    for _ in range(400):
        k, now = f"k{rng.randrange(10)}", T0 + rng.randrange(50)
        if rng.random() < 0.8:
            slot, _ = pair.lookup_or_assign(k, now)
            pair.set_expire(slot, now + rng.randrange(-10, 100))
        else:
            pair.take_moves()


# ---------------------------------------------------------------------
# the tier move: plain version against the JAX program
# ---------------------------------------------------------------------
def random_tiers(rng, C, Cb):
    return [rng.integers(-2**31, 2**31, (S, n, 8)).astype(np.int32)
            for n in (C, C, Cb, Cb)]


def jax_moves(tiers, moves):
    """The JAX store's drain: [S, Pm] padded records through
    _moves_mesh_jit."""
    pp = max(max(len(m[0]) for m in moves), 1)
    dp = max(max(len(m[3]) for m in moves), 1)
    pk, pd, dd = (np.zeros((S, n), np.int32) for n in (pp, pp, dp))
    ps, ds = np.full((S, pp), -1, np.int32), np.full((S, dp), -1, np.int32)
    for s, (a, b, c, d, e) in enumerate(moves):
        pk[s, :len(a)], ps[s, :len(a)], pd[s, :len(a)] = a, b, c
        ds[s, :len(d)], dd[s, :len(d)] = d, e
    state, back = _moves_mesh_jit(
        jbuckets.BucketState(jnp.asarray(tiers[0]), jnp.asarray(tiers[1])),
        jbuckets.BackState(jnp.asarray(tiers[2]), jnp.asarray(tiers[3])),
        *[jnp.asarray(a) for a in (pk, ps, pd, ds, dd)])
    return [np.asarray(a) for a in (*state, *back)]


@pytest.mark.parametrize("seed,C,Cb,n_demo,n_promo", [
    (0, 64, 256, 20, 15), (1, 64, 64, 40, 30), (2, 32, 512, 0, 12), (3, 32, 16, 9, 0)])
def test_apply_moves_plain_matches_jax(seed, C, Cb, n_demo, n_promo):
    rng = np.random.default_rng(seed)
    tiers = random_tiers(rng, C, Cb)
    moves = random_moves(rng, C, Cb, n_demo, n_promo)
    want = jax_moves(tiers, moves)
    records = buckets.moves_to_records(moves)
    for order in (records, records[:, ::-1]):  # either order, the same bytes
        got = [torch.tensor(a) for a in tiers]
        buckets.apply_moves_plain(*got, torch.tensor(np.ascontiguousarray(order)))
        for g, w in zip(got, want, strict=True):
            assert g.numpy().tobytes() == w.tobytes()


def test_apply_moves_plain_rejects_repeated_destinations():
    rng = np.random.default_rng(4)
    tiers = [torch.tensor(a) for a in random_tiers(rng, 16, 16)]
    twice = np.array([[2, 2], [0, 1], [5, 5]], np.int32)  # two demotions to back[5]
    with pytest.raises(ValueError, match="more than once"):
        buckets.apply_moves_plain(*tiers, torch.tensor(twice))


# ---------------------------------------------------------------------
# stores
# ---------------------------------------------------------------------
class Pair:
    """A JAX and a port two-tier MeshBucketStore driven with the same
    calls, compared after each."""

    def __init__(self, front, back, g_capacity=4096):
        self.j = JaxStore(capacity_per_shard=front, back_capacity_per_shard=back,
                          g_capacity=g_capacity)
        self.t = MeshBucketStore(capacity_per_shard=front, back_capacity_per_shard=back,
                                 g_capacity=g_capacity, device="cpu")

    def apply(self, reqs, now, **kw):
        a = self.j.apply([JaxRequest(**vars(r)) for r in reqs], now, **kw)
        b = self.t.apply(reqs, now, **kw)
        assert [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in a] == \
            [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in b]
        self.check()
        return b

    def check(self):
        for (jx, tx) in ((self.j.state, self.t.state), (self.j.back, self.t.back)):
            assert np.asarray(jx.hot).tobytes() == tx.hot.numpy().tobytes()
            assert np.asarray(jx.cold).tobytes() == tx.cold.numpy().tobytes()
        for jt, tt in zip(self.j.tables, self.t.tables, strict=True):
            assert jt.tier_stats == tt.tier_stats
            keys, slots = tt.entries()
            assert jt.keys() == keys
            assert [jt.get_slot(k) for k in keys] == slots.tolist()
            (jk, js, je), (tk, ts, te) = jt.back_entries(), tt.back_entries()
            assert jk == tk and js.tobytes() == ts.tobytes() and je.tobytes() == te.tobytes()
        self.t.check_consistency()

    def items(self):
        a, b = self.j.snapshot_items(), self.t.snapshot_items()
        assert [(i.key, i.algorithm, i.expire_at, vars(i.value)) for i in a] == \
            [(i.key, i.algorithm, i.expire_at, vars(i.value)) for i in b]
        self.check()
        return b


@pytest.mark.parametrize("algo", [Algorithm.TOKEN_BUCKET, Algorithm.LEAKY_BUCKET])
def test_dataclass_churn_matches_jax(algo):
    """front=2 per shard: constant demote/promote churn, one request per
    batch as in tests/test_two_tier.py."""
    rng = random.Random(11)
    pair = Pair(2, 512)
    now = T0
    for _ in range(120):
        now += rng.randrange(0, 500)
        pair.apply([mk(f"k{rng.randrange(40)}", hits=rng.choice([0, 1, 1, 2]), algo=algo)],
                   now)
    stats = [t.tier_stats for t in pair.t.tables]
    assert sum(s[2] for s in stats) > 20 and sum(s[3] for s in stats) > 20, stats


def test_snapshot_items_include_back_rows():
    pair = Pair(8, 256)
    for i in range(64):
        pair.apply([mk(f"s{i}", algo=i % 2)], T0)
    items = pair.items()
    assert {it.key for it in items} == {f"tt_s{i}" for i in range(64)}
    assert sum(t.tier_stats[1] for t in pair.t.tables) > 0  # some came from the back


def drive(store, batches):
    """apply_columns_async with two batches in flight: batch i+1 is
    planned before batch i is read back."""
    out, pending = [], None
    for keys, cols, now in batches:
        h = store.apply_columns_async(keys, now_ms=now, **cols)
        if pending is not None:
            out.append(pending.result())
        pending = h
    out.append(pending.result())
    return out


def test_columnar_churn_two_in_flight_matches_jax():
    """Shifting key windows: each batch's per-shard keys fit the front,
    consecutive windows demote and promote constantly; both stores
    plan each batch with the previous one in flight."""
    rng = np.random.default_rng(5)
    pair = Pair(24, 2048)
    batches = []
    now = T0
    for step in range(10):
        n = 240
        ids = (step % 4) * 60 + rng.integers(0, 80, n)
        now += 700
        batches.append(([f"c{k}" for k in ids], dict(
            algorithm=(ids % 2).astype(np.int32), behavior=np.zeros(n, np.int32),
            hits=rng.choice([0, 1, 1, 2], n).astype(np.int64),
            limit=np.full(n, 50, np.int64), duration=np.full(n, 60_000, np.int64)), now))
    got_j, got_t = drive(pair.j, batches), drive(pair.t, batches)
    for a, b in zip(got_j, got_t, strict=True):
        for f in ("status", "limit", "remaining", "reset_time"):
            assert np.asarray(a[f]).tobytes() == np.asarray(b[f]).tobytes(), f
    pair.check()
    stats = [t.tier_stats for t in pair.t.tables]
    assert sum(s[2] for s in stats) > 100 and sum(s[3] for s in stats) > 100, stats
    pair.items()


def test_drain_launches_once_per_window_and_not_when_idle():
    store = MeshBucketStore(capacity_per_shard=2, back_capacity_per_shard=64, device="cpu")
    per_shard = [[] for _ in range(S)]
    i = 0
    while min(len(k) for k in per_shard) < 4:  # four keys of each shard
        key = f"w{i}"
        i += 1
        if len(per_shard[shard_of_key(f"tt_{key}", S)]) < 4:
            per_shard[shard_of_key(f"tt_{key}", S)].append(key)

    def batch(part, now):
        keys = [f"tt_{k}" for ks in per_shard for k in ks[2 * part:2 * part + 2]]
        n = len(keys)
        store.apply_columns(keys, np.zeros(n, np.int32), np.zeros(n, np.int32),
                            np.ones(n, np.int64), np.full(n, 9, np.int64),
                            np.full(n, 60_000, np.int64), now)

    batch(0, T0)
    assert store.move_dispatches == 0  # fills every front
    batch(1, T0 + 1)
    assert store.move_dispatches == 1  # every shard's demotions in one launch
    assert [t.tier_stats[1:4] for t in store.tables] == [(2, 2, 0)] * S
    batch(1, T0 + 2)
    assert store.move_dispatches == 1  # front-resident: nothing queued
    batch(0, T0 + 3)
    assert store.move_dispatches == 2  # promotions and demotions, one launch
    assert [t.tier_stats[1:4] for t in store.tables] == [(2, 4, 2)] * S


def test_global_key_demoted_by_churn_then_synced():
    pair = Pair(4, 256, g_capacity=16)
    g = mk("gk", behavior=int(Behavior.GLOBAL))
    pair.apply([g], T0)
    home = shard_of_key("tt_gk", S)
    for i in range(64):  # churn every front table so "gk" demotes
        pair.apply([mk(f"churn{i}")], T0 + 1)
    t = pair.t.tables[home]
    assert t.get_slot("tt_gk") is None and "tt_gk" in t.back_entries()[0]
    a, b = pair.j.sync_globals(T0 + 2), pair.t.sync_globals(T0 + 2)
    assert a.broadcast_count == b.broadcast_count == 1
    assert vars(a.broadcasts[0].status) == vars(b.broadcasts[0].status)
    assert b.broadcasts[0].status.remaining == 9
    pair.check()
    pair.apply([g, mk("gk", hits=2, behavior=int(Behavior.GLOBAL))], T0 + 3,
               home_shard=(home + 1) % S)
    pair.j.sync_globals(T0 + 4)
    pair.t.sync_globals(T0 + 4)
    pair.check()


def test_rejects_a_store_spi():
    class DummyStore:
        def get(self, *a):
            return None

        def on_change(self, *a):
            pass

        def remove(self, *a):
            pass

    with pytest.raises(ValueError, match="Store SPI"):
        MeshBucketStore(capacity_per_shard=8, back_capacity_per_shard=64,
                        store=DummyStore(), device="cpu")


@pytest.mark.parametrize("back,per_shard", [(0, 0), (1, 1), (4096, 512), (4097, 513)])
def test_service_back_cache_size_reaches_the_store(back, per_shard):
    svc = V1Service(ServiceConfig(cache_size=64, back_cache_size=back, device="cpu",
                                  global_sync_wait_s=3600.0))
    try:
        store = svc.store
        assert store.back_capacity_per_shard == per_shard
        if per_shard:
            assert tuple(store.back.hot.shape) == (S, per_shard, 8)
            assert all(t.tier_stats == (0, 0, 0, 0, 0) for t in store.tables)
        else:
            assert store.back is None
    finally:
        svc.close()


def test_carry_over_with_a_back_tier():
    """A JAX two-tier store's state loaded into a port store: both then
    answer the same batches identically.  The traffic stays below the
    back tier's wrap, where the FIFO cursor equals the demotion count
    (the JAX table does not expose it)."""
    rng = np.random.default_rng(8)
    j = JaxStore(capacity_per_shard=6, back_capacity_per_shard=128)
    now = T0
    for step in range(4):
        ids = step * 20 + rng.integers(0, 30, 60)
        j.apply([JaxRequest(**vars(mk(f"co{k}", algo=int(k % 2)))) for k in ids], now)
        now += 300
    entries, back_entries, cursors = [], [], []
    for jt in j.tables:
        keys = jt.keys()
        slots = np.array([jt.get_slot(k) for k in keys], np.int32)
        entries.append((keys, slots, jt.get_expire_bulk(slots)))
        back_entries.append(jt.back_entries())
        cursors.append(jt.tier_stats[2])
        assert jt.tier_stats[4] == 0  # below the wrap
    assert sum(c for c in cursors) > 20
    t = MeshBucketStore(capacity_per_shard=6, back_capacity_per_shard=128, device="cpu")
    t.load_state_numpy(np.asarray(j.state.hot), np.asarray(j.state.cold), entries,
                       back=(np.asarray(j.back.hot), np.asarray(j.back.cold),
                             back_entries, cursors))
    for jt, tt in zip(j.tables, t.tables, strict=True):
        assert sorted(jt.back_entries()[0]) == sorted(tt.back_entries()[0])
    # The loaded fronts' LRU order is their commit order, not the JAX
    # tables' recency, so later evictions pick other victims and slots:
    # the answers and every key's row (front or back) stay identical.
    for step in range(4):
        ids = (step + 2) * 20 + rng.integers(0, 30, 60)
        reqs = [mk(f"co{k}", algo=int(k % 2)) for k in ids]
        a = j.apply([JaxRequest(**vars(r)) for r in reqs], now)
        b = t.apply(reqs, now)
        assert [(r.status, r.remaining, r.reset_time) for r in a] == \
            [(r.status, r.remaining, r.reset_time) for r in b]
        now += 300
    assert sum(tt.tier_stats[3] for tt in t.tables) > 0  # promotions after the load
    assert [jt.tier_stats[0] for jt in j.tables] == [tt.tier_stats[0] for tt in t.tables]
    assert sorted((i.key, i.algorithm, i.expire_at, tuple(vars(i.value).values()))
                  for i in j.snapshot_items()) == \
        sorted((i.key, i.algorithm, i.expire_at, tuple(vars(i.value).values()))
               for i in t.snapshot_items())


def test_load_state_needs_back_exactly_with_a_back_tier():
    t = MeshBucketStore(capacity_per_shard=4, back_capacity_per_shard=8, device="cpu")
    z = np.zeros((S, 4, 8), np.int32)
    empty = [([], np.zeros(0, np.int32), np.zeros(0, np.int64))] * S
    with pytest.raises(ValueError, match="back"):
        t.load_state_numpy(z, z, empty)
