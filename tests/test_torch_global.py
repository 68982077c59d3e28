"""The port's GLOBAL plane against the JAX package's.

Kernel functions: the plain versions of the answer, sync and replica
programs (ops/global_ops.py) against the JAX programs they transcribe
(parallel/mesh.py `_answer_rounds_jit`, `_get_sync_fn`,
`_set_replica_jit`, `_clear_jit`) on the same seeded numpy inputs.
Stores: the scenarios of tests/test_global.py, a seeded randomized
differential, the replica commit and the GLOBAL state carry-over, run on
a JAX store (8-device virtual CPU mesh, tests/conftest.py) and a port
store (`device="cpu"`) side by side.  Everything is integer, so the
tolerance is 0: responses, hot/cold state, replica columns, the key
table's mirrors and every SyncResult column must be identical.
"""

import numpy as np
import pytest
import torch

from gubernator_tpu.ops import buckets as jbuckets
from gubernator_tpu.ops import global_ops as jglobal
from gubernator_tpu.parallel import mesh as jmesh
from gubernator_tpu.parallel.global_mgr import GlobalsColumns as JaxGlobalsColumns
from gubernator_tpu.parallel.mesh import MeshBucketStore as JaxStore
from gubernator_tpu.types import RateLimitRequest as JaxRequest
from gubernator_tpu_torch.ops import global_ops
from gubernator_tpu_torch.ops.buckets import state_to_numpy
from gubernator_tpu_torch.parallel.global_mgr import GlobalsColumns
from gubernator_tpu_torch.parallel.mesh import MeshBucketStore, shard_of_key
from gubernator_tpu_torch.types import Algorithm, Behavior, RateLimitRequest, Status

T0 = 1_573_430_430_000
S = 8
GLOBAL = int(Behavior.GLOBAL)


# ---------------------------------------------------------------------
# kernel functions: plain versions against the JAX programs
# ---------------------------------------------------------------------
def _split(v):
    v = np.asarray(v, np.int64)
    return (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32), (v >> 32).astype(np.int32)


def random_state(rng, C):
    n = S * C
    algo = rng.integers(0, 2, n)
    limit = rng.integers(0, 50, n)
    rem = (rng.random(n) * (limit + 1)).astype(np.int64)
    rem = np.where(algo == 1, rem * (1 << 20) + rng.integers(0, 1 << 20, n), rem)
    expire = T0 + rng.integers(-30_000, 60_000, n)
    expire = np.where(rng.random(n) < 0.1, T0, expire)  # expiry at the exact ms
    hot = np.zeros((n, 8), np.int32)
    cold = np.zeros((n, 8), np.int32)
    hot[:, 0] = algo | (rng.integers(0, 2, n) << 2)
    hot[:, 1], hot[:, 2] = _split(rem)
    hot[:, 3], hot[:, 4] = _split(T0 - rng.integers(0, 120_000, n))
    hot[:, 5], hot[:, 6] = _split(expire)
    cold[:, 0], cold[:, 1] = _split(limit)
    cold[:, 2], cold[:, 3] = _split(rng.choice([1000, 30_000, 60_000], n))
    return hot.reshape(S, C, 8), cold.reshape(S, C, 8)


def random_gcols(rng, G):
    return [
        rng.integers(0, 2, (S, G)).astype(np.int32),
        rng.integers(0, 50, (S, G)).astype(np.int64),
        rng.integers(0, 50, (S, G)).astype(np.int64),
        T0 + rng.integers(-1000, 60_000, (S, G)),
        # live (>= T0, some exactly T0) or expired replica entries
        np.where(rng.random((S, G)) < 0.5, T0 + rng.integers(-2, 3, (S, G)), 0),
        rng.integers(-3, 9, (S, G)).astype(np.int64),
    ]


def to_torch_gcols(cols):
    return global_ops.global_columns_from_numpy(cols, "cpu")


def to_jax_gcols(cols):
    return jglobal.GlobalColumns(*[np.array(c) for c in cols])


def same_gcols(jcols, tcols):
    for name, a, b in zip(global_ops.GlobalColumns._fields, jcols, tcols):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def answer_case(rng, C, P, G, n_rounds):
    """Lanes as the dataclass path plans them: unique slots per (round,
    shard), duplicate gslots, GLOBAL lanes with live or dead replica
    entries (the same gslot both answered from the replica at one shard
    and evaluated at another), negative hits, 25% padding."""
    used = P * 3 // 4
    slot = np.full((S, P), -1, np.int32)
    rid = np.zeros((S, P), np.int32)
    gslot = np.full((S, P), -1, np.int32)
    for s in range(S):
        rid[s, :used] = rng.integers(0, n_rounds, used)
        for r in range(n_rounds):
            sel = np.nonzero(rid[s, :used] == r)[0]
            slot[s, sel] = rng.choice(C, sel.size, replace=False)
        g = np.where(rng.random(used) < 0.5, rng.integers(0, G, used), -1)
        gslot[s, :used] = g
    slot = np.where(rng.random((S, P)) < 0.1, -1, slot)  # replica-hint lanes
    cols = dict(
        slot=slot,
        exists=rng.random((S, P)) < 0.8,
        algorithm=rng.integers(0, 2, (S, P)).astype(np.int32),
        behavior=rng.choice([0, GLOBAL, GLOBAL | 8, GLOBAL | 4], (S, P)).astype(np.int32),
        hits=rng.choice([-2, 0, 1, 1, 2, 5], (S, P)).astype(np.int64),
        limit=rng.choice([1, 5, 20, 49], (S, P)).astype(np.int64),
        duration=rng.choice([1000, 30_000, 60_000], (S, P)).astype(np.int64),
        greg_expire=np.zeros((S, P), np.int64),
        greg_duration=np.zeros((S, P), np.int64),
    )
    greg = (cols["behavior"] & 4) != 0
    cols["greg_expire"] = np.where(greg, T0 + 86_400_000 - 5, 0)
    cols["greg_duration"] = np.where(greg, 86_400_000, 0)
    occ = np.zeros((S, P), np.int32)
    write = slot >= 0
    return cols, occ, write, rid, gslot


@pytest.mark.parametrize("seed,n_rounds", [(0, 1), (1, 3)])
def test_answer_rounds_matches_jax(seed, n_rounds):
    rng = np.random.default_rng(seed)
    C, P, G = 64, 64, 16
    hot, cold = random_state(rng, C)
    gc = random_gcols(rng, G)
    cols, occ, write, rid, gslot = answer_case(rng, C, P, G, n_rounds)

    jbatch = jbuckets.RequestBatch(**{k: np.array(v) for k, v in cols.items()},
                                   occ=occ, write=write)
    jstate, jg, jpacked = jmesh._answer_rounds_jit(
        jbuckets.BucketState(np.array(hot), np.array(cold)), to_jax_gcols(gc),
        jbatch, jglobal.GlobalBatchExtra(gslot=gslot), rid, n_rounds, T0)

    lanes = np.stack([cols["slot"], cols["exists"] | (write << 1), cols["algorithm"],
                      cols["behavior"], occ, rid], axis=1).astype(np.int32)
    values = np.stack([cols[k] for k in ("hits", "limit", "duration", "greg_expire",
                                         "greg_duration")], axis=1)
    th, tc, tg = torch.tensor(hot), torch.tensor(cold), to_torch_gcols(gc)
    packed = global_ops.answer_rounds(th, tc, tg, torch.tensor(lanes), torch.tensor(values),
                                      torch.tensor(gslot), n_rounds, T0)
    np.testing.assert_array_equal(np.asarray(jpacked), packed.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.hot), th.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.cold), tc.numpy())
    same_gcols(jg, tg)
    cached = (packed.numpy()[:, 0] >> 2) & 1
    assert cached.any() and (cached == 0).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_global_sync_matches_jax(seed):
    rng = np.random.default_rng(seed)
    C, G = 64, 32
    hot, cold = random_state(rng, C)
    gc = random_gcols(rng, G)
    owner_shard = rng.integers(-1, S, G).astype(np.int32)  # -1: a remote owner
    owner_slot = np.where(rng.random(G) < 0.9, rng.permutation(C)[:G], -1).astype(np.int32)
    greg = rng.random(G) < 0.2
    cfg = global_ops.SyncConfig(
        owner_slot=owner_slot, owner_shard=owner_shard,
        algorithm=rng.integers(0, 2, G).astype(np.int32),
        behavior=np.where(greg, 4, rng.choice([0, 8], G)).astype(np.int32),
        limit=rng.choice([5, 20, 49], G).astype(np.int64),
        duration=rng.choice([1000, 60_000], G).astype(np.int64),
        greg_expire=np.where(greg, T0 + 3_600_000, 0).astype(np.int64),
        greg_duration=np.where(greg, 3_600_000, 0).astype(np.int64),
    )
    dirty = rng.random((S, G)) < 0.2

    jstore = JaxStore(capacity_per_shard=C, g_capacity=G)
    fn = jmesh._get_sync_fn(jstore.mesh, jstore.axis)
    jcfg = jglobal.SyncConfig(*[np.asarray(c) for c in cfg])
    jstate, jg, jpacked = fn(jbuckets.BucketState(np.array(hot), np.array(cold)),
                             to_jax_gcols(gc), jcfg, dirty, T0)

    th, tc, tg = torch.tensor(hot), torch.tensor(cold), to_torch_gcols(gc)
    packed = global_ops.global_sync(th, tc, tg, torch.tensor(cfg.pack()),
                                    torch.tensor(dirty), T0)
    np.testing.assert_array_equal(np.asarray(jpacked), packed.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.hot), th.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.cold), tc.numpy())
    same_gcols(jg, tg)
    applied = (packed.numpy()[0, 0] >> 1) & 1
    assert applied.any() and (applied == 0).any()


def test_set_replica_and_clear_match_jax():
    rng = np.random.default_rng(5)
    G = 32
    gc = random_gcols(rng, G)
    M = 16
    gslots = np.full(M, -1, np.int32)
    gslots[:11] = rng.permutation(G)[:11]
    gslots[11] = G + 3  # out of range: dropped, never wrapped
    status = rng.integers(0, 2, M).astype(np.int32)
    limit, remaining = rng.integers(0, 99, M), rng.integers(0, 99, M)
    reset = T0 + rng.integers(0, 10_000, M)
    jg = jmesh._set_replica_jit(to_jax_gcols(gc), gslots, status, limit, remaining, reset)
    tg = to_torch_gcols(gc)
    global_ops.set_replica(tg, gslots, status, limit, remaining, reset)
    same_gcols(jg, tg)

    idx = np.full(8, G, np.int32)  # pow2 padding with G
    idx[:5] = rng.permutation(G)[:5]
    idx[5] = idx[0]  # a duplicate clear is harmless
    jg = jmesh._clear_jit(jg, idx)
    global_ops.clear_gslots(tg, idx)
    same_gcols(jg, tg)

    with pytest.raises(ValueError, match="more than once"):
        global_ops.set_replica(tg, [1, 1], [0, 0], [1, 1], [1, 1], [1, 1])
    with pytest.raises(ValueError, match="negative"):
        global_ops.clear_gslots(tg, [-1])


# ---------------------------------------------------------------------
# stores side by side
# ---------------------------------------------------------------------
class Pair:
    """A JAX store and a port store driven with the same calls; every
    call's results and the stores' state are compared after it."""

    def __init__(self, capacity, g_capacity):
        self.j = JaxStore(capacity_per_shard=capacity, g_capacity=g_capacity)
        self.t = MeshBucketStore(capacity_per_shard=capacity, g_capacity=g_capacity,
                                 device="cpu")

    def apply(self, reqs, now, **kw):
        a = self.j.apply([JaxRequest(**vars(r)) for r in reqs], now, **kw)
        b = self.t.apply(reqs, now, **kw)
        fa = [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in a]
        fb = [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in b]
        assert fa == fb
        self.check()
        return b

    def sync(self, now):
        a = self.j.sync_globals(now)
        b = self.t.sync_globals(now)
        assert a.did_work == b.did_work
        for name in ("broadcast_cols", "remote_hit_cols"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                for f in vars(x):
                    assert np.array_equal(np.asarray(getattr(x, f)),
                                          np.asarray(getattr(y, f))), (name, f)
        self.check()
        return b

    def replica(self, cols, now):
        self.j.set_replica_batch(JaxGlobalsColumns(**vars(cols)), now)
        self.t.set_replica_batch(cols, now)
        assert self.j.replica_commit_dispatches == self.t.replica_commit_dispatches
        self.check()

    def check(self):
        hot, cold = state_to_numpy(self.t.state)
        np.testing.assert_array_equal(np.asarray(self.j.state.hot), hot)
        np.testing.assert_array_equal(np.asarray(self.j.state.cold), cold)
        same_gcols(self.j.gcols, self.t.gcols)
        jt, tt = self.j.gtable, self.t.gtable
        assert jt._key_to_gslot == tt._key_to_gslot
        for f in ("owner_shard", "owner_slot", "algorithm", "behavior", "limit",
                  "duration", "greg_expire", "greg_duration", "rep_expire"):
            np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f), err_msg=f)
        assert jt.names == tt.names and jt.unique_keys == tt.unique_keys
        np.testing.assert_array_equal(self.j.dirty, self.t.dirty)


def mk(key, hits=1, limit=10, duration=60_000, behavior=GLOBAL,
       algo=Algorithm.TOKEN_BUCKET):
    return RateLimitRequest(name="glob", unique_key=key, hits=hits, limit=limit,
                            duration=duration, algorithm=algo, behavior=behavior)


def owner_and_other(key):
    owner = shard_of_key(f"glob_{key}", S)
    return owner, (owner + 1) % S


def test_non_owner_answers_locally_then_converges():
    st = Pair(64, 32)
    _, other = owner_and_other("k1")
    assert st.apply([mk("k1")], T0, home_shard=other)[0].remaining == 9
    assert st.sync(T0 + 1).broadcast_count == 1
    assert st.apply([mk("k1")], T0 + 2, home_shard=other)[0].remaining == 9
    assert st.apply([mk("k1")], T0 + 3, home_shard=other)[0].remaining == 9
    st.sync(T0 + 4)
    assert st.apply([mk("k1", hits=0)], T0 + 5, home_shard=other)[0].remaining == 7


def test_owner_local_hits_broadcast_without_forwarding():
    st = Pair(64, 32)
    owner, other = owner_and_other("k2")
    assert st.apply([mk("k2", hits=4)], T0, home_shard=owner)[0].remaining == 6
    st.sync(T0 + 1)
    assert st.apply([mk("k2", hits=1)], T0 + 2, home_shard=other)[0].remaining == 6


def test_hot_key_skew_converges_across_shards():
    st = Pair(64, 32)
    owner, _ = owner_and_other("hot")
    limit, total, now = 1000, 1, T0
    st.apply([mk("hot", hits=1, limit=limit)], now, home_shard=owner)
    st.sync(now)
    for _ in range(5):
        now += 10
        for s in range(S):
            if s != owner:
                hits = 7 + (s % 3)
                r = st.apply([mk("hot", hits=hits, limit=limit)], now, home_shard=s)[0]
                assert r.status == Status.UNDER_LIMIT
                total += hits
        now += 10
        st.sync(now)
    r = st.apply([mk("hot", hits=0, limit=limit)], now, home_shard=owner)[0]
    assert r.remaining == limit - total


def test_over_limit_propagates_to_replicas():
    st = Pair(64, 32)
    owner, other = owner_and_other("k3")
    st.apply([mk("k3", hits=10, limit=10)], T0, home_shard=owner)
    st.sync(T0 + 1)
    for i in range(3):
        r = st.apply([mk("k3", hits=1, limit=10)], T0 + 2 + i, home_shard=other)[0]
        assert (r.status, r.remaining) == (Status.UNDER_LIMIT, 0)
    st.sync(T0 + 9)
    r = st.apply([mk("k3", hits=0, limit=10)], T0 + 10, home_shard=owner)[0]
    assert (r.status, r.remaining) == (Status.OVER_LIMIT, 0)
    r = st.apply([mk("k3", hits=1, limit=10)], T0 + 11, home_shard=other)[0]
    assert r.status == Status.OVER_LIMIT


class ClearSpy:
    """Counts the port's clear_gslots calls and records the gslots its
    store's key table evicts, batch by batch."""

    def __init__(self, monkeypatch, store):
        self.calls = 0
        self.evicted = []
        real_clear = global_ops.clear_gslots
        real_assign = store.gtable.lookup_or_assign

        def clear(gcols, idx):
            self.calls += 1
            real_clear(gcols, idx)

        def assign(key, owner):
            g, ev = real_assign(key, owner)
            if ev is not None:
                self.evicted.append(ev)
            return g, ev

        monkeypatch.setattr(global_ops, "clear_gslots", clear)
        monkeypatch.setattr(store.gtable, "lookup_or_assign", assign)

    def take(self):
        out = (self.calls, self.evicted)
        self.calls, self.evicted = 0, []
        return out


def _lane_batches_case(st, spy):
    """One GLOBAL lane a batch: a synced key's gslot is recycled by a
    later key, whose first answer must not see the old replica entry."""
    owner1, _ = owner_and_other("e1")
    st.apply([mk("e1", hits=6, limit=10)], T0, home_shard=owner1)
    st.sync(T0 + 1)
    g_e1 = st.t.gtable.get("glob_e1")
    for k, clears in (("e2", 0), ("e3", 1)):
        st.apply([mk(k)], T0 + 2, home_shard=owner_and_other(k)[1])
        assert spy.take()[0] == clears
    assert st.t.gtable.get("glob_e1") is None and st.t.gtable.get("glob_e3") == g_e1
    r = st.apply([mk("e3", hits=0)], T0 + 3, home_shard=owner_and_other("e3")[1])[0]
    assert r.remaining == 9
    assert spy.take()[0] == 0


def _one_batch_case(st, spy):
    """A table of 8 gslots, full of synced keys with live replica
    entries and pending hits, then one 64-lane dataclass batch of 30 new
    keys with duplicates, owner and non-owner lanes: most lanes evict,
    and gslots recycled early in the batch are evicted again by later
    lanes.  The port clears them with one call after routing, the JAX
    store with one a lane; answers, state, replica columns (ghits
    included) and the key table must agree.  A batch that evicts nothing
    clears nothing."""
    rng = np.random.default_rng(12)
    old = [f"o{k}" for k in range(8)]
    st.apply([mk(k, hits=2, limit=50) for k in old], T0, home_shard=3)
    st.sync(T0 + 1)
    st.apply([mk(k, hits=1, limit=50) for k in old], T0 + 2, home_shard=5)
    assert spy.take() == (0, [])
    keys = [f"n{k}" for k in rng.integers(0, 30, 64)] + old[:2]
    reqs = [mk(k, hits=int(rng.integers(0, 3)), limit=20) for k in keys]
    st.apply(reqs, T0 + 3, home_shard=2)
    calls, evicted = spy.take()
    assert calls == 1 and len(evicted) > 8 and len(set(evicted)) < len(evicted)
    st.sync(T0 + 4)
    st.apply(reqs[-8:], T0 + 5, home_shard=6)
    assert spy.take() == (0, [])


@pytest.mark.parametrize("case", ["lane_batches", "one_batch"])
def test_gslot_eviction_clears_device_rows(monkeypatch, case):
    """Recycled gslots' replica rows are zeroed before the answer kernel
    reads them: the port clears a batch's recycled gslots with one
    clear_gslots call (none for a batch that recycles none), the JAX
    store one a lane, with the same bytes."""
    st = Pair(64, 2 if case == "lane_batches" else 8)
    spy = ClearSpy(monkeypatch, st.t)
    (_lane_batches_case if case == "lane_batches" else _one_batch_case)(st, spy)


def test_sync_fast_path_survives_owner_slot_eviction():
    st = Pair(4, 32)
    owner, _ = owner_and_other("gk")
    st.apply([mk("gk", hits=3, limit=10)], T0, home_shard=owner)
    st.sync(T0)
    filler = [mk(f"fill{i}", limit=100, behavior=0) for i in range(256)
              if shard_of_key(f"glob_fill{i}", S) == owner][:8]
    st.apply(filler, T0 + 1, home_shard=owner)
    assert st.t.tables[owner].get_slot("glob_gk") is None
    st.apply([mk("gk", hits=2, limit=10)], T0 + 2, home_shard=owner)
    res = st.sync(T0 + 2)
    bc = {b.key: b for b in res.broadcasts}
    assert bc["glob_gk"].status.remaining == 8


def test_sync_fast_path_steady_state_skips_verification():
    st = Pair(64, 32)
    owner, _ = owner_and_other("s1")
    st.apply([mk("s1", hits=1, limit=100)], T0, home_shard=owner)
    st.sync(T0)
    gen_before = [t.generation for t in st.t.tables]
    st.apply([mk("s1", hits=1, limit=100)], T0 + 1, home_shard=owner)
    assert [t.generation for t in st.t.tables] == gen_before
    calls = {"n": 0}
    table = st.t.tables[owner]
    orig = table.get_slot

    def counting_get_slot(key):
        calls["n"] += 1
        return orig(key)

    table.get_slot = counting_get_slot
    try:
        st.sync(T0 + 1)
    finally:
        del table.get_slot
    assert calls["n"] == 0
    g = st.t.gtable.get("glob_s1")
    assert table.get_slot("glob_s1") == int(st.t.gtable.owner_slot[g])


def random_requests(rng, n, n_keys):
    reqs = []
    for _ in range(n):
        k = int(rng.integers(0, n_keys))
        beh = int(rng.choice([0, GLOBAL, GLOBAL, GLOBAL | 4, GLOBAL | 8, 4]))
        if rng.random() < 0.05:
            beh |= int(Behavior.NO_BATCHING)
        reqs.append(RateLimitRequest(
            name="rd", unique_key=f"k{k}", hits=int(rng.choice([0, 1, 1, 2, 3])),
            limit=int(rng.choice([5, 12])) if k % 3 else 9,
            duration=86_400_000 if beh & 4 else int(rng.choice([900, 2000])),
            algorithm=k % 2, behavior=beh))
    return reqs


@pytest.mark.parametrize("seed", [0, 1])
def test_randomized_differential(seed):
    """Mixed GLOBAL and plain lanes, duplicates, token and leaky, daily
    Gregorian, rotating home shards, remote owners, expiry at the exact
    ms (steps of 450 ms against 900 ms durations), and gslot eviction
    (12 GLOBAL keys against 10 gslots)."""
    rng = np.random.default_rng(seed)
    st = Pair(8, 10)
    now = T0
    for step in range(10):
        kw = {}
        if step % 4 == 3:
            kw["remote_global"] = True
        elif step % 2:
            kw["home_shard"] = step % S
        st.apply(random_requests(rng, 24, 12), now, **kw)
        if step % 2 == 0:
            st.sync(now)
        now += 450
    res = st.sync(now)
    assert res.remote_hit_cols is not None or res.broadcast_cols is not None


def test_set_replica_batch_with_duplicates_and_evictions():
    st = Pair(16, 4)
    st.apply([mk("own", hits=2)], T0, home_shard=owner_and_other("own")[0])
    keys = ["glob_r0", "glob_r1", "glob_r0", "glob_r2", "glob_r3", "glob_r4", "glob_r1"]
    n = len(keys)
    cols = GlobalsColumns(
        keys=keys, algorithm=np.arange(n, dtype=np.int32) % 2,
        status=np.array([0, 1, 1, 0, 0, 1, 0], np.int32),
        limit=np.full(n, 10, np.int64), remaining=np.arange(n, dtype=np.int64),
        reset_time=T0 + 1000 * np.arange(1, n + 1, dtype=np.int64))
    st.replica(cols, T0)  # 4 gslots: assignments evict, duplicates keep the last lane
    assert st.t.replica_commit_dispatches == 2
    r = st.apply([mk("r4", hits=1)], T0 + 1, home_shard=0)[0]
    assert r.remaining == 5  # answered from the replica entry
    st.sync(T0 + 2)


def test_global_state_carry_over_from_a_jax_store():
    rng = np.random.default_rng(7)
    jstore = JaxStore(capacity_per_shard=8, g_capacity=8)
    now = T0
    for step in range(4):
        reqs = [JaxRequest(**vars(r)) for r in random_requests(rng, 20, 10)]
        jstore.apply(reqs, now, home_shard=step % S)
        if step == 1:
            jstore.sync_globals(now)
        now += 300
    tstore = MeshBucketStore(capacity_per_shard=8, g_capacity=8, device="cpu")
    entries = []
    for t in jstore.tables:
        keys = t.keys()
        slots = np.array([t.get_slot(k) for k in keys], np.int32)
        entries.append((keys, slots, t.get_expire_bulk(slots)))
    tstore.load_state_numpy(np.asarray(jstore.state.hot), np.asarray(jstore.state.cold),
                            entries)
    jt = jstore.gtable
    tstore.load_global_state(
        [np.asarray(c) for c in jstore.gcols],
        dict(key_to_gslot=jt._key_to_gslot, free=jt._free, lru=list(jt._lru),
             columns={f: getattr(jt, f) for f in
                      ("owner_shard", "owner_slot", "algorithm", "behavior", "limit",
                       "duration", "greg_expire", "greg_duration", "rep_expire",
                       "names", "unique_keys")}),
        jstore.dirty)
    st = Pair.__new__(Pair)
    st.j, st.t = jstore, tstore
    st.check()
    st.sync(now)
    for step in range(3):
        st.apply(random_requests(rng, 20, 10), now, home_shard=(step * 3) % S)
        now += 300
    st.sync(now)


def test_measure_sync_cost_and_autotune():
    """tests/test_global.py's twin: measure_sync_cost_s returns the cost
    of one sync kernel and leaves the JAX store's bytes; the
    GlobalManager sizes its window from its in-situ sync timings (<= 10%
    overhead, clamped) once GLOBAL traffic is observed."""
    from gubernator_tpu_torch.service import GlobalManager, ServiceConfig, V1Service
    from gubernator_tpu_torch.types import GetRateLimitsRequest, PeerInfo
    from gubernator_tpu_torch.utils.clock import Clock

    st = Pair(256, 64)
    assert 0 < st.t.measure_sync_cost_s(T0, iters=2) < 60.0
    st.j.measure_sync_cost_s(T0, iters=2)
    st.check()

    store = st.t
    clock = Clock()
    clock.freeze(T0)
    svc = V1Service(ServiceConfig(store=store, clock=clock, advertise_address="127.0.0.1:9991"))
    svc.set_peers([PeerInfo(grpc_address="127.0.0.1:9991", is_owner=True)])
    try:
        mgr = svc.global_mgr
        assert mgr._auto and mgr.sync_wait_s == GlobalManager.SYNC_WAIT_FALLBACK_S
        mgr._interval.stop()  # drive ticks by hand
        svc.get_rate_limits(GetRateLimitsRequest(requests=[mk("tune", hits=1, limit=10)]))
        mgr._tick()
        assert mgr.measured_sync_cost_s is not None
        expected = GlobalManager.window_for_cost(mgr.measured_sync_cost_s)
        assert mgr.sync_wait_s == pytest.approx(expected)
        assert mgr._interval.duration_s == pytest.approx(expected)
        assert mgr._auto
        before = mgr.sync_wait_s
        mgr._observe_sync_cost(10.0)
        assert mgr.sync_wait_s == pytest.approx(before)
        for _ in range(GlobalManager.SYNC_COST_SAMPLES):
            mgr._observe_sync_cost(10.0)
        assert mgr.sync_wait_s == GlobalManager.SYNC_WAIT_MAX_S
    finally:
        svc.close()
