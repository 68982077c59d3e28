"""The port's one-shard ShardStore against the JAX package's ShardStore.

Both stores get the same numpy-seeded batches under a frozen clock:
the columnar path on each of its three wires (the dict wire, narrow
per-lane columns when a batch has more than 256 configs, wide columns
for monthly Gregorian lanes or `force_wire="wide"`), the dataclass
`apply`, the Python slot table (`use_native=False`), the Store SPI, the
persistence plane (load_item, snapshot_items, snapshot_columns and
commit_transfer, a JAX-written snapshot restored through the port's
SnapshotManager), pipelined batches that launch as one group, the
narrow wire's pass-through sentinel, and a V1Service over each store.
The port runs on the CPU (`device="cpu"`, the kernels' plain
versions), the JAX store on its default CPU device.  Everything is
integer, so the tolerance is 0: answers, hot/cold bytes, `algo_mirror`,
the slot tables (keys in order, slots, expiries), Store calls and
items, snapshot lanes must be identical.
"""

import threading
import time

import numpy as np
import pytest

from gubernator_tpu import snapshot as jsnap
from gubernator_tpu import store as jstore_spi
from gubernator_tpu.config import BehaviorConfig
from gubernator_tpu.models.shard import ShardStore as JaxShard
from gubernator_tpu.service import IngressColumns as JaxColumns
from gubernator_tpu.service import ServiceConfig as JaxConfig
from gubernator_tpu.service import V1Service as JaxService
from gubernator_tpu.types import GetRateLimitsRequest as JaxGetRequest
from gubernator_tpu.types import PeerInfo
from gubernator_tpu.types import RateLimitRequest as JaxRequest
from gubernator_tpu.utils import gregorian
from gubernator_tpu.utils.clock import Clock as JaxClock
from gubernator_tpu_torch import native
from gubernator_tpu_torch import snapshot as snap
from gubernator_tpu_torch import store as spi
from gubernator_tpu_torch.models.shard import (
    ColumnsHandle,
    GregResolver,
    ShardStore,
    make_columns,
)
from gubernator_tpu_torch.ops import _kernels, buckets
from gubernator_tpu_torch.service import IngressColumns, ServiceConfig, V1Service
from gubernator_tpu_torch.types import Behavior, GetRateLimitsRequest, RateLimitRequest
from gubernator_tpu_torch.utils.clock import Clock

NOW = 1_573_430_430_000
C = 1024
RESET = int(Behavior.RESET_REMAINING)
FIELDS = ("status", "limit", "remaining", "reset_time")


def same_store(j, t):
    """Hot/cold bytes, algo_mirror and the slot table (keys in order,
    slots, expiries) identical."""
    assert np.asarray(j.state.hot).tobytes() == t.state.hot[0].numpy().tobytes()
    assert np.asarray(j.state.cold).tobytes() == t.state.cold[0].numpy().tobytes()
    assert j.algo_mirror.tobytes() == t.algo_mirror.tobytes()
    keys = t.table.keys()
    assert j.table.keys() == keys
    assert [j.table.get_slot(k) for k in keys] == [t.table.get_slot(k) for k in keys]
    if hasattr(t.table, "get_expire_bulk"):
        every = np.arange(t.capacity, dtype=np.int32)
        assert j.table.get_expire_bulk(every).tobytes() == \
            t.table.get_expire_bulk(every).tobytes()
    else:
        assert j.table.expire_ms.tobytes() == t.table.expire_ms.tobytes()
    assert j.size() == t.size()


def batch(rng, n, n_keys, prefix="k", limit=None, behavior=0):
    ids = rng.integers(0, n_keys, n)  # duplicates on purpose
    keys = [f"s_{prefix}{i}" for i in ids]
    cols = dict(
        algorithm=(ids % 2).astype(np.int32),
        behavior=(np.full(n, behavior, np.int32) if np.isscalar(behavior)
                  else behavior.astype(np.int32)),
        hits=rng.choice([0, 1, 1, 2, 3], n).astype(np.int64),
        limit=np.full(n, 10, np.int64) if limit is None else limit,
        duration=rng.choice([1000, 60_000], n).astype(np.int64),
    )
    return keys, cols


def both(j, t, keys, cols, now, **kw):
    a = j.apply_columns(keys, now_ms=now, **cols, **kw)
    b = t.apply_columns(keys, now_ms=now, **cols, **kw)
    for f in FIELDS:
        assert np.array_equal(np.asarray(a[f]), np.asarray(b[f])), f
    same_store(j, t)
    return b


def _count_kernels(monkeypatch):
    """Count the dispatch wrappers' calls (the plain versions run on the
    CPU, so the kernels' own counts stay 0)."""
    calls = {"dict": 0, "cols": 0}
    for name, key in (("bucket_rounds_dict", "dict"), ("bucket_rounds_cols", "cols")):
        fn = getattr(buckets, name)

        def wrapped(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(buckets, name, wrapped)
    return calls


# ---------------------------------------------------------------------
# the columnar path, each wire
# ---------------------------------------------------------------------
def test_dict_wire_narrow(monkeypatch):
    calls = _count_kernels(monkeypatch)
    rng = np.random.default_rng(1)
    j, t = JaxShard(capacity=C), ShardStore(capacity=C, device="cpu")
    now = NOW
    both(j, t, *batch(rng, 600, 400), now)
    now += 1500
    keys, cols = batch(rng, 500, 200)
    cols["behavior"] = np.where(rng.random(500) < 0.2, RESET, 0).astype(np.int32)
    both(j, t, keys, cols, now)  # non-uniform groups: rounds 1+
    now += 61_000  # the short buckets expire: recreated in place
    both(j, t, *batch(rng, 700, 2000, prefix="e"), now)  # past capacity: LRU eviction
    assert calls == {"dict": 3, "cols": 0}


def test_monthly_gregorian_batch_is_wide():
    rng = np.random.default_rng(2)
    j, t = JaxShard(capacity=C), ShardStore(capacity=C, device="cpu")
    now = 1_701_388_800_000  # a whole month to the reset
    ge, gd = GregResolver(now).resolve(gregorian.GREGORIAN_MONTHS)
    for i in range(2):
        keys, cols = batch(rng, 300, 200, prefix="g", behavior=4)
        cols["duration"] = np.full(300, gregorian.GREGORIAN_MONTHS, np.int64)
        both(j, t, keys, cols, now + i, greg_expire=np.full(300, ge, np.int64),
             greg_duration=np.full(300, gd, np.int64))
    # a narrow batch on the same keys passes the far-future expiry through
    both(j, t, *batch(rng, 300, 200, prefix="g"), now + 2)


def test_more_than_256_configs_take_narrow_columns(monkeypatch):
    calls = _count_kernels(monkeypatch)
    rng = np.random.default_rng(3)
    j, t = JaxShard(capacity=C), ShardStore(capacity=C, device="cpu")
    for i in range(2):
        keys, cols = batch(rng, 600, 300, limit=rng.integers(1, 400, 600).astype(np.int64))
        both(j, t, keys, cols, NOW + i * 700)
    assert calls == {"dict": 0, "cols": 2}


def test_force_wire_wide(monkeypatch):
    calls = _count_kernels(monkeypatch)
    rng = np.random.default_rng(4)
    j, t = JaxShard(capacity=C), ShardStore(capacity=C, device="cpu")
    both(j, t, *batch(rng, 400, 300), NOW)
    keys, cols = batch(rng, 400, 300)
    cols["behavior"] = np.where(rng.random(400) < 0.2, RESET, 0).astype(np.int32)
    both(j, t, keys, cols, NOW + 10, force_wire="wide")
    assert calls == {"dict": 1, "cols": 1}


@pytest.mark.parametrize("packed", [False, True], ids=["key_list", "packed_keys"])
def test_passthrough_sentinel_survives_a_later_eviction(packed):
    """A far-future expiry passed through unchanged by a narrow batch
    (the -2 sentinel) while a later batch, planned before the first
    commits, evicts the slot: the reset comes from the plan-time
    snapshot.  The port's store also takes the keys packed (the JAX
    store reads a sentinel lane's key from a list)."""
    now = 1_701_388_800_000
    ge, gd = GregResolver(now).resolve(gregorian.GREGORIAN_MONTHS)
    cap = 8
    j, t = JaxShard(capacity=cap), ShardStore(capacity=cap, device="cpu")
    keys = [f"s_far{i}" for i in range(cap)]
    one = np.ones(cap)
    both(j, t, keys, dict(algorithm=np.zeros(cap, np.int32),
                          behavior=np.full(cap, 4, np.int32), hits=one,
                          limit=np.full(cap, 100, np.int64),
                          duration=np.full(cap, gregorian.GREGORIAN_MONTHS, np.int64)),
         now, greg_expire=np.full(cap, ge, np.int64), greg_duration=np.full(cap, gd, np.int64))
    # narrow, same config: the stored month-away expiry is passed through
    narrow = dict(algorithm=np.zeros(cap, np.int32), behavior=np.zeros(cap, np.int32),
                  hits=one, limit=np.full(cap, 100, np.int64),
                  duration=np.full(cap, gregorian.GREGORIAN_MONTHS, np.int64))
    evict = dict(algorithm=np.zeros(cap, np.int32), behavior=np.zeros(cap, np.int32),
                 hits=one, limit=np.full(cap, 5, np.int64),
                 duration=np.full(cap, 60_000, np.int64))
    out = []
    for s in (j, t):
        k = native.PackedKeys(*native.pack_keys(keys)) if packed and s is t else keys
        h1 = s.apply_columns_async(k, now_ms=now + 1, **narrow)
        h2 = s.apply_columns_async([f"s_new{i}" for i in range(cap)], now_ms=now + 2, **evict)
        out.append((h1.result(), h2.result()))
    for a, b in zip(*out):
        for f in FIELDS:
            assert np.array_equal(np.asarray(a[f]), np.asarray(b[f])), f
    assert (out[1][0]["reset_time"] == ge).all()
    same_store(j, t)


def _reserve_ticket(store, keys, cols, now):
    """Plan one batch and take its launch turn without launching it, so
    that later submissions queue at the launch gate."""
    c = make_columns(cols["algorithm"], cols["behavior"], cols["hits"],
                     cols["limit"], cols["duration"], len(keys))
    with store._plan_lock:
        prep = store._prepare_columns(keys, c, now)
        h = ColumnsHandle(store, prep.commit, c.limit)
        h.ticket = store._next_ticket
        store._next_ticket += 1
        store._inflight.append(h)
    return h, prep


def test_async_batches_launch_as_one_group():
    """Four batches submitted before the first result: the later three
    wait at the launch gate and launch with the first as one group of
    four K1 launches, which the JAX store's fused program matches."""
    rng = np.random.default_rng(9)
    batches = [batch(rng, 200, 150) for _ in range(4)]  # one padded shape
    j = JaxShard(capacity=C)
    store = ShardStore(capacity=C, device="cpu")
    h0, prep0 = _reserve_ticket(store, *batches[0], NOW)
    handles = [None] * 3

    def submit(i):
        k, c = batches[i + 1]
        handles[i] = store.apply_columns_async(k, now_ms=NOW + i + 1, **c)

    threads = []
    for i in range(3):  # one at a time, so the tickets follow the batches
        th = threading.Thread(target=submit, args=(i,))
        th.start()
        threads.append(th)
        deadline = time.monotonic() + 10
        while len(store._launch_gate) < i + 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(store._launch_gate) == i + 1
    store._launch_in_order(h0, store._stage_columns(prep0))
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    assert store.device_dispatches == 1  # one group of four
    jh = [j.apply_columns_async(k, now_ms=NOW + i, **c) for i, (k, c) in enumerate(batches)]
    for a, b in zip(jh, [h0] + handles):
        ra, rb = a.result(), b.result()
        for f in FIELDS:
            assert np.array_equal(np.asarray(ra[f]), np.asarray(rb[f])), f
    same_store(j, store)


def test_concurrent_dispatchers_match_a_ticket_order_replay():
    """Four dispatcher threads, two batches in flight each, with a short
    switch interval: every answer and the final state equal a JAX
    ShardStore fed the same batches in ticket order."""
    import sys

    rng = np.random.default_rng(15)
    batches = [batch(rng, 256, 300) for _ in range(16)]
    t = ShardStore(capacity=C, device="cpu")
    got, errors = {}, []
    lock = threading.Lock()

    def worker(w):
        try:
            pending = []
            for i in range(w, len(batches), 4):
                k, c = batches[i]
                pending.append((i, t.apply_columns_async(k, now_ms=NOW + i, **c)))
                if len(pending) == 2:
                    i0, h = pending.pop(0)
                    with lock:
                        got[h.ticket] = (i0, h.result())
            for i0, h in pending:
                with lock:
                    got[h.ticket] = (i0, h.result())
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors and sorted(got) == list(range(len(batches)))
    j = JaxShard(capacity=C)
    for ticket in sorted(got):
        i, r = got[ticket]
        k, c = batches[i]
        want = j.apply_columns(k, now_ms=NOW + i, **c)
        for f in FIELDS:
            assert np.array_equal(np.asarray(want[f]), r[f]), (ticket, f)
    same_store(j, t)


def test_fused_form_matches_solo_launches():
    """apply_rounds_packed_fused (K launches into [K, 4, P]) against the
    JAX fused program on the same wires."""
    from gubernator_tpu.ops import buckets as jb

    from chip_smoke import random_state

    rng = np.random.default_rng(12)
    hot, cold = (a[0] for a in random_state(rng, C, False, shards=1))
    wires, nrs = [], []
    for i in range(3):
        slot = rng.permutation(C)[:256].astype(np.int32)
        wr = np.ones(256, bool)
        cfg = rng.integers(0, 4, 256)
        table = [np.array(c + [0] * 252, np.int64) for c in (
            [0, 1, 0, 1], [0, 0, RESET, 0], [1, 2, 1, 0], [10, 5, 7, 3],
            [1000, 60_000, 1000, 60_000], [0] * 4, [0] * 4)]
        wires.append(buckets.pack_dict_wire(slot[None], rng.random((1, 256)) < 0.7, wr[None],
                                            cfg[None], np.zeros((1, 256)),
                                            np.zeros((1, 256)), table)[0])
        nrs.append(1)
    import torch

    st = buckets.BucketState(torch.tensor(hot[None]), torch.tensor(cold[None]))
    got = buckets.apply_rounds_packed_fused(st, wires, nrs, [NOW + i for i in range(3)])
    jst, want = jb.fused_packed_jit(3, False, donate_wires=False)(
        jb.BucketState(hot=hot, cold=cold), *wires, np.array(nrs, np.int32),
        np.array([NOW + i for i in range(3)], np.int64))
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert st.hot.numpy().tobytes() == np.asarray(jst.hot).tobytes()
    assert st.cold.numpy().tobytes() == np.asarray(jst.cold).tobytes()


# ---------------------------------------------------------------------
# the dataclass path and the Python slot table
# ---------------------------------------------------------------------
def _jreq(r):
    return JaxRequest(**vars(r))


def _fields(resps):
    return [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in resps]


def _traffic(rng, n, n_keys, prefix="p"):
    ids = rng.integers(0, n_keys, n)
    return [RateLimitRequest(
        name="shard", unique_key=f"{prefix}{i}", hits=int(rng.choice([0, 1, 1, 2, 5])),
        limit=int(rng.choice([5, 10, 50])), duration=int(rng.choice([1000, 60_000])),
        algorithm=int(i % 2), behavior=RESET if rng.random() < 0.05 else 0) for i in ids]


def _both_apply(j, t, reqs, now):
    a = j.apply([_jreq(r) for r in reqs], now)
    b = t.apply(reqs, now)
    assert _fields(a) == _fields(b)
    same_store(j, t)
    return b


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python_table"])
def test_dataclass_apply(use_native):
    rng = np.random.default_rng(5)
    j = JaxShard(capacity=128, use_native=use_native)
    t = ShardStore(capacity=128, device="cpu", use_native=use_native)
    assert t.supports_columns == use_native
    now = NOW
    for step in range(4):
        reqs = _traffic(rng, 150, 220)  # duplicates, RESET, eviction past 128
        if step == 2:  # an invalid Gregorian duration is its lane's error
            reqs[3].behavior = int(Behavior.DURATION_IS_GREGORIAN)
            reqs[3].duration = 99
        _both_apply(j, t, reqs, now)
        now += 700
    if not use_native:
        with pytest.raises(RuntimeError, match="native host runtime"):
            t.apply_columns(["a"], [0], [0], [1], [5], [1000], NOW)


# ---------------------------------------------------------------------
# the Store SPI and the persistence plane
# ---------------------------------------------------------------------
def _item(it):
    v = it.value
    return (int(it.algorithm), it.key, int(it.expire_at), type(v).__name__,
            tuple(float(x) if isinstance(x, float) else int(x) for x in vars(v).values()))


def _items(store):
    return {k: _item(it) for k, it in store.cache_items.items()}


def test_store_spi_call_sequences():
    """Preloaded items of either algorithm, algorithm switches,
    RESET_REMAINING, duplicate keys and a full table: every response,
    state byte, Store call and stored item equal, call for call."""
    rng = np.random.default_rng(21)
    js, ts = jstore_spi.MockStore(), spi.MockStore()
    j = JaxShard(capacity=32, store=js)
    t = ShardStore(capacity=32, device="cpu", store=ts)
    assert not t.supports_columns
    for i in range(0, 200, 3):
        algo, rem = int(i % 2 if i % 7 else 1 - i % 2), int(rng.integers(0, 10))
        exp = NOW + int(rng.integers(-50, 5000))
        for mod, st in ((jstore_spi, js), (spi, ts)):
            value = (mod.TokenBucketItem(limit=10, duration=1000, created_at=NOW - 100,
                                         remaining=rem) if algo == 0 else
                     mod.LeakyBucketItem(limit=10, duration=1000, updated_at=NOW - 100,
                                         remaining=float(rem)))
            st.cache_items[f"shard_p{i}"] = mod.CacheItem(algorithm=algo, key=f"shard_p{i}",
                                                          value=value, expire_at=exp)
    now = NOW
    for _ in range(5):
        reqs = _traffic(rng, 90, 200)
        for r in reqs:
            if rng.random() < 0.1:
                r.algorithm = 1 - r.algorithm
        _both_apply(j, t, reqs, now)
        assert js.called == ts.called
        assert _items(js) == _items(ts)
        now += 400
    assert ts.called["Remove()"] > 0 and ts.called["Get()"] > 0


def test_load_item_snapshot_items_and_transfer_round_trip():
    rng = np.random.default_rng(8)
    j, t = JaxShard(capacity=256), ShardStore(capacity=256, device="cpu")
    _both_apply(j, t, _traffic(rng, 200, 150), NOW)
    for i in range(6):  # Loader.Load items, either algorithm
        for s, mod in ((j, jstore_spi), (t, spi)):
            value = (mod.TokenBucketItem(limit=7, duration=60_000, created_at=NOW,
                                         remaining=3 + i) if i % 2 == 0 else
                     mod.LeakyBucketItem(limit=7, duration=60_000, updated_at=NOW,
                                         remaining=2.5))
            s.load_item(mod.CacheItem(algorithm=i % 2, key=f"shard_l{i}", value=value,
                                      expire_at=NOW + 30_000))
    same_store(j, t)
    assert [_item(x) for x in j.snapshot_items()] == [_item(x) for x in t.snapshot_items()]
    later = NOW + 1500  # the 1-second buckets have expired
    jc, tc = j.snapshot_columns(later), t.snapshot_columns(later)
    assert jc.keys == tc.keys and 0 < len(tc) < t.size()
    for f in ("algorithm", "status", "limit", "remaining", "duration", "stamp", "expire_at"):
        assert np.asarray(getattr(jc, f)).tobytes() == getattr(tc, f).tobytes(), f
    dj, dt = JaxShard(capacity=256), ShardStore(capacity=256, device="cpu")
    _both_apply(dj, dt, _traffic(rng, 100, 150), later)  # live rows to merge into
    assert dj.commit_transfer(jc, later) == dt.commit_transfer(tc, later) == len(tc)
    same_store(dj, dt)
    _both_apply(dj, dt, _traffic(rng, 150, 150), later + 1)


def test_jax_snapshot_restores_through_the_port_snapshot_manager(tmp_path):
    rng = np.random.default_rng(10)
    j = JaxShard(capacity=256)
    for i in range(3):
        keys, cols = batch(rng, 300, 200)
        j.apply_columns(keys, now_ms=NOW + i, **cols)
    path = str(tmp_path / "shard.snap")
    jsnap.write_snapshot(path, j.snapshot_columns(NOW + 5), NOW + 5)

    class Host:  # the service fields SnapshotManager reads
        def __init__(self, store):
            self.store = store
            clock = Clock()
            clock.freeze(NOW + 10)
            self.clock = clock

    t = ShardStore(capacity=256, device="cpu")
    mgr = snap.SnapshotManager(Host(t), path=path, interval_s=0)
    mgr.restore()
    dj = JaxShard(capacity=256)
    dj.commit_transfer(jsnap.read_snapshot(path)[0], NOW + 10)
    same_store(dj, t)
    assert t.size() > 100
    both(dj, t, *batch(rng, 300, 200), NOW + 20)


def test_load_state_numpy_carries_a_jax_shard_store_over():
    rng = np.random.default_rng(13)
    j = JaxShard(capacity=C)
    for i in range(2):
        keys, cols = batch(rng, 400, 300)
        j.apply_columns(keys, now_ms=NOW + i, **cols)
    keys = j.table.keys()
    slots = np.array([j.table.get_slot(k) for k in keys], np.int32)
    t = ShardStore(capacity=C, device="cpu")
    t.load_state_numpy(np.asarray(j.state.hot), np.asarray(j.state.cold),
                       (keys, slots, j.table.get_expire_bulk(slots)), j.algo_mirror)
    assert t.size() == j.size()
    assert t.algo_mirror.tobytes() == j.algo_mirror.tobytes()
    for i in range(2):
        keys, cols = batch(rng, 400, 300)
        a = j.apply_columns(keys, now_ms=NOW + 5000 + i, **cols)
        b = t.apply_columns(keys, now_ms=NOW + 5000 + i, **cols)
        for f in FIELDS:
            assert np.array_equal(np.asarray(a[f]), b[f]), f
    assert np.asarray(j.state.hot).tobytes() == t.state.hot[0].numpy().tobytes()


# ---------------------------------------------------------------------
# a V1Service over each store
# ---------------------------------------------------------------------
def test_service_over_a_shard_store():
    jclock, tclock = JaxClock(), Clock()
    jclock.freeze(NOW)
    tclock.freeze(NOW)
    jsvc = JaxService(JaxConfig(store=JaxShard(capacity=512), clock=jclock,
                                behaviors=BehaviorConfig(global_sync_wait_s=3600.0),
                                advertise_address="127.0.0.1:9999"))
    jsvc.set_peers([PeerInfo(grpc_address="127.0.0.1:9999", is_owner=True)])
    # The port's service at the default (auto-sized) sync window: with
    # no GLOBAL sync in the store it runs no GlobalManager at all.
    tsvc = V1Service(ServiceConfig(store=ShardStore(capacity=512, device="cpu"),
                                   clock=tclock))
    try:
        rng = np.random.default_rng(14)
        for step in range(4):
            reqs = _traffic(rng, 40, 30, prefix="v")
            reqs[0].unique_key = ""  # validation error
            for r in reqs[5:12]:  # GLOBAL lanes: a one-shard store answers them locally
                r.behavior |= int(Behavior.GLOBAL)
            if step == 1:
                reqs[1].behavior = int(Behavior.DURATION_IS_GREGORIAN)
                reqs[1].duration = gregorian.GREGORIAN_DAYS
            a = jsvc.get_rate_limits(JaxGetRequest(requests=[_jreq(r) for r in reqs]))
            b = tsvc.get_rate_limits(GetRateLimitsRequest(requests=reqs))
            assert _fields(a.responses) == _fields(b.responses)
            n = 8
            names = ["svc"] * n
            # Four batched lanes: the JAX service dispatches as many at
            # once (its express bypass), more only after its batching
            # window, behind the GLOBAL lanes' dataclass call; the port
            # has no window and launches them before that call.
            beh = rng.permutation([0, 0, 0, 0, int(Behavior.NO_BATCHING),
                                   int(Behavior.NO_BATCHING), int(Behavior.GLOBAL),
                                   int(Behavior.GLOBAL)])
            uks = [f"c{i}" for i in rng.integers(0, 6, n)]
            cols = dict(algorithm=rng.integers(0, 2, n).astype(np.int32),
                        behavior=beh.astype(np.int32),
                        hits=np.ones(n, np.int64), limit=np.full(n, 5, np.int64),
                        duration=np.full(n, 10_000, np.int64))
            a = jsvc.get_rate_limits_columns(JaxColumns(names=names, unique_keys=uks, **cols))
            b = tsvc.get_rate_limits_columns(IngressColumns(names=names, unique_keys=uks,
                                                            **cols))
            assert _fields([a.response_at(i) for i in range(n)]) == \
                _fields([b.response_at(i) for i in range(n)])
            jclock.advance(300)
            tclock.advance(300)
        same_store(jsvc.store, tsvc.store)
        # Neither store has a GLOBAL sync: the JAX service's sync pass
        # fails on it, the port's service has no pass to run.
        with pytest.raises(AttributeError, match="sync_globals"):
            jsvc.global_mgr.run_once()
        assert tsvc.global_mgr is None
    finally:
        jsvc.close()
        tsvc.close()


def test_store_without_device_raises_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardStore(capacity=8)


def test_kernel_counts_stay_zero_on_the_cpu():
    """On the CPU the store's wrappers take the plain versions: no
    kernel is launched."""
    before = dict(_kernels.LAUNCHES)
    rng = np.random.default_rng(3)
    t = ShardStore(capacity=64, device="cpu")
    keys, cols = batch(rng, 50, 40)
    t.apply_columns(keys, now_ms=NOW, **cols)
    assert dict(_kernels.LAUNCHES) == before
