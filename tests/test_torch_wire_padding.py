"""The padded lane count of a batch's shard rows, and the store
pipeline's count of what each batch ships.

`pad_size` keeps the JAX package's shapes (64, 256, 1,024 lanes) for
rows of up to 1,024 lanes and pads longer rows to the next multiple of
256 lanes, where the JAX package doubles.  At such a P (1,280 lanes a
shard) the port still answers as the JAX store does, on the mesh's dict
wire (narrow and forced wide), on a GLOBAL dataclass batch and on the
one-shard store, and same-P batches still launch as one group.  The
counts (`wire.*` of `take_pipeline_stats`) are exact: live lanes, lane
slots, the wire's bytes, and a fused group's readback once.
"""

import threading
import time

import numpy as np
import pytest

from gubernator_tpu.models.shard import ShardStore as JaxShard
from gubernator_tpu.parallel.mesh import MeshBucketStore as JaxStore
from gubernator_tpu.types import RateLimitRequest as JaxRequest
from gubernator_tpu_torch.models.shard import (
    ColumnsHandle,
    ShardStore,
    make_columns,
    pad_size,
)
from gubernator_tpu_torch.ops import buckets
from gubernator_tpu_torch.ops.buckets import state_to_numpy
from gubernator_tpu_torch.parallel.mesh import MeshBucketStore, shard_of_key
from gubernator_tpu_torch.types import Behavior, RateLimitRequest

NOW = 1_573_430_430_000
S = 8
C = 1024  # slots per shard
FIELDS = ("status", "limit", "remaining", "reset_time")
WIRE = ("wire.lanes", "wire.slots", "wire.up_bytes", "wire.down_bytes")
TABLE = buckets.DICT_WIRE_TABLE_WORDS


# ---------------------------------------------------------------------
# pad_size
# ---------------------------------------------------------------------
@pytest.mark.parametrize("n,want", [(0, 64), (1, 64), (64, 64), (65, 256), (256, 256),
                                    (257, 1024), (1_024, 1_024)])
def test_pad_size_keeps_the_small_shapes(n, want):
    assert pad_size(n) == want


@pytest.mark.parametrize("n,want", [(1_025, 1_280), (1_280, 1_280), (1_281, 1_536),
                                    (3_030, 3_072), (4_520, 4_608), (35_316, 35_328),
                                    ((1 << 20) + 1, (1 << 20) + 256)])
def test_pad_size_steps_by_256_lanes_above_1024(n, want):
    assert pad_size(n) == want


def test_pad_size_covers_n_and_is_monotone():
    pads = [pad_size(n) for n in range(70_000)]
    assert all(p >= n for n, p in enumerate(pads))
    assert all(a <= b for a, b in zip(pads, pads[1:]))
    assert all(p - n < 256 for n, p in enumerate(pads) if n > 1_024)


# ---------------------------------------------------------------------
# the mesh store at P = 1,280
# ---------------------------------------------------------------------
def keys_by_shard(prefix, per_shard):
    """`per_shard` hash keys of each of the S shards."""
    pool = [[] for _ in range(S)]
    i = 0
    while min(len(p) for p in pool) < per_shard:
        k = f"m_{prefix}{i}"
        s = shard_of_key(k, S)
        if len(pool[s]) < per_shard:
            pool[s].append(k)
        i += 1
    return pool


def sharded_batch(rng, counts, prefix="k", keys_per_shard=400, limit=None):
    """Lanes of shard s: counts[s] draws (with duplicates) from its own
    keys, shuffled, so the largest shard row holds max(counts) lanes."""
    pool = keys_by_shard(prefix, keys_per_shard)
    keys = [pool[s][i] for s, n in enumerate(counts)
            for i in rng.integers(0, keys_per_shard, n)]
    keys = [keys[i] for i in rng.permutation(len(keys))]
    n = len(keys)
    cols = dict(
        algorithm=rng.integers(0, 2, n).astype(np.int32),
        behavior=np.zeros(n, np.int32),
        hits=rng.choice([0, 1, 1, 2, 3], n).astype(np.int64),
        limit=np.full(n, 10, np.int64) if limit is None else limit,
        duration=rng.choice([1_000, 60_000], n).astype(np.int64),
    )
    return keys, cols


def counts(rng, top):
    """Lanes of each shard: one shard holds `top`, the others fewer."""
    c = rng.integers(top - 150, top, S)
    c[rng.integers(0, S)] = top
    return c


def both(jstore, tstore, keys, cols, now, **kw):
    a = jstore.apply_columns(keys, now_ms=now, **cols, **kw)
    b = tstore.apply_columns(keys, now_ms=now, **cols, **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(a[f]), np.asarray(b[f]), err_msg=f)
    return b


def same_state(jstore, tstore):
    hot, cold = state_to_numpy(tstore.state)
    np.testing.assert_array_equal(np.asarray(jstore.state.hot), hot)
    np.testing.assert_array_equal(np.asarray(jstore.state.cold), cold)


def wire(store):
    stats, _, _ = store.take_pipeline_stats()
    return {k: stats[k] for k in WIRE if k in stats}


def test_mesh_dict_wire_at_a_non_power_of_two_pad():
    """Largest shard rows of 1,100 to 1,300 lanes pad to 1,280 or 1,536
    lanes (the JAX store pads to 2,048): the narrow dict wire, then the
    forced wide per-lane columns, answer and leave the state as the JAX
    store does."""
    rng = np.random.default_rng(21)
    jstore = JaxStore(capacity_per_shard=C)
    tstore = MeshBucketStore(capacity_per_shard=C, device="cpu")
    now = NOW
    for top, kw in ((1_150, {}), (1_290, {}), (1_200, {"force_wire": "wide"})):
        tstore.take_pipeline_stats()
        both(jstore, tstore, *sharded_batch(rng, counts(rng, top)), now, **kw)
        P = wire(tstore)["wire.slots"][1] // S
        assert P == pad_size(top) and P % 256 == 0 and P & (P - 1)
        assert P < 2_048
        now += 1_500
    assert tstore.size() == jstore.size()
    same_state(jstore, tstore)


def test_global_batch_at_a_non_power_of_two_pad():
    """A GLOBAL dataclass batch (K3) whose home shard row holds 1,200
    GLOBAL lanes plus its own plain lanes: P = 1,280, answers, state,
    replica columns and the sync as the JAX store's."""
    rng = np.random.default_rng(22)
    jstore = JaxStore(capacity_per_shard=C, g_capacity=512)
    tstore = MeshBucketStore(capacity_per_shard=C, g_capacity=512, device="cpu")
    pads = []
    plan = tstore._plan_answer

    def spy(*a, **kw):
        prep = plan(*a, **kw)
        pads.append(prep.lanes.shape[2])
        return prep

    tstore._plan_answer = spy
    glob, plain = int(Behavior.GLOBAL), 0
    now = NOW
    for step in range(2):
        reqs = [RateLimitRequest(
            name="g", unique_key=f"k{int(k)}", hits=int(rng.choice([0, 1, 2])), limit=12,
            duration=60_000, algorithm=int(k) % 2, behavior=glob if i < 1_200 else plain)
            for i, k in enumerate(rng.integers(0, 300, 1_600))]
        a = jstore.apply([JaxRequest(**vars(r)) for r in reqs], now, home_shard=0)
        b = tstore.apply(reqs, now, home_shard=0)
        assert ([(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in a]
                == [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in b])
        same_state(jstore, tstore)
        ja, ta = jstore.sync_globals(now), tstore.sync_globals(now)
        assert ja.did_work == ta.did_work
        x, y = ja.broadcast_cols, ta.broadcast_cols
        assert (x is None) == (y is None)
        if x is not None:
            for f in vars(x):
                assert np.array_equal(np.asarray(getattr(x, f)), np.asarray(getattr(y, f))), f
        now += 700
    assert pads and all(p == 1_280 for p in pads), pads
    for a, b in zip(jstore.gcols, tstore.gcols):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_shard_store_batch_of_1100_lanes():
    """The one-shard store pads a batch of 1,100 lanes to 1,280 (the JAX
    store to 2,048): answers, rows, mirror and slot table as the JAX
    store's."""
    rng = np.random.default_rng(23)
    j, t = JaxShard(capacity=C), ShardStore(capacity=C, device="cpu")
    now = NOW
    for n in (1_100, 1_100):
        ids = rng.integers(0, 700, n)
        keys = [f"s_k{i}" for i in ids]
        cols = dict(algorithm=(ids % 2).astype(np.int32), behavior=np.zeros(n, np.int32),
                    hits=rng.choice([0, 1, 1, 2, 3], n).astype(np.int64),
                    limit=np.full(n, 10, np.int64),
                    duration=rng.choice([1_000, 60_000], n).astype(np.int64))
        t.take_pipeline_stats()
        both(j, t, keys, cols, now)
        assert wire(t)["wire.slots"] == (1, 1_280, 1_280)
        now += 1_500
    assert np.asarray(j.state.hot).tobytes() == t.state.hot[0].numpy().tobytes()
    assert np.asarray(j.state.cold).tobytes() == t.state.cold[0].numpy().tobytes()
    assert j.algo_mirror.tobytes() == t.algo_mirror.tobytes()
    assert j.table.keys() == t.table.keys()


# ---------------------------------------------------------------------
# launch groups and the counts
# ---------------------------------------------------------------------
def _reserve_ticket(store, keys, cols, now):
    """Plan one batch and take its launch turn without launching it,
    so that later submissions queue at the launch gate."""
    c = make_columns(cols["algorithm"], cols["behavior"], cols["hits"],
                     cols["limit"], cols["duration"], len(keys))
    with store._plan_lock:
        prep = store._prepare_columns(keys, c, now)
        h = ColumnsHandle(store, prep.commit, c.limit)
        h.ticket = store._next_ticket
        store._next_ticket += 1
        store._inflight.append(h)
    return h, prep


def test_backlogged_batches_above_1024_a_shard_launch_fused():
    """Four batches whose largest shard rows hold 1,100 to 1,280 lanes
    share P = 1,280 and launch as one group, as at P = 64; the group's
    answers and state are a serial store's and the JAX store's, and its
    one readback counts once, with the four batches' bytes."""
    rng = np.random.default_rng(24)
    batches = [sharded_batch(rng, counts(rng, top)) for top in (1_280, 1_100, 1_250, 1_190)]
    serial = MeshBucketStore(capacity_per_shard=C, device="cpu")
    jstore = JaxStore(capacity_per_shard=C)
    want = [both(jstore, serial, k, c, NOW + i) for i, (k, c) in enumerate(batches)]

    store = MeshBucketStore(capacity_per_shard=C, device="cpu")
    h0, prep0 = _reserve_ticket(store, *batches[0], NOW)
    assert prep0.padded == 1_280
    handles = [None] * 3

    def submit(i):
        k, c = batches[i + 1]
        handles[i] = store.apply_columns_async(k, now_ms=NOW + i + 1, **c)

    threads = []
    for i in range(3):  # one at a time, so the tickets follow the batches
        t = threading.Thread(target=submit, args=(i,))
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 30
        while len(store._launch_gate) < i + 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(store._launch_gate) == i + 1
    store.take_pipeline_stats()
    store._launch_in_order(h0, store._stage_columns(prep0))
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert store.device_dispatches == 1  # all four batches in one group
    for h, w in zip([h0] + handles, want):
        got = h.result()
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], w[f])
    np.testing.assert_array_equal(store.state.hot.numpy(), serial.state.hot.numpy())
    np.testing.assert_array_equal(store.state.cold.numpy(), serial.state.cold.numpy())
    same_state(jstore, store)
    # The stacked narrow result i32[4, S, 4, P], read back once.
    assert wire(store)["wire.down_bytes"] == (1, 4 * S * 4 * 1_280 * 4, 4 * S * 4 * 1_280 * 4)


@pytest.mark.parametrize("top,force_wire,P", [
    (700, None, 1_024), (1_024, None, 1_024), (1_100, None, 1_280), (1_100, "wide", 1_280),
])
def test_wire_counts_are_exact_for_a_known_batch(top, force_wire, P):
    """One batch: live lanes, S x P lane slots, the wire's bytes up (the
    dict wire i32[S, 3P + 3,072]; per-lane columns i32[S, 6, P] and
    i64[S, 5, P] when forced wide) and the result's down (i32 or i64
    [S, 4, P]).  Rows of up to 1,024 lanes keep P = 1,024."""
    rng = np.random.default_rng(25)
    store = MeshBucketStore(capacity_per_shard=C, device="cpu")
    keys, cols = sharded_batch(rng, counts(rng, top))
    store.take_pipeline_stats()
    store.apply_columns(keys, now_ms=NOW, force_wire=force_wire, **cols)
    n = len(keys)
    if force_wire is None:
        up, down = S * (3 * P + TABLE) * 4, S * 4 * P * 4
    else:
        up, down = S * 6 * P * 4 + S * 5 * P * 8, S * 4 * P * 8
    assert wire(store) == {"wire.lanes": (1, n, n), "wire.slots": (1, S * P, S * P),
                           "wire.up_bytes": (1, up, up), "wire.down_bytes": (1, down, down)}


def test_one_shard_wire_counts_and_the_express_slot():
    """The one-shard store counts its dict wire i32[1, 3P + 3,072] and
    result i32[1, 4, P]; a batch the express slot answers on the host
    launches nothing and ships nothing."""
    store = ShardStore(capacity=C, device="cpu")
    store.take_pipeline_stats()
    n = 300
    store.apply_columns([f"o{i}" for i in range(n)], np.zeros(n, np.int32),
                        np.zeros(n, np.int32), np.ones(n, np.int64), np.full(n, 5, np.int64),
                        np.full(n, 1_000, np.int64), NOW)
    up, down = (3 * 1_024 + TABLE) * 4, 4 * 1_024 * 4
    assert wire(store) == {"wire.lanes": (1, n, n), "wire.slots": (1, 1_024, 1_024),
                           "wire.up_bytes": (1, up, up), "wire.down_bytes": (1, down, down)}
    store.scalar_fast_path = True
    store.apply_columns(["o1"], np.zeros(1, np.int32), np.zeros(1, np.int32),
                        np.ones(1, np.int64), np.full(1, 5, np.int64),
                        np.full(1, 1_000, np.int64), NOW + 1)
    assert store.scalar_applies == 1
    assert wire(store) == {}
