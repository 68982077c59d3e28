"""The port's MeshBucketStore against the JAX MeshBucketStore.

Both stores get the same seeded batches under a frozen clock through
`apply_columns`; every batch's answers and the final state tensors must
be identical (tolerance 0: all integer).  The port runs on the CPU
(`device="cpu"`), where its wrappers take the plain versions of the
kernels; the JAX store runs on the 8-device virtual CPU mesh of
tests/conftest.py, so both have S = 8 shards.
"""

import threading
import time

import numpy as np
import pytest

from gubernator_tpu.parallel.mesh import MeshBucketStore as JaxStore
from gubernator_tpu.utils import gregorian
from gubernator_tpu_torch.models.shard import GregResolver
from gubernator_tpu_torch.ops.buckets import state_to_numpy
from gubernator_tpu_torch.parallel.mesh import MeshBucketStore, shard_of_key
from gubernator_tpu.parallel.mesh import shard_of_key as jax_shard_of_key

NOW = 1_573_430_430_000
C = 128  # slots per shard


def batch(rng, n, n_keys, prefix="k", algo=None, behavior=0, hits=None,
          limit=None, duration=None):
    ids = rng.integers(0, n_keys, n)  # duplicates on purpose
    keys = [f"m_{prefix}{i}" for i in ids]
    cols = dict(
        algorithm=rng.integers(0, 2, n).astype(np.int32) if algo is None
        else np.full(n, algo, np.int32),
        behavior=np.full(n, behavior, np.int32),
        hits=rng.choice([0, 1, 1, 2, 3], n).astype(np.int64) if hits is None else hits,
        limit=np.full(n, 10, np.int64) if limit is None else limit,
        duration=np.full(n, 60_000, np.int64) if duration is None else duration,
    )
    return keys, cols


def both(jstore, tstore, keys, cols, now, **kw):
    a = jstore.apply_columns(keys, now_ms=now, **cols, **kw)
    b = tstore.apply_columns(keys, now_ms=now, **cols, **kw)
    for f in ("status", "limit", "remaining", "reset_time"):
        np.testing.assert_array_equal(np.asarray(a[f]), np.asarray(b[f]), err_msg=f)
    return b


def same_state(jstore, tstore):
    hot, cold = state_to_numpy(tstore.state)
    np.testing.assert_array_equal(np.asarray(jstore.state.hot), hot)
    np.testing.assert_array_equal(np.asarray(jstore.state.cold), cold)


def greg_cols(now, n, kind):
    ge, gd = GregResolver(now).resolve(kind)
    return np.full(n, ge, np.int64), np.full(n, gd, np.int64)


def test_shard_of_key_matches():
    for i in range(500):
        assert shard_of_key(f"k{i}", 8) == jax_shard_of_key(f"k{i}", 8)


def test_mesh_matches_jax_over_batches():
    rng = np.random.default_rng(5)
    jstore = JaxStore(capacity_per_shard=C)
    tstore = MeshBucketStore(capacity_per_shard=C, device="cpu")
    now = NOW
    # 1: duplicates, both algorithms (grouped occurrences)
    both(jstore, tstore, *batch(rng, 300, 200), now)
    now += 1500
    # 2: RESET_REMAINING mixed in: non-uniform groups take extra rounds
    keys, cols = batch(rng, 200, 60)
    cols["behavior"] = np.where(rng.random(200) < 0.3, 8, 0).astype(np.int32)
    both(jstore, tstore, keys, cols, now)
    now += 20_000
    # 3: monthly Gregorian: far-future expiries, the wide output
    keys, cols = batch(rng, 150, 150, prefix="g")
    cols["behavior"] = np.full(150, 4, np.int32)
    cols["duration"] = np.full(150, gregorian.GREGORIAN_MONTHS, np.int64)
    ge, gd = greg_cols(now, 150, gregorian.GREGORIAN_MONTHS)
    both(jstore, tstore, keys, cols, now, greg_expire=ge, greg_duration=gd)
    now += 1000
    # 4: more than 256 distinct configs: the per-lane-column fallback
    keys, cols = batch(rng, 400, 300, limit=rng.integers(1, 400, 400).astype(np.int64))
    both(jstore, tstore, keys, cols, now)
    now += 61_000  # first buckets expire: recreated in place
    # 5: forced wide per-lane-column wire
    both(jstore, tstore, *batch(rng, 300, 200), now, force_wire="wide")
    now += 10
    # 6: more keys than capacity: LRU eviction in the slot tables
    both(jstore, tstore, *batch(rng, 600, 5000, prefix="e"), now)
    assert tstore.size() == jstore.size()
    same_state(jstore, tstore)


def _reserve_ticket(store, keys, cols, now):
    """Plan one batch and take its launch turn without launching it,
    so that later submissions queue at the launch gate."""
    from gubernator_tpu_torch.models.shard import ColumnsHandle, make_columns

    c = make_columns(cols["algorithm"], cols["behavior"], cols["hits"],
                     cols["limit"], cols["duration"], len(keys))
    with store._plan_lock:
        prep = store._prepare_columns(keys, c, now)
        h = ColumnsHandle(store, prep.commit, c.limit)
        h.ticket = store._next_ticket
        store._next_ticket += 1
        store._inflight.append(h)
    return h, prep


def test_async_batches_launch_fused_and_match_serial():
    rng = np.random.default_rng(9)
    batches = [batch(rng, 120, 90) for _ in range(4)]  # same padded shape
    serial = MeshBucketStore(capacity_per_shard=C, device="cpu")
    jstore = JaxStore(capacity_per_shard=C)
    want = []
    for i, (k, c) in enumerate(batches):
        want.append(both(jstore, serial, k, c, NOW + i))

    store = MeshBucketStore(capacity_per_shard=C, device="cpu")
    h0, prep0 = _reserve_ticket(store, *batches[0], NOW)
    handles = [None] * 3

    def submit(i):
        k, c = batches[i + 1]
        handles[i] = store.apply_columns_async(k, now_ms=NOW + i + 1, **c)

    threads = []
    for i in range(3):  # one at a time, so the tickets follow the batches
        t = threading.Thread(target=submit, args=(i,))
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 10
        while len(store._launch_gate) < i + 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(store._launch_gate) == i + 1
    store._launch_in_order(h0, store._stage_columns(prep0))
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert store.device_dispatches == 1  # all four batches in one group
    for h, w in zip([h0] + handles, want):
        got = h.result()
        for f in ("status", "limit", "remaining", "reset_time"):
            np.testing.assert_array_equal(got[f], w[f])
    np.testing.assert_array_equal(store.state.hot.numpy(), serial.state.hot.numpy())
    np.testing.assert_array_equal(store.state.cold.numpy(), serial.state.cold.numpy())
    same_state(jstore, store)


def test_load_state_numpy_carries_a_jax_store_over():
    rng = np.random.default_rng(13)
    jstore = JaxStore(capacity_per_shard=C)
    for i in range(2):
        keys, cols = batch(rng, 200, 150)
        jstore.apply_columns(keys, now_ms=NOW + i, **cols)
    entries = []
    for t in jstore.tables:
        keys = t.keys()
        slots = np.array([t.get_slot(k) for k in keys], np.int32)
        entries.append((keys, slots, t.get_expire_bulk(slots)))
    tstore = MeshBucketStore(capacity_per_shard=C, device="cpu")
    tstore.load_state_numpy(np.asarray(jstore.state.hot),
                            np.asarray(jstore.state.cold), entries)
    assert tstore.size() == jstore.size()
    for i in range(2):
        both(jstore, tstore, *batch(rng, 200, 150), NOW + 5000 + i)
    same_state(jstore, tstore)


def test_global_lanes_are_rejected():
    """Both stores refuse GLOBAL lanes on the columnar path, with the
    same message: they take the dataclass path (`apply`)."""
    msg = r"GLOBAL lanes must take the dataclass path \(apply\)"
    for store in (MeshBucketStore(capacity_per_shard=8, device="cpu"),
                  JaxStore(capacity_per_shard=8)):
        with pytest.raises(ValueError, match=msg):
            store.apply_columns(["a", "b"], np.zeros(2), np.full(2, 2), np.ones(2),
                                np.full(2, 5), np.full(2, 1000), NOW)
