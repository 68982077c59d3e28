"""The port's slot tables against the JAX package's.

`models/slot_table.py` (the Python SlotTable, ShardStore(use_native=
False)'s table) is held to the JAX SlotTable op for op, and to the
port's C++ NativeSlotTable, on randomized sequences of lookups, commits
(removals and stale lanes included), removals, expiry writes and clock
steps; the cache.go cases of tests/test_slot_table.py run on both port
tables; the port's NativeBatchPlanner plans as the JAX one does.
Every observable output must be identical.
"""

import numpy as np
import pytest

from gubernator_tpu import native as jnative
from gubernator_tpu.models.shard import make_columns as jax_make_columns
from gubernator_tpu.models.slot_table import SlotTable as JaxSlotTable
from gubernator_tpu_torch import native
from gubernator_tpu_torch.models.shard import make_columns
from gubernator_tpu_torch.models.slot_table import SlotTable


def _ops(seed, steps, n_keys, with_remove=True):
    """A seeded op sequence: (op, key, value)."""
    rng = np.random.RandomState(seed)
    now = 1000
    for _ in range(steps):
        op = int(rng.randint(0, 11))
        key = f"k{rng.randint(0, n_keys)}"
        if op == 9 and not with_remove:
            op = 0
        if op < 6:
            yield "lookup", key, now
        elif op < 8:
            yield "commit", key, (now + int(rng.randint(-50, 500)), bool(rng.random() < 0.15))
        elif op == 8:
            yield "stale", key, now + 77
        elif op == 9:
            yield "remove", key, None
        else:
            now += int(rng.randint(0, 200))


def _apply(t, op, key, val, log):
    if op == "lookup":
        log.append(t.lookup_or_assign(key, val))
    elif op == "commit":
        slot = t.get_slot(key)
        log.append(slot)
        if slot is not None:
            t.commit([slot], [val[0]], [val[1]], keys=[key])
    elif op == "stale":
        # a lane whose slot now belongs to another key changes nothing
        slot = t.get_slot(key)
        if slot is not None:
            t.commit([slot], [val], [True], keys=[key + "_stale"])
    else:
        t.remove(key)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_python_table_matches_jax_op_for_op(seed):
    a, b = JaxSlotTable(24), SlotTable(24)
    la, lb = [], []
    for op, key, val in _ops(seed, 2500, 60):
        _apply(a, op, key, val, la)
        _apply(b, op, key, val, lb)
        assert la[-1:] == lb[-1:], (op, key)
    assert la == lb
    assert (a.hits, a.misses, a.evictions, a.generation) == \
        (b.hits, b.misses, b.evictions, b.generation)
    assert a.keys() == b.keys()
    assert a.expire_ms.tobytes() == b.expire_ms.tobytes()
    assert [a.key_of(s) for s in range(24)] == [b.key_of(s) for s in range(24)]


@pytest.mark.parametrize("seed", [4, 5])
def test_python_table_matches_the_native_table(seed):
    """The port's two tables (the C++ one has no remove yet: it comes
    with resharding)."""
    py, nat = SlotTable(24), native.NativeSlotTable(24)
    lp, ln = [], []
    for op, key, val in _ops(seed, 2500, 60, with_remove=False):
        _apply(py, op, key, val, lp)
        _apply(nat, op, key, val, ln)
        assert lp[-1:] == ln[-1:], (op, key)
    assert len(py) == len(nat)
    assert sorted(py.keys()) == sorted(nat.keys())
    # (their mapping generations count differently: only an unchanged
    # value between two reads is a contract)
    assert py.evictions == nat.evictions
    every = np.arange(24, dtype=np.int32)
    assert py.expire_ms.tobytes() == nat.get_expire_bulk(every).tobytes()


@pytest.fixture(params=["python", "native"])
def table(request):
    return lambda n: SlotTable(n) if request.param == "python" else native.NativeSlotTable(n)


def test_assign_hit_expiry_and_recycling(table):
    t = table(4)
    s, exists = t.lookup_or_assign("a", 100)
    assert not exists
    t.commit([s], [200], [False], keys=["a"])
    assert t.lookup_or_assign("a", 150) == (s, True)
    # strict expiry: at exactly ExpireAt the item is still live
    assert t.lookup_or_assign("a", 200) == (s, True)
    assert t.lookup_or_assign("a", 201) == (s, False)  # same key, same slot


def test_lru_eviction_order_and_freed_slots(table):
    t = table(2)
    sa, _ = t.lookup_or_assign("a", 0)
    sb, _ = t.lookup_or_assign("b", 0)
    t.commit([sa, sb], [10**15, 10**15], [False, False], keys=["a", "b"])
    t.lookup_or_assign("a", 1)  # touch a; b becomes LRU
    sc, _ = t.lookup_or_assign("c", 2)
    assert sc == sb and t.get_slot("b") is None and t.get_slot("a") == sa
    assert t.evictions == 1
    t.commit([sa], [0], [True], keys=["a"])  # removed: slot freed
    assert len(t) == 1
    assert t.lookup_or_assign("d", 3) == (sa, False)


def test_batch_planner_matches_jax():
    """The port's NativeBatchPlanner (gt_batch_*) plans and commits as
    the JAX one: duplicate groups, RESET_REMAINING lanes, eviction."""
    rng = np.random.RandomState(11)
    jt, tt = jnative.NativeSlotTable(64), native.NativeSlotTable(64)
    now = 1_700_000_000_000
    for step in range(6):
        n = 300
        ids = rng.randint(0, 120, n)
        keys = [f"b{i}" for i in ids]
        args = ((ids % 2).astype(np.int32), np.where(rng.random_sample(n) < 0.1, 8, 0),
                np.ones(n, np.int64), np.full(n, 10, np.int64), np.full(n, 1000, np.int64), n)
        jp = jnative.NativeBatchPlanner(jt, keys, now)
        tp = native.NativeBatchPlanner(tt, keys, now)
        a = jp.plan_grouped(jax_make_columns(*args), 8)
        b = tp.plan_grouped(make_columns(*args), 8)
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
        exp = now + rng.randint(-5, 2000, n)
        removed = rng.random_sample(n) < 0.05
        jp.commit_plan(exp, removed)
        tp.commit_plan(exp, removed)
        assert jt.keys() == tt.keys()
        every = np.arange(64, dtype=np.int32)
        assert jt.get_expire_bulk(every).tobytes() == tt.get_expire_bulk(every).tobytes()
        now += 700
