"""The express scalar slot (ops/scalar.py) against the JAX package's.

`apply_one` evaluates one lane against its bucket row on the host and
writes the row in place: lane by lane it must give the JAX apply_one's
answer and row bytes on seeded rows and requests (every path: token
reset, existing and create, leaky existing and create, algorithm
switches, expiry at the exact millisecond, Gregorian lanes, huge
limits).  Then the randomized runs of tests/test_express.py: port
stores on the CPU with `scalar_fast_path = True` beside JAX stores with
the same switch (a ShardStore, a MeshBucketStore, eviction pressure, a
Gregorian lane); answers, state and `scalar_applies` must be identical,
and equal to the same traffic through the kernels' plain versions.
Tolerance 0: all integer.
"""

import random

import numpy as np
import pytest
import torch

from gubernator_tpu.models.shard import ShardStore as JaxShard
from gubernator_tpu.ops import scalar as jscalar
from gubernator_tpu.parallel.mesh import MeshBucketStore as JaxMesh
from gubernator_tpu_torch.models.shard import ShardStore
from gubernator_tpu_torch.ops import scalar
from gubernator_tpu_torch.parallel.mesh import MeshBucketStore

NOW = 1_700_000_000_000


def _split(v):
    v = np.int64(v)
    return np.int32(np.uint32(int(v) & 0xFFFFFFFF).view(np.int32)), np.int32(int(v) >> 32)


def _row(rng):
    algo = int(rng.integers(0, 2))
    limit = int(rng.choice([0, 1, 5, 10, 1000, 2**40]))
    rem = int(rng.integers(0, limit + 1)) if limit < 2**31 else int(rng.integers(0, 2**35))
    if algo == 1:
        rem = rem * (1 << 20) + int(rng.integers(0, 1 << 20))
    hot = np.zeros(8, np.int32)
    cold = np.zeros(8, np.int32)
    hot[0] = algo | (int(rng.integers(0, 2)) << 2)
    hot[1], hot[2] = _split(rem)
    hot[3], hot[4] = _split(NOW - int(rng.integers(0, 200_000)))
    hot[5], hot[6] = _split(int(rng.choice([0, NOW - 1, NOW, NOW + 1,
                                            NOW + int(rng.integers(0, 100_000))])))
    cold[0], cold[1] = _split(limit)
    cold[2], cold[3] = _split(int(rng.choice([1000, 60_000, 2**44])))
    return hot, cold


def _request(rng):
    greg = rng.random() < 0.2
    beh = (8 if rng.random() < 0.15 else 0) | (4 if greg else 0)
    return dict(
        exists=bool(rng.random() < 0.8), algorithm=int(rng.integers(0, 2)), behavior=beh,
        hits=int(rng.choice([0, 1, 1, 2, 7, 2**40])),
        limit=int(rng.choice([0, 1, 5, 10, 1000, 2**40])),
        duration=int(rng.choice([1000, 60_000, 2**44])),
        greg_expire=NOW + int(rng.integers(1, 86_400_000)) if greg else 0,
        greg_duration=86_400_000 if greg else 0, now_ms=NOW)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_one_matches_jax_lane_by_lane(seed):
    rng = np.random.default_rng(seed)
    for i in range(400):
        hot, cold = _row(rng)
        req = _request(rng)
        jh, jc, th, tc = hot.copy(), cold.copy(), hot.copy(), cold.copy()
        want = jscalar.apply_one(jh, jc, **req)
        got = scalar.apply_one(th, tc, **req)
        assert want == got, (i, req)
        assert jh.tobytes() == th.tobytes() and jc.tobytes() == tc.tobytes(), (i, req)


def test_apply_one_writes_through_the_tensor_view():
    hot = torch.zeros((2, 4, 8), dtype=torch.int32)
    cold = torch.zeros((2, 4, 8), dtype=torch.int32)
    view_h, view_c = scalar.shard_view(hot, 1), scalar.shard_view(cold, 1)
    st, rem, reset, exp, removed = scalar.apply_one(
        view_h[2], view_c[2], exists=False, algorithm=0, behavior=0, hits=1, limit=5,
        duration=1000, greg_expire=0, greg_duration=0, now_ms=NOW)
    assert (st, rem, reset, exp, removed) == (0, 4, NOW + 1000, NOW + 1000, False)
    assert int(hot[1, 2, 1]) == 4 and int(cold[1, 2, 0]) == 5
    assert not hot[0].any() and scalar.device_is_cpu("cpu")


# ---------------------------------------------------------------------
# the randomized runs of tests/test_express.py, both packages
# ---------------------------------------------------------------------
def _drive_store(store, seed: int, steps: int = 150):
    """Randomized small batches through the columnar API: expiry edges
    (clock jumps past short durations), duplicate-heavy batches, token
    and leaky, RESET_REMAINING (tests/test_express.py's `_drive_store`)."""
    rng = random.Random(seed)
    out = []
    now = 1_000_000
    for step in range(steps):
        n = rng.choice([1, 1, 2, 3, 4])
        ks = [f"k{rng.randrange(6)}" for _ in range(n)]
        if rng.random() < 0.35:
            ks = [ks[0]] * n  # duplicate group
        algo = np.array([rng.choice([0, 1]) for _ in range(n)], np.int32)
        beh = np.array([rng.choice([0, 0, 0, 8]) for _ in range(n)], np.int32)
        hits = np.array([rng.choice([0, 1, 1, 2, 5, 11]) for _ in range(n)], np.int64)
        limit = np.full(n, rng.choice([1, 3, 10, 30]), np.int64)
        dur = np.full(n, rng.choice([7, 50, 100, 1000]), np.int64)
        now += rng.choice([0, 0, 1, 3, 60, 120, 1500])  # expiry edges
        r = store.apply_columns(ks, algo, beh, hits, limit, dur, now)
        out.append(tuple((int(r["status"][i]), int(r["remaining"][i]),
                          int(r["reset_time"][i])) for i in range(n)))
    return out


def _state(store):
    return store.state.hot.numpy().tobytes(), store.state.cold.numpy().tobytes()


def _jax_rows(a):
    """The JAX store's rows as they are now: its express slot writes
    the device buffer in place, under a host copy that an earlier
    readback may have cached on the array, so read a fresh result."""
    return np.asarray(a + 0).tobytes()


def _express(store):
    store.scalar_fast_path = True
    return store


@pytest.mark.parametrize("seed", [31, 32])
def test_scalar_oracle_shard(seed):
    j = _express(JaxShard(capacity=64))
    t = _express(ShardStore(capacity=64, device="cpu"))
    plain = ShardStore(capacity=64, device="cpu")
    want = _drive_store(j, seed)
    assert _drive_store(t, seed) == want == _drive_store(plain, seed)
    assert t.scalar_applies == j.scalar_applies == 150
    assert t.device_dispatches == 0 and plain.scalar_applies == 0
    assert _jax_rows(j.state.hot) == t.state.hot[0].numpy().tobytes()
    assert _state(t) == _state(plain)


@pytest.mark.parametrize("seed", [31, 32])
def test_scalar_oracle_mesh(seed):
    j = _express(JaxMesh(capacity_per_shard=32))
    t = _express(MeshBucketStore(capacity_per_shard=32, device="cpu"))
    plain = MeshBucketStore(capacity_per_shard=32, device="cpu")
    want = _drive_store(j, seed)
    assert _drive_store(t, seed) == want == _drive_store(plain, seed)
    assert t.scalar_applies == j.scalar_applies == 150
    assert t.device_dispatches == 0
    assert _jax_rows(j.state.hot) == t.state.hot.numpy().tobytes()
    assert _state(t) == _state(plain)


def test_scalar_oracle_eviction_pressure():
    """A tiny table forces mid-batch slot takeovers (another key's
    create evicting into a just-written slot): the case the sequential
    exists rule must not confuse with a duplicate group."""
    j = _express(JaxShard(capacity=4))
    t = _express(ShardStore(capacity=4, device="cpu"))
    plain = ShardStore(capacity=4, device="cpu")
    want = _drive_store(j, 41, steps=120)
    assert _drive_store(t, 41, steps=120) == want == _drive_store(plain, 41, steps=120)
    assert t.scalar_applies == j.scalar_applies == 120
    assert _state(t) == _state(plain)


def test_scalar_gregorian_lane():
    now = 1_700_000_000_000
    ge = np.array([now + 3_600_000], np.int64)
    gd = np.array([3_600_000], np.int64)

    def drive(store):
        out = []
        for i in range(4):
            r = store.apply_columns(
                ["gk"], np.zeros(1, np.int32), np.full(1, 4, np.int32),
                np.ones(1, np.int64), np.full(1, 10, np.int64),
                np.full(1, 4, np.int64),  # calendar enum, not ms
                now + i, greg_expire=ge, greg_duration=gd)
            out.append((int(r["status"][0]), int(r["remaining"][0]), int(r["reset_time"][0])))
        return out

    j = _express(JaxShard(capacity=16))
    t = _express(ShardStore(capacity=16, device="cpu"))
    assert drive(t) == drive(j) == drive(ShardStore(capacity=16, device="cpu"))
    assert t.scalar_applies == j.scalar_applies == 4
    assert drive(t)[0] == (0, 5, now + 3_600_000)


def test_express_slot_is_never_taken_on_the_card():
    """A CUDA store's batches take the kernel: the slot's eligibility
    reads the store's device (no tensor is touched here)."""
    t = _express(ShardStore(capacity=8, device="cpu"))
    m = _express(MeshBucketStore(capacity_per_shard=8, device="cpu"))
    from gubernator_tpu_torch.models.shard import make_columns

    cols = make_columns([0], [0], [1], [5], [1000], 1)
    assert t._scalar_eligible(cols) and m._scalar_eligible(cols)
    for store in (t, m):
        store.device = torch.device("cuda", 0)
        assert not store._scalar_eligible(cols)
    m.device = torch.device("cpu")
    m.back = object()  # a two-tier store has no express slot
    assert not m._scalar_eligible(cols)
    with pytest.raises(TypeError):  # no host view off the CPU, and no copy
        scalar.shard_view(torch.zeros((1, 2, 8), dtype=torch.int32, device="meta"), 0)
