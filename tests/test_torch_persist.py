"""The port's persistence plane against the JAX package's.

Row functions: the plain row gather / scatter (ops/buckets.py) against
the JAX programs they transcribe (`_gather_rows_mesh_jit`,
`_write_rows_mesh_jit`, `_write_row_jit`, `rows_to_split`).  Snapshot
format: the port's codec against the JAX golden and the JAX codec.
Stores: dumps and restores across the two packages in both directions,
the Store SPI call sequences of tests/test_store.py at the mesh level,
and the service's Loader and snapshot wiring, each run on a JAX store or
service (8-device virtual CPU mesh, tests/conftest.py) and a port one
(`device="cpu"`) side by side.  Everything is integer, so the tolerance
is 0: rows, state bytes, `algo_mirror`, slot tables, file bytes,
responses, store calls and items must be identical.
"""

import os
import zlib

import numpy as np
import pytest
import torch

from gubernator_tpu import snapshot as jsnap
from gubernator_tpu.config import BehaviorConfig
from gubernator_tpu.ops import buckets as jbuckets
from gubernator_tpu.parallel import mesh as jmesh
from gubernator_tpu.parallel.mesh import MeshBucketStore as JaxStore
from gubernator_tpu.reshard import TransferColumns as JaxColumns
from gubernator_tpu.service import ServiceConfig as JaxConfig
from gubernator_tpu.service import V1Service as JaxService
from gubernator_tpu import store as jstore_spi
from gubernator_tpu.types import GetRateLimitsRequest as JaxGetRequest
from gubernator_tpu.types import PeerInfo
from gubernator_tpu.types import RateLimitRequest as JaxRequest
from gubernator_tpu.utils.clock import Clock as JaxClock
from gubernator_tpu_torch import snapshot as snap
from gubernator_tpu_torch import store as spi
from gubernator_tpu_torch.ops import _kernels, buckets
from gubernator_tpu_torch.parallel.mesh import MeshBucketStore, shard_of_key
from gubernator_tpu_torch.reshard import TransferColumns
from gubernator_tpu_torch.service import ServiceConfig, V1Service
from gubernator_tpu_torch.types import (
    Algorithm,
    Behavior,
    GetRateLimitsRequest,
    RateLimitRequest,
    Status,
)
from gubernator_tpu_torch.utils.clock import Clock
from tests.test_snapshot import GOLDEN_HEX, _golden_cols

NOW = 1_573_430_430_000
S = 8
RESET = int(Behavior.RESET_REMAINING)
EXTREMES = np.array([0, 1, -1, 2**31 - 1, -2**31, 2**31, 2**32 - 1, 2**32,
                     2**62, 2**63 - 1, -2**63], np.int64)


# ---------------------------------------------------------------------
# row functions: plain versions against the JAX programs
# ---------------------------------------------------------------------
def _state(rng, C):
    return (rng.integers(-2**31, 2**31, (S, C, 8)).astype(np.int32),
            rng.integers(-2**31, 2**31, (S, C, 8)).astype(np.int32))


def _rows(rng, shape):
    def col():
        return np.where(rng.random(shape) < 0.5, rng.choice(EXTREMES, shape),
                        rng.integers(-2**40, 2**40, shape))

    return jbuckets.BucketRows(
        algo=rng.integers(-3, 5, shape).astype(np.int32), limit=col(),
        remaining=col(), duration=col(), stamp=col(), expire_at=col(),
        status=rng.integers(-3, 5, shape).astype(np.int32))


def _mesh_lanes(slots):
    shard = np.broadcast_to(np.arange(slots.shape[0])[:, None], slots.shape)
    return torch.tensor(np.stack([shard, slots]).astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_gather_and_scatter_match_jax(seed):
    rng = np.random.default_rng(seed)
    C, P = 128, 48
    hot, cold = _state(rng, C)
    slots = np.stack([rng.permutation(C)[:P] for _ in range(S)]).astype(np.int32)
    slots[rng.random((S, P)) < 0.2] = -1  # padding
    jstate = jbuckets.BucketState(hot=hot, cold=cold)
    want = jmesh._gather_rows_mesh_jit(jstate, slots)
    c32, c64 = buckets.read_rows_plain(torch.tensor(hot), torch.tensor(cold),
                                       _mesh_lanes(slots))
    got = buckets.cols_to_rows(c32.numpy(), c64.numpy())
    live = slots >= 0  # JAX wraps a -1 slot to the last row; no caller reads it
    for f in jbuckets.BucketRows._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a[live], b[live]), f
        assert not b[~live].any(), f

    rows = _rows(rng, (S, P))
    want = jmesh._write_rows_mesh_jit(jstate, slots, rows)
    h, c = torch.tensor(hot), torch.tensor(cold)
    buckets.write_rows(h, c, _mesh_lanes(slots),
                       *[torch.tensor(x) for x in buckets.rows_to_cols(rows)])
    assert np.asarray(want.hot).tobytes() == h.numpy().tobytes()
    assert np.asarray(want.cold).tobytes() == c.numpy().tobytes()


def test_single_row_write_and_split_match_jax():
    rng = np.random.default_rng(4)
    hot, cold = _state(rng, 32)
    for i in range(6):
        row = _rows(rng, (1,))
        s, slot = int(rng.integers(0, S)), int(rng.integers(0, 32))
        want = jmesh._write_row_jit(jbuckets.BucketState(hot=hot, cold=cold),
                                    np.int32(s), np.int32(slot), row)
        h, c = torch.tensor(hot), torch.tensor(cold)
        buckets.write_rows(h, c, torch.tensor([[s], [slot]], dtype=torch.int32),
                           *[torch.tensor(x) for x in buckets.rows_to_cols(row)])
        assert np.asarray(want.hot).tobytes() == h.numpy().tobytes()
        assert np.asarray(want.cold).tobytes() == c.numpy().tobytes()
        hot, cold = h.numpy(), c.numpy()
    rows = _rows(rng, (64,))
    want = jbuckets.rows_to_split(rows)
    got = buckets.rows_to_split(rows)
    assert np.asarray(want.hot).tobytes() == got.hot.numpy().tobytes()
    assert np.asarray(want.cold).tobytes() == got.cold.numpy().tobytes()


def test_duplicate_rows_keep_the_last_lane():
    shard = np.array([0, 1, 0, 0, 2, 1, 0], np.int32)
    slot = np.array([5, 5, -1, 5, 7, 5, -1], np.int32)
    assert buckets.last_lane_per_slot(shard, slot).tolist() == [3, 4, 5]
    hot = torch.zeros((S, 8, 8), dtype=torch.int32)
    lanes = torch.tensor(np.stack([shard, slot]))
    c32 = torch.zeros((2, 7), dtype=torch.int32)
    c64 = torch.zeros((5, 7), dtype=torch.int64)
    with pytest.raises(ValueError, match="more than once"):
        buckets.write_rows(hot, hot.clone(), lanes, c32, c64)


# ---------------------------------------------------------------------
# snapshot format
# ---------------------------------------------------------------------
def _port_cols(jcols):
    return TransferColumns(**vars(jcols))


def test_snapshot_golden_bytes():
    raw = snap.encode_snapshot(_port_cols(_golden_cols()), saved_at_ms=1_573_430_430_500,
                               ring_hash=0xDEADBEEF12345678)
    assert raw == bytes.fromhex(GOLDEN_HEX)


def _seeded_cols(rng, n):
    keys = [f"k{i}_{'é汉'[i % 2]}" + "x" * int(rng.integers(0, 40)) for i in range(n)]
    return TransferColumns(
        keys=keys, algorithm=rng.integers(0, 2, n).astype(np.int32),
        status=rng.integers(0, 2, n).astype(np.int32),
        limit=rng.choice(EXTREMES, n), remaining=rng.choice(EXTREMES, n),
        duration=rng.integers(0, 2**40, n), stamp=NOW + rng.integers(-2**30, 2**30, n),
        expire_at=NOW + rng.integers(-2**30, 2**30, n))


@pytest.mark.parametrize("n", [0, 1, 257])
def test_encode_and_decode_match_jax(n):
    cols = _seeded_cols(np.random.default_rng(n), n)
    raw = snap.encode_snapshot(cols, NOW, ring_hash=n)
    assert raw == jsnap.encode_snapshot(JaxColumns(**vars(cols)), NOW, ring_hash=n)
    got, meta = snap.decode_snapshot(raw)
    want, jmeta = jsnap.decode_snapshot(raw)
    assert meta == jmeta and got.keys == want.keys == cols.keys
    for f in ("algorithm", "status", "limit", "remaining", "duration", "stamp", "expire_at"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _defects(raw):
    """Damaged copies of a valid file: truncations, appended bytes, bit
    flips in each region, wrong magic and version, invalid UTF-8 under a
    valid checksum, and a fenced file under another ring."""
    out = [raw[:cut] for cut in (0, 4, 29, 33, len(raw) // 2, len(raw) - 1)]
    out.append(raw + b"\x00")
    for pos in (11, 39, len(raw) - 20, len(raw) - 1):
        b = bytearray(raw)
        b[pos] ^= 0x40
        out.append(bytes(b))
    out.append(b"NOPE" + raw[4:])
    out.append(raw[:4] + b"\x63" + raw[5:])
    b = bytearray(raw[:-4])
    b[30 + 8] = 0xFF
    out.append(bytes(b) + zlib.crc32(bytes(b)).to_bytes(4, "little"))
    return out


def test_decoder_rejects_what_jax_rejects():
    raw = snap.encode_snapshot(_port_cols(_golden_cols()), NOW, ring_hash=5)
    for i, bad in enumerate(_defects(raw)):
        with pytest.raises(jsnap.SnapshotError) as jerr:
            jsnap.decode_snapshot(bad)
        with pytest.raises(snap.SnapshotError) as terr:
            snap.decode_snapshot(bad)
        assert str(jerr.value) == str(terr.value), i
    # strict fencing: a fenced file under its own ring passes, under
    # another it is rejected; an unfenced one passes anywhere
    snap.decode_snapshot(raw, expected_ring=5)
    with pytest.raises(snap.SnapshotError, match="ring fingerprint"):
        snap.decode_snapshot(raw, expected_ring=6)
    snap.decode_snapshot(snap.encode_snapshot(_port_cols(_golden_cols()), NOW), expected_ring=6)


def test_crash_safe_write(tmp_path, monkeypatch):
    path = str(tmp_path / "gub.snap")
    snap.write_snapshot(path, _port_cols(_golden_cols()), NOW)
    before = open(path, "rb").read()

    def boom(_fd):
        raise OSError("disk full")

    monkeypatch.setattr(os, "fsync", boom)
    with pytest.raises(OSError):
        snap.write_snapshot(path, _seeded_cols(np.random.default_rng(1), 3), NOW + 1)
    monkeypatch.undo()
    assert open(path, "rb").read() == before
    assert os.listdir(tmp_path) == ["gub.snap"]


# ---------------------------------------------------------------------
# stores side by side
# ---------------------------------------------------------------------
def _jreq(r):
    return JaxRequest(**vars(r))


def _fields(resps):
    return [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in resps]


def same_store(j, t, key_order=True):
    """State bytes, algo_mirror and every slot table (keys, in the same
    order unless `key_order` is False, slots, expiries) identical."""
    hot, cold = buckets.state_to_numpy(t.state)
    assert np.asarray(j.state.hot).tobytes() == hot.tobytes()
    assert np.asarray(j.state.cold).tobytes() == cold.tobytes()
    assert j.algo_mirror.tobytes() == t.algo_mirror.tobytes()
    every = np.arange(t.capacity_per_shard, dtype=np.int32)
    for jt, tt in zip(j.tables, t.tables):
        keys, slots = tt.entries()
        assert (jt.keys() if key_order else sorted(jt.keys())) == \
            (keys if key_order else sorted(keys))
        assert [jt.get_slot(k) for k in keys] == slots.tolist()
        assert jt.get_expire_bulk(every).tobytes() == tt.get_expire_bulk(every).tobytes()


def _traffic(rng, n, n_keys, prefix="p"):
    ids = rng.integers(0, n_keys, n)
    return [RateLimitRequest(
        name="persist", unique_key=f"{prefix}{i}", hits=int(rng.choice([0, 1, 1, 2, 5])),
        limit=int(rng.choice([5, 10, 50])), duration=int(rng.choice([1000, 60_000])),
        algorithm=int(i % 2), behavior=RESET if rng.random() < 0.05 else 0) for i in ids]


def _both_apply(j, t, reqs, now, key_order=True):
    a = j.apply([_jreq(r) for r in reqs], now)
    b = t.apply(reqs, now)
    assert _fields(a) == _fields(b)
    same_store(j, t, key_order)
    return b


def _columns_batch(rng, n, n_keys):
    ids = rng.integers(0, n_keys, n)
    return [f"persist_c{i}" for i in ids], dict(
        algorithm=(ids % 2).astype(np.int32), behavior=np.zeros(n, np.int32),
        hits=rng.choice([0, 1, 2], n).astype(np.int64), limit=np.full(n, 20, np.int64),
        duration=np.full(n, 60_000, np.int64))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_restores_across_packages(tmp_path, writer):
    rng = np.random.default_rng(11)
    C = 64
    src_j, src_t = JaxStore(capacity_per_shard=C), MeshBucketStore(capacity_per_shard=C,
                                                                    device="cpu")
    now = NOW
    for step in range(3):
        _both_apply(src_j, src_t, _traffic(rng, 80, 150), now)
        keys, cols = _columns_batch(rng, 100, 120)
        a = src_j.apply_columns(keys, now_ms=now, **cols)
        b = src_t.apply_columns(keys, now_ms=now, **cols)
        for f in ("status", "limit", "remaining", "reset_time"):
            assert np.array_equal(np.asarray(a[f]), b[f]), f
        # The JAX store's columnar commit also writes its algo_mirror,
        # which only the Store SPI reads, and a store with one has no
        # columnar path; the port's does not.
        src_j.algo_mirror[:] = src_t.algo_mirror
        same_store(src_j, src_t)
        now += 700
    jcols, tcols = src_j.snapshot_columns(now), src_t.snapshot_columns(now)
    raw = jsnap.encode_snapshot(jcols, now)
    assert raw == snap.encode_snapshot(tcols, now)
    assert len(tcols) > 100
    path = str(tmp_path / "x.snap")
    if writer == "jax":
        jsnap.write_snapshot(path, jcols, now)
    else:
        snap.write_snapshot(path, tcols, now)
    dst_j, dst_t = JaxStore(capacity_per_shard=C), MeshBucketStore(capacity_per_shard=C,
                                                                    device="cpu")
    later = now + 5000  # some rows expire in between
    n_j = dst_j.commit_transfer(jsnap.read_snapshot(path)[0], later)
    n_t = dst_t.commit_transfer(snap.read_snapshot(path)[0], later)
    assert n_j == n_t > 0 and n_t < len(tcols)
    same_store(dst_j, dst_t)
    _both_apply(dst_j, dst_t, _traffic(rng, 120, 150), later)


def test_restore_overflowing_a_shard_keeps_the_later_key():
    """More keys for shard 0 than its capacity: the batch's later keys
    evict its earlier ones, several lanes name one slot, and the later
    lane's row is the one that stays (the JAX program's scatter order)."""
    C = 8
    keys = [k for k in (f"ov{i}" for i in range(400)) if shard_of_key(k, S) == 0][:20]
    keys += [f"other{i}" for i in range(6)]
    n = len(keys)
    rng = np.random.default_rng(2)
    cols = TransferColumns(
        keys=keys, algorithm=rng.integers(0, 2, n).astype(np.int32),
        status=rng.integers(0, 2, n).astype(np.int32), limit=np.full(n, 100, np.int64),
        remaining=rng.integers(0, 100, n).astype(np.int64),
        duration=np.full(n, 60_000, np.int64), stamp=np.full(n, NOW, np.int64),
        expire_at=NOW + rng.integers(1, 60_000, n))
    j, t = JaxStore(capacity_per_shard=C), MeshBucketStore(capacity_per_shard=C, device="cpu")
    _both_apply(j, t, [RateLimitRequest(name="o", unique_key=f"pre{i}", hits=1, limit=9,
                                        duration=60_000) for i in range(30)], NOW)
    assert j.commit_transfer(JaxColumns(**vars(cols)), NOW) == \
        t.commit_transfer(cols, NOW) == n
    same_store(j, t)
    assert len(t.tables[0]) == C
    _both_apply(j, t, [RateLimitRequest(name="o", unique_key=k, hits=1, limit=100,
                                        duration=60_000, algorithm=int(a))
                       for k, a in zip(keys, cols.algorithm)], NOW + 1)


def test_restore_merges_into_live_rows():
    rng = np.random.default_rng(5)
    j, t = JaxStore(capacity_per_shard=64), MeshBucketStore(capacity_per_shard=64, device="cpu")
    reqs = _traffic(rng, 120, 60)
    _both_apply(j, t, reqs, NOW)
    # Lower and higher remaining than the live rows, other algorithms,
    # duplicates and expired lanes.
    keys = [r.hash_key() for r in reqs[:80]]
    n = len(keys)
    cols = TransferColumns(
        keys=keys, algorithm=np.array([r.algorithm for r in reqs[:80]], np.int32)
        ^ (rng.random(n) < 0.2), status=rng.integers(0, 2, n).astype(np.int32),
        limit=np.full(n, 10, np.int64),
        remaining=rng.integers(0, 12, n) * np.where(rng.random(n) < 0.5, 1, buckets.LEAKY_SCALE),
        duration=np.full(n, 60_000, np.int64), stamp=NOW - rng.integers(0, 5000, n),
        expire_at=NOW + rng.integers(-100, 60_000, n))
    assert j.commit_transfer(JaxColumns(**vars(cols)), NOW + 1) == \
        t.commit_transfer(cols, NOW + 1)
    same_store(j, t)
    _both_apply(j, t, reqs[::-1], NOW + 2)


def test_state_carry_over_includes_algo_mirror():
    rng = np.random.default_rng(9)
    j = JaxStore(capacity_per_shard=32)
    j.apply([_jreq(r) for r in _traffic(rng, 60, 80)], NOW)
    entries = []
    for jt in j.tables:
        keys = jt.keys()
        slots = np.array([jt.get_slot(k) for k in keys], np.int32)
        entries.append((keys, slots, jt.get_expire_bulk(slots)))
    t = MeshBucketStore(capacity_per_shard=32, device="cpu")
    t.load_state_numpy(np.asarray(j.state.hot), np.asarray(j.state.cold), entries,
                       algo_mirror=j.algo_mirror)
    assert t.algo_mirror.tobytes() == j.algo_mirror.tobytes()
    # Tables rebuilt from a key map hold the same keys and slots, in
    # another hash-map order (a snapshot's lane order, not an answer).
    _both_apply(j, t, _traffic(rng, 60, 80), NOW + 10, key_order=False)


# ---------------------------------------------------------------------
# Store SPI (store_test.go, tests/test_store.py) at the mesh level
# ---------------------------------------------------------------------
def _item(it):
    """A CacheItem of either package as a comparable tuple."""
    v = it.value
    return (int(it.algorithm), it.key, int(it.expire_at), type(v).__name__,
            tuple(float(x) if isinstance(x, float) else int(x) for x in vars(v).values()))


def _items(store):
    return {k: _item(it) for k, it in store.cache_items.items()}


class StorePair:
    """A JAX and a port MeshBucketStore, each over its own MockStore,
    driven with the same batches; responses, store calls, stored items
    and store state compared after each."""

    def __init__(self, C=64):
        self.js, self.ts = jstore_spi.MockStore(), spi.MockStore()
        self.j = JaxStore(capacity_per_shard=C, store=self.js)
        self.t = MeshBucketStore(capacity_per_shard=C, device="cpu", store=self.ts)
        assert not self.t.supports_columns

    def preload(self, key, algo, remaining, stamp, expire, limit=10, duration=1000):
        for mod, st in ((jstore_spi, self.js), (spi, self.ts)):
            if algo == Algorithm.TOKEN_BUCKET:
                value = mod.TokenBucketItem(limit=limit, duration=duration,
                                            created_at=stamp, remaining=int(remaining))
            else:
                value = mod.LeakyBucketItem(limit=limit, duration=duration,
                                            updated_at=stamp, remaining=float(remaining))
            st.cache_items[key] = mod.CacheItem(algorithm=algo, key=key, value=value,
                                                expire_at=expire)

    def apply(self, reqs, now):
        b = _both_apply(self.j, self.t, reqs, now)
        assert self.js.called == self.ts.called
        assert _items(self.js) == _items(self.ts)
        return b


def _mk(algo, key="account:1234", behavior=0, hits=1):
    return RateLimitRequest(name="test_store", unique_key=key, hits=hits, limit=10,
                            duration=1000, algorithm=algo, behavior=behavior)


@pytest.mark.parametrize(
    "algo,switch_algo,preload,first_rem,first_status,second_rem,second_status",
    [
        (Algorithm.TOKEN_BUCKET, Algorithm.LEAKY_BUCKET, False, 9, Status.UNDER_LIMIT, 8,
         Status.UNDER_LIMIT),
        (Algorithm.TOKEN_BUCKET, Algorithm.LEAKY_BUCKET, True, 0, Status.UNDER_LIMIT, 0,
         Status.OVER_LIMIT),
        (Algorithm.LEAKY_BUCKET, Algorithm.TOKEN_BUCKET, False, 9, Status.UNDER_LIMIT, 8,
         Status.UNDER_LIMIT),
        (Algorithm.LEAKY_BUCKET, Algorithm.TOKEN_BUCKET, True, 0, Status.UNDER_LIMIT, 0,
         Status.OVER_LIMIT),
    ],
    ids=["token-empty", "token-preloaded", "leaky-empty", "leaky-preloaded"],
)
def test_store_call_sequences(algo, switch_algo, preload, first_rem, first_status,
                              second_rem, second_status):
    st = StorePair()
    req = _mk(algo)
    if preload:
        st.preload(req.hash_key(), algo, 1, NOW, NOW + 1000)
    r = st.apply([req], NOW)[0]
    assert (r.remaining, r.status) == (first_rem, first_status)
    assert st.ts.called == {"OnChange()": 1, "Remove()": 0, "Get()": 1}
    r = st.apply([req], NOW)[0]
    assert (r.remaining, r.status) == (second_rem, second_status)
    assert st.ts.called == {"OnChange()": 2, "Remove()": 0, "Get()": 1}
    st.apply([_mk(switch_algo)], NOW)
    assert st.ts.called == {"OnChange()": 3, "Remove()": 1, "Get()": 2}
    assert st.ts.cache_items[req.hash_key()].algorithm == switch_algo


def test_store_reset_remaining_removes_from_store():
    st = StorePair()
    st.apply([_mk(Algorithm.TOKEN_BUCKET)], NOW)
    r = st.apply([_mk(Algorithm.TOKEN_BUCKET, behavior=RESET)], NOW)[0]
    assert r.remaining == 10
    assert st.ts.called == {"OnChange()": 1, "Remove()": 1, "Get()": 1}
    assert not st.ts.cache_items


def test_store_randomized_differential():
    """Preloaded store items of either algorithm, algorithm switches,
    RESET_REMAINING lanes, duplicate keys (rounds) and a full table."""
    rng = np.random.default_rng(21)
    st = StorePair(C=16)
    for i in range(0, 200, 3):
        st.preload(f"persist_p{i}", int(i % 2 if i % 7 else 1 - i % 2),
                   rng.integers(0, 10), NOW - 100, NOW + int(rng.integers(-50, 5000)))
    now = NOW
    for _ in range(5):
        reqs = _traffic(rng, 90, 200)
        for r in reqs:
            if rng.random() < 0.1:
                r.algorithm = 1 - r.algorithm
        st.apply(reqs, now)
        now += 400
    assert st.ts.called["Remove()"] > 0 and st.ts.called["Get()"] > 0


# ---------------------------------------------------------------------
# service wiring, held against the JAX service
# ---------------------------------------------------------------------
def _services(path="", loader=None, jloader=None, store=None, jstore=None):
    """A JAX and a port service (close both: they run threads)."""
    jclock = JaxClock()
    jclock.freeze(NOW)
    beh = BehaviorConfig(global_sync_wait_s=3600.0, multi_region_sync_wait_s=3600.0)
    jpath = path and path + ".jax"
    j = JaxService(JaxConfig(cache_size=2048, clock=jclock, behaviors=beh, loader=jloader,
                             advertise_address="127.0.0.1:9999", snapshot_path=jpath,
                             persist_store=jstore))
    j.set_peers([PeerInfo(grpc_address="127.0.0.1:9999", is_owner=True)])
    tclock = Clock()
    tclock.freeze(NOW)
    t = V1Service(ServiceConfig(cache_size=2048, clock=tclock, device="cpu",
                                global_sync_wait_s=3600.0, loader=loader,
                                snapshot_path=path, persist_store=store))
    return j, t


def _req(key, hits=1, limit=10, algorithm=Algorithm.TOKEN_BUCKET):
    return RateLimitRequest(name="snap", unique_key=key, hits=hits, limit=limit,
                            duration=60_000, algorithm=algorithm)


def _both_requests(j, t, reqs):
    a = j.get_rate_limits(JaxGetRequest(requests=[_jreq(r) for r in reqs])).responses
    b = t.get_rate_limits(GetRateLimitsRequest(requests=reqs)).responses
    assert _fields(a) == _fields(b)
    return b


def _same_file(jpath, tpath):
    """The two services' files hold the same lanes (the JAX service
    stamps its ring's fingerprint into the header, the port 0)."""
    a, am = jsnap.read_snapshot(jpath)
    b, bm = snap.read_snapshot(tpath)
    assert a.keys == b.keys and am["saved_at_ms"] == bm["saved_at_ms"]
    for f in ("algorithm", "status", "limit", "remaining", "duration", "stamp", "expire_at"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert bm["ring_hash"] == 0
    return b


def test_service_shutdown_save_then_boot_restore(tmp_path):
    path = str(tmp_path / "svc.snap")
    j, t = _services(path)
    try:
        _both_requests(j, t, [_req(f"b{i}", hits=3, limit=10 + i) for i in range(12)])
    finally:
        j.close()
        t.close()
    cols = _same_file(path + ".jax", path)
    assert len(cols) == 12 and t.snapshots.saves_ok == 1 == j.snapshots.saves_ok
    j, t = _services(path)
    try:
        assert t.snapshots.restore_result == j.snapshots.restore_result == "ok"
        assert t.snapshots.restored_lanes == j.snapshots.restored_lanes == 12
        assert t.snapshots.last_restore_seconds > 0
        same_store(j.store, t.store)
        r = _both_requests(j, t, [_req(f"b{i}", hits=0, limit=10 + i) for i in range(12)])
        assert [x.remaining for x in r] == [7 + i for i in range(12)]
    finally:
        j.close()
        t.close()


def test_corrupt_snapshot_is_a_loud_cold_start(tmp_path, caplog):
    path = str(tmp_path / "corrupt.snap")
    for p in (path, path + ".jax"):
        with open(p, "wb") as f:
            f.write(b"GUBS" + bytes(range(64)))
    j, t = _services(path)
    try:
        assert t.snapshots.restore_result == j.snapshots.restore_result == "rejected"
        assert t.snapshots.restored_lanes == 0
        assert "REJECTED" in caplog.text
        r = _both_requests(j, t, [_req("fresh")])
        assert r[0].remaining == 9
    finally:
        j.close()
        t.close()


def _loader_items(mod):
    out = []
    for i in range(40):
        if i % 3:
            v = mod.TokenBucketItem(limit=10, duration=60_000, remaining=i % 10,
                                    created_at=NOW - i, status=i % 2)
        else:
            v = mod.LeakyBucketItem(limit=10, duration=60_000, remaining=(i % 10) + 0.375,
                                    updated_at=NOW - i)
        out.append(mod.CacheItem(algorithm=int(i % 3 == 0), key=f"snap_l{i}", value=v,
                                 expire_at=NOW + (60_000 if i % 5 else -1)))
    return out


def test_loader_rides_commit_transfer_and_saves_items(tmp_path, monkeypatch):
    path = str(tmp_path / "both.snap")
    key = _req("l1").hash_key()
    row = TransferColumns(keys=[key], algorithm=np.zeros(1, np.int32),
                          status=np.zeros(1, np.int32), limit=np.full(1, 10),
                          remaining=np.full(1, 7), duration=np.full(1, 60_000),
                          stamp=np.full(1, NOW), expire_at=np.full(1, NOW + 60_000))
    snap.write_snapshot(path, row, NOW)
    jsnap.write_snapshot(path + ".jax", JaxColumns(**vars(row)), NOW)
    jl, tl = jstore_spi.MockLoader(), spi.MockLoader()
    jl.cache_items, tl.cache_items = _loader_items(jstore_spi), _loader_items(spi)
    calls = []
    real = MeshBucketStore.commit_transfer
    monkeypatch.setattr(MeshBucketStore, "commit_transfer",
                        lambda self, cols, now: calls.append(len(cols)) or real(self, cols, now))
    j, t = _services(path, loader=tl, jloader=jl)
    try:
        assert calls == [40, 1]  # the loader's items, then the snapshot
        assert tl.called == jl.called == {"Load()": 1, "Save()": 0}
        same_store(j.store, t.store)
        # min wins: the snapshot's 7 cannot un-spend the loader's 1
        r = _both_requests(j, t, [_req(f"l{i}", hits=1) for i in range(40)])
        assert r[1].remaining == 0
    finally:
        j.close()
        t.close()
    assert tl.called == jl.called == {"Load()": 1, "Save()": 1}
    saved = [_item(it) for it in tl.cache_items[40:]]
    assert saved == [_item(it) for it in jl.cache_items[40:]]
    assert len(saved) == 40


def test_loader_leaky_items_roundtrip_fixed_point():
    items = [it for it in _loader_items(spi) if isinstance(it.value, spi.LeakyBucketItem)]
    cols = snap.items_to_columns(items)
    want = jsnap.items_to_columns(
        [it for it in _loader_items(jstore_spi) if isinstance(it.value, jstore_spi.LeakyBucketItem)])
    assert snap.encode_snapshot(cols, NOW) == jsnap.encode_snapshot(want, NOW)
    back = snap.columns_to_items(cols)
    assert [b.value.remaining for b in back] == [it.value.remaining for it in items]
    assert all(b.value.updated_at == it.value.updated_at for b, it in zip(back, items))


def test_store_spi_service_routes_every_lane_through_apply():
    js, ts = jstore_spi.MockStore(), spi.MockStore()
    j, t = _services(store=ts, jstore=js)
    try:
        assert not t.store.supports_columns
        reqs = [_req(f"s{i % 5}", algorithm=i % 2) for i in range(12)] + [_req("")]
        for _ in range(2):
            _both_requests(j, t, reqs)
        assert ts.called == js.called and _items(ts) == _items(js)
        assert ts.called["OnChange()"] > 0
    finally:
        j.close()
        t.close()


def _port_service(**kw):
    c = Clock()
    c.freeze(NOW)
    return V1Service(ServiceConfig(cache_size=2048, clock=c, device="cpu",
                                   global_sync_wait_s=3600.0, **kw))


def test_interval_thread_writes_a_file(tmp_path):
    path = str(tmp_path / "cadence.snap")
    t = _port_service(snapshot_path=path, snapshot_interval_s=0.05)
    try:
        t.get_rate_limits(GetRateLimitsRequest(requests=[_req("tick")]))
        for _ in range(100):
            if t.snapshots.saves_ok >= 2:
                break
            t.snapshots._stop.wait(0.05)
        assert t.snapshots.saves_ok >= 2
        assert snap.read_snapshot(path)[0].keys == [_req("tick").hash_key()]
    finally:
        t.close()


def test_boot_sweeps_orphaned_temp_files(tmp_path):
    path = str(tmp_path / "sweep.snap")
    snap.write_snapshot(path, _port_cols(_golden_cols()), NOW)
    for name in (".sweep.snap.tmp.111", ".sweep.snap.tmp.222", "unrelated.tmp"):
        (tmp_path / name).write_bytes(b"torn")
    t = _port_service(snapshot_path=path)
    try:
        assert t.snapshots.restore_result == "ok"
        assert sorted(os.listdir(tmp_path)) == ["sweep.snap", "unrelated.tmp"]
    finally:
        t.close()


# ---------------------------------------------------------------------
# launch counts: one gather per dump, gather + scatter per restore, one
# single-lane scatter per store inject
# ---------------------------------------------------------------------
def test_row_wrapper_calls_per_operation(monkeypatch):
    counts = {"gather": [], "write": []}
    real_g, real_w = buckets.gather_rows, buckets.write_rows
    monkeypatch.setattr(buckets, "gather_rows",
                        lambda h, c, lanes: counts["gather"].append(lanes.shape[1])
                        or real_g(h, c, lanes))
    monkeypatch.setattr(buckets, "write_rows",
                        lambda h, c, lanes, *a: counts["write"].append(lanes.shape[1])
                        or real_w(h, c, lanes, *a))
    before = dict(_kernels.LAUNCHES)
    src = MeshBucketStore(capacity_per_shard=64, device="cpu")
    src.apply([_req(f"m{i}", hits=2) for i in range(12)], NOW)
    cols = src.snapshot_columns(NOW)
    assert counts == {"gather": [12], "write": []} and src.transfer_drain_dispatches == 1
    dst = MeshBucketStore(capacity_per_shard=64, device="cpu")
    assert dst.commit_transfer(cols, NOW) == 12
    assert counts == {"gather": [12, 12], "write": [12]}
    assert dst.transfer_commit_dispatches == 2
    ms = spi.MockStore()
    st = MeshBucketStore(capacity_per_shard=64, device="cpu", store=ms)
    for k in ("a", "b"):
        ms.cache_items[f"snap_{k}"] = spi.CacheItem(
            key=f"snap_{k}", value=spi.TokenBucketItem(limit=10, duration=60_000,
                                                       remaining=4, created_at=NOW),
            expire_at=NOW + 60_000)
    counts["gather"].clear()
    counts["write"].clear()
    r = st.apply([_req("a"), _req("b"), _req("c"), _req("a")], NOW)
    assert [x.remaining for x in r] == [3, 3, 9, 2]
    assert counts == {"gather": [3, 1], "write": [1, 1]}  # a round per duplicate
    assert _kernels.LAUNCHES == before  # CPU tensors reach no kernel
