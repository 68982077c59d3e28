"""The port's plain bucket-rounds versions against the JAX programs.

Every case seeds both sides from one random bucket state (numpy, then
`state_from_numpy` for the port) and one request batch, runs the JAX
package's per-shard program vmapped over S = 8 shards exactly as
parallel/mesh.py does (`_rounds_packed_mesh`, `_rounds_packed_wide_mesh`,
`_rounds32_mesh_jit`, `_rounds64_mesh_jit`) and the port's
`bucket_rounds_dict` / `bucket_rounds_cols` on CPU tensors, and compares
the packed outputs and the state bytes.  All arithmetic is integer:
tolerance 0, the comparison is bit-exact.

The cases cover what tests/test_algorithms.py pins: expiry at the exact
ms, a non-representable leaky rate, a huge limit (the 128-bit leak
division, mixed with fast-path lanes in one batch), duplicate keys
(analytic occurrence groups and several rounds), padding lanes,
algorithm switches, RESET_REMAINING, daily and monthly Gregorian
windows and the narrow output's -2 keep-sentinel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import buckets as jb
from gubernator_tpu.parallel import mesh as jmesh
from gubernator_tpu.utils import gregorian
from gubernator_tpu_torch.ops import buckets as tb

NOW = 1_573_430_430_000
S = 8
SCALE = 1 << 20
MONTH = 31 * 24 * 3600 * 1000


def _split(v):
    v = np.asarray(v, np.int64)
    return (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32), (v >> 32).astype(np.int32)


def random_state(rng, C, wide=False):
    """Bucket rows in the domain the store produces: remaining within
    [0, limit] (leaky scaled), stamps and expiries around NOW (some at
    exactly NOW, some expired, some free), and a few far-future expiries
    that the narrow output cannot carry."""
    n = S * C
    algo = rng.integers(0, 2, n)
    status = rng.integers(0, 2, n)
    lim_hi = 2**40 if wide else 200
    limit = np.where(rng.random(n) < 0.8, rng.integers(0, 200, n), rng.integers(0, lim_hi, n))
    duration = rng.choice([1000, 30_000, 60_000, 3_600_000], n)
    rem = (rng.random(n) * (limit + 1)).astype(np.int64)
    rem = np.where(algo == 1, rem * SCALE + rng.integers(0, SCALE, n), rem)
    stamp = NOW - rng.integers(0, 2 * 3_600_000, n)
    expire = NOW + rng.integers(-60_000, 3_600_000, n)
    pick = rng.random(n)
    expire = np.where(pick < 0.05, NOW, expire)
    expire = np.where((pick >= 0.05) & (pick < 0.1), NOW - 1, expire)
    expire = np.where((pick >= 0.1) & (pick < 0.15), 0, expire)
    expire = np.where((pick >= 0.15) & (pick < 0.2), NOW + (1 << 40), expire)
    hot = np.zeros((n, 8), np.int32)
    cold = np.zeros((n, 8), np.int32)
    hot[:, 0] = (algo & 3) | ((status & 1) << 2)
    hot[:, 1], hot[:, 2] = _split(rem)
    hot[:, 3], hot[:, 4] = _split(stamp)
    hot[:, 5], hot[:, 6] = _split(expire)
    cold[:, 0], cold[:, 1] = _split(limit)
    cold[:, 2], cold[:, 3] = _split(duration)
    return hot.reshape(S, C, 8), cold.reshape(S, C, 8)


def random_configs(rng, k, wide=False, greg=None):
    """k configs: columns (algo, behavior, hits, limit, duration,
    greg_expire, greg_duration) as int64 arrays."""
    algo = rng.integers(0, 2, k)
    behavior = np.where(rng.random(k) < 0.15, 8, 0)  # RESET_REMAINING
    hits = rng.choice([0, 1, 1, 1, 2, 3, 5, 50], k)
    limit = rng.choice([0, 1, 5, 10, 30, 100, 199], k)
    duration = rng.choice([1000, 30_000, 60_000, 3_600_000], k)
    ge = np.zeros(k, np.int64)
    gd = np.zeros(k, np.int64)
    if wide:
        big = rng.random(k) < 0.4
        limit = np.where(big, 2**42, limit)
        hits = np.where(big & (rng.random(k) < 0.5), 2**41, hits)
        # rn >= 2**43 forces the 128-bit leak division on these lanes.
        duration = np.where(big & (rng.random(k) < 0.5), 2**44, duration)
    if greg is not None:
        # Gregorian windows: greg_expire/duration as the host resolves them.
        import datetime as dt

        now_dt = dt.datetime.fromtimestamp(NOW / 1000, tz=dt.timezone.utc)
        on = rng.random(k) < 0.5
        ge_v = gregorian.gregorian_expiration(now_dt, greg)
        gd_v = gregorian.gregorian_duration(now_dt, greg)
        behavior = np.where(on, behavior | 4, behavior)
        duration = np.where(on, greg, duration)
        ge = np.where(on, ge_v, 0)
        gd = np.where(on, gd_v, 0)
    return [np.asarray(c, np.int64) for c in (algo, behavior, hits, limit, duration, ge, gd)]


def random_plan(rng, C, P, n_cfg, rounds=1, pad_frac=0.2):
    """Per-shard lanes the grouped planner could emit: within a round
    each slot belongs to one uniform group (consecutive occ, one config,
    only the last occurrence writes); later rounds may revisit slots.
    Returns [S, P] arrays slot, exists, write, cfg, occ, rid."""
    slot = np.full((S, P), -1, np.int32)
    exists = np.zeros((S, P), np.uint8)
    write = np.zeros((S, P), np.uint8)
    cfg = np.zeros((S, P), np.int64)
    occ = np.zeros((S, P), np.int32)
    rid = np.zeros((S, P), np.int32)
    for s in range(S):
        j = 0
        used = int(P * (1 - pad_frac))
        r = 0
        taken = set()
        while j < used:
            if rounds > 1 and rng.random() < 0.3:
                r = (r + 1) % rounds
            m = int(min(rng.choice([1, 1, 1, 2, 3, 5]), used - j))
            sl = int(rng.integers(0, C))
            if (r, sl) in taken:
                continue
            taken.add((r, sl))
            c = int(rng.integers(0, n_cfg))
            ex = int(rng.random() < 0.8)
            for o in range(m):
                slot[s, j] = sl
                exists[s, j] = ex
                cfg[s, j] = c
                occ[s, j] = o
                write[s, j] = int(o == m - 1)
                rid[s, j] = r
                j += 1
        perm = rng.permutation(P)  # lanes of a group need not be adjacent
        for a in (slot, exists, write, cfg, occ, rid):
            a[s] = a[s][perm]
    return slot, exists, write, cfg, occ, rid


def _jax_state(hot, cold):
    return jb.BucketState(hot=jnp.asarray(hot), cold=jnp.asarray(cold))


def _compare(jstate, jout, hot_t, cold_t, tout):
    np.testing.assert_array_equal(np.asarray(jout), tout.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.hot), hot_t.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.cold), cold_t.numpy())


def run_dict_case(seed, wide, C=64, P=64, n_cfg=12, rounds=1, greg=None):
    rng = np.random.default_rng(seed)
    hot, cold = random_state(rng, C, wide=wide)
    cfgs = random_configs(rng, n_cfg, wide=wide, greg=greg)
    slot, exists, write, cfg, occ, rid = random_plan(rng, C, P, n_cfg, rounds)
    # the dict table carries greg_expire as a delta from now
    table = list(cfgs)
    table[5] = np.where(cfgs[6] != 0, cfgs[5] - NOW, 0)
    table = [np.concatenate([t, np.zeros(256 - n_cfg, np.int64)]) for t in table]
    wire = tb.pack_dict_wire(slot, exists, write, cfg, occ, rid, table)
    np.testing.assert_array_equal(
        wire, jb.pack_dict_wire(slot, exists, write, cfg, occ, rid, table))
    n_rounds = int(rid.max()) + 1
    fn = jmesh._rounds_packed_wide_mesh if wide else jmesh._rounds_packed_mesh
    jstate, jout = jax.jit(fn)(_jax_state(hot, cold), jnp.asarray(wire), n_rounds, NOW)
    st = tb.state_from_numpy(hot, cold, "cpu")
    tout = tb.bucket_rounds_dict(st.hot, st.cold, torch.from_numpy(wire), n_rounds, NOW, wide)
    _compare(jstate, jout, st.hot, st.cold, tout)
    return np.asarray(jout)


def run_cols_case(seed, wide, C=64, P=64, n_cfg=300, rounds=2, greg=None):
    rng = np.random.default_rng(seed)
    hot, cold = random_state(rng, C, wide=wide)
    cfgs = random_configs(rng, n_cfg, wide=wide, greg=greg)
    slot, exists, write, cfg, occ, rid = random_plan(rng, C, P, n_cfg, rounds)
    vals = [c[cfg] for c in cfgs]  # per-lane columns, [S, P] each
    if not wide:  # narrow wire: greg_expire as a delta, i32 values
        vals[5] = np.where(vals[6] != 0, vals[5] - NOW, 0)
    vdt = np.int64 if wide else np.int32
    n_rounds = int(rid.max()) + 1
    if wide:
        batch = jb.make_batch(slot, exists.astype(bool), vals[0], vals[1], *vals[2:7],
                              occ=occ, write=write.astype(bool))
        fn = jmesh._rounds64_mesh_jit
    else:
        batch = jb.make_batch32(slot, exists.astype(bool), vals[0], vals[1], *vals[2:7],
                                occ=occ, write=write.astype(bool))
        fn = jmesh._rounds32_mesh_jit
    jstate, jout = fn(_jax_state(hot, cold), batch, jnp.asarray(rid), n_rounds, NOW)
    lanes = np.stack([slot, exists | (write << 1), vals[0], vals[1], occ, rid],
                     axis=1).astype(np.int32)
    values = np.stack(vals[2:7], axis=1).astype(vdt)
    st = tb.state_from_numpy(hot, cold, "cpu")
    tout = tb.bucket_rounds_cols(st.hot, st.cold, torch.from_numpy(lanes),
                                 torch.from_numpy(values), n_rounds, NOW, wide)
    _compare(jstate, jout, st.hot, st.cold, tout)
    return np.asarray(jout)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_dict_random(seed, wide):
    run_dict_case(seed, wide)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_dict_duplicate_rounds(wide):
    out = run_dict_case(10, wide, rounds=4)
    assert out.shape == (S, 4, 64)


@pytest.mark.parametrize("greg", [gregorian.GREGORIAN_DAYS, gregorian.GREGORIAN_MONTHS],
                         ids=["daily", "monthly"])
def test_dict_gregorian(greg):
    # daily deltas fit the narrow output, monthly ones need the wide one
    run_dict_case(20, greg == gregorian.GREGORIAN_MONTHS, greg=greg)
    if greg == gregorian.GREGORIAN_DAYS:
        run_dict_case(21, True, greg=greg)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_cols_random(seed, wide):
    run_cols_case(seed, wide)


def test_cols_gregorian_monthly_wide():
    run_cols_case(22, True, greg=gregorian.GREGORIAN_MONTHS)


def test_narrow_keep_sentinel_fires():
    """A live far-future expiry passed through unchanged comes back as
    -2, and that case occurs in the random batches above."""
    seen = 0
    for seed in range(3):
        seen += int((run_dict_case(seed, False)[:, 2:4] == -2).sum())
    assert seen > 0


def _single_lane_case(hot_row, cold_row, cfg, now, wide, exists=1, occ=0, write=1):
    """One lane on shard 0 slot 0 (the rest padding) through both
    sides; returns the port's packed output of that lane."""
    C, P = 4, 4
    hot = np.zeros((S, C, 8), np.int32)
    cold = np.zeros((S, C, 8), np.int32)
    hot[0, 0] = hot_row
    cold[0, 0] = cold_row
    slot = np.full((S, P), -1, np.int32)
    slot[0, 0] = 0
    z = np.zeros((S, P), np.int32)
    ex = z.copy()
    ex[0, 0] = exists
    wr = z.copy()
    wr[0, 0] = write
    oc = z.copy()
    oc[0, 0] = occ
    table = [np.zeros(256, np.int64) for _ in range(7)]
    for k, v in enumerate(cfg):
        table[k][0] = v
    table[5][0] = cfg[5] - now if cfg[6] else 0
    wire = tb.pack_dict_wire(slot, ex, wr, z, oc, z, table)
    fn = jmesh._rounds_packed_wide_mesh if wide else jmesh._rounds_packed_mesh
    jstate, jout = jax.jit(fn)(_jax_state(hot, cold), jnp.asarray(wire), 1, now)
    st = tb.state_from_numpy(hot, cold, "cpu")
    tout = tb.bucket_rounds_dict(st.hot, st.cold, torch.from_numpy(wire), 1, now, wide)
    _compare(jstate, jout, st.hot, st.cold, tout)
    return tout[0, :, 0].tolist(), st.hot[0, 0].tolist()


def _row(algo, rem, stamp, expire, status=0):
    h = np.zeros(8, np.int32)
    h[0] = algo | (status << 2)
    h[1], h[2] = _split(rem)
    h[3], h[4] = _split(stamp)
    h[5], h[6] = _split(expire)
    return h


def _cold(limit, duration):
    c = np.zeros(8, np.int32)
    c[0], c[1] = _split(limit)
    c[2], c[3] = _split(duration)
    return c


def test_expiry_at_exact_ms_is_live():
    # token bucket drained to 0 that expires exactly now: still live
    out, _ = _single_lane_case(_row(0, 0, NOW - 1000, NOW), _cold(2, 1000),
                               (0, 0, 1, 2, 1000, 0, 0), NOW, False)
    assert out[0] & 1 == 1  # OVER_LIMIT from the drained bucket
    out, _ = _single_lane_case(_row(0, 0, NOW - 1001, NOW - 1), _cold(2, 1000),
                               (0, 0, 1, 2, 1000, 0, 0), NOW, False)
    assert out[0] & 1 == 0 and out[1] == 1  # expired: recreated


def test_leaky_nonrepresentable_rate_is_exact():
    # limit 30 per 1000 ms drained at NOW-500: exactly 15 tokens leak back
    out, _ = _single_lane_case(_row(1, 0, NOW - 500, NOW + 500), _cold(30, 1000),
                               (1, 0, 0, 30, 1000, 0, 0), NOW, False)
    assert out[1] == 15


def test_leaky_huge_limit_takes_128_bit_division():
    big, month = 2**42, 30 * 24 * 3600 * 1000
    dur = 2**44  # rn >= 2**43: the 128-bit branch
    out, _ = _single_lane_case(_row(1, 0, NOW - dur // 2, NOW + dur), _cold(big, dur),
                               (1, 0, 0, big, dur, 0, 0), NOW, True)
    assert out[1] == big // 2
    out, _ = _single_lane_case(_row(1, 0, NOW - month // 2, NOW + month),
                               _cold(big, month), (1, 0, 0, big, month, 0, 0), NOW, True)
    assert abs(out[1] - big // 2) <= 1


def test_algorithm_switch_recreates():
    # a live token row hit with a leaky request is recreated as leaky
    out, hot = _single_lane_case(_row(0, 3, NOW - 10, NOW + 5000), _cold(10, 5000),
                                 (1, 0, 1, 10, 5000, 0, 0), NOW, False)
    assert hot[0] & 3 == 1 and out[1] == 9


def test_reset_remaining_token_removes():
    out, hot = _single_lane_case(_row(0, 3, NOW - 10, NOW + 5000), _cold(10, 5000),
                                 (0, 8, 1, 10, 5000, 0, 0), NOW, False)
    assert out[0] == 2  # removed bit, UNDER_LIMIT
    assert out[3] == -1  # new expiry is an absolute 0


def test_decode_narrow_matches_jax():
    """Host decode of a narrow result: -1 / -2 sentinels, the -2 case
    taking the slot table's expiry while the slot maps the lane's key."""
    from gubernator_tpu import native as jnative
    from gubernator_tpu.models.shard import decode_narrow as jdecode
    from gubernator_tpu_torch import native as tnative
    from gubernator_tpu_torch.models.shard import decode_narrow as tdecode

    keys = [f"k{i}" for i in range(6)]
    slots = np.arange(6, dtype=np.int32)
    expire = NOW + np.arange(6, dtype=np.int64) * (1 << 33)
    pn = np.array([[0, 1, 2, 3, 0, 1],
                   [5, 0, 7, 2**31 - 1, 1, 0],
                   [-1, -2, 10, -2, 0, -2],
                   [-2, -1, 20, 5, -2, 3]], np.int32)
    passthrough = np.full(6, 12345, np.int64)
    lookup = keys[:4] + ["other", "k5"]  # lane 4's slot maps another key
    out = []
    for mod, decode in ((jnative, jdecode), (tnative, tdecode)):
        t = mod.NativeSlotTable(16)
        t.commit(slots, expire, np.zeros(6, np.uint8), keys=keys)
        out.append(decode(t, lookup, slots, pn, NOW, passthrough))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert out[1][3][1] == expire[1] and out[1][3][0] == 0
