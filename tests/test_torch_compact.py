"""The compact commit (K10's plain versions) and the one-shard forms
against the JAX package's programs.

`apply_compact32` / `apply_compact_packed` evaluate every lane of a
single-round batch and write the rows of only the lanes listed in
`wlane`.  The port's forms (ops/buckets.py, plain versions on the CPU)
get the same numpy-seeded inputs as the JAX ones: the case of
tests/test_columnar.py::test_compact_commit_matches_rounds_kernel (both
batches), a seeded Zipf single-round plan from the C++ planner with
every write lane listed and with a strict subset of them, on narrow
per-lane columns and on the dict wire.  The JAX one-shard rounds
programs (apply_rounds32, apply_rounds, apply_batch,
apply_rounds_packed[_wide]) are held on a multi-round plan to what the
port's ShardStore runs for them: bucket_rounds_cols /
bucket_rounds_dict on a [1, C, 8] state, and apply_batch.  Everything is
integer, so the tolerance is 0: packed outputs and hot/cold bytes must
be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import buckets as jb
from gubernator_tpu_torch import native
from gubernator_tpu_torch.models.shard import make_columns
from gubernator_tpu_torch.ops import buckets

NOW = 1_700_000_000_000

# The JAX programs, jitted as their stores call them (an eager call
# dispatches op by op).  The state is donated: each call gets its own.
J = {name: jax.jit(getattr(jb, name), static_argnums=static)
     for name, static in (("apply_compact32", ()), ("apply_compact_packed", ()),
                          ("apply_rounds32", (3,)), ("apply_rounds", (3,)),
                          ("apply_batch", ()), ("apply_rounds_packed", (2,)),
                          ("apply_rounds_packed_wide", (2,)))}


def rounds_cols(wide):
    """JAX apply_rounds (wide) / apply_rounds32's counterpart: K2's
    plain version at S = 1 on the batch's per-lane columns."""

    def run(state, req, round_id, n_rounds, now):
        lanes, values = (torch.from_numpy(a) for a in buckets.batch_columns(req, round_id))
        return buckets.bucket_rounds_cols(state.hot, state.cold, lanes, values, n_rounds,
                                          now, wide)[0]

    return run


def rounds_dict(wide):
    """JAX apply_rounds_packed[_wide]'s counterpart: K1's plain version
    at S = 1 on the one-shard wire."""

    def run(state, wire, n_rounds, now):
        return buckets.bucket_rounds_dict(state.hot, state.cold, torch.from_numpy(wire)[None],
                                          n_rounds, now, wide)[0]

    return run


def port_state(hot, cold):
    return buckets.BucketState(torch.tensor(np.asarray(hot)[None]),
                               torch.tensor(np.asarray(cold)[None]))


def same(jstate, jout, tstate, tout):
    assert np.asarray(jout).tobytes() == tout.numpy().tobytes()
    assert np.asarray(jstate.hot).tobytes() == tstate.hot[0].numpy().tobytes()
    assert np.asarray(jstate.cold).tobytes() == tstate.cold[0].numpy().tobytes()


def grouped_plan(ids):
    """A grouped single-round plan: occurrence index within each key's
    group, its last lane writing (test_columnar.py's construction)."""
    B = len(ids)
    slot_of = {k: i for i, k in enumerate(np.unique(ids))}
    slots = np.array([slot_of[k] for k in ids], np.int32)
    occ = np.zeros(B, np.int32)
    seen, last = {}, {}
    for i in range(B):
        seen[ids[i]] = seen.get(ids[i], -1) + 1
        occ[i] = seen[ids[i]]
        last[ids[i]] = i
    write = np.zeros(B, bool)
    write[list(last.values())] = True
    return slots, occ, write


def test_compact_commit_matches_rounds_kernel_case():
    """tests/test_columnar.py's case, both batches: the port's compact
    form equals JAX's, and equals K2 narrow on the same batch."""
    rng = np.random.RandomState(9)
    C, B = 512, 256
    ids = rng.randint(0, 96, size=B)
    slots, occ, write = grouped_plan(ids)

    def cols(exists):
        return (slots, np.full(B, exists, bool), (ids % 2).astype(np.int32),
                np.zeros(B, np.int32), np.ones(B, np.int32), np.full(B, 1000, np.int32),
                np.full(B, 60_000, np.int32))

    wl = np.nonzero(write)[0].astype(np.int32)
    wlane = np.full(128, -1, np.int32)
    wlane[: len(wl)] = wl
    js = jb.init_state(C)
    t = port_state(np.zeros((C, 8), np.int32), np.zeros((C, 8), np.int32))
    r = port_state(np.zeros((C, 8), np.int32), np.zeros((C, 8), np.int32))
    for step, exists in enumerate((False, True)):
        now = NOW + 500 * step
        js, jout = J["apply_compact32"](js, jb.make_batch32(*cols(exists), occ=occ, write=write),
                                      jnp.asarray(wlane), now)
        tout = buckets.apply_compact32(t, buckets.make_batch32(*cols(exists), occ=occ,
                                                               write=write), wlane, now)
        same(js, jout, t, tout)
        rout = rounds_cols(False)(r, buckets.make_batch32(*cols(exists), occ=occ,
                                                          write=write), None, 1, now)
        assert rout.numpy().tobytes() == tout.numpy().tobytes()
        assert r.hot.numpy().tobytes() == t.hot.numpy().tobytes()
        assert r.cold.numpy().tobytes() == t.cold.numpy().tobytes()


def zipf_plan(seed, C, P, n_keys):
    """A single-round plan of Zipf traffic from the C++ planner on a
    C-slot table an earlier batch filled: (slots, exists, occ, write,
    algorithm) plus seeded state rows."""
    rng = np.random.RandomState(seed)
    table = native.NativeSlotTable(C)
    for _ in range(2):
        hot = rng.randint(0, max(n_keys // 10, 1), P)
        ids = np.where(rng.random_sample(P) < 0.8, hot, rng.randint(0, n_keys, P))
        algo = (ids % 2).astype(np.int32)
        cols = make_columns(algo, np.zeros(P, np.int32), np.ones(P, np.int64),
                            np.full(P, 1000, np.int64), np.full(P, 60_000, np.int64), P)
        planner = native.NativeBatchPlanner(table, [f"z{k}" for k in ids], NOW)
        rid, slots, exists, occ, write, n_rounds = planner.plan_grouped(cols, 8)
        planner.commit_plan(np.full(P, NOW + 30_000, np.int64), np.zeros(P, bool))
    assert n_rounds == 1 and not rid.any()
    r = np.random.default_rng(seed)
    hot = np.zeros((C, 8), np.int32)
    cold = np.zeros((C, 8), np.int32)
    hot[:, 0] = r.integers(0, 2, C)  # algorithm
    hot[:, 1] = r.integers(0, 1000, C) << np.where(hot[:, 0] == 1, 20, 0)  # remaining
    hot[:, 3] = (NOW - r.integers(0, 60_000, C)) & 0xFFFFFFFF  # stamp lo
    hot[:, 4] = (NOW - 60_000) >> 32
    exp = NOW + r.integers(-1000, 60_000, C)
    hot[:, 5], hot[:, 6] = (exp & 0xFFFFFFFF).astype(np.uint32).view(np.int32), exp >> 32
    cold[:, 0], cold[:, 2] = 1000, 60_000
    return (slots, exists, occ, write, algo), hot, cold


@pytest.mark.parametrize("subset", [False, True], ids=["every_writer", "half_the_writers"])
@pytest.mark.parametrize("wire", ["cols", "dict"])
def test_compact_forms_match_jax_on_a_zipf_plan(wire, subset):
    P = 2048
    (slots, exists, occ, write, algo), hot, cold = zipf_plan(3, 4096, P, 1500)
    wl = np.nonzero(write)[0].astype(np.int32)
    if subset:
        wl = np.sort(np.random.default_rng(4).choice(wl, wl.size // 3, replace=False))
    wlane = np.full(wl.size + 37, -1, np.int32)
    wlane[: wl.size] = wl
    hits = np.where(algo == 0, 1, 2).astype(np.int32)
    cols = (slots, exists, algo, np.zeros(P, np.int32), hits,
            np.full(P, 1000, np.int32), np.full(P, 60_000, np.int32))
    t = port_state(hot, cold)
    js = jb.BucketState(hot=jnp.asarray(hot), cold=jnp.asarray(cold))
    if wire == "cols":
        js, jout = J["apply_compact32"](js, jb.make_batch32(*cols, occ=occ, write=write),
                                      jnp.asarray(wlane), NOW)
        tout = buckets.apply_compact32(t, buckets.make_batch32(*cols, occ=occ, write=write),
                                       wlane, NOW)
    else:
        mc = make_columns(algo, np.zeros(P, np.int32), hits, cols[5], cols[6], P)
        cfg, table = buckets.build_config_dict(mc, NOW)
        w = buckets.pack_dict_wire(slots[None], exists[None], write[None], cfg[None],
                                   occ[None], np.zeros((1, P), np.int32), table)[0]
        js, jout = J["apply_compact_packed"](js, jnp.asarray(w), jnp.asarray(wlane), NOW)
        tout = buckets.apply_compact_packed(t, w, wlane, NOW)
    same(js, jout, t, tout)
    assert (np.asarray(jout)[1] > 0).any() and t.hot.numpy().any()


def test_compact_lane_quirks_match_jax():
    """The JAX form's handling of odd `wlane` entries: past the batch
    (clipped to its last lane), repeated, negative padding."""
    P = 256
    (slots, exists, occ, write, algo), hot, cold = zipf_plan(5, 1024, P, 200)
    write[-1] = True  # the clipped entries name a writer
    occ[-1] = 0
    slots[-1] = 1023
    wl = np.nonzero(write)[0]
    wlane = np.concatenate([wl, wl[:7], [P, P + 50, -1, -3]]).astype(np.int32)
    cols = (slots, exists, algo, np.zeros(P, np.int32), np.ones(P, np.int32),
            np.full(P, 1000, np.int32), np.full(P, 60_000, np.int32))
    js, jout = J["apply_compact32"](jb.BucketState(hot=jnp.asarray(hot), cold=jnp.asarray(cold)),
                                  jb.make_batch32(*cols, occ=occ, write=write),
                                  jnp.asarray(wlane), NOW)
    t = port_state(hot, cold)
    tout = buckets.apply_compact32(t, buckets.make_batch32(*cols, occ=occ, write=write),
                                   wlane, NOW)
    same(js, jout, t, tout)


# ---------------------------------------------------------------------
# the one-shard rounds forms
# ---------------------------------------------------------------------
def multi_round_plan(rng, C, P, rounds):
    slots = np.full(P, -1, np.int32)
    rid = np.zeros(P, np.int32)
    used = P * 7 // 8
    rid[:used] = rng.integers(0, rounds, used)
    for r in range(rounds):
        sel = np.nonzero(rid[:used] == r)[0]
        slots[sel] = rng.choice(C, sel.size, replace=False)
    return slots, rid


@pytest.mark.parametrize("seed", [0, 1])
def test_one_shard_rounds_forms_match_jax(seed):
    rng = np.random.default_rng(seed)
    C, P, R = 512, 256, 3
    (slots, exists, occ, write, algo), hot, cold = zipf_plan(seed, C, P, 300)
    slots, rid = multi_round_plan(rng, C, P, R)
    beh = np.where(rng.random(P) < 0.1, 8, 0).astype(np.int32)
    hits = rng.integers(0, 4, P)
    limit = rng.choice([5, 10, 1000], P)
    dur = rng.choice([1000, 60_000], P)
    greg = rng.random(P) < 0.1
    beh = np.where(greg, beh | 4, beh).astype(np.int32)
    gd = np.where(greg, 86_400_000, 0)
    ge = np.where(greg, NOW + rng.integers(1, 86_400_000, P), 0)
    base = (slots, exists, algo, beh)

    def run(jfn, tfn, jbatch, tbatch, *args):
        js, jout = jfn(jb.BucketState(hot=jnp.asarray(hot), cold=jnp.asarray(cold)),
                       jbatch, *args)
        t = port_state(hot, cold)
        tout = tfn(t, tbatch, *args)
        return js, jout, t, tout

    # apply_rounds32: narrow columns, greg expiry as a delta
    b32 = (*base, hits, limit, dur, np.where(greg, ge - NOW, 0), gd)
    same(*run(J["apply_rounds32"], rounds_cols(False),
              jb.make_batch32(*b32, occ=occ, write=write),
              buckets.make_batch32(*b32, occ=occ, write=write),
              jnp.asarray(rid), R, NOW))
    # apply_rounds: wide columns, a limit past int32
    b64 = (*base, hits, np.where(rng.random(P) < 0.2, 2**40, limit), dur, ge, gd)
    js, jout, t, tout = run(J["apply_rounds"], rounds_cols(True),
                            jb.make_batch(*b64, occ=occ, write=write),
                            buckets.make_batch(*b64, occ=occ, write=write),
                            jnp.asarray(rid), R, NOW)
    same(js, jout, t, tout)
    # apply_batch: one round, every lane its own group (no occ/write)
    one = np.unique(slots[slots >= 0], return_index=True)[1]
    s1 = np.full(P, -1, np.int32)
    s1[one] = slots[slots >= 0][np.arange(one.size)]
    b1 = (s1, exists, algo, beh, hits, limit, dur, ge, gd)
    js, jout = J["apply_batch"](jb.BucketState(hot=jnp.asarray(hot), cold=jnp.asarray(cold)),
                              jb.make_batch(*b1), NOW)
    t = port_state(hot, cold)
    tout = buckets.apply_batch(t, buckets.make_batch(*b1), NOW)
    for f in ("status", "limit", "remaining", "reset_time", "new_expire", "removed"):
        a, b = np.asarray(getattr(jout, f)), getattr(tout, f)
        assert np.array_equal(a, b), f
    assert np.asarray(js.hot).tobytes() == t.hot[0].numpy().tobytes()
    assert np.asarray(js.cold).tobytes() == t.cold[0].numpy().tobytes()
    # apply_rounds_packed[_wide]: the dict wire
    mc = make_columns(algo, beh, hits, limit, dur, P, ge, gd)
    cfg, table = buckets.build_config_dict(mc, NOW)
    w = buckets.pack_dict_wire(s1[None], exists[None], np.ones((1, P), bool), cfg[None],
                               np.zeros((1, P)), np.zeros((1, P), np.int32), table)[0]
    for jfn, tfn in ((J["apply_rounds_packed"], rounds_dict(False)),
                     (J["apply_rounds_packed_wide"], rounds_dict(True))):
        js, jout = jfn(jb.BucketState(hot=jnp.asarray(hot), cold=jnp.asarray(cold)),
                       jnp.asarray(w), 1, NOW)
        t = port_state(hot, cold)
        same(js, jout, t, tfn(t, w, 1, NOW))
    packed = rounds_dict(True)(port_state(hot, cold), w, 1, NOW).numpy()
    for a, b in zip(jb.unpack_output(packed), buckets.unpack_output(packed)):
        assert np.array_equal(np.asarray(a), b)
