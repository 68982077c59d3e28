"""The port's CUDA kernels, compiled by g++ against a CPU stand-in of
the CUDA runtime (tests/cuda_emu/cuda_runtime.h), against their plain
PyTorch versions: the same seeded cases as tests/test_torch_kernels.py
(K1 and K2 narrow and wide; K3-K6 of the GLOBAL plane; the row gather
K7 and row scatter K8; the tier move K9; the compact commit K10),
tolerance 0.

This holds the kernels' device logic (the cooperative rounds kernel
with its grid barriers, held lanes and re-read lanes, each branch of
the lane evaluation at its edges, the replica answer, the sync, the
scatters, the row composition and split, the tier move's one
cooperative launch with the quarters past its shared memory spilled, the
compact commit over the listed write lanes) on a machine
with no card, where the cuda-marked tests skip.  The stand-in runs the
threads of a launch one after another (a cooperative launch as fibers
that meet at each grid barrier; GT_EMU_SMS sets its grid), so it shows
no race and nothing of what nvcc does; the card runs of
tests/test_torch_kernels.py and chip_smoke.py remain the test of the
built kernels.  It is built with -fwrapv: int64 arithmetic that
overflows wraps, as on the card and in the plain versions."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "gubernator_tpu_torch", "csrc")
EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")
# `kernel<<<grid, block, 0, stream>>>(` and, for a kernel of no
# arguments, `kernel<<<...>>>()`
LAUNCH = re.compile(r"([\w:]+(?:<[\w:, ]+>)?)<<<(.+?)>>>\((\))?", re.S)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel wrappers of ops/_kernels.py bound to the g++ build of
    csrc/*.cu, taking CPU tensors."""
    from gubernator_tpu_torch.ops import _kernels

    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build the emulated kernels")
    out = tmp_path_factory.mktemp("cuda_emu")
    sources = []
    for src in _kernels.SOURCES:
        with open(src) as f:
            text = LAUNCH.sub(lambda m: f"gt_emu_launch({m.group(2)}, {m.group(1)}"
                              + (")" if m.group(3) else ", "), f.read())
        path = out / (os.path.basename(src) + ".cpp")
        path.write_text(text)
        sources.append(str(path))
    lib_path = str(out / "kernels_emu.so")
    subprocess.run(["g++", "-std=c++17", "-O1", "-fno-strict-aliasing", "-fwrapv", "-shared",
                    "-fPIC", "-I", EMU, "-I", CSRC, *sources, "-o", lib_path],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    for fn, argtypes in _kernels._SIGNATURES.items():
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = argtypes
    mp = pytest.MonkeyPatch()
    mp.setattr(_kernels, "_lib", lib)
    mp.setattr(_kernels, "_stream", lambda device: 0)
    mp.setattr(_kernels, "_require_card", lambda what, device: None)
    mp.setattr(_kernels, "LAUNCHES", dict.fromkeys(_kernels.LAUNCHES, 0))  # counts of its own
    yield _kernels
    mp.undo()


def _same(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("kind", ["dict", "cols"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emulated_kernel_matches_plain(emulated, kind, wide, seed):
    import torch

    from chip_smoke import NOW, make_case
    from gubernator_tpu_torch.ops import buckets

    hot, cold, args, n_rounds = make_case(seed, 512, 256, 1 + seed, wide, kind,
                                          12 if kind == "dict" else 300)
    kernel = emulated.bucket_rounds_dict if kind == "dict" else emulated.bucket_rounds_cols
    plain = (buckets.bucket_rounds_dict_plain if kind == "dict"
             else buckets.bucket_rounds_cols_plain)
    before = emulated.LAUNCHES[kernel.__name__]
    runs = []
    for fn in (kernel, plain):
        h, c = torch.tensor(hot), torch.tensor(cold)
        out = fn(h, c, *[torch.tensor(a) for a in args], n_rounds, NOW, wide)
        runs.append([t.numpy() for t in (out, h, c)])
    _same(*runs)
    assert emulated.LAUNCHES[kernel.__name__] == before + 1


@pytest.mark.parametrize("kind", ["answer", "sync", "replica", "clear"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emulated_global_kernel_matches_plain(emulated, kind, seed):
    import torch

    from chip_smoke import NOW, global_case, run_global
    from gubernator_tpu_torch.ops import global_ops

    case = global_case(kind, seed, 256, 64, 128 if kind == "answer" else 32, 1 + seed)
    want = run_global(torch, "cpu", kind, case, plain=True)
    hot, cold, gc, args = case
    h, c = torch.tensor(hot), torch.tensor(cold)
    g = global_ops.global_columns_from_numpy(gc, "cpu")
    a = [torch.tensor(x) if isinstance(x, np.ndarray) else x for x in args]
    if kind == "answer":
        out = [emulated.global_answer_rounds(h, c, g, *a[:3], a[3], NOW)]
    elif kind == "sync":
        out = [emulated.global_sync(h, c, g, *a, NOW)]
    else:
        (emulated.set_replica if kind == "replica" else emulated.clear_gslots)(g, a[0])
        out = []
    _same([t.numpy() for t in (*out, h, c, *g)], want)


@pytest.mark.parametrize("K", [37, 300])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("shards", [1, 8])
def test_emulated_clear_kernel_lists(emulated, shards, order, K):
    """K6 (one thread per column, shard and entry) on clear lists sorted
    as the stores hand them over and in any order, with repeated
    entries, padding at G and past it, K not a multiple of the block
    (37, and 300 over blocks of 256), at S = 1 and S = 8."""
    import torch

    from chip_smoke import random_gcols
    from gubernator_tpu_torch.ops import global_ops

    rng = np.random.default_rng(30 + K + shards)
    G = 64
    gc = [np.ascontiguousarray(c[:shards]) for c in random_gcols(rng, G)]
    idx = rng.integers(0, G, K)
    idx[rng.random(K) < 0.15] = G + rng.integers(0, 9)
    idx[:4] = idx[4]
    if order == "sorted":
        idx.sort()
    got, want = (global_ops.global_columns_from_numpy(gc, "cpu") for _ in range(2))
    before = emulated.LAUNCHES["clear_gslots"]
    emulated.clear_gslots(got, torch.tensor(idx))
    global_ops.clear_gslots_plain(want, torch.tensor(idx))
    _same([t.numpy() for t in got], [t.numpy() for t in want])
    assert emulated.LAUNCHES["clear_gslots"] == before + 1
    cleared = np.unique(idx[idx < G])
    assert all(not t.numpy()[:, cleared].any() for t in got)


@pytest.mark.parametrize("kind", ["gather", "write"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emulated_row_kernel_matches_plain(emulated, kind, seed):
    import torch

    from chip_smoke import rows_case, run_rows

    case = rows_case(seed, 64, 300)
    want = run_rows(torch, "cpu", kind, case, plain=True)
    hot, cold, lanes, c32, c64, keep = case
    h, c = torch.tensor(hot), torch.tensor(cold)
    before = emulated.LAUNCHES[f"{kind}_rows"]
    if kind == "gather":
        out = list(emulated.gather_rows(h, c, torch.tensor(lanes)))
    else:
        emulated.write_rows(h, c, *[torch.tensor(np.ascontiguousarray(a[:, keep]))
                                    for a in (lanes, c32, c64)])
        out = []
    _same([t.numpy() for t in (*out, h, c)], want)
    assert emulated.LAUNCHES[f"{kind}_rows"] == before + 1


@pytest.mark.parametrize("reverse", [False, True], ids=["in_order", "reversed"])
@pytest.mark.parametrize("seed,C,Cb,n_demo,n_promo", [
    (0, 64, 256, 20, 15), (1, 64, 64, 40, 30), (2, 32, 512, 0, 12), (3, 32, 16, 9, 0)])
def test_emulated_moves_kernel_matches_plain(emulated, reverse, seed, C, Cb, n_demo, n_promo):
    """K9 with both hazards of a window (a demoted front slot reused by a
    promotion, a kind-1 promotion reading a demotion's source) and dead
    records, the records in either order."""
    import torch

    from chip_smoke import moves_case, run_moves

    case = moves_case(seed, C, Cb, n_demo, n_promo)
    want = run_moves(torch, "cpu", case, plain=True)
    *tiers, records = case
    if reverse:
        records = np.ascontiguousarray(records[:, ::-1])
    t = [torch.tensor(a) for a in tiers]
    before = emulated.LAUNCHES["apply_moves"]
    emulated.apply_moves(*t, torch.tensor(records))
    _same([x.numpy() for x in t], want)
    assert emulated.LAUNCHES["apply_moves"] == before + 1


@pytest.mark.parametrize("reverse", [False, True], ids=["in_order", "reversed"])
@pytest.mark.parametrize("seed", [4, 5])
def test_emulated_moves_kernel_past_held_quarters(emulated, monkeypatch, reverse, seed):
    """K9 on one resident block (512 threads, 4 quarters each: 512
    records held in shared memory) with a window of 886 records: the
    quarters past the held ones go through the spill buffer, gathered
    before the grid barrier and stored after it, with both hazards of a
    window and the records in either order."""
    import torch

    from chip_smoke import moves_case, run_moves

    monkeypatch.setenv("GT_EMU_SMS", "1")
    case = moves_case(seed, 256, 1024, 60, 50)
    *tiers, records = case
    N = records.shape[1]
    assert emulated.moves_spill(N) == 4 * N - 4 * 512 > 0
    want = run_moves(torch, "cpu", case, plain=True)
    if reverse:
        records = np.ascontiguousarray(records[:, ::-1])
    t = [torch.tensor(a) for a in tiers]
    before = emulated.LAUNCHES["apply_moves"]
    emulated.apply_moves(*t, torch.tensor(records))
    _same([x.numpy() for x in t], want)
    assert emulated.LAUNCHES["apply_moves"] == before + 1


def _global_rounds_case(seed, G=64, P=256, n_rounds=4):
    """chip_smoke.global_case's answer batch (S = 8, 256 slots, G
    gslots, P lanes a shard, GLOBAL keys repeated across rounds, live,
    expired and just-expiring replica entries, negative hits) with a
    twentieth of its GLOBAL lanes sent to gslots past G (their hits
    dropped, the cached test at gslot G - 1)."""
    from chip_smoke import global_case

    hot, cold, gc, (lanes, values, gslot, nr) = global_case("answer", seed, 256, G, P,
                                                            n_rounds)
    rng = np.random.default_rng(seed + 1000)
    far = (gslot >= 0) & (rng.random(gslot.shape) < 0.05)
    gslot = np.where(far, G + rng.integers(0, 3, gslot.shape), gslot).astype(np.int32)
    assert far.any() and nr == n_rounds
    return hot, cold, gc, (lanes, values, gslot, nr)


@pytest.mark.parametrize("sms", ["1", "4"])
@pytest.mark.parametrize("seed", [6, 7])
def test_emulated_answer_rounds_past_held_lanes(emulated, monkeypatch, sms, seed):
    """K3 in four rounds whose GLOBAL keys repeat across rounds; on one
    resident block (GT_EMU_SMS=1: 512 lanes held of 2,048) most lanes
    are read again each round and their writers evaluated again in the
    write half.  Outputs, rows and replica columns equal the plain
    version's, and each GLOBAL lane's hits are added to ghits exactly
    once (in-range gslots only)."""
    import torch

    from chip_smoke import NOW, S, run_global
    from gubernator_tpu_torch.ops import global_ops

    monkeypatch.setenv("GT_EMU_SMS", sms)
    case = _global_rounds_case(seed)
    hot, cold, gc, (lanes, values, gslot, nr) = case
    blocks, held = emulated.answer_launch_shape(lanes.shape[0] * lanes.shape[2])
    assert (blocks, held) == (int(sms), int(sms) * 256 * 2)
    want = run_global(torch, "cpu", "answer", case, plain=True)
    h, c = torch.tensor(hot), torch.tensor(cold)
    g = global_ops.global_columns_from_numpy(gc, "cpu")
    out = emulated.global_answer_rounds(h, c, g, torch.tensor(lanes), torch.tensor(values),
                                        torch.tensor(gslot), nr, NOW)
    _same([t.numpy() for t in (out, h, c, *g)], want)
    ghits = gc[5].copy()
    live = (gslot >= 0) & (gslot < gc[5].shape[1]) & (lanes[:, 5] < nr)
    for s in range(S):
        np.add.at(ghits[s], gslot[s][live[s]], values[s, 0][live[s]])
    assert np.array_equal(g.ghits.numpy(), ghits)


def test_emulated_launch_floor(emulated):
    """The empty kernels of the launch floor launch, plain and as a
    cooperative launch with its grid barrier, and count nowhere."""
    before = dict(emulated.LAUNCHES)
    emulated.launch_floor(False, 2, "cpu")
    emulated.launch_floor(True, 2, "cpu")
    assert emulated.LAUNCHES == before


def test_emulated_back_row_gather_counts_apart(emulated):
    """K7 on a back tier (ops/buckets.py read_back_rows) counts under its
    own name."""
    import torch

    from chip_smoke import rows_case, run_rows

    hot, cold, lanes, *_ = case = rows_case(5, 64, 300)
    want = run_rows(torch, "cpu", "gather", case, plain=True)
    h, c = torch.tensor(hot), torch.tensor(cold)
    before = dict(emulated.LAUNCHES)
    out = emulated.gather_rows(h, c, torch.tensor(lanes), count="gather_back_rows")
    _same([t.numpy() for t in (*out, h, c)], want)
    assert emulated.LAUNCHES["gather_back_rows"] == before["gather_back_rows"] + 1
    assert emulated.LAUNCHES["gather_rows"] == before["gather_rows"]


@pytest.mark.parametrize("kind", ["dict", "cols"])
@pytest.mark.parametrize("seed,subset", [(0, False), (1, True), (2, False), (3, True)])
def test_emulated_compact_kernel_matches_plain(emulated, kind, seed, subset):
    """K10 on a one-shard single-round batch, every write lane listed or
    half of them."""
    import torch

    from chip_smoke import NOW, compact_case, run_compact

    case = compact_case(seed, 512, 256, kind, 12 if kind == "dict" else 300, subset=subset)
    want = run_compact(torch, "cpu", kind, case, plain=True)
    hot, cold, args, wlane = case
    h, c = torch.tensor(hot), torch.tensor(cold)
    src = dict(wire=torch.tensor(args[0])) if kind == "dict" else dict(
        lanes=torch.tensor(args[0]), values=torch.tensor(args[1]))
    before = emulated.LAUNCHES["bucket_compact"]
    out = emulated.bucket_compact(h, c, torch.tensor(wlane), NOW, **src)
    _same([t.numpy() for t in (out, h, c)], want)
    assert emulated.LAUNCHES["bucket_compact"] == before + 1


def test_emulated_compact_kernel_keeps_the_wlane_quirks(emulated):
    """The JAX form's quirks: an entry past the batch stands for its last
    lane, a repeated entry writes the same row again, a negative entry
    writes nothing, an empty list commits nothing."""
    import torch

    from chip_smoke import NOW, compact_case, run_compact

    hot, cold, args, wlane = compact_case(7, 512, 256, "dict", 12)
    listed = wlane[0][wlane[0] >= 0]
    odd = np.concatenate([listed, listed[:5], [256, 10_000, -1, -7]]).astype(np.int32)
    for wl in (odd[None], np.zeros((1, 0), np.int32)):
        case = (hot, cold, args, np.ascontiguousarray(wl))
        want = run_compact(torch, "cpu", "dict", case, plain=True)
        h, c = torch.tensor(hot), torch.tensor(cold)
        out = emulated.bucket_compact(h, c, torch.tensor(case[3]), NOW,
                                      wire=torch.tensor(args[0]))
        _same([t.numpy() for t in (out, h, c)], want)


def _compact_src(kind, args):
    import torch

    return dict(wire=torch.tensor(args[0])) if kind == "dict" else dict(
        lanes=torch.tensor(args[0]), values=torch.tensor(args[1]))


@pytest.mark.parametrize("kind", ["dict", "cols"])
@pytest.mark.parametrize("subset", [False, True], ids=["every", "half"])
def test_emulated_compact_kernel_past_held_lanes(emulated, monkeypatch, kind, subset):
    """K10 on one resident block (GT_EMU_SMS=1: 256 threads holding 2
    lanes each, 512 of the batch's 2,048): the listed writers past the
    held lanes evaluate again in the write half and store only where
    the list names them."""
    import torch

    from chip_smoke import NOW, compact_case, run_compact

    monkeypatch.setenv("GT_EMU_SMS", "1")
    case = compact_case(8 + subset, 4096, 2048, kind, 12 if kind == "dict" else 300,
                        subset=subset)
    want = run_compact(torch, "cpu", kind, case, plain=True)
    hot, cold, args, wlane = case
    assert (wlane[0] >= 512).sum() > 100
    h, c = torch.tensor(hot), torch.tensor(cold)
    out = emulated.bucket_compact(h, c, torch.tensor(wlane), NOW, **_compact_src(kind, args))
    _same([t.numpy() for t in (out, h, c)], want)


def test_emulated_compact_kernel_quirks_past_held_lanes(emulated, monkeypatch):
    """The wlane quirks (entries at and past P stand for lane P - 1,
    negative entries list nothing, repeated entries) on one resident
    block, with listed lanes past the held ones.  Lane P - 1 is a write
    lane listed only through the entries past P."""
    import torch

    from chip_smoke import NOW, compact_case, run_compact

    monkeypatch.setenv("GT_EMU_SMS", "1")
    hot, cold, args, wlane = compact_case(12, 4096, 2048, "dict", 12)
    listed = wlane[0][wlane[0] >= 0]
    assert listed[-1] == 2047
    listed = listed[:-1]
    odd = np.concatenate([listed[::-1], listed[-9:], listed[:3], [2048, 50_000, -1, -9]])
    case = (hot, cold, args, np.ascontiguousarray(odd.astype(np.int32)[None]))
    want = run_compact(torch, "cpu", "dict", case, plain=True)
    h, c = torch.tensor(hot), torch.tensor(cold)
    out = emulated.bucket_compact(h, c, torch.tensor(case[3]), NOW, **_compact_src("dict", args))
    _same([t.numpy() for t in (out, h, c)], want)


@pytest.mark.parametrize("sms", ["1", "4"])
@pytest.mark.parametrize("kind", ["dict", "cols"])
def test_emulated_compact_kernel_back_to_back_lists(emulated, monkeypatch, sms, kind):
    """Two K10 calls back to back on one state with disjoint write lists
    (the even and the odd write lanes): each equals the plain version
    and changes only rows of the lanes its own list names, so a mark
    left by the first call stores nothing in the second."""
    import torch

    from chip_smoke import NOW, _pad_wlane, compact_case
    from gubernator_tpu_torch.ops import buckets

    monkeypatch.setenv("GT_EMU_SMS", sms)
    hot, cold, args, wlane = compact_case(11, 4096, 2048, kind, 12 if kind == "dict" else 300)
    src = _compact_src(kind, args)
    slot = (src["wire"][0, :2048] if kind == "dict" else src["lanes"][0, 0]).numpy()
    plain = (buckets.apply_compact_packed_plain if kind == "dict"
             else buckets.apply_compact32_plain)
    listed = wlane[0][wlane[0] >= 0]
    h, c = torch.tensor(hot), torch.tensor(cold)
    hp, cp = torch.tensor(hot), torch.tensor(cold)
    for own in (listed[0::2], listed[1::2]):
        wl = torch.tensor(_pad_wlane(own))
        before = h.numpy().copy()
        out = emulated.bucket_compact(h, c, wl, NOW, **src)
        want = plain(hp, cp, *src.values(), wl, NOW)
        _same([t.numpy() for t in (out, h, c)], [t.numpy() for t in (want, hp, cp)])
        changed = np.nonzero((h.numpy()[0] != before[0]).any(axis=1))[0]
        assert changed.size and set(changed) <= set(slot[own])


def _rounds(emulated, kind, hot, cold, args, n_rounds, wide):
    """(out, hot, cold) of the emulated K1/K2 and of its plain version."""
    import torch

    from chip_smoke import NOW
    from gubernator_tpu_torch.ops import buckets

    kernel = emulated.bucket_rounds_dict if kind == "dict" else emulated.bucket_rounds_cols
    plain = (buckets.bucket_rounds_dict_plain if kind == "dict"
             else buckets.bucket_rounds_cols_plain)
    runs = []
    for fn in (kernel, plain):
        h, c = torch.tensor(hot), torch.tensor(cold)
        out = fn(h, c, *[torch.tensor(a) for a in args], n_rounds, NOW, wide)
        runs.append([t.numpy() for t in (out, h, c)])
    return runs


@pytest.mark.parametrize("kind", ["dict", "cols"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("seed", [10, 11])
def test_emulated_rounds_reuse_slots(emulated, kind, wide, seed):
    """Four rounds in one launch, half of each round's slots written in
    the round before: round r + 1 must read round r's rows, across the
    grid barrier and across blocks."""
    from chip_smoke import make_case

    hot, cold, args, n_rounds = make_case(seed, 512, 256, 4, wide, kind,
                                          12 if kind == "dict" else 300, reuse=0.5)
    assert n_rounds == 4
    _same(*_rounds(emulated, kind, hot, cold, args, n_rounds, wide))


@pytest.mark.parametrize("kind", ["dict", "cols"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_emulated_grid_smaller_than_batch(emulated, monkeypatch, kind, wide):
    """One resident block (256 threads) for 8 x 256 lanes: each thread
    holds two lanes (K2 wide three) and re-reads the rest each round,
    whose writers evaluate again in the write half."""
    from chip_smoke import S, make_case

    monkeypatch.setenv("GT_EMU_SMS", "1")
    held = 3 if kind == "cols" and wide else 2
    assert emulated.held_lanes(kind == "dict", wide) == 256 * held < S * 256
    hot, cold, args, n_rounds = make_case(12, 512, 256, 3, wide, kind,
                                          12 if kind == "dict" else 300, reuse=0.5)
    _same(*_rounds(emulated, kind, hot, cold, args, n_rounds, wide))


# A month's Gregorian duration as the reference's gregorian_duration
# reports it from a December 2023 instant (ms): every monthly leaky lane
# takes the 128-bit leak division.
MONTH_MS = 1_701_387_101_203_199_999


def _edge_case(edge, seed, wide):
    """A dict-wire batch (S = 8, C = 512, P = 256, 2 rounds) whose
    configs and rows sit at one edge of the lane evaluation."""
    from chip_smoke import NOW, S, _split, random_plan, random_state
    from gubernator_tpu_torch.ops import buckets

    rng = np.random.default_rng(seed)
    C, P, k = 512, 256, 64
    hot, cold = random_state(rng, C, True)
    n = S * C
    algo = rng.integers(0, 2, k)
    behavior = np.zeros(k, np.int64)
    hits = rng.choice([0, 1, 2, 5], k)
    limit = rng.choice([1, 10, 100, 1000], k)
    duration = rng.choice([1000, 60_000, 3_600_000], k)
    ge, gd = np.zeros(k, np.int64), np.zeros(k, np.int64)
    h, c = hot.reshape(n, 8), cold.reshape(n, 8)
    if edge == "int32_edges":  # operands at 2**31 and 2**32
        edges = np.array([2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1, 2**32, 2**32 + 1])
        hits = rng.choice(np.concatenate([edges, [0, 1]]), k)
        limit = rng.choice(np.concatenate([edges, [1, 7]]), k)
        duration = rng.choice(np.concatenate([edges, [1000]]), k)
        h[:, 1], h[:, 2] = _split(rng.choice(edges, n))
        c[:, 0], c[:, 1] = _split(rng.choice(edges, n))
        h[:, 3], h[:, 4] = _split(NOW - rng.choice(np.concatenate([edges, [5, 0]]), n))
    elif edge == "negative":  # negative limits, hits and remaining
        hits = rng.choice([-1, -5, -(2**31), 0, 3], k)
        limit = rng.choice([-1, -100, 0, 5, -(2**33)], k)
        duration = rng.choice([-1000, 1, 60_000], k)
        h[:, 1], h[:, 2] = _split(rng.integers(-(2**40), 2**20, n))
    elif edge == "muldiv":  # leaks whose product passes int64: the 128-bit division
        algo = np.ones(k, np.int64)
        limit = rng.choice([2**42, 2**41 + 3, 2**40 - 1, 2**52 - 1, 2**52, 2**60 + 9], k)
        duration = rng.choice([2**43, 2**44 + 5, 2**45, MONTH_MS, 2**62 + 11], k)
        hits = rng.choice([1, 2**20, 0], k)
        h[:, 3], h[:, 4] = _split(NOW - rng.integers(0, 2**44, n))
    elif edge == "double_division":  # leak divisions between 2**32 and 2**53 and past it
        algo = np.ones(k, np.int64)
        limit = rng.choice([10**9 + 7, 2**33 + 5, 2**40, 999_983], k)
        duration = rng.choice([3_600_000, 86_400_000, 2**35 + 1, 2**42 - 3], k)
        h[:, 3], h[:, 4] = _split(NOW - rng.integers(0, 2**42, n))
    elif edge == "reset_remaining":
        behavior = rng.choice([0, 8], k)
        h[:, 5], h[:, 6] = _split(NOW + rng.integers(-5, 60_000, n))
    elif edge == "algorithm_switch":  # live rows of the other algorithm
        h[:, 0] = (1 - algo[rng.integers(0, k, n)]) | (h[:, 0] & 4)
        h[:, 5], h[:, 6] = _split(NOW + rng.integers(0, 60_000, n))
    elif edge == "gregorian":
        behavior = rng.choice([4, 12, 0], k)
        gd = np.where(behavior & 4, rng.choice([86_400_000, 2**33, MONTH_MS], k), 0)
        ge = np.where(behavior & 4, rng.choice([1, 3_600_000, 2**31 + 5, 2**34], k), 0)
    elif edge == "occ_groups":  # the plan's duplicate groups, at small limits
        hits = rng.choice([1, 2, 3, 7], k)
        limit = rng.choice([0, 1, 3, 8, 20], k)
    cfgs = [np.asarray(v, np.int64) for v in (algo, behavior, hits, limit, duration, ge, gd)]
    plan = random_plan(rng, C, P, 2, reuse=0.5)
    cfg = rng.integers(0, k, (S, P))
    for s in range(S):
        cfg[s] = cfg[s][plan["grp"][s] % P]
    table = [np.concatenate([v, np.zeros(256 - k, np.int64)]) for v in cfgs]
    wire = buckets.pack_dict_wire(plan["slot"], plan["ex"], plan["wr"], cfg, plan["occ"],
                                  plan["rid"], table)
    return hot, cold, (wire,), int(plan["rid"].max()) + 1


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("edge", ["int32_edges", "negative", "muldiv", "double_division",
                                  "reset_remaining", "algorithm_switch", "gregorian",
                                  "occ_groups"])
def test_emulated_eval_edges_match_plain(emulated, edge, wide):
    """Each branch of the lane evaluation at its edges through the
    emulated K1: the 32-bit and double division forms' limits, negative
    operands, the 128-bit leak, RESET_REMAINING, algorithm switches,
    Gregorian lanes and duplicate groups with occ > 0."""
    hot, cold, args, n_rounds = _edge_case(edge, 20 + len(edge), wide)
    _same(*_rounds(emulated, "dict", hot, cold, args, n_rounds, wide))
