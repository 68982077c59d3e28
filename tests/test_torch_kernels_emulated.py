"""The port's CUDA kernels, compiled by g++ against a CPU stand-in of
the CUDA runtime (tests/cuda_emu/cuda_runtime.h), against their plain
PyTorch versions: the same seeded cases as tests/test_torch_kernels.py
(K1 and K2 narrow and wide; K3-K6 of the GLOBAL plane; the row gather
K7 and row scatter K8; the tier move K9; the compact commit K10),
tolerance 0.

This holds the kernels' device logic (the round steps, the replica
answer, the sync, the scatters, the row composition and split, the
tier move's gather and scatter, the compact commit over the listed
write lanes) on a machine with no card, where the
cuda-marked tests skip.  The stand-in runs the threads of a launch one
after another, so it shows no race and nothing of what nvcc does; the
card runs of tests/test_torch_kernels.py and chip_smoke.py remain the
test of the built kernels."""

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
LAUNCH = re.compile(r"([\w:]+(?:<[\w:, ]+>)?)<<<(.+?)>>>\(", re.S)


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
            text = LAUNCH.sub(lambda m: f"gt_emu_launch({m.group(2)}, {m.group(1)}, ", f.read())
        path = out / (os.path.basename(src) + ".cpp")
        path.write_text(text)
        sources.append(str(path))
    lib_path = str(out / "kernels_emu.so")
    subprocess.run(["g++", "-std=c++17", "-O1", "-fno-strict-aliasing", "-shared", "-fPIC",
                    "-I", EMU, "-I", CSRC, *sources, "-o", lib_path],
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
