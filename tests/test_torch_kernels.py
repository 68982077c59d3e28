"""The port's CUDA kernels against their plain PyTorch versions, on the
card: seeded cases (chip_smoke.make_case, chip_smoke.global_case,
chip_smoke.rows_case, chip_smoke.moves_case, chip_smoke.compact_case)
through each kernel (K1 and K2 narrow and wide, also in rounds that
reuse slots and past the lanes one launch holds; K3-K6 of the GLOBAL
plane, K3 also past the lanes its launch holds; the row gather K7 and
row scatter K8; the tier move K9, its records in either order, also on
a window past what its launch holds in registers; the compact commit
K10, every write lane listed or half of them) must give the plain
version's outputs, state and replica-column bytes exactly (tolerance 0:
all integer).  Skipped without a CUDA device; on a machine with one,
run `python -m pytest -m cuda tests/test_torch_kernels.py`.
`python3 chip_smoke.py` runs the same comparison at full size."""

import numpy as np
import pytest

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", ["dict", "cols"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_matches_plain(cuda_device, kind, wide, seed):
    import torch

    from chip_smoke import make_case, run_kernel

    hot, cold, args, n_rounds = make_case(seed, 512, 256, 1 + seed, wide, kind,
                                          12 if kind == "dict" else 300)
    got = run_kernel(torch, cuda_device, kind, hot, cold, args, n_rounds, wide, plain=False)
    want = run_kernel(torch, cuda_device, kind, hot, cold, args, n_rounds, wide, plain=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("kind", ["dict", "cols"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("P,rounds", [(256, 4), (65_536, 3)], ids=["rounds", "past_held"])
def test_kernel_rounds_match_plain(cuda_device, kind, wide, P, rounds):
    """Rounds that reuse half the slots of the round before, in one
    launch; at P = 65,536 the 8 x P lanes pass what one launch holds."""
    import torch

    from chip_smoke import S, make_case, run_kernel
    from gubernator_tpu_torch.ops import _kernels

    if P > 256:
        assert S * P > _kernels.held_lanes(kind == "dict", wide)
    hot, cold, args, n_rounds = make_case(30 + rounds, max(4096, P), P, rounds, wide, kind,
                                          12 if kind == "dict" else 300, reuse=0.5)
    got = run_kernel(torch, cuda_device, kind, hot, cold, args, n_rounds, wide, plain=False)
    want = run_kernel(torch, cuda_device, kind, hot, cold, args, n_rounds, wide, plain=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("kind", ["answer", "sync", "replica", "clear"])
@pytest.mark.parametrize("seed", [0, 1])
def test_global_kernel_matches_plain(cuda_device, kind, seed):
    import torch

    from chip_smoke import global_case, run_global

    case = global_case(kind, seed, 256, 64, 128 if kind == "answer" else 32, 1 + 2 * seed)
    got = run_global(torch, cuda_device, kind, case, plain=False)
    want = run_global(torch, cuda_device, kind, case, plain=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("n_rounds", [1, 3])
def test_answer_rounds_past_held_lanes(cuda_device, n_rounds):
    """K3 on 8 x 65,536 lanes, more than its one launch holds: the rest
    are read again each round and their writers evaluated again in the
    write half, while each GLOBAL lane's hits reach ghits once."""
    import torch

    from chip_smoke import S, global_case, run_global
    from gubernator_tpu_torch.ops import _kernels

    P = 65_536
    assert S * P > _kernels.answer_launch_shape(S * P)[1]
    case = global_case("answer", 40 + n_rounds, 65_536, 65_536, P, n_rounds)
    got = run_global(torch, cuda_device, "answer", case, plain=False)
    want = run_global(torch, cuda_device, "answer", case, plain=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("kind", ["gather", "write"])
@pytest.mark.parametrize("seed", [0, 1])
def test_row_kernel_matches_plain(cuda_device, kind, seed):
    import torch

    from chip_smoke import rows_case, run_rows

    case = rows_case(seed, 64, 300)
    got = run_rows(torch, cuda_device, kind, case, plain=False)
    want = run_rows(torch, cuda_device, kind, case, plain=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("reverse", [False, True], ids=["in_order", "reversed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_moves_kernel_matches_plain(cuda_device, seed, reverse):
    import torch

    from chip_smoke import moves_case, run_moves

    case = moves_case(seed, 64, 256, 20, 15)
    got = run_moves(torch, cuda_device, case, plain=False, reverse=reverse)
    want = run_moves(torch, cuda_device, case, plain=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("reverse", [False, True], ids=["in_order", "reversed"])
def test_moves_kernel_past_held_quarters(cuda_device, reverse):
    """K9 on a window of 302,508 records, more than its one launch holds
    in shared memory (4 quarters a resident thread): the rest are
    spilled before the grid barrier and stored after it."""
    import torch

    from chip_smoke import moves_case, run_moves
    from gubernator_tpu_torch.ops import _kernels

    case = moves_case(50, 65_536, 262_144, 22_000, 20_000)
    assert _kernels.moves_spill(case[-1].shape[1]) > 0
    got = run_moves(torch, cuda_device, case, plain=False, reverse=reverse)
    want = run_moves(torch, cuda_device, case, plain=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("kind", ["dict", "cols"])
@pytest.mark.parametrize("seed,subset", [(0, False), (1, True)])
def test_compact_kernel_matches_plain(cuda_device, kind, seed, subset):
    import torch

    from chip_smoke import compact_case, run_compact

    case = compact_case(seed, 512, 256, kind, 12 if kind == "dict" else 300, subset=subset)
    got = run_compact(torch, cuda_device, kind, case, plain=False)
    want = run_compact(torch, cuda_device, kind, case, plain=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("kind", ["dict", "cols"])
def test_compact_kernel_past_held_lanes(cuda_device, kind):
    """K10 on one shard of 300,000 lanes, past the 270,336 its launch
    holds on an H100 (132 SMs x 4 blocks x 256 threads x 2): the
    writers past them evaluate again in the write half and store only
    where the list names them; then a second call on the same state
    with the other half of the write lanes listed."""
    import torch

    from chip_smoke import NOW, _compact_fns, _pad_wlane, compact_case

    hot, cold, args, wlane = compact_case(40, 600_000, 300_000, kind,
                                          12 if kind == "dict" else 300)
    listed = wlane[0][wlane[0] >= 0]
    targs = [torch.tensor(a, device=cuda_device) for a in args]
    sides = [(fn, torch.tensor(hot, device=cuda_device), torch.tensor(cold, device=cuda_device))
             for fn in _compact_fns()[kind]]
    for own in (listed[0::2], listed[1::2]):
        wl = torch.tensor(_pad_wlane(own), device=cuda_device)
        got, want = [[fn(h, c, *targs, wl, NOW), h, c] for fn, h, c in sides]
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("shards", [1, 8])
def test_clear_kernel_lists(cuda_device, shards, order):
    """K6 on a 3,000-entry list of a 65,536-gslot table, with repeated
    entries and padding at G and past it, sorted or not, at S = 1 and
    S = 8."""
    import torch

    from chip_smoke import random_gcols
    from gubernator_tpu_torch.ops import _kernels, global_ops

    rng = np.random.default_rng(50 + shards)
    G, K = 65_536, 3_000
    gc = [np.ascontiguousarray(c[:shards]) for c in random_gcols(rng, G)]
    idx = rng.integers(0, G, K)
    idx[rng.random(K) < 0.1] = G + rng.integers(0, 9)
    idx[:4] = idx[4]
    if order == "sorted":
        idx.sort()
    got, want = (global_ops.global_columns_from_numpy(gc, cuda_device) for _ in range(2))
    idx_t = torch.tensor(idx, device=cuda_device)
    _kernels.clear_gslots(got, idx_t)
    global_ops.clear_gslots_plain(want, idx_t)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
