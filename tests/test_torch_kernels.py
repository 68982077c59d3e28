"""The port's CUDA kernels against their plain PyTorch versions, on the
card: seeded cases (chip_smoke.make_case, chip_smoke.global_case,
chip_smoke.rows_case, chip_smoke.moves_case, chip_smoke.compact_case)
through each kernel (K1 and K2 narrow and wide; K3-K6 of the GLOBAL
plane; the row gather K7 and row scatter K8; the tier move K9, its
records in either order; the compact commit K10, every write lane
listed or half of them) must give the plain version's outputs, state
and replica-column bytes exactly (tolerance 0: all integer).  Skipped
without a CUDA device; on a machine with one, run
`python -m pytest -m cuda tests/test_torch_kernels.py`.
`python3 chip_smoke.py` runs the same comparison at full size."""

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
