"""Build, bind and launch the port's CUDA kernels.

csrc/bucket_rounds.cu (K1, K2), csrc/global_ops.cu (K3-K6),
csrc/rows.cu (K7, K8), csrc/moves.cu (K9) and csrc/compact.cu (K10),
with csrc/launch_floor.cu (empty kernels that measure a launch's fixed
cost), are compiled with nvcc for sm_90a, one nvcc process per source
started together, into one shared library with a plain C interface the
first time a kernel is launched (or `build()` is called), and bound
through ctypes.  Each wrapper checks device, dtype, shape and
contiguity, allocates its output and scratch with torch.empty (K1-K3
and K10 stage nothing: their one cooperative launch keeps a round's new
rows on the SM; K9 needs scratch only for a window past what its launch
holds in shared memory; K10 keeps one mark word a lane per device and
stream, `_compact_marks`), launches on PyTorch's current stream, raises
when the launch returns a CUDA error, counts its launches in LAUNCHES
and reports each kernel's first launch to telemetry.py.

Nothing here runs on import: the CPU tests import this module's package
on a machine with no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from .. import telemetry
from ..utils.build import build_library
from .buckets import DICT_WIRE_TABLE_WORDS

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = [os.path.join(_CSRC, name)
           for name in ("bucket_rounds.cu", "global_ops.cu", "rows.cu", "moves.cu",
                        "compact.cu", "launch_floor.cu")]
HEADERS = [os.path.join(_CSRC, name) for name in ("bucket_rounds.cuh", "rounds.cuh")]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo", "-I", _CSRC,
]
LINK_FLAGS = ["-shared"]

# Launches per kernel since the last reset_launch_counts(): one per
# wrapper call that reached the kernel, each one device launch.
# The row gather counts under "gather_back_rows" when it reads the
# two-tier table's back tier (ops/buckets.py read_back_rows).
LAUNCHES = {
    "bucket_rounds_dict": 0, "bucket_rounds_cols": 0,
    "global_answer_rounds": 0, "global_sync": 0, "set_replica": 0,
    "clear_gslots": 0, "gather_rows": 0, "write_rows": 0,
    "gather_back_rows": 0, "apply_moves": 0, "bucket_compact": 0,
}

_lib = None
_lib_lock = threading.Lock()
# K10's list marks, (device, stream) -> (i32 tensor, last generation):
# each call stamps the lanes its write list names with a generation of
# its own, so a word an earlier call stamped never counts and no call
# clears them.
_marks: dict = {}
_marks_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(log: "list | None" = None) -> str:
    """Compile the kernels if their library is absent; returns its path.
    `log` receives nvcc's output (ptxas register and spill report)."""
    nvcc = nvcc_path()
    return build_library("kernels", SOURCES, [nvcc, *NVCC_FLAGS], deps=HEADERS,
                         log=log, link=[nvcc, *LINK_FLAGS])


_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_SIGNATURES = {
    "gt_bucket_rounds_dict": [_P, _P, _I64, _I64, _P, _I64, _I32, _I64, _I32, _P, _P],
    "gt_bucket_rounds_cols": [_P, _P, _I64, _I64, _P, _P, _I64, _I32, _I64, _I32, _P, _P],
    "gt_bucket_rounds_held_lanes": [_I32, _I32, _P],
    "gt_global_answer_rounds": [_P, _P, _I64, _I64, _P, _P, _P, _I64, _P, _P, _P, _P,
                                _P, _P, _I64, _I32, _I64, _P, _P],
    "gt_global_answer_launch_shape": [_I64, _P, _P],
    "gt_global_sync": [_P, _P, _I64, _I64, _P, _P, _P, _P, _P, _P, _I64, _P, _P, _I64,
                       _P, _P],
    "gt_set_replica": [_P, _P, _P, _P, _P, _P, _I64, _I64, _P, _I64, _P],
    "gt_clear_gslots": [_P, _P, _P, _P, _P, _P, _I64, _I64, _P, _I64, _P],
    "gt_gather_rows": [_P, _P, _I64, _I64, _P, _I64, _P, _P, _P],
    "gt_write_rows": [_P, _P, _I64, _I64, _P, _I64, _P, _P, _P],
    "gt_apply_moves": [_P, _P, _I64, _I64, _P, _P, _I64, _P, _I64, _P, _I64, _P],
    "gt_apply_moves_spill": [_I64, _P],
    "gt_bucket_compact": [_P, _P, _I64, _I64, _I32, _P, _P, _I64, _P, _I64, _I64,
                          _P, _I32, _P, _P],
    "gt_launch_floor": [_I32, _I64, _I32, _P],
}


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                for fn, argtypes in _SIGNATURES.items():
                    getattr(lib, fn).restype = ctypes.c_int
                    getattr(lib, fn).argtypes = argtypes
                _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _require_card(what: str, device) -> None:
    """The kernels take CUDA tensors only (a CPU tensor takes the plain
    version in the dispatching wrapper)."""
    if device.type != "cuda":
        raise ValueError(f"{what} must be on a CUDA device, got {device}")


def _state(hot, cold):
    _require_card("kernel state", hot.device)
    if hot.dim() != 3 or hot.shape[2] != 8:
        raise ValueError(f"state must be [S, C, 8], got {tuple(hot.shape)}")
    S, C, _ = hot.shape
    _check("hot", hot, torch.int32, (S, C, 8), hot.device)
    _check("cold", cold, torch.int32, (S, C, 8), hot.device)
    return S, C


def _out(out, S, P, wide, device):
    dtype = torch.int64 if wide else torch.int32
    if out is None:
        return torch.empty((S, 4, P), dtype=dtype, device=device)
    _check("out", out, dtype, (S, 4, P), device)
    return out


def _stream(device) -> int:
    """PyTorch's current stream on `device`, as the kernels' stream."""
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _finish(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1
    telemetry.note_launch(name)


def bucket_rounds_dict(hot, cold, wire, n_rounds: int, now_ms: int, wide: bool,
                       out=None):
    """K1: one dict-wire batch (see ops/buckets.py bucket_rounds_dict)."""
    S, C = _state(hot, cold)
    if wire.dim() != 2 or (wire.shape[1] - DICT_WIRE_TABLE_WORDS) % 3 \
            or wire.shape[1] <= DICT_WIRE_TABLE_WORDS:
        raise ValueError(f"wire must be [S, 3P + {DICT_WIRE_TABLE_WORDS}], "
                         f"got {tuple(wire.shape)}")
    P = (wire.shape[1] - DICT_WIRE_TABLE_WORDS) // 3
    _check("wire", wire, torch.int32, (S, wire.shape[1]), hot.device)
    if n_rounds < 1:
        raise ValueError("n_rounds must be >= 1")
    out = _out(out, S, P, wide, hot.device)
    rc = _get_lib().gt_bucket_rounds_dict(
        hot.data_ptr(), cold.data_ptr(), S, C, wire.data_ptr(), P,
        int(n_rounds), int(now_ms), 1 if wide else 0, out.data_ptr(),
        _stream(hot.device),
    )
    _finish("bucket_rounds_dict", rc)
    return out


def bucket_rounds_cols(hot, cold, lanes, values, n_rounds: int, now_ms: int,
                       wide: bool):
    """K2: one per-lane-column batch (see ops/buckets.py
    bucket_rounds_cols)."""
    S, C = _state(hot, cold)
    if lanes.dim() != 3 or lanes.shape[1] != 6:
        raise ValueError(f"lanes must be [S, 6, P], got {tuple(lanes.shape)}")
    P = lanes.shape[2]
    _check("lanes", lanes, torch.int32, (S, 6, P), hot.device)
    _check("values", values, torch.int64 if wide else torch.int32, (S, 5, P),
           hot.device)
    if n_rounds < 1:
        raise ValueError("n_rounds must be >= 1")
    out = _out(None, S, P, wide, hot.device)
    rc = _get_lib().gt_bucket_rounds_cols(
        hot.data_ptr(), cold.data_ptr(), S, C, lanes.data_ptr(),
        values.data_ptr(), P, int(n_rounds), int(now_ms), 1 if wide else 0,
        out.data_ptr(), _stream(hot.device),
    )
    _finish("bucket_rounds_cols", rc)
    return out


def held_lanes(dict_wire: bool, wide: bool) -> int:
    """The lanes one K1 (`dict_wire`) or K2 launch holds across its
    round barriers on the current device (resident threads x lanes a
    thread holds); a larger batch re-reads the rest each round."""
    n = ctypes.c_int64(0)
    rc = _get_lib().gt_bucket_rounds_held_lanes(1 if dict_wire else 0, 1 if wide else 0,
                                                 ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"held_lanes: occupancy query failed with CUDA error {rc}")
    return n.value


# ---------------------------------------------------------------------
# GLOBAL-plane kernels (csrc/global_ops.cu)
# ---------------------------------------------------------------------
def _gcols(gcols, device):
    """Check the replica columns; returns (S, G, their pointers)."""
    if gcols.rep_status.dim() != 2:
        raise ValueError(f"replica columns must be [S, G], got {tuple(gcols.rep_status.shape)}")
    S, G = gcols.rep_status.shape
    _check("rep_status", gcols.rep_status, torch.int32, (S, G), device)
    for name in ("rep_limit", "rep_remaining", "rep_reset", "rep_expire", "ghits"):
        _check(name, getattr(gcols, name), torch.int64, (S, G), device)
    return S, G, [t.data_ptr() for t in gcols]


def global_answer_rounds(hot, cold, gcols, lanes, values, gslot, n_rounds: int,
                         now_ms: int):
    """K3: all rounds of one dataclass-path batch (see ops/global_ops.py
    answer_rounds)."""
    S, C = _state(hot, cold)
    if lanes.dim() != 3 or lanes.shape[1] != 6:
        raise ValueError(f"lanes must be [S, 6, P], got {tuple(lanes.shape)}")
    P = lanes.shape[2]
    dev = hot.device
    _check("lanes", lanes, torch.int32, (S, 6, P), dev)
    _check("values", values, torch.int64, (S, 5, P), dev)
    _check("gslot", gslot, torch.int32, (S, P), dev)
    gS, G, gptrs = _gcols(gcols, dev)
    if gS != S:
        raise ValueError(f"replica columns have {gS} shards, state {S}")
    if n_rounds < 1:
        raise ValueError("n_rounds must be >= 1")
    out = torch.empty((S, 5, P), dtype=torch.int64, device=dev)
    rc = _get_lib().gt_global_answer_rounds(
        hot.data_ptr(), cold.data_ptr(), S, C, lanes.data_ptr(), values.data_ptr(),
        gslot.data_ptr(), P, *gptrs, G, int(n_rounds), int(now_ms), out.data_ptr(),
        _stream(dev),
    )
    _finish("global_answer_rounds", rc)
    return out


def answer_launch_shape(n_lanes: int) -> tuple:
    """K3's launch for a batch of `n_lanes` (S * P) lanes on the current
    device: (blocks of 256 threads, lanes it holds across its round
    barriers); a larger batch re-reads the rest each round."""
    blocks, held = ctypes.c_int64(0), ctypes.c_int64(0)
    rc = _get_lib().gt_global_answer_launch_shape(int(n_lanes), ctypes.byref(blocks),
                                                  ctypes.byref(held))
    if rc != 0:
        raise RuntimeError(f"answer_launch_shape: occupancy query failed with CUDA error {rc}")
    return blocks.value, held.value


def global_sync(hot, cold, gcols, cfg, dirty, now_ms: int):
    """K4: one GLOBAL sync (see ops/global_ops.py global_sync)."""
    S, C = _state(hot, cold)
    dev = hot.device
    gS, G, gptrs = _gcols(gcols, dev)
    if gS != S:
        raise ValueError(f"replica columns have {gS} shards, state {S}")
    _check("cfg", cfg, torch.int64, (8, G), dev)
    _check("dirty", dirty, torch.bool, (S, G), dev)
    out = torch.empty((S, 8, G), dtype=torch.int64, device=dev)
    rc = _get_lib().gt_global_sync(
        hot.data_ptr(), cold.data_ptr(), S, C, *gptrs, G, cfg.data_ptr(),
        dirty.data_ptr(), int(now_ms), out.data_ptr(), _stream(dev),
    )
    _finish("global_sync", rc)
    return out


def set_replica(gcols, upd):
    """K5: replica commit of upd i64[5, M] (see ops/global_ops.py
    set_replica)."""
    dev = gcols.rep_status.device
    _require_card("replica columns", dev)
    S, G, gptrs = _gcols(gcols, dev)
    if upd.dim() != 2 or upd.shape[0] != 5:
        raise ValueError(f"upd must be [5, M], got {tuple(upd.shape)}")
    M = upd.shape[1]
    _check("upd", upd, torch.int64, (5, M), dev)
    rc = _get_lib().gt_set_replica(*gptrs, S, G, upd.data_ptr(), M,
                                               _stream(dev))
    _finish("set_replica", rc)


def clear_gslots(gcols, idx):
    """K6: zero the replica columns at idx i64[K] (see ops/global_ops.py
    clear_gslots)."""
    dev = gcols.rep_status.device
    _require_card("replica columns", dev)
    S, G, gptrs = _gcols(gcols, dev)
    if idx.dim() != 1:
        raise ValueError(f"idx must be [K], got {tuple(idx.shape)}")
    _check("idx", idx, torch.int64, (idx.shape[0],), dev)
    rc = _get_lib().gt_clear_gslots(*gptrs, S, G, idx.data_ptr(),
                                                idx.shape[0], _stream(dev))
    _finish("clear_gslots", rc)


# ---------------------------------------------------------------------
# Row kernels of the persistence plane (csrc/rows.cu)
# ---------------------------------------------------------------------
def _lanes(lanes, device):
    if lanes.dim() != 2 or lanes.shape[0] != 2:
        raise ValueError(f"lanes must be [2, M], got {tuple(lanes.shape)}")
    _check("lanes", lanes, torch.int32, (2, lanes.shape[1]), device)
    return lanes.shape[1]


def gather_rows(hot, cold, lanes, count: str = "gather_rows"):
    """K7: the full rows at lanes i32[2, M]; returns (c32 i32[2, M],
    c64 i64[5, M]) (see ops/buckets.py read_rows_plain).  The launch
    counts under `count` ("gather_back_rows" on the back tier)."""
    S, C = _state(hot, cold)
    M = _lanes(lanes, hot.device)
    c32 = torch.empty((2, M), dtype=torch.int32, device=hot.device)
    c64 = torch.empty((5, M), dtype=torch.int64, device=hot.device)
    if M:
        rc = _get_lib().gt_gather_rows(hot.data_ptr(), cold.data_ptr(), S, C,
                                       lanes.data_ptr(), M, c32.data_ptr(),
                                       c64.data_ptr(), _stream(hot.device))
        _finish(count, rc)
    return c32, c64


def write_rows(hot, cold, lanes, c32, c64) -> None:
    """K8: write the rows of (c32, c64) at lanes i32[2, M] in place; the
    in-range lanes must name distinct rows (see ops/buckets.py
    write_rows_plain)."""
    S, C = _state(hot, cold)
    M = _lanes(lanes, hot.device)
    _check("c32", c32, torch.int32, (2, M), hot.device)
    _check("c64", c64, torch.int64, (5, M), hot.device)
    if M:
        rc = _get_lib().gt_write_rows(hot.data_ptr(), cold.data_ptr(), S, C,
                                      lanes.data_ptr(), M, c32.data_ptr(),
                                      c64.data_ptr(), _stream(hot.device))
        _finish("write_rows", rc)


# ---------------------------------------------------------------------
# Tier moves of the two-tier table (csrc/moves.cu)
# ---------------------------------------------------------------------
def apply_moves(hot, cold, back_hot, back_cold, records) -> None:
    """K9: one drain window of tier moves, records i32[3, N] = (op =
    shard << 2 | kind, src, dst), applied to the front hot/cold
    [S, C, 8] and back hot/cold [S, Cb, 8] in place; live records must
    name distinct destinations (see ops/buckets.py apply_moves_plain)."""
    S, C = _state(hot, cold)
    bS, Cb = _state(back_hot, back_cold)
    if bS != S:
        raise ValueError(f"back tier has {bS} shards, front {S}")
    if records.dim() != 2 or records.shape[0] != 3:
        raise ValueError(f"records must be [3, N], got {tuple(records.shape)}")
    N = records.shape[1]
    _check("records", records, torch.int32, (3, N), hot.device)
    if not N:
        return
    n_spill = moves_spill(N)
    spill = (torch.empty((n_spill, 4), dtype=torch.int32, device=hot.device)
             if n_spill else None)
    rc = _get_lib().gt_apply_moves(
        hot.data_ptr(), cold.data_ptr(), S, C, back_hot.data_ptr(),
        back_cold.data_ptr(), Cb, records.data_ptr(), N,
        spill.data_ptr() if spill is not None else None, n_spill, _stream(hot.device))
    _finish("apply_moves", rc)


def moves_spill(n_records: int) -> int:
    """The 16-byte quarters of a K9 window of `n_records` records (four
    each: the hot and cold rows' halves) past what its one launch holds
    in shared memory on the current device (0 up to 4 quarters a
    resident thread): the scratch it stages them in."""
    n = ctypes.c_int64(0)
    rc = _get_lib().gt_apply_moves_spill(int(n_records), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"moves_spill: occupancy query failed with CUDA error {rc}")
    return n.value


# ---------------------------------------------------------------------
# The compact commit (csrc/compact.cu)
# ---------------------------------------------------------------------
def bucket_compact(hot, cold, wlane, now_ms: int, wire=None, lanes=None, values=None):
    """K10: one single-round narrow batch from the dict wire (`wire`
    i32[S, 3P + 3072]) or from per-lane columns (`lanes` i32[S, 6, P],
    `values` i32[S, 5, P]), round ids ignored; every lane evaluated,
    then only the rows of the lanes in `wlane` i32[S, Pw] written (see
    ops/buckets.py apply_compact32_plain), in one cooperative launch of
    the rounds kernel.  Returns i32[S, 4, P]."""
    S, C = _state(hot, cold)
    dev = hot.device
    if (wire is None) == (lanes is None):
        raise ValueError("give either the dict wire or the per-lane columns")
    if wire is not None:
        if wire.dim() != 2 or (wire.shape[1] - DICT_WIRE_TABLE_WORDS) % 3 \
                or wire.shape[1] <= DICT_WIRE_TABLE_WORDS:
            raise ValueError(f"wire must be [S, 3P + {DICT_WIRE_TABLE_WORDS}], "
                             f"got {tuple(wire.shape)}")
        P = (wire.shape[1] - DICT_WIRE_TABLE_WORDS) // 3
        _check("wire", wire, torch.int32, (S, wire.shape[1]), dev)
        src, vals = wire, None
    else:
        if lanes.dim() != 3 or lanes.shape[1] != 6:
            raise ValueError(f"lanes must be [S, 6, P], got {tuple(lanes.shape)}")
        P = lanes.shape[2]
        _check("lanes", lanes, torch.int32, (S, 6, P), dev)
        _check("values", values, torch.int32, (S, 5, P), dev)
        src, vals = lanes, values
    if wlane.dim() != 2 or wlane.shape[0] != S:
        raise ValueError(f"wlane must be [S, Pw], got {tuple(wlane.shape)}")
    Pw = wlane.shape[1]
    _check("wlane", wlane, torch.int32, (S, Pw), dev)
    out = _out(None, S, P, False, dev)
    stream = _stream(dev)
    mark, gen = _compact_marks(S * P, dev, stream)
    rc = _get_lib().gt_bucket_compact(
        hot.data_ptr(), cold.data_ptr(), S, C, 1 if wire is not None else 0,
        src.data_ptr(), vals.data_ptr() if vals is not None else None, P,
        wlane.data_ptr(), Pw, int(now_ms), mark.data_ptr(), gen, out.data_ptr(), stream)
    _finish("bucket_compact", rc)
    return out


def _compact_marks(n: int, device, stream: int):
    """K10's mark words for `n` lanes on `device`'s `stream` and this
    call's generation.  The words are zeroed only when they are made (at
    first use, on growth, and after 2**31 - 1 generations); calls on one
    stream run in order, so each sees only its own stamps."""
    key = (str(device), stream)
    with _marks_lock:
        mark, gen = _marks.get(key, (None, 0))
        if mark is None or mark.numel() < n or gen == 2**31 - 1:
            size = n if mark is None else max(n, mark.numel())
            mark, gen = torch.zeros(size, dtype=torch.int32, device=device), 0
        gen += 1
        _marks[key] = (mark, gen)
    return mark, gen


# ---------------------------------------------------------------------
# The launch floor (csrc/launch_floor.cu): not a kernel of any path
# ---------------------------------------------------------------------
def launch_floor(cooperative: bool, blocks: int, device, threads: int = 256) -> None:
    """One empty launch on `device`'s current stream: a plain kernel, or
    (`cooperative`) a cooperative kernel whose only work is one grid
    barrier; what a launch costs the card with no work in it.  Not
    counted in LAUNCHES."""
    _require_card("launch_floor", torch.device(device))
    rc = _get_lib().gt_launch_floor(1 if cooperative else 0, int(blocks), int(threads),
                                    _stream(device))
    if rc != 0:
        raise RuntimeError(f"launch_floor: launch failed with CUDA error {rc}")
