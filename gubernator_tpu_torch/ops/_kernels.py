"""Build, bind and launch the bucket-rounds CUDA kernels.

csrc/bucket_rounds.cu is compiled with nvcc for sm_90a into a shared
library with a plain C interface the first time a kernel is launched
(or `build()` is called), and bound through ctypes.  Each wrapper checks
device, dtype, shape and contiguity, allocates its output and scratch
with torch.empty, launches on PyTorch's current stream, raises when the
launch returns a CUDA error, and counts its launches in LAUNCHES.

Nothing here runs on import: the CPU tests import this module's package
on a machine with no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from ..utils.build import build_library
from .buckets import DICT_WIRE_TABLE_WORDS

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = [os.path.join(_CSRC, "bucket_rounds.cu")]
HEADERS = [os.path.join(_CSRC, "bucket_rounds.cuh")]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", _CSRC,
]

# Launches per kernel since the last reset_launch_counts(): one per
# wrapper call that reached the kernel.
LAUNCHES = {"bucket_rounds_dict": 0, "bucket_rounds_cols": 0}
_STAGE_WORDS = 16  # per-lane scratch record (bucket_rounds.cuh kStageWords)

_lib = None
_lib_lock = threading.Lock()


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
    return build_library("bucket_rounds", SOURCES, [nvcc_path(), *NVCC_FLAGS],
                         deps=HEADERS, log=log)


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
                lib.gt_bucket_rounds_dict.restype = ctypes.c_int
                lib.gt_bucket_rounds_dict.argtypes = [
                    p, p, i64, i64, p, i64, i32, i64, i32, p, p, p,
                ]
                lib.gt_bucket_rounds_cols.restype = ctypes.c_int
                lib.gt_bucket_rounds_cols.argtypes = [
                    p, p, i64, i64, p, p, i64, i32, i64, i32, p, p, p,
                ]
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


def _state(hot, cold):
    if hot.device.type != "cuda":
        raise ValueError(f"kernel state must be on a CUDA device, got {hot.device}")
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


def _finish(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


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
    stage = torch.empty((S, P, _STAGE_WORDS), dtype=torch.int32, device=hot.device)
    with torch.cuda.device(hot.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _get_lib().gt_bucket_rounds_dict(
            hot.data_ptr(), cold.data_ptr(), S, C, wire.data_ptr(), P,
            int(n_rounds), int(now_ms), 1 if wide else 0, stage.data_ptr(),
            out.data_ptr(), stream,
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
    stage = torch.empty((S, P, _STAGE_WORDS), dtype=torch.int32, device=hot.device)
    with torch.cuda.device(hot.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _get_lib().gt_bucket_rounds_cols(
            hot.data_ptr(), cold.data_ptr(), S, C, lanes.data_ptr(),
            values.data_ptr(), P, int(n_rounds), int(now_ms), 1 if wide else 0,
            stage.data_ptr(), out.data_ptr(), stream,
        )
    _finish("bucket_rounds_cols", rc)
    return out
