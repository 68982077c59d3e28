"""CLI entry points of the port.

Shared device selection, the counterpart of the JAX package's
`apply_jax_platform_env`: the server's store runs on the current CUDA
device unless its config asks for another with `GUBER_TORCH_DEVICE`
("cpu" runs the kernels' plain versions).  A config that names no
device on a machine without a CUDA device fails at startup; nothing
falls back to the CPU on its own.
"""

from __future__ import annotations

DEVICE_ENV = "GUBER_TORCH_DEVICE"


def select_device(conf):
    """Check and normalise `conf.device` (set from GUBER_TORCH_DEVICE):
    None becomes the current CUDA device and raises RuntimeError when
    there is none; a named device must parse.  Returns the device the
    daemon's store is built on ("cpu", "cuda:N")."""
    import torch

    if conf.device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the server runs on the card unless its "
                f"config sets {DEVICE_ENV}=cpu"
            )
        conf.device = f"cuda:{torch.cuda.current_device()}"
    dev = torch.device(conf.device)  # raises on a malformed name
    conf.device = "cpu" if dev.type == "cpu" else str(dev)
    return conf.device
