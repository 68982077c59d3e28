"""gubernator_tpu_torch — the PyTorch/CUDA port of gubernator_tpu.

Token-bucket / leaky-bucket rate limiting with bucket state as int32
tensors on one CUDA device and every request batch evaluated by
hand-written kernels (csrc/).  The JAX package `gubernator_tpu` is the
reference this package is held to; the port imports nothing of it, and
nothing of JAX.
"""

from .types import (
    Algorithm,
    Behavior,
    GetRateLimitsRequest,
    GetRateLimitsResponse,
    HealthCheckResponse,
    PeerInfo,
    RateLimitRequest,
    RateLimitResponse,
    Status,
    has_behavior,
    set_behavior,
    MILLISECOND,
    SECOND,
    MINUTE,
    HOUR,
)

__version__ = "0.1.0"

__all__ = [
    "Algorithm",
    "Behavior",
    "Status",
    "RateLimitRequest",
    "RateLimitResponse",
    "GetRateLimitsRequest",
    "GetRateLimitsResponse",
    "HealthCheckResponse",
    "PeerInfo",
    "has_behavior",
    "set_behavior",
    "MILLISECOND",
    "SECOND",
    "MINUTE",
    "HOUR",
]
