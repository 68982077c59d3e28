"""Wire-schema types: enums, request/response dataclasses, JSON codec.

Parity with the reference protos (`proto/gubernator.proto:57-189`,
`proto/peers.proto:36-57`): same field names, enum values, and bit-flag
behavior semantics.  The JSON codec mirrors grpc-gateway conventions
(accepts both snake_case and camelCase keys; emits camelCase).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class Algorithm(enum.IntEnum):
    """proto/gubernator.proto:57-62"""

    TOKEN_BUCKET = 0
    LEAKY_BUCKET = 1


class Behavior(enum.IntFlag):
    """Bit flags controlling rate-limit behavior (proto/gubernator.proto:65-131).

    BATCHING is the zero value (default, no bit set).
    """

    BATCHING = 0
    NO_BATCHING = 1
    GLOBAL = 2
    DURATION_IS_GREGORIAN = 4
    RESET_REMAINING = 8
    MULTI_REGION = 16


class Status(enum.IntEnum):
    """proto/gubernator.proto:161-164"""

    UNDER_LIMIT = 0
    OVER_LIMIT = 1


def has_behavior(flags: int, flag: Behavior) -> bool:
    """Reference `HasBehavior` (gubernator.go:476-481)."""
    return bool(int(flags) & int(flag))


def set_behavior(flags: int, flag: Behavior, on: bool) -> int:
    """Reference `SetBehavior` (gubernator.go:483-488)."""
    if on:
        return int(flags) | int(flag)
    return int(flags) & ~int(flag)


# Duration helpers in milliseconds (client.go:30-34).
MILLISECOND = 1
SECOND = 1000 * MILLISECOND
MINUTE = 60 * SECOND
HOUR = 60 * MINUTE


@dataclass
class RateLimitRequest:
    """Mirror of `RateLimitReq` (proto/gubernator.proto:133-159)."""

    name: str = ""
    unique_key: str = ""
    hits: int = 0
    limit: int = 0
    duration: int = 0
    algorithm: int = Algorithm.TOKEN_BUCKET
    behavior: int = Behavior.BATCHING

    def hash_key(self) -> str:
        """The cache/shard key: Name + "_" + UniqueKey (client.go:36-38)."""
        return f"{self.name}_{self.unique_key}"

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "uniqueKey": self.unique_key,
            "hits": str(self.hits),
            "limit": str(self.limit),
            "duration": str(self.duration),
            "algorithm": Algorithm(self.algorithm).name,
            "behavior": int(self.behavior),
        }

    @classmethod
    def from_json(cls, d: dict) -> "RateLimitRequest":
        return cls(
            name=d.get("name", ""),
            unique_key=_pick(d, "unique_key", "uniqueKey", default=""),
            hits=_to_int(d.get("hits", 0)),
            limit=_to_int(d.get("limit", 0)),
            duration=_to_int(d.get("duration", 0)),
            algorithm=_parse_enum(d.get("algorithm", 0), Algorithm),
            behavior=_parse_behavior(d.get("behavior", 0)),
        )


@dataclass
class RateLimitResponse:
    """Mirror of `RateLimitResp` (proto/gubernator.proto:166-179)."""

    status: int = Status.UNDER_LIMIT
    limit: int = 0
    remaining: int = 0
    reset_time: int = 0
    error: str = ""
    metadata: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict:
        out = {
            "status": Status(self.status).name,
            "limit": str(self.limit),
            "remaining": str(self.remaining),
            "resetTime": str(self.reset_time),
        }
        if self.error:
            out["error"] = self.error
        if self.metadata:
            out["metadata"] = dict(self.metadata)
        return out

    @classmethod
    def from_json(cls, d: dict) -> "RateLimitResponse":
        return cls(
            status=_parse_enum(d.get("status", 0), Status),
            limit=_to_int(d.get("limit", 0)),
            remaining=_to_int(d.get("remaining", 0)),
            reset_time=_to_int(_pick(d, "reset_time", "resetTime", default=0)),
            error=d.get("error", ""),
            metadata=d.get("metadata", {}) or {},
        )


@dataclass
class GetRateLimitsRequest:
    """Mirror of `GetRateLimitsReq` (proto/gubernator.proto:48-50)."""

    requests: List[RateLimitRequest] = field(default_factory=list)

    def to_json(self) -> dict:
        return {"requests": [r.to_json() for r in self.requests]}

    @classmethod
    def from_json(cls, d: dict) -> "GetRateLimitsRequest":
        return cls(requests=[RateLimitRequest.from_json(r) for r in d.get("requests", [])])


@dataclass
class GetRateLimitsResponse:
    """Mirror of `GetRateLimitsResp` (proto/gubernator.proto:53-55)."""

    responses: List[RateLimitResponse] = field(default_factory=list)

    def to_json(self) -> dict:
        return {"responses": [r.to_json() for r in self.responses]}

    @classmethod
    def from_json(cls, d: dict) -> "GetRateLimitsResponse":
        return cls(responses=[RateLimitResponse.from_json(r) for r in d.get("responses", [])])


@dataclass
class HealthCheckResponse:
    """Mirror of `HealthCheckResp` (proto/gubernator.proto:182-189)."""

    status: str = "healthy"
    message: str = ""
    peer_count: int = 0
    # Peers whose circuit breaker is currently open/half-open (not yet
    # re-trusted); forwarded keys they own are served by degraded local
    # evaluation (faults.py).  JSON-only extension: the reference proto
    # has no such field, so the gRPC wire omits it.
    breaker_open_count: int = 0
    # Daemon build version (the package `__version__`).  JSON-only
    # extension like breaker_open_count: the reference HealthCheckResp
    # proto has no version field, so the gRPC wire omits it.
    version: str = ""

    def to_json(self) -> dict:
        out = {
            "status": self.status,
            "peerCount": self.peer_count,
            "breakerOpenCount": self.breaker_open_count,
        }
        if self.version:
            out["version"] = self.version
        if self.message:
            out["message"] = self.message
        return out

    @classmethod
    def from_json(cls, d: dict) -> "HealthCheckResponse":
        return cls(
            status=d.get("status", ""),
            message=d.get("message", ""),
            peer_count=_to_int(_pick(d, "peer_count", "peerCount", default=0)),
            breaker_open_count=_to_int(
                _pick(d, "breaker_open_count", "breakerOpenCount", default=0)
            ),
            version=d.get("version", ""),
        )


@dataclass
class UpdatePeerGlobal:
    """Mirror of `UpdatePeerGlobal` (proto/peers.proto:52-56)."""

    key: str = ""
    status: RateLimitResponse = field(default_factory=RateLimitResponse)
    algorithm: int = Algorithm.TOKEN_BUCKET

    def to_json(self) -> dict:
        return {
            "key": self.key,
            "status": self.status.to_json(),
            "algorithm": Algorithm(self.algorithm).name,
        }

    @classmethod
    def from_json(cls, d: dict) -> "UpdatePeerGlobal":
        return cls(
            key=d.get("key", ""),
            status=RateLimitResponse.from_json(d.get("status", {}) or {}),
            algorithm=_parse_enum(d.get("algorithm", 0), Algorithm),
        )


@dataclass
class PeerInfo:
    """Mirror of `PeerInfo` (config.go:135-149)."""

    grpc_address: str = ""
    http_address: str = ""
    data_center: str = ""
    is_owner: bool = False  # stamped by the daemon, never serialized

    def to_json(self) -> dict:
        return {
            "grpcAddress": self.grpc_address,
            "httpAddress": self.http_address,
            "dataCenter": self.data_center,
        }

    @classmethod
    def from_json(cls, d: dict) -> "PeerInfo":
        return cls(
            grpc_address=_pick(d, "grpc_address", "grpcAddress", default=""),
            http_address=_pick(d, "http_address", "httpAddress", default=""),
            data_center=_pick(d, "data_center", "dataCenter", default=""),
        )


def _pick(d: dict, *names: str, default=None):
    for n in names:
        if n in d:
            return d[n]
    return default


def _to_int(v) -> int:
    if v is None:
        return 0
    return int(v)


def _parse_enum(v, enum_cls):
    if isinstance(v, str):
        try:
            return enum_cls[v]
        except KeyError:
            return enum_cls(int(v))
    return enum_cls(int(v))


def _parse_behavior(v) -> int:
    # Behavior may arrive as an int bitmask, a flag name, or a list of names.
    if isinstance(v, list):
        out = 0
        for item in v:
            out |= _parse_behavior(item)
        return out
    if isinstance(v, str):
        try:
            return int(v)
        except ValueError:
            return int(Behavior[v])
    return int(v)
