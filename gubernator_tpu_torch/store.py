"""Persistence SPI: Store (continuous) and Loader (startup/shutdown).

Parity with store.go:29-58: `Store.on_change/get/remove` are called
synchronously around every rate-limit evaluation for keys it covers;
`Loader.load/save` run once at daemon start/stop.  Mock implementations
ship in the production package exactly like the reference's
(store.go:60-130) so user test suites can count calls.

Item shapes mirror TokenBucketItem / LeakyBucketItem (store.go:11-24);
leaky `remaining` is a float (the device keeps it fixed-point, the SPI
converts), so user stores written against the reference port directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Protocol, Tuple, Union

from .types import Algorithm, RateLimitRequest, Status


@dataclass
class TokenBucketItem:
    """store.go:18-24"""

    limit: int = 0
    duration: int = 0
    remaining: int = 0
    created_at: int = 0
    status: int = Status.UNDER_LIMIT


@dataclass
class LeakyBucketItem:
    """store.go:11-16"""

    limit: int = 0
    duration: int = 0
    remaining: float = 0.0
    updated_at: int = 0


@dataclass
class CacheItem:
    """cache.go:64-76"""

    algorithm: int = Algorithm.TOKEN_BUCKET
    key: str = ""
    value: Union[TokenBucketItem, LeakyBucketItem, None] = None
    expire_at: int = 0


class Store(Protocol):
    """store.go:29-45.  OnChange receives the item state AFTER the
    request was applied; Get fulfills cache misses; Remove is called on
    explicit removal (RESET_REMAINING, algorithm switch), never on
    expiry."""

    def on_change(self, r: RateLimitRequest, item: CacheItem) -> None: ...

    def get(self, r: RateLimitRequest) -> Tuple[Optional[CacheItem], bool]: ...

    def remove(self, key: str) -> None: ...


class Loader(Protocol):
    """store.go:49-58."""

    def load(self) -> Iterable[CacheItem]: ...

    def save(self, items: Iterator[CacheItem]) -> None: ...


class MockStore:
    """store.go:60-92 — call-counting in-memory store."""

    def __init__(self):
        self.called: Dict[str, int] = {"OnChange()": 0, "Remove()": 0, "Get()": 0}
        self.cache_items: Dict[str, CacheItem] = {}

    def on_change(self, r: RateLimitRequest, item: CacheItem) -> None:
        self.called["OnChange()"] += 1
        self.cache_items[item.key] = item

    def get(self, r: RateLimitRequest) -> Tuple[Optional[CacheItem], bool]:
        self.called["Get()"] += 1
        item = self.cache_items.get(r.hash_key())
        return item, item is not None

    def remove(self, key: str) -> None:
        self.called["Remove()"] += 1
        self.cache_items.pop(key, None)


class MockLoader:
    """store.go:94-130 — call-counting loader."""

    def __init__(self):
        self.called: Dict[str, int] = {"Load()": 0, "Save()": 0}
        self.cache_items: List[CacheItem] = []

    def load(self) -> Iterable[CacheItem]:
        self.called["Load()"] += 1
        return list(self.cache_items)

    def save(self, items: Iterator[CacheItem]) -> None:
        self.called["Save()"] += 1
        self.cache_items.extend(items)
