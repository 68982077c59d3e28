"""64-bit FNV-1 / FNV-1a hashing with an optional C fast path.

The reference uses github.com/segmentio/fasthash fnv1/fnv1a for its
consistent-hash ring (`replicated_hash.go:31,59-64`).  These are the
standard FNV-64 parameter sets, reimplemented here from the published
algorithm.  The batched C++ implementation in the host runtime
(native/host_runtime.cpp) accelerates the hot host-side path of hashing
many keys per request batch; the pure-Python path is the fallback and
the semantics oracle.
"""

from __future__ import annotations

from typing import Iterable, List

_FNV_OFFSET64 = 0xCBF29CE484222325
_FNV_PRIME64 = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a_64(data: bytes) -> int:
    """FNV-1a 64-bit hash (xor, then multiply)."""
    h = _FNV_OFFSET64
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME64) & _MASK64
    return h


def fnv1_64(data: bytes) -> int:
    """FNV-1 64-bit hash (multiply, then xor)."""
    h = _FNV_OFFSET64
    for b in data:
        h = (h * _FNV_PRIME64) & _MASK64
        h ^= b
    return h


def hash_string_64(s: str) -> int:
    """Default key hash: FNV-1a over UTF-8 bytes (replicated_hash.go:31)."""
    return fnv1a_64(s.encode("utf-8"))


def hash_batch_64(keys: Iterable[str]) -> List[int]:
    """FNV-1a-64 over a batch of string keys, in the C++ host runtime
    (native/host_runtime.cpp::gt_fnv1_batch)."""
    from .. import native

    return [int(h) for h in native.fnv1_batch(list(keys), variant_1a=True)]
