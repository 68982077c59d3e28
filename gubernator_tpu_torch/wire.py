"""The wire codecs: GUBC binary frames and the protobuf converters.

The port of the JAX package's wire.py, byte for byte.  The GUBC frames
are the HTTP transport's binary bodies: kinds 1/2 (the columnar peer
hop), 3 (the GLOBAL broadcast), 4 (an ownership transfer), 5/6 (the
public columnar ingress) and 7 (a cross-region batch of the federation
plane).  The dataclasses in `types.py` stay the
in-process currency; protobuf enters only at the gRPC edge, mirroring
how the reference's generated pb types live at its gRPC boundary
(gubernator.pb.go / peers.pb.go).

The generated pb modules (proto/) need `protobuf`, which a machine
that serves only HTTP may not have: they are imported on the first use
of a pb codec, never when this module is imported.
"""

from __future__ import annotations

import json
import struct
import threading
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

import importlib

from .types import (
    GetRateLimitsRequest,
    GetRateLimitsResponse,
    HealthCheckResponse,
    RateLimitRequest,
    RateLimitResponse,
    UpdatePeerGlobal,
)


class _LazyModule:
    """A generated pb module, imported on first attribute access (inside
    the pb codec that needs it)."""

    __slots__ = ("_name", "_mod")

    def __init__(self, name: str):
        self._name = name
        self._mod = None

    def __getattr__(self, attr):
        mod = self._mod
        if mod is None:
            mod = importlib.import_module(self._name, __package__)
            self._mod = mod
        return getattr(mod, attr)


pb = _LazyModule(".proto.gubernator_pb2")
pc_pb = _LazyModule(".proto.peers_columns_pb2")
peers_pb = _LazyModule(".proto.peers_pb2")

# A forwarded batch as parallel columns — the peer-hop currency shared
# by PeerClient (send) and wire codecs (both transports):
# (names, unique_keys, algorithm i32, behavior i32, hits i64, limit
# i64, duration i64), all length n.
PeerColumns = Tuple[Sequence[str], Sequence[str], np.ndarray, np.ndarray,
                    np.ndarray, np.ndarray, np.ndarray]


# ---- RateLimitReq ----------------------------------------------------
def req_to_pb(r: RateLimitRequest) -> pb.RateLimitReq:
    return pb.RateLimitReq(
        name=r.name,
        unique_key=r.unique_key,
        hits=int(r.hits),
        limit=int(r.limit),
        duration=int(r.duration),
        algorithm=int(r.algorithm),
        behavior=int(r.behavior),
    )


def req_from_pb(m: pb.RateLimitReq) -> RateLimitRequest:
    return RateLimitRequest(
        name=m.name,
        unique_key=m.unique_key,
        hits=m.hits,
        limit=m.limit,
        duration=m.duration,
        algorithm=int(m.algorithm),
        behavior=int(m.behavior),
    )


# ---- RateLimitResp ---------------------------------------------------
def resp_to_pb(r: RateLimitResponse) -> pb.RateLimitResp:
    m = pb.RateLimitResp(
        status=int(r.status),
        limit=int(r.limit),
        remaining=int(r.remaining),
        reset_time=int(r.reset_time),
        error=r.error,
    )
    for k, v in (r.metadata or {}).items():
        m.metadata[k] = v
    return m


def resp_from_pb(m: pb.RateLimitResp) -> RateLimitResponse:
    return RateLimitResponse(
        status=int(m.status),
        limit=m.limit,
        remaining=m.remaining,
        reset_time=m.reset_time,
        error=m.error,
        metadata=dict(m.metadata),
    )


# ---- batch envelopes -------------------------------------------------
def get_rate_limits_req_to_pb(req: GetRateLimitsRequest) -> pb.GetRateLimitsReq:
    return pb.GetRateLimitsReq(requests=[req_to_pb(r) for r in req.requests])


def get_rate_limits_req_from_pb(m: pb.GetRateLimitsReq) -> GetRateLimitsRequest:
    return GetRateLimitsRequest(requests=[req_from_pb(r) for r in m.requests])


def get_rate_limits_resp_to_pb(resp: GetRateLimitsResponse) -> pb.GetRateLimitsResp:
    return pb.GetRateLimitsResp(responses=[resp_to_pb(r) for r in resp.responses])


def get_rate_limits_resp_from_pb(m: pb.GetRateLimitsResp) -> GetRateLimitsResponse:
    return GetRateLimitsResponse(responses=[resp_from_pb(r) for r in m.responses])


def peer_rate_limits_req_to_pb(req: GetRateLimitsRequest) -> peers_pb.GetPeerRateLimitsReq:
    return peers_pb.GetPeerRateLimitsReq(requests=[req_to_pb(r) for r in req.requests])


def peer_rate_limits_req_from_pb(m: peers_pb.GetPeerRateLimitsReq) -> GetRateLimitsRequest:
    return GetRateLimitsRequest(requests=[req_from_pb(r) for r in m.requests])


def peer_rate_limits_resp_to_pb(resp: GetRateLimitsResponse) -> peers_pb.GetPeerRateLimitsResp:
    return peers_pb.GetPeerRateLimitsResp(rate_limits=[resp_to_pb(r) for r in resp.responses])


def peer_rate_limits_resp_from_pb(m: peers_pb.GetPeerRateLimitsResp) -> GetRateLimitsResponse:
    return GetRateLimitsResponse(responses=[resp_from_pb(r) for r in m.rate_limits])


# ---- columnar fast path ---------------------------------------------
def columns_from_pb(m: pb.GetRateLimitsReq):
    """Parse the pb batch straight into ingress columns (the gRPC half
    of the zero-dataclass hot path)."""
    import numpy as np

    from .service import IngressColumns

    items = m.requests
    n = len(items)
    return IngressColumns(
        names=[r.name for r in items],
        unique_keys=[r.unique_key for r in items],
        algorithm=np.fromiter((r.algorithm for r in items), np.int32, count=n),
        behavior=np.fromiter((r.behavior for r in items), np.int32, count=n),
        hits=np.fromiter((r.hits for r in items), np.int64, count=n),
        limit=np.fromiter((r.limit for r in items), np.int64, count=n),
        duration=np.fromiter((r.duration for r in items), np.int64, count=n),
    )


def _columns_to_resp_list(result):
    ov = result.overrides
    status = result.status
    limit = result.limit
    remaining = result.remaining
    reset = result.reset_time
    owner_of = getattr(result, "owner_of", None)
    owner_addrs = getattr(result, "owner_addrs", None)
    out = []
    for i in range(result.n):
        r = ov.get(i)
        if r is not None:
            out.append(resp_to_pb(r))
        else:
            m = pb.RateLimitResp(
                status=int(status[i]),
                limit=int(limit[i]),
                remaining=int(remaining[i]),
                reset_time=int(reset[i]),
            )
            if owner_of is not None and owner_of[i] >= 0:
                # Forwarded lane: the owner's address rides metadata
                # (gubernator.go:190,209 parity) without a per-lane
                # dataclass on the fast path.
                m.metadata["owner"] = owner_addrs[owner_of[i]]
            out.append(m)
    return out


def columns_to_pb(result) -> pb.GetRateLimitsResp:
    """Serialize a service.ColumnarResult directly from its arrays."""
    return pb.GetRateLimitsResp(responses=_columns_to_resp_list(result))


def columns_to_peer_pb(result) -> peers_pb.GetPeerRateLimitsResp:
    """PeersV1 twin of columns_to_pb (field name rate_limits,
    peers.proto:42-45)."""
    return peers_pb.GetPeerRateLimitsResp(rate_limits=_columns_to_resp_list(result))


# ---- columnar peer hop (zero-dataclass forwarded path) ---------------
#
# Two encodings of the same PeerColumns batch (architecture.md
# "Columnar pipeline: the peer hop"):
#   * proto columns (peers_columns.proto) for the gRPC transport —
#     served as PeersV1/GetPeerRateLimitsColumns; old peers answer
#     UNIMPLEMENTED and the sender falls back to the classic
#     per-request GetPeerRateLimits encoding.
#   * a compact binary frame for the HTTP transport — POSTed to the
#     SAME /v1/peer.GetPeerRateLimits path; the receiver sniffs the
#     magic (JSON bodies can never start with it), old receivers
#     answer 400 and the sender falls back to per-request JSON.
#
# Neither direction materializes a RateLimitRequest/RateLimitResponse
# per lane: requests decode straight into service.IngressColumns,
# responses into a service.ColumnarResult whose sparse overrides
# (error/metadata lanes) are the only per-lane objects.

FRAME_MAGIC = b"GUBC"
FRAME_VERSION = 1
_FRAME_KIND_REQ = 1
_FRAME_KIND_RESP = 2
# Public V1 ingress twins of kinds 1/2 (architecture.md "Columnar
# pipeline: the front door"): the SAME column layout magic-sniffed on
# POST /v1/GetRateLimits.  A distinct kind byte (not a path) carries
# the public/peer distinction because the public response must carry
# the owner annotation (forwarded lanes' metadata.owner) that the peer
# hop never needs — kind 6 appends it as two columns.
_FRAME_KIND_INGRESS_REQ = 5
_FRAME_KIND_INGRESS_RESP = 6
COLUMNS_CONTENT_TYPE = "application/x-gubernator-columns"


_FRAME_HEADER_LEN = 10  # magic(4) + version(1) + kind(1) + n(4)

# Optional trace-context trailer on a request frame (tracing.py): after
# the seven columns, `TRACE_MAGIC | u32 n_entries | n_entries * 32B`
# where each entry is `<II` lane_lo, lane_hi (exclusive) + 16B trace id
# + 8B span id (big-endian, the traceparent byte order).  Entries are
# lane RANGES because a coalesced RPC's lanes arrive as contiguous
# per-ingress-batch runs that share one context.  A frame without the
# trailer is byte-identical to the pre-trace layout (the
# GUBER_TRACE_SAMPLE=0 wire-parity contract); receivers that predate
# the trailer reject it as a length mismatch, which the sender treats
# as a version answer and renegotiates (peer_client._post_columns_inner).
TRACE_MAGIC = b"GTRC"
_TRACE_ENTRY_LEN = 32

# (lane_lo, lane_hi, trace_id 128-bit int, span_id 64-bit int)
TraceEntry = Tuple[int, int, int, int]


def _pack_trace_entry(entry: TraceEntry) -> bytes:
    """THE 32-byte entry layout, shared by the frame trailer and the
    proto column (one codec: a format change lands everywhere)."""
    lo, hi, tid, sid = entry
    return (
        struct.pack("<II", lo, hi)
        + int(tid).to_bytes(16, "big")
        + int(sid).to_bytes(8, "big")
    )


def _unpack_trace_entry(raw: bytes, pos: int = 0) -> TraceEntry:
    lo, hi = struct.unpack_from("<II", raw, pos)
    return (
        lo, hi,
        int.from_bytes(raw[pos + 8:pos + 24], "big"),
        int.from_bytes(raw[pos + 24:pos + 32], "big"),
    )


def pack_trace_entries(entries: Sequence[TraceEntry]) -> bytes:
    parts = [TRACE_MAGIC, struct.pack("<I", len(entries))]
    parts.extend(_pack_trace_entry(e) for e in entries)
    return b"".join(parts)


def unpack_trace_entries(raw: bytes, pos: int) -> Tuple[list, int]:
    """Parse a trace trailer at `pos`; raises ValueError when
    malformed/truncated (the decode edge maps it to a 400)."""
    if raw[pos:pos + 4] != TRACE_MAGIC:
        raise ValueError("columns frame length mismatch")
    pos += 4
    try:
        (count,) = struct.unpack_from("<I", raw, pos)
    except struct.error:
        raise ValueError("trace trailer truncated") from None
    pos += 4
    if pos + count * _TRACE_ENTRY_LEN > len(raw):
        raise ValueError("trace trailer truncated")
    entries = []
    for _ in range(count):
        entries.append(_unpack_trace_entry(raw, pos))
        pos += _TRACE_ENTRY_LEN
    return entries, pos


def is_columns_frame(raw: bytes) -> bool:
    return len(raw) >= _FRAME_HEADER_LEN and raw[:4] == FRAME_MAGIC


def _pack_str_column(strs: Sequence[str]) -> bytes:
    """u32 blob_len | u32 offsets[n+1] | utf-8 blob (byte offsets)."""
    parts = [s.encode("utf-8") for s in strs]
    offsets = np.zeros(len(parts) + 1, dtype=np.uint32)
    if parts:
        np.cumsum([len(p) for p in parts], out=offsets[1:])
    blob = b"".join(parts)
    return struct.pack("<I", len(blob)) + offsets.tobytes() + blob


def _read_array(raw: bytes, pos: int, dtype, n: int):
    try:
        arr = np.frombuffer(raw, dtype=dtype, count=n, offset=pos)
    except ValueError:
        raise ValueError("columns frame truncated") from None
    return arr, pos + arr.nbytes


def encode_columns_frame(
    cols: PeerColumns, trace: "Optional[Sequence[TraceEntry]]" = None,
    kind: int = _FRAME_KIND_REQ,
) -> bytes:
    """PeerColumns -> binary request frame (see architecture.md for the
    byte-level spec).  `trace` (sampled lanes' contexts) appends the
    optional trace trailer; None/empty keeps the frame byte-identical
    to the pre-trace layout.  `kind` selects the peer hop (1, default)
    or the public ingress twin (5) — same byte layout either way."""
    names, uks, algo, beh, hits, limit, duration = cols
    n = len(names)
    parts = [
        FRAME_MAGIC,
        struct.pack("<BBI", FRAME_VERSION, kind, n),
        _pack_str_column(names),
        _pack_str_column(uks),
        np.ascontiguousarray(algo, dtype=np.int32).tobytes(),
        np.ascontiguousarray(beh, dtype=np.int32).tobytes(),
        np.ascontiguousarray(hits, dtype=np.int64).tobytes(),
        np.ascontiguousarray(limit, dtype=np.int64).tobytes(),
        np.ascontiguousarray(duration, dtype=np.int64).tobytes(),
    ]
    if trace:
        parts.append(pack_trace_entries(trace))
    return b"".join(parts)


def _read_str_blob(raw: bytes, pos: int, n: int):
    """(offsets u32[n+1], blob bytes, next_pos) — no string decode."""
    try:
        (blob_len,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        offsets = np.frombuffer(raw, dtype=np.uint32, count=n + 1, offset=pos)
    except (struct.error, ValueError):
        raise ValueError("columns frame truncated") from None
    pos += 4 * (n + 1)
    blob = raw[pos:pos + blob_len]
    if len(blob) != blob_len or (n and int(offsets[-1]) != blob_len):
        raise ValueError("columns frame string column truncated")
    if n and (
        int(offsets[0]) != 0
        or bool(np.any(np.diff(offsets.astype(np.int64)) < 0))
    ):
        # Non-monotonic offsets would later surface as negative lengths
        # deep inside the service (a 500); reject at the decode edge
        # where the caller maps it to a 400.
        raise ValueError("columns frame string offsets invalid")
    return offsets, blob, pos + blob_len


def _packed_hash_keys(nb: bytes, no, ub: bytes, uo):
    """Build the per-lane hash keys (name + "_" + unique_key) as a
    native.PackedKeys with ONE vectorized byte scatter — the owner's
    planner consumes packed keys directly, so the receive path never
    materializes n Python strings."""
    from .native import PackedKeys

    no64 = no.astype(np.int64)
    uo64 = uo.astype(np.int64)
    nlen = np.diff(no64)
    ulen = np.diff(uo64)
    n = len(nlen)
    out_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(nlen + 1 + ulen, out=out_off[1:])
    buf = np.empty(int(out_off[-1]), dtype=np.uint8)
    nb_a = np.frombuffer(nb, dtype=np.uint8)
    ub_a = np.frombuffer(ub, dtype=np.uint8)
    if nb_a.size:
        buf[
            np.arange(nb_a.size, dtype=np.int64)
            + np.repeat(out_off[:-1] - no64[:-1], nlen)
        ] = nb_a
    buf[out_off[:-1] + nlen] = ord("_")
    if ub_a.size:
        buf[
            np.arange(ub_a.size, dtype=np.int64)
            + np.repeat(out_off[:-1] + nlen + 1 - uo64[:-1], ulen)
        ] = ub_a
    return PackedKeys(buf, out_off)


class FrameIngressColumns:
    """service.IngressColumns twin decoded LAZILY from a binary frame:
    numeric columns are zero-copy views of the frame buffer, hash keys
    come packed (prevalidated — forwarded lanes were validated at the
    sender's ingress, so the error column is all-zero), and
    name/unique_key strings only materialize for the lanes that need
    dataclasses (GLOBAL / MULTI_REGION / slow legs)."""

    __slots__ = ("algorithm", "behavior", "hits", "limit", "duration",
                 "_n", "_nb", "_no", "_ub", "_uo", "_names", "_uks",
                 "trace_ctx", "_err", "_packed")

    def __init__(self, n, nb, no, ub, uo, algo, beh, hits, limit, duration,
                 trace_ctx=None, err=None, packed=None):
        self._n = n
        self._nb, self._no = nb, no
        self._ub, self._uo = ub, uo
        self.algorithm = algo
        self.behavior = beh
        self.hits = hits
        self.limit = limit
        self.duration = duration
        self._names = None
        self._uks = None
        # Wire trace-context column (lane ranges -> trace/span ids);
        # consumed by tracing.request_links on the owner's dispatch.
        self.trace_ctx = trace_ctx
        # Public-ingress validation codes (1 = empty unique_key, 2 =
        # empty name; the LazyIngressColumns convention).  None on the
        # peer hop — forwarded lanes were validated at the sender's
        # ingress, so the error column is all-zero by contract.
        self._err = err
        # Pre-built packed hash keys (the native gt_frame_parse hands
        # them over ready); None = build with the numpy scatter.
        self._packed = packed

    def __len__(self) -> int:
        return self._n

    @property
    def prevalidated(self):
        packed = self._packed
        if packed is None:
            packed = _packed_hash_keys(self._nb, self._no, self._ub, self._uo)
        err = self._err
        if err is None:
            err = np.zeros(self._n, dtype=np.uint8)
        return packed, err

    def _name_at(self, i: int) -> str:
        return self._nb[self._no[i]:self._no[i + 1]].decode("utf-8")

    def _uk_at(self, i: int) -> str:
        return self._ub[self._uo[i]:self._uo[i + 1]].decode("utf-8")

    @property
    def names(self):
        if self._names is None:
            self._names = [self._name_at(i) for i in range(self._n)]
        return self._names

    @property
    def unique_keys(self):
        if self._uks is None:
            self._uks = [self._uk_at(i) for i in range(self._n)]
        return self._uks

    def request_at(self, i: int) -> RateLimitRequest:
        return RateLimitRequest(
            name=self._name_at(i),
            unique_key=self._uk_at(i),
            hits=int(self.hits[i]),
            limit=int(self.limit[i]),
            duration=int(self.duration[i]),
            algorithm=int(self.algorithm[i]),
            behavior=int(self.behavior[i]),
        )


def _decode_req_frame(raw: bytes, want_kind: int, validate: bool):
    """Shared body of the two request-frame decoders.  `validate` is
    the public-ingress mode: compute per-lane empty-name/unique_key
    codes (untrusted client) and range-check the algorithm column; the
    peer hop skips both (sender-side ingress already validated)."""
    if not is_columns_frame(raw):
        raise ValueError("not a columns frame")
    version, kind, n = struct.unpack_from("<BBI", raw, 4)
    if version != FRAME_VERSION or kind != want_kind:
        raise ValueError(
            f"unsupported columns frame (version={version}, kind={kind})"
        )
    pos = 10
    no, nb, pos = _read_str_blob(raw, pos, n)
    uo, ub, pos = _read_str_blob(raw, pos, n)
    algo, pos = _read_array(raw, pos, np.int32, n)
    beh, pos = _read_array(raw, pos, np.int32, n)
    hits, pos = _read_array(raw, pos, np.int64, n)
    limit, pos = _read_array(raw, pos, np.int64, n)
    duration, pos = _read_array(raw, pos, np.int64, n)
    trace_ctx = None
    if pos != len(raw):
        # The only legal continuation is the trace-context trailer
        # (tracing.py); anything else is still a length mismatch.
        trace_ctx, pos = unpack_trace_entries(raw, pos)
        if pos != len(raw):
            raise ValueError("columns frame length mismatch")
    if validate and n and bool(np.any((algo < 0) | (algo > 1))):
        # An out-of-range algorithm would reach the kernel as a
        # garbage branch selector; reject the frame at the decode
        # edge (the gateway maps it to a 400) — the client library
        # only ever emits 0/1.
        raise ValueError("ingress frame algorithm out of range")
    if validate:
        _check_utf8_blobs(nb, ub)
    # The port always has its host runtime (the planner needs it), so
    # the lazy form is the only one: the JAX decode's eager
    # IngressColumns branch serves a build without its runtime.
    err = None
    if validate and n:
        # Per-lane validation codes, consumed via `prevalidated`.
        err = np.zeros(n, dtype=np.uint8)
        err[np.diff(no.astype(np.int64)) == 0] = 2  # empty name
        err[np.diff(uo.astype(np.int64)) == 0] = 1  # empty unique_key
    return FrameIngressColumns(
        n, nb, no, ub, uo, algo, beh, hits, limit, duration,
        trace_ctx=trace_ctx, err=err,
    )


def _check_utf8_blobs(nb: bytes, ub: bytes) -> None:
    """Public-edge string validation: the lazy decode paths defer
    per-lane .decode('utf-8') into the service's slow legs, where
    invalid bytes from an untrusted client would surface as a 500 deep
    in routing (failing every coalesced rider) instead of a 400 here —
    and would make the native and fallback builds answer the same
    frame differently.  One whole-blob decode per column; trusted peer
    frames skip this (their strings were validated at the sender's
    ingress)."""
    try:
        nb.decode("utf-8")
        ub.decode("utf-8")
    except UnicodeDecodeError:
        raise ValueError(
            "columns frame strings are not valid utf-8"
        ) from None


def decode_columns_frame(raw: bytes):
    """Binary request frame -> ingress columns (the receiver half of
    the zero-dataclass peer hop): a lazy FrameIngressColumns (packed
    hash keys for the planner, no per-lane strings).  Raises ValueError
    on a malformed/foreign frame."""
    return _decode_req_frame(raw, _FRAME_KIND_REQ, validate=False)


# ---- public columnar ingress (the front door) ------------------------
#
# The peer hop's columnar playbook applied to the CLIENT->daemon hop (architecture.md
# "Columnar pipeline: the front door"): a GUBC frame (kind 5, same
# column layout as the peer hop) magic-sniffed on the existing
# POST /v1/GetRateLimits path, or proto columns served as
# V1/GetRateLimitsColumns on the gRPC transport.  The response is a
# kind-6 frame / IngressColumnsResp: the kind-2 layout plus the owner
# annotation (owner_of i32[n] + owner address column) so forwarded
# lanes keep their metadata.owner without a per-lane JSON override.
# A daemon with GUBER_INGRESS_COLUMNS=0 never sniffs: the frame falls
# into json.loads and answers 400 exactly like a pre-columns build —
# that IS the client's version probe (sticky classic fallback).

def is_ingress_frame(raw: bytes) -> bool:
    return is_columns_frame(raw) and raw[5] == _FRAME_KIND_INGRESS_REQ


def encode_ingress_frame(
    cols: PeerColumns, trace: "Optional[Sequence[TraceEntry]]" = None
) -> bytes:
    """PeerColumns -> public ingress request frame (kind 5; byte layout
    of the kind-1 peer frame, trace trailer rules included)."""
    return encode_columns_frame(cols, trace=trace, kind=_FRAME_KIND_INGRESS_REQ)


def decode_ingress_frame(raw: bytes):
    """Public ingress frame -> ingress columns.  Unlike the peer hop
    the sender is UNTRUSTED: empty-name/unique_key lanes get per-lane
    validation codes (the service answers them per lane, JSON parity)
    and an out-of-range algorithm rejects the frame.  Tries the native
    single-pass parser first (gt_frame_parse: validation, column
    slicing and the packed hash-key scatter all before Python-level
    work); falls back to the numpy decode."""
    from . import native

    cols = native.parse_ingress_frame(raw)
    if cols is not None:
        return cols
    return _decode_req_frame(raw, _FRAME_KIND_INGRESS_REQ, validate=True)


def is_ingress_result_frame(raw: bytes) -> bool:
    return is_columns_frame(raw) and raw[5] == _FRAME_KIND_INGRESS_RESP


def encode_ingress_result_frame(result) -> bytes:
    """service.ColumnarResult -> public ingress response frame (kind
    6): the kind-2 arrays + `u32 n_owner_addrs [str column owner_addrs
    | i32 owner_of[n]]` + the sparse override pairs.  Owner columns are
    written only when the batch had forwarded lanes (n_owner_addrs=0
    otherwise), so a purely-local batch costs 4 extra bytes."""
    owner_addrs = result.owner_addrs if result.owner_of is not None else []
    parts = [
        FRAME_MAGIC,
        struct.pack("<BBI", FRAME_VERSION, _FRAME_KIND_INGRESS_RESP, result.n),
        *_result_array_parts(result),
        struct.pack("<I", len(owner_addrs)),
    ]
    if owner_addrs:
        parts.append(_pack_str_column(owner_addrs))
        parts.append(
            np.ascontiguousarray(result.owner_of, dtype=np.int32).tobytes()
        )
    _append_override_parts(parts, result.overrides)
    return b"".join(parts)


def decode_ingress_result_frame(raw: bytes):
    """Public ingress response frame -> service.ColumnarResult (client
    side: response_at / the waiter scatter reads owner metadata off the
    arrays, no per-lane dataclasses)."""
    from .service import ColumnarResult

    if not is_columns_frame(raw):
        raise ValueError("not a columns frame")
    version, kind, n = struct.unpack_from("<BBI", raw, 4)
    if version != FRAME_VERSION or kind != _FRAME_KIND_INGRESS_RESP:
        raise ValueError(
            f"unsupported columns frame (version={version}, kind={kind})"
        )
    status, limit, remaining, reset_time, pos = _read_result_arrays(raw, 10, n)
    owner_addrs: list = []
    owner_of = None
    try:
        (n_addr,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        if n_addr:
            ao, ab, pos = _read_str_blob(raw, pos, n_addr)
            owner_addrs = [
                ab[ao[i]:ao[i + 1]].decode("utf-8") for i in range(n_addr)
            ]
            owner_of, pos = _read_array(raw, pos, np.int32, n)
    except struct.error:
        raise ValueError("columns frame truncated") from None
    overrides, pos = _read_overrides(raw, pos)
    if pos != len(raw):
        raise ValueError("columns frame length mismatch")
    return ColumnarResult(
        n=n, status=status, limit=limit, remaining=remaining,
        reset_time=reset_time, overrides=overrides,
        owner_addrs=owner_addrs,
        owner_of=None if owner_of is None else np.array(owner_of),
    )


def result_to_ingress_columns_pb(result) -> "pc_pb.IngressColumnsResp":
    """ColumnarResult -> proto columns response for the public
    V1/GetRateLimitsColumns RPC (kind-6 twin on the gRPC transport)."""
    m = _fill_result_columns_pb(pc_pb.IngressColumnsResp(), result)
    if result.owner_of is not None:
        m.owner_of.extend(np.asarray(result.owner_of, dtype=np.int32).tolist())
        m.owner_addrs.extend(result.owner_addrs)
    return m


def result_from_ingress_columns_pb(m) -> "object":
    from .service import ColumnarResult

    n = len(m.status)
    owner_of = None
    if len(m.owner_of):
        owner_of = np.fromiter(m.owner_of, np.int32, count=len(m.owner_of))
    return ColumnarResult(
        n=n,
        status=np.fromiter(m.status, np.int32, count=n),
        limit=np.fromiter(m.limit, np.int64, count=n),
        remaining=np.fromiter(m.remaining, np.int64, count=n),
        reset_time=np.fromiter(m.reset_time, np.int64, count=n),
        overrides={int(o.lane): resp_from_pb(o.resp) for o in m.overrides},
        owner_addrs=list(m.owner_addrs),
        owner_of=owner_of,
    )


def _result_array_parts(result) -> list:
    """The four result arrays' wire bytes — the section kinds 2 and 6
    share (one encoder: a layout change lands in both)."""
    return [
        np.ascontiguousarray(result.status, dtype=np.int32).tobytes(),
        np.ascontiguousarray(result.limit, dtype=np.int64).tobytes(),
        np.ascontiguousarray(result.remaining, dtype=np.int64).tobytes(),
        np.ascontiguousarray(result.reset_time, dtype=np.int64).tobytes(),
    ]


def _append_override_parts(parts: list, overrides) -> None:
    """Sparse (lane, json) override pairs — the trailer kinds 2 and 6
    share; the only per-lane encode work on a result."""
    parts.append(struct.pack("<I", len(overrides)))
    for lane, resp in overrides.items():
        body = json.dumps(resp.to_json(), separators=(",", ":")).encode("utf-8")
        parts.append(struct.pack("<II", int(lane), len(body)))
        parts.append(body)


def _read_result_arrays(raw: bytes, pos: int, n: int):
    status, pos = _read_array(raw, pos, np.int32, n)
    limit, pos = _read_array(raw, pos, np.int64, n)
    remaining, pos = _read_array(raw, pos, np.int64, n)
    reset_time, pos = _read_array(raw, pos, np.int64, n)
    return status, limit, remaining, reset_time, pos


def _read_overrides(raw: bytes, pos: int):
    try:
        (n_ov,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        overrides = {}
        for _ in range(n_ov):
            lane, blen = struct.unpack_from("<II", raw, pos)
            pos += 8
            if pos + blen > len(raw):
                raise ValueError("columns frame truncated")
            overrides[int(lane)] = RateLimitResponse.from_json(
                json.loads(raw[pos:pos + blen])
            )
            pos += blen
    except struct.error:
        raise ValueError("columns frame truncated") from None
    return overrides, pos


def encode_result_frame(result) -> bytes:
    """service.ColumnarResult -> binary response frame.  Plain lanes
    ride the arrays; overrides (error/metadata lanes) ride as sparse
    (lane, json) pairs — the only per-lane encode work."""
    parts = [
        FRAME_MAGIC,
        struct.pack("<BBI", FRAME_VERSION, _FRAME_KIND_RESP, result.n),
        *_result_array_parts(result),
    ]
    _append_override_parts(parts, result.overrides)
    return b"".join(parts)


def decode_result_frame(raw: bytes):
    """Binary response frame -> service.ColumnarResult (client side:
    the sender scatters these arrays into its own result arrays)."""
    from .service import ColumnarResult

    if not is_columns_frame(raw):
        raise ValueError("not a columns frame")
    version, kind, n = struct.unpack_from("<BBI", raw, 4)
    if version != FRAME_VERSION or kind != _FRAME_KIND_RESP:
        raise ValueError(
            f"unsupported columns frame (version={version}, kind={kind})"
        )
    status, limit, remaining, reset_time, pos = _read_result_arrays(raw, 10, n)
    overrides, pos = _read_overrides(raw, pos)
    if pos != len(raw):
        raise ValueError("columns frame length mismatch")
    return ColumnarResult(
        n=n, status=status, limit=limit, remaining=remaining,
        reset_time=reset_time, overrides=overrides,
    )


# -- proto columns (gRPC transport) ------------------------------------
def peer_columns_req_to_pb(
    cols: PeerColumns, trace: "Optional[Sequence[TraceEntry]]" = None
) -> pc_pb.PeerColumnsReq:
    names, uks, algo, beh, hits, limit, duration = cols
    m = pc_pb.PeerColumnsReq()
    m.names.extend(names)
    m.unique_keys.extend(uks)
    m.algorithm.extend(np.asarray(algo, dtype=np.int32).tolist())
    m.behavior.extend(np.asarray(beh, dtype=np.int32).tolist())
    m.hits.extend(np.asarray(hits, dtype=np.int64).tolist())
    m.limit.extend(np.asarray(limit, dtype=np.int64).tolist())
    m.duration.extend(np.asarray(duration, dtype=np.int64).tolist())
    if trace:
        # One 32-byte packed entry per field element; proto3 receivers
        # that predate the field skip it as an unknown field (that IS
        # the negotiation: no probe needed on this transport).
        m.trace.extend(_pack_trace_entry(e) for e in trace)
    return m


def _trace_entries_from_pb(m) -> "Optional[list]":
    entries = [
        _unpack_trace_entry(raw)
        for raw in getattr(m, "trace", ())
        if len(raw) == _TRACE_ENTRY_LEN  # skip foreign/corrupt entries
    ]
    return entries or None


def ingress_from_peer_columns_pb(m: pc_pb.PeerColumnsReq):
    from .service import IngressColumns

    n = len(m.names)
    return IngressColumns(
        names=list(m.names),
        unique_keys=list(m.unique_keys),
        algorithm=np.fromiter(m.algorithm, np.int32, count=n),
        behavior=np.fromiter(m.behavior, np.int32, count=n),
        hits=np.fromiter(m.hits, np.int64, count=n),
        limit=np.fromiter(m.limit, np.int64, count=n),
        duration=np.fromiter(m.duration, np.int64, count=n),
        trace_ctx=_trace_entries_from_pb(m),
    )


def _fill_result_columns_pb(m, result):
    """Shared column fill for PeerColumnsResp / IngressColumnsResp
    (same field numbers 1-5; the ingress twin adds owners on top)."""
    m.status.extend(np.asarray(result.status, dtype=np.int32).tolist())
    m.limit.extend(np.asarray(result.limit, dtype=np.int64).tolist())
    m.remaining.extend(np.asarray(result.remaining, dtype=np.int64).tolist())
    m.reset_time.extend(np.asarray(result.reset_time, dtype=np.int64).tolist())
    for lane, resp in result.overrides.items():
        ov = m.overrides.add()
        ov.lane = int(lane)
        ov.resp.CopyFrom(resp_to_pb(resp))
    return m


def result_to_peer_columns_pb(result) -> pc_pb.PeerColumnsResp:
    return _fill_result_columns_pb(pc_pb.PeerColumnsResp(), result)


def result_from_peer_columns_pb(m: pc_pb.PeerColumnsResp):
    from .service import ColumnarResult

    n = len(m.status)
    return ColumnarResult(
        n=n,
        status=np.fromiter(m.status, np.int32, count=n),
        limit=np.fromiter(m.limit, np.int64, count=n),
        remaining=np.fromiter(m.remaining, np.int64, count=n),
        reset_time=np.fromiter(m.reset_time, np.int64, count=n),
        overrides={int(o.lane): resp_from_pb(o.resp) for o in m.overrides},
    )


def peer_columns_slice(cols: PeerColumns, lo: int, hi: int) -> PeerColumns:
    """Lane slice of a PeerColumns batch (the classic-downgrade resend
    must re-chunk an oversized columnar chunk to MAX_BATCH_SIZE)."""
    names, uks, algo, beh, hits, limit, duration = cols
    return (
        names[lo:hi], uks[lo:hi], algo[lo:hi], beh[lo:hi],
        hits[lo:hi], limit[lo:hi], duration[lo:hi],
    )


def concat_results(parts):
    """Concatenate ColumnarResults lane-wise (the inverse of
    peer_columns_slice for the classic-downgrade resend)."""
    from .service import ColumnarResult

    if len(parts) == 1:
        return parts[0]
    out = ColumnarResult.empty(sum(p.n for p in parts))
    lo = 0
    for p in parts:
        sl = slice(lo, lo + p.n)
        out.status[sl] = p.status
        out.limit[sl] = p.limit
        out.remaining[sl] = p.remaining
        out.reset_time[sl] = p.reset_time
        for lane, r in p.overrides.items():
            out.overrides[lo + int(lane)] = r
        lo += p.n
    return out


# -- classic fallback, built from columns ------------------------------
# The mixed-version slow lane: a peer that doesn't speak columns still
# receives a correct classic batch.  Per-lane pb/JSON objects are built
# here (the wire format demands them), but still no dataclasses.
def peer_columns_to_classic_pb(cols: PeerColumns) -> peers_pb.GetPeerRateLimitsReq:
    names, uks, algo, beh, hits, limit, duration = cols
    return peers_pb.GetPeerRateLimitsReq(
        requests=[
            pb.RateLimitReq(
                name=names[i], unique_key=uks[i], hits=int(hits[i]),
                limit=int(limit[i]), duration=int(duration[i]),
                algorithm=int(algo[i]), behavior=int(beh[i]),
            )
            for i in range(len(names))
        ]
    )


def result_from_classic_peer_pb(m: peers_pb.GetPeerRateLimitsResp):
    """Classic per-request response -> ColumnarResult: plain lanes fill
    the arrays, error/metadata lanes become overrides."""
    from .service import ColumnarResult

    items = m.rate_limits
    n = len(items)
    result = ColumnarResult.empty(n)
    for i, r in enumerate(items):
        if r.error or r.metadata:
            result.overrides[i] = resp_from_pb(r)
        else:
            result.status[i] = r.status
            result.limit[i] = r.limit
            result.remaining[i] = r.remaining
            result.reset_time[i] = r.reset_time
    return result


def peer_columns_to_classic_json(cols: PeerColumns) -> dict:
    names, uks, algo, beh, hits, limit, duration = cols
    from .types import Algorithm

    return {
        "requests": [
            {
                "name": names[i],
                "uniqueKey": uks[i],
                "hits": str(int(hits[i])),
                "limit": str(int(limit[i])),
                "duration": str(int(duration[i])),
                "algorithm": Algorithm(int(algo[i])).name,
                "behavior": int(beh[i]),
            }
            for i in range(len(names))
        ]
    }


def _result_from_classic_items(items: list):
    """Classic per-response JSON objects -> ColumnarResult: plain lanes
    fill the arrays, error/metadata lanes become overrides.  Shared by
    the peer ("rateLimits") and public-ingress ("responses") envelopes
    so the two decoders cannot drift."""
    from .service import ColumnarResult
    from .types import Status, _parse_enum

    n = len(items)
    result = ColumnarResult.empty(n)
    for i, d in enumerate(items):
        if d.get("error") or d.get("metadata"):
            result.overrides[i] = RateLimitResponse.from_json(d)
        else:
            result.status[i] = int(_parse_enum(d.get("status", 0), Status))
            result.limit[i] = int(d.get("limit", 0))
            result.remaining[i] = int(d.get("remaining", 0))
            result.reset_time[i] = int(
                d.get("resetTime", d.get("reset_time", 0))
            )
    return result


def result_from_classic_peer_json(body: dict):
    """Classic {"rateLimits": [...]} JSON response -> ColumnarResult."""
    return _result_from_classic_items(body.get("rateLimits", []))


def result_from_classic_ingress_json(body: dict):
    """Classic {"responses": [...]} JSON (the public /v1/GetRateLimits
    shape) -> ColumnarResult — the columns client's downgraded-receive
    twin of result_from_classic_peer_json."""
    return _result_from_classic_items(body.get("responses", []))


# ---- GLOBAL broadcast ------------------------------------------------
#
# Columnar replication plane (architecture.md "GLOBAL plane"): the
# owner's sync pass emits its broadcasts as one GlobalsColumns batch
# and fans the SAME encoded payload to every peer.  Two encodings of
# the batch, mirroring the peer-forward hop:
#   * proto columns (GlobalsColumnsReq) for the gRPC transport — served
#     as PeersV1/UpdatePeerGlobalsColumns; old peers answer
#     UNIMPLEMENTED and the sender falls back to the classic per-item
#     UpdatePeerGlobals encoding.
#   * a GUBC frame (kind 3) for the HTTP transport, POSTed to the SAME
#     /v1/peer.UpdatePeerGlobals path; the receiver sniffs the magic
#     (JSON bodies can never start with it), old receivers answer
#     4xx/"codec can't decode" and the sender falls back to per-item
#     JSON.
# BroadcastBatch caches every encoding, so an N-peer fan-out encodes
# each at most once per tick.

_FRAME_KIND_GLOBALS = 3


def is_globals_frame(raw: bytes) -> bool:
    return is_columns_frame(raw) and raw[5] == _FRAME_KIND_GLOBALS


def encode_globals_frame(cols) -> bytes:
    """GlobalsColumns -> binary broadcast frame: GUBC header (kind 3)
    + key string column + algo/status i32 + limit/remaining/reset i64."""
    n = len(cols.keys)
    return b"".join(
        (
            FRAME_MAGIC,
            struct.pack("<BBI", FRAME_VERSION, _FRAME_KIND_GLOBALS, n),
            _pack_str_column(cols.keys),
            np.ascontiguousarray(cols.algorithm, dtype=np.int32).tobytes(),
            np.ascontiguousarray(cols.status, dtype=np.int32).tobytes(),
            np.ascontiguousarray(cols.limit, dtype=np.int64).tobytes(),
            np.ascontiguousarray(cols.remaining, dtype=np.int64).tobytes(),
            np.ascontiguousarray(cols.reset_time, dtype=np.int64).tobytes(),
        )
    )


def decode_globals_frame(raw: bytes):
    """Binary broadcast frame -> GlobalsColumns.  Raises ValueError on
    a malformed/foreign frame (the gateway maps it to a 400)."""
    from .parallel.global_mgr import GlobalsColumns

    if not is_columns_frame(raw):
        raise ValueError("not a columns frame")
    version, kind, n = struct.unpack_from("<BBI", raw, 4)
    if version != FRAME_VERSION or kind != _FRAME_KIND_GLOBALS:
        raise ValueError(
            f"unsupported globals frame (version={version}, kind={kind})"
        )
    pos = _FRAME_HEADER_LEN
    ko, kb, pos = _read_str_blob(raw, pos, n)
    algo, pos = _read_array(raw, pos, np.int32, n)
    status, pos = _read_array(raw, pos, np.int32, n)
    limit, pos = _read_array(raw, pos, np.int64, n)
    remaining, pos = _read_array(raw, pos, np.int64, n)
    reset, pos = _read_array(raw, pos, np.int64, n)
    if pos != len(raw):
        raise ValueError("columns frame length mismatch")
    return GlobalsColumns(
        keys=[kb[ko[i]:ko[i + 1]].decode("utf-8") for i in range(n)],
        algorithm=algo, status=status, limit=limit,
        remaining=remaining, reset_time=reset,
    )


def globals_cols_to_pb(cols) -> pc_pb.GlobalsColumnsReq:
    m = pc_pb.GlobalsColumnsReq()
    m.keys.extend(cols.keys)
    m.algorithm.extend(np.asarray(cols.algorithm, dtype=np.int32).tolist())
    m.status.extend(np.asarray(cols.status, dtype=np.int32).tolist())
    m.limit.extend(np.asarray(cols.limit, dtype=np.int64).tolist())
    m.remaining.extend(np.asarray(cols.remaining, dtype=np.int64).tolist())
    m.reset_time.extend(np.asarray(cols.reset_time, dtype=np.int64).tolist())
    return m


def globals_cols_from_pb(m: pc_pb.GlobalsColumnsReq):
    from .parallel.global_mgr import GlobalsColumns

    n = len(m.keys)
    return GlobalsColumns(
        keys=list(m.keys),
        algorithm=np.fromiter(m.algorithm, np.int32, count=n),
        status=np.fromiter(m.status, np.int32, count=n),
        limit=np.fromiter(m.limit, np.int64, count=n),
        remaining=np.fromiter(m.remaining, np.int64, count=n),
        reset_time=np.fromiter(m.reset_time, np.int64, count=n),
    )


class BroadcastBatch:
    """One sync pass's broadcasts with every wire encoding cached: the
    N-peer fan-out encodes ONCE per encoding actually used (the
    pre-columns sender re-encoded the whole batch per peer per tick).
    The classic encodings are built through the exact dataclass path
    the pre-columns sender used, so a GUBER_GLOBAL_COLUMNS=0 daemon —
    or a classic-negotiated peer — sees byte-identical wire.

    Lazy init is LOCKED: the fan-out pool hands one batch to many
    concurrent sends, and an unguarded check-then-encode would let
    every worker encode its own copy — per-peer encoding through the
    back door."""

    __slots__ = ("cols", "_lock", "_frame", "_pb", "_classic_pb",
                 "_classic_json", "_updates")

    def __init__(self, cols):
        self.cols = cols
        self._lock = threading.Lock()
        self._frame = None
        self._pb = None
        self._classic_pb = None
        self._classic_json = None
        self._updates = None

    def __len__(self) -> int:
        return len(self.cols.keys)

    def updates(self):
        # Callers hold self._lock (or are single-threaded test code).
        if self._updates is None:
            self._updates = self.cols.to_updates()
        return self._updates

    def frame(self) -> bytes:
        with self._lock:
            if self._frame is None:
                self._frame = encode_globals_frame(self.cols)
            return self._frame

    def columns_pb(self) -> pc_pb.GlobalsColumnsReq:
        with self._lock:
            if self._pb is None:
                self._pb = globals_cols_to_pb(self.cols)
            return self._pb

    def classic_pb(self) -> peers_pb.UpdatePeerGlobalsReq:
        with self._lock:
            if self._classic_pb is None:
                self._classic_pb = update_globals_req_to_pb(self.updates())
            return self._classic_pb

    def classic_json_bytes(self) -> bytes:
        with self._lock:
            if self._classic_json is None:
                self._classic_json = json.dumps(
                    {"globals": [u.to_json() for u in self.updates()]}
                ).encode("utf-8")
            return self._classic_json


# ---- Ownership transfer (elastic membership, reshard.py) -------------
# A ring delta ships the moved keys' FULL device bucket rows from the
# old owner to the new one:
#   * proto columns (TransferColumnsReq) served as the gRPC
#     PeersV1/TransferOwnership method;
#   * a GUBC frame (kind 4) POSTed to /v1/peer.TransferOwnership on the
#     HTTP transport.
# Both carry the destination ring's fingerprint so a receiver whose
# ring changed again FENCES the batch (dead-epoch transfer).  A peer
# without the transfer surface answers UNIMPLEMENTED / 404 — provably
# unapplied — and the sender falls back sticky to the classic
# (pre-reshard) behavior for that peer: the moved keys reset there,
# counted as aborts.

_FRAME_KIND_TRANSFER = 4


def is_transfer_frame(raw: bytes) -> bool:
    return is_columns_frame(raw) and raw[5] == _FRAME_KIND_TRANSFER


def encode_transfer_frame(cols) -> bytes:
    """TransferColumns -> binary transfer frame: GUBC header (kind 4)
    + `<Q` ring_hash + key string column + algo/status i32 +
    limit/remaining/duration/stamp/expire_at i64."""
    n = len(cols.keys)
    return b"".join(
        (
            FRAME_MAGIC,
            struct.pack("<BBI", FRAME_VERSION, _FRAME_KIND_TRANSFER, n),
            struct.pack("<Q", cols.ring_hash & 0xFFFFFFFFFFFFFFFF),
            _pack_str_column(cols.keys),
            np.ascontiguousarray(cols.algorithm, dtype=np.int32).tobytes(),
            np.ascontiguousarray(cols.status, dtype=np.int32).tobytes(),
            np.ascontiguousarray(cols.limit, dtype=np.int64).tobytes(),
            np.ascontiguousarray(cols.remaining, dtype=np.int64).tobytes(),
            np.ascontiguousarray(cols.duration, dtype=np.int64).tobytes(),
            np.ascontiguousarray(cols.stamp, dtype=np.int64).tobytes(),
            np.ascontiguousarray(cols.expire_at, dtype=np.int64).tobytes(),
        )
    )


def decode_transfer_frame(raw: bytes):
    """Binary transfer frame -> reshard.TransferColumns.  Raises
    ValueError on a malformed/foreign frame (the gateway maps it to a
    400)."""
    from .reshard import TransferColumns

    if not is_columns_frame(raw):
        raise ValueError("not a columns frame")
    version, kind, n = struct.unpack_from("<BBI", raw, 4)
    if version != FRAME_VERSION or kind != _FRAME_KIND_TRANSFER:
        raise ValueError(
            f"unsupported transfer frame (version={version}, kind={kind})"
        )
    pos = _FRAME_HEADER_LEN
    (ring_hash,) = struct.unpack_from("<Q", raw, pos)
    pos += 8
    ko, kb, pos = _read_str_blob(raw, pos, n)
    algo, pos = _read_array(raw, pos, np.int32, n)
    status, pos = _read_array(raw, pos, np.int32, n)
    limit, pos = _read_array(raw, pos, np.int64, n)
    remaining, pos = _read_array(raw, pos, np.int64, n)
    duration, pos = _read_array(raw, pos, np.int64, n)
    stamp, pos = _read_array(raw, pos, np.int64, n)
    expire, pos = _read_array(raw, pos, np.int64, n)
    if pos != len(raw):
        raise ValueError("columns frame length mismatch")
    return TransferColumns(
        keys=[kb[ko[i]:ko[i + 1]].decode("utf-8") for i in range(n)],
        algorithm=algo, status=status, limit=limit, remaining=remaining,
        duration=duration, stamp=stamp, expire_at=expire,
        ring_hash=int(ring_hash),
    )


def transfer_cols_to_pb(cols) -> "pc_pb.TransferColumnsReq":
    m = pc_pb.TransferColumnsReq()
    m.ring_hash = cols.ring_hash & 0xFFFFFFFFFFFFFFFF
    m.keys.extend(cols.keys)
    m.algorithm.extend(np.asarray(cols.algorithm, dtype=np.int32).tolist())
    m.status.extend(np.asarray(cols.status, dtype=np.int32).tolist())
    m.limit.extend(np.asarray(cols.limit, dtype=np.int64).tolist())
    m.remaining.extend(np.asarray(cols.remaining, dtype=np.int64).tolist())
    m.duration.extend(np.asarray(cols.duration, dtype=np.int64).tolist())
    m.stamp.extend(np.asarray(cols.stamp, dtype=np.int64).tolist())
    m.expire_at.extend(np.asarray(cols.expire_at, dtype=np.int64).tolist())
    return m


def transfer_cols_from_pb(m) -> "object":
    from .reshard import TransferColumns

    n = len(m.keys)
    return TransferColumns(
        keys=list(m.keys),
        algorithm=np.fromiter(m.algorithm, np.int32, count=n),
        status=np.fromiter(m.status, np.int32, count=n),
        limit=np.fromiter(m.limit, np.int64, count=n),
        remaining=np.fromiter(m.remaining, np.int64, count=n),
        duration=np.fromiter(m.duration, np.int64, count=n),
        stamp=np.fromiter(m.stamp, np.int64, count=n),
        expire_at=np.fromiter(m.expire_at, np.int64, count=n),
        ring_hash=int(m.ring_hash),
    )


# ---- Multi-region federation (federation.py) -------------------------
# Cross-region hit replication batch (architecture.md "Multi-region
# federation"): per-key summed MULTI_REGION hits + the origin region's
# id, shipped to each remote region's owner:
#   * proto columns (RegionColumnsReq) served as the gRPC
#     PeersV1/UpdateRegionColumns method;
#   * a GUBC frame (kind 7) POSTed to /v1/peer.UpdateRegionColumns on
#     the HTTP transport.
# A peer without the region surface answers UNIMPLEMENTED / 404 —
# provably unapplied — and the sender falls back sticky to the classic
# per-item GetPeerRateLimits encoding (exactly the pre-federation
# wire; GUBER_REGION_COLUMNS=0 forces it, golden-tested
# byte-identical).

_FRAME_KIND_REGION = 7


def is_region_frame(raw: bytes) -> bool:
    return is_columns_frame(raw) and raw[5] == _FRAME_KIND_REGION


def encode_region_frame(cols) -> bytes:
    """federation.RegionColumns -> binary region frame: GUBC header
    (kind 7) + `u32 origin_len | origin utf-8` + the seven kind-1
    request columns (names/unique_keys string columns, algo/behavior
    i32, hits/limit/duration i64)."""
    n = len(cols.names)
    origin = cols.origin.encode("utf-8")
    return b"".join(
        (
            FRAME_MAGIC,
            struct.pack("<BBI", FRAME_VERSION, _FRAME_KIND_REGION, n),
            struct.pack("<I", len(origin)),
            origin,
            _pack_str_column(cols.names),
            _pack_str_column(cols.unique_keys),
            np.ascontiguousarray(cols.algorithm, dtype=np.int32).tobytes(),
            np.ascontiguousarray(cols.behavior, dtype=np.int32).tobytes(),
            np.ascontiguousarray(cols.hits, dtype=np.int64).tobytes(),
            np.ascontiguousarray(cols.limit, dtype=np.int64).tobytes(),
            np.ascontiguousarray(cols.duration, dtype=np.int64).tobytes(),
        )
    )


def decode_region_frame(raw: bytes):
    """Binary region frame -> federation.RegionColumns.  Raises
    ValueError on a malformed/foreign frame (the gateway maps it to a
    400)."""
    from .federation import RegionColumns

    if not is_columns_frame(raw):
        raise ValueError("not a columns frame")
    version, kind, n = struct.unpack_from("<BBI", raw, 4)
    if version != FRAME_VERSION or kind != _FRAME_KIND_REGION:
        raise ValueError(
            f"unsupported region frame (version={version}, kind={kind})"
        )
    pos = _FRAME_HEADER_LEN
    try:
        (origin_len,) = struct.unpack_from("<I", raw, pos)
    except struct.error:
        raise ValueError("columns frame truncated") from None
    pos += 4
    origin_b = raw[pos:pos + origin_len]
    if len(origin_b) != origin_len:
        raise ValueError("columns frame truncated")
    try:
        origin = origin_b.decode("utf-8")
    except UnicodeDecodeError:
        raise ValueError("region frame origin is not valid utf-8") from None
    pos += origin_len
    no, nb, pos = _read_str_blob(raw, pos, n)
    uo, ub, pos = _read_str_blob(raw, pos, n)
    algo, pos = _read_array(raw, pos, np.int32, n)
    beh, pos = _read_array(raw, pos, np.int32, n)
    hits, pos = _read_array(raw, pos, np.int64, n)
    limit, pos = _read_array(raw, pos, np.int64, n)
    duration, pos = _read_array(raw, pos, np.int64, n)
    if pos != len(raw):
        raise ValueError("columns frame length mismatch")
    return RegionColumns(
        origin=origin,
        names=[nb[no[i]:no[i + 1]].decode("utf-8") for i in range(n)],
        unique_keys=[ub[uo[i]:uo[i + 1]].decode("utf-8") for i in range(n)],
        algorithm=algo, behavior=beh,
        hits=hits, limit=limit, duration=duration,
    )


def region_cols_to_pb(cols) -> "pc_pb.RegionColumnsReq":
    m = pc_pb.RegionColumnsReq()
    m.origin = cols.origin
    m.names.extend(cols.names)
    m.unique_keys.extend(cols.unique_keys)
    m.algorithm.extend(np.asarray(cols.algorithm, dtype=np.int32).tolist())
    m.behavior.extend(np.asarray(cols.behavior, dtype=np.int32).tolist())
    m.hits.extend(np.asarray(cols.hits, dtype=np.int64).tolist())
    m.limit.extend(np.asarray(cols.limit, dtype=np.int64).tolist())
    m.duration.extend(np.asarray(cols.duration, dtype=np.int64).tolist())
    return m


def region_cols_from_pb(m) -> "object":
    from .federation import RegionColumns

    n = len(m.names)
    return RegionColumns(
        origin=m.origin,
        names=list(m.names),
        unique_keys=list(m.unique_keys),
        algorithm=np.fromiter(m.algorithm, np.int32, count=n),
        behavior=np.fromiter(m.behavior, np.int32, count=n),
        hits=np.fromiter(m.hits, np.int64, count=n),
        limit=np.fromiter(m.limit, np.int64, count=n),
        duration=np.fromiter(m.duration, np.int64, count=n),
    )


def update_global_to_pb(u: UpdatePeerGlobal) -> peers_pb.UpdatePeerGlobal:
    return peers_pb.UpdatePeerGlobal(
        key=u.key, status=resp_to_pb(u.status), algorithm=int(u.algorithm)
    )


def update_global_from_pb(m: peers_pb.UpdatePeerGlobal) -> UpdatePeerGlobal:
    return UpdatePeerGlobal(
        key=m.key, status=resp_from_pb(m.status), algorithm=int(m.algorithm)
    )


def update_globals_req_to_pb(updates: Iterable[UpdatePeerGlobal]) -> peers_pb.UpdatePeerGlobalsReq:
    return peers_pb.UpdatePeerGlobalsReq(globals=[update_global_to_pb(u) for u in updates])


def update_globals_req_from_pb(m: peers_pb.UpdatePeerGlobalsReq) -> List[UpdatePeerGlobal]:
    return [update_global_from_pb(u) for u in m.globals]


# ---- HealthCheck -----------------------------------------------------
def health_to_pb(h: HealthCheckResponse) -> pb.HealthCheckResp:
    return pb.HealthCheckResp(
        status=h.status, message=h.message, peer_count=int(h.peer_count)
    )


def health_from_pb(m: pb.HealthCheckResp) -> HealthCheckResponse:
    return HealthCheckResponse(
        status=m.status, message=m.message, peer_count=m.peer_count
    )
