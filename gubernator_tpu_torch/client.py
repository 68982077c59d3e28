"""Client helpers (reference client.go + python/gubernator/__init__.py).

`GrpcV1Client` (via `dial_v1_server`) speaks the gRPC V1 service — the
reference's DialV1Server path (client.go:41-57).  `V1Client` speaks the
HTTP/JSON gateway.  Both expose the same get_rate_limits / health_check
surface; `sleep_until_reset` is the Python client's convenience
(python/gubernator/__init__.py:12-17).

`ColumnsV1Client` is the columnar front-door client (architecture.md
"Columnar pipeline: the front door"): checks accumulate client-side
into numpy-backed column sub-batches behind an adaptive BatchWindow,
flush as ONE GUBC ingress frame each, and pipeline multiple in-flight
frames per connection; a daemon without the columnar surface
(pre-columns build or GUBER_INGRESS_COLUMNS=0) answers the first frame
with 400/404 and the client falls back sticky to the classic JSON
encoding — wire-identical to a plain V1Client from then on.

The port of the JAX package's client.py, with the same bytes on every
wire.  It needs no device: `GrpcV1Client.get_rate_limits_columns`
builds the port's `service.ColumnarResult`, and nothing else here
touches torch.  This module and grpc_server.py are the only modules of
the port that import grpc.
"""

from __future__ import annotations

import datetime
import http.client
import json
import random
import socket
import ssl
import string
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional

import numpy as np

from .types import (
    MILLISECOND,  # noqa: F401 — duration consts re-exported (client.go:30-34)
    MINUTE,  # noqa: F401
    SECOND,  # noqa: F401
    GetRateLimitsRequest,
    GetRateLimitsResponse,
    HealthCheckResponse,
    PeerInfo,
    RateLimitRequest,
    RateLimitResponse,
)


def _uds_endpoint(endpoint: str) -> Optional[str]:
    """Socket path of a `unix:///path` endpoint, else None.  The UDS
    lane (GUBER_UDS_PATH on the native edge) speaks the identical
    HTTP/1.1 + GUBC protocol over an AF_UNIX stream — same clients,
    same bytes, no TCP stack."""
    if endpoint.startswith("unix://"):
        return endpoint[len("unix://"):]
    return None


class _UnixHTTPConnection(http.client.HTTPConnection):
    """http.client over an AF_UNIX stream (the classic-JSON leg of a
    unix:// target; the frame leg rides _PipelinedConn)."""

    def __init__(self, path: str, timeout_s: float):
        super().__init__("localhost", timeout=timeout_s)
        self._uds_path = path

    def connect(self):  # noqa: D102 — stdlib override
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(self.timeout)
        self.sock.connect(self._uds_path)


class V1Client:
    """HTTP/JSON gateway client.

    Connections are persistent (HTTP/1.1 keep-alive, one per calling
    thread) — the pre-PR client paid a TCP handshake per request.  A
    server may close an idle kept-alive socket at any time; the expiry
    race (RemoteDisconnected / reset on a PREVIOUSLY-USED connection)
    is retried once on a fresh connection transparently, the urllib3
    retry rule — the request provably never reached a handler, so the
    retry cannot double-count.  Failures on a fresh connection surface
    to the caller unchanged.

    `endpoint` may be host:port or `unix:///path` (the native edge's
    same-host UDS lane, GUBER_UDS_PATH); TLS does not apply to UDS
    targets."""

    def __init__(
        self,
        endpoint: str = "127.0.0.1:1050",
        timeout_s: float = 5.0,
        tls_context: Optional[ssl.SSLContext] = None,
    ):
        self.endpoint = endpoint
        self.timeout_s = timeout_s
        self.tls_context = tls_context
        self._local = threading.local()  # per-thread persistent conn

    def _connect(self):
        uds = _uds_endpoint(self.endpoint)
        if uds is not None:
            if self.tls_context is not None:
                raise ValueError("TLS is not supported over unix:// targets")
            return _UnixHTTPConnection(uds, self.timeout_s)
        host, _, port = self.endpoint.partition(":")
        if self.tls_context is not None:
            return http.client.HTTPSConnection(
                host, int(port or 443), timeout=self.timeout_s, context=self.tls_context
            )
        return http.client.HTTPConnection(host, int(port or 80), timeout=self.timeout_s)

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
            self._local.conn = None

    def _roundtrip(self, method: str, path: str, body: Optional[bytes],
                   content_type: str = "application/json"):
        """One request over this thread's persistent connection;
        returns (status, raw body).  Stale keep-alive sockets retry
        once (see class docstring).  The retry covers ONLY the phases
        where the request provably never executed — the send, and a
        RemoteDisconnected BEFORE any status line (the server closed
        the idle socket without answering).  Once a status line has
        arrived the handler ran, so a failure while reading the body
        must surface: resending a POST there would double-count."""
        for _ in range(2):
            fresh = getattr(self._local, "conn", None) is None
            try:
                if fresh:
                    self._local.conn = self._connect()
                conn = self._local.conn
                conn.request(
                    method, path, body=body,
                    headers={"Content-Type": content_type},
                )
                r = conn.getresponse()
            except (
                http.client.RemoteDisconnected,
                BrokenPipeError,
                ConnectionResetError,
            ):
                self._drop_conn()
                if fresh:
                    # A NEW connection failing is a real server problem,
                    # not the keep-alive expiry race — surface it.
                    raise
                # Reused socket the server closed while idle: no status
                # line was ever received, so the request was not
                # answered and the close predates (or raced) our bytes
                # — one transparent retry is safe.
                continue
            except (OSError, http.client.HTTPException):
                self._drop_conn()
                raise
            try:
                raw = r.read()
            except (OSError, http.client.HTTPException):
                # Status received = the handler executed; a body-read
                # failure is NOT retry-safe (the urllib3 rule's limit).
                self._drop_conn()
                raise
            if r.will_close:
                self._drop_conn()
            return r.status, raw
        raise RuntimeError("unreachable")  # pragma: no cover

    def _request(self, method: str, path: str, payload: Optional[dict] = None) -> dict:
        body = json.dumps(payload).encode() if payload is not None else None
        status, raw = self._roundtrip(method, path, body)
        data = json.loads(raw) if raw else {}
        if status != 200:
            raise RuntimeError(
                f"{path} returned HTTP {status}: {data.get('message', raw[:200])}"
            )
        return data

    def get_rate_limits(self, req: GetRateLimitsRequest) -> GetRateLimitsResponse:
        return GetRateLimitsResponse.from_json(
            self._request("POST", "/v1/GetRateLimits", req.to_json())
        )

    def health_check(self) -> HealthCheckResponse:
        return HealthCheckResponse.from_json(self._request("GET", "/v1/HealthCheck"))

    def metrics_text(self) -> str:
        _status, raw = self._roundtrip("GET", "/metrics", None)
        return raw.decode()

    def close(self) -> None:
        """Close THIS thread's persistent connection (other threads'
        sockets close when their threads exit / on GC)."""
        self._drop_conn()


class _PipelinedConn:
    """One persistent HTTP/1.1 connection with request PIPELINING: the
    sender writes each request as soon as it is encoded (under a write
    lock) and a reader thread resolves responses in FIFO order — so
    several in-flight frames share one socket and the client never
    waits a round trip between window flushes.  Both gateway edges
    serve pipelined requests in arrival order (the stdlib handler
    serially; the native epoll edge via its token-ordered response
    queue), which is what makes FIFO matching correct.

    Responses resolve as (status, raw_body) on the posted Future; a
    connection-level failure fails every in-flight future and marks the
    conn dead (the owner builds a fresh one)."""

    MAX_INFLIGHT = 32  # bound pipelined requests per socket

    def __init__(self, endpoint: str, timeout_s: float,
                 tls_context: Optional[ssl.SSLContext] = None):
        uds = _uds_endpoint(endpoint)
        if uds is not None:
            # Same-host UDS lane: identical protocol, no TCP stack.
            if tls_context is not None:
                raise ValueError("TLS is not supported over unix:// targets")
            self._host = "localhost"
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.settimeout(timeout_s)
            self._sock.connect(uds)
        else:
            host, _, port = endpoint.partition(":")
            self._host = host
            self._sock = socket.create_connection(
                (host, int(port or 80)), timeout=timeout_s
            )
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if tls_context is not None:
            # Handshake still under timeout_s: a server that accepts
            # TCP but never completes TLS must not park the window's
            # only flusher thread forever.
            self._sock = tls_context.wrap_socket(self._sock, server_hostname=host)
        # AFTER connect+handshake, reads must BLOCK: the reader thread
        # sits in readline between responses (idle keep-alive
        # included), so a socket-level read timeout would tear the conn
        # down whenever the pipeline runs dry.  Response deadlines
        # belong to the waiters' fut.result timeouts; _fail unblocks
        # the reader by shutting the socket down.
        self._sock.settimeout(None)
        self._rfile = self._sock.makefile("rb")
        # _wlock serializes WRITERS only.  Liveness state (dead flag +
        # pending queue) lives under its own lock so _fail()/close()
        # can tear the conn down while a writer is parked in sendall on
        # a full send buffer — teardown shutdown()s the socket, which
        # unblocks that sendall with an error.  Taking _wlock for
        # teardown would deadlock behind exactly the stuck writer it
        # needs to rescue.
        self._wlock = threading.Lock()
        self._state_lock = threading.Lock()
        self._pending: "deque[Future]" = deque()
        self._slots = threading.BoundedSemaphore(self.MAX_INFLIGHT)
        self.dead = False
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True, name="columns-client-reader"
        )
        self._reader.start()

    def post(self, path: str, body: bytes, content_type: str) -> Future:
        """Write one POST; returns a Future of (status, raw_body).
        Raises ConnectionError when the conn is dead."""
        self._slots.acquire()
        fut: Future = Future()
        head = (
            f"POST {path} HTTP/1.1\r\nHost: {self._host}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n\r\n"
        ).encode()
        queued = False
        try:
            with self._wlock:
                with self._state_lock:
                    if self.dead:
                        raise ConnectionError("connection is closed")
                    # Queue BEFORE the write: a response cannot arrive
                    # for a request whose bytes have not gone out yet,
                    # so the reader can never pop an unqueued future.
                    self._pending.append(fut)
                    queued = True
                self._sock.sendall(head + body)
        except BaseException:
            # _fail releases one slot per QUEUED future (ours included
            # once queued); releasing here too would double-release the
            # bounded semaphore.
            if not queued:
                self._slots.release()
            self._fail(ConnectionError("send failed"))
            raise
        return fut

    def _read_loop(self) -> None:
        try:
            while True:
                line = self._rfile.readline()
                if not line:
                    raise ConnectionError("server closed the connection")
                parts = line.split(None, 2)
                if len(parts) < 2 or not parts[0].startswith(b"HTTP/"):
                    raise ConnectionError(f"malformed status line {line[:80]!r}")
                status = int(parts[1])
                clen = 0
                will_close = False
                while True:
                    h = self._rfile.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    name, _, val = h.partition(b":")
                    lname = name.strip().lower()
                    if lname == b"content-length":
                        clen = int(val.strip())
                    elif lname == b"connection" and b"close" in val.lower():
                        will_close = True
                body = self._rfile.read(clen) if clen else b""
                if clen and len(body) != clen:
                    raise ConnectionError("truncated response body")
                fut = self._pending.popleft()
                self._slots.release()
                fut.set_result((status, body))
                if will_close:
                    raise ConnectionError("server is closing the connection")
        except Exception as e:  # noqa: BLE001 — fail-all teardown
            self._fail(e)

    def _fail(self, exc: BaseException) -> None:
        with self._state_lock:
            if self.dead:
                pending: List[Future] = []
            else:
                self.dead = True
                pending = list(self._pending)
                self._pending.clear()
        # shutdown BEFORE close: it reliably unblocks a writer parked
        # in sendall (and the reader in readline); the close only
        # releases the fd.  Both are no-op-swallowed on repeat calls.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        for fut in pending:
            self._slots.release()
            if not fut.done():
                fut.set_exception(
                    ConnectionError(f"pipelined connection failed: {exc}")
                )

    def close(self) -> None:
        self._fail(ConnectionError("client closed"))


class ColumnsV1Client:
    """Columnar front-door client (the reference `python/gubernator/`
    twin rebuilt on the GUBC wire): see the module docstring for the
    batching/pipelining/negotiation model.

    * `check(...)` / `submit_columns(...)` enqueue into the adaptive
      window and return a Future — concurrent callers coalesce into one
      frame of up to `max_lanes` lanes.
    * `get_rate_limits(req)` is the blocking drop-in for V1Client.
    * Negotiation is sticky per client: the first flush probes with a
      frame; 400/404/415 (or the pre-columns gateway's codec 500) means
      "old daemon, speak JSON" — the probe batch is resent classic
      inside the same flush (the 4xx proves it was never applied) and
      every later flush goes straight to JSON, byte-identical to a
      plain V1Client.
    """

    def __init__(
        self,
        endpoint: str = "127.0.0.1:1050",
        timeout_s: float = 5.0,
        batch_wait_s: float = 0.0005,
        max_lanes: Optional[int] = None,
        connections: int = 2,
        tls_context: Optional[ssl.SSLContext] = None,
    ):
        from .config import INGRESS_COLUMNS_MAX_LANES, MAX_BATCH_SIZE
        from .utils.batch_window import BatchWindow
        # Frame replies decode into service.ColumnarResult, and the
        # port's service module imports torch (seconds): load it here,
        # not inside the first request's deadline.
        from . import service  # noqa: F401

        self.endpoint = endpoint
        self.timeout_s = timeout_s
        self.tls_context = tls_context
        self._columns_cap = (
            INGRESS_COLUMNS_MAX_LANES if max_lanes is None else max_lanes
        )
        self._classic_cap = MAX_BATCH_SIZE
        # None = untried (probe with a frame), True = daemon speaks
        # columns, False = classic JSON only.  Sticky for the client's
        # lifetime, like PeerClient._columnar.
        self._columnar: Optional[bool] = None
        self._closed = False
        # The classic fallback leg rides a V1Client (keep-alive +
        # stale-retry): its POST body is json.dumps of the exact
        # to_json() shape, so a downgraded client is wire-identical to
        # a pre-columns one.
        self._json_client = V1Client(endpoint, timeout_s, tls_context)
        self._conns: List[Optional[_PipelinedConn]] = [None] * max(connections, 1)
        self._conn_locks = [threading.Lock() for _ in self._conns]
        self._rr = 0
        self._window = BatchWindow(
            self._send_batch,
            batch_wait_s,
            self._columns_cap,
            lazy=True,
            adaptive=True,
            weigh=lambda item: len(item[0][0]),
        )

    # -- public surface ------------------------------------------------
    def check(self, name: str, unique_key: str, hits: int = 1,
              limit: int = 0, duration: int = 0, algorithm: int = 0,
              behavior: int = 0) -> "Future":
        """One rate-limit check; resolves to a RateLimitResponse.
        Concurrent checks coalesce into one wire frame."""
        fut = self.submit_columns((
            [name], [unique_key],
            np.array([algorithm], np.int32), np.array([behavior], np.int32),
            np.array([hits], np.int64), np.array([limit], np.int64),
            np.array([duration], np.int64),
        ))
        out: Future = Future()

        def done(f):
            try:
                rc, lo, _hi = f.result()
                out.set_result(rc.response_at(lo))
            except Exception as e:  # noqa: BLE001
                out.set_exception(e)

        fut.add_done_callback(done)
        return out

    def submit_columns(self, cols) -> "Future":
        """Submit a column sub-batch (wire.PeerColumns shape) to the
        coalescing window; resolves to (ColumnarResult, lo, hi) — this
        sub-batch's slice of the flushed frame's shared result."""
        from . import tracing

        if self._closed:
            raise ConnectionError("client is closed")
        n = len(cols[0])
        if n > self._columns_cap:
            raise ValueError(
                f"batch of {n} lanes exceeds max_lanes {self._columns_cap}"
            )
        # Reject malformed sub-batches HERE, per caller: garbage inside
        # a coalesced frame (ragged columns, out-of-range algorithm)
        # would 400 — or worse, misalign — the whole flush and take
        # every innocent rider of the window down with it.
        if any(len(c) != n for c in cols[1:]):
            raise ValueError("column length mismatch")
        algo = np.asarray(cols[2])
        if n and bool(((algo < 0) | (algo > 1)).any()):
            raise ValueError("algorithm out of range")
        fut: Future = Future()
        if tracing.enabled():
            ctx = tracing.current()
            if ctx is not None:
                fut._trace_ctx = ctx
        self._window.submit((cols, fut))
        return fut

    def get_rate_limits(self, req: GetRateLimitsRequest) -> GetRateLimitsResponse:
        """Blocking drop-in for V1Client.get_rate_limits, riding the
        columnar window."""
        rs = req.requests
        fut = self.submit_columns((
            [r.name for r in rs],
            [r.unique_key for r in rs],
            np.fromiter((int(r.algorithm) for r in rs), np.int32, count=len(rs)),
            np.fromiter((int(r.behavior) for r in rs), np.int32, count=len(rs)),
            np.fromiter((int(r.hits) for r in rs), np.int64, count=len(rs)),
            np.fromiter((int(r.limit) for r in rs), np.int64, count=len(rs)),
            np.fromiter((int(r.duration) for r in rs), np.int64, count=len(rs)),
        ))
        rc, lo, hi = fut.result(timeout=self.timeout_s + 1.0)
        return GetRateLimitsResponse(
            responses=[rc.response_at(i) for i in range(lo, hi)]
        )

    def health_check(self) -> HealthCheckResponse:
        return self._json_client.health_check()

    def close(self) -> None:
        self._closed = True
        self._window.stop(timeout_s=self.timeout_s)
        # The stop() drain may have just written final frames; give
        # their in-flight responses a bounded window to land before the
        # sockets close (late waiters would otherwise see spurious
        # ConnectionErrors for answered requests).
        deadline = time.monotonic() + self.timeout_s
        for conn in self._conns:
            while (
                conn is not None and not conn.dead and conn._pending
                and time.monotonic() < deadline
            ):
                time.sleep(0.005)
        for i, conn in enumerate(self._conns):
            if conn is not None:
                conn.close()
                self._conns[i] = None
        self._json_client.close()

    # -- flush path ----------------------------------------------------
    def _get_conn(self, k: int) -> _PipelinedConn:
        with self._conn_locks[k]:
            conn = self._conns[k]
            if conn is None or conn.dead:
                conn = _PipelinedConn(
                    self.endpoint, self.timeout_s, self.tls_context
                )
                self._conns[k] = conn
            return conn

    def _send_batch(self, batch: List[tuple]) -> None:
        """Window flush: chunk the queued sub-batches to the negotiated
        cap and send each chunk as ONE pipelined POST (frame or JSON).
        Runs on the window's flusher thread; nothing here waits on a
        response — completion handlers scatter results from the reader
        thread, which is what lets consecutive flushes pipeline."""
        cap = (
            self._columns_cap if self._columnar is not False
            else self._classic_cap
        )
        chunk: List[tuple] = []
        lanes = 0
        for item in batch:
            n = len(item[0][0])
            if chunk and lanes + n > cap:
                self._send_chunk(chunk)
                chunk, lanes = [], 0
                cap = (
                    self._columns_cap if self._columnar is not False
                    else self._classic_cap
                )
            chunk.append(item)
            lanes += n
        if chunk:
            self._send_chunk(chunk)

    @staticmethod
    def _concat(chunk: List[tuple]):
        if len(chunk) == 1:
            return chunk[0][0]
        return (
            [s for c, _ in chunk for s in c[0]],
            [s for c, _ in chunk for s in c[1]],
            *(
                np.concatenate([c[i] for c, _ in chunk])
                for i in range(2, 7)
            ),
        )

    def _trace_entries(self, chunk: List[tuple]):
        from . import tracing

        if not tracing.enabled():
            return None
        entries, lo = [], 0
        for c, fut in chunk:
            hi = lo + len(c[0])
            ctx = getattr(fut, "_trace_ctx", None)
            if ctx is not None:
                entries.append((lo, hi, ctx.trace_id, ctx.span_id))
            lo = hi
        return entries or None

    def _send_chunk(self, chunk: List[tuple]) -> None:
        from . import wire

        cols = self._concat(chunk)
        try:
            if self._columnar is False:
                self._send_chunk_classic(chunk, cols)
                return
            frame = wire.encode_ingress_frame(
                cols, trace=self._trace_entries(chunk)
            )
            k = self._rr = (self._rr + 1) % len(self._conns)
            try:
                rfut = self._get_conn(k).post(
                    "/v1/GetRateLimits", frame, wire.COLUMNS_CONTENT_TYPE
                )
            except Exception:  # noqa: BLE001
                # A failed post() is provably unanswered (at worst a
                # PARTIAL request reached a closing socket — the server
                # discards incomplete bodies), which is the keep-alive
                # expiry race on this leg: the idle conn died between
                # flushes.  One resend on a fresh connection; a second
                # failure surfaces.
                rfut = self._get_conn(k).post(
                    "/v1/GetRateLimits", frame, wire.COLUMNS_CONTENT_TYPE
                )
        except Exception as e:  # noqa: BLE001
            self._fail_chunk(chunk, e)
            return
        rfut.add_done_callback(lambda f: self._on_frame_reply(chunk, cols, f))

    def _on_frame_reply(self, chunk: List[tuple], cols, rfut) -> None:
        """Reader-thread completion for a frame POST: decode + scatter,
        or negotiate down sticky and resend classic inside this same
        flush (the rejection proves the frame was never applied)."""
        from . import wire

        try:
            status, body = rfut.result()
        except Exception as e:  # noqa: BLE001
            self._fail_chunk(chunk, e)
            return
        try:
            if status == 200 and wire.is_ingress_result_frame(body):
                self._columnar = True
                self._scatter(chunk, wire.decode_ingress_result_frame(body))
                return
            # A 400 from a COLUMNS-AWARE daemon rejecting THIS frame
            # ("invalid columns frame ..." — malformed, bad algorithm —
            # or "... too large" — a max_lanes override above the
            # server's cap) is a client bug: fail the chunk, do NOT
            # downgrade — the classic resend would halve every future
            # request's throughput for nothing.  Version answers are
            # the pre-columns shapes: the 400 json.loads gives a binary
            # body, a 404/415, or the old gateway's codec 500.
            rejected = (
                status in (404, 415)
                or (
                    status == 400
                    and b"invalid columns frame" not in body
                    and b"too large" not in body
                )
                or (status == 500 and b"codec can't decode" in body)
            )
            if rejected:
                # Old daemon (or GUBER_INGRESS_COLUMNS=0): remember,
                # shrink the window to the classic per-POST cap, resend
                # THIS chunk as classic JSON — on its OWN thread, not
                # this reader thread: during the probe several frame
                # chunks may be pipelined on this socket, and a serial
                # blocking resend here would stall FIFO delivery of
                # their replies past the waiters' timeouts.  Rare by
                # construction (once per downgraded client).
                self._columnar = False
                self._window.limit = self._classic_cap
                threading.Thread(
                    target=self._send_chunk_classic, args=(chunk, cols),
                    daemon=True, name="columns-client-downgrade",
                ).start()
                return
            if status == 200:
                # A 200 with a non-frame body: the daemon ANSWERED (it
                # may have applied the hits), so a resend would
                # double-count — fail the batch, speak classic onward.
                self._columnar = False
                self._window.limit = self._classic_cap
                raise RuntimeError(
                    "daemon answered a columns frame with a non-frame 200 body"
                )
            raise RuntimeError(
                f"/v1/GetRateLimits returned HTTP {status}: {body[:200]!r}"
            )
        except Exception as e:  # noqa: BLE001
            self._fail_chunk(chunk, e)

    def _send_chunk_classic(self, chunk: List[tuple], cols) -> None:
        """Classic JSON leg: re-chunk to the reference's 1000-item cap
        and POST each piece through the keep-alive V1Client — the exact
        pre-columns wire bytes (interop-golden-tested)."""
        from . import wire

        try:
            n_total = len(cols[0])
            parts = []
            for lo in range(0, n_total, self._classic_cap):
                sub = wire.peer_columns_slice(
                    cols, lo, min(lo + self._classic_cap, n_total)
                )
                body = self._json_client._request(
                    "POST", "/v1/GetRateLimits",
                    wire.peer_columns_to_classic_json(sub),
                )
                parts.append(wire.result_from_classic_ingress_json(body))
            self._scatter(chunk, wire.concat_results(parts))
        except Exception as e:  # noqa: BLE001
            self._fail_chunk(chunk, e)

    @staticmethod
    def _scatter(chunk: List[tuple], rc) -> None:
        n = sum(len(c[0]) for c, _ in chunk)
        if rc.n != n:
            ColumnsV1Client._fail_chunk(chunk, RuntimeError(
                f"daemon returned {rc.n} rate limits for {n} requests"
            ))
            return
        lo = 0
        for c, fut in chunk:
            hi = lo + len(c[0])
            if not fut.done():
                fut.set_result((rc, lo, hi))
            lo = hi

    @staticmethod
    def _fail_chunk(chunk: List[tuple], exc: BaseException) -> None:
        for _, fut in chunk:
            if not fut.done():
                fut.set_exception(exc)


class GrpcV1Client:
    """gRPC client for the V1 service (client.go:41-57 DialV1Server)."""

    def __init__(self, endpoint: str, timeout_s: float = 5.0, credentials=None):
        import grpc

        from .proto import V1_SERVICE
        from .proto import gubernator_pb2 as pb
        from .proto import peers_columns_pb2 as pc_pb

        self.endpoint = endpoint
        self.timeout_s = timeout_s
        if credentials is not None:
            self._channel = grpc.secure_channel(endpoint, credentials)
        else:
            self._channel = grpc.insecure_channel(endpoint)
        self._get_rate_limits = self._channel.unary_unary(
            f"/{V1_SERVICE}/GetRateLimits",
            request_serializer=pb.GetRateLimitsReq.SerializeToString,
            response_deserializer=pb.GetRateLimitsResp.FromString,
        )
        self._get_rate_limits_columns = self._channel.unary_unary(
            f"/{V1_SERVICE}/GetRateLimitsColumns",
            request_serializer=pc_pb.PeerColumnsReq.SerializeToString,
            response_deserializer=pc_pb.IngressColumnsResp.FromString,
        )
        self._health_check = self._channel.unary_unary(
            f"/{V1_SERVICE}/HealthCheck",
            request_serializer=pb.HealthCheckReq.SerializeToString,
            response_deserializer=pb.HealthCheckResp.FromString,
        )
        # Columns negotiation, sticky like the HTTP client's: None =
        # probe first, False = daemon answered UNIMPLEMENTED (pre-
        # columns build / GUBER_INGRESS_COLUMNS=0), speak classic.
        self._columnar: Optional[bool] = None

    def get_rate_limits(self, req: GetRateLimitsRequest) -> GetRateLimitsResponse:
        from . import wire

        m = self._get_rate_limits(
            wire.get_rate_limits_req_to_pb(req), timeout=self.timeout_s
        )
        return wire.get_rate_limits_resp_from_pb(m)

    def get_rate_limits_columns(self, cols) -> "object":
        """Columnar GetRateLimits (wire.PeerColumns in, ColumnarResult
        out) against V1/GetRateLimitsColumns; UNIMPLEMENTED downgrades
        sticky to the classic per-request encoding — the method never
        executed, so the resend cannot double-count."""
        import grpc

        from . import wire

        if self._columnar is not False:
            try:
                m = self._get_rate_limits_columns(
                    wire.peer_columns_req_to_pb(cols), timeout=self.timeout_s
                )
                self._columnar = True
                return wire.result_from_ingress_columns_pb(m)
            except grpc.RpcError as e:
                code = e.code() if hasattr(e, "code") else None
                if code != grpc.StatusCode.UNIMPLEMENTED:
                    raise
                self._columnar = False
        from .config import MAX_BATCH_SIZE
        from .service import ColumnarResult

        # Classic downgrade: re-chunk to the reference's 1000-item cap
        # (a columnar batch may carry up to INGRESS_COLUMNS_MAX_LANES —
        # one oversize GetRateLimits would be rejected OutOfRange).
        n_total = len(cols[0])
        parts = []
        for lo in range(0, n_total, MAX_BATCH_SIZE):
            names, uks, algo, beh, hits, limit, duration = (
                wire.peer_columns_slice(
                    cols, lo, min(lo + MAX_BATCH_SIZE, n_total)
                )
            )
            resp = self.get_rate_limits(GetRateLimitsRequest(requests=[
                RateLimitRequest(
                    name=names[i], unique_key=uks[i], hits=int(hits[i]),
                    limit=int(limit[i]), duration=int(duration[i]),
                    algorithm=int(algo[i]), behavior=int(beh[i]),
                )
                for i in range(len(names))
            ]))
            part = ColumnarResult.empty(len(resp.responses))
            part.overrides = dict(enumerate(resp.responses))
            parts.append(part)
        if not parts:
            return ColumnarResult.empty(0)
        return wire.concat_results(parts)

    def health_check(self) -> HealthCheckResponse:
        from . import wire
        from .proto import gubernator_pb2 as pb

        return wire.health_from_pb(self._health_check(pb.HealthCheckReq(), timeout=self.timeout_s))

    def close(self) -> None:
        self._channel.close()


def dial_v1_server(address: str, credentials=None, timeout_s: float = 5.0) -> GrpcV1Client:
    """client.go:41-57."""
    return GrpcV1Client(address, timeout_s=timeout_s, credentials=credentials)


def sleep_until_reset(rate_limit: RateLimitResponse) -> None:
    """python/gubernator/__init__.py:12-17."""
    now = time.time()
    delta = rate_limit.reset_time / 1000.0 - now
    if delta > 0:
        time.sleep(delta)


def to_timestamp(duration: datetime.timedelta) -> int:
    """Duration -> unix-millisecond count for request duration fields
    (client.go:62-64)."""
    return int(duration.total_seconds() * 1000)


def from_unix_milliseconds(ts: int) -> datetime.datetime:
    """Unix-ms timestamp -> aware datetime (client.go:76-78)."""
    return datetime.datetime.fromtimestamp(ts / 1000.0, tz=datetime.timezone.utc)


def from_timestamp(ts: int) -> datetime.timedelta:
    """Unix-ms timestamp -> elapsed time since it (now - ts, matching
    client.go:69-72): positive for past timestamps, NEGATIVE for future
    ones.  To wait out a reset_time, use sleep_until_reset, not this."""
    return datetime.datetime.now(tz=datetime.timezone.utc) - from_unix_milliseconds(ts)


def random_peer(peers: List[PeerInfo]) -> PeerInfo:
    """client.go:81-86."""
    return random.choice(peers)


def random_string(prefix: str = "", n: int = 10) -> str:
    """client.go:89-97."""
    return prefix + "".join(random.choices(string.ascii_lowercase + string.digits, k=n))