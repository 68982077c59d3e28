"""etcd discovery pool — lease-registration + prefix-watch membership.

The port of the JAX package's etcd_pool.py (host code, no device), over
the port's own copies of the etcd pb2 modules (proto/etcd_kv_pb2.py,
proto/etcd_rpc_pb2.py).  It imports grpc: `peers.make_pool` imports it
only for etcd discovery.

Reference behavior (etcd.go): each daemon registers itself at
`/gubernator/peers/<grpc_address>` with a 30s lease kept alive in the
background, re-registering with a 5s backoff whenever the keepalive is
lost (etcd.go:222-316); it lists the prefix for the current peer set and
watches it (resuming from the list revision) to rebuild the peer map on
every change (etcd.go:110-220); Close deletes the key and revokes the
lease (etcd.go:296-310, 318-321).

The reference depends on the official Go client; this build talks to
etcd's public gRPC API directly (etcdserverpb KV/Lease/Watch) through a
minimal client over grpcio and wire-subset stubs
(proto/etcd_rpc.proto) — wire-compatible with a real etcd v3 cluster
and with the in-process fake used by tests.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import grpc

from .proto import etcd_rpc_pb2 as rpc
from .types import PeerInfo

log = logging.getLogger("gubernator.etcd")

ETCD_TIMEOUT_S = 10.0  # etcd.go:31
BACKOFF_TIMEOUT_S = 5.0  # etcd.go:32
LEASE_TTL_S = 30  # etcd.go:34
DEFAULT_BASE_KEY = "/gubernator/peers/"  # etcd.go:35


def prefix_range_end(prefix: bytes) -> bytes:
    """etcd's GetPrefixRangeEnd: the prefix with its last byte
    incremented (carrying over 0xff)."""
    end = bytearray(prefix)
    for i in reversed(range(len(end))):
        if end[i] < 0xFF:
            end[i] += 1
            return bytes(end[: i + 1])
    return b"\0"  # whole keyspace


class EtcdClient:
    """Minimal etcd v3 client: KV Range/Put/DeleteRange, Lease
    Grant/Revoke/KeepAlive, Watch — just the surface the pool needs."""

    def __init__(
        self,
        endpoints: Sequence[str],
        credentials: Optional[grpc.ChannelCredentials] = None,
        timeout_s: float = ETCD_TIMEOUT_S,
        username: str = "",
        password: str = "",
    ):
        if not endpoints:
            raise ValueError("at least one etcd endpoint is required")
        self.endpoints = list(endpoints)
        self.timeout_s = timeout_s
        self._credentials = credentials
        self._username = username
        self._password = password
        self._metadata: "Optional[list]" = None
        self._endpoint_idx = 0
        self._rotate_lock = threading.Lock()
        self._retired_channels: list = []
        self._connect()

    @property
    def endpoint_index(self) -> int:
        return self._endpoint_idx

    def _connect(self) -> None:
        """(Re)build the channel + stubs against the current endpoint.
        The Go client load-balances across all endpoints; here failover
        is explicit — rotate() advances to the next endpoint and the
        pool's retry loops call it on any RPC failure."""
        target = self.endpoints[self._endpoint_idx]
        if self._credentials is not None:
            self._channel = grpc.secure_channel(target, self._credentials)
        else:
            self._channel = grpc.insecure_channel(target)
        u = self._channel.unary_unary
        s = self._channel.stream_stream
        self._range = u(
            "/etcdserverpb.KV/Range",
            request_serializer=rpc.RangeRequest.SerializeToString,
            response_deserializer=rpc.RangeResponse.FromString,
        )
        self._put = u(
            "/etcdserverpb.KV/Put",
            request_serializer=rpc.PutRequest.SerializeToString,
            response_deserializer=rpc.PutResponse.FromString,
        )
        self._delete = u(
            "/etcdserverpb.KV/DeleteRange",
            request_serializer=rpc.DeleteRangeRequest.SerializeToString,
            response_deserializer=rpc.DeleteRangeResponse.FromString,
        )
        self._compact = u(
            "/etcdserverpb.KV/Compact",
            request_serializer=rpc.CompactionRequest.SerializeToString,
            response_deserializer=rpc.CompactionResponse.FromString,
        )
        self._grant = u(
            "/etcdserverpb.Lease/LeaseGrant",
            request_serializer=rpc.LeaseGrantRequest.SerializeToString,
            response_deserializer=rpc.LeaseGrantResponse.FromString,
        )
        self._revoke = u(
            "/etcdserverpb.Lease/LeaseRevoke",
            request_serializer=rpc.LeaseRevokeRequest.SerializeToString,
            response_deserializer=rpc.LeaseRevokeResponse.FromString,
        )
        self._keepalive = s(
            "/etcdserverpb.Lease/LeaseKeepAlive",
            request_serializer=rpc.LeaseKeepAliveRequest.SerializeToString,
            response_deserializer=rpc.LeaseKeepAliveResponse.FromString,
        )
        self._watch = s(
            "/etcdserverpb.Watch/Watch",
            request_serializer=rpc.WatchRequest.SerializeToString,
            response_deserializer=rpc.WatchResponse.FromString,
        )
        self._authenticate = u(
            "/etcdserverpb.Auth/Authenticate",
            request_serializer=rpc.AuthenticateRequest.SerializeToString,
            response_deserializer=rpc.AuthenticateResponse.FromString,
        )
        # GUBER_ETCD_USER/PASSWORD (config.go:309-310): etcd v3 auth is
        # token-based — Authenticate once per connection, then send the
        # token as `token` metadata on every call.  Re-connecting (the
        # rotate() failover path) re-authenticates, which also renews an
        # expired token: callers' retry loops rotate on auth errors the
        # same as on transport errors.
        if self._username:
            try:
                resp = self._authenticate(
                    rpc.AuthenticateRequest(
                        name=self._username, password=self._password
                    ),
                    timeout=self.timeout_s,
                )
                self._metadata = [("token", resp.token)]
            except grpc.RpcError as e:
                code = e.code() if hasattr(e, "code") else None
                # Wrong credentials must fail pool construction (the
                # reference's client refuses too); a TRANSPORT failure
                # must not kill the retry loops that call rotate() from
                # their own except-handlers — leave the stale/absent
                # token, let the next RPC fail, and back off again.
                if self._metadata is None and code == grpc.StatusCode.INVALID_ARGUMENT:
                    raise
                log.warning("etcd re-authentication failed (will retry): %s", e)

    def rotate(self, observed_index: Optional[int] = None) -> None:
        """Fail over to the next configured endpoint.

        `observed_index` is the endpoint the caller saw failing:
        concurrent failures from the keepalive and watch threads then
        advance the index ONCE, not past the fresh endpoint.  The old
        channel is retired, not closed — the other thread's healthy
        stream on it keeps running; retirees close at client close()."""
        with self._rotate_lock:
            if observed_index is not None and observed_index != self._endpoint_idx:
                return  # another thread already rotated away
            if len(self.endpoints) <= 1:
                # Single endpoint: nothing to fail over to, but rebuild
                # the channel anyway — with auth enabled this is the
                # only place an expired token gets renewed (etcd simple
                # tokens expire server-side; every caller reaches here
                # via its failure-retry loop).
                self._retired_channels.append(self._channel)
                while len(self._retired_channels) > 2:
                    self._retired_channels.pop(0).close()
                self._connect()
                return
            self._retired_channels.append(self._channel)
            # Bound the retirement list: only the most recent retirees
            # can still carry another thread's live stream; older ones
            # closed their streams rotations ago — close them now or a
            # long outage leaks a channel per backoff cycle.
            while len(self._retired_channels) > 2:
                self._retired_channels.pop(0).close()
            self._endpoint_idx = (self._endpoint_idx + 1) % len(self.endpoints)
            self._connect()

    # ------------------------------------------------------------------
    def range_prefix(self, prefix: str) -> Tuple[List[Tuple[str, bytes]], int]:
        """All (key, value) under prefix, plus the store revision to
        resume a watch from (etcd.go:141-161)."""
        p = prefix.encode()
        resp = self._range(
            rpc.RangeRequest(key=p, range_end=prefix_range_end(p)),
            timeout=self.timeout_s, metadata=self._metadata,
        )
        kvs = [(kv.key.decode(), kv.value) for kv in resp.kvs]
        return kvs, resp.header.revision

    def compact(self, revision: int) -> None:
        """KV.Compact — not used by the pool itself (etcd compacts on
        its own schedule in production); exposed for the integration
        tests that prove the pool survives watch-resume across a
        compaction (mvcc ErrCompacted -> canceled watch -> re-list)."""
        self._compact(
            rpc.CompactionRequest(revision=revision),
            timeout=self.timeout_s, metadata=self._metadata,
        )

    def put(self, key: str, value: bytes, lease_id: int = 0) -> None:
        self._put(
            rpc.PutRequest(key=key.encode(), value=value, lease=lease_id),
            timeout=self.timeout_s, metadata=self._metadata,
        )

    def delete(self, key: str) -> None:
        self._delete(
            rpc.DeleteRangeRequest(key=key.encode()),
            timeout=self.timeout_s, metadata=self._metadata,
        )

    def lease_grant(self, ttl_s: int) -> int:
        resp = self._grant(
            rpc.LeaseGrantRequest(TTL=ttl_s),
            timeout=self.timeout_s, metadata=self._metadata,
        )
        if resp.error:
            raise RuntimeError(f"lease grant failed: {resp.error}")
        return resp.ID

    def lease_revoke(self, lease_id: int) -> None:
        self._revoke(
            rpc.LeaseRevokeRequest(ID=lease_id),
            timeout=self.timeout_s, metadata=self._metadata,
        )

    def lease_keepalive(self, lease_id: int, interval_s: float, stop: threading.Event):
        """Generator of keepalive responses, sending a ping every
        `interval_s` until `stop` is set or the stream dies.  The caller
        treats StopIteration/RpcError as 'keepalive lost'."""

        def requests():
            while not stop.is_set():
                yield rpc.LeaseKeepAliveRequest(ID=lease_id)
                stop.wait(interval_s)

        return self._keepalive(requests(), metadata=self._metadata)

    def watch_prefix(self, prefix: str, start_revision: int, stop: threading.Event):
        """Returns (response_iterator, done_event) for a prefix watch
        from `start_revision`.  The caller MUST set `done` when it stops
        consuming the stream: the request-side generator parks in a
        bounded wait on (done | stop), so gRPC's request-consumer thread
        exits promptly instead of leaking one blocked thread per watch
        attempt."""
        p = prefix.encode()
        done = threading.Event()

        def requests():
            yield rpc.WatchRequest(
                create_request=rpc.WatchCreateRequest(
                    key=p,
                    range_end=prefix_range_end(p),
                    start_revision=start_revision,
                )
            )
            while not stop.is_set() and not done.is_set():
                done.wait(0.5)

        return self._watch(requests(), metadata=self._metadata), done

    def close(self) -> None:
        with self._rotate_lock:
            for ch in self._retired_channels:
                ch.close()
            self._retired_channels.clear()
            self._channel.close()


def credentials_from_config(conf) -> Optional[grpc.ChannelCredentials]:
    """setupEtcdTLS equivalent (config.go:390-433): build channel
    credentials from the GUBER_ETCD_TLS_* surface.

      * GUBER_ETCD_TLS_CA           — verify against this CA
      * GUBER_ETCD_TLS_CERT/KEY     — client certificate (mTLS)
      * GUBER_ETCD_TLS_ENABLE       — TLS with system roots
      * GUBER_ETCD_TLS_SKIP_VERIFY  — TLS pinning each endpoint's own
        certificate fetched at startup (Python gRPC cannot disable
        verification outright; trust-on-first-use is the closest
        faithful semantic to the reference's InsecureSkipVerify)

    Returns None when no TLS knob is set (plaintext)."""
    ca = getattr(conf, "etcd_tls_ca", "")
    cert = getattr(conf, "etcd_tls_cert", "")
    key = getattr(conf, "etcd_tls_key", "")
    enable = getattr(conf, "etcd_tls_enable", False)
    skip = getattr(conf, "etcd_tls_skip_verify", False)
    if not (ca or (cert and key) or enable or skip):
        return None
    root_pem = None
    if ca:
        with open(ca, "rb") as f:
            root_pem = f.read()
    elif skip:
        import ssl as _ssl

        pins = []
        for ep in getattr(conf, "etcd_endpoints", []):
            host, _, port = ep.partition(":")
            try:
                pins.append(
                    _ssl.get_server_certificate(
                        (host, int(port or 2379)), timeout=ETCD_TIMEOUT_S
                    )
                )
            except OSError as e:  # endpoint down: pin the others
                log.warning("etcd skip-verify pin failed for %s: %s", ep, e)
        if pins:
            root_pem = "".join(pins).encode()
    key_pem = chain_pem = None
    if cert and key:
        with open(key, "rb") as f:
            key_pem = f.read()
        with open(cert, "rb") as f:
            chain_pem = f.read()
    return grpc.ssl_channel_credentials(
        root_certificates=root_pem,
        private_key=key_pem,
        certificate_chain=chain_pem,
    )


class EtcdPool:
    """Peer discovery over etcd (reference EtcdPool, etcd.go:42-334)."""

    def __init__(
        self,
        advertise: PeerInfo,
        on_update: Callable[[List[PeerInfo]], None],
        endpoints: Sequence[str] = ("127.0.0.1:2379",),
        key_prefix: str = DEFAULT_BASE_KEY,
        client: Optional[EtcdClient] = None,
        credentials: Optional[grpc.ChannelCredentials] = None,
        lease_ttl_s: int = LEASE_TTL_S,
        backoff_s: float = BACKOFF_TIMEOUT_S,
        username: str = "",
        password: str = "",
    ):
        if not advertise.grpc_address:
            raise ValueError("Advertise.GRPCAddress is required")  # etcd.go:78
        self.advertise = advertise
        self.on_update = on_update
        self.key_prefix = key_prefix
        self.lease_ttl_s = lease_ttl_s
        self.backoff_s = backoff_s
        self.client = client or EtcdClient(
            endpoints, credentials=credentials,
            username=username, password=password,
        )
        self._instance_key = key_prefix + advertise.grpc_address
        self._peers: dict = {}
        self._peers_lock = threading.Lock()
        self._stop = threading.Event()
        self._lease_id: Optional[int] = None

        # Initial registration is synchronous like the reference
        # (etcd.go:262-264: failure fails pool construction), trying
        # each configured endpoint before giving up.
        for attempt in range(len(self.client.endpoints)):
            try:
                self._register_once()
                break
            except grpc.RpcError:
                if attempt == len(self.client.endpoints) - 1:
                    raise
                self.client.rotate()
        self._collect_and_notify()

        self._threads = [
            threading.Thread(target=self._keepalive_loop, daemon=True),
            threading.Thread(target=self._watch_loop, daemon=True),
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------
    def _register_once(self) -> None:
        """Grant lease + put our PeerInfo under it (etcd.go:240-259)."""
        payload = json.dumps(self.advertise.to_json()).encode()
        self._lease_id = self.client.lease_grant(self.lease_ttl_s)
        self.client.put(self._instance_key, payload, lease_id=self._lease_id)

    def _keepalive_loop(self) -> None:
        """Consume keepalives; on loss, re-register with backoff
        (etcd.go:266-295)."""
        while not self._stop.is_set():
            ep = self.client.endpoint_index
            try:
                stream = self.client.lease_keepalive(
                    self._lease_id, max(self.lease_ttl_s / 3.0, 0.05), self._stop
                )
                for resp in stream:
                    if self._stop.is_set():
                        return
                    if resp.TTL <= 0:
                        # Real etcd keeps the stream open and answers an
                        # expired lease with TTL=0; treat it like a
                        # stream loss (the Go client closes its channel
                        # on TTL<=0, which etcd.go re-registers on).
                        break
            except grpc.RpcError:
                self.client.rotate(ep)
            if self._stop.is_set():
                return
            log.warning("keep alive lost, attempting to re-register peer")
            while not self._stop.is_set():
                ep = self.client.endpoint_index
                try:
                    self._register_once()
                    break
                except grpc.RpcError as e:
                    log.error("while attempting to re-register peer: %s", e)
                    self.client.rotate(ep)
                    self._stop.wait(self.backoff_s)

    # ------------------------------------------------------------------
    def _collect_and_notify(self) -> int:
        """List the prefix, rebuild the peer map, push an update;
        returns the revision to watch from (etcd.go:141-161)."""
        kvs, revision = self.client.range_prefix(self.key_prefix)
        peers = {}
        for key, value in kvs:
            info = self._unmarshal(value)
            if info is not None:
                peers[key] = info
        with self._peers_lock:
            self._peers = peers
        self._call_on_update()
        return revision

    def _watch_loop(self) -> None:
        """Watch the prefix from the collect revision; any event mutates
        the peer map and re-notifies; stream failure re-collects with
        backoff (etcd.go:96-139, 174-220)."""
        revision = None
        while not self._stop.is_set():
            done = None
            ep = self.client.endpoint_index
            try:
                if revision is None:
                    revision = self._collect_and_notify() + 1
                stream, done = self.client.watch_prefix(
                    self.key_prefix, revision, self._stop
                )
                for resp in stream:
                    if self._stop.is_set():
                        return
                    if resp.canceled:
                        break
                    changed = False
                    for ev in resp.events:
                        key = ev.kv.key.decode()
                        if ev.type == 1:  # DELETE
                            changed = self._peers.pop(key, None) is not None or changed
                        else:  # PUT
                            info = self._unmarshal(ev.kv.value)
                            if info is not None:
                                self._peers[key] = info
                                changed = True
                        revision = max(revision, ev.kv.mod_revision + 1)
                    if changed:
                        self._call_on_update()
            except grpc.RpcError:
                self.client.rotate(ep)
            finally:
                if done is not None:
                    done.set()  # release the request-side generator
            if self._stop.is_set():
                return
            revision = None  # full re-collect after any stream failure
            self._stop.wait(self.backoff_s)

    @staticmethod
    def _unmarshal(value: bytes) -> Optional[PeerInfo]:
        try:
            return PeerInfo.from_json(json.loads(value.decode()))
        except (ValueError, UnicodeDecodeError):
            log.error("unable to unmarshal PeerInfo from etcd value %r", value[:100])
            return None

    def _call_on_update(self) -> None:
        """etcd.go:323-334 (IsOwner stamped by the daemon's set_peers;
        the reference stamps here, but the daemon re-stamps anyway)."""
        with self._peers_lock:
            peers = sorted(self._peers.values(), key=lambda p: p.grpc_address)
        try:
            self.on_update(peers)
        except Exception:  # noqa: BLE001
            log.exception("on_update callback failed")

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Deregister then shut down (etcd.go:296-310, 318-321)."""
        if self._stop.is_set():
            return
        self._stop.set()
        try:
            self.client.delete(self._instance_key)
            if self._lease_id is not None:
                self.client.lease_revoke(self._lease_id)
        except grpc.RpcError as e:
            log.warning("during etcd deregistration: %s", e)
        for t in self._threads:
            t.join(timeout=2.0)
        self.client.close()
