"""Daemon — process assembly (reference daemon.go).

The port of the JAX package's daemon.py, step for step: the
process-wide switches, the warmup window, TLS, the service over a store
on the configured device (`DaemonConfig.device`: None = the current
CUDA device, which raises without one; "cpu" runs the plain versions),
the kernels' warmup launches, the gRPC server, the HTTP edge (the C++
epoll edge with its ingress pump under GUBER_NATIVE_HTTP=1, else the
stdlib gateway, which alone serves TLS), discovery (static, file,
member-list gossip, etcd or k8s: `peers.make_pool`, given this node's
advertised PeerInfo), and graceful shutdown with the snapshot and Loader
save.  `set_peers` stamps IsOwner by
advertise-address compare exactly like daemon.go:277-287.

The incident black box's process switch
comes with blackbox.py (slice A6).
"""

from __future__ import annotations

import socket
import time
from typing import Optional, Sequence

from .config import DaemonConfig
from .gateway import GatewayServer
from .grpc_server import GrpcServer, channel_credentials
from .metrics import Metrics
from .service import ServiceConfig, V1Service
from .tls import setup_tls
from .types import PeerInfo
from .utils.clock import DEFAULT_CLOCK, Clock
from .utils.net import resolve_host_ip


class Daemon:
    def __init__(self, conf: DaemonConfig, clock: Optional[Clock] = None):
        self.conf = conf
        self.clock = clock or DEFAULT_CLOCK
        self.service: Optional[V1Service] = None
        self.gateway: Optional[GatewayServer] = None
        self.grpc: Optional[GrpcServer] = None
        self._pool = None
        self._closed = False

    # ------------------------------------------------------------------
    def start(self) -> "Daemon":
        """daemon.go:72-251.  On any startup failure, tear down whatever
        was already running: a half-started daemon must not leak bound
        ports and service threads to a retrying supervisor."""
        try:
            return self._start()
        except BaseException:
            self.close()
            raise

    def _start(self) -> "Daemon":
        from . import profiling, telemetry, tracing

        # Process-wide planes: the daemon's parsed knobs win over the
        # modules' import-time env defaults, in both directions.
        tracing.set_sample_rate(self.conf.behaviors.trace_sample)
        telemetry.set_enabled(self.conf.behaviors.xla_telemetry)
        telemetry.set_storm(
            self.conf.behaviors.xla_storm,
            self.conf.behaviors.xla_storm_window_s,
        )
        profiling.set_hz(self.conf.behaviors.profile_hz)
        profiling.set_enabled(self.conf.behaviors.profile)
        # Every build and first launch from here to the end of the
        # warmup is warmup; after mark_steady() one counts as a
        # steady-state rebuild and can trip the storm event.
        telemetry.begin_warmup()
        tls_conf = setup_tls(self.conf.tls)
        server_tls = tls_conf.server_ctx if tls_conf else None
        peer_creds = None
        if tls_conf is not None and not tls_conf.insecure_skip_verify:
            peer_creds = channel_credentials(tls_conf)
        svc_conf = ServiceConfig(
            cache_size=self.conf.cache_size,
            back_cache_size=self.conf.back_cache_size,
            global_cache_size=self.conf.global_cache_size,
            behaviors=self.conf.behaviors,
            data_center=self.conf.data_center,
            persist_store=self.conf.store,
            loader=self.conf.loader,
            snapshot_path=self.conf.snapshot_path,
            blackbox_dir=self.conf.blackbox_dir,
            clock=self.clock,
            metrics=Metrics(),
            device=self.conf.device,
            peer_tls_context=tls_conf.client_ctx if tls_conf else None,
            peer_channel_credentials=peer_creds,
            fault_plan=self.conf.fault_plan,
        )
        self.service = V1Service(svc_conf)
        # Load the kernel library and launch every kernel of the path
        # once BEFORE accepting traffic, outside any client's deadline.
        self.service.store.warmup(
            self.clock.now_ms(), warm_shapes=self.conf.warmup_shapes
        )
        telemetry.mark_steady()
        grpc_listen = self.conf.grpc_listen_address
        if not grpc_listen:
            host, _, _ = self.conf.listen_address.partition(":")
            grpc_listen = f"{host or '127.0.0.1'}:0"
        self.grpc = GrpcServer(
            self.service, grpc_listen, tls_conf=tls_conf,
            max_conn_age_s=self.conf.grpc_max_conn_age_s,
        ).start()
        # HTTP edge: the stdlib gateway by default (and always under
        # TLS); GUBER_NATIVE_HTTP=1 selects the C++ epoll edge, with the
        # native ingress pump unless GUBER_NATIVE_INGRESS=0.
        self.gateway = None
        if self.conf.native_http is True and server_tls is not None:
            raise RuntimeError(
                "GUBER_NATIVE_HTTP=1 is incompatible with TLS: the native "
                "edge has no TLS support (use the default stdlib gateway)"
            )
        if server_tls is None and self.conf.native_http is True:
            from .gateway import NativeGatewayServer

            self.gateway = NativeGatewayServer(
                self.service, self.conf.listen_address,
                n_workers=self.conf.native_workers,
                acceptors=self.conf.acceptors,
                uds_path=self.conf.uds_path,
            )
            if (
                self.conf.behaviors.native_ingress
                and self.service.serves_ingress_columns
            ):
                from .gateway import NativeIngressPump

                pump = NativeIngressPump(self.service).start()
                pump.update_ring()
                self.gateway.pump = pump
        if self.gateway is None:
            self.gateway = GatewayServer(
                self.service, self.conf.listen_address, tls_context=server_tls
            )
        self.gateway.start()
        # Port 0 resolves at bind time; a wildcard host must be replaced
        # by a routable IP before peers see it (net.go:12-33 via
        # config.go:249).  The advertise address names the gRPC port.
        self.service.conf.advertise_address = resolve_host_ip(
            self.conf.advertise_address or self.grpc.address
        )
        self.http_advertise = resolve_host_ip(self.gateway.address)

        if self.conf.peer_discovery_type == "static":
            # A static daemon with no peer list serves standalone: it is
            # its own (sole) owner for every key.
            self.set_peers(self.conf.peers or [self.peer_info])
        elif self.conf.peer_discovery_type == "file":
            from .peers import FilePool

            self._pool = FilePool(self.conf.peers_file, on_update=self.set_peers)
        elif self.conf.peer_discovery_type in ("etcd", "member-list", "k8s"):
            from .peers import make_pool

            self._pool = make_pool(
                self.conf.peer_discovery_type,
                self.conf,
                on_update=self.set_peers,
                advertise=self.peer_info,
            )
        self.wait_for_connect()
        return self

    # ------------------------------------------------------------------
    @property
    def peer_info(self) -> PeerInfo:
        return PeerInfo(
            grpc_address=self.service.conf.advertise_address,
            http_address=self.http_advertise,
            data_center=self.conf.data_center,
        )

    def set_peers(self, peers: Sequence[PeerInfo]) -> None:
        """Stamp IsOwner by address compare, then hand to the service
        (daemon.go:277-287).  Both of this daemon's addresses count as
        "me".  Updates after close() are dropped: a discovery poller
        racing shutdown must not rebuild the ring of a half-torn-down
        service."""
        if self._closed or self.service is None:
            return
        mine = {self.service.conf.advertise_address, self.http_advertise}
        stamped = [
            PeerInfo(
                grpc_address=p.grpc_address,
                http_address=p.http_address or p.grpc_address,
                data_center=p.data_center,
                is_owner=(p.grpc_address in mine or p.http_address in mine),
            )
            for p in peers
        ]
        self.service.set_peers(stamped)

    # ------------------------------------------------------------------
    def wait_for_connect(self, timeout_s: float = 10.0) -> None:
        """Block until every listener accepts (daemon.go:305-344)."""
        deadline = time.monotonic() + timeout_s
        for address in (self.gateway.address, self.grpc.address):
            host, _, port = address.partition(":")
            while True:
                try:
                    with socket.create_connection((host, int(port)), timeout=0.5):
                        break
                except OSError:
                    if time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"listener at {address} never became reachable"
                        )
                    time.sleep(0.05)

    # ------------------------------------------------------------------
    def close(self) -> None:
        """daemon.go:254-274 (the snapshot and Loader save happen in
        service.close)."""
        if self._closed:
            return
        self._closed = True
        if self._pool is not None:
            self._pool.close()
        if self.service is not None:
            self.service.close()
        if self.grpc is not None:
            self.grpc.close()
        if self.gateway is not None:
            self.gateway.close()


def spawn_daemon(conf: DaemonConfig, clock: Optional[Clock] = None) -> Daemon:
    """daemon.go:59-70."""
    return Daemon(conf, clock=clock).start()
