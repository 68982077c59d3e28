"""Configuration: behavior knobs, service/daemon config, GUBER_* env parsing.

Mirrors config.go: `BehaviorConfig` (config.go:42-63) with the same
defaults (BatchTimeout 500ms, BatchWait 500us, BatchLimit 1000, and the
GLOBAL/multi-region equivalents, config.go:106-133), `DaemonConfig`
(config.go:155-202), and `setup_daemon_config` env handling
(config.go:220-388): env-file lines -> GUBER_* environment -> defaults.

Divergence: the default GLOBAL/multi-region sync window is 100ms instead
of the reference's 500us — each sync here is a device launch whose
cost wants amortizing; tests and deployments tune it down exactly like
the reference's own test harness does (cluster/cluster.go:104-110 uses
50ms).

The port parses and validates every knob of the JAX package's
config.py, so one environment yields the same DaemonConfig in both
(tests/test_torch_config.py).  Knobs of planes the port does not have
yet (peers, discovery, TLS, the native edge, telemetry, profiling,
audit, federation, the black box) are parsed and carried; nothing in
the port reads them.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .types import PeerInfo

MAX_BATCH_SIZE = 1000  # gubernator.go:36

# Lane cap for ONE public columnar ingress request: a columnar client
# coalesces many callers' checks into one frame, so it carries more
# than the classic per-request cap (the columnar peer hop's cap).
INGRESS_COLUMNS_MAX_LANES = 16_384


@dataclass
class BehaviorConfig:
    """config.go:42-63 (durations in seconds)."""

    batch_timeout_s: float = 0.5
    batch_wait_s: float = 0.0005
    batch_limit: int = 1000
    # Bounded ingress queue (lanes): the LocalBatcher/ColumnarBatcher
    # coalescing windows admit at most this many queued LANES (a
    # multi-item columnar submission counts every lane).  A submission
    # that would exceed the cap is SHED with a 429-style
    # ResourceExhausted error (NOT an OVER_LIMIT status — that is an
    # answer about the client's limit, not about daemon overload) and
    # counted.  Rationale: every queued caller pays the backlog, so
    # past the point where queued work exceeds any useful deadline,
    # shedding is strictly kinder than queueing.  The default admits
    # ~4 full flushes of the columnar batcher (4 x 64k lanes); 0
    # disables the bound.  Env: GUBER_INGRESS_QUEUE_LANES.
    ingress_queue_lanes: int = 262_144
    # Columnar peer hop (wire.py "columnar peer hop"): forwarded batches
    # travel as column arrays (proto columns on gRPC, the binary frame
    # on HTTP) and are served from the columnar receive path.  False
    # disables BOTH directions — the daemon neither sends nor serves
    # columns, behaving exactly like a pre-columns peer (the
    # mixed-version interop tests run one daemon in this mode).
    # Env: GUBER_PEER_COLUMNS.
    peer_columns: bool = True
    # Native ingress service loop (host_runtime.cpp gt_ingress_*): on
    # the native HTTP edge, steady-state kind-5 ingress frames are
    # validated, hashed, ring-routed, coalesced, dispatched and
    # answered with Python touching only batch-granularity control —
    # the GIL leaves the per-frame path entirely.  False = every frame
    # decodes/encodes through the Python gateway path
    # (behavior-identical — the fast lane serves only semantics
    # the Python path also serves; this knob exists for A/B and as the
    # interop-proof off switch).  Env: GUBER_NATIVE_INGRESS.
    native_ingress: bool = True
    # Public columnar ingress (wire.py "public columnar ingress", the
    # front door): the daemon sniffs GUBC kind-5 frames on
    # POST /v1/GetRateLimits and serves V1/GetRateLimitsColumns over
    # gRPC, decoding client batches straight into ingress columns (no
    # per-request JSON/dict/dataclass work) and answering from the
    # result arrays.  False withholds both surfaces — a columns client
    # sees 400/UNIMPLEMENTED exactly like against a pre-columns build
    # and falls back sticky to classic JSON (the mixed-version interop
    # mode); classic clients are unaffected either way.
    # Env: GUBER_INGRESS_COLUMNS.
    ingress_columns: bool = True

    global_timeout_s: float = 0.5
    # None = AUTO: size the window from the measured device cost of one
    # sync launch (GlobalManager resolves it from its ticks so the sync
    # overhead stays ~10% of the window).  Set a float (or
    # GUBER_GLOBAL_SYNC_WAIT) to pin it, as the test harness does
    # (cluster.py uses 50ms, mirroring cluster/cluster.go:104-110).
    global_sync_wait_s: Optional[float] = None
    global_batch_limit: int = 1000
    # Columnar GLOBAL replication plane (architecture.md "GLOBAL
    # plane"): broadcasts travel as one GlobalsColumns batch (proto
    # columns on gRPC, the GUBC globals frame on HTTP), encoded once
    # per tick and committed by the receiver in one device program;
    # forwarded GLOBAL hits ride the columnar GetPeerRateLimits path.
    # False disables BOTH directions — the daemon sends per-item
    # classic encodings, serves no columnar globals surface, and
    # commits received broadcasts per item, behaving exactly like a
    # pre-columns peer (wire- and dispatch-identical; the interop mode).
    # Env: GUBER_GLOBAL_COLUMNS.
    global_columns: bool = True
    # Broadcast fan-out concurrency: the GlobalManager sends one
    # sync pass's broadcasts to all peers through a pool of this many
    # workers, so tick wall-time stops scaling as peers x RTT (the
    # pre-columns sender fanned out serially).  Env: GUBER_GLOBAL_FANOUT.
    global_fanout: int = 8

    # -- multi-region federation plane (federation.py) -----------------
    # Per-send deadline of one cross-region batch.
    # Env: GUBER_MULTI_REGION_TIMEOUT.
    multi_region_timeout_s: float = 0.5
    # Flush window of the per-region accumulator: MULTI_REGION hits
    # aggregate per key for this long, then one encode-once batch fans
    # to every remote region's owners.  Env: GUBER_MULTI_REGION_SYNC_WAIT.
    multi_region_sync_wait_s: float = 0.1
    # Queue-full early flush (multiregion.go batching semantics): the
    # accumulator flushes IMMEDIATELY when it holds this many distinct
    # keys instead of waiting out the window.  0 disables the early
    # kick (window-only flushes).  Env: GUBER_MULTI_REGION_BATCH_LIMIT.
    multi_region_batch_limit: int = 1000
    # Columnar inter-region wire (the GUBC region frame / proto
    # RegionColumnsReq served as PeersV1/UpdateRegionColumns).  False
    # disables BOTH directions — sends use the classic per-item
    # GetPeerRateLimits encoding (byte-identical to the pre-federation
    # sender) and the region surface is withheld so peers see
    # UNIMPLEMENTED/404, exactly like a pre-federation daemon (the
    # mixed-version interop mode).  Env: GUBER_REGION_COLUMNS.
    region_columns: bool = True

    # -- peer fault tolerance (faults.py) ------------------------------
    # Per-peer circuit breaker: this many consecutive transport
    # failures open the circuit; while open, calls to the peer fail
    # fast and forwarded keys degrade to local evaluation.  After the
    # open interval one half-open probe decides re-close vs re-open.
    circuit_threshold: int = 5  # GUBER_CIRCUIT_THRESHOLD
    circuit_open_interval_s: float = 2.0  # GUBER_CIRCUIT_OPEN_INTERVAL
    # Forward re-pick loop: attempt budget (the reference hardcodes 5,
    # gubernator.go:154-162) and the jittered-backoff envelope slept
    # between attempts (full jitter, so a herd that saw one peer die
    # does not retry in lockstep).
    forward_retry_limit: int = 5  # GUBER_FORWARD_RETRY_LIMIT
    retry_backoff_base_s: float = 0.02  # GUBER_RETRY_BACKOFF_BASE
    retry_backoff_max_s: float = 1.0  # GUBER_RETRY_BACKOFF_MAX
    # Host-tier GLOBAL / multi-region send loops: retries per peer send
    # per tick (0 = one attempt, no retry).  Kept small — a failed peer
    # is the breaker's job across ticks, not this budget's.
    global_send_retries: int = 1  # GUBER_GLOBAL_SEND_RETRIES

    # -- request tracing (tracing.py) ----------------------------------
    # Ingress sampling rate, 0..1.  0 (the default) disables tracing
    # entirely: every hook is a single comparison and the peer wire is
    # byte-identical to a pre-trace build (the interop parity
    # contract).  The daemon applies this process-wide at startup.
    # Env: GUBER_TRACE_SAMPLE.
    trace_sample: float = 0.0

    # -- millisecond express lane (architecture.md "Express lane") -----
    # Shallow-queue latency bypass: small submissions dispatch
    # IMMEDIATELY (no coalescing window) when the batcher queue and the
    # dispatch pipeline are shallow, singleton checks on CPU backends
    # take the host-side scalar path (ops/scalar.py, zero device
    # programs), NO_BATCHING frames ride the native express queue
    # instead of the Python fallback, and GUBER_LATENCY_TARGET_MS caps
    # the effective coalescing window (see latency_target_ms below).
    # False = exact pre-express behavior: every submission waits out
    # the window, NO_BATCHING frames on the native edge fall back to
    # Python, the window is occupancy-sized only (the interop/A-B off
    # switch; byte-identical results either way — the bypass changes
    # WHEN a dispatch launches, never what it computes).
    # Env: GUBER_EXPRESS.
    express: bool = True
    # Bypass shallow-queue threshold, in queued LANES: a submission
    # takes the express bypass only while fewer than this many lanes
    # are queued at its batcher (deeper queues mean the window is
    # already coalescing real backlog — bypassing it would only add
    # dispatches without helping latency).  Env: GUBER_EXPRESS_QUEUE_DEPTH.
    express_queue_depth: int = 64
    # Bypass small-batch ceiling, in lanes: submissions wider than this
    # always take the window (a wide batch amortizes its own dispatch;
    # the bypass exists for the 1-4 lane interactive shapes).
    # Env: GUBER_EXPRESS_MAX_LANES.
    express_max_lanes: int = 4
    # Host-side scalar fast path for singleton checks on CPU backends
    # (ops/scalar.py): skip device dispatch entirely, same ticket-order
    # commit discipline.  Only meaningful with express on; exists as a
    # separate switch so the bypass can be A/B-tested with and without
    # the scalar slot.  Env: GUBER_EXPRESS_SCALAR.
    express_scalar: bool = True

    # -- latency SLO engine (saturation.py) ----------------------------
    # Ingress latency target in ms.  > 0 turns on the SLO burn-rate
    # engine: every V1/GetRateLimits is judged good/bad against the
    # target, multi-window (5m/1h) error-budget burn rates export as
    # gubernator_slo_burn_rate, and a page-level fast burn (>= 14.4x
    # on the 5m window) dumps the flight recorder.  With the express
    # lane on, the knob is also BINDING: it caps the effective
    # coalescing window of both ingress batchers at target/2 (half the
    # budget for coalescing, half for dispatch+readback — architecture
    # .md "Express lane"), so occupancy mode yields to latency mode.
    # 0 (default) disables the engine and leaves the window
    # occupancy-sized.  Env: GUBER_LATENCY_TARGET_MS.
    latency_target_ms: float = 0.0
    # SLO objective: the fraction of ingress requests that must answer
    # under the target (the error budget is 1 - objective).
    # Env: GUBER_SLO_OBJECTIVE.
    slo_objective: float = 0.99

    # -- device telemetry (the JAX package's telemetry.py) -------------
    # Per-program launch timings + device memory sampling; the knobs
    # keep the JAX package's names.  Env: GUBER_XLA_TELEMETRY.
    xla_telemetry: bool = True
    # Recompile-storm trip of the JAX package (nothing compiles at run
    # time in the port).
    # Env: GUBER_XLA_STORM / GUBER_XLA_STORM_WINDOW (window is a Go
    # duration; a bare number means ms).
    xla_storm: int = 3
    xla_storm_window_s: float = 60.0

    # -- cost observatory (profiling.py) -------------------------------
    # Continuous host sampling profiler: a daemon thread folds every
    # thread's stack ~profile_hz times/s into phase-tagged flamegraph
    # windows (GET /debug/pprof).  False compiles the plane out: the
    # sampler tick is one branch, every scope hook one comparison
    # returning a shared no-op (the bench gate pins the overhead ratio
    # >= 0.95 — profiling_overhead_ratio).  Env: GUBER_PROFILE.
    profile: bool = True
    # Sampling rate in Hz (out-of-range [1, 1000] values are rejected
    # loudly at boot, never clamped; the default 67 is deliberately not
    # a divisor of common periodic work, and each tick adds seeded
    # jitter so the sampler cannot phase-lock with a workload).  Env:
    # GUBER_PROFILE_HZ.
    profile_hz: float = 67.0
    # Tenant cost ledger cardinality bound: the top-K rate-limit NAMES
    # keep exact per-tenant accumulators (hits, over-limit, shed,
    # ingress bytes, lane-time/queue shares); everyone else rolls into
    # one `other` bucket, so metric cardinality is K+1 no matter how
    # many distinct names exist.  Env: GUBER_TENANT_TOPK.
    tenant_topk: int = 16

    # -- conservation audit (audit.py) ---------------------------------
    # Always-on windowed reconciliation of the exactly-once ledgers
    # (hits admitted vs dispatched vs applied vs forwarded, GLOBAL
    # carry slack, reshard lane conservation), publishing
    # gubernator_audit_violations_total{invariant} and auto-dumping the
    # flight recorder on any violation.  False stops the checker
    # thread; the ledger counters themselves are always recorded (one
    # int add per batch).  Env: GUBER_AUDIT.
    audit: bool = True
    # Reconciliation cadence in seconds.  Env: GUBER_AUDIT_INTERVAL
    # (a Go duration string; a bare number means ms).
    audit_interval_s: float = 5.0

    # -- elastic membership / live resharding (reshard.py) -------------
    # On a ring delta, drain moved device-resident counters off the old
    # owner and ship them to the new owner as a columnar transfer
    # (GUBC frame kind 4 / PeersV1.TransferOwnership), instead of
    # silently orphaning them — a scale-out event stops being a
    # cluster-wide rate-limit reset.  False = the pre-reshard interop
    # mode: no transfer surface is served (senders negotiate down,
    # exactly like talking to an old build), no handoff is initiated,
    # and a ring change resets moved buckets (legacy semantics).
    # Env: GUBER_RESHARD.
    reshard: bool = True
    # Double-dispatch read window after a membership change: for this
    # long, reads of keys whose owner moved are also peeked (hits=0) at
    # the OLD owner and merged monotonically, so no request observes a
    # reset bucket while the state transfer is in flight.  0 disables
    # the window (transfers still run).  Env: GUBER_RESHARD_HANDOFF.
    reshard_handoff_s: float = 2.0

    # -- durability plane (snapshot.py) --------------------------------
    # Background snapshot cadence in seconds (only active when a
    # snapshot path is configured via GUBER_SNAPSHOT / DaemonConfig
    # .snapshot_path).  0 = shutdown-only snapshots: the file is still
    # written on close()/SIGTERM, just never on a timer.  Env:
    # GUBER_SNAPSHOT_INTERVAL (a Go duration string; bare number = ms).
    snapshot_interval_s: float = 60.0

    # -- incident black box (blackbox.py) ------------------------------
    # Always-on bounded traffic tap at every GUBC wire choke point:
    # per-wire byte-budgeted rings of raw frames, frozen into a
    # crash-safe on-disk bundle whenever a flight-recorder auto-dump
    # trigger fires (breaker-open, audit-violation, slo-fast-burn, ...)
    # or an operator POSTs /debug/incident — replayable with
    # scripts/replay.py.  False = one branch per frame (the tap and
    # trigger hooks go dark; bench-gated blackbox_overhead_ratio).
    # Env: GUBER_BLACKBOX.
    blackbox: bool = True
    # Total in-memory capture budget in MiB, split across the five wire
    # rings (public/peer/global/transfer/region).  Env:
    # GUBER_BLACKBOX_MB (loud reject outside [1, 4096]).
    blackbox_mb: int = 64
    # Bundle retention: oldest incident-* dirs beyond this count are
    # pruned after each write.  Env: GUBER_BLACKBOX_RETAIN (loud reject
    # outside [1, 1024]).
    blackbox_retain: int = 8


@dataclass
class DaemonConfig:
    """config.go:155-202 equivalent.

    `grpc_listen_address` is the gRPC data plane (client V1 + peer
    PeersV1, the reference's GUBER_GRPC_ADDRESS); `listen_address` is
    the HTTP/JSON gateway + /metrics (GUBER_HTTP_ADDRESS).  An empty
    grpc_listen_address binds an ephemeral port on the gateway host.
    """

    listen_address: str = "127.0.0.1:1050"
    grpc_listen_address: str = ""
    # Rotate long-lived gRPC client connections (daemon.go:91-96,
    # GUBER_GRPC_MAX_CONN_AGE_SEC); 0 disables.
    grpc_max_conn_age_s: int = 0
    advertise_address: str = ""
    cache_size: int = 50_000
    back_cache_size: int = 0  # two-tier back tier (0 = single-tier)
    # None = auto-size to cache_size, clamped [4096, 65536] (the
    # reference caps GLOBAL keys only by its shared cache,
    # global.go:83-91).  See ServiceConfig.global_cache_size.
    global_cache_size: "int | None" = None
    # HTTP edge: True serves the gateway from the C++ epoll edge
    # (NativeGatewayServer — better tail latency and per-request
    # overhead; startup error if the native runtime is missing or TLS
    # is on).  Default/False: the stdlib gateway (wins bulk-batch
    # throughput on few-core hosts — measured A/B in RESULTS.md).
    # Env: GUBER_NATIVE_HTTP=1/0.
    native_http: "bool | None" = None
    # Native-edge Python worker count (parse + submit only — the async
    # completion path means workers never block on device rounds, so a
    # handful saturates the submit path; raise on many-core hosts if
    # /metrics shows ingress-queue 503s).  None = NativeGatewayServer
    # default (4).  Env: GUBER_NATIVE_WORKERS.
    native_workers: "int | None" = None
    # Native-edge acceptor sharding: N SO_REUSEPORT listen sockets on
    # the HTTP port, each with its own epoll loop thread, all feeding
    # the one shared device pipeline — the kernel spreads accepted
    # connections across the group, so a single serializing accept/
    # read loop stops being the ingress ceiling.  1 (default) is the
    # classic single loop, behavior-identical to the pre-sharding
    # edge.  Only meaningful with GUBER_NATIVE_HTTP=1.
    # Env: GUBER_ACCEPTORS.
    acceptors: int = 1
    # Same-host UDS lane: when set, the native edge ALSO listens on
    # this AF_UNIX socket path, speaking the identical HTTP/1.1 +
    # GUBC kind-5/6 protocol (the sidecar deployment shape — a
    # same-pod client skips the TCP stack entirely).  Clients target
    # it as `unix:///path` (ColumnsV1Client / V1Client).  A stale
    # socket file at the path is unlinked at startup; "" disables.
    # Only meaningful with GUBER_NATIVE_HTTP=1.  Env: GUBER_UDS_PATH.
    uds_path: str = ""
    # Durability plane (snapshot.py): path of the crash-safe columnar
    # device-state snapshot file.  "" (and the explicit opt-outs "0"/
    # "false"/"off" in the env var) = disabled — every restart is a
    # full reset, exactly the pre-durability daemon.  Written with
    # temp+fsync+rename on close()/SIGTERM and every
    # behaviors.snapshot_interval_s; restored at boot with ONE monotone
    # merge-commit.  Env: GUBER_SNAPSHOT.
    snapshot_path: str = ""
    # Incident black box (blackbox.py): directory incident bundles are
    # written into.  "" (and the boolean-flavored opt-outs in the env
    # var) = no bundles — the in-memory rings still run (and feed
    # /debug/status), there's just nowhere to freeze them to.
    # Env: GUBER_BLACKBOX_DIR.
    blackbox_dir: str = ""
    data_center: str = ""
    behaviors: BehaviorConfig = field(default_factory=BehaviorConfig)
    # Static peer list (the zero-dependency discovery mode; etcd,
    # member-list and k8s discovery are not ported yet).
    peers: List[PeerInfo] = field(default_factory=list)
    peer_discovery_type: str = "static"  # static | file | etcd | member-list | k8s
    peers_file: str = ""
    # member-list gossip knobs (reference MemberListPoolConfig,
    # memberlist.go:44-66 / config.go:314-317).
    member_list_address: str = ""  # bind host:port, default advertise_host:7946
    member_list_known_nodes: List[str] = field(default_factory=list)
    member_list_node_name: str = ""
    # etcd discovery knobs (reference EtcdPoolConfig, etcd.go:54-72 /
    # config.go:304-312).
    etcd_endpoints: List[str] = field(default_factory=lambda: ["localhost:2379"])
    etcd_key_prefix: str = "/gubernator/peers/"
    etcd_advertise_address: str = ""  # defaults to the daemon advertise address
    # etcd auth + TLS (config.go:309-310, setupEtcdTLS config.go:390-433)
    etcd_user: str = ""
    etcd_password: str = ""
    etcd_tls_enable: bool = False
    etcd_tls_cert: str = ""
    etcd_tls_key: str = ""
    etcd_tls_ca: str = ""
    etcd_tls_skip_verify: bool = False
    # k8s discovery knobs (reference K8sPoolConfig, kubernetes.go:63-72 /
    # config.go:320-328).
    k8s_namespace: str = "default"
    k8s_pod_ip: str = ""
    k8s_pod_port: str = "81"  # reference default (kubernetes.go peer port)
    k8s_selector: str = ""
    k8s_mechanism: str = "endpoints"  # endpoints | pods
    store: object = None
    loader: object = None
    # Deterministic chaos harness: a faults.FaultPlan consulted by every
    # PeerClient this daemon creates and by the gossip prober (None =
    # honor the process-wide faults.install() plan instead).
    fault_plan: object = None  # Optional[faults.FaultPlan]
    # Seed for the SWIM probe-order RNG (gossip.py) so suspect/confirm
    # transitions replay deterministically in chaos tests.  None = a
    # fresh unseeded RNG per node.  Env: GUBER_GOSSIP_SEED.
    gossip_seed: "int | None" = None
    debug: bool = False
    # TLS (reference tls.go); wraps the gateway listener and the peer
    # transport when set (TLSConfig above).
    tls: object = None  # Optional[TLSConfig]
    # The store's device: None = the current CUDA device (raises
    # without one); "cpu" runs the plain versions.
    device: object = None
    # Lane counts MeshBucketStore.warmup launches at startup (the
    # kernels' library load and first launches happen there, not inside
    # a client's deadline).  Env: GUBER_WARMUP_SHAPES.
    warmup_shapes: List[int] = field(default_factory=lambda: [1, 250, 1000])

    def resolved_advertise(self) -> str:
        return self.advertise_address or self.listen_address


WATCH_ENDPOINTS = "endpoints"
WATCH_PODS = "pods"


def watch_mechanism_from_string(mechanism: str) -> str:
    """kubernetes.go:51-62: empty defaults to endpoints (the JAX
    package's k8s_pool.py helper, kept here until discovery is ported)."""
    if mechanism in ("", WATCH_ENDPOINTS):
        return WATCH_ENDPOINTS
    if mechanism == WATCH_PODS:
        return WATCH_PODS
    raise ValueError(f"unknown watch mechanism specified: {mechanism}")


@dataclass
class TLSConfig:
    """tls.go:30-104 file paths and switches, as the JAX package's
    tls.py holds them; the port has no TLS transport yet."""

    ca_file: str = ""
    ca_key_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    auto_tls: bool = False
    client_auth: str = ""  # "", "request", "require-and-verify"
    client_auth_ca_file: str = ""
    client_auth_cert_file: str = ""
    client_auth_key_file: str = ""
    insecure_skip_verify: bool = False

    @property
    def enabled(self) -> bool:
        return bool(self.auto_tls or self.cert_file or self.ca_file)


def _env_bool(merged: "Dict[str, str]", key: str, default: bool) -> bool:
    """Reference getEnvBool semantics: any truthy string enables
    (config.go:444-489); absent keeps the default."""
    v = merged.get(key, "")
    if v == "":
        return default
    return v.lower() in ("true", "1", "yes")


def _env_int(env: Dict[str, str], name: str, default: int) -> int:
    v = env.get(name, "")
    return int(v) if v else default


_DURATION_UNITS_S = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,
    "μs": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
}

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|μs|ms|s|m|h)")


def parse_duration(v: str) -> float:
    """Go duration string -> seconds: '300ms', '1m30s', '1.5h', with the
    same unit set as time.ParseDuration. A bare number is milliseconds."""
    v = v.strip()
    if not v:
        raise ValueError("empty duration")
    if re.fullmatch(r"\d+(?:\.\d+)?", v):
        return float(v) / 1000.0
    pos, total = 0, 0.0
    for m in _DURATION_RE.finditer(v):
        if m.start() != pos:
            break
        total += float(m.group(1)) * _DURATION_UNITS_S[m.group(2)]
        pos = m.end()
    if pos != len(v):
        raise ValueError(f"invalid duration '{v}'")
    return total


def _env_float_ms(env: Dict[str, str], name: str, default_s: float) -> float:
    """GUBER durations are Go duration strings in the reference
    (config.go uses time.ParseDuration); a bare number means ms."""
    v = env.get(name, "")
    if not v:
        return default_s
    try:
        return parse_duration(v)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def from_env_file(path: str) -> Dict[str, str]:
    """KEY=VALUE lines -> dict (config.go:493-521); '#' comments skipped."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                raise ValueError(f"malformed line in env file: '{line}'")
            k, _, v = line.partition("=")
            out[k.strip()] = v.strip()
    return out


def setup_daemon_config(
    config_file: str = "", env: Optional[Dict[str, str]] = None
) -> DaemonConfig:
    """Env-file -> GUBER_* env vars -> defaults (config.go:220-388)."""
    merged: Dict[str, str] = {}
    if config_file:
        merged.update(from_env_file(config_file))
    merged.update({k: v for k, v in (env or os.environ).items() if k.startswith("GUBER_")})

    conf = DaemonConfig()
    conf.listen_address = merged.get("GUBER_HTTP_ADDRESS") or conf.listen_address
    conf.grpc_listen_address = merged.get("GUBER_GRPC_ADDRESS", "")
    conf.grpc_max_conn_age_s = _env_int(merged, "GUBER_GRPC_MAX_CONN_AGE_SEC", 0)
    conf.advertise_address = merged.get(
        "GUBER_ADVERTISE_ADDRESS", merged.get("GUBER_GRPC_ADVERTISE_ADDRESS", "")
    )
    conf.cache_size = _env_int(merged, "GUBER_CACHE_SIZE", conf.cache_size)
    conf.back_cache_size = _env_int(
        merged, "GUBER_BACK_CACHE_SIZE", conf.back_cache_size
    )
    conf.global_cache_size = _env_int(
        merged, "GUBER_GLOBAL_CACHE_SIZE", conf.global_cache_size
    )
    v = merged.get("GUBER_NATIVE_HTTP", "")
    if v:
        conf.native_http = v.strip().lower() in ("1", "true", "yes", "on")
    conf.native_workers = _env_int(
        merged, "GUBER_NATIVE_WORKERS", conf.native_workers
    )
    conf.acceptors = _env_int(merged, "GUBER_ACCEPTORS", conf.acceptors)
    # Loud, not clamped: GUBER_ACCEPTORS=0 would accept-but-never-
    # serve and >64 is a misconfiguration, not a scaling plan (each
    # acceptor is a native thread).
    if not 1 <= conf.acceptors <= 64:
        raise ValueError(
            f"GUBER_ACCEPTORS must be in [1, 64], got '{conf.acceptors}'"
        )
    conf.uds_path = merged.get("GUBER_UDS_PATH", conf.uds_path)
    conf.data_center = merged.get("GUBER_DATA_CENTER", "")
    if merged.get("GUBER_WARMUP_SHAPES"):
        conf.warmup_shapes = [
            int(s) for s in merged["GUBER_WARMUP_SHAPES"].split(",") if s.strip()
        ]
    conf.debug = merged.get("GUBER_DEBUG", "").lower() in ("true", "1", "yes")
    conf.peer_discovery_type = merged.get("GUBER_PEER_DISCOVERY_TYPE", "static")
    if conf.peer_discovery_type not in ("static", "file", "etcd", "member-list", "k8s"):
        raise ValueError(
            f"GUBER_PEER_DISCOVERY_TYPE is invalid; expected 'static', 'file', "
            f"'etcd', 'member-list' or 'k8s' got '{conf.peer_discovery_type}'"
        )
    conf.peers_file = merged.get("GUBER_PEERS_FILE", "")
    conf.member_list_address = merged.get("GUBER_MEMBERLIST_ADDRESS", "")
    conf.member_list_known_nodes = [
        n.strip()
        for n in merged.get("GUBER_MEMBERLIST_KNOWN_NODES", "").split(",")
        if n.strip()
    ]
    conf.member_list_node_name = merged.get("GUBER_MEMBERLIST_NODE_NAME", "")
    etcd_endpoints = merged.get("GUBER_ETCD_ENDPOINTS", "")
    if etcd_endpoints:
        conf.etcd_endpoints = [e.strip() for e in etcd_endpoints.split(",") if e.strip()]
    conf.etcd_key_prefix = merged.get("GUBER_ETCD_KEY_PREFIX", conf.etcd_key_prefix)
    conf.etcd_advertise_address = merged.get("GUBER_ETCD_ADVERTISE_ADDRESS", "")
    conf.etcd_user = merged.get("GUBER_ETCD_USER", conf.etcd_user)
    conf.etcd_password = merged.get("GUBER_ETCD_PASSWORD", conf.etcd_password)
    conf.etcd_tls_enable = _env_bool(merged, "GUBER_ETCD_TLS_ENABLE", conf.etcd_tls_enable)
    conf.etcd_tls_cert = merged.get("GUBER_ETCD_TLS_CERT", conf.etcd_tls_cert)
    conf.etcd_tls_key = merged.get("GUBER_ETCD_TLS_KEY", conf.etcd_tls_key)
    conf.etcd_tls_ca = merged.get("GUBER_ETCD_TLS_CA", conf.etcd_tls_ca)
    conf.etcd_tls_skip_verify = _env_bool(
        merged, "GUBER_ETCD_TLS_SKIP_VERIFY", conf.etcd_tls_skip_verify
    )
    conf.k8s_namespace = merged.get("GUBER_K8S_NAMESPACE", conf.k8s_namespace)
    conf.k8s_pod_ip = merged.get("GUBER_K8S_POD_IP", "")
    conf.k8s_pod_port = merged.get("GUBER_K8S_POD_PORT", "") or conf.k8s_pod_port
    conf.k8s_selector = merged.get("GUBER_K8S_ENDPOINTS_SELECTOR", "")
    try:
        conf.k8s_mechanism = watch_mechanism_from_string(
            merged.get("GUBER_K8S_WATCH_MECHANISM", "")
        )
    except ValueError:
        raise ValueError(
            "`GUBER_K8S_WATCH_MECHANISM` needs to be either 'endpoints' or "
            "'pods' (defaults to 'endpoints')"
        ) from None
    if conf.peer_discovery_type == "k8s" and not conf.k8s_selector:
        raise ValueError(
            "when using k8s for peer discovery, you MUST provide a "
            "`GUBER_K8S_ENDPOINTS_SELECTOR` to select the gubernator peers "
            "from the endpoints listing"
        )  # config.go:356-360
    if conf.peer_discovery_type == "member-list" and not conf.member_list_known_nodes:
        raise ValueError(
            "when member-list is used for peer discovery, you MUST provide a "
            "list of known nodes via GUBER_MEMBERLIST_KNOWN_NODES"
        )  # config.go:366-370

    b = conf.behaviors
    b.batch_timeout_s = _env_float_ms(merged, "GUBER_BATCH_TIMEOUT", b.batch_timeout_s)
    b.batch_wait_s = _env_float_ms(merged, "GUBER_BATCH_WAIT", b.batch_wait_s)
    b.batch_limit = _env_int(merged, "GUBER_BATCH_LIMIT", b.batch_limit)
    if b.batch_limit > MAX_BATCH_SIZE:
        raise ValueError(f"GUBER_BATCH_LIMIT cannot exceed '{MAX_BATCH_SIZE}'")
    b.ingress_queue_lanes = _env_int(
        merged, "GUBER_INGRESS_QUEUE_LANES", b.ingress_queue_lanes
    )
    b.peer_columns = _env_bool(merged, "GUBER_PEER_COLUMNS", b.peer_columns)
    b.ingress_columns = _env_bool(
        merged, "GUBER_INGRESS_COLUMNS", b.ingress_columns
    )
    b.native_ingress = _env_bool(
        merged, "GUBER_NATIVE_INGRESS", b.native_ingress
    )
    b.global_timeout_s = _env_float_ms(merged, "GUBER_GLOBAL_TIMEOUT", b.global_timeout_s)
    b.global_sync_wait_s = _env_float_ms(
        merged, "GUBER_GLOBAL_SYNC_WAIT", b.global_sync_wait_s
    )
    b.global_batch_limit = _env_int(
        merged, "GUBER_GLOBAL_BATCH_LIMIT", b.global_batch_limit
    )
    if b.global_batch_limit > MAX_BATCH_SIZE:
        raise ValueError(f"GUBER_GLOBAL_BATCH_LIMIT cannot exceed '{MAX_BATCH_SIZE}'")
    b.global_columns = _env_bool(merged, "GUBER_GLOBAL_COLUMNS", b.global_columns)
    b.global_fanout = _env_int(merged, "GUBER_GLOBAL_FANOUT", b.global_fanout)
    if b.global_fanout < 1:
        raise ValueError("GUBER_GLOBAL_FANOUT must be >= 1")
    b.multi_region_timeout_s = _env_float_ms(
        merged, "GUBER_MULTI_REGION_TIMEOUT", b.multi_region_timeout_s
    )
    if b.multi_region_timeout_s <= 0:
        raise ValueError("GUBER_MULTI_REGION_TIMEOUT must be > 0")
    b.multi_region_sync_wait_s = _env_float_ms(
        merged, "GUBER_MULTI_REGION_SYNC_WAIT", b.multi_region_sync_wait_s
    )
    if b.multi_region_sync_wait_s <= 0:
        raise ValueError("GUBER_MULTI_REGION_SYNC_WAIT must be > 0")
    b.multi_region_batch_limit = _env_int(
        merged, "GUBER_MULTI_REGION_BATCH_LIMIT", b.multi_region_batch_limit
    )
    # The federation accumulator HONORS the limit as its queue-full
    # early flush (0 = window-only); a negative value is a config bug,
    # not a mode (and >MAX_BATCH_SIZE would make the CLASSIC fallback
    # chunks unsendable to a pre-federation peer).
    if b.multi_region_batch_limit < 0:
        raise ValueError("GUBER_MULTI_REGION_BATCH_LIMIT must be >= 0")
    if b.multi_region_batch_limit > MAX_BATCH_SIZE:
        raise ValueError(
            f"GUBER_MULTI_REGION_BATCH_LIMIT cannot exceed '{MAX_BATCH_SIZE}'"
        )
    b.region_columns = _env_bool(
        merged, "GUBER_REGION_COLUMNS", b.region_columns
    )
    b.circuit_threshold = _env_int(
        merged, "GUBER_CIRCUIT_THRESHOLD", b.circuit_threshold
    )
    if b.circuit_threshold < 1:
        raise ValueError("GUBER_CIRCUIT_THRESHOLD must be >= 1")
    b.circuit_open_interval_s = _env_float_ms(
        merged, "GUBER_CIRCUIT_OPEN_INTERVAL", b.circuit_open_interval_s
    )
    b.forward_retry_limit = _env_int(
        merged, "GUBER_FORWARD_RETRY_LIMIT", b.forward_retry_limit
    )
    b.retry_backoff_base_s = _env_float_ms(
        merged, "GUBER_RETRY_BACKOFF_BASE", b.retry_backoff_base_s
    )
    b.retry_backoff_max_s = _env_float_ms(
        merged, "GUBER_RETRY_BACKOFF_MAX", b.retry_backoff_max_s
    )
    b.global_send_retries = _env_int(
        merged, "GUBER_GLOBAL_SEND_RETRIES", b.global_send_retries
    )
    b.xla_telemetry = _env_bool(merged, "GUBER_XLA_TELEMETRY", b.xla_telemetry)
    b.xla_storm = _env_int(merged, "GUBER_XLA_STORM", b.xla_storm)
    if b.xla_storm < 1:
        raise ValueError("GUBER_XLA_STORM must be >= 1")
    b.xla_storm_window_s = _env_float_ms(
        merged, "GUBER_XLA_STORM_WINDOW", b.xla_storm_window_s
    )
    if b.xla_storm_window_s <= 0:
        raise ValueError("GUBER_XLA_STORM_WINDOW must be > 0")
    b.profile = _env_bool(merged, "GUBER_PROFILE", b.profile)
    v = merged.get("GUBER_PROFILE_HZ", "")
    if v:
        try:
            hz = float(v)
        except ValueError:
            raise ValueError(
                f"GUBER_PROFILE_HZ must be a number (Hz), got '{v}'"
            ) from None
        # Loud, not clamped: GUBER_PROFILE_HZ=5000 silently sampling at
        # the 1000 cap would hide a 5x misconfiguration; 0 meaning
        # "off" is GUBER_PROFILE=0's job, not a magic rate.
        if not 1.0 <= hz <= 1000.0:
            raise ValueError(
                f"GUBER_PROFILE_HZ must be in [1, 1000], got '{v}'"
            )
        b.profile_hz = hz
    b.tenant_topk = _env_int(merged, "GUBER_TENANT_TOPK", b.tenant_topk)
    if not 1 <= b.tenant_topk <= 1024:
        # The bound IS the point of the knob: 0 tenants tracks nothing
        # and >1024 is an unbounded-cardinality config bug.
        raise ValueError(
            f"GUBER_TENANT_TOPK must be in [1, 1024], got '{b.tenant_topk}'"
        )
    b.audit = _env_bool(merged, "GUBER_AUDIT", b.audit)
    b.audit_interval_s = _env_float_ms(
        merged, "GUBER_AUDIT_INTERVAL", b.audit_interval_s
    )
    if b.audit_interval_s <= 0:
        raise ValueError("GUBER_AUDIT_INTERVAL must be > 0")
    b.reshard = _env_bool(merged, "GUBER_RESHARD", b.reshard)
    b.reshard_handoff_s = _env_float_ms(
        merged, "GUBER_RESHARD_HANDOFF", b.reshard_handoff_s
    )
    if b.reshard_handoff_s < 0:
        raise ValueError("GUBER_RESHARD_HANDOFF must be >= 0")
    v = merged.get("GUBER_SNAPSHOT", "").strip()
    # GUBER_SNAPSHOT=0 (the chaos suite's pre-durability mode) and its
    # boolean-flavored siblings read as "disabled", not as a filename.
    conf.snapshot_path = (
        "" if v.lower() in ("", "0", "false", "off", "no") else v
    )
    b.snapshot_interval_s = _env_float_ms(
        merged, "GUBER_SNAPSHOT_INTERVAL", b.snapshot_interval_s
    )
    if b.snapshot_interval_s < 0:
        raise ValueError("GUBER_SNAPSHOT_INTERVAL must be >= 0")
    b.blackbox = _env_bool(merged, "GUBER_BLACKBOX", b.blackbox)
    b.blackbox_mb = _env_int(merged, "GUBER_BLACKBOX_MB", b.blackbox_mb)
    if not 1 <= b.blackbox_mb <= 4096:
        # Loud, not clamped: a 0 budget silently capturing nothing
        # while the tap reads enabled would surface as an empty bundle
        # at the worst possible moment (mid-incident).
        raise ValueError(
            f"GUBER_BLACKBOX_MB must be in [1, 4096], got '{b.blackbox_mb}'"
        )
    b.blackbox_retain = _env_int(
        merged, "GUBER_BLACKBOX_RETAIN", b.blackbox_retain
    )
    if not 1 <= b.blackbox_retain <= 1024:
        raise ValueError(
            f"GUBER_BLACKBOX_RETAIN must be in [1, 1024], "
            f"got '{b.blackbox_retain}'"
        )
    v = merged.get("GUBER_BLACKBOX_DIR", "").strip()
    # Same boolean-flavored opt-outs as GUBER_SNAPSHOT: "0" reads as
    # "no bundle dir", not as a directory named 0.
    conf.blackbox_dir = (
        "" if v.lower() in ("", "0", "false", "off", "no") else v
    )
    v = merged.get("GUBER_TRACE_SAMPLE", "")
    if v:
        try:
            rate = float(v)
        except ValueError:
            rate = -1.0
        if not 0.0 <= rate <= 1.0:
            # Loud, not clamped: GUBER_TRACE_SAMPLE=5 meaning "5%"
            # silently tracing EVERY request is a 20x surprise.
            raise ValueError(
                f"GUBER_TRACE_SAMPLE must be a float in [0, 1], got '{v}'"
            )
        b.trace_sample = rate
    b.express = _env_bool(merged, "GUBER_EXPRESS", b.express)
    b.express_queue_depth = _env_int(
        merged, "GUBER_EXPRESS_QUEUE_DEPTH", b.express_queue_depth
    )
    # Loud, not clamped: 0 would make the bypass unreachable while the
    # knob reads enabled (GUBER_EXPRESS=0 is the off switch), and a
    # threshold past the ingress-queue cap is a misconfiguration, not
    # a latency plan.
    if not 1 <= b.express_queue_depth <= 1_000_000:
        raise ValueError(
            f"GUBER_EXPRESS_QUEUE_DEPTH must be in [1, 1000000], "
            f"got '{b.express_queue_depth}'"
        )
    b.express_max_lanes = _env_int(
        merged, "GUBER_EXPRESS_MAX_LANES", b.express_max_lanes
    )
    if not 1 <= b.express_max_lanes <= 64:
        # The bypass exists for the small interactive shapes; a wide
        # batch amortizes its own launch through the window.
        raise ValueError(
            f"GUBER_EXPRESS_MAX_LANES must be in [1, 64], "
            f"got '{b.express_max_lanes}'"
        )
    b.express_scalar = _env_bool(
        merged, "GUBER_EXPRESS_SCALAR", b.express_scalar
    )
    v = merged.get("GUBER_LATENCY_TARGET_MS", "")
    if v:
        try:
            target = float(v)
        except ValueError:
            raise ValueError(
                f"GUBER_LATENCY_TARGET_MS must be a number (ms), got '{v}'"
            ) from None
        if target < 0:
            raise ValueError("GUBER_LATENCY_TARGET_MS must be >= 0")
        b.latency_target_ms = target
    v = merged.get("GUBER_SLO_OBJECTIVE", "")
    if v:
        try:
            obj = float(v)
        except ValueError:
            obj = -1.0
        if not 0.0 < obj < 1.0:
            # Loud, not clamped: GUBER_SLO_OBJECTIVE=99 meaning "99%"
            # would silently demand a zero error budget.
            raise ValueError(
                f"GUBER_SLO_OBJECTIVE must be a fraction in (0, 1), got '{v}'"
            )
        b.slo_objective = obj
    conf.gossip_seed = _env_int(merged, "GUBER_GOSSIP_SEED", conf.gossip_seed)

    # Static peers: GUBER_STATIC_PEERS=grpcAddr[|httpAddr],... (our
    # addition for the zero-dependency mode; the reference's equivalent
    # is the member-list seed GUBER_MEMBERLIST_KNOWN_NODES).  Entries
    # are gRPC data-plane addresses, like the reference's peer lists;
    # the optional |httpAddr names the peer's gateway for the HTTP
    # fallback transport (required by insecure_skip_verify TLS).
    static = merged.get("GUBER_STATIC_PEERS", "")
    if static:
        conf.peers = []
        for entry in static.split(","):
            entry = entry.strip()
            if not entry:
                continue
            grpc_addr, _, http_addr = entry.partition("|")
            conf.peers.append(
                PeerInfo(
                    grpc_address=grpc_addr.strip(),
                    http_address=http_addr.strip() or grpc_addr.strip(),
                )
            )

    tls_keys = (
        "GUBER_TLS_CA", "GUBER_TLS_CA_KEY", "GUBER_TLS_CERT", "GUBER_TLS_KEY",
        "GUBER_TLS_AUTO", "GUBER_TLS_CLIENT_AUTH", "GUBER_TLS_CLIENT_AUTH_CA_CERT",
        "GUBER_TLS_CLIENT_AUTH_CERT", "GUBER_TLS_CLIENT_AUTH_KEY",
        "GUBER_TLS_INSECURE_SKIP_VERIFY",
    )
    if any(merged.get(k) for k in tls_keys):
        conf.tls = TLSConfig(
            ca_file=merged.get("GUBER_TLS_CA", ""),
            ca_key_file=merged.get("GUBER_TLS_CA_KEY", ""),
            cert_file=merged.get("GUBER_TLS_CERT", ""),
            key_file=merged.get("GUBER_TLS_KEY", ""),
            auto_tls=merged.get("GUBER_TLS_AUTO", "").lower() in ("true", "1", "yes"),
            client_auth=merged.get("GUBER_TLS_CLIENT_AUTH", ""),
            client_auth_ca_file=merged.get("GUBER_TLS_CLIENT_AUTH_CA_CERT", ""),
            client_auth_cert_file=merged.get("GUBER_TLS_CLIENT_AUTH_CERT", ""),
            client_auth_key_file=merged.get("GUBER_TLS_CLIENT_AUTH_KEY", ""),
            insecure_skip_verify=merged.get(
                "GUBER_TLS_INSECURE_SKIP_VERIFY", ""
            ).lower() in ("true", "1", "yes"),
        )
    return conf
