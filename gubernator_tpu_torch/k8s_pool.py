"""Kubernetes discovery pool — Endpoints/Pods list+watch membership.

The port of the JAX package's k8s_pool.py (host code, no device, the
stdlib only).

Reference behavior (kubernetes.go): a SharedIndexInformer watches either
the Endpoints of a Service or Pods by label selector
(kubernetes.go:44-62, 155-181); every add/update/delete rebuilds the
peer list from the informer store — endpoint subset addresses or
running-and-ready pod IPs, each as `ip:pod_port`, with IsOwner matched
by PodIP (kubernetes.go:183-237).

The reference depends on client-go; this build implements the informer
pattern directly over the Kubernetes HTTP API with the stdlib: an
initial LIST captures state + resourceVersion, a chunked WATCH stream
applies JSON events from that version, and any stream failure (timeout,
410 Gone) falls back to relist-then-rewatch — the same list/watch
contract client-go's Reflector implements.  In-cluster credentials come
from the standard service-account mount, like client-go's
rest.InClusterConfig (kubernetesconfig.go:1-11).
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import socket
import ssl
import threading
import urllib.parse
from typing import Callable, Dict, List, Optional, Tuple

from .types import PeerInfo

log = logging.getLogger("gubernator.k8s")

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
BACKOFF_S = 5.0

WATCH_ENDPOINTS = "endpoints"
WATCH_PODS = "pods"


def watch_mechanism_from_string(mechanism: str) -> str:
    """kubernetes.go:51-62: empty defaults to endpoints."""
    if mechanism in ("", WATCH_ENDPOINTS):
        return WATCH_ENDPOINTS
    if mechanism == WATCH_PODS:
        return WATCH_PODS
    raise ValueError(f"unknown watch mechanism specified: {mechanism}")


class K8sApiClient:
    """Minimal Kubernetes API client (list + watch) over stdlib HTTP.

    Defaults to in-cluster config: KUBERNETES_SERVICE_HOST/PORT env plus
    the service-account token and CA from the standard mount.  Tests
    and out-of-cluster use pass `api_url` (http:// or https://) and an
    optional token/ca_file directly.
    """

    def __init__(
        self,
        api_url: str = "",
        token: str = "",
        ca_file: str = "",
        client_cert_file: str = "",
        client_key_file: str = "",
        skip_tls_verify: bool = False,
    ):
        if not api_url:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError(
                    "not running in-cluster (no KUBERNETES_SERVICE_HOST) and "
                    "no api_url was provided"
                )
            api_url = f"https://{host}:{port}"
        self.api_url = api_url.rstrip("/")
        if not token:
            token_path = os.path.join(SERVICE_ACCOUNT_DIR, "token")
            if os.path.exists(token_path):
                with open(token_path) as f:
                    token = f.read().strip()
        self.token = token
        if not ca_file:
            default_ca = os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt")
            if os.path.exists(default_ca):
                ca_file = default_ca
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if self.api_url.startswith("https://"):
            self._ssl_ctx = ssl.create_default_context(
                cafile=ca_file or None
            )
            if client_cert_file:
                self._ssl_ctx.load_cert_chain(
                    client_cert_file, client_key_file or None
                )
            if skip_tls_verify:
                self._ssl_ctx.check_hostname = False
                self._ssl_ctx.verify_mode = ssl.CERT_NONE

    @classmethod
    def auto(cls) -> "K8sApiClient":
        """In-cluster config when the service-account env is present,
        otherwise the local kubeconfig — the reference's build-tag pair
        (kubernetesconfig.go:1-11 in-cluster /
        kubernetesconfig_local.go:1-38 ~/.kube/config)."""
        if os.environ.get("KUBERNETES_SERVICE_HOST"):
            return cls()
        try:
            return cls.from_kubeconfig()
        except FileNotFoundError as e:
            raise RuntimeError(
                "not running in-cluster (no KUBERNETES_SERVICE_HOST) and no "
                f"kubeconfig found ({e.filename}); set KUBECONFIG or mount "
                "the service account"
            ) from e

    @classmethod
    def from_kubeconfig(cls, path: str = "", context: str = "") -> "K8sApiClient":
        """Out-of-cluster client from a kubeconfig file
        (kubernetesconfig_local.go:1-38 equivalent: clientcmd loading
        rules — $KUBECONFIG, then ~/.kube/config).  Supports server +
        CA (file or inline base64 data), bearer token, and client
        cert/key auth; `context` overrides current-context."""
        import base64
        import tempfile

        try:
            import yaml
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "kubeconfig support requires PyYAML "
                "(pip install 'gubernator-tpu[k8s]')"
            ) from e

        path = (
            path
            or os.environ.get("KUBECONFIG", "")
            or os.path.expanduser("~/.kube/config")
        )
        with open(path) as f:
            cfg = yaml.safe_load(f) or {}
        base_dir = os.path.dirname(os.path.abspath(path))

        def by_name(section, name):
            for entry in cfg.get(section, []) or []:
                if entry.get("name") == name:
                    return entry.get(section.rstrip("s"), {})
            raise ValueError(f"kubeconfig: no {section} entry named {name!r}")

        ctx_name = context or cfg.get("current-context", "")
        if not ctx_name:
            raise ValueError("kubeconfig: no current-context set")
        ctx = by_name("contexts", ctx_name)
        cluster = by_name("clusters", ctx.get("cluster", ""))
        user = by_name("users", ctx.get("user", ""))
        for unsupported in ("exec", "auth-provider"):
            if user.get(unsupported):
                # Silently ignoring these would yield an unauthenticated
                # client that 401s at runtime with no hint why.
                raise ValueError(
                    f"kubeconfig: user {ctx.get('user')!r} uses "
                    f"'{unsupported}' auth, which this client does not "
                    "support; use a token or client certificate"
                )

        def materialize(file_key: str, data_key: str, source: dict) -> str:
            """Inline base64 *-data wins over the file path variant.
            Materialized files (which may hold a client PRIVATE KEY)
            are 0600 and removed at interpreter exit.  Relative file
            paths resolve against the kubeconfig's own directory
            (clientcmd semantics)."""
            data = source.get(data_key, "")
            if data:
                import atexit

                tmp = tempfile.NamedTemporaryFile(
                    prefix="guber-kubeconfig-", delete=False
                )
                tmp.write(base64.b64decode(data))
                tmp.close()
                atexit.register(
                    lambda p=tmp.name: os.path.exists(p) and os.remove(p)
                )
                return tmp.name
            file_path = source.get(file_key, "")
            if file_path and not os.path.isabs(file_path):
                file_path = os.path.join(base_dir, file_path)
            return file_path

        return cls(
            api_url=cluster.get("server", ""),
            token=user.get("token", ""),
            ca_file=materialize(
                "certificate-authority", "certificate-authority-data", cluster
            ),
            client_cert_file=materialize(
                "client-certificate", "client-certificate-data", user
            ),
            client_key_file=materialize("client-key", "client-key-data", user),
            skip_tls_verify=bool(cluster.get("insecure-skip-tls-verify")),
        )

    def _connect(self, timeout: Optional[float]):
        scheme, _, rest = self.api_url.partition("://")
        hostname, _, port = rest.partition(":")
        if scheme == "https":
            return http.client.HTTPSConnection(
                hostname, int(port or 443), timeout=timeout, context=self._ssl_ctx
            )
        return http.client.HTTPConnection(hostname, int(port or 80), timeout=timeout)

    def _request(self, conn, path: str, params: Dict[str, str]):
        if params:
            path += "?" + urllib.parse.urlencode(params)
        headers = {}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        conn.request("GET", path, headers=headers)
        resp = conn.getresponse()
        if resp.status != 200:
            body = resp.read(200)
            raise OSError(f"k8s API returned HTTP {resp.status}: {body!r}")
        return resp

    # LIST page size: apiservers cap very large lists and the reflector
    # contract is chunked reads (metadata.continue tokens); 500 matches
    # client-go's default reflector page size.
    LIST_LIMIT = 500

    def list(
        self, namespace: str, resource: str, selector: str = ""
    ) -> Tuple[List[dict], str]:
        """Chunked LIST of a namespaced resource (limit= + continue=
        pagination, the client-go reflector contract); returns
        (all items, resourceVersion of the FINAL chunk — the version
        the subsequent watch must start from)."""
        items: List[dict] = []
        cont = ""
        conn = self._connect(timeout=10.0)  # one connection for all chunks
        try:
            while True:
                params = {"limit": str(self.LIST_LIMIT)}
                if selector:
                    params["labelSelector"] = selector
                if cont:
                    params["continue"] = cont
                body = json.load(
                    self._request(
                        conn, f"/api/v1/namespaces/{namespace}/{resource}", params
                    )
                )
                items.extend(body.get("items", []))
                meta = body.get("metadata", {})
                cont = meta.get("continue", "")
                if not cont:
                    return items, meta.get("resourceVersion", "")
        finally:
            conn.close()

    def watch(
        self,
        namespace: str,
        resource: str,
        resource_version: str,
        selector: str = "",
        stop: Optional[threading.Event] = None,
    ):
        """WATCH stream from resource_version: yields (type, object)
        dicts until the server closes the stream, an error arrives, or
        `stop` is set.  The connection is parked on the instance so
        close_watch() can unblock the reader from another thread via a
        socket shutdown — HTTPResponse.close() would deadlock on the
        buffer lock the blocked readline holds."""
        params = {"watch": "true", "resourceVersion": resource_version}
        if selector:
            params["labelSelector"] = selector
        conn = self._connect(timeout=None)
        self._watch_conn = conn
        try:
            resp = self._request(
                conn, f"/api/v1/namespaces/{namespace}/{resource}", params
            )
            for line in resp:
                if stop is not None and stop.is_set():
                    return
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                yield event.get("type", ""), event.get("object", {})
        finally:
            self._watch_conn = None
            try:
                if conn.sock is not None:
                    conn.sock.close()
            except OSError:
                pass

    def close_watch(self) -> None:
        """Unblock a watch() reader stuck in readline: TCP-shutdown the
        socket so the read returns EOF; the watch thread then tears the
        connection down itself."""
        conn = getattr(self, "_watch_conn", None)
        if conn is not None and conn.sock is not None:
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class K8sPool:
    """Peer discovery over the Kubernetes API (reference K8sPool,
    kubernetes.go:35-241)."""

    def __init__(
        self,
        on_update: Callable[[List[PeerInfo]], None],
        namespace: str = "default",
        selector: str = "",
        pod_ip: str = "",
        pod_port: str = "81",
        mechanism: str = WATCH_ENDPOINTS,
        api_client: Optional[K8sApiClient] = None,
        backoff_s: float = BACKOFF_S,
    ):
        self.on_update = on_update
        self.namespace = namespace
        self.selector = selector
        self.pod_ip = pod_ip
        self.pod_port = pod_port
        self.mechanism = watch_mechanism_from_string(mechanism)
        self.backoff_s = backoff_s
        # In-cluster service account or local kubeconfig, like the
        # reference's build-tag pair (kubernetesconfig*.go).
        self.client = api_client or K8sApiClient.auto()
        self._store: Dict[str, dict] = {}  # namespace/name -> object
        self._stop = threading.Event()
        # The informer loop: list -> watch -> (on failure) relist.
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    @staticmethod
    def _key(obj: dict) -> str:
        meta = obj.get("metadata", {})
        return f"{meta.get('namespace', '')}/{meta.get('name', '')}"

    def _run(self) -> None:
        resource = self.mechanism  # "endpoints" | "pods"
        while not self._stop.is_set():
            try:
                items, rv = self.client.list(self.namespace, resource, self.selector)
                self._store = {self._key(o): o for o in items}
                self._update_peers()
                for etype, obj in self.client.watch(
                    self.namespace, resource, rv, self.selector, self._stop
                ):
                    if self._stop.is_set():
                        return
                    if etype == "ERROR":
                        break  # e.g. 410 Gone: relist from scratch
                    if etype == "DELETED":
                        self._store.pop(self._key(obj), None)
                    elif etype in ("ADDED", "MODIFIED"):
                        self._store[self._key(obj)] = obj
                    else:
                        continue  # BOOKMARK etc.
                    self._update_peers()
            except (OSError, ValueError, http.client.HTTPException) as e:
                # HTTPException covers mid-stream truncation
                # (IncompleteRead etc.), which is neither an OSError nor
                # a ValueError — the informer must relist, not die.
                if not self._stop.is_set():
                    log.warning("k8s watch failed, will relist: %s", e)
            if self._stop.is_set():
                return
            self._stop.wait(self.backoff_s)

    # ------------------------------------------------------------------
    def _update_peers(self) -> None:
        if self.mechanism == WATCH_PODS:
            peers = self._peers_from_pods()
        else:
            peers = self._peers_from_endpoints()
        try:
            self.on_update(peers)
        except Exception:  # noqa: BLE001
            log.exception("on_update callback failed")

    def _peers_from_pods(self) -> List[PeerInfo]:
        """kubernetes.go:187-210: skip pods with any container not ready
        or not running; IsOwner by PodIP match."""
        peers = []
        for obj in self._store.values():
            status = obj.get("status", {})
            ip = status.get("podIP", "")
            if not ip:
                continue
            statuses = status.get("containerStatuses", [])
            if any(
                not cs.get("ready") or "running" not in cs.get("state", {})
                for cs in statuses
            ):
                continue
            peers.append(
                PeerInfo(
                    grpc_address=f"{ip}:{self.pod_port}",
                    is_owner=(ip == self.pod_ip),
                )
            )
        return sorted(peers, key=lambda p: p.grpc_address)

    def _peers_from_endpoints(self) -> List[PeerInfo]:
        """kubernetes.go:212-237: every ready subset address."""
        peers = []
        for obj in self._store.values():
            for subset in obj.get("subsets", []) or []:
                for addr in subset.get("addresses", []) or []:
                    ip = addr.get("ip", "")
                    if not ip:
                        continue
                    peers.append(
                        PeerInfo(
                            grpc_address=f"{ip}:{self.pod_port}",
                            is_owner=(ip == self.pod_ip),
                        )
                    )
        return sorted(peers, key=lambda p: p.grpc_address)

    # ------------------------------------------------------------------
    def close(self) -> None:
        self._stop.set()
        self.client.close_watch()
        self._thread.join(timeout=2.0)
