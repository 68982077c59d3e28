"""TLS subsystem (reference tls.go).

Builds server/client ssl contexts from files (tls.go:118-263) or
generates a self-signed CA + server certificate on the fly — AutoTLS
(tls.go:265-416, selfCert/selfCA) — via the openssl CLI (the stdlib has
no cert-generation API and `cryptography` is not in this image).
Supports the reference's client-auth modes: "" (off), "request"
(tls.ClientAuthType RequestClientCert) and "require-and-verify"
(RequireAndVerifyClientCert), plus insecure_skip_verify for the client
side.

The server context wraps the gateway listener; the client context is
handed to every PeerClient so peer data-plane traffic is encrypted and
(under mTLS) mutually authenticated, mirroring how the reference feeds
ClientTLS into the peer dialer (daemon.go:102-106, peer_client.go:87-132).

The port of the JAX package's tls.py, the one home of `TLSConfig`
(config.py builds it from the GUBER_TLS_* variables).  The daemon
hands the client context (and, without insecure_skip_verify, the gRPC
channel credentials) to the service, whose PeerClients dial with it.
"""

from __future__ import annotations

import os
import shutil
import ssl
import subprocess
import tempfile
from dataclasses import dataclass, field
from typing import Optional, Tuple

from .utils.net import discover_network_addresses


class TLSError(Exception):
    pass


@dataclass
class TLSConfig:
    """tls.go:30-104 equivalent (file paths; AutoTLS generates them)."""

    ca_file: str = ""
    ca_key_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    auto_tls: bool = False
    client_auth: str = ""  # "", "request", "require-and-verify"
    client_auth_ca_file: str = ""  # CA used to verify client certs
    client_auth_cert_file: str = ""  # cert this node presents as a client
    client_auth_key_file: str = ""
    insecure_skip_verify: bool = False
    # Populated by setup_tls:
    server_ctx: Optional[ssl.SSLContext] = field(default=None, repr=False)
    client_ctx: Optional[ssl.SSLContext] = field(default=None, repr=False)

    @property
    def enabled(self) -> bool:
        return bool(self.auto_tls or self.cert_file or self.ca_file)


def _openssl(*args: str) -> None:
    try:
        subprocess.run(
            [shutil.which("openssl") or "/usr/bin/openssl", *args],
            check=True, capture_output=True, timeout=60,
        )
    except FileNotFoundError as e:
        raise TLSError("AutoTLS requires the openssl binary") from e
    except subprocess.CalledProcessError as e:
        raise TLSError(
            f"openssl {' '.join(args[:2])} failed: {e.stderr.decode()[:300]}"
        ) from e


def self_ca(dir_: str) -> Tuple[str, str]:
    """Generate a self-signed CA (tls.go:364-416). Returns (crt, key)."""
    ca_key = os.path.join(dir_, "ca.key")
    ca_crt = os.path.join(dir_, "ca.crt")
    _openssl(
        "req", "-x509", "-newkey", "ec", "-pkeyopt", "ec_paramgen_curve:P-256",
        "-keyout", ca_key, "-out", ca_crt, "-days", "2", "-nodes",
        "-subj", "/O=gubernator-tpu/CN=auto-ca",
    )
    return ca_crt, ca_key


def self_cert(
    dir_: str, ca_crt: str, ca_key: str, name: str = "server",
    client: bool = False,
) -> Tuple[str, str]:
    """Generate a CA-signed cert (tls.go:265-362). SANs cover loopback,
    every non-loopback interface IP, their reverse-DNS names, and the
    hostname (net.go:70-106 discovery).  Returns (crt, key)."""
    key = os.path.join(dir_, f"{name}.key")
    csr = os.path.join(dir_, f"{name}.csr")
    crt = os.path.join(dir_, f"{name}.crt")
    ext = os.path.join(dir_, f"{name}.ext")
    sans = ["DNS:localhost", "IP:127.0.0.1", "IP:0.0.0.0"]
    ips, dns_names = discover_network_addresses()
    sans.extend(f"IP:{ip}" for ip in ips)
    sans.extend(f"DNS:{n}" for n in dns_names)
    try:
        import socket

        host = socket.gethostname()
        if f"DNS:{host}" not in sans:
            sans.append(f"DNS:{host}")
    except OSError:
        pass
    usage = "clientAuth" if client else "serverAuth,clientAuth"
    with open(ext, "w") as f:
        f.write(f"subjectAltName={','.join(sans)}\n")
        f.write(f"extendedKeyUsage={usage}\n")
    _openssl(
        "req", "-newkey", "ec", "-pkeyopt", "ec_paramgen_curve:P-256",
        "-keyout", key, "-out", csr, "-nodes",
        "-subj", f"/O=gubernator-tpu/CN={name}",
    )
    _openssl(
        "x509", "-req", "-in", csr, "-CA", ca_crt, "-CAkey", ca_key,
        "-CAcreateserial", "-out", crt, "-days", "2", "-extfile", ext,
    )
    return crt, key


def setup_tls(conf: Optional[TLSConfig]) -> Optional[TLSConfig]:
    """Assemble server_ctx/client_ctx (tls.go:118-263).  Mutates and
    returns conf; returns None when TLS is not configured."""
    if conf is None or not conf.enabled:
        return None

    if conf.auto_tls and not conf.cert_file:
        dir_ = tempfile.mkdtemp(prefix="guber-autotls-")
        if not conf.ca_file:
            conf.ca_file, conf.ca_key_file = self_ca(dir_)
        elif not conf.ca_key_file:
            raise TLSError("auto-tls with a provided CA requires ca_key_file")
        conf.cert_file, conf.key_file = self_cert(
            dir_, conf.ca_file, conf.ca_key_file
        )

    if not conf.cert_file or not conf.key_file:
        raise TLSError("TLS requires cert_file and key_file (or auto_tls)")

    server = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server.load_cert_chain(conf.cert_file, conf.key_file)
    client_ca = conf.client_auth_ca_file or conf.ca_file
    if conf.client_auth:
        if not client_ca:
            raise TLSError(
                "client auth enabled but no CA to verify client certs "
                "(ca_file or client_auth_ca_file)"
            )
        server.load_verify_locations(client_ca)
        if conf.client_auth == "require-and-verify":
            server.verify_mode = ssl.CERT_REQUIRED
        elif conf.client_auth == "request":
            server.verify_mode = ssl.CERT_OPTIONAL
        else:
            raise TLSError(
                f"invalid client_auth '{conf.client_auth}'; expected "
                "'request' or 'require-and-verify'"
            )

    client = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if conf.insecure_skip_verify:
        client.check_hostname = False
        client.verify_mode = ssl.CERT_NONE
    elif conf.ca_file:
        client.load_verify_locations(conf.ca_file)
    else:
        client.load_default_certs()
    # Under mTLS this node's peer-client must present a cert; AutoTLS
    # server certs carry clientAuth usage so the server pair is reused
    # (tls.go:188-207 equivalent).
    if conf.client_auth_cert_file:
        client.load_cert_chain(conf.client_auth_cert_file, conf.client_auth_key_file)
    elif conf.client_auth and conf.cert_file:
        client.load_cert_chain(conf.cert_file, conf.key_file)

    conf.server_ctx = server
    conf.client_ctx = client
    return conf


def client_context(
    ca_file: str = "",
    cert_file: str = "",
    key_file: str = "",
    insecure_skip_verify: bool = False,
) -> ssl.SSLContext:
    """Standalone client-side context builder (for V1Client users)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if insecure_skip_verify:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    elif ca_file:
        ctx.load_verify_locations(ca_file)
    else:
        ctx.load_default_certs()
    if cert_file:
        ctx.load_cert_chain(cert_file, key_file)
    return ctx
