"""Network discovery helpers (reference net.go).

`resolve_host_ip` mirrors ResolveHostIP (net.go:12-33): when a daemon
binds a wildcard address (0.0.0.0 / ::), the advertised peer address
must be a routable interface IP, or every peer would "forward" to its
own loopback and the ring would never agree on owners.
"""

from __future__ import annotations

import socket


def discover_ip() -> str:
    """Best non-loopback IPv4 of this host (net.go:58-67).

    The UDP connect never sends a packet; it only asks the kernel which
    source interface routes toward a public address.
    """
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("8.8.8.8", 80))
            ip = s.getsockname()[0]
            if not ip.startswith("127."):
                return ip
    except OSError:
        pass
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None, socket.AF_INET):
            ip = info[4][0]
            if not ip.startswith("127."):
                return ip
    except OSError:
        pass
    return "127.0.0.1"


def discover_network_addresses() -> "tuple[list[str], list[str]]":
    """Every non-loopback IPv4 interface address on this host plus the
    DNS names they reverse-resolve to (net.go:70-106) — the SAN set for
    AutoTLS self-signed certificates.  Interface enumeration uses the
    Linux SIOCGIFADDR ioctl; other platforms degrade to the
    route-probed address from discover_ip()."""
    ips = set()
    try:
        import fcntl
        import struct

        SIOCGIFADDR = 0x8915
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for _, ifname in socket.if_nameindex():
                try:
                    packed = fcntl.ioctl(
                        s.fileno(), SIOCGIFADDR,
                        struct.pack("256s", ifname[:15].encode()),
                    )
                except OSError:
                    continue  # interface without an IPv4 address
                ip = socket.inet_ntoa(packed[20:24])
                if not ip.startswith("127."):
                    ips.add(ip)
    except (ImportError, OSError):
        pass
    fallback = discover_ip()
    if fallback != "127.0.0.1":
        ips.add(fallback)
    # Reverse-DNS with a hard deadline: a broken resolver must not add
    # its full timeout+retry cycle per IP to daemon startup (this runs
    # inside AutoTLS cert generation).  Plain DAEMON threads, not a
    # ThreadPoolExecutor: concurrent.futures' atexit hook joins its
    # non-daemon workers, so one stuck gethostbyaddr would hang process
    # shutdown; daemon threads genuinely die with the process.
    names: set = set()
    if ips:
        import threading

        lock = threading.Lock()

        def rdns(ip):
            try:
                name = socket.gethostbyaddr(ip)[0]
            except OSError:
                return
            with lock:
                names.add(name)

        threads = [
            threading.Thread(target=rdns, args=(ip,), daemon=True) for ip in ips
        ]
        for t in threads:
            t.start()
        deadline = 1.5
        import time

        end = time.monotonic() + deadline
        for t in threads:
            t.join(timeout=max(end - time.monotonic(), 0))
        with lock:
            snapshot = set(names)
        return sorted(ips), sorted(snapshot)
    return sorted(ips), sorted(names)


def resolve_host_ip(addr: str) -> str:
    """Replace a wildcard host in 'host:port' with a routable IP
    (net.go:12-33)."""
    host, sep, port = addr.rpartition(":")
    if not sep:
        return addr
    if host in ("", "0.0.0.0", "::", "[::]"):
        return f"{discover_ip()}:{port}"
    return addr
