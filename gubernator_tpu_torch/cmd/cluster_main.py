"""Local cluster binary (reference cmd/gubernator-cluster/main.go:30-56):
start an in-process loopback cluster for client-library testing; prints
"Ready" once all daemons accept connections.

Every daemon's store runs on the current CUDA device unless
GUBER_TORCH_DEVICE names another ("cpu" runs the plain versions); with
neither a card nor that setting it exits 1 with "no CUDA device", as
the server does."""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="gubernator-tpu-torch local cluster")
    parser.add_argument("--nodes", type=int, default=6)
    args = parser.parse_args(argv)

    from types import SimpleNamespace

    from . import DEVICE_ENV, select_device

    try:
        device = select_device(
            SimpleNamespace(device=os.environ.get(DEVICE_ENV, "").strip() or None))
    except RuntimeError as e:
        print(f"gubernator-tpu-torch-cluster: {e}", file=sys.stderr)
        return 1

    from ..cluster import Cluster

    cl = Cluster().start(args.nodes, device=device)
    for p in cl.peers:
        print(f"peer: http://{p.http_address} grpc://{p.grpc_address}")
    print("Ready")
    sys.stdout.flush()

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    cl.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
