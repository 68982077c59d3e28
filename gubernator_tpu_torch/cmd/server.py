"""Server binary (reference cmd/gubernator/main.go): flags -> daemon.

    python -m gubernator_tpu_torch.cmd.server -config FILE [-debug]
        [-frozen-clock-ms MS]

FILE holds GUBER_* lines (`config.setup_daemon_config`); the store runs
on the current CUDA device unless the config sets
GUBER_TORCH_DEVICE=cpu.  Discovery follows GUBER_PEER_DISCOVERY_TYPE
(static, file, member-list with GUBER_MEMBERLIST_*, etcd with
GUBER_ETCD_*, k8s with GUBER_K8S_*); GUBER_DATA_CENTER names the node's
region, and GUBER_MULTI_REGION_* and GUBER_REGION_COLUMNS set the
federation plane.  SIGINT or SIGTERM closes the daemon (a gossip node
leaves first), which writes its snapshot when GUBER_SNAPSHOT names one.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="gubernator-tpu-torch rate-limit daemon")
    parser.add_argument("-config", dest="config", default="", help="env config file")
    parser.add_argument("-debug", dest="debug", action="store_true", help="debug logging")
    parser.add_argument(
        "-version", "--version", dest="version", action="store_true",
        help="print version and exit",
    )
    # The Daemon(conf, clock=) seam from the command line: a daemon whose
    # clock stands still answers as a replay of the same requests does.
    parser.add_argument(
        "-frozen-clock-ms", dest="frozen_clock_ms", type=int, default=None,
        help="freeze the daemon's clock at this unix-ms instant (replay "
        "checks against another daemon; not for serving)",
    )
    args = parser.parse_args(argv)

    if args.version:
        from .. import __version__

        print(f"gubernator-tpu-torch {__version__}")
        return 0

    from ..config import setup_daemon_config
    from ..daemon import spawn_daemon
    from ..utils.logging import setup_logging
    from . import select_device

    conf = setup_daemon_config(config_file=args.config)
    if args.debug:
        conf.debug = True
    setup_logging(debug=conf.debug)
    device = select_device(conf)
    # Handlers before the (long) startup: a signal during the warmup
    # closes the daemon once it is up instead of killing the process
    # with its listeners half bound.
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    clock = None
    if args.frozen_clock_ms is not None:
        from ..utils.clock import Clock

        clock = Clock()
        clock.freeze(args.frozen_clock_ms)
    daemon = spawn_daemon(conf, clock=clock)
    addr = daemon.gateway.address
    print(f"gubernator-tpu-torch listening on http://{addr} "
          f"(advertise {daemon.peer_info.grpc_address}, grpc {daemon.grpc.address}, "
          f"device {device})")
    sys.stdout.flush()
    stop.wait()
    daemon.close()
    # The launches since the last POST /debug/launches, the shutdown
    # snapshot's gather included: the close's kernels have no route left.
    from ..ops import _kernels

    print(f"gubernator-tpu-torch stopped (snapshot save "
          f"{daemon.service.snapshots.last_save_seconds:.6f} s, "
          f"kernel launches {json.dumps(_kernels.LAUNCHES)})")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
