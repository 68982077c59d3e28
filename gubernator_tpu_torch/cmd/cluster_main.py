"""Local cluster binary (reference cmd/gubernator-cluster/main.go:30-56).

It starts an in-process loopback cluster of several daemons, which
needs the multi-node harness `cluster.py` and the peer clients of slice
A2; until then it says so and exits 2.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="gubernator-tpu-torch local cluster")
    parser.add_argument("--nodes", type=int, default=6)
    parser.parse_args(argv)
    print("gubernator-tpu-torch-cluster needs cluster.py and the peer "
          "clients (slice A2), not ported yet", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
