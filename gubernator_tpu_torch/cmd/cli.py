"""Load-generation CLI (reference cmd/gubernator-cli/main.go:48-108):
generate random token-bucket limits and hammer an endpoint, printing
OVER_LIMIT responses.

    python -m gubernator_tpu_torch.cmd.cli [ENDPOINT] [--limits N]
        [--concurrency N] [--columns]

It needs no device: it only speaks HTTP to a daemon.
"""

from __future__ import annotations

import argparse
import random
import threading
from concurrent.futures import ThreadPoolExecutor


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="gubernator-tpu-torch load generator")
    parser.add_argument("endpoint", nargs="?", default="127.0.0.1:1050")
    parser.add_argument("--limits", type=int, default=2000)
    parser.add_argument("--concurrency", type=int, default=10)
    parser.add_argument(
        "--columns", action="store_true",
        help="drive the columnar front door (ColumnsV1Client: checks "
        "coalesce into GUBC frames; falls back to classic JSON against "
        "an old daemon)",
    )
    args = parser.parse_args(argv)

    from ..client import ColumnsV1Client, V1Client, random_string
    from ..types import SECOND, Algorithm, GetRateLimitsRequest, RateLimitRequest, Status

    if args.columns:
        client = ColumnsV1Client(args.endpoint, timeout_s=0.5)
    else:
        client = V1Client(args.endpoint, timeout_s=0.5)
    rng = random.Random()
    limits = [
        RateLimitRequest(
            name=f"ID-{i:04d}",
            unique_key=random_string("id-", 10),
            hits=1,
            limit=rng.randint(1, 10),
            duration=rng.randint(1, 10) * SECOND,
            algorithm=Algorithm.TOKEN_BUCKET,
        )
        for i in range(args.limits)
    ]

    over = 0
    over_lock = threading.Lock()

    def send(req):
        nonlocal over
        resp = client.get_rate_limits(GetRateLimitsRequest(requests=[req]))
        rl = resp.responses[0]
        if rl.status == Status.OVER_LIMIT:
            with over_lock:
                over += 1
            print(f"OVER_LIMIT {req.name} {req.unique_key} remaining={rl.remaining}")

    with ThreadPoolExecutor(max_workers=args.concurrency) as pool:
        list(pool.map(send, limits))
    client.close()
    print(f"done: {args.limits} requests, {over} over limit")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
