"""Long soak of the async native edge, on the port: 2 daemons,
mixed request shapes (single-key batched/NO_BATCHING, 50/200-lane,
GLOBAL, MULTI_REGION), raw half-close clients, one daemon RESTART
mid-soak.  Steady-state phases must be error-free; only the churn
window tolerates transient failures (fast connect-refused retries
while the restarted daemon is down).

The PyTorch port's twin of scripts/long_soak.py: the same soak, output
and exit code over gubernator_tpu_torch (no JAX).  The daemons' stores
run on the current CUDA device, or on the plain versions with
GUBER_TORCH_DEVICE=cpu.  Run from the repo root:

    python -u scripts/torch_long_soak.py

The peer deadline stays the JAX twin's 60 s (GUBER_BATCH_TIMEOUT), so
the two soaks run the same configuration."""
import json
import os
import socket
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gubernator_tpu_torch.client import V1Client
from gubernator_tpu_torch.cluster import Cluster, fast_test_behaviors
from gubernator_tpu_torch.gateway import NativeGatewayServer
from gubernator_tpu_torch.types import (
    Algorithm, Behavior, GetRateLimitsRequest, RateLimitRequest,
)

SOAK_S = 600
CHURN_AT_S = 240
CHURN_WINDOW_S = 90  # restart + re-peer + client reconnect grace
SHAPES = [
    (1, 0), (1, int(Behavior.NO_BATCHING)), (50, 0),
    (200, 0), (4, int(Behavior.GLOBAL)), (8, int(Behavior.MULTI_REGION)),
]


def main() -> int:
    # The JAX twin's peer deadline (GUBER_BATCH_TIMEOUT = 60 s).
    beh = fast_test_behaviors()
    beh.batch_timeout_s = 60.0
    cl = Cluster().start_with(["", ""], native_http=True, behaviors=beh,
                              device=os.environ.get("GUBER_TORCH_DEVICE") or None)
    assert all(isinstance(d.gateway, NativeGatewayServer) for d in cl.daemons)
    print(f"cluster up: {[d.gateway.address for d in cl.daemons]}", flush=True)

    stop = threading.Event()
    lock = threading.Lock()
    stats = {"requests": 0, "lanes": 0, "steady_errors": [], "churn_errors": 0}
    churn = {"active": False}

    def worker(wid):
        i = 0
        client = None
        while not stop.is_set():
            if client is None:
                client = V1Client(cl.daemons[wid % 2].gateway.address, timeout_s=120.0)
            lanes, beh = SHAPES[(wid + i) % len(SHAPES)]
            reqs = [
                RateLimitRequest(
                    name="lsoak", unique_key=f"w{wid % 3}k{(i + j) % 40}", hits=1,
                    limit=100_000_000, duration=120_000,
                    algorithm=Algorithm.TOKEN_BUCKET if j % 2 == 0 else Algorithm.LEAKY_BUCKET,
                    behavior=beh,
                )
                for j in range(lanes)
            ]
            try:
                resp = client.get_rate_limits(GetRateLimitsRequest(requests=reqs))
                errs = [r.error for r in resp.responses if r.error]
                with lock:
                    stats["requests"] += 1
                    stats["lanes"] += lanes
                    if errs:
                        if churn["active"]:
                            stats["churn_errors"] += len(errs)
                        else:
                            stats["steady_errors"].extend(errs[:2])
            except Exception as e:  # noqa: BLE001
                client = None  # reconnect (the daemon may have restarted)
                with lock:
                    stats["requests"] += 1
                    if churn["active"]:
                        stats["churn_errors"] += lanes
                    else:
                        stats["steady_errors"].append(f"{type(e).__name__}: {e}")
            i += 1

    def half_close_client():
        """Periodically exercise the EOF framing path against daemon 0."""
        while not stop.is_set():
            time.sleep(7)
            try:
                host, _, port = cl.daemons[0].gateway.address.partition(":")
                body = json.dumps({"requests": [{
                    "name": "lsoak", "uniqueKey": "hc", "hits": "1",
                    "limit": "1000000", "duration": "60000",
                    "algorithm": "TOKEN_BUCKET"}]}).encode()
                with socket.create_connection((host, int(port)), timeout=120) as s:
                    s.sendall(b"POST /v1/GetRateLimits HTTP/1.1\r\nHost: x\r\n"
                              b"Content-Length: %d\r\n\r\n" % len(body) + body)
                    s.shutdown(socket.SHUT_WR)
                    data = s.recv(65536)
                    assert data.startswith(b"HTTP/1.1 200"), data[:80]
            except AssertionError:
                with lock:
                    if not churn["active"]:
                        stats["steady_errors"].append("half-close got non-200")
            except Exception:  # noqa: BLE001 — churn-window connect refusals
                pass

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(12)]
    threads.append(threading.Thread(target=half_close_client))
    for t in threads:
        t.start()

    t0 = time.time()
    restarted = False
    while time.time() - t0 < SOAK_S:
        time.sleep(5)
        el = time.time() - t0
        if not restarted and el >= CHURN_AT_S:
            print(f"[{el:.0f}s] RESTARTING daemon 1 mid-traffic", flush=True)
            churn["active"] = True
            cl.restart(1)
            restarted = True
            churn_end = time.time() + CHURN_WINDOW_S
        if restarted and churn["active"] and time.time() > churn_end:
            churn["active"] = False
            print(f"[{el:.0f}s] churn window closed; back to steady-state strictness", flush=True)
        with lock:
            print(f"[{el:.0f}s] reqs={stats['requests']} lanes={stats['lanes']} "
                  f"steady_errs={len(stats['steady_errors'])} churn_errs={stats['churn_errors']}",
                  flush=True)
        if stats["steady_errors"]:
            print("EARLY ERRORS:", stats["steady_errors"][:6], flush=True)
            break

    stop.set()
    for t in threads:
        t.join(timeout=180)
    alive = [t.name for t in threads if t.is_alive()]
    cl.stop()

    print(f"final: {stats['requests']} requests / {stats['lanes']} lanes; "
          f"steady errors: {len(stats['steady_errors'])}; "
          f"churn-window errors: {stats['churn_errors']}; stuck threads: {alive}")
    assert not alive, f"threads deadlocked: {alive}"
    assert stats["requests"] > 200, "soak made no progress"
    assert not stats["steady_errors"], stats["steady_errors"][:5]
    print("LONG SOAK PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
