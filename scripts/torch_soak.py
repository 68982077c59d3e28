#!/usr/bin/env python
"""Multi-daemon soak harness, on the port: gated by the conservation
audit.

The PyTorch port's twin of scripts/soak.py: the same flags, output and
exit codes over gubernator_tpu_torch (no JAX), plus `--device` (default
`cuda`: every daemon's store runs the CUDA kernels on the card; `cpu`
runs their plain versions).  The daemons of one run share the card.

Stands up an in-process cluster of N daemons (default 4) on loopback
ports — real gateways, real peer wire, real device dispatch — and
drives it for minutes with:

* **Zipf traffic** — key popularity drawn from a seeded Zipf
  distribution (the viral-key shape), mixed token/leaky algorithms,
  a slice of GLOBAL-behavior lanes, through rotating entry daemons so
  every request shape crosses the peer hop.  Lanes spread over a small
  TENANT pool (the rate-limit name is the tenant unit), with one
  PLANTED HOT TENANT soaking the burst traffic — the cost
  observatory's per-tenant ledger (profiling.py, GET /debug/tenants)
  must rank it #1 on its owner daemon and must conserve
  (top-K + other == totals) on every poll, and at final quiesce the
  summed tenant ledgers must reconcile EXACTLY against the audit
  ledger's ingress counters (ingress_hits + peer_ingress_hits).
* **Burst replay** — periodic bursts replaying one hot key at
  many-lane batches (the retry-storm shape), under the hot tenant's
  name on one fixed key so the tenant has a single owner daemon.
* **FaultPlan partitions** — a seeded fault plan periodically
  partitions one daemon's data plane (ERROR rules) and heals it, so
  breakers trip, degraded evaluation engages, and the GLOBAL plane
  requeues — all paths the conservation ledger must reconcile through.
* **Membership churn** — periodically drops one daemon from everyone's
  peer list and re-adds it, driving ring deltas, the double-dispatch
  window, and reshard transfers.
* **Multi-region federation** (`--regions RxD`, e.g. `2x2`) — the
  daemons split into R regions of D (distinct GUBER_DATA_CENTER
  labels), a slice of lanes turns MULTI_REGION so the federation plane
  replicates cross-region, the inter-region wire runs under an
  always-on seeded WAN shape (FaultPlan `wan`: normal-ish latency +
  jitter + rate loss), fault events become WAN storms against one
  region's daemons (heavy loss — an effective partition — injected
  then healed), and churn rotates WITHIN a region so each region
  reshards independently.  The exit gate additionally requires the
  region ledger to have moved (the plane demonstrably ran).

Trace-sampled (GUBER_TRACE_SAMPLE default 0.02) so
scripts/trace_collect.py can stitch cross-daemon traces from the run.

PASS/FAIL gate, checked every poll and at exit (exit code 1 on any):

* any `gubernator_audit_violations_total` increment on any daemon
  (the audit IS the soak's oracle: no double-commits, no lost hits,
  carry within the documented slack, no negative remaining);
* a daemon that stops answering /debug/status outside a deliberate
  partition window;
* zero traffic progress.

`--smoke` runs the 60-second 2-daemon variant (the slow-marked
tests/test_torch_replay.py soak twin asserts the status invariants
in-suite).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _fetch(addr: str, path: str, timeout_s: float = 10.0) -> dict:
    with urllib.request.urlopen(
        f"http://{addr}{path}", timeout=timeout_s
    ) as r:
        return json.loads(r.read())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=3.0)
    ap.add_argument("--daemons", type=int, default=4)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--keys", type=int, default=2000)
    ap.add_argument("--zipf-a", type=float, default=1.2,
                    help="Zipf exponent (>1; larger = hotter head)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--trace-sample", type=float, default=0.02)
    ap.add_argument("--poll-every", type=float, default=3.0)
    ap.add_argument("--fault-every", type=float, default=20.0,
                    help="seconds between partition injections (0=off)")
    ap.add_argument("--fault-for", type=float, default=4.0,
                    help="partition duration seconds")
    ap.add_argument("--churn-every", type=float, default=45.0,
                    help="seconds between membership churn events (0=off)")
    ap.add_argument("--regions", default="",
                    help="RxD federation topology (e.g. 2x2 = two "
                         "2-daemon regions); overrides --daemons")
    ap.add_argument("--smoke", action="store_true",
                    help="60s, 2 daemons, no churn (CI-speed)")
    ap.add_argument("--device", default="cuda",
                    help="every daemon's store device: cuda (default) or cpu")
    args = ap.parse_args()
    if args.smoke:
        args.minutes = 1.0
        args.daemons = 2
        args.churn_every = 0.0
    n_regions, per_region = 0, 0
    if args.regions:
        try:
            r, d = args.regions.lower().split("x")
            n_regions, per_region = int(r), int(d)
        except ValueError:
            ap.error(f"--regions must look like 2x2, got {args.regions!r}")
        if n_regions < 2 or per_region < 1:
            ap.error("--regions needs >= 2 regions of >= 1 daemon")
        args.daemons = n_regions * per_region

    import numpy as np

    from gubernator_tpu_torch import faults
    from gubernator_tpu_torch.client import V1Client
    from gubernator_tpu_torch.cluster import Cluster, fast_test_behaviors
    from gubernator_tpu_torch.types import (
        Algorithm,
        Behavior,
        GetRateLimitsRequest,
        RateLimitRequest,
    )

    rng = np.random.RandomState(args.seed)
    beh = fast_test_behaviors()
    beh.batch_timeout_s = 30.0
    beh.trace_sample = args.trace_sample
    beh.latency_target_ms = 30_000.0
    beh.audit = True
    beh.audit_interval_s = 2.0
    # Churn opens the double-dispatch window for real (the test default
    # turns it off because every fixture startup is a membership change).
    beh.reshard_handoff_s = 1.0 if args.churn_every else 0.0

    plan = faults.FaultPlan(seed=args.seed)
    faults.install(plan)

    deadline = time.time() + args.minutes * 60.0
    # Region labels per daemon: "" (single-region, the pre-federation
    # shape) unless --regions asked for an RxD split.
    dcs = (
        [f"region-{chr(97 + r)}"
         for r in range(n_regions) for _ in range(per_region)]
        if n_regions else [""] * args.daemons
    )
    print(
        f"soak: {args.daemons} daemons"
        + (f" in {n_regions} regions of {per_region}" if n_regions else "")
        + f", {args.minutes:.1f} min, "
        f"zipf a={args.zipf_a} over {args.keys} keys, seed {args.seed}, "
        f"trace sample {args.trace_sample}"
    )
    cl = Cluster().start_with(dcs, behaviors=beh, device=args.device)
    addrs = [d.gateway.address for d in cl.daemons]
    print(f"soak: gateways {addrs}")
    if n_regions:
        # Always-on WAN shape on the inter-region wire (the region op
        # only matches cross-region sends, so local rings stay LAN).
        plan.wan(op="UpdateRegionColumns",
                 latency_s=0.02, jitter_s=0.005, loss=0.02)
        print("soak: WAN shape on region wire "
              "(20ms ± 5ms, 2% loss, seeded)")

    stop = threading.Event()
    lock = threading.Lock()
    stats = {"requests": 0, "lanes": 0, "errors": []}
    # Zipf ranks -> key ids (bounded; np.random.zipf is unbounded)
    zipf_pool = (rng.zipf(args.zipf_a, size=200_000) - 1) % args.keys

    # Tenant pool (the cost-observatory soak satellite): the planted
    # hot tenant rides every burst ON ONE FIXED KEY — a single hash
    # key has a single owner daemon, which is where the "is the hot
    # tenant ranked #1 on its owner" assertion is checked; steady
    # lanes rotate over the cold tenants.
    HOT_TENANT = "tenant-hot"
    HOT_KEY = f"{HOT_TENANT}_hot"  # name_unique-key, the hash-key rule
    cold_tenants = [f"tenant-{c}" for c in "abcdef"]

    def worker(wid: int) -> None:
        wrng = np.random.RandomState(args.seed * 1000 + wid)
        client = V1Client(addrs[wid % len(addrs)], timeout_s=60.0)
        i = 0
        while not stop.is_set():
            # Burst cadence sized so the hot tenant DOMINATES: ~1/15
            # of requests x 200 lanes ≈ half of all lanes, vs ~1/6 of
            # the rest per cold tenant — rank #1 must be unambiguous
            # on every daemon even in a 60s smoke.
            burst = (i % 15) == 14
            lanes = 200 if burst else int(wrng.choice([1, 8, 50]))
            ids = (
                np.full(lanes, zipf_pool[wrng.randint(len(zipf_pool))])
                if burst  # burst replay: one hot key, many lanes
                else zipf_pool[wrng.randint(0, len(zipf_pool), size=lanes)]
            )
            reqs = [
                RateLimitRequest(
                    name=(
                        HOT_TENANT if burst
                        else cold_tenants[(int(k) + j) % len(cold_tenants)]
                    ),
                    unique_key="hot" if burst else f"k{int(k)}",
                    hits=1,
                    limit=1_000_000_000,
                    duration=300_000,
                    algorithm=(
                        Algorithm.TOKEN_BUCKET if (j + wid) % 2 == 0
                        else Algorithm.LEAKY_BUCKET
                    ),
                    behavior=(
                        # The hot tenant stays on the plain forwarded
                        # fast path: its folds land at ONE owner.
                        0 if burst
                        else int(Behavior.GLOBAL) if int(k) % 17 == 0
                        else int(Behavior.MULTI_REGION)
                        if n_regions and int(k) % 13 == 5
                        else 0
                    ),
                )
                for j, k in enumerate(ids)
            ]
            try:
                resp = client.get_rate_limits(
                    GetRateLimitsRequest(requests=reqs)
                )
                errs = [r.error for r in resp.responses if r.error]
                with lock:
                    stats["requests"] += 1
                    stats["lanes"] += lanes
                    stats["errors"].extend(errs[:2])
            except Exception as e:  # noqa: BLE001 — partitions make some fail
                with lock:
                    stats["errors"].append(f"{type(e).__name__}: {e}")
            i += 1

    threads = [
        threading.Thread(target=worker, args=(w,), daemon=True)
        for w in range(args.workers)
    ]
    for t in threads:
        t.start()

    failures: list = []
    heal_at = None
    heal_fault = None
    fault_events = 0
    churn_events = 0
    next_fault = time.time() + args.fault_every if args.fault_every else None
    next_churn = time.time() + args.churn_every if args.churn_every else None
    churned_idx = None
    baseline_err = 0
    try:
        while time.time() < deadline and not failures:
            time.sleep(args.poll_every)
            now = time.time()
            # -- fault scheduling --------------------------------------
            if heal_at is not None and now >= heal_at:
                heal_fault()
                heal_at, heal_fault = None, None
            if (next_fault is not None and now >= next_fault
                    and heal_at is None):
                if n_regions and fault_events % 2 == 0:
                    # WAN storm: near-total seeded loss on the region
                    # wire TOWARD one region — an inter-region
                    # partition the federation carry must ride out —
                    # injected, then healed back to the steady WAN
                    # shape (its peer="*" rule survives the per-peer
                    # heal).
                    region = int(rng.randint(n_regions))
                    victims = [
                        d.peer_info.grpc_address
                        for d in cl.daemons[
                            region * per_region:(region + 1) * per_region
                        ]
                    ]
                    for v in victims:
                        plan.wan(peer=v, op="UpdateRegionColumns",
                                 latency_s=0.08, jitter_s=0.03, loss=0.9)

                    def heal_fault(vs=tuple(victims),
                                   label=chr(97 + region)) -> None:
                        for v in vs:
                            plan.heal(v, "UpdateRegionColumns")
                        print(f"soak: healed WAN storm toward region-{label}")

                    print(
                        f"soak: WAN storm toward region-{chr(97 + region)} "
                        f"({victims}) for {args.fault_for}s"
                    )
                else:
                    victim = cl.daemons[
                        int(rng.randint(len(cl.daemons)))
                    ].peer_info.grpc_address
                    plan.partition(victim)

                    def heal_fault(v=victim) -> None:
                        plan.heal(v)
                        print(f"soak: healed partition of {v}")

                    print(f"soak: partitioned {victim} for {args.fault_for}s")
                heal_at = now + args.fault_for
                fault_events += 1
                next_fault = now + args.fault_every
            if next_churn is not None and now >= next_churn:
                next_churn = now + args.churn_every
                if churned_idx is None:
                    if n_regions and per_region >= 2:
                        # Per-region churn: rotate regions, drop the
                        # region's LAST member so its local ring
                        # reshards while the other regions' ownership
                        # stays put (the region-picker stability
                        # property).
                        region = churn_events % n_regions
                        churned_idx = region * per_region + per_region - 1
                        churn_events += 1
                    else:
                        churned_idx = int(rng.randint(1, len(cl.daemons)))
                    peers = [
                        p for j, p in enumerate(cl.peers) if j != churned_idx
                    ]
                    print(
                        f"soak: churn OUT {cl.peers[churned_idx].grpc_address}"
                    )
                else:
                    peers = list(cl.peers)
                    print(
                        f"soak: churn IN {cl.peers[churned_idx].grpc_address}"
                    )
                    churned_idx = None
                for d in cl.daemons:
                    d.set_peers(peers)
            # -- invariant polling -------------------------------------
            for i, addr in enumerate(addrs):
                try:
                    aud = _fetch(addr, "/debug/audit")
                except OSError as e:
                    if heal_at is None:
                        failures.append(f"{addr}: unreachable: {e}")
                    continue
                if aud["violationTotal"]:
                    failures.append(
                        f"{addr}: AUDIT VIOLATIONS {aud['violations']} "
                        f"ledger={aud['ledger']}"
                    )
                # Cost observatory: the tenant ledger must CONSERVE on
                # every poll — top-K rows + the `other` rollup must sum
                # exactly to the totals for every stat (eviction moves
                # stats between buckets, never loses them).
                try:
                    ten = _fetch(addr, "/debug/tenants")
                except OSError:
                    continue  # reachability already judged above
                for stat in ("hits", "lanes", "overLimit", "shed",
                             "ingressBytes"):
                    parts = (
                        sum(r[stat] for r in ten["topk"])
                        + ten["other"][stat]
                    )
                    if parts != ten["totals"][stat]:
                        failures.append(
                            f"{addr}: tenant ledger LEAK on {stat}: "
                            f"topk+other={parts} != "
                            f"totals={ten['totals'][stat]}"
                        )
            with lock:
                nerr = len(stats["errors"])
                reqs = stats["requests"]
            print(
                f"soak: t-{max(deadline - now, 0):.0f}s requests={reqs} "
                f"errors={nerr - baseline_err}"
            )
            baseline_err = nerr
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        # Final reconciliation with traffic quiesced: run one audit
        # check on every daemon (in-flight lag has drained, so the
        # inequalities are at their tightest).
        for d in cl.daemons:
            try:
                d.service.auditor.check_now()
                snap = d.service.auditor.snapshot()
                if snap["violationTotal"]:
                    failures.append(
                        f"{d.gateway.address}: final audit violations "
                        f"{snap['violations']}"
                    )
            except Exception as e:  # noqa: BLE001
                failures.append(f"final audit check failed: {e}")
        sample = {}
        try:
            sample = _fetch(addrs[0], "/debug/audit")
        except OSError:
            pass
        # -- cost-observatory final reconciliation (quiesced) ----------
        # (1) The planted hot tenant must be ranked #1 on its owner
        # daemon: HOT_KEY has exactly one owner in the current ring,
        # and every burst lane folded there (locally or through the
        # peer door).
        try:
            owner_addr = (
                cl.daemons[0].service.get_peer(HOT_KEY).info.grpc_address
            )
            owner = next(
                d for d in cl.daemons
                if d.peer_info.grpc_address == owner_addr
            )
            ten = _fetch(owner.gateway.address, "/debug/tenants")
            if not ten["topk"] or ten["topk"][0]["tenant"] != HOT_TENANT:
                failures.append(
                    f"hot tenant not #1 on owner {owner.gateway.address}: "
                    f"top={[r['tenant'] for r in ten['topk'][:3]]}"
                )
            else:
                print(
                    f"soak: hot tenant '{HOT_TENANT}' ranked #1 on owner "
                    f"{owner.gateway.address} "
                    f"(hits={ten['topk'][0]['hits']})"
                )
        except Exception as e:  # noqa: BLE001
            failures.append(f"hot-tenant owner check failed: {e}")
        # (2) The summed per-daemon tenant ledgers must reconcile
        # EXACTLY with the audit ledger's ingress counters: every
        # audit ingress note has a tenant fold beside it, so at
        # quiesce  sum(tenant totals.hits) == ingress_hits +
        # peer_ingress_hits  (the in-process cluster shares one audit
        # ledger; forwarded lanes count once per door on both sides).
        try:
            from gubernator_tpu_torch import audit as audit_ledger

            tenant_hits = sum(
                d.service.tenants.totals()["hits"] for d in cl.daemons
            )
            led = audit_ledger.ledger_snapshot()
            audit_ingress = (
                led.get("ingress_hits", 0) + led.get("peer_ingress_hits", 0)
            )
            if tenant_hits != audit_ingress:
                failures.append(
                    f"tenant ledger does not reconcile with audit: "
                    f"sum(tenant hits)={tenant_hits} != ingress_hits+"
                    f"peer_ingress_hits={audit_ingress}"
                )
            else:
                print(
                    f"soak: tenant ledgers reconcile with audit ingress "
                    f"({tenant_hits} hits)"
                )
        except Exception as e:  # noqa: BLE001
            failures.append(f"tenant/audit reconciliation failed: {e}")
        faults.uninstall()
        cl.stop()

    with lock:
        reqs, lanes = stats["requests"], stats["lanes"]
    print(
        f"soak: done — {reqs} requests / {lanes} lanes; "
        f"ledger sample: { {k: v for k, v in sample.get('ledger', {}).items() if v} }"
    )
    if reqs == 0:
        failures.append("soak made zero progress")
    if n_regions:
        # The topology must have EXERCISED the federation plane: a 2x2
        # run whose region ledger never moved proves nothing about it.
        # (The ledger is process-shared, so read it directly — it
        # outlives the stopped cluster.)
        from gubernator_tpu_torch import audit as audit_ledger

        if not audit_ledger.ledger_snapshot().get("region_sent_hits"):
            failures.append(
                "region plane made zero progress (region_sent_hits == 0)"
            )
    if failures:
        print("soak: FAIL")
        for f in failures[:10]:
            print(f"  - {f}")
        return 1
    print("soak: PASS (zero conservation violations)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
