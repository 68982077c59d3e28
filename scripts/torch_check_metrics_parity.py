#!/usr/bin/env python
"""Lint exported Prometheus metric names against the golden list, on the port.

The PyTorch port's twin of scripts/check_metrics_parity.py: the same
golden list, output and exit code, held against the port's `Metrics`
(gubernator_tpu_torch.metrics, no JAX).  The list is the JAX script's,
copied: a name added on either side fails one of the two scripts.

Two classes of names, two rules:

* REFERENCE_PARITY — names ported verbatim from the reference
  Gubernator so its dashboards/alerts work unchanged (metrics.py
  module docstring).  FROZEN: renaming or dropping one silently breaks
  every deployed dashboard, so a diff here fails the build until the
  golden list is updated in the same reviewed change.

* EXTENSIONS — names this project added (fault tolerance, columnar
  hop, dispatch pipeline, tracing).  New names are allowed only by
  editing this list — i.e. every new exported series passes review
  here instead of appearing silently.

Exit 0 on exact match, 1 with a readable diff otherwise.  Covered by
tests/test_torch_replay.py against the JAX script.
"""

from __future__ import annotations

import os
import sys

# Runnable as `python scripts/torch_check_metrics_parity.py` from the repo
# root without an installed package.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Names as prometheus_client reports them at collect() time (counters
# WITHOUT the _total suffix).
REFERENCE_PARITY = frozenset(
    {
        "gubernator_cache_size",            # cache.go:88-92
        "gubernator_cache_access_count",    # cache.go:205-218
        "gubernator_grpc_request_counts",   # grpc_stats.go:45-51
        "gubernator_grpc_request_duration", # grpc_stats.go:52-59
        "gubernator_async_durations",       # global.go:40-48
        "gubernator_broadcast_durations",   # global.go:49-56
    }
)

EXTENSIONS = frozenset(
    {
        # peer fault tolerance
        "gubernator_circuit_breaker_state",
        "gubernator_circuit_breaker_transitions",
        "gubernator_peer_retry_count",
        "gubernator_degraded_local_evals",
        # columnar peer hop
        "gubernator_peer_columns_batches",
        # bounded ingress + dispatch pipeline
        "gubernator_ingress_shed",
        "gubernator_dispatch_inflight",
        "gubernator_dispatch_inflight_hwm",
        "gubernator_dispatch_stage_seconds",
        # observability
        "gubernator_build_info",
        "gubernator_request_duration_seconds",
        # columnar GLOBAL replication plane
        "gubernator_global_broadcast_batches",
        "gubernator_global_fanout_concurrency",
        "gubernator_global_requeued_hits",
        "gubernator_global_dropped_hits",
        # saturation & SLO observability plane (saturation.py)
        "gubernator_latency_attribution_seconds",
        "gubernator_occupancy_slots",
        "gubernator_occupancy_capacity",
        "gubernator_occupancy_evictions",
        "gubernator_ingress_queue_lanes",
        "gubernator_batch_window_wait_seconds",
        "gubernator_lane_utilization",
        "gubernator_dispatcher_busy_ratio",
        "gubernator_slo_latency_target_ms",
        "gubernator_slo_burn_rate",
        "gubernator_slo_requests",
        "gubernator_hotkey_lanes",
        "gubernator_hotkey_topk",
        # public columnar ingress (the front door)
        "gubernator_ingress_columns_batches",
        # native service loop (host_runtime.cpp gt_ingress_*)
        "gubernator_native_ingress_batches",
        "gubernator_ingress_acceptor_requests",
        "gubernator_ingress_acceptor_conns",
        "gubernator_ingress_acceptor_frames",
        "gubernator_ingress_acceptor_lanes",
        # elastic membership / live resharding (reshard.py)
        "gubernator_reshard_transfers",
        "gubernator_reshard_lanes",
        "gubernator_reshard_handoff_seconds",
        "gubernator_ring_generation",
        # XLA/device telemetry (telemetry.py)
        "gubernator_xla_compiles",
        "gubernator_xla_compile_seconds",
        "gubernator_xla_steady_recompiles",
        "gubernator_xla_program_runs",
        "gubernator_device_memory_bytes",
        "gubernator_device_live_buffers",
        # conservation audit (audit.py)
        "gubernator_audit_violations",
        "gubernator_audit_checks",
        "gubernator_audit_ledger",
        # multi-region federation plane (federation.py)
        "gubernator_region_batches",
        "gubernator_region_carry_keys",
        "gubernator_region_requeued_hits",
        "gubernator_region_dropped_hits",
        # durability plane (snapshot.py)
        "gubernator_snapshot_writes",
        "gubernator_snapshot_restores",
        "gubernator_snapshot_lanes",
        "gubernator_snapshot_age_seconds",
        # cost observatory (profiling.py) — per-tenant cost
        # attribution (top-K + other rollup, cardinality-bounded) and
        # the continuous host profiler's vitals.
        "gubernator_tenant_cost",
        "gubernator_tenant_other",
        "gubernator_tenant_total",
        "gubernator_profile_samples",
        "gubernator_profile_hz",
        # millisecond express lane (architecture.md "Express
        # lane") + the jax readback-flake quarantine counter.
        "gubernator_express_lanes",
        "gubernator_express_hit_ratio",
        "gubernator_readback_retries",
        # incident black box (blackbox.py) — always-on wire
        # capture rings + triggered bundle writes.
        "gubernator_blackbox_frames",
        "gubernator_blackbox_ring_bytes",
        "gubernator_blackbox_bundles",
        "gubernator_blackbox_last_trigger_age_seconds",
    }
)

GOLDEN = REFERENCE_PARITY | EXTENSIONS


def main() -> int:
    from gubernator_tpu_torch.metrics import Metrics

    exported = {fam.name for fam in Metrics().registry.collect()}
    missing = sorted(GOLDEN - exported)
    unexpected = sorted(exported - GOLDEN)
    if not missing and not unexpected:
        print(f"metrics parity OK ({len(exported)} families)")
        return 0
    if missing:
        frozen = sorted(set(missing) & REFERENCE_PARITY)
        print("MISSING metric families (golden names not exported):")
        for name in missing:
            tag = "REFERENCE-PARITY, FROZEN" if name in frozen else "extension"
            print(f"  - {name}  [{tag}]")
    if unexpected:
        print("UNEXPECTED metric families (new names need review here):")
        for name in unexpected:
            print(f"  + {name}")
        print(
            "add intentionally-new names to EXTENSIONS in "
            "scripts/check_metrics_parity.py"
        )
    return 1


if __name__ == "__main__":
    sys.exit(main())
