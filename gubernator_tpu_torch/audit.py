"""Always-on conservation audit: the chaos-suite oracles, productionized.

The exactly-once invariants this system promises — no double-committed
hits on the peer wire, GLOBAL hit lanes delivered exactly once or
counted, reshard transfer lanes conserved, device grants bounded by
what was dispatched — are pinned today by offline chaos tests (PRs 5
and 7).  This module keeps a windowed LEDGER of the same quantities on
the live path and reconciles them every `GUBER_AUDIT_INTERVAL`
seconds, so an accounting bug (or a byzantine network duplicating
deliveries) surfaces as `gubernator_audit_violations_total{invariant}`
plus a flight-recorder auto-dump — not as a customer noticing their
rate limit ran double.

**Ledger.**  Cumulative counters recorded at DISTINCT layers of the
stack (each invariant compares two different layers' views of the same
hits, which is what makes the reconciliation meaningful):

  ingress_hits            hits entering the public front door
  peer_ingress_hits       hits entering via GetPeerRateLimits
  dispatched_hits         hits entering the columnar dispatch pipeline
  applied_hits            hits GRANTED by the device (UNDER_LIMIT
                          lanes at commit decode)
  forward_admitted_hits   hits handed to the peer-forward wire
  forward_wire_hits       hits that REACHED a peer, per transport
                          attempt (success or timeout-ambiguous;
                          provably-unapplied failures do not count)
  global_agg_hits         GLOBAL hits aggregated by the sync collective
  global_sent_hits        GLOBAL hits delivered owner-ward
  global_dropped_hits     GLOBAL hits dropped counted (timeout-shaped
                          / carry overflow)
  reshard_drained_lanes   lanes gathered off this owner for transfer
  reshard_acked_lanes     lanes a new owner ACKed (forgotten locally)
  reshard_received_lanes  transfer lanes received from old owners
  reshard_committed_lanes merge-committed here
  reshard_rejected_lanes  received but not owned under the current ring
  snapshot_saved_lanes    lanes gathered into a completed snapshot dump
  snapshot_loaded_lanes   lanes decoded from a snapshot file at boot
  snapshot_committed_lanes lanes merge-committed by the boot restore
  region_agg_hits         MULTI_REGION hits admitted toward a remote
                          region at flush (new lanes only, counted per
                          destination region; carried lanes were
                          counted the flush they first aggregated)
  region_sent_hits        region hits delivered to a remote owner (ok)
  region_dropped_hits     region hits dropped counted (timeout-shaped
                          sends that may have applied remotely, carry
                          overflow, departed regions)
  region_admitted_hits    region hits handed to the wire per logical
                          send (federation.RegionBatch)
  region_wire_hits        region hits that REACHED a peer, per
                          transport delivery (success or
                          timeout-ambiguous; provably-unapplied
                          failures do not count)
  region_recv_hits        hits decoded from a received
                          UpdateRegionColumns batch
  region_applied_hits     region hits the receiver applied locally
  negative_remaining      decoded lanes with remaining < 0 (device
                          arithmetic corruption; must stay 0)

**Invariants.**  Each is a one-sided inequality that tolerates
in-flight lag (the later layer's counter lags the earlier one's), so
interval windowing can never false-positive — only EXCESS on the later
side (hits materializing from nowhere = a double-commit / conservation
break) trips it:

  device_conservation    applied_hits            <= dispatched_hits
  forward_conservation   forward_wire_hits       <= forward_admitted_hits
  global_conservation    global_sent + dropped   <= global_agg_hits
  global_slack           requeue carry keys      <= HIT_CARRY_MAX
                         (the documented bounded-loss slack)
  reshard_out            reshard_acked_lanes     <= reshard_drained_lanes
  reshard_in             committed + rejected    <= reshard_received_lanes
  snapshot_restore       snapshot_committed      <= snapshot_loaded
                         (a restore can only drop lanes — expired in
                         transit, duplicate keys — never mint them)
  region_conservation    region_wire_hits        <= region_admitted_hits
                         (the federation plane's exactly-once chain,
                         sender side: a DUPLICATE re-delivery on the
                         region wire doubles the wire side and fires)
  region_delivery        region_sent + dropped   <= region_agg_hits
  region_apply           region_applied_hits     <= region_recv_hits
  region_slack           region carry keys       <= REGION_CARRY_MAX
                         (federation.py's documented bounded-loss
                         slack per destination region, summed)
  negative_remaining     negative_remaining      == 0

The federation chain "origin-admitted >= wire-reached >= remote-applied"
is audited as SIDE-LOCAL pairs: admitted/wire on the sender,
recv/applied on the receiver.  In an in-process multi-daemon soak the
shared ledger additionally keeps the cross-daemon inequality
(wire >= recv) true by construction; across real processes each daemon
reconciles only its own pairs, so a receiver is never falsely blamed
for hits whose admit note lives in another process.

A FaultPlan DUPLICATE rule (faults.py) — the injectable model of a
network/proxy re-delivering an applied RPC — makes the sender count
`forward_wire_hits` twice for hits admitted once: the seeded
double-commit the chaos suite uses to prove the audit fires.  A clean
run keeps every inequality slack and the audit silent.

The ledger is MODULE-GLOBAL (the saturation/tracing convention: one
daemon per process in production; in-process test clusters share one
plane and the inequalities still hold summed across daemons because
both sides of each are summed).  Each `Auditor` captures a BASELINE
snapshot when armed, so ledger traffic from earlier same-process tests
or startup warmup cannot leak into its verdicts.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from . import tracing
from .utils.logging import category_logger

logger = category_logger("audit")

# Ledger counter names, in report order.
COUNTERS = (
    "ingress_hits",
    "peer_ingress_hits",
    "dispatched_hits",
    "applied_hits",
    "forward_admitted_hits",
    "forward_wire_hits",
    "global_agg_hits",
    "global_sent_hits",
    "global_dropped_hits",
    "reshard_drained_lanes",
    "reshard_acked_lanes",
    "reshard_received_lanes",
    "reshard_committed_lanes",
    "reshard_rejected_lanes",
    "snapshot_saved_lanes",
    "snapshot_loaded_lanes",
    "snapshot_committed_lanes",
    "region_agg_hits",
    "region_sent_hits",
    "region_dropped_hits",
    "region_admitted_hits",
    "region_wire_hits",
    "region_recv_hits",
    "region_applied_hits",
    "negative_remaining",
)

_lock = threading.Lock()
_ledger: Dict[str, int] = {k: 0 for k in COUNTERS}
# Gauges: absolute values set by their owner (not cumulative).
_gauges: Dict[str, float] = {}


def note(counter: str, n: int) -> None:
    """Record `n` units into a cumulative ledger counter.  Called per
    BATCH / per RPC, never per lane — one lock, one int add."""
    if n <= 0:
        return
    with _lock:
        _ledger[counter] = _ledger.get(counter, 0) + int(n)


def set_gauge(name: str, value: float) -> None:
    with _lock:
        _gauges[name] = value


def ledger_snapshot() -> Dict[str, int]:
    with _lock:
        return dict(_ledger)


def gauges_snapshot() -> Dict[str, float]:
    with _lock:
        return dict(_gauges)


def reset() -> None:
    """Test hook: zero the ledger and gauges."""
    with _lock:
        for k in list(_ledger):
            _ledger[k] = 0
        _gauges.clear()


# ---------------------------------------------------------------------
# Invariant table: name -> (lhs counters, rhs counters, slack).
# Violation when sum(lhs) > sum(rhs) + slack, evaluated on
# baseline-relative deltas.
# ---------------------------------------------------------------------
INVARIANTS = {
    "device_conservation": (("applied_hits",), ("dispatched_hits",), 0),
    "forward_conservation": (
        ("forward_wire_hits",), ("forward_admitted_hits",), 0,
    ),
    "global_conservation": (
        ("global_sent_hits", "global_dropped_hits"), ("global_agg_hits",), 0,
    ),
    "reshard_out": (("reshard_acked_lanes",), ("reshard_drained_lanes",), 0),
    "reshard_in": (
        ("reshard_committed_lanes", "reshard_rejected_lanes"),
        ("reshard_received_lanes",), 0,
    ),
    "snapshot_restore": (
        ("snapshot_committed_lanes",), ("snapshot_loaded_lanes",), 0,
    ),
    "region_conservation": (
        ("region_wire_hits",), ("region_admitted_hits",), 0,
    ),
    "region_delivery": (
        ("region_sent_hits", "region_dropped_hits"), ("region_agg_hits",), 0,
    ),
    "region_apply": (("region_applied_hits",), ("region_recv_hits",), 0),
    "negative_remaining": (("negative_remaining",), (), 0),
}

# The documented GLOBAL requeue-carry bound (service.GlobalManager
# .HIT_CARRY_MAX; imported lazily to avoid a cycle) — checked as a
# gauge invariant: carry beyond the cap means the bounded-loss contract
# the architecture documents no longer holds.
GLOBAL_CARRY_GAUGE = "global_carry_keys"

# The federation requeue-carry bound (federation.REGION_CARRY_MAX),
# checked the same way: carry beyond the cap means the documented
# bounded-loss contract of the region plane no longer holds.
REGION_CARRY_GAUGE = "region_carry_keys"


def _carry_cap() -> int:
    from .service import GlobalManager

    return GlobalManager.HIT_CARRY_MAX


def _region_carry_cap() -> int:
    from .federation import REGION_CARRY_MAX

    return REGION_CARRY_MAX


class Auditor:
    """Periodic reconciliation of the ledger against the invariant
    table.  `metrics` (a metrics.Metrics) receives live violation /
    check counters; detected violations also record an
    `audit-violation` flight-recorder event (auto-dump, rate-limited by
    tracing's dump throttle).  One auditor per V1Service; `arm()`
    captures the baseline so pre-existing same-process ledger traffic
    is excluded from its verdicts."""

    def __init__(self, metrics=None, interval_s: float = 5.0,
                 enabled: bool = True, time_fn=time.monotonic,
                 recorder=None):
        self.metrics = metrics
        self.interval_s = max(float(interval_s), 0.05)
        self.enabled = bool(enabled)
        self._time = time_fn
        # The owning service's flight recorder: bound in the audit
        # thread so violation events (and the incident bundles they
        # trigger) attribute to THIS daemon, not the process default —
        # co-resident soak daemons each get their own black box.
        self.recorder = recorder
        self._baseline: Dict[str, int] = {}
        self._violation_extents: Dict[str, int] = {}
        self.violations: Dict[str, int] = {}
        self.checks = 0
        self.last_check_monotonic = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Serializes check_now: the interval thread and direct callers
        # (soak final pass, tests, a future scrape hook) must not race
        # the extent-compare-then-count sequence — one real violation
        # must increment the counter exactly once.
        self._check_lock = threading.Lock()
        self.arm()

    def arm(self) -> None:
        """(Re)capture the ledger baseline: deltas reported by check()
        are relative to this point.  The FIRST reconciliation after
        arming SEEDS the extent table without counting: arming is not
        atomic with the paired notes (an RPC whose admitted side landed
        before the baseline delivers its wire side after it), so the
        in-flight halves of operations straddling the arm read as
        excess exactly once — attributing that to the arm instead of
        firing keeps a daemon constructed under live same-process
        traffic from dumping a false violation.  Real conservation
        breaks keep producing excess and fire on GROWTH at the next
        interval."""
        self._baseline = ledger_snapshot()
        self._violation_extents = {}
        self._seeded = False

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="conservation-audit"
        )
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
            self._thread = None

    def _run(self) -> None:
        if self.recorder is not None:
            tracing.bind_recorder(self.recorder)
        while not self._stop.wait(self.interval_s):
            try:
                self.check_now()
            except Exception:  # noqa: BLE001 — the audit must never die
                logger.exception("conservation audit check failed")

    # ------------------------------------------------------------------
    def deltas(self) -> Dict[str, int]:
        cur = ledger_snapshot()
        return {
            k: cur.get(k, 0) - self._baseline.get(k, 0) for k in cur
        }

    def check_now(self) -> List[dict]:
        """One reconciliation pass.  Returns the list of violations
        FOUND this pass (new or grown); persisting-unchanged violations
        are reported in snapshot() but not re-counted, so a single
        double-commit increments the counter once, not once per
        interval forever.  The first pass after arm() seeds extents
        silently (see arm): it counts as a check but can never fire."""
        with self._check_lock:
            return self._check_locked()

    def _check_locked(self) -> List[dict]:
        seeding = not self._seeded
        self._seeded = True
        d = self.deltas()
        found: List[dict] = []
        for name, (lhs, rhs, slack) in INVARIANTS.items():
            excess = sum(d.get(k, 0) for k in lhs) - (
                sum(d.get(k, 0) for k in rhs) + slack
            )
            if excess > 0:
                prev = self._violation_extents.get(name, 0)
                if excess > prev:
                    self._violation_extents[name] = excess
                    found.append({
                        "invariant": name,
                        "excess": excess,
                        "lhs": {k: d.get(k, 0) for k in lhs},
                        "rhs": {k: d.get(k, 0) for k in rhs},
                    })
        carry = gauges_snapshot().get(GLOBAL_CARRY_GAUGE)
        if carry is not None and carry > _carry_cap():
            excess = int(carry) - _carry_cap()
            if excess > self._violation_extents.get("global_slack", 0):
                self._violation_extents["global_slack"] = excess
                found.append({
                    "invariant": "global_slack",
                    "excess": excess,
                    "lhs": {GLOBAL_CARRY_GAUGE: int(carry)},
                    "rhs": {"HIT_CARRY_MAX": _carry_cap()},
                })
        rcarry = gauges_snapshot().get(REGION_CARRY_GAUGE)
        if rcarry is not None and rcarry > _region_carry_cap():
            excess = int(rcarry) - _region_carry_cap()
            if excess > self._violation_extents.get("region_slack", 0):
                self._violation_extents["region_slack"] = excess
                found.append({
                    "invariant": "region_slack",
                    "excess": excess,
                    "lhs": {REGION_CARRY_GAUGE: int(rcarry)},
                    "rhs": {"REGION_CARRY_MAX": _region_carry_cap()},
                })
        self.checks += 1
        self.last_check_monotonic = self._time()
        if self.metrics is not None:
            self.metrics.audit_checks.inc()
        if seeding:
            return []
        for v in found:
            name = v["invariant"]
            self.violations[name] = self.violations.get(name, 0) + 1
            if self.metrics is not None:
                self.metrics.audit_violations.labels(invariant=name).inc()
            logger.warning(
                "conservation audit VIOLATION %s: excess=%d lhs=%s rhs=%s",
                name, v["excess"], v["lhs"], v["rhs"],
            )
            # The flight recorder's auto-dump path: a conservation break is exactly
            # the moment the flight recorder's last-N spans matter.
            tracing.record_event(
                "audit-violation", invariant=name, excess=v["excess"],
            )
        return found

    def snapshot(self) -> dict:
        """The GET /debug/audit document."""
        return {
            "enabled": self.enabled,
            "intervalS": self.interval_s,
            "checks": self.checks,
            "violations": dict(self.violations),
            "violationTotal": sum(self.violations.values()),
            "ledger": self.deltas(),
            "gauges": gauges_snapshot(),
            "invariants": {
                name: {"lhs": list(lhs), "rhs": list(rhs), "slack": slack}
                for name, (lhs, rhs, slack) in INVARIANTS.items()
            },
        }
