"""Peer fault tolerance: circuit breakers, jittered backoff, and a
deterministic fault-injection harness.

The reference Gubernator survives peer churn as routine — k8s pods
cycle, gossip detects failures, and the data plane keeps serving.  The
three pieces here give this build the same property:

  * `CircuitBreaker` — per-peer closed -> open -> half-open state
    machine wrapped around every PeerClient RPC.  A threshold of
    consecutive transport failures opens the circuit; while open every
    call fails fast (no connect timeout burned per request); after the
    open interval ONE probe is let through (half-open), and its outcome
    closes or re-opens the circuit.

  * `Backoff` — exponential backoff with full jitter (delay drawn
    uniformly from [0, min(max, base * mult^attempt)]), used by the
    forward re-pick loop and the global/multi-region send loops instead
    of bare immediate retries.

  * `FaultPlan` — a seedable, ordered list of `FaultRule`s that can
    drop, delay, or error the Nth (or every, or a seeded fraction of)
    RPC per peer.  PeerClient and the gossip probe path consult the
    installed plan at their transport call sites, so chaos scenarios
    are injected through a supported hook — no monkeypatching — and are
    reproducible in CI: the same seed yields the same decision
    sequence.

Install a plan process-wide with `install(plan)` / `uninstall()` (the
in-process cluster harness path) or per-client via the `faults=`
constructor argument on PeerClient / Gossip.

The PyTorch port's copy of the JAX package's faults.py, line for line:
the same state machines and the same seeded decisions
(tests/test_torch_faults.py).  The port's PeerClient consults it; the
gossip probe path comes with gossip.py.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

# ----------------------------------------------------------------------
# Circuit breaker
# ----------------------------------------------------------------------
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

# Numeric encoding for the state gauge (metrics.py): closed < half-open
# < open so alert thresholds can use a simple `> 0` / `== 2` compare.
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """closed -> open -> half-open failure-count breaker.

    * CLOSED: calls flow; `failure_threshold` consecutive failures
      (successes reset the count) transition to OPEN.
    * OPEN: `allow()` is False until `open_interval_s` elapses, then
      the breaker moves to HALF_OPEN and reserves ONE probe slot.
    * HALF_OPEN: exactly one in-flight probe; its success closes the
      circuit (counters reset), its failure re-opens it for another
      interval.  Concurrent callers see False while the probe is out.

    Callers MUST pair every True `allow()` with exactly one
    `record_success()` or `record_failure()` — that releases the
    half-open probe slot.  `clock` is injectable for deterministic
    tests (defaults to time.monotonic).
    """

    def __init__(
        self,
        failure_threshold: int = 5,
        open_interval_s: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str], None]] = None,
    ):
        self.failure_threshold = max(1, int(failure_threshold))
        self.open_interval_s = float(open_interval_s)
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False

    # -- observers ------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._peek_state()

    @property
    def state_code(self) -> int:
        return STATE_CODES[self.state]

    @property
    def is_open(self) -> bool:
        """Non-mutating: True while calls would fast-fail (the probe
        window counts as open for routing decisions — a half-open peer
        is not yet trusted with traffic)."""
        return self.state != CLOSED

    def _peek_state(self) -> str:
        # Lock held.  An expired OPEN reads as HALF_OPEN so observers
        # (health, metrics) never report a stale open past the interval.
        if self._state == OPEN and (
            self._clock() - self._opened_at >= self.open_interval_s
        ):
            return HALF_OPEN
        return self._state

    # -- the call-site protocol ----------------------------------------
    def allow(self) -> bool:
        """Gate one call.  Mutating: an expired OPEN transitions to
        HALF_OPEN here and this caller becomes the probe."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.open_interval_s:
                    return False
                self._transition(HALF_OPEN)
                self._probe_inflight = True
                return True
            # HALF_OPEN: one probe at a time.
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probe_inflight = False
            if self._state == HALF_OPEN:
                self._open()
                return
            if self._state == OPEN:
                # Failures while open (late completions of calls that
                # started before the trip) keep the window fresh.
                self._opened_at = self._clock()
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._open()

    def _open(self) -> None:
        self._opened_at = self._clock()
        self._failures = 0
        self._transition(OPEN)

    def _transition(self, state: str) -> None:
        self._state = state
        if self._on_transition is not None:
            try:
                self._on_transition(state)
            except Exception:  # noqa: BLE001 — metrics must not break the breaker
                pass


# ----------------------------------------------------------------------
# Backoff
# ----------------------------------------------------------------------
class Backoff:
    """Exponential backoff with full jitter (delay ~ U[0, cap(attempt)]
    where cap = min(max_s, base_s * multiplier**attempt)).

    Full jitter beats equal-jitter for the re-pick loop's purpose:
    concurrent requests that all saw the same peer die must not retry
    in lockstep.  `rng` is injectable for reproducible chaos runs.
    """

    def __init__(
        self,
        base_s: float = 0.02,
        max_s: float = 1.0,
        multiplier: float = 2.0,
        rng: Optional[random.Random] = None,
    ):
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.multiplier = float(multiplier)
        self._rng = rng or random.Random()

    def cap(self, attempt: int) -> float:
        return min(self.max_s, self.base_s * (self.multiplier ** max(attempt, 0)))

    def delay(self, attempt: int) -> float:
        return self._rng.uniform(0.0, self.cap(attempt))

    def sleep(self, attempt: int) -> float:
        d = self.delay(attempt)
        if d > 0:
            time.sleep(d)
        return d


# ----------------------------------------------------------------------
# Fault injection
# ----------------------------------------------------------------------
DROP = "drop"
DELAY = "delay"
ERROR = "error"
# DUPLICATE: let the call proceed, then deliver it AGAIN — the network
# or a misbehaving proxy re-delivering an RPC that already applied.
# The peer hop's hit-carrying RPCs are increments, NOT idempotent, so a
# duplicated delivery is a true double-commit on the wire: the seeded
# fault the conservation audit (audit.py forward_conservation) must
# catch.  PeerClient applies it by invoking the transport twice inside
# one guarded call (breaker sees one call; the duplicate's own failure
# is swallowed — a dropped duplicate is just a clean network again).
DUPLICATE = "duplicate"
# WAN: the wide-area link shape — every matching call pays a seeded
# normal-ish latency (mean latency_s, stddev jitter_s, clamped at 0)
# and a seeded fraction `loss` of calls is lost outright.  A lost call
# presents timeout-shaped (DROP: the request — or its RESPONSE — died
# in transit, so the RPC may have applied remotely and the caller must
# not blind-retry).  The surviving calls resolve to ordinary DELAY
# actions, so every existing interception point applies a WAN rule
# with no new handling (gossip's delay-eats-ack-budget rule included).
# All draws come from the plan's per-(peer, op) seeded streams: the
# same seed yields the same loss pattern AND the same latency series,
# which is what lets the 2x2 region soak replay a WAN weather system
# deterministically.
WAN = "wan"

# Known interception points (the `op` a rule matches against):
#   GetPeerRateLimits / UpdatePeerGlobals  — PeerClient data-plane RPCs
#   gossip.probe                            — SWIM UDP ping sends
OP_GOSSIP_PROBE = "gossip.probe"


@dataclass
class FaultRule:
    """One match-and-act rule.

    peer/op match by exact string or "*".  The rule fires on matching
    calls number `after+1 .. after+count` (per (peer, op) pair, 1-based;
    count=None means forever), and only when the plan's seeded RNG draw
    is < `rate`.  `kind`:

      * ERROR — raise a connection-shaped failure (not_ready=True by
        default: the caller's re-pick/breaker path engages, like a real
        UNAVAILABLE).
      * DROP  — raise a timeout-shaped failure (not_ready=False: the
        RPC may have executed server-side, so callers must NOT retry —
        the DEADLINE_EXCEEDED caveat, peer_client.py:44-49).  No real
        sleep: deterministic-fast for CI.
      * DELAY — sleep `delay_s`, then let the call proceed.  On gossip
        probes the delay eats the ack budget instead: delay_s >= the
        probe timeout counts the probe as lost (without a real sleep),
        so injected latency can drive suspicion (gossip._ping).
    """

    peer: str = "*"
    op: str = "*"
    kind: str = ERROR
    after: int = 0
    count: Optional[int] = None
    rate: float = 1.0
    delay_s: float = 0.0
    not_ready: bool = True
    message: str = ""
    # WAN-shape parameters (kind=WAN only): per-call latency drawn
    # from N(latency_s, jitter_s) clamped at 0, and `loss` = seeded
    # probability the call is lost (timeout-shaped DROP).
    latency_s: float = 0.0
    jitter_s: float = 0.0
    loss: float = 0.0
    # Times this rule decided a call's fate (FaultPlan.intercept bumps
    # it under the plan lock).  Lives on the rule itself so the count
    # can never be confused with another rule's after heal() frees one.
    fired_count: int = 0

    def __post_init__(self) -> None:
        # DROP is timeout-shaped by definition: the RPC may have
        # executed server-side, so it must never present as a safely
        # retryable connection failure (the DEADLINE_EXCEEDED caveat,
        # peer_client.py:44-49).
        if self.kind == DROP:
            self.not_ready = False

    def matches(self, peer: str, op: str) -> bool:
        return self.peer in ("*", peer) and self.op in ("*", op)


@dataclass
class FaultAction:
    kind: str
    delay_s: float = 0.0
    not_ready: bool = True
    message: str = ""


class FaultPlan:
    """A seedable, ordered fault plan.

    Rules are evaluated MOST-SPECIFIC-FIRST: an exact `peer` beats
    peer="*", then an exact `op` beats op="*"; equally specific rules
    keep insertion order.  Within that order the first rule whose
    (peer, op) matches, whose per-(rule, peer, op) call window is
    active, and whose seeded RNG draw passes `rate` decides the call's
    fate — so a per-victim storm or `partition(victim)` laid over a
    steady peer="*" WAN shape takes effect instead of being shadowed
    by the earlier wildcard (the 2x2 region soak's layering), and
    healing the specific rule falls back to the steady shape.
    Per-(peer, op) call counters advance on EVERY intercepted call, so
    "the Nth RPC to peer X" is well-defined regardless of how many
    rules exist.  All state is behind one lock: a plan is shared by
    every PeerClient in the process when installed globally.
    """

    def __init__(self, seed: Optional[int] = None):
        self.seed = seed
        self._lock = threading.Lock()
        self._rules: List[FaultRule] = []
        self._calls: Dict[Tuple[str, str], int] = {}
        # One RNG stream per (peer, op), derived from the plan seed:
        # the Nth call to a given (peer, op) sees the Nth draw of its
        # own stream no matter how concurrent calls to OTHER peers/ops
        # interleave — without this, rate-gated rules in a multi-daemon
        # cluster would consume one shared sequence in thread-schedule
        # order and "same seed, same decisions" would not hold.
        self._rngs: Dict[Tuple[str, str], random.Random] = {}

    # -- authoring ------------------------------------------------------
    def add(self, rule: FaultRule) -> FaultRule:
        with self._lock:
            self._rules.append(rule)
        return rule

    def partition(self, peer: str, op: str = "*") -> FaultRule:
        """Every matching RPC fails connection-shaped (UNAVAILABLE-like)
        until healed — the client-side view of a network partition."""
        return self.add(FaultRule(peer=peer, op=op, kind=ERROR, not_ready=True))

    def drop_nth(self, peer: str, n: int, op: str = "*") -> FaultRule:
        """Time out exactly the Nth matching RPC (1-based)."""
        return self.add(FaultRule(peer=peer, op=op, kind=DROP, after=n - 1, count=1))

    def drop(self, peer: str = "*", op: str = "*", rate: float = 1.0) -> FaultRule:
        """Time out matching RPCs (timeout-shaped: the call may have
        executed server-side, so callers must not blind-retry) at the
        seeded `rate` until healed — lossy-network chaos, e.g. DROP on
        the resharding transfer frames."""
        return self.add(FaultRule(peer=peer, op=op, kind=DROP, rate=rate))

    def error_nth(self, peer: str, n: int, op: str = "*", count: int = 1) -> FaultRule:
        """Fail connection-shaped starting at the Nth matching RPC."""
        return self.add(
            FaultRule(peer=peer, op=op, kind=ERROR, after=n - 1, count=count)
        )

    def delay(self, peer: str, delay_s: float, op: str = "*",
              rate: float = 1.0) -> FaultRule:
        return self.add(
            FaultRule(peer=peer, op=op, kind=DELAY, delay_s=delay_s, rate=rate)
        )

    def duplicate(self, peer: str = "*", op: str = "*", rate: float = 1.0,
                  after: int = 0, count: Optional[int] = None) -> FaultRule:
        """Deliver matching RPCs TWICE (byzantine-network chaos): the
        seeded double-commit that must trip the conservation audit's
        forward_conservation invariant on the sender."""
        return self.add(
            FaultRule(peer=peer, op=op, kind=DUPLICATE, rate=rate,
                      after=after, count=count)
        )

    def wan(self, peer: str = "*", op: str = "*", latency_s: float = 0.05,
            jitter_s: float = 0.01, loss: float = 0.0,
            rate: float = 1.0) -> FaultRule:
        """Shape matching RPCs like a wide-area link until healed:
        every call pays a seeded normal-ish delay (mean `latency_s`,
        stddev `jitter_s`, clamped at 0) and a seeded `loss` fraction
        is lost outright (timeout-shaped — the call may have applied
        remotely, so callers must not blind-retry; the federation
        sender drops those hits COUNTED).  The 2x2 region soak installs
        one of these per inter-region (peer, op) pair and heals it to
        model a WAN partition ending."""
        if not 0.0 <= loss <= 1.0:
            raise ValueError(f"loss must be within [0, 1], got {loss}")
        if latency_s < 0.0 or jitter_s < 0.0:
            raise ValueError("latency_s/jitter_s must be >= 0")
        return self.add(FaultRule(
            peer=peer, op=op, kind=WAN, rate=rate,
            latency_s=latency_s, jitter_s=jitter_s, loss=loss,
        ))

    def heal(self, peer: str = "*", op: str = "*") -> int:
        """Remove matching rules (the partition ends, the peer returns).
        Returns how many rules were removed.  Call counters are kept:
        healing must not rewind "Nth RPC" bookkeeping for other rules."""
        with self._lock:
            before = len(self._rules)
            self._rules = [
                r for r in self._rules
                if not (peer in ("*", r.peer) and op in ("*", r.op))
            ]
            return before - len(self._rules)

    # -- interception ---------------------------------------------------
    def intercept(self, peer: str, op: str,
                  exclude: tuple = ()) -> Optional[FaultAction]:
        """Decide one call's fate.  Returns None (proceed) or a
        FaultAction.  The caller applies the action — sleeps for DELAY,
        raises for ERROR/DROP — so the plan itself never blocks while
        holding its lock.  `exclude` skips rules of the named kinds
        BEFORE they match (no fired_count / rate-draw consumption): a
        caller that cannot honor a kind (gossip probes and DUPLICATE)
        must not silently burn the rule's accounting."""
        with self._lock:
            key = (peer, op)
            n = self._calls.get(key, 0) + 1
            self._calls[key] = n
            rng = self._rngs.get(key)
            if rng is None:
                # str seeds hash stably (sha512, not PYTHONHASHSEED),
                # so the stream replays across processes too.
                rng = self._rngs[key] = random.Random(
                    f"{self.seed}:{peer}:{op}" if self.seed is not None else None
                )
            # Most-specific-first (stable, so equal specificity keeps
            # insertion order): exact peer beats "*", then exact op —
            # a per-victim storm/partition layered over a steady
            # peer="*" WAN rule must win, not be shadowed by it.
            ordered = sorted(
                self._rules,
                key=lambda r: (r.peer == "*", r.op == "*"),
            )
            for rule in ordered:
                if rule.kind in exclude:
                    continue
                if not rule.matches(peer, op):
                    continue
                if n <= rule.after:
                    continue
                if rule.count is not None and n > rule.after + rule.count:
                    continue
                if rule.rate < 1.0 and rng.random() >= rule.rate:
                    continue
                rule.fired_count += 1
                if rule.kind == WAN:
                    # Resolve the WAN shape to an ordinary DROP/DELAY
                    # action HERE, from the same per-(peer, op) seeded
                    # stream as the rate draw — interception points
                    # need no WAN-specific handling and the loss
                    # pattern + latency series replay under a seed.
                    # Draw ORDER is part of the wire format of a seed:
                    # loss first, then latency only for survivors.
                    if rule.loss > 0.0 and rng.random() < rule.loss:
                        return FaultAction(
                            kind=DROP, not_ready=False,
                            message=rule.message or (
                                f"injected wan loss (peer {peer}, "
                                f"op {op}, call #{n})"
                            ),
                        )
                    return FaultAction(
                        kind=DELAY,
                        delay_s=max(
                            0.0, rng.gauss(rule.latency_s, rule.jitter_s)
                        ),
                        not_ready=rule.not_ready,
                        message=rule.message or (
                            f"injected wan latency (peer {peer}, "
                            f"op {op}, call #{n})"
                        ),
                    )
                msg = rule.message or (
                    f"injected {rule.kind} (peer {peer}, op {op}, call #{n})"
                )
                return FaultAction(
                    kind=rule.kind, delay_s=rule.delay_s,
                    not_ready=rule.not_ready, message=msg,
                )
            return None

    # -- observers (chaos-test assertions) ------------------------------
    def calls(self, peer: str, op: str) -> int:
        with self._lock:
            return self._calls.get((peer, op), 0)

    def fired(self, rule: FaultRule) -> int:
        with self._lock:
            return rule.fired_count


# ----------------------------------------------------------------------
# Process-wide installation (the no-monkeypatch hook)
# ----------------------------------------------------------------------
_active_lock = threading.Lock()
_active_plan: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Install `plan` process-wide: every PeerClient/Gossip instance
    without an explicit `faults=` consults it on each RPC/probe."""
    global _active_plan
    with _active_lock:
        _active_plan = plan
    return plan


def uninstall() -> None:
    global _active_plan
    with _active_lock:
        _active_plan = None


def active() -> Optional[FaultPlan]:
    with _active_lock:
        return _active_plan


class injected:
    """Context manager: `with faults.injected(plan): ...` installs the
    plan for the block and uninstalls on exit (even on error) — the
    chaos-test idiom."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        return install(self.plan)

    def __exit__(self, *exc) -> None:
        uninstall()
