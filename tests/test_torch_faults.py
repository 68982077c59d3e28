"""The port's faults.py (breaker, backoff, fault plans) against the JAX
package's.

* The cases of tests/test_faults.py run as cases of one test
  parametrised over the two packages: each case's function is rebound
  to the package's faults, peer_client, config and types modules.  The
  gossip cases need gossip.py, which the port does not have yet.
* A FaultPlan gives the same decisions in both packages for one seed
  and one call sequence (every rule kind, rates, WAN weather, heals).
* A CircuitBreaker and a Backoff give the same state and delay
  sequences on a fake clock.
"""

import random
import types

import pytest

import gubernator_tpu_torch.config as tconfig
import gubernator_tpu_torch.faults as tfaults
import gubernator_tpu_torch.peer_client as tpeer
import gubernator_tpu_torch.types as ttypes
from gubernator_tpu import faults as jfaults
from tests import test_faults as jcases

# The port's twin of each name tests/test_faults.py imports.
_PORT_NAMES = {
    "faults": tfaults,
    "BehaviorConfig": tconfig.BehaviorConfig,
    "setup_daemon_config": tconfig.setup_daemon_config,
    "Backoff": tfaults.Backoff,
    "CircuitBreaker": tfaults.CircuitBreaker,
    "FaultPlan": tfaults.FaultPlan,
    "FaultRule": tfaults.FaultRule,
    "PeerClient": tpeer.PeerClient,
    "PeerError": tpeer.PeerError,
    "is_circuit_open": tpeer.is_circuit_open,
    "is_not_ready": tpeer.is_not_ready,
    "GetRateLimitsRequest": ttypes.GetRateLimitsRequest,
    "PeerInfo": ttypes.PeerInfo,
    "RateLimitRequest": ttypes.RateLimitRequest,
}

_CASES = sorted(
    name for name in dir(jcases)
    if name.startswith("test_") and "gossip_probe" not in name
)


def _port_globals():
    g = dict(vars(jcases))
    g.update(_PORT_NAMES)
    # Helpers the cases call (_client, _req, FakeClock) see the port too.
    for name, fn in list(g.items()):
        if isinstance(fn, types.FunctionType) and fn.__module__ == jcases.__name__:
            g[name] = types.FunctionType(fn.__code__, g, name, fn.__defaults__,
                                         fn.__closure__)
    return g


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("case", _CASES)
def test_jax_fault_cases(case, pkg):
    fn = getattr(jcases, case)
    if pkg == "torch":
        fn = _port_globals()[case]
        assert fn.__globals__["faults"] is tfaults
    fn()


def _plan_decisions(mod, seed):
    """One call sequence over every rule kind: (kind, delay, message,
    not_ready) per call, or None."""
    p = mod.FaultPlan(seed=seed)
    p.error_nth("a:1", 3, count=2, op="GetPeerRateLimits")
    p.drop_nth("b:2", 2)
    p.delay("c:3", 0.25, op="UpdatePeerGlobals")
    p.add(mod.FaultRule(peer="*", op="TransferOwnership", kind=mod.ERROR, rate=0.4))
    p.add(mod.FaultRule(peer="d:4", op="*", kind=mod.DUPLICATE, rate=0.5))
    p.wan("e:5", latency_s=0.02, jitter_s=0.01, loss=0.2)
    p.partition("f:6")
    out = []
    rng = random.Random(seed)
    peers = ["a:1", "b:2", "c:3", "d:4", "e:5", "f:6", "g:7"]
    ops = ["GetPeerRateLimits", "UpdatePeerGlobals", "TransferOwnership",
           "UpdateRegionColumns"]
    for step in range(400):
        if step == 300:
            out.append(("heal", p.heal("f:6")))
        act = p.intercept(rng.choice(peers), rng.choice(ops))
        out.append(None if act is None else
                   (act.kind, act.delay_s, act.message, act.not_ready))
    out.append(tuple(p.calls(x, o) for x in peers for o in ops))
    return out


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_fault_plan_decisions_match_jax(seed):
    assert _plan_decisions(tfaults, seed) == _plan_decisions(jfaults, seed)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _breaker_trace(mod, seed):
    clk, seen = _Clock(), []
    b = mod.CircuitBreaker(failure_threshold=3, open_interval_s=0.5, clock=clk,
                           on_transition=seen.append)
    rng = random.Random(seed)
    trace = []
    for _ in range(300):
        r = rng.random()
        if r < 0.3:
            clk.t += rng.choice([0.1, 0.25, 0.5])
        elif r < 0.6:
            trace.append(("allow", b.allow()))
        elif r < 0.85:
            b.record_failure()
        else:
            b.record_success()
        trace.append((b.state, b.state_code, b.is_open))
    return trace, seen


def _backoff_trace(mod, seed):
    bo = mod.Backoff(base_s=0.02, max_s=1.0, multiplier=2.0, rng=random.Random(seed))
    return [(bo.cap(a), bo.delay(a)) for a in range(12) for _ in range(3)]


@pytest.mark.parametrize("seed", [1, 99])
def test_breaker_and_backoff_sequences_match_jax(seed):
    assert _breaker_trace(tfaults, seed) == _breaker_trace(jfaults, seed)
    assert _backoff_trace(tfaults, seed) == _backoff_trace(jfaults, seed)
