"""The one traffic generator: a mix is a JSON file of parameters under
`portbench/traffic/`, and this module turns it and a seed into requests.

A mix describes closed-loop flows.  Flow c owns the key ids congruent to
c modulo `flows`, so no two flows share a bucket and each key's hits
arrive in its flow's order whatever the service's coalescing does.  Each
flow cycles through a script of `script_requests` requests whose keys
are drawn before the measured window.

Time moves in epochs.  The service's clock is frozen; every flow sends
`epoch_requests` requests and waits, and once every flow's answers are
in, the clock moves on by `epoch_ms` and the next epoch starts.  So the
instant a hit is evaluated at is fixed by its place in its flow
(`now_of`), whatever the pace, and buckets leak, expire and refill
within a run.

Parameters (all required unless marked):

- `flows`, `lanes_per_request`, `script_requests`, `epoch_requests`,
  `epoch_ms`
- `keys`: size of the id space, every id filled once in set-up
- `hot_fraction`, `hot_traffic`: the hot-set stand-in for a Zipf draw,
  `hot_traffic` of the draws on the first `hot_fraction` of a flow's
  ids, the rest uniform over all of them
- `name`: the rate limit's name on every lane
- `algorithm`: "token" or "leaky"; `limit`, `duration_ms`, `hits`
- `behavior` (optional): a list of at most one upstream Behavior name,
  set on every lane as its `behavior` bits; absent or empty, 0
  (BATCHING).  Only the names of BEHAVIORS, those a cell sends
- `fill_lanes`: lanes of one set-up fill request
- `lead_requests`: requests per flow, on average, answered before the
  window opens
- `entry`: how a flow's request reaches the service: "json" (the
  /v1/GetRateLimits body, parsed by the port's native edge parser) or
  "columns" (an IngressColumns); the set-up fill always sends columns
- `issuers`: threads that issue the flows' requests
- `now_ms`: the clock at the fill; the seed moves it by whole days
  (`now_days` of them at most, optional, default 0)
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List

import numpy as np

from portbench import reference

TOKEN, LEAKY = 0, 1
# The Behavior bits (gubernator.proto) a mix may set: those a cell sends.
# GLOBAL and MULTI_REGION need peers, which a one-node run has not.
BEHAVIORS = {"NO_BATCHING": 1}
DAY_MS = 86_400_000
SEED_SALT = 0x5EED


def load(root: str, name: str) -> dict:
    with open(os.path.join(root, "portbench", "traffic", f"{name}.json")) as f:
        return json.load(f)


@dataclass
class Traffic:
    params: dict
    now_ms: int  # the clock at the fill
    columns: dict  # one request's per-lane columns but the keys (the same for all)
    fill: List[np.ndarray]  # key ids of the set-up requests, in order
    scripts: List[List[np.ndarray]]  # key ids of each flow's requests, cycled

    @property
    def flows(self) -> int:
        return len(self.scripts)

    def ids(self, flow: int, index: int) -> np.ndarray:
        """Key ids of request `index` of `flow` (-1: fill request)."""
        if flow < 0:
            return self.fill[index]
        script = self.scripts[flow]
        return script[index % len(script)]

    def now_of(self, flow: int, index: int) -> int:
        """The clock a request is evaluated at: the fill's instant, or
        that of the request's epoch."""
        if flow < 0:
            return self.now_ms
        p = self.params
        return self.now_ms + (index // int(p["epoch_requests"]) + 1) * int(p["epoch_ms"])


def behavior_names(p: dict) -> List[str]:
    """The mix's `behavior` names: at most one, from BEHAVIORS."""
    names = p.get("behavior") or []
    if not isinstance(names, list) or len(names) > 1:
        raise ValueError(f"traffic parameter 'behavior' is a list of one name, not {names!r}")
    if names and names[0] not in BEHAVIORS:
        raise ValueError(f"traffic parameter 'behavior': {names[0]!r} not among "
                         f"{sorted(BEHAVIORS)}")
    return names


def behavior_bits(p: dict) -> int:
    names = behavior_names(p)
    return BEHAVIORS[names[0]] if names else 0


def columns(p: dict, n: int) -> dict:
    """Per-lane request columns of an `n`-lane request of mix `p`."""
    algo = {"token": TOKEN, "leaky": LEAKY}[p["algorithm"]]
    return dict(algorithm=np.full(n, algo, np.int32),
                behavior=np.full(n, behavior_bits(p), np.int32),
                hits=np.full(n, int(p["hits"]), np.int64),
                limit=np.full(n, int(p["limit"]), np.int64),
                duration=np.full(n, int(p["duration_ms"]), np.int64))


def reference_hits(traffic: Traffic, reqs: "List[tuple[int, int]]") -> "reference.Hits":
    """The reference's lanes of the requests `reqs`, (flow, index) pairs
    answered in this order (a key's hits keep their order)."""
    ids = [traffic.ids(f, i) for f, i in reqs]
    n = sum(len(x) for x in ids)
    sizes = np.array([len(x) for x in ids], np.int64)
    now = np.repeat(np.array([traffic.now_of(f, i) for f, i in reqs], np.int64), sizes)
    key = np.concatenate(ids).astype(np.int64) if ids else np.zeros(0, np.int64)
    p = traffic.params
    col = columns(p, n)
    return reference.Hits(key=key, seq=np.arange(n, dtype=np.int64), now=now,
                          **{f: v.astype(np.int64) for f, v in col.items()})


def draws(rng, n_ids: int, size, hot_fraction: float, hot_traffic: float):
    """`hot_traffic` of the draws uniform over the first `hot_fraction`
    of [0, n_ids), the rest uniform over all of it."""
    hot = rng.integers(0, max(int(n_ids * hot_fraction), 1), size)
    cold = rng.integers(0, n_ids, size)
    return np.where(rng.random(size) < hot_traffic, hot, cold)


def build(p: dict, seed: int) -> Traffic:
    """The mix's requests for `seed`: the same seed gives the same
    requests, and every seed the same sizes and shape of work."""
    rng = np.random.default_rng([SEED_SALT, seed])
    flows, lanes = int(p["flows"]), int(p["lanes_per_request"])
    per_script, keys = int(p["script_requests"]), int(p["keys"])
    per_flow = keys // flows  # ids of one flow
    d = draws(rng, per_flow, (flows, per_script, lanes), float(p["hot_fraction"]),
              float(p["hot_traffic"]))
    ids = d * flows + np.arange(flows)[:, None, None]
    scripts = [list(ids[c]) for c in range(flows)]
    all_ids = rng.permutation(per_flow * flows).astype(np.int64)
    step = int(p["fill_lanes"])
    fill = [all_ids[i:i + step] for i in range(0, len(all_ids), step)]
    now = int(p["now_ms"]) + int(rng.integers(0, int(p.get("now_days", 0)) + 1)) * DAY_MS
    return Traffic(params=p, now_ms=now, columns=columns(p, lanes), fill=fill,
                   scripts=scripts)
