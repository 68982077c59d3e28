"""Tiny versions of the benchmark's cells, for CPU tests: the same mixes
and configurations at sizes a test run holds."""

import os

from portbench import traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ENV = {"GUBER_BATCH_WAIT": "500us", "GUBER_GLOBAL_SYNC_WAIT": "1h",
       "GUBER_WARMUP_SHAPES": "20"}
SIZES = {
    "leaky1m-batched-128c": ({"GUBER_CACHE_SIZE": "8192"}, {"keys": 400}),
    # One-lane requests, as on the card; a CPU store's express scalar
    # slot off, so they take the store's launch path, as on the card.
    "token1k-nobatch-1c": ({"GUBER_CACHE_SIZE": "8192", "GUBER_EXPRESS_SCALAR": "0"},
                           {"keys": 40, "lanes_per_request": 1}),
}
MIXES = tuple(SIZES)


def cell(name: str):
    """(config, mix) of the tiny cell `name`: 4 flows of 20-lane requests
    (or as SIZES sets) over a quarter of the keys each, so hot keys go
    over their limit and the clock moves every 8 requests of a flow."""
    env, over = SIZES[name]
    mix = traffic.load(ROOT, name)
    mix.update({"flows": 4, "lanes_per_request": 20, "fill_lanes": 20, "lead_requests": 1,
                "issuers": 1, "script_requests": 4, "epoch_requests": 8, **over})
    return {"env": {**ENV, **env}}, mix
