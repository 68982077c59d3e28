#!/usr/bin/env python
"""Deterministic incident replay from a black-box bundle, on the port.

The PyTorch port's twin of scripts/replay.py: the same flags, report
and exit codes, over gubernator_tpu_torch (no JAX), plus `--device`
(default `cuda`: the replayed service's store runs the CUDA kernels on
the card, and never falls back to the CPU; `cpu` runs their plain
versions).  A bundle either package wrote replays here, and the report
is byte-identical to the JAX script's for the same bundle.

Boots a fresh single daemon (in-process V1Service + gateway, no
sockets) from an incident bundle (blackbox.py): restores the captured
state snapshot when the bundle carries one, freezes the service clock
to the captured wall stamps, re-drives every captured INBOUND frame
through the real gateway router in capture order, and reconstructs the
sender-side conservation ledger from the captured OUTBOUND frames —
a FaultPlan DUPLICATE that double-delivered a forward during the
incident re-appears as byte-identical back-to-back outbound frames
and re-fires the same `forward_conservation` violation through the
real Auditor.  The final report is normalized (frame counts, response
status tally, CRC32 over every response body, violations) so two
replays of one bundle are byte-identical — the determinism oracle
tests/test_blackbox.py and tests/test_torch_replay.py assert.

Determinism contract + slack (architecture.md "Incident black box"):
frames replay sequentially on one thread against a frozen clock, so
batching, bucket math and reset stamps reproduce; capture slack —
native express-lane singles answered in C++, gRPC/JSON peer bodies,
and frames evicted from the byte-budgeted rings — replays as absent
traffic, and identical back-to-back outbound frames are indistinguish-
able from a real duplicate by design.

Usage:
  python scripts/torch_replay.py BUNDLE_DIR                   # replay + report
  python scripts/torch_replay.py --pace original BUNDLE_DIR   # captured pacing
  python scripts/torch_replay.py --twice BUNDLE_DIR           # determinism check
  python scripts/torch_replay.py --to-test out_test.py BUNDLE_DIR
  python scripts/torch_replay.py --smoke --device cpu         # self-contained CI

Exit codes: 0 replay ran (and, with --twice, was deterministic; when
the bundle recorded audit violations, they reproduced); 1 the bundle
failed verification or the replay diverged; 2 usage/IO error.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import zlib

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

#: Captured inbound frame kind -> the gateway path that serves it.
#: Inbound kinds 2/6 are responses this daemon RECEIVED as a client —
#: not driveable (their requests replay on the daemon that served
#: them; scripts/incident_collect.py pairs the two sides).
ENDPOINT_BY_KIND = {
    5: "/v1/GetRateLimits",
    1: "/v1/peer.GetPeerRateLimits",
    3: "/v1/peer.UpdatePeerGlobals",
    4: "/v1/peer.TransferOwnership",
    7: "/v1/peer.UpdateRegionColumns",
}

#: Outbound kinds whose sender-side conservation ledger replay
#: reconstructs: kind -> (wire counter, admitted counter).
LEDGER_BY_KIND = {
    1: ("forward_wire_hits", "forward_admitted_hits"),
    7: ("region_wire_hits", "region_admitted_hits"),
}


def _frame_hits(raw: bytes) -> int:
    from gubernator_tpu_torch import wire

    try:
        kind = raw[5]
        cols = (
            wire.decode_region_frame(raw) if kind == 7
            else wire.decode_columns_frame(raw)
        )
        return int(sum(int(h) for h in cols.hits))
    except Exception:  # noqa: BLE001 — unreconstructable frame
        return 0


def replay_bundle(bundle_path: str, pace: str = "fast",
                  device: str = "cuda") -> dict:
    """Replay one bundle on `device`; returns the normalized report
    dict.  Raises blackbox.BundleError if the bundle fails verification
    (nothing is driven — the no-half-replay contract)."""
    from gubernator_tpu_torch import audit, blackbox, gateway, tracing
    from gubernator_tpu_torch.config import BehaviorConfig
    from gubernator_tpu_torch.service import ServiceConfig, V1Service
    from gubernator_tpu_torch.utils.clock import Clock

    bundle = blackbox.load_bundle(bundle_path)
    records = bundle.merged_records()

    # The replayed daemon's config: the captured scalar knobs on top of
    # defaults, with the observability feedback loops forced off — the
    # replay must not write bundles about itself, and the audit verdict
    # comes from ONE deterministic check_now() at the end, not a timer.
    behaviors = BehaviorConfig()
    for k, v in bundle.manifest.get("knobs", {}).items():
        if hasattr(behaviors, k) and isinstance(
            getattr(behaviors, k), (bool, int, float, str)
        ):
            setattr(behaviors, k, type(getattr(behaviors, k))(v))
    behaviors.audit = False
    behaviors.blackbox = False
    behaviors.snapshot_interval_s = 0.0

    clock = Clock()
    first_wall_ms = records[0][0] // 1_000_000 if records else int(
        bundle.manifest.get("wallNs", time.time_ns()) // 1_000_000
    )
    clock.freeze(first_wall_ms)

    tmp_state = None
    snapshot_path = ""
    if os.path.exists(os.path.join(bundle_path, "state.snap")):
        # Restore the captured device state: boot from the exact
        # counters the incident daemon held at bundle-write time.
        tmp_state = tempfile.mkdtemp(prefix="gubernator-replay-")
        snapshot_path = os.path.join(tmp_state, "state.snap")
        shutil.copyfile(
            os.path.join(bundle_path, "state.snap"), snapshot_path
        )

    audit.reset()
    svc = V1Service(ServiceConfig(
        cache_size=4096,
        behaviors=behaviors,
        advertise_address=(
            bundle.manifest.get("service", {}).get("advertiseAddress", "")
            or "replay:0"
        ),
        clock=clock,
        snapshot_path=snapshot_path,
        device=device,
    ))
    try:
        svc.set_peers([])  # everything owned locally: no re-forwarding
        tracing.bind_recorder(svc.recorder)
        svc.auditor.check_now()  # seed the extent table (zero traffic)

        driven: dict = {}
        skipped = 0
        statuses: dict = {}
        body_crc = 0
        reconstructed: dict = {}
        last_out: dict = {}
        prev_mono = records[0][1] if records else 0
        last_ms = first_wall_ms
        for wall_ns, mono_ns, direction, peer, kind, frame in records:
            if pace == "original" and mono_ns > prev_mono:
                time.sleep(min((mono_ns - prev_mono) / 1e9, 0.25))
            prev_mono = mono_ns
            # The frozen clock tracks the CAPTURED wall stamps: bucket
            # expiry and reset math replay exactly as they ran.
            rec_ms = wall_ns // 1_000_000
            if rec_ms > last_ms:
                clock.advance(rec_ms - last_ms)
                last_ms = rec_ms
            if direction == "out":
                counters = LEDGER_BY_KIND.get(kind)
                if counters is not None:
                    wire_c, admitted_c = counters
                    hits = _frame_hits(frame)
                    audit.note(wire_c, hits)
                    # Byte-identical back-to-back frames to one peer =
                    # the captured signature of a redelivery: wire-side
                    # only, which re-creates the original excess.
                    if last_out.get((kind, peer)) != frame:
                        audit.note(admitted_c, hits)
                    last_out[(kind, peer)] = frame
                    for c in counters:
                        reconstructed[c] = int(
                            audit.ledger_snapshot().get(c, 0)
                        )
                continue
            endpoint = ENDPOINT_BY_KIND.get(kind)
            if endpoint is None:
                skipped += 1
                continue
            status, _ctype, body = gateway.handle_request(
                svc, "POST", endpoint, frame
            )
            wire_name = blackbox._KIND_WIRE.get(kind, "?")  # noqa: SLF001
            driven[wire_name] = driven.get(wire_name, 0) + 1
            statuses[str(status)] = statuses.get(str(status), 0) + 1
            body_crc = zlib.crc32(body, body_crc)

        svc.auditor.check_now()
        violations = dict(svc.auditor.violations)
        bundle_audit = bundle.doc("audit.json") or {}
        bundle_violations = {
            k: v for k, v in (bundle_audit.get("violations") or {}).items()
            if v
        }
        return {
            "bundle": bundle.manifest.get("name", ""),
            "framesCaptured": {
                w: len(recs) for w, recs in bundle.frames.items()
            },
            "driven": driven,
            "skippedResponses": skipped,
            "responseStatuses": statuses,
            "responseCrc32": body_crc,
            "reconstructedLedger": reconstructed,
            "violations": violations,
            "bundleViolations": bundle_violations,
            # The acceptance verdict: every invariant the live incident
            # tripped re-trips under replay.
            "reproducesBundleViolations": set(bundle_violations)
            <= set(violations),
        }
    finally:
        svc.close()
        if tmp_state is not None:
            shutil.rmtree(tmp_state, ignore_errors=True)


def emit_test(bundle_path: str, out_path: str, device: str = "cuda") -> None:
    """--to-test: write a pytest regression file that replays the
    bundle twice on `device` and pins the determinism + violation-reproduction
    verdicts — a production incident turned into a repo test."""
    bundle_path = os.path.abspath(bundle_path)
    src = f'''"""Auto-generated incident regression (scripts/torch_replay.py --to-test).

Replays the captured bundle twice and asserts (1) the replay is
deterministic (byte-identical normalized reports) and (2) every audit
invariant the live incident tripped re-trips under replay.
"""

import json
import os

import pytest

BUNDLE = {bundle_path!r}
DEVICE = {device!r}


@pytest.mark.skipif(
    not os.path.isdir(BUNDLE), reason="incident bundle not present"
)
def test_incident_replays_deterministically():
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from scripts.torch_replay import replay_bundle

    first = replay_bundle(BUNDLE, device=DEVICE)
    second = replay_bundle(BUNDLE, device=DEVICE)
    assert json.dumps(first, sort_keys=True) == json.dumps(
        second, sort_keys=True
    )
    assert first["reproducesBundleViolations"], (
        first["violations"], first["bundleViolations"]
    )
'''
    with open(out_path, "w") as f:
        f.write(src)


def run_smoke(device: str = "cuda") -> int:
    """--smoke: synthesize a bundle carrying a
    duplicated forward (the FaultPlan DUPLICATE signature), replay it
    twice, and require determinism + the reproduced violation."""
    import numpy as np

    from gubernator_tpu_torch import blackbox, wire

    workdir = tempfile.mkdtemp(prefix="gubernator-replay-smoke-")
    try:
        bb = blackbox.BlackBox(service=None, path=workdir, budget_mb=4)
        ingress = wire.encode_ingress_frame((
            ["smoke"], ["k1"],
            np.zeros(1, np.int32), np.zeros(1, np.int32),
            np.ones(1, np.int64), np.full(1, 10, np.int64),
            np.full(1, 60_000, np.int64),
        ))
        forward = wire.encode_columns_frame((
            ["smoke"], ["k2"],
            np.zeros(1, np.int32), np.zeros(1, np.int32),
            np.full(1, 3, np.int64), np.full(1, 10, np.int64),
            np.full(1, 60_000, np.int64),
        ))
        bb.tap("in", "", ingress)
        bb.tap("out", "peer-b", forward)
        bb.tap("out", "peer-b", forward)  # the duplicate delivery
        bundle_dir = bb.write_bundle(
            [{"kind": "manual", "wallNs": time.time_ns(),
              "monoNs": time.monotonic_ns(), "fields": {}}]
        )
        # The synthetic incident has no audit.json; pin the expectation
        # the live auto-dump path records, so the replay verdict is
        # exercised end to end.
        first = replay_bundle(bundle_dir, device=device)
        second = replay_bundle(bundle_dir, device=device)
        if json.dumps(first, sort_keys=True) != json.dumps(
            second, sort_keys=True
        ):
            print("replay-smoke: NONDETERMINISTIC", file=sys.stderr)
            print(json.dumps(first, indent=2), file=sys.stderr)
            print(json.dumps(second, indent=2), file=sys.stderr)
            return 1
        ok = (
            first["violations"].get("forward_conservation", 0) >= 1
            and first["driven"].get("public") == 1
            and first["responseStatuses"].get("200") == 1
        )
        if not ok:
            print("replay-smoke: violation not reproduced", file=sys.stderr)
            print(json.dumps(first, indent=2), file=sys.stderr)
            return 1
        print(
            "replay-smoke: OK — deterministic, forward_conservation "
            f"excess reproduced (report crc={first['responseCrc32']})"
        )
        return 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("bundle", nargs="?", help="incident bundle directory")
    p.add_argument("--pace", choices=("fast", "original"), default="fast",
                   help="fast = back-to-back (default); original = sleep "
                        "the captured inter-frame gaps (capped 250ms)")
    p.add_argument("--twice", action="store_true",
                   help="replay twice and fail unless byte-identical")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the raw report JSON")
    p.add_argument("--to-test", metavar="FILE", default="",
                   help="also emit a pytest regression file")
    p.add_argument("--smoke", action="store_true",
                   help="self-contained synthesize+replay CI check")
    p.add_argument("--device", default="cuda",
                   help="the replayed store's device: cuda (default, the "
                        "kernels on the card) or cpu (their plain versions)")
    args = p.parse_args(argv)

    if args.smoke:
        return run_smoke(args.device)
    if not args.bundle:
        p.error("BUNDLE_DIR required (or --smoke)")
    if not os.path.isdir(args.bundle):
        print(f"replay: {args.bundle}: no such bundle directory",
              file=sys.stderr)
        return 2

    from gubernator_tpu_torch.blackbox import BundleError

    try:
        report = replay_bundle(args.bundle, pace=args.pace,
                               device=args.device)
        if args.twice:
            again = replay_bundle(args.bundle, pace=args.pace,
                                  device=args.device)
            if json.dumps(report, sort_keys=True) != json.dumps(
                again, sort_keys=True
            ):
                print("replay: NONDETERMINISTIC across two replays",
                      file=sys.stderr)
                return 1
    except BundleError as e:
        print(f"replay: {args.bundle}: REJECTED: {e}", file=sys.stderr)
        return 1

    if args.to_test:
        emit_test(args.bundle, args.to_test, device=args.device)
        print(f"replay: wrote regression test {args.to_test}")

    if args.as_json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        drv = " ".join(f"{w}:{n}" for w, n in sorted(report["driven"].items()))
        vio = (
            ", ".join(
                f"{k}x{v}" for k, v in sorted(report["violations"].items())
            ) or "none"
        )
        print(
            f"{args.bundle}: replayed [{drv or 'nothing'}] "
            f"statuses={report['responseStatuses']} "
            f"crc={report['responseCrc32']:#010x} violations={vio} "
            f"reproduces-bundle="
            f"{report['reproducesBundleViolations']}"
        )
    if report["bundleViolations"] and not report["reproducesBundleViolations"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
