#!/usr/bin/env python
"""Multi-daemon incident stitcher: merge black-box bundles into one
fleet-level incident timeline, on the port.

The PyTorch port's twin of scripts/incident_collect.py: the same flags,
output and exit codes over gubernator_tpu_torch.blackbox (no JAX).
Bundles from port and JAX nodes stitch into one timeline.

A cluster incident writes one bundle PER DAEMON (each V1Service owns
its own black box).  This script takes the bundle directories from
every involved daemon — or a parent directory holding several
GUBER_BLACKBOX_DIR trees — verifies each (the replay/fsck loader, so
a corrupt bundle rejects instead of polluting the timeline), and
stitches:

* **Triggers** across daemons, merged by wall clock: which daemon
  dumped first, and what cascade followed.
* **Wire frames** across daemons, merged by wall clock with their
  direction + peer: daemon A's "out" to B pairs with B's "in" from A,
  so a double-delivery or a lost frame is visible as an unpaired edge.
* **Trace ids** across span snapshots (the trace_collect.py rule): a
  trace that appears in more than one bundle marks the request chains
  that crossed the incident.

Usage:
    python scripts/torch_incident_collect.py BUNDLE_DIR [BUNDLE_DIR ...]
    python scripts/torch_incident_collect.py --scan /var/lib/gubernator/bb/
    python scripts/torch_incident_collect.py --json BUNDLE_DIR ...

Exit code: 0 when every named bundle verified and at least one was
stitched; 1 when any bundle was rejected or none were found.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _scan(root: str) -> list:
    """Find incident-* bundle dirs anywhere under `root` (each daemon
    points GUBER_BLACKBOX_DIR at its own subdirectory)."""
    found = []
    for dirpath, dirnames, _files in os.walk(root):
        for d in list(dirnames):
            if d.startswith("incident-"):
                found.append(os.path.join(dirpath, d))
                dirnames.remove(d)  # bundles don't nest
    return sorted(found)


def collect(paths: list) -> dict:
    """Load + verify every bundle; return the stitched incident doc."""
    from gubernator_tpu_torch.blackbox import BundleError, load_bundle

    bundles, rejected = [], []
    for p in paths:
        try:
            bundles.append(load_bundle(p))
        except BundleError as e:
            rejected.append({"path": p, "error": str(e)})
    triggers = []
    frames = []
    traces: dict = {}
    for b in bundles:
        daemon = (
            b.manifest.get("service", {}).get("advertiseAddress", "")
            or b.manifest.get("name", b.path)
        )
        for t in b.manifest.get("triggers", []):
            triggers.append({
                "daemon": daemon,
                "kind": t.get("kind", "?"),
                "wallNs": t.get("wallNs", 0),
                "fields": t.get("fields", {}),
            })
        for wire_name, recs in b.frames.items():
            for wall_ns, _mono_ns, direction, peer, kind, frame in recs:
                frames.append({
                    "daemon": daemon, "wire": wire_name,
                    "dir": direction, "peer": peer, "kind": kind,
                    "bytes": len(frame), "wallNs": wall_ns,
                })
        spans_doc = b.doc("spans.json") or []
        for span in spans_doc:
            tid = span.get("trace_id")
            if tid:
                traces.setdefault(tid, set()).add(daemon)
    triggers.sort(key=lambda t: t["wallNs"])
    frames.sort(key=lambda f: f["wallNs"])
    cross = {
        tid: sorted(daemons)
        for tid, daemons in traces.items() if len(daemons) > 1
    }
    return {
        "bundles": [b.manifest.get("name", b.path) for b in bundles],
        "rejected": rejected,
        "triggers": triggers,
        "frames": frames,
        "crossDaemonTraces": cross,
        "firstTrigger": triggers[0] if triggers else None,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("bundles", nargs="*", metavar="BUNDLE_DIR",
                   help="incident bundle directories to stitch")
    p.add_argument("--scan", metavar="DIR", default="",
                   help="also stitch every incident-* dir under DIR")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the raw stitched doc")
    p.add_argument("--frames", action="store_true",
                   help="include the merged frame timeline in the table "
                        "output")
    args = p.parse_args(argv)

    paths = list(args.bundles)
    if args.scan:
        paths.extend(_scan(args.scan))
    paths = sorted(set(paths))
    if not paths:
        print("incident_collect: no bundles named or found", file=sys.stderr)
        return 1
    doc = collect(paths)
    if args.as_json:
        print(json.dumps(doc, indent=2))
    else:
        print(f"bundles: {len(doc['bundles'])} "
              f"(rejected: {len(doc['rejected'])})")
        for r in doc["rejected"]:
            print(f"  REJECTED {r['path']}: {r['error']}")
        print("trigger timeline:")
        t0 = doc["triggers"][0]["wallNs"] if doc["triggers"] else 0
        for t in doc["triggers"]:
            dt_ms = (t["wallNs"] - t0) / 1e6
            print(f"  +{dt_ms:9.1f}ms  {t['daemon']:<22} {t['kind']} "
                  f"{t['fields'] or ''}")
        if doc["crossDaemonTraces"]:
            print("cross-daemon traces:")
            for tid, daemons in sorted(doc["crossDaemonTraces"].items()):
                print(f"  {tid}: {' '.join(daemons)}")
        if args.frames:
            print("frame timeline:")
            for f in doc["frames"]:
                dt_ms = (f["wallNs"] - t0) / 1e6 if t0 else 0.0
                print(
                    f"  +{dt_ms:9.1f}ms  {f['daemon']:<22} {f['dir']:<3} "
                    f"{f['wire']}/k{f['kind']} peer={f['peer'] or '-'} "
                    f"{f['bytes']}B"
                )
    return 1 if (doc["rejected"] or not doc["bundles"]) else 0


if __name__ == "__main__":
    sys.exit(main())
