#!/usr/bin/env python
"""Offline incident-bundle verify/dump (the black box's fsck), on the port.

The PyTorch port's twin of scripts/blackbox_fsck.py: the same flags,
output and exit codes over gubernator_tpu_torch.blackbox (no JAX).  A
bundle either package wrote verifies here.

Reads a gubernator-tpu incident bundle directory (blackbox.py format),
verifies manifest format/version, every file's size + CRC32 against
the manifest table, and every frame log's header + per-record CRC —
exactly the checks scripts/torch_replay.py runs before it will re-drive a
single frame — and prints a summary.  Exit codes are gate-ready:

  0  bundle is complete and checksum-valid
  1  bundle is corrupt / truncated / bit-flipped / wrong version
  2  usage / IO error (missing directory)

Usage:
  python scripts/torch_blackbox_fsck.py /var/lib/gubernator/blackbox/incident-...
  python scripts/torch_blackbox_fsck.py --json BUNDLE_DIR
  python scripts/torch_blackbox_fsck.py --frames BUNDLE_DIR   # per-frame rows
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path", help="incident bundle directory to verify")
    p.add_argument("--json", action="store_true",
                   help="emit the verdict as JSON")
    p.add_argument("--frames", action="store_true",
                   help="include per-frame rows in the dump")
    args = p.parse_args(argv)

    from gubernator_tpu_torch.blackbox import BundleError, load_bundle

    if not os.path.exists(args.path):
        print(f"blackbox_fsck: {args.path}: no such directory",
              file=sys.stderr)
        return 2
    if not os.path.isdir(args.path):
        print(f"blackbox_fsck: {args.path}: not a bundle directory",
              file=sys.stderr)
        return 2
    try:
        bundle = load_bundle(args.path)
    except OSError as e:
        print(f"blackbox_fsck: {args.path}: {e}", file=sys.stderr)
        return 2
    except BundleError as e:
        if args.json:
            print(json.dumps({"ok": False, "path": args.path,
                              "error": str(e)}))
        else:
            print(f"blackbox_fsck: {args.path}: REJECTED: {e}",
                  file=sys.stderr)
        return 1

    m = bundle.manifest
    doc = {
        "ok": True,
        "path": args.path,
        "name": m.get("name", ""),
        "version": m.get("version"),
        "wallNs": m.get("wallNs"),
        "service": m.get("service", {}),
        "triggers": [t.get("kind") for t in m.get("triggers", [])],
        "suppressedTriggers": m.get("suppressedTriggers", 0),
        "files": len(m.get("files", {})),
        "frames": {w: len(recs) for w, recs in bundle.frames.items()},
        "frameBytes": {
            w: sum(len(r[5]) for r in recs)
            for w, recs in bundle.frames.items()
        },
    }
    if args.frames:
        doc["frameRows"] = [
            {"wire": w, "wallNs": r[0], "monoNs": r[1], "dir": r[2],
             "peer": r[3], "kind": r[4], "bytes": len(r[5])}
            for w, recs in sorted(bundle.frames.items()) for r in recs
        ]
    if args.json:
        print(json.dumps(doc, indent=2))
    else:
        frames = " ".join(
            f"{w}:{n}" for w, n in sorted(doc["frames"].items()) if n
        ) or "none"
        print(
            f"{args.path}: OK v{doc['version']} — "
            f"triggers={','.join(doc['triggers']) or 'none'} "
            f"frames=[{frames}] files={doc['files']}"
        )
        if args.frames:
            for row in doc["frameRows"]:
                print(
                    f"  {row['wire']:<9} {row['dir']:<3} kind={row['kind']} "
                    f"peer={row['peer'] or '-'} bytes={row['bytes']} "
                    f"wall_ns={row['wallNs']}"
                )
    return 0


if __name__ == "__main__":
    sys.exit(main())
