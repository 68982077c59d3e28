#!/usr/bin/env python
"""Offline snapshot verify/dump (the durability plane's fsck), on the port.

The PyTorch port's twin of scripts/snapshot_fsck.py: the same flags,
output and exit codes over gubernator_tpu_torch.snapshot (no JAX).  A
snapshot either package wrote verifies here.

Reads a gubernator-tpu snapshot file (snapshot.py format), verifies
magic/version/length/checksum — exactly the checks the boot restore
runs — and prints a summary or a JSON dump.  Exit codes are gate-ready:

  0  file is a complete, checksum-valid snapshot
  1  file is corrupt / truncated / wrong version / wrong ring
  2  usage / IO error (missing file)

Usage:
  python scripts/torch_snapshot_fsck.py /var/lib/gubernator/gub.snap
  python scripts/torch_snapshot_fsck.py --json --keys gub.snap
  python scripts/torch_snapshot_fsck.py --expect-ring 0xDEADBEEF... gub.snap
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path", help="snapshot file to verify")
    p.add_argument("--json", action="store_true",
                   help="emit the verdict (and --keys dump) as JSON")
    p.add_argument("--keys", action="store_true",
                   help="include per-lane key/remaining rows in the dump")
    p.add_argument("--expect-ring", default=None, metavar="HASH",
                   help="strict fencing: fail unless the file's membership "
                        "fingerprint matches (hex or decimal; unfenced "
                        "files always pass)")
    args = p.parse_args(argv)

    from gubernator_tpu_torch.snapshot import SnapshotError, read_snapshot

    expected = int(args.expect_ring, 0) if args.expect_ring else None
    try:
        cols, meta = read_snapshot(args.path, expected_ring=expected)
    except FileNotFoundError:
        print(f"snapshot_fsck: {args.path}: no such file", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"snapshot_fsck: {args.path}: {e}", file=sys.stderr)
        return 2
    except SnapshotError as e:
        if args.json:
            print(json.dumps({"ok": False, "path": args.path,
                              "error": str(e)}))
        else:
            print(f"snapshot_fsck: {args.path}: REJECTED: {e}",
                  file=sys.stderr)
        return 1

    doc = {
        "ok": True,
        "path": args.path,
        "version": meta["version"],
        "lanes": meta["lanes"],
        "bytes": meta["bytes"],
        "savedAtMs": meta["saved_at_ms"],
        "ringHash": format(meta["ring_hash"], "016x"),
    }
    if args.keys:
        doc["rows"] = [
            {
                "key": cols.keys[i],
                "algorithm": int(cols.algorithm[i]),
                "limit": int(cols.limit[i]),
                "remaining": int(cols.remaining[i]),
                "expireAtMs": int(cols.expire_at[i]),
            }
            for i in range(len(cols))
        ]
    if args.json:
        print(json.dumps(doc, indent=2))
    else:
        print(
            f"{args.path}: OK v{doc['version']} — {doc['lanes']} lanes, "
            f"{doc['bytes']} bytes, saved_at_ms={doc['savedAtMs']}, "
            f"ring={doc['ringHash']}"
        )
        if args.keys:
            for row in doc["rows"]:
                print(
                    f"  {row['key']}: remaining={row['remaining']}/"
                    f"{row['limit']} algo={row['algorithm']} "
                    f"expire={row['expireAtMs']}"
                )
    return 0


if __name__ == "__main__":
    sys.exit(main())
