"""Build-at-first-use of the port's native sources.

Both native pieces of the port — the C++ host runtime (g++) and the
CUDA kernels (nvcc) — are compiled from the package's own sources into
`gubernator_tpu_torch/_build/` (listed in .gitignore) the first time a
process needs them.  The output name carries a digest of the sources
and the command, so an edited source or flag builds a new library and
a stale one is never loaded.  An exclusive file lock serialises
concurrent builds (test workers, two stores in one process); each
writes to a unique temporary name and renames it into place.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from typing import Sequence

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)


def library_path(name: str, sources: Sequence[str], cmd: Sequence[str]) -> str:
    """Where `name` built from `sources` by `cmd` lives (built or not)."""
    h = hashlib.sha256(" ".join(cmd).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def build_library(name: str, sources: Sequence[str], cmd: Sequence[str],
                  deps: Sequence[str] = (), timeout_s: float = 600.0,
                  log: "list | None" = None) -> str:
    """Compile `sources` (plus headers `deps`, hashed but not passed)
    with `cmd + sources + ['-o', out]` unless an up-to-date library
    exists; returns its path.  The compiler's output of a build that
    ran is appended to `log` when given.  Raises RuntimeError with the
    compiler's output when the build fails."""
    path = library_path(name, list(sources) + list(deps), cmd)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):  # built by the holder we waited for
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run(
                [*cmd, *sources, "-o", tmp],
                capture_output=True, text=True, timeout=timeout_s,
            )
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"{name}: build failed to run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"{name}: build failed ({proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, path)
        if log is not None:
            log.append(proc.stdout + proc.stderr)
    return path
