"""Build-at-first-use of the port's native sources.

Both native pieces of the port — the C++ host runtime (g++) and the
CUDA kernels (nvcc) — are compiled from the package's own sources into
`gubernator_tpu_torch/_build/` (listed in .gitignore) the first time a
process needs them.  The output name carries a digest of the sources
and the command, so an edited source or flag builds a new library and
a stale one is never loaded; each build that runs is reported to
telemetry.py with its wall time.  An exclusive file lock serialises
concurrent builds (test workers, two stores in one process); each
writes to a unique temporary name and renames it into place.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import time
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


def _run_all(name: str, cmds: Sequence[Sequence[str]], timeout_s: float) -> list:
    """Run `cmds` as concurrent processes; returns their output (stdout
    and stderr merged) in order.  Raises RuntimeError with the output of
    the first that failed; kills every process on a timeout."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=timeout_s)[0] for p in procs]
    except (OSError, subprocess.SubprocessError) as e:
        for p in procs:
            p.kill()
            p.wait()
        raise RuntimeError(f"{name}: build failed to run: {e}") from e
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{name}: build failed ({p.returncode}):\n{out}")
    return outs


def build_library(name: str, sources: Sequence[str], cmd: Sequence[str],
                  deps: Sequence[str] = (), timeout_s: float = 600.0,
                  log: "list | None" = None,
                  link: "Sequence[str] | None" = None) -> str:
    """Compile `sources` (plus headers `deps`, hashed but not passed)
    with `cmd + sources + ['-o', out]` unless an up-to-date library
    exists; returns its path.  With `link`, every source is compiled to
    an object of its own by `cmd + ['-c', source, '-o', obj]`, one
    compiler process per source, all started together, and the objects
    are linked by `link + objects + ['-o', out]`.  The compilers' output
    of a build that ran is appended to `log` when given.  Raises
    RuntimeError with the compiler's output when the build fails."""
    path = library_path(name, list(sources) + list(deps), [*cmd, *(link or ())])
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):  # built by the holder we waited for
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        if link is None:
            steps = [[[*cmd, *sources, "-o", tmp]]]
            objects = []
        else:
            objects = [f"{tmp}.{i}.o" for i in range(len(sources))]
            steps = [[[*cmd, "-c", src, "-o", obj] for src, obj in zip(sources, objects)],
                     [[*link, *objects, "-o", tmp]]]
        t0 = time.perf_counter()
        try:
            for step in steps:
                outs = _run_all(name, step, timeout_s)
                if log is not None:
                    log.extend(outs)
        finally:
            for obj in objects:
                if os.path.exists(obj):
                    os.remove(obj)
        os.replace(tmp, path)
    from .. import telemetry

    telemetry.note_program_created(f"build:{name}")
    telemetry.note_compile(f"build:{name}", time.perf_counter() - t0)
    return path
