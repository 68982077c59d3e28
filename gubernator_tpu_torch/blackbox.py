"""Incident black box: triggered capture bundles + deterministic replay.

The observability fabric (tracing/saturation/audit/profiling) can
*detect* every failure class the flight recorder dumps on — but the
dump is a log line of spans, and the traffic that caused the incident
evaporates with the moment.  This module turns the GUBC wire choke
points (wire.py kinds 1-7: every byte the daemons exchange flows
through a handful of encode/decode sites) into an always-on bounded
**traffic tap**, and every flight-recorder auto-dump trigger into a
crash-safe on-disk **incident bundle** that `scripts/torch_replay.py`
(and the JAX package's `scripts/replay.py`) can re-drive
deterministically.

The PyTorch port's copy of the JAX package's blackbox.py: the same
rings, triggers, writer and loader, and the same formats byte for byte
(GUBL v1 frame logs, manifest version 1), so a bundle either package
writes loads in the other.  Host code only: no kernel runs here.

Three pieces:

* **Taps** — per-wire byte-budgeted in-memory rings (public / peer /
  global / transfer / region, classified from the frame's kind byte).
  `tap()` records (wall ns, mono ns, direction, peer, kind, raw frame
  bytes); `tap_taken()` reconstructs the kind-5 frames a native-edge
  take batch coalesced (the one choke point that no longer holds the
  original bytes).  Disabled (`GUBER_BLACKBOX=0` or force_disable) the
  tap is one branch per frame — bench-gated like tracing/profiling
  (blackbox_overhead_ratio >= 0.95).

* **Bundles** — `on_trigger` rides tracing.Recorder.dump_hooks: every
  _DUMP_KINDS event (plus POST /debug/incident) wakes an off-thread
  writer that coalesces trigger storms (one bundle, many trigger
  records), rate-limits (min_interval_s), freezes the rings, and
  writes a temp+fsync+rename bundle directory: manifest (triggers,
  stamps, version, knobs, ring fingerprints, fault seed, per-file
  CRCs), per-wire `.gfl` frame logs, span/event snapshots, the
  /debug/status|latency|audit|tenants docs, a metrics scrape, and —
  when the durability plane has one — the state snapshot.  Retention
  is bounded (GUBER_BLACKBOX_RETAIN oldest-pruned).

* **Loader** — `load_bundle()` is the ONE parser replay and
  scripts/torch_blackbox_fsck.py share: manifest format/version, per-file
  CRC32 + size, frame-log header and per-record CRC all verify before
  a single frame is surfaced, so a corrupt bundle can never
  half-replay (BundleError, loudly).

Capture scope: GUBC frames only.  JSON bodies and gRPC protobuf peers
are not tapped (the columnar wire IS the steady-state data plane); the
native express queue answers NO_BATCHING singles entirely in C++ and
those frames never surface to Python — both are documented replay
slack (architecture.md "Incident black box").
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .utils.logging import category_logger

logger = category_logger("blackbox")

# ---------------------------------------------------------------------
# Process-wide switches (the tracing/profiling plane pattern): the
# daemon applies its parsed GUBER_BLACKBOX via set_enabled; library
# embedders get the import-time env default (on).  force_disable is
# the bench's "compiled out" baseline for the overhead gate.
# ---------------------------------------------------------------------
_FORCE_DISABLED: bool = False


def _env_enabled(default: bool = True) -> bool:
    v = os.environ.get("GUBER_BLACKBOX", "").strip().lower()
    if not v:
        return default
    return v not in ("0", "false", "off", "no")


_ENABLED: bool = _env_enabled()


def set_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = bool(flag)


def force_disable(flag: bool) -> None:
    """Bench hook: behave as if the module did not exist (the
    'blackbox-compiled-out' baseline of the overhead gate)."""
    global _FORCE_DISABLED
    _FORCE_DISABLED = bool(flag)


def enabled() -> bool:
    """One branch — the hot-path guard every tap uses."""
    return _ENABLED and not _FORCE_DISABLED


# ---------------------------------------------------------------------
# Wire classification + frame-log codec
# ---------------------------------------------------------------------
#: The five capture rings, one per wire plane; classification is the
#: frame's kind byte (raw[5]) — the same sniff the gateway routes by.
WIRES = ("public", "peer", "global", "transfer", "region")
_KIND_WIRE = {1: "peer", 2: "peer", 3: "global", 4: "transfer",
              5: "public", 6: "public", 7: "region"}

_GUBC_MAGIC = b"GUBC"

#: Frame-log file format: `GUBL | u32 version`, then per record
#: `u32 payload_len | u32 crc32(payload) | payload` where payload is
#: `<QQBBHI` wall_ns, mono_ns, direction (0=in 1=out), kind, peer_len,
#: frame_len, followed by the peer string and the raw frame bytes.
#: Length+CRC per record means truncation and bit flips both reject at
#: the exact record, never as a silently shorter capture.
GFL_MAGIC = b"GUBL"
GFL_VERSION = 1
_REC_HEAD = struct.Struct("<QQBBHI")

BUNDLE_FORMAT = "gubernator-blackbox-bundle"
BUNDLE_VERSION = 1
MANIFEST_NAME = "manifest.json"

#: (wall_ns, mono_ns, direction "in"/"out", peer, kind, frame bytes)
FrameRecord = Tuple[int, int, str, str, int, bytes]


class BundleError(Exception):
    """A bundle failed verification — corrupt, truncated, or from an
    incompatible version.  Loaders raise instead of degrading: a
    half-verified bundle must never half-replay."""


def encode_frame_log(records: List[FrameRecord]) -> bytes:
    parts = [GFL_MAGIC, struct.pack("<I", GFL_VERSION)]
    for wall_ns, mono_ns, direction, peer, kind, frame in records:
        peer_b = peer.encode("utf-8")
        payload = (
            _REC_HEAD.pack(wall_ns, mono_ns,
                           0 if direction == "in" else 1,
                           kind, len(peer_b), len(frame))
            + peer_b + frame
        )
        parts.append(struct.pack("<II", len(payload), zlib.crc32(payload)))
        parts.append(payload)
    return b"".join(parts)


def decode_frame_log(raw: bytes, name: str = "frame log"
                     ) -> List[FrameRecord]:
    """Parse one .gfl file; BundleError on any malformation (wrong
    magic/version, truncated record, CRC mismatch, trailing bytes)."""
    if raw[:4] != GFL_MAGIC:
        raise BundleError(f"{name}: bad magic (not a GUBL frame log)")
    try:
        (version,) = struct.unpack_from("<I", raw, 4)
    except struct.error:
        raise BundleError(f"{name}: truncated header") from None
    if version != GFL_VERSION:
        raise BundleError(
            f"{name}: unsupported frame-log version {version} "
            f"(want {GFL_VERSION})"
        )
    records: List[FrameRecord] = []
    pos = 8
    while pos < len(raw):
        try:
            length, crc = struct.unpack_from("<II", raw, pos)
        except struct.error:
            raise BundleError(f"{name}: truncated record header") from None
        pos += 8
        payload = raw[pos:pos + length]
        if len(payload) != length:
            raise BundleError(f"{name}: truncated record payload")
        if zlib.crc32(payload) != crc:
            raise BundleError(f"{name}: record CRC mismatch")
        pos += length
        try:
            wall_ns, mono_ns, d, kind, peer_len, frame_len = \
                _REC_HEAD.unpack_from(payload, 0)
        except struct.error:
            raise BundleError(f"{name}: malformed record") from None
        body = payload[_REC_HEAD.size:]
        if len(body) != peer_len + frame_len:
            raise BundleError(f"{name}: record length mismatch")
        peer = body[:peer_len].decode("utf-8", errors="replace")
        frame = body[peer_len:]
        records.append(
            (wall_ns, mono_ns, "in" if d == 0 else "out", peer, kind,
             frame)
        )
    return records


# ---------------------------------------------------------------------
# The per-wire capture ring
# ---------------------------------------------------------------------
class _WireRing:
    """Byte-budgeted frame ring: append evicts oldest until under
    budget.  A small lock per record — the tap sites already sit next
    to an HTTP round trip or a device dispatch, and the bench gate
    bounds the total (blackbox_overhead_ratio >= 0.95)."""

    __slots__ = ("budget", "frames", "nbytes", "frames_total",
                 "bytes_total", "_mu")

    def __init__(self, budget: int):
        self.budget = max(int(budget), 1)
        self.frames: List[FrameRecord] = []
        self.nbytes = 0
        self.frames_total = 0  # monotonic, for the metrics counter
        self.bytes_total = 0
        self._mu = threading.Lock()

    def record(self, rec: FrameRecord) -> None:
        nb = len(rec[5]) + len(rec[3]) + 32
        with self._mu:
            self.frames.append(rec)
            self.nbytes += nb
            self.frames_total += 1
            self.bytes_total += nb
            while self.nbytes > self.budget and len(self.frames) > 1:
                old = self.frames.pop(0)
                self.nbytes -= len(old[5]) + len(old[3]) + 32
            if self.nbytes > self.budget:
                # A single frame larger than the whole budget still
                # captures (the incident frame is the point).
                pass

    def freeze(self) -> List[FrameRecord]:
        with self._mu:
            return list(self.frames)

    def stats(self) -> Tuple[int, int, int]:
        with self._mu:
            return len(self.frames), self.nbytes, self.frames_total


def _frames_from_taken(tb) -> List[bytes]:
    """Reconstruct the original kind-5 ingress frames a native take
    batch (gateway.NativeIngressPump) coalesced: the C++ edge parsed
    and freed the original bytes, but the batch keeps every column plus
    per-frame lane counts, so the frames re-encode byte-identically to
    wire.encode_ingress_frame's layout (no trace trailer — the fast
    lane never carries sampled frames).  Must run BEFORE complete():
    the batch's views die inside it."""
    from . import wire as wire_mod

    nf = int(tb.n_frames)
    if nf <= 0:
        return []
    lanes = np.asarray(tb.frame_lanes, dtype=np.int64)
    bounds = np.zeros(nf + 1, dtype=np.int64)
    np.cumsum(lanes, out=bounds[1:])
    no = np.asarray(tb._no, dtype=np.int64)
    uo = np.asarray(tb._uo, dtype=np.int64)
    frames: List[bytes] = []
    for fi in range(nf):
        lo, hi = int(bounds[fi]), int(bounds[fi + 1])
        n = hi - lo
        n_off = (no[lo:hi + 1] - no[lo]).astype(np.uint32)
        n_blob = bytes(tb._nb[no[lo]:no[hi]])
        u_off = (uo[lo:hi + 1] - uo[lo]).astype(np.uint32)
        u_blob = bytes(tb._ub[uo[lo]:uo[hi]])
        frames.append(b"".join((
            _GUBC_MAGIC,
            struct.pack("<BBI", wire_mod.FRAME_VERSION,
                        wire_mod._FRAME_KIND_INGRESS_REQ, n),
            struct.pack("<I", len(n_blob)), n_off.tobytes(), n_blob,
            struct.pack("<I", len(u_blob)), u_off.tobytes(), u_blob,
            np.ascontiguousarray(tb.algorithm[lo:hi], np.int32).tobytes(),
            np.ascontiguousarray(tb.behavior[lo:hi], np.int32).tobytes(),
            np.ascontiguousarray(tb.hits[lo:hi], np.int64).tobytes(),
            np.ascontiguousarray(tb.limit[lo:hi], np.int64).tobytes(),
            np.ascontiguousarray(tb.duration[lo:hi], np.int64).tobytes(),
        )))
    return frames


# ---------------------------------------------------------------------
# The black box
# ---------------------------------------------------------------------
class BlackBox:
    """One per V1Service (the per-instance keying of the flight-
    recorder fix): the five wire rings, the trigger/coalesce/rate-limit
    state, and the off-thread bundle writer.  `service` may be None for
    ring-only unit use (no bundles)."""

    #: Storm-gather window: triggers arriving within this of the first
    #: one land in the SAME bundle as extra trigger records.
    COALESCE_S = 0.25
    #: Minimum spacing between bundles (manual triggers bypass).
    MIN_INTERVAL_S = 30.0
    #: Safety cap on queued trigger records between bundle writes.
    MAX_PENDING = 1000

    def __init__(self, service=None, path: str = "", budget_mb: int = 64,
                 retain: int = 8, enabled: bool = True):
        self.service = service
        self.path = path or ""
        self.retain = max(int(retain), 1)
        self.budget_bytes = max(int(budget_mb), 1) * (1 << 20)
        self._on = bool(enabled)
        per = max(self.budget_bytes // len(WIRES), 4096)
        self.rings: Dict[str, _WireRing] = {w: _WireRing(per) for w in WIRES}
        self.coalesce_s = self.COALESCE_S
        self.min_interval_s = self.MIN_INTERVAL_S
        self._pending: List[dict] = []
        self._suppressed = 0
        self._force = False
        self._trigger_mu = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_bundle_mono: Optional[float] = None
        self._last_trigger_mono: Optional[float] = None
        self.bundles_written = 0
        self._seq = itertools.count(1)
        self._write_mu = threading.Lock()

    # -- taps ----------------------------------------------------------
    def live(self) -> bool:
        """True when taps would record.  For callers whose capture has
        a pre-tap cost (the gRPC transport re-encodes proto columns as
        a canonical GUBC frame) — everyone else just calls tap()."""
        return not _FORCE_DISABLED and self._on and _ENABLED

    def tap(self, direction: str, peer: str, data) -> None:
        """Record one wire frame.  Tolerates non-frame bodies (JSON,
        empty) by sniffing the GUBC magic — callers pass every POST
        body / response without pre-classifying."""
        if _FORCE_DISABLED or not (self._on and _ENABLED):
            return
        if data is None or len(data) < 10 or data[:4] != _GUBC_MAGIC:
            return
        wire_name = _KIND_WIRE.get(data[5])
        if wire_name is None:
            return
        self.rings[wire_name].record(
            (time.time_ns(), time.monotonic_ns(), direction, peer,
             data[5], bytes(data))
        )

    def tap_taken(self, tb) -> None:
        """Native-edge tap: reconstruct and record the kind-5 frames a
        NativeIngressPump take batch coalesced.  Fenced — diagnostics
        must never fail the pump."""
        if _FORCE_DISABLED or not (self._on and _ENABLED):
            return
        try:
            frames = _frames_from_taken(tb)
        except Exception:  # noqa: BLE001
            logger.exception("blackbox native tap failed")
            return
        ring = self.rings["public"]
        wall, mono = time.time_ns(), time.monotonic_ns()
        for frame in frames:
            ring.record((wall, mono, "in", "", 5, frame))

    # -- triggers ------------------------------------------------------
    def on_trigger(self, kind: str, fields: dict) -> None:
        """tracing.Recorder dump hook: queue one trigger record and
        wake the writer.  Never blocks, never raises into the path
        that fired the event."""
        if _FORCE_DISABLED or not (self._on and _ENABLED):
            return
        rec = {
            "kind": kind,
            "wallNs": time.time_ns(),
            "monoNs": time.monotonic_ns(),
            "fields": {
                k: v for k, v in (fields or {}).items()
                if k not in ("kind", "ts_ns")
            },
        }
        with self._trigger_mu:
            self._last_trigger_mono = time.monotonic()
            if len(self._pending) < self.MAX_PENDING:
                self._pending.append(rec)
            else:
                self._suppressed += 1
            self._ensure_thread()
        self._wake.set()

    def trigger_manual(self, reason: str = "") -> dict:
        """POST /debug/incident: operator-requested bundle — queued
        like any trigger but exempt from the rate limit (an operator
        asking for evidence gets it)."""
        with self._trigger_mu:
            self._force = True
        self.on_trigger("manual", {"reason": reason or "operator"})
        return {"accepted": True, "dir": self.path}

    def _ensure_thread(self) -> None:
        # _trigger_mu held.
        if self._thread is None or not self._thread.is_alive():
            if self._stop.is_set():
                return
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="blackbox-writer"
            )
            self._thread.start()

    def _run(self) -> None:
        while True:
            self._wake.wait()
            if self._stop.is_set():
                return
            self._wake.clear()
            # Coalescing gather window: a breaker storm's triggers all
            # land before this expires and share one bundle.
            if self._stop.wait(self.coalesce_s):
                return
            with self._trigger_mu:
                triggers, self._pending = self._pending, []
                force, self._force = self._force, False
                suppressed, self._suppressed = self._suppressed, 0
            if not triggers:
                continue
            now = time.monotonic()
            if (not force and self._last_bundle_mono is not None
                    and now - self._last_bundle_mono < self.min_interval_s):
                with self._trigger_mu:
                    self._suppressed += len(triggers)
                continue
            if not self.path:
                # Rings always run; bundles need a configured dir.
                continue
            self._last_bundle_mono = now
            try:
                self.write_bundle(triggers, suppressed=suppressed)
            except Exception:  # noqa: BLE001
                logger.exception("blackbox bundle write failed")

    # -- bundle write --------------------------------------------------
    def write_bundle(self, triggers: List[dict],
                     suppressed: int = 0) -> str:
        """Freeze the rings and write one crash-safe bundle directory:
        every file fsynced inside a `.tmp-*` dir, manifest (with the
        per-file CRC table) last, then one atomic rename + dir fsync —
        the snapshot.py write discipline, so a reader never sees a
        partial bundle and a crash leaves only a `.tmp-*` to sweep."""
        name = (
            f"incident-{time.strftime('%Y%m%dT%H%M%S', time.gmtime())}"
            f"-{os.getpid()}-{next(self._seq):04d}"
        )
        with self._write_mu:
            frames = {w: self.rings[w].freeze() for w in WIRES}
            files: Dict[str, bytes] = {}
            rings_meta: Dict[str, dict] = {}
            for w in WIRES:
                blob = encode_frame_log(frames[w])
                files[f"wire-{w}.gfl"] = blob
                rings_meta[w] = {
                    "frames": len(frames[w]),
                    "bytes": sum(len(r[5]) for r in frames[w]),
                    "fingerprint": zlib.crc32(
                        b"".join(r[5] for r in frames[w])
                    ),
                }
            for fname, doc in self._service_docs().items():
                files[fname] = doc
            manifest = {
                "format": BUNDLE_FORMAT,
                "version": BUNDLE_VERSION,
                "name": name,
                "wallNs": time.time_ns(),
                "monoNs": time.monotonic_ns(),
                "gubernatorVersion": _pkg_version(),
                "service": self._service_identity(),
                "triggers": triggers,
                "suppressedTriggers": suppressed,
                "knobs": self._knobs(),
                "faultSeed": self._fault_seed(),
                "rings": rings_meta,
                "files": {
                    fname: {"bytes": len(blob),
                            "crc32": zlib.crc32(blob)}
                    for fname, blob in files.items()
                },
            }
            os.makedirs(self.path, exist_ok=True)
            tmp = os.path.join(self.path, f".tmp-{name}")
            final = os.path.join(self.path, name)
            try:
                os.makedirs(tmp, exist_ok=True)
                for fname, blob in files.items():
                    _write_fsync(os.path.join(tmp, fname), blob)
                _write_fsync(
                    os.path.join(tmp, MANIFEST_NAME),
                    json.dumps(manifest, indent=1, default=str)
                    .encode("utf-8"),
                )
                os.replace(tmp, final)
                _fsync_dir(self.path)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            self.bundles_written += 1
            logger.warning(
                "blackbox bundle written dir=%s triggers=%s", final,
                [t["kind"] for t in triggers],
            )
            self._prune()
            return final

    def _service_docs(self) -> Dict[str, bytes]:
        """The debug-surface snapshots, each independently fenced — a
        failing section costs that file, never the bundle."""
        svc = self.service
        docs: Dict[str, bytes] = {}
        if svc is None:
            return docs
        from . import saturation, tracing

        def _put(fname, fn):
            try:
                docs[fname] = json.dumps(fn(), default=str).encode("utf-8")
            except Exception:  # noqa: BLE001
                logger.exception("blackbox %s snapshot failed", fname)

        recs = [r for r in (getattr(svc, "recorder", None),
                            tracing.default_recorder()) if r is not None]
        _put("spans.json", lambda: tracing.spans_snapshot(recorders=recs))
        _put("events.json", lambda: tracing.events_snapshot(recorders=recs))
        _put("status.json", svc.debug_status)
        _put("latency.json", lambda: {
            "phases": saturation.phase_snapshot(),
            "express": saturation.express_snapshot(),
            "slo": svc.slo.snapshot(),
        })
        _put("audit.json", svc.auditor.snapshot)
        _put("tenants.json", svc.tenants.snapshot)
        try:
            # The gateway /metrics collect-on-scrape discipline: refresh
            # the scrape-time families under the scrape lock, render.
            m = svc.metrics
            with m.scrape_lock:
                m.observe_cache(svc.store)
                m.observe_dispatch(svc.store)
                m.observe_saturation(svc)
                m.observe_telemetry(getattr(svc.store, "device", None))
                m.observe_audit(svc)
                m.observe_cost(svc)
                m.observe_native_ingress(svc)
                m.observe_blackbox(svc)
                docs["metrics.prom"] = m.render()
        except Exception:  # noqa: BLE001
            logger.exception("blackbox metrics scrape failed")
        try:
            snap_path = getattr(svc.conf, "snapshot_path", "")
            if snap_path and os.path.exists(snap_path):
                with open(snap_path, "rb") as f:
                    docs["state.snap"] = f.read()
        except Exception:  # noqa: BLE001
            logger.exception("blackbox state-snapshot copy failed")
        return docs

    def _service_identity(self) -> dict:
        svc = self.service
        if svc is None:
            return {}
        rec = getattr(svc, "recorder", None)
        return {
            "advertiseAddress": getattr(svc.conf, "advertise_address", ""),
            "dataCenter": getattr(svc.conf, "data_center", ""),
            "recorder": getattr(rec, "name", ""),
            "pid": os.getpid(),
        }

    def _knobs(self) -> dict:
        svc = self.service
        if svc is None:
            return {}
        import dataclasses

        try:
            b = dataclasses.asdict(svc.conf.behaviors)
        except Exception:  # noqa: BLE001
            return {}
        return {
            k: v for k, v in b.items()
            if isinstance(v, (bool, int, float, str))
        }

    def _fault_seed(self):
        from . import faults as faults_mod

        plan = None
        if self.service is not None:
            plan = getattr(self.service.conf, "fault_plan", None)
        if plan is None:
            plan = faults_mod.active()
        return getattr(plan, "seed", None)

    def _prune(self) -> None:
        try:
            keep = list_bundles(self.path)
            for name in keep[:-self.retain]:
                shutil.rmtree(
                    os.path.join(self.path, name), ignore_errors=True
                )
            # Sweep crash leftovers: a `.tmp-*` older than a minute is
            # a dead writer's partial bundle.
            for entry in os.listdir(self.path):
                if entry.startswith(".tmp-"):
                    p = os.path.join(self.path, entry)
                    if time.time() - os.path.getmtime(p) > 60:
                        shutil.rmtree(p, ignore_errors=True)
        except OSError:
            pass

    # -- status / lifecycle -------------------------------------------
    def snapshot(self) -> dict:
        """The `blackbox` section of GET /debug/status (fed to
        scripts/cluster_status.py's blackbox column)."""
        ring_frames, ring_bytes = {}, {}
        for w, ring in self.rings.items():
            n, nb, _total = ring.stats()
            ring_frames[w] = n
            ring_bytes[w] = nb
        on_disk = len(list_bundles(self.path)) if self.path else 0
        age = None
        if self._last_trigger_mono is not None:
            age = round(time.monotonic() - self._last_trigger_mono, 1)
        return {
            "enabled": bool(self._on and _ENABLED and not _FORCE_DISABLED),
            "dir": self.path,
            "bundles": self.bundles_written,
            "bundlesOnDisk": on_disk,
            "lastTriggerAgeS": age,
            "ringFrames": ring_frames,
            "ringBytes": ring_bytes,
            "ringBudgetBytes": self.budget_bytes,
            "suppressedTriggers": self._suppressed,
        }

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)


# ---------------------------------------------------------------------
# Bundle loading (shared by replay + fsck)
# ---------------------------------------------------------------------
class Bundle:
    """A fully-verified on-disk incident bundle."""

    def __init__(self, path: str, manifest: dict,
                 frames: Dict[str, List[FrameRecord]]):
        self.path = path
        self.manifest = manifest
        self.frames = frames

    def doc(self, name: str):
        """Parse one of the bundle's JSON documents (status.json,
        audit.json, ...); None when the bundle omitted it."""
        p = os.path.join(self.path, name)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return json.loads(f.read())

    def merged_records(self) -> List[FrameRecord]:
        """Every captured frame across all wires in capture (monotonic
        stamp) order — the replay drive order."""
        out: List[FrameRecord] = []
        for recs in self.frames.values():
            out.extend(recs)
        out.sort(key=lambda r: r[1])
        return out


def list_bundles(path: str) -> List[str]:
    try:
        return sorted(
            e for e in os.listdir(path)
            if e.startswith("incident-")
            and os.path.isdir(os.path.join(path, e))
        )
    except OSError:
        return []


def load_bundle(path: str) -> Bundle:
    """Open + verify one bundle directory; BundleError on ANY defect —
    missing/corrupt manifest, wrong format/version, per-file size or
    CRC mismatch, malformed frame log.  Verification is total before
    any frame is surfaced (the no-half-replay contract)."""
    mp = os.path.join(path, MANIFEST_NAME)
    try:
        with open(mp, "rb") as f:
            manifest = json.loads(f.read())
    except OSError as e:
        raise BundleError(f"manifest unreadable: {e}") from e
    except ValueError as e:
        raise BundleError(f"manifest corrupt: {e}") from e
    if not isinstance(manifest, dict):
        raise BundleError("manifest corrupt: not an object")
    if manifest.get("format") != BUNDLE_FORMAT:
        raise BundleError(
            f"not a blackbox bundle (format={manifest.get('format')!r})"
        )
    if manifest.get("version") != BUNDLE_VERSION:
        raise BundleError(
            f"unsupported bundle version {manifest.get('version')!r} "
            f"(want {BUNDLE_VERSION})"
        )
    table = manifest.get("files")
    if not isinstance(table, dict):
        raise BundleError("manifest corrupt: missing files table")
    blobs: Dict[str, bytes] = {}
    for fname, meta in table.items():
        fp = os.path.join(path, fname)
        try:
            with open(fp, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise BundleError(f"{fname}: unreadable: {e}") from e
        if len(blob) != meta.get("bytes"):
            raise BundleError(
                f"{fname}: size mismatch (have {len(blob)}, manifest "
                f"says {meta.get('bytes')}) — truncated or tampered"
            )
        if zlib.crc32(blob) != meta.get("crc32"):
            raise BundleError(f"{fname}: CRC mismatch — corrupt")
        blobs[fname] = blob
    frames: Dict[str, List[FrameRecord]] = {}
    for w in WIRES:
        fname = f"wire-{w}.gfl"
        if fname in blobs:
            frames[w] = decode_frame_log(blobs[fname], name=fname)
        else:
            frames[w] = []
    return Bundle(path, manifest, frames)


# ---------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------
def _write_fsync(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _pkg_version() -> str:
    try:
        from . import __version__

        return __version__
    except Exception:  # noqa: BLE001
        return "unknown"
