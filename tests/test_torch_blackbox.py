"""The incident black box: the port against the JAX package.

`gubernator_tpu_torch/blackbox.py` and its taps, held to
`gubernator_tpu/blackbox.py` at tolerance 0:

* the frame-log codec (GUBL v1): the same seeded records encode to the
  same bytes and decode across the packages; a bundle either package
  wrote loads in both, and each corruption of the JAX suite is rejected
  with the same message by both loaders, both fsck scripts and the
  port's replay;
* the rings and triggers: budget eviction, kind classification and the
  magic sniff, force_disable, storm coalescing, the rate limit and its
  manual bypass, retention;
* the edges: the same seeded traffic through the stdlib handler, the
  async handler and the native pump leaves the same (direction, peer,
  kind, bytes) sequence in every ring; `_frames_from_taken` rebuilds the
  frames a native take coalesced; with the box off the wire bytes are
  the same and the rings stay dark;
* the surfaces: POST /debug/incident (403, 409, 202), the `blackbox`
  section of /debug/status, the `gubernator_blackbox_*` values on
  /metrics, the daemon's GUBER_BLACKBOX switch, a daemon booted with
  GUBER_BLACKBOX_DIR, scripts/cluster_status.py's blackbox column and
  scripts/trace_collect.py against port nodes;
* the other scripts' port twins (torch_blackbox_fsck,
  torch_incident_collect, torch_snapshot_fsck): the JAX script's exit
  code and output on the same inputs.

Every wait and join has a bound.
"""

from __future__ import annotations

import importlib.util
import json
import os
import socket
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from gubernator_tpu import blackbox as jbb
from gubernator_tpu import config as jcfg
from gubernator_tpu import gateway as jgw
from gubernator_tpu import snapshot as jsnap
from gubernator_tpu import tracing as jtracing
from gubernator_tpu import wire as jwire
from gubernator_tpu.config import BehaviorConfig as JBehaviors
from gubernator_tpu.daemon import Daemon as JDaemon
from gubernator_tpu.service import ServiceConfig as JConfig
from gubernator_tpu.service import V1Service as JService
from gubernator_tpu.types import PeerInfo as JPeer
from gubernator_tpu.utils.clock import Clock
from gubernator_tpu_torch import blackbox as tbb
from gubernator_tpu_torch import config as tcfg
from gubernator_tpu_torch import gateway as tgw
from gubernator_tpu_torch import native as tnative
from gubernator_tpu_torch import snapshot as tsnap
from gubernator_tpu_torch import tracing as ttracing
from gubernator_tpu_torch import wire as twire
from gubernator_tpu_torch.config import BehaviorConfig as TBehaviors
from gubernator_tpu_torch.daemon import Daemon as TDaemon
from gubernator_tpu_torch.reshard import TransferColumns
from gubernator_tpu_torch.service import ServiceConfig as TConfig
from gubernator_tpu_torch.service import V1Service as TService
from gubernator_tpu_torch.types import PeerInfo as TPeer
from tests.test_snapshot import _golden_cols
from tests.test_torch_gateway import _connect, _frame_cols, _request, _sequence, _serve

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
NOW = 1_573_430_400_000
ADDR = "127.0.0.1:9999"
TIMEOUT = 30.0

PKG = {
    "torch": SimpleNamespace(bb=tbb, wire=twire, gw=tgw, tracing=ttracing),
    "jax": SimpleNamespace(bb=jbb, wire=jwire, gw=jgw, tracing=jtracing),
}


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _clean():
    for p in PKG.values():
        p.tracing.reset()
        p.tracing.set_sample_rate(0.0)  # the native fast lane needs it off
        p.bb.force_disable(False)
        p.bb.set_enabled(True)
    yield
    for p in PKG.values():
        p.tracing.reset()
        p.bb.force_disable(False)
        p.bb.set_enabled(True)


def _cols(key="k", hits=3):
    return (["bb"], [key], [1], [0], [hits], [1000], [60_000])


def _rec(r):
    """A frame record without its clock stamps."""
    return (r[2], r[3], r[4], bytes(r[5]))


def _rings(bb):
    return {w: [_rec(r) for r in bb.rings[w].freeze()] for w in bb.rings}


def _wait_bundles(bbmod, path, n=1, timeout_s=10.0, box=None):
    """The bundles under `path` once n are there (and, given the writing
    box, once it has counted them: the writer renames the bundle into
    place before it bumps its count)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        found = [os.path.join(path, e) for e in bbmod.list_bundles(path)]
        if len(found) >= n and (box is None or box.bundles_written >= n):
            return found
        time.sleep(0.02)
    raise AssertionError(f"no {n} bundles under {path} within {timeout_s}s")


def _manifest(bundle):
    with open(os.path.join(bundle, "manifest.json"), "rb") as f:
        return json.loads(f.read())


# ---------------------------------------------------------------------
# The frame-log codec
# ---------------------------------------------------------------------
def _seeded_records(seed, n=48):
    rng = np.random.default_rng(seed)
    peers = ["", "10.0.0.2:81", "peer-b", "néø:7"]
    out = []
    for _ in range(n):
        frame = rng.integers(0, 256, int(rng.integers(0, 400)), dtype=np.uint8).tobytes()
        out.append((int(rng.integers(0, 2**63)), int(rng.integers(0, 2**63)),
                    str(rng.choice(["in", "out"])), str(rng.choice(peers)),
                    int(rng.integers(1, 8)), frame))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_frame_log_codec_matches_jax(seed):
    recs = _seeded_records(seed)
    raw = tbb.encode_frame_log(recs)
    assert raw == jbb.encode_frame_log(recs)
    assert tbb.decode_frame_log(raw) == jbb.decode_frame_log(raw) == recs
    assert tbb.encode_frame_log([]) == jbb.encode_frame_log([]) == b"GUBL\x01\x00\x00\x00"
    assert (tbb.WIRES, tbb._KIND_WIRE, tbb._REC_HEAD.format) == (
        jbb.WIRES, jbb._KIND_WIRE, jbb._REC_HEAD.format)


def _good_bundle(p, path) -> str:
    bb = p.bb.BlackBox(None, path=str(path), budget_mb=1)
    bb.tap("in", "", p.wire.encode_ingress_frame(_cols("a")))
    bb.tap("out", "p:1", p.wire.encode_columns_frame(_cols("b")))
    bb.tap("out", "p:1", p.wire.encode_columns_frame(_cols("c", hits=5)))
    out = bb.write_bundle([{"kind": "manual", "wallNs": 1, "monoNs": 1, "fields": {}}])
    bb.close()
    return out


def _flip_byte(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def _truncate(path, by):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - by)


def _rewrite_manifest(bundle_dir, mutate):
    p = os.path.join(bundle_dir, "manifest.json")
    with open(p) as f:
        m = json.load(f)
    mutate(m)
    with open(p, "w") as f:
        json.dump(m, f)


def _garbage_manifest(d):
    with open(os.path.join(d, "manifest.json"), "wb") as f:
        f.write(b"not json")


# The corruptions of tests/test_blackbox.py.
CORRUPTIONS = [
    ("gfl-truncated", lambda d: _truncate(os.path.join(d, "wire-peer.gfl"), 3)),
    ("gfl-bit-flip", lambda d: _flip_byte(
        os.path.join(d, "wire-peer.gfl"), os.path.getsize(os.path.join(d, "wire-peer.gfl")) - 5)),
    ("gfl-bad-magic", lambda d: _flip_byte(os.path.join(d, "wire-public.gfl"), 0)),
    ("file-missing", lambda d: os.unlink(os.path.join(d, "wire-global.gfl"))),
    ("manifest-garbage", _garbage_manifest),
    ("manifest-wrong-version", lambda d: _rewrite_manifest(
        d, lambda m: m.__setitem__("version", 999))),
    ("manifest-wrong-format", lambda d: _rewrite_manifest(
        d, lambda m: m.__setitem__("format", "something-else"))),
    ("manifest-bad-crc", lambda d: _rewrite_manifest(
        d, lambda m: m["files"]["wire-peer.gfl"].__setitem__("crc32", 1))),
]


def _run_both(capsys, pairs, argv):
    """(rc, stdout, stderr) of each script's main(argv)."""
    out = []
    for name in pairs:
        rc = _script(name).main(list(argv))
        o = capsys.readouterr()
        out.append((rc, o.out, o.err))
    return out


@pytest.mark.parametrize("writer", ["torch", "jax"])
@pytest.mark.parametrize("name,corrupt", CORRUPTIONS, ids=[c[0] for c in CORRUPTIONS])
def test_corrupt_bundle_rejected_alike(tmp_path, capsys, writer, name, corrupt):
    bundle = _good_bundle(PKG[writer], tmp_path)
    good_t, good_j = tbb.load_bundle(bundle), jbb.load_bundle(bundle)
    assert good_t.frames == good_j.frames and good_t.merged_records()
    assert good_t.manifest == good_j.manifest
    corrupt(bundle)
    msgs = []
    for mod in (tbb, jbb):
        with pytest.raises(mod.BundleError) as ei:
            mod.load_bundle(bundle)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1], msgs
    # The port's replay refuses before driving a frame...
    with pytest.raises(tbb.BundleError):
        _script("torch_replay").replay_bundle(bundle, device="cpu")
    # ...and both offline verifiers exit 1 with the same words.
    for argv in ([bundle], [bundle, "--json"]):
        t, j = _run_both(capsys, ("torch_blackbox_fsck", "blackbox_fsck"), argv)
        assert t == j and t[0] == 1, (t, j)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_fsck_ok_and_usage_exits_match_jax(tmp_path, capsys, writer):
    bundle = _good_bundle(PKG[writer], tmp_path)
    for argv in ([bundle, "--json"], [bundle], [bundle, "--frames"],
                 [bundle, "--json", "--frames"], [str(tmp_path / "nope")]):
        t, j = _run_both(capsys, ("torch_blackbox_fsck", "blackbox_fsck"), argv)
        assert t == j, (argv, t, j)
    rc, out, _ = _run_both(capsys, ("torch_blackbox_fsck",), [bundle, "--json"])[0]
    doc = json.loads(out)
    assert rc == 0 and doc["ok"] is True
    assert doc["frames"]["peer"] == 2 and doc["frames"]["public"] == 1
    assert _run_both(capsys, ("torch_blackbox_fsck",), [str(tmp_path / "nope")])[0][0] == 2


@pytest.mark.parametrize("mix", ["torch", "jax", "mixed"])
def test_incident_collect_matches_jax(tmp_path, capsys, mix):
    wa, wb = {"torch": ("torch", "torch"), "jax": ("jax", "jax"),
              "mixed": ("torch", "jax")}[mix]
    a = _good_bundle(PKG[wa], tmp_path / "a")
    b = _good_bundle(PKG[wb], tmp_path / "b")
    pair = ("torch_incident_collect", "incident_collect")
    for argv in (["--scan", str(tmp_path), "--json"], [a, b], [a, b, "--frames"]):
        t, j = _run_both(capsys, pair, argv)
        assert t == j and t[0] == 0, (argv, t, j)
    rc, out, _ = _run_both(capsys, pair[:1], ["--scan", str(tmp_path), "--json"])[0]
    doc = json.loads(out)
    assert len(doc["bundles"]) == 2 and not doc["rejected"]
    assert len(doc["frames"]) == 6
    assert [t["kind"] for t in doc["triggers"]] == ["manual", "manual"]
    _flip_byte(os.path.join(b, "wire-peer.gfl"), 20)
    for argv in ([a, b], [a, b, "--json"], [str(tmp_path / "none")], []):
        t, j = _run_both(capsys, pair, argv)
        assert t == j and t[0] == 1, (argv, t, j)


def _snapshot_files(tmp_path):
    """One snapshot file written by each package, the same lanes."""
    jcols = _golden_cols()
    pj, pt = str(tmp_path / "jax.snap"), str(tmp_path / "torch.snap")
    jsnap.write_snapshot(pj, jcols, NOW, ring_hash=0xDEADBEEF12345678)
    tsnap.write_snapshot(pt, TransferColumns(**vars(jcols)), NOW, ring_hash=0xDEADBEEF12345678)
    with open(pj, "rb") as f, open(pt, "rb") as g:
        assert f.read() == g.read()
    return {"jax": pj, "torch": pt}


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_snapshot_fsck_matches_jax(tmp_path, capsys, writer):
    path = _snapshot_files(tmp_path)[writer]
    pair = ("torch_snapshot_fsck", "snapshot_fsck")
    good = [[path], [path, "--json", "--keys"], [path, "--keys"],
            [path, "--expect-ring", "0xDEADBEEF12345678"]]
    for argv in good:
        t, j = _run_both(capsys, pair, argv)
        assert t == j and t[0] == 0, (argv, t, j)
    for argv in ([path, "--expect-ring", "0x1"], [path, "--json", "--expect-ring", "7"]):
        t, j = _run_both(capsys, pair, argv)
        assert t == j and t[0] == 1, (argv, t, j)
    t, j = _run_both(capsys, pair, [str(tmp_path / "nope.snap")])
    assert t == j and t[0] == 2
    _flip_byte(path, os.path.getsize(path) - 2)
    for argv in ([path], [path, "--json"]):
        t, j = _run_both(capsys, pair, argv)
        assert t == j and t[0] == 1, (argv, t, j)
    _truncate(path, 9)
    t, j = _run_both(capsys, pair, [path])
    assert t == j and t[0] == 1


# ---------------------------------------------------------------------
# Rings, taps, triggers
# ---------------------------------------------------------------------
def test_ring_byte_budget_evicts_oldest():
    frames = [twire.encode_columns_frame(_cols(f"key-{i:04d}")) for i in range(200)]
    got = []
    for mod in (tbb, jbb):
        ring = mod._WireRing(budget=4096)
        for i, f in enumerate(frames):
            ring.record((i, i, "in", "", 1, f))
        got.append((ring.stats(), [_rec(r) for r in ring.freeze()]))
    assert got[0] == got[1]
    (n, nbytes, total), kept = got[0]
    assert total == 200 and n < 200 and nbytes <= 4096
    assert [r[3] for r in kept] == frames[200 - n:]


def test_tap_classifies_by_kind_and_sniffs_magic(tmp_path):
    rings = []
    for name, p in PKG.items():
        bb = p.bb.BlackBox(None, path=str(tmp_path / name), budget_mb=1)
        bb.tap("in", "", b'{"requests": []}')
        bb.tap("in", "", b"GU")
        bb.tap("in", "", b"")
        bb.tap("in", "", p.wire.encode_ingress_frame(_cols()))
        bb.tap("out", "10.0.0.2:81", p.wire.encode_columns_frame(_cols()))
        bb.tap("out", "10.0.0.2:81", p.wire.encode_columns_frame(_cols(), kind=3))
        bb.tap("in", "", b"GUBC\x01\x09" + bytes(8))  # an unknown kind
        rings.append((_rings(bb), {w: bb.rings[w].stats()[0] for w in p.bb.WIRES}))
    assert rings[0] == rings[1]
    assert rings[0][1] == {"public": 1, "peer": 1, "global": 1, "transfer": 0, "region": 0}
    assert rings[0][0]["peer"][0][:3] == ("out", "10.0.0.2:81", 1)


def test_force_disable_is_dark(tmp_path):
    for name, p in PKG.items():
        bb = p.bb.BlackBox(None, path=str(tmp_path / name), budget_mb=1)
        p.bb.force_disable(True)
        assert not bb.live() and not p.bb.enabled()
        bb.tap("in", "", p.wire.encode_ingress_frame(_cols()))
        bb.on_trigger("audit-violation", {})
        p.bb.force_disable(False)
        assert bb.live()
        assert all(bb.rings[w].stats() == (0, 0, 0) for w in p.bb.WIRES)
        assert bb._pending == [] and bb._thread is None


def test_trigger_storm_coalesces_into_one_bundle(tmp_path):
    out = []
    for name, p in PKG.items():
        bb = p.bb.BlackBox(None, path=str(tmp_path / name), budget_mb=1)
        bb.coalesce_s = 0.05
        try:
            for i in range(5):
                bb.on_trigger("breaker-open", {"peer": f"p{i}", "kind": "x", "ts_ns": 1})
            bundles = _wait_bundles(p.bb, str(tmp_path / name), 1, box=bb)
            m = _manifest(bundles[0])
            out.append((len(bundles), [(t["kind"], t["fields"]) for t in m["triggers"]],
                        m["suppressedTriggers"], bb.snapshot()["bundles"]))
        finally:
            bb.close()
    assert out[0] == out[1]
    assert out[0][0] == 1 and len(out[0][1]) == 5


def test_rate_limit_suppresses_and_manual_bypasses(tmp_path):
    out = []
    for name, p in PKG.items():
        path = str(tmp_path / name)
        bb = p.bb.BlackBox(None, path=path, budget_mb=1)
        bb.coalesce_s = 0.02
        bb.min_interval_s = 3600.0
        try:
            bb.on_trigger("audit-violation", {"invariant": "x"})
            _wait_bundles(p.bb, path, 1, box=bb)
            bb.on_trigger("audit-violation", {"invariant": "x"})
            deadline = time.monotonic() + 5.0
            while bb.snapshot()["suppressedTriggers"] == 0 and time.monotonic() < deadline:
                time.sleep(0.02)
            first = (len(p.bb.list_bundles(path)), bb.snapshot()["suppressedTriggers"])
            bb.trigger_manual("on purpose")
            bundles = _wait_bundles(p.bb, path, 2, box=bb)
            m = _manifest(bundles[-1])
            out.append((first, m["suppressedTriggers"], [t["kind"] for t in m["triggers"]],
                        m["triggers"][-1]["fields"], bb.snapshot()["suppressedTriggers"]))
        finally:
            bb.close()
    assert out[0] == out[1]
    assert out[0][0] == (1, 1) and out[0][1] >= 1 and out[0][2][-1] == "manual"


def test_retention_prunes_oldest(tmp_path):
    out = []
    for name, p in PKG.items():
        path = str(tmp_path / name)
        bb = p.bb.BlackBox(None, path=path, budget_mb=1, retain=2)
        try:
            names = [os.path.basename(bb.write_bundle([{"kind": "manual"}])) for _ in range(4)]
            kept = p.bb.list_bundles(path)
            assert kept == names[-2:]
            os.makedirs(os.path.join(path, ".tmp-stale"))
            os.utime(os.path.join(path, ".tmp-stale"), (1, 1))
            bb.write_bundle([{"kind": "manual"}])
            out.append((len(kept), len(p.bb.list_bundles(path)), sorted(
                e for e in os.listdir(path) if e.startswith(".tmp-")), bb.bundles_written))
        finally:
            bb.close()
    assert out[0] == out[1] == (2, 2, [], 5)


def test_bundle_cross_loads_with_the_same_files(tmp_path):
    """A bundle's manifest apart from the stamps, name and version (and
    the frame logs' CRCs, which cover the records' stamps), its files'
    sizes and its frames without their stamps are the same from either
    writer, read by the other package's loader."""
    docs = []
    for name, p in PKG.items():
        bundle = _good_bundle(p, tmp_path / name)
        m = dict(_manifest(bundle))
        for k in ("name", "wallNs", "monoNs", "gubernatorVersion"):
            m.pop(k)
        m["files"] = {f: v["bytes"] for f, v in m["files"].items()}
        assert set(os.listdir(bundle)) == set(m["files"]) | {"manifest.json"}
        other = (jbb if name == "torch" else tbb).load_bundle(bundle)
        docs.append((m, {w: [_rec(r) for r in v] for w, v in other.frames.items()}))
    assert docs[0] == docs[1]


# ---------------------------------------------------------------------
# The edges
# ---------------------------------------------------------------------
def _services(blackbox_dir="", ring=True, audit=False):
    clock = Clock()
    clock.freeze(NOW)
    kw = dict(global_sync_wait_s=3600.0, audit=audit, snapshot_interval_s=0.0)
    js = JService(JConfig(cache_size=4096, clock=clock, advertise_address=ADDR,
                          behaviors=JBehaviors(**kw), blackbox_dir=blackbox_dir and blackbox_dir + "-jax"))
    ts = TService(TConfig(cache_size=4096, clock=clock, advertise_address=ADDR,
                          behaviors=TBehaviors(**kw), device="cpu",
                          blackbox_dir=blackbox_dir and blackbox_dir + "-torch"))
    js.set_peers([JPeer(grpc_address=ADDR, is_owner=True)] if ring else [])
    ts.set_peers([TPeer(grpc_address=ADDR, is_owner=True)] if ring else [])
    return {"jax": js, "torch": ts}


def _drive_handler(p, svc, seq):
    return [p.gw.handle_request(svc, m, path, b) for m, path, b in seq]


def _drive_async(p, svc, seq):
    out = []
    for m, path, b in seq:
        done = threading.Event()
        box = []

        def respond(status, ctype, body, box=box, done=done):
            box.append((status, ctype, bytes(body)))
            done.set()

        p.gw.handle_request_async(svc, m, path, b, respond)
        assert done.wait(TIMEOUT), (path, m)
        out.append(box[0])
    return out


def _drive_sockets(p, svc, seq):
    srv = _serve(p.gw, svc, native=True, pump=True)
    try:
        with _connect(srv.address) as s:
            return [_request(s, m, path, b) for m, path, b in seq], srv.pump.stats()
    finally:
        srv.close()


@pytest.mark.parametrize("edge", ["stdlib", "async", "native_pump"])
def test_edge_taps_match_jax(edge):
    seq = _sequence()
    svcs = _services()
    got = {}
    try:
        for name, svc in svcs.items():
            p = PKG[name]
            if edge == "stdlib":
                answers = _drive_handler(p, svc, seq)
            elif edge == "async":
                answers = _drive_async(p, svc, seq)
            else:
                answers = _drive_sockets(p, svc, seq)
            got[name] = (answers, _rings(svc.blackbox))
    finally:
        for svc in svcs.values():
            svc.close()
    assert got["torch"] == got["jax"]
    rings = got["torch"][1]
    frames_in = [b for m, path, b in seq if path == "/v1/GetRateLimits" and b[:4] == b"GUBC"]
    assert [r[3] for r in rings["public"] if r[0] == "in"] == frames_in
    assert len([r for r in rings["peer"] if r[0] == "in"]) == 1
    if edge == "native_pump":
        st = got["torch"][0][1]
        assert st["frames"] >= 1 and st["fallbacks"] >= 1, st
    else:
        # every frame request has its kind-6 (or kind-2) answer beside it
        assert [r[2] for r in rings["public"] if r[0] == "out"] == [6] * len(frames_in)


def test_frames_from_taken_rebuilds_the_frames_sent():
    """Frames on several connections coalesce into one native take; both
    packages' `_frames_from_taken` rebuild each frame byte for byte."""
    edge = tnative.HttpEdge("127.0.0.1:0")
    b = tnative.IngressBatcher()
    b.set_ring(np.zeros(0, np.uint64), np.zeros(0, np.uint8), all_self=True, enabled=True,
               cap_lanes=0, max_frame_lanes=16384, behavior_mask=1 | 2 | 4 | 16)
    frames = [twire.encode_ingress_frame(_frame_cols(70 + k, n))
              for k, n in enumerate([1, 7, 33, 2, 120])]
    socks = []
    try:
        for f in frames:
            s = _connect(f"127.0.0.1:{edge.port}")
            socks.append(s)
            s.sendall(f"POST /v1/GetRateLimits HTTP/1.1\r\nHost: t\r\nContent-Type: "
                      f"{twire.COLUMNS_CONTENT_TYPE}\r\nContent-Length: {len(f)}\r\n\r\n"
                      .encode() + f)
            assert edge.next(timeout_ms=5000, ingress=b) is tnative.FAST_LANE
        tb = b.take(1 << 20, timeout_ms=5000)
        assert tb is not None and tb.n_frames == len(frames)
        assert tbb._frames_from_taken(tb) == jbb._frames_from_taken(tb) == frames
        box = tbb.BlackBox(None, budget_mb=1)
        box.tap_taken(tb)
        assert [_rec(r) for r in box.rings["public"].freeze()] == [
            ("in", "", 5, f) for f in frames]
        b.fail(tb, 500, "Error", "application/json", b"{}")
    finally:
        for s in socks:
            s.close()
        b.stop()
        edge.shutdown()
        edge.free()
        b.free()


def test_disabled_wire_bytes_identical_and_rings_dark():
    frames = [twire.encode_ingress_frame(_cols(f"gk{i}", hits=2)) for i in range(4)]
    seq = [("POST", "/v1/GetRateLimits", f) for f in frames]
    bodies = {}
    for off in (False, True):
        for p in PKG.values():
            p.bb.force_disable(off)
        svcs = _services(ring=False)
        try:
            for name, svc in svcs.items():
                out = _drive_handler(PKG[name], svc, seq)
                assert all(s == 200 for s, _, _ in out)
                bodies[(name, off)] = [bytes(b) for _, _, b in out]
                stats = {w: svc.blackbox.rings[w].stats() for w in tbb.WIRES}
                if off:
                    assert all(v == (0, 0, 0) for v in stats.values())
                else:
                    assert stats["public"][0] == 8  # request + response each
        finally:
            for svc in svcs.values():
                svc.close()
    assert len(set(tuple(v) for v in bodies.values())) == 1


# ---------------------------------------------------------------------
# The surfaces
# ---------------------------------------------------------------------
def _norm(raw: bytes, svc) -> bytes:
    return raw.replace(svc.blackbox.path.encode(), b"DIR") if svc.blackbox.path else raw


def _blackbox_metrics(p, svc):
    _, _, body = p.gw.handle_request(svc, "GET", "/metrics", b"")
    return sorted(line for line in bytes(body).decode().splitlines()
                  if line.startswith("gubernator_blackbox_") and "_created" not in line
                  and not line.startswith("gubernator_blackbox_last_trigger_age_seconds"))


def test_debug_incident_and_surfaces_match_jax(tmp_path):
    svcs = _services(blackbox_dir=str(tmp_path / "bb"))
    seq = _sequence()
    got = {}
    try:
        for name, svc in svcs.items():
            p = PKG[name]
            svc.blackbox.coalesce_s = 0.02
            _drive_handler(p, svc, seq)
            st, ct, body = p.gw.handle_request(svc, "POST", "/debug/incident", b'{"reason": "drill"}')
            bundles = _wait_bundles(p.bb, svc.blackbox.path, 1, box=svc.blackbox)
            m = _manifest(bundles[0])
            bad = p.gw.handle_request(svc, "POST", "/debug/incident", b"[1]")
            snap = svc.debug_status()["blackbox"]
            age = snap.pop("lastTriggerAgeS")
            snap["dir"] = "DIR"
            p.bb.force_disable(True)
            off = p.gw.handle_request(svc, "POST", "/debug/incident", b"")
            off_snap = svc.debug_status()["blackbox"]["enabled"]
            p.bb.force_disable(False)
            got[name] = dict(
                accepted=(st, ct, _norm(bytes(body), svc)), bad=(bad[0], bytes(bad[2])),
                off=(off[0], off[1], bytes(off[2])), off_snap=off_snap,
                triggers=[(t["kind"], t["fields"]) for t in m["triggers"]],
                service={k: v for k, v in m["service"].items() if k != "pid"},
                knobs=m["knobs"], rings=m["rings"], files=sorted(m["files"]),
                snap=snap, age=age is not None and age >= 0,
                metrics=_blackbox_metrics(p, svc))
    finally:
        for svc in svcs.values():
            svc.close()
    t, j = got["torch"], got["jax"]
    for k in t:
        if k == "knobs":
            continue
        assert t[k] == j[k], (k, t[k], j[k])
    assert t["accepted"][0] == 202 and t["off"][0] == 403 and t["off_snap"] is False
    assert t["triggers"] == [("manual", {"reason": "drill"})]
    assert t["service"]["advertiseAddress"] == ADDR
    assert "status.json" in t["files"] and "metrics.prom" in t["files"]
    assert t["snap"]["enabled"] and t["snap"]["bundles"] == 1
    # The JAX knobs a port node records are the same values, under the
    # names the port shares with it.
    assert {k: v for k, v in t["knobs"].items() if k in j["knobs"]} == {
        k: v for k, v in j["knobs"].items() if k in t["knobs"]}
    # No bundle directory: 409, the same body.
    svcs = _services()
    try:
        out = {n: PKG[n].gw.handle_request(s, "POST", "/debug/incident", b"") for n, s in svcs.items()}
        assert out["torch"][0] == 409 and (out["torch"][0], bytes(out["torch"][2])) == (
            out["jax"][0], bytes(out["jax"][2]))
    finally:
        for svc in svcs.values():
            svc.close()


def test_closed_service_unhooks_from_the_default_recorder(tmp_path):
    svcs = [TService(TConfig(cache_size=1024, device="cpu", blackbox_dir=str(tmp_path / f"s{i}"),
                             behaviors=TBehaviors(audit=False, snapshot_interval_s=0.0)))
            for i in range(3)]
    hooks = ttracing.default_recorder().dump_hooks
    assert all(s.blackbox.on_trigger in hooks for s in svcs)
    for s in svcs[:2]:
        s.close()
    assert [s.blackbox.on_trigger in hooks for s in svcs] == [False, False, True]
    svcs[2].blackbox.coalesce_s = 0.02
    ttracing.record_event("audit-violation", invariant="x")
    _wait_bundles(tbb, str(tmp_path / "s2"), 1)
    assert not tbb.list_bundles(str(tmp_path / "s0")) and not tbb.list_bundles(str(tmp_path / "s1"))
    svcs[2].close()


# ---------------------------------------------------------------------
# The daemons: GUBER_BLACKBOX, GUBER_BLACKBOX_DIR, cluster_status.py
# ---------------------------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _daemon(kind, env):
    env = {"GUBER_HTTP_ADDRESS": f"127.0.0.1:{_free_port()}",
           "GUBER_GRPC_ADDRESS": f"127.0.0.1:{_free_port()}",
           "GUBER_CACHE_SIZE": "4096", "GUBER_TRACE_SAMPLE": "0",
           "GUBER_GLOBAL_SYNC_WAIT": "3600s", **env}
    clock = Clock()
    clock.freeze(NOW)
    if kind == "jax":
        conf = jcfg.setup_daemon_config(env=env)
        cls = JDaemon
    else:
        conf = tcfg.setup_daemon_config(env={**env, "GUBER_TORCH_DEVICE": "cpu"})
        cls = TDaemon
    conf.warmup_shapes = []
    return cls(conf, clock=clock).start()


def _http(addr, method, path, body=b""):
    req = urllib.request.Request(f"http://{addr}{path}", data=body if method == "POST" else None,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("flag", ["0", "1"])
def test_daemon_applies_guber_blackbox_both_ways(flag):
    on = flag == "1"
    for kind, p in PKG.items():
        p.bb.set_enabled(not on)  # the daemon's parsed knob must win
        d = _daemon(kind, {"GUBER_BLACKBOX": flag})
        try:
            assert p.bb.enabled() is on, kind
            st, body = _http(d.gateway.address, "POST", "/debug/incident")
            assert st == (409 if on else 403), (kind, st, body)
        finally:
            d.close()


def test_daemon_boots_with_blackbox_dir_and_answers_like_jax(tmp_path):
    """A port daemon with GUBER_BLACKBOX_DIR set boots (its service once
    raised NotImplementedError) and answers as a JAX daemon with the
    same config: the same bodies, the same incident statuses, bundles
    on disk, and scripts/cluster_status.py's same blackbox column."""
    cs = _script("cluster_status")
    frame = twire.encode_ingress_frame(_frame_cols(5, 30))
    body = json.dumps({"requests": [{"name": "a", "uniqueKey": "b", "hits": "1", "limit": "5",
                                     "duration": "60000"}]}).encode()
    got = {}
    for kind, p in PKG.items():
        path = str(tmp_path / kind)
        d = _daemon(kind, {"GUBER_BLACKBOX_DIR": path})
        try:
            d.service.blackbox.coalesce_s = 0.02
            addr = d.gateway.address
            answers = [_http(addr, "POST", "/v1/GetRateLimits", body),
                       _http(addr, "POST", "/v1/GetRateLimits", frame)]
            inc = _http(addr, "POST", "/debug/incident", b'{"reason": "boot"}')
            bundles = _wait_bundles(p.bb, path, 1, box=d.service.blackbox)
            row = cs.summarize("node", cs.fetch_status(addr))
            frames = {w: len(v) for w, v in p.bb.load_bundle(bundles[0]).frames.items()}
            got[kind] = (answers, inc[0], inc[1].replace(path.encode(), b"DIR"),
                         row["blackbox"].split(" ")[0], frames)
        finally:
            d.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == 202 and got["torch"][3] == "1/1"
    assert got["torch"][4]["public"] == 2  # the frame and its answer


def test_trace_collect_stitches_port_nodes():
    """scripts/trace_collect.py speaks HTTP only: against two port
    nodes it stitches one trace across the forward hop."""
    import sys

    sys.path.insert(0, SCRIPTS)
    import trace_collect

    from gubernator_tpu_torch.client import V1Client
    from gubernator_tpu_torch.cluster import Cluster, fast_test_behaviors
    from gubernator_tpu_torch.types import GetRateLimitsRequest, RateLimitRequest

    beh = fast_test_behaviors()
    beh.trace_sample = 1.0  # the daemons set the process-wide rate
    cl = Cluster().start_with(["", ""], behaviors=beh, device="cpu")
    try:
        svc0 = cl.daemons[0].service
        me = cl.daemons[0].peer_info.grpc_address
        key = next(f"{i}tc" for i in range(200)
                   if svc0.get_peer(f"tc_{i}tc").info.grpc_address != me)
        V1Client(cl.daemons[0].gateway.address, timeout_s=TIMEOUT).get_rate_limits(
            GetRateLimitsRequest(requests=[RateLimitRequest(
                name="tc", unique_key=key, hits=1, limit=10, duration=60_000)]))
        spans = []
        for d in cl.daemons:
            spans += trace_collect.fetch_spans(d.gateway.address)
        trees = trace_collect.stitch(spans)
        crossing = [t for t in trees.values() if len(t["daemons"]) > 1]
        assert crossing, {k: v["daemons"] for k, v in trees.items()}
    finally:
        cl.stop()
        ttracing.set_sample_rate(0.0)
