"""The port's wire codecs (gubernator_tpu_torch/wire.py) against the
JAX package's, byte for byte.

Every GUBC frame kind — 1/2 (the columnar peer hop), 3 (the GLOBAL
broadcast), 4 (an ownership transfer), 5/6 (the public columnar
ingress), 7 (a cross-region batch) — is encoded from the same seeded
columns by both packages and compared byte for byte (tolerance 0), and
each side decodes the other's bytes to the same columns (a region
frame or RegionColumnsReq to each package's own RegionColumns, and a
malformed region frame to the same error).  The pb codecs serialize to the same bytes too, and the module imports
with protobuf, grpc and prometheus_client absent.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from gubernator_tpu import native as jnative
from gubernator_tpu import wire as jwire
from gubernator_tpu.federation import RegionColumns
from gubernator_tpu.parallel.global_mgr import GlobalsColumns as JGlobals
from gubernator_tpu.reshard import TransferColumns as JTransfer
from gubernator_tpu.service import ColumnarResult as JResult
from gubernator_tpu.types import RateLimitResponse as JResp
from gubernator_tpu_torch import wire as twire
from gubernator_tpu_torch.federation import RegionColumns as TRegionColumns
from gubernator_tpu_torch.parallel.global_mgr import GlobalsColumns as TGlobals
from gubernator_tpu_torch.reshard import TransferColumns as TTransfer
from gubernator_tpu_torch.service import ColumnarResult as TResult
from gubernator_tpu_torch.types import RateLimitResponse as TResp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [0, 1, 2]


def _names(rng, n, prefix):
    # Multi-byte utf-8, empty strings and varied lengths.
    pool = [prefix, f"{prefix}é", "ключ", "", "k" * 40]
    return [f"{pool[int(rng.integers(0, 5))]}{int(rng.integers(0, 1000))}"
            if rng.random() > 0.1 else "" for _ in range(n)]


def _peer_cols(seed, n=None):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60)) if n is None else n
    names = [s or "n" for s in _names(rng, n, "name")]
    uks = [s or "u" for s in _names(rng, n, "uk")]
    return (names, uks,
            rng.integers(0, 2, n).astype(np.int32),
            rng.choice([0, 1, 2, 4, 8, 16], n).astype(np.int32),
            rng.integers(0, 1 << 40, n).astype(np.int64),
            rng.integers(-5, 1 << 40, n).astype(np.int64),
            rng.integers(0, 1 << 40, n).astype(np.int64))


def _trace(seed, n):
    rng = np.random.default_rng(seed + 100)
    cuts = sorted(set(int(c) for c in rng.integers(0, n + 1, 3)) | {0, n})
    return [(lo, hi, int(rng.integers(1, 1 << 62)) << 60 | 7, int(rng.integers(1, 1 << 62)))
            for lo, hi in zip(cuts, cuts[1:]) if hi > lo]


def _results(seed, n):
    """(JAX result, port result) with the same arrays, overrides and
    owner columns."""
    rng = np.random.default_rng(seed + 200)
    arrays = dict(status=rng.integers(0, 2, n).astype(np.int32),
                  limit=rng.integers(0, 1 << 40, n).astype(np.int64),
                  remaining=rng.integers(-3, 1 << 40, n).astype(np.int64),
                  reset_time=rng.integers(0, 1 << 42, n).astype(np.int64))
    ov = [int(i) for i in rng.choice(n, min(n, 3), replace=False)]
    jr, tr = JResult(n=n, **arrays), TResult(n=n, **{k: v.copy() for k, v in arrays.items()})
    for k, i in enumerate(ov):
        kw = dict(error="boom é") if k == 0 else dict(status=1, limit=5, remaining=k,
                                                      reset_time=9, metadata={"owner": "p:1"})
        jr.overrides[i] = JResp(**kw)
        tr.overrides[i] = TResp(**kw)
    if n > 2:
        lanes = np.arange(0, n, 2)
        jr.set_owner(lanes, "10.0.0.1:81")
        tr.set_owner(lanes, "10.0.0.1:81")
    return jr, tr


def _same_result(a, b):
    assert a.n == b.n
    for f in ("status", "limit", "remaining", "reset_time"):
        assert np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f))), f
    assert {k: v.to_json() for k, v in a.overrides.items()} == \
        {k: v.to_json() for k, v in b.overrides.items()}
    assert list(getattr(a, "owner_addrs", [])) == list(getattr(b, "owner_addrs", []))
    oa, ob = getattr(a, "owner_of", None), getattr(b, "owner_of", None)
    assert (oa is None) == (ob is None)
    if oa is not None:
        assert np.array_equal(oa, ob)


def _same_ingress(a, b):
    assert len(a) == len(b)
    assert list(a.names) == list(b.names)
    assert list(a.unique_keys) == list(b.unique_keys)
    for f in ("algorithm", "behavior", "hits", "limit", "duration"):
        assert np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f))), f
    assert getattr(a, "trace_ctx", None) == getattr(b, "trace_ctx", None)
    pa, pb_ = getattr(a, "prevalidated", None), getattr(b, "prevalidated", None)
    if pa is not None and pb_ is not None:
        assert list(pa[0]) == list(pb_[0])
        assert np.array_equal(pa[1], pb_[1])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("traced", [False, True])
def test_request_frames_kinds_1_and_5(seed, traced):
    cols = _peer_cols(seed)
    trace = _trace(seed, len(cols[0])) if traced else None
    for jenc, tenc, jdec, tdec in (
        (jwire.encode_columns_frame, twire.encode_columns_frame,
         jwire.decode_columns_frame, twire.decode_columns_frame),
        (jwire.encode_ingress_frame, twire.encode_ingress_frame,
         jwire.decode_ingress_frame, twire.decode_ingress_frame),
    ):
        jb, tb = jenc(cols, trace=trace), tenc(cols, trace=trace)
        assert jb == tb
        _same_ingress(jdec(tb), tdec(jb))
        _same_ingress(jdec(jb), tdec(tb))


def test_ingress_frame_validation_codes_and_rejections():
    """Empty names and keys get per-lane codes on both sides (native and
    numpy decode), and both refuse the same malformed frames with the
    same wording."""
    n = 6
    cols = (["a", "", "c", "d", "", "f"], ["1", "2", "", "4", "", "6"],
            np.zeros(n, np.int32), np.zeros(n, np.int32), np.ones(n, np.int64),
            np.full(n, 5, np.int64), np.full(n, 1000, np.int64))
    raw = jwire.encode_ingress_frame(cols)
    ja, tb = jwire.decode_ingress_frame(raw), twire.decode_ingress_frame(raw)
    _same_ingress(ja, tb)
    assert list(tb.prevalidated[1]) == [0, 2, 1, 0, 1, 0]
    bad = [raw[:-3], raw[:12], raw + b"x",
           jwire.encode_ingress_frame(cols[:2] + (np.full(n, 3, np.int32),) + cols[3:]),
           raw.replace(b"c", b"\xff", 1)]
    for b in bad:
        with pytest.raises(ValueError) as je:
            jwire.decode_ingress_frame(b)
        with pytest.raises(ValueError) as te:
            twire.decode_ingress_frame(b)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("seed", SEEDS)
def test_result_frames_kinds_2_and_6(seed):
    n = int(np.random.default_rng(seed).integers(1, 50))
    jr, tr = _results(seed, n)
    assert twire.encode_ingress_result_frame(tr) == jwire.encode_ingress_result_frame(jr)
    _same_result(twire.decode_ingress_result_frame(jwire.encode_ingress_result_frame(jr)), jr)
    _same_result(jwire.decode_ingress_result_frame(twire.encode_ingress_result_frame(tr)), tr)
    # Kind 2 carries no owner columns.
    jr.owner_of = tr.owner_of = None
    jr.owner_addrs, tr.owner_addrs = [], []
    assert twire.encode_result_frame(tr) == jwire.encode_result_frame(jr)
    _same_result(twire.decode_result_frame(jwire.encode_result_frame(jr)), jr)
    _same_result(jwire.decode_result_frame(twire.encode_result_frame(tr)), tr)


def _globals(seed):
    rng = np.random.default_rng(seed + 300)
    n = int(rng.integers(0, 40))
    kw = dict(keys=[f"g_{i}é{int(rng.integers(0, 99))}" for i in range(n)],
              algorithm=rng.integers(0, 2, n).astype(np.int32),
              status=rng.integers(0, 2, n).astype(np.int32),
              limit=rng.integers(0, 1 << 40, n).astype(np.int64),
              remaining=rng.integers(0, 1 << 40, n).astype(np.int64),
              reset_time=rng.integers(0, 1 << 42, n).astype(np.int64))
    return JGlobals(**kw), TGlobals(**{k: (v.copy() if k != "keys" else list(v))
                                       for k, v in kw.items()})


@pytest.mark.parametrize("seed", SEEDS)
def test_globals_frame_kind_3(seed):
    jg, tg = _globals(seed)
    jb, tb = jwire.encode_globals_frame(jg), twire.encode_globals_frame(tg)
    assert jb == tb
    for a, b in ((twire.decode_globals_frame(jb), jg), (jwire.decode_globals_frame(tb), tg)):
        assert list(a.keys) == list(b.keys)
        for f in ("algorithm", "status", "limit", "remaining", "reset_time"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    # The broadcast batch caches the same encodings.
    jbb, tbb = jwire.BroadcastBatch(jg), twire.BroadcastBatch(tg)
    assert tbb.frame() == jbb.frame()
    assert tbb.classic_json_bytes() == jbb.classic_json_bytes()
    assert tbb.classic_pb().SerializeToString() == jbb.classic_pb().SerializeToString()
    assert tbb.columns_pb().SerializeToString() == jbb.columns_pb().SerializeToString()


def _transfer(seed, ring_hash):
    rng = np.random.default_rng(seed + 400)
    n = int(rng.integers(0, 40))
    kw = dict(keys=[f"t_{i}ß" for i in range(n)],
              algorithm=rng.integers(0, 2, n).astype(np.int32),
              status=rng.integers(0, 2, n).astype(np.int32),
              limit=rng.integers(0, 1 << 40, n).astype(np.int64),
              remaining=rng.integers(0, 1 << 40, n).astype(np.int64),
              duration=rng.integers(0, 1 << 40, n).astype(np.int64),
              stamp=rng.integers(0, 1 << 42, n).astype(np.int64),
              expire_at=rng.integers(0, 1 << 42, n).astype(np.int64),
              ring_hash=ring_hash)
    return JTransfer(**kw), TTransfer(**kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_transfer_frame_kind_4(seed):
    jt, tt = _transfer(seed, (0x9C559A3B704EF3F << 4) + seed)
    jb, tb = jwire.encode_transfer_frame(jt), twire.encode_transfer_frame(tt)
    assert jb == tb
    for a, b in ((twire.decode_transfer_frame(jb), jt), (jwire.decode_transfer_frame(tb), tt)):
        assert list(a.keys) == list(b.keys) and a.ring_hash == b.ring_hash
        for f in ("algorithm", "status", "limit", "remaining", "duration", "stamp",
                  "expire_at"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (twire.transfer_cols_to_pb(tt).SerializeToString()
            == jwire.transfer_cols_to_pb(jt).SerializeToString())


@pytest.mark.parametrize("seed", SEEDS)
def test_region_frame_kind_7_encode(seed):
    """The port encodes a region batch as the JAX package does; the JAX
    decode reads the port's bytes back to the batch."""
    names, uks, algo, beh, hits, limit, dur = _peer_cols(seed)
    rc = RegionColumns(origin=f"dc-{seed}é", names=names, unique_keys=uks, algorithm=algo,
                       behavior=beh, hits=hits, limit=limit, duration=dur)
    tb = twire.encode_region_frame(rc)
    assert tb == jwire.encode_region_frame(rc)
    assert twire.is_region_frame(tb) and not twire.is_transfer_frame(tb)
    back = jwire.decode_region_frame(tb)
    assert back.origin == rc.origin and back.names == names and back.unique_keys == uks
    assert (twire.region_cols_to_pb(rc).SerializeToString()
            == jwire.region_cols_to_pb(rc).SerializeToString())


def _region(cls, seed):
    names, uks, algo, beh, hits, limit, dur = _peer_cols(seed)
    return cls(origin=f"dc-{seed}é", names=names, unique_keys=uks, algorithm=algo,
               behavior=beh, hits=hits, limit=limit, duration=dur)


def _region_fields(rc):
    return (rc.origin, rc.names, rc.unique_keys, rc.algorithm.dtype.str,
            rc.algorithm.tolist(), rc.behavior.dtype.str, rc.behavior.tolist(),
            rc.hits.dtype.str, rc.hits.tolist(), rc.limit.dtype.str, rc.limit.tolist(),
            rc.duration.dtype.str, rc.duration.tolist())


@pytest.mark.parametrize("seed", SEEDS)
def test_region_frame_kind_7_decodes_across_packages(seed):
    """A region frame and a RegionColumnsReq encoded by one package
    decode in the other to its own RegionColumns with the same columns,
    and re-encode to the same bytes."""
    jrc, trc = _region(RegionColumns, seed), _region(TRegionColumns, seed)
    jb, tb = jwire.encode_region_frame(jrc), twire.encode_region_frame(trc)
    assert jb == tb
    from_j, from_t = twire.decode_region_frame(jb), jwire.decode_region_frame(tb)
    assert isinstance(from_j, TRegionColumns) and isinstance(from_t, RegionColumns)
    assert _region_fields(from_j) == _region_fields(from_t) == _region_fields(jrc)
    assert twire.encode_region_frame(from_j) == jb
    jpb = jwire.region_cols_to_pb(jrc).SerializeToString()
    tpb = twire.region_cols_to_pb(trc).SerializeToString()
    assert jpb == tpb
    from gubernator_tpu.proto import peers_columns_pb2 as jpc
    from gubernator_tpu_torch.proto import peers_columns_pb2 as tpc

    from_j = twire.region_cols_from_pb(tpc.RegionColumnsReq.FromString(jpb))
    from_t = jwire.region_cols_from_pb(jpc.RegionColumnsReq.FromString(tpb))
    assert isinstance(from_j, TRegionColumns)
    assert _region_fields(from_j) == _region_fields(from_t) == _region_fields(jrc)


def _malformed_region_frames():
    rc = _region(RegionColumns, 0)
    good = jwire.encode_region_frame(rc)
    empty = jwire.encode_region_frame(_region(RegionColumns, 1).slice(0, 0))
    bad_origin = bytearray(good)
    bad_origin[14] = 0xFF  # the origin's first byte: not utf-8
    return {
        "not_a_frame": b"{}",
        "other_kind": jwire.encode_ingress_frame(_peer_cols(0)),
        "bad_version": good[:4] + b"\x09" + good[5:],
        "truncated_header": good[:12],
        "truncated_origin": good[:16],
        "origin_not_utf8": bytes(bad_origin),
        "truncated_columns": good[:-3],
        "trailing_bytes": good + b"\x00",
        "empty_trailing": empty + b"\x01",
    }


@pytest.mark.parametrize("case", sorted(_malformed_region_frames()))
def test_malformed_region_frame_fails_alike(case):
    """Both decoders refuse a malformed region frame with the same
    exception type and message (the gateway's 400 body)."""
    raw = _malformed_region_frames()[case]
    errs = []
    for w in (jwire, twire):
        with pytest.raises(Exception) as e:
            w.decode_region_frame(raw)
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1]
    assert errs[0][0] == "ValueError"


def test_frame_kind_sniffs_agree():
    frames = [
        jwire.encode_columns_frame(_peer_cols(0)),
        jwire.encode_ingress_frame(_peer_cols(1)),
        jwire.encode_globals_frame(_globals(0)[0]),
        jwire.encode_transfer_frame(_transfer(0, 1)[0]),
        b'{"requests": []}', b"GUB", b"",
    ]
    for f in frames:
        for name in ("is_columns_frame", "is_ingress_frame", "is_globals_frame",
                     "is_transfer_frame", "is_region_frame", "is_ingress_result_frame"):
            assert getattr(twire, name)(f) == getattr(jwire, name)(f), (name, f[:8])


@pytest.mark.parametrize("seed", SEEDS)
def test_pb_codecs(seed):
    cols = _peer_cols(seed)
    trace = _trace(seed, len(cols[0]))
    assert (twire.peer_columns_req_to_pb(cols, trace=trace).SerializeToString()
            == jwire.peer_columns_req_to_pb(cols, trace=trace).SerializeToString())
    assert (twire.peer_columns_to_classic_pb(cols).SerializeToString()
            == jwire.peer_columns_to_classic_pb(cols).SerializeToString())
    assert twire.peer_columns_to_classic_json(cols) == jwire.peer_columns_to_classic_json(cols)
    m = jwire.peer_columns_req_to_pb(cols, trace=trace)
    _same_ingress(twire.ingress_from_peer_columns_pb(m), jwire.ingress_from_peer_columns_pb(m))
    n = len(cols[0])
    jr, tr = _results(seed, n)
    for enc in ("result_to_ingress_columns_pb", "columns_to_pb", "columns_to_peer_pb"):
        assert (getattr(twire, enc)(tr).SerializeToString()
                == getattr(jwire, enc)(jr).SerializeToString()), enc
    _same_result(twire.result_from_ingress_columns_pb(jwire.result_to_ingress_columns_pb(jr)),
                 jr)
    jr.owner_of = tr.owner_of = None
    jr.owner_addrs, tr.owner_addrs = [], []
    assert (twire.result_to_peer_columns_pb(tr).SerializeToString()
            == jwire.result_to_peer_columns_pb(jr).SerializeToString())
    _same_result(twire.result_from_peer_columns_pb(jwire.result_to_peer_columns_pb(jr)), jr)
    jg, tg = _globals(seed)
    _g = twire.globals_cols_from_pb(jwire.globals_cols_to_pb(jg))
    assert list(_g.keys) == list(jg.keys) and np.array_equal(_g.remaining, jg.remaining)


def test_module_imports_without_pb_grpc_or_prometheus():
    code = (
        "import sys\n"
        "for m in ('google.protobuf', 'google', 'grpc', 'prometheus_client', 'jax'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from gubernator_tpu_torch import wire, gateway\n"
        "cols = (['a'], ['b'], np.zeros(1, np.int32), np.zeros(1, np.int32),\n"
        "        np.ones(1, np.int64), np.ones(1, np.int64), np.ones(1, np.int64))\n"
        "raw = wire.encode_ingress_frame(cols)\n"
        "assert len(wire.decode_ingress_frame(raw)) == 1\n"
        "try:\n"
        "    wire.columns_to_pb(None)\n"
        "except ImportError:\n"
        "    print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_native_frame_parse_matches_jax_runtime():
    """gt_frame_parse of both runtimes: the same columns, packed hash
    keys and validation codes."""
    from gubernator_tpu_torch import native as tnative

    for seed in SEEDS:
        raw = jwire.encode_ingress_frame(_peer_cols(seed))
        a, b = jnative.parse_ingress_frame(raw), tnative.parse_ingress_frame(raw)
        _same_ingress(a, b)
