"""Token-bucket / leaky-bucket evaluation over struct-of-arrays state.

The port of the JAX package's ops/buckets.py (and of the per-shard
programs of its parallel/mesh.py).  Bucket state is two int32 tensors
of shape [S, C, 8] on one device, S shards by C slots; a whole request
batch is evaluated per shard against it, duplicate keys serialised into
rounds.  Semantics, row layout, wire formats and packed outputs are the
JAX package's bit for bit (tests/test_torch_buckets.py holds them to
it); see its module docstring for the reference citations.

Two implementations of each device function live here:

* the CUDA kernels (csrc/bucket_rounds.cu, csrc/rows.cu,
  csrc/moves.cu and csrc/compact.cu, bound in ops/_kernels.py), which
  the wrappers `bucket_rounds_dict` / `bucket_rounds_cols`, the row
  gather / scatter `gather_rows` / `write_rows` (and `read_back_rows`,
  the gather on the two-tier table's back tier), the tier move
  `apply_moves` and the compact commit `compact_dict` / `compact_cols`
  launch for CUDA tensors;
* their plain PyTorch versions (`bucket_rounds_dict_plain`,
  `bucket_rounds_cols_plain`, `read_rows_plain`, `write_rows_plain`,
  `apply_moves_plain`, `apply_compact_packed_plain`,
  `apply_compact32_plain`), a straight transcription of the JAX
  programs, which the wrappers take for CPU tensors and which the chip
  smoke test holds the kernels against on the card.

The one-shard forms of the JAX package's ShardStore that the port's
ShardStore calls (`apply_batch`, `apply_rounds_packed_fused`) and K10's
(`apply_compact32`, `apply_compact_packed`) are thin wrappers over the
same kernels with S = 1; its other one-shard programs are
`bucket_rounds_dict` / `bucket_rounds_cols` on a [1, C, 8] state.

State is updated in place (the kernels write their rows into `hot` and
`cold`; the plain versions scatter into them), which replaces the JAX
package's buffer donation.  All arithmetic is integer: int64 compute on
int32 storage, floor division throughout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..types import Algorithm, Behavior, Status

# Fixed-point scale for leaky-bucket fractional remaining.
LEAKY_SCALE_BITS = 20
LEAKY_SCALE = 1 << LEAKY_SCALE_BITS

DICT_TABLE_ROWS = 256  # config-table rows of the dict wire
# algo + behavior rows (i32), then five value rows as i64 lo/hi pairs.
DICT_WIRE_TABLE_WORDS = 2 * DICT_TABLE_ROWS + 5 * 2 * DICT_TABLE_ROWS

# hot lane indices
_H_FLAGS, _H_REM_LO, _H_REM_HI = 0, 1, 2
_H_STAMP_LO, _H_STAMP_HI, _H_EXP_LO, _H_EXP_HI = 3, 4, 5, 6
# cold lane indices
_C_LIM_LO, _C_LIM_HI, _C_DUR_LO, _C_DUR_HI = 0, 1, 2, 3

_I32_MAX = (1 << 31) - 1
_MASK32 = (1 << 32) - 1
_I64 = torch.int64
_I32 = torch.int32

_TOKEN = int(Algorithm.TOKEN_BUCKET)
_GREG = int(Behavior.DURATION_IS_GREGORIAN)
_RESET = int(Behavior.RESET_REMAINING)
_OVER = int(Status.OVER_LIMIT)
_UNDER = int(Status.UNDER_LIMIT)

class BucketState(NamedTuple):
    """Bucket tables of all shards: two int32 tensors [S, C, 8].

      hot[s, c]  — rewritten on every hit:
        0 flags (bits 0-1 algo, bit 2 status), 1 remaining_lo,
        2 remaining_hi, 3 stamp_lo, 4 stamp_hi, 5 expire_lo,
        6 expire_hi, 7 spare
      cold[s, c] — rewritten only when a lane's stored config changes:
        0 limit_lo, 1 limit_hi, 2 duration_lo, 3 duration_hi, 4-7 spare

    Every int64 value is a lo/hi int32 pair (sign in hi); leaky
    remaining is scaled by LEAKY_SCALE.  The layout is the JAX
    package's, so states carry across with state_from_numpy."""

    hot: torch.Tensor
    cold: torch.Tensor


def init_state(n_shards: int, capacity: int, device) -> BucketState:
    """Fresh all-expired tables (expire_at=0 => every slot is free)."""
    z = dict(dtype=_I32, device=device)
    return BucketState(
        hot=torch.zeros((n_shards, capacity, 8), **z),
        cold=torch.zeros((n_shards, capacity, 8), **z),
    )


def state_from_numpy(hot, cold, device) -> BucketState:
    """A port state from host arrays of shape [S, C, 8] (for example
    `np.asarray(jax_store.state.hot)`), copied onto `device`."""
    def put(a):
        a = np.ascontiguousarray(a, dtype=np.int32)
        if a.ndim != 3 or a.shape[2] != 8:
            raise ValueError(f"state must be [S, C, 8], got {a.shape}")
        return torch.from_numpy(a.copy()).to(device)

    hot_t, cold_t = put(hot), put(cold)
    if hot_t.shape != cold_t.shape:
        raise ValueError("hot and cold must have the same shape")
    return BucketState(hot=hot_t, cold=cold_t)


def state_to_numpy(state: BucketState):
    """(hot, cold) int32 numpy copies of a state."""
    return state.hot.cpu().numpy().copy(), state.cold.cpu().numpy().copy()


class BucketRows(NamedTuple):
    """Logical (composed int64) bucket rows, one lane per entry: the
    host exchange format of the Store and Loader SPIs, snapshots and
    row injection (the JAX package's BucketRows).  Fields are numpy
    arrays or tensors of one shape; algo and status are int32, the rest
    int64 (leaky remaining scaled by LEAKY_SCALE)."""

    algo: object
    limit: object
    remaining: object
    duration: object
    stamp: object
    expire_at: object
    status: object


# The row kernels' column layout: c32 i32[2, M] = (algo, status),
# c64 i64[5, M] = (limit, remaining, duration, stamp, expire_at).
ROW_COLS32 = ("algo", "status")
ROW_COLS64 = ("limit", "remaining", "duration", "stamp", "expire_at")


def rows_to_cols(rows: BucketRows):
    """Host BucketRows -> the row kernels' (c32, c64) numpy columns."""
    c32 = np.stack([np.asarray(getattr(rows, f), np.int32) for f in ROW_COLS32])
    c64 = np.stack([np.asarray(getattr(rows, f), np.int64) for f in ROW_COLS64])
    return c32, c64


def cols_to_rows(c32, c64) -> BucketRows:
    """The row kernels' (c32, c64) columns -> BucketRows (views)."""
    return BucketRows(**dict(zip(ROW_COLS32, c32)), **dict(zip(ROW_COLS64, c64)))


def last_lane_per_slot(shard, slot) -> np.ndarray:
    """Ascending indices of the lanes a row scatter keeps so that, of
    two lanes for one (shard, slot), the later wins; lanes with a
    negative slot (padding) are left out.  A restore with more keys for
    a shard than its capacity evicts keys of its own batch, and the
    table then maps their slot to the later key."""
    shard = np.asarray(shard, np.int64)
    slot = np.asarray(slot, np.int64)
    live = np.nonzero(slot >= 0)[0]
    key = (shard[live] << 32) | slot[live]
    _, first_rev = np.unique(key[::-1], return_index=True)
    return np.sort(live[(live.size - 1) - first_rev])


# ---------------------------------------------------------------------
# Host encoders / decoders (numpy): the formats of the JAX package.
# ---------------------------------------------------------------------
def pack_dict_wire(slot, exists, write, cfg, occ, round_id, table) -> np.ndarray:
    """Serialize one dict-wire batch into a SINGLE i32[S, 3P + 3072]
    buffer:

      words [0,P)    slot (i32)
      words [P,2P)   occ | flags<<16 | cfg<<24   (flags: bit0 exists,
                                                  bit1 write)
      words [2P,3P)  round_id
      words [3P,..)  config-table rows: algo(256), behavior(256), then
                     hits/limit/duration/greg_expire_delta/
                     greg_duration as i64 lo/hi word pairs (512 each)

    Inputs are [S, P] arrays plus the 7-row table as [rows][256]
    (shared by every shard row)."""
    S, P = slot.shape
    w = np.empty((S, 3 * P + DICT_WIRE_TABLE_WORDS), dtype=np.int32)
    w[:, :P] = slot
    meta = occ.astype(np.int32) & 0xFFFF
    meta |= (exists.astype(np.int32) | (write.astype(np.int32) << 1)) << 16
    meta |= cfg.astype(np.int32) << 24
    w[:, P:2 * P] = meta
    w[:, 2 * P:3 * P] = round_id
    pos = 3 * P
    for k in range(2):  # algo, behavior: i32
        w[:, pos:pos + DICT_TABLE_ROWS] = table[k].astype(np.int32)
        pos += DICT_TABLE_ROWS
    for k in range(2, 7):  # value rows: i64 as lo/hi
        v = table[k].astype(np.int64)
        w[:, pos:pos + DICT_TABLE_ROWS] = (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        pos += DICT_TABLE_ROWS
        w[:, pos:pos + DICT_TABLE_ROWS] = (v >> 32).astype(np.int32)
        pos += DICT_TABLE_ROWS
    return w


def build_config_dict(cols, now_ms: int):
    """Host half of the dict wire: map each lane's 7 value columns to a
    row index in a <=256-row table.  Returns (cfg_idx u8[B], table
    7x i64[DICT_TABLE_ROWS]) or None when the batch has too many
    distinct configs (the caller takes the per-lane-column wire).
    Lanes group by a 64-bit polynomial mix of the columns, then every
    lane is VERIFIED equal to its group representative, so a hash
    collision degrades to the fallback, never to a wrong config."""
    greg_delta = np.where(
        cols.greg_duration != 0, cols.greg_expire - now_ms, 0
    ).astype(np.int64)
    arrays = (
        cols.algo, cols.behavior, cols.hits, cols.limit, cols.duration,
        greg_delta, cols.greg_duration,
    )
    n = len(cols.algo)
    if n == 0:
        return None
    with np.errstate(over="ignore"):
        h = np.zeros(n, np.int64)
        for c in arrays:
            h = h * np.int64(1000003) + c.astype(np.int64)
    uq, idx_first, inv = np.unique(h, return_index=True, return_inverse=True)
    if len(uq) > DICT_TABLE_ROWS:
        return None
    for c in arrays:
        if not np.array_equal(c[idx_first][inv], c):
            return None  # collision: correctness over compactness
    table = []
    for c in arrays:
        row = np.zeros(DICT_TABLE_ROWS, np.int64)
        row[: len(uq)] = c[idx_first]
        table.append(row)
    return inv.astype(np.uint8), tuple(table)


def unpack_output32(packed, now_ms: int, table_expire):
    """Host decode of one narrow i32[4, B] result: (status, removed,
    remaining, reset_time, new_expire) with absolute int64 times.
    -1 decodes to absolute 0; -2 ("unchanged pass-through") makes
    reset_time the slot table's pre-commit expiry `table_expire` and
    leaves new_expire at -1 so the commit skips it."""
    row0 = packed[0]
    te = np.asarray(table_expire, dtype="int64")

    def undelta(row, keep):
        d = row.astype("int64")
        return np.where(d == -2, keep, np.where(d == -1, 0, d + now_ms))

    return (
        (row0 & 1).astype("int32"),
        ((row0 >> 1) & 1).astype(bool),
        packed[1].astype("int64"),
        undelta(packed[2], te),
        undelta(packed[3], np.int64(-1)),
    )


# ---------------------------------------------------------------------
# Plain PyTorch versions of the kernels
# ---------------------------------------------------------------------
def _compose64(lo, hi):
    """Exact int64 from a lo/hi int32 pair (sign lives in hi)."""
    return (hi.to(_I64) << 32) | (lo.to(_I64) & _MASK32)


def _lo32(v):
    """Low 32 bits of int64 `v` as int32 (explicit two's-complement
    wrap, so the cast never sees an out-of-range value)."""
    return (((v & _MASK32) ^ 0x80000000) - 0x80000000).to(_I32)


def _hi32(v):
    return (v >> 32).to(_I32)


def _sext32(v):
    """int64 `v` truncated to its low 32 bits, sign-extended back to
    int64 — the JAX package's `.astype(int32)` on a composed value."""
    return ((v & _MASK32) ^ 0x80000000) - 0x80000000


def _muldiv(a, b, d):
    """Exact (floor(a*b/d), a*b mod d) for 0 <= a <= d, 0 <= b < 2**63,
    1 <= d < 2**63, in int64 only.

    The JAX package forms the 128-bit product in uint64 halves and
    divides by shift-subtract; torch's uint64 support is partial, so
    this walks b's bits from the top keeping the running product
    modulo d: every step doubles the remainder and adds `a` modulo d
    without ever forming a value >= 2**63 (each addition is taken as a
    subtraction of the complement d - x).  The quotient grows by one
    bit per step and never exceeds b."""
    q = torch.zeros_like(a)
    r = torch.zeros_like(a)
    for bit in range(62, -1, -1):
        t = d - r  # 2r mod d: r + r if r < d - r else r - (d - r)
        wrap = r >= t
        r = torch.where(wrap, r - t, r + r)
        q = q + q + wrap.to(_I64)
        take = ((b >> bit) & 1) == 1
        t = d - a  # r + a mod d, only on this bit's lanes
        wrap = take & (r >= t)
        r = torch.where(wrap, r - t, torch.where(take, r + a, r))
        q = q + wrap.to(_I64)
    return q, r


def _leak_amounts(el_c, lim_nn, rn):
    """Exact (floor(el*lim/rn), floor((el*lim mod rn) * SCALE / rn)).

    Fast path (int64 only): lim = qL*rn + rL, el*lim/rn = el*qL +
    el*rL/rn, exact whenever el*rL fits.  The JAX package picks the
    fast or the 128-bit branch for the whole batch; both are exact, so
    picking per lane (the 128-bit form only where the fast one could
    overflow) gives the same bits."""
    qL = lim_nn // rn
    rL = lim_nn % rn
    max64 = (1 << 63) - 1
    safe_rl = torch.clamp(rL, min=1)
    ok = ((rL == 0) | (el_c <= max64 // safe_rl)) & (rn < (1 << 43))
    prod = torch.where(ok, el_c * rL, 0)
    lw = el_c * qL + prod // rn
    lr = prod % rn
    frac = (lr * LEAKY_SCALE) // rn
    slow = (~ok).nonzero(as_tuple=True)
    if slow[0].numel():
        e, lm, d = el_c[slow], lim_nn[slow], rn[slow]
        lw_s, lr_s = _muldiv(e, lm, d)
        fr_s, _ = _muldiv(lr_s, torch.full_like(lr_s, LEAKY_SCALE), d)
        lw = lw.index_put(slow, lw_s)
        frac = frac.index_put(slow, fr_s)
    return lw, frac


class RequestBatch(NamedTuple):
    """One batch of resolved requests for every shard, [S, P] each
    (int64 values, bool flags; the JAX package's RequestBatch with a
    leading shard axis), or, from `make_batch`, one shard's host
    columns [P].  `slot` -1 marks an inactive or padding lane:
    it reads nothing, writes nothing and answers zeros.  `occ` and
    `write` come from the grouped planner (occurrence index within a
    uniform duplicate group, and whether the lane stores its row)."""

    slot: torch.Tensor  # i64, -1 = inactive / padding
    exists: torch.Tensor
    algorithm: torch.Tensor
    behavior: torch.Tensor
    hits: torch.Tensor
    limit: torch.Tensor
    duration: torch.Tensor
    greg_expire: torch.Tensor
    greg_duration: torch.Tensor
    occ: torch.Tensor
    write: torch.Tensor


def _apply_compute(hot_g, cold_g, req: RequestBatch, now):
    """One batch evaluation without the commit (the JAX package's
    buckets._apply_compute): returns the packed response rows
    (row0, remaining, reset_time, new_expire, pre_expire) and the new
    rows (hot i32[..., 8], cold i32[..., 8], writes, cold_changed)."""
    valid = req.slot >= 0
    g_flags = hot_g[..., _H_FLAGS].to(_I64)
    g_algo = g_flags & 3
    g_status = (g_flags >> 2) & 1
    g_limit = _compose64(cold_g[..., _C_LIM_LO], cold_g[..., _C_LIM_HI])
    g_rem = _compose64(hot_g[..., _H_REM_LO], hot_g[..., _H_REM_HI])
    g_dur = _compose64(cold_g[..., _C_DUR_LO], cold_g[..., _C_DUR_HI])
    g_stamp = _compose64(hot_g[..., _H_STAMP_LO], hot_g[..., _H_STAMP_HI])
    g_exp = _compose64(hot_g[..., _H_EXP_LO], hot_g[..., _H_EXP_HI])

    # Expiry-as-miss: a slot at exactly its expiry is still live.
    live = req.exists & (g_exp >= now)
    exist = live & (g_algo == req.algorithm)  # algo switch => recreate

    is_tok = req.algorithm == _TOKEN
    greg = (req.behavior & _GREG) != 0
    reset_b = (req.behavior & _RESET) != 0
    hits, limit, duration = req.hits, req.limit, req.duration
    occ64 = req.occ
    hs = torch.clamp(hits, min=1)

    def occ_rem(base):
        taken = torch.minimum(occ64, base // hs)
        return torch.where(hits > 0, base - hits * taken, base)

    # ---------------- token bucket, existing item ----------------
    tok_reset = live & is_tok & reset_b
    t_rem0 = torch.clamp(g_rem + (limit - g_limit), min=0)
    dur_changed = g_dur != duration
    exp_from_cfg = torch.where(greg, req.greg_expire, g_stamp + duration)
    dur_expired = dur_changed & (exp_from_cfg < now)
    t_exp = torch.where(dur_changed, exp_from_cfg, g_exp)

    tok_exist = exist & is_tok & ~reset_b & ~dur_expired
    do_hit = hits > 0
    t_rem0 = occ_rem(t_rem0)
    can_take = do_hit & (hits <= t_rem0)
    t_rem1 = torch.where(can_take, t_rem0 - hits, t_rem0)
    t_resp_status = torch.where(
        do_hit & ((t_rem0 == 0) | (hits > t_rem0)), _OVER, g_status
    )
    t_new_status = torch.where(do_hit & (t_rem0 == 0), _OVER, g_status)

    # ---------------- token bucket, fresh create ----------------
    c_exp_tok = torch.where(greg, req.greg_expire, now + duration)
    remc = occ_rem(limit)
    c_over = hits > remc
    c_rem_tok = torch.where(c_over, remc, remc - hits)
    c_status_store = torch.where((occ64 > 0) & do_hit & (remc == 0), _OVER, _UNDER)

    # ---------------- leaky bucket, existing item ----------------
    lky_exist = exist & ~is_tok
    l_rem = torch.where(lky_exist & reset_b, limit * LEAKY_SCALE, g_rem)
    rate_num = torch.where(greg, req.greg_duration, duration)
    dur_eff = torch.where(greg, req.greg_expire - now, duration)
    lim_safe = torch.clamp(limit, min=1)

    elapsed = now - g_stamp
    rn = torch.clamp(rate_num, min=1)
    el_c = torch.minimum(torch.clamp(elapsed, min=0), rn)
    lim_nn = torch.clamp(limit, min=0)
    leak_whole, leak_frac = _leak_amounts(el_c, lim_nn, rn)
    leak_s = leak_whole * LEAKY_SCALE + leak_frac
    do_leak = leak_whole > 0
    l_rem = torch.where(do_leak, l_rem + leak_s, l_rem)
    l_stamp = torch.where(do_leak, now, g_stamp)
    l_rem = torch.where(l_rem // LEAKY_SCALE > limit, limit * LEAKY_SCALE, l_rem)

    rem_int0 = l_rem // LEAKY_SCALE
    l_reset = now + rate_num // lim_safe

    rem_int = occ_rem(rem_int0)
    l_rem_base = l_rem - (rem_int0 - rem_int) * LEAKY_SCALE

    at_zero = rem_int == 0
    exact = ~at_zero & (rem_int == hits)
    overflow = ~at_zero & ~exact & (hits > rem_int)
    take = exact | (~at_zero & ~overflow & (hits > 0))
    l_rem_f = torch.where(take, l_rem_base - hits * LEAKY_SCALE, l_rem_base)
    l_resp_rem = torch.where(
        exact, 0, torch.where(take, l_rem_f // LEAKY_SCALE, rem_int)
    )
    l_resp_status = torch.where(at_zero | overflow, _OVER, _UNDER)
    take64 = take.to(_I64)
    taken_cnt = torch.where(hits > 0, (rem_int0 - rem_int) // hs, 0) + take64
    drained_exactly = (hits > 0) & (taken_cnt > 0) & (rem_int - hits * take64 == 0)
    any_plain = (taken_cnt - drained_exactly.to(_I64)) >= 1
    l_exp = torch.where(any_plain, now + dur_eff, g_exp)

    # ---------------- leaky bucket, fresh create ----------------
    lc_over_all = hits > limit
    remlc = occ_rem(limit)
    remlc = torch.where(lc_over_all & (occ64 > 0), 0, remlc)
    lc_take = (hits > 0) & (hits <= remlc)
    lc_over = hits > remlc
    lc_rem = torch.where(
        lc_over_all, 0, (remlc - hits * lc_take.to(_I64)) * LEAKY_SCALE
    )
    lc_resp_rem = torch.where(lc_take, remlc - hits, torch.where(lc_over_all, 0, remlc))
    lc_exp = now + dur_eff
    lc_reset = now + dur_eff // lim_safe

    # ---------------- merge the five paths ----------------
    def sel(tok_reset_v, tok_exist_v, tok_create_v, lky_exist_v, lky_create_v):
        return torch.where(
            is_tok,
            torch.where(
                tok_reset, tok_reset_v,
                torch.where(tok_exist, tok_exist_v, tok_create_v),
            ),
            torch.where(lky_exist, lky_exist_v, lky_create_v),
        )

    z64 = torch.zeros_like(hits)
    resp_status = sel(
        torch.full_like(g_status, _UNDER), t_resp_status,
        torch.where(c_over, _OVER, _UNDER), l_resp_status,
        torch.where(lc_over, _OVER, _UNDER),
    )
    resp_rem = sel(limit, torch.where(can_take, t_rem1, t_rem0), c_rem_tok,
                   l_resp_rem, lc_resp_rem)
    resp_reset = sel(z64, t_exp, c_exp_tok, l_reset, lc_reset)

    n_algo = torch.where(valid, req.algorithm, g_algo)
    n_limit = sel(g_limit, limit, limit, limit, limit)
    n_rem = sel(g_rem, t_rem1, c_rem_tok, l_rem_f, lc_rem)
    n_dur = sel(g_dur, g_dur, duration, duration, dur_eff)
    n_stamp = sel(g_stamp, g_stamp, now, l_stamp, now)
    n_exp = sel(z64, t_exp, c_exp_tok, l_exp, lc_exp)
    n_status = sel(
        torch.full_like(g_status, _UNDER), t_new_status, c_status_store,
        torch.full_like(g_status, _UNDER), torch.full_like(g_status, _UNDER),
    )

    removed = tok_reset & valid
    writes = valid & req.write
    n_flags = (n_algo & 3) | ((n_status & 1) << 2)
    cold_changed = writes & ((n_limit != g_limit) | (n_dur != g_dur))

    row0 = torch.where(valid, resp_status, _UNDER) | (removed.to(_I64) << 1)
    out = torch.stack((
        row0,
        torch.where(valid, resp_rem, z64),
        torch.where(valid, resp_reset, z64),
        torch.where(valid, n_exp, z64),
        torch.where(valid, g_exp, z64),
    ), dim=-2)  # [S, 5, P]
    z32 = torch.zeros_like(hot_g[..., 0])
    new_hot = torch.stack((
        n_flags.to(_I32), _lo32(n_rem), _hi32(n_rem), _lo32(n_stamp),
        _hi32(n_stamp), _lo32(n_exp), _hi32(n_exp), z32,
    ), dim=-1)
    new_cold = torch.stack((
        _lo32(n_limit), _hi32(n_limit), _lo32(n_dur), _hi32(n_dur),
        z32, z32, z32, z32,
    ), dim=-1)
    return out, new_hot, new_cold, writes, cold_changed


def _apply_batch_packed(state: BucketState, req: RequestBatch, now):
    """One batch against every shard's table, in place: gather each
    lane's rows, evaluate, scatter the write lanes' rows (the cold row
    only where its config changed).  Returns the packed i64[S, 5, P]
    (row0 = status | removed << 1, remaining, reset_time, new_expire,
    pre_expire)."""
    S, P = req.slot.shape
    C = state.hot.shape[1]
    sidx = torch.arange(S, device=req.slot.device)[:, None].expand(S, P)
    s = torch.clamp(req.slot, 0, C - 1)
    out, new_hot, new_cold, writes, cold_changed = _apply_compute(
        state.hot[sidx, s], state.cold[sidx, s], req, now
    )
    # Write slots are unique within a batch, so the scatter order does
    # not matter.
    state.hot[sidx[writes], req.slot[writes]] = new_hot[writes]
    state.cold[sidx[cold_changed], req.slot[cold_changed]] = new_cold[cold_changed]
    return out


class BatchOutput(NamedTuple):
    """Per-lane responses (the JAX package's BatchOutput): tensors
    [S, P] from `apply_batch_plain`, host arrays [P] from the one-shard
    `apply_batch`."""

    status: torch.Tensor  # i64
    limit: torch.Tensor  # i64, the request's limit (0 on inactive lanes)
    remaining: torch.Tensor
    reset_time: torch.Tensor
    new_expire: torch.Tensor  # the slot's expire_at after this lane
    removed: torch.Tensor  # bool: token RESET_REMAINING freed the slot
    pre_expire: torch.Tensor  # the slot's stored expiry as gathered


def apply_batch_plain(state: BucketState, req: RequestBatch, now) -> BatchOutput:
    """The JAX package's apply_batch vmapped over S, in place (the plain
    versions of the GLOBAL kernels build on it): slots are
    unique within the batch (duplicate keys are the planner's rounds or
    `occ` groups).  The JAX form's `cold_cond` only chooses how its
    cold-row scatter is compiled; either way the cold row is written
    only where a lane's config changed, as here."""
    out = _apply_batch_packed(state, req, now)
    return BatchOutput(
        status=out[:, 0] & 1,
        limit=torch.where(req.slot >= 0, req.limit, 0),
        remaining=out[:, 1],
        reset_time=out[:, 2],
        new_expire=out[:, 3],
        removed=((out[:, 0] >> 1) & 1) == 1,
        pre_expire=out[:, 4],
    )


def _rounds_plain(state: BucketState, req: RequestBatch, round_id, n_rounds: int, now):
    """Rounds loop over all shards (apply_rounds / apply_rounds32 vmapped
    over S): round r's lanes read the state rounds < r left, then its
    write lanes store their rows.  Returns packed i64[S, 5, P] (row 4 is
    each lane's pre-round stored expiry)."""
    S, P = req.slot.shape
    packed = torch.zeros((S, 5, P), dtype=_I64, device=req.slot.device)
    for r in range(n_rounds):
        active = round_id == r
        out = _apply_batch_packed(
            state, req._replace(slot=torch.where(active, req.slot, -1)), now
        )
        packed = torch.where(active[:, None, :], out, packed)
    return packed


def _narrow(packed, now):
    """Pack i64[S, 5, P] to the narrow i32[S, 4, P] output: remaining
    clipped to [0, 2**31); times as deltas from now with -1 for an
    absolute 0 and -2 for an unrepresentable value equal to the lane's
    pre-round stored expiry."""
    pre_exp = packed[:, 4]

    def delta(v):
        d = v - now
        fits = (d >= 0) & (d <= _I32_MAX)
        return torch.where(
            v == 0, -1,
            torch.where(fits, d, torch.where(v == pre_exp, -2, torch.clamp(d, 0, _I32_MAX))),
        )

    return torch.stack((
        packed[:, 0], torch.clamp(packed[:, 1], 0, _I32_MAX),
        delta(packed[:, 2]), delta(packed[:, 3]),
    ), dim=1).to(_I32)


def _finish(packed, now, wide: bool):
    return packed[:, :4].contiguous() if wide else _narrow(packed, now)


def _dict_request(wire, now: int, wide: bool):
    """Decode a single-buffer wire i32[S, 3P + 3072] into the lanes'
    RequestBatch and round ids (the JAX package's unpack_dict_wire and
    the table gathers of apply_rounds_packed / _wide): the narrow form
    takes each value's low word as int32, the wide one the whole i64."""
    S, W = wire.shape
    P = (W - DICT_WIRE_TABLE_WORDS) // 3
    w = wire.to(_I64)
    meta = w[:, P:2 * P]
    fl = (meta >> 16) & 0xFF
    cfg = (meta >> 24) & 0xFF
    base = 3 * P
    R = DICT_TABLE_ROWS

    def row(k):  # one config-table row gathered per lane, [S, P]
        return torch.gather(w[:, base + k * R:base + (k + 1) * R], 1, cfg)

    def value(k):  # value row k (0..4) composed from its lo/hi words
        lo = torch.gather(w[:, base + (2 + 2 * k) * R:base + (3 + 2 * k) * R], 1, cfg)
        hi = torch.gather(w[:, base + (3 + 2 * k) * R:base + (4 + 2 * k) * R], 1, cfg)
        v = (hi << 32) | (lo & _MASK32)
        return v if wide else _sext32(v)

    hits, limit, duration, delta, greg_dur = (value(k) for k in range(5))
    if wide:
        greg_expire = torch.where(greg_dur != 0, now + delta, 0)
    else:
        greg_expire = now + delta
    req = RequestBatch(
        slot=w[:, :P], exists=(fl & 1) != 0, algorithm=row(0),
        behavior=row(1), hits=hits, limit=limit, duration=duration,
        greg_expire=greg_expire, greg_duration=greg_dur,
        occ=meta & 0xFFFF, write=(fl & 2) != 0,
    )
    return req, w[:, 2 * P:3 * P]


def _cols_request(lanes, values, now: int, wide: bool):
    """Decode the per-lane-column wire (lanes i32[S, 6, P], values
    [S, 5, P]) into the lanes' RequestBatch and round ids; narrow values
    carry greg_expire as a delta from now, wide ones absolute."""
    ln = lanes.to(_I64)
    v = values.to(_I64)
    greg_expire = v[:, 3] if wide else now + v[:, 3]
    req = RequestBatch(
        slot=ln[:, 0], exists=(ln[:, 1] & 1) != 0, algorithm=ln[:, 2],
        behavior=ln[:, 3], hits=v[:, 0], limit=v[:, 1], duration=v[:, 2],
        greg_expire=greg_expire, greg_duration=v[:, 4], occ=ln[:, 4],
        write=(ln[:, 1] & 2) != 0,
    )
    return req, ln[:, 5]


def bucket_rounds_dict_plain(hot, cold, wire, n_rounds: int, now_ms: int,
                             wide: bool):
    """Plain version of the dict-wire kernel (the JAX package's
    apply_rounds_packed / apply_rounds_packed_wide vmapped over S):
    decodes the single-buffer wire i32[S, 3P + 3072], runs the rounds
    against `hot`/`cold` in place and returns the packed output,
    i32[S, 4, P] or, when `wide`, i64[S, 4, P]."""
    now = int(now_ms)
    req, rid = _dict_request(wire, now, wide)
    packed = _rounds_plain(BucketState(hot, cold), req, rid, n_rounds, now)
    return _finish(packed, now, wide)


def bucket_rounds_cols_plain(hot, cold, lanes, values, n_rounds: int,
                             now_ms: int, wide: bool):
    """Plain version of the per-lane-column kernel (the JAX package's
    apply_rounds32 when `values` is i32 with greg_expire as a delta
    from now, apply_rounds when it is i64 with absolute greg_expire;
    both vmapped over S).  `lanes` is i32[S, 6, P] (slot,
    flags = exists | write<<1, algorithm, behavior, occ, round_id) and
    `values` [S, 5, P] (hits, limit, duration, greg_expire,
    greg_duration)."""
    now = int(now_ms)
    req, rid = _cols_request(lanes, values, now, wide)
    packed = _rounds_plain(BucketState(hot, cold), req, rid, n_rounds, now)
    return _finish(packed, now, wide)


def _compact_plain(hot, cold, req: RequestBatch, wlane, now: int):
    """One round of every lane (round ids ignored), then a commit of
    only the lanes `wlane` i32[S, Pw] lists (the JAX package's
    apply_compact32 vmapped over S): an entry below 0 is padding and
    writes nothing, an entry >= P stands for lane P - 1 (JAX's clip), a
    repeated entry writes its row twice (the same bytes); a listed lane
    writes its hot row where it is a write lane and its cold row where
    its config changed.  Returns the narrow i32[S, 4, P]."""
    S, P = req.slot.shape
    C = hot.shape[1]
    sidx = torch.arange(S, device=req.slot.device)[:, None]
    s = torch.clamp(req.slot, 0, C - 1)
    out, new_hot, new_cold, writes, cold_changed = _apply_compute(
        hot[sidx.expand(S, P), s], cold[sidx.expand(S, P), s], req, now)
    wl = torch.clamp(wlane.to(_I64), 0, P - 1)
    wsh = sidx.expand_as(wl)
    in_table = req.slot < C  # a slot past the table drops its write
    hot_w = (wlane >= 0) & (writes & in_table)[wsh, wl]
    cold_w = hot_w & cold_changed[wsh, wl]
    hot[wsh[hot_w], req.slot[wsh[hot_w], wl[hot_w]]] = new_hot[wsh[hot_w], wl[hot_w]]
    cold[wsh[cold_w], req.slot[wsh[cold_w], wl[cold_w]]] = new_cold[wsh[cold_w], wl[cold_w]]
    return _narrow(out, now)


def apply_compact32_plain(hot, cold, lanes, values, wlane, now_ms: int):
    """Plain version of the compact-commit kernel K10 fed from narrow
    per-lane columns (the JAX package's apply_compact32 vmapped over S):
    lanes i32[S, 6, P] and values i32[S, 5, P] as bucket_rounds_cols
    takes them (round ids ignored), wlane i32[S, Pw]; updates hot/cold
    in place and returns i32[S, 4, P] (see _compact_plain)."""
    now = int(now_ms)
    req, _ = _cols_request(lanes, values, now, wide=False)
    return _compact_plain(hot, cold, req, wlane, now)


def apply_compact_packed_plain(hot, cold, wire, wlane, now_ms: int):
    """Plain version of K10 fed from the dict wire (the JAX package's
    apply_compact_packed vmapped over S): wire i32[S, 3P + 3072], its
    round ids ignored; otherwise as apply_compact32_plain."""
    now = int(now_ms)
    req, _ = _dict_request(wire, now, wide=False)
    return _compact_plain(hot, cold, req, wlane, now)


# ---------------------------------------------------------------------
# Dispatch wrappers: the kernel for CUDA tensors, the plain version for
# CPU tensors, nothing else.
# ---------------------------------------------------------------------
def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def bucket_rounds_dict(hot, cold, wire, n_rounds: int, now_ms: int,
                       wide: bool, out=None):
    """Apply one dict-wire batch to every shard (updates `hot`/`cold`
    in place) and return the packed output; `out` optionally receives
    it (a preallocated tensor of the right shape and dtype)."""
    if _route(hot) == "cuda":
        from . import _kernels

        return _kernels.bucket_rounds_dict(hot, cold, wire, n_rounds, now_ms,
                                           wide, out=out)
    res = bucket_rounds_dict_plain(hot, cold, wire, n_rounds, now_ms, wide)
    if out is not None:
        out.copy_(res)
        return out
    return res


def bucket_rounds_cols(hot, cold, lanes, values, n_rounds: int, now_ms: int,
                       wide: bool):
    """Apply one per-lane-column batch to every shard (in place) and
    return the packed output."""
    if _route(hot) == "cuda":
        from . import _kernels

        return _kernels.bucket_rounds_cols(hot, cold, lanes, values, n_rounds,
                                           now_ms, wide)
    return bucket_rounds_cols_plain(hot, cold, lanes, values, n_rounds,
                                    now_ms, wide)


def compact_dict(hot, cold, wire, wlane, now_ms: int):
    """One single-round dict-wire batch with the compact commit: every
    lane evaluated, only the rows of the lanes in `wlane` i32[S, Pw]
    written (in place); returns the narrow i32[S, 4, P] (see
    apply_compact_packed_plain)."""
    if _route(hot) == "cuda":
        from . import _kernels

        return _kernels.bucket_compact(hot, cold, wlane, now_ms, wire=wire)
    return apply_compact_packed_plain(hot, cold, wire, wlane, now_ms)


def compact_cols(hot, cold, lanes, values, wlane, now_ms: int):
    """compact_dict fed from narrow per-lane columns (see
    apply_compact32_plain)."""
    if _route(hot) == "cuda":
        from . import _kernels

        return _kernels.bucket_compact(hot, cold, wlane, now_ms, lanes=lanes,
                                       values=values)
    return apply_compact32_plain(hot, cold, lanes, values, wlane, now_ms)


# ---------------------------------------------------------------------
# One-shard forms: the JAX package's programs of its one-shard store
# (ShardStore).  The port's ShardStore keeps a BucketState with S = 1,
# so these run K1, K2 and K10 with one shard; they take one shard's
# columns [P] (a wire i32[3P + 3072]) as the JAX forms do and return
# the packed output without the shard axis.
# ---------------------------------------------------------------------
class RequestBatch32(NamedTuple):
    """Narrow per-lane columns of one shard (the JAX package's
    RequestBatch32): int32 values, the Gregorian expiry as a delta from
    now (0 where unused).  Host arrays [P]."""

    slot: np.ndarray
    exists: np.ndarray
    algorithm: np.ndarray
    behavior: np.ndarray
    hits: np.ndarray
    limit: np.ndarray
    duration: np.ndarray
    greg_expire_delta: np.ndarray
    greg_duration: np.ndarray
    occ: np.ndarray
    write: np.ndarray


def _one_shard_columns(slot, exists, algorithm, behavior, vdtype, values, occ, write):
    slot = np.asarray(slot, np.int32)
    n = slot.shape[0]
    return dict(
        slot=slot, exists=np.asarray(exists, bool),
        algorithm=np.asarray(algorithm, np.int32),
        behavior=np.asarray(behavior, np.int32),
        **{k: np.zeros(n, vdtype) if v is None else np.asarray(v, vdtype)
           for k, v in values.items()},
        # No occurrence column: every lane its own group; no write
        # column: every lane writes (the JAX forms' None defaults).
        occ=np.zeros(n, np.int32) if occ is None else np.asarray(occ, np.int32),
        write=np.ones(n, bool) if write is None else np.asarray(write, bool),
    )


def make_batch(slot, exists, algorithm, behavior, hits, limit, duration,
               greg_expire=None, greg_duration=None, occ=None,
               write=None) -> RequestBatch:
    """One shard's wide per-lane columns (the JAX package's make_batch)
    as host arrays [P]; int64 values, absolute Gregorian expiry."""
    return RequestBatch(**_one_shard_columns(
        slot, exists, algorithm, behavior, np.int64,
        dict(hits=hits, limit=limit, duration=duration, greg_expire=greg_expire,
             greg_duration=greg_duration), occ, write))


def make_batch32(slot, exists, algorithm, behavior, hits, limit, duration,
                 greg_expire_delta=None, greg_duration=None, occ=None,
                 write=None) -> RequestBatch32:
    """One shard's narrow per-lane columns (the JAX package's
    make_batch32) as host arrays [P]."""
    return RequestBatch32(**_one_shard_columns(
        slot, exists, algorithm, behavior, np.int32,
        dict(hits=hits, limit=limit, duration=duration,
             greg_expire_delta=greg_expire_delta, greg_duration=greg_duration),
        occ, write))


def batch_columns(req, round_id=None):
    """One shard's batch (make_batch or make_batch32) as the per-lane
    wire of K2 and K10: host lanes i32[1, 6, P] and values [1, 5, P],
    i64 for a RequestBatch, i32 for a RequestBatch32.  `round_id`
    defaults to round 0 for every lane."""
    slot = np.asarray(req.slot, np.int32)
    rid = np.zeros_like(slot) if round_id is None else np.asarray(round_id, np.int32)
    flags = np.asarray(req.exists, np.int32) | (np.asarray(req.write, np.int32) << 1)
    lanes = np.stack([slot, flags, np.asarray(req.algorithm, np.int32),
                      np.asarray(req.behavior, np.int32),
                      np.asarray(req.occ, np.int32), rid])[None]
    wide = isinstance(req, RequestBatch)
    greg_expire = req.greg_expire if wide else req.greg_expire_delta
    values = np.stack([np.asarray(v, np.int64 if wide else np.int32) for v in (
        req.hits, req.limit, req.duration, greg_expire, req.greg_duration)])[None]
    return np.ascontiguousarray(lanes), np.ascontiguousarray(values)


def _shard_device(state: BucketState) -> torch.device:
    if state.hot.dim() != 3 or state.hot.shape[0] != 1:
        raise ValueError(f"a one-shard state is [1, C, 8], got {tuple(state.hot.shape)}")
    return state.hot.device


def _put(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _wire_row(wire, device) -> torch.Tensor:
    """A one-shard wire, i32[3P + 3072] (tensor or host array), as the
    kernels' [1, W] on `device`."""
    w = wire if isinstance(wire, torch.Tensor) else torch.from_numpy(np.asarray(wire, np.int32))
    return w.to(device).reshape(1, -1).contiguous()


def unpack_output(packed):
    """Host decode of a wide packed i64[4, P] (the JAX package's
    unpack_output): (status, removed, remaining, reset_time,
    new_expire)."""
    row0 = packed[0]
    return ((row0 & 1).astype("int32"), (row0 >> 1).astype(bool),
            packed[1], packed[2], packed[3])


def apply_batch(state: BucketState, req: RequestBatch, now_ms: int) -> BatchOutput:
    """The JAX package's apply_batch on one shard: one round of a wide
    batch through K2 (round 0 for every lane), slots unique; the
    BatchOutput is rebuilt on the host from the packed i64[4, P], the
    limit echoed from the request.  The packed output carries no
    pre-round expiry, so `pre_expire` is None."""
    dev = _shard_device(state)
    lanes, values = batch_columns(req)
    packed = bucket_rounds_cols(state.hot, state.cold, _put(lanes, dev), _put(values, dev),
                                1, now_ms, True)[0].cpu().numpy()
    status, removed, remaining, reset, new_expire = unpack_output(packed)
    slot = np.asarray(req.slot)
    return BatchOutput(status=status, limit=np.where(slot >= 0, np.asarray(req.limit), 0),
                       remaining=remaining, reset_time=reset, new_expire=new_expire,
                       removed=removed, pre_expire=None)


def apply_rounds_packed_fused(state: BucketState, wires, n_rounds_vec, now_vec,
                              wide: bool = False):
    """The JAX package's apply_rounds_packed_fused: K same-shape wires
    applied in order (batch i + 1 sees the state batch i left), K
    launches of K1 on one stream into one stacked result [K, 4, P]."""
    dev = _shard_device(state)
    ws = [_wire_row(w, dev) for w in wires]
    P = (ws[0].shape[1] - DICT_WIRE_TABLE_WORDS) // 3
    out = torch.empty((len(ws), 1, 4, P), device=dev,
                      dtype=torch.int64 if wide else torch.int32)
    for i, w in enumerate(ws):
        bucket_rounds_dict(state.hot, state.cold, w, int(n_rounds_vec[i]),
                           int(now_vec[i]), wide, out=out[i])
    return out[:, 0]


def apply_compact32(state: BucketState, req32: RequestBatch32, wlane, now_ms: int):
    """The JAX package's apply_compact32 on one shard (K10 on narrow
    columns): a single-round batch, every lane evaluated, only the rows
    of the lanes in `wlane` i32[Pw] (-1 padded) written; returns the
    narrow i32[4, P]."""
    dev = _shard_device(state)
    lanes, values = batch_columns(req32)
    wl = _put(np.asarray(wlane, np.int32).reshape(1, -1), dev)
    return compact_cols(state.hot, state.cold, _put(lanes, dev), _put(values, dev),
                        wl, now_ms)[0]


def apply_compact_packed(state: BucketState, wire, wlane, now_ms: int):
    """The JAX package's apply_compact_packed on one shard (K10 on the
    dict wire, its round ids ignored); returns the narrow i32[4, P]."""
    dev = _shard_device(state)
    wl = _put(np.asarray(wlane, np.int32).reshape(1, -1), dev)
    return compact_dict(state.hot, state.cold, _wire_row(wire, dev), wl, now_ms)[0]


# ---------------------------------------------------------------------
# Row gather / scatter (the persistence plane: snapshots, restores, the
# Store and Loader SPIs).  Lanes are i32[2, ...] = (shard, slot); a lane
# whose shard or slot is out of range reads zeros and writes nothing.
# ---------------------------------------------------------------------
def rows_to_split(rows: BucketRows) -> BucketState:
    """Logical rows -> hot/cold i32[..., 8] rows (the JAX package's
    rows_to_split): the whole row, spare words zero."""
    def t(v):
        return torch.as_tensor(v).to(_I64)

    algo, status = t(rows.algo), t(rows.status)
    remaining, stamp, expire = t(rows.remaining), t(rows.stamp), t(rows.expire_at)
    limit, duration = t(rows.limit), t(rows.duration)
    flags = ((algo & 3) | ((status & 1) << 2)).to(_I32)
    z = torch.zeros_like(flags)
    hot = torch.stack((
        flags, _lo32(remaining), _hi32(remaining), _lo32(stamp), _hi32(stamp),
        _lo32(expire), _hi32(expire), z,
    ), dim=-1)
    cold = torch.stack((
        _lo32(limit), _hi32(limit), _lo32(duration), _hi32(duration), z, z, z, z,
    ), dim=-1)
    return BucketState(hot=hot, cold=cold)


def _lane_index(hot, lanes):
    S, C = hot.shape[0], hot.shape[1]
    shard, slot = lanes[0].to(_I64), lanes[1].to(_I64)
    live = (shard >= 0) & (shard < S) & (slot >= 0) & (slot < C)
    return live, torch.where(live, shard, 0), torch.where(live, slot, 0)


def read_rows_plain(hot, cold, lanes):
    """Plain version of the row gather K7 (the JAX package's read_rows,
    through _gather_rows_mesh_jit for [S, P] slots): the full rows at
    `lanes` i32[2, ...] composed into c32 i32[2, ...] (algo, status) and
    c64 i64[5, ...] (limit, remaining, duration, stamp, expire_at).
    Out-of-range lanes read zeros (JAX's gather would wrap a -1 slot to
    the last row; no caller reads a padding lane)."""
    live, s, c = _lane_index(hot, lanes)
    h, k = hot[s, c], cold[s, c]
    flags = h[..., _H_FLAGS].to(_I64)
    c32 = torch.stack((flags & 3, (flags >> 2) & 1))
    c64 = torch.stack((
        _compose64(k[..., _C_LIM_LO], k[..., _C_LIM_HI]),
        _compose64(h[..., _H_REM_LO], h[..., _H_REM_HI]),
        _compose64(k[..., _C_DUR_LO], k[..., _C_DUR_HI]),
        _compose64(h[..., _H_STAMP_LO], h[..., _H_STAMP_HI]),
        _compose64(h[..., _H_EXP_LO], h[..., _H_EXP_HI]),
    ))
    return torch.where(live, c32, 0).to(_I32), torch.where(live, c64, 0)


def write_rows_plain(hot, cold, lanes, c32, c64) -> None:
    """Plain version of the row scatter K8 (the JAX package's write_rows
    and rows_to_split, through _write_rows_mesh_jit / _write_row_jit):
    split each lane's logical row and write its whole hot and cold rows
    in place; out-of-range lanes are dropped.  The in-range lanes must
    name distinct (shard, slot) pairs (last_lane_per_slot makes them
    so): two writes of one row would race on the card."""
    live, s, c = _lane_index(hot, lanes)
    C = hot.shape[1]
    key = (s * C + c)[live]
    if torch.unique(key).numel() != key.numel():
        raise ValueError("write_rows: a (shard, slot) appears more than once")
    split = rows_to_split(cols_to_rows(c32, c64))
    hot[s[live], c[live]] = split.hot[live]
    cold[s[live], c[live]] = split.cold[live]


def _flat_lanes(lanes):
    if lanes.dim() < 2 or lanes.shape[0] != 2:
        raise ValueError(f"lanes must be [2, ...], got {tuple(lanes.shape)}")
    return lanes.reshape(2, -1).contiguous()


def gather_rows(hot, cold, lanes):
    """The full rows at `lanes` i32[2, ...] (shard, slot): (c32, c64) of
    shapes [2, ...] and [5, ...] (see read_rows_plain)."""
    if _route(hot) == "cuda":
        from . import _kernels

        dims = lanes.shape[1:]
        c32, c64 = _kernels.gather_rows(hot, cold, _flat_lanes(lanes))
        return c32.reshape(2, *dims), c64.reshape(5, *dims)
    return read_rows_plain(hot, cold, lanes)


def write_rows(hot, cold, lanes, c32, c64) -> None:
    """Write whole rows at `lanes` i32[2, ...] from (c32, c64), in place
    (see write_rows_plain)."""
    if _route(hot) == "cuda":
        from . import _kernels

        _kernels.write_rows(hot, cold, _flat_lanes(lanes),
                            c32.reshape(2, -1).contiguous(),
                            c64.reshape(5, -1).contiguous())
        return
    write_rows_plain(hot, cold, lanes, c32, c64)


# ---------------------------------------------------------------------
# The two-tier table's back tier and its moves.  Kernel lanes address
# only the front table (BucketState); rows move between the tiers in
# host-planned windows of promotions and demotions (the native Table's
# two-tier mode), applied by `apply_moves` before any launch that reads
# front rows.
# ---------------------------------------------------------------------
class BackState(NamedTuple):
    """Back tier of the two-tier bucket table: hot and cold int32
    [S, Cb, 8], the BucketState row layout.  Only the move launch
    writes it; the snapshot path reads it (read_back_rows)."""

    hot: torch.Tensor
    cold: torch.Tensor


def init_back(n_shards: int, capacity: int, device) -> BackState:
    """A zeroed back tier of `capacity` rows per shard."""
    return BackState(*init_state(n_shards, capacity, device))


# Move record kinds (the low two bits of a record's op word).
MOVE_PROMOTE_BACK = 0  # back[src] -> front[dst]
MOVE_PROMOTE_FRONT = 1  # front[src] -> front[dst] (demoted and re-promoted in one window)
MOVE_DEMOTE = 2  # front[src] -> back[dst]


def moves_to_records(moves) -> np.ndarray:
    """One drain window of every shard's queued moves as flat records
    i32[3, N] = (op = shard << 2 | kind, src, dst).  `moves[s]` is shard
    s's (promo_kind, promo_src, promo_dst, demo_src, demo_dst) from
    NativeSlotTable.take_moves; cancelled records (src -1) are left
    out.  One device holds every shard, so the list needs none of the
    JAX store's [S, pow2] padding."""
    parts = []
    for s, (pk, ps, pd, ds, dd) in enumerate(moves):
        pk, ps, pd, ds, dd = (np.asarray(a, np.int64) for a in (pk, ps, pd, ds, dd))
        d, p = ds >= 0, ps >= 0
        parts.append(np.stack([(s << 2) | np.full(int(d.sum()), MOVE_DEMOTE), ds[d], dd[d]]))
        parts.append(np.stack([(s << 2) | pk[p], ps[p], pd[p]]))
    if not parts:
        return np.zeros((3, 0), np.int32)
    return np.ascontiguousarray(np.concatenate(parts, axis=1), dtype=np.int32)


def _move_index(hot, back_hot, records):
    """(live, shard, kind, src, dst) of each record; a record whose
    kind, shard, source or destination is out of range is not live."""
    S, C, Cb = hot.shape[0], hot.shape[1], back_hot.shape[1]
    op, src, dst = records.to(_I64)
    shard, kind = op >> 2, op & 3
    src_cap = torch.where(kind == MOVE_PROMOTE_BACK, Cb, C)
    dst_cap = torch.where(kind == MOVE_DEMOTE, Cb, C)
    live = ((kind <= MOVE_DEMOTE) & (shard >= 0) & (shard < S) & (src >= 0)
            & (src < src_cap) & (dst >= 0) & (dst < dst_cap))
    return live, shard[live], kind[live], src[live], dst[live]


def apply_moves_plain(hot, cold, back_hot, back_cold, records) -> None:
    """Plain version of the tier move K9 (the JAX package's
    buckets.apply_moves, through _moves_mesh_jit): apply one drain
    window of records i32[3, N] (moves_to_records) in place.  Every
    source row is read before any destination is written, so demotions
    take PRE-promotion front rows and promotions take pre-demotion back
    rows (kind 0) or front rows (kind 1), whatever the records' order.
    Records that are not live (a negative source) do nothing.  The live
    records must name distinct destinations (the host's
    cancel_pending_demo makes them so): two writes of one row would
    race on the card."""
    live, sh, kind, src, dst = _move_index(hot, back_hot, records)
    C, Cb = hot.shape[1], back_hot.shape[1]
    demote = kind == MOVE_DEMOTE
    key = (sh * 2 + demote.to(_I64)) * max(C, Cb) + dst
    if torch.unique(key).numel() != key.numel():
        raise ValueError("apply_moves: a destination row appears more than once")
    from_back = (kind == MOVE_PROMOTE_BACK)[:, None]
    fsrc, bsrc = src.clamp(max=C - 1), src.clamp(max=Cb - 1)
    rows_hot = torch.where(from_back, back_hot[sh, bsrc], hot[sh, fsrc])
    rows_cold = torch.where(from_back, back_cold[sh, bsrc], cold[sh, fsrc])
    up = ~demote
    hot[sh[up], dst[up]] = rows_hot[up]
    cold[sh[up], dst[up]] = rows_cold[up]
    back_hot[sh[demote], dst[demote]] = rows_hot[demote]
    back_cold[sh[demote], dst[demote]] = rows_cold[demote]


def apply_moves(state: BucketState, back: BackState, records) -> None:
    """Apply one drain window of tier moves (records i32[3, N]) to the
    front and back tables in place (see apply_moves_plain)."""
    if _route(state.hot) == "cuda":
        from . import _kernels

        _kernels.apply_moves(state.hot, state.cold, back.hot, back.cold, records)
        return
    apply_moves_plain(state.hot, state.cold, back.hot, back.cold, records)


def read_back_rows(back: BackState, lanes):
    """The full rows of the back tier at `lanes` i32[2, ...] (shard,
    back slot): the row gather on the back tensors, (c32, c64) as
    gather_rows gives them (the JAX package's read_back_rows)."""
    if _route(back.hot) == "cuda":
        from . import _kernels

        dims = lanes.shape[1:]
        c32, c64 = _kernels.gather_rows(back.hot, back.cold, _flat_lanes(lanes),
                                        count="gather_back_rows")
        return c32.reshape(2, *dims), c64.reshape(5, *dims)
    return read_rows_plain(back.hot, back.cold, lanes)
