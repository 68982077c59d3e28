"""GLOBAL-behavior device state and programs: replica columns, hit
accumulators, the answer program and the sync program.

The port of the JAX package's ops/global_ops.py (see it for the
reference model: replica caches answer non-owner lanes, hits accumulate
per shard, a sync aggregates them at the owner and broadcasts the
owner's status back).  Where the JAX package runs one program per shard
under vmap or shard_map, the port keeps the S shards as the leading
dimension of every tensor on one device: the replica columns are
[S, G], and a psum over the mesh axis is a sum over dim 0.

Every device function has two implementations:

* a CUDA kernel (csrc/global_ops.cu, bound in ops/_kernels.py), which
  the dispatch functions `answer_rounds`, `global_sync`, `set_replica`
  and `clear_gslots` launch for CUDA tensors;
* a plain PyTorch version (`*_plain`), a straight transcription of the
  JAX program, which the dispatch functions take for CPU tensors and
  which the chip smoke test holds the kernels against on the card.

State is updated in place (the JAX package donates and returns it).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import buckets
from .buckets import BucketState, RequestBatch

_I64 = torch.int64
_I32 = torch.int32


class GlobalColumns(NamedTuple):
    """Per-shard GLOBAL state, [S, G] each: the owner's last broadcast
    status (rep_*, a replica entry expiring at rep_expire) and the hits
    answered locally and not yet synced (ghits)."""

    rep_status: torch.Tensor  # i32
    rep_limit: torch.Tensor  # i64
    rep_remaining: torch.Tensor  # i64
    rep_reset: torch.Tensor  # i64
    rep_expire: torch.Tensor  # i64
    ghits: torch.Tensor  # i64


class SyncConfig(NamedTuple):
    """Per-gslot apply config of a sync, host-provided ([G] each): the
    host mirrors the last-seen request config of every GLOBAL key."""

    owner_slot: np.ndarray  # i32, -1 = unresolved
    owner_shard: np.ndarray  # i32, -1 = owned by a remote daemon
    algorithm: np.ndarray  # i32
    behavior: np.ndarray  # i32 (GLOBAL bit stripped)
    limit: np.ndarray  # i64
    duration: np.ndarray  # i64
    greg_expire: np.ndarray  # i64
    greg_duration: np.ndarray  # i64

    def pack(self) -> np.ndarray:
        """The config as one i64[8, G] array (one upload per sync), rows
        in field order."""
        return np.stack([np.asarray(c, dtype=np.int64) for c in self])


def init_global_columns(n_shards: int, g_capacity: int, device) -> GlobalColumns:
    z = dict(device=device)
    shape = (n_shards, g_capacity)
    return GlobalColumns(
        rep_status=torch.zeros(shape, dtype=_I32, **z),
        rep_limit=torch.zeros(shape, dtype=_I64, **z),
        rep_remaining=torch.zeros(shape, dtype=_I64, **z),
        rep_reset=torch.zeros(shape, dtype=_I64, **z),
        rep_expire=torch.zeros(shape, dtype=_I64, **z),
        ghits=torch.zeros(shape, dtype=_I64, **z),
    )


def global_columns_from_numpy(cols, device) -> GlobalColumns:
    """Replica columns from host arrays, in field order (for example the
    JAX store's `[np.asarray(c) for c in store.gcols]`)."""
    cols = list(cols)
    if len(cols) != len(GlobalColumns._fields):
        raise ValueError(f"need {len(GlobalColumns._fields)} columns, got {len(cols)}")
    dtypes = (np.int32,) + (np.int64,) * 5
    out = [torch.from_numpy(np.array(c, dtype=dt)).to(device)
           for c, dt in zip(cols, dtypes)]
    if any(t.dim() != 2 or t.shape != out[0].shape for t in out):
        raise ValueError("replica columns must all be [S, G]")
    return GlobalColumns(*out)


# ---------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------
def _lanes_request(lanes, values) -> RequestBatch:
    """A RequestBatch from the per-lane-column wire: lanes i32[S, 6, P]
    (slot, exists | write << 1, algorithm, behavior, occ, round_id),
    values i64[S, 5, P] (hits, limit, duration, greg_expire,
    greg_duration)."""
    ln = lanes.to(_I64)
    v = values.to(_I64)
    return RequestBatch(
        slot=ln[:, 0], exists=(ln[:, 1] & 1) != 0, algorithm=ln[:, 2],
        behavior=ln[:, 3], hits=v[:, 0], limit=v[:, 1], duration=v[:, 2],
        greg_expire=v[:, 3], greg_duration=v[:, 4], occ=ln[:, 4],
        write=(ln[:, 1] & 2) != 0,
    )


def answer_rounds_plain(hot, cold, gcols: GlobalColumns, lanes, values, gslot,
                        n_rounds: int, now_ms: int):
    """Plain version of K3 (the JAX package's _answer_rounds_jit: a loop
    over rounds of global_ops.answer_batch, vmapped over S).  `gslot`
    i32[S, P] is the JAX GlobalBatchExtra column: the process-wide GLOBAL
    key id of a lane at a non-owner shard, else -1.  Round r's lanes
    (round_id == r): a GLOBAL lane (gslot >= 0) whose replica
    entry is live (rep_expire >= now) answers from rep_* and touches no
    bucket; the others evaluate against the bucket tables; every GLOBAL
    lane adds its hits to ghits.  Updates hot/cold and ghits in place;
    returns i64[S, 5, P]: status | removed << 1 | cached << 2, limit,
    remaining, reset_time, new_expire (zeros for lanes no round runs)."""
    req = _lanes_request(lanes, values)
    rid = lanes[:, 5].to(_I64)
    gs_all = gslot.to(_I64)
    S, P = req.slot.shape
    G = gcols.ghits.shape[1]
    now = int(now_ms)
    sidx = torch.arange(S, device=hot.device)[:, None].expand(S, P)
    state = BucketState(hot, cold)
    packed = torch.zeros((S, 5, P), dtype=_I64, device=hot.device)
    for r in range(n_rounds):
        active = rid == r
        gs = torch.where(active, gs_all, -1)
        has_g = gs >= 0
        g = torch.clamp(gs, 0, G - 1)
        cached = has_g & (gcols.rep_expire[sidx, g] >= now)
        slot = torch.where(active & ~cached, req.slot, -1)
        out = buckets.apply_batch_plain(state, req._replace(slot=slot), now)
        status = torch.where(cached, gcols.rep_status[sidx, g].to(_I64), out.status)
        row0 = status | (out.removed.to(_I64) << 1) | (cached.to(_I64) << 2)
        newp = torch.stack((
            row0,
            torch.where(cached, gcols.rep_limit[sidx, g], out.limit),
            torch.where(cached, gcols.rep_remaining[sidx, g], out.remaining),
            torch.where(cached, gcols.rep_reset[sidx, g], out.reset_time),
            out.new_expire,
        ), dim=1)
        packed = torch.where(active[:, None, :], newp, packed)
        # Out-of-range gslots are dropped, never wrapped (JAX's
        # mode="drop"); integer addition commutes, so duplicates are safe.
        add = has_g & (gs < G)
        gcols.ghits.index_put_((sidx[add], gs[add]), req.hits[add], accumulate=True)
    return packed


def global_sync_plain(hot, cold, gcols: GlobalColumns, cfg, dirty, now_ms: int):
    """Plain version of K4 (the JAX package's global_sync under
    shard_map; every psum is a sum over the shard dim).  `cfg` is the
    packed i64[8, G] SyncConfig, `dirty` bool[S, G].  The owner shard of
    each active gslot (hits synced, or dirty at the owner) applies the
    summed hits to its bucket; its answer is broadcast into every
    shard's replica columns; ghits reset.  Returns i64[S, 8, G]:
    removed | applied << 1, new_expire, total hits, then each shard's
    rep_status, rep_limit, rep_remaining, rep_reset, rep_expire."""
    S, G = gcols.ghits.shape
    now = int(now_ms)
    owner_slot, owner_shard, algo, beh, limit, duration, ge, gd = cfg.to(_I64)
    total = gcols.ghits.sum(dim=0)  # psum(ghits)
    shard = torch.arange(S, device=hot.device)[:, None]
    mine = owner_shard[None, :] == shard  # [S, G]
    any_dirty = (mine & dirty).any(dim=0)
    active = (total > 0) | any_dirty
    apply_mask = mine & active & (owner_slot >= 0)

    def lanes(v):
        return v[None, :].expand(S, G)

    req = RequestBatch(
        slot=torch.where(apply_mask, owner_slot, -1), exists=apply_mask,
        algorithm=lanes(algo), behavior=lanes(beh), hits=lanes(total),
        limit=lanes(limit), duration=lanes(duration), greg_expire=lanes(ge),
        greg_duration=lanes(gd), occ=torch.zeros_like(apply_mask, dtype=_I64),
        write=apply_mask,
    )
    out = buckets.apply_batch_plain(BucketState(hot, cold), req, now)

    def bcast(v):  # exactly one shard owns each gslot: a masked psum
        return torch.where(apply_mask, v, 0).sum(dim=0)

    applied = apply_mask.any(dim=0)
    b_reset = bcast(out.reset_time)
    new = (
        torch.where(applied, bcast(out.status).to(_I32), gcols.rep_status),
        torch.where(applied, bcast(out.limit), gcols.rep_limit),
        torch.where(applied, bcast(out.remaining), gcols.rep_remaining),
        torch.where(applied, b_reset, gcols.rep_reset),
        # a replica entry expires at ResetTime
        torch.where(applied, b_reset, gcols.rep_expire),
    )
    for dst, src in zip(gcols, new):
        dst.copy_(src)
    gcols.ghits.zero_()
    return torch.stack((
        out.removed.to(_I64) | (applied.to(_I64) << 1)[None, :],
        out.new_expire,
        lanes(total),
        *(c.to(_I64) for c in new),
    ), dim=1)


def set_replica_plain(gcols: GlobalColumns, upd) -> None:
    """Plain version of K5 (the JAX package's set_replica vmapped over
    S): upd i64[5, M] = gslot, status, limit, remaining, reset; writes
    rep_status/limit/remaining/reset and rep_expire = reset at each
    in-range gslot of every shard."""
    G = gcols.rep_status.shape[1]
    g, status, limit, remaining, reset = upd
    keep = (g >= 0) & (g < G)
    g = g[keep]
    for col, v in ((gcols.rep_status, status.to(_I32)), (gcols.rep_limit, limit),
                   (gcols.rep_remaining, remaining), (gcols.rep_reset, reset),
                   (gcols.rep_expire, reset)):
        col[:, g] = v[keep]


def clear_gslots_plain(gcols: GlobalColumns, idx) -> None:
    """Plain version of K6 (the JAX package's clear_gslots vmapped over
    S): zero the six columns at the in-range indices of idx i64[K]."""
    G = gcols.rep_status.shape[1]
    idx = idx[(idx >= 0) & (idx < G)]
    for col in gcols:
        col[:, idx] = 0


# ---------------------------------------------------------------------
# Dispatch: the kernel for CUDA tensors, the plain version for CPU
# tensors, nothing else.
# ---------------------------------------------------------------------
def answer_rounds(hot, cold, gcols: GlobalColumns, lanes, values, gslot,
                  n_rounds: int, now_ms: int):
    """Run every round of one dataclass-path batch (in place); returns
    the packed i64[S, 5, P] answers (see answer_rounds_plain)."""
    if buckets._route(hot) == "cuda":
        from . import _kernels

        return _kernels.global_answer_rounds(hot, cold, gcols, lanes, values,
                                             gslot, n_rounds, now_ms)
    return answer_rounds_plain(hot, cold, gcols, lanes, values, gslot, n_rounds,
                               now_ms)


def global_sync(hot, cold, gcols: GlobalColumns, cfg, dirty, now_ms: int):
    """One GLOBAL sync (in place); returns the packed i64[S, 8, G]
    result (see global_sync_plain)."""
    if buckets._route(hot) == "cuda":
        from . import _kernels

        return _kernels.global_sync(hot, cold, gcols, cfg, dirty, now_ms)
    return global_sync_plain(hot, cold, gcols, cfg, dirty, now_ms)


def set_replica(gcols: GlobalColumns, gslots, status, limit, remaining, reset) -> None:
    """Write owner-broadcast statuses into every shard's replica columns
    (the receive side of UpdatePeerGlobals): host arrays of one length
    M, gslot -1 (or >= G) lanes dropped.  A gslot may appear once: the
    caller keeps the last lane per key, since concurrent writes of one
    gslot would not order as the JAX program's scatter does."""
    g = np.asarray(gslots, dtype=np.int64)
    valid = g[(g >= 0) & (g < gcols.rep_status.shape[1])]
    if np.unique(valid).size != valid.size:
        raise ValueError("set_replica: a gslot appears more than once")
    upd = np.stack([g] + [np.asarray(c, dtype=np.int64)
                          for c in (status, limit, remaining, reset)])
    upd_t = torch.from_numpy(upd).to(gcols.rep_status.device)
    if buckets._route(gcols.rep_status) == "cuda":
        from . import _kernels

        _kernels.set_replica(gcols, upd_t)
    else:
        set_replica_plain(gcols, upd_t)


def clear_gslots(gcols: GlobalColumns, idx) -> None:
    """Zero the rows of recycled gslots in every shard (host array;
    indices >= G are padding and dropped).  A negative index raises: the
    JAX program would wrap it to the last rows, and no caller means
    that."""
    idx = np.asarray(idx, dtype=np.int64)
    if (idx < 0).any():
        raise ValueError("clear_gslots: negative gslot index")
    idx_t = torch.from_numpy(idx).to(gcols.rep_status.device)
    if buckets._route(gcols.rep_status) == "cuda":
        from . import _kernels

        _kernels.clear_gslots(gcols, idx_t)
    else:
        clear_gslots_plain(gcols, idx_t)
