"""Edge-partitioned blocked walks: the graph-sharded engine (port of
``node2vec_tpu/parallel/edge_partitioned_blocked.py``).

Shard ``s`` of the data axis owns the vertex range ``[s·Vp, (s+1)·Vp)`` as
its own blocked tables (``walk/blocked.py``: light rows and heavy headers,
heavy blocks, block ids, (rev±, pfx) pairs), so a rank holds O(E/S + V/S·4P)
of the adjacency whatever the degrees.  Owners hold everything a step
needs: owner(cur) serves the prev-excluded proposal and owner(prev) the
membership test, and walkers carry only scalars.

A superstep is two request/response rounds over the data axis
(``Mesh.all_to_all``), each walker at most one attempt:

1. **bucket** (K20 ``ep_bucket``, home): each active walker is ranked
   within its destination owner(cur) in lane order; lanes past
   ``capacity`` defer and consume no draw.  The 7-field request carries
   cur, prev, the back edge's weight with its triangle bit, the back
   prefix, and the uniforms at counters 4·att + 0 and + 1;
2. **propose** (K21 ``ep_propose``, owner(cur)): the return branch, or the
   prev-excluded inverse CDF over the light row or the heavy header and one
   block, on local tables; the candidate with its weight, reverse metadata
   and prefixes comes back;
3. **membership** (q != 1; K20 again for the 2-field request, then K22
   ``ep_member`` at owner(prev)): is the candidate in N(prev)?  A lane that
   cannot send here defers its whole attempt;
4. **advance** (K23, home): acceptance against the uniform at 4·att + 2,
   the trial cap and its counted fallbacks, the path write, the carried
   edge metadata, and the count of walkers still pending.  It runs in one
   launch with the next superstep's step 1 (``ep_advance_bucket``): a
   chunk's first ranking is a prologue, and each superstep ends by
   advancing and ranking the next (the ranking consumes no draw and leaves
   the state as it is, so the walks are unchanged).

Draws are keyed on (seed, global walker id, attempt), and a deferred
attempt replays with the same counter, so the walks equal the
single-device blocked engine's.  JAX loops in a ``while_loop`` whose
condition is a psum of the pending walkers; here the host loops, and reads
the all-reduced pending count every ``PENDING_CHECK_EVERY`` supersteps: a
superstep with no pending walker changes nothing, and the loop never runs
past ``slack·walk_length·(1 if q <= 1 else 4) + 16`` supersteps.  Walkers
unfinished at that bound are returned as a count, never cut silently.

Each rank keeps its data coordinate's shard (``partition_blocked_graph``
and ``load_partitioned_graph`` with a mesh); ranks of one data coordinate
hold the same shard, as JAX's ``P(axis, None)`` gives.  The ``.npz`` +
``meta.json`` files are the JAX package's.  CPU tensors take the kernels'
plain versions; CUDA tensors launch the kernels or raise.
``edge_partitioned_blocked_walk_plain`` runs the plain versions on any
device.
"""

from __future__ import annotations

import json
import os
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from node2vec_torch import _build
from node2vec_torch.ops.hashrng import hash_uniform
from node2vec_torch.ops.sampling import prefix_sums
from node2vec_torch.parallel.sharded_walk import shard_block
from node2vec_torch.walk.blocked import (
    KERNEL_MAX_C,
    KERNEL_MAX_P,
    PAD_ID,
    QUADS_PER_ROW,
    _MAG,
    _PAD,
    _edge_metadata,
    _edge_metadata_ranged,
    _f32,
    _max_blocks,
    _pack_range,
    _pick,
    _table_widths,
)

# rows of the carried walker state, one int32 row each (floats as their bits)
T, CUR, PREV, W_FWD, FWD_PFX, W_BACK_ENC, BACK_PFX, ALIVE, TRIALS, ATT = range(10)
CARRY_ROWS = 10
PROPOSE_FIELDS = 7  # cur, prev, w_back_enc, back_pfx, u_branch, u_prop, t
MEMBER_FIELDS = 2  # prev, cand
RESPONSE_FIELDS = 6  # cand, w, rev_enc, pfx, ppfx, take_back
PENDING_CHECK_EVERY = 4
# K20's and K24's per-warp destination counts (bucket_common.cuh) live in shared memory
KERNEL_MAX_SHARDS = 256
_SIGN = -(1 << 31)


class PartitionedBlockedGraph(NamedTuple):
    """Per-shard blocked tables, stacked shard-major (JAX's layout).

    ``shards``: the shard indices the tables hold, in order (None: every
    shard).  With a mesh a rank holds its data coordinate's shard alone."""

    light: torch.Tensor  # [n_held*Vp, 4P rounded to 128] int32
    biw: torch.Tensor  # [n_held*NBp, 2C]
    bids: torch.Tensor  # [n_held*NBp, C]
    brp: torch.Tensor  # [n_held*NBp*C/64, 128]
    rows_per_shard: int  # Vp
    blocks_per_shard: int  # NBp
    light_width: int
    block_width: int
    n_vertices: int
    shards: Optional[Tuple[int, ...]] = None


class _Prepared(NamedTuple):
    """The CSR padded with isolated vertices to full ranges, its per-edge
    metadata, and the shapes every shard shares."""

    indptr: np.ndarray
    indices: np.ndarray
    weights: np.ndarray
    rev_enc: np.ndarray
    pfx: np.ndarray
    light_width: int
    block_width: int
    rows_per_shard: int
    blocks_per_shard: int
    n_vertices: int

    def meta(self) -> dict:
        return dict(rows_per_shard=self.rows_per_shard, blocks_per_shard=self.blocks_per_shard,
                    light_width=self.light_width, block_width=self.block_width,
                    n_vertices=self.n_vertices)


def _prepare(indptr, indices, weights, n_shards: int, light_width, block_width,
             ranged_metadata: bool) -> _Prepared:
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int32)
    weights = np.asarray(weights, dtype=np.float32)
    n_v = len(indptr) - 1
    p_l, c = _table_widths(indptr, light_width, block_width)
    if ranged_metadata:
        rev_enc, pfx = _edge_metadata_ranged(indptr, indices, weights, n_shards)
    else:
        rev_enc, pfx = _edge_metadata(indptr, indices, weights)
    v_p = -(-n_v // n_shards)
    if n_shards * v_p > n_v:
        indptr = np.concatenate([indptr, np.full(n_shards * v_p - n_v, indptr[-1], np.int64)])
    deg = np.diff(indptr)
    heavy_blocks = np.where(deg > p_l, -(-deg // c), 0)
    nb_p = max(max(int(heavy_blocks[s * v_p: (s + 1) * v_p].sum()) for s in range(n_shards)), 1)
    return _Prepared(indptr, indices, weights, rev_enc, pfx, p_l, c, v_p, nb_p, n_v)


def _shard_tables(prep: _Prepared, s: int):
    """Shard ``s``'s (light, biw, bids, brp), padded to the common block count."""
    indptr, indices, weights, rev_enc, pfx, p_l, c, v_p, nb_p, _ = prep
    light, b_iw, b_ids, b_rp = _pack_range(indptr, indices, weights, rev_enc, pfx,
                                           s * v_p, (s + 1) * v_p, p_l, c)
    biw = np.full((nb_p, 2 * c), PAD_ID, np.int32)
    biw[:, c:] = np.float32(0.0).view(np.int32)
    biw[: b_iw.shape[0]] = b_iw
    bids = np.full((nb_p, c), PAD_ID, np.int32)
    bids[: b_ids.shape[0]] = b_ids
    brp = np.zeros((nb_p * c // QUADS_PER_ROW, 128), np.int32)
    brp[: b_rp.shape[0]] = b_rp
    return light, biw, bids, brp


def _stack(parts, device, meta: dict, shards) -> PartitionedBlockedGraph:
    tables = [torch.from_numpy(np.ascontiguousarray(np.concatenate([p[i] for p in parts])))
              .to(device) for i in range(4)]
    return PartitionedBlockedGraph(
        *tables, rows_per_shard=meta["rows_per_shard"],
        blocks_per_shard=meta["blocks_per_shard"], light_width=meta["light_width"],
        block_width=meta["block_width"], n_vertices=meta["n_vertices"],
        shards=None if shards is None else tuple(int(s) for s in shards))


def partition_blocked_graph(
    indptr: np.ndarray,
    indices: np.ndarray,
    weights: np.ndarray,
    n_shards: int,
    light_width: int | None = None,
    block_width: int | None = None,
    mesh=None,
    axis_name: str = "data",
    ranged_metadata: bool = False,
) -> PartitionedBlockedGraph:
    """Range-partition a CSR graph into per-shard blocked tables.

    Per-edge reverse metadata is computed over the whole graph (reverse edges
    cross shards), or one vertex range at a time with ``ranged_metadata``
    (exact triangle bits either way, so the walks agree).  With ``mesh``
    only this rank's data shard is packed, onto the mesh's device; without
    one every shard is kept, stacked, in CPU tensors."""
    prep = _prepare(indptr, indices, weights, n_shards, light_width, block_width,
                    ranged_metadata)
    meta = prep.meta()
    if mesh is None:
        return _stack([_shard_tables(prep, s) for s in range(n_shards)], "cpu", meta, None)
    if mesh.shape[axis_name] != n_shards:
        raise ValueError(f"{n_shards} shards on a '{axis_name}' axis of {mesh.shape[axis_name]}")
    mine = mesh.coords[axis_name]
    return _stack([_shard_tables(prep, mine)], mesh.device, meta, (mine,))


def save_partitioned_graph(
    path: str,
    indptr: np.ndarray,
    indices: np.ndarray,
    weights: np.ndarray,
    n_shards: int,
    light_width: int | None = None,
    block_width: int | None = None,
    ranged_metadata: bool = False,
) -> None:
    """Pack per-range blocked shards to disk: ``shard_{s:05d}.npz`` (light,
    biw, bids, brp) and ``meta.json``, the JAX package's files, read back
    shard by shard with ``load_partitioned_graph``."""
    prep = _prepare(indptr, indices, weights, n_shards, light_width, block_width,
                    ranged_metadata)
    os.makedirs(path, exist_ok=True)
    for s in range(n_shards):
        light, biw, bids, brp = _shard_tables(prep, s)
        np.savez_compressed(os.path.join(path, f"shard_{s:05d}.npz"),
                            light=light, biw=biw, bids=bids, brp=brp)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"n_shards": n_shards, **prep.meta()}, f)


def load_partitioned_graph(
    path: str,
    mesh=None,
    shards: Optional[Sequence[int]] = None,
    axis_name: str = "data",
) -> PartitionedBlockedGraph:
    """Load shards written by ``save_partitioned_graph`` (either package's).

    ``shards`` picks the files read.  With ``mesh`` it defaults to this
    rank's data shard and the tables go to the mesh's device; without one to
    every shard, in CPU tensors."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if shards is None and mesh is not None:
        if mesh.shape[axis_name] != meta["n_shards"]:
            raise ValueError(f"{meta['n_shards']} shards on a '{axis_name}' axis of "
                             f"{mesh.shape[axis_name]}")
        shards = (mesh.coords[axis_name],)
    held = None if shards is None else tuple(shards)
    parts = []
    for s in range(meta["n_shards"]) if held is None else held:
        with np.load(os.path.join(path, f"shard_{s:05d}.npz")) as d:
            parts.append([d[k] for k in ("light", "biw", "bids", "brp")])
    return _stack(parts, "cpu" if mesh is None else mesh.device, meta, held)


def local_tables(graph: PartitionedBlockedGraph, shard: int):
    """Shard ``shard``'s (light, biw, bids, brp) rows of ``graph``."""
    held = graph.shards if graph.shards is not None else range(
        graph.light.shape[0] // graph.rows_per_shard)
    if shard not in held:
        raise ValueError(f"the partitioned graph holds shards {tuple(held)}, not {shard}")
    i = list(held).index(shard)
    v_p, nb_p, c = graph.rows_per_shard, graph.blocks_per_shard, graph.block_width
    q_p = nb_p * c // QUADS_PER_ROW
    return (graph.light[i * v_p: (i + 1) * v_p], graph.biw[i * nb_p: (i + 1) * nb_p],
            graph.bids[i * nb_p: (i + 1) * nb_p], graph.brp[i * q_p: (i + 1) * q_p])


# --------------------------------------------------------------------------- #
# the superstep's four functions: plain versions
# --------------------------------------------------------------------------- #

def init_carry(starts: torch.Tensor) -> torch.Tensor:
    """The carried state [CARRY_ROWS, n] int32 of walkers at ``starts``:
    cur = start, prev = -1, alive where start >= 0, everything else 0."""
    n = starts.shape[0]
    carry = torch.zeros((CARRY_ROWS, n), dtype=torch.int32, device=starts.device)
    alive = starts >= 0
    carry[CUR] = torch.where(alive, starts, 0)
    carry[PREV] = -1
    carry[ALIVE] = alive.to(torch.int32)
    return carry


def _owner(v: torch.Tensor, rows_per_shard: int, n_shards: int) -> torch.Tensor:
    return torch.clamp(torch.div(v, rows_per_shard, rounding_mode="floor"), 0, n_shards - 1)


def ep_bucket_plain(carry, seed: int, gid_base: int, *, n_shards: int, capacity: int,
                    rows_per_shard: int, walk_length: int, slot_a=None, back=None):
    """``_bucket_by_dest`` (JAX ``:297``) and the request pack: (send
    [S·cap, F] int32, -1 where no lane was placed; slot [n] int32, the
    lane's flat slot or S·cap when it defers or sends nothing).

    Without ``slot_a`` the proposal requests (F = 7) go to owner(cur) of
    every active lane (alive, t < L), with the uniforms at 4·att + 0, + 1;
    with ``slot_a`` and ``back`` (the proposal round's slots and responses)
    the membership requests (F = 2: prev, cand) go to owner(prev) of each
    lane that sent, did not die, did not take the return edge and is past
    step 0."""
    n = carry.shape[1]
    dev = carry.device
    n_req = n_shards * capacity
    t, prev = carry[T], carry[PREV]
    if slot_a is None:
        active = (carry[ALIVE] != 0) & (t < walk_length)
        dest = torch.where(active, _owner(carry[CUR].clamp(min=0), rows_per_shard, n_shards), 0)
    else:
        sent = slot_a < n_req
        got = back[slot_a.clamp(0, n_req - 1).long()]
        take = got[:, 5] > 0
        died = sent & (got[:, 0] < 0) & ~take
        active = sent & ~died & ~take & (t != 0)
        dest = torch.where(active, _owner(prev.clamp(min=0), rows_per_shard, n_shards), 0)
    onehot = (dest[:, None] == torch.arange(n_shards, device=dev)[None, :]) & active[:, None]
    rank = torch.cumsum(onehot.to(torch.int64), dim=0) - 1
    mine = torch.where(onehot, rank, 0).sum(1)
    sendable = active & (mine < capacity)
    slot = torch.where(sendable, dest.long() * capacity + mine, n_req)
    if slot_a is None:
        gids = torch.arange(gid_base, gid_base + n, dtype=torch.int64, device=dev)
        ctr = (carry[ATT].long() & 0xFFFFFFFF) * 4
        u_branch = hash_uniform(seed, gids, ctr)
        u_prop = hash_uniform(seed, gids, ctr + 1)
        req = torch.stack([torch.where(sendable, carry[CUR], -1), prev, carry[W_BACK_ENC],
                           carry[BACK_PFX], u_branch.view(torch.int32),
                           u_prop.view(torch.int32), t], dim=1)
    else:
        req = torch.stack([torch.where(sendable, prev, -1), got[:, 0]], dim=1)
    send = torch.full((n_req + 1, req.shape[1]), -1, dtype=torch.int32, device=dev)
    send[slot[sendable]] = req[sendable]
    return send[:-1], slot.to(torch.int32)


def _mark(stats: Optional[dict], key: str, size: int, idx: torch.Tensor) -> None:
    """stats[key], a mask of ``size`` entries, gains ``idx``."""
    if stats is not None:
        stats.setdefault(key, torch.zeros(size, dtype=torch.bool, device=idx.device))[idx] = True


def ep_propose_plain(recv, light, biw, brp, *, my_shard: int, rows_per_shard: int,
                     light_width: int, block_width: int, return_param: float,
                     inout_param: float, stats: Optional[dict] = None):
    """Owner(cur) serves the proposals (JAX ``:401-500``): for each valid
    request row (cur >= 0) the response (cand, or -1 at a vertex of degree
    0; its weight bits; rev±; pfx and ppfx bits; take_back); -1 in every
    field of an empty row.

    ``stats``, when given, gains masks of what the call reads, for a bound
    on the kernel's traffic: the distinct "light_rows", "biw_rows" (a
    block's weights scanned), and 32-byte "biw_id_sectors" and
    "brp_sectors" holding a chosen id or (rev±, pfx) pair."""
    p_l, c = light_width, block_width
    maxb = _max_blocks(p_l)
    dev = recv.device
    resp = torch.full((recv.shape[0], 6), -1, dtype=torch.int32, device=dev)
    rows = torch.nonzero(recv[:, 0] >= 0).squeeze(1)
    if rows.numel() == 0:
        return resp
    r = recv[rows]
    r_wb = _f32(r[:, 2] & _MAG)
    r_bpfx, r_ub, r_up = _f32(r[:, 3]), _f32(r[:, 4]), _f32(r[:, 5])
    r_first = r[:, 6] == 0
    local_v = (r[:, 0].long() - my_shard * rows_per_shard).clamp(0, rows_per_shard - 1)
    row = light[local_v]
    ids = row[:, :p_l]
    w_light = _f32(row[:, p_l: 2 * p_l])
    is_heavy = row[:, 0] < -1
    h_cum = _f32(row[:, 5 + maxb: 5 + 2 * maxb])
    light_deg = ((ids != _PAD) & (ids >= 0)).sum(1)
    degree = torch.where(is_heavy, row[:, 4].long(), light_deg)
    wtot = torch.where(is_heavy, _f32(row[:, 3]), w_light.sum(1))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if return_param == 1.0 and inout_param == 1.0:
        take_back = torch.zeros_like(r_first)
        target = r_up * wtot
    else:
        inv_p = torch.tensor(np.float32(1.0 / return_param), device=dev)
        inv_q = torch.tensor(np.float32(1.0 / inout_param), device=dev)
        alpha_hi = torch.tensor(np.float32(max(1.0, 1.0 / inout_param)), device=dev)
        m1 = torch.where(r_first, zero, r_wb * inv_p)
        alpha2 = torch.where(r[:, 2] < 0, alpha_hi, inv_q)
        rest = torch.clamp(wtot - r_wb, min=0.0)
        m2 = rest * alpha2
        take_back = ~r_first & (r_ub < m1 / torch.clamp(m1 + m2, min=1e-30))
        u2 = r_up * rest
        target = torch.where(u2 < r_bpfx, u2, u2 + r_wb)

    cdf_l = prefix_sums(w_light)
    slot_l = torch.minimum((cdf_l < target[:, None]).sum(1), torch.clamp(degree - 1, min=0))
    cand_l = _pick(ids, slot_l)
    w_l = _pick(row[:, p_l: 2 * p_l], slot_l)
    rev_l = _pick(row[:, 2 * p_l: 3 * p_l], slot_l)
    pfx_l = _pick(row[:, 3 * p_l: 4 * p_l], slot_l)
    ppfx_l = torch.where(slot_l > 0, _pick(cdf_l, slot_l - 1), zero)

    h_nb = row[:, 2].long()
    blk = torch.minimum((h_cum < target[:, None]).sum(1), torch.clamp(h_nb - 1, min=0))
    base = torch.where(blk > 0, _pick(h_cum, blk - 1), zero)
    resid = target - base
    local_b = torch.where(is_heavy, row[:, 1].long() + blk, 0).clamp(0, biw.shape[0] - 1)
    brow = biw[local_b]
    cdf_b = prefix_sums(_f32(brow[:, c:]))
    nvalid = (brow[:, :c] != _PAD).sum(1)
    slot_b = torch.minimum((cdf_b < resid[:, None]).sum(1), torch.clamp(nvalid - 1, min=0))
    cand_h = _pick(brow[:, :c], slot_b)
    w_h = _pick(brow[:, c:], slot_b)
    gslot = local_b * c + slot_b
    qrow = brp[(gslot // QUADS_PER_ROW).clamp(0, brp.shape[0] - 1)]
    qpos = 2 * (gslot % QUADS_PER_ROW)
    rev_h = _pick(qrow, qpos)
    pfx_h = _pick(qrow, qpos + 1)
    ppfx_h = base + torch.where(slot_b > 0, _pick(cdf_b, slot_b - 1), zero)

    _mark(stats, "light_rows", light.shape[0], local_v)
    _mark(stats, "biw_rows", biw.shape[0], local_b[is_heavy])
    _mark(stats, "biw_id_sectors", biw.numel() // 8, (local_b * 2 * c + slot_b)[is_heavy] // 8)
    _mark(stats, "brp_sectors", brp.numel() // 8, gslot[is_heavy] // 4)
    cand = torch.where(is_heavy, cand_h, cand_l)
    ppfx = torch.where(is_heavy, ppfx_h, ppfx_l)
    resp[rows] = torch.stack([
        torch.where(degree == 0, -1, cand),
        torch.where(is_heavy, w_h, w_l),
        torch.where(is_heavy, rev_h, rev_l),
        torch.where(is_heavy, pfx_h, pfx_l),
        ppfx.view(torch.int32),
        take_back.to(torch.int32),
    ], dim=1)
    return resp


def ep_member_plain(recv, light, bids, *, my_shard: int, rows_per_shard: int,
                    light_width: int, block_width: int, stats: Optional[dict] = None):
    """Owner(prev) answers the membership requests (JAX ``:527-553``): 1
    where cand is in N(prev) (the light row, or the heavy block that the
    header's minimum ids pick), else 0; 0 for an empty row.  [n_req, 1].
    ``stats`` gains masks of the distinct "light_rows" and "bids_rows" read."""
    p_l = light_width
    maxb = _max_blocks(p_l)
    out = torch.zeros((recv.shape[0], 1), dtype=torch.int32, device=recv.device)
    rows = torch.nonzero(recv[:, 0] >= 0).squeeze(1)
    if rows.numel() == 0:
        return out
    r = recv[rows]
    cand = r[:, 1]
    local_p = (r[:, 0].long() - my_shard * rows_per_shard).clamp(0, rows_per_shard - 1)
    prow = light[local_p]
    p_heavy = prow[:, 0] < -1
    shared_light = (prow[:, :p_l] == cand[:, None]).any(1)
    jm = (prow[:, 5: 5 + maxb] <= cand[:, None]).sum(1) - 1
    jm = torch.minimum(torch.clamp(jm, min=0), torch.clamp(prow[:, 2].long() - 1, min=0))
    local_pb = torch.where(p_heavy, prow[:, 1].long() + jm, 0).clamp(0, bids.shape[0] - 1)
    shared_h = (bids[local_pb] == cand[:, None]).any(1)
    _mark(stats, "light_rows", light.shape[0], local_p)
    _mark(stats, "bids_rows", bids.shape[0], local_pb[p_heavy])
    out[rows, 0] = torch.where(p_heavy, shared_h, shared_light).to(torch.int32)
    return out


def ep_advance_plain(carry, paths, n_fb, slot_a, back, slot_b, resp_b, seed: int,
                     gid_base: int, *, walk_length: int, max_trials: int,
                     return_param: float, inout_param: float) -> torch.Tensor:
    """Home: acceptance, trial cap, path write and carried state (JAX
    ``:502-509``, ``:554-610``), in place on ``carry``, ``paths`` and the
    fallback count ``n_fb`` [1]; returns the count of walkers still pending
    (alive, t < L) as an int32 [1] tensor.  ``slot_b``/``resp_b`` are None
    at q == 1 (no membership round)."""
    n = carry.shape[1]
    dev = carry.device
    n_req = back.shape[0]
    el = walk_length
    t, cur, prev = carry[T].clone(), carry[CUR].clone(), carry[PREV].clone()
    w_fwd, fwd_pfx = _f32(carry[W_FWD]), _f32(carry[FWD_PFX])
    w_back_enc, back_pfx = carry[W_BACK_ENC].clone(), _f32(carry[BACK_PFX])
    alive, trials, att = carry[ALIVE] != 0, carry[TRIALS].clone(), carry[ATT].clone()
    w_back = _f32(w_back_enc & _MAG)
    back_shared = w_back_enc < 0
    first_order = t == 0
    gids = torch.arange(gid_base, gid_base + n, dtype=torch.int64, device=dev)
    u_acc = hash_uniform(seed, gids, (att.long() & 0xFFFFFFFF) * 4 + 2)

    send_a = slot_a < n_req
    got = back[slot_a.clamp(0, n_req - 1).long()]
    a_cand, a_w, a_rev = got[:, 0], _f32(got[:, 1]), got[:, 2]
    a_pfx, a_ppfx, a_take = _f32(got[:, 3]), _f32(got[:, 4]), got[:, 5] > 0
    died = send_a & (a_cand < 0) & ~a_take
    inv_q = torch.tensor(np.float32(1.0 / inout_param), device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    if slot_b is not None:
        need_b = send_a & ~died & ~a_take & ~first_order
        send_b = slot_b < resp_b.shape[0]
        shared = resp_b[slot_b.clamp(0, resp_b.shape[0] - 1).long(), 0] > 0
        attempted = send_a & (send_b | ~need_b)
    else:
        shared = torch.zeros_like(send_a)
        attempted = send_a
    if return_param == 1.0 and inout_param == 1.0:
        accept = attempted
    elif inout_param == 1.0:
        accept = attempted & (a_take | first_order | (a_cand != prev))
    else:
        alpha_hi = torch.tensor(np.float32(max(1.0, 1.0 / inout_param)), device=dev)
        alpha2 = torch.where(back_shared, alpha_hi, inv_q)
        bias2 = torch.where(shared, one, inv_q)
        accept = attempted & (a_take | first_order
                              | ((a_cand != prev) & (u_acc * alpha2 <= bias2)))
    alive = alive & ~died
    trials = torch.where(attempted, torch.where(accept, 0, trials + 1), trials)
    force = attempted & alive & (trials >= max_trials)
    n_fb += (force & ~accept).sum().to(n_fb.dtype)
    adv = (accept | force) & alive
    take = a_take & ~force
    nxt = torch.where(take, prev, a_cand)
    lanes = torch.nonzero(adv).squeeze(1)
    paths[lanes, (t[lanes] + 1).long()] = nxt[lanes]
    nw_fwd = torch.where(take, w_back, a_w)
    nf_pfx = torch.where(take, back_pfx, a_ppfx)
    nw_back_enc = torch.where(take, w_fwd.view(torch.int32) | torch.where(back_shared, _SIGN, 0)
                              .to(torch.int32), a_rev)
    nb_pfx = torch.where(take, fwd_pfx, a_pfx)
    carry[W_FWD] = torch.where(adv, nw_fwd, w_fwd).view(torch.int32)
    carry[FWD_PFX] = torch.where(adv, nf_pfx, fwd_pfx).view(torch.int32)
    carry[W_BACK_ENC] = torch.where(adv, nw_back_enc, w_back_enc)
    carry[BACK_PFX] = torch.where(adv, nb_pfx, back_pfx).view(torch.int32)
    carry[PREV] = torch.where(adv, cur, prev)
    carry[CUR] = torch.where(adv, nxt, cur)
    t = torch.where(adv, t + 1, t)
    carry[T] = t
    carry[TRIALS] = torch.where(adv, 0, trials)
    carry[ATT] = torch.where(attempted & alive, att + 1, att)
    carry[ALIVE] = alive.to(torch.int32)
    return (alive & (t < el)).sum().to(torch.int32).reshape(1)


# --------------------------------------------------------------------------- #
# the kernels' wrappers (CPU tensors take the plain versions)
# --------------------------------------------------------------------------- #

def _mode(return_param: float, inout_param: float) -> int:
    """0: p = q = 1; 1: q == 1; 2: q != 1 (membership)."""
    if inout_param != 1.0:
        return 2
    return 1 if return_param != 1.0 else 0


def ep_bucket(carry, seed: int, gid_base: int, *, n_shards: int, capacity: int,
              rows_per_shard: int, walk_length: int, slot_a=None, back=None):
    """K20: ``ep_bucket_plain``'s (send, slot), stable in lane order."""
    if not carry.is_cuda:
        return ep_bucket_plain(carry, seed, gid_base, n_shards=n_shards, capacity=capacity,
                               rows_per_shard=rows_per_shard, walk_length=walk_length,
                               slot_a=slot_a, back=back)
    if n_shards > KERNEL_MAX_SHARDS:
        raise ValueError(f"ep_bucket kernel takes at most {KERNEL_MAX_SHARDS} shards")
    member = slot_a is not None
    tensors = (carry, slot_a, back) if member else (carry,)
    _build.require_cuda("ep_bucket", *tensors)
    n = carry.shape[1]
    n_req = n_shards * capacity
    fields = MEMBER_FIELDS if member else PROPOSE_FIELDS
    send = torch.empty((n_req, fields), dtype=torch.int32, device=carry.device)
    slot = torch.empty(n, dtype=torch.int32, device=carry.device)
    tiles = torch.empty((max(-(-n // 1024), 1), n_shards), dtype=torch.int32,
                        device=carry.device)
    rc = _build.lib().n2v_ep_bucket(
        _build.ptr(carry), n, _build.ptr_or_null(slot_a), _build.ptr_or_null(back),
        _build.ptr(send), _build.ptr(slot), _build.ptr(tiles), n_shards, capacity,
        rows_per_shard, walk_length, int(gid_base), seed & 0xFFFFFFFF, int(member),
        _build.stream_of(carry))
    _build.check(rc, "ep_bucket")
    _build.launches["ep_bucket"] += 1
    return send, slot


def ep_propose(recv, light, biw, brp, *, my_shard: int, rows_per_shard: int,
               light_width: int, block_width: int, return_param: float, inout_param: float):
    """K21: ``ep_propose_plain``'s responses, an 8-lane group a request, a heavy
    block scanned in shared memory (block_width <= 256)."""
    kw = dict(my_shard=my_shard, rows_per_shard=rows_per_shard, light_width=light_width,
              block_width=block_width)
    if not recv.is_cuda:
        return ep_propose_plain(recv, light, biw, brp, return_param=return_param,
                                inout_param=inout_param, **kw)
    _check_kernel_tables("ep_propose", light, light_width, block_width)
    _build.require_cuda("ep_propose", recv, light, biw, brp)
    resp = torch.empty((recv.shape[0], RESPONSE_FIELDS), dtype=torch.int32, device=recv.device)
    rc = _build.lib().n2v_ep_propose(
        _build.ptr(recv), recv.shape[0], _build.ptr(light), rows_per_shard, _build.ptr(biw),
        _build.ptr(brp), _build.ptr(resp), int(my_shard) * rows_per_shard,
        float(np.float32(1.0 / return_param)), float(np.float32(1.0 / inout_param)),
        float(np.float32(max(1.0, 1.0 / inout_param))), _mode(return_param, inout_param),
        light_width, block_width, _build.stream_of(recv))
    _build.check(rc, "ep_propose")
    _build.launches["ep_propose"] += 1
    return resp


def ep_member(recv, light, bids, *, my_shard: int, rows_per_shard: int, light_width: int,
              block_width: int):
    """K22: ``ep_member_plain``'s answers, one warp a request."""
    kw = dict(my_shard=my_shard, rows_per_shard=rows_per_shard, light_width=light_width,
              block_width=block_width)
    if not recv.is_cuda:
        return ep_member_plain(recv, light, bids, **kw)
    _check_kernel_tables("ep_member", light, light_width, block_width)
    _build.require_cuda("ep_member", recv, light, bids)
    out = torch.empty((recv.shape[0], 1), dtype=torch.int32, device=recv.device)
    rc = _build.lib().n2v_ep_member(
        _build.ptr(recv), recv.shape[0], _build.ptr(light), rows_per_shard, _build.ptr(bids),
        _build.ptr(out), int(my_shard) * rows_per_shard, light_width, block_width,
        _build.stream_of(recv))
    _build.check(rc, "ep_member")
    _build.launches["ep_member"] += 1
    return out


def ep_advance_bucket_plain(carry, paths, n_fb, slot_a, back, slot_b, resp_b, seed: int,
                            gid_base: int, *, n_shards: int, capacity: int, rows_per_shard: int,
                            walk_length: int, max_trials: int, return_param: float,
                            inout_param: float):
    """The fused launch's function: ``ep_advance_plain`` (the superstep that
    ``slot_a``, ``back`` and at q != 1 ``slot_b``, ``resp_b`` answer, in
    place), then ``ep_bucket_plain``'s phase A on the advanced state.
    Returns (send, slot, pending): the next superstep's proposal round and
    the walkers still pending [1]."""
    pending = ep_advance_plain(carry, paths, n_fb, slot_a, back, slot_b, resp_b, seed,
                               gid_base, walk_length=walk_length, max_trials=max_trials,
                               return_param=return_param, inout_param=inout_param)
    send, slot = ep_bucket_plain(carry, seed, gid_base, n_shards=n_shards, capacity=capacity,
                                 rows_per_shard=rows_per_shard, walk_length=walk_length)
    return send, slot, pending


def ep_advance_bucket(carry, paths, n_fb, slot_a, back, slot_b, resp_b, seed: int,
                      gid_base: int, *, n_shards: int, capacity: int, rows_per_shard: int,
                      walk_length: int, max_trials: int, return_param: float,
                      inout_param: float):
    """K23 in K20's phase-A launch: ``ep_advance_bucket_plain``'s (send,
    slot, pending), one cooperative launch; the pending count is written by
    the kernel (no memset)."""
    kw = dict(n_shards=n_shards, capacity=capacity, rows_per_shard=rows_per_shard,
              walk_length=walk_length, max_trials=max_trials, return_param=return_param,
              inout_param=inout_param)
    if not carry.is_cuda:
        return ep_advance_bucket_plain(carry, paths, n_fb, slot_a, back, slot_b, resp_b, seed,
                                       gid_base, **kw)
    if n_shards > KERNEL_MAX_SHARDS:
        raise ValueError(f"ep_advance_bucket kernel takes at most {KERNEL_MAX_SHARDS} shards")
    member = slot_b is not None
    _build.require_cuda("ep_advance_bucket", carry, paths, n_fb, slot_a, back,
                        *((slot_b, resp_b) if member else ()))
    n = carry.shape[1]
    n_req = n_shards * capacity
    if n_fb.dtype != torch.int32 or paths.shape != (n, walk_length + 1):
        raise ValueError("ep_advance_bucket takes an int32 fallback count and paths [n, L+1]")
    if back.shape[0] != n_req or (member and resp_b.shape[0] != n_req):
        raise ValueError("ep_advance_bucket takes the responses of n_shards * capacity slots")
    dev = carry.device
    send = torch.empty((n_req, PROPOSE_FIELDS), dtype=torch.int32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    pending = torch.empty(1, dtype=torch.int32, device=dev)
    tiles = torch.empty((max(-(-n // 1024), 1), n_shards), dtype=torch.int32, device=dev)
    rc = _build.lib().n2v_ep_advance_bucket(
        _build.ptr(carry), n, _build.ptr(paths), _build.ptr(n_fb), _build.ptr(pending),
        _build.ptr(slot_a), _build.ptr(back), _build.ptr_or_null(slot_b),
        _build.ptr_or_null(resp_b), _build.ptr(send), _build.ptr(slot), _build.ptr(tiles),
        n_shards, capacity, rows_per_shard, walk_length, max_trials, int(gid_base),
        seed & 0xFFFFFFFF, float(np.float32(1.0 / inout_param)),
        float(np.float32(max(1.0, 1.0 / inout_param))), _mode(return_param, inout_param),
        _build.stream_of(carry))
    _build.check(rc, "ep_advance_bucket")
    _build.launches["ep_advance_bucket"] += 1
    return send, slot, pending


def _check_kernel_tables(name: str, light, light_width: int, block_width: int) -> None:
    if light.dim() != 2 or light.shape[1] != 128 or light_width > KERNEL_MAX_P:
        raise ValueError(f"{name} kernel takes light rows of 128 lanes (light_width <= "
                         f"{KERNEL_MAX_P})")
    if block_width > KERNEL_MAX_C or block_width % QUADS_PER_ROW:
        raise ValueError(f"{name} kernel takes block_width <= {KERNEL_MAX_C}, a multiple "
                         f"of {QUADS_PER_ROW}")


class _Plain:
    bucket = staticmethod(ep_bucket_plain)
    propose = staticmethod(ep_propose_plain)
    member = staticmethod(ep_member_plain)
    advance_bucket = staticmethod(ep_advance_bucket_plain)


class _Kernels:
    bucket = staticmethod(ep_bucket)
    propose = staticmethod(ep_propose)
    member = staticmethod(ep_member)
    advance_bucket = staticmethod(ep_advance_bucket)


# --------------------------------------------------------------------------- #
# the walk
# --------------------------------------------------------------------------- #

def max_supersteps(walk_length: int, inout_param: float, slack: int = 4) -> int:
    """JAX's bound: ``slack·walk_length·(1 if q <= 1 else 4) + 16``."""
    return slack * walk_length * (1 if inout_param <= 1 else 4) + 16


def superstep(ops, mesh, axis_name: str, tables, carry, paths, n_fb, ranked, seed: int,
              gid_base: int, *, n_shards: int, capacity: int, rows_per_shard: int,
              my_shard: int, light_width: int, block_width: int, walk_length: int,
              return_param: float, inout_param: float, max_trials: int):
    """One superstep through ``ops`` (the kernels or their plain versions).
    ``ranked``: its proposal round's (send, slot), which the previous
    superstep's fused launch (or the chunk's first ``ops.bucket``) made.
    Returns the next superstep's (send, slot) and this rank's pending count
    [1].  ``mesh`` None: a single shard, whose exchanges are the identity."""
    light, biw, bids, brp = tables

    def exchange(buf):
        return buf if mesh is None else mesh.all_to_all(buf, axis_name)

    geo = dict(n_shards=n_shards, capacity=capacity, rows_per_shard=rows_per_shard,
               walk_length=walk_length)
    own = dict(my_shard=my_shard, rows_per_shard=rows_per_shard, light_width=light_width,
               block_width=block_width)
    send_a, slot_a = ranked
    back = exchange(ops.propose(exchange(send_a), light, biw, brp, return_param=return_param,
                                inout_param=inout_param, **own))
    slot_b = resp_b = None
    if inout_param != 1.0:
        send_b, slot_b = ops.bucket(carry, seed, gid_base, slot_a=slot_a, back=back, **geo)
        resp_b = exchange(ops.member(exchange(send_b), light, bids, **own))
    send, slot, pending = ops.advance_bucket(
        carry, paths, n_fb, slot_a, back, slot_b, resp_b, seed, gid_base, max_trials=max_trials,
        return_param=return_param, inout_param=inout_param, **geo)
    return (send, slot), pending


def run_supersteps(step: Callable[[int], torch.Tensor], pending: torch.Tensor, bound: int,
                   mesh, axis_name: str) -> int:
    """The graph-sharded walks' host loop: ``step(t)`` runs superstep t and
    returns this rank's pending count [1], from ``pending`` before the
    first.  The all-reduced count is read every ``PENDING_CHECK_EVERY``
    supersteps (a superstep with no pending walker changes nothing); the
    loop stops when it is 0, and never runs past ``bound`` supersteps.
    Returns the supersteps run."""
    t = 0
    while t < bound and int(mesh.all_reduce_sum(pending, axis_name)) > 0:
        for _ in range(min(PENDING_CHECK_EVERY, bound - t)):
            pending = step(t)
            t += 1
    return t


def _walk(ops, mesh, graph: PartitionedBlockedGraph, starts, gid_base: int, seed: int, *,
          walk_length: int, return_param: float, inout_param: float, max_trials: int,
          capacity: int, slack: int, axis_name: str, stats: Optional[dict]):
    if max_trials < 1:
        raise ValueError(f"max_trials must be >= 1, got {max_trials}")
    n_shards = mesh.shape[axis_name]
    lo, n_local = shard_block(mesh, starts.shape[0], axis_name)
    my = mesh.coords[axis_name]
    tables = local_tables(graph, my)
    local = starts[lo: lo + n_local].to(torch.int32)
    if capacity <= 0:
        capacity = n_local
    seed = seed & 0xFFFFFFFF
    carry = init_carry(local)
    paths = torch.full((n_local, walk_length + 1), -1, dtype=torch.int32, device=local.device)
    paths[:, 0] = torch.where(local >= 0, local, -1)
    n_fb = torch.zeros(1, dtype=torch.int32, device=local.device)
    bound = max_supersteps(walk_length, inout_param, slack)
    kw = dict(n_shards=n_shards, capacity=capacity, rows_per_shard=graph.rows_per_shard,
              my_shard=my, light_width=graph.light_width, block_width=graph.block_width,
              walk_length=walk_length, return_param=return_param, inout_param=inout_param,
              max_trials=max_trials)
    pending = ((carry[ALIVE] != 0) & (carry[T] < walk_length)).sum().to(torch.int32).reshape(1)
    ranked = ops.bucket(carry, seed, gid_base + lo, n_shards=n_shards, capacity=capacity,
                        rows_per_shard=graph.rows_per_shard, walk_length=walk_length)

    def step(_):
        nonlocal ranked
        ranked, pend = superstep(ops, mesh, axis_name, tables, carry, paths, n_fb, ranked, seed,
                                 gid_base + lo, **kw)
        return pend

    it = run_supersteps(step, pending, bound, mesh, axis_name)
    if stats is not None:
        stats["supersteps"] = stats.get("supersteps", 0) + it
    unfinished = ((carry[ALIVE] != 0) & (carry[T] < walk_length)).sum()
    return paths, unfinished, n_fb[0].long()


def edge_partitioned_blocked_walk(
    mesh,
    graph: PartitionedBlockedGraph,
    starts: torch.Tensor,  # [W] int32, the chunk's starts (-1 dead), W a multiple of the axis
    gid_base: int,  # global id of the chunk's walker 0
    seed: int,
    *,
    walk_length: int,
    return_param: float,
    inout_param: float,
    max_trials: int = 64,
    capacity: int = 0,
    slack: int = 4,
    axis_name: str = "data",
    stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Graph-sharded blocked walks of this rank's block of ``starts``:
    (paths [W / S, L+1] int32, this shard's walkers unfinished at the
    superstep bound, this shard's trial-capped fallbacks), the counts int64
    scalars.  ``capacity`` (requests a rank sends each owner a round)
    defaults to W / S; ``stats`` gains "supersteps", the supersteps run."""
    return _walk(_Kernels, mesh, graph, starts, gid_base, seed, walk_length=walk_length,
                 return_param=float(return_param), inout_param=float(inout_param),
                 max_trials=max_trials, capacity=capacity, slack=slack, axis_name=axis_name,
                 stats=stats)


def edge_partitioned_blocked_walk_plain(
    mesh, graph: PartitionedBlockedGraph, starts: torch.Tensor, gid_base: int, seed: int, *,
    walk_length: int, return_param: float, inout_param: float, max_trials: int = 64,
    capacity: int = 0, slack: int = 4, axis_name: str = "data", stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``edge_partitioned_blocked_walk`` through the plain versions, on the
    tensors' device."""
    return _walk(_Plain, mesh, graph, starts, gid_base, seed, walk_length=walk_length,
                 return_param=float(return_param), inout_param=float(inout_param),
                 max_trials=max_trials, capacity=capacity, slack=slack, axis_name=axis_name,
                 stats=stats)
