"""Edge-partitioned walks over the dense packed adjacency: the round-1
graph-sharded walk (port of ``node2vec_tpu/parallel/edge_partitioned.py``).

Shard ``s`` of the data axis owns the vertex range ``[s·Vp, (s+1)·Vp)`` and
holds only those rows of the packed ``[V, 2P]`` adjacency
(``partition_packed_adjacency``).  Walkers are sharded by walker id and
their state (path, cur, prev, cursor, alive and the row N(prev) of the
previous frontier) stays on their home rank.  A superstep is one
request/response round over the data axis (two ``Mesh.all_to_all``s):

1. **bucket** (K24 ``epd_bucket``, home): each active walker (alive,
   cursor < L) is ranked within its owner(cur) in lane order, on K20's
   grid ranking; lanes past ``capacity`` defer to a later superstep.  The
   request is ``[cur, prev, u bits, N(prev)[P]]``;
2. **serve** (K25 ``epd_serve``, owner(cur)): the local row, the p/q bias
   against the carried N(prev), the exact inverse-CDF pick (K1's step);
   the response is ``[nxt, row ids[P]]``, nxt -1 at a sink;
3. **advance** (K26 ``epd_advance``, home): a walker that got a step
   writes it at its cursor + 1 and carries the row as its next N(prev); one
   that got -1 dies; the pending count (alive, cursor < L) for the loop.

Each walker advances by its own cursor, so a deferred walker's path stays
contiguous: capacity shifts the schedule, not the walk.  Empty slots
answer -1 in every field (JAX computes values nobody reads there), so the
kernels' and the plain versions' buffers compare whole.

The draws: JAX splits a key each superstep (folded with the rank's data
coordinate); here ``draws(t)`` gives superstep t's ``[W/S]`` float32
uniforms, by default ``torch.rand`` from a generator on the tensors'
device seeded from (seed, data coordinate).  Given the same draws the
walks equal JAX's bit for bit on dyadic graphs (every partial sum exact).
JAX loops in a ``while_loop`` whose condition is a psum of the pending
walkers; here the host loops, in the ep-blocked walk's ``run_supersteps``:
it reads the all-reduced pending count every ``PENDING_CHECK_EVERY``
supersteps (a superstep with no pending walker changes nothing), never
past ``4·walk_length + 4`` supersteps.  Walkers unfinished at that bound
are counted in ``stats``, never cut silently.

CPU tensors take the three kernels' plain versions; CUDA tensors launch
the kernels or raise.  ``edge_partitioned_walk_plain`` runs the plain
versions on any device.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from node2vec_torch import _build
from node2vec_torch.ops.sampling import prefix_sums
from node2vec_torch.parallel.edge_partitioned_blocked import KERNEL_MAX_SHARDS, run_supersteps
from node2vec_torch.parallel.sharded_walk import shard_block
from node2vec_torch.walk.dense import MAX_P, PAD_ID, shared_neighbor_mask

# rows of the carried walker state, one int32 row each
CUR, PREV, ALIVE, CURSOR = range(4)
CARRY_ROWS = 4
REQUEST_HEAD = 3  # cur, prev, u bits; then N(prev)[P]
BUCKET_TILE = 256  # K24's lanes a tile (csrc/epd_walk.cu kTile)


def partition_packed_adjacency(packed_adj: np.ndarray, n_shards: int) -> Tuple[np.ndarray, int]:
    """Pad the [V, 2P] packed adjacency to a multiple of ``n_shards`` rows:
    (padded [S·Vp, 2P] array, Vp).  Row r of shard s is vertex ``s·Vp + r``;
    pad rows hold PAD_ID ids and 0.0 weights.  A rank of data coordinate s
    holds rows ``[s·Vp, (s+1)·Vp)``."""
    n_vertices, width = packed_adj.shape
    rows_per_shard = -(-n_vertices // n_shards)
    padded = np.full((n_shards * rows_per_shard, width), PAD_ID, packed_adj.dtype)
    padded[:, width // 2:] = np.float32(0.0).view(np.int32)
    padded[:n_vertices] = packed_adj
    return padded, rows_per_shard


def max_supersteps(walk_length: int) -> int:
    """JAX's bound: 4x slack over the no-deferral superstep count."""
    return 4 * walk_length + 4


def init_carry(starts: torch.Tensor) -> torch.Tensor:
    """The carried state [CARRY_ROWS, n] int32 of walkers at ``starts``:
    cur = start (0 for a dead lane), prev = -1, alive where start >= 0,
    cursor 0."""
    carry = torch.zeros((CARRY_ROWS, starts.shape[0]), dtype=torch.int32, device=starts.device)
    alive = starts >= 0
    carry[CUR] = torch.where(alive, starts, 0)
    carry[PREV] = -1
    carry[ALIVE] = alive.to(torch.int32)
    return carry


def _owner(v: torch.Tensor, rows_per_shard: int, n_shards: int) -> torch.Tensor:
    return torch.clamp(torch.div(v, rows_per_shard, rounding_mode="floor"), 0, n_shards - 1)


def _pending(carry: torch.Tensor, walk_length: int) -> torch.Tensor:
    return ((carry[ALIVE] != 0) & (carry[CURSOR] < walk_length)).sum().to(torch.int32).reshape(1)


# --------------------------------------------------------------------------- #
# the superstep's three functions: plain versions
# --------------------------------------------------------------------------- #

def epd_bucket_plain(carry, prev_rows, u, *, n_shards: int, capacity: int, rows_per_shard: int,
                     walk_length: int):
    """Bucket by owner(cur) and pack the requests (JAX ``:104-135``): (send
    [S·cap, 3+P] int32, -1 where no lane was placed; slot [n] int32, the
    lane's flat slot dest·cap + rank, or S·cap when it is not active or
    defers)."""
    dev = carry.device
    n_req = n_shards * capacity
    active = (carry[ALIVE] != 0) & (carry[CURSOR] < walk_length)
    dest = torch.where(active, _owner(carry[CUR].clamp(min=0), rows_per_shard, n_shards), 0)
    onehot = (dest[:, None] == torch.arange(n_shards, device=dev)[None, :]) & active[:, None]
    rank = torch.cumsum(onehot.to(torch.int64), dim=0) - 1
    mine = torch.where(onehot, rank, 0).sum(1)
    sendable = active & (mine < capacity)
    slot = torch.where(sendable, dest.long() * capacity + mine, n_req)
    req = torch.cat([carry[CUR, :, None], carry[PREV, :, None],
                     u.to(torch.float32).view(torch.int32)[:, None], prev_rows], dim=1)
    send = torch.full((n_req + 1, req.shape[1]), -1, dtype=torch.int32, device=dev)
    send[slot[sendable]] = req[sendable]
    return send[:-1], slot.to(torch.int32)


def epd_serve_plain(recv, local_adj, *, my_shard: int, rows_per_shard: int, return_param: float,
                    inout_param: float):
    """Owner(cur) serves the requests against its rows (JAX ``:143-177``):
    [S·cap, 1+P] int32, ``[nxt, row ids]`` for a valid request (nxt -1 when
    the row's total weight is 0), -1 in every field of an empty one."""
    p_cols = local_adj.shape[1] // 2
    resp = torch.full((recv.shape[0], 1 + p_cols), -1, dtype=torch.int32, device=recv.device)
    rows_idx = torch.nonzero(recv[:, 0] >= 0).squeeze(1)
    if rows_idx.numel() == 0:
        return resp
    r = recv[rows_idx]
    r_prev = r[:, 1]
    r_u = r[:, 2].contiguous().view(torch.float32)
    local = (r[:, 0].long() - my_shard * rows_per_shard).clamp(0, rows_per_shard - 1)
    packed = local_adj[local]
    rows = packed[:, :p_cols]
    wts = packed[:, p_cols:].contiguous().view(torch.float32)
    inv_p = torch.tensor(np.float32(1.0 / return_param), device=recv.device)
    inv_q = torch.tensor(np.float32(1.0 / inout_param), device=recv.device)
    one = torch.ones((), dtype=torch.float32, device=recv.device)
    back = rows == r_prev[:, None]
    shared = shared_neighbor_mask(rows, r[:, REQUEST_HEAD:])
    bias = torch.where(back, inv_p, torch.where(shared, one, inv_q))
    bias = torch.where((r_prev < 0)[:, None], one, bias)
    bw = wts * bias
    total = torch.sum(bw, dim=1)
    cdf = prefix_sums(bw)
    # clamp to degree-1: ulp gaps between the prefix sums and the separate
    # total can put u·total above cdf[degree-1], on a PAD_ID lane
    degree = torch.sum(rows != int(PAD_ID), dim=1)
    pick = torch.minimum(torch.sum(cdf < (r_u * total)[:, None], dim=1),
                         torch.clamp(degree - 1, min=0))
    nxt = torch.gather(rows, 1, pick[:, None]).squeeze(1)
    resp[rows_idx, 0] = torch.where(total > 0, nxt, -1)
    resp[rows_idx, 1:] = rows
    return resp


def epd_advance_plain(carry, prev_rows, paths, slot, back, *, walk_length: int) -> torch.Tensor:
    """Home: read each lane's response by slot and advance (JAX
    ``:185-200``), in place on ``carry``, ``prev_rows`` and ``paths``;
    returns the count of walkers still pending (alive, cursor < L) as an
    int32 [1] tensor."""
    n_req = back.shape[0]
    sendable = slot < n_req
    got = back[slot.clamp(0, n_req - 1).long()]
    cur, cursor = carry[CUR].clone(), carry[CURSOR].clone()
    stepped = sendable & (got[:, 0] >= 0)
    died = sendable & (got[:, 0] < 0)
    lanes = torch.nonzero(stepped).squeeze(1)
    paths[lanes, (cursor[lanes] + 1).long()] = got[lanes, 0]
    carry[ALIVE] = ((carry[ALIVE] != 0) & ~died).to(torch.int32)
    carry[CURSOR] = torch.where(stepped, cursor + 1, cursor)
    carry[PREV] = torch.where(stepped, cur, carry[PREV])
    carry[CUR] = torch.where(stepped, got[:, 0], cur)
    prev_rows[lanes] = got[lanes, 1:]
    return _pending(carry, walk_length)


# --------------------------------------------------------------------------- #
# the kernels' wrappers (CPU tensors take the plain versions)
# --------------------------------------------------------------------------- #

def epd_bucket(carry, prev_rows, u, *, n_shards: int, capacity: int, rows_per_shard: int,
               walk_length: int):
    """K24: ``epd_bucket_plain``'s (send, slot), stable in lane order, in
    one cooperative launch that writes each slot once."""
    kw = dict(n_shards=n_shards, capacity=capacity, rows_per_shard=rows_per_shard,
              walk_length=walk_length)
    if not carry.is_cuda:
        return epd_bucket_plain(carry, prev_rows, u, **kw)
    if n_shards > KERNEL_MAX_SHARDS:
        raise ValueError(f"epd_bucket kernel takes at most {KERNEL_MAX_SHARDS} shards")
    if u.dtype != torch.float32 or prev_rows.dtype != torch.int32:
        raise TypeError("epd_bucket takes float32 uniforms and int32 carried rows")
    _build.require_cuda("epd_bucket", carry, prev_rows, u)
    n, p_cols = prev_rows.shape
    n_req = n_shards * capacity
    send = torch.empty((n_req, REQUEST_HEAD + p_cols), dtype=torch.int32, device=carry.device)
    slot = torch.empty(n, dtype=torch.int32, device=carry.device)
    tiles = torch.empty((max(-(-n // BUCKET_TILE), 1), n_shards), dtype=torch.int32,
                        device=carry.device)  # the blocks' counts (grid <= tiles)
    rc = _build.lib().n2v_epd_bucket(
        _build.ptr(carry), n, _build.ptr(prev_rows), _build.ptr(u), _build.ptr(send),
        _build.ptr(slot), _build.ptr(tiles), n_shards, capacity, rows_per_shard, walk_length,
        p_cols, _build.stream_of(carry))
    _build.check(rc, "epd_bucket")
    _build.launches["epd_bucket"] += 1
    return send, slot


def unsorted_requests(recv, p_cols: int, uniform: bool) -> int:
    """The valid second-order requests whose N(prev) is not non-decreasing:
    those K25 serves by the whole scan of N(prev), not by its bisection (0
    when p = q = 1, where no request tests membership)."""
    if uniform:
        return 0
    nprev = recv[:, REQUEST_HEAD:REQUEST_HEAD + p_cols]
    biased = (recv[:, 0] >= 0) & (recv[:, 1] >= 0)
    return int((biased & (nprev[:, 1:] < nprev[:, :-1]).any(1)).sum())


def epd_serve(recv, local_adj, *, my_shard: int, rows_per_shard: int, return_param: float,
              inout_param: float, scans: Optional[torch.Tensor] = None):
    """K25: ``epd_serve_plain``'s responses, a warp a request at a time on a
    persistent grid.  ``scans``, an int32 [1] tensor on the requests'
    device, gains the requests served by the whole scan of an unsorted
    N(prev) (``unsorted_requests``)."""
    uniform = return_param == 1.0 and inout_param == 1.0
    if not recv.is_cuda:
        if scans is not None:
            scans += unsorted_requests(recv, local_adj.shape[1] // 2, uniform)
        return epd_serve_plain(recv, local_adj, my_shard=my_shard, rows_per_shard=rows_per_shard,
                               return_param=return_param, inout_param=inout_param)
    p_cols = local_adj.shape[1] // 2
    if p_cols > MAX_P or recv.shape[1] != REQUEST_HEAD + p_cols:
        raise ValueError(f"epd_serve kernel takes P <= {MAX_P} and requests [n, 3 + P]")
    _build.require_cuda("epd_serve", recv, local_adj)
    if scans is not None and (scans.dtype != torch.int32 or scans.device != recv.device):
        raise TypeError("scans must be an int32 tensor on the requests' device")
    resp = torch.empty((recv.shape[0], 1 + p_cols), dtype=torch.int32, device=recv.device)
    rc = _build.lib().n2v_epd_serve(
        _build.ptr(recv), recv.shape[0], _build.ptr(local_adj), local_adj.shape[0],
        _build.ptr(resp), int(my_shard) * rows_per_shard, p_cols,
        float(np.float32(1.0 / return_param)), float(np.float32(1.0 / inout_param)),
        int(uniform), _build.ptr_or_null(scans), _build.stream_of(recv))
    _build.check(rc, "epd_serve")
    _build.launches["epd_serve"] += 1
    return resp


def epd_advance(carry, prev_rows, paths, slot, back, *, walk_length: int) -> torch.Tensor:
    """K26: ``epd_advance_plain`` in place, one thread a walker and a warp a
    carried row; the pending count lands in a device scalar."""
    if not carry.is_cuda:
        return epd_advance_plain(carry, prev_rows, paths, slot, back, walk_length=walk_length)
    _build.require_cuda("epd_advance", carry, prev_rows, paths, slot, back)
    if paths.shape != (carry.shape[1], walk_length + 1) or back.shape[1] != 1 + prev_rows.shape[1]:
        raise ValueError("epd_advance takes paths [n, L+1] and responses [n_req, 1 + P]")
    pending = torch.zeros(1, dtype=torch.int32, device=carry.device)
    rc = _build.lib().n2v_epd_advance(
        _build.ptr(carry), carry.shape[1], _build.ptr(prev_rows), _build.ptr(paths),
        _build.ptr(slot), _build.ptr(back), back.shape[0], walk_length, prev_rows.shape[1],
        _build.ptr(pending), _build.stream_of(carry))
    _build.check(rc, "epd_advance")
    _build.launches["epd_advance"] += 1
    return pending


class _Plain:
    bucket = staticmethod(epd_bucket_plain)
    serve = staticmethod(epd_serve_plain)
    advance = staticmethod(epd_advance_plain)


class _Kernels:
    bucket = staticmethod(epd_bucket)
    serve = staticmethod(epd_serve)
    advance = staticmethod(epd_advance)


# --------------------------------------------------------------------------- #
# the walk
# --------------------------------------------------------------------------- #

def superstep(ops, mesh, axis_name: str, local_adj, carry, prev_rows, paths, u, *,
              n_shards: int, capacity: int, rows_per_shard: int, my_shard: int,
              walk_length: int, return_param: float, inout_param: float) -> torch.Tensor:
    """One superstep through ``ops`` (the kernels or their plain versions)
    with this superstep's uniforms ``u``; returns this rank's pending count
    [1].  ``mesh`` None: a single shard, whose exchanges are the identity."""

    def exchange(buf):
        return buf if mesh is None else mesh.all_to_all(buf, axis_name)

    send, slot = ops.bucket(carry, prev_rows, u, n_shards=n_shards, capacity=capacity,
                            rows_per_shard=rows_per_shard, walk_length=walk_length)
    back = exchange(ops.serve(exchange(send), local_adj, my_shard=my_shard,
                              rows_per_shard=rows_per_shard, return_param=return_param,
                              inout_param=inout_param))
    return ops.advance(carry, prev_rows, paths, slot, back, walk_length=walk_length)


def default_draws(seed: int, coord: int, n_local: int, device) -> Callable[[int], torch.Tensor]:
    """Superstep t's uniforms: ``torch.rand`` from a generator on ``device``
    seeded from (seed, data coordinate), one call a superstep in order."""
    state = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(coord)]).generate_state(2)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))

    def draws(t: int) -> torch.Tensor:
        return torch.rand(n_local, generator=gen, device=device)

    return draws


def _walk(ops, mesh, local_adj: torch.Tensor, rows_per_shard: int, starts: torch.Tensor,
          seed: int, *, walk_length: int, return_param: float, inout_param: float,
          capacity: int, axis_name: str, draws, stats: Optional[dict]) -> torch.Tensor:
    n_shards = mesh.shape[axis_name]
    if local_adj.shape[0] != rows_per_shard:
        raise ValueError(f"partitioned_adj holds {local_adj.shape[0]} rows; this rank's block "
                         f"is rows_per_shard = {rows_per_shard}")
    lo, n_local = shard_block(mesh, starts.shape[0], axis_name)
    my = mesh.coords[axis_name]
    dev = local_adj.device
    local = starts[lo: lo + n_local].to(device=dev, dtype=torch.int32)
    if capacity <= 0:
        capacity = n_local
    if draws is None:
        draws = default_draws(seed, my, n_local, dev)
    p_cols = local_adj.shape[1] // 2
    carry = init_carry(local)
    prev_rows = torch.full((n_local, p_cols), int(PAD_ID), dtype=torch.int32, device=dev)
    paths = torch.full((n_local, walk_length + 1), -1, dtype=torch.int32, device=dev)
    paths[:, 0] = torch.where(local >= 0, local, -1)
    kw = dict(n_shards=n_shards, capacity=capacity, rows_per_shard=rows_per_shard, my_shard=my,
              walk_length=walk_length, return_param=float(return_param),
              inout_param=float(inout_param))

    def step(t: int) -> torch.Tensor:
        u = draws(t).to(device=dev, dtype=torch.float32)
        return superstep(ops, mesh, axis_name, local_adj, carry, prev_rows, paths, u, **kw)

    t = run_supersteps(step, _pending(carry, walk_length), max_supersteps(walk_length), mesh,
                       axis_name)
    if stats is not None:
        stats["supersteps"] = stats.get("supersteps", 0) + t
        stats["unfinished"] = stats.get("unfinished", 0) + int(_pending(carry, walk_length))
    return paths


def edge_partitioned_walk(
    mesh,
    partitioned_adj: torch.Tensor,  # this rank's [rows_per_shard, 2P] block of the padded array
    rows_per_shard: int,
    starts: torch.Tensor,  # [W] int32, the chunk's starts (-1 dead), W a multiple of the axis
    seed: int,
    *,
    walk_length: int,
    return_param: float,
    inout_param: float,
    capacity: int = 0,
    axis_name: str = "data",
    draws: Optional[Callable[[int], torch.Tensor]] = None,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Walks over a packed adjacency range-sharded over the mesh's data
    axis: this rank's rows of paths, [W / S, L+1] int32 (-1 padded), walkers
    ``[d·W/S, (d+1)·W/S)`` of the chunk.  ``capacity`` (requests a rank
    sends each owner a superstep) defaults to W / S, which never defers.
    ``draws(t)``: superstep t's [W / S] uniforms (``default_draws`` when
    None).  ``stats`` gains "supersteps" (run) and "unfinished" (this
    rank's walkers still pending at the bound)."""
    return _walk(_Kernels, mesh, partitioned_adj, rows_per_shard, starts, seed,
                 walk_length=walk_length, return_param=return_param, inout_param=inout_param,
                 capacity=capacity, axis_name=axis_name, draws=draws, stats=stats)


def edge_partitioned_walk_plain(
    mesh, partitioned_adj: torch.Tensor, rows_per_shard: int, starts: torch.Tensor, seed: int, *,
    walk_length: int, return_param: float, inout_param: float, capacity: int = 0,
    axis_name: str = "data", draws: Optional[Callable[[int], torch.Tensor]] = None,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """``edge_partitioned_walk`` through the three plain versions, on the
    tensors' device."""
    return _walk(_Plain, mesh, partitioned_adj, rows_per_shard, starts, seed,
                 walk_length=walk_length, return_param=return_param, inout_param=inout_param,
                 capacity=capacity, axis_name=axis_name, draws=draws, stats=stats)
