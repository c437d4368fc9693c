"""Dense (padded-adjacency) walk engine (port of ``node2vec_tpu/walk/dense.py``).

Neighbor lists are one dense ``[V, 2P]`` int32 matrix (P = next power of two
>= max degree, min 8): columns ``[0, P)`` are the sorted neighbor ids
(INT32_MAX padding) and columns ``[P, 2P)`` the float32 edge weights bitcast
to int32 (0.0 padding).  Each walker-step gathers one packed row, biases it
(1/p back edge, 1 shared neighbor of the previous vertex, 1/q otherwise;
step 0 first-order), and picks by exact inverse CDF with one counter-hash
uniform.  No rejection loop and no approximation.

``dense_walk_chunk`` launches kernel K1 (``csrc/dense_walk.cu``) for CUDA
tensors and runs ``dense_walk_chunk_plain``, the same math in plain PyTorch,
for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from node2vec_torch import _build
from node2vec_torch.ops.hashrng import hash_uniform
from node2vec_torch.ops.sampling import prefix_sums

PAD_ID = np.int32(np.iinfo(np.int32).max)  # keeps rows sorted; never equals a real id
MAX_P = 256  # K1 holds at most 8 columns per lane


def build_padded_adjacency(
    indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray
) -> np.ndarray:
    """CSR -> packed dense [V, 2P] int32 (ids | bitcast weights); P = next
    pow2 >= max degree (min 8)."""
    degrees = np.diff(indptr)
    max_deg = int(degrees.max()) if len(degrees) else 0
    p = 8
    while p < max_deg:
        p *= 2
    n_vertices = len(indptr) - 1
    packed = np.empty((n_vertices, 2 * p), dtype=np.int32)
    packed[:, :p] = PAD_ID
    packed[:, p:] = np.float32(0.0).view(np.int32)
    if len(indices):
        row = np.repeat(np.arange(n_vertices), degrees)
        col = np.arange(len(indices)) - np.repeat(indptr[:-1], degrees)
        packed[row, col] = indices
        packed[row, p + col] = np.asarray(weights, dtype=np.float32).view(np.int32)
    return packed


def shared_neighbor_mask(rows: torch.Tensor, prev_rows: torch.Tensor) -> torch.Tensor:
    """[W, P] mask: rows[w, i] ∈ prev_rows[w, :] (all-pairs lane compare)."""
    return (rows[:, :, None] == prev_rows[:, None, :]).any(-1)


def dense_walk_chunk_plain(
    packed_adj: torch.Tensor,
    starts: torch.Tensor,
    gid_base: int,
    seed: int,
    *,
    walk_length: int,
    return_param: float,
    inout_param: float,
) -> torch.Tensor:
    """The JAX ``dense_walk_chunk_impl`` op for op in plain PyTorch."""
    n_walkers = starts.shape[0]
    dev = starts.device
    gids = torch.arange(gid_base, gid_base + n_walkers, dtype=torch.int64, device=dev)
    seed = seed & 0xFFFFFFFF
    p_cols = packed_adj.shape[1] // 2
    inv_p = float(np.float32(1.0 / return_param))
    inv_q = float(np.float32(1.0 / inout_param))
    uniform_bias = return_param == 1.0 and inout_param == 1.0

    alive = starts >= 0
    paths = torch.full((n_walkers, walk_length + 1), -1, dtype=torch.int32, device=dev)
    paths[:, 0] = torch.where(alive, starts, -1)
    col_iota = torch.arange(p_cols, device=dev)[None, :]
    prev = torch.full((n_walkers,), -1, dtype=torch.int32, device=dev)
    cur = torch.where(alive, starts, 0)
    prev_rows = torch.full((n_walkers, p_cols), int(PAD_ID), dtype=torch.int32, device=dev)
    for t in range(walk_length):
        cur_safe = torch.where(alive, cur, 0).long()
        packed = packed_adj[cur_safe]  # [W, 2P]: the one row gather per step
        rows = packed[:, :p_cols]
        wts = packed[:, p_cols:].contiguous().view(torch.float32)
        if uniform_bias:
            bw = wts
        else:
            first_order = prev < 0
            back = rows == prev[:, None]
            shared = shared_neighbor_mask(rows, prev_rows)
            bias = torch.where(
                back, inv_p, torch.where(shared, 1.0, inv_q)
            ).to(torch.float32)
            bias = torch.where(first_order[:, None], 1.0, bias).to(torch.float32)
            bw = wts * bias  # pads carry zero weight

        total = torch.sum(bw, dim=1)
        alive = alive & (total > 0)

        u = hash_uniform(seed, gids, t) * total
        cdf = prefix_sums(bw)
        # clamp to degree-1: cdf and total are separate sums, so u can land in
        # the ulp gap above cdf[degree-1], where every zero-weight pad column
        # (cdf equal there) would count
        degree = torch.sum(rows != int(PAD_ID), dim=1)
        idx = torch.minimum(
            torch.sum(cdf < u[:, None], dim=1),
            torch.clamp(degree - 1, min=0),
        )
        nxt = torch.sum(torch.where(col_iota == idx[:, None], rows, 0), dim=1).to(torch.int32)

        paths[:, t + 1] = torch.where(alive, nxt, -1)
        prev = torch.where(alive, cur, prev)
        cur = torch.where(alive, nxt, cur)
        # the freshly gathered frontier row becomes next step's N(prev)
        prev_rows = torch.where(alive[:, None], rows, prev_rows)
    return paths


def unsorted_steps(packed_adj: torch.Tensor, paths: torch.Tensor, uniform: bool) -> int:
    """The second-order steps of ``paths`` whose N(prev) (prev's row of ids)
    is not non-decreasing: those K1 tests by the whole scan of N(prev), not
    by its bisection (0 when p = q = 1, where no step tests membership).  A
    step t >= 1 is taken by every walker alive at it (``paths[:, t] >= 0``),
    a sink's included."""
    if uniform or paths.shape[1] < 3:
        return 0
    p_cols = packed_adj.shape[1] // 2
    ids = packed_adj[:, :p_cols]
    unsorted = (ids[:, 1:] < ids[:, :-1]).any(1)
    taken = paths[:, 1:-1] >= 0
    prev = paths[:, :-2].clamp(min=0).long()
    return int((taken & unsorted[prev]).sum())


def dense_walk_chunk(
    packed_adj: torch.Tensor,  # [V, 2P] int32: sorted ids | bitcast f32 weights
    starts: torch.Tensor,  # [W] int32, negative = dead lane
    gid_base: int,  # global id of lane 0 (chunk-invariant RNG: gid = gid_base + lane)
    seed: int,
    *,
    walk_length: int,
    return_param: float,
    inout_param: float,
    scans: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact biased walks; returns [W, walk_length+1] int32 (-1 padded).

    Uniforms are keyed on (seed, global walker id, step) via the counter hash,
    so walk content is bit-invariant to walker_chunk and padding.  CPU tensors
    take the plain version; CUDA tensors launch K1 or raise.  ``scans``, an
    int32 [1] tensor on the starts' device, gains the steps that tested
    membership by the whole scan of an unsorted N(prev) (``unsorted_steps``).
    """
    if packed_adj.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError("dense_walk_chunk takes int32 packed_adj and starts")
    if packed_adj.dim() != 2 or packed_adj.shape[1] % 2 or starts.dim() != 1:
        raise ValueError("dense_walk_chunk takes packed_adj [V, 2P] and starts [W]")
    uniform_bias = return_param == 1.0 and inout_param == 1.0
    if not packed_adj.is_cuda:
        paths = dense_walk_chunk_plain(
            packed_adj, starts, gid_base, seed, walk_length=walk_length,
            return_param=return_param, inout_param=inout_param,
        )
        if scans is not None:
            scans += unsorted_steps(packed_adj, paths, uniform_bias)
        return paths
    p_cols = packed_adj.shape[1] // 2
    if p_cols > MAX_P:
        raise ValueError(f"dense_walk kernel takes P <= {MAX_P}, got {p_cols}")
    _build.require_cuda("dense_walk", packed_adj, starts)
    if scans is not None and (scans.dtype != torch.int32 or scans.device != starts.device):
        raise TypeError("scans must be an int32 tensor on the starts' device")
    n_walkers = starts.shape[0]
    paths = torch.empty((n_walkers, walk_length + 1), dtype=torch.int32, device=starts.device)
    lib = _build.lib()
    rc = lib.n2v_dense_walk(
        _build.ptr(packed_adj), p_cols, _build.ptr(starts), _build.ptr(paths),
        n_walkers, walk_length, int(gid_base), seed & 0xFFFFFFFF,
        float(np.float32(1.0 / return_param)), float(np.float32(1.0 / inout_param)),
        int(uniform_bias), _build.ptr_or_null(scans), _build.stream_of(starts),
    )
    _build.check(rc, "dense_walk")
    _build.launches["dense_walk"] += 1
    return paths
