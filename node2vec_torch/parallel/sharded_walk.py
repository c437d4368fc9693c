"""Walks with the walkers sharded over the mesh's data axis (port of
``node2vec_tpu/parallel/sharded_walk.py``).

Each rank holds the whole graph (the tables are replicated, ``P()``) and
walks its data coordinate's block of the chunk's walkers with the
single-device kernel: K1 ``dense_walk``, K5 ``blocked_walk`` or K12
``csr_walk``.  Every draw is keyed on (seed, global walker id, counter), so
a shard's rows equal the single-device engine's rows for the same walkers,
and the walks need no collective.  Ranks of one data coordinate (its model
ranks) walk the same block, as the JAX shards do.

Each function takes the chunk's ``starts`` [n] (``n`` a multiple of the
data axis) and the global id of its walker 0, ``gid_base``, and returns
this rank's rows of paths, ``[n / n_data, L + 1]``: walkers ``[d * n /
n_data, (d + 1) * n / n_data)``.  ``WalkEngine(mesh=)`` pads a chunk and
gathers the rows back (``Mesh.all_gather``).  On the card each launch is
counted under the kernel's name and under ``<kernel>_sharded``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from node2vec_torch import _build
from node2vec_torch.parallel.mesh import Mesh
from node2vec_torch.walk.blocked import blocked_walk_chunk
from node2vec_torch.walk.csr import csr_walk_chunk
from node2vec_torch.walk.dense import dense_walk_chunk


def shard_block(mesh: Mesh, n: int, axis_name: str = "data") -> Tuple[int, int]:
    """(first walker, walker count) of this rank's block of ``n`` walkers."""
    n_shards = mesh.shape[axis_name]
    if n % n_shards:
        raise ValueError(f"{n} walkers do not split evenly over {n_shards} '{axis_name}' shards")
    local = n // n_shards
    return mesh.coords[axis_name] * local, local


def _count(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        _build.launches[name + "_sharded"] += 1


def sharded_dense_walk_chunk(
    mesh: Mesh, packed_adj: torch.Tensor, starts: torch.Tensor, gid_base: int, seed: int, *,
    walk_length: int, return_param: float, inout_param: float, axis_name: str = "data",
) -> torch.Tensor:
    """Dense-engine walks of this rank's block of ``starts`` (K1), the
    packed adjacency replicated."""
    lo, n_local = shard_block(mesh, starts.shape[0], axis_name)
    paths = dense_walk_chunk(packed_adj, starts[lo: lo + n_local], gid_base + lo, seed,
                             walk_length=walk_length, return_param=return_param,
                             inout_param=inout_param)
    _count("dense_walk", packed_adj)
    return paths


def sharded_blocked_walk_chunk(
    mesh: Mesh, light: torch.Tensor, biw: torch.Tensor, bids: torch.Tensor, brp: torch.Tensor,
    slq: Optional[torch.Tensor], starts: torch.Tensor, gid_base: int, seed: int, *,
    walk_length: int, return_param: float, inout_param: float, max_trials: int = 64,
    light_width: int = 31, block_width: int = 256, has_heavy: bool = True,
    shared_lists: bool = False, sl_exhaustive: bool = False, axis_name: str = "data",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blocked-engine walks of this rank's block (K5), the tables (and the
    shared-list table) replicated: (paths, this shard's trial-capped
    accepts, this shard's sampling attempts), the counts int64 scalars."""
    lo, n_local = shard_block(mesh, starts.shape[0], axis_name)
    out = blocked_walk_chunk(
        light, biw, bids, brp, starts[lo: lo + n_local], gid_base + lo, seed,
        walk_length=walk_length, return_param=return_param, inout_param=inout_param,
        max_trials=max_trials, light_width=light_width, block_width=block_width,
        has_heavy=has_heavy, slq=slq, shared_lists=shared_lists, sl_exhaustive=sl_exhaustive,
    )
    _count("blocked_walk", light)
    return out


def sharded_walk_chunk(
    mesh: Mesh, indptr: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor,
    alias: torch.Tensor, prob: torch.Tensor, wtot: torch.Tensor, starts: torch.Tensor,
    gid_base: int, seed: int, *, walk_length: int, return_param: float, inout_param: float,
    max_trials: int = 64, search_iters: int = 32, axis_name: str = "data",
) -> torch.Tensor:
    """CSR-engine walks of this rank's block (K12), the CSR and its alias
    tables replicated."""
    lo, n_local = shard_block(mesh, starts.shape[0], axis_name)
    paths = csr_walk_chunk(indptr, indices, weights, alias, prob, wtot,
                           starts[lo: lo + n_local], gid_base + lo, seed,
                           walk_length=walk_length, return_param=return_param,
                           inout_param=inout_param, max_trials=max_trials,
                           search_iters=search_iters)
    _count("csr_walk", indptr)
    return paths
