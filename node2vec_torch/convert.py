"""State carried across between the JAX package and the port.

The JAX trainer keeps numpy-convertible tables in the logical ``[N, D]``
layout at its boundaries (checkpoints, ``emb_in``/``emb_out``), never the
packed dim-64 device layout, and the port works on that layout throughout.
``from_reference_state`` and ``to_reference_state`` turn one side's trainer
state into the other's, so both trainers can start from the same tables;
``from_reference_fused`` and ``to_reference_fused`` do the same for the
fused-table step's [V, D+1] tables (the accumulator in column D).
``from_reference_sharded_state`` gives a mesh rank its column slices of
JAX's full tables (the column-sharded trainer's state), and
``to_reference_sharded_state`` gathers them back;
``from_reference_row_state`` and ``from_reference_hs_row_state`` give it its
rows ``rank::N`` of the row-sharded trainers' full tables.
``blocked_graph_from_arrays`` takes the blocked walk engine's tables, which
have one layout in both packages, so both walk kernels can run on the very
tables one package packed.  Like every entry point of the port, each puts
its tensors on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from node2vec_torch.device import resolve_device
from node2vec_torch.walk.blocked import BlockedGraph


def from_reference_state(
    emb_in, emb_out, acc_in, acc_out, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(emb_in [V, D], emb_out [N_out, D], acc_in [V], acc_out [N_out])
    arrays -> contiguous float32 tensors on ``device`` (copies, never
    views).  The output table has its own row count: V for SGNS, the
    Huffman tree's n_inner for hierarchical softmax (theta)."""
    device = resolve_device(device)
    out = []
    for a, ndim in ((emb_in, 2), (emb_out, 2), (acc_in, 1), (acc_out, 1)):
        a = np.array(a, dtype=np.float32, copy=True)
        if a.ndim != ndim:
            raise ValueError(f"expected a {ndim}-d array, got shape {a.shape}")
        out.append(torch.from_numpy(a).to(device))
    if out[0].shape[1] != out[1].shape[1]:
        raise ValueError(f"emb_in and emb_out must have one D, got {out[0].shape[1]} "
                         f"and {out[1].shape[1]}")
    for table, acc, name in ((out[0], out[2], "in"), (out[1], out[3], "out")):
        if acc.shape[0] != table.shape[0]:
            raise ValueError(f"acc_{name} must have one entry per emb_{name} row")
    return tuple(out)


def to_reference_state(
    emb_in: torch.Tensor, emb_out: torch.Tensor, acc_in: torch.Tensor, acc_out: torch.Tensor
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The port's state tensors -> host float32 numpy arrays, logical layout."""
    return tuple(t.detach().to("cpu", torch.float32).numpy().copy()
                 for t in (emb_in, emb_out, acc_in, acc_out))


def from_reference_sharded_state(mesh, emb_in, emb_out, acc_in, acc_out, device="cuda"):
    """This rank's ``ShardedSGNSState`` from full (emb_in [V, D], emb_out
    [V, D], acc_in [V], acc_out [V]) arrays, e.g. ``np.asarray`` of a JAX
    ``ShardedSGNSState``'s global arrays: its model coordinate's columns of
    the tables and the whole accumulators."""
    from node2vec_torch.parallel.sharded_sgns import ShardedSGNSState, shard_columns

    e_in, e_out, a_in, a_out = from_reference_state(emb_in, emb_out, acc_in, acc_out, device)
    return ShardedSGNSState(shard_columns(mesh, e_in), shard_columns(mesh, e_out), a_in, a_out)


def to_reference_sharded_state(mesh, state) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                                     np.ndarray]:
    """The full tables of a ``ShardedSGNSState`` as host float32 arrays,
    gathered over the model axis (a collective: every rank calls it)."""
    from node2vec_torch.parallel.sharded_sgns import gather_columns

    return to_reference_state(gather_columns(mesh, state.emb_in),
                              gather_columns(mesh, state.emb_out), state.acc_in, state.acc_out)


def from_reference_row_state(mesh, emb_in, emb_out, acc_in, acc_out, device="cuda"):
    """This rank's ``RowShardedState`` from full logical (emb_in [V, D],
    emb_out [V, D], acc_in [V] or [V, 1], acc_out) arrays, e.g. JAX's
    ``init_row_state`` un-interleaved (``row_state_to_host``): its rows
    ``rank::N``, padded to whole ranks."""
    from node2vec_torch.parallel.rowsharded_sgns import row_state_from_host

    return row_state_from_host(mesh, emb_in, emb_out, acc_in, acc_out, device=device)


def from_reference_hs_row_state(mesh, emb_in, theta, acc_in, acc_theta, device="cuda"):
    """This rank's ``RowHSState`` from full logical (emb_in [V, D], theta
    [n_inner, D], acc_in, acc_theta) arrays, e.g. JAX's
    ``init_hs_row_state`` through ``hs_state_to_host``."""
    from node2vec_torch.parallel.rowsharded_hs import hs_state_from_host

    return hs_state_from_host(mesh, emb_in, theta, acc_in, acc_theta, device=device)


def from_reference_fused(tab_in, tab_out, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX fused tables (``init_fused_embeddings``, ``sgns_epoch_fused``:
    [V, D+1] arrays) -> contiguous float32 tensors on ``device`` (copies)."""
    device = resolve_device(device)
    out = [torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(device)
           for a in (tab_in, tab_out)]
    if out[0].dim() != 2 or out[0].shape != out[1].shape or out[0].shape[1] < 2:
        raise ValueError(f"fused tables must both be [V, D+1], got {tuple(out[0].shape)} "
                         f"and {tuple(out[1].shape)}")
    return tuple(out)


def to_reference_fused(tab_in: torch.Tensor, tab_out: torch.Tensor
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The port's fused tables -> host float32 numpy arrays [V, D+1]."""
    return tuple(t.detach().to("cpu", torch.float32).numpy().copy() for t in (tab_in, tab_out))


def blocked_graph_from_arrays(
    light, biw, bids, brp, light_width: int, block_width: int, has_heavy: bool,
    device="cuda", slq=None, sl_ovf_wfrac: float = 1.0,
) -> BlockedGraph:
    """The port's BlockedGraph from host copies of the four tables (e.g.
    ``np.asarray`` of a JAX BlockedGraph's), and of its shared lists
    ``slq`` when it has them, as contiguous int32 tensors on ``device``."""
    device = resolve_device(device)
    tables = [torch.from_numpy(np.array(a, dtype=np.int32, copy=True)).to(device)
              for a in (light, biw, bids, brp)]
    c = int(block_width)
    if tables[0].dim() != 2 or tables[0].shape[1] < 4 * light_width:
        raise ValueError(f"light must be [V, >= 4P], got {tuple(tables[0].shape)}")
    nb = tables[1].shape[0]
    if (tuple(tables[1].shape) != (nb, 2 * c) or tuple(tables[2].shape) != (nb, c)
            or tuple(tables[3].shape) != (nb * c // 64, 128)):
        raise ValueError("biw, bids and brp must be [NB, 2C], [NB, C] and [NB*C/64, 128]")
    if slq is not None:
        slq = torch.from_numpy(np.array(slq, dtype=np.int32, copy=True)).to(device)
        if slq.dim() != 2 or slq.shape[1] != 128:
            raise ValueError(f"slq must be [*, 128], got {tuple(slq.shape)}")
    return BlockedGraph(*tables, int(light_width), c, bool(has_heavy), slq,
                        float(sl_ovf_wfrac))
