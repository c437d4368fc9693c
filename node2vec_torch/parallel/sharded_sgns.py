"""SGNS over a mesh: tensor-parallel embedding columns × data-parallel
batches (port of ``node2vec_tpu/parallel/sharded_sgns.py``).

* model axis: each rank holds dims ``[m * Dm, (m + 1) * Dm)`` of every row
  of emb_in and emb_out (``Dm = D / n_model``).  Row gathers are local; a
  pair's logit is a sum of partial dot products over the ranks' columns,
  all-reduced over the model axis.
* data axis: each data coordinate trains its own block of the batch's
  walks; the accumulator increments and the table deltas are all-reduced
  over the data axis before they are applied, so every replica of a
  column slice stays the same.

The Adagrad accumulators are ``[V]``, replicated on every rank.

The step (``_col_step``, sharded_sgns.py:57-139), on each rank, in order:

1. the pair lists, K13's first launch (``models.skipgram.pair_lists``);
2. K16 ``col_pair_logits``: partial logits over this rank's columns;
3. ``all_reduce(model)``: the full logits;
4. K17 ``col_pair_grads``: gradients over the rank's columns from the full
   logits, with each gradient row's partial sum of squares and the loss
   partials;
5. ``all_reduce(model)`` of the squares;
6. K3 in its squares mode into a zeroed ``[V]`` increment ``dacc``
   (squares divided by the full D);
7. ``all_reduce(data)`` of ``dacc`` (and the loss partials), then
   ``acc += dacc``: every square lands before any scale is read;
8. K4, scaled by the final accumulators, into zeroed ``[V, Dm]`` deltas,
   which are ``all_reduce(data)``'d and added to the tables (the JAX
   step's dense psum); with one data coordinate K4 writes straight into
   the tables (the same sum, in another order).

As in the port's one-device steps, the draws are inputs: the shrink
``b_sh`` and the negatives' ``r1``, ``r2`` of this rank's data coordinate.
Every model rank of a data coordinate must take the same draws, and data
coordinates different ones (the JAX step folds the data index into its
key, ``fold_in(key, d)``).  Tables and accumulators are updated in place.
CPU tensors take the kernels' plain versions; CUDA tensors launch the
kernels or raise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from node2vec_torch import _build
from node2vec_torch.device import resolve_device
from node2vec_torch.models import skipgram as sg
from node2vec_torch.parallel.mesh import Mesh


class ShardedSGNSState(NamedTuple):
    emb_in: torch.Tensor  # [V, D / n_model]: this rank's columns
    emb_out: torch.Tensor  # [V, D / n_model]
    acc_in: torch.Tensor  # [V], replicated
    acc_out: torch.Tensor  # [V], replicated


def shard_columns(mesh: Mesh, table: torch.Tensor) -> torch.Tensor:
    """This rank's ``P(None, "model")`` slice of a full table, contiguous:
    columns ``[m * D / n_model, (m + 1) * D / n_model)``."""
    dim, n_model = table.shape[1], mesh.shape["model"]
    if dim % n_model:
        raise ValueError(f"vector_size {dim} not divisible by model axis {n_model}")
    width = dim // n_model
    lo = mesh.coords["model"] * width
    return table[:, lo: lo + width].contiguous()


def gather_columns(mesh: Mesh, table: torch.Tensor) -> torch.Tensor:
    """The full table from every model rank's column slice."""
    return mesh.all_gather(table, "model", dim=1)


def init_sharded_state(mesh: Mesh, n_vertices: int, dim: int, seed: int = 1,
                       device="cuda") -> ShardedSGNSState:
    """word2vec's init (``models.skipgram.init_embeddings``, the same on
    every rank), of which this rank keeps its columns."""
    emb_in, emb_out, acc_in, acc_out = sg.init_embeddings(n_vertices, dim, seed,
                                                          device=resolve_device(device))
    return ShardedSGNSState(shard_columns(mesh, emb_in), shard_columns(mesh, emb_out),
                            acc_in, acc_out)


# --------------------------------------------------------------------------- #
# K16: partial logits over this rank's columns
# --------------------------------------------------------------------------- #
#
# Output: one flat float32 buffer [P + B * L1 * S], so one all-reduce sums
# both: [:P] the lanes' partial positive logits (0 on an invalid lane) and
# [P:] each walk position's partial negative logits [B * L1, S] (0 for a
# position with no valid lane: the JAX step's [P, S] has 2w equal rows a
# position).


def _lanes(walks: torch.Tensor, window: int) -> int:
    return walks.shape[0] * 2 * window * walks.shape[1]


def _centers_live(centers: torch.Tensor, walks: torch.Tensor, window: int) -> torch.Tensor:
    """[B * L1] float32: the valid lanes of each walk position."""
    n_walks, length = walks.shape
    valid = (centers >= 0).reshape(n_walks, 2 * window, length)
    return valid.sum(dim=1).reshape(-1).to(torch.float32)


def col_pair_logits_plain(emb_in, emb_out, walks, centers, contexts, neg_ids, *,
                          window: int) -> torch.Tensor:
    """K16's function in plain PyTorch (sharded_sgns.py:80-87, before the
    psum)."""
    valid = centers >= 0
    ci = emb_in[torch.where(valid, centers, 0).long()]
    co = emb_out[torch.where(valid, contexts, 0).long()]
    pos = torch.sum(ci * co, dim=-1) * valid.to(torch.float32)
    xin = emb_in[torch.where(walks >= 0, walks, 0).reshape(-1).long()]
    neg = (xin @ emb_out[neg_ids.long()].T) * (_centers_live(centers, walks, window) > 0)[:, None]
    return torch.cat([pos, neg.reshape(-1)])


def _check_col_args(name, emb_in, emb_out, walks, centers, contexts, neg_ids, window) -> None:
    _build.require_cuda(name, emb_in, emb_out, walks, centers, contexts, neg_ids)
    if (emb_in.dtype, emb_out.dtype) != (torch.float32, torch.float32):
        raise TypeError(f"{name} takes float32 tables")
    if any(t.dtype != torch.int32 for t in (walks, centers, contexts, neg_ids)):
        raise TypeError(f"{name} takes int32 walks, pair lists and neg_ids")
    if emb_out.shape != emb_in.shape or emb_in.dim() != 2 or walks.dim() != 2:
        raise ValueError("emb_in and emb_out must both be [V, Dm], walks [B, L1]")
    n = _lanes(walks, window)
    if centers.shape != (n,) or contexts.shape != (n,):
        raise ValueError(f"the pair lists must be [B * 2w * L1] = [{n}]")


def col_pair_logits(emb_in, emb_out, walks, centers, contexts, neg_ids, *,
                    window: int) -> torch.Tensor:
    """K16 for CUDA tensors, the plain version for CPU tensors."""
    if not emb_in.is_cuda:
        return col_pair_logits_plain(emb_in, emb_out, walks, centers, contexts, neg_ids,
                                     window=window)
    _check_col_args("col_pair_logits", emb_in, emb_out, walks, centers, contexts, neg_ids,
                    window)
    n_walks, length = walks.shape
    dim, s = emb_in.shape[1], neg_ids.shape[0]
    n = _lanes(walks, window)
    lib = _build.lib()
    ws, ws_blocks = _build.staging(lib.n2v_col_pair_logits_smem(length, dim, s, window),
                                   n_walks, emb_in.device)
    out = torch.empty((n + n_walks * length * s,), dtype=torch.float32, device=emb_in.device)
    rc = lib.n2v_col_pair_logits(
        _build.ptr(emb_in), _build.ptr(emb_out), dim, _build.ptr(walks), _build.ptr(centers),
        _build.ptr(neg_ids), n_walks, length, window, s, _build.ptr(out),
        _build.ptr(out[n:]), _build.ptr_or_null(ws), ws_blocks, _build.stream_of(emb_in),
    )
    _build.check(rc, "col_pair_logits")
    _build.launches["col_pair_logits"] += 1
    if ws is not None:
        _build.launches["col_pair_logits_global"] += 1
    return out


# --------------------------------------------------------------------------- #
# K17: gradients and partial squares from the model-summed logits
# --------------------------------------------------------------------------- #
#
# Outputs: d_ci, d_co [P, Dm] (0 on invalid lanes), d_no [S, Dm], one flat
# float32 buffer of partial squares [2P + S] (sum over Dm of d_ci[p]^2, of
# d_co[p]^2, of d_no[s]^2: one all-reduce sums them), and the loss
# partials [3] (sum of log sigmoid(pos) over valid lanes, of log
# sigmoid(-neg) over valid lanes and negatives, the valid-lane count).


def col_pair_grads_plain(emb_in, emb_out, walks, centers, contexts, neg_ids, logits, *,
                         window: int, negatives: int):
    """K17's function in plain PyTorch (sharded_sgns.py:89-110 op for op,
    before the psums of the squares)."""
    valid = centers >= 0
    w_valid = valid.to(torch.float32)
    n, s = centers.shape[0], neg_ids.shape[0]
    ci = emb_in[torch.where(valid, centers, 0).long()]
    co = emb_out[torch.where(valid, contexts, 0).long()]
    no = emb_out[neg_ids.long()]
    pos_logit = logits[:n]
    n_walks, length = walks.shape
    # each lane's negative logits are its center position's
    neg_logit = (logits[n:].reshape(n_walks, 1, length, s)
                 .expand(n_walks, 2 * window, length, s).reshape(n, s))
    neg_scale = negatives / s
    parts = torch.stack([torch.sum(F.logsigmoid(pos_logit) * w_valid),
                         torch.sum(F.logsigmoid(-neg_logit) * w_valid[:, None]), w_valid.sum()])
    g_pos = (torch.sigmoid(pos_logit) - 1.0) * w_valid
    g_neg = torch.sigmoid(neg_logit) * w_valid[:, None] * neg_scale
    d_ci = g_pos[:, None] * co + g_neg @ no
    d_co = g_pos[:, None] * ci
    d_no = g_neg.T @ ci
    sq = torch.cat([torch.sum(d_ci * d_ci, dim=-1), torch.sum(d_co * d_co, dim=-1),
                    torch.sum(d_no * d_no, dim=-1)])
    return d_ci, d_co, d_no, sq, parts


def col_pair_grads(emb_in, emb_out, walks, centers, contexts, neg_ids, logits, *,
                   window: int, negatives: int):
    """K17 for CUDA tensors, the plain version for CPU tensors."""
    if not emb_in.is_cuda:
        return col_pair_grads_plain(emb_in, emb_out, walks, centers, contexts, neg_ids,
                                    logits, window=window, negatives=negatives)
    _check_col_args("col_pair_grads", emb_in, emb_out, walks, centers, contexts, neg_ids,
                    window)
    n_walks, length = walks.shape
    dim, s = emb_in.shape[1], neg_ids.shape[0]
    n = _lanes(walks, window)
    if logits.shape != (n + n_walks * length * s,) or logits.dtype != torch.float32:
        raise ValueError("logits must be K16's float32 [P + B * L1 * S] buffer")
    _build.require_cuda("col_pair_grads", emb_in, logits)
    lib = _build.lib()
    ws, ws_blocks = _build.staging(lib.n2v_col_pair_grads_smem(length, dim, s, window),
                                   n_walks, emb_in.device)
    dev = emb_in.device
    d_ci = torch.empty((n, dim), dtype=torch.float32, device=dev)
    d_co = torch.empty_like(d_ci)
    d_no = torch.zeros((s, dim), dtype=torch.float32, device=dev)
    sq = torch.empty((2 * n + s,), dtype=torch.float32, device=dev)
    loss_parts = torch.zeros((n_walks, 3), dtype=torch.float32, device=dev)
    done = torch.zeros((1,), dtype=torch.int32, device=dev)
    rc = lib.n2v_col_pair_grads(
        _build.ptr(emb_in), _build.ptr(emb_out), dim, _build.ptr(walks), _build.ptr(centers),
        _build.ptr(neg_ids), _build.ptr(logits), _build.ptr(logits[n:]), n_walks, length,
        window, s, float(np.float32(negatives / s)), _build.ptr(d_ci), _build.ptr(d_co),
        _build.ptr(d_no), _build.ptr(sq), _build.ptr(sq[n:]), _build.ptr(sq[2 * n:]),
        _build.ptr(loss_parts), _build.ptr(done), _build.ptr_or_null(ws), ws_blocks,
        _build.stream_of(emb_in),
    )
    _build.check(rc, "col_pair_grads")
    _build.launches["col_pair_grads"] += 1
    if ws is not None:
        _build.launches["col_pair_grads_global"] += 1
    return d_ci, d_co, d_no, sq, loss_parts.sum(dim=0)


# --------------------------------------------------------------------------- #
# the step and the epoch
# --------------------------------------------------------------------------- #

_KERNELS = (sg.pair_lists, col_pair_logits, col_pair_grads, sg.adagrad_accumulate_squares,
            sg.adagrad_apply)
_PLAIN = (sg.pair_lists_plain, col_pair_logits_plain, col_pair_grads_plain,
          sg.adagrad_accumulate_squares_plain, sg.adagrad_apply_plain)


def _col_step(ops, mesh: Mesh, state: ShardedSGNSState, walks, b_sh, r1, r2, lr: float,
              ns_alias, ns_prob, vocab_mask, window: int, negatives: int, pairs):
    lists, logits_fn, grads_fn, accumulate, apply = ops
    emb_in, emb_out, acc_in, acc_out = state
    n_vertices = acc_in.shape[0]
    dim = emb_in.shape[1] * mesh.shape["model"]
    neg_ids = sg.negative_ids(r1, r2, ns_alias, ns_prob)
    centers, contexts = lists(walks, b_sh, vocab_mask, window)
    n = centers.shape[0]
    logits = mesh.all_reduce_sum(
        logits_fn(emb_in, emb_out, walks, centers, contexts, neg_ids, window=window), "model")
    d_ci, d_co, d_no, sq, parts = grads_fn(emb_in, emb_out, walks, centers, contexts, neg_ids,
                                           logits, window=window, negatives=negatives)
    mesh.all_reduce_sum(sq, "model")
    # [dacc_in | dacc_out | loss partials]: one all-reduce over the data axis
    red = torch.zeros((2 * n_vertices + 3,), dtype=torch.float32, device=acc_in.device)
    accumulate(red[:n_vertices], red[n_vertices: 2 * n_vertices], sq[:n], centers,
               sq[n: 2 * n], contexts, sq[2 * n:], neg_ids, dim)
    red[2 * n_vertices:] = parts
    mesh.all_reduce_sum(red, "data")
    acc_in += red[:n_vertices]
    acc_out += red[n_vertices: 2 * n_vertices]
    tot = red[2 * n_vertices:]
    loss = -(tot[0] + (negatives / neg_ids.shape[0]) * tot[1]) / torch.clamp(tot[2], min=1.0)
    sg._add_pairs(pairs, tot[2])
    # invalid lanes (row -1) have zero gradients and are skipped
    rows = (d_ci, centers, d_co, contexts, d_no, neg_ids)
    if mesh.shape["data"] == 1:
        apply(emb_in, emb_out, acc_in, acc_out, *rows, lr)
    else:
        delta = torch.zeros((2,) + tuple(emb_in.shape), dtype=torch.float32,
                            device=emb_in.device)
        apply(delta[0], delta[1], acc_in, acc_out, *rows, lr)
        mesh.all_reduce_sum(delta, "data")  # the dense psum of the JAX step
        emb_in += delta[0]
        emb_out += delta[1]
    return loss


def sharded_sgns_step(
    mesh: Mesh, state: ShardedSGNSState, walks, b_sh, r1, r2, lr: float, ns_alias, ns_prob,
    vocab_mask, *, window: int, negatives: int, pairs=None,
) -> torch.Tensor:
    """One TP × DP step (``_col_step``), in place on ``state``; returns the
    loss, the same on every rank.  ``walks``: this rank's data block of the
    batch [B / n_data, L1]; ``b_sh`` ([B / n_data, 1, L1] or [B / n_data,
    L1], 1..w; None for the full window), ``r1``/``r2`` [S]: its data
    coordinate's draws.  ``pairs``, a scalar tensor or None, gains the
    step's valid-lane count over all data shards.  K13's pair lists, K16,
    K17, K3's squares mode and K4 on CUDA tensors, their plain versions on
    CPU tensors."""
    return _col_step(_KERNELS, mesh, state, walks, b_sh, r1, r2, lr, ns_alias, ns_prob,
                     vocab_mask, window, negatives, pairs)


def sharded_sgns_step_plain(
    mesh: Mesh, state: ShardedSGNSState, walks, b_sh, r1, r2, lr: float, ns_alias, ns_prob,
    vocab_mask, *, window: int, negatives: int, pairs=None,
) -> torch.Tensor:
    """``sharded_sgns_step`` through the plain versions, on any device."""
    return _col_step(_PLAIN, mesh, state, walks, b_sh, r1, r2, lr, ns_alias, ns_prob,
                     vocab_mask, window, negatives, pairs)


def col_sgns_epoch(
    mesh: Mesh, state: ShardedSGNSState, corpus: torch.Tensor, perm: torch.Tensor,
    draws: Callable[[int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    step0: int, lr0: float, lr_slope: float, ns_alias, ns_prob, vocab_mask, *,
    batch_local: int, n_batches: int, window: int, negatives: int, min_lr: float,
    pairs=None,
) -> torch.Tensor:
    """One epoch of column-sharded TP × DP SGNS (``_build_col_epoch``,
    sharded_sgns.py:184-245, as a Python loop).  ``corpus``: this rank's
    data block, [n_batches * batch_local, L1]; ``perm``: its shuffle, a
    permutation of those rows drawn for the data coordinate (the JAX epoch's
    ``permutation(fold_in(fold_in(key, 0x5F5E2), d))``); ``draws(gstep)``:
    the data coordinate's (b_sh, r1, r2) of global step ``gstep``.  The
    learning rate decays on the step as in ``models.skipgram.step_lr``.
    Returns the per-batch losses [n_batches]."""
    corpus = corpus[perm.to(corpus.device)]
    losses = []
    for b in range(n_batches):
        gstep = step0 + b
        lr = sg.step_lr(lr0, lr_slope, gstep, min_lr)
        b_sh, r1, r2 = draws(gstep)
        losses.append(sharded_sgns_step(
            mesh, state, corpus[b * batch_local: (b + 1) * batch_local], b_sh, r1, r2, lr,
            ns_alias, ns_prob, vocab_mask, window=window, negatives=negatives, pairs=pairs,
        ))
    return torch.stack(losses)
