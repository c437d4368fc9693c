"""CBOW, the ``sg=0`` architecture (port of ``node2vec_tpu/models/cbow.py``),
gensim's default: ``Word2VecParams(sg=0)``.

For every center position the hidden vector ``h`` is the mean
(``cbow_mean=True``, gensim's default) or the sum of its contexts' input
rows inside the shrunk window; a position with no valid context is no
trainable center (``w_c = 0``).  ``h`` is scored against the center's
output row and S shared negatives (``negative > 0``, CBOW-NS), or along
the center's own Huffman path (``negative == 0``, CBOW-HS, on the tree
``models/hsoftmax.py`` builds, with no dense head: every path entry gets
one update per occurrence).  The gradient of ``h`` goes back to every
contributing context's input row (divided by the context count under
``cbow_mean``, like gensim's ``g /= count``), and the loss is divided by
the number of trainable centers.

Kernels, each beside its plain PyTorch version:

* K9 ``cbow_grads`` (``csrc/cbow.cu``): g_in, d_out (the centers' output
  rows), d_no (the shared negatives) and the loss;
* K10 ``cbow_hs_grads`` (``csrc/cbow_hs.cu``): g_in, the per-occurrence
  path gradients g_theta with their theta rows (-1 where masked) and the
  loss;
* K3 ``adagrad_accumulate`` and K4 ``adagrad_apply`` (``models/skipgram.py``)
  over (g_in, walks), (d_out, walks), (d_no, negatives) for CBOW-NS and
  (g_in, walks), (g_theta, theta_rows) and an empty list for CBOW-HS.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise.  The steps take their draws as tensors, as the skip-gram steps do:
CBOW-NS the (b_sh, r1, r2) of ``Draws.step`` (the JAX step splits its key
as SGNS does), CBOW-HS the b_sh of ``Draws.window_shrink`` (drawn from the
unsplit key, as skip-gram HS draws it).  Every table stays fp32: the JAX
CBOW-HS step's bf16 h, theta and g are a TPU storage choice.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from node2vec_torch import _build
from node2vec_torch.models.skipgram import (
    _step as _ns_step,
    adagrad_accumulate,
    adagrad_accumulate_plain,
    adagrad_apply,
    adagrad_apply_plain,
    step_lr,
    window_shift,
)

# --------------------------------------------------------------------------- #
# the context window (plain)
# --------------------------------------------------------------------------- #


def context_mean(x_in: torch.Tensor, valid_pos: torch.Tensor, b_sh: torch.Tensor,
                 window: int, cbow_mean: bool):
    """cbow.py:60 ``_context_mean``: (h [B, L1, D], cnt [B, L1] context
    counts, [(d, [B, L1] 0/1 validity of offset d)]).  A center with no
    valid context has h = 0 and cnt = 0."""
    pv: List[Tuple[int, torch.Tensor]] = []
    h_sum = torch.zeros_like(x_in)
    cnt = torch.zeros(valid_pos.shape, dtype=torch.float32, device=x_in.device)
    for d in [d for d in range(-window, window + 1) if d != 0]:
        pvd = (valid_pos & window_shift(valid_pos, d) & (abs(d) <= b_sh)).to(torch.float32)
        pv.append((d, pvd))
        h_sum = h_sum + window_shift(x_in, d) * pvd[..., None]
        cnt = cnt + pvd
    h = h_sum / torch.clamp(cnt, min=1.0)[..., None] if cbow_mean else h_sum
    return h, cnt, pv


def scatter_context_grads(g_h: torch.Tensor, pv) -> torch.Tensor:
    """cbow.py:94 ``_scatter_context_grads``: g_in[l + d] += g_h[l] for
    every valid (center l, offset d)."""
    g_in = torch.zeros_like(g_h)
    for d, pvd in pv:
        g_in = g_in + window_shift(g_h * pvd[..., None], -d)
    return g_in


def _centers(emb_in, walks, vocab_mask, b_sh, window: int, cbow_mean: bool):
    """(walks_safe, h, cnt, pv, w_c, n_centers) of a batch."""
    walks_safe = torch.where(walks >= 0, walks, 0).long()
    valid_pos = (walks >= 0) & vocab_mask[walks_safe]
    h, cnt, pv = context_mean(emb_in[walks_safe], valid_pos, b_sh, window, cbow_mean)
    w_c = (valid_pos & (cnt > 0)).to(torch.float32)  # trainable centers
    return walks_safe, h, cnt, pv, w_c, torch.clamp(w_c.sum(), min=1.0)


# --------------------------------------------------------------------------- #
# K9: grads of one CBOW-NS step
# --------------------------------------------------------------------------- #


def cbow_grads_plain(emb_in, emb_out, walks, vocab_mask, b_sh, neg_ids, *, window: int,
                     negatives: int, cbow_mean: bool):
    """cbow.py:148-196 op for op: (g_in [B*L1, D], d_out [B*L1, D],
    d_no [S, D], loss)."""
    n_walks, length = walks.shape
    dim = emb_in.shape[1]
    walks_safe, h, cnt, pv, w_c, n_centers = _centers(emb_in, walks, vocab_mask, b_sh,
                                                      window, cbow_mean)
    x_out = emb_out[walks_safe]  # the centers' own output rows
    pos_logit = torch.sum(h * x_out, dim=-1)
    g_pos = (torch.sigmoid(pos_logit) - 1.0) * w_c

    s = neg_ids.shape[0]
    no = emb_out[neg_ids.long()]  # [S, D]
    h_flat = h.reshape(-1, dim)
    w_flat = w_c.reshape(-1)
    neg_scale = negatives / s
    nl = h_flat @ no.T  # [B*L1, S]
    g_neg = torch.sigmoid(nl) * w_flat[:, None] * neg_scale
    loss = -(torch.sum(F.logsigmoid(pos_logit) * w_c)
             + neg_scale * torch.sum(F.logsigmoid(-nl) * w_flat[:, None])) / n_centers

    g_h = g_pos[..., None] * x_out + (g_neg @ no).reshape(n_walks, length, dim)
    if cbow_mean:
        g_h = g_h / torch.clamp(cnt, min=1.0)[..., None]
    g_in = scatter_context_grads(g_h, pv)
    d_out = g_pos[..., None] * h
    d_no = g_neg.T @ h_flat
    return g_in.reshape(-1, dim), d_out.reshape(-1, dim), d_no, loss


def cbow_grads(emb_in, emb_out, walks, vocab_mask, b_sh, neg_ids, *, window: int,
               negatives: int, cbow_mean: bool):
    """K9 for CUDA tensors, the plain version for CPU tensors."""
    if not emb_in.is_cuda:
        return cbow_grads_plain(emb_in, emb_out, walks, vocab_mask, b_sh, neg_ids,
                                window=window, negatives=negatives, cbow_mean=cbow_mean)
    _build.require_cuda("cbow_grads", emb_in, emb_out, walks, vocab_mask, b_sh, neg_ids)
    if (emb_in.dtype, emb_out.dtype) != (torch.float32, torch.float32):
        raise TypeError("cbow_grads takes float32 tables")
    if (walks.dtype, b_sh.dtype, neg_ids.dtype, vocab_mask.dtype) != (
        torch.int32, torch.int32, torch.int32, torch.bool
    ):
        raise TypeError("cbow_grads takes int32 walks/b_sh/neg_ids and a bool mask")
    if b_sh.shape != walks.shape or walks.dim() != 2:
        raise ValueError(f"b_sh {tuple(b_sh.shape)} must match walks {tuple(walks.shape)}")
    if emb_out.shape != emb_in.shape or emb_in.dim() != 2:
        raise ValueError("emb_in and emb_out must both be [V, D]")
    n_walks, length = walks.shape
    dim = emb_in.shape[1]
    s = neg_ids.shape[0]
    lib = _build.lib()
    ws, ws_blocks = _build.staging(lib.n2v_cbow_grads_smem(length, dim, s), n_walks,
                                   emb_in.device)
    dev = emb_in.device
    g_in = torch.empty((n_walks * length, dim), dtype=torch.float32, device=dev)
    d_out = torch.empty_like(g_in)
    d_no = torch.zeros((s, dim), dtype=torch.float32, device=dev)
    parts = torch.zeros((n_walks, 3), dtype=torch.float32, device=dev)
    neg_scale = negatives / s
    rc = lib.n2v_cbow_grads(
        _build.ptr(emb_in), _build.ptr(emb_out), dim, _build.ptr(walks),
        _build.ptr(vocab_mask), _build.ptr(b_sh), _build.ptr(neg_ids),
        n_walks, length, window, s, float(np.float32(neg_scale)), int(cbow_mean),
        _build.ptr(g_in), _build.ptr(d_out), _build.ptr(d_no), _build.ptr(parts),
        _build.ptr_or_null(ws), ws_blocks, _build.stream_of(emb_in),
    )
    _build.check(rc, "cbow_grads")
    _build.launches["cbow_grads"] += 1
    if ws is not None:
        _build.launches["cbow_grads_global"] += 1
    tot = parts.sum(dim=0)
    loss = -(tot[0] + neg_scale * tot[1]) / torch.clamp(tot[2], min=1.0)
    return g_in, d_out, d_no, loss


# --------------------------------------------------------------------------- #
# K10: grads of one CBOW-HS step
# --------------------------------------------------------------------------- #


def cbow_hs_grads_plain(emb_in, theta, walks, vocab_mask, b_sh, points, codes, lengths, *,
                        window: int, cbow_mean: bool):
    """cbow.py:264-304 in fp32: (g_in [B*L1, D], g_theta [B*L1*CL, D],
    theta_rows [B*L1*CL] int32, loss).  Row (position * CL + c) of g_theta
    is the gradient of the center's level-c path entry; theta_rows is that
    entry's theta row, or -1 where the center is not trainable or c lies
    beyond its code."""
    dim = emb_in.shape[1]
    cl = points.shape[1]
    walks_safe, h, cnt, pv, w_c, n_centers = _centers(emb_in, walks, vocab_mask, b_sh,
                                                      window, cbow_mean)
    pts = points[walks_safe].long()  # [B, L1, CL]: the CENTER's own path
    sgn = 1.0 - 2.0 * codes[walks_safe].to(torch.float32)
    plen = lengths[walks_safe]
    pmask = (torch.arange(cl, device=walks.device)[None, None, :]
             < plen[..., None]).to(torch.float32) * w_c[..., None]
    th = theta[pts]  # [B, L1, CL, D]
    logit = (h[:, :, None, :] * th).sum(-1)
    loss = -(F.logsigmoid(sgn * logit) * pmask).sum() / n_centers
    g = (torch.sigmoid(logit) - (1.0 + sgn) / 2.0) * pmask  # [B, L1, CL]
    g_h = (g[..., None] * th).sum(2)
    g_th = g[..., None] * h[:, :, None, :]
    if cbow_mean:
        g_h = g_h / torch.clamp(cnt, min=1.0)[..., None]
    g_in = scatter_context_grads(g_h, pv)
    theta_rows = torch.where(pmask > 0, pts, -1).reshape(-1).to(torch.int32)
    return g_in.reshape(-1, dim), g_th.reshape(-1, dim), theta_rows, loss


def cbow_hs_grads(emb_in, theta, walks, vocab_mask, b_sh, points, codes, lengths, *,
                  window: int, cbow_mean: bool):
    """K10 for CUDA tensors, the plain version for CPU tensors."""
    if not emb_in.is_cuda:
        return cbow_hs_grads_plain(emb_in, theta, walks, vocab_mask, b_sh, points, codes,
                                   lengths, window=window, cbow_mean=cbow_mean)
    _build.require_cuda("cbow_hs_grads", emb_in, theta, walks, vocab_mask, b_sh, points, codes,
                        lengths)
    if (emb_in.dtype, theta.dtype) != (torch.float32, torch.float32):
        raise TypeError("cbow_hs_grads takes float32 tables")
    if (walks.dtype, b_sh.dtype, points.dtype, codes.dtype, lengths.dtype,
            vocab_mask.dtype) != (torch.int32, torch.int32, torch.int32, torch.int8,
                                  torch.int32, torch.bool):
        raise TypeError("cbow_hs_grads takes int32 walks/b_sh/points/lengths, int8 codes "
                        "and a bool mask")
    if b_sh.shape != walks.shape or walks.dim() != 2:
        raise ValueError(f"b_sh {tuple(b_sh.shape)} must match walks {tuple(walks.shape)}")
    if emb_in.dim() != 2 or theta.dim() != 2 or theta.shape[1] != emb_in.shape[1]:
        raise ValueError("emb_in must be [V, D] and theta [n_inner, D]")
    n_vertices = emb_in.shape[0]
    if (points.shape != codes.shape or points.dim() != 2 or points.shape[0] != n_vertices
            or lengths.shape != (n_vertices,)):
        raise ValueError("points/codes must be [V, CL] and lengths [V]")
    n_walks, length = walks.shape
    dim = emb_in.shape[1]
    cl = points.shape[1]
    lib = _build.lib()
    ws, ws_blocks = _build.staging(lib.n2v_cbow_hs_grads_smem(length, dim), n_walks,
                                   emb_in.device)
    dev = emb_in.device
    g_in = torch.empty((n_walks * length, dim), dtype=torch.float32, device=dev)
    g_theta = torch.empty((n_walks * length * cl, dim), dtype=torch.float32, device=dev)
    theta_rows = torch.empty((n_walks * length * cl,), dtype=torch.int32, device=dev)
    parts = torch.zeros((n_walks, 2), dtype=torch.float32, device=dev)
    rc = lib.n2v_cbow_hs_grads(
        _build.ptr(emb_in), _build.ptr(theta), dim, _build.ptr(walks),
        _build.ptr(vocab_mask), _build.ptr(b_sh), _build.ptr(points), _build.ptr(codes),
        _build.ptr(lengths), cl, n_walks, length, window, int(cbow_mean),
        _build.ptr(g_in), _build.ptr(g_theta), _build.ptr(theta_rows), _build.ptr(parts),
        _build.ptr_or_null(ws), ws_blocks, _build.stream_of(emb_in),
    )
    _build.check(rc, "cbow_hs_grads")
    _build.launches["cbow_hs_grads"] += 1
    if ws is not None:
        _build.launches["cbow_hs_grads_global"] += 1
    tot = parts.sum(dim=0)
    loss = -tot[0] / torch.clamp(tot[1], min=1.0)
    return g_in, g_theta, theta_rows, loss


# --------------------------------------------------------------------------- #
# the steps and the epochs
# --------------------------------------------------------------------------- #


def cbow_walk_step(emb_in, emb_out, acc_in, acc_out, walks, b_sh, r1, r2, lr: float,
                   ns_alias, ns_prob, vocab_mask, *, window: int, negatives: int,
                   cbow_mean: bool) -> torch.Tensor:
    """One CBOW-NS + row-wise Adagrad step (``cbow_walk_step_impl``), in
    place on the four state tensors; returns the loss.  Goes through K9, K3,
    K4 on CUDA tensors and their plain versions on CPU tensors."""
    return _ns_step(functools.partial(cbow_grads, cbow_mean=cbow_mean), adagrad_accumulate,
                    adagrad_apply, emb_in, emb_out, acc_in, acc_out, walks, b_sh, r1, r2, lr,
                    ns_alias, ns_prob, vocab_mask, window, negatives)


def cbow_walk_step_plain(emb_in, emb_out, acc_in, acc_out, walks, b_sh, r1, r2, lr: float,
                         ns_alias, ns_prob, vocab_mask, *, window: int, negatives: int,
                         cbow_mean: bool) -> torch.Tensor:
    """``cbow_walk_step`` through the three plain versions, on any device."""
    return _ns_step(functools.partial(cbow_grads_plain, cbow_mean=cbow_mean),
                    adagrad_accumulate_plain, adagrad_apply_plain, emb_in, emb_out, acc_in,
                    acc_out, walks, b_sh, r1, r2, lr, ns_alias, ns_prob, vocab_mask, window,
                    negatives)


def cbow_hs_lists(g_in, g_theta, theta_rows, walks):
    """K3/K4's three (grads, rows) lists of a CBOW-HS step: the emb_in rows,
    theta's path entries (-1 where masked) and an empty third list (no
    head)."""
    none = torch.empty((0,), dtype=torch.int32, device=walks.device)
    return (g_in, walks.reshape(-1), g_theta, theta_rows, g_theta[:0], none)


def _hs_step(grads, accumulate, apply, emb_in, theta, acc_in, acc_theta, walks, b_sh, lr,
             points, codes, lengths, vocab_mask, window, cbow_mean):
    g_in, g_theta, theta_rows, loss = grads(
        emb_in, theta, walks, vocab_mask, b_sh, points, codes, lengths,
        window=window, cbow_mean=cbow_mean,
    )
    lists = cbow_hs_lists(g_in, g_theta, theta_rows, walks)
    accumulate(acc_in, acc_theta, *lists)
    apply(emb_in, theta, acc_in, acc_theta, *lists, lr)
    return loss


def cbow_hs_step(emb_in, theta, acc_in, acc_theta, walks, b_sh, lr: float, points, codes,
                 lengths, vocab_mask, *, window: int, cbow_mean: bool) -> torch.Tensor:
    """One CBOW-HS + row-wise Adagrad step (``cbow_hs_step_impl``), in place
    on the four state tensors; returns the loss.  Goes through K10, K3, K4
    on CUDA tensors and their plain versions on CPU tensors."""
    return _hs_step(cbow_hs_grads, adagrad_accumulate, adagrad_apply, emb_in, theta, acc_in,
                    acc_theta, walks, b_sh, lr, points, codes, lengths, vocab_mask, window,
                    cbow_mean)


def cbow_hs_step_plain(emb_in, theta, acc_in, acc_theta, walks, b_sh, lr: float, points,
                       codes, lengths, vocab_mask, *, window: int,
                       cbow_mean: bool) -> torch.Tensor:
    """``cbow_hs_step`` through the three plain versions, on any device."""
    return _hs_step(cbow_hs_grads_plain, adagrad_accumulate_plain, adagrad_apply_plain,
                    emb_in, theta, acc_in, acc_theta, walks, b_sh, lr, points, codes, lengths,
                    vocab_mask, window, cbow_mean)


def cbow_epoch(
    emb_in, emb_out, acc_in, acc_out, corpus: torch.Tensor,
    draws: Callable[[int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    step0: int, lr0: float, lr_slope: float, ns_alias, ns_prob, vocab_mask, *,
    batch: int, n_batches: int, window: int, negatives: int, min_lr: float,
    cbow_mean: bool,
) -> torch.Tensor:
    """A whole epoch of CBOW-NS steps over a shuffled, batch-padded corpus
    (``_cbow_epoch_impl`` as a Python loop).  ``draws(gstep)`` returns the
    step's (b_sh, r1, r2).  Returns the per-batch losses."""
    losses = []
    for b in range(n_batches):
        gstep = step0 + b
        b_sh, r1, r2 = draws(gstep)
        losses.append(cbow_walk_step(
            emb_in, emb_out, acc_in, acc_out, corpus[b * batch: (b + 1) * batch], b_sh, r1, r2,
            step_lr(lr0, lr_slope, gstep, min_lr), ns_alias, ns_prob, vocab_mask,
            window=window, negatives=negatives, cbow_mean=cbow_mean,
        ))
    return torch.stack(losses)


def cbow_hs_epoch(
    emb_in, theta, acc_in, acc_theta, corpus: torch.Tensor,
    draws: Callable[[int], torch.Tensor], step0: int, lr0: float, lr_slope: float,
    points, codes, lengths, vocab_mask, *,
    batch: int, n_batches: int, window: int, min_lr: float, cbow_mean: bool,
) -> torch.Tensor:
    """A whole epoch of CBOW-HS steps (``_cbow_hs_epoch_impl`` as a Python
    loop).  ``draws(gstep)`` returns the step's window shrink b_sh [B, L1].
    Returns the per-batch losses."""
    losses = []
    for b in range(n_batches):
        gstep = step0 + b
        losses.append(cbow_hs_step(
            emb_in, theta, acc_in, acc_theta, corpus[b * batch: (b + 1) * batch], draws(gstep),
            step_lr(lr0, lr_slope, gstep, min_lr), points, codes, lengths, vocab_mask,
            window=window, cbow_mean=cbow_mean,
        ))
    return torch.stack(losses)
