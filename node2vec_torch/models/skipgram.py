"""Walk-structured skip-gram negative sampling (port of the SGNS path of
``node2vec_tpu/models/skipgram.py``).

One step over a batch of walks ``[B, L1]``: every walk position's input and
output rows are gathered once, all window offsets are shifted elementwise
products with gensim-style window shrinking, S negatives are shared by the
whole batch (drawn from the unigram^0.75 alias table, loss scaled by K/S),
and one of three updates:

* row-wise Adagrad per occurrence (the default): every occurrence's
  mean-squared grad lands in the row's accumulator before any row is
  scaled by 1/sqrt of it;
* ``preagg=True`` with Adagrad: the gradients of a vertex's occurrences are
  summed first, and each vertex takes one accumulator increment and one
  update per batch (the shared negatives are not de-duplicated);
* ``optimizer="sgd"`` (which forces ``preagg``): each vertex steps by
  ``-lr * sum / count`` over its occurrences with ``walks >= 0``, and the
  negatives by ``-lr * d_no / max(pairs * K / S, 1)``; no accumulator
  changes.

The step is five kernels, each beside its plain PyTorch version:

* K2 ``sgns_grads`` (``csrc/sgns.cu``): grads, d_no, the loss and the
  batch's valid-pair count;
* K3 ``adagrad_accumulate`` and K4 ``adagrad_apply`` (``csrc/adagrad.cu``),
  two launches because the accumulators must be complete before any row
  reads them.  They take three (grads, rows) lists, so the HS step
  (``models/hsoftmax.py``) and the preaggregated step run on them too;
* K11 ``preagg_rows`` and ``sgd_apply`` (``csrc/preagg.cu``): the segment
  sums and counts of the batch's rows by vertex, and the SGD update.

Beside the trainers' step, the module has the JAX package's other SGNS
steps, which no trainer of either package calls:

* ``sgns_train_step``, the pair-based step, with ``make_pairs``: K13
  ``sgns_pair_grads`` (``csrc/sgns_pairs.cu``: the pair lists, then
  per-lane gradients), then K3/K4 over the pair lists;
* ``sgns_walk_step_fused`` and ``sgns_epoch_fused`` on [V, D+1] tables
  with the accumulator in column D: K2 with the tables' width as its row
  stride, then K14 ``fused_adagrad`` (``csrc/fused_adagrad.cu``);
* ``sgns_corpus_step``, ``sgns_walk_step`` on a slice of a corpus.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise.  Unlike the JAX step, which draws its randomness inside, this step
takes the draws as tensors: ``b_sh`` [B, L1] int32 in [1, w], ``r1``/``r2``
[S] float32 (``draw_step`` makes them from a torch.Generator; tests make
them with jax.random).  Tables and accumulators are updated in place, which
saves the copies the functional JAX version makes.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from node2vec_torch import _build
from node2vec_torch.device import resolve_device

_EPS = 1e-12
SLOT_EMPTY = int(np.iinfo(np.int32).max)  # an unclaimed entry of K11's slot map
OPTIMIZERS = ("adagrad", "sgd")


def init_embeddings(
    n_vertices: int, dim: int, seed: int = 1, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """word2vec-standard init: input ~ U(-0.5/dim, 0.5/dim), output zeros,
    plus the two row-wise Adagrad accumulators (zeros).  The uniform comes
    from a torch.Generator seeded with ``seed`` on ``device``, which is the
    card unless the caller passes ``device="cpu"``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    emb_in = torch.rand((n_vertices, dim), generator=gen, device=device)
    emb_in = (emb_in - 0.5) / dim
    emb_out = torch.zeros((n_vertices, dim), dtype=torch.float32, device=device)
    acc_in = torch.zeros((n_vertices,), dtype=torch.float32, device=device)
    acc_out = torch.zeros((n_vertices,), dtype=torch.float32, device=device)
    return emb_in, emb_out, acc_in, acc_out


def draw_step(
    gen: torch.Generator, n_walks: int, length: int, window: int,
    shared_negatives: int, shrink_window: bool, device,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step's random draws: (b_sh [B, L1] int32 in [1, w], r1 [S], r2 [S])."""
    if shrink_window:
        b_sh = torch.randint(
            1, window + 1, (n_walks, length), generator=gen, device=device,
            dtype=torch.int32,
        )
    else:
        b_sh = torch.full((n_walks, length), window, dtype=torch.int32, device=device)
    r1 = torch.rand((shared_negatives,), generator=gen, device=device)
    r2 = torch.rand((shared_negatives,), generator=gen, device=device)
    return b_sh, r1, r2


def negative_ids(
    r1: torch.Tensor, r2: torch.Tensor, ns_alias: torch.Tensor, ns_prob: torch.Tensor
) -> torch.Tensor:
    """Shared negatives from the noise alias table (skipgram.py:382-383)."""
    n_vertices = ns_prob.shape[0]
    slot = torch.clamp((r1 * n_vertices).to(torch.int32), max=n_vertices - 1)
    slot_l = slot.long()
    return torch.where(r2 < ns_prob[slot_l], slot, ns_alias[slot_l]).to(torch.int32)


def window_shift(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x`` shifted by ``d`` along axis 1: entry i is x[:, i + d], zero
    outside the walk."""
    out = torch.zeros_like(x)
    length = x.shape[1]
    if abs(d) >= length:
        return out
    if d >= 0:
        out[:, : length - d] = x[:, d:]
    else:
        out[:, -d:] = x[:, : length + d]
    return out


# --------------------------------------------------------------------------- #
# K2: grads of one step
# --------------------------------------------------------------------------- #


def sgns_grads_plain(
    emb_in, emb_out, walks, vocab_mask, b_sh, neg_ids, *, window: int, negatives: int,
    dim=None,
):
    """skipgram.py:344-398 op for op: (g_in [B*L1, D], g_out [B*L1, D],
    d_no [S, D], loss, pairs), ``pairs`` the batch's valid-pair count
    (sum of mult, a float32 scalar: the SGD step scales the negatives by
    it).  ``dim``: the tables' first ``dim`` columns are the vectors (the
    fused [V, D+1] tables, :541-596); None reads every column."""
    if dim is not None:
        emb_in, emb_out = emb_in[:, :dim], emb_out[:, :dim]
    walks_safe = torch.where(walks >= 0, walks, 0).long()
    valid_pos = (walks >= 0) & vocab_mask[walks_safe]
    g_in, g_out, d_no, pos_loss, neg_sum, pairs = sgns_terms(
        emb_in[walks_safe], emb_out[walks_safe], emb_out[neg_ids.long()], valid_pos, b_sh,
        window, negatives)
    neg_loss = (negatives / neg_ids.shape[0]) * neg_sum
    loss = -(pos_loss + neg_loss) / torch.clamp(pairs, min=1.0)
    return g_in, g_out, d_no, loss, pairs


def sgns_terms(x_in, x_out, no, valid_pos, b_sh, window: int, negatives: int, neg_live=None):
    """The body of K2's plain versions (skipgram.py:344-398) on gathered
    rows x_in, x_out [B, L1, D] and the negatives' rows no [S, D]: (g_in
    [B*L1, D], g_out [B*L1, D], d_no [S, D], the sum of log sigmoid over the
    valid pairs' logits, the negative terms' sum before the K/S factor, the
    valid-pair count).  ``neg_live`` (the routed step's ``ok_neg.all()``)
    scales every negative term; None leaves them whole."""
    n_walks, length, dim = x_in.shape
    g_in = torch.zeros_like(x_in)
    g_out = torch.zeros_like(x_out)
    pos_loss = torch.zeros((), dtype=torch.float32, device=x_in.device)
    mult = torch.zeros((n_walks, length), dtype=torch.float32, device=x_in.device)
    for d in [d for d in range(-window, window + 1) if d != 0]:
        xo = window_shift(x_out, d)
        pv = (valid_pos & window_shift(valid_pos, d) & (abs(d) <= b_sh)).to(torch.float32)
        logit = torch.sum(x_in * xo, dim=-1)
        g = (torch.sigmoid(logit) - 1.0) * pv
        g_in = g_in + g[..., None] * xo
        g_out = g_out + window_shift(g[..., None] * x_in, -d)
        pos_loss = pos_loss + torch.sum(F.logsigmoid(logit) * pv)
        mult = mult + pv

    x_in_flat = x_in.reshape(-1, dim)
    m_flat = mult.reshape(-1)
    if neg_live is not None:
        m_flat = m_flat * neg_live
    neg_scale = negatives / no.shape[0]
    nl = x_in_flat @ no.T  # [B*L1, S]
    g_neg = torch.sigmoid(nl) * m_flat[:, None] * neg_scale
    neg_sum = torch.sum(F.logsigmoid(-nl) * m_flat[:, None])
    g_in_flat = g_in.reshape(-1, dim) + g_neg @ no
    d_no = g_neg.T @ x_in_flat
    return g_in_flat, g_out.reshape(-1, dim), d_no, pos_loss, neg_sum, torch.sum(mult)


def sgns_grads(
    emb_in, emb_out, walks, vocab_mask, b_sh, neg_ids, *, window: int, negatives: int,
    dim=None,
):
    """K2 for CUDA tensors, the plain version for CPU tensors.  ``dim``:
    as in the plain version; K2 then reads rows of the tables' width (its
    ``ld``) and their first ``dim`` columns."""
    if not emb_in.is_cuda:
        return sgns_grads_plain(
            emb_in, emb_out, walks, vocab_mask, b_sh, neg_ids,
            window=window, negatives=negatives, dim=dim,
        )
    _build.require_cuda("sgns_grads", emb_in, emb_out, walks, vocab_mask, b_sh, neg_ids)
    if (emb_in.dtype, emb_out.dtype) != (torch.float32, torch.float32):
        raise TypeError("sgns_grads takes float32 tables")
    if (walks.dtype, b_sh.dtype, neg_ids.dtype, vocab_mask.dtype) != (
        torch.int32, torch.int32, torch.int32, torch.bool
    ):
        raise TypeError("sgns_grads takes int32 walks/b_sh/neg_ids and a bool mask")
    if b_sh.shape != walks.shape or walks.dim() != 2:
        raise ValueError(f"b_sh {tuple(b_sh.shape)} must match walks {tuple(walks.shape)}")
    if emb_out.shape != emb_in.shape or emb_in.dim() != 2:
        raise ValueError("emb_in and emb_out must both be [V, D]")
    n_walks, length = walks.shape
    ld = emb_in.shape[1]
    dim = ld if dim is None else int(dim)
    if not 0 < dim <= ld:
        raise ValueError(f"dim {dim} must be in 1..{ld}, the tables' width")
    s = neg_ids.shape[0]
    lib = _build.lib()
    ws, ws_blocks = _build.staging(lib.n2v_sgns_grads_smem(length, dim, s, window), n_walks,
                                   emb_in.device)
    dev = emb_in.device
    g_in = torch.empty((n_walks * length, dim), dtype=torch.float32, device=dev)
    g_out = torch.empty_like(g_in)
    d_no = torch.zeros((s, dim), dtype=torch.float32, device=dev)
    parts = torch.zeros((n_walks, 3), dtype=torch.float32, device=dev)
    neg_scale = negatives / s
    rc = lib.n2v_sgns_grads(
        _build.ptr(emb_in), _build.ptr(emb_out), dim, ld, _build.ptr(walks),
        _build.ptr(vocab_mask), _build.ptr(b_sh), _build.ptr(neg_ids),
        n_walks, length, window, s, float(np.float32(neg_scale)),
        _build.ptr(g_in), _build.ptr(g_out), _build.ptr(d_no), _build.ptr(parts),
        _build.ptr_or_null(ws), ws_blocks, _build.stream_of(emb_in),
    )
    _build.check(rc, "sgns_grads")
    _build.launches["sgns_grads"] += 1
    if ws is not None:
        _build.launches["sgns_grads_global"] += 1
    tot = parts.sum(dim=0)
    loss = -(tot[0] + neg_scale * tot[1]) / torch.clamp(tot[2], min=1.0)
    return g_in, g_out, d_no, loss, tot[2]


# --------------------------------------------------------------------------- #
# K3 + K4: row-wise Adagrad, per occurrence
# --------------------------------------------------------------------------- #
#
# Both take three (grads, rows) lists: g_in at rows_in of emb_in / acc_in,
# g_out at rows_out and g_extra at rows_extra of emb_out / acc_out.  A row
# id < 0 skips its gradient row.  SGNS passes the flat walks as rows_in and
# rows_out and its shared negatives with d_no as the extra list; HS passes
# the flat walks, the tail rows of theta and its head rows 0..K-1 with
# d_head (models/hsoftmax.py).


def _row_lists(t_in, t_out, g_in, rows_in, g_out, rows_out, g_extra, rows_extra):
    """(target, grads, rows) of the three lists: t_in is emb_in or acc_in,
    t_out emb_out or acc_out."""
    return ((t_in, g_in, rows_in), (t_out, g_out, rows_out), (t_out, g_extra, rows_extra))


def adagrad_accumulate_plain(acc_in, acc_out, g_in, rows_in, g_out, rows_out, g_extra,
                             rows_extra):
    """skipgram.py:463-468 (and hsoftmax.py:396-398, :414-416, :420-427), in
    place on the accumulators."""
    for acc, g, rows in _row_lists(acc_in, acc_out, g_in, rows_in, g_out, rows_out,
                                   g_extra, rows_extra):
        safe = torch.where(rows >= 0, rows, 0).long()
        acc.index_add_(0, safe, torch.mean(g * g, dim=-1) * (rows >= 0).to(torch.float32))


def adagrad_accumulate(acc_in, acc_out, g_in, rows_in, g_out, rows_out, g_extra,
                       rows_extra):
    """K3 for CUDA tensors, the plain version for CPU tensors."""
    args = (g_in, rows_in, g_out, rows_out, g_extra, rows_extra)
    if not acc_in.is_cuda:
        return adagrad_accumulate_plain(acc_in, acc_out, *args)
    _build.require_cuda("adagrad_accumulate", acc_in, acc_out, *args)
    _check_adagrad_args((acc_in, acc_out), *args)
    rc = _build.lib().n2v_adagrad_accumulate(
        _build.ptr(acc_in), _build.ptr(acc_out),
        *_list_ptrs(*args), g_in.shape[1], _build.stream_of(acc_in),
    )
    _build.check(rc, "adagrad_accumulate")
    _build.launches["adagrad_accumulate"] += 1


def adagrad_apply_plain(emb_in, emb_out, acc_in, acc_out, g_in, rows_in, g_out, rows_out,
                        g_extra, rows_extra, lr: float):
    """skipgram.py:469-475 (and hsoftmax.py:399-412, :417-418, :428-429), in
    place on the tables."""
    tables = _row_lists(emb_in, emb_out, g_in, rows_in, g_out, rows_out, g_extra, rows_extra)
    accs = (acc_in, acc_out, acc_out)
    updates = []
    for (table, g, rows), acc in zip(tables, accs):  # every scale before any update
        safe = torch.where(rows >= 0, rows, 0).long()
        scale = torch.rsqrt(acc[safe] + _EPS) * (rows >= 0).to(torch.float32)
        updates.append((table, safe, -lr * g * scale[:, None]))
    for table, safe, upd in updates:
        table.index_add_(0, safe, upd)


def adagrad_apply(emb_in, emb_out, acc_in, acc_out, g_in, rows_in, g_out, rows_out, g_extra,
                  rows_extra, lr: float):
    """K4 for CUDA tensors, the plain version for CPU tensors."""
    args = (g_in, rows_in, g_out, rows_out, g_extra, rows_extra)
    if not emb_in.is_cuda:
        return adagrad_apply_plain(emb_in, emb_out, acc_in, acc_out, *args, lr)
    _build.require_cuda("adagrad_apply", emb_in, emb_out, acc_in, acc_out, *args)
    _check_adagrad_args((emb_in, emb_out, acc_in, acc_out), *args)
    if emb_in.shape[1] != g_in.shape[1] or emb_out.shape[1] != g_in.shape[1]:
        raise ValueError("tables must be [rows, D] with the grads' D")
    if acc_in.shape[0] != emb_in.shape[0] or acc_out.shape[0] != emb_out.shape[0]:
        raise ValueError("each accumulator must have one entry per table row")
    rc = _build.lib().n2v_adagrad_apply(
        _build.ptr(emb_in), _build.ptr(emb_out), _build.ptr(acc_in), _build.ptr(acc_out),
        *_list_ptrs(*args), g_in.shape[1], float(lr), _build.stream_of(emb_in),
    )
    _build.check(rc, "adagrad_apply")
    _build.launches["adagrad_apply"] += 1


def adagrad_accumulate_squares_plain(acc_in, acc_out, sq_in, rows_in, sq_out, rows_out,
                                     sq_extra, rows_extra, dim: int):
    """K3's squares mode in plain PyTorch (sharded_sgns.py:106-116): each
    row's square is given, summed over the model group's column slices;
    acc[rows] += sq / dim (``dim`` the full D), rows < 0 skipped."""
    for acc, sq, rows in _row_lists(acc_in, acc_out, sq_in, rows_in, sq_out, rows_out,
                                    sq_extra, rows_extra):
        safe = torch.where(rows >= 0, rows, 0).long()
        acc.index_add_(0, safe, sq / dim * (rows >= 0).to(torch.float32))


def adagrad_accumulate_squares(acc_in, acc_out, sq_in, rows_in, sq_out, rows_out, sq_extra,
                               rows_extra, dim: int):
    """K3's squares mode for CUDA tensors, the plain version for CPU tensors."""
    args = (sq_in, rows_in, sq_out, rows_out, sq_extra, rows_extra)
    if not acc_in.is_cuda:
        return adagrad_accumulate_squares_plain(acc_in, acc_out, *args, dim)
    _build.require_cuda("adagrad_accumulate_squares", acc_in, acc_out, *args)
    _check_adagrad_args((acc_in, acc_out), *(t[:, None] if k % 2 == 0 else t
                                             for k, t in enumerate(args)))
    rc = _build.lib().n2v_adagrad_accumulate_squares(
        _build.ptr(acc_in), _build.ptr(acc_out), *_list_ptrs(*args), int(dim),
        _build.stream_of(acc_in),
    )
    _build.check(rc, "adagrad_accumulate_squares")
    _build.launches["adagrad_accumulate_squares"] += 1


def _list_ptrs(g_in, rows_in, g_out, rows_out, g_extra, rows_extra):
    out = []
    for g, rows in ((g_in, rows_in), (g_out, rows_out), (g_extra, rows_extra)):
        out += [_build.ptr(g), _build.ptr(rows), rows.shape[0]]
    return out


def _check_adagrad_args(tables, g_in, rows_in, g_out, rows_out, g_extra, rows_extra) -> None:
    if any(r.dtype != torch.int32 for r in (rows_in, rows_out, rows_extra)):
        raise TypeError("Adagrad kernels take int32 row lists")
    if any(t.dtype != torch.float32 for t in (*tables, g_in, g_out, g_extra)):
        raise TypeError("Adagrad kernels take float32 tables, accumulators and grads")
    dim = g_in.shape[1] if g_in.dim() == 2 else -1
    for g, rows in ((g_in, rows_in), (g_out, rows_out), (g_extra, rows_extra)):
        if rows.dim() != 1 or g.shape != (rows.shape[0], dim):
            raise ValueError("each gradient list must be [rows, D] beside its int32 rows [rows]")


# --------------------------------------------------------------------------- #
# K11: one summed gradient per vertex of the batch, and the SGD update
# --------------------------------------------------------------------------- #
#
# Layout of K11's outputs over the batch's flat rows [N = B*L1]: row r of
# ga_in, ga_out and cnt holds the sums and the occurrence count of the
# vertex whose first live occurrence (walks >= 0) is row r, and heads[r] is
# that vertex; every other row is zero with head -1.  This is the JAX
# package's segment layout (a segment per distinct vertex, empty segments
# dropped) with the segments at their first occurrence instead of in sorted
# order, so K3/K4 and sgd_apply take heads as their row list unchanged.


def new_slot_map(n_vertices: int, device) -> torch.Tensor:
    """K11's scratch: int32 [V] of SLOT_EMPTY.  K11 leaves it as it found
    it, so one map serves every step of a fit."""
    return torch.full((n_vertices,), SLOT_EMPTY, dtype=torch.int32, device=device)


def preagg_rows_plain(walks_flat, g_in, g_out):
    """skipgram.py:409-423 and the count at :431-433 with torch.unique and
    index_add_: (ga_in [N, D], ga_out [N, D], heads int32 [N], cnt float32
    [N]) in K11's layout.  A row with walks < 0 adds nothing and is not
    counted; an out-of-vocabulary row is counted (its gradients are 0)."""
    n = walks_flat.shape[0]
    dev = walks_flat.device
    live = torch.nonzero(walks_flat >= 0).squeeze(1)
    verts, seg = torch.unique(walks_flat[live], return_inverse=True)
    first = torch.full((verts.numel(),), n, dtype=torch.long, device=dev)
    first = first.scatter_reduce(0, seg, live, reduce="amin")
    rep = first[seg]  # each live row's representative row
    ga_in = torch.zeros_like(g_in).index_add_(0, rep, g_in[live])
    ga_out = torch.zeros_like(g_out).index_add_(0, rep, g_out[live])
    cnt = torch.zeros(n, dtype=torch.float32, device=dev)
    cnt.index_add_(0, rep, torch.ones(live.numel(), dtype=torch.float32, device=dev))
    heads = torch.full((n,), -1, dtype=torch.int32, device=dev)
    heads[first] = verts.to(torch.int32)
    return ga_in, ga_out, heads, cnt


def preagg_rows(walks_flat, g_in, g_out, slot=None):
    """K11 for CUDA tensors (``slot`` a map from ``new_slot_map``, returned
    as it was given), the plain version for CPU tensors (``slot`` unused)."""
    if not g_in.is_cuda:
        return preagg_rows_plain(walks_flat, g_in, g_out)
    if slot is None or slot.dtype != torch.int32 or slot.dim() != 1:
        raise ValueError("preagg_rows on the card needs an int32 [V] slot map (new_slot_map)")
    _build.require_cuda("preagg_rows", walks_flat, g_in, g_out, slot)
    if walks_flat.dtype != torch.int32 or (g_in.dtype, g_out.dtype) != (torch.float32,) * 2:
        raise TypeError("preagg_rows takes int32 rows and float32 grads")
    n = walks_flat.shape[0]
    if walks_flat.dim() != 1 or g_in.dim() != 2 or g_in.shape[0] != n or g_out.shape != g_in.shape:
        raise ValueError("preagg_rows takes rows [N] and grads [N, D]")
    ga_in = torch.empty_like(g_in)
    ga_out = torch.empty_like(g_out)
    heads = torch.empty((n,), dtype=torch.int32, device=g_in.device)
    cnt = torch.empty((n,), dtype=torch.float32, device=g_in.device)
    rc = _build.lib().n2v_preagg_rows(
        _build.ptr(walks_flat), n, _build.ptr(g_in), _build.ptr(g_out), g_in.shape[1],
        _build.ptr(slot), _build.ptr(ga_in), _build.ptr(ga_out), _build.ptr(heads),
        _build.ptr(cnt), _build.stream_of(g_in),
    )
    _build.check(rc, "preagg_rows")
    _build.launches["preagg_rows"] += 1
    return ga_in, ga_out, heads, cnt


def sgd_apply_plain(emb_in, emb_out, ga_in, ga_out, heads, cnt, d_no, neg_ids, pairs,
                    lr: float, neg_scale: float):
    """skipgram.py:434-442, in place on the tables: each head row steps by
    -lr * ga / max(cnt, 1) on both tables, each shared negative by
    -lr * d_no / max(pairs * neg_scale, 1); rows with head -1 are skipped."""
    ok = heads >= 0
    rows = heads[ok].long()
    inv = 1.0 / torch.clamp(cnt[ok], min=1.0)
    emb_in.index_add_(0, rows, (-lr * ga_in[ok]) * inv[:, None])
    emb_out.index_add_(0, rows, (-lr * ga_out[ok]) * inv[:, None])
    cnt_neg = torch.clamp(pairs * neg_scale, min=1.0)
    emb_out.index_add_(0, neg_ids.long(), (-lr * d_no) / cnt_neg)


def sgd_apply(emb_in, emb_out, ga_in, ga_out, heads, cnt, d_no, neg_ids, pairs, lr: float,
              neg_scale: float):
    """``sgd_apply`` (``csrc/preagg.cu``) for CUDA tensors, the plain
    version for CPU tensors.  ``pairs`` stays on the device: no sync."""
    args = (ga_in, ga_out, heads, cnt, d_no, neg_ids, pairs)
    if not emb_in.is_cuda:
        return sgd_apply_plain(emb_in, emb_out, *args, lr, neg_scale)
    _build.require_cuda("sgd_apply", emb_in, emb_out, *args)
    if any(t.dtype != torch.float32 for t in (emb_in, emb_out, ga_in, ga_out, cnt, d_no, pairs)):
        raise TypeError("sgd_apply takes float32 tables, grads, counts and pairs")
    if heads.dtype != torch.int32 or neg_ids.dtype != torch.int32:
        raise TypeError("sgd_apply takes int32 heads and neg_ids")
    dim = emb_in.shape[1]
    n, s = heads.shape[0], neg_ids.shape[0]
    if (emb_out.shape[1] != dim or ga_in.shape != (n, dim) or ga_out.shape != (n, dim)
            or cnt.shape != (n,) or d_no.shape != (s, dim) or pairs.numel() != 1):
        raise ValueError("sgd_apply takes tables [V, D], grads [N, D], heads and cnt [N], "
                         "d_no [S, D], neg_ids [S] and a one-element pairs")
    rc = _build.lib().n2v_sgd_apply(
        _build.ptr(emb_in), _build.ptr(emb_out), dim, _build.ptr(ga_in), _build.ptr(ga_out),
        _build.ptr(heads), _build.ptr(cnt), n, _build.ptr(d_no), _build.ptr(neg_ids), s,
        _build.ptr(pairs), float(np.float32(neg_scale)), float(np.float32(lr)),
        _build.stream_of(emb_in),
    )
    _build.check(rc, "sgd_apply")
    _build.launches["sgd_apply"] += 1


# --------------------------------------------------------------------------- #
# The step and the epoch
# --------------------------------------------------------------------------- #


def resolve_optimizer(optimizer: str, preagg: bool) -> bool:
    """Whether the step preaggregates (skipgram.py:318-325): "sgd" forces
    it, an unknown optimizer raises."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return preagg or optimizer == "sgd"


def _step(grads, accumulate, apply, emb_in, emb_out, acc_in, acc_out, walks, b_sh, r1, r2,
          lr, ns_alias, ns_prob, vocab_mask, window, negatives, preaggregated=None):
    """The negative-sampling step of SGNS and CBOW-NS (``grads`` K2 or K9).
    ``preaggregated``: None for row-wise Adagrad per occurrence, or SGNS's
    (aggregate, sgd, optimizer, slot) for the pre-aggregated branch."""
    neg_ids = negative_ids(r1, r2, ns_alias, ns_prob)
    g_in, g_out, d_no, loss, *pairs = grads(
        emb_in, emb_out, walks, vocab_mask, b_sh, neg_ids,
        window=window, negatives=negatives,
    )
    walks_flat = walks.reshape(-1)
    if preaggregated is None:
        lists = (g_in, walks_flat, g_out, walks_flat, d_no, neg_ids)
    else:
        aggregate, sgd, optimizer, slot = preaggregated
        ga_in, ga_out, heads, cnt = aggregate(walks_flat, g_in, g_out, slot)
        if optimizer == "sgd":
            sgd(emb_in, emb_out, ga_in, ga_out, heads, cnt, d_no, neg_ids, pairs[0], lr,
                negatives / neg_ids.shape[0])
            return loss
        # K3/K4's two launches keep the JAX order: every increment (the
        # negatives' to acc_out too) lands before any scale is read
        lists = (ga_in, heads, ga_out, heads, d_no, neg_ids)
    accumulate(acc_in, acc_out, *lists)
    apply(emb_in, emb_out, acc_in, acc_out, *lists, lr)
    return loss


def sgns_walk_step(
    emb_in, emb_out, acc_in, acc_out, walks, b_sh, r1, r2, lr: float,
    ns_alias, ns_prob, vocab_mask, *, window: int, negatives: int,
    optimizer: str = "adagrad", preagg: bool = False, slot=None,
) -> torch.Tensor:
    """One SGNS step (``sgns_walk_step_impl``), in place on the four state
    tensors; returns the loss.  Goes through K2 and K3/K4 (Adagrad, per
    occurrence), K2, K11 and K3/K4 (Adagrad, ``preagg``) or K2, K11 and
    sgd_apply (``optimizer="sgd"``) on CUDA tensors, and their plain
    versions on CPU tensors.  ``slot``: K11's slot map (``new_slot_map``),
    which a preaggregated step on the card needs."""
    pre = None
    if resolve_optimizer(optimizer, preagg):
        pre = (preagg_rows, sgd_apply, optimizer, slot)
    return _step(sgns_grads, adagrad_accumulate, adagrad_apply, emb_in, emb_out, acc_in,
                 acc_out, walks, b_sh, r1, r2, lr, ns_alias, ns_prob, vocab_mask, window,
                 negatives, pre)


def sgns_walk_step_plain(
    emb_in, emb_out, acc_in, acc_out, walks, b_sh, r1, r2, lr: float,
    ns_alias, ns_prob, vocab_mask, *, window: int, negatives: int,
    optimizer: str = "adagrad", preagg: bool = False,
) -> torch.Tensor:
    """``sgns_walk_step`` through the plain versions, on any device."""
    pre = None
    if resolve_optimizer(optimizer, preagg):
        pre = (lambda w, g_in, g_out, _slot: preagg_rows_plain(w, g_in, g_out),
               sgd_apply_plain, optimizer, None)
    return _step(sgns_grads_plain, adagrad_accumulate_plain, adagrad_apply_plain, emb_in,
                 emb_out, acc_in, acc_out, walks, b_sh, r1, r2, lr, ns_alias, ns_prob,
                 vocab_mask, window, negatives, pre)


def step_lr(lr0: float, lr_slope: float, gstep: int, min_lr: float) -> float:
    """max(lr0 - slope * gstep, min_lr) in float32, as the JAX epoch computes it."""
    lr = np.float32(lr0) - np.float32(lr_slope) * np.float32(gstep)
    return float(np.maximum(lr, np.float32(min_lr)))


def sgns_epoch(
    emb_in, emb_out, acc_in, acc_out, corpus: torch.Tensor,
    draws: Callable[[int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    step0: int, lr0: float, lr_slope: float, ns_alias, ns_prob, vocab_mask, *,
    batch: int, n_batches: int, window: int, negatives: int, min_lr: float,
    optimizer: str = "adagrad", preagg: bool = False, slot=None,
) -> torch.Tensor:
    """A whole epoch of steps over a shuffled, batch-padded corpus
    (``_sgns_epoch_impl`` as a Python loop).  ``draws(gstep)`` returns the
    step's (b_sh, r1, r2).  ``slot``: K11's slot map for the preaggregated
    steps on the card, made here once for the epoch if not given.  Returns
    the per-batch losses [n_batches]."""
    if slot is None and emb_in.is_cuda and resolve_optimizer(optimizer, preagg):
        slot = new_slot_map(acc_in.shape[0], emb_in.device)
    losses = []
    for b in range(n_batches):
        gstep = step0 + b
        lr = step_lr(lr0, lr_slope, gstep, min_lr)
        wb = corpus[b * batch: (b + 1) * batch]
        b_sh, r1, r2 = draws(gstep)
        losses.append(sgns_walk_step(
            emb_in, emb_out, acc_in, acc_out, wb, b_sh, r1, r2, lr,
            ns_alias, ns_prob, vocab_mask, window=window, negatives=negatives,
            optimizer=optimizer, preagg=preagg, slot=slot,
        ))
    return torch.stack(losses)


def pairs_per_batch(n_walks: int, walk_length: int, window: int) -> int:
    return n_walks * (walk_length + 1) * 2 * window


def sgns_corpus_step(
    emb_in, emb_out, acc_in, acc_out, corpus: torch.Tensor, offset: int, b_sh, r1, r2,
    lr: float, ns_alias, ns_prob, vocab_mask, *, batch: int, window: int, negatives: int,
    optimizer: str = "adagrad", slot=None,
) -> torch.Tensor:
    """``sgns_walk_step`` on rows [offset, offset + batch) of a corpus on
    the device (``_sgns_corpus_step_impl``, skipgram.py:670-696); the start
    is clamped so the slice stays inside the corpus, as
    ``dynamic_slice_in_dim`` clamps it."""
    start = min(max(int(offset), 0), max(corpus.shape[0] - batch, 0))
    return sgns_walk_step(
        emb_in, emb_out, acc_in, acc_out, corpus[start: start + batch], b_sh, r1, r2, lr,
        ns_alias, ns_prob, vocab_mask, window=window, negatives=negatives,
        optimizer=optimizer, slot=slot,
    )


# --------------------------------------------------------------------------- #
# K13: the pair-based step (sgns_train_step)
# --------------------------------------------------------------------------- #
#
# The step of ``node2vec_tpu.models.sgns_train_step``: the batch becomes a
# flat list of P = B * 2w * L1 (center, context) lanes in the JAX order
# (walk, offset, position), each lane gathers its own rows, and row-wise
# Adagrad is applied per occurrence over three lists: d_ci at the center
# rows, d_co at the context rows and d_no at the shared negatives (K3/K4,
# invalid lanes at row -1).  No trainer of either package calls it; the
# JAX column-TP trainer builds on it.


def _offsets(window: int):
    return [d for d in range(-window, window + 1) if d != 0]


def pair_lists_plain(walks, b_sh, vocab_mask, window: int):
    """make_pairs' rule (skipgram.py:130-165) as two int32 lists [P]:
    (centers, contexts), -1 where the lane is invalid.  ``b_sh``: the
    shrunk window of each (walk, position), B * L1 int32 entries ([B, 1,
    L1] in the JAX draw), or None for the full window."""
    n_walks, length = walks.shape
    pad = torch.full((n_walks, window), -1, dtype=walks.dtype, device=walks.device)
    padded = torch.cat([pad, walks, pad], dim=1)
    offsets = _offsets(window)
    ctx = torch.stack([padded[:, d + window: d + window + length] for d in offsets], dim=1)
    center = walks[:, None, :].expand_as(ctx)
    valid = (center >= 0) & (ctx >= 0)
    if b_sh is not None:
        dist = torch.tensor([abs(d) for d in offsets], dtype=torch.int32,
                            device=walks.device)[None, :, None]
        valid &= dist <= b_sh.reshape(n_walks, 1, length)
    valid &= (vocab_mask[torch.where(valid, center, 0).long()]
              & vocab_mask[torch.where(valid, ctx, 0).long()])
    return (torch.where(valid, center, -1).reshape(-1).to(torch.int32),
            torch.where(valid, ctx, -1).reshape(-1).to(torch.int32))


def pair_lists(walks, b_sh, vocab_mask, window: int):
    """K13's first launch for CUDA tensors, the plain version for CPU
    tensors."""
    if not walks.is_cuda:
        return pair_lists_plain(walks, b_sh, vocab_mask, window)
    n_walks, length = walks.shape
    if b_sh is None:
        b_sh = torch.full_like(walks, window)
    b_sh = b_sh.reshape(n_walks, length)
    _build.require_cuda("pair_lists", walks, b_sh, vocab_mask)
    if (walks.dtype, b_sh.dtype, vocab_mask.dtype) != (torch.int32, torch.int32, torch.bool):
        raise TypeError("pair_lists takes int32 walks and b_sh and a bool mask")
    n = n_walks * 2 * window * length
    centers = torch.empty((n,), dtype=torch.int32, device=walks.device)
    contexts = torch.empty_like(centers)
    rc = _build.lib().n2v_pair_lists(
        _build.ptr(walks), _build.ptr(b_sh), _build.ptr(vocab_mask), n_walks, length, window,
        _build.ptr(centers), _build.ptr(contexts), _build.stream_of(walks),
    )
    _build.check(rc, "pair_lists")
    _build.launches["pair_lists"] += 1
    return centers, contexts


def make_pairs(walks, b_sh, vocab_mask, window: int):
    """(center, context, valid) flattened to [B * 2w * L1] in the JAX order
    (skipgram.py:130-165): invalid lanes (-1 tails, out of the vocabulary,
    beyond the shrunk window) carry valid=False and id 0.  ``b_sh`` is the
    shrink draw the JAX version makes inside ([B, 1, L1] in 1..w), or None
    for the full window.  On the card this is K13's first launch."""
    centers, contexts = pair_lists(walks, b_sh, vocab_mask, window)
    valid = centers >= 0
    return torch.where(valid, centers, 0), torch.where(valid, contexts, 0), valid


def sgns_pair_grads_plain(emb_in, emb_out, walks, centers, contexts, neg_ids, *,
                          window: int, negatives: int):
    """skipgram.py:205-235 op for op on the pair lists: (d_ci [P, D], d_co
    [P, D], d_no [S, D], loss, pairs), ``pairs`` the valid-lane count (a
    float32 scalar, as K2's); invalid lanes get zero gradients.  ``walks``
    and ``window`` are the kernel's inputs and unused here."""
    valid = centers >= 0
    w_valid = valid.to(torch.float32)
    pairs = w_valid.sum()
    n_valid = torch.clamp(pairs, min=1.0)
    ci = emb_in[torch.where(valid, centers, 0).long()]
    co = emb_out[torch.where(valid, contexts, 0).long()]
    no = emb_out[neg_ids.long()]
    pos_logit = torch.sum(ci * co, dim=-1)
    neg_logit = ci @ no.T
    neg_scale = negatives / neg_ids.shape[0]
    loss = -(torch.sum(F.logsigmoid(pos_logit) * w_valid)
             + neg_scale * torch.sum(F.logsigmoid(-neg_logit) * w_valid[:, None])) / n_valid
    g_pos = (torch.sigmoid(pos_logit) - 1.0) * w_valid
    g_neg = torch.sigmoid(neg_logit) * w_valid[:, None] * neg_scale
    d_ci = g_pos[:, None] * co + g_neg @ no
    d_co = g_pos[:, None] * ci
    d_no = g_neg.T @ ci
    return d_ci, d_co, d_no, loss, pairs


def sgns_pair_grads(emb_in, emb_out, walks, centers, contexts, neg_ids, *, window: int,
                    negatives: int):
    """K13's second launch for CUDA tensors (on the walks and the centers of
    the first), the plain version for CPU tensors."""
    if not emb_in.is_cuda:
        return sgns_pair_grads_plain(emb_in, emb_out, walks, centers, contexts, neg_ids,
                                     window=window, negatives=negatives)
    _build.require_cuda("sgns_pair_grads", emb_in, emb_out, walks, centers, contexts, neg_ids)
    if (emb_in.dtype, emb_out.dtype) != (torch.float32, torch.float32):
        raise TypeError("sgns_pair_grads takes float32 tables")
    if any(t.dtype != torch.int32 for t in (walks, centers, contexts, neg_ids)):
        raise TypeError("sgns_pair_grads takes int32 walks, pair lists and neg_ids")
    if emb_out.shape != emb_in.shape or emb_in.dim() != 2 or walks.dim() != 2:
        raise ValueError("emb_in and emb_out must both be [V, D], walks [B, L1]")
    n_walks, length = walks.shape
    n = n_walks * 2 * window * length
    if centers.shape != (n,) or contexts.shape != (n,):
        raise ValueError(f"the pair lists must be [B * 2w * L1] = [{n}]")
    dim = emb_in.shape[1]
    s = neg_ids.shape[0]
    lib = _build.lib()
    ws, ws_blocks = _build.staging(lib.n2v_sgns_pair_grads_smem(length, dim, s, window),
                                   n_walks, emb_in.device)
    dev = emb_in.device
    d_ci = torch.empty((n, dim), dtype=torch.float32, device=dev)
    d_co = torch.empty_like(d_ci)
    d_no = torch.zeros((s, dim), dtype=torch.float32, device=dev)
    parts = torch.zeros((n_walks, 3), dtype=torch.float32, device=dev)
    neg_scale = negatives / s
    rc = lib.n2v_sgns_pair_grads(
        _build.ptr(emb_in), _build.ptr(emb_out), dim, _build.ptr(walks), _build.ptr(centers),
        _build.ptr(neg_ids), n_walks, length, window, s, float(np.float32(neg_scale)),
        _build.ptr(d_ci), _build.ptr(d_co), _build.ptr(d_no), _build.ptr(parts),
        _build.ptr_or_null(ws), ws_blocks, _build.stream_of(emb_in),
    )
    _build.check(rc, "sgns_pair_grads")
    _build.launches["sgns_pair_grads"] += 1
    if ws is not None:
        _build.launches["sgns_pair_grads_global"] += 1
    tot = parts.sum(dim=0)
    loss = -(tot[0] + neg_scale * tot[1]) / torch.clamp(tot[2], min=1.0)
    return d_ci, d_co, d_no, loss, tot[2]


def _add_pairs(pairs, n) -> None:
    if pairs is not None:
        pairs.add_(n.to(pairs.dtype))


def _pair_step(lists, grads, accumulate, apply, emb_in, emb_out, acc_in, acc_out, walks,
               b_sh, r1, r2, lr, ns_alias, ns_prob, vocab_mask, window, negatives, pairs):
    neg_ids = negative_ids(r1, r2, ns_alias, ns_prob)
    centers, contexts = lists(walks, b_sh, vocab_mask, window)
    d_ci, d_co, d_no, loss, n = grads(emb_in, emb_out, walks, centers, contexts, neg_ids,
                                      window=window, negatives=negatives)
    _add_pairs(pairs, n)
    # K3/K4's two launches keep the JAX order (:237-246): every square
    # lands before any scale is read; invalid lanes (row -1) have zero
    # gradients, so JAX's writes of zeros to row 0 change nothing
    rows = (d_ci, centers, d_co, contexts, d_no, neg_ids)
    accumulate(acc_in, acc_out, *rows)
    apply(emb_in, emb_out, acc_in, acc_out, *rows, lr)
    return loss


def sgns_train_step(
    emb_in, emb_out, acc_in, acc_out, walks, b_sh, r1, r2, lr: float,
    ns_alias, ns_prob, vocab_mask, *, window: int, negatives: int, pairs=None,
) -> torch.Tensor:
    """The pair-based SGNS step (``sgns_train_step_impl``, skipgram.py:168),
    in place on the four state tensors; returns the loss.  ``b_sh`` is the
    shrink draw ([B, 1, L1] or [B, L1], 1..w; None for the full window),
    ``r1``/``r2`` [S] the negatives' uniforms.  ``pairs``, a scalar tensor
    or None, gains the step's valid-lane count on its device, without a
    sync.  K13 and K3/K4 on CUDA tensors, their plain versions on CPU
    tensors."""
    return _pair_step(pair_lists, sgns_pair_grads, adagrad_accumulate, adagrad_apply,
                      emb_in, emb_out, acc_in, acc_out, walks, b_sh, r1, r2, lr, ns_alias,
                      ns_prob, vocab_mask, window, negatives, pairs)


def sgns_train_step_plain(
    emb_in, emb_out, acc_in, acc_out, walks, b_sh, r1, r2, lr: float,
    ns_alias, ns_prob, vocab_mask, *, window: int, negatives: int, pairs=None,
) -> torch.Tensor:
    """``sgns_train_step`` through the plain versions, on any device."""
    return _pair_step(pair_lists_plain, sgns_pair_grads_plain, adagrad_accumulate_plain,
                      adagrad_apply_plain, emb_in, emb_out, acc_in, acc_out, walks, b_sh, r1,
                      r2, lr, ns_alias, ns_prob, vocab_mask, window, negatives, pairs)


# --------------------------------------------------------------------------- #
# K14: the fused-table step (sgns_walk_step_fused)
# --------------------------------------------------------------------------- #
#
# [V, D+1] tables with each row's Adagrad accumulator in column D
# (skipgram.py:489-667).  The gradients are the positional step's, so they
# run on K2 with the tables' width as its row stride; the update is one
# pass: each occurrence is scaled by rsqrt(acc0 + its own square), acc0 the
# accumulator from before the batch, and adds (delta vector, square) to its
# row.  Not on either package's production path: the JAX package measured
# it slower on the TPU and keeps it as a negative result.


def init_fused_embeddings(n_vertices: int, dim: int, seed: int = 1, device="cuda"):
    """[V, D+1] tables: ``init_embeddings``' values with the accumulator
    (zeros) in column D."""
    emb_in, emb_out, acc_in, acc_out = init_embeddings(n_vertices, dim, seed, device)
    return (torch.cat([emb_in, acc_in[:, None]], dim=1),
            torch.cat([emb_out, acc_out[:, None]], dim=1))


def split_fused(table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[V, D+1] fused table -> ([V, D] embeddings, [V] accumulator), views."""
    return table[:, :-1], table[:, -1]


def fused_adagrad_plain(tab_in, tab_out, g_in, rows_in, g_out, rows_out, d_no, neg_ids,
                        lr: float):
    """skipgram.py:597-620 in place on the fused tables: every scale reads
    the accumulators as they stood before the batch; rows < 0 add nothing."""
    dim = tab_in.shape[1] - 1
    updates = []
    for tab, g, rows in ((tab_in, g_in, rows_in), (tab_out, g_out, rows_out),
                         (tab_out, d_no, neg_ids)):
        ok = (rows >= 0).to(torch.float32)
        safe = torch.where(rows >= 0, rows, 0).long()
        sq = torch.mean(g * g, dim=-1) * ok
        scale = torch.rsqrt(tab[safe, dim] + sq + _EPS) * ok
        updates.append((tab, safe, torch.cat([-lr * g * scale[:, None], sq[:, None]], dim=1)))
    for tab, safe, upd in updates:
        tab.index_add_(0, safe, upd)


def fused_adagrad(tab_in, tab_out, g_in, rows_in, g_out, rows_out, d_no, neg_ids, lr: float):
    """K14 for CUDA tensors, the plain version for CPU tensors."""
    args = (g_in, rows_in, g_out, rows_out, d_no, neg_ids)
    if not tab_in.is_cuda:
        return fused_adagrad_plain(tab_in, tab_out, *args, lr)
    _build.require_cuda("fused_adagrad", tab_in, tab_out, *args)
    _check_adagrad_args((tab_in, tab_out), *args)
    dim = g_in.shape[1]
    if tab_in.dim() != 2 or tab_in.shape[1] != dim + 1 or tab_out.shape[1] != dim + 1:
        raise ValueError("fused tables must be [rows, D+1] with the grads' D")
    n = sum(r.shape[0] for r in (rows_in, rows_out, neg_ids))
    scale = torch.empty((n,), dtype=torch.float32, device=tab_in.device)
    sq = torch.empty_like(scale)
    rc = _build.lib().n2v_fused_adagrad(
        _build.ptr(tab_in), _build.ptr(tab_out), *_list_ptrs(*args), dim,
        float(np.float32(lr)), _build.ptr(scale), _build.ptr(sq), _build.stream_of(tab_in),
    )
    _build.check(rc, "fused_adagrad")
    _build.launches["fused_adagrad"] += 1


def _fused_step(grads, apply, tab_in, tab_out, walks, b_sh, r1, r2, lr, ns_alias, ns_prob,
                vocab_mask, window, negatives, pairs):
    neg_ids = negative_ids(r1, r2, ns_alias, ns_prob)
    g_in, g_out, d_no, loss, n = grads(tab_in, tab_out, walks, vocab_mask, b_sh, neg_ids,
                                       window=window, negatives=negatives,
                                       dim=tab_in.shape[1] - 1)
    _add_pairs(pairs, n)
    walks_flat = walks.reshape(-1)
    apply(tab_in, tab_out, g_in, walks_flat, g_out, walks_flat, d_no, neg_ids, lr)
    return loss


def sgns_walk_step_fused(
    tab_in, tab_out, walks, b_sh, r1, r2, lr: float, ns_alias, ns_prob, vocab_mask, *,
    window: int, negatives: int, pairs=None,
) -> torch.Tensor:
    """The fused-table SGNS step (``sgns_walk_step_fused_impl``,
    skipgram.py:506), in place on the [V, D+1] tables; returns the loss.
    K2 (row stride D + 1) and K14 on CUDA tensors, their plain versions on
    CPU tensors; the draws as in ``sgns_walk_step``, ``pairs`` as in
    ``sgns_train_step``."""
    return _fused_step(sgns_grads, fused_adagrad, tab_in, tab_out, walks, b_sh, r1, r2, lr,
                       ns_alias, ns_prob, vocab_mask, window, negatives, pairs)


def sgns_walk_step_fused_plain(
    tab_in, tab_out, walks, b_sh, r1, r2, lr: float, ns_alias, ns_prob, vocab_mask, *,
    window: int, negatives: int, pairs=None,
) -> torch.Tensor:
    """``sgns_walk_step_fused`` through the plain versions, on any device."""
    return _fused_step(sgns_grads_plain, fused_adagrad_plain, tab_in, tab_out, walks, b_sh,
                       r1, r2, lr, ns_alias, ns_prob, vocab_mask, window, negatives, pairs)


def sgns_epoch_fused(
    tab_in, tab_out, corpus: torch.Tensor,
    draws: Callable[[int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    step0: int, lr0: float, lr_slope: float, ns_alias, ns_prob, vocab_mask, *,
    batch: int, n_batches: int, window: int, negatives: int, min_lr: float, pairs=None,
) -> torch.Tensor:
    """A fused-table epoch (``_sgns_epoch_fused_impl``, skipgram.py:631, as
    a Python loop): ``draws(gstep)`` returns the step's (b_sh, r1, r2);
    ``pairs`` as in ``sgns_train_step``.  Returns the per-batch losses
    [n_batches]."""
    losses = []
    for b in range(n_batches):
        gstep = step0 + b
        b_sh, r1, r2 = draws(gstep)
        losses.append(sgns_walk_step_fused(
            tab_in, tab_out, corpus[b * batch: (b + 1) * batch], b_sh, r1, r2,
            step_lr(lr0, lr_slope, gstep, min_lr), ns_alias, ns_prob, vocab_mask,
            window=window, negatives=negatives, pairs=pairs,
        ))
    return torch.stack(losses)
