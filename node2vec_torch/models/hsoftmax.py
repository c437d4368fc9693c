"""Hierarchical-softmax skip-gram (port of ``node2vec_tpu/models/hsoftmax.py``),
the reference's default objective: ``Word2VecParams(negative=0)``.

A Huffman tree over vertex counts gives every vertex a path of inner nodes
(``points``, root first) and branch bits (``codes``); for a valid (center,
context) pair the loss is -sum_c log sigma(sgn_c * x_in[center] .
theta[point_c]) over the context's path, sgn = 1 - 2 * code.

Host part (plain numpy, equal to the JAX package's bit for bit):
``build_huffman`` (the native two-queue merge for n >= 65,536 when the
native core loads, heapq below that: the two break count ties differently),
``cap_code_length`` and ``head_level_offsets``.  Inner nodes are numbered
breadth first, so tree level c holds the ids [level_offsets[c],
level_offsets[c + 1]) and path position c is level c.

The step keeps the JAX package's update rule, including its dense head: the
first H levels (K = head_offsets[H] inner nodes, at most 512) get ONE
pre-aggregated row-wise Adagrad update per batch from ``d_head`` [K, D],
the deeper ("tail") path entries and emb_in one update per occurrence.  The
JAX package scores the head with a [B*L1, D] @ [D, K] matmul and one-hot
selects; a dot product with theta[point] is the same number, and the port
scores head and tail alike.  Every table stays fp32 (the JAX package's bf16
path tensors are a TPU storage choice, not semantics).

Kernels, each beside its plain PyTorch version:

* K8 ``hs_grads`` (``csrc/hs.cu``): g_in, the per-occurrence tail gradients
  with their table rows, d_head and the loss;
* K3 ``adagrad_accumulate`` and K4 ``adagrad_apply`` (``models/skipgram.py``,
  ``csrc/adagrad.cu``) over three row lists: emb_in rows = walk positions,
  theta tail rows (-1 where masked), theta head rows 0..K-1 with d_head.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise.  The step takes its window shrink ``b_sh`` [B, L1] as a tensor
(the JAX step draws it from ``fold_in(key, gstep)``) and updates the tables
in place.
"""

from __future__ import annotations

import heapq
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from node2vec_torch import _build, native
from node2vec_torch.models.skipgram import (
    adagrad_accumulate,
    adagrad_accumulate_plain,
    adagrad_apply,
    adagrad_apply_plain,
    step_lr,
    window_shift,
)

# --------------------------------------------------------------------------- #
# The Huffman tree (host)
# --------------------------------------------------------------------------- #


class HuffmanTree(NamedTuple):
    points: np.ndarray  # [V, CL] int32 BFS inner-node ids along the path, root first
    codes: np.ndarray  # [V, CL] int8 branch bits
    lengths: np.ndarray  # [V] int32 code lengths
    n_inner: int
    level_offsets: np.ndarray  # [depth + 1] int64: level c is ids [off[c], off[c+1])


def build_huffman(counts: np.ndarray) -> HuffmanTree:
    """word2vec's Huffman coding over vertex counts (zero counts become 1,
    so every vertex has a path; the vocab mask drops them from training).

    The merge is the native two-queue one when the native core is available
    and n >= 65,536, heapq below that; the paths come from the native core
    whenever it is available.  The two merges break count ties differently
    (both optimal, equal length multisets), so this choice is the JAX
    package's, or the trees differ."""
    counts = np.maximum(np.asarray(counts, dtype=np.int64), 1)
    n = len(counts)
    if n == 1:
        return HuffmanTree(np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int8),
                           np.ones(1, np.int32), 1, np.array([0, 1], np.int64))
    if native.available() and n >= 65536:
        order0 = np.argsort(counts, kind="stable")
        p_s, b_s, d_s = native.huffman_merge(counts[order0])
        parent = np.empty(2 * n - 1, dtype=np.int64)
        branch = np.empty(2 * n - 1, dtype=np.int8)
        depth = np.empty(2 * n - 1, dtype=np.int32)
        parent[order0], branch[order0], depth[order0] = p_s[:n], b_s[:n], d_s[:n]
        parent[n:], branch[n:], depth[n:] = p_s[n:], b_s[n:], d_s[n:]
    else:
        # heap of (count, tiebreak, node id); leaves 0..n-1, inner n..2n-2
        heap = [(int(c), i, i) for i, c in enumerate(counts)]
        heapq.heapify(heap)
        parent = np.zeros(2 * n - 1, dtype=np.int64)
        branch = np.zeros(2 * n - 1, dtype=np.int8)
        nxt = n
        while len(heap) > 1:
            c1, _, a = heapq.heappop(heap)
            c2, _, b = heapq.heappop(heap)
            parent[a] = nxt
            parent[b] = nxt
            branch[b] = 1
            heapq.heappush(heap, (c1 + c2, nxt, nxt))
            nxt += 1
        # parents are created after their children: one descending pass
        depth = np.zeros(2 * n - 1, dtype=np.int32)
        for x in range(2 * n - 3, n - 1, -1):
            depth[x] = depth[parent[x]] + 1
        depth[:n] = depth[parent[:n]] + 1
    n_inner = n - 1

    # breadth-first renumbering: a stable sort by depth makes each level a
    # contiguous id range
    inner_depth = depth[n:]
    order = np.argsort(inner_depth, kind="stable")
    new_id = np.empty(n_inner, dtype=np.int64)
    new_id[order] = np.arange(n_inner)
    level_offsets = np.concatenate([[0], np.cumsum(np.bincount(inner_depth))]).astype(np.int64)

    lengths = depth[:n].astype(np.int32)
    max_len = int(lengths.max())
    if native.available():
        points, codes = native.huffman_paths(parent, branch, new_id, lengths, max_len)
        return HuffmanTree(points, codes, lengths, n_inner, level_offsets)
    points = np.zeros((n, max_len), dtype=np.int32)
    codes = np.zeros((n, max_len), dtype=np.int8)
    node = np.arange(n, dtype=np.int64)
    active = np.arange(n, dtype=np.int64)
    for i in range(max_len):
        cols = lengths[active] - 1 - i
        keep = cols >= 0
        active = active[keep]
        cols = cols[keep]
        cur = node[active]
        points[active, cols] = new_id[parent[cur] - n]
        codes[active, cols] = branch[cur]
        node[active] = parent[cur]
    return HuffmanTree(points, codes, lengths, n_inner, level_offsets)


def cap_code_length(tree: HuffmanTree, counts: np.ndarray, tail_mass: float = 1e-3,
                    max_len: Optional[int] = None) -> HuffmanTree:
    """Cap the padded code length at the smallest L whose truncated path
    entries carry <= ``tail_mass`` of the count-weighted total; ``max_len``
    (``Word2VecParams.hs_max_code_length``) is a hard cap on top.  Rare
    vertices then train on a prefix of their code."""
    w = np.maximum(np.asarray(counts, dtype=np.float64), 0.0)
    lens = tree.lengths.astype(np.int64)
    total = float((w * lens).sum())
    tree_len = int(tree.points.shape[1])
    if total <= 0:
        if max_len is None or tree_len <= max_len:
            return tree
        cap = max_len
    else:
        for cap in range(1, tree_len + 1):
            truncated = float((w * np.maximum(lens - cap, 0)).sum())
            if truncated / total <= tail_mass:
                break
        if max_len is not None:
            cap = min(cap, max_len)
    if cap >= tree_len:
        return tree
    return HuffmanTree(
        points=np.ascontiguousarray(tree.points[:, :cap]),
        codes=np.ascontiguousarray(tree.codes[:, :cap]),
        lengths=np.minimum(tree.lengths, cap).astype(np.int32),
        n_inner=tree.n_inner,
        level_offsets=tree.level_offsets,
    )


# Above this many theta rows the JAX package turns the dense head off (it
# guards a TPU runtime fault, node2vec_tpu/models/hsoftmax.py:433-445).  The
# threshold is inherited as it is: the head changes the update rule, so the
# head split must equal the JAX package's at every size for both packages to
# train the same model.
DENSE_HEAD_MAX_ROWS = 4_194_304


def head_level_offsets(tree: HuffmanTree, max_rows: int = 512,
                       table_rows: Optional[int] = None) -> Tuple[int, ...]:
    """The head split: the longest level prefix whose inner nodes number at
    most ``max_rows`` (and no deeper than the padded code length), as
    level_offsets[:H + 1]; (0,) when no head applies, and always when
    ``table_rows`` (theta's row count) exceeds ``DENSE_HEAD_MAX_ROWS``."""
    if table_rows is not None and table_rows > DENSE_HEAD_MAX_ROWS:
        return (0,)
    off = tree.level_offsets
    cl = tree.points.shape[1]
    h = 0
    while h < len(off) - 1 and h < cl and off[h + 1] <= max_rows:
        h += 1
    return tuple(int(x) for x in off[: h + 1])


def head_split(head_offsets, code_len: int) -> Tuple[int, int]:
    """(H, K): head levels taken densely and the head's row count."""
    n_head = min(len(head_offsets) - 1, code_len)
    return n_head, int(head_offsets[n_head])


# --------------------------------------------------------------------------- #
# K8: grads of one step
# --------------------------------------------------------------------------- #


def hs_grads_plain(emb_in, theta, walks, vocab_mask, b_sh, points, codes, lengths, *,
                   window: int, head_offsets):
    """hsoftmax.py:255-395 in fp32: (g_in [B*L1, D], g_tail [B*L1*CLT, D],
    tail_rows [B*L1*CLT] int32, d_head [K, D], loss).

    g_tail holds each occurrence's gradient of its level-(H + t) path entry
    at row (position * CLT + t), as the context of every center that pairs
    with it; tail_rows is that entry's theta row, or -1 where the position is
    dead or the entry lies beyond its code.  d_head sums the head entries'
    gradients at their rows."""
    cl = points.shape[1]
    n_head, k_rows = head_split(head_offsets, cl)
    walks_safe = torch.where(walks >= 0, walks, 0).long()
    valid_pos = (walks >= 0) & vocab_mask[walks_safe]
    pts = points[walks_safe].long()  # [B, L1, CL]: the path of each position's vertex
    sgn = 1.0 - 2.0 * codes[walks_safe].to(torch.float32)
    plen = lengths[walks_safe]
    pmask = (torch.arange(cl, device=walks.device)[None, None, :] < plen[..., None]).to(
        torch.float32)
    g_in, g_ctx, loss, n_pairs = hs_terms(emb_in[walks_safe], theta[pts], valid_pos, sgn,
                                          pmask, b_sh, window)
    loss = loss / torch.clamp(n_pairs, min=1.0)
    return hs_outputs(g_in, g_ctx, pts, walks, pmask, n_head, k_rows) + (loss,)


def hs_terms(x_in, th, valid_pos, sgn, pmask, b_sh, window: int):
    """The body of K8's plain versions (hsoftmax.py:255-380) on gathered
    rows: x_in [B, L1, D], th [B, L1, CL, D] each position's path rows, its
    branch signs sgn and path mask pmask [B, L1, CL].  Returns (g_in [B, L1,
    D], g_ctx [B, L1, CL, D] each path entry's gradient at its context
    position, the loss summed over the valid pairs' path entries, the
    valid-pair count)."""
    g_in = torch.zeros_like(x_in)
    g_ctx = torch.zeros_like(th)  # each path entry's gradient, at its context position
    loss = torch.zeros((), dtype=torch.float32, device=x_in.device)
    n_pairs = torch.zeros((), dtype=torch.float32, device=x_in.device)
    for d in [d for d in range(-window, window + 1) if d != 0]:
        th_c = window_shift(th, d)  # the context's path rows at the center
        pv = (valid_pos & window_shift(valid_pos, d) & (abs(d) <= b_sh)).to(torch.float32)
        n_pairs = n_pairs + pv.sum()
        sgn_c = window_shift(sgn, d)
        m = pv[..., None] * window_shift(pmask, d)  # [B, L1, CL]
        logit = (x_in[:, :, None, :] * th_c).sum(-1)
        loss = loss - (F.logsigmoid(sgn_c * logit) * m).sum()
        # d/dlogit of -log sigma(s x) = sigma(x) - t, target t = (1 + s) / 2
        g = (torch.sigmoid(logit) - (1.0 + sgn_c) / 2.0) * m
        g_in = g_in + (g[..., None] * th_c).sum(2)
        g_ctx = g_ctx + window_shift(g[..., None] * x_in[:, :, None, :], -d)
    return g_in, g_ctx, loss, n_pairs


def hs_outputs(g_in, g_ctx, pts, walks, pmask, n_head: int, k_rows: int):
    """K8's outputs from ``hs_terms``'s: (g_in [B*L1, D], g_tail [B*L1*CLT,
    D], tail_rows [B*L1*CLT] int32, d_head [K, D]); the tail rows are -1
    where the position is dead or its entry masked."""
    dim = g_in.shape[-1]
    d_head = torch.zeros((k_rows, dim), dtype=torch.float32, device=g_in.device)
    if n_head:
        d_head.index_add_(0, pts[:, :, :n_head].reshape(-1),
                          g_ctx[:, :, :n_head].reshape(-1, dim))
    live = (walks >= 0)[..., None] & (pmask[:, :, n_head:] > 0)
    tail_rows = torch.where(live, pts[:, :, n_head:], -1).reshape(-1).to(torch.int32)
    return g_in.reshape(-1, dim), g_ctx[:, :, n_head:].reshape(-1, dim), tail_rows, d_head


def check_hs_kernel_shape(dim: int, code_len: int) -> None:
    """K8 (both modes) takes any dim >= 1 (past 512 columns in chunks) and a
    code length >= 1 (every Huffman tree has one)."""
    if dim < 1:
        raise ValueError(f"hs_grads takes dim >= 1, got {dim}")
    if code_len < 1:
        raise ValueError("hs_grads takes a code length >= 1")


def hs_grads(emb_in, theta, walks, vocab_mask, b_sh, points, codes, lengths, *,
             window: int, head_offsets):
    """K8 for CUDA tensors, the plain version for CPU tensors."""
    if not emb_in.is_cuda:
        return hs_grads_plain(emb_in, theta, walks, vocab_mask, b_sh, points, codes, lengths,
                              window=window, head_offsets=head_offsets)
    _build.require_cuda("hs_grads", emb_in, theta, walks, vocab_mask, b_sh, points, codes,
                        lengths)
    if (emb_in.dtype, theta.dtype) != (torch.float32, torch.float32):
        raise TypeError("hs_grads takes float32 tables")
    if (walks.dtype, b_sh.dtype, points.dtype, codes.dtype, lengths.dtype,
            vocab_mask.dtype) != (torch.int32, torch.int32, torch.int32, torch.int8,
                                  torch.int32, torch.bool):
        raise TypeError("hs_grads takes int32 walks/b_sh/points/lengths, int8 codes "
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
    check_hs_kernel_shape(dim, cl)
    n_head, k_rows = head_split(head_offsets, cl)
    clt = cl - n_head
    lib = _build.lib()
    ws, ws_blocks = _build.staging(lib.n2v_hs_grads_smem(length, dim, cl, window, k_rows),
                                   n_walks, emb_in.device)
    dev = emb_in.device
    g_in = torch.empty((n_walks * length, dim), dtype=torch.float32, device=dev)
    g_tail = torch.empty((n_walks * length * clt, dim), dtype=torch.float32, device=dev)
    tail_rows = torch.empty((n_walks * length * clt,), dtype=torch.int32, device=dev)
    d_head = torch.zeros((k_rows, dim), dtype=torch.float32, device=dev)
    parts = torch.zeros((n_walks, 2), dtype=torch.float32, device=dev)
    rc = lib.n2v_hs_grads(
        _build.ptr(emb_in), _build.ptr(theta), dim, _build.ptr(walks),
        _build.ptr(vocab_mask), _build.ptr(b_sh), _build.ptr(points), _build.ptr(codes),
        _build.ptr(lengths), cl, n_walks, length, window, n_head, k_rows,
        _build.ptr(g_in), _build.ptr(g_tail), _build.ptr(tail_rows), _build.ptr(d_head),
        _build.ptr(parts), _build.ptr_or_null(ws), ws_blocks, _build.stream_of(emb_in),
    )
    _build.check(rc, "hs_grads")
    _build.launches["hs_grads"] += 1
    if ws is not None:
        _build.launches["hs_grads_global"] += 1
    tot = parts.sum(dim=0)
    loss = -tot[0] / torch.clamp(tot[1], min=1.0)
    return g_in, g_tail, tail_rows, d_head, loss


# --------------------------------------------------------------------------- #
# The step and the epoch
# --------------------------------------------------------------------------- #


def _step(grads, accumulate, apply, emb_in, theta, acc_in, acc_theta, walks, b_sh, lr,
          points, codes, lengths, vocab_mask, window, head_offsets):
    g_in, g_tail, tail_rows, d_head, loss = grads(
        emb_in, theta, walks, vocab_mask, b_sh, points, codes, lengths,
        window=window, head_offsets=head_offsets,
    )
    head_rows = torch.arange(d_head.shape[0], dtype=torch.int32, device=walks.device)
    rows_in = walks.reshape(-1)
    lists = (g_in, rows_in, g_tail, tail_rows, d_head, head_rows)
    accumulate(acc_in, acc_theta, *lists)
    apply(emb_in, theta, acc_in, acc_theta, *lists, lr)
    return loss


def hs_walk_step(emb_in, theta, acc_in, acc_theta, walks, b_sh, lr: float, points, codes,
                 lengths, vocab_mask, *, window: int, head_offsets) -> torch.Tensor:
    """One HS + row-wise Adagrad step (``hs_walk_step_impl``), in place on
    the four state tensors; returns the loss.  Goes through K8, K3, K4 on
    CUDA tensors and their plain versions on CPU tensors."""
    return _step(hs_grads, adagrad_accumulate, adagrad_apply, emb_in, theta, acc_in,
                 acc_theta, walks, b_sh, lr, points, codes, lengths, vocab_mask, window,
                 head_offsets)


def hs_walk_step_plain(emb_in, theta, acc_in, acc_theta, walks, b_sh, lr: float, points,
                       codes, lengths, vocab_mask, *, window: int,
                       head_offsets) -> torch.Tensor:
    """``hs_walk_step`` through the three plain versions, on any device."""
    return _step(hs_grads_plain, adagrad_accumulate_plain, adagrad_apply_plain, emb_in,
                 theta, acc_in, acc_theta, walks, b_sh, lr, points, codes, lengths,
                 vocab_mask, window, head_offsets)


def hs_epoch(
    emb_in, theta, acc_in, acc_theta, corpus: torch.Tensor,
    draws: Callable[[int], torch.Tensor], step0: int, lr0: float, lr_slope: float,
    points, codes, lengths, vocab_mask, *,
    batch: int, n_batches: int, window: int, min_lr: float, head_offsets,
) -> torch.Tensor:
    """A whole epoch of HS steps over a shuffled, batch-padded corpus
    (``_hs_epoch_impl`` as a Python loop).  ``draws(gstep)`` returns the
    step's window shrink b_sh [B, L1].  Returns the per-batch losses."""
    losses = []
    for b in range(n_batches):
        gstep = step0 + b
        lr = step_lr(lr0, lr_slope, gstep, min_lr)
        wb = corpus[b * batch: (b + 1) * batch]
        losses.append(hs_walk_step(
            emb_in, theta, acc_in, acc_theta, wb, draws(gstep), lr, points, codes, lengths,
            vocab_mask, window=window, head_offsets=head_offsets,
        ))
    return torch.stack(losses)
