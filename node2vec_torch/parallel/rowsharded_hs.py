"""Row-sharded hierarchical softmax (port of
``node2vec_tpu/parallel/rowsharded_hs.py``): the input table and the
Huffman inner-node table theta (word2vec's syn1) row-sharded over every rank
of the mesh, with the routing of ``parallel.rowsharded_sgns``.

Per step, per rank (``_row_hs_step``, rowsharded_hs.py:156-344):

* the centers, ``[B * L1]`` requests, are routed against the emb_in rows
  (K18, K19), and so are the tail path rows (levels >= H,
  ``[B * L1 * (CL - H)]`` requests) against theta's;
* the head (levels < H, K <= 512 rows that every pair reaches) is not
  routed: each rank all-gathers its first ``ceil(K / N)`` local theta rows,
  K8's routed mode scores it and pre-aggregates ``d_head [K, D]``, which is
  all-reduced over the world, and each owner applies its own head rows;
* the gradients go back per unique row (K19's pack) and the owners apply
  row-wise Adagrad, K3's squares mode (K3 for the head rows) then one K4.

The Huffman path tables are replicated, like the noise tables of SGNS.  The
step's window shrink ``b_sh`` is an input, drawn per flat rank by the
trainers.  CPU tensors take the plain versions; CUDA tensors launch the
kernels or raise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from node2vec_torch import _build
from node2vec_torch.device import resolve_device
from node2vec_torch.models import hsoftmax as hs
from node2vec_torch.models.skipgram import init_embeddings, step_lr
from node2vec_torch.parallel.mesh import Mesh
from node2vec_torch.parallel.rowsharded_sgns import (
    ADAGRAD,
    ADAGRAD_PLAIN,
    _take,
    pad_to,
    plan_routes,
    plan_routes_plain,
    route_gather,
    route_gather_plain,
    route_pack,
    route_pack_plain,
    routed_apply,
    routed_gather,
    row_cap,
    shard_rows,
    unshard_rows,
)


class RowHSState(NamedTuple):
    emb_in: torch.Tensor  # [Vp / N, D]: logical rows v ≡ rank (mod N), at v // N
    theta: torch.Tensor  # [Ip / N, D] inner-node rows, the same layout
    acc_in: torch.Tensor  # [Vp / N]
    acc_theta: torch.Tensor  # [Ip / N]
    n_vertices: int
    n_inner: int


def init_hs_row_state(mesh: Mesh, n_vertices: int, n_inner: int, dim: int, seed: int = 1,
                      device="cuda") -> RowHSState:
    """The single-device HS init (emb_in ~ U(±0.5/D) from
    ``models.skipgram.init_embeddings``, theta zero), of which this rank
    keeps its rows."""
    dev = resolve_device(device)
    emb_in = init_embeddings(n_vertices, dim, seed, device=dev)[0]
    n_dev = mesh.n_devices
    i_local = pad_to(n_inner, n_dev) // n_dev
    v_local = pad_to(n_vertices, n_dev) // n_dev
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
    return RowHSState(shard_rows(mesh, emb_in), zeros(i_local, dim), zeros(v_local),
                      zeros(i_local), n_vertices, n_inner)


def hs_state_to_host(mesh: Mesh, state: RowHSState
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Full logical host copies (emb_in [V, D], theta [n_inner, D], acc_in
    [V], acc_theta [n_inner]), gathered over the world (every rank calls it)."""
    n_v, n_i = state.n_vertices, state.n_inner
    return tuple(unshard_rows(mesh, t, n).cpu().numpy() for t, n in (
        (state.emb_in, n_v), (state.theta, n_i), (state.acc_in, n_v), (state.acc_theta, n_i)))


def unshard_hs_rows(mesh: Mesh, state: RowHSState) -> Tuple[np.ndarray, np.ndarray]:
    """The logical (emb_in [V, D], theta [n_inner, D]) on the host."""
    return hs_state_to_host(mesh, state)[:2]


def hs_state_from_host(mesh: Mesh, emb_in, theta, acc_in, acc_theta,
                       device="cuda") -> RowHSState:
    """This rank's state from full logical arrays (a checkpoint's)."""
    dev = resolve_device(device)
    t = [torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(dev)
         for a in (emb_in, theta, acc_in, acc_theta)]
    if t[2].dim() == 2:  # JAX's [n, 1] accumulators
        t[2], t[3] = t[2][:, 0], t[3][:, 0]
    return RowHSState(*(shard_rows(mesh, x) for x in t), int(t[0].shape[0]), int(t[1].shape[0]))


# --------------------------------------------------------------------------- #
# K8's routed mode
# --------------------------------------------------------------------------- #


def hs_grads_routed_plain(x_in, slot_in, th, slot_th, head, walks, vocab_mask, b_sh, points,
                          codes, lengths, *, window: int, head_offsets):
    """K8's routed mode in plain PyTorch (rowsharded_hs.py:184-298, with
    the head scored as dot products with its rows): (g_in [B*L1, D], g_tail
    [B*L1*CLT, D], tail_rows [B*L1*CLT], d_head [K, D], parts [2] = (sum of
    log sigmoid over the valid pairs' path entries, the valid-pair count)).
    ``x_in``, ``th``: the buffers the owners sent back; ``head``: the
    all-gathered head rows [K, D]."""
    n_walks, length = walks.shape
    dim = x_in.shape[1]
    cl = points.shape[1]
    n_head, k_rows = hs.head_split(head_offsets, cl)
    clt = cl - n_head
    walks_safe = torch.where(walks >= 0, walks, 0).long()
    valid_pos = ((walks >= 0) & vocab_mask[walks_safe]
                 & (slot_in >= 0).reshape(n_walks, length))
    pts = points[walks_safe].long()
    sgn = 1.0 - 2.0 * codes[walks_safe].to(torch.float32)
    plen = lengths[walks_safe]
    pmask = (torch.arange(cl, device=walks.device)[None, None, :] < plen[..., None]).to(
        torch.float32)
    rows = [head[torch.clamp(pts[:, :, :n_head], max=max(k_rows - 1, 0))]]
    if clt:
        rows.append(_take(th, slot_th).reshape(n_walks, length, clt, dim))
        pmask[:, :, n_head:] *= (slot_th >= 0).reshape(n_walks, length, clt)
    g_in, g_ctx, loss, n_pairs = hs.hs_terms(
        _take(x_in, slot_in).reshape(n_walks, length, dim), torch.cat(rows, dim=2), valid_pos,
        sgn, pmask, b_sh, window)
    return hs.hs_outputs(g_in, g_ctx, pts, walks, pmask, n_head, k_rows) + (
        torch.stack([-loss, n_pairs]),)


def hs_grads_routed(x_in, slot_in, th, slot_th, head, walks, vocab_mask, b_sh, points, codes,
                    lengths, *, window: int, head_offsets):
    """K8's routed mode for CUDA tensors, the plain version for CPU ones."""
    if not x_in.is_cuda:
        return hs_grads_routed_plain(x_in, slot_in, th, slot_th, head, walks, vocab_mask, b_sh,
                                     points, codes, lengths, window=window,
                                     head_offsets=head_offsets)
    _build.require_cuda("hs_grads_routed", x_in, slot_in, th, slot_th, head, walks, vocab_mask,
                        b_sh, points, codes, lengths)
    if any(t.dtype != torch.float32 for t in (x_in, th, head)):
        raise TypeError("hs_grads_routed takes float32 buffers")
    if (walks.dtype, b_sh.dtype, points.dtype, codes.dtype, lengths.dtype, slot_in.dtype,
            slot_th.dtype, vocab_mask.dtype) != (torch.int32,) * 3 + (torch.int8,) + \
            (torch.int32,) * 3 + (torch.bool,):
        raise TypeError("hs_grads_routed takes int32 walks/b_sh/points/lengths/slots, int8 "
                        "codes and a bool mask")
    n_walks, length = walks.shape
    dim = x_in.shape[1]
    cl = points.shape[1]
    n_head, k_rows = hs.head_split(head_offsets, cl)
    clt = cl - n_head
    if b_sh.shape != walks.shape or slot_in.shape != (n_walks * length,) or \
            slot_th.shape != (n_walks * length * clt,) or head.shape != (k_rows, dim) or \
            th.shape[1] != dim:
        raise ValueError("b_sh must match walks, slot_in be [B * L1], slot_th [B * L1 * "
                         "(CL - H)], head [K, D] and th [*, D]")
    lib = _build.lib()
    ws, ws_blocks = _build.staging(lib.n2v_hs_grads_smem(length, dim, cl, window, k_rows),
                                   n_walks, x_in.device)
    dev = x_in.device
    g_in = torch.empty((n_walks * length, dim), dtype=torch.float32, device=dev)
    g_tail = torch.empty((n_walks * length * clt, dim), dtype=torch.float32, device=dev)
    tail_rows = torch.empty((n_walks * length * clt,), dtype=torch.int32, device=dev)
    d_head = torch.zeros((k_rows, dim), dtype=torch.float32, device=dev)
    parts = torch.zeros((n_walks, 2), dtype=torch.float32, device=dev)
    rc = lib.n2v_hs_grads_routed(
        _build.ptr(x_in), _build.ptr(th), _build.ptr(head), dim, _build.ptr(walks),
        _build.ptr(vocab_mask), _build.ptr(b_sh), _build.ptr(points), _build.ptr(codes),
        _build.ptr(lengths), _build.ptr(slot_in), _build.ptr(slot_th), cl, n_walks, length,
        window, n_head, k_rows, _build.ptr(g_in), _build.ptr(g_tail), _build.ptr(tail_rows),
        _build.ptr(d_head), _build.ptr(parts), _build.ptr_or_null(ws), ws_blocks,
        _build.stream_of(x_in),
    )
    _build.check(rc, "hs_grads_routed")
    _build.launches["hs_grads_routed"] += 1
    if ws is not None:
        _build.launches["hs_grads_routed_global"] += 1
    return g_in, g_tail, tail_rows, d_head, parts.sum(dim=0)


# --------------------------------------------------------------------------- #
# the step and the epoch
# --------------------------------------------------------------------------- #

_KERNELS = (plan_routes, route_gather, hs_grads_routed, route_pack, ADAGRAD)
_PLAIN = (plan_routes_plain, route_gather_plain, hs_grads_routed_plain, route_pack_plain,
          ADAGRAD_PLAIN)


def _row_hs_step(ops, mesh: Mesh, state: RowHSState, walks, b_sh, lr: float, points, codes,
                 lengths, vocab_mask, cap_in: int, cap_th: int, window: int, head_offsets):
    plan, gather, grads, pack, adagrad = ops
    n_dev = mesh.n_devices
    dim = state.emb_in.shape[1]
    dev = state.emb_in.device
    cl = points.shape[1]
    n_head, k_rows = hs.head_split(head_offsets, cl)
    clt = cl - n_head
    walks_flat = walks.reshape(-1)
    rows = torch.where(walks_flat >= 0, walks_flat, 0)  # dead positions request row 0
    plan_in = plan(rows, n_dev, cap_in)
    x_in, ids_in = routed_gather(mesh, state.emb_in, plan_in, gather)
    dropped = plan_in.n_dropped
    if clt:
        prow = points[rows.long()][:, n_head:].reshape(-1).contiguous()
        plan_th = plan(prow, n_dev, cap_th)
        th, ids_th = routed_gather(mesh, state.theta, plan_th, gather)
        slot_th = plan_th.slot
        dropped = dropped + plan_th.n_dropped
    else:
        th = torch.empty((0, dim), dtype=torch.float32, device=dev)
        slot_th = torch.empty((0,), dtype=torch.int32, device=dev)
    kp = -(-k_rows // n_dev)  # local head rows: logical row j on rank j % N at j // N
    if n_head:
        gathered = mesh.all_gather(state.theta[:kp].contiguous(), mesh.world)  # [N * kp, D]
        head = gathered.reshape(n_dev, kp, dim).transpose(0, 1).reshape(kp * n_dev, dim)
        head = head[:k_rows].contiguous()
    else:
        head = torch.empty((0, dim), dtype=torch.float32, device=dev)
    g_in, g_tail, tail_rows, d_head, parts = grads(
        x_in, plan_in.slot, th, slot_th, head, walks, vocab_mask, b_sh, points, codes,
        lengths, window=window, head_offsets=head_offsets)
    # (d_head, loss, valid pairs, dropped rows): one psum over the world
    red = torch.cat([d_head.reshape(-1),
                     torch.stack([-parts[0], parts[1], dropped.to(torch.float32)])])
    mesh.all_reduce_sum(red, mesh.world)
    head_rows = None
    if n_head:
        d_pad = torch.zeros((kp * n_dev, dim), dtype=torch.float32, device=dev)
        d_pad[:k_rows] = red[: k_rows * dim].reshape(k_rows, dim)
        d_mine = d_pad.reshape(kp, n_dev, dim)[:, mesh.rank].contiguous()
        head_rows = (d_mine, torch.arange(kp, dtype=torch.int32, device=dev))
    sides = [(pack(plan_in, n_dev, cap_in, g_in, walks_flat), ids_in), None]
    if clt:
        sides[1] = (pack(plan_th, n_dev, cap_th, g_tail, tail_rows), ids_th)
    routed_apply(mesh, (state.emb_in, state.theta, state.acc_in, state.acc_theta), sides, lr,
                 head=head_rows, adagrad=adagrad)
    tot = red[k_rows * dim:]
    return tot[0] / torch.clamp(tot[1], min=1.0), tot[2]


def row_hs_step(mesh: Mesh, state: RowHSState, walks, b_sh, lr: float, points, codes, lengths,
                vocab_mask, *, cap_in: int, cap_th: int, window: int, head_offsets=(0,)):
    """One routed HS step (``_row_hs_step``) on this rank's walks [B_local,
    L1], in place on ``state``; returns (loss, dropped), float32 scalars the
    same on every rank.  ``head_offsets`` (``hsoftmax.head_level_offsets``
    with ``table_rows=ceil(n_inner / N)``) replicates the tree top instead of
    routing it.  K18, K19, K8's routed mode, K3 (head rows), K3's squares
    mode and K4 on CUDA tensors, their plain versions on CPU tensors."""
    return _row_hs_step(_KERNELS, mesh, state, walks, b_sh, lr, points, codes, lengths,
                        vocab_mask, cap_in, cap_th, window, head_offsets)


def row_hs_step_plain(mesh: Mesh, state: RowHSState, walks, b_sh, lr: float, points, codes,
                      lengths, vocab_mask, *, cap_in: int, cap_th: int, window: int,
                      head_offsets=(0,)):
    """``row_hs_step`` through the plain versions, on any device."""
    return _row_hs_step(_PLAIN, mesh, state, walks, b_sh, lr, points, codes, lengths,
                        vocab_mask, cap_in, cap_th, window, head_offsets)


def hs_caps(batch_local: int, length: int, code_len: int, head_offsets, n_dev: int,
            cap_slack: float = 2.0) -> Tuple[int, int]:
    """(cap_in, cap_th), rowsharded_hs.py:436-443: the centers' requests and
    the worst case of distinct tail path rows."""
    n_head = min(len(head_offsets) - 1, code_len)
    return (row_cap(batch_local * length, n_dev, cap_slack),
            row_cap(batch_local * length * max(code_len - n_head, 1), n_dev, cap_slack))


def row_hs_epoch(
    mesh: Mesh, state: RowHSState, corpus: torch.Tensor, perm: torch.Tensor,
    draws: Callable[[int], torch.Tensor], step0: int, lr0: float, lr_slope: float,
    points, codes, lengths, vocab_mask, *, batch_local: int, n_batches: int, window: int,
    min_lr: float, cap_slack: float = 2.0, head_offsets=(0,),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One epoch of routed row-sharded HS (``row_hs_epoch``,
    rowsharded_hs.py:401-455, as a Python loop): ``corpus`` this rank's rows,
    ``perm`` its shuffle, ``draws(gstep)`` its window shrink b_sh.  Returns
    (losses [n_batches], dropped rows summed over the epoch), on the device."""
    cap_in, cap_th = hs_caps(batch_local, corpus.shape[1], points.shape[1], head_offsets,
                             mesh.n_devices, cap_slack)
    corpus = corpus[perm.to(corpus.device)]
    losses, dropped = [], torch.zeros((), dtype=torch.float32, device=corpus.device)
    for b in range(n_batches):
        gstep = step0 + b
        loss, d = row_hs_step(
            mesh, state, corpus[b * batch_local: (b + 1) * batch_local], draws(gstep),
            step_lr(lr0, lr_slope, gstep, min_lr), points, codes, lengths, vocab_mask,
            cap_in=cap_in, cap_th=cap_th, window=window, head_offsets=head_offsets)
        losses.append(loss)
        dropped = dropped + d
    return torch.stack(losses), dropped
