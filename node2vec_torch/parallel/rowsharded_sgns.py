"""Row-sharded SGNS: the embedding tables partitioned by vertex over every
rank of the mesh (port of ``node2vec_tpu/parallel/rowsharded_sgns.py``).

* Layout: rank ``r`` of the flattened mesh (``Mesh.world``, N ranks) owns
  the logical rows ``v ≡ r (mod N)`` as a local ``[Vp / N, D]`` table, row
  ``v`` at local index ``v // N`` (``Vp``: V padded to whole ranks).  The
  accumulators are ``[Vp / N]`` alike.  Walks are sharded over the same
  ranks, so each rank is a data worker and the owner of its rows.
* Each step routes the rows its batch touches: K18 ``route_plan``
  deduplicates the requests and buckets the unique ids by owner into
  ``[N, cap]``; one ``all_to_all`` sends the buckets, the owners gather the
  rows (K19's gather launch) and a second ``all_to_all`` sends them back.
  The gradients go the other way, summed per unique row first (K19's pack
  launch: ``[N, cap, D + 1]``, the sum of the mean squares in column D);
  the owners then run row-wise Adagrad over the received rows in two
  passes, K3's squares mode then K4, so every source's squares land before
  any scale is read.
* A bucket can overflow its capacity: its largest ids are dropped for the
  step, their pairs masked, and the count returned (``dropped``), never
  silently lost.

The step's draws are inputs, as in the port's other steps: ``b_sh`` and the
shared negatives' ``r1``, ``r2`` of this rank (the JAX step draws them from
``fold_in(key, my)``, :281-282).  The trainers draw them per flat rank.
CPU tensors take the kernels' plain versions (the JAX code line by line:
``torch.sort``, ``index_add_`` and their kin appear only there); CUDA
tensors launch the kernels or raise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from node2vec_torch import _build
from node2vec_torch.device import resolve_device
from node2vec_torch.models import skipgram as sg
from node2vec_torch.parallel.mesh import Mesh


class RowShardedState(NamedTuple):
    emb_in: torch.Tensor  # [Vp / N, D]: logical rows v ≡ rank (mod N), at v // N
    emb_out: torch.Tensor
    acc_in: torch.Tensor  # [Vp / N] row-wise Adagrad accumulators
    acc_out: torch.Tensor
    n_vertices: int  # unpadded V


def pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def shard_rows(mesh: Mesh, table: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a full logical table (or accumulator): padded with
    zeros to whole ranks, then rows ``rank::N``, contiguous."""
    n_dev = mesh.n_devices
    n_pad = pad_to(table.shape[0], n_dev)
    if n_pad > table.shape[0]:
        pad = torch.zeros((n_pad - table.shape[0],) + tuple(table.shape[1:]),
                          dtype=table.dtype, device=table.device)
        table = torch.cat([table, pad])
    return table[mesh.rank::n_dev].contiguous()


def unshard_rows(mesh: Mesh, local: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The full logical table from every rank's rows (a collective: every
    rank calls it), its first ``n_rows`` rows, on this rank's device."""
    n_dev = mesh.n_devices
    gathered = mesh.all_gather(local, mesh.world)  # [N * Vp / N, ...] in rank order
    per = local.shape[0]
    full = gathered.reshape((n_dev, per) + tuple(local.shape[1:])).transpose(0, 1)
    return full.reshape((n_dev * per,) + tuple(local.shape[1:]))[:n_rows].contiguous()


def init_row_state(mesh: Mesh, n_vertices: int, dim: int, seed: int = 1,
                   device="cuda") -> RowShardedState:
    """word2vec's init (``models.skipgram.init_embeddings``, the same full
    table on every rank), of which this rank keeps its rows; zero
    accumulators."""
    emb_in, emb_out, _, _ = sg.init_embeddings(n_vertices, dim, seed,
                                               device=resolve_device(device))
    n_local = pad_to(n_vertices, mesh.n_devices) // mesh.n_devices
    zeros = lambda: torch.zeros((n_local,), dtype=torch.float32, device=emb_in.device)  # noqa: E731
    return RowShardedState(shard_rows(mesh, emb_in), shard_rows(mesh, emb_out), zeros(),
                           zeros(), n_vertices)


def row_state_to_host(mesh: Mesh, state: RowShardedState
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Full logical host copies (emb_in [V, D], emb_out [V, D], acc_in [V],
    acc_out [V]) for checkpoints: gathered over the world (every rank calls
    it, every rank gets them)."""
    n = state.n_vertices
    return tuple(unshard_rows(mesh, t, n).cpu().numpy()
                 for t in (state.emb_in, state.emb_out, state.acc_in, state.acc_out))


def row_state_from_host(mesh: Mesh, emb_in, emb_out, acc_in, acc_out,
                        device="cuda") -> RowShardedState:
    """This rank's state from full logical arrays (a checkpoint's, or
    ``np.asarray`` of a JAX ``RowShardedState``'s tables un-interleaved)."""
    dev = resolve_device(device)
    t = [torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(dev)
         for a in (emb_in, emb_out, acc_in, acc_out)]
    if t[2].dim() == 2:  # JAX's [V, 1] accumulators
        t[2], t[3] = t[2][:, 0], t[3][:, 0]
    return RowShardedState(*(shard_rows(mesh, x) for x in t), int(t[0].shape[0]))


# --------------------------------------------------------------------------- #
# K18: the route plan
# --------------------------------------------------------------------------- #


class RoutePlan(NamedTuple):
    """JAX's RoutePlan (one table's unique request set) and the port's
    ``slot``, ``order`` and ``n_uniq`` (csrc/route.cu)."""

    uniq: torch.Tensor  # [R] unique ids ascending, 0 past n_uniq
    inv: torch.Tensor  # [R] request -> unique slot
    is_uniq: torch.Tensor  # [R] bool
    owner: torch.Tensor  # [R] uniq mod N (N on dead slots)
    bucket_pos: torch.Tensor  # [R] rank in the owner's bucket, ascending id order
    ok: torch.Tensor  # [R] bool: a live unique within capacity
    send_ids: torch.Tensor  # [N, cap] the buckets, -1 padded
    n_dropped: torch.Tensor  # int32 scalar
    slot: torch.Tensor  # [R] the request's row owner * cap + rank of the returned buffer, -1 dropped
    order: torch.Tensor  # [R] request positions in (id, position) order
    n_uniq: torch.Tensor  # int32 scalar


def plan_routes_plain(ids: torch.Tensor, n_dev: int, cap: int) -> RoutePlan:
    """K18's function in plain PyTorch (rowsharded_sgns.py:170-203 line by
    line, and the port's three fields)."""
    r = ids.shape[0]
    dev = ids.device
    order = torch.sort(ids, stable=True).indices
    s = ids[order]
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), s[1:] != s[:-1]])
    slot = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    n_uniq = slot[-1] + 1
    uniq = torch.zeros((r,), dtype=ids.dtype, device=dev)
    uniq[slot.long()] = s
    inv = torch.zeros((r,), dtype=torch.int32, device=dev)
    inv[order] = slot
    iota = torch.arange(r, dtype=torch.int32, device=dev)
    is_uniq = iota < n_uniq

    owner = torch.where(is_uniq, torch.remainder(uniq, n_dev), n_dev).to(torch.int32)
    oorder = torch.sort(owner, stable=True).indices
    osorted = owner[oorder]
    ofirst = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                        osorted[1:] != osorted[:-1]])
    start_idx = torch.cummax(torch.where(ofirst, iota, 0), 0).values
    rank = torch.zeros((r,), dtype=torch.int32, device=dev)
    rank[oorder] = iota - start_idx

    fits = is_uniq & (rank < cap)
    n_dropped = torch.sum(is_uniq & ~fits, dtype=torch.int32)
    send_ids = torch.full((n_dev, cap), -1, dtype=torch.int32, device=dev)
    send_ids[owner[fits].long(), rank[fits].long()] = uniq[fits].to(torch.int32)

    inv_l = inv.long()
    req_slot = torch.where(fits[inv_l], owner[inv_l] * cap + rank[inv_l], -1).to(torch.int32)
    return RoutePlan(uniq.to(torch.int32), inv, is_uniq, owner, rank, fits, send_ids,
                     n_dropped, req_slot, order.to(torch.int32), n_uniq.to(torch.int32))


def plan_routes(ids: torch.Tensor, n_dev: int, cap: int) -> RoutePlan:
    """K18 for a CUDA tensor, the plain version for a CPU tensor.  ``ids``:
    int32 [R], the step's requests."""
    if not ids.is_cuda:
        return plan_routes_plain(ids, n_dev, cap)
    _build.require_cuda("route_plan", ids)
    if ids.dtype != torch.int32 or ids.dim() != 1 or ids.shape[0] == 0:
        raise ValueError("route_plan takes a non-empty int32 request vector [R]")
    if n_dev < 1 or cap < 1:
        raise ValueError(f"route_plan needs n_dev >= 1 and cap >= 1, got {n_dev}, {cap}")
    r = ids.shape[0]
    dev = ids.device
    i32 = dict(dtype=torch.int32, device=dev)
    lib = _build.lib()
    ws = torch.empty((2, r), dtype=torch.int64, device=dev)
    ws_i = torch.empty((-(-r // lib.n2v_route_tile()) * (n_dev + 1),), **i32)
    uniq, inv, owner, rank, slot, order = (torch.empty((r,), **i32) for _ in range(6))
    is_uniq = torch.empty((r,), dtype=torch.bool, device=dev)
    ok = torch.empty((r,), dtype=torch.bool, device=dev)
    send_ids = torch.empty((n_dev, cap), **i32)
    n_out = torch.empty((2,), **i32)
    rc = lib.n2v_route_plan(
        _build.ptr(ids), r, int(n_dev), int(cap), _build.ptr(ws[0]), _build.ptr(ws[1]),
        _build.ptr(ws_i), _build.ptr(uniq), _build.ptr(inv), _build.ptr(is_uniq),
        _build.ptr(owner), _build.ptr(rank), _build.ptr(ok), _build.ptr(send_ids),
        _build.ptr(n_out), _build.ptr(slot), _build.ptr(order), _build.stream_of(ids),
    )
    _build.check(rc, "route_plan")
    _build.launches["route_plan"] += 1
    return RoutePlan(uniq, inv, is_uniq, owner, rank, ok, send_ids, n_out[1], slot, order,
                     n_out[0])


def row_cap(requests: int, n_dev: int, cap_slack: float = 2.0) -> int:
    """A bucket's capacity for ``requests`` requests a rank
    (rowsharded_sgns.py:471-472)."""
    return max(64, int(-(-requests * cap_slack // n_dev // 64) * 64))


# --------------------------------------------------------------------------- #
# K19: the owners' gather, and the requesters' pack
# --------------------------------------------------------------------------- #


def route_gather_plain(table_local: torch.Tensor, recv_ids: torch.Tensor,
                       n_dev: int) -> torch.Tensor:
    """K19's gather in plain PyTorch (rowsharded_sgns.py:216-222):
    [N * cap, D], the local rows ``recv_ids // N``, zeros where -1."""
    ids = recv_ids.reshape(-1)
    rows = table_local[(torch.clamp(ids, min=0) // n_dev).long()]
    return torch.where((ids >= 0)[:, None], rows, 0.0)


def route_gather(table_local: torch.Tensor, recv_ids: torch.Tensor, n_dev: int) -> torch.Tensor:
    """K19's gather launch for CUDA tensors, the plain version for CPU ones."""
    if not table_local.is_cuda:
        return route_gather_plain(table_local, recv_ids, n_dev)
    _build.require_cuda("route_gather", table_local, recv_ids)
    if table_local.dtype != torch.float32 or recv_ids.dtype != torch.int32:
        raise TypeError("route_gather takes a float32 table and int32 ids")
    n = recv_ids.numel()
    dim = table_local.shape[1]
    out = torch.empty((n, dim), dtype=torch.float32, device=table_local.device)
    rc = _build.lib().n2v_route_gather(_build.ptr(table_local), dim, _build.ptr(recv_ids), n,
                                       int(n_dev), _build.ptr(out),
                                       _build.stream_of(table_local))
    _build.check(rc, "route_gather")
    _build.launches["route_gather"] += 1
    return out


def _live(live: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    if live is None:
        return torch.ones((n,), dtype=torch.float32, device=device)
    return (live >= 0).to(torch.float32)


def route_pack_plain(plan: RoutePlan, n_dev: int, cap: int, g_a, live_a, g_b=None,
                     live_b=None) -> torch.Tensor:
    """K19's pack in plain PyTorch (rowsharded_sgns.py:244-251 with the
    segment sums :355-381): the requests' gradient rows (g_a's, then
    g_b's), masked by their live arrays (>= 0: live; None: all), summed per
    unique row with their mean squares, placed at (owner, rank) of
    ``[N * cap, D + 1]`` where ok."""
    g = g_a * _live(live_a, g_a.shape[0], g_a.device)[:, None]
    sq = torch.mean(g_a * g_a, dim=-1) * _live(live_a, g_a.shape[0], g_a.device)
    if g_b is not None:
        w_b = _live(live_b, g_b.shape[0], g_b.device)
        g = torch.cat([g, g_b * w_b[:, None]])
        sq = torch.cat([sq, torch.mean(g_b * g_b, dim=-1) * w_b])
    r, dim = plan.uniq.shape[0], g.shape[1]
    inv = plan.inv.long()
    gu = torch.zeros((r, dim), dtype=torch.float32, device=g.device).index_add_(0, inv, g)
    squ = torch.zeros((r,), dtype=torch.float32, device=g.device).index_add_(0, inv, sq)
    payload = torch.where(plan.ok[:, None], torch.cat([gu, squ[:, None]], dim=1), 0.0)
    send = torch.zeros((n_dev * cap, dim + 1), dtype=torch.float32, device=g.device)
    pos = (plan.owner.clamp(0, n_dev - 1) * cap + plan.bucket_pos.clamp(0, cap - 1)).long()
    return send.index_put_((pos,), torch.where(plan.ok[:, None], payload, 0.0), accumulate=True)


def route_pack(plan: RoutePlan, n_dev: int, cap: int, g_a, live_a, g_b=None,
               live_b=None) -> torch.Tensor:
    """K19's pack launch for CUDA tensors, the plain version for CPU ones."""
    if not g_a.is_cuda:
        return route_pack_plain(plan, n_dev, cap, g_a, live_a, g_b, live_b)
    n_a, dim = g_a.shape
    has_b = g_b is not None
    n_b = g_b.shape[0] if has_b else 0
    r = plan.uniq.shape[0]
    if n_a + n_b != r:
        raise ValueError(f"route_pack: {n_a} + {n_b} gradient rows for {r} requests")
    tensors = [g_a, plan.order, plan.inv, plan.owner, plan.bucket_pos, plan.ok]
    tensors += [t for t in (live_a, g_b, live_b) if t is not None]
    _build.require_cuda("route_pack", *tensors)
    if g_a.dtype != torch.float32 or (has_b and (g_b.dtype, g_b.shape[1]) != (torch.float32,
                                                                                  dim)):
        raise TypeError("route_pack takes float32 gradient rows of one width")
    if not 0 < dim <= 1024:
        raise ValueError(f"route_pack takes rows of 1..1024 floats, not {dim}")
    if any(t is not None and t.dtype != torch.int32 for t in (live_a, live_b)):
        raise TypeError("route_pack takes int32 live arrays")
    send = torch.zeros((n_dev * cap, dim + 1), dtype=torch.float32, device=g_a.device)
    rc = _build.lib().n2v_route_pack(
        _build.ptr(g_a), _build.ptr_or_null(live_a), n_a, _build.ptr_or_null(g_b),
        _build.ptr_or_null(live_b), dim, _build.ptr(plan.order), _build.ptr(plan.inv),
        _build.ptr(plan.owner), _build.ptr(plan.bucket_pos), _build.ptr(plan.ok), r, int(cap),
        _build.ptr(send), _build.stream_of(g_a),
    )
    _build.check(rc, "route_pack")
    _build.launches["route_pack"] += 1
    return send


# --------------------------------------------------------------------------- #
# the two routing halves
# --------------------------------------------------------------------------- #


def routed_gather(mesh: Mesh, table_local: torch.Tensor, plan: RoutePlan,
                  gather=route_gather) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_routed_gather`` (rowsharded_sgns.py:206-230): the buckets go to
    their owners, each owner gathers the rows asked of it (K19), and they
    come back.  Returns (rows [N * cap, D], request p's row at
    ``plan.slot[p]``; the ids the owners received [N, cap], which
    ``routed_apply`` reuses)."""
    recv_ids = mesh.all_to_all(plan.send_ids)  # row j: the ids rank j asks of me
    rows = gather(table_local, recv_ids, mesh.n_devices)
    return mesh.all_to_all(rows), recv_ids


def _owner_rows(mesh: Mesh, send: torch.Tensor, recv_ids: torch.Tensor):
    """The owner's side of ``_routed_apply`` (:252-258): the packed rows
    received from every source, as (grads [N * cap, D], squares [N * cap],
    local rows, -1 where the slot is empty)."""
    recv = mesh.all_to_all(send)
    dim = recv.shape[1] - 1
    rows = torch.where(recv_ids >= 0, recv_ids // mesh.n_devices, -1).reshape(-1)
    return recv[:, :dim].contiguous(), recv[:, dim].contiguous(), rows.to(torch.int32)


def _empty_lists(dim: int, device):
    return (torch.empty((0, dim), dtype=torch.float32, device=device),
            torch.empty((0,), dtype=torch.float32, device=device),
            torch.empty((0,), dtype=torch.int32, device=device))


ADAGRAD = (sg.adagrad_accumulate, sg.adagrad_accumulate_squares, sg.adagrad_apply)
ADAGRAD_PLAIN = (sg.adagrad_accumulate_plain, sg.adagrad_accumulate_squares_plain,
                 sg.adagrad_apply_plain)


def routed_apply(mesh: Mesh, tables, sides, lr: float, head=None, adagrad=ADAGRAD) -> None:
    """``_routed_apply`` (rowsharded_sgns.py:233-267) for one or two tables
    at once, in place.  ``tables``: (emb_a, emb_b, acc_a, acc_b);
    ``sides``: (send_a, recv_ids_a) and (send_b, recv_ids_b) or None, each
    table's packed rows (K19's pack) and the ids its owners received
    (``routed_gather``).  ``head``: (grads [kp, D], local rows [kp]) of table
    b applied from their gradients (HS's head rows,
    rowsharded_hs.py:300-313) or None.  Every square lands first (K3's
    squares mode; K3 for the head), then K4 scales by the final
    accumulators; ``adagrad``: (K3, K3's squares mode, K4), or
    ``ADAGRAD_PLAIN``."""
    emb_a, emb_b, acc_a, acc_b = tables
    dim = emb_a.shape[1]
    g_e, sq_e, rows_e = _empty_lists(dim, emb_a.device)
    g_a, sq_a, rows_a = _owner_rows(mesh, *sides[0])
    g_b, sq_b, rows_b = (g_e, sq_e, rows_e) if sides[1] is None else _owner_rows(mesh, *sides[1])
    g_h, rows_h = (g_e, rows_e) if head is None else head
    accumulate, accumulate_sq, apply = adagrad
    if head is not None:
        accumulate(acc_a, acc_b, g_e, rows_e, g_e, rows_e, g_h, rows_h)
    # the received squares are mean squares already: divide by 1
    accumulate_sq(acc_a, acc_b, sq_a, rows_a, sq_b, rows_b, sq_e, rows_e, 1)
    apply(emb_a, emb_b, acc_a, acc_b, g_a, rows_a, g_b, rows_b, g_h, rows_h, lr)


# --------------------------------------------------------------------------- #
# K2's routed mode
# --------------------------------------------------------------------------- #


def _take(buf: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Rows ``buf[slot]``, zeros where slot is -1 (a dropped request)."""
    return torch.where((slot >= 0)[:, None], buf[torch.clamp(slot, min=0).long()], 0.0)


def sgns_grads_routed_plain(x_in, slot_in, x_out, slot_out, slot_neg, walks, vocab_mask, b_sh,
                            *, window: int, negatives: int):
    """K2's routed mode in plain PyTorch (rowsharded_sgns.py:284-344):
    (g_in [B*L1, D], g_out [B*L1, D], d_no [S, D], parts [3] = (sum of log
    sigmoid of the positive logits, of the negative terms before K/S, the
    valid-pair count)).  ``x_in``, ``x_out``: the buffers the owners sent
    back; the slots K18's."""
    n_walks, length = walks.shape
    dim = x_in.shape[1]
    walks_safe = torch.where(walks >= 0, walks, 0).long()
    ok = (slot_in >= 0) & (slot_out >= 0)
    valid_pos = (walks >= 0) & vocab_mask[walks_safe] & ok.reshape(n_walks, length)
    xi = _take(x_in, slot_in).reshape(n_walks, length, dim)
    xo = _take(x_out, slot_out).reshape(n_walks, length, dim)
    no = _take(x_out, slot_neg)
    neg_live = (slot_neg >= 0).all().to(torch.float32)
    g_in, g_out, d_no, pos, neg, mult = sg.sgns_terms(xi, xo, no, valid_pos, b_sh, window,
                                                      negatives, neg_live)
    return g_in, g_out, d_no, torch.stack([pos, neg, mult])


def sgns_grads_routed(x_in, slot_in, x_out, slot_out, slot_neg, walks, vocab_mask, b_sh, *,
                      window: int, negatives: int):
    """K2's routed mode for CUDA tensors, the plain version for CPU ones."""
    if not x_in.is_cuda:
        return sgns_grads_routed_plain(x_in, slot_in, x_out, slot_out, slot_neg, walks,
                                       vocab_mask, b_sh, window=window, negatives=negatives)
    _build.require_cuda("sgns_grads_routed", x_in, slot_in, x_out, slot_out, slot_neg, walks,
                        vocab_mask, b_sh)
    if (x_in.dtype, x_out.dtype) != (torch.float32, torch.float32) or x_in.shape[1] != \
            x_out.shape[1]:
        raise TypeError("sgns_grads_routed takes float32 buffers of one width")
    if any(t.dtype != torch.int32 for t in (slot_in, slot_out, slot_neg, walks, b_sh)) or \
            vocab_mask.dtype != torch.bool:
        raise TypeError("sgns_grads_routed takes int32 slots/walks/b_sh and a bool mask")
    n_walks, length = walks.shape
    if b_sh.shape != walks.shape or slot_in.shape != (n_walks * length,) or \
            slot_out.shape != slot_in.shape:
        raise ValueError("b_sh must match walks, and the slots be [B * L1]")
    dim, s = x_in.shape[1], slot_neg.shape[0]
    lib = _build.lib()
    ws, ws_blocks = _build.staging(lib.n2v_sgns_grads_smem(length, dim, s, window), n_walks,
                                   x_in.device)
    dev = x_in.device
    g_in = torch.empty((n_walks * length, dim), dtype=torch.float32, device=dev)
    g_out = torch.empty_like(g_in)
    d_no = torch.zeros((s, dim), dtype=torch.float32, device=dev)
    parts = torch.zeros((n_walks, 3), dtype=torch.float32, device=dev)
    rc = lib.n2v_sgns_grads_routed(
        _build.ptr(x_in), _build.ptr(x_out), dim, _build.ptr(walks), _build.ptr(vocab_mask),
        _build.ptr(b_sh), _build.ptr(slot_in), _build.ptr(slot_out), _build.ptr(slot_neg),
        n_walks, length, window, s, float(np.float32(negatives / s)), _build.ptr(g_in),
        _build.ptr(g_out), _build.ptr(d_no), _build.ptr(parts), _build.ptr_or_null(ws),
        ws_blocks, _build.stream_of(x_in),
    )
    _build.check(rc, "sgns_grads_routed")
    _build.launches["sgns_grads_routed"] += 1
    if ws is not None:
        _build.launches["sgns_grads_routed_global"] += 1
    return g_in, g_out, d_no, parts.sum(dim=0)


# --------------------------------------------------------------------------- #
# the step and the epoch
# --------------------------------------------------------------------------- #

_KERNELS = (plan_routes, route_gather, sgns_grads_routed, route_pack, ADAGRAD)
_PLAIN = (plan_routes_plain, route_gather_plain, sgns_grads_routed_plain, route_pack_plain,
          ADAGRAD_PLAIN)


def _row_step(ops, mesh: Mesh, state: RowShardedState, walks, b_sh, r1, r2, lr: float,
              ns_alias, ns_prob, vocab_mask, cap: int, window: int, negatives: int):
    plan, gather, grads, pack, adagrad = ops
    n_dev = mesh.n_devices
    walks_flat = walks.reshape(-1)
    rows = torch.where(walks_flat >= 0, walks_flat, 0)  # dead positions request row 0
    neg_ids = sg.negative_ids(r1, r2, ns_alias, ns_prob)
    n = rows.shape[0]
    plan_in = plan(rows, n_dev, cap)
    plan_out = plan(torch.cat([rows, neg_ids]), n_dev, cap)
    x_in, ids_in = routed_gather(mesh, state.emb_in, plan_in, gather)
    x_out, ids_out = routed_gather(mesh, state.emb_out, plan_out, gather)
    g_in, g_out, d_no, parts = grads(x_in, plan_in.slot, x_out, plan_out.slot[:n],
                                     plan_out.slot[n:], walks, vocab_mask, b_sh,
                                     window=window, negatives=negatives)
    # (loss numerator, valid pairs, dropped rows): one psum over the world
    red = torch.stack([-(parts[0] + (negatives / neg_ids.shape[0]) * parts[1]), parts[2],
                       (plan_in.n_dropped + plan_out.n_dropped).to(torch.float32)])
    mesh.all_reduce_sum(red, mesh.world)
    send_in = pack(plan_in, n_dev, cap, g_in, walks_flat)
    send_out = pack(plan_out, n_dev, cap, g_out, walks_flat, d_no, None)
    routed_apply(mesh, state[:4], ((send_in, ids_in), (send_out, ids_out)), lr,
                 adagrad=adagrad)
    return red[0] / torch.clamp(red[1], min=1.0), red[2]


def row_sgns_step(mesh: Mesh, state: RowShardedState, walks, b_sh, r1, r2, lr: float,
                  ns_alias, ns_prob, vocab_mask, *, cap: int, window: int, negatives: int):
    """One routed step (``_row_sgns_step``) on this rank's walks [B_local,
    L1], in place on ``state``; returns (loss, dropped), float32 scalars the
    same on every rank: the world's loss over its valid pairs and the rows
    dropped to capacity.  K18, K19, K2's routed mode, K3's squares mode and
    K4 on CUDA tensors, their plain versions on CPU tensors."""
    return _row_step(_KERNELS, mesh, state, walks, b_sh, r1, r2, lr, ns_alias, ns_prob,
                     vocab_mask, cap, window, negatives)


def row_sgns_step_plain(mesh: Mesh, state: RowShardedState, walks, b_sh, r1, r2, lr: float,
                        ns_alias, ns_prob, vocab_mask, *, cap: int, window: int,
                        negatives: int):
    """``row_sgns_step`` through the plain versions, on any device."""
    return _row_step(_PLAIN, mesh, state, walks, b_sh, r1, r2, lr, ns_alias, ns_prob,
                     vocab_mask, cap, window, negatives)


def row_sgns_epoch(
    mesh: Mesh, state: RowShardedState, corpus: torch.Tensor, perm: torch.Tensor,
    draws: Callable[[int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    step0: int, lr0: float, lr_slope: float, ns_alias, ns_prob, vocab_mask, *,
    batch_local: int, n_batches: int, window: int, negatives: int, shared_negatives: int,
    min_lr: float, cap_slack: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One epoch of routed row-sharded SGNS (``row_sgns_epoch``,
    rowsharded_sgns.py:397-486, as a Python loop).  ``corpus``: this rank's
    rows [n_local, L1]; ``perm``: its shuffle this epoch (the JAX epoch's
    ``permutation(fold_in(fold_in(key, my), 0x5F5E1))``); ``draws(gstep)``:
    this rank's (b_sh, r1, r2) of global step ``gstep``.  The capacity is
    JAX's, from ``batch_local * L1 + shared_negatives`` requests.  Returns
    (losses [n_batches], dropped rows summed over the epoch), on the device:
    nothing here waits for the card."""
    cap = row_cap(batch_local * corpus.shape[1] + shared_negatives, mesh.n_devices, cap_slack)
    corpus = corpus[perm.to(corpus.device)]
    losses, dropped = [], torch.zeros((), dtype=torch.float32, device=corpus.device)
    for b in range(n_batches):
        gstep = step0 + b
        b_sh, r1, r2 = draws(gstep)
        loss, d = row_sgns_step(
            mesh, state, corpus[b * batch_local: (b + 1) * batch_local], b_sh, r1, r2,
            sg.step_lr(lr0, lr_slope, gstep, min_lr), ns_alias, ns_prob, vocab_mask, cap=cap,
            window=window, negatives=negatives)
        losses.append(loss)
        dropped = dropped + d
    return torch.stack(losses), dropped
