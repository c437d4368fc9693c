"""CSR walk engine: alias-proposal rejection walks over the sorted CSR
(port of ``node2vec_tpu/walk/engine.py:66 walk_chunk_impl``).

The JAX package keeps it as the reference-style fallback beside the dense
and blocked engines (``WalkEngine(strategy="csr")``).  Each step is an exact
mixture: with mass ``w(cur, prev)/p`` (found by one binary search in cur's
row) the walker returns to prev and accepts outright; otherwise it draws a
neighbour proportional to weight from cur's alias table, rejects prev, and
accepts with probability bias/max(1, 1/q), bias 1 when the neighbour is in
prev's row (a binary search there) and 1/q otherwise.  A round draws K
proposals (``k_prop_batch``) and takes the first accepted one; after
``n_rounds`` rounds without one the walker keeps the last proposal (the
bounded-trials fallback, proportional to weight).  Step 0 is first-order
and accepts every proposal; p = q = 1 accepts every proposal and skips the
searches; a degree-1 vertex whose one neighbour is prev moves back at once,
with no draw; a vertex of degree 0 ends the walk (-1 after it).

Every uniform is keyed on (seed, global walker id, counter): proposal k of a
round uses counters ``(att + k) * 4 + {0, 1, 2, 3}``, and ``att`` advances by
K only while the walker attempts, so a walker's draws do not depend on the
others, the chunking or the padding.

``csr_walk_chunk`` launches kernel K12 (``csrc/csr_walk.cu``) for CUDA
tensors and runs ``csr_walk_chunk_plain``, the JAX program op for op in
plain PyTorch, for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from node2vec_torch import _build
from node2vec_torch.ops.hashrng import hash_uniform
from node2vec_torch.ops.sampling import contains_in_segments, searchsorted_in_segments

SECTOR = 8  # 4-byte entries per 32-byte sector (the traffic counts of ``stats``)


def proposal_rounds(return_param: float, inout_param: float, max_trials: int) -> Tuple[int, int]:
    """(K proposals a round, rounds) as engine.py:123-129 sizes them.
    Python's ``round`` rounds half to even: q = 5 gives K = 2."""
    inv_q = 1.0 / inout_param
    alpha2_max, alpha2_min = max(1.0, inv_q), min(1.0, inv_q)
    kb = int(min(8, max(1, round((alpha2_max / alpha2_min) / 2))))
    return kb, max(1, -(-max_trials // kb))


def search_iters(max_degree: int) -> int:
    """Binary-search depth of the CSR engine (engine.py:336)."""
    return max(1, int(np.ceil(np.log2(max_degree + 1))) + 1)


def _mark(stats: Optional[dict], key: str, idx: torch.Tensor) -> None:
    if stats is not None and idx.numel():
        stats[key][idx.long() // SECTOR] = True


def csr_walk_chunk_plain(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    weights: torch.Tensor,
    alias: torch.Tensor,
    prob: torch.Tensor,
    wtot: torch.Tensor,
    starts: torch.Tensor,
    gid_base: int,
    seed: int,
    *,
    walk_length: int,
    return_param: float,
    inout_param: float,
    max_trials: int,
    search_iters: int,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """``walk_chunk_impl`` op for op: paths [W, walk_length + 1] int32.

    ``stats``, when given, gains boolean masks over the 32-byte sectors of
    "indptr", "indices", "weights", "alias", "prob" and "wtot" that the run
    reads (the reads a walker makes up to its accepted proposal), for a
    bound on the kernel's traffic.
    """
    dev = starts.device
    n_w = starts.shape[0]
    n_e = indices.shape[0]
    last_e = max(n_e - 1, 0)
    seed = seed & 0xFFFFFFFF
    inv_p = torch.tensor(np.float32(1.0 / return_param), device=dev)
    inv_q = torch.tensor(np.float32(1.0 / inout_param), device=dev)
    alpha2_max = torch.tensor(np.float32(max(1.0, 1.0 / inout_param)), device=dev)
    one = torch.tensor(1.0, dtype=torch.float32, device=dev)
    uniform_bias = return_param == 1.0 and inout_param == 1.0
    kb, n_rounds = proposal_rounds(return_param, inout_param, max_trials)
    if stats is not None:
        for key, t in (("indptr", indptr), ("indices", indices), ("weights", weights),
                       ("alias", alias), ("prob", prob), ("wtot", wtot)):
            stats.setdefault(key, torch.zeros(t.shape[0] // SECTOR + 1, dtype=torch.bool,
                                              device=dev))
    gid_col = torch.arange(gid_base, gid_base + n_w, dtype=torch.int64, device=dev)[:, None]
    k_ctr = torch.arange(kb, dtype=torch.int64, device=dev)[None, :]
    k_iota = k_ctr.expand(n_w, kb)
    lanes = torch.arange(n_w, device=dev)

    alive = starts >= 0
    paths = torch.full((n_w, walk_length + 1), -1, dtype=torch.int32, device=dev)
    paths[:, 0] = torch.where(alive, starts, -1)
    if n_e == 0:  # no vertex has a neighbour: every walk ends at its start
        return paths
    cur = torch.where(alive, starts, 0).long()
    prev = torch.full((n_w,), -1, dtype=torch.int64, device=dev)
    att = torch.zeros(n_w, dtype=torch.int64, device=dev)
    for t in range(walk_length):
        cur_safe = torch.where(alive, cur, 0)
        seg_start = indptr[cur_safe].long()
        degree = indptr[cur_safe + 1].long() - seg_start
        _mark(stats, "indptr", torch.cat([cur_safe[alive], cur_safe[alive] + 1]))
        alive = alive & (degree > 0)
        prev_safe = torch.where(prev >= 0, prev, 0)
        prev_start = indptr[prev_safe].long()
        prev_degree = indptr[prev_safe + 1].long() - prev_start
        first_order = prev < 0
        safe_deg = torch.clamp(degree, min=1)

        if uniform_bias:
            m1 = torch.zeros(n_w, dtype=torch.float32, device=dev)
            only_back = torch.zeros(n_w, dtype=torch.bool, device=dev)
        else:
            pos = searchsorted_in_segments(prev_safe, seg_start, degree, indices, search_iters)
            pos_safe = pos.clamp(0, last_e)
            has_back = ((pos < seg_start + degree) & (indices[pos_safe].long() == prev_safe)
                        & ~first_order)
            w_back = torch.where(has_back, weights[pos_safe], 0.0)
            m1 = w_back * inv_p
            only_back = has_back & (degree == 1)
            if stats is not None:  # the back-edge search of the biased steps (t >= 1)
                b = alive & ~first_order
                _mark(stats, "indptr", torch.cat([prev_safe[b], prev_safe[b] + 1]))
                _mark(stats, "indices", _search_reads(prev_safe[b], seg_start[b], degree[b],
                                                      indices, search_iters))
                _mark(stats, "weights", pos_safe[alive & has_back])
        _mark(stats, "wtot", cur_safe[alive])
        m2 = wtot[cur_safe] * alpha2_max
        p_branch1 = m1 / torch.clamp(m1 + m2, min=1e-30)

        cand = torch.where(only_back, prev, 0)
        accepted = only_back.clone()
        for _ in range(n_rounds):
            attempting = alive & ~accepted
            if not bool(attempting.any()):
                break
            ctr = (att[:, None] + k_ctr) * 4
            r1 = hash_uniform(seed, gid_col, ctr)
            r2 = hash_uniform(seed, gid_col, ctr + 1)
            deg_b = safe_deg[:, None]
            slot = torch.minimum((r1 * deg_b.to(torch.float32)).to(torch.int64), deg_b - 1)
            e = (seg_start[:, None] + slot).clamp(0, last_e)
            keep = r2 < prob[e]
            j = torch.where(keep, slot, alias[e].long())
            col = (seg_start[:, None] + j).clamp(0, last_e)
            proposal = indices[col].long()
            if uniform_bias:
                accept_now = torch.ones((n_w, kb), dtype=torch.bool, device=dev)
            else:
                take_back = hash_uniform(seed, gid_col, ctr + 2) < p_branch1[:, None]
                proposal = torch.where(take_back, prev[:, None], proposal)
                is_return = proposal == prev[:, None]
                p_start = prev_start[:, None].expand(n_w, kb)
                p_degree = prev_degree[:, None].expand(n_w, kb)
                is_shared = contains_in_segments(
                    proposal.reshape(-1), p_start.reshape(-1), p_degree.reshape(-1), indices,
                    search_iters,
                ).reshape(n_w, kb)
                bias2 = torch.where(is_shared, one, inv_q)
                u = hash_uniform(seed, gid_col, ctr + 3)
                accept_now = torch.where(take_back, True, ~is_return & (u * alpha2_max <= bias2))
                accept_now = torch.where(first_order[:, None], True, accept_now)
            any_new = accept_now.any(dim=1)
            first_idx = torch.argmax(accept_now.to(torch.int8), dim=1)
            chosen = proposal[lanes, first_idx]
            fallback = proposal[:, kb - 1]
            if stats is not None:
                # the proposals a walker draws: up to its first accepted one
                drawn = attempting[:, None] & ((k_iota <= first_idx[:, None]) | ~any_new[:, None])
                _mark(stats, "prob", e[drawn])
                _mark(stats, "alias", e[drawn & ~keep])
                _mark(stats, "indices", col[drawn])
                if not uniform_bias:  # membership of a biased step's non-return proposals
                    m = drawn & ~take_back & ~is_return & ~first_order[:, None]
                    _mark(stats, "indices", _search_reads(proposal[m], p_start[m], p_degree[m],
                                                          indices, search_iters))
            cand = torch.where(accepted, cand, torch.where(any_new, chosen, fallback))
            att = torch.where(attempting, att + kb, att)
            accepted = accepted | any_new

        paths[:, t + 1] = torch.where(alive, cand, -1).to(torch.int32)
        prev = torch.where(alive, cur, prev)
        cur = torch.where(alive, cand, cur)
    return paths


def _search_reads(values, start, length, indices, n_iters) -> torch.Tensor:
    """The positions of ``indices`` that membership tests of ``values`` read
    (the probes, then the lower bound where it lies in the segment)."""
    probes: list = []
    contains_in_segments(values, start, length, indices, n_iters, probes)
    return torch.cat(probes) if probes else values.new_zeros(0)


def csr_walk_chunk(
    indptr: torch.Tensor,  # [V+1] int32
    indices: torch.Tensor,  # [E] int32, sorted per row
    weights: torch.Tensor,  # [E] float32
    alias: torch.Tensor,  # [E] int32
    prob: torch.Tensor,  # [E] float32
    wtot: torch.Tensor,  # [V] float32
    starts: torch.Tensor,  # [W] int32, negative = dead lane
    gid_base: int,  # global id of lane 0 (chunk-invariant RNG)
    seed: int,
    *,
    walk_length: int,
    return_param: float,
    inout_param: float,
    max_trials: int,
    search_iters: int,
) -> torch.Tensor:
    """CSR walks: paths [W, walk_length + 1] int32, -1 after a walk ends.

    CPU tensors take the plain version; CUDA tensors launch K12 or raise.
    """
    ints, floats = (indptr, indices, alias, starts), (weights, prob, wtot)
    if any(x.dtype != torch.int32 for x in ints) or any(x.dtype != torch.float32 for x in floats):
        raise TypeError("csr_walk_chunk takes int32 indptr/indices/alias/starts and "
                        "float32 weights/prob/wtot")
    n_e = indices.shape[0]
    if (any(x.dim() != 1 for x in (*ints, *floats)) or weights.shape[0] != n_e
            or alias.shape[0] != n_e or prob.shape[0] != n_e
            or wtot.shape[0] != indptr.shape[0] - 1):
        raise ValueError("csr_walk_chunk takes indptr [V+1], indices/weights/alias/prob [E], "
                         "wtot [V] and starts [W]")
    if max_trials < 1 or search_iters < 1:
        raise ValueError("max_trials and search_iters must be >= 1")
    kw = dict(walk_length=walk_length, return_param=return_param, inout_param=inout_param,
              max_trials=max_trials, search_iters=search_iters)
    if not indptr.is_cuda:
        return csr_walk_chunk_plain(indptr, indices, weights, alias, prob, wtot, starts,
                                    gid_base, seed, **kw)
    _build.require_cuda("csr_walk", *ints, *floats)
    n_w = starts.shape[0]
    paths = torch.empty((n_w, walk_length + 1), dtype=torch.int32, device=starts.device)
    kb, n_rounds = proposal_rounds(return_param, inout_param, max_trials)
    rc = _build.lib().n2v_csr_walk(
        _build.ptr(indptr), _build.ptr(indices), _build.ptr(weights), _build.ptr(alias),
        _build.ptr(prob), _build.ptr(wtot), n_e, _build.ptr(starts), _build.ptr(paths), n_w,
        walk_length, int(gid_base), seed & 0xFFFFFFFF,
        float(np.float32(1.0 / return_param)), float(np.float32(1.0 / inout_param)),
        float(np.float32(max(1.0, 1.0 / inout_param))), kb, n_rounds, search_iters,
        int(return_param == 1.0 and inout_param == 1.0), _build.stream_of(starts),
    )
    _build.check(rc, "csr_walk")
    _build.launches["csr_walk"] += 1
    return paths
