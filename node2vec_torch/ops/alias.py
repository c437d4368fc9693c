"""Alias tables and draws (port of ``node2vec_tpu/ops/alias.py``).

Host side: one (prob, alias) entry per edge, built once with the
reference's underfull/overfull LIFO-stack algorithm (the multithreaded C++
core when available, a per-vertex numpy loop otherwise), and the
reference's per-table constructors and scalar draws.  Device side: the batched
first-order draw ``alias_draw``, kernel K15 (``csrc/alias_draw.cu``) on
CUDA tensors and its plain PyTorch version on CPU tensors.  Unlike the JAX
version, which splits a key for its uniforms, it takes them as inputs.
"""

from __future__ import annotations

from typing import List, Sequence, Set, Tuple

import numpy as np
import torch

from node2vec_torch import _build


def generate_alias_tables(node_weights: Sequence[float]) -> Tuple[List[int], List[float]]:
    """(alias, probs) for one weight vector, as the reference builds them:
    probabilities normalized by the mean weight, the underfull/overfull
    stacks filled in index order and popped from the end."""
    n = len(node_weights)
    if n == 0:
        return [], []
    alias = [0] * n
    avg_weight = sum(node_weights) / n
    if avg_weight <= 0:
        raise ValueError(f"Non-positive total weight in {node_weights!r}")
    probs = [w / avg_weight for w in node_weights]

    underfull: List[int] = []
    overfull: List[int] = []
    for i in range(n):
        (underfull if probs[i] < 1.0 else overfull).append(i)

    while underfull and overfull:
        under, over = underfull.pop(), overfull.pop()
        alias[under] = over
        probs[over] = probs[over] + probs[under] - 1.0
        (underfull if probs[over] < 1.0 else overfull).append(over)
    return alias, probs


def generate_edge_alias_tables(
    src_id: int,
    src_nbs_id: Set[int],
    dst_neighbors: Tuple[Sequence[int], Sequence[float]],
    return_param: float = 1.0,
    inout_param: float = 1.0,
) -> Tuple[List[int], List[float]]:
    """Second-order (p/q-biased) alias table for one edge: weight/p for the
    back edge, weight for a shared neighbour, weight/q otherwise.  The walk
    engines never build these; they are the oracle of the walk tests."""
    if len(dst_neighbors) != 2 or len(dst_neighbors[0]) != len(dst_neighbors[1]):
        raise ValueError(f"Invalid neighbors tuple '{dst_neighbors}'!")
    if return_param == 0 or inout_param == 0:
        raise ValueError(
            f"Zero return ({return_param}) or inout ({inout_param}) parameter!"
        )
    biased: List[float] = []
    for nbr, weight in zip(dst_neighbors[0], dst_neighbors[1]):
        if nbr == src_id:
            biased.append(weight / return_param)
        elif nbr in src_nbs_id:
            biased.append(weight)
        else:
            biased.append(weight / inout_param)
    return generate_alias_tables(biased)


def _build_alias_csr_numpy(indptr: np.ndarray, weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy bulk alias build: one (alias, prob) entry per CSR edge."""
    n_edges = int(indptr[-1])
    alias = np.zeros(n_edges, dtype=np.int32)
    prob = np.ones(n_edges, dtype=np.float32)
    w = np.asarray(weights, dtype=np.float64)
    for v in range(len(indptr) - 1):
        lo, hi = int(indptr[v]), int(indptr[v + 1])
        deg = hi - lo
        if deg == 0:
            continue
        seg = w[lo:hi]
        probs = seg * (deg / seg.sum())
        a = np.zeros(deg, dtype=np.int32)
        underfull = [i for i in range(deg) if probs[i] < 1.0]
        overfull = [i for i in range(deg) if probs[i] >= 1.0]
        while underfull and overfull:
            under, over = underfull.pop(), overfull.pop()
            a[under] = over
            probs[over] = probs[over] + probs[under] - 1.0
            (underfull if probs[over] < 1.0 else overfull).append(over)
        alias[lo:hi] = a
        prob[lo:hi] = probs.astype(np.float32)
    return alias, prob


def build_alias_csr(indptr: np.ndarray, weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Bulk first-order alias tables over an entire CSR graph.

    Returns (alias[E] int32 — *segment-local* alias slots, prob[E] float32).
    """
    from node2vec_torch import native

    if native.available():
        return native.build_alias_csr(indptr, weights)
    return _build_alias_csr_numpy(np.asarray(indptr), np.asarray(weights))


def alias_draw_single(
    alias: Sequence[int], probs: Sequence[float], r1: float, r2: float
) -> int:
    """Two-uniform alias draw: slot floor(r1 * n), kept if r2 < prob, else
    its alias."""
    n = len(alias)
    i = min(int(r1 * n), n - 1)
    return i if r2 < probs[i] else int(alias[i])


def alias_draw_single_wiki(
    alias: Sequence[int], probs: Sequence[float], r: float
) -> int:
    """One-uniform alias draw: r * n split into the slot (integer part) and
    the coin (fractional part)."""
    n = len(alias)
    scaled = r * n
    i = min(int(scaled), n - 1)
    frac = scaled - i
    return i if frac < probs[i] else int(alias[i])


def alias_draw_plain(start, degree, r1, r2, alias, prob, indices) -> torch.Tensor:
    """ops/alias.py:165-194 given the uniforms: [W] int32 neighbour ids,
    -1 where the degree is 0 (the JAX version returns an unspecified id
    there, which its callers mask)."""
    live = degree > 0
    safe_deg = torch.clamp(degree, min=1)
    slot = torch.minimum((r1 * safe_deg).to(torch.int32), safe_deg - 1)
    e = torch.where(live, start + slot, 0).long()
    j = torch.where(r2 < prob[e], slot, alias[e])
    out = indices[torch.where(live, start + j, 0).long()]
    return torch.where(live, out, -1).to(torch.int32)


def alias_draw(start, degree, r1, r2, alias, prob, indices) -> torch.Tensor:
    """A first-order neighbour draw for each of W walkers: ``start`` and
    ``degree`` [W] int32 (each walker's CSR segment), ``r1``/``r2`` [W]
    float32 uniforms in [0, 1), ``alias``/``prob`` [E] the CSR alias tables
    (segment-local slots), ``indices`` [E] the CSR neighbour ids.  K15 for
    CUDA tensors, the plain version for CPU tensors."""
    args = (start, degree, r1, r2, alias, prob, indices)
    if not start.is_cuda:
        return alias_draw_plain(*args)
    _build.require_cuda("alias_draw", *args)
    if any(t.dtype != torch.int32 for t in (start, degree, alias, indices)):
        raise TypeError("alias_draw takes int32 start, degree, alias and indices")
    if any(t.dtype != torch.float32 for t in (r1, r2, prob)):
        raise TypeError("alias_draw takes float32 r1, r2 and prob")
    n = start.shape[0]
    if any(t.shape != (n,) for t in (degree, r1, r2)) or not (
            alias.shape == prob.shape == indices.shape and alias.dim() == 1):
        raise ValueError("alias_draw takes [W] start, degree, r1, r2 and [E] tables")
    out = torch.empty((n,), dtype=torch.int32, device=start.device)
    rc = _build.lib().n2v_alias_draw(
        *[_build.ptr(t) for t in args], n, _build.ptr(out), _build.stream_of(start),
    )
    _build.check(rc, "alias_draw")
    _build.launches["alias_draw"] += 1
    return out
