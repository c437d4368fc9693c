"""Sampling primitives of the walk engines (port of
``node2vec_tpu/ops/sampling.py``).

``prefix_sums``: the JAX version is an upper-triangular-ones matmul at
HIGHEST precision for narrow rows, which is a cumsum in another summation
order.  On rows where every partial sum is exact (dyadic weights) the two
agree bit for bit.

``searchsorted_in_segments`` and ``contains_in_segments``: batched lower
bound and membership within sorted CSR segments, a fixed number of binary
search iterations each (the CSR engine's bias-class test, ``walk/csr.py``).
"""

from __future__ import annotations

from typing import List, Optional

import torch


def prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis."""
    return torch.cumsum(x, dim=-1)


def searchsorted_in_segments(
    values: torch.Tensor,
    start: torch.Tensor,
    length: torch.Tensor,
    sorted_data: torch.Tensor,
    n_iters: int = 32,
    probes: Optional[List[torch.Tensor]] = None,
) -> torch.Tensor:
    """Batched lower_bound of ``values[i]`` within
    ``sorted_data[start[i]:start[i]+length[i]]`` (ops/sampling.py:16).

    Returns int64 global positions (in [start, start+length]) of the first
    element >= value, after ``n_iters`` iterations (>= ceil(log2(max segment
    length)) gives the exact lower bound).  ``mid`` is clamped into the array
    for empty segments, as in the JAX version.  ``probes``, when given,
    gains the positions each iteration reads (of the lanes still searching).
    """
    lo = start.long()
    hi = lo + length.long()
    values = values.long()
    last = max(sorted_data.shape[0] - 1, 0)
    for _ in range(n_iters):
        mid = (lo + hi) >> 1
        mid_safe = mid.clamp(0, last)
        active = lo < hi
        if probes is not None:
            probes.append(mid_safe[active])
        go_right = sorted_data[mid_safe].long() < values
        lo, hi = (torch.where(active & go_right, mid + 1, lo),
                  torch.where(active & ~go_right, mid, hi))
    return lo


def contains_in_segments(
    values: torch.Tensor,
    start: torch.Tensor,
    length: torch.Tensor,
    sorted_data: torch.Tensor,
    n_iters: int = 32,
    probes: Optional[List[torch.Tensor]] = None,
) -> torch.Tensor:
    """Batched membership: is ``values[i]`` in the i-th sorted segment?
    (ops/sampling.py:46)."""
    pos = searchsorted_in_segments(values, start, length, sorted_data, n_iters, probes)
    in_range = pos < start.long() + length.long()
    pos_safe = pos.clamp(0, max(sorted_data.shape[0] - 1, 0))
    if probes is not None:
        probes.append(pos_safe[in_range])
    return in_range & (sorted_data[pos_safe].long() == values.long())
