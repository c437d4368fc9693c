"""Row-wise prefix sums for inverse-CDF sampling (port of
``node2vec_tpu/ops/sampling.prefix_sums``).

The JAX version is an upper-triangular-ones matmul at HIGHEST precision for
narrow rows, which is a cumsum in another summation order.  On rows where
every partial sum is exact (dyadic weights) the two agree bit for bit.
"""

from __future__ import annotations

import torch


def prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis."""
    return torch.cumsum(x, dim=-1)
