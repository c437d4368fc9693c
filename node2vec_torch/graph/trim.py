"""Hotspot-vertex trimming (port of ``node2vec_tpu/graph/trim.py``).

Any vertex whose out-degree exceeds ``max_out_degree`` keeps a uniform
random sample of exactly ``max_out_degree`` of its out-edges.  The native
core and the numpy fallback draw different (equally uniform) subsets, so
equality with the JAX package needs the native core on both sides.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from node2vec_torch.constants import MAX_OUT_DEGREES


def trim_hotspot_edges(
    src: np.ndarray,
    dst: np.ndarray,
    weight: Optional[np.ndarray],
    max_out_degree: int = 0,
    random_seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Keep at most ``max_out_degree`` random out-edges per source vertex.

    Edge order within a kept group follows the random priority order (a uniform
    sample, like the reference's ``random.sample``); CSR construction re-sorts
    rows by dst afterwards so downstream results don't depend on it.
    """
    if max_out_degree <= 0:
        max_out_degree = MAX_OUT_DEGREES
    src = np.asarray(src)
    n = len(src)
    if n == 0:
        return src, np.asarray(dst), weight

    # only offender vertices' edges need the priority sort — hubs hold a
    # small fraction of edges, so restrict the O(n log n) work to them
    if np.issubdtype(src.dtype, np.integer) and src.min() >= 0:
        codes = src
    else:  # unindexed vertex names (strings): factorize first
        _, codes = np.unique(src, return_inverse=True)
    deg = np.bincount(codes, minlength=int(codes.max()) + 1 if n else 0)
    if (deg <= max_out_degree).all():
        return src, np.asarray(dst), weight
    from node2vec_torch import native

    if native.available():
        # parallel C++ path: per-vertex partial Fisher-Yates, deterministic
        # under the seed (a different uniform subset than the numpy fallback —
        # both valid; the reference's two paths likewise differ, SURVEY §2.6)
        seed_val = (
            random_seed
            if random_seed is not None
            else int(np.random.default_rng().integers(2**62))
        )
        keep = native.trim_hotspot(codes, len(deg), max_out_degree, seed_val)
        kept = np.flatnonzero(keep)  # ascending: original edge order preserved
        w = None if weight is None else np.asarray(weight)[kept]
        return src[kept], np.asarray(dst)[kept], w

    over = deg[codes] > max_out_degree
    idx = np.flatnonzero(over)  # edges of offender vertices only
    s_over = codes[idx]
    m = len(idx)

    rng = np.random.default_rng(random_seed)
    priority = rng.random(m)
    order = np.lexsort((priority, s_over))
    s_sorted = s_over[order]
    # rank of each edge within its src group (0-based)
    new_group = np.empty(m, dtype=bool)
    new_group[0] = True
    new_group[1:] = s_sorted[1:] != s_sorted[:-1]
    group_start = np.maximum.accumulate(np.where(new_group, np.arange(m), 0))
    rank = np.arange(m) - group_start
    keep_sorted = rank < max_out_degree
    kept = np.concatenate([np.flatnonzero(~over), idx[order[keep_sorted]]])
    kept.sort()  # preserve original edge order among survivors
    w = None if weight is None else np.asarray(weight)[kept]
    return src[kept], np.asarray(dst)[kept], w
