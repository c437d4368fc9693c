"""Vertex indexing: arbitrary vertex names -> dense int32 ids and back
(port of ``node2vec_tpu/graph/indexer.py``).

Sorted-unique id order, as in the JAX package.  Integer names go through the
native C++ core; other names through ``np.unique``, which gives the same ids
as the JAX package's pandas factorize path without importing pandas.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def index_edges(
    src: np.ndarray, dst: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Map arbitrary vertex names to dense ids.

    Returns (src_ids int32, dst_ids int32, names) where ``names[id]`` is the
    original vertex name (sorted ascending, so ids are deterministic).
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    if (
        np.issubdtype(src.dtype, np.integer)
        and np.issubdtype(dst.dtype, np.integer)
        and np.can_cast(src.dtype, np.int64)  # uint64 would wrap: fallback
        and np.can_cast(dst.dtype, np.int64)
    ):
        from node2vec_torch import native

        if native.available():
            # parallel C++ path (bit-compatible: sorted-unique order either way)
            src_ids, dst_ids, names = native.index_edges_i64(src, dst)
            out_dtype = np.result_type(src.dtype, dst.dtype)  # numpy concat rule
            if names.size and out_dtype != np.int64:
                names = names.astype(out_dtype)
            return src_ids, dst_ids, names
    all_names = np.concatenate([src, dst])
    names, inverse = np.unique(all_names, return_inverse=True)
    if len(names) > np.iinfo(np.int32).max:
        raise ValueError(f"Too many vertices for int32 ids: {len(names)}")
    inverse = inverse.reshape(-1).astype(np.int32)
    n = len(src)
    return inverse[:n], inverse[n:], names
