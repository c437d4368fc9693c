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


def index_graph_pandas(df, indexed: bool = False):
    """DataFrame-level indexing (``node2vec_tpu/graph/indexer.py:73``).

    Input must have columns src/dst (+ optional weight, defaulted to 1.0).
    Returns (edges with int32 src/dst ids, name_id frame with columns
    [name, id]) — or (df, None) if already indexed.  pandas is imported
    here, by the one function that builds frames.
    """
    import pandas as pd

    if "src" not in df.columns or "dst" not in df.columns:
        raise ValueError(f"Input graph NOT in the right format: {list(df.columns)}")
    if "weight" not in df.columns:
        df = df.assign(weight=np.float32(1.0))
    if indexed:
        out = df[["src", "dst", "weight"]].copy()
        out["src"] = out["src"].astype(np.int32)
        out["dst"] = out["dst"].astype(np.int32)
        out["weight"] = out["weight"].astype(np.float32)
        return out, None
    src_ids, dst_ids, names = index_edges(df["src"].to_numpy(), df["dst"].to_numpy())
    edges = pd.DataFrame(
        {
            "src": src_ids,
            "dst": dst_ids,
            "weight": df["weight"].to_numpy().astype(np.float32),
        }
    )
    name_id = pd.DataFrame({"name": names, "id": np.arange(len(names), dtype=np.int32)})
    return edges, name_id
