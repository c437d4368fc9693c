"""Graph ingestion: edge lists from DataFrames, arrays, or files -> Graph
(port of ``node2vec_tpu/graph/ingest.py``).

Validate schema, default weight to 1.0, optionally log1p-transform weights,
mirror for undirected graphs, trim hotspot vertices, index names to dense
ids, and build the CSR + alias tables.  Trim/mirror ordering follows the
native-spark path by default (mirror BEFORE trim); ``trim_before_mirror=True``
selects the fugue ordering.

pandas is imported only to read a text/CSV/parquet file; a DataFrame handed
in is recognised without importing pandas (whoever made it already did).
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

import numpy as np

from node2vec_torch.constants import MAX_OUT_DEGREES
from node2vec_torch.graph.csr import Graph, from_edge_arrays, mirror_dedup
from node2vec_torch.graph.indexer import index_edges
from node2vec_torch.graph.trim import trim_hotspot_edges


def _is_dataframe(data) -> bool:
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(data, pd.DataFrame)


def _load_edge_columns(
    data,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Normalize any supported input into (src, dst, weight-or-None) arrays."""
    if isinstance(data, str):
        ext = os.path.splitext(data)[1].lower()
        if ext in (".npz",):
            z = np.load(data, allow_pickle=True)
            return z["src"], z["dst"], (z["weight"] if "weight" in z else None)
        import pandas as pd

        if ext in (".parquet", ".pq"):
            data = pd.read_parquet(data)
        elif ext in (".csv",):
            data = pd.read_csv(data)
        else:  # whitespace-separated edge list: src dst [weight]
            data = pd.read_csv(
                data,
                sep=r"\s+",
                comment="#",
                header=None,
                names=["src", "dst", "weight"],
            )
            if data["weight"].isna().all():
                data = data[["src", "dst"]]
    if _is_dataframe(data):
        if "src" not in data.columns or "dst" not in data.columns:
            raise ValueError(
                f"Input graph NOT in the right format: {list(data.columns)}"
            )
        w = data["weight"].to_numpy() if "weight" in data.columns else None
        return data["src"].to_numpy(), data["dst"].to_numpy(), w
    if isinstance(data, tuple):
        if len(data) == 2:
            return np.asarray(data[0]), np.asarray(data[1]), None
        if len(data) == 3:
            return np.asarray(data[0]), np.asarray(data[1]), np.asarray(data[2])
    raise TypeError(f"Unsupported edge input type: {type(data)!r}")


def build_graph(
    data,
    *,
    indexed: bool = True,
    directed: bool = True,
    max_out_degree: int = 0,
    random_seed: Optional[int] = None,
    log1p_weight: bool = False,
    trim_before_mirror: bool = False,
) -> Graph:
    """Full ingest pipeline: load -> weight default -> [log1p] -> mirror/trim -> index -> CSR."""
    src, dst, weight = _load_edge_columns(data)
    if weight is None:
        weight = np.ones(len(src), dtype=np.float32)
    weight = np.asarray(weight, dtype=np.float32)
    if log1p_weight:
        weight = np.log1p(weight)
    if np.any(weight < 0):
        raise ValueError("negative edge weights are not supported")

    names = None
    if not indexed:
        src, dst, names = index_edges(src, dst)
    else:
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if len(src) and (src.min() < 0 or dst.min() < 0):
            raise ValueError("indexed vertex ids must be non-negative")
        if len(src) and max(src.max(), dst.max()) >= 2**31:
            raise ValueError(
                "indexed vertex ids must fit int32 (< 2^31); re-index with "
                "indexed=False to map arbitrary ids to dense int32"
            )
        src = src.astype(np.int32)
        dst = dst.astype(np.int32)

    if max_out_degree <= 0:
        max_out_degree = MAX_OUT_DEGREES

    if not directed and not trim_before_mirror:
        # native-spark ordering: mirror first, then trim
        src, dst, weight = mirror_dedup(src, dst, weight)
    src, dst, weight = trim_hotspot_edges(src, dst, weight, max_out_degree, random_seed)
    if not directed and trim_before_mirror:
        # fugue ordering: trim first, then mirror
        src, dst, weight = mirror_dedup(src, dst, weight)

    n_vertices = len(names) if names is not None else (
        int(max(src.max(initial=-1), dst.max(initial=-1))) + 1 if len(src) else 0
    )
    # Mirroring already happened above, so build directed; record the logical flag.
    g = from_edge_arrays(
        src, dst, weight, n_vertices=n_vertices, names=names, directed=True
    )
    g.directed = directed
    return g
