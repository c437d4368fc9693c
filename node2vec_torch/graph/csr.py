"""CSR graph containers (port of ``node2vec_tpu/graph/csr.py``).

The graph is four flat arrays (indptr/indices/weights + precomputed per-edge
alias tables) built on the host.  Neighbor lists are sorted ascending per
row, so the dense walk engine's packed rows are sorted too, and the CSR
engine's membership tests are binary searches.  ``Graph.to_device`` uploads
them, with each vertex's total out-weight, as a ``DeviceGraph``: only the
CSR walk engine (``walk/csr.py``) reads it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class DeviceGraph(NamedTuple):
    """Graph arrays as tensors on one device (int32 indptr: E < 2^31)."""

    indptr: torch.Tensor  # [V+1] int32
    indices: torch.Tensor  # [E] int32, sorted per row
    weights: torch.Tensor  # [E] float32
    alias: torch.Tensor  # [E] int32 segment-local alias slots
    prob: torch.Tensor  # [E] float32 alias keep-probabilities
    wtot: torch.Tensor  # [V] float32 per-vertex total out-weight

    @property
    def n_vertices(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.indices.shape[0]


@dataclasses.dataclass
class Graph:
    """Host-side CSR graph with precomputed first-order alias tables."""

    indptr: np.ndarray  # [V+1] int64
    indices: np.ndarray  # [E] int32, sorted ascending within each row
    weights: np.ndarray  # [E] float32
    alias: np.ndarray  # [E] int32
    prob: np.ndarray  # [E] float32
    names: Optional[np.ndarray] = None  # [V] original vertex names (None if pre-indexed)
    directed: bool = True

    @property
    def n_vertices(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    def out_degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def neighbors(self, v: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = self.indptr[v], self.indptr[v + 1]
        return self.indices[lo:hi], self.weights[lo:hi]

    def to_device(self, device="cuda") -> DeviceGraph:
        """The arrays on ``device`` (``resolve_device``: "cuda" unless the
        caller asks for the CPU); ``wtot`` is the float64 running sum's
        difference over each row, cast to float32, as the JAX package's."""
        from node2vec_torch.device import resolve_device

        if self.n_edges >= np.iinfo(np.int32).max:
            raise ValueError(
                "the single-device graph path requires E < 2^31 (int32 indptr); "
                "the sharded engines are ROADMAP Queue A item 12"
            )
        dev = resolve_device(device)
        cs = np.concatenate([[0.0], np.cumsum(self.weights, dtype=np.float64)])
        wtot = (cs[self.indptr[1:]] - cs[self.indptr[:-1]]).astype(np.float32)
        arrays = (
            (self.indptr, np.int32), (self.indices, np.int32), (self.weights, np.float32),
            (self.alias, np.int32), (self.prob, np.float32), (wtot, np.float32),
        )
        return DeviceGraph(*(torch.from_numpy(np.ascontiguousarray(a, dtype=t)).to(dev)
                             for a, t in arrays))

    def id_of(self, name) -> int:
        """Dense id of an original vertex name (binary search: names are sorted)."""
        if self.names is None:
            return int(name)
        i = int(np.searchsorted(self.names, name))
        if i >= len(self.names) or self.names[i] != name:
            raise KeyError(f"Unknown vertex name: {name!r}")
        return i

    def name_of(self, vid: int):
        return vid if self.names is None else self.names[vid]


def build_csr(
    src: np.ndarray,
    dst: np.ndarray,
    weight: Optional[np.ndarray],
    n_vertices: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR from an edge list; rows sorted by dst. Native C++ path when available."""
    from node2vec_torch import native

    if native.available():
        return native.build_csr(src, dst, weight, n_vertices)
    # numpy fallback: lexsort by (src, dst)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if len(src) and (src.min() < 0 or src.max() >= n_vertices or dst.min() < 0 or dst.max() >= n_vertices):
        raise ValueError("edge endpoint out of range")
    w = (
        np.ones(len(src), dtype=np.float32)
        if weight is None
        else np.asarray(weight, dtype=np.float32)
    )
    order = np.lexsort((dst, src))
    indices = dst[order]
    weights = w[order]
    counts = np.bincount(src, minlength=n_vertices).astype(np.int64)
    indptr = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, indices, weights


def mirror_dedup(
    src: np.ndarray, dst: np.ndarray, weight: Optional[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Undirected mirroring: union of both directions, (src,dst) deduplicated."""
    from node2vec_torch import native

    if native.available():
        return native.mirror_dedup(src, dst, weight)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    w = (
        np.ones(len(src), dtype=np.float32)
        if weight is None
        else np.asarray(weight, dtype=np.float32)
    )
    all_src = np.concatenate([src, dst])
    all_dst = np.concatenate([dst, src])
    all_w = np.concatenate([w, w])
    key = all_src.astype(np.int64) << 32 | all_dst.astype(np.uint32)
    _, first = np.unique(key, return_index=True)
    first.sort()
    return all_src[first], all_dst[first], all_w[first]


def from_edge_arrays(
    src: np.ndarray,
    dst: np.ndarray,
    weight: Optional[np.ndarray] = None,
    *,
    n_vertices: Optional[int] = None,
    names: Optional[np.ndarray] = None,
    directed: bool = True,
) -> Graph:
    """Build a Graph (CSR + alias tables) from already-indexed int edge arrays."""
    from node2vec_torch.ops.alias import build_alias_csr

    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if n_vertices is None:
        n_vertices = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    if not directed:
        src, dst, weight = mirror_dedup(src, dst, weight)
    indptr, indices, weights = build_csr(src, dst, weight, n_vertices)
    alias, prob = build_alias_csr(indptr, weights)
    return Graph(
        indptr=indptr,
        indices=indices,
        weights=weights,
        alias=alias,
        prob=prob,
        names=names,
        directed=directed,
    )
