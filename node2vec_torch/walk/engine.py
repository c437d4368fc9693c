"""Chunked walk runner (port of ``node2vec_tpu/walk/engine.py``, dense strategy).

Replicates each start vertex ``num_walks`` times and sweeps fixed-size walker
chunks through the dense walk kernel.  Semantics as in the JAX package:
step 0 is first-order, sinks end walks (the path keeps its prefix, -1
after), walks can be restricted to seed start vertices, and every draw is
keyed on (seed, global walker id, step), so results do not depend on
``walker_chunk``.

Only the dense strategy is ported.  The blocked engine (max degree above
``dense_max_degree``), the CSR fallback, the edge-partitioned engine and
mesh sharding raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from node2vec_torch.constants import Node2VecParams
from node2vec_torch.device import resolve_device
from node2vec_torch.graph.csr import Graph
from node2vec_torch.walk.dense import build_padded_adjacency, dense_walk_chunk

_NOT_PORTED = {
    "blocked": "the blocked walk engine is not ported yet (ROADMAP Queue A item 6)",
    "csr": "the CSR fallback walk engine is not ported yet (ROADMAP Queue A item 10)",
    "ep_blocked": "the edge-partitioned walk engine is not ported yet (ROADMAP Queue A item 12)",
}


class WalkEngine:
    """Chunked walk runner over the dense padded-adjacency sampler."""

    def __init__(
        self,
        graph: Graph,
        params: Node2VecParams,
        strategy: str = "auto",
        dense_max_degree: int = 256,
        mesh=None,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded walks are not ported yet (ROADMAP Queue A item 12)"
            )
        self.device = resolve_device(device)
        self.params = params
        self.n_vertices = int(graph.n_vertices)
        indptr = graph.indptr
        max_deg = int(np.max(np.diff(indptr))) if len(indptr) > 1 else 0
        self.max_degree = max_deg
        if strategy == "auto":
            if max_deg > dense_max_degree:
                raise NotImplementedError(
                    f"max degree {max_deg} > dense_max_degree {dense_max_degree} "
                    f"needs the blocked engine: {_NOT_PORTED['blocked']}"
                )
            strategy = "dense"
        if strategy in _NOT_PORTED:
            raise NotImplementedError(_NOT_PORTED[strategy])
        if strategy != "dense":
            raise ValueError(f"unknown walk strategy {strategy!r}")
        self.strategy = strategy
        self.packed_adj = torch.from_numpy(
            build_padded_adjacency(indptr, graph.indices, graph.weights)
        ).to(self.device)

    def _effective_chunk(self, n_total: int) -> int:
        chunk = min(self.params.walker_chunk, max(n_total, 1))
        # bound the [W, P] working set: W * P <= 2^24 elements
        w_cap = max(1024, (1 << 25) // self.packed_adj.shape[1])
        return min(chunk, w_cap)

    def _run_chunk(
        self, chunk_starts: np.ndarray, gid_base: int = 0, seed: int = 0
    ) -> torch.Tensor:
        p = self.params
        return dense_walk_chunk(
            self.packed_adj,
            torch.from_numpy(chunk_starts).to(self.device),
            gid_base,
            seed & 0xFFFFFFFF,
            walk_length=p.walk_length,
            return_param=float(p.return_param),
            inout_param=float(p.inout_param),
        )

    def _starts(self, start_vertices: Optional[np.ndarray]) -> np.ndarray:
        if start_vertices is None:
            starts_one = np.arange(self.n_vertices, dtype=np.int32)
        else:
            starts_one = np.asarray(start_vertices, dtype=np.int32)
            if len(starts_one) and starts_one.max() >= self.n_vertices:
                raise ValueError(
                    f"start vertex {int(starts_one.max())} >= n_vertices {self.n_vertices}"
                )
        return np.tile(starts_one, self.params.num_walks)

    def _chunks(self, seed: int, start_vertices: Optional[np.ndarray]):
        """Yield (lo, hi, device paths of the chunk's real rows)."""
        starts = self._starts(start_vertices)
        n_total = len(starts)
        chunk = self._effective_chunk(n_total)
        for lo in range(0, n_total, chunk):
            hi = min(lo + chunk, n_total)
            chunk_starts = np.full(chunk, -1, dtype=np.int32)
            chunk_starts[: hi - lo] = starts[lo:hi]
            paths = self._run_chunk(chunk_starts, gid_base=lo, seed=seed)
            yield lo, hi, paths[: hi - lo]

    def run(
        self,
        seed: int = 0,
        start_vertices: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """All walks as a host array [num_starts * num_walks, walk_length+1].

        Row layout: walk copy ``i`` of start vertex ``v`` is row
        ``i * num_starts + v``.
        """
        n_total = len(self._starts(start_vertices))
        out = np.empty((n_total, self.params.walk_length + 1), dtype=np.int32)
        for lo, hi, paths in self._chunks(seed, start_vertices):
            out[lo:hi] = paths.cpu().numpy()
        return out

    def run_device(
        self,
        seed: int = 0,
        start_vertices: Optional[np.ndarray] = None,
    ) -> torch.Tensor:
        """Like run(), but the walk corpus stays on the engine's device —
        feed it straight into Word2VecTorch.fit."""
        parts = [paths for _, _, paths in self._chunks(seed, start_vertices)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)


def random_walks(
    graph: Graph,
    params: Optional[Node2VecParams] = None,
    seed: int = 0,
    start_vertices: Optional[np.ndarray] = None,
    device="cuda",
) -> np.ndarray:
    """Functional form: all walks of ``graph`` as a host array."""
    return WalkEngine(graph, params or Node2VecParams(), device=device).run(
        seed, start_vertices
    )
