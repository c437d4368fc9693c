"""Chunked walk runner (port of ``node2vec_tpu/walk/engine.py``, dense and
blocked strategies).

Replicates each start vertex ``num_walks`` times and sweeps fixed-size walker
chunks through a walk kernel: the dense engine (K1) when the max degree is
at most ``dense_max_degree``, the blocked engine (K5) above it.  Semantics
as in the JAX package: step 0 is first-order, sinks end walks (the path
keeps its prefix, -1 after), walks can be restricted to seed start
vertices, and every draw is keyed on (seed, global walker id, counter), so
results do not depend on ``walker_chunk``.

The CSR fallback, the edge-partitioned engine, mesh sharding and the
blocked engine's shared-list sampler raise ``NotImplementedError`` naming
their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from node2vec_torch.constants import Node2VecParams
from node2vec_torch.device import resolve_device
from node2vec_torch.graph.csr import Graph
from node2vec_torch.walk.blocked import (
    SHARED_LISTS_NOT_PORTED,
    BlockedGraph,
    blocked_walk_chunk,
    build_blocked_graph,
)
from node2vec_torch.walk.dense import build_padded_adjacency, dense_walk_chunk

_NOT_PORTED = {
    "csr": "the CSR fallback walk engine is not ported yet (ROADMAP Queue A item 10)",
    "ep_blocked": "the edge-partitioned walk engine is not ported yet (ROADMAP Queue A item 12)",
}


class WalkEngine:
    """Chunked walk runner over the dense or the blocked sampler.

    ``blocked_graph``: prebuilt blocked tables to reuse across engines over
    the same graph (host packing and upload of a multi-million-edge graph
    take seconds; p, q and the trial cap live in the kernel, not the
    tables).  ``shared_lists`` keeps the JAX engine's signature: "auto" and
    False both run the rejection-bound sampler (the JAX "auto" resolves to
    False too); True asks for the shared-list sampler, which is not ported.
    """

    def __init__(
        self,
        graph: Graph,
        params: Node2VecParams,
        strategy: str = "auto",
        dense_max_degree: int = 256,
        mesh=None,
        device="cuda",
        blocked_graph: Optional[BlockedGraph] = None,
        shared_lists="auto",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded walks are not ported yet (ROADMAP Queue A item 12)"
            )
        if shared_lists is True:
            raise NotImplementedError(SHARED_LISTS_NOT_PORTED)
        self.device = resolve_device(device)
        self.params = params
        self.n_vertices = int(graph.n_vertices)
        indptr = graph.indptr
        max_deg = int(np.max(np.diff(indptr))) if len(indptr) > 1 else 0
        self.max_degree = max_deg
        if strategy == "auto":
            strategy = "dense" if max_deg <= dense_max_degree else "blocked"
        if strategy in _NOT_PORTED:
            raise NotImplementedError(_NOT_PORTED[strategy])
        if strategy not in ("dense", "blocked"):
            raise ValueError(f"unknown walk strategy {strategy!r}")
        self.strategy = strategy
        self.packed_adj = None
        self.bgraph = None
        # blocked engine: trial-capped accepts and sampling attempts, kept as
        # device scalars and read back only when the property is read
        self._fb_base = 0
        self._att_base = 0
        self._fb_parts: list = []
        self._att_parts: list = []
        if strategy == "dense":
            self.packed_adj = torch.from_numpy(
                build_padded_adjacency(indptr, graph.indices, graph.weights)
            ).to(self.device)
        elif blocked_graph is not None:
            bdev = blocked_graph.light.device
            if bdev.type != self.device.type or self.device.index not in (None, bdev.index):
                raise ValueError(
                    f"blocked_graph lies on {blocked_graph.light.device}, "
                    f"the engine runs on {self.device}"
                )
            self.bgraph = blocked_graph
        else:
            self.bgraph = build_blocked_graph(
                indptr, graph.indices, graph.weights, device=self.device
            )

    @property
    def fallback_count(self) -> int:
        """Trial-capped proportional-to-weight accepts (blocked engine).
        Reading drains the pending device counters (may block)."""
        if self._fb_parts:
            self._fb_base += int(torch.stack(self._fb_parts).sum())
            self._fb_parts = []
        return self._fb_base

    @fallback_count.setter
    def fallback_count(self, value: int) -> None:
        self._fb_parts = []
        self._fb_base = int(value)

    @property
    def attempt_count(self) -> int:
        """Total sampling attempts (blocked engine).  Reading drains the
        pending device counters (may block)."""
        if self._att_parts:
            self._att_base += int(torch.stack(self._att_parts).sum())
            self._att_parts = []
        return self._att_base

    @attempt_count.setter
    def attempt_count(self, value: int) -> None:
        self._att_parts = []
        self._att_base = int(value)

    def _effective_chunk(self, n_total: int) -> int:
        chunk = min(self.params.walker_chunk, max(n_total, 1))
        if self.strategy == "dense":
            # bound the [W, P] working set: W * P <= 2^24 elements
            w_cap = max(1024, (1 << 25) // self.packed_adj.shape[1])
        else:
            # bound the carried per-walker state (row + prev_mem + path)
            per_walker = 6 * self.bgraph.light_width + self.params.walk_length
            w_cap = max(1024, (1 << 26) // per_walker)
        return min(chunk, w_cap)

    def n_chunks(self, start_vertices: Optional[np.ndarray] = None) -> int:
        """How many walker chunks run() sweeps."""
        n_total = len(self._starts(start_vertices))
        return -(-n_total // self._effective_chunk(n_total))

    def _run_chunk(
        self, chunk_starts: np.ndarray, gid_base: int = 0, seed: int = 0
    ) -> torch.Tensor:
        p = self.params
        starts = torch.from_numpy(chunk_starts).to(self.device)
        kw = dict(walk_length=p.walk_length, return_param=float(p.return_param),
                  inout_param=float(p.inout_param))
        if self.strategy == "dense":
            return dense_walk_chunk(self.packed_adj, starts, gid_base, seed & 0xFFFFFFFF, **kw)
        bg = self.bgraph
        paths, n_fb, n_att = blocked_walk_chunk(
            bg.light, bg.biw, bg.bids, bg.brp, starts, gid_base, seed & 0xFFFFFFFF,
            max_trials=p.max_rejection_trials, light_width=bg.light_width,
            block_width=bg.block_width, has_heavy=bg.has_heavy, **kw,
        )
        self._fb_parts.append(n_fb)  # device scalars, drained lazily
        self._att_parts.append(n_att)
        return paths

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
