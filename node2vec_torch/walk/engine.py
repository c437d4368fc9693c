"""Chunked walk runner (port of ``node2vec_tpu/walk/engine.py``: the dense,
blocked and CSR strategies).

Replicates each start vertex ``num_walks`` times and sweeps fixed-size walker
chunks through a walk kernel: the dense engine (K1) when the max degree is
at most ``dense_max_degree``, the blocked engine (K5) above it, and, asked
for by ``strategy="csr"``, the CSR engine (K12, ``walk/csr.py``), which the
JAX package keeps as the reference-style fallback; its ``DeviceGraph`` is
uploaded at the first CSR chunk.  Semantics as in the JAX package: step 0
is first-order, sinks end walks (the path keeps its prefix, -1 after),
walks can be restricted to seed start vertices, and every draw is keyed on
(seed, global walker id, counter), so results do not depend on
``walker_chunk``.  ``run`` fetches the corpus to the host (with
``checkpoint_dir``, completed chunks are persisted and a restarted run
skips them), ``run_device`` keeps it on the device, and ``chunk_source``
regenerates any chunk on demand for the streaming trainer.

The blocked engine runs the shared-list 3-atom sampler as the JAX engine
does (``shared_lists``).  With a ``mesh`` (``parallel.make_mesh``) every
chunk is walked with its walkers sharded over the data axis
(``parallel.sharded_walk``) and gathered back, so ``run``, ``run_device``
and ``chunk_source`` give every rank the whole corpus, bit-equal to the
engine without a mesh.  The edge-partitioned engine (``graph_sharded``,
``partitioned_graph``, ``strategy="ep_blocked"``) raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from node2vec_torch.constants import Node2VecParams
from node2vec_torch.device import resolve_device
from node2vec_torch.graph.csr import DeviceGraph, Graph
from node2vec_torch.utils.checkpoint import (
    graph_digest,
    load_walk_chunks,
    save_walk_chunk,
    walk_fingerprint,
)
from node2vec_torch.utils.metrics import measure
from node2vec_torch.walk.blocked import (
    BlockedGraph,
    blocked_walk_chunk,
    build_blocked_graph,
    slq_or_dummy,
)
from node2vec_torch.walk.csr import csr_walk_chunk, search_iters
from node2vec_torch.walk.dense import build_padded_adjacency, dense_walk_chunk

_NOT_PORTED = {
    "ep_blocked": "the edge-partitioned walk engine is not ported yet (ROADMAP Queue A item 12)",
}
_GRAPH_SHARDED_NOT_PORTED = ("graph_sharded=True (the edge-partitioned walks) is not ported "
                             "yet (ROADMAP Queue A item 12)")


class WalkEngine:
    """Chunked walk runner over the dense, blocked or CSR sampler.

    ``graph``: a host ``Graph`` or a ``DeviceGraph`` (as the JAX engine
    takes).  ``blocked_graph``: prebuilt blocked tables to reuse across
    engines over the same graph (host packing and upload of a
    multi-million-edge graph take seconds; p, q and the trial cap live in
    the kernel, not the tables).  ``mesh``: walk every chunk sharded over
    its data axis; the engine's device is the mesh's.  ``shared_lists``: the blocked engine's
    exact 3-atom sampler, as in the JAX engine.  True builds the per-edge
    lists and uses them; "auto" (the default) uses only a prebuilt table
    (``blocked_graph=``) whose overflow weight fraction is <= 0.15, and never
    builds one; False never uses them.  ``graph_sharded=True`` needs a mesh, as
    in the JAX package (``ValueError`` without one); ``partitioned_graph``
    is read only by the graph-sharded engine.
    """

    def __init__(
        self,
        graph: Union[Graph, DeviceGraph],
        params: Node2VecParams,
        strategy: str = "auto",
        dense_max_degree: int = 256,
        mesh=None,
        graph_sharded: bool = False,
        partitioned_graph=None,
        blocked_graph: Optional[BlockedGraph] = None,
        shared_lists="auto",
        device="cuda",
    ):
        if graph_sharded and mesh is None:
            raise ValueError("graph_sharded=True requires a mesh")
        if graph_sharded:
            raise NotImplementedError(_GRAPH_SHARDED_NOT_PORTED)
        self.device = resolve_device(device)
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"the mesh runs on {mesh.device}, the engine on {self.device}")
        self.mesh = mesh
        self.params = params
        self.n_vertices = int(graph.n_vertices)
        if isinstance(graph, Graph):
            self._graph_host, self._dgraph = graph, None
            indptr, indices, weights = graph.indptr, graph.indices, graph.weights
        else:
            self._graph_host, self._dgraph = None, graph
            indptr, indices, weights = (np.asarray(t.cpu()) for t in
                                        (graph.indptr, graph.indices, graph.weights))
            indptr = indptr.astype(np.int64)
        max_deg = int(np.max(np.diff(indptr))) if len(indptr) > 1 else 0
        self.max_degree = max_deg
        self.search_iters = search_iters(max_deg)
        if strategy == "auto":
            strategy = "dense" if max_deg <= dense_max_degree else "blocked"
        if strategy in _NOT_PORTED:
            raise NotImplementedError(_NOT_PORTED[strategy])
        if strategy not in ("dense", "blocked", "csr"):
            raise ValueError(f"unknown walk strategy {strategy!r}")
        self.strategy = strategy
        # checkpoint fingerprints change when the edges change, not just V
        self.graph_token = graph_digest(indices, weights)
        self._sl_policy = shared_lists
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
                build_padded_adjacency(indptr, indices, weights)
            ).to(self.device)
        elif strategy == "csr":
            if self._dgraph is not None:
                self._check_device("graph", self._dgraph.indptr)
        elif blocked_graph is not None:
            self._check_device("blocked_graph", blocked_graph.light)
            self.bgraph = blocked_graph
        else:
            self.bgraph = build_blocked_graph(indptr, indices, weights,
                                              shared_lists=shared_lists is True,
                                              device=self.device)

    def _check_device(self, name: str, t: torch.Tensor) -> None:
        if t.device.type != self.device.type or self.device.index not in (None, t.device.index):
            raise ValueError(f"{name} lies on {t.device}, the engine runs on {self.device}")

    @property
    def dgraph(self) -> DeviceGraph:
        """The CSR on the device, uploaded at first use: only the CSR
        strategy reads it."""
        if self._dgraph is None:
            self._dgraph = self._graph_host.to_device(self.device)
        return self._dgraph

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

    def _sl_flags(self) -> Tuple[bool, bool]:
        """(shared_lists, sl_exhaustive) for the blocked kernel, under the
        auto policy of the class docstring."""
        bg = self.bgraph
        if bg is None or bg.slq is None:
            return False, False
        pol = self._sl_policy
        on = pol if isinstance(pol, bool) else bg.sl_ovf_wfrac <= 0.15
        return on, on and bg.sl_exhaustive

    def _strategy_token(self) -> str:
        """Strategy string for walk fingerprints, as the JAX engine's: the
        applied shared-list flags change the walks at q != 1, so they are
        part of it ("+sl", "+slx"); at q == 1 the sampler is off."""
        tok = self.strategy
        if self.strategy == "blocked" and self.params.inout_param != 1.0:
            use_sl, sl_ex = self._sl_flags()
            if use_sl:
                tok += "+slx" if sl_ex else "+sl"
        return tok

    def _effective_chunk(self, n_total: int) -> int:
        chunk = min(self.params.walker_chunk, max(n_total, 1))
        if self.strategy == "dense":
            # bound the [W, P] working set: W * P <= 2^24 elements
            return min(chunk, max(1024, (1 << 25) // self.packed_adj.shape[1]))
        if self.strategy == "blocked":
            # bound the carried per-walker state (row + prev_mem + path, + the
            # shared-list row and its fetch when the sampler is on)
            per_walker = 6 * self.bgraph.light_width + self.params.walk_length
            if self._sl_flags()[0]:
                per_walker += 144
            return min(chunk, max(1024, (1 << 26) // per_walker))
        return chunk  # csr: no cap, as in the JAX engine

    def _run_chunk(
        self, chunk_starts: np.ndarray, gid_base: int = 0, seed: int = 0
    ) -> torch.Tensor:
        if self.mesh is not None:
            return self._run_chunk_sharded(chunk_starts, gid_base, seed)
        p = self.params
        starts = torch.from_numpy(chunk_starts).to(self.device)
        kw = dict(walk_length=p.walk_length, return_param=float(p.return_param),
                  inout_param=float(p.inout_param))
        if self.strategy == "dense":
            return dense_walk_chunk(self.packed_adj, starts, gid_base, seed & 0xFFFFFFFF, **kw)
        if self.strategy == "csr":
            g = self.dgraph
            return csr_walk_chunk(g.indptr, g.indices, g.weights, g.alias, g.prob, g.wtot, starts,
                                  gid_base, seed & 0xFFFFFFFF, max_trials=p.max_rejection_trials,
                                  search_iters=self.search_iters, **kw)
        bg = self.bgraph
        use_sl, sl_ex = self._sl_flags()
        paths, n_fb, n_att = blocked_walk_chunk(
            bg.light, bg.biw, bg.bids, bg.brp, starts, gid_base, seed & 0xFFFFFFFF,
            max_trials=p.max_rejection_trials, light_width=bg.light_width,
            block_width=bg.block_width, has_heavy=bg.has_heavy, slq=slq_or_dummy(bg),
            shared_lists=use_sl, sl_exhaustive=sl_ex, **kw,
        )
        self._fb_parts.append(n_fb)  # device scalars, drained lazily
        self._att_parts.append(n_att)
        return paths

    def _run_chunk_sharded(
        self, chunk_starts: np.ndarray, gid_base: int, seed: int
    ) -> torch.Tensor:
        """The chunk's walkers sharded over the mesh's data axis (the graph
        replicated), padded with dead lanes to a multiple of it; the rows
        gathered back over the data axis (node2vec_tpu/walk/engine.py:586)."""
        from node2vec_torch.parallel import sharded_walk

        mesh, p = self.mesh, self.params
        n = len(chunk_starts)
        n_pad = -(-n // mesh.shape["data"]) * mesh.shape["data"]
        padded = np.full(n_pad, -1, dtype=np.int32)
        padded[:n] = chunk_starts
        starts = torch.from_numpy(padded).to(self.device)
        kw = dict(walk_length=p.walk_length, return_param=float(p.return_param),
                  inout_param=float(p.inout_param))
        if self.strategy == "dense":
            local = sharded_walk.sharded_dense_walk_chunk(
                mesh, self.packed_adj, starts, gid_base, seed & 0xFFFFFFFF, **kw)
        elif self.strategy == "csr":
            g = self.dgraph
            local = sharded_walk.sharded_walk_chunk(
                mesh, g.indptr, g.indices, g.weights, g.alias, g.prob, g.wtot, starts, gid_base,
                seed & 0xFFFFFFFF, max_trials=p.max_rejection_trials,
                search_iters=self.search_iters, **kw)
        else:
            bg = self.bgraph
            use_sl, sl_ex = self._sl_flags()
            local, n_fb, n_att = sharded_walk.sharded_blocked_walk_chunk(
                mesh, bg.light, bg.biw, bg.bids, bg.brp, slq_or_dummy(bg), starts, gid_base,
                seed & 0xFFFFFFFF, max_trials=p.max_rejection_trials,
                light_width=bg.light_width, block_width=bg.block_width,
                has_heavy=bg.has_heavy, shared_lists=use_sl, sl_exhaustive=sl_ex, **kw)
            counts = mesh.all_reduce_sum(torch.stack([n_fb, n_att]), "data")
            self._fb_parts.append(counts[0])  # summed over the data shards
            self._att_parts.append(counts[1])
        return mesh.all_gather(local, "data")[:n]

    def _starts_one(self, start_vertices: Optional[np.ndarray]) -> np.ndarray:
        """The start vertices, one walk each."""
        if start_vertices is None:
            return np.arange(self.n_vertices, dtype=np.int32)
        starts_one = np.asarray(start_vertices, dtype=np.int32)
        if len(starts_one) and starts_one.max() >= self.n_vertices:
            raise ValueError(
                f"start vertex {int(starts_one.max())} >= n_vertices {self.n_vertices}"
            )
        return starts_one

    def _starts(self, start_vertices: Optional[np.ndarray]) -> np.ndarray:
        return np.tile(self._starts_one(start_vertices), self.params.num_walks)

    def _chunk_starts(self, starts: np.ndarray, lo: int, chunk: int) -> np.ndarray:
        """Chunk ``[lo, lo + chunk)`` of the walker starts, dead (-1) lanes
        past the end."""
        out = np.full(chunk, -1, dtype=np.int32)
        part = starts[lo: lo + chunk]
        out[: len(part)] = part
        return out

    def _chunks(self, seed: int, start_vertices: Optional[np.ndarray]):
        """Yield (lo, hi, device paths of the chunk's real rows)."""
        starts = self._starts(start_vertices)
        n_total = len(starts)
        chunk = self._effective_chunk(n_total)
        for lo in range(0, n_total, chunk):
            hi = min(lo + chunk, n_total)
            paths = self._run_chunk(self._chunk_starts(starts, lo, chunk), gid_base=lo, seed=seed)
            yield lo, hi, paths[: hi - lo]

    def run(
        self,
        seed: int = 0,
        start_vertices: Optional[np.ndarray] = None,
        checkpoint_dir: Optional[str] = None,
        timer=None,
    ) -> np.ndarray:
        """All walks as a host array [num_starts * num_walks, walk_length+1].

        Row layout: walk copy ``i`` of start vertex ``v`` is row
        ``i * num_starts + v``.  With ``checkpoint_dir``, each completed
        chunk is saved (the JAX package's file format and fingerprint) and
        a restarted run with the same configuration skips the chunks on
        disk.  On the card each chunk is copied to a pinned host buffer on
        a copy stream while the next chunk's kernel runs.  ``timer`` (a
        ``StepTimer``) records each walked chunk, with the fetch of the
        chunk before it, as "walk_chunk".
        """
        p = self.params
        starts_one = self._starts_one(start_vertices)
        starts = np.tile(starts_one, p.num_walks)
        n_total = len(starts)
        chunk = self._effective_chunk(n_total)
        fp = walk_fingerprint(p, seed, starts_one, self.n_vertices,
                              graph_token=self.graph_token, strategy=self._strategy_token())
        done = load_walk_chunks(checkpoint_dir, fingerprint=fp)
        out = np.empty((n_total, p.walk_length + 1), dtype=np.int32)
        fetch = _ChunkFetcher(self.device, (chunk, p.walk_length + 1))

        # with a mesh every rank holds the corpus; rank 0 alone writes it
        writer = self.mesh is None or self.mesh.rank == 0

        def persist(fetched) -> None:
            for c_idx, lo, hi in fetched:
                if checkpoint_dir and writer:
                    save_walk_chunk(checkpoint_dir, c_idx, out[lo:hi], fingerprint=fp)

        for c_idx, lo in enumerate(range(0, n_total, chunk)):
            hi = min(lo + chunk, n_total)
            if c_idx in done and done[c_idx].shape == (hi - lo, p.walk_length + 1):
                out[lo:hi] = done[c_idx]
                continue
            with measure(timer, "walk_chunk"):
                paths = self._run_chunk(self._chunk_starts(starts, lo, chunk), gid_base=lo,
                                        seed=seed)
                # the previous chunk reaches the host while this one walks
                persist(fetch.push(paths, (c_idx, lo, hi), out))
        persist(fetch.drain(out))
        return out

    def chunk_source(
        self,
        seed: int = 0,
        start_vertices: Optional[np.ndarray] = None,
    ) -> Tuple[int, int, Callable[[int], torch.Tensor]]:
        """Virtual-corpus interface: (n_chunks, chunk, source), where
        ``source(i)`` regenerates walk chunk i on the engine's device as a
        full ``chunk`` rows, the tail chunk padded with dead (-1) rows
        (streaming needs constant chunk shapes).  Chunks are pure functions
        of (seed, chunk index), so a corpus of any size streams through
        fixed device memory."""
        starts = self._starts(start_vertices)
        n_total = len(starts)
        chunk = self._effective_chunk(n_total)
        n_chunks = -(-n_total // chunk)

        def source(c_idx: int) -> torch.Tensor:
            lo = c_idx * chunk
            return self._run_chunk(self._chunk_starts(starts, lo, chunk), gid_base=lo, seed=seed)

        return n_chunks, chunk, source

    def run_device(
        self,
        seed: int = 0,
        start_vertices: Optional[np.ndarray] = None,
    ) -> torch.Tensor:
        """Like run(), but the walk corpus stays on the engine's device —
        feed it straight into Word2VecTorch.fit."""
        parts = [paths for _, _, paths in self._chunks(seed, start_vertices)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)


class _ChunkFetcher:
    """Walk chunks to a host array, one chunk behind the walk kernels.

    On the card chunk k is copied ``non_blocking`` into a pinned host
    buffer on a copy stream that waits for its kernel, so the copy runs
    while chunk k+1's kernel does; the host reads the buffer before the
    next copy is queued into it.  On the CPU the rows are copied at once."""

    def __init__(self, device: torch.device, shape: Tuple[int, int]):
        self.cuda = device.type == "cuda"
        self.pending = None  # (copy event, (c_idx, lo, hi))
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.pinned = torch.empty(shape, dtype=torch.int32, pin_memory=True)

    def push(self, paths: torch.Tensor, where, out: np.ndarray):
        """Start fetching ``paths`` (rows [0, hi - lo) go to out[lo:hi]);
        returns the chunks that reached ``out``, as (c_idx, lo, hi)."""
        c_idx, lo, hi = where
        if not self.cuda:
            out[lo:hi] = paths[: hi - lo].numpy()
            return [where]
        done = self.drain(out)  # frees the buffer this copy is about to use
        self.stream.wait_event(torch.cuda.current_stream(paths.device).record_event())
        with torch.cuda.stream(self.stream):
            self.pinned.copy_(paths, non_blocking=True)
            paths.record_stream(self.stream)
            self.pending = (self.stream.record_event(), where)
        return done

    def drain(self, out: np.ndarray):
        if self.pending is None:
            return []
        copied, (c_idx, lo, hi) = self.pending
        self.pending = None
        copied.synchronize()
        out[lo:hi] = self.pinned[: hi - lo].numpy()
        return [(c_idx, lo, hi)]


def random_walks(
    graph: Union[Graph, DeviceGraph],
    params: Optional[Node2VecParams] = None,
    seed: int = 0,
    start_vertices: Optional[np.ndarray] = None,
    device="cuda",
    checkpoint_dir: Optional[str] = None,
) -> np.ndarray:
    """Functional form: all walks of ``graph`` as a host array."""
    return WalkEngine(graph, params or Node2VecParams(), device=device).run(
        seed, start_vertices, checkpoint_dir
    )
