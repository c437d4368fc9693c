"""Top-level pipeline (port of ``node2vec_tpu/api.py``): preprocess ->
random_walk -> fit -> embedding, on one device or over a mesh.

``Node2Vec`` runs on the card by default (``device="cuda"``) and raises when
CUDA is missing unless the caller passes ``device="cpu"``, which runs every
kernel's plain PyTorch version.  Graphs with a max degree above 256 walk on
the blocked engine (K5), as in the JAX package.  ``run_pipeline()`` streams
over a virtual corpus when it spans several walker chunks, trains from host
slabs with ``host_corpus=True``, and every stage resumes from
``checkpoint_dir``.  A trained model is kept with ``save_model`` and read
back with ``load_model`` (the JAX package's file; either package loads the
other's).  The functional forms ``trim_index`` and ``random_walk`` return
DataFrames, as the JAX package's do.  With ``mesh=`` (``parallel.make_mesh``,
called on every rank) the walks shard their walkers over the mesh's data
axis and ``fit`` trains with the tables' columns sharded over its model
axis, or with ``table_sharding="row"`` their rows over every rank
(``Word2VecTorch.fit_sharded``; ``run_pipeline`` then streams into
``fit_streaming_sharded``).  The graph-sharded walks of the JAX pipeline
are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import gc
import logging
from typing import Any, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from node2vec_torch.constants import MAX_OUT_DEGREES, Node2VecParams, Word2VecParams
from node2vec_torch.device import resolve_device
from node2vec_torch.embedding import Node2VecTorchEmbedding
from node2vec_torch.graph import Graph, build_graph, mirror_dedup, trim_hotspot_edges
from node2vec_torch.graph.indexer import index_graph_pandas
from node2vec_torch.models.word2vec import Word2VecTorch
from node2vec_torch.walk import WalkEngine
from node2vec_torch.walk.engine import random_walks as _random_walks_fn

logger = logging.getLogger(__name__)


class Node2Vec:
    """End-to-end node2vec on one device.

    >>> n2v = Node2Vec(n2v_params={"num_walks": 10, "walk_length": 20})
    >>> n2v.preprocess_input_graph(df, indexed=False, directed=False)
    >>> n2v.random_walk()
    >>> n2v.fit()
    >>> df_emb = n2v.embedding()
    """

    def __init__(
        self,
        n2v_params: Optional[Union[Node2VecParams, Mapping[str, Any]]] = None,
        w2v_params: Optional[Union[Word2VecParams, Mapping[str, Any]]] = None,
        max_out_degree: int = 0,
        random_seed: Optional[int] = None,
        profile: str = "fugue",
        checkpoint_dir: Optional[str] = None,
        walk_seed_vertices: Optional[np.ndarray] = None,
        mesh=None,
        graph_sharded: bool = False,
        table_sharding: str = "column",
        shared_lists="auto",
        host_corpus: bool = False,
        device="cuda",
    ):
        """``checkpoint_dir``: walk chunks, train state and streaming
        snapshots are saved there, and each stage resumes from them.

        ``host_corpus=True``: the walk corpus lives in host memory and
        training uploads globally shuffled slabs double-buffered
        (``Word2VecTorch.fit_host``), for corpora that do not fit on the
        card beside the tables.

        ``shared_lists`` is passed to ``WalkEngine``, as in the JAX package:
        True builds the blocked engine's per-edge shared-neighbour lists and
        walks with the exact 3-atom sampler at q != 1; "auto" (the default)
        and False walk without them (auto uses only a prebuilt table, which
        the pipeline never passes).

        ``mesh`` (``parallel.make_mesh``): walks shard their walkers over
        the mesh's data axis, and ``fit`` trains over the mesh
        (``Word2VecTorch.fit_sharded``); every rank runs the pipeline and
        ends with the whole model.  ``table_sharding`` picks the mesh
        trainer's table layout: "column" (the default) shards the tables'
        columns over the model axis; "row" shards their rows over every
        rank and routes them each step (SGNS, and hierarchical softmax,
        which a mesh trains only in this layout), and streams over a
        virtual corpus in ``run_pipeline``.  It is validated as in the JAX package, with or without a
        mesh.  ``graph_sharded=True`` (the edge-partitioned walks) raises
        ``NotImplementedError`` with a mesh, and ``ValueError`` without one
        when the walks start, as the JAX engine does."""
        if table_sharding not in ("column", "row"):
            raise ValueError(
                f"table_sharding must be 'column' or 'row', got {table_sharding!r}"
            )
        if host_corpus and mesh is not None:
            raise ValueError(
                "host_corpus is the single-device trainer path; on a mesh "
                "use table_sharding='row' (+ streaming) instead"
            )
        if graph_sharded and mesh is not None:
            raise NotImplementedError(
                "graph_sharded=True (the edge-partitioned walks) is not ported yet "
                "(ROADMAP Queue A item 12)"
            )
        self.mesh = mesh
        self.graph_sharded = graph_sharded
        self.checkpoint_dir = checkpoint_dir
        self.host_corpus = host_corpus
        self.device = resolve_device(device)
        if isinstance(n2v_params, Node2VecParams):
            self.n2v_params = n2v_params
        else:
            self.n2v_params = Node2VecParams.from_dict(n2v_params, profile=profile)
        if isinstance(w2v_params, Word2VecParams):
            self.w2v_params = w2v_params
        else:
            self.w2v_params = Word2VecParams.from_dict(w2v_params)
        self.max_out_degree = max_out_degree or MAX_OUT_DEGREES
        self.random_seed = random_seed if random_seed is not None else 0
        self.walk_seed_vertices = walk_seed_vertices
        self.shared_lists = shared_lists
        self.table_sharding = table_sharding
        self.graph: Optional[Graph] = None
        self.walks: Optional[np.ndarray] = None
        self.backend: Optional[Node2VecTorchEmbedding] = None
        self._engine: Optional[WalkEngine] = None

    # -- pipeline stages ---------------------------------------------------- #

    def preprocess_input_graph(
        self,
        data,
        indexed: bool = True,
        directed: bool = True,
        log1p_weight: bool = False,
    ) -> Graph:
        """Validate/index/trim and build the CSR graph.  ``data`` is a tuple
        of arrays (src, dst[, weight]), a path (.npz, .csv, .parquet or a
        whitespace edge list) or a DataFrame with src/dst[/weight]."""
        self.graph = build_graph(
            data,
            indexed=indexed,
            directed=directed,
            max_out_degree=self.max_out_degree,
            random_seed=self.random_seed,
            log1p_weight=log1p_weight,
        )
        self._engine = None  # packed tables belong to the previous graph
        logger.info(
            "graph preprocessed: %d vertices, %d edges",
            self.graph.n_vertices,
            self.graph.n_edges,
        )
        return self.graph

    def _walk_engine(self) -> WalkEngine:
        """Build once, reuse: the packed tables are p/q/seed independent."""
        if self._engine is None:
            self._engine = WalkEngine(
                self.graph, self.n2v_params, mesh=self.mesh, graph_sharded=self.graph_sharded,
                shared_lists=self.shared_lists, device=self.device,
            )
        return self._engine

    def _new_backend(self, walks=None) -> Node2VecTorchEmbedding:
        return Node2VecTorchEmbedding(
            df_walks=walks, name_id=self.graph.names if self.graph is not None else None,
            w2v_params=self.w2v_params, device=self.device,
        )

    def _stream_source_token(self, engine: WalkEngine) -> str:
        """Identity of the virtual walk corpus for streaming-checkpoint
        fingerprints (graph content, walk params, seed, engine), the JAX
        package's string."""
        starts = self.walk_seed_vertices
        return (
            f"{engine.graph_token}|{self.n2v_params!r}|{self.random_seed}|"
            f"{engine._strategy_token()}|"
            f"{None if starts is None else list(map(int, starts))}"
        )

    def random_walk(self) -> np.ndarray:
        """Generate the walk corpus as a host array."""
        if self.graph is None:
            raise RuntimeError("call preprocess_input_graph() first")
        self.walks = self._walk_engine().run(
            seed=self.random_seed, start_vertices=self.walk_seed_vertices,
            checkpoint_dir=self.checkpoint_dir,
        )
        logger.info("random walks done: %s", self.walks.shape)
        return self.walks

    def run_pipeline(
        self, verbose: bool = False, streaming: Optional[bool] = None
    ) -> Word2VecTorch:
        """Walks + training, the corpus kept off the host where it can be.

        With ``host_corpus=True`` the walks go to host memory, the engine's
        device tables are released, and ``fit_host`` trains from slabs.
        Otherwise ``streaming`` (default None: on when the corpus spans
        several walker chunks, as in the JAX package) trains over a virtual
        corpus: walk chunks regenerate on the device every epoch, chunk k+1
        enqueued while chunk k trains, and ``self.walks`` stays None.
        ``streaming=False`` walks the whole corpus on the device and trains
        on it in memory.
        """
        if self.graph is None:
            raise RuntimeError("call preprocess_input_graph() first")
        engine = self._walk_engine()
        self.backend = self._new_backend()
        n_v = self.graph.n_vertices
        if self.host_corpus:
            self.walks = engine.run(
                seed=self.random_seed, start_vertices=self.walk_seed_vertices,
                checkpoint_dir=self.checkpoint_dir,
            )
            # free the device graph tables before the slabs go up
            self._engine = None
            del engine
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            self.backend.model.fit_host(
                self.walks, n_vertices=n_v, verbose=verbose,
                checkpoint_dir=self.checkpoint_dir,
            )
            self.backend.walks = self.walks
            return self.backend.model
        n_chunks, _, source = engine.chunk_source(
            seed=self.random_seed, start_vertices=self.walk_seed_vertices
        )
        if streaming is None:
            # a mesh streams only with the row layout (the JAX package's rule)
            streaming = n_chunks > 1 and (self.mesh is None or self.table_sharding == "row")
        if streaming and self.mesh is None:
            self.backend.model.fit_streaming(
                source, n_chunks, n_v, verbose=verbose,
                checkpoint_dir=self.checkpoint_dir,
                source_token=self._stream_source_token(engine),
            )
            self.walks = None  # virtual corpus: regenerate with random_walk()
            return self.backend.model
        if streaming:
            self.backend.model.fit_streaming_sharded(
                source, n_chunks, self.mesh, n_v, table_sharding=self.table_sharding,
                verbose=verbose, checkpoint_dir=self.checkpoint_dir,
                source_token=self._stream_source_token(engine),
            )
            self.walks = None
            return self.backend.model
        walks_dev = engine.run_device(
            seed=self.random_seed, start_vertices=self.walk_seed_vertices
        )
        if self.mesh is not None:
            # the mesh trainer takes a host corpus (it shards the rows itself)
            self.walks = walks_dev.cpu().numpy()
            del walks_dev
            self.backend.model.fit_sharded(
                self.walks, self.mesh, n_vertices=n_v, verbose=verbose,
                table_sharding=self.table_sharding, checkpoint_dir=self.checkpoint_dir,
            )
            return self.backend.model
        self.backend.model.fit(
            walks_dev, n_vertices=n_v, verbose=verbose, checkpoint_dir=self.checkpoint_dir,
        )
        self.walks = walks_dev.cpu().numpy()
        return self.backend.model

    def fit(self, verbose: bool = False) -> Word2VecTorch:
        """Train embeddings over the walks (``fit_sharded`` with a mesh,
        ``fit_host`` with ``host_corpus=True``)."""
        if self.walks is None:
            raise RuntimeError("call random_walk() first")
        self.backend = self._new_backend(self.walks)
        # vocabulary covers every graph vertex even if rare ones fall below
        # min_count (they are masked, not renumbered)
        n_v = self.graph.n_vertices if self.graph else None
        model = self.backend.model
        if self.mesh is not None:
            model.fit_sharded(self.walks, self.mesh, n_vertices=n_v, verbose=verbose,
                              table_sharding=self.table_sharding,
                              checkpoint_dir=self.checkpoint_dir)
            return model
        trainer = model.fit_host if self.host_corpus else model.fit
        trainer(self.walks, n_vertices=n_v, verbose=verbose, checkpoint_dir=self.checkpoint_dir)
        return model

    def embedding(self, as_frame: bool = True):
        """Vectors mapped back to original names (see
        Node2VecTorchEmbedding.embedding)."""
        if self.backend is None:
            raise RuntimeError("model not fitted yet!")
        return self.backend.embedding(as_frame=as_frame)

    def get_vector(self, vertex_name: Union[str, int]) -> np.ndarray:
        if self.backend is None:
            raise RuntimeError("model not fitted yet!")
        return self.backend.get_vector(vertex_name)

    # -- persistence -------------------------------------------------------- #

    def save_model(self, cloud_path: str, model_name: str) -> None:
        if self.backend is None:
            raise RuntimeError("model not fitted yet!")
        self.backend.save_model(cloud_path, model_name)

    def load_model(self, cloud_path: str, model_name: str) -> Word2VecTorch:
        """A model file of either package, its tables on this run's device."""
        if self.backend is None:
            self.backend = Node2VecTorchEmbedding(w2v_params=self.w2v_params,
                                                  device=self.device)
        return self.backend.load_model(cloud_path, model_name)

    def save_vectors(self, cloud_path: str, file_name: str) -> None:
        if self.backend is None:
            raise RuntimeError("model not fitted yet!")
        self.backend.save_vectors(cloud_path, file_name)

    def load_vectors(self, cloud_path: str, file_name: str):
        """A word2vec text file as DataFrame[name, vector]."""
        if self.backend is None:
            self.backend = Node2VecTorchEmbedding(w2v_params=self.w2v_params,
                                                  device=self.device)
        return self.backend.load_vectors(cloud_path, file_name)


# --------------------------------------------------------------------------- #
# Functional forms (the JAX package's api.py:340-402)
# --------------------------------------------------------------------------- #


def trim_index(
    df,
    indexed: bool = False,
    directed: bool = False,
    max_out_deg: int = 0,
    random_seed: Optional[int] = None,
) -> Tuple[Any, Optional[Any]]:
    """Trim hotspot vertices, then index (fugue order): returns (edges
    DataFrame with int32 src/dst and float32 weight, name_id DataFrame or
    None).  Undirected graphs are mirrored after indexing."""
    import pandas as pd

    if "src" not in df.columns or "dst" not in df.columns:
        raise ValueError(f"Input graph NOT in the right format: {list(df.columns)}")
    w = df["weight"].to_numpy() if "weight" in df.columns else None
    src, dst, w = trim_hotspot_edges(
        df["src"].to_numpy(), df["dst"].to_numpy(), w, max_out_deg, random_seed
    )
    trimmed = pd.DataFrame({"src": src, "dst": dst})
    if w is not None:
        trimmed["weight"] = w
    edges, name_id = index_graph_pandas(trimmed, indexed=indexed)
    if not directed:
        s, d, wt = mirror_dedup(
            edges["src"].to_numpy(), edges["dst"].to_numpy(), edges["weight"].to_numpy()
        )
        edges = pd.DataFrame({"src": s, "dst": d, "weight": wt})
    return edges, name_id


def random_walk(
    df,
    n2v_params: Optional[Mapping[str, Any]] = None,
    walk_seed: Optional[np.ndarray] = None,
    random_seed: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    device="cuda",
):
    """Walk corpus as DataFrame[src, walk] from an indexed edge DataFrame
    (src/dst[/weight] int columns) or a prebuilt Graph, walked on
    ``device`` (the card unless the caller asks for the CPU)."""
    import pandas as pd

    graph = df if isinstance(df, Graph) else build_graph(df, indexed=True, directed=True)
    params = (
        n2v_params
        if isinstance(n2v_params, Node2VecParams)
        else Node2VecParams.from_dict(n2v_params)
    )
    walks = _random_walks_fn(
        graph,
        params,
        seed=random_seed if random_seed is not None else 0,
        start_vertices=walk_seed,
        device=device,
        checkpoint_dir=checkpoint_dir,
    )
    return pd.DataFrame(
        {"src": walks[:, 0], "walk": [row[row >= 0].tolist() for row in walks]}
    )
