"""Rank programs of the port's graph-sharded walk tests
(tests/test_torch_ep_blocked.py), run by ``parallel.launch.spawn`` over
gloo on the CPU.

This module imports neither jax nor the JAX package: the ranks run the
port alone.  ``programs`` reads its case (graphs as edge arrays, starts and
walk settings the test made) from a pickle file, runs every check of its
world size on a (world × 1) mesh, and returns numpy results, which the test
holds against the port's single-device blocked walk and the JAX package in
its own process.  ``hub_graph`` is the graph family of the JAX package's
``tests/test_blocked.py:_hub_graph``; the test builds both packages' graphs
from its edges.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from node2vec_torch import Node2Vec
from node2vec_torch.constants import Node2VecParams, Word2VecParams
from node2vec_torch.datasets import run_quality, synthetic_multilabel
from node2vec_torch.graph import from_edge_arrays
from node2vec_torch.parallel import (
    edge_partitioned_blocked_walk,
    load_partitioned_graph,
    make_mesh,
    partition_blocked_graph,
)
from node2vec_torch.walk import WalkEngine


def hub_edges(hub_deg: int = 600, seed: int = 0, with_far: bool = False,
              dyadic: bool = False):
    """(src, dst, w) of hub 0 with ``hub_deg`` out and in edges and a light
    ring (the hub spans several 256-wide blocks); ``with_far`` adds a vertex
    reachable from every ring vertex but not from the hub.  Weights uniform
    in [0.5, 2), as the JAX test graph's, or with ``dyadic`` in {0.5, 1, 2}
    (every partial sum exact, so both packages' prefix sums agree)."""
    rng = np.random.default_rng(seed)
    nbrs = np.arange(1, hub_deg + 1, dtype=np.int32)
    src = np.concatenate([np.zeros(hub_deg, np.int32), nbrs])
    dst = np.concatenate([nbrs, np.zeros(hub_deg, np.int32)])
    src = np.concatenate([src, nbrs, (nbrs % hub_deg) + 1])
    dst = np.concatenate([dst, (nbrs % hub_deg) + 1, nbrs])
    if with_far:
        far = np.int32(hub_deg + 1)
        src = np.concatenate([src, nbrs, [far]])
        dst = np.concatenate([dst, np.full(hub_deg, far, np.int32), [1]])
    if dyadic:
        w = rng.choice(np.float32([0.5, 1.0, 2.0]), len(src))
    else:
        w = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    return src, dst, w


def hub_graph(**kw):
    return from_edge_arrays(*hub_edges(**kw), directed=True)


def _load(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _walk(mesh, graph, starts: np.ndarray, walk: dict):
    """The ep walk of ``starts`` on ``mesh``, gathered: (paths, unfinished
    summed over the data axis, fallbacks summed)."""
    kw = {k: walk[k] for k in ("walk_length", "return_param", "inout_param", "max_trials",
                               "capacity", "slack") if k in walk}
    local, unfin, fb = edge_partitioned_blocked_walk(
        mesh, graph, torch.from_numpy(starts), walk.get("gid_base", 0), walk["seed"], **kw)
    counts = mesh.all_reduce_sum(torch.stack([unfin, fb]), "data")
    return mesh.all_gather(local, "data").numpy(), int(counts[0]), int(counts[1])


def programs(path: str) -> dict:
    """Every check at this process group's world size, on a (world × 1) mesh."""
    case = _load(path)
    mesh = make_mesh(device="cpu")
    n = mesh.shape["data"]
    graphs = {name: from_edge_arrays(*edges, directed=True)
              for name, edges in case["graphs"].items()}
    out: dict = {"walks": {}, "tables": {}}
    for name, (graph_name, starts, walk, ranged) in case["walks"].items():
        g = graphs[graph_name]
        pg = partition_blocked_graph(g.indptr, g.indices, g.weights, n, mesh=mesh,
                                     ranged_metadata=ranged)
        out["walks"][name] = _walk(mesh, pg, starts, walk)
    # this rank's shard of the partition on the mesh
    g = graphs["hub"]
    pg = partition_blocked_graph(g.indptr, g.indices, g.weights, n, mesh=mesh)
    out["tables"]["partition"] = [t.numpy() for t in pg[:4]] + [pg.shards]
    # the engine on the JAX package's saved shards of its graph, and packing its own
    walk = case["engine_walk"]
    g = graphs[walk["graph"]]
    params = Node2VecParams(**walk["params"])
    loaded = load_partitioned_graph(case["jax_saved"], mesh=mesh)
    out["tables"]["jax_saved"] = [t.numpy() for t in loaded[:4]] + [loaded.shards]
    out["engine_loaded"] = WalkEngine(g, params, mesh=mesh, graph_sharded=True,
                                      partitioned_graph=loaded,
                                      device="cpu").run(seed=walk["seed"])
    eng = WalkEngine(g, params, mesh=mesh, graph_sharded=True, device="cpu")
    out["engine"] = (eng.strategy, eng._strategy_token(), eng.run(seed=walk["seed"]),
                     eng.unfinished_count, eng.fallback_count, list(eng.superstep_counts))
    if "pipeline" in case:
        pipe = case["pipeline"]
        src, dst, w = case["graphs"]["hub"]
        for layout in ("column", "row"):
            n2v = Node2Vec(n2v_params=pipe["n2v"], w2v_params=pipe["w2v"], mesh=mesh,
                           graph_sharded=True, table_sharding=layout, device="cpu")
            n2v.preprocess_input_graph((src, dst, w), indexed=True, directed=True)
            walks = n2v.random_walk()
            model = n2v.run_pipeline()
            out[f"pipeline_{layout}"] = (walks, n2v._walk_engine().strategy, model.losses,
                                         model.vectors.copy())
    if "quality" in case:
        q = case["quality"]
        gq, labels = synthetic_multilabel(q["n"], seed=0)
        out["quality"] = run_quality(gq, labels, Node2VecParams(**q["n2v"]),
                                     Word2VecParams(**q["w2v"]), train_ratios=(0.5,),
                                     mesh=mesh, device="cpu")["micro_f1@0.5"]
    return out
