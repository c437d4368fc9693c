"""Rank programs of the port's dense graph-sharded walk and distributed
build tests (tests/test_torch_edge_partitioned.py,
tests/test_torch_distributed_build.py), run by ``parallel.launch.spawn``
over gloo on the CPU.

This module imports neither jax nor the JAX package: the ranks run the
port alone.  ``programs`` reads its case from a pickle file and returns
numpy results, which the tests hold against the JAX package in their own
process.  A dense walk case carries the packed adjacency, the starts, the
walk settings and, for each data shard, the JAX walk's uniforms in
superstep order; a build case the whole edge list, of which each rank
takes its contiguous shard.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from node2vec_torch.graph import build_graph
from node2vec_torch.parallel import (
    edge_partitioned_blocked_walk,
    edge_partitioned_walk,
    make_mesh,
    partition_blocked_graph,
    partition_packed_adjacency,
)
from node2vec_torch.parallel.distributed_build import (
    assemble_partitioned,
    build_participant,
    run_distributed,
)

BUILD = dict(n_shards=None, directed=False, max_out_degree=48, random_seed=5)


def shard(a, nparts: int, pid: int):
    """Participant ``pid``'s contiguous shard of ``a`` (the shards
    concatenate in pid order to ``a``)."""
    cuts = np.linspace(0, len(a), nparts + 1).astype(np.int64)
    return a[cuts[pid]: cuts[pid + 1]]


def epd_walk(mesh, case: dict):
    """The dense graph-sharded walk of one case on ``mesh`` given JAX's
    draws of this rank's shard: (paths gathered over the data axis, the
    supersteps run, unfinished walkers summed over the data axis)."""
    n, d = mesh.shape["data"], mesh.coords["data"]
    padded, rps = partition_packed_adjacency(case["packed"], n)
    local = torch.from_numpy(padded[d * rps: (d + 1) * rps])
    draws = case["draws"][d]
    stats: dict = {}
    paths = edge_partitioned_walk(
        mesh, local, rps, torch.from_numpy(case["starts"]), case["seed"],
        walk_length=case["walk_length"], return_param=case["p"], inout_param=case["q"],
        capacity=case["capacity"], draws=lambda t: torch.from_numpy(draws[t]), stats=stats)
    unfinished = mesh.all_reduce_sum(torch.tensor([stats["unfinished"]]), "data")
    return mesh.all_gather(paths, "data").numpy(), stats["supersteps"], int(unfinished)


def _result(res) -> dict:
    keys = ("light", "biw", "bids", "brp", "indptr", "indices", "weights", "rev_enc", "pfx",
            "names", "name_base", "meta", "ranges", "pid")
    return {k: getattr(res, k) for k in keys}


def build(mesh, case: dict) -> dict:
    """``run_distributed`` of this rank's shard of each edge list, and the
    assembled shards walked by ``edge_partitioned_blocked_walk`` beside the
    monolithic partition's walk."""
    nparts, pid = mesh.n_devices, mesh.rank
    results = {name: run_distributed(build_participant(
        pid, nparts, shard(src, nparts, pid), shard(dst, nparts, pid), shard(w, nparts, pid),
        indexed=False, **BUILD), mesh) for name, (src, dst, w) in case["edges"].items()}
    out = {name: _result(res) for name, res in results.items()}
    src, dst, w = case["edges"]["int"]
    walk = case["walk"]
    starts = torch.from_numpy(walk["starts"])
    kw = dict(walk_length=walk["walk_length"], return_param=walk["p"], inout_param=walk["q"])
    assembled = assemble_partitioned(results["int"], mesh=mesh)
    g = build_graph((src, dst, w), indexed=False, directed=False,
                    max_out_degree=BUILD["max_out_degree"], random_seed=BUILD["random_seed"])
    mono = partition_blocked_graph(g.indptr, g.indices, g.weights, nparts, mesh=mesh,
                                   ranged_metadata=True)
    walks = []
    for pg in (assembled, mono):
        local, unfin, fb = edge_partitioned_blocked_walk(mesh, pg, starts, 0, walk["seed"], **kw)
        counts = mesh.all_reduce_sum(torch.stack([unfin, fb]), "data")
        walks.append((mesh.all_gather(local, "data").numpy(), int(counts[0]), int(counts[1])))
    out["walks"] = walks
    out["assembled_shards"] = assembled.shards
    return out


def programs(path: str) -> dict:
    """Every case of this world size on a (world × 1) mesh."""
    with open(path, "rb") as f:
        case = pickle.load(f)
    mesh = make_mesh(device="cpu")
    out = {"epd": {name: epd_walk(mesh, c) for name, c in case["epd"].items()}}
    if "build" in case:
        out["build"] = build(mesh, case["build"])
    return out
