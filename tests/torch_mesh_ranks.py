"""Rank programs of the port's mesh tests (tests/test_torch_mesh.py,
tests/test_torch_sharded_sgns.py), run by ``parallel.launch.spawn`` over
gloo on the CPU.

This module imports neither jax nor the JAX package: the ranks run the
port alone.  Each program reads its case (numpy arrays and parameters the
test made, JAX's draws among them) from a pickle file, runs every check of
its world size, and returns numpy results, which the test holds against the
JAX package in its own process.
"""

from __future__ import annotations

import os
import pickle
import shutil

import numpy as np
import torch

from node2vec_torch import Node2Vec, convert
from node2vec_torch.constants import Node2VecParams, Word2VecParams
from node2vec_torch.datasets import synthetic_multilabel
from node2vec_torch.graph import from_edge_arrays
from node2vec_torch.models.vocab import subsample_walks
from node2vec_torch.models.word2vec import Word2VecTorch
from node2vec_torch.parallel import (
    col_sgns_epoch,
    initialize_distributed,
    make_mesh,
    sharded_blocked_walk_chunk,
    sharded_dense_walk_chunk,
    sharded_sgns_step,
    sharded_walk_chunk,
)
from node2vec_torch.walk import WalkEngine
from node2vec_torch.walk.csr import search_iters
from node2vec_torch.walk.dense import build_padded_adjacency


def _load(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _raises(fn, exc) -> str:
    """The message of ``exc`` raised by ``fn()``; fails when it does not raise."""
    try:
        fn()
    except exc as e:
        return str(e)
    raise AssertionError(f"{fn} did not raise {exc.__name__}")


def karate():
    """Zachary's karate club, (src, dst) of its 78 undirected edges."""
    edges = np.array([
        (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10),
        (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21), (0, 31), (1, 2),
        (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21), (1, 30), (2, 3),
        (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28), (2, 32), (3, 7),
        (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10), (5, 16), (6, 16),
        (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32), (14, 33),
        (15, 32), (15, 33), (18, 32), (18, 33), (19, 33), (20, 32), (20, 33),
        (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32), (23, 33),
        (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33),
        (28, 31), (28, 33), (29, 32), (29, 33), (30, 32), (30, 33), (31, 32),
        (31, 33), (32, 33),
    ], dtype=np.int32)
    return edges[:, 0], edges[:, 1]


def _tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


# --------------------------------------------------------------------------- #
# the mesh and the sharded walks
# --------------------------------------------------------------------------- #


def mesh_and_walks(path: str) -> dict:
    """make_mesh's coordinates and validation, then the three sharded walk
    functions and WalkEngine(mesh=) at every mesh shape of the case."""
    case = _load(path)
    world = torch.distributed.get_world_size()
    out = {"rank": torch.distributed.get_rank()}
    initialize_distributed("127.0.0.1:1", 99, 98)  # a no-op: the group exists
    out["too_big"] = _raises(lambda: make_mesh(world, 2, device="cpu"), ValueError)
    out["not_divisible"] = _raises(lambda: make_mesh(n_model=3, device="cpu"), ValueError)
    if world > 1:
        out["leaves_out"] = _raises(lambda: make_mesh(1, 1, device="cpu"), ValueError)
    src, dst, w = case["edges"]
    g = from_edge_arrays(src, dst, w, directed=True)
    packed = torch.from_numpy(build_padded_adjacency(g.indptr, g.indices, g.weights))
    dg = g.to_device("cpu")
    iters = search_iters(int(np.diff(g.indptr).max()))
    starts = torch.from_numpy(case["starts"])
    kw = dict(walk_length=case["walk_length"], return_param=case["p"], inout_param=case["q"])
    for shape in case["shapes"]:
        if shape[0] * shape[1] != world:
            continue
        mesh = make_mesh(*shape, device="cpu")
        res = {"coords": dict(mesh.coords), "shape": dict(mesh.shape),
               "axis_names": mesh.axis_names}
        res["dense"] = _np(sharded_dense_walk_chunk(mesh, packed, starts, case["gid_base"],
                                                    case["seed"], **kw))
        res["csr"] = _np(sharded_walk_chunk(
            mesh, dg.indptr, dg.indices, dg.weights, dg.alias, dg.prob, dg.wtot, starts,
            case["gid_base"], case["seed"], search_iters=iters, **kw))
        for name, (tables, bkw) in case["blocked"].items():
            bg = convert.blocked_graph_from_arrays(**tables, device="cpu")
            paths, n_fb, n_att = sharded_blocked_walk_chunk(
                mesh, *bg[:4], bg.slq, starts, case["gid_base"], case["seed"], **bkw, **kw)
            res[name] = (_np(paths), int(n_fb), int(n_att))
        params = Node2VecParams(**case["engine_params"])
        for strategy in ("dense", "blocked", "csr"):
            eng = WalkEngine(g, params, strategy=strategy, mesh=mesh, device="cpu",
                             shared_lists=strategy == "blocked")
            n_chunks, chunk, source = eng.chunk_source(seed=case["seed"])
            res["engine_" + strategy] = {
                "run": eng.run(seed=case["seed"]),
                "run_device": _np(eng.run_device(seed=case["seed"])),
                "tail_chunk": _np(source(n_chunks - 1)), "chunk": chunk,
                "fallback": eng.fallback_count, "attempts": eng.attempt_count,
            }
        out[_tag(shape)] = res
    return out


# --------------------------------------------------------------------------- #
# the column-sharded step and epoch
# --------------------------------------------------------------------------- #


def col_step_and_epoch(path: str) -> dict:
    """sharded_sgns_step and col_sgns_epoch at every mesh shape of the case,
    from JAX's state and with JAX's draws."""
    case = _load(path)
    world = torch.distributed.get_world_size()
    out = {}
    tabs = case["tables"]
    ns = [torch.from_numpy(case[k]) for k in ("ns_alias", "ns_prob", "mask")]
    kw = dict(window=case["window"], negatives=case["negatives"])
    for shape in case["shapes"]:
        if shape[0] * shape[1] != world:
            continue
        mesh = make_mesh(*shape, device="cpu")
        d = mesh.coords["data"]
        res = {"coords": dict(mesh.coords)}
        state = convert.from_reference_sharded_state(mesh, *tabs, device="cpu")
        walks = torch.from_numpy(case["walks"])
        b_local = walks.shape[0] // shape[0]
        draws = case["step_draws"][_tag(shape)][d]
        pairs = torch.zeros(())
        losses = []
        for k in range(case["n_steps"]):  # the same batch, the step's draws each time
            b_sh, r1, r2 = (torch.from_numpy(x) for x in draws[k])
            losses.append(float(sharded_sgns_step(
                mesh, state, walks[d * b_local: (d + 1) * b_local], b_sh, r1, r2,
                case["lr"], *ns, pairs=pairs, **kw)))
        res["step"] = ([_np(t) for t in state], losses, float(pairs))
        ep = case["epoch"][_tag(shape)]
        state = convert.from_reference_sharded_state(mesh, *tabs, device="cpu")
        corpus = torch.from_numpy(ep["corpus"])
        n_local = corpus.shape[0] // shape[0]
        step_draws = ep["draws"][d]
        losses = col_sgns_epoch(
            mesh, state, corpus[d * n_local: (d + 1) * n_local], torch.from_numpy(ep["perm"][d]),
            lambda gstep: tuple(torch.from_numpy(x) for x in step_draws[gstep]),
            ep["step0"], ep["lr0"], ep["lr_slope"], *ns, batch_local=ep["batch_local"],
            n_batches=ep["n_batches"], min_lr=ep["min_lr"], **kw)
        res["epoch"] = ([_np(t) for t in state], _np(losses))
        res["full"] = convert.to_reference_sharded_state(mesh, state)
        out[_tag(shape)] = res
    return out


# --------------------------------------------------------------------------- #
# fit_sharded: guards, training, K7's base, checkpoints across packages
# --------------------------------------------------------------------------- #


def fit_sharded_checks(path: str) -> dict:
    case = _load(path)
    out = {}
    walks = case["walks"]
    n_v = case["n_vertices"]
    w2v = case["w2v"]
    for shape in case["shapes"]:
        mesh = make_mesh(*shape, device="cpu")
        d = mesh.coords["data"]
        res = {}
        model = Word2VecTorch(Word2VecParams(**w2v), shared_negatives=16, device="cpu")
        model.fit_sharded(walks, mesh, n_vertices=n_v)
        res["fit"] = (model.losses, model.vectors.copy(), model.emb_out.copy())
        sampled = Word2VecTorch(Word2VecParams(**{**w2v, "sample": 1e-2, "max_iter": 2}),
                                shared_negatives=16, device="cpu")
        res["sampled"] = sampled.fit_sharded(walks, mesh, n_vertices=n_v).losses
        # K7 on this data shard's rows from their flat position in the corpus
        corpus = torch.from_numpy(case["sub_corpus"])
        n_local = corpus.shape[0] // shape[0]
        block = corpus[d * n_local: (d + 1) * n_local].contiguous()
        res["k7"] = _np(subsample_walks(block, torch.from_numpy(case["keep"]), 7, 2_500_003,
                                        base=d * n_local * corpus.shape[1]))
        guards = {}
        for name, kw, layout in (("cbow", {"sg": 0}, "column"), ("hs_column", {"negative": 0},
                                                                  "column")):
            m = Word2VecTorch(Word2VecParams(**{**w2v, **kw}), device="cpu")
            guards[name] = _raises(lambda: m.fit_sharded(walks, mesh, table_sharding=layout),
                                   ValueError)
        for name, kw in (("hs_row", {"negative": 0}), ("row", {})):  # the row layout trains
            m = Word2VecTorch(Word2VecParams(**{**w2v, **kw}), device="cpu")
            guards[name] = m.fit_sharded(walks, mesh, table_sharding="row").losses
        if shape[1] > 1:
            m = Word2VecTorch(Word2VecParams(**{**w2v, "vector_size": 33}), device="cpu")
            guards["dim"] = _raises(lambda: m.fit_sharded(walks, mesh), ValueError)
        res["guards"] = guards
        # checkpoints: JAX's file resumed (nothing left to train, then one
        # more epoch), and the port's file for JAX to resume
        e = case["jax_ckpt_epoch"]
        resumed = Word2VecTorch(Word2VecParams(**{**w2v, "max_iter": e}), shared_negatives=16,
                                device="cpu")
        resumed.fit_sharded(walks, mesh, n_vertices=n_v, checkpoint_dir=case["jax_ckpt"])
        res["resumed"] = (resumed.emb_in.copy(), resumed.emb_out.copy(), _np(resumed.acc_in),
                          _np(resumed.acc_out))
        more_dir = os.path.join(case["port_ckpt"], "more_" + _tag(shape))
        if mesh.rank == 0:  # training on writes the file: keep JAX's as it is
            shutil.copytree(case["jax_ckpt"], more_dir)
        mesh.barrier()
        more = Word2VecTorch(Word2VecParams(**{**w2v, "max_iter": e + 1}), shared_negatives=16,
                             device="cpu")
        res["resumed_more"] = more.fit_sharded(walks, mesh, n_vertices=n_v,
                                               checkpoint_dir=more_dir).losses
        port_dir = os.path.join(case["port_ckpt"], _tag(shape))
        written = Word2VecTorch(Word2VecParams(**{**w2v, "max_iter": 1}), shared_negatives=16,
                                device="cpu")
        written.fit_sharded(walks, mesh, n_vertices=n_v, checkpoint_dir=port_dir)
        res["written"] = (port_dir, written.emb_in.copy(), written.emb_out.copy())
        out[_tag(shape)] = res
    return out


# --------------------------------------------------------------------------- #
# Node2Vec(mesh=)
# --------------------------------------------------------------------------- #


def pipeline(path: str) -> dict:
    """Node2Vec(mesh=) on karate (random_walk, fit, embedding, run_pipeline),
    the quality graph's vectors, and the cases that still raise."""
    case = _load(path)
    mesh = make_mesh(*case["shape"], device="cpu")
    src, dst = karate()
    n2v = Node2Vec(n2v_params=case["n2v"], w2v_params=case["w2v"], random_seed=3, mesh=mesh,
                   device="cpu")
    n2v.preprocess_input_graph((src, dst), indexed=True, directed=False)
    out = {"walks": n2v.random_walk().copy()}
    model = n2v.fit()
    names, vectors = n2v.embedding(as_frame=False)
    out["fit"] = (model.losses, np.asarray(names), vectors.copy())
    model = n2v.run_pipeline()
    out["run_pipeline"] = (model.losses, model.vectors.copy(), n2v.walks.copy())
    g, _ = synthetic_multilabel(case["quality_n"], seed=0)
    q = Node2Vec(n2v_params=case["quality_n2v"], w2v_params=case["quality_w2v"], random_seed=0,
                 mesh=mesh, device="cpu")
    q.graph = g
    out["quality"] = q.run_pipeline().vectors.copy()
    # the row layout trains (fit_sharded "row", and run_pipeline streaming
    # into fit_streaming_sharded); what still raises (ROADMAP item 12), and
    # the host-corpus guard
    row = Node2Vec(n2v_params=case["n2v"], w2v_params=case["w2v"], mesh=mesh,
                   table_sharding="row", device="cpu")
    row.preprocess_input_graph((src, dst), indexed=True, directed=False)
    row.random_walk()
    out["row_fit"] = row.fit().losses
    streamed = Node2Vec(n2v_params={**case["n2v"], "walker_chunk": 16}, w2v_params=case["w2v"],
                        mesh=mesh, table_sharding="row", device="cpu")
    streamed.preprocess_input_graph((src, dst), indexed=True, directed=False)
    model = streamed.run_pipeline()
    out["row_streaming"] = (model.losses, model.vectors.copy(), streamed.walks)
    out["graph_sharded"] = _raises(
        lambda: Node2Vec(mesh=mesh, graph_sharded=True, device="cpu"), NotImplementedError)
    out["host_corpus"] = _raises(
        lambda: Node2Vec(mesh=mesh, host_corpus=True, device="cpu"), ValueError)
    return out


def programs(calls) -> list:
    """Several programs of this module in one spawn: ``calls`` is a list of
    (function name, case path); returns their results in order."""
    return [globals()[name](path) for name, path in calls]


def fail_on_rank(rank: int) -> int:
    """Raises on ``rank`` before the others reach a collective that would
    wait for it; returns the rank's number elsewhere."""
    if torch.distributed.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()
    return torch.distributed.get_rank()
