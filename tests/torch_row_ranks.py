"""Rank programs of the row-sharded tests (tests/test_torch_row_sharded.py),
run by ``parallel.launch.spawn`` over gloo on the CPU.

This module imports neither jax nor the JAX package: the ranks run the
port alone.  Each program reads its case (numpy arrays and parameters the
test made, JAX's draws and states among them) from a pickle file, runs
every check of its world size, and returns numpy results, which the test
holds against the JAX package in its own process.
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
from node2vec_torch.models import hsoftmax as hs
from node2vec_torch.models import skipgram as sg
from node2vec_torch.models.vocab import subsample_walks
from node2vec_torch.models.word2vec import Word2VecTorch
from node2vec_torch.parallel import make_mesh
from node2vec_torch.parallel import rowsharded_hs as rh
from node2vec_torch.parallel import rowsharded_sgns as rs
from node2vec_torch.walk import WalkEngine

from torch_mesh_ranks import karate


def _load(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------- #
# the routed steps and epochs, from JAX's state with JAX's draws
# --------------------------------------------------------------------------- #


def steps_and_epochs(path: str) -> dict:
    """row_sgns_step / row_hs_step (normal and forced-overflow capacities),
    row_sgns_epoch / row_hs_epoch, each from JAX's full tables, given JAX's
    draws; at world 1 also the single-device steps on the same draws."""
    case = _load(path)
    mesh = make_mesh(device="cpu")
    n, rank = mesh.n_devices, mesh.rank
    out = {"world": n}
    walks = _t(case["walks"])
    b_local = walks.shape[0] // n
    local = walks[rank * b_local: (rank + 1) * b_local].contiguous()
    noise = [_t(case[k]) for k in ("ns_alias", "ns_prob", "mask")]
    hs_tabs = [_t(case[k]) for k in ("points", "codes", "lengths")]
    mask = noise[2]
    kw = dict(window=case["window"])

    def full(state_fn, state):
        return [np.asarray(a) for a in state_fn(mesh, state)]

    res = {}
    for name, cap in case["sgns_caps"][n].items():
        state = convert.from_reference_row_state(mesh, *case["sgns_tables"], device="cpu")
        losses, drops = [], []
        for k in range(case["n_steps"]):
            b_sh, r1, r2 = (_t(x) for x in case["sgns_draws"][n][name][k][rank])
            loss, d = rs.row_sgns_step(mesh, state, local, b_sh, r1, r2, case["lr"], *noise,
                                       cap=cap, negatives=case["negatives"], **kw)
            losses.append(float(loss))
            drops.append(float(d))
        res[name] = (full(rs.row_state_to_host, state), losses, drops)
    out["sgns_step"] = res

    res = {}
    for name, (head, cap_in, cap_th) in case["hs_cases"][n].items():
        state = convert.from_reference_hs_row_state(mesh, *case["hs_tables"], device="cpu")
        losses, drops = [], []
        for k in range(case["n_steps"]):
            b_sh = _t(case["hs_draws"][n][name][k][rank])
            loss, d = rh.row_hs_step(mesh, state, local, b_sh, case["lr"], *hs_tabs, mask,
                                     cap_in=cap_in, cap_th=cap_th, head_offsets=head, **kw)
            losses.append(float(loss))
            drops.append(float(d))
        res[name] = (full(rh.hs_state_to_host, state), losses, drops)
    out["hs_step"] = res

    if n == 1:  # the routing is the identity: the single-device steps
        b_sh, r1, r2 = (_t(x) for x in case["sgns_draws"][1]["normal"][0][0])
        state = convert.from_reference_row_state(mesh, *case["sgns_tables"], device="cpu")
        got = rs.row_sgns_step(mesh, state, walks, b_sh, r1, r2, case["lr"], *noise,
                               cap=case["sgns_caps"][1]["normal"],
                               negatives=case["negatives"], **kw)[0]
        ref = list(convert.from_reference_state(*case["sgns_tables"], device="cpu"))
        want = sg.sgns_walk_step_plain(*ref, walks, b_sh, r1, r2, case["lr"], *noise,
                                       negatives=case["negatives"], **kw)
        out["sgns_identity"] = ([_np(t) for t in state[:4]], float(got),
                                [_np(t) for t in ref], float(want))
        res = {}
        for name, (head, cap_in, cap_th) in case["hs_cases"][1].items():
            b_sh = _t(case["hs_draws"][1][name][0][0])
            state = convert.from_reference_hs_row_state(mesh, *case["hs_tables"],
                                                        device="cpu")
            got = rh.row_hs_step(mesh, state, walks, b_sh, case["lr"], *hs_tabs, mask,
                                 cap_in=cap_in, cap_th=cap_th, head_offsets=head, **kw)[0]
            ref = list(convert.from_reference_state(*case["hs_tables"], device="cpu"))
            want = hs.hs_walk_step_plain(*ref, walks, b_sh, case["lr"], *hs_tabs, mask,
                                         head_offsets=head, **kw)
            res[name] = ([_np(t) for t in state[:4]], float(got), [_np(t) for t in ref],
                         float(want))
        out["hs_identity"] = res

    if n not in case["epoch"]:
        return out
    ep = case["epoch"][n]
    corpus = _t(case["corpus"])
    n_local = corpus.shape[0] // n
    block = corpus[rank * n_local: (rank + 1) * n_local].contiguous()
    perm = _t(ep["perm"][rank])
    common = dict(batch_local=ep["batch_local"], n_batches=ep["n_batches"],
                  min_lr=ep["min_lr"], **kw)
    state = convert.from_reference_row_state(mesh, *case["sgns_tables"], device="cpu")
    sd = ep["sgns_draws"][rank]
    losses, dropped = rs.row_sgns_epoch(
        mesh, state, block, perm, lambda g: tuple(_t(x) for x in sd[g]), ep["step0"],
        ep["lr0"], ep["lr_slope"], *noise, negatives=case["negatives"],
        shared_negatives=case["shared"], **common)
    out["sgns_epoch"] = (full(rs.row_state_to_host, state), _np(losses), float(dropped))
    state = convert.from_reference_hs_row_state(mesh, *case["hs_tables"], device="cpu")
    hd = ep["hs_draws"][rank]
    losses, dropped = rh.row_hs_epoch(
        mesh, state, block, perm, lambda g: _t(hd[g]), ep["step0"], ep["lr0"], ep["lr_slope"],
        *hs_tabs, mask, head_offsets=ep["head"], **common)
    out["hs_epoch"] = (full(rh.hs_state_to_host, state), _np(losses), float(dropped))
    return out


# --------------------------------------------------------------------------- #
# the trainers: fit_sharded("row"), checkpoints, K7, fit_streaming_sharded
# --------------------------------------------------------------------------- #


def _karate_graph():
    src, dst = karate()
    return from_edge_arrays(src, dst, directed=False)


class _Stop(Exception):
    pass


def _epoch_recorder():
    """A stand-in for ``Word2VecTorch._row_epoch`` that trains nothing and
    records each call's rows, step0, LR slope, batch_local, n_batches and
    step key; returns (it, the calls)."""
    calls = []

    def record(mesh, state, corpus, draws, step0, lr_slope, batch_local, n_batches, tables):
        calls.append((_np(corpus), step0, lr_slope, batch_local, n_batches, draws.key))
        return torch.zeros(n_batches), torch.zeros(())

    return record, calls


def trainers(path: str) -> dict:
    case = _load(path)
    mesh = make_mesh(device="cpu")
    rank, n = mesh.rank, mesh.n_devices
    out = {}
    walks = case["walks"]
    w2v = case["w2v"]

    def model(**kw):
        return Word2VecTorch(Word2VecParams(**{**w2v, **kw}), shared_negatives=16, device="cpu")

    for name, kw in (("sgns", {}), ("hs", {"negative": 0})):
        m = model(**kw)
        m.fit_sharded(walks, mesh, n_vertices=34, table_sharding="row")
        out["fit_" + name] = (m.losses, m.vectors.copy(), m.emb_out.copy())
    out["sampled"] = model(sample=1e-2, max_iter=2).fit_sharded(
        walks, mesh, n_vertices=34, table_sharding="row").losses

    # K7 on this rank's rows from their flat position: fit's contiguous
    # blocks and the streaming chunk's stride-interleaved rows
    corpus = _t(case["sub_corpus"])
    keep = _t(case["keep"])
    n_local = corpus.shape[0] // n
    length = corpus.shape[1]
    block = corpus[rank * n_local: (rank + 1) * n_local].contiguous()
    out["k7_block"] = _np(subsample_walks(block, keep, 7, 3_000_001, base=rank * n_local * length))
    inter = corpus[rank::n].contiguous()
    out["interleaved"] = _np(inter)
    out["k7_interleaved"] = _np(subsample_walks(inter.clone(), keep, 7, 10_000_003,
                                                base=rank * n_local * length))

    # train_state checkpoints: JAX's resumed (nothing left to train), the port's for JAX
    resumed = model(max_iter=1)
    resumed.fit_sharded(walks, mesh, n_vertices=34, table_sharding="row",
                        checkpoint_dir=case["jax_ckpt"])
    out["resumed"] = (resumed.emb_in.copy(), resumed.emb_out.copy(), _np(resumed.acc_in),
                      _np(resumed.acc_out))
    port_dir = os.path.join(case["port_ckpt"], "train")
    written = model(max_iter=1)
    written.fit_sharded(walks, mesh, n_vertices=34, table_sharding="row",
                        checkpoint_dir=port_dir)
    out["written"] = (port_dir, written.emb_in.copy(), written.emb_out.copy())

    # streaming over the engine's chunks, SGNS and HS; a run stopped mid-epoch
    # resumes from its snapshot and ends bit-equal to the uninterrupted one
    g = _karate_graph()
    eng = WalkEngine(g, Node2VecParams(**case["n2v"]), mesh=mesh, device="cpu")
    n_chunks, _, source = eng.chunk_source(seed=0)
    out["n_chunks"] = n_chunks
    for name, kw in (("sgns", {}), ("hs", {"negative": 0})):
        full = model(max_iter=2, **kw)
        full.fit_streaming_sharded(source, n_chunks, mesh, 34, source_token="karate")
        ck = os.path.join(case["port_ckpt"], "stream_" + name)
        calls = [0]

        def stopping(i):
            calls[0] += 1
            if calls[0] == case["stop_at_call"]:
                raise _Stop()
            return source(i)

        try:
            model(max_iter=2, **kw).fit_streaming_sharded(
                stopping, n_chunks, mesh, 34, checkpoint_dir=ck, checkpoint_every_chunks=2,
                source_token="karate")
            stopped = False
        except _Stop:
            stopped = True
        again = model(max_iter=2, **kw)
        again.fit_streaming_sharded(source, n_chunks, mesh, 34, checkpoint_dir=ck,
                                    checkpoint_every_chunks=2, source_token="karate")
        out["stream_" + name] = (full.losses, full.vectors.copy(), full.emb_out.copy(),
                                 again.losses, again.vectors.copy(), again.emb_out.copy(),
                                 stopped)
    # the chunk loop's geometry on the test's chunks, the epochs recorded
    chunks = case["geometry_chunks"]
    for name, kw in (("sgns", {}), ("hs", {"negative": 0})):
        m = model(max_iter=2, **kw)
        m._row_epoch, out["geometry_" + name] = _epoch_recorder()
        m.fit_streaming_sharded(lambda i: _t(chunks[i]), len(chunks), mesh, 34)
    # JAX's stream-state file (an epoch done): nothing left to train
    jax_dir = os.path.join(case["port_ckpt"], "jax_stream")
    if rank == 0:
        shutil.copytree(case["jax_stream"], jax_dir)
    mesh.barrier()
    from_jax = model(max_iter=1)
    from_jax.fit_streaming_sharded(source, n_chunks, mesh, 34, checkpoint_dir=jax_dir,
                                   source_token="karate")
    out["jax_stream"] = (from_jax.emb_in.copy(), from_jax.emb_out.copy())
    out["guards"] = {
        "column": _raises(lambda: model().fit_streaming_sharded(
            source, n_chunks, mesh, 34, table_sharding="column"), ValueError),
        "cbow": _raises(lambda: model(sg=0).fit_streaming_sharded(
            source, n_chunks, mesh, 34), ValueError),
        "cbow_fit": _raises(lambda: model(sg=0).fit_sharded(
            walks, mesh, table_sharding="row"), ValueError),
    }
    return out


def _raises(fn, exc) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    raise AssertionError(f"{fn} did not raise {exc.__name__}")


# --------------------------------------------------------------------------- #
# Node2Vec(mesh=, table_sharding="row")
# --------------------------------------------------------------------------- #


def pipeline(path: str) -> dict:
    case = _load(path)
    mesh = make_mesh(device="cpu")
    src, dst = karate()
    out = {}
    for name, kw in (("sgns", {}), ("hs", {"negative": 0})):
        n2v = Node2Vec(n2v_params=case["n2v"], w2v_params={**case["w2v"], **kw},
                       random_seed=3, mesh=mesh, table_sharding="row", device="cpu")
        n2v.preprocess_input_graph((src, dst), indexed=True, directed=False)
        walks = n2v.random_walk().copy()
        model = n2v.fit()
        out["fit_" + name] = (walks, model.losses, model.vectors.copy())
        streamed = Node2Vec(n2v_params={**case["n2v"], "walker_chunk": 16},
                            w2v_params={**case["w2v"], **kw}, random_seed=3, mesh=mesh,
                            table_sharding="row", device="cpu")
        streamed.preprocess_input_graph((src, dst), indexed=True, directed=False)
        model = streamed.run_pipeline()
        out["stream_" + name] = (model.losses, model.vectors.copy(), streamed.walks)
    g, _ = synthetic_multilabel(case["quality_n"], seed=0)
    q = Node2Vec(n2v_params=case["quality_n2v"], w2v_params=case["quality_w2v"], random_seed=0,
                 mesh=mesh, table_sharding="row", device="cpu")
    q.graph = g
    out["quality"] = q.run_pipeline().vectors.copy()
    return out


def programs(calls) -> list:
    """Several programs of this module in one spawn: ``calls`` is a list of
    (function name, case path); returns their results in order."""
    return [globals()[name](path) for name, path in calls]
