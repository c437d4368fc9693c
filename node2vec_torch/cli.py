"""Staged command-line driver: index | walk | embed | eval | quality (port
of ``node2vec_tpu/cli.py``).

The reference's examples dispatch on ``sys.argv[1]`` across the same
stages with parquet handoff between them (its
``examples/native_spark.py:39-61``); this driver has an
argument parser, an eval and a quality stage, and hands off npz files in a
work directory: ``graph.npz``, ``walks.npz`` (with the walk parameters as
``n2v_params``), ``model.npz``, ``vectors.txt`` and ``w2v_params.json``.
The files are the JAX package's, so stages of the two packages mix on one
work directory.  Stages run on the card unless ``--device cpu``.

Usage:
  python -m node2vec_torch.cli index --input edges.csv --workdir /tmp/run [--undirected --log1p]
  python -m node2vec_torch.cli walk  --workdir /tmp/run [--num-walks 10 --walk-length 20 -p 1 -q 1]
  python -m node2vec_torch.cli embed --workdir /tmp/run [--dim 128 --epochs 10]
  python -m node2vec_torch.cli eval  --workdir /tmp/run
  python -m node2vec_torch.cli quality --input synthetic

pandas (text, CSV and parquet edge files) and sklearn (``--labels``, the
quality stage's F1) are imported only by the stages that need them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time

import numpy as np

logger = logging.getLogger("node2vec_torch.cli")


def _graph_paths(workdir: str):
    return os.path.join(workdir, "graph.npz"), os.path.join(workdir, "walks.npz")


def stage_index(args) -> None:
    from node2vec_torch.graph import build_graph

    g = build_graph(
        args.input,
        indexed=args.indexed,
        directed=not args.undirected,
        max_out_degree=args.max_out_degree,
        random_seed=args.seed,
        log1p_weight=args.log1p,
    )
    os.makedirs(args.workdir, exist_ok=True)
    graph_path, _ = _graph_paths(args.workdir)
    np.savez_compressed(
        graph_path,
        indptr=g.indptr,
        indices=g.indices,
        weights=g.weights,
        alias=g.alias,
        prob=g.prob,
        names=g.names if g.names is not None else np.array([]),
        directed=np.bool_(g.directed),
    )
    logger.info("indexed graph: %d vertices, %d edges -> %s", g.n_vertices, g.n_edges,
                graph_path)


def _load_graph(workdir: str):
    from node2vec_torch.graph import Graph

    graph_path, _ = _graph_paths(workdir)
    with np.load(graph_path, allow_pickle=True) as z:
        return Graph(
            indptr=z["indptr"],
            indices=z["indices"],
            weights=z["weights"],
            alias=z["alias"],
            prob=z["prob"],
            names=z["names"] if len(z["names"]) else None,
            directed=bool(z["directed"]),
        )


def stage_walk(args) -> None:
    from node2vec_torch.constants import Node2VecParams
    from node2vec_torch.utils.metrics import StepTimer
    from node2vec_torch.walk import WalkEngine

    g = _load_graph(args.workdir)
    params = Node2VecParams(
        num_walks=args.num_walks,
        walk_length=args.walk_length,
        return_param=args.p,
        inout_param=args.q,
        max_rejection_trials=args.max_trials,
    )
    t0 = time.time()
    engine = WalkEngine(g, params, device=args.device)
    walks = engine.run(
        seed=args.seed,
        checkpoint_dir=os.path.join(args.workdir, "walk_ckpt") if args.checkpoint else None,
        timer=StepTimer(),
    )
    dt = time.time() - t0
    _, walks_path = _graph_paths(args.workdir)
    # the walk parameters, so that `eval` reruns them on a holdout split
    np.savez_compressed(walks_path, walks=walks, n2v_params=json.dumps(dataclasses.asdict(params)))
    steps = int((walks >= 0).sum() - len(walks))
    logger.info("walks %s in %.2fs (%.0f walk-steps/s) -> %s", walks.shape, dt,
                steps / dt if dt > 0 else 0, walks_path)
    if engine.fallback_count:
        logger.info("approximate-mode fallbacks: %d of %d steps (%.1f%%) forced past the "
                    "%d-trial cap", engine.fallback_count, steps,
                    100.0 * engine.fallback_count / max(steps, 1), args.max_trials)


def stage_embed(args) -> None:
    from node2vec_torch.constants import Word2VecParams
    from node2vec_torch.embedding import Node2VecTorchEmbedding

    g = _load_graph(args.workdir)
    _, walks_path = _graph_paths(args.workdir)
    with np.load(walks_path) as z:
        walks = z["walks"]
    params = Word2VecParams(
        min_count=args.min_count,
        vector_size=args.dim,
        max_iter=args.epochs,
        window_size=args.window,
        negative=args.negative,
        step_size=args.lr,
        sg=args.sg,
        sample=args.sample,
    )
    backend = Node2VecTorchEmbedding(df_walks=walks, name_id=g.names, w2v_params=params,
                                     device=args.device)
    t0 = time.time()
    fit = backend.model.fit_host if args.host_corpus else backend.model.fit
    fit(walks, n_vertices=g.n_vertices, verbose=True,
        checkpoint_dir=os.path.join(args.workdir, "train_ckpt") if args.checkpoint else None)
    logger.info("training done in %.2fs", time.time() - t0)
    backend.save_model(args.workdir, "model")
    backend.save_vectors(args.workdir, "vectors.txt")
    with open(os.path.join(args.workdir, "w2v_params.json"), "w") as f:
        json.dump(dataclasses.asdict(params), f)
    logger.info("saved model + vectors under %s", args.workdir)


def _recorded_params(workdir: str):
    """(Node2VecParams, Word2VecParams) recorded by the walk and embed
    stages, with defaults for files that lack them."""
    from node2vec_torch.constants import Node2VecParams, Word2VecParams

    n2v_d, w2v_d = {}, {"min_count": 1, "max_iter": 5}
    _, walks_path = _graph_paths(workdir)
    if os.path.exists(walks_path):
        with np.load(walks_path, allow_pickle=True) as z:
            if "n2v_params" in z.files:
                n2v_d = json.loads(str(z["n2v_params"]))
    w2v_path = os.path.join(workdir, "w2v_params.json")
    if os.path.exists(w2v_path):
        with open(w2v_path) as f:
            w2v_d = json.load(f)
    return Node2VecParams.from_dict(n2v_d), Word2VecParams.from_dict(w2v_d)


def stage_eval(args) -> None:
    from node2vec_torch.eval import (
        link_prediction_auc,
        node_classification_f1,
        sample_negative_edges,
    )

    g = _load_graph(args.workdir)
    with np.load(os.path.join(args.workdir, "model.npz"), allow_pickle=True) as z:
        emb = z["emb_in"]
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    if args.train_edge_auc:
        # opt-in diagnostic: the positives are training-graph edges (the
        # embeddings saw them), so this AUC is optimistic
        src = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
        n_pos = min(len(src), 10_000)
        pick = np.random.default_rng(args.seed).choice(len(src), n_pos, replace=False)
        neg = sample_negative_edges(g.indptr, g.indices, n_pos, seed=args.seed)
        auc = link_prediction_auc(emb, (src[pick], g.indices[pick]), neg)
        result = {"metric": "train_edge_auc", "value": auc, "n_edges_eval": n_pos}
    else:
        # the held-out protocol: hold edges out, rerun the walks and the
        # training on the rest with the recorded parameters, and score the
        # held-out edges against non-edges
        from node2vec_torch.datasets import holdout_link_prediction

        n2v_p, w2v_p = _recorded_params(args.workdir)
        res = holdout_link_prediction(g, holdout_frac=args.holdout_frac, n2v_params=n2v_p,
                                      w2v_params=w2v_p, seed=args.seed, device=args.device)
        result = {"metric": "holdout_link_auc", "value": res["holdout_link_auc"],
                  "holdout_frac": args.holdout_frac}
    if args.labels:
        # whitespace file: vertex_id label (the node2vec paper's protocol)
        lab = np.loadtxt(args.labels, dtype=np.int64)
        labels = np.full(g.n_vertices, -1, dtype=np.int64)
        labels[lab[:, 0]] = lab[:, 1]
        have = labels >= 0
        result.update(node_classification_f1(emb[have], labels[have],
                                             train_ratio=args.train_ratio, seed=args.seed))
    print(json.dumps(result))


def stage_quality(args) -> None:
    from node2vec_torch.constants import Node2VecParams, Word2VecParams
    from node2vec_torch.datasets import load_mat_dataset, run_quality, synthetic_multilabel

    if args.input == "synthetic":
        g, labels = synthetic_multilabel(seed=args.seed)
    else:
        g, labels = load_mat_dataset(args.input)
    n2v = Node2VecParams(num_walks=args.num_walks, walk_length=args.walk_length,
                         return_param=args.p, inout_param=args.q)
    w2v = Word2VecParams(
        min_count=1,
        vector_size=args.dim,
        max_iter=args.epochs,
        window_size=args.window,
        negative=args.negative,  # 0 = hierarchical softmax (the reference's default)
    )
    ratios = [float(r) for r in args.train_ratios.split(",")]
    t0 = time.time()
    result = run_quality(g, labels, n2v, w2v, train_ratios=ratios, seed=args.seed,
                         device=args.device)
    result["wall_s"] = round(time.time() - t0, 1)
    result["dataset"] = args.input
    print(json.dumps(result))


def _device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help='where walks and training run: "cuda" (default) or "cpu"')


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    parser = argparse.ArgumentParser(prog="node2vec_torch")
    sub = parser.add_subparsers(dest="stage", required=True)

    p_index = sub.add_parser("index", help="ingest + index + trim an edge list")
    p_index.add_argument("--input", required=True, help="edge file (csv/parquet/npz/txt)")
    p_index.add_argument("--workdir", required=True)
    p_index.add_argument("--indexed", action="store_true", help="ids already dense ints")
    p_index.add_argument("--undirected", action="store_true")
    p_index.add_argument("--log1p", action="store_true", help="log1p-transform weights")
    p_index.add_argument("--max-out-degree", type=int, default=0)
    p_index.add_argument("--seed", type=int, default=0)

    p_walk = sub.add_parser("walk", help="generate the walk corpus")
    p_walk.add_argument("--workdir", required=True)
    p_walk.add_argument("--num-walks", type=int, default=10)
    p_walk.add_argument("--walk-length", type=int, default=20)
    p_walk.add_argument("-p", type=float, default=1.0, dest="p")
    p_walk.add_argument("-q", type=float, default=1.0, dest="q")
    p_walk.add_argument("--seed", type=int, default=0)
    p_walk.add_argument("--checkpoint", action="store_true")
    p_walk.add_argument(
        "--max-trials", type=int, default=64, dest="max_trials",
        help="p/q rejection-round cap for the blocked/CSR engines (the dense engine samples "
        "exactly and ignores it); low values (1-2) are the approximate fast mode on "
        "heavy-tail graphs — forced steps are reported",
    )
    _device_arg(p_walk)

    p_embed = sub.add_parser("embed", help="train skip-gram embeddings")
    p_embed.add_argument("--workdir", required=True)
    p_embed.add_argument("--dim", type=int, default=128)
    p_embed.add_argument("--epochs", type=int, default=10)
    p_embed.add_argument("--window", type=int, default=5)
    p_embed.add_argument("--negative", type=int, default=5)
    p_embed.add_argument("--min-count", type=int, default=10)
    p_embed.add_argument("--lr", type=float, default=0.025)
    p_embed.add_argument("--sg", type=int, default=1, choices=(0, 1),
                         help="1 = skip-gram (default), 0 = CBOW (gensim's default architecture)")
    p_embed.add_argument("--sample", type=float, default=0.0,
                         help="frequent-vertex subsampling threshold (gensim 'sample'; 0 = off)")
    p_embed.add_argument("--checkpoint", action="store_true")
    p_embed.add_argument(
        "--host-corpus", action="store_true",
        help="keep the walk corpus in host RAM and stream shuffled slabs to the device "
        "(fit_host), for corpora that do not fit device memory next to the tables",
    )
    _device_arg(p_embed)

    p_eval = sub.add_parser(
        "eval",
        help="held-out link-prediction AUC (+F1 with --labels); --train-edge-auc for the "
        "optimistic train-edge diagnostic",
    )
    p_eval.add_argument("--workdir", required=True)
    p_eval.add_argument("--seed", type=int, default=0)
    p_eval.add_argument("--labels", default=None, help="file: vertex_id label")
    p_eval.add_argument("--train-ratio", type=float, default=0.5)
    p_eval.add_argument("--holdout-frac", type=float, default=0.2,
                        help="edge fraction held out before walks (default protocol)")
    p_eval.add_argument("--train-edge-auc", action="store_true",
                        help="score training-graph edges with the saved model instead "
                        "(optimistic diagnostic; no retraining)")
    _device_arg(p_eval)

    p_q = sub.add_parser(
        "quality",
        help="benchmark-dataset protocol: walks -> SGNS -> multi-label F1 (node2vec paper "
        "§4.3); --input is a DeepWalk-format .mat (BlogCatalog/PPI/Wikipedia) or 'synthetic'",
    )
    p_q.add_argument("--input", required=True, help=".mat path or 'synthetic'")
    p_q.add_argument("--num-walks", type=int, default=10)
    p_q.add_argument("--walk-length", type=int, default=80)
    p_q.add_argument("-p", type=float, default=1.0, dest="p")
    p_q.add_argument("-q", type=float, default=1.0, dest="q")
    p_q.add_argument("--dim", type=int, default=128)
    p_q.add_argument("--epochs", type=int, default=5)
    p_q.add_argument("--window", type=int, default=10)
    p_q.add_argument("--negative", type=int, default=5,
                     help="negatives per pair; 0 = hierarchical softmax")
    p_q.add_argument("--train-ratios", default="0.1,0.5,0.9",
                     help="comma-separated label-train fractions")
    p_q.add_argument("--seed", type=int, default=0)
    _device_arg(p_q)

    args = parser.parse_args(argv)
    {
        "index": stage_index,
        "walk": stage_walk,
        "embed": stage_embed,
        "eval": stage_eval,
        "quality": stage_quality,
    }[args.stage](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
