"""Reference values of chip_smoke.py's quality gates, from the JAX package
on the CPU (and, with --port, from the PyTorch port's plain path).

    JAX_PLATFORMS=cpu python experiments/port_gate_reference.py [--port] [--hs] [--cbow]
        [--sgd] [--mesh N_DATA,N_MODEL[,row]] [--trainers fit run_pipeline host_corpus]
        [--seeds 0 1]

The gates train on ``synthetic_multilabel(2000, seed=0)`` with num_walks 8,
walk_length 40, dim 128, max_iter 5, min_count 1, p = q = 1, and read the
held-out link-prediction AUC (20% of the edges held out before walking)
and the same-label minus no-shared-label mean cosine over 200k pairs.
Three trainers: "fit" (walks to the host, then fit), "run_pipeline"
(``Node2Vec.run_pipeline()`` at walker_chunk 2048, so it streams over 8
chunks) and "host_corpus" (``Node2Vec(host_corpus=True)``, with
sample=1e-3).  ``--hs`` trains hierarchical softmax (negative=0), the
reference's default objective, instead of negative sampling; ``--cbow``
trains CBOW (sg=0, gensim's default architecture) instead of skip-gram, so
``--cbow --hs`` trains CBOW with hierarchical softmax; ``--sgd`` trains
SGNS with ``optimizer="sgd"`` at ``step_size=0.025`` (the reference
trainers' update rule).  ``--mesh 2,1`` runs the JAX package on a (data ×
model) mesh of virtual CPU devices: "fit" trains ``fit_sharded`` and
"run_pipeline" ``Node2Vec(mesh=).run_pipeline()``, both the column-sharded
trainer, or with ``--mesh 2,1,row`` the row-sharded ones (``fit_sharded``
with ``table_sharding="row"``, and ``run_pipeline`` streaming into
``fit_streaming_sharded``) (``--port`` does not run with it: the port's mesh
runs in ranks of their own, ``chip_smoke.py``'s ``mesh_ranks``).  Prints one JSON line per
(package, objective, trainer, seed).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--mesh" in sys.argv:  # virtual CPU devices for the mesh, before jax starts
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import node2vec_tpu  # noqa: E402
from node2vec_tpu.constants import Node2VecParams as RefN2V  # noqa: E402
from node2vec_tpu.constants import Word2VecParams as RefW2V  # noqa: E402
from node2vec_tpu.graph import from_edge_arrays as ref_from_edge_arrays  # noqa: E402
from node2vec_tpu.models.word2vec import Word2VecTPU  # noqa: E402
from node2vec_tpu.walk import random_walks as ref_random_walks  # noqa: E402
from node2vec_torch.constants import Node2VecParams, Word2VecParams  # noqa: E402
from node2vec_torch.datasets import (  # noqa: E402
    holdout_link_prediction,
    holdout_split,
    label_cosine_gap,
    synthetic_multilabel,
    train_embeddings,
)
from node2vec_torch.eval import link_prediction_auc  # noqa: E402

TRAINERS = {
    "fit": ({}, {}),
    "run_pipeline": ({"walker_chunk": 2048}, {}),
    "host_corpus": ({}, {"sample": 1e-3}),
}


def jax_vectors(indptr, indices, weights, n_vertices, n2v, w2v, seed, trainer, mesh=None,
                table_sharding="column"):
    src = np.repeat(np.arange(n_vertices), np.diff(indptr)).astype(np.int32)
    g = ref_from_edge_arrays(src, indices, weights, n_vertices=n_vertices, directed=True)
    if trainer == "fit":
        walks = ref_random_walks(g, n2v, seed=seed)
        model = Word2VecTPU(w2v)
        if mesh is not None:
            return np.asarray(model.fit_sharded(walks, mesh, n_vertices=n_vertices,
                                                table_sharding=table_sharding).vectors)
        return np.asarray(model.fit(walks, n_vertices=n_vertices).vectors)
    pipe = node2vec_tpu.Node2Vec(n2v, w2v, random_seed=seed,
                                 host_corpus=trainer == "host_corpus", mesh=mesh,
                                 table_sharding=table_sharding)
    pipe.graph = g
    model = pipe.run_pipeline()
    if trainer == "run_pipeline" and mesh is None:
        assert pipe.walks is None, "the JAX pipeline did not stream"
    return np.asarray(model.vectors)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", action="store_true", help="also run the port on the CPU")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--trainers", nargs="+", default=list(TRAINERS))
    ap.add_argument("--hs", action="store_true",
                    help="hierarchical softmax (negative=0) instead of negative sampling")
    ap.add_argument("--cbow", action="store_true", help="CBOW (sg=0) instead of skip-gram")
    ap.add_argument("--sgd", action="store_true",
                    help='SGNS with optimizer="sgd", step_size=0.025 instead of Adagrad')
    ap.add_argument("--mesh", default=None,
                    help="N_DATA,N_MODEL[,row]: the JAX package's column-sharded (or, with "
                         "',row', row-sharded) trainer on a mesh")
    args = ap.parse_args()
    mesh, layout = None, "column"
    if args.mesh:
        from node2vec_tpu.parallel import make_mesh

        if args.port:
            ap.error("--port does not run with --mesh")
        fields = args.mesh.split(",")
        n_data, n_model = int(fields[0]), int(fields[1])
        layout = fields[2] if len(fields) > 2 else "column"
        mesh = make_mesh(n_data, n_model, devices=jax.devices()[: n_data * n_model])
    g, labels = synthetic_multilabel(2000, seed=0)
    for trainer in args.trainers:
        n2v_kw, w2v_kw = TRAINERS[trainer]
        n2v_kw = dict(num_walks=8, walk_length=40, **n2v_kw)
        w2v_kw = dict(min_count=1, max_iter=5, vector_size=128, **w2v_kw)
        if args.hs:
            w2v_kw["negative"] = 0
        if args.cbow:
            w2v_kw["sg"] = 0
        if args.sgd:
            w2v_kw.update(optimizer="sgd", step_size=0.025)
        objective = ("cbow_" if args.cbow else "") + ("hs" if args.hs else
                                                      "ns" if args.cbow else "sgns")
        if args.sgd:
            objective += "_sgd"
        if mesh is not None:
            objective += f"_mesh{n_data}x{n_model}" + ("_row" if layout == "row" else "")
        for seed in args.seeds:
            kept, pos, neg = holdout_split(g, 0.2, seed)
            emb = jax_vectors(*_csr(kept, g.n_vertices), g.n_vertices, RefN2V(**n2v_kw),
                              RefW2V(**w2v_kw), seed, trainer, mesh, layout)
            emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
            full = jax_vectors(g.indptr, g.indices, g.weights, g.n_vertices,
                               RefN2V(**n2v_kw), RefW2V(**w2v_kw), seed, trainer, mesh, layout)
            print(json.dumps({"package": "node2vec_tpu (CPU)", "objective": objective,
                              "trainer": trainer, "seed": seed,
                              "holdout_link_auc": link_prediction_auc(emb, pos, neg),
                              "label_cosine_gap": label_cosine_gap(full, labels,
                                                                   n_pairs=200_000, seed=0)}),
                  flush=True)
            if args.port:
                n2v, w2v = Node2VecParams(**n2v_kw), Word2VecParams(**w2v_kw)
                auc = holdout_link_prediction(g, n2v_params=n2v, w2v_params=w2v, seed=seed,
                                              device="cpu", trainer=trainer)
                vec, _ = train_embeddings(g, n2v, w2v, seed=seed, device="cpu", trainer=trainer)
                print(json.dumps({"package": "node2vec_torch (CPU)", "objective": objective,
                                  "trainer": trainer, "seed": seed, **auc,
                                  "label_cosine_gap": label_cosine_gap(vec, labels,
                                                                       n_pairs=200_000, seed=0)}),
                      flush=True)


def _csr(kept, n_vertices):
    """(indptr, indices, weights) of the kept directed edges."""
    from node2vec_torch.graph import from_edge_arrays

    g = from_edge_arrays(*kept, n_vertices=n_vertices, directed=True)
    return g.indptr, g.indices, g.weights


if __name__ == "__main__":
    main()
