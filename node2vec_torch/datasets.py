"""Synthetic labelled graphs and the quality protocols (port of part of
``node2vec_tpu/datasets.py``).

``load_mat_dataset`` reads a DeepWalk/node2vec-format ``.mat`` file (scipy
imported inside).  ``synthetic_multilabel`` builds the overlapping-community
graph of the JAX package (the same graph from the same seed).  ``holdout_link_prediction``
and ``run_quality`` train, so they take ``device=``.  ``multilabel_f1``
needs sklearn and imports it lazily; ``label_cosine_gap`` is a label check
that needs nothing beyond numpy.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from node2vec_torch.graph.csr import Graph, from_edge_arrays


def load_mat_dataset(path: str) -> Tuple[Graph, np.ndarray]:
    """(Graph, labels[V, L] bool) from a DeepWalk/node2vec-format .mat file
    (keys ``network``, a sparse adjacency, and ``group``, a sparse
    node-label matrix; BlogCatalog, PPI and Wikipedia are undirected)."""
    from scipy import io as sio
    from scipy import sparse

    m = sio.loadmat(path)
    if "network" not in m or "group" not in m:
        raise ValueError(
            f"{path} is not a DeepWalk-format dataset "
            f"(need 'network' and 'group' keys, got {sorted(m)})"
        )
    adj = sparse.csr_matrix(m["network"])
    labels = np.asarray(sparse.csr_matrix(m["group"]).todense()) > 0
    coo = adj.tocoo()
    g = from_edge_arrays(
        coo.row.astype(np.int32),
        coo.col.astype(np.int32),
        coo.data.astype(np.float32),
        n_vertices=adj.shape[0],
        directed=False,
    )
    return g, labels


def synthetic_multilabel(
    n_vertices: int = 3000,
    n_labels: int = 12,
    avg_degree: int = 12,
    labels_per_vertex: float = 1.6,
    p_in_out_ratio: float = 12.0,
    seed: int = 0,
    degree_skew: float = 0.0,
) -> Tuple[Graph, np.ndarray]:
    """Overlapping-community graph with community ids as multi-labels.

    Each vertex joins 1+ communities; edge probability is much higher within
    a shared community.  ``degree_skew`` > 0 draws intra-community endpoints
    from a zipf-like weight ``rank^-skew`` instead of uniformly.
    """
    rng = np.random.default_rng(seed)
    member = rng.random((n_vertices, n_labels)) < (labels_per_vertex / n_labels)
    none = ~member.any(axis=1)
    member[none, rng.integers(0, n_labels, none.sum())] = True

    def pick(vs: np.ndarray, k: int) -> np.ndarray:
        if degree_skew <= 0.0:
            return vs[rng.integers(0, len(vs), k)]
        w = np.arange(1, len(vs) + 1, dtype=np.float64) ** -degree_skew
        return vs[rng.choice(len(vs), size=k, p=w / w.sum())]

    src_list, dst_list = [], []
    n_intra = n_vertices * avg_degree * 3 // 4
    per_label = np.maximum((member.sum(0) * n_intra) // member.sum(), 1)
    for c in range(n_labels):
        vs = np.flatnonzero(member[:, c])
        if len(vs) < 2:
            continue
        k = int(per_label[c])
        src_list.append(pick(vs, k))
        dst_list.append(pick(vs, k))
    n_noise = int(n_intra / p_in_out_ratio)
    src_list.append(rng.integers(0, n_vertices, n_noise).astype(np.int64))
    dst_list.append(rng.integers(0, n_vertices, n_noise).astype(np.int64))
    src = np.concatenate(src_list).astype(np.int32)
    dst = np.concatenate(dst_list).astype(np.int32)
    keep = src != dst
    g = from_edge_arrays(src[keep], dst[keep], directed=False)
    return g, member


def multilabel_f1(
    embeddings: np.ndarray,
    labels: np.ndarray,
    train_ratio: float = 0.5,
    seed: int = 0,
) -> Dict[str, float]:
    """Top-k one-vs-rest protocol (node2vec paper §4.3 / DeepWalk): test
    nodes predict their k highest-scoring labels, k = their true count."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.multiclass import OneVsRestClassifier

    rng = np.random.default_rng(seed)
    has_label = labels.any(axis=1)
    idx = np.flatnonzero(has_label)
    rng.shuffle(idx)
    n_train = max(int(len(idx) * train_ratio), 1)
    tr, te = idx[:n_train], idx[n_train:]

    clf = OneVsRestClassifier(LogisticRegression(max_iter=500, C=1.0))
    clf.fit(embeddings[tr], labels[tr])
    scores = clf.decision_function(embeddings[te])
    if scores.ndim == 1:
        scores = scores[:, None]

    k = labels[te].sum(axis=1)
    order = np.argsort(-scores, axis=1)
    pred = np.zeros_like(labels[te])
    for i in range(len(te)):
        pred[i, order[i, : k[i]]] = True

    true = labels[te]
    tp = (pred & true).sum()
    micro = 2 * tp / max(pred.sum() + true.sum(), 1)
    per_label_tp = (pred & true).sum(axis=0)
    per_label_f1 = np.where(
        (pred.sum(0) + true.sum(0)) > 0,
        2 * per_label_tp / np.maximum(pred.sum(0) + true.sum(0), 1),
        0.0,
    )
    macro = per_label_f1[true.sum(0) > 0].mean()
    return {"micro_f1": float(micro), "macro_f1": float(macro)}


def label_cosine_gap(
    embeddings: np.ndarray, labels: np.ndarray, n_pairs: int = 200_000, seed: int = 0
) -> float:
    """Mean cosine of random vertex pairs that share a label minus that of
    pairs that share none (``n_pairs`` uniform pairs, u != v)."""
    rng = np.random.default_rng(seed)
    n = len(embeddings)
    u = rng.integers(0, n, n_pairs)
    v = rng.integers(0, n, n_pairs)
    keep = u != v
    u, v = u[keep], v[keep]
    unit = embeddings / np.maximum(np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-12)
    cos = np.sum(unit[u] * unit[v], axis=1)
    share = (labels[u] & labels[v]).any(axis=1)
    return float(cos[share].mean() - cos[~share].mean())


def _walk_engine(graph: Graph, n2v_params, device, blocked_widths=None,
                 shared_lists: bool = False, mesh=None):
    """WalkEngine over ``graph`` (on ``mesh`` when given); with
    ``blocked_widths = (P, C)`` on the blocked engine, its tables built at
    those widths (with the shared-list sampler's lists when
    ``shared_lists``)."""
    from node2vec_torch.walk import WalkEngine
    from node2vec_torch.walk.blocked import build_blocked_graph

    if blocked_widths is None:
        return WalkEngine(graph, n2v_params, device=device, shared_lists=shared_lists,
                          mesh=mesh)
    bg = build_blocked_graph(graph.indptr, graph.indices, graph.weights,
                             *blocked_widths, shared_lists=shared_lists, device=device)
    return WalkEngine(graph, n2v_params, strategy="blocked", device=device, blocked_graph=bg,
                      shared_lists=shared_lists, mesh=mesh)


TRAINERS = ("fit", "run_pipeline", "host_corpus")


def _train(graph: Graph, n2v, w2v, seed: int, device, blocked_widths, trainer: str,
           shared_lists: bool = False, mesh=None, table_sharding: str = "column"):
    """Walk ``graph`` and train; returns (model, walk strategy).  ``trainer``
    is "fit" (walks to the host, then ``Word2VecTorch.fit``, or
    ``fit_sharded`` on ``mesh``), "run_pipeline" (``Node2Vec.run_pipeline()``
    with its defaults: it streams when the corpus spans several walker
    chunks; on ``mesh`` it trains ``fit_sharded``, or with
    ``table_sharding="row"`` streams into ``fit_streaming_sharded``) or
    "host_corpus" (``Node2Vec(host_corpus=True).run_pipeline()``, i.e.
    ``fit_host``)."""
    from node2vec_torch.models.word2vec import Word2VecTorch

    if trainer not in TRAINERS:
        raise ValueError(f"trainer must be one of {TRAINERS}, got {trainer!r}")
    engine = _walk_engine(graph, n2v, device, blocked_widths, shared_lists, mesh)
    if trainer == "fit":
        walks = engine.run(seed=seed)
        model = Word2VecTorch(w2v, device=device)
        if mesh is not None:
            return (model.fit_sharded(walks, mesh, n_vertices=graph.n_vertices,
                                      table_sharding=table_sharding), engine.strategy)
        return model.fit(walks, n_vertices=graph.n_vertices), engine.strategy
    from node2vec_torch.api import Node2Vec

    pipe = Node2Vec(n2v, w2v, random_seed=seed, device=device,
                    host_corpus=trainer == "host_corpus", mesh=mesh,
                    table_sharding=table_sharding)
    pipe.graph, pipe._engine = graph, engine
    return pipe.run_pipeline(), engine.strategy


def train_embeddings(graph: Graph, n2v_params=None, w2v_params=None, seed: int = 0,
                     device="cuda", blocked_widths=None,
                     trainer: str = "fit", shared_lists: bool = False,
                     mesh=None, table_sharding: str = "column") -> Tuple[np.ndarray, str]:
    """Walks -> SGNS on the full graph, as ``run_quality`` trains:
    returns (input vectors [V, D], walk strategy).  ``blocked_widths =
    (light_width, block_width)`` walks on the blocked engine at those
    widths whatever the graph's degrees, with the shared-list sampler when
    ``shared_lists``; ``trainer``, ``mesh`` and ``table_sharding`` as in
    ``_train``."""
    from node2vec_torch.constants import Node2VecParams, Word2VecParams

    n2v = n2v_params or Node2VecParams(num_walks=10, walk_length=80)
    w2v = w2v_params or Word2VecParams(min_count=1, max_iter=5)
    model, strategy = _train(graph, n2v, w2v, seed, device, blocked_widths, trainer,
                             shared_lists, mesh, table_sharding)
    return model.vectors, strategy


def holdout_split(graph: Graph, holdout_frac: float = 0.2, seed: int = 0):
    """Hold out ``holdout_frac`` of the undirected edges before walking:
    (src, dst, weight) of the directed edges that stay, the held-out pairs
    (src, dst) and as many sampled non-edges (at most 20,000)."""
    from node2vec_torch.eval import sample_negative_edges

    rng = np.random.default_rng(seed)
    src = np.repeat(
        np.arange(graph.n_vertices), np.diff(graph.indptr)
    ).astype(np.int32)
    dst = graph.indices
    # undirected graphs store both directions; hold out canonical pairs
    canon = src < dst
    pairs = np.flatnonzero(canon)
    rng.shuffle(pairs)
    n_hold = int(len(pairs) * holdout_frac)
    held = np.zeros(len(src), dtype=bool)
    held[pairs[:n_hold]] = True
    # remove both directions of held-out pairs
    key_all = src.astype(np.int64) * graph.n_vertices + dst
    key_rev = dst.astype(np.int64) * graph.n_vertices + src
    held_keys = set(key_all[held].tolist())
    drop = held | np.isin(key_rev, list(held_keys))
    neg = sample_negative_edges(graph.indptr, graph.indices, min(n_hold, 20000), seed=seed)
    return (src[~drop], dst[~drop], graph.weights[~drop]), (src[held], dst[held]), neg


def holdout_link_prediction(
    graph: Graph,
    holdout_frac: float = 0.2,
    n2v_params=None,
    w2v_params=None,
    seed: int = 0,
    device="cuda",
    blocked_widths=None,
    trainer: str = "fit",
    shared_lists: bool = False,
    mesh=None,
    table_sharding: str = "column",
) -> Dict[str, float]:
    """Honest link-prediction AUC: hold out edges BEFORE walk generation,
    embed on the rest, score held-out edges vs sampled non-edges.
    ``blocked_widths``, ``trainer``, ``shared_lists``, ``mesh`` and
    ``table_sharding`` as in ``train_embeddings``."""
    from node2vec_torch.constants import Node2VecParams, Word2VecParams
    from node2vec_torch.eval import link_prediction_auc

    kept, pos, neg = holdout_split(graph, holdout_frac, seed)
    g_train = from_edge_arrays(*kept, n_vertices=graph.n_vertices, directed=True)
    model, _ = _train(g_train, n2v_params or Node2VecParams(),
                      w2v_params or Word2VecParams(min_count=1, max_iter=5), seed, device,
                      blocked_widths, trainer, shared_lists, mesh, table_sharding)
    emb = model.vectors
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    return {"holdout_link_auc": link_prediction_auc(emb, pos, neg)}


def run_quality(
    graph: Graph,
    labels: np.ndarray,
    n2v_params=None,
    w2v_params=None,
    train_ratios: Sequence[float] = (0.1, 0.5, 0.9),
    seed: int = 0,
    mesh=None,
    device="cuda",
) -> Dict[str, object]:
    """Full quality protocol: walks -> SGNS -> multi-label F1 per train ratio.

    With ``mesh`` the walks run on it and the tables train row-sharded
    (``fit_sharded(..., table_sharding="row")``), as in the JAX package."""
    emb, strategy = train_embeddings(graph, n2v_params, w2v_params, seed, device, mesh=mesh,
                                     table_sharding="row")
    out: Dict[str, object] = {
        "n_vertices": graph.n_vertices,
        "n_edges": graph.n_edges,
        "n_labels": int(labels.shape[1]),
        "walk_strategy": strategy,
    }
    for r in train_ratios:
        scores = multilabel_f1(emb, labels, train_ratio=r, seed=seed)
        out[f"micro_f1@{r}"] = scores["micro_f1"]
        out[f"macro_f1@{r}"] = scores["macro_f1"]
    return out
