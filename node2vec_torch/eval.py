"""Embedding-quality evaluation (port of ``node2vec_tpu/eval.py``).

Link-prediction AUC, node-classification F1, and chi-square agreement of
walk transitions with the analytic p/q distribution.
``link_prediction_auc`` ranks with scipy (Mann–Whitney U with ties
averaged), which is the number sklearn's ``roc_auc_score`` gives, so the
port needs no sklearn there; ``node_classification_f1`` imports sklearn
inside.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def sample_negative_edges(
    indptr: np.ndarray,
    indices: np.ndarray,
    n_samples: int,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform non-edges (u,v), u!=v, rejection-sampled against the CSR with
    one global searchsorted over the sorted (u*V+v) edge keys."""
    n_vertices = len(indptr) - 1
    n_edges = len(indices)
    rng = np.random.default_rng(seed)
    src_rep = np.repeat(np.arange(n_vertices, dtype=np.int64), np.diff(indptr))
    edge_keys = src_rep * n_vertices + indices  # ascending (sorted CSR rows)
    out_u = np.empty(n_samples, dtype=np.int64)
    out_v = np.empty(n_samples, dtype=np.int64)
    got = 0
    while got < n_samples:
        m = 2 * (n_samples - got) + 16
        u = rng.integers(0, n_vertices, size=m)
        v = rng.integers(0, n_vertices, size=m)
        keys = u * n_vertices + v
        pos = np.searchsorted(edge_keys, keys)
        pos_c = np.minimum(pos, max(n_edges - 1, 0))
        is_edge = (pos < n_edges) & (edge_keys[pos_c] == keys) if n_edges else False
        ok = (u != v) & ~is_edge
        take = min(int(ok.sum()), n_samples - got)
        out_u[got : got + take] = u[ok][:take]
        out_v[got : got + take] = v[ok][:take]
        got += take
    return out_u, out_v


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """ROC AUC of binary ``labels`` by score rank (ties averaged)."""
    from scipy.stats import rankdata

    labels = np.asarray(labels, dtype=bool)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("ROC AUC needs both positive and negative samples")
    ranks = rankdata(scores)  # average ranks for ties
    u = ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def link_prediction_auc(
    embeddings: np.ndarray,
    pos_edges: Tuple[np.ndarray, np.ndarray],
    neg_edges: Tuple[np.ndarray, np.ndarray],
) -> float:
    """ROC AUC of dot-product edge scores: positives vs sampled non-edges."""
    pu, pv = pos_edges
    nu, nv = neg_edges
    pos_scores = np.sum(embeddings[pu] * embeddings[pv], axis=1)
    neg_scores = np.sum(embeddings[nu] * embeddings[nv], axis=1)
    y = np.concatenate([np.ones(len(pos_scores)), np.zeros(len(neg_scores))])
    s = np.concatenate([pos_scores, neg_scores])
    return roc_auc(y, s)


def node_classification_f1(
    embeddings: np.ndarray,
    labels: np.ndarray,
    train_ratio: float = 0.5,
    seed: int = 0,
) -> Dict[str, float]:
    """Micro/macro F1 of one-vs-rest logistic regression on the embeddings
    (the node2vec paper's evaluation protocol)."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import f1_score
    from sklearn.model_selection import train_test_split

    x_tr, x_te, y_tr, y_te = train_test_split(
        embeddings, labels, train_size=train_ratio, random_state=seed, stratify=labels
    )
    clf = LogisticRegression(max_iter=1000)
    clf.fit(x_tr, y_tr)
    pred = clf.predict(x_te)
    return {
        "micro_f1": float(f1_score(y_te, pred, average="micro")),
        "macro_f1": float(f1_score(y_te, pred, average="macro")),
    }


def analytic_second_order_probs(
    graph,
    prev: int,
    cur: int,
    return_param: float,
    inout_param: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact node2vec transition distribution for the edge (prev -> cur):
    weight/p to return, weight for shared neighbors, weight/q otherwise.
    Returns (neighbor_ids, probabilities)."""
    nbrs, weights = graph.neighbors(cur)
    prev_nbrs = set(graph.neighbors(prev)[0].tolist())
    bias = np.where(
        nbrs == prev,
        1.0 / return_param,
        np.where([int(x) in prev_nbrs for x in nbrs], 1.0, 1.0 / inout_param),
    )
    w = weights * bias
    return nbrs, w / w.sum()


def walk_transition_pvalue(
    graph,
    walks: np.ndarray,
    prev: int,
    cur: int,
    return_param: float,
    inout_param: float,
) -> Optional[float]:
    """Chi-square p-value: empirical next-hop counts after (prev,cur) vs analytic.

    Returns None when the walk corpus contains too few (prev,cur) transitions.
    """
    from scipy import stats

    nbrs, probs = analytic_second_order_probs(
        graph, prev, cur, return_param, inout_param
    )
    hits = (walks[:, :-2] == prev) & (walks[:, 1:-1] == cur)
    nxt = walks[:, 2:][hits]
    nxt = nxt[nxt >= 0]
    if len(nxt) < 5 * len(nbrs):
        return None
    counts = np.array([(nxt == int(v)).sum() for v in nbrs], dtype=np.float64)
    return float(stats.chisquare(counts, probs * counts.sum()).pvalue)
