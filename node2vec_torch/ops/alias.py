"""Host-side alias tables over a whole CSR (port of the host half of
``node2vec_tpu/ops/alias.py``).

One (prob, alias) entry per edge, built once with the reference's
underfull/overfull LIFO-stack algorithm: the multithreaded C++ core when
available, a per-vertex numpy loop otherwise.  The device-side alias draws
of the JAX module are not ported yet (ROADMAP Queue A).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _build_alias_csr_numpy(indptr: np.ndarray, weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy bulk alias build: one (alias, prob) entry per CSR edge."""
    n_edges = int(indptr[-1])
    alias = np.zeros(n_edges, dtype=np.int32)
    prob = np.ones(n_edges, dtype=np.float32)
    w = np.asarray(weights, dtype=np.float64)
    for v in range(len(indptr) - 1):
        lo, hi = int(indptr[v]), int(indptr[v + 1])
        deg = hi - lo
        if deg == 0:
            continue
        seg = w[lo:hi]
        probs = seg * (deg / seg.sum())
        a = np.zeros(deg, dtype=np.int32)
        underfull = [i for i in range(deg) if probs[i] < 1.0]
        overfull = [i for i in range(deg) if probs[i] >= 1.0]
        while underfull and overfull:
            under, over = underfull.pop(), overfull.pop()
            a[under] = over
            probs[over] = probs[over] + probs[under] - 1.0
            (underfull if probs[over] < 1.0 else overfull).append(over)
        alias[lo:hi] = a
        prob[lo:hi] = probs.astype(np.float32)
    return alias, prob


def build_alias_csr(indptr: np.ndarray, weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Bulk first-order alias tables over an entire CSR graph.

    Returns (alias[E] int32 — *segment-local* alias slots, prob[E] float32).
    """
    from node2vec_torch import native

    if native.available():
        return native.build_alias_csr(indptr, weights)
    return _build_alias_csr_numpy(np.asarray(indptr), np.asarray(weights))
