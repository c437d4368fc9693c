"""Vocabulary and negative-sampling table for skip-gram training (a copy of
``node2vec_tpu/models/vocab.py``).

Vertex ids index arrays directly: the "vocabulary" is a count vector, a
min-count mask, and an alias table over the unigram^0.75 noise distribution
(word2vec's standard SGNS negative distribution).  Counting happens on the
host; a corpus handed over as a torch tensor is copied to the host first.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Vocabulary:
    counts: np.ndarray  # [V] int64 corpus frequency of each vertex
    mask: np.ndarray  # [V] bool — True where counts >= min_count
    ns_alias: np.ndarray  # [V] int32 alias table over unigram^0.75
    ns_prob: np.ndarray  # [V] float32

    @property
    def n_vertices(self) -> int:
        return len(self.counts)

    @property
    def n_kept(self) -> int:
        return int(self.mask.sum())


def build_vocab_from_counts(
    counts: np.ndarray,
    min_count: int = 1,
    ns_exponent: float = 0.75,
) -> Vocabulary:
    """Vocabulary from a precomputed count vector (host or device-derived)."""
    from node2vec_torch.ops.alias import build_alias_csr

    counts = np.asarray(counts, dtype=np.int64)
    n_vertices = len(counts)
    mask = counts >= max(min_count, 1)

    noise = counts.astype(np.float64) ** ns_exponent
    noise[~mask] = 0.0
    if noise.sum() == 0:
        # degenerate corpus: uniform noise so sampling stays well-defined
        noise = np.ones(max(n_vertices, 1), dtype=np.float64)
    indptr = np.array([0, max(n_vertices, 1)], dtype=np.int64)
    ns_alias, ns_prob = build_alias_csr(indptr, noise.astype(np.float32))
    return Vocabulary(
        counts=counts,
        mask=mask,
        ns_alias=ns_alias.astype(np.int32),
        ns_prob=ns_prob.astype(np.float32),
    )


def subsample_keep_prob(
    counts: np.ndarray, sample: float, mask: Optional[np.ndarray] = None
) -> np.ndarray:
    """Per-vertex keep probability for frequent-vertex subsampling.

    gensim semantics (``Word2Vec(sample=...)``, active by default at 1e-3 in
    the reference's gensim backend since params pass straight through,
    its ``embedding.py:105-126``): with
    ``threshold = sample * retained_total`` (or an absolute count when
    ``sample >= 1``, gensim's other convention),

        p_keep(v) = min(1, (sqrt(count_v / threshold) + 1) * threshold / count_v)

    Occurrences are then kept i.i.d. with p_keep at training time (the
    trainers mask discarded positions in place; gensim removes them before
    windowing — the same documented divergence as min_count, docs/parity.md).
    """
    counts = np.asarray(counts, dtype=np.float64)
    retained = counts if mask is None else np.where(mask, counts, 0.0)
    total = retained.sum()
    if sample <= 0 or total <= 0:
        return np.ones(len(counts), dtype=np.float32)
    threshold = sample * total if sample < 1.0 else float(sample)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = (np.sqrt(counts / threshold) + 1.0) * threshold / counts
    p = np.where(counts > 0, p, 1.0)
    return np.minimum(p, 1.0).astype(np.float32)


def build_vocab(
    walks: np.ndarray,
    n_vertices: Optional[int] = None,
    min_count: int = 1,
    ns_exponent: float = 0.75,
) -> Vocabulary:
    """Count vertices over the walk corpus and build the noise alias table.

    ``walks`` is int32 [N, L+1] with -1 padding (numpy, or a torch tensor,
    which is copied to the host).  Vertices below ``min_count`` are masked
    out of training and excluded from the noise distribution (gensim
    behavior: they are simply not in the vocab).
    """
    if not isinstance(walks, np.ndarray):
        walks = walks.cpu().numpy()
    flat = walks.reshape(-1)
    flat = flat[flat >= 0]
    if n_vertices is None:
        n_vertices = int(flat.max()) + 1 if len(flat) else 0
    counts = np.bincount(flat, minlength=n_vertices).astype(np.int64)
    return build_vocab_from_counts(counts, min_count, ns_exponent)
