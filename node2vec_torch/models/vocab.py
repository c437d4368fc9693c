"""Vocabulary and negative-sampling table for skip-gram training (a copy of
``node2vec_tpu/models/vocab.py``).

Vertex ids index arrays directly: the "vocabulary" is a count vector, a
min-count mask, and an alias table over the unigram^0.75 noise distribution
(word2vec's standard SGNS negative distribution).  A numpy corpus is
counted on the host with ``np.bincount``; a torch corpus is counted where it
lies by ``vertex_counts`` (kernel K6, ``csrc/vertex_counts.cu``, on the card;
its plain version on the CPU), and only the [V] counts reach the host;
with ``out=`` it accumulates into a persistent counts tensor, which is how
the streaming trainer counts a virtual corpus chunk by chunk.

``subsample_walks`` (kernel K7, ``csrc/subsample.cu``) applies gensim's
frequent-vertex subsampling to a corpus on the card, drawing its uniforms
from the counter hash keyed on (seed, flat position, stream tag).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from node2vec_torch import _build


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


def _counts_out(walks: torch.Tensor, n_vertices: int, out: Optional[torch.Tensor]):
    if out is None:
        return torch.zeros(n_vertices, dtype=torch.int32, device=walks.device)
    if out.dtype != torch.int32 or out.shape != (n_vertices,) or out.device != walks.device:
        raise ValueError(
            f"out must be an int32 [{n_vertices}] tensor on {walks.device}, got "
            f"{out.dtype} {tuple(out.shape)} on {out.device}"
        )
    return out


def vertex_counts_plain(
    walks: torch.Tensor, n_vertices: int, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """int32 [V] counts of the entries in [0, V) of ``walks``, added to
    ``out`` when it is given."""
    flat = walks.reshape(-1)
    keep = (flat >= 0) & (flat < n_vertices)
    counts = _counts_out(walks, n_vertices, out)
    return counts.index_add_(0, flat[keep].long(), torch.ones_like(flat[keep]))


def vertex_counts(
    walks: torch.Tensor, n_vertices: int, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """How often each vertex occurs in a walk corpus: int32 [V] on the
    corpus's device; entries < 0 (padding) and >= V are not counted.  With
    ``out`` (int32 [V] on the same device) the counts are added to it and
    ``out`` is returned.

    CPU tensors take the plain version; CUDA tensors launch K6 or raise.
    """
    if walks.dtype != torch.int32:
        raise TypeError("vertex_counts takes an int32 corpus")
    if n_vertices < 0 or n_vertices > np.iinfo(np.int32).max:
        raise ValueError(f"n_vertices must be in [0, 2^31), got {n_vertices}")
    if not walks.is_cuda:
        return vertex_counts_plain(walks, n_vertices, out)
    walks = walks.contiguous()
    if walks.data_ptr() % 16:  # the kernel reads 16-byte vectors
        walks = walks.clone()
    counts = _counts_out(walks, n_vertices, out)
    _build.require_cuda("vertex_counts", walks, counts)
    rc = _build.lib().n2v_vertex_counts(
        _build.ptr(walks), walks.numel(), _build.ptr(counts), n_vertices,
        _build.stream_of(walks),
    )
    _build.check(rc, "vertex_counts")
    _build.launches["vertex_counts"] += 1
    return counts


def _check_subsample_args(walks, keep_prob, tag, u=None, base=0):
    if walks.dtype != torch.int32 or keep_prob.dtype != torch.float32:
        raise TypeError("subsample_walks takes an int32 corpus and a float32 keep_prob")
    if keep_prob.dim() != 1 or keep_prob.shape[0] == 0:
        raise ValueError("keep_prob must be a non-empty [V] table")
    if base < 0 or walks.numel() + base > 1 << 32:
        raise ValueError("subsample_walks keys its draws on 32-bit positions: "
                         f"{walks.numel()} entries from position {base} is too many")
    if not 0 <= int(tag) < 1 << 32:
        raise ValueError(f"stream tag {tag} is not a uint32")
    if u is not None and u.shape != walks.shape:
        raise ValueError(f"u {tuple(u.shape)} must match walks {tuple(walks.shape)}")


def subsample_walks_plain(
    walks: torch.Tensor, keep_prob: torch.Tensor, seed: int, tag: int,
    u: Optional[torch.Tensor] = None, out: Optional[torch.Tensor] = None, base: int = 0,
) -> torch.Tensor:
    """``_subsample_walks`` (word2vec.py:37-48) in plain PyTorch: entries
    v >= 0 survive when u < keep_prob[v], others become -1.  ``u`` defaults
    to K7's draws, ``hash_uniform(seed, base + flat position, tag)``; a test
    may pass JAX's uniforms instead.  With ``out`` the result is written
    there (it may be ``walks`` itself)."""
    from node2vec_torch.ops.hashrng import hash_uniform

    base = int(base)
    _check_subsample_args(walks, keep_prob, tag, u, base)
    if u is None:
        pos = torch.arange(base, base + walks.numel(), dtype=torch.int64, device=walks.device)
        u = hash_uniform(seed, pos.reshape(walks.shape), tag)
    safe = torch.where(walks >= 0, walks, 0).long().clamp(max=keep_prob.shape[0] - 1)
    keep = (walks < 0) | (u < keep_prob[safe])
    res = torch.where(keep, walks, -1)
    return res if out is None else out.copy_(res)


def subsample_walks(
    walks: torch.Tensor, keep_prob: torch.Tensor, seed: int, tag: int,
    out: Optional[torch.Tensor] = None, base: int = 0,
) -> torch.Tensor:
    """Frequent-vertex subsampling of an int32 corpus (gensim ``sample``),
    one draw per entry keyed on (seed, base + flat position, stream tag).
    ``base``: the flat position of ``walks``' first entry in the corpus it
    is a slice of, so a data shard draws what the whole corpus draws there
    (0, the one-device trainers' value, keeps their draws).  Returns a new
    tensor, or writes ``out`` (which may be ``walks``).

    CPU tensors take the plain version; CUDA tensors launch K7 or raise.
    """
    base = int(base)
    if not walks.is_cuda:
        return subsample_walks_plain(walks, keep_prob, seed, tag, out=out, base=base)
    _check_subsample_args(walks, keep_prob, tag, base=base)
    if out is None:
        out = torch.empty_like(walks, memory_format=torch.contiguous_format)
    _build.require_cuda("subsample_walks", walks, keep_prob, out)
    if out.shape != walks.shape or out.dtype != torch.int32:
        raise ValueError("out must be an int32 tensor of the corpus's shape")
    if walks.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("subsample_walks reads and writes 16-byte vectors: "
                         "corpus and out must be 16-byte aligned")
    rc = _build.lib().n2v_subsample_walks(
        _build.ptr(walks), walks.numel(), _build.ptr(keep_prob), keep_prob.shape[0],
        int(seed) & 0xFFFFFFFF, int(tag), base, _build.ptr(out), _build.stream_of(walks),
    )
    _build.check(rc, "subsample_walks")
    _build.launches["subsample_walks"] += 1
    return out


def build_vocab(
    walks: np.ndarray,
    n_vertices: Optional[int] = None,
    min_count: int = 1,
    ns_exponent: float = 0.75,
) -> Vocabulary:
    """Count vertices over the walk corpus and build the noise alias table.

    ``walks`` is int32 [N, L+1] with -1 padding: numpy, counted on the
    host, or a torch tensor, counted on its device.  Vertices below
    ``min_count`` are masked out of training and excluded from the noise
    distribution (gensim behavior: they are simply not in the vocab).
    """
    if not isinstance(walks, np.ndarray):
        if n_vertices is None:
            n_vertices = int(walks.max()) + 1 if walks.numel() else 0
        counts = vertex_counts(walks.to(torch.int32), n_vertices).cpu().numpy()
        return build_vocab_from_counts(counts, min_count, ns_exponent)
    flat = walks.reshape(-1)
    flat = flat[flat >= 0]
    if n_vertices is None:
        n_vertices = int(flat.max()) + 1 if len(flat) else 0
    counts = np.bincount(flat, minlength=n_vertices).astype(np.int64)
    return build_vocab_from_counts(counts, min_count, ns_exponent)
