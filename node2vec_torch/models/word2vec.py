"""Word2VecTorch: the skip-gram trainer (port of ``Word2VecTPU.fit``
for SGNS with row-wise Adagrad, ``node2vec_tpu/models/word2vec.py:139-284``).

Walks in, per-vertex embedding vectors out: the corpus is padded to whole
batches and kept on the device, each epoch shuffles it with
``torch.randperm`` on a seeded ``torch.Generator`` and sweeps the SGNS step
over its batches with word2vec's linear learning-rate decay.  All random
draws (init, shuffle, window shrink, negatives) come from generators seeded
with ``params.seed`` on the trainer's device.

Not ported yet, and raising ``NotImplementedError``: CBOW (``sg=0``),
hierarchical softmax (``negative=0``), ``optimizer="sgd"``, frequent-vertex
subsampling (``sample>0``), ``fit_streaming``, ``fit_host`` and
``fit_sharded``.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from node2vec_torch.constants import Word2VecParams
from node2vec_torch.device import resolve_device
from node2vec_torch.models.skipgram import draw_step, init_embeddings, sgns_epoch
from node2vec_torch.models.vocab import Vocabulary, build_vocab

logger = logging.getLogger(__name__)


def _effective_batch(
    batch_walks: int, n_walks: int, floor: int = 1,
    target_updates: int = 512,
) -> int:
    """Batch size with a small-corpus cap: at least ~``target_updates``
    optimizer updates per epoch, but never below 64 walks per batch (the
    shared-negative pool is drawn per batch).  Inactive at production corpus
    sizes (n_walks >= target_updates * batch_walks)."""
    batch = min(batch_walks, max(n_walks, 1))
    target = max(target_updates, 1)
    return max(min(batch, max(n_walks // target, 64, floor)), floor)


class Word2VecTorch:
    """Skip-gram negative-sampling trainer over walk corpora."""

    def __init__(
        self,
        params: Optional[Word2VecParams] = None,
        shared_negatives: int = 64,
        device="cuda",
    ):
        self.params = params or Word2VecParams()
        self.shared_negatives = shared_negatives
        self.device = resolve_device(device)
        self.vocab: Optional[Vocabulary] = None
        self._emb_in: Optional[torch.Tensor] = None
        self._emb_out: Optional[torch.Tensor] = None
        self.acc_in: Optional[torch.Tensor] = None
        self.acc_out: Optional[torch.Tensor] = None
        self._losses: list = []

    def _check_supported(self) -> None:
        p = self.params
        if p.sg == 0:
            raise NotImplementedError("CBOW (sg=0) is not ported yet (ROADMAP Queue A item 9)")
        if p.negative == 0:
            raise NotImplementedError(
                "hierarchical softmax (negative=0) is not ported yet (ROADMAP Queue A item 8)"
            )
        if p.optimizer != "adagrad":
            raise NotImplementedError(
                "optimizer='sgd' is not ported yet (ROADMAP Queue A item 14)"
            )
        if p.sample > 0:
            raise NotImplementedError(
                "frequent-vertex subsampling (sample>0) is not ported yet "
                "(ROADMAP Queue A item 14)"
            )

    def fit(
        self,
        walks,
        n_vertices: Optional[int] = None,
        verbose: bool = False,
    ) -> "Word2VecTorch":
        """Train embeddings over a walk corpus [N, L+1] int32 (-1 padded),
        given as a numpy array (counted on the host before the upload) or a
        torch tensor (counted on its device, by K6 on the card)."""
        self._check_supported()
        p = self.params
        dev = self.device
        if isinstance(walks, np.ndarray):
            walks = np.ascontiguousarray(walks, dtype=np.int32)
        self.vocab = build_vocab(
            walks, n_vertices, min_count=p.min_count, ns_exponent=p.ns_exponent
        )
        if isinstance(walks, np.ndarray):
            walks = torch.from_numpy(walks)
        walks = walks.to(device=dev, dtype=torch.int32)
        n_v = self.vocab.n_vertices
        if self.vocab.n_kept == 0:
            raise ValueError(
                f"No vertex meets min_count={p.min_count}; corpus too small"
            )
        emb_in, emb_out, acc_in, acc_out = init_embeddings(
            n_v, p.vector_size, seed=p.seed, device=dev
        )
        ns_alias = torch.from_numpy(self.vocab.ns_alias).to(dev)
        ns_prob = torch.from_numpy(self.vocab.ns_prob).to(dev)
        vocab_mask = torch.from_numpy(self.vocab.mask).to(dev)

        n_walks, length = walks.shape
        batch = _effective_batch(p.batch_walks, n_walks)
        n_batches = (n_walks + batch - 1) // batch
        total_steps = max(p.max_iter * n_batches, 1)
        lr_slope = float(np.float32(p.step_size / total_steps))

        # device-resident corpus, padded to whole batches with dead rows
        n_padded = n_batches * batch
        corpus = walks
        if n_padded > n_walks:
            pad = torch.full((n_padded - n_walks, length), -1, dtype=torch.int32, device=dev)
            corpus = torch.cat([walks, pad])

        gen = torch.Generator(device=dev).manual_seed(p.seed)

        def draws(_gstep: int):
            return draw_step(
                gen, batch, length, p.window_size, self.shared_negatives,
                p.shrink_window, dev,
            )

        self._losses = []
        for epoch in range(p.max_iter):
            perm = torch.randperm(n_padded, generator=gen, device=dev)
            shuffled = corpus[perm]
            losses = sgns_epoch(
                emb_in, emb_out, acc_in, acc_out, shuffled, draws,
                epoch * n_batches, p.step_size, lr_slope, ns_alias, ns_prob,
                vocab_mask, batch=batch, n_batches=n_batches,
                window=p.window_size, negatives=p.negative, min_lr=p.min_step_size,
            )
            epoch_loss = float(losses.mean())  # mean over batches
            self._losses.append(epoch_loss)
            if verbose:
                logger.info("epoch %d/%d loss=%.4f", epoch + 1, p.max_iter, epoch_loss)

        self._emb_in, self._emb_out = emb_in, emb_out
        self.acc_in, self.acc_out = acc_in, acc_out
        return self

    def fit_streaming(self, *args, **kwargs):
        raise NotImplementedError("fit_streaming is not ported yet (ROADMAP Queue A item 7)")

    def fit_host(self, *args, **kwargs):
        raise NotImplementedError("fit_host is not ported yet (ROADMAP Queue A item 7)")

    def fit_sharded(self, *args, **kwargs):
        raise NotImplementedError("fit_sharded is not ported yet (ROADMAP Queue A item 12)")

    @property
    def losses(self) -> list:
        """Mean loss of each epoch of the last fit()."""
        return list(self._losses)

    @property
    def emb_in(self) -> Optional[np.ndarray]:
        """Input table [V, D] as numpy (copied from the device on access)."""
        return None if self._emb_in is None else self._emb_in.cpu().numpy()

    @property
    def emb_out(self) -> Optional[np.ndarray]:
        return None if self._emb_out is None else self._emb_out.cpu().numpy()

    @property
    def vectors(self) -> np.ndarray:
        """Input embedding table [V, D] (word2vec convention: input side)."""
        if self._emb_in is None:
            raise RuntimeError("model not fitted yet")
        return self.emb_in

    def vector(self, vertex_id: int) -> np.ndarray:
        if self.vocab is not None and not self.vocab.mask[vertex_id]:
            raise KeyError(f"vertex {vertex_id} below min_count (not in vocabulary)")
        return self._emb_in[vertex_id].cpu().numpy()
