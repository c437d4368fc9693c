"""Word2VecTorch: the word2vec trainers (port of ``Word2VecTPU.fit``,
``fit_host``, ``fit_streaming``, ``_fit_hs`` and ``_fit_cbow`` with row-wise
Adagrad, ``node2vec_tpu/models/word2vec.py:37-1043``).

Walks in, per-vertex embedding vectors out, through three trainers that
share one step, picked by ``sg`` and ``negative`` in the JAX package's
order: CBOW with hierarchical softmax (K10, K3, K4, ``models/cbow.py``) for
``sg == 0, negative == 0``; skip-gram hierarchical softmax (K8, K3, K4,
``models/hsoftmax.py``), the reference's default objective, for
``negative == 0``; CBOW with negative sampling (K9, K3, K4) for
``sg == 0``; SGNS (K2-K4, ``models/skipgram.py``) otherwise.  With
hierarchical softmax the output table ``emb_out`` is the Huffman tree's
inner-node table theta [n_inner, D] (word2vec's syn1), built from the
vocabulary's counts of all V vertices; ``vectors`` stays the input table.

* ``fit``: the corpus lives on the device, padded to whole batches; each
  epoch shuffles it and sweeps the step over its batches with word2vec's
  linear learning-rate decay;
* ``fit_host``: the corpus stays in host memory; each epoch draws one
  global host permutation and uploads slabs double-buffered (pinned host
  buffers, a copy stream), so device memory is the tables plus two slabs;
* ``fit_streaming``: a virtual corpus, ``walk_source(i)`` regenerating walk
  chunk i on the device; a first pass counts the vertices
  (``_streaming_counts``, K6 into one persistent counts tensor), then each
  epoch visits the chunks in a seeded order, chunk i+1's walk enqueued
  before chunk i trains.

``sample > 0`` applies gensim's frequent-vertex subsampling to every
shuffled corpus, slab or chunk (K7 ``subsample_walks``).  Every trainer
saves its state to ``checkpoint_dir`` (the JAX package's file formats) and
resumes from it.

Randomness: every draw is keyed on absolute indices, as the JAX package
keys its draws with ``fold_in(PRNGKey(seed), tag)``, so a resumed run
replays the uninterrupted one (bit for bit on the CPU; on the card K2's
fp32 atomics reorder sums).  ``Draws`` makes a ``torch.Generator`` seeded
from a hash of (seed, tag) at each site: tag 1,000,000+epoch for fit's
shuffle, 7,000,000+epoch*n_chunks+i for a streamed chunk's, the global
step for a step's window shrink and negatives (HS draws only the shrink,
the first draw of the same generator); subsampling takes the tags
2,000,000+epoch (fit), 4,000,000+epoch*n_slabs+s (fit_host) and
8,000,000+epoch*n_chunks+i (fit_streaming) into K7's counter hash.
fit_host's permutations and fit_streaming's chunk orders are numpy, seeded
as in the JAX package, and equal to its own.

``optimizer`` is read only by SGNS, as in the JAX package: hierarchical
softmax and CBOW train row-wise Adagrad whatever it says.  SGNS with
``optimizer="sgd"`` takes the pre-aggregated step (K2, K11 ``preagg_rows``
and ``sgd_apply``; one slot map [V] a fit, never saved); its checkpoints
still carry the accumulators, unchanged, as the JAX package's do.

``fit_sharded`` trains over a (data × model) mesh: SGNS with the tables'
columns sharded over the model axis (``parallel.sharded_sgns``), or, with
``table_sharding="row"``, SGNS or hierarchical softmax with the tables' rows
sharded over every rank and routed each step (``parallel.rowsharded_sgns``,
``parallel.rowsharded_hs``); ``fit_streaming_sharded`` streams a virtual
corpus into the row layout.  The mesh trainers draw per data coordinate
(column) or per flat rank (row), under the JAX package's keys: the row
trainers key an epoch's (fit) or a chunk's (streaming: 9,000,000+epoch*
n_chunks+i) draws on that number, a rank's shuffle on tag 0x5F5E1 and a
step's on its global step, and subsample with the tags 3,000,000+epoch and
10,000,000+epoch*n_chunks+i from the rank's position in the corpus.

``emb_in``, ``emb_out`` and ``vectors`` read a table back from the device
once and cache it until training or an assignment writes it; assigning a
numpy array or a tensor puts it on the model's device.
"""

from __future__ import annotations

import functools
import logging
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from node2vec_torch.constants import Word2VecParams
from node2vec_torch.device import resolve_device
from node2vec_torch.models.cbow import cbow_epoch, cbow_hs_epoch
from node2vec_torch.models.hsoftmax import (
    HuffmanTree,
    build_huffman,
    cap_code_length,
    head_level_offsets,
    hs_epoch,
)
from node2vec_torch.models.skipgram import draw_step, init_embeddings, new_slot_map, sgns_epoch
from node2vec_torch.models.vocab import (
    Vocabulary,
    build_vocab,
    build_vocab_from_counts,
    subsample_keep_prob,
    subsample_walks,
    vertex_counts,
)
from node2vec_torch.utils.checkpoint import (
    load_stream_state,
    load_train_state,
    save_stream_state,
    save_train_state,
    stream_fingerprint,
)
from node2vec_torch.utils.metrics import measure

logger = logging.getLogger(__name__)

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _tag_seed(seed: int, tag: int, fold: Optional[int] = None) -> int:
    """63-bit generator seed for the draw site ``tag`` of a run seeded with
    ``seed`` (splitmix64 of both), and of data shard ``fold`` when given."""
    x = _splitmix64(_splitmix64(seed & _MASK64) ^ (tag & _MASK64))
    if fold is not None:
        x = _splitmix64(x ^ _splitmix64((fold + 1) & _MASK64))
    return x >> 1


class Draws:
    """Every random draw of one fit, each keyed on (params.seed, tag).

    The trainers reach randomness only through these methods, so a test
    can hand a trainer JAX's draws instead (``Word2VecTorch._new_draws``).
    ``data_index``: the mesh trainer's data coordinate (the column layout)
    or flat rank (the row layout), folded into every site's key (its model
    ranks draw alike, its data shards differently).  ``key``: a further
    number every site's key is folded with (the row trainers' epoch or
    chunk, as the JAX package folds its root key with it first).
    """

    def __init__(self, params: Word2VecParams, shared_negatives: int, device,
                 data_index: Optional[int] = None, key: Optional[int] = None):
        self.params = params
        self.shared_negatives = shared_negatives
        self.device = device
        self.data_index = data_index
        self.key = key

    def generator(self, tag: int) -> torch.Generator:
        seed = self.params.seed if self.key is None else _tag_seed(self.params.seed, self.key)
        seed = _tag_seed(seed, tag, self.data_index)
        return torch.Generator(device=self.device).manual_seed(seed)

    def init(self, n_vertices: int, dim: int):
        """(emb_in, emb_out, acc_in, acc_out), word2vec's init."""
        return init_embeddings(n_vertices, dim, seed=self.params.seed, device=self.device)

    def permutation(self, tag: int, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator(tag), device=self.device)

    def step(self, gstep: int, n_walks: int, length: int):
        """(b_sh, r1, r2) of global step ``gstep``."""
        p = self.params
        return draw_step(self.generator(gstep), n_walks, length, p.window_size,
                         self.shared_negatives, p.shrink_window, self.device)

    def window_shrink(self, gstep: int, n_walks: int, length: int) -> torch.Tensor:
        """b_sh of global step ``gstep`` for the HS steps: the b_sh that
        ``step`` draws, without the negatives."""
        p = self.params
        return draw_step(self.generator(gstep), n_walks, length, p.window_size, 0,
                         p.shrink_window, self.device)[0]

    def subsample(self, walks: torch.Tensor, keep_prob: torch.Tensor, tag: int,
                  base: int = 0) -> torch.Tensor:
        """K7 in place on a corpus the trainer owns (a shuffled copy, an
        uploaded slab, a data shard's copy of its rows from flat position
        ``base`` of the corpus)."""
        return subsample_walks(walks, keep_prob, self.params.seed, tag, out=walks, base=base)


def _sync(t: torch.Tensor) -> None:
    """Wait for the work queued on ``t``'s stream (bounds the enqueue depth)."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def _streaming_counts(walk_source: Callable[[int], torch.Tensor], n_chunks: int,
                      n_vertices: int) -> Tuple[np.ndarray, Optional[int]]:
    """Pass-1 exact corpus counts over a virtual corpus, nothing
    materialized: K6 adds each chunk into one int32 counts tensor on the
    chunk's device, spilled to a host int64 total every 256 chunks so hub
    counts cannot wrap.  A sync every 8 chunks bounds how many chunks are
    queued at once.  Returns (counts int64 [V], walk length)."""
    counts_host = np.zeros((n_vertices,), np.int64)
    counts = None
    length = None
    for c in range(n_chunks):
        w = walk_source(c)
        length = w.shape[1]
        if counts is None:
            counts = torch.zeros((n_vertices,), dtype=torch.int32, device=w.device)
        vertex_counts(w, n_vertices, out=counts)
        if (c + 1) % 8 == 0:
            _sync(counts)
        if (c + 1) % 256 == 0:
            counts_host += counts.cpu().numpy()
            counts.zero_()
    if counts is not None:
        counts_host += counts.cpu().numpy()
    return counts_host, length


def _effective_batch(
    batch_walks: int, n_walks: int, floor: int = 1,
    target_updates: int = 512,
) -> int:
    """Batch size with a small-corpus cap: at least ~``target_updates``
    optimizer updates per epoch, but never below 64 walks per batch (the
    shared-negative pool is drawn per batch).  Inactive at production corpus
    sizes (n_walks >= target_updates * batch_walks); the streaming trainer
    scales ``target_updates`` down by n_chunks."""
    batch = min(batch_walks, max(n_walks, 1))
    target = max(target_updates, 1)
    return max(min(batch, max(n_walks // target, 64, floor)), floor)


class _SlabUploader:
    """Host slabs of a corpus to the device for ``fit_host``.

    On the card: two pinned host buffers, each filled with ``np.take`` and
    copied ``non_blocking`` on a copy stream; the training stream waits on
    the copy's event.  A buffer is refilled only after its previous copy
    has completed.  ``events`` keeps (copy start, copy end) of each upload.
    On the CPU each slab is a fresh array, since the tensor aliases it."""

    def __init__(self, walks: np.ndarray, slab: int, device: torch.device):
        self.walks = walks
        self.slab = slab
        self.device = device
        self.cuda = device.type == "cuda"
        self.events: List[tuple] = []
        if self.cuda:
            shape = (slab, walks.shape[1])
            self.pinned = [torch.empty(shape, dtype=torch.int32, pin_memory=True)
                           for _ in range(2)]
            self.copied = [None, None]
            self.stream = torch.cuda.Stream(device)
            self.n_uploads = 0

    def _fill(self, buf: np.ndarray, idx: np.ndarray) -> None:
        np.take(self.walks, idx, axis=0, out=buf[: len(idx)])
        buf[len(idx):] = -1  # tail slab: dead rows, the trainers mask them

    def upload(self, perm: np.ndarray, s: int):
        idx = perm[s * self.slab: (s + 1) * self.slab]
        if not self.cuda:
            buf = np.empty((self.slab, self.walks.shape[1]), np.int32)
            self._fill(buf, idx)
            return torch.from_numpy(buf), None
        k = self.n_uploads % 2
        self.n_uploads += 1
        if self.copied[k] is not None:
            self.copied[k].synchronize()
        self._fill(self.pinned[k].numpy(), idx)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            start.record()
            dev = torch.empty(self.pinned[k].shape, dtype=torch.int32, device=self.device)
            dev.copy_(self.pinned[k], non_blocking=True)
            end.record()
        self.copied[k] = end
        self.events.append((start, end))
        return dev, end

    def ready(self, pending) -> torch.Tensor:
        """The uploaded slab, with the training stream made to wait for it."""
        slab_dev, end = pending
        if end is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(end)
            slab_dev.record_stream(cur)
        return slab_dev


class Word2VecTorch:
    """word2vec trainer over walk corpora: skip-gram (``sg=1``) or CBOW
    (``sg=0``), with negative sampling (``negative > 0``) or hierarchical
    softmax (``negative == 0``)."""

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
        self.tree: Optional[HuffmanTree] = None
        self.head_offsets: Tuple[int, ...] = (0,)
        self._losses: list = []
        self._slab_losses: list = []
        self._slab_events: list = []
        self._h2d_events: list = []
        self._host: dict = {}  # cached host copies of the tables ("in", "out")
        self._slot: Optional[torch.Tensor] = None  # K11's slot map (SGD), scratch
        self.dropped_rows = 0  # the row-sharded trainers' rows dropped to capacity, last fit

    def _begin(self) -> None:
        """Every trainer's entry: the tables are about to be written, so the
        cached host copies and the last fit's scratch go."""
        self._host.clear()
        self._slot = None

    # -- shared pieces of the three trainers -------------------------------- #

    def _new_draws(self) -> Draws:
        return Draws(self.params, self.shared_negatives, self.device)

    def _require_vocab(self) -> None:
        if self.vocab.n_kept == 0:
            raise ValueError(
                f"No vertex meets min_count={self.params.min_count}; corpus too small"
            )

    def _objective(self):
        """The step's device tables, from the vocabulary: negative
        sampling's (ns_alias, ns_prob, vocab_mask), or hierarchical
        softmax's (points, codes, lengths, vocab_mask) of the Huffman tree
        over all V vertices' counts, capped as the JAX package caps it; the
        tree and its head split are kept on self (CBOW-HS has no head)."""
        v = self.vocab
        p = self.params
        if p.negative > 0:
            self.tree = None
            tables = (v.ns_alias, v.ns_prob, v.mask)
        else:
            self.tree = cap_code_length(build_huffman(v.counts), v.counts,
                                        max_len=p.hs_max_code_length or None)
            self.head_offsets = head_level_offsets(self.tree, table_rows=self.tree.n_inner)
            tables = (self.tree.points, self.tree.codes, self.tree.lengths, v.mask)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in tables)

    def _keep_table(self) -> Optional[torch.Tensor]:
        """[V] keep probabilities for ``sample`` subsampling, or None."""
        if self.params.sample <= 0:
            return None
        keep = subsample_keep_prob(self.vocab.counts, self.params.sample, self.vocab.mask)
        return torch.from_numpy(keep).to(self.device)

    def _to_device(self, tables) -> List[torch.Tensor]:
        return [torch.from_numpy(np.ascontiguousarray(t, dtype=np.float32)).to(self.device)
                for t in tables]

    @staticmethod
    def _to_host(state) -> List[np.ndarray]:
        return [t.cpu().numpy() for t in state]

    def _fresh_state(self, draws: Draws, n_vertices: int) -> List[torch.Tensor]:
        """[emb_in, emb_out, acc_in, acc_out], word2vec's init; with
        hierarchical softmax the output table and its accumulator are
        theta's, zeros of n_inner rows."""
        state = list(draws.init(n_vertices, self.params.vector_size))
        if self.tree is not None:
            n_inner = self.tree.n_inner
            state[1] = torch.zeros((n_inner, self.params.vector_size), dtype=torch.float32,
                                   device=self.device)
            state[3] = torch.zeros((n_inner,), dtype=torch.float32, device=self.device)
        return state

    def _restored(self, tables) -> List[torch.Tensor]:
        """Snapshot tables on the device, their output rows checked against
        the objective (V rows with negative sampling, n_inner with
        hierarchical softmax)."""
        n_out = self.vocab.n_vertices if self.tree is None else self.tree.n_inner
        if tables[1].shape[0] != n_out or tables[3].shape[0] != n_out:
            raise ValueError(
                f"checkpoint output table has {tables[1].shape[0]} rows, this objective "
                f"needs {n_out} (negative={self.params.negative})"
            )
        self._host.clear()
        return self._to_device(tables)

    def _init_state(self, draws: Draws, checkpoint_dir: Optional[str]):
        """Fresh tables, or those of the newest train-state snapshot:
        (state [emb_in, emb_out, acc_in, acc_out], first epoch to run)."""
        state = self._fresh_state(draws, self.vocab.n_vertices)
        ckpt = load_train_state(checkpoint_dir)
        if ckpt is None:
            return state, 0
        logger.info("resuming training from epoch %d", ckpt[0])
        return self._restored(ckpt[1:]), ckpt[0]

    def _train(self, state, corpus, draws: Draws, step0: int, lr_slope: float,
               batch: int, n_batches: int, tables) -> torch.Tensor:
        """CBOW-HS, HS, CBOW-NS or SGNS (word2vec.py:711-758's order) over
        ``n_batches`` batches of ``corpus``, in place on ``state``; returns
        the per-batch losses."""
        p = self.params
        length = corpus.shape[1]
        kw = dict(batch=batch, n_batches=n_batches, window=p.window_size,
                  min_lr=p.min_step_size)
        if self.tree is not None:
            shrink = functools.partial(draws.window_shrink, n_walks=batch, length=length)
            if p.sg == 0:
                return cbow_hs_epoch(*state, corpus, shrink, step0, p.step_size, lr_slope,
                                     *tables, cbow_mean=p.cbow_mean, **kw)
            return hs_epoch(*state, corpus, shrink, step0, p.step_size, lr_slope, *tables,
                            head_offsets=self.head_offsets, **kw)
        step = functools.partial(draws.step, n_walks=batch, length=length)
        if p.sg == 0:
            return cbow_epoch(*state, corpus, step, step0, p.step_size, lr_slope, *tables,
                              negatives=p.negative, cbow_mean=p.cbow_mean, **kw)
        # only SGNS reads the optimizer (word2vec.py:167-182, :261): HS and
        # CBOW train row-wise Adagrad whatever it says
        return sgns_epoch(*state, corpus, step, step0, p.step_size, lr_slope, *tables,
                          negatives=p.negative, optimizer=p.optimizer,
                          slot=self._slot_map(state[2].shape[0]), **kw)

    def _epoch_name(self) -> str:
        """The name ``fit`` records an epoch under (word2vec.py:238, :878,
        :1000)."""
        p = self.params
        if p.sg == 0:
            return "cbow_epoch"
        return "hs_epoch" if p.negative == 0 else "sgns_epoch"

    def _slot_map(self, n_vertices: int) -> Optional[torch.Tensor]:
        """K11's slot map for SGD, made once a fit (scratch: never saved)."""
        if self.params.optimizer != "sgd":
            return None
        if self._slot is None:
            self._slot = new_slot_map(n_vertices, self.device)
        return self._slot

    def _finish(self, state) -> "Word2VecTorch":
        self._emb_in, self._emb_out, self.acc_in, self.acc_out = state
        self._host.clear()
        return self

    # -- the trainers -------------------------------------------------------- #

    def fit(
        self,
        walks,
        n_vertices: Optional[int] = None,
        verbose: bool = False,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1,
        timer=None,
    ) -> "Word2VecTorch":
        """Train embeddings over a walk corpus [N, L+1] int32 (-1 padded),
        given as a numpy array (counted on the host before the upload) or a
        torch tensor (counted on its device, by K6 on the card).

        With ``checkpoint_dir``, state is saved every ``checkpoint_every``
        epochs and fit() resumes from the newest saved epoch.  ``timer``
        (a ``StepTimer``) records each epoch's training and loss readback
        under the JAX package's name for the objective: "sgns_epoch",
        "hs_epoch" or "cbow_epoch".
        """
        self._begin()
        p = self.params
        dev = self.device
        if isinstance(walks, np.ndarray):
            walks = np.ascontiguousarray(walks, dtype=np.int32)
        self.vocab = build_vocab(
            walks, n_vertices, min_count=p.min_count, ns_exponent=p.ns_exponent
        )
        self._require_vocab()
        if isinstance(walks, np.ndarray):
            walks = torch.from_numpy(walks)
        walks = walks.to(device=dev, dtype=torch.int32)
        draws = self._new_draws()
        tables = self._objective()
        state, start_epoch = self._init_state(draws, checkpoint_dir)
        keep = self._keep_table()

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

        self._losses = []
        for epoch in range(start_epoch, p.max_iter):
            shuffled = corpus[draws.permutation(1_000_000 + epoch, n_padded)]
            if keep is not None:  # gensim subsampling, redrawn per epoch
                shuffled = draws.subsample(shuffled, keep, 2_000_000 + epoch)
            with measure(timer, self._epoch_name()):
                losses = self._train(state, shuffled, draws, epoch * n_batches, lr_slope,
                                     batch, n_batches, tables)
                epoch_loss = float(losses.mean())  # mean over batches
            self._losses.append(epoch_loss)
            if verbose:
                logger.info("epoch %d/%d loss=%.4f", epoch + 1, p.max_iter, epoch_loss)
            if checkpoint_dir and (epoch + 1) % checkpoint_every == 0:
                save_train_state(checkpoint_dir, epoch + 1, *self._to_host(state))
        return self._finish(state)

    def fit_host(
        self,
        walks: np.ndarray,
        n_vertices: Optional[int] = None,
        slab_walks: int = 1 << 20,
        verbose: bool = False,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1,
        timer=None,
    ) -> "Word2VecTorch":
        """Host-resident-corpus trainer: the corpus never lives on the device.

        Each epoch draws one global host permutation
        (``default_rng(seed * 1_000_003 + 17 + epoch)``, as the JAX package),
        cuts it into slabs of ``slab_walks`` rows (whole batches) and
        gathers and uploads each while the previous slab trains (its steps
        are queued on the card first); the tail slab is
        padded with dead rows, and its all-dead trailing batches are left out
        of the epoch loss.  ``self._slab_losses`` keeps each slab's mean loss;
        ``self._slab_events`` each upload's (copy start, copy end) events and
        each slab's (train start, train end) on the card.  With
        ``checkpoint_dir``, the train state is saved every
        ``checkpoint_every`` epochs and fit_host resumes from the newest.
        ``timer`` records each epoch's slab loop as "host_epoch".
        """
        self._begin()
        p = self.params
        walks = np.ascontiguousarray(walks, dtype=np.int32)
        self.vocab = build_vocab(
            walks, n_vertices, min_count=p.min_count, ns_exponent=p.ns_exponent
        )
        self._require_vocab()
        draws = self._new_draws()
        tables = self._objective()
        state, start_epoch = self._init_state(draws, checkpoint_dir)
        keep = self._keep_table()

        n_walks = len(walks)
        batch = _effective_batch(p.batch_walks, n_walks)
        slab = max((min(slab_walks, n_walks) // batch) * batch, batch)
        slab_batches = slab // batch
        n_slabs = -(-n_walks // slab)
        total_steps = max(p.max_iter * n_slabs * slab_batches, 1)
        lr_slope = float(np.float32(p.step_size / total_steps))
        # the tail slab's dead rows sit at its end, so its trailing batches
        # can be all padding: they train nothing and report loss 0
        tail_real = n_walks - (n_slabs - 1) * slab
        tail_real_batches = min(-(-tail_real // batch), slab_batches)

        uploader = _SlabUploader(walks, slab, self.device)
        timing = self.device.type == "cuda"
        self._losses = []
        self._slab_losses = []
        self._slab_events = []
        for epoch in range(start_epoch, p.max_iter):
            perm = np.random.default_rng(p.seed * 1_000_003 + 17 + epoch).permutation(n_walks)
            with measure(timer, "host_epoch"):
                pending = uploader.upload(perm, 0)
                epoch_losses = []
                for s in range(n_slabs):
                    slab_dev = uploader.ready(pending)
                    if timing:
                        t_start = torch.cuda.Event(enable_timing=True)
                        t_start.record()
                    if keep is not None:  # gensim subsampling, redrawn per slab
                        slab_dev = draws.subsample(slab_dev, keep,
                                                   4_000_000 + epoch * n_slabs + s)
                    step0 = (epoch * n_slabs + s) * slab_batches
                    losses = self._train(state, slab_dev, draws, step0, lr_slope, batch,
                                         slab_batches, tables)
                    if timing:
                        t_end = torch.cuda.Event(enable_timing=True)
                        t_end.record()
                        self._slab_events.append((t_start, t_end))
                    if s + 1 < n_slabs:  # gather and copy the next slab while it trains
                        pending = uploader.upload(perm, s + 1)
                    if s == n_slabs - 1:
                        losses = losses[:tail_real_batches]
                    epoch_losses.append(losses)
                    if (s + 1) % 4 == 0:
                        _sync(losses)  # bound the enqueue depth
            self._slab_losses.append([float(x.mean()) for x in epoch_losses])
            self._losses.append(float(torch.cat(epoch_losses).mean()))
            if verbose:
                logger.info("host epoch %d/%d loss=%.4f (%d slabs)",
                            epoch + 1, p.max_iter, self._losses[-1], n_slabs)
            if checkpoint_dir and (epoch + 1) % checkpoint_every == 0:
                save_train_state(checkpoint_dir, epoch + 1, *self._to_host(state))
        self._h2d_events = uploader.events
        return self._finish(state)

    def fit_streaming(
        self,
        walk_source: Callable[[int], torch.Tensor],
        n_chunks: int,
        n_vertices: int,
        verbose: bool = False,
        timer=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every_chunks: int = 0,
        source_token: str = "",
    ) -> "Word2VecTorch":
        """Train over a virtual corpus: ``walk_source(i)`` regenerates walk
        chunk i on the device (``WalkEngine.chunk_source``), always with
        the same number of rows.

        A first pass counts the vertices (``_streaming_counts``).  Each
        epoch then visits the chunks in ``default_rng(seed)``'s order for
        that epoch (all epochs drawn up front); a chunk is shuffled on the
        device, cut to whole batches (the tail rows beyond them are dropped,
        as in the JAX package) and trained, chunk i+1's walk enqueued first.

        With ``checkpoint_dir``, a snapshot (cursor, tables, Adagrad state,
        losses, pass-1 counts) is written at every epoch end and, when
        ``checkpoint_every_chunks`` > 0, every that many chunks; a restarted
        call resumes from it without the counting pass.  ``source_token``
        identifies the walk source (graph digest, walk params, walk seed),
        so a snapshot is never resumed against another virtual corpus.
        ``timer`` records each chunk's training call as "stream_chunk" (its
        enqueue on the card: the JAX package times the dispatch there too).
        """
        self._begin()
        p = self.params
        dev = self.device
        fp = stream_fingerprint(p, n_chunks, n_vertices, token=source_token)
        resume = load_stream_state(checkpoint_dir, fp)
        chunk_walks = None
        cur_losses = np.zeros(0, np.float32)
        prev_losses = np.zeros(0, np.float32)
        start_epoch = start_chunk = 0
        if resume is not None:
            (start_epoch, start_chunk, e_in, e_out, a_in, a_out,
             prev_losses, cur_losses, counts_host, chunk_walks) = resume
            logger.info("resuming streaming training at epoch %d chunk %d",
                        start_epoch, start_chunk)
        else:
            counts_host, _ = _streaming_counts(walk_source, n_chunks, n_vertices)
        self.vocab = build_vocab_from_counts(
            counts_host, min_count=p.min_count, ns_exponent=p.ns_exponent
        )
        self._require_vocab()
        tables = self._objective()  # HS: the tree from the pass-1 or the snapshot's counts
        keep = self._keep_table()
        draws = self._new_draws()
        if resume is not None:
            state = self._restored((e_in, e_out, a_in, a_out))
        else:
            state = self._fresh_state(draws, n_vertices)
        rng = np.random.default_rng(p.seed)
        # all epochs' chunk orders up front: a resume replays the same stream
        orders = [rng.permutation(n_chunks) for _ in range(p.max_iter)]

        self._losses = [float(x) for x in prev_losses]
        batch = n_batches = lr_slope = None
        step0 = 0

        def geometry(walks_per_chunk: int):
            b = _effective_batch(p.batch_walks, walks_per_chunk,
                                 target_updates=max(512 // n_chunks, 1))
            nb = walks_per_chunk // b
            slope = float(np.float32(p.step_size / max(p.max_iter * n_chunks * nb, 1)))
            return b, nb, slope

        if chunk_walks is not None:  # resume: geometry known from the snapshot
            batch, n_batches, lr_slope = geometry(chunk_walks)
            step0 = (start_epoch * n_chunks + start_chunk) * n_batches

        def snapshot(epoch_next: int, chunk_next: int, epoch_losses) -> None:
            cur = (torch.cat(epoch_losses).cpu().numpy() if epoch_losses
                   else np.zeros(0, np.float32))
            save_stream_state(
                checkpoint_dir, fp, epoch_next, chunk_next, *self._to_host(state),
                np.asarray(self._losses, np.float32), cur,
                counts=counts_host, chunk_walks=chunk_walks or 0,
            )

        for epoch in range(start_epoch, p.max_iter):
            order = orders[epoch]
            skip = start_chunk if epoch == start_epoch else 0
            if skip >= n_chunks:
                continue  # epoch-end snapshots normalize to (epoch + 1, 0)
            epoch_losses = []
            if epoch == start_epoch and len(cur_losses):
                epoch_losses.append(torch.from_numpy(np.asarray(cur_losses, np.float32)).to(dev))
            pending = walk_source(int(order[skip]))
            for i in range(skip, n_chunks):
                # prefetch: chunk i+1's walk is enqueued before chunk i trains
                nxt = walk_source(int(order[i + 1])) if i + 1 < n_chunks else None
                corpus = pending.to(device=dev, dtype=torch.int32)
                n_walks_c = corpus.shape[0]
                if chunk_walks is None:
                    chunk_walks = n_walks_c
                    batch, n_batches, lr_slope = geometry(n_walks_c)
                elif n_walks_c != chunk_walks:
                    raise ValueError(
                        f"walk_source chunk {int(order[i])} has {n_walks_c} walks, "
                        f"expected {chunk_walks}: streaming requires constant chunk "
                        "shapes (WalkEngine.chunk_source pads every chunk)"
                    )
                perm = draws.permutation(7_000_000 + epoch * n_chunks + i, n_walks_c)
                shuffled = corpus[perm][: n_batches * batch]
                if keep is not None:
                    shuffled = draws.subsample(shuffled, keep, 8_000_000 + epoch * n_chunks + i)
                with measure(timer, "stream_chunk"):
                    losses = self._train(state, shuffled, draws, step0, lr_slope, batch,
                                         n_batches, tables)
                step0 += n_batches
                epoch_losses.append(losses)
                pending = nxt
                if (i + 1) % 4 == 0:
                    _sync(losses)  # at most ~4 chunks of walk + train work queued
                if (checkpoint_dir and checkpoint_every_chunks > 0 and i + 1 < n_chunks
                        and (i + 1) % checkpoint_every_chunks == 0):
                    snapshot(epoch, i + 1, epoch_losses)
            self._losses.append(float(torch.cat(epoch_losses).mean()))
            if verbose:
                logger.info("streaming epoch %d/%d loss=%.4f", epoch + 1, p.max_iter,
                            self._losses[-1])
            if checkpoint_dir:
                snapshot(epoch + 1, 0, [])
        return self._finish(state)

    def fit_sharded(
        self,
        walks,
        mesh,
        n_vertices: Optional[int] = None,
        verbose: bool = False,
        table_sharding: str = "column",
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1,
    ) -> "Word2VecTorch":
        """Training over a (data × model) mesh (``parallel.make_mesh``),
        called on every rank with the whole corpus [N, L+1] (numpy or a
        tensor).

        ``table_sharding="column"``: each rank holds its model coordinate's
        columns of both tables and trains its data coordinate's rows of each
        batch (``parallel.sharded_sgns``).  As in the JAX package the batch
        is rounded to whole data shards, the corpus padded to whole batches
        and permuted once on the host (``default_rng(seed)``), and each data
        shard reshuffles its rows every epoch on the device; the draws are
        keyed on (seed, tag, step) and the data coordinate.  With ``sample >
        0`` each shard subsamples its rows as the whole corpus would be
        (K7 from the shard's flat position).  Checkpoints are the JAX
        package's file: every rank reads it, rank 0 writes the full tables.
        Afterwards ``emb_in``, ``emb_out`` and ``vectors`` are the full
        tables on every rank.

        ``table_sharding="row"`` (``_fit_row_sharded``): SGNS, or hierarchical
        softmax (``negative=0``, which needs this layout), with each rank
        owning the rows ``v ≡ rank (mod N)`` of both tables; the batch is
        rounded to whole ranks and the corpus cut to whole batches.
        """
        from node2vec_torch.parallel.sharded_sgns import (
            ShardedSGNSState,
            col_sgns_epoch,
            gather_columns,
            init_sharded_state,
            shard_columns,
        )

        p = self.params
        if p.sg == 0:
            raise ValueError(
                "CBOW (sg=0) is supported on the single-device and streaming trainers "
                "(fit/fit_streaming); the sharded trainers are skip-gram only — set sg=1 "
                "or train unsharded"
            )
        if p.negative == 0:
            if table_sharding != "row":
                raise ValueError(
                    "hierarchical softmax (negative=0) requires table_sharding='row' in the "
                    "sharded trainer (the inner-node table is row-sharded like the embeddings)"
                )
        if mesh.device.type != self.device.type:
            raise ValueError(f"the mesh runs on {mesh.device}, the model on {self.device}")
        if table_sharding == "row":
            return self._fit_row_sharded(walks, mesh, n_vertices, verbose, checkpoint_dir,
                                         checkpoint_every)
        self._begin()
        if isinstance(walks, torch.Tensor):
            walks = walks.cpu().numpy()
        walks = np.ascontiguousarray(walks, dtype=np.int32)
        self.vocab = build_vocab(
            walks, n_vertices, min_count=p.min_count, ns_exponent=p.ns_exponent
        )
        self._require_vocab()
        n_v = self.vocab.n_vertices
        n_data, n_model = mesh.shape["data"], mesh.shape["model"]
        if p.vector_size % n_model:
            raise ValueError(
                f"vector_size {p.vector_size} not divisible by model axis {n_model}"
            )
        d_idx = mesh.coords["data"]
        draws = Draws(p, self.shared_negatives, self.device, data_index=d_idx)
        state = init_sharded_state(mesh, n_v, p.vector_size, seed=p.seed, device=self.device)
        start_epoch = 0
        ckpt = load_train_state(checkpoint_dir)
        if ckpt is not None:
            start_epoch = ckpt[0]
            e_in, e_out, a_in, a_out = self._restored(ckpt[1:])
            state = ShardedSGNSState(shard_columns(mesh, e_in), shard_columns(mesh, e_out),
                                     a_in, a_out)
            del e_in, e_out
            logger.info("resuming sharded training from epoch %d", start_epoch)
        ns_alias, ns_prob, mask = self._objective()

        n_walks, length = walks.shape
        batch = _effective_batch(p.batch_walks, n_walks)
        batch -= batch % n_data
        batch = max(batch, n_data)
        batch_local = batch // n_data
        n_batches = -(-n_walks // batch)
        total_steps = max(p.max_iter * n_batches, 1)
        lr_slope = float(np.float32(p.step_size / total_steps))
        # the corpus padded to whole sharded batches and permuted once on
        # the host, so the data shards hold stratified rows (each epoch then
        # reshuffles within the shard)
        n_used = n_batches * batch
        corpus_host = np.full((n_used, length), -1, dtype=np.int32)
        corpus_host[: min(n_walks, n_used)] = walks[:n_used]
        corpus_host = corpus_host[np.random.default_rng(p.seed).permutation(n_used)]
        n_local = n_used // n_data
        row0 = d_idx * n_local
        corpus = torch.from_numpy(corpus_host[row0: row0 + n_local]).to(self.device)
        del corpus_host
        keep = self._keep_table()
        step = functools.partial(draws.step, n_walks=batch_local, length=length)

        self._losses = []
        for epoch in range(start_epoch, p.max_iter):
            ep_corpus = corpus
            if keep is not None:  # the shard's rows, drawn as in the whole corpus
                ep_corpus = draws.subsample(corpus.clone(), keep, 2_500_000 + epoch,
                                            base=row0 * length)
            losses = col_sgns_epoch(
                mesh, state, ep_corpus, draws.permutation(5_000_000 + epoch, n_local), step,
                epoch * n_batches, p.step_size, lr_slope, ns_alias, ns_prob, mask,
                batch_local=batch_local, n_batches=n_batches, window=p.window_size,
                negatives=p.negative, min_lr=p.min_step_size,
            )
            self._losses.append(float(losses.mean()))
            if verbose:
                logger.info("sharded epoch %d/%d loss=%.4f", epoch + 1, p.max_iter,
                            self._losses[-1])
            if checkpoint_dir and (epoch + 1) % checkpoint_every == 0:
                full = (gather_columns(mesh, state.emb_in), gather_columns(mesh, state.emb_out),
                        state.acc_in, state.acc_out)
                if mesh.rank == 0:
                    save_train_state(checkpoint_dir, epoch + 1, *self._to_host(full))
                mesh.barrier()  # no rank reads the file before it is whole
        return self._finish((gather_columns(mesh, state.emb_in),
                             gather_columns(mesh, state.emb_out), state.acc_in, state.acc_out))

    # -- the row-sharded trainers ------------------------------------------ #

    def _row_objective(self, mesh):
        """The step's device tables (``_objective``), and for hierarchical
        softmax the head split over the sharded theta: the JAX package's
        ``head_level_offsets(tree, table_rows=ceil(n_inner / N))``."""
        tables = self._objective()
        if self.tree is not None:
            self.head_offsets = head_level_offsets(
                self.tree, table_rows=-(-self.tree.n_inner // mesh.n_devices))
        return tables

    def _row_state(self, mesh, host=None):
        """This rank's row state: word2vec's init, or from full host tables
        (a checkpoint's) with their output rows checked."""
        from node2vec_torch.parallel import rowsharded_hs as rh
        from node2vec_torch.parallel import rowsharded_sgns as rs

        p = self.params
        n_v = self.vocab.n_vertices
        if host is not None:
            n_out = n_v if self.tree is None else self.tree.n_inner
            if host[1].shape[0] != n_out or np.asarray(host[3]).shape[0] != n_out:
                raise ValueError(
                    f"checkpoint output table has {host[1].shape[0]} rows, this objective "
                    f"needs {n_out} (negative={p.negative})"
                )
            if self.tree is None:
                return rs.row_state_from_host(mesh, *host, device=self.device)
            return rh.hs_state_from_host(mesh, *host, device=self.device)
        if self.tree is None:
            return rs.init_row_state(mesh, n_v, p.vector_size, seed=p.seed, device=self.device)
        return rh.init_hs_row_state(mesh, n_v, self.tree.n_inner, p.vector_size, seed=p.seed,
                                    device=self.device)

    def _row_to_host(self, mesh, state) -> Tuple[np.ndarray, ...]:
        """The full logical tables and accumulators, on every rank (a
        collective)."""
        from node2vec_torch.parallel import rowsharded_hs as rh
        from node2vec_torch.parallel import rowsharded_sgns as rs

        if self.tree is None:
            return rs.row_state_to_host(mesh, state)
        return rh.hs_state_to_host(mesh, state)

    def _row_epoch(self, mesh, state, corpus, draws: Draws, step0: int, lr_slope: float,
                   batch_local: int, n_batches: int, tables):
        """One row-sharded epoch over this rank's rows, shuffled by the
        rank's draws (tag 0x5F5E1): (losses, dropped) on the device."""
        from node2vec_torch.parallel.rowsharded_hs import row_hs_epoch
        from node2vec_torch.parallel.rowsharded_sgns import row_sgns_epoch

        p = self.params
        length = corpus.shape[1]
        perm = draws.permutation(0x5F5E1, corpus.shape[0])
        kw = dict(batch_local=batch_local, n_batches=n_batches, window=p.window_size,
                  min_lr=p.min_step_size)
        if self.tree is not None:
            shrink = functools.partial(draws.window_shrink, n_walks=batch_local, length=length)
            return row_hs_epoch(mesh, state, corpus, perm, shrink, step0, p.step_size, lr_slope,
                                *tables, head_offsets=self.head_offsets, **kw)
        step = functools.partial(draws.step, n_walks=batch_local, length=length)
        return row_sgns_epoch(mesh, state, corpus, perm, step, step0, p.step_size, lr_slope,
                              *tables, negatives=p.negative,
                              shared_negatives=self.shared_negatives, **kw)

    def _row_finish(self, mesh, state, dropped) -> "Word2VecTorch":
        """Warn of rows dropped to capacity, as the JAX trainers do (and keep
        their count in ``dropped_rows``), and keep the full tables on every
        rank."""
        total = self.dropped_rows = int(round(float(dropped)))
        if total:
            logger.warning(
                "row-sharded training dropped %d routed rows to capacity overflow (raise "
                "cap_slack or batch size)", total,
            )
        return self._finish(self._to_device(self._row_to_host(mesh, state)))

    def _row_draws(self, mesh, key: int) -> Draws:
        return Draws(self.params, self.shared_negatives, self.device, data_index=mesh.rank,
                     key=key)

    def _fit_row_sharded(self, walks, mesh, n_vertices, verbose: bool,
                         checkpoint_dir: Optional[str], checkpoint_every: int
                         ) -> "Word2VecTorch":
        """The row-sharded trainers, SGNS and HS (word2vec.py:1517-1772):
        the batch rounded to whole ranks, the corpus cut to whole batches
        (floor: the tail is dropped), padded with -1 rows, permuted once by
        ``default_rng(seed)`` and split into contiguous blocks over the flat
        ranks; each epoch every rank reshuffles its block on the device.
        ``sample > 0``: each rank subsamples its rows with K7 from their
        position in the corpus."""
        p = self.params
        self._begin()
        if isinstance(walks, torch.Tensor):
            walks = walks.cpu().numpy()
        walks = np.ascontiguousarray(walks, dtype=np.int32)
        self.vocab = build_vocab(
            walks, n_vertices, min_count=p.min_count, ns_exponent=p.ns_exponent
        )
        self._require_vocab()
        n_dev = mesh.n_devices
        tables = self._row_objective(mesh)
        ckpt = load_train_state(checkpoint_dir)
        start_epoch = 0 if ckpt is None else ckpt[0]
        state = self._row_state(mesh, None if ckpt is None else ckpt[1:])
        if ckpt is not None:
            logger.info("resuming row-sharded training from epoch %d", start_epoch)

        n_walks, length = walks.shape
        batch = max(_effective_batch(p.batch_walks, n_walks, floor=n_dev) // n_dev, 1) * n_dev
        batch_local = batch // n_dev
        n_batches = max(n_walks // batch, 1)
        n_used = n_batches * batch
        corpus_host = np.full((n_used, length), -1, dtype=np.int32)
        corpus_host[: min(n_walks, n_used)] = walks[:n_used]
        corpus_host = corpus_host[np.random.default_rng(p.seed).permutation(n_used)]
        n_local = n_used // n_dev
        row0 = mesh.rank * n_local
        corpus = torch.from_numpy(corpus_host[row0: row0 + n_local]).to(self.device)
        del corpus_host
        total_steps = max(p.max_iter * n_batches, 1)
        lr_slope = float(np.float32(p.step_size / total_steps))
        keep = self._keep_table()

        self._losses = []
        dropped = torch.zeros((), dtype=torch.float32, device=self.device)
        for epoch in range(start_epoch, p.max_iter):
            draws = self._row_draws(mesh, epoch)
            ep_corpus = corpus
            if keep is not None:  # the rank's rows, drawn as in the whole corpus
                ep_corpus = draws.subsample(corpus.clone(), keep, 3_000_000 + epoch,
                                            base=row0 * length)
            losses, d = self._row_epoch(mesh, state, ep_corpus, draws, epoch * n_batches,
                                        lr_slope, batch_local, n_batches, tables)
            dropped = dropped + d
            self._losses.append(float(losses.mean()))
            if verbose:
                logger.info("row-sharded epoch %d/%d loss=%.4f", epoch + 1, p.max_iter,
                            self._losses[-1])
            if checkpoint_dir and (epoch + 1) % checkpoint_every == 0:
                host = self._row_to_host(mesh, state)
                if mesh.rank == 0:
                    save_train_state(checkpoint_dir, epoch + 1, *host)
                mesh.barrier()  # no rank reads the file before it is whole
        return self._row_finish(mesh, state, dropped)

    def fit_streaming_sharded(
        self,
        walk_source: Callable[[int], torch.Tensor],
        n_chunks: int,
        mesh,
        n_vertices: int,
        table_sharding: str = "row",
        verbose: bool = False,
        timer=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every_chunks: int = 0,
        source_token: str = "",
    ) -> "Word2VecTorch":
        """A virtual corpus into the row-sharded tables (word2vec.py:
        1045-1344), SGNS or hierarchical softmax, called on every rank with
        ``walk_source(i)`` giving every rank chunk i whole
        (``WalkEngine.chunk_source``, with or without a mesh).

        A first pass counts the vertices (``_streaming_counts``).  Each
        epoch visits the chunks in ``default_rng(seed)``'s order; a chunk is
        padded with -1 rows to whole ranks and stride-interleaved, rank r
        taking rows r, r + N, ... (a walk chunk is a contiguous vertex
        range, and the ranks' shuffles never cross ranks).  Each rank
        shuffles its rows, subsamples them with K7 from their position in
        the interleaved chunk when ``sample > 0``, and trains its whole
        batches.  Snapshots and resume are ``fit_streaming``'s (the JAX
        stream-state file), the source token marked ``"|row-sharded"``; a
        resumed run replays the uninterrupted one.  ``timer`` records each
        chunk's training as "stream_chunk".
        """
        p = self.params
        if p.sg == 0:
            raise ValueError(
                "CBOW (sg=0) is supported on the single-device and streaming trainers "
                "(fit/fit_streaming); the sharded trainers are skip-gram only — set sg=1 "
                "or train unsharded"
            )
        if table_sharding != "row":
            raise ValueError(
                "streaming sharded training requires table_sharding='row' (column mode "
                "replicates the full table per data shard — materialize the corpus and use "
                "fit_sharded instead)"
            )
        if mesh.device.type != self.device.type:
            raise ValueError(f"the mesh runs on {mesh.device}, the model on {self.device}")
        self._begin()
        dev = self.device
        n_dev, rank = mesh.n_devices, mesh.rank
        fp = stream_fingerprint(p, n_chunks, n_vertices, token=source_token + "|row-sharded")
        resume = load_stream_state(checkpoint_dir, fp)
        chunk_walks = None
        cur_losses = np.zeros(0, np.float32)
        prev_losses = np.zeros(0, np.float32)
        start_epoch = start_chunk = 0
        host = None
        if resume is not None:
            (start_epoch, start_chunk, e_in, e_out, a_in, a_out,
             prev_losses, cur_losses, counts_host, chunk_walks) = resume
            host = (e_in, e_out, a_in, a_out)
            logger.info("resuming row-sharded streaming training at epoch %d chunk %d",
                        start_epoch, start_chunk)
        else:
            counts_host, _ = _streaming_counts(walk_source, n_chunks, n_vertices)
        self.vocab = build_vocab_from_counts(
            counts_host, min_count=p.min_count, ns_exponent=p.ns_exponent
        )
        self._require_vocab()
        tables = self._row_objective(mesh)
        keep = self._keep_table()
        state = self._row_state(mesh, host)
        del host
        rng = np.random.default_rng(p.seed)
        orders = [rng.permutation(n_chunks) for _ in range(p.max_iter)]

        self._losses = [float(x) for x in prev_losses]
        batch_local = n_batches = lr_slope = None
        step0 = 0

        def geometry(walks_per_chunk: int):
            b = max(_effective_batch(p.batch_walks, walks_per_chunk, floor=n_dev,
                                     target_updates=max(512 // n_chunks, 1)) // n_dev, 1)
            nb = max((walks_per_chunk // n_dev) // b, 1)
            slope = float(np.float32(p.step_size / max(p.max_iter * n_chunks * nb, 1)))
            return b, nb, slope

        if chunk_walks is not None:  # resume: geometry known from the snapshot
            batch_local, n_batches, lr_slope = geometry(chunk_walks)
            step0 = (start_epoch * n_chunks + start_chunk) * n_batches

        def snapshot(epoch_next: int, chunk_next: int, epoch_losses) -> None:
            cur = (torch.cat(epoch_losses).cpu().numpy() if epoch_losses
                   else np.zeros(0, np.float32))
            full = self._row_to_host(mesh, state)  # a collective: every rank
            if rank == 0:
                save_stream_state(
                    checkpoint_dir, fp, epoch_next, chunk_next, *full,
                    np.asarray(self._losses, np.float32), cur,
                    counts=counts_host, chunk_walks=chunk_walks or 0,
                )
            mesh.barrier()

        dropped = torch.zeros((), dtype=torch.float32, device=dev)
        for epoch in range(start_epoch, p.max_iter):
            order = orders[epoch]
            skip = start_chunk if epoch == start_epoch else 0
            if skip >= n_chunks:
                continue  # epoch-end snapshots normalize to (epoch + 1, 0)
            epoch_losses = []
            if epoch == start_epoch and len(cur_losses):
                epoch_losses.append(torch.from_numpy(np.asarray(cur_losses, np.float32)).to(dev))
            pending = walk_source(int(order[skip]))
            for i in range(skip, n_chunks):
                # prefetch: chunk i+1's walk is enqueued before chunk i trains
                nxt = walk_source(int(order[i + 1])) if i + 1 < n_chunks else None
                chunk = pending.to(device=dev, dtype=torch.int32)
                if chunk.shape[0] % n_dev:  # dead rows to whole ranks
                    pad = torch.full((n_dev - chunk.shape[0] % n_dev, chunk.shape[1]), -1,
                                     dtype=torch.int32, device=dev)
                    chunk = torch.cat([chunk, pad])
                n_walks_c, length = chunk.shape
                if chunk_walks is None:
                    chunk_walks = n_walks_c
                    batch_local, n_batches, lr_slope = geometry(n_walks_c)
                elif n_walks_c != chunk_walks:
                    raise ValueError(
                        f"walk_source chunk {int(order[i])} has {n_walks_c} walks, "
                        f"expected {chunk_walks}: streaming requires constant chunk shapes "
                        "(WalkEngine.chunk_source pads every chunk)"
                    )
                n_local = n_walks_c // n_dev
                local = chunk[rank::n_dev].contiguous()  # the stride-interleaved block
                draws = self._row_draws(mesh, 9_000_000 + epoch * n_chunks + i)
                if keep is not None:
                    local = draws.subsample(local, keep, 10_000_000 + epoch * n_chunks + i,
                                            base=rank * n_local * length)
                with measure(timer, "stream_chunk"):
                    losses, d = self._row_epoch(mesh, state, local, draws, step0, lr_slope,
                                                batch_local, n_batches, tables)
                dropped = dropped + d
                step0 += n_batches
                epoch_losses.append(losses)
                pending = nxt
                if (i + 1) % 4 == 0:
                    _sync(losses)  # at most ~4 chunks of walk + train work queued
                if (checkpoint_dir and checkpoint_every_chunks > 0 and i + 1 < n_chunks
                        and (i + 1) % checkpoint_every_chunks == 0):
                    snapshot(epoch, i + 1, epoch_losses)
            self._losses.append(float(torch.cat(epoch_losses).mean()))
            if verbose:
                logger.info("streaming row-sharded epoch %d/%d loss=%.4f", epoch + 1,
                            p.max_iter, self._losses[-1])
            if checkpoint_dir:
                snapshot(epoch + 1, 0, [])
        return self._row_finish(mesh, state, dropped)

    @property
    def losses(self) -> list:
        """Mean loss of each epoch of the last fit."""
        return list(self._losses)

    def _host_table(self, key: str, table: Optional[torch.Tensor]) -> Optional[np.ndarray]:
        """The table as numpy, read back from the device once and cached
        until training or an assignment writes it."""
        if table is None:
            return None
        if key not in self._host:
            self._host[key] = table.cpu().numpy()
        return self._host[key]

    def _on_device(self, value) -> Optional[torch.Tensor]:
        if value is None:
            return None
        if isinstance(value, torch.Tensor):
            return value.detach().to(device=self.device, dtype=torch.float32).contiguous()
        return torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32)).to(self.device)

    @property
    def emb_in(self) -> Optional[np.ndarray]:
        """Input table [V, D] as numpy (read back from the device on the
        first access after training or an assignment, then cached)."""
        return self._host_table("in", self._emb_in)

    @emb_in.setter
    def emb_in(self, value) -> None:
        """A numpy array or tensor, put on the model's device."""
        self._emb_in = self._on_device(value)
        self._host.pop("in", None)

    @property
    def emb_out(self) -> Optional[np.ndarray]:
        """Output table as numpy: [V, D] with negative sampling, theta
        [n_inner, D] with hierarchical softmax (cached as ``emb_in``)."""
        return self._host_table("out", self._emb_out)

    @emb_out.setter
    def emb_out(self, value) -> None:
        self._emb_out = self._on_device(value)
        self._host.pop("out", None)

    @property
    def vectors(self) -> np.ndarray:
        """Input embedding table [V, D] (word2vec convention: input side)."""
        if self._emb_in is None:
            raise RuntimeError("model not fitted yet")
        return self.emb_in

    def vector(self, vertex_id: int) -> np.ndarray:
        v = self.vectors[vertex_id]
        if self.vocab is not None and not self.vocab.mask[vertex_id]:
            raise KeyError(f"vertex {vertex_id} below min_count (not in vocabulary)")
        return v
