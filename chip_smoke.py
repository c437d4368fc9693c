#!/usr/bin/env python3
"""Smoke run of the PyTorch port (node2vec_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run, one card
    python3 chip_smoke.py --quick    # build + kernel checks at small shapes only

Phases, each printing JSON lines as it goes (a cut run keeps what it printed):

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build: every kernel in node2vec_torch/csrc with nvcc (sm_90a), timed;
3. kernel checks on the card, each kernel's wrapper against its plain
   PyTorch version on the same inputs:
   - K1 dense_walk on the smoke graph at (p, q) = (0.25, 4) and (1, 1),
     131,072 walkers: unit weights and power-of-two p, q make every partial
     sum exact, so the paths must be bit-equal;
   - K2 sgns_grads, K3 adagrad_accumulate, K4 adagrad_apply: one step at
     V = 131,072, D = 128, S = 64, window 5, L1 = 21, at the main path's
     batch and at B = 8192; rtol 1e-4, atol 1e-6, because fp32 atomics
     reorder the sums (a tensor whose entries sum many signed terms, as
     d_no, K11's sums, theta under a Huffman path's root and the CBOW
     steps' tables, to rtol 1e-4 of its largest entry);
   - K5 blocked_walk on the heavy-tail RMAT (scale 19, 8 * 2^19 drawn
     edges, numpy seed 0, undirected, max_out_degree 10,000, self loops
     kept; the graph of bench.py:807-821), 131,072 walkers x 20 steps at
     (p, q, max_trials) = (0.25, 4, 64), (1, 1, 64), (1, 4, 64) and
     (0.25, 4, 2): unit weights, so paths, fallbacks and attempts must be
     bit-equal; its bound counts each table byte the run reads once
     (distinct rows and sectors, from the plain run);
4. edge cases the main paths do not reach (K1 at P = 8 .. 256 with sinks,
   dead lanes and general weights; the SGNS step at other shapes; K5 with
   sinks and dead lanes, at P = 8 / C = 64, on a hub of degree 20,000
   (C = 512), and on general weights by chi-square with a heavy current
   vertex and a heavy previous vertex), and a small reference: the
   Quickstart on the karate graph with device="cuda" (in 64-walker chunks)
   and device="cpu" gives bit-equal walks;
5. the dense main path: ``Node2Vec(device="cuda")`` through
   preprocess_input_graph -> random_walk -> fit -> embedding on the
   dense-engine graph (131,072 vertices, 2,097,152 drawn undirected
   unit-weight edges, numpy seed 0), p = 0.25, q = 4, num_walks 10,
   walk_length 20, dim 128, window 5, negative 5, min_count 10, max_iter cut
   to 1 epoch; launch counts are reset just before and read just after, and
   K1-K4 must have run;
6. the blocked main path: ``Node2Vec(device="cuda", max_out_degree=10_000)``
   through preprocess_input_graph -> run_pipeline(streaming=False) ->
   embedding on the RMAT graph of 3., same parameters (max_iter cut to 1,
   streaming forced off: the in-memory trainer on the RMAT); K5, K6 and
   K2-K4 must have run the expected number of times; then K6 against its
   plain version and torch.bincount on that run's corpus;
6a. the mesh main path, ``main_path_mesh``: ``Node2Vec(mesh=make_mesh(1,
   1))``, a world of one over NCCL, through ``run_pipeline()`` on the dense
   graph of 5. with its parameters (max_iter cut to 1): walks sharded over
   the data axis (K1 10 times through sharded_dense_walk_chunk, bit-equal
   to 5.'s) and ``fit_sharded`` with the column layout (K13's pair lists,
   K16 col_pair_logits, K17 col_pair_grads, K3's squares mode and K4 512
   times each, K2 never), its rates beside 5.'s, the profiled fit with the
   collectives' host and device shares of it, from its trace; then
   ``random_walk()`` on the RMAT at 1 x 1 (K5 through
   sharded_blocked_walk_chunk) bit-equal to 6.'s walks;
6b. ``mesh_ranks``: two ranks sharing the card over gloo
   (``parallel.launch.spawn``; every collective copied through host
   memory), at meshes 2 x 1 and 1 x 2: the dense, blocked and CSR engines'
   sharded walks bit-equal to the single-device engine's, one column step
   at the main path's batch against ``sharded_sgns_step_plain`` (its wall
   and collective time), the dense delta all-reduce at 2 x 1 timed, and the
   quality gate of 10. through ``Node2Vec(mesh=).run_pipeline()`` at the
   SGNS limits; at 2 x 1 also the row layout (``_row_rank_checks``): one
   routed SGNS step and one HS step at the main path's batch against the
   same steps through the plain versions, a step whose capacity drops rows
   (the dropped counts equal), the routed step's wall and collective time,
   and the quality gates through ``Node2Vec(mesh=,
   table_sharding="row").run_pipeline()`` for SGNS and HS at their limits;
7. the streaming main path: the same Node2Vec on the same RMAT through
   ``run_pipeline()`` with no argument, which streams over its 40 walker
   chunks (max_iter cut to 1): K5 40 times for the counting pass and 40
   per epoch for training, K6 40 times (the streaming form, out=), K2-K4
   40 x 16 per epoch, K1 never; walk-regeneration time from CUDA events
   around every chunk, fit time, pair-updates/s and peak device memory.
   Then a resume drill: fit_streaming with a checkpoint directory and a
   snapshot every 8 chunks, killed by an exception from walk_source at
   the chunk in position 20 and run again; it must finish from the
   snapshot at chunk 16 without a counting pass (K5 24 launches, K6 none),
   with finite tables and the full loss list.  Then K6's streaming form
   over the 40 chunk_source chunks against K6 over the in-memory corpus,
   torch.bincount and the plain version;
8. the host-corpus main path: ``Node2Vec(device="cuda", host_corpus=True)``
   on the dense graph of 5. with sample=1e-3 through run_pipeline(): K1
   10 times, K7 once a slab and epoch, K2-K4 once a batch of each slab;
   H2D time of each slab (events on the copy stream) and how much of it
   the training stream hid; then K7 against its plain version at that
   path's slab shape (bit-equal), an all-dead slab, a keep table of ones,
   in place against out of place, and a z-test of the keep count;
9. the hierarchical-softmax main path: ``Node2Vec(device="cuda")`` on the
   dense graph of 5. with negative=0 (the reference's default objective)
   through ``run_pipeline()`` with no argument, which streams over its 10
   walker chunks (max_iter cut to 1): K1 10 times to count and 10 to
   train, K6 10 times (streaming form), K8 hs_grads and K3/K4 10 x 51,
   K2 never; the tree's code length, head levels and rows, fit time,
   pair-updates/s, walk regeneration and peak device memory;
9a. the CBOW main paths on the dense graph of 5. (max_iter cut to 1):
   ``main_path_cbow``, sg=0 with negative 5 through ``run_pipeline()``
   with no argument (10 chunks: K1 20, K6 10, K9 cbow_grads and K3/K4
   10 x 51, K2, K8 and K10 never; trainable-center updates per training
   second), and ``main_path_cbow_hs``, sg=0 with negative=0 through
   ``host_corpus=True`` and sample=1e-3 (fit_host: K1, K7, K10
   cbow_hs_grads and K3/K4, K2, K8 and K9 never; its tree and H2D
   events), each followed by its ``breakdown`` line;
9b. ``main_path_sgd``: the dense graph of 5. with optimizer="sgd",
   step_size 0.025 through ``run_pipeline()`` with no argument (10 chunks:
   K1 20, K6 10, K2, K11 preagg_rows and sgd_apply 10 x 51, K3/K4 never),
   and ``main_path_csr``: ``WalkEngine(rmat, params, strategy="csr",
   device="cuda").run_device()`` on the RMAT of 3. (K12 csr_walk 40 times,
   K1 and K5 never; walk steps/s, DeviceGraph bytes), then
   ``Word2VecTorch.fit`` for one epoch on that corpus; each followed by its
   ``breakdown`` line;
9a'. the row-sharded main paths, ``main_path_mesh_row`` and
   ``main_path_mesh_row_hs``: ``Node2Vec(mesh=make_mesh(1, 1),
   table_sharding="row")`` over NCCL through ``run_pipeline()`` on the
   dense graph of 5. (max_iter cut to 1), which streams over its 10 chunks
   into ``fit_streaming_sharded``: per step K18 route_plan, K19's gather
   and pack twice each, K2's routed mode (K8's with negative=0, its 9 head
   levels all-gathered), K3's squares mode and K4 once (K3 once for HS's
   head rows), K2 and K8 direct never, no row dropped; rates beside
   ``main_path``'s, ``main_path_streaming``'s and ``main_path_hs``'s, peak
   memory, and the profiled fit with the collectives' share of it (as 6a.);
9c. ``surface`` (right after 5., on its model): ``save_model`` ->
   ``load_model`` into a new ``Node2Vec(device="cuda")`` (tables, counts,
   mask and names bit-equal), ``save_vectors`` -> ``load_vectors``, the
   functional ``trim_index`` -> ``random_walk`` on the edge list (walks
   equal to ``WalkEngine.run``'s), a ``StepTimer`` through
   ``WalkEngine.run`` and ``fit`` (max_iter 2), and one ``alias_draw``
   (K15) from every vertex; then ``main_path_pairs``: the Quickstart walks
   (K1), ``build_vocab`` (K6) and one epoch of ``sgns_train_step`` at
   B = 2,560 (512 steps: K13's pair lists and gradients and K3/K4 512
   times each, K2 never), and ``main_path_fused``: ``sgns_epoch_fused``
   from ``init_fused_embeddings`` on the same corpus and draws (K2 at row
   stride 129 and K14 512 times each, K3/K4 never), each holding its
   first 3 steps to the plain versions and printing its losses (no
   quality gate: no JAX trainer reaches these steps);
9d. the shared-list main paths: ``main_path_shared_lists``,
   ``Node2Vec(..., shared_lists=True).run_pipeline()`` on the RMAT of 3.,
   streamed as 7. (K5 in its mixed shared-list mode 80 times, K6 40,
   K2-K4 40 x 16; token "blocked+sl"), and ``main_path_shared_lists_er``,
   ``WalkEngine(strategy="blocked", shared_lists=True).run_device()`` on the
   dense graph of 5., whose lists are exhaustive (K5 in that mode 10
   times, token "blocked+slx"), then ``fit`` for one epoch; each followed
   by its ``breakdown`` lines;
10. quality gates on synthetic_multilabel(2000, seed=0) with num_walks 8,
   walk_length 40, dim 128, max_iter 5, min_count 1, p = q = 1: held-out
   link-prediction AUC >= 0.60, and the same-label minus no-shared-label
   mean cosine >= 0.05; on the engine the graph selects (dense) through
   fit, on blocked tables at P = 8, C = 64, where most vertices are heavy,
   through run_pipeline() at walker_chunk 2048 (it streams over 8
   chunks), and through host_corpus=True with sample=1e-3; then with
   negative=0 (HS) through fit, run_pipeline() at walker_chunk 2048 and
   host_corpus=True with sample=1e-3 (the JAX package's HS values on the
   CPU clear the same limits, PERF.md section 2); then CBOW with limits of
   its own, two thirds of the JAX package's margin over a broken trainer:
   CBOW-NS through fit (AUC >= 0.57, gap >= 0.045) and CBOW-HS through
   run_pipeline() at walker_chunk 2048 (AUC >= 0.55, gap >= 0.033); then
   SGNS with optimizer="sgd", step_size 0.025, by the same rule: through
   fit (AUC >= 0.58, gap >= 0.145) and run_pipeline() at walker_chunk 2048
   (AUC >= 0.575, gap >= 0.135); then the shared-list sampler on blocked
   tables at P = 8, C = 64 through fit at (p, q) = (1, 2) (the sampler is
   off at q == 1), at the blocked SGNS limits; then ``main_path_wide``: the
   node2vec paper's walk_length 80 and window 10 at widths past shared
   memory, SGNS and HS at dim 256 through fit at the SGNS and HS limits,
   CBOW-NS at dim 256 and CBOW-HS at dim 512 through fit for one epoch and
   8 steps of ``sgns_train_step`` at dim 256 (every K2, K8, K9, K10, K13
   launch staged in global memory, losses and tables finite);
11. the ``kernels`` line (times, bounds, launches, errors; K16, K17 and K3's
   squares mode from 6a.; K18, K19's gather and pack and K2's routed mode
   from 9a'., K8's routed mode from its HS run; K6 once for each
   JAX function it replaces, K3/K4 once for SGNS, once for HS's row lists,
   once for CBOW-HS's and once for the pair step's, K2 once more at row
   stride D + 1, K5 once for each shared-list mode, and K2, K8, K9, K10 and
   K13 once more in global staging; the staging kernels' rows say their
   mode), then the last line ``{"ok": true, "device": {...}}``.

Kernel checks of 3. also hold K8 hs_grads and K3/K4 over HS's three row
lists (emb_in rows, theta's tail rows, theta's head rows) against their
plain versions on the dense graph's Huffman tree (counts proportional to
degree: code length 18, a head of 9 levels and 511 rows, 131,071 inner
nodes), D = 128, L1 = 21, window 5, at the HS path's batch (2,570) and at
B = 8192, with the tolerances of the SGNS step; edge cases 4. add the head
off, a code length capped at 8 (no tail), a one-vertex vocabulary, walk
length 80, and D = 100 at window 10, with dead lanes and
out-of-vocabulary positions in every case.  They hold K9 cbow_grads, K10
cbow_hs_grads (on the same tree, without its head: CBOW-HS updates every
path entry per occurrence) and K3/K4 over CBOW-HS's row lists the same
way, on main_path_hs's first chunk at its batch (cbow_mean True and False)
and at B = 8192; edge cases add dead lanes with 20% of the vertices out of
the vocabulary, all-dead walks, centers with no context, window >= L1,
walk length 81, D = 100 at window 10, and 2-position walks, where K9's
loss equals K2's under the same draws.  They hold K11 preagg_rows,
sgd_apply and K3/K4 over the de-duplicated lists, and both pre-aggregated
steps (optimizer="sgd"; preagg=True with Adagrad), against their plain
versions on main_path_sgd's batch (2,570 walks of its first chunk,
shuffled) and at B = 8192 (sums to rtol 1e-4 of their largest entry,
heads and counts exactly, the slot map back to empty); edge cases add dead
lanes with 20% of the vertices out of the vocabulary, all-dead walks, a
one-vertex batch and a 48-vertex batch whose repeated negatives are all
heads.  They hold K12 csr_walk bit-equal to its plain version on the
dense graph and the RMAT (131,072 walkers x 20) at (p, q) = (0.25, 4),
(1, 1) and (1, 5) (K = 2 by Python's half-even rounding); edge cases add
sinks and dead lanes, the forced back edge at a degree-1 vertex, and a
chi-square on general weights.  They hold K13 (pair lists bit-equal,
per-lane gradients elementwise) and K3/K4 over its pair lists, with and
without the shrink and with 40% of the vertices out of the vocabulary, K2
at row stride D + 1 against its plain version and against K2 at stride D
(both timed), K14 with repeated rows, dead rows and a negative that is
also a center, and K15 bit-equal on the dense graph's CSR alias tables and
on degree-0/1 lanes, with a chi-square against general edge weights, at
the main paths' batch (B = 2,560); and K2-K4 at dim 64, the width the JAX
package packs.  They hold K5's shared-list modes (check_blocked_walk_sl)
bit-equal to the plain version at (p, q) = (0.25, 4) and (1, 5) on the RMAT
(mixed) and on the dense graph packed as blocked tables at P = 31
(exhaustive), 131,072 walkers x 20, with attempts/step and times on the
same walkers without the lists, the slq bytes, build seconds and overflow
share (bound: check_blocked_walk's plus 64 B an slq entry fetched); edge
cases for them (edge_cases_sl: P = 32's 256-lane rows, absent reverse
edges, sinks and dead lanes, the exhaustive ring hub, the two-hub overflow
edge with a chi-square, q == 1 with the table bit-equal to none); and
check_wide: K2, K13, K9 and K8 at L1 = 81, D = 256, window 10, S = 64
and K10 at D = 512, which stage in global memory, against their plain
versions at their checks' tolerances, timed with their bounds, at the
shapes main_path_wide launches (K2, K8, K9, K10: its fits' 64-walk batch
of the quality graph's corpus, with that corpus's vocabulary and Huffman
tree; K13: its B = 256 batch of the dense graph's walks), the kernels
line's global-staging rows; then K2, K9, K8 and K10 at B = 256 random
walks on the dense graph's tree.  They hold K16 col_pair_logits, K17
col_pair_grads and K3's squares mode against their plain versions on the
same batch at Dm = 128 (one model rank) and Dm = 64 (two, their all-reduce
summed in the check), K16 then K17 against K13 at Dm = 128, and the whole
column step on the 1 x 1 NCCL mesh against its plain version.  ``check_route``
holds K18 route_plan bit-equal to its plain version on the row main path's
batch (2,570 walks of the dense graph's first chunk and 64 negatives) at N
= 1, 2, 4, 8 and at a capacity that drops rows, K19's gather bit-equal and
its pack, K2's routed mode and K8's (on the dense graph's tree, its head of
9 levels) to their plain versions, and at N = 1 the routed modes to K2 and
K8 direct (K2's routed mode also at N = 2 with rows and negatives dropped).

``--quick`` runs 2-4 at small shapes (with K16, K17, K3's squares mode,
``check_route`` and ``mesh_ranks`` on a 4,096-vertex graph, without the
gates) (K5, its shared-list modes and K12 on
the RMAT at scale 12,
K6 and its streaming form on its walks, K7 on them, K8, K9 and K10 on a
4,096-vertex tree, K11 and sgd_apply on 64 walks, check_wide at its own
shapes) and stops.  Exits non-zero, printing no result, when CUDA is missing
or any phase fails.  Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from node2vec_torch import Node2Vec, _build, ops, random_walk, trim_index
from node2vec_torch.constants import Node2VecParams, Word2VecParams
from node2vec_torch.datasets import (
    holdout_link_prediction,
    label_cosine_gap,
    synthetic_multilabel,
    train_embeddings,
)
from node2vec_torch.eval import walk_transition_pvalue
from node2vec_torch.graph import build_graph, from_edge_arrays
from node2vec_torch.models import cbow
from node2vec_torch.models import hsoftmax as hs
from node2vec_torch.models import skipgram as sg
from node2vec_torch.models.vocab import (
    build_vocab,
    build_vocab_from_counts,
    subsample_keep_prob,
    subsample_walks,
    subsample_walks_plain,
    vertex_counts,
    vertex_counts_plain,
)
from node2vec_torch.models.word2vec import Word2VecTorch, _effective_batch, _streaming_counts
from node2vec_torch.ops import alias as alias_mod
from node2vec_torch.parallel import launch, make_mesh
from node2vec_torch.parallel import rowsharded_hs as rh
from node2vec_torch.parallel import rowsharded_sgns as rs
from node2vec_torch.parallel import sharded_sgns as col
from node2vec_torch.utils import StepTimer
from node2vec_torch.utils.checkpoint import load_stream_state, save_stream_state, stream_fingerprint
from node2vec_torch.walk import WalkEngine, blocked, csr, dense

# NVIDIA H100 SXM data sheet (dense, no sparsity), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # CUDA-core fp32; also used for the 32-bit integer compares
RTOL, ATOL = 1e-4, 1e-6

SOURCES = {
    "dense_walk": ("node2vec_torch/csrc/dense_walk.cu",
                   "node2vec_tpu/walk/dense.py:85 (+ experiments/pallas_step.py:106)"),
    "sgns_grads": ("node2vec_torch/csrc/sgns.cu", "node2vec_tpu/models/skipgram.py:344"),
    "adagrad_accumulate": ("node2vec_torch/csrc/adagrad.cu",
                           "node2vec_tpu/models/skipgram.py:463"),
    "adagrad_apply": ("node2vec_torch/csrc/adagrad.cu", "node2vec_tpu/models/skipgram.py:469"),
    "blocked_walk": ("node2vec_torch/csrc/blocked_walk.cu",
                     "node2vec_tpu/walk/blocked.py:732"),
    "vertex_counts": ("node2vec_torch/csrc/vertex_counts.cu",
                      "node2vec_tpu/models/vocab.py:104"),
    # K6's streaming form: the same kernel adding into one counts tensor
    "vertex_counts_streaming": ("node2vec_torch/csrc/vertex_counts.cu",
                                "node2vec_tpu/models/word2vec.py:51"),
    "subsample_walks": ("node2vec_torch/csrc/subsample.cu",
                        "node2vec_tpu/models/word2vec.py:37"),
    "hs_grads": ("node2vec_torch/csrc/hs.cu", "node2vec_tpu/models/hsoftmax.py:209"),
    # K3 and K4 over HS's three row lists (emb_in, theta's tail, theta's head)
    "adagrad_accumulate_hs": ("node2vec_torch/csrc/adagrad.cu",
                              "node2vec_tpu/models/hsoftmax.py:396"),
    "adagrad_apply_hs": ("node2vec_torch/csrc/adagrad.cu",
                         "node2vec_tpu/models/hsoftmax.py:399"),
    "cbow_grads": ("node2vec_torch/csrc/cbow.cu", "node2vec_tpu/models/cbow.py:112"),
    "cbow_hs_grads": ("node2vec_torch/csrc/cbow_hs.cu", "node2vec_tpu/models/cbow.py:230"),
    # K3 and K4 over CBOW-HS's row lists (emb_in, theta's path entries; no head)
    "adagrad_accumulate_cbow_hs": ("node2vec_torch/csrc/adagrad.cu",
                                   "node2vec_tpu/models/cbow.py:306"),
    "adagrad_apply_cbow_hs": ("node2vec_torch/csrc/adagrad.cu",
                              "node2vec_tpu/models/cbow.py:314"),
    "preagg_rows": ("node2vec_torch/csrc/preagg.cu", "node2vec_tpu/models/skipgram.py:405"),
    "sgd_apply": ("node2vec_torch/csrc/preagg.cu", "node2vec_tpu/models/skipgram.py:434"),
    "csr_walk": ("node2vec_torch/csrc/csr_walk.cu", "node2vec_tpu/walk/engine.py:66"),
    # K13: the pair lists (make_pairs), then the per-lane gradients
    "pair_lists": ("node2vec_torch/csrc/sgns_pairs.cu", "node2vec_tpu/models/skipgram.py:130"),
    "sgns_pair_grads": ("node2vec_torch/csrc/sgns_pairs.cu",
                        "node2vec_tpu/models/skipgram.py:168"),
    # K3 and K4 over the pair step's lists (centers, contexts, negatives)
    "adagrad_accumulate_pairs": ("node2vec_torch/csrc/adagrad.cu",
                                 "node2vec_tpu/models/skipgram.py:241"),
    "adagrad_apply_pairs": ("node2vec_torch/csrc/adagrad.cu",
                            "node2vec_tpu/models/skipgram.py:248"),
    # K2 at row stride D + 1 on the fused tables
    "sgns_grads_fused": ("node2vec_torch/csrc/sgns.cu", "node2vec_tpu/models/skipgram.py:541"),
    "fused_adagrad": ("node2vec_torch/csrc/fused_adagrad.cu",
                      "node2vec_tpu/models/skipgram.py:597"),
    "alias_draw": ("node2vec_torch/csrc/alias_draw.cu", "node2vec_tpu/ops/alias.py:165"),
    # K5's shared-list branch: some edges overflow (N(prev) kept), or none do
    "blocked_walk_sl_mixed": ("node2vec_torch/csrc/blocked_walk.cu",
                              "node2vec_tpu/walk/blocked.py:772"),
    "blocked_walk_sl_exhaustive": ("node2vec_torch/csrc/blocked_walk.cu",
                                   "node2vec_tpu/walk/blocked.py:983"),
    # the column-sharded step (parallel/sharded_sgns.py:57 _col_step): partial
    # logits, gradients and squares, and the accumulator increments
    "col_pair_logits": ("node2vec_torch/csrc/col_sgns.cu",
                        "node2vec_tpu/parallel/sharded_sgns.py:85"),
    "col_pair_grads": ("node2vec_torch/csrc/col_sgns.cu",
                       "node2vec_tpu/parallel/sharded_sgns.py:97"),
    "adagrad_accumulate_squares": ("node2vec_torch/csrc/adagrad.cu",
                                   "node2vec_tpu/parallel/sharded_sgns.py:112"),
    # the row-sharded steps' routing (parallel/rowsharded_sgns.py, rowsharded_hs.py)
    "route_plan": ("node2vec_torch/csrc/route.cu", "node2vec_tpu/parallel/rowsharded_sgns.py:170"),
    "route_gather": ("node2vec_torch/csrc/route.cu",
                     "node2vec_tpu/parallel/rowsharded_sgns.py:206"),
    "route_pack": ("node2vec_torch/csrc/route.cu", "node2vec_tpu/parallel/rowsharded_sgns.py:233"),
    "sgns_grads_routed": ("node2vec_torch/csrc/sgns.cu",
                          "node2vec_tpu/parallel/rowsharded_sgns.py:270"),
    "hs_grads_routed": ("node2vec_torch/csrc/hs.cu", "node2vec_tpu/parallel/rowsharded_hs.py:156"),
}
# the walk-at-a-time step kernels staging in global memory (csrc/staging.cuh)
for _k in ("sgns_grads", "hs_grads", "cbow_grads", "cbow_hs_grads", "sgns_pair_grads",
           "col_pair_logits", "col_pair_grads"):
    SOURCES[_k + "_global"] = SOURCES[_k]
# the kernels line: (row, launch counter, main path whose launches it reads)
ROWS = (("dense_walk", "dense_walk", "main_path"),
        ("sgns_grads", "sgns_grads", "main_path"),
        ("adagrad_accumulate", "adagrad_accumulate", "main_path"),
        ("adagrad_apply", "adagrad_apply", "main_path"),
        ("blocked_walk", "blocked_walk", "main_path_blocked"),
        ("vertex_counts", "vertex_counts", "main_path_blocked"),
        ("vertex_counts_streaming", "vertex_counts", "main_path_streaming"),
        ("subsample_walks", "subsample_walks", "main_path_host"),
        ("hs_grads", "hs_grads", "main_path_hs"),
        ("adagrad_accumulate_hs", "adagrad_accumulate", "main_path_hs"),
        ("adagrad_apply_hs", "adagrad_apply", "main_path_hs"),
        ("cbow_grads", "cbow_grads", "main_path_cbow"),
        ("cbow_hs_grads", "cbow_hs_grads", "main_path_cbow_hs"),
        ("adagrad_accumulate_cbow_hs", "adagrad_accumulate", "main_path_cbow_hs"),
        ("adagrad_apply_cbow_hs", "adagrad_apply", "main_path_cbow_hs"),
        ("preagg_rows", "preagg_rows", "main_path_sgd"),
        ("sgd_apply", "sgd_apply", "main_path_sgd"),
        ("csr_walk", "csr_walk", "main_path_csr"),
        ("pair_lists", "pair_lists", "main_path_pairs"),
        ("sgns_pair_grads", "sgns_pair_grads", "main_path_pairs"),
        ("adagrad_accumulate_pairs", "adagrad_accumulate", "main_path_pairs"),
        ("adagrad_apply_pairs", "adagrad_apply", "main_path_pairs"),
        ("sgns_grads_fused", "sgns_grads", "main_path_fused"),
        ("fused_adagrad", "fused_adagrad", "main_path_fused"),
        ("alias_draw", "alias_draw", "surface"),
        ("blocked_walk_sl_mixed", "blocked_walk_sl_mixed", "main_path_shared_lists"),
        ("blocked_walk_sl_exhaustive", "blocked_walk_sl_exhaustive", "main_path_shared_lists_er"),
        ("sgns_grads_global", "sgns_grads_global", "main_path_wide"),
        ("sgns_pair_grads_global", "sgns_pair_grads_global", "main_path_wide"),
        ("cbow_grads_global", "cbow_grads_global", "main_path_wide"),
        ("hs_grads_global", "hs_grads_global", "main_path_wide"),
        ("cbow_hs_grads_global", "cbow_hs_grads_global", "main_path_wide"),
        ("col_pair_logits", "col_pair_logits", "main_path_mesh"),
        ("col_pair_grads", "col_pair_grads", "main_path_mesh"),
        ("adagrad_accumulate_squares", "adagrad_accumulate_squares", "main_path_mesh"),
        ("route_plan", "route_plan", "main_path_mesh_row"),
        ("route_gather", "route_gather", "main_path_mesh_row"),
        ("route_pack", "route_pack", "main_path_mesh_row"),
        ("sgns_grads_routed", "sgns_grads_routed", "main_path_mesh_row"),
        ("hs_grads_routed", "hs_grads_routed", "main_path_mesh_row_hs"))
GRADS = ("sgns_grads", "hs_grads", "cbow_grads", "cbow_hs_grads")  # one per objective
ADAGRAD = ("adagrad_accumulate", "adagrad_apply")
SGD = ("preagg_rows", "sgd_apply")  # SGNS with optimizer="sgd"
DENSE_PATH = ("dense_walk", "sgns_grads", "adagrad_accumulate", "adagrad_apply")
ROOT = os.path.dirname(os.path.abspath(__file__))
N2V_MAIN = {"num_walks": 10, "walk_length": 20, "return_param": 0.25, "inout_param": 4.0}
W2V_MAIN = {"vector_size": 128, "window_size": 5, "negative": 5, "min_count": 10}


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line carries the seconds since the start (t_s)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def _with_staging(name: str, row: dict, before: dict) -> dict:
    """A results row, with where its check staged the walks when the row's
    kernel stages them (csrc/staging.cuh): "global" when the kernel's
    global-staging launch counter rose since ``before`` (a copy of
    _build.launches taken as the check began), else "shared"."""
    kernel = name.removesuffix("_fused")  # K2 at row stride D + 1
    if kernel + "_global" in _build.MODE_COUNTS:
        rose = _build.launches[kernel + "_global"] > before.get(kernel + "_global", 0)
        row["staging"] = "global" if rose else "shared"
    return row


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over ``reps`` calls (CUDA events).  A spin
    kernel holds the stream while the calls are enqueued, so a kernel shorter
    than its host-side launch cost is timed on the device, not at the rate
    the host launches it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def smoke_edges(n_vertices: int, n_edges: int, seed: int = 0):
    """The dense-engine ER graph of experiments/pallas_step.py:32-38."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges).astype(np.int32)
    dst = rng.integers(0, n_vertices, n_edges).astype(np.int32)
    keep = src != dst
    return src[keep], dst[keep]


def rmat_edges(n_vertices_log2: int, n_edges: int, seed: int = 0):
    """RMAT generator (a=0.57, b=c=0.19): power-law degree distribution
    (a copy of examples/scale_test.py:rmat_edges)."""
    rng = np.random.default_rng(seed)
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    a, b, c = 0.57, 0.19, 0.19
    for _ in range(n_vertices_log2):
        r = rng.random(n_edges)
        src_bit = (r >= a + b).astype(np.int64)
        r2 = rng.random(n_edges)
        dst_bit = np.where(
            src_bit == 0, (r2 >= a / (a + b)).astype(np.int64),
            (r2 >= c / (c + (1 - a - b - c))).astype(np.int64),
        )
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return src.astype(np.int32), dst.astype(np.int32)


def rmat_graph(scale: int):
    """The bench's heavy-tail graph: (src, dst, Graph) of RMAT at ``scale``,
    8 * 2^scale drawn edges, indexed, undirected, max_out_degree 10,000,
    self loops kept."""
    src, dst = rmat_edges(scale, 8 << scale)
    return src, dst, build_graph((src, dst), indexed=True, directed=False,
                                 max_out_degree=10_000, random_seed=0)


# --------------------------------------------------------------------------- #
# kernel checks
# --------------------------------------------------------------------------- #


def check_dense_walk(graph, n_walkers: int, walk_length: int, results: dict) -> None:
    dev = torch.device("cuda")
    packed = torch.from_numpy(
        dense.build_padded_adjacency(graph.indptr, graph.indices, graph.weights)
    ).to(dev)
    p_cols = packed.shape[1] // 2
    starts = (torch.arange(n_walkers, dtype=torch.int32, device=dev) % graph.n_vertices)
    for p, q in ((0.25, 4.0), (1.0, 1.0)):
        kw = dict(walk_length=walk_length, return_param=p, inout_param=q)
        got = dense.dense_walk_chunk(packed, starts, 0, 0, **kw)
        want = dense.dense_walk_chunk_plain(packed, starts, 0, 0, **kw)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        n_diff = int((got != want).sum())
        ms = time_ms(lambda: dense.dense_walk_chunk(packed, starts, 0, 0, **kw))
        plain_ms = time_ms(lambda: dense.dense_walk_chunk_plain(packed, starts, 0, 0, **kw),
                           reps=2, warmup=1)
        # bytes: one 2P*4 B row per live walker-step, starts read, paths written;
        # ops: P^2 membership compares per biased step (steps >= 1)
        live = int((got[:, :-1] >= 0).sum())
        biased = 0 if (p, q) == (1.0, 1.0) else int((got[:, 1:-1] >= 0).sum())
        n_bytes = live * 2 * p_cols * 4 + n_walkers * 4 + got.numel() * 4
        b_ms, b_by = bound_ms(n_bytes, biased * p_cols * p_cols)
        emit({"phase": "check", "kernel": "dense_walk", "p": p, "q": q,
              "walkers": n_walkers, "P": p_cols, "bit_equal": n_diff == 0,
              "entries_differing": n_diff, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": b_ms, "bound_by": b_by})
        require(n_diff == 0, f"dense_walk differs from its plain version at p={p} q={q}")
        if (p, q) == (0.25, 4.0):  # the main path's setting
            results["dense_walk"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def _close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
    require(ok, f"{name}: max abs err {err} outside rtol {RTOL} atol {ATOL}")
    return err


def _close_to_largest(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """A tensor whose entries sum many signed terms through fp32 atomics, in
    an order that changes from run to run (d_no, K11's segment sums, a
    table row that a Huffman path's root updates from every center): an
    entry near zero carries the rounding of large partial sums, so it is
    held to rtol of the tensor's largest entry."""
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    require(err <= RTOL * scale, f"{name}: max abs err {err} > rtol {RTOL} * max |.| {scale}")
    return err


def check_sgns(n_vertices: int, n_walks: int, length: int, dim: int, window: int,
               n_neg: int, record: bool, results: dict, corpus=None) -> None:
    """K2, K3, K4 each against its plain version on the same inputs: the
    first ``n_walks`` rows of ``corpus`` [*, length] and its vocabulary
    (min_count 1) where given, else random walks with dead tails."""
    before = _build.launches.copy()
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    emb_in = torch.from_numpy(rng.normal(0, 0.1, (n_vertices, dim)).astype(np.float32)).to(dev)
    emb_out = torch.from_numpy(rng.normal(0, 0.1, (n_vertices, dim)).astype(np.float32)).to(dev)
    acc_in = torch.from_numpy(rng.random(n_vertices).astype(np.float32)).to(dev)
    acc_out = torch.from_numpy(rng.random(n_vertices).astype(np.float32)).to(dev)
    if corpus is None:
        walks_np = rng.integers(0, n_vertices, (n_walks, length)).astype(np.int32)
        dead = rng.integers(length // 2, length + 1, n_walks)  # some walks end early
        walks_np[np.arange(length)[None, :] >= dead[:, None]] = -1
        counts = np.bincount(walks_np[walks_np >= 0], minlength=n_vertices)
    else:
        walks_np = np.ascontiguousarray(corpus[:n_walks])
        counts = np.bincount(corpus[corpus >= 0], minlength=n_vertices)
    walks = torch.from_numpy(walks_np).to(dev)
    vocab = build_vocab_from_counts(counts, min_count=2 if corpus is None else 1)
    mask = torch.from_numpy(vocab.mask).to(dev)
    b_sh = torch.from_numpy(rng.integers(1, window + 1, (n_walks, length)).astype(np.int32)).to(dev)
    r1 = torch.from_numpy(rng.random(n_neg).astype(np.float32)).to(dev)
    r2 = torch.from_numpy(rng.random(n_neg).astype(np.float32)).to(dev)
    noise = (torch.from_numpy(vocab.ns_alias).to(dev), torch.from_numpy(vocab.ns_prob).to(dev))
    neg = sg.negative_ids(r1, r2, *noise)
    kw = dict(window=window, negatives=5)
    lr = 0.05

    # K2.  d_no [S, D] sums B*L1 signed terms, so an entry near zero carries
    # the rounding of large partial sums: it is held to rtol of its largest
    # entry; every other output elementwise
    got = sg.sgns_grads(emb_in, emb_out, walks, mask, b_sh, neg, **kw)
    want = sg.sgns_grads_plain(emb_in, emb_out, walks, mask, b_sh, neg, **kw)
    errs = [_close(f"sgns_grads[{k}]", g, w) for k, g, w in
            zip(("g_in", "g_out", "loss"), (got[0], got[1], got[3]), (want[0], want[1], want[3]))]
    d_no_err = float((got[2] - want[2]).abs().max())
    d_no_scale = float(want[2].abs().max())
    require(d_no_err <= RTOL * d_no_scale,
            f"sgns_grads[d_no]: max abs err {d_no_err} > rtol {RTOL} * max |d_no| {d_no_scale}")
    errs.append(d_no_err)
    g_in, g_out, d_no = want[:3]
    walks_flat = walks.reshape(-1)
    lists = (g_in, walks_flat, g_out, walks_flat, d_no, neg)  # SGNS's three row lists
    k2_ms = time_ms(lambda: sg.sgns_grads(emb_in, emb_out, walks, mask, b_sh, neg, **kw))
    k2_plain = time_ms(lambda: sg.sgns_grads_plain(emb_in, emb_out, walks, mask, b_sh, neg, **kw),
                       reps=3, warmup=1)

    # K3 on the plain K2 outputs
    a_in, a_out = acc_in.clone(), acc_out.clone()
    sg.adagrad_accumulate(a_in, a_out, *lists)
    p_in, p_out = acc_in.clone(), acc_out.clone()
    sg.adagrad_accumulate_plain(p_in, p_out, *lists)
    k3_err = max(_close("adagrad_accumulate[acc_in]", a_in, p_in),
                 _close("adagrad_accumulate[acc_out]", a_out, p_out))
    k3_ms = time_ms(lambda: sg.adagrad_accumulate(a_in, a_out, *lists))
    s_in, s_out = acc_in.clone(), acc_out.clone()
    k3_plain = time_ms(lambda: sg.adagrad_accumulate_plain(s_in, s_out, *lists))

    # K4 on the plain K3 outputs
    t_in, t_out = emb_in.clone(), emb_out.clone()
    sg.adagrad_apply(t_in, t_out, p_in, p_out, *lists, lr)
    q_in, q_out = emb_in.clone(), emb_out.clone()
    sg.adagrad_apply_plain(q_in, q_out, p_in, p_out, *lists, lr)
    k4_err = max(_close("adagrad_apply[emb_in]", t_in, q_in),
                 _close("adagrad_apply[emb_out]", t_out, q_out))
    k4_ms = time_ms(lambda: sg.adagrad_apply(t_in, t_out, p_in, p_out, *lists, lr))
    k4_plain = time_ms(lambda: sg.adagrad_apply_plain(q_in, q_out, p_in, p_out, *lists, lr))

    # the whole step, kernels against plain versions, from the same state and
    # draws: tables, accumulators and loss elementwise
    b_state = [t.clone() for t in (emb_in, emb_out, acc_in, acc_out)]
    p_state = [t.clone() for t in (emb_in, emb_out, acc_in, acc_out)]
    loss_k = sg.sgns_walk_step(*b_state, walks, b_sh, r1, r2, lr, *noise, mask, **kw)
    loss_p = sg.sgns_walk_step_plain(*p_state, walks, b_sh, r1, r2, lr, *noise, mask, **kw)
    step_err = max(_close(f"step[{k}]", a, b) for k, a, b in zip(
        ("emb_in", "emb_out", "acc_in", "acc_out", "loss"), (*b_state, loss_k), (*p_state, loss_p)))
    emit({"phase": "check", "kernel": "sgns_walk_step (K2+K3+K4)", "B": n_walks,
          "max_abs_err": step_err, "rtol": RTOL, "atol": ATOL})

    # library yardsticks: index_add_ of the same (precomputed) row updates —
    # the scatter half of K3 and K4, timed, never used by the port
    rows = torch.where(walks_flat >= 0, walks_flat, 0).long()
    valid = (walks_flat >= 0).float()
    sq_in = (g_in * g_in).mean(-1) * valid
    sq_out = torch.cat([(g_out * g_out).mean(-1) * valid, (d_no * d_no).mean(-1)])
    rows_out = torch.cat([rows, neg.long()])
    k3_lib = time_ms(lambda: (s_in.index_add_(0, rows, sq_in),
                              s_out.index_add_(0, rows_out, sq_out)))
    upd_in = -lr * g_in * torch.rsqrt(p_in[rows] + 1e-12)[:, None]
    upd_out = torch.cat([-lr * g_out * torch.rsqrt(p_out[rows] + 1e-12)[:, None],
                         -lr * d_no * torch.rsqrt(p_out[neg.long()] + 1e-12)[:, None]])
    k4_lib = time_ms(lambda: (t_in.index_add_(0, rows, upd_in),
                              t_out.index_add_(0, rows_out, upd_out)))

    # bounds, from this run's data
    # K2 reads every position's two rows and writes every position's grads;
    # K3/K4 need only the valid positions' grads (walks >= 0) and touch each
    # distinct accumulator entry / table row once
    n_rows = n_walks * length
    n_valid = int((walks_flat >= 0).sum())
    u_in = int(torch.unique(rows[walks_flat >= 0]).numel())
    u_out = int(torch.unique(torch.cat([rows[walks_flat >= 0], neg.long()])).numel())
    grads_bytes = (2 * n_rows + n_neg) * dim * 4
    k2_bytes = 2 * n_rows * dim * 4 + n_neg * dim * 4 + 2 * n_rows * 4 + grads_bytes
    k2_ops = 6 * n_rows * dim * (n_neg + 2 * window)
    valid_grads = (2 * n_valid + n_neg) * dim * 4
    k3_bytes = valid_grads + n_rows * 4 + n_neg * 4 + 8 * (u_in + u_out)
    k4_bytes = valid_grads + n_rows * 4 + n_neg * 4 + 4 * (u_in + u_out) + 8 * dim * (u_in + u_out)
    rec = {
        "sgns_grads": (max(errs), k2_ms, k2_plain, bound_ms(k2_bytes, k2_ops), None),
        "adagrad_accumulate": (k3_err, k3_ms, k3_plain,
                               bound_ms(k3_bytes, 2 * (2 * n_valid + n_neg) * dim), k3_lib),
        "adagrad_apply": (k4_err, k4_ms, k4_plain,
                          bound_ms(k4_bytes, 3 * (2 * n_valid + n_neg) * dim), k4_lib),
    }
    for name, (err, ms, plain_ms, (b_ms, b_by), lib_ms) in rec.items():
        emit({"phase": "check", "kernel": name, "B": n_walks, "L1": length, "D": dim,
              "S": n_neg, "V": n_vertices, "max_abs_err": err, "rtol": RTOL, "atol": ATOL,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
              "library_ms": lib_ms})
        if record:
            results[name] = _with_staging(name, {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms}, before)


def edge_cases() -> None:
    """Cases the main path does not reach, each against the plain version:
    K1 at P = 8 .. 256 on weights {0.5, 1, 2} with sinks and dead lanes
    (bit-equal), K1 on general weights (chi-square against the analytic
    p/q distribution, p-value > 1e-4), and the SGNS step at other walk
    lengths, widths and windows (the tolerances of check_sgns)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    n = 600
    for max_deg in (5, 12, 30, 100, 250):
        deg = rng.integers(1, max_deg + 1, n - 20)  # the last 20 vertices are sinks
        deg[0] = max_deg
        src = np.repeat(np.arange(n - 20), deg).astype(np.int32)
        dst = rng.integers(0, n, len(src)).astype(np.int32)
        w = rng.choice(np.float32([0.5, 1.0, 2.0]), len(src))
        g = from_edge_arrays(src, dst, w, n_vertices=n, directed=True)
        packed = torch.from_numpy(
            dense.build_padded_adjacency(g.indptr, g.indices, g.weights)).to(dev)
        starts = torch.arange(n, dtype=torch.int32, device=dev).repeat(3)
        starts[::13] = -1
        for p, q in ((0.25, 4.0), (4.0, 0.25), (1.0, 1.0)):
            kw = dict(walk_length=30, return_param=p, inout_param=q)
            got = dense.dense_walk_chunk(packed, starts, 1000, 99, **kw)
            want = dense.dense_walk_chunk_plain(packed, starts, 1000, 99, **kw)
            n_diff = int((got != want).sum())
            require(n_diff == 0, f"dense_walk differs at P={packed.shape[1] // 2} p={p} q={q}")
        emit({"phase": "edge_case", "kernel": "dense_walk", "P": packed.shape[1] // 2,
              "sink_ended_walks": int((got[:, -1] < 0).sum()), "bit_equal": True})

    src = np.array([0, 0, 1, 1, 1, 2, 2, 3], dtype=np.int32)
    dst = np.array([1, 2, 0, 2, 3, 0, 1, 1], dtype=np.int32)
    w = np.array([1.0, 1.0, 1.0, 2.0, 1.5, 1, 1, 1], dtype=np.float32) * np.float32(1.3)
    g = from_edge_arrays(src, dst, w, directed=True)
    p, q = 0.5, 2.0
    walks = WalkEngine(g, Node2VecParams(num_walks=20000, walk_length=2, return_param=p,
                                         inout_param=q), device="cuda").run(
        seed=11, start_vertices=np.array([0], np.int32))
    pval = walk_transition_pvalue(g, walks, 0, 1, p, q)
    emit({"phase": "edge_case", "kernel": "dense_walk", "general_weights_chi2_pvalue": pval})
    require(pval is not None and pval > 1e-4, f"chi-square p-value {pval}")

    for n_walks, length, dim, window in ((256, 81, 128, 5), (64, 21, 256, 10), (96, 11, 100, 5)):
        check_sgns(4096, n_walks, length, dim, window, 64, False, {})


BLOCKED_SETTINGS = ((0.25, 4.0, 64), (1.0, 1.0, 64), (1.0, 4.0, 64), (0.25, 4.0, 2))


def blocked_bytes(paths: torch.Tensor, stats: dict, row_bytes: int, c: int) -> int:
    """Least traffic of a blocked walk run, each byte read once: the
    distinct light rows read (``row_bytes`` each), the distinct blocks whose
    C weights were scanned, the distinct 32 B sectors holding a chosen id or
    a chosen brp pair, the distinct bids rows probed, the starts read and
    the paths written.  The sets come from the plain version's run on the
    same inputs."""
    def n(key):
        return int(stats[key].sum())

    return (n("light_rows") * row_bytes + n("biw_rows") * c * 4 + n("bids_rows") * c * 4
            + (n("biw_id_sectors") + n("brp_sectors")) * 32
            + paths.shape[0] * 4 + paths.numel() * 4)


def blocked_access_bytes(paths: torch.Tensor, stats: dict, row_bytes: int, c: int,
                         uniform: bool) -> int:
    """The same run's bytes per access (a light row per live walker-step, a
    block's weights plus the id and pair sectors per heavy attempt, a sector
    per heavy-prev probe): what reaches L2 when nothing is reused in L1."""
    rows = int((paths[:, :-1] >= 0).sum())
    per_heavy = c * 4 + 32 + (0 if uniform else 32)
    return (rows * row_bytes + stats.get("heavy_attempts", 0) * per_heavy
            + stats.get("heavy_prev_probes", 0) * 32 + paths.shape[0] * 4 + paths.numel() * 4)


def check_blocked_walk(graph, n_walkers: int, walk_length: int, results: dict) -> None:
    """K5 against its plain version on the RMAT graph: bit-equal paths,
    fallbacks and attempts at every setting of BLOCKED_SETTINGS."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    bg = blocked.build_blocked_graph(graph.indptr, graph.indices, graph.weights, device=dev)
    torch.cuda.synchronize()
    deg = np.diff(graph.indptr)
    emit({"phase": "blocked_tables", "n_vertices": graph.n_vertices, "n_edges": graph.n_edges,
          "max_degree": int(deg.max()), "isolated": int((deg == 0).sum()),
          "heavy_vertices": int((deg > bg.light_width).sum()),
          "heavy_edges": int(deg[deg > bg.light_width].sum()), "P": bg.light_width,
          "C": bg.block_width, "bytes": {k: int(t.numel() * 4) for k, t in zip(
              ("light", "biw", "bids", "brp"), bg[:4])}, "build_s": time.perf_counter() - t0})
    starts = torch.arange(n_walkers, dtype=torch.int32, device=dev) % graph.n_vertices
    shapes = dict(light_width=bg.light_width, block_width=bg.block_width,
                  has_heavy=bg.has_heavy)
    for p, q, trials in BLOCKED_SETTINGS:
        kw = dict(walk_length=walk_length, return_param=p, inout_param=q, max_trials=trials,
                  **shapes)
        got = blocked.blocked_walk_chunk(*bg[:4], starts, 0, 0, **kw)
        stats: dict = {}
        want = blocked.blocked_walk_chunk_plain(*bg[:4], starts, 0, 0, stats=stats, **kw)
        torch.cuda.synchronize()
        n_diff = int((got[0] != want[0]).sum())
        counters = [int(got[1]), int(got[2])]
        counters_plain = [int(want[1]), int(want[2])]
        err = int((got[0].long() - want[0].long()).abs().max())
        ms = time_ms(lambda: blocked.blocked_walk_chunk(*bg[:4], starts, 0, 0, **kw), reps=5)
        plain_ms = time_ms(lambda: blocked.blocked_walk_chunk_plain(*bg[:4], starts, 0, 0, **kw),
                           reps=1, warmup=0)
        steps = int((got[0][:, 1:] >= 0).sum())
        row_bytes = bg.light.shape[1] * 4
        n_bytes = blocked_bytes(got[0], stats, row_bytes, bg.block_width)
        access_bytes = blocked_access_bytes(got[0], stats, row_bytes, bg.block_width,
                                            (p, q) == (1.0, 1.0))
        b_ms, b_by = bound_ms(n_bytes, 0)
        emit({"phase": "check", "kernel": "blocked_walk", "p": p, "q": q, "max_trials": trials,
              "walkers": n_walkers, "walk_length": walk_length, "P": bg.light_width,
              "C": bg.block_width, "bit_equal": n_diff == 0, "entries_differing": n_diff,
              "fallbacks_attempts": counters, "fallbacks_attempts_plain": counters_plain,
              "walk_steps": steps, "attempts_per_step": counters[1] / max(steps, 1),
              "heavy_attempts": stats.get("heavy_attempts", 0),
              "heavy_prev_probes": stats.get("heavy_prev_probes", 0),
              "distinct": {k: int(stats[k].sum()) for k in (
                  "light_rows", "biw_rows", "biw_id_sectors", "bids_rows", "brp_sectors")},
              "ms": ms, "plain_ms": plain_ms, "walk_steps_per_s": steps / (ms / 1e3),
              "bound_bytes": n_bytes, "bound_ms": b_ms, "bound_by": b_by,
              "access_bytes": access_bytes, "access_ms_at_hbm_rate": access_bytes / HBM_BYTES_PER_S * 1e3})
        require(n_diff == 0, f"blocked_walk differs from its plain version at p={p} q={q} "
                             f"max_trials={trials}")
        require(counters == counters_plain,
                f"blocked_walk counters {counters} != plain {counters_plain}")
        if trials == 2:
            require(counters[0] > 0, "max_trials=2 produced no fallback")
        if (p, q, trials) == BLOCKED_SETTINGS[0]:  # the main path's setting
            results["blocked_walk"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                       "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def _hub_edges(hub_deg: int, seed: int, dyadic: bool, with_far: bool = False):
    """Hub 0 with ``hub_deg`` out/in edges and a ring over its neighbours
    (tests/test_blocked.py:30); ``with_far`` adds a vertex every ring vertex
    reaches that is not the hub's neighbour."""
    rng = np.random.default_rng(seed)
    nbrs = np.arange(1, hub_deg + 1, dtype=np.int32)
    src = np.concatenate([np.zeros(hub_deg, np.int32), nbrs, nbrs, nbrs % hub_deg + 1])
    dst = np.concatenate([nbrs, np.zeros(hub_deg, np.int32), nbrs % hub_deg + 1, nbrs])
    if with_far:
        src = np.concatenate([src, nbrs, [hub_deg + 1]]).astype(np.int32)
        dst = np.concatenate([dst, np.full(hub_deg, hub_deg + 1, np.int32), [1]]).astype(np.int32)
    w = (rng.choice(np.float32([0.5, 1.0, 2.0]), len(src)) if dyadic
         else rng.uniform(0.5, 2.0, len(src)).astype(np.float32))
    return src, dst, w


def _dyadic_heavy_graph():
    """A directed graph of 500 vertices with weights {0.5, 1, 2}: three
    multi-block hubs (degree 300, 520, 700), light vertices of degree 1..40,
    reverse edges for half of the edges (1/p atoms and triangles; the other
    half have none) and 15 sinks."""
    rng = np.random.default_rng(3)
    n = 500
    deg = rng.integers(1, 41, n - 15)  # the last 15 vertices are sinks
    deg[:3] = (300, 520, 700)
    src = np.repeat(np.arange(n - 15), deg).astype(np.int32)
    dst = rng.integers(0, n, len(src)).astype(np.int32)
    back = rng.random(len(src)) < 0.5  # reverse edges: 1/p atoms and triangles
    src, dst = np.concatenate([src, dst[back]]), np.concatenate([dst, src[back]])
    keep = src < n - 15
    w = rng.choice(np.float32([0.5, 1.0, 2.0]), int(keep.sum()))
    return from_edge_arrays(src[keep], dst[keep], w, n_vertices=n, directed=True)


def edge_cases_blocked() -> None:
    """K5 where the main path does not go, each against the plain version:
    sinks and dead lanes on a dyadic graph at P = 31 / C = 256 and at
    P = 8 / C = 64, a hub of degree 20,000 (C = 512), every setting of
    BLOCKED_SETTINGS plus (4, 0.25) bit-equal; general weights by
    chi-square (p-value > 1e-4) with the heavy vertex as current and as
    previous vertex."""
    dev = torch.device("cuda")
    dyadic = _dyadic_heavy_graph()
    hub = from_edge_arrays(*_hub_edges(20000, 4, dyadic=True), directed=True)
    for name, g, widths in (("sinks_dead_lanes", dyadic, (None, None)),
                            ("narrow_P8_C64", dyadic, (8, 64)),
                            ("hub_20000", hub, (None, None))):
        bg = blocked.build_blocked_graph(g.indptr, g.indices, g.weights, *widths, device=dev)
        starts = torch.arange(3 * g.n_vertices, dtype=torch.int32, device=dev) % g.n_vertices
        starts[::13] = -1
        if name == "hub_20000":
            starts = torch.cat([torch.zeros(4096, dtype=torch.int32, device=dev), starts[:8192]])
        for p, q, trials in BLOCKED_SETTINGS + ((4.0, 0.25, 64),):
            kw = dict(walk_length=30, return_param=p, inout_param=q, max_trials=trials,
                      light_width=bg.light_width, block_width=bg.block_width,
                      has_heavy=bg.has_heavy)
            got = blocked.blocked_walk_chunk(*bg[:4], starts, 1000, 99, **kw)
            want = blocked.blocked_walk_chunk_plain(*bg[:4], starts, 1000, 99, **kw)
            n_diff = int((got[0] != want[0]).sum())
            require(n_diff == 0 and [int(x) for x in got[1:]] == [int(x) for x in want[1:]],
                    f"blocked_walk differs on {name} at p={p} q={q} max_trials={trials}")
        emit({"phase": "edge_case", "kernel": "blocked_walk", "case": name,
              "P": bg.light_width, "C": bg.block_width, "walkers": int(starts.numel()),
              "sink_ended_walks": int((got[0][:, -1] < 0).sum()), "bit_equal": True})

    g = from_edge_arrays(*_hub_edges(100, 3, dyadic=False, with_far=True), directed=True)
    bg = blocked.build_blocked_graph(g.indptr, g.indices, g.weights, 8, 64, device=dev)
    for role, prev, cur in (("heavy_cur", 5, 0), ("heavy_prev", 0, 80)):
        for p, q in ((0.25, 4.0), (2.0, 0.5)):
            engine = WalkEngine(g, Node2VecParams(num_walks=20000, walk_length=2,
                                                  return_param=p, inout_param=q),
                                strategy="blocked", device="cuda", blocked_graph=bg)
            walks = engine.run(seed=11, start_vertices=np.array([prev], np.int32))
            pval = walk_transition_pvalue(g, walks, prev, cur, p, q)
            emit({"phase": "edge_case", "kernel": "blocked_walk", "case": role, "p": p, "q": q,
                  "general_weights_chi2_pvalue": pval})
            require(pval is not None and pval > 1e-4, f"{role} chi-square p-value {pval}")


# --------------------------------------------------------------------------- #
# K5's shared-list modes
# --------------------------------------------------------------------------- #

SL_SETTINGS = ((0.25, 4.0, 64), (1.0, 5.0, 64))


def _sl_tables(graph, widths=(None, None)):
    """Blocked tables with the shared lists, built and uploaded (timed),
    and what a line says of them."""
    t0 = time.perf_counter()
    bg = blocked.build_blocked_graph(graph.indptr, graph.indices, graph.weights, *widths,
                                     shared_lists=True, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    entries = bg.slq.reshape(-1, blocked.SL_LANES)[: graph.n_edges]
    n_ovf = int((entries[:, 13] & 1).sum())
    deg = np.diff(graph.indptr)
    info = {"n_vertices": graph.n_vertices, "n_edges": graph.n_edges,
            "max_degree": int(deg.max()), "heavy_vertices": int((deg > bg.light_width).sum()),
            "P": bg.light_width, "C": bg.block_width, "light_row_lanes": int(bg.light.shape[1]),
            "slq_bytes": int(bg.slq.numel() * 4), "build_s": build_s,
            "overflow_edges": n_ovf, "overflow_edge_share": n_ovf / max(graph.n_edges, 1),
            "absent_reverse_edges": int((entries[:, 12] < 0).sum()),
            "sl_ovf_wfrac": bg.sl_ovf_wfrac, "sl_exhaustive": bg.sl_exhaustive}
    return bg, info


def check_blocked_walk_sl(graph, name: str, n_walkers: int, walk_length: int,
                          results: dict) -> None:
    """K5 in its shared-list mode on ``graph`` (exhaustive when no edge
    overflowed, mixed otherwise) against its plain version: bit-equal paths,
    fallbacks and attempts at every setting of SL_SETTINGS.  The same
    walkers without the lists give attempts/step and the kernel's time
    without them.  The bound is check_blocked_walk's plus 64 B for each slq
    entry the run fetches (one a live walker-step after the first)."""
    dev = torch.device("cuda")
    bg, info = _sl_tables(graph)
    mode = "sl_exhaustive" if bg.sl_exhaustive else "sl_mixed"
    emit({"phase": "blocked_tables_sl", "graph": name, "mode": mode, **info})
    if not bg.sl_exhaustive:
        emit({"phase": "blocked_tables_sl", "graph": name,
              "note": f"{info['overflow_edges']} edges overflow: the mixed mode runs here"})
    starts = torch.arange(n_walkers, dtype=torch.int32, device=dev) % graph.n_vertices
    shapes = dict(light_width=bg.light_width, block_width=bg.block_width,
                  has_heavy=bg.has_heavy)
    sl = dict(slq=bg.slq, shared_lists=True, sl_exhaustive=bg.sl_exhaustive)
    for p, q, trials in SL_SETTINGS:
        kw = dict(walk_length=walk_length, return_param=p, inout_param=q, max_trials=trials,
                  **shapes)
        got = blocked.blocked_walk_chunk(*bg[:4], starts, 0, 0, **kw, **sl)
        off = blocked.blocked_walk_chunk(*bg[:4], starts, 0, 0, **kw)  # the same, no lists
        stats: dict = {}
        want = blocked.blocked_walk_chunk_plain(*bg[:4], starts, 0, 0, stats=stats, **kw, **sl)
        torch.cuda.synchronize()
        n_diff = int((got[0] != want[0]).sum())
        counters = [int(got[1]), int(got[2])]
        counters_plain = [int(want[1]), int(want[2])]
        err = int((got[0].long() - want[0].long()).abs().max())
        ms = time_ms(lambda: blocked.blocked_walk_chunk(*bg[:4], starts, 0, 0, **kw, **sl),
                     reps=5)
        ms_off = time_ms(lambda: blocked.blocked_walk_chunk(*bg[:4], starts, 0, 0, **kw), reps=5)
        plain_ms = time_ms(lambda: blocked.blocked_walk_chunk_plain(*bg[:4], starts, 0, 0, **kw,
                                                                    **sl), reps=1, warmup=0)
        steps = int((got[0][:, 1:] >= 0).sum())
        steps_off = int((off[0][:, 1:] >= 0).sum())
        row_bytes = bg.light.shape[1] * 4
        n_bytes = (blocked_bytes(got[0], stats, row_bytes, bg.block_width)
                   + stats["slq_fetches"] * 64)
        b_ms, b_by = bound_ms(n_bytes, 0)
        emit({"phase": "check", "kernel": "blocked_walk", "mode": mode, "graph": name, "p": p,
              "q": q, "max_trials": trials, "walkers": n_walkers, "walk_length": walk_length,
              "P": bg.light_width, "C": bg.block_width, "bit_equal": n_diff == 0,
              "entries_differing": n_diff, "fallbacks_attempts": counters,
              "fallbacks_attempts_plain": counters_plain, "walk_steps": steps,
              "attempts_per_step": counters[1] / max(steps, 1),
              "attempts_per_step_without_lists": int(off[2]) / max(steps_off, 1),
              "slq_fetches": stats["slq_fetches"],
              "heavy_prev_probes": stats.get("heavy_prev_probes", 0),
              "ms": ms, "ms_without_lists": ms_off, "plain_ms": plain_ms,
              "walk_steps_per_s": steps / (ms / 1e3),
              "walk_steps_per_s_without_lists": steps_off / (ms_off / 1e3),
              "bound_bytes": n_bytes, "bound_ms": b_ms, "bound_by": b_by})
        require(n_diff == 0, f"blocked_walk ({mode}) differs from its plain version on {name} "
                             f"at p={p} q={q}")
        require(counters == counters_plain,
                f"blocked_walk ({mode}) counters {counters} != plain {counters_plain} on {name}")
        if (p, q, trials) == SL_SETTINGS[0]:
            results["blocked_walk_" + mode] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None, "mode": mode}


def _two_hub_edges(dyadic: bool, n_shared: int = 20, n_spokes: int = 300):
    """Hubs A = 0 and B = 1 joined by a heavy edge and sharing ``n_shared``
    neighbours, each with ``n_spokes`` of its own (undirected;
    tests/test_blocked.py:401): the edge A -> B overflows SL_K, the hub ->
    shared-neighbour edges keep complete lists."""
    shared = np.arange(2, 2 + n_shared, dtype=np.int32)
    a_only = np.arange(2 + n_shared, 2 + n_shared + n_spokes, dtype=np.int32)
    src = np.concatenate([np.zeros(1, np.int32), np.zeros(n_shared, np.int32),
                          np.ones(n_shared, np.int32), np.zeros(n_spokes, np.int32),
                          np.ones(n_spokes, np.int32)])
    dst = np.concatenate([np.ones(1, np.int32), shared, shared, a_only, a_only + n_spokes])
    rng = np.random.default_rng(3)
    w = (rng.choice(np.float32([0.5, 1.0, 2.0]), len(src)) if dyadic
         else rng.uniform(0.5, 2.0, len(src)).astype(np.float32))
    w[0] = 32.0 if dyadic else 60.0  # most first hops from A take A -> B
    return src, dst, w


def edge_cases_sl() -> None:
    """K5's shared-list modes where the main paths do not go, each against
    the plain version, bit-equal at SL_SETTINGS, (4, 0.25) and a trial cap
    of 2: a directed graph with sinks, dead lanes and absent reverse edges
    (mixed: its hubs overflow), the same graph at P = 32 (256-lane rows: the
    ebase lane past the loaded 128), the exhaustive ring hub, and the
    two-hub graph whose hub-hub edge overflows; on each, q == 1 with the
    table bit-equal to no table.  Then general weights through the overflow
    edge by chi-square (transitions out of B with prev = A)."""
    dev = torch.device("cuda")
    dyadic = _dyadic_heavy_graph()
    cases = (("directed_sinks_dead_lanes", dyadic, (None, None)),
             ("P32_256_lane_rows", dyadic, (32, None)),
             ("exhaustive_ring_hub", from_edge_arrays(*_hub_edges(600, 0, dyadic=True),
                                                      directed=True), (None, None)),
             ("two_hub_overflow", from_edge_arrays(*_two_hub_edges(dyadic=True),
                                                   directed=False), (None, None)))
    for name, g, widths in cases:
        bg, info = _sl_tables(g, widths)
        starts = torch.arange(3 * g.n_vertices, dtype=torch.int32, device=dev) % g.n_vertices
        starts[::13] = -1
        shapes = dict(light_width=bg.light_width, block_width=bg.block_width,
                      has_heavy=bg.has_heavy)
        sl = dict(slq=bg.slq, shared_lists=True, sl_exhaustive=bg.sl_exhaustive)
        for p, q, trials in SL_SETTINGS + ((4.0, 0.25, 64), (0.25, 4.0, 2)):
            kw = dict(walk_length=30, return_param=p, inout_param=q, max_trials=trials, **shapes)
            got = blocked.blocked_walk_chunk(*bg[:4], starts, 1000, 99, **kw, **sl)
            want = blocked.blocked_walk_chunk_plain(*bg[:4], starts, 1000, 99, **kw, **sl)
            require(bool(torch.equal(got[0], want[0]))
                    and [int(x) for x in got[1:]] == [int(x) for x in want[1:]],
                    f"blocked_walk (shared lists) differs on {name} at p={p} q={q} "
                    f"max_trials={trials}")
        kw = dict(walk_length=30, return_param=0.5, inout_param=1.0, max_trials=64, **shapes)
        with_table = blocked.blocked_walk_chunk(*bg[:4], starts, 1000, 99, **kw, **sl)
        without = blocked.blocked_walk_chunk(*bg[:4], starts, 1000, 99, **kw)
        require(all(bool(torch.equal(a, b)) for a, b in zip(with_table, without)),
                f"q == 1 walks with the lists differ from walks without on {name}")
        emit({"phase": "edge_case", "kernel": "blocked_walk", "case": name,
              "mode": "sl_exhaustive" if bg.sl_exhaustive else "sl_mixed",
              "walkers": int(starts.numel()), "sink_ended_walks": int((got[0][:, -1] < 0).sum()),
              "bit_equal": True, "q1_with_table_equals_without": True, **info})

    p, q = 0.25, 4.0
    g = from_edge_arrays(*_two_hub_edges(dyadic=False), directed=False)
    engine = WalkEngine(g, Node2VecParams(num_walks=30000, walk_length=2, return_param=p,
                                          inout_param=q, walker_chunk=1 << 15),
                        strategy="blocked", shared_lists=True, device="cuda")
    walks = engine.run(seed=23, start_vertices=np.array([0], np.int32))
    pval = walk_transition_pvalue(g, walks, 0, 1, p, q)
    emit({"phase": "edge_case", "kernel": "blocked_walk", "case": "overflow_edge_chi2",
          "strategy_token": engine._strategy_token(),
          "transitions_A_B": int((walks[:, 1] == 1).sum()),
          "general_weights_chi2_pvalue": pval})
    require(engine._strategy_token() == "blocked+sl", f"token {engine._strategy_token()}")
    require(pval is not None and pval > 1e-4, f"overflow-edge chi-square p-value {pval}")


# --------------------------------------------------------------------------- #
# the step kernels past shared memory (global staging)
# --------------------------------------------------------------------------- #

# the node2vec paper's walk_length 80 (L1 = 81) and window 10, at dim 256
# (K10 at 512), S = 64 shared negatives; B = 256 walks, main_path_wide's
# sgns_train_step batch
WIDE = dict(B=256, L1=81, D=256, window=10)


def check_wide(graph, tree, counts, results: dict) -> None:
    """The step kernels past shared memory, each against its plain version
    at the tolerances of its own check (check_sgns, check_pairs, check_cbow,
    check_hs), timed with its bound, and each staged in global memory.

    The kernels line's *_global rows are taken at the shapes main_path_wide
    launches: K2, K9, K8 and K10 on a batch of the quality graph's corpus (8
    walks of 80 a vertex, in an epoch's shuffled order; the fit's batch,
    _effective_batch: 64 walks) with that corpus's vocabulary and Huffman
    tree, at dim 256 (K10 512); K13 on the first B = 256 of ``graph``'s walks
    of 80, as main_path_wide steps it.  K2, K9, K8 and K10 then run at
    B = 256 random walks on ``tree`` (lines only)."""
    b, l1, d, w = WIDE["B"], WIDE["L1"], WIDE["D"], WIDE["window"]
    lib = _build.lib()
    w2v = Word2VecParams()
    g_q, _ = synthetic_multilabel(2000, seed=0)
    corpus = WalkEngine(g_q, Node2VecParams(num_walks=8, walk_length=l1 - 1),
                        device="cuda").run_device(seed=0).cpu().numpy()
    q_counts = np.bincount(corpus[corpus >= 0], minlength=g_q.n_vertices)
    q_tree = hs.cap_code_length(hs.build_huffman(q_counts), q_counts,
                                max_len=w2v.hs_max_code_length or None)
    corpus = corpus[np.random.default_rng(0).permutation(len(corpus))]
    q_b = _effective_batch(w2v.batch_walks, len(corpus))
    pair_walks = WalkEngine(graph, Node2VecParams(num_walks=1, walk_length=l1 - 1),
                            device="cuda").run_device(seed=0)
    pair_mask = torch.from_numpy(build_vocab(pair_walks, graph.n_vertices, min_count=1).mask)
    pair_batch = (pair_walks[:b].contiguous(), pair_mask.to(pair_walks.device))
    del pair_walks

    def hs_smem(t):
        k_rows = hs.head_split(hs.head_level_offsets(t, table_rows=t.n_inner),
                               int(t.points.shape[1]))[1]
        return lib.n2v_hs_grads_smem(l1, d, int(t.points.shape[1]), w, k_rows)

    def cbow_run(t, c, n, dim, case, walks):
        return lambda r: check_cbow(t, c, n, l1, dim, w, True, True, True, r, case=case,
                                    walks=walks)

    def hs_run(t, c, n, case, walks):
        head = hs.head_level_offsets(t, table_rows=t.n_inner)
        return lambda r: check_hs(t, c, n, l1, d, w, head, True, True, r, case=case,
                                  walks=walks)

    main = f"main_path_wide: quality corpus, B = {q_b}"
    runs = (  # (kernel, smem, check, case, recorded)
        ("sgns_grads", lib.n2v_sgns_grads_smem(l1, d, 64, w),
         lambda r: check_sgns(g_q.n_vertices, q_b, l1, d, w, 64, True, r, corpus=corpus),
         main, True),
        ("sgns_pair_grads", lib.n2v_sgns_pair_grads_smem(l1, d, 64, w),
         lambda r: check_pairs(graph.n_vertices, b, l1, d, w, True, r, "wide",
                               batch=pair_batch),
         f"main_path_wide: sgns_train_step batch 0, B = {b}", True),
        ("cbow_grads", lib.n2v_cbow_grads_smem(l1, d, 64),
         cbow_run(q_tree, q_counts, q_b, d, "wide", corpus), main, True),
        ("hs_grads", hs_smem(q_tree), hs_run(q_tree, q_counts, q_b, "wide", corpus), main,
         True),
        ("cbow_hs_grads", lib.n2v_cbow_hs_grads_smem(l1, 2 * d),
         cbow_run(q_tree, q_counts, q_b, 2 * d, "wide, D = 512", corpus), main, True),
        ("sgns_grads", lib.n2v_sgns_grads_smem(l1, d, 64, w),
         lambda r: check_sgns(4096, b, l1, d, w, 64, True, r), "B = 256, random walks", False),
        ("cbow_grads", lib.n2v_cbow_grads_smem(l1, d, 64),
         cbow_run(tree, counts, b, d, "wide, B = 256", None), "B = 256, random walks", False),
        ("hs_grads", hs_smem(tree), hs_run(tree, counts, b, "wide, B = 256", None),
         "B = 256, random walks", False),
        ("cbow_hs_grads", lib.n2v_cbow_hs_grads_smem(l1, 2 * d),
         cbow_run(tree, counts, b, 2 * d, "wide, B = 256, D = 512", None),
         "B = 256, random walks", False),
    )
    limit = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin", 232448)
    for name, smem, run, case, recorded in runs:
        tmp: dict = {}
        run(tmp)
        row = tmp[name]
        emit({"phase": "wide", "kernel": name, "case": case, "smem_bytes": int(smem),
              "shared_memory_per_block_optin": int(limit), **row})
        require(row["staging"] == "global",
                f"{name} at {smem} B ({case}) staged in {row['staging']} memory, not global")
        if recorded:
            results[name + "_global"] = row


def check_vertex_counts(walks: torch.Tensor, n_vertices: int, results: dict) -> None:
    """K6 against its plain version on a corpus on the card: exact counts.
    torch.bincount of the corpus's valid entries (filtered outside the
    timed call) is the library yardstick."""
    got = vertex_counts(walks, n_vertices)
    want = vertex_counts_plain(walks, n_vertices)
    flat = walks.reshape(-1)
    valid = flat[flat >= 0]
    lib = torch.bincount(valid, minlength=n_vertices)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    require(err == 0, f"vertex_counts differs from its plain version by {err}")
    require(bool((lib == got).all()), "vertex_counts differs from torch.bincount")
    ms = time_ms(lambda: vertex_counts(walks, n_vertices))
    plain_ms = time_ms(lambda: vertex_counts_plain(walks, n_vertices))
    lib_ms = time_ms(lambda: torch.bincount(valid, minlength=n_vertices))
    b_ms, b_by = bound_ms(walks.numel() * 4 + n_vertices * 4, walks.numel())
    emit({"phase": "check", "kernel": "vertex_counts", "corpus": list(walks.shape),
          "V": n_vertices, "exact": True, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "bound_ms": b_ms, "bound_by": b_by})
    results["vertex_counts"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def check_streaming_counts(engine: WalkEngine, n_vertices: int, results: dict) -> None:
    """K6's streaming form (``_streaming_counts``: K6 adding every
    chunk_source chunk into one counts tensor) against K6 over the
    concatenated in-memory corpus, torch.bincount and the plain version
    over the same chunks: exact counts.  torch.bincount of each chunk's
    valid entries (filtered outside the timed call), added up, is the
    library yardstick."""
    n_chunks, chunk, source = engine.chunk_source(seed=0)
    chunks = [source(i) for i in range(n_chunks)]
    corpus = engine.run_device(seed=0)
    got, length = _streaming_counts(lambda i: chunks[i], n_chunks, n_vertices)
    in_memory = vertex_counts(corpus, n_vertices).cpu().numpy()
    flat = corpus.reshape(-1)
    lib = torch.bincount(flat[flat >= 0], minlength=n_vertices).cpu().numpy()
    plain = torch.zeros(n_vertices, dtype=torch.int32, device="cuda")
    for c in chunks:
        vertex_counts_plain(c, n_vertices, out=plain)
    err = int(np.abs(got - plain.cpu().numpy()).max())
    require(err == 0, f"streaming vertex counts differ from the plain version by {err}")
    require(bool((got == in_memory).all()), "streaming counts differ from K6 in memory")
    require(bool((got == lib).all()), "streaming counts differ from torch.bincount")
    counts = torch.zeros(n_vertices, dtype=torch.int32, device="cuda")

    def kernel():
        counts.zero_()
        for c in chunks:
            vertex_counts(c, n_vertices, out=counts)

    def plain_run():
        counts.zero_()
        for c in chunks:
            vertex_counts_plain(c, n_vertices, out=counts)

    valid = [c.reshape(-1)[c.reshape(-1) >= 0] for c in chunks]
    total = torch.zeros(n_vertices, dtype=torch.int64, device="cuda")
    ms = time_ms(kernel, reps=5)
    plain_ms = time_ms(plain_run, reps=2, warmup=1)
    lib_ms = time_ms(lambda: [total.add_(torch.bincount(v, minlength=n_vertices)) for v in valid],
                     reps=5)
    entries = n_chunks * chunk * length
    b_ms, b_by = bound_ms(entries * 4 + n_vertices * 4, entries)
    emit({"phase": "check", "kernel": "vertex_counts (streaming form)", "chunks": n_chunks,
          "chunk": [chunk, length], "V": n_vertices, "exact": True,
          "equals_in_memory_and_bincount": True, "ms": ms, "plain_ms": plain_ms,
          "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by})
    results["vertex_counts_streaming"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                          "bound_ms": b_ms, "bound_by": b_by,
                                          "library_ms": lib_ms}


HASH_OPS = 26  # integer ops of one draw: two fmix32 rounds, the Weyl mix, compare, select


def check_subsample(walks: np.ndarray, vocab, slab: int, results: dict) -> None:
    """K7 against its plain version on the first ``slab`` rows of a corpus
    (the host path's slab shape): bit-equal, both drawing the counter hash.
    The keep table is the corpus's at sample=1e-6: at gensim's 1e-3 no
    vertex of a near-uniform graph holds enough of the corpus to be
    dropped (that table is held to keep every entry), at 1e-6 about half
    the entries drop.  Edge cases: an all-dead slab and a keep table of
    ones pass through; in place equals out of place.  The keep count over
    the slab is held to its expectation (the sum of keep_prob over the
    live entries) by a z-test, |z| < 5."""
    dev = torch.device("cuda")
    corpus = torch.from_numpy(np.ascontiguousarray(walks[:slab])).to(dev)
    keep_1e3 = torch.from_numpy(subsample_keep_prob(vocab.counts, 1e-3, vocab.mask)).to(dev)
    keep = torch.from_numpy(subsample_keep_prob(vocab.counts, 1e-6, vocab.mask)).to(dev)
    seed, tag = 1, 4_000_000
    dropped_1e3 = int((subsample_walks(corpus, keep_1e3, seed, tag) != corpus).sum())
    got = subsample_walks(corpus, keep, seed, tag)
    want = subsample_walks_plain(corpus, keep, seed, tag)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    require(n_diff == 0, f"subsample_walks differs from its plain version in {n_diff} entries")
    dead = torch.full_like(corpus, -1)
    require(bool((subsample_walks(dead, keep, seed, tag) == -1).all()),
            "subsample_walks changed an all-dead slab")
    require(bool((subsample_walks(corpus, torch.ones_like(keep), seed, tag) == corpus).all()),
            "subsample_walks dropped an entry with keep probability 1")
    inplace = corpus.clone()
    subsample_walks(inplace, keep, seed, tag, out=inplace)
    require(bool((inplace == got).all()), "subsample_walks in place differs from out of place")
    live = corpus >= 0
    p_live = keep[corpus[live].long()].double()
    expected = float(p_live.sum())
    sd = float((p_live * (1 - p_live)).sum().sqrt())
    kept = int((got >= 0).sum())
    z = (kept - expected) / max(sd, 1e-12)
    require(abs(z) < 5, f"subsample_walks kept {kept}, expected {expected:.1f} (z = {z:.2f})")
    ms = time_ms(lambda: subsample_walks(corpus, keep, seed, tag))
    plain_ms = time_ms(lambda: subsample_walks_plain(corpus, keep, seed, tag), reps=3, warmup=1)
    n_live = int(live.sum())
    distinct = int(torch.unique(corpus[live]).numel())
    b_ms, b_by = bound_ms(2 * corpus.numel() * 4 + distinct * 4, HASH_OPS * n_live)
    emit({"phase": "check", "kernel": "subsample_walks", "slab": list(corpus.shape),
          "V": int(keep.numel()), "bit_equal": True, "live_entries": n_live,
          "sample": 1e-6, "keep_prob_min_at_1e-3": float(keep_1e3.min()),
          "dropped_at_1e-3": dropped_1e3,
          "kept": kept, "expected_kept": expected, "z": z, "keep_rate": kept / max(n_live, 1),
          "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
          "library_ms": None})
    err = int((got.long() - want.long()).abs().max())
    results["subsample_walks"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                  "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


# --------------------------------------------------------------------------- #
# hierarchical softmax: K8 and K3/K4 over HS's row lists
# --------------------------------------------------------------------------- #


def hs_tree(graph, max_len=None):
    """(tree, counts): the Huffman tree over counts proportional to degree
    (a walk's stationary distribution on an undirected graph), scaled to a
    corpus of 10 walks of 21 per vertex, as main_path_hs counts it."""
    deg = np.diff(graph.indptr).astype(np.float64)
    counts = np.rint(deg * (10 * 21 * graph.n_vertices) / deg.sum()).astype(np.int64)
    return hs.cap_code_length(hs.build_huffman(counts), counts, max_len=max_len), counts


def _hs_inputs(tree, counts, n_walks: int, length: int, dim: int, window: int, seed: int,
               walks=None):
    """Tables, window shrinks, the vocabulary mask (min_count 10) and the
    tree's tables, on the card, and walks: the first ``n_walks`` rows of
    ``walks`` where given, else random walks with dead tails and
    out-of-vocabulary vertices."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    n_vertices = len(counts)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    state = [t(rng.normal(0, 0.1, (n_vertices, dim)).astype(np.float32)),
             t(rng.normal(0, 0.1, (tree.n_inner, dim)).astype(np.float32)),
             t(rng.random(n_vertices).astype(np.float32)),
             t(rng.random(tree.n_inner).astype(np.float32))]
    if walks is None:
        walks = rng.integers(0, n_vertices, (n_walks, length)).astype(np.int32)
        dead = rng.integers(length // 2, length + 1, n_walks)
        walks[np.arange(length)[None, :] >= dead[:, None]] = -1
    else:
        walks = walks[:n_walks]
    mask = counts >= min(10, int(counts.max()))
    b_sh = rng.integers(1, window + 1, (n_walks, length)).astype(np.int32)
    tables = (t(tree.points), t(tree.codes), t(tree.lengths))
    return state, t(walks), t(mask), t(b_sh), tables


def _hs_live_entries(walks, mask, b_sh, lengths, window: int):
    """(valid pairs, live (pair, path entry)s) of a batch: what K8 computes."""
    safe = torch.where(walks >= 0, walks, 0).long()
    vpos = (walks >= 0) & mask[safe]
    plen = lengths[safe].long()
    pairs = entries = 0
    for d in [d for d in range(-window, window + 1) if d != 0]:
        pv = vpos & sg.window_shift(vpos, d) & (abs(d) <= b_sh)
        pairs += int(pv.sum())
        entries += int((pv * sg.window_shift(plen, d)).sum())
    return pairs, entries


def check_hs(tree, counts, n_walks: int, length: int, dim: int, window: int, head_offsets,
             timed: bool, record: bool, results: dict, case: str = "main",
             walks=None) -> None:
    """K8 hs_grads, and K3/K4 over HS's three row lists, each against its
    plain version on the same inputs (``walks`` as ``_hs_inputs`` takes
    them); then the whole step.  Tolerances are
    those of check_sgns: g_in, g_tail and the loss elementwise, tail_rows
    exact, d_head (sums over every head entry of the batch, through fp32
    atomics) to rtol of its largest entry; the Adagrad kernels and the
    step's tables elementwise."""
    before = _build.launches.copy()
    dev = torch.device("cuda")
    walks_from = ("random, dead tails" if walks is None else "main_path_wide's quality corpus"
                  if case.startswith("wide") else "main_path_hs chunk 0")
    (emb_in, theta, acc_in, acc_th), walks, mask, b_sh, tables = _hs_inputs(
        tree, counts, n_walks, length, dim, window, seed=5, walks=walks)
    kw = dict(window=window, head_offsets=head_offsets)
    args = (emb_in, theta, walks, mask, b_sh, *tables)
    got = hs.hs_grads(*args, **kw)
    want = hs.hs_grads_plain(*args, **kw)
    torch.cuda.synchronize()
    errs = [_close(f"hs_grads[{k}] ({case})", g, w) for k, g, w in
            zip(("g_in", "g_tail", "loss"), (got[0], got[1], got[4]), (want[0], want[1], want[4]))
            if w.numel()]  # no g_tail when every level is in the head
    require(torch.equal(got[2], want[2]), f"hs_grads[tail_rows] ({case}) differ")
    dh_err = float((got[3] - want[3]).abs().max()) if got[3].numel() else 0.0
    dh_scale = float(want[3].abs().max()) if got[3].numel() else 0.0
    require(dh_err <= RTOL * dh_scale,
            f"hs_grads[d_head] ({case}): max abs err {dh_err} > rtol {RTOL} * {dh_scale}")
    errs.append(dh_err)
    g_in, g_tail, tail_rows, d_head, _ = want
    n_head, k_rows = hs.head_split(head_offsets, tree.points.shape[1])
    head_rows = torch.arange(k_rows, dtype=torch.int32, device=dev)
    walks_flat = walks.reshape(-1)
    lists = (g_in, walks_flat, g_tail, tail_rows, d_head, head_rows)

    a_in, a_th = acc_in.clone(), acc_th.clone()
    sg.adagrad_accumulate(a_in, a_th, *lists)
    p_in, p_th = acc_in.clone(), acc_th.clone()
    sg.adagrad_accumulate_plain(p_in, p_th, *lists)
    k3_err = max(_close(f"adagrad_accumulate_hs[acc_in] ({case})", a_in, p_in),
                 _close(f"adagrad_accumulate_hs[acc_theta] ({case})", a_th, p_th))
    lr = 0.05
    t_in, t_th = emb_in.clone(), theta.clone()
    sg.adagrad_apply(t_in, t_th, p_in, p_th, *lists, lr)
    q_in, q_th = emb_in.clone(), theta.clone()
    sg.adagrad_apply_plain(q_in, q_th, p_in, p_th, *lists, lr)
    k4_err = max(_close(f"adagrad_apply_hs[emb_in] ({case})", t_in, q_in),
                 _close_to_largest(f"adagrad_apply_hs[theta] ({case})", t_th, q_th))

    b_state = [x.clone() for x in (emb_in, theta, acc_in, acc_th)]
    p_state = [x.clone() for x in (emb_in, theta, acc_in, acc_th)]
    loss_k = hs.hs_walk_step(*b_state, walks, b_sh, lr, *tables, mask, **kw)
    loss_p = hs.hs_walk_step_plain(*p_state, walks, b_sh, lr, *tables, mask, **kw)
    step_err = max([_close_to_largest(f"hs step[theta] ({case})", b_state[1], p_state[1])]
                   + [_close(f"hs step[{k}] ({case})", a, b) for k, a, b in zip(
                       ("emb_in", "acc_in", "acc_theta", "loss"),
                       (b_state[0], *b_state[2:], loss_k), (p_state[0], *p_state[2:], loss_p))])
    line = {"phase": "check" if timed else "edge_case", "kernel": "hs_grads + K3/K4 (HS)",
            "case": case, "B": n_walks, "L1": length, "D": dim, "window": window,
            "V": len(counts), "CL": int(tree.points.shape[1]), "H": n_head, "K": k_rows,
            "n_inner": tree.n_inner, "walks": walks_from,
            "max_abs_err": {"hs_grads": max(errs), "accumulate": k3_err, "apply": k4_err,
                            "step": step_err},
            "rtol": RTOL, "atol": ATOL}
    if not timed:
        emit(line)
        return

    k8_ms = time_ms(lambda: hs.hs_grads(*args, **kw))
    k8_plain = time_ms(lambda: hs.hs_grads_plain(*args, **kw), reps=2, warmup=1)
    k3_ms = time_ms(lambda: sg.adagrad_accumulate(a_in, a_th, *lists))
    s_in, s_th = acc_in.clone(), acc_th.clone()
    k3_plain = time_ms(lambda: sg.adagrad_accumulate_plain(s_in, s_th, *lists))
    k4_ms = time_ms(lambda: sg.adagrad_apply(t_in, t_th, p_in, p_th, *lists, lr))
    k4_plain = time_ms(lambda: sg.adagrad_apply_plain(q_in, q_th, p_in, p_th, *lists, lr))

    # library yardsticks: index_add_ of the same precomputed rows, never used by the port
    live_in = walks_flat >= 0
    live_tail = tail_rows >= 0
    rows_in = walks_flat[live_in].long()
    rows_th = torch.cat([tail_rows[live_tail].long(), head_rows.long()])
    g_th = torch.cat([g_tail[live_tail], d_head])
    sq_in, sq_th = (g_in[live_in] ** 2).mean(-1), (g_th ** 2).mean(-1)
    k3_lib = time_ms(lambda: (s_in.index_add_(0, rows_in, sq_in),
                              s_th.index_add_(0, rows_th, sq_th)))
    upd_in = -lr * g_in[live_in] * torch.rsqrt(p_in[rows_in] + 1e-12)[:, None]
    upd_th = -lr * g_th * torch.rsqrt(p_th[rows_th] + 1e-12)[:, None]
    k4_lib = time_ms(lambda: (t_in.index_add_(0, rows_in, upd_in),
                              t_th.index_add_(0, rows_th, upd_th)))

    # bounds, from this run's data.  K8 reads the batch's ids and shrinks,
    # each distinct vertex's emb_in row, path, length and mask byte once,
    # each distinct theta row on those paths once, and writes g_in of the
    # live positions, g_tail with its row of the live tail entries (those
    # K3/K4 read) and d_head; it does 6 * D flops per live (pair, entry)
    # (the dot, the g_in term, the context-gradient term)
    n_rows = n_walks * length
    clt = tree.points.shape[1] - n_head
    cl = tree.points.shape[1]
    pairs, entries = _hs_live_entries(walks, mask, b_sh, tables[2], window)
    u_in = torch.unique(rows_in)
    on_path = torch.arange(cl, device=dev)[None, :] < tables[2][u_in][:, None]
    u_th = int(torch.unique(tables[0][u_in][on_path]).numel())
    k8_bytes = (n_rows * 8 + u_in.numel() * (dim * 4 + cl * 5 + 5) + u_th * dim * 4
                + int(live_in.sum()) * dim * 4 + int(live_tail.sum()) * (dim * 4 + 4)
                + k_rows * dim * 4)
    n_live = int(live_in.sum()) + int(live_tail.sum()) + k_rows
    u_acc_in = int(u_in.numel())
    u_acc_th = int(torch.unique(rows_th).numel())
    ids = (n_rows + n_rows * clt + k_rows) * 4
    k3_bytes = n_live * dim * 4 + ids + 8 * (u_acc_in + u_acc_th)
    k4_bytes = n_live * dim * 4 + ids + 4 * (u_acc_in + u_acc_th) + 8 * dim * (u_acc_in + u_acc_th)
    rec = {
        "hs_grads": (max(errs), k8_ms, k8_plain, bound_ms(k8_bytes, 6 * dim * entries), None),
        "adagrad_accumulate_hs": (k3_err, k3_ms, k3_plain, bound_ms(k3_bytes, 2 * dim * n_live),
                                  k3_lib),
        "adagrad_apply_hs": (k4_err, k4_ms, k4_plain, bound_ms(k4_bytes, 3 * dim * n_live),
                             k4_lib),
    }
    line.update({"valid_pairs": pairs, "live_path_entries": entries,
                 "live_positions": int(live_in.sum()), "live_tail_entries": int(live_tail.sum()),
                 "distinct_vertices": u_acc_in, "distinct_theta_rows": u_th})
    emit(line)
    for name, (err, ms, plain_ms, (b_ms, b_by), lib_ms) in rec.items():
        emit({"phase": "check", "kernel": name, "case": case, "B": n_walks, "L1": length,
              "D": dim, "CL": cl, "H": n_head, "K": k_rows, "max_abs_err": err, "rtol": RTOL,
              "atol": ATOL, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
              "library_ms": lib_ms})
        if record:
            results[name] = _with_staging(name, {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms}, before)


def edge_cases_hs(tree, counts) -> None:
    """K8 and K3/K4 where the main path does not go, each against the plain
    version (check_hs's tolerances): the head off, a code length capped at
    8 (hs_max_code_length=8: every level in the head, no tail), a
    one-vertex vocabulary with and without its head, and other walk
    lengths, widths and windows.  Dead lanes and out-of-vocabulary
    positions are in every case's walks."""
    capped = hs.cap_code_length(tree, counts, max_len=8)
    one = hs.build_huffman(np.array([7]))
    one_counts = np.array([7])
    cases = (("head_off", tree, counts, 256, 21, 128, 5, (0,)),
             ("max_code_length_8", capped, counts, 256, 21, 128, 5,
              hs.head_level_offsets(capped, table_rows=capped.n_inner)),
             ("one_vertex", one, one_counts, 64, 21, 128, 5,
              hs.head_level_offsets(one, table_rows=1)),
             ("one_vertex_head_off", one, one_counts, 64, 21, 128, 5, (0,)),
             ("walk_length_80", tree, counts, 64, 81, 128, 5,
              hs.head_level_offsets(tree, table_rows=tree.n_inner)),
             ("dim_100_window_10", tree, counts, 96, 11, 100, 10,
              hs.head_level_offsets(tree, table_rows=tree.n_inner)))
    for case, t, c, n_walks, length, dim, window, head in cases:
        check_hs(t, c, n_walks, length, dim, window, head, False, False, {}, case=case)


# --------------------------------------------------------------------------- #
# CBOW: K9, K10 and K3/K4 over CBOW-HS's row lists
# --------------------------------------------------------------------------- #


def _cbow_inputs(tree, counts, n_walks: int, length: int, dim: int, window: int, seed: int,
                 walks=None, oov: float = 0.0, dead: bool = True):
    """_hs_inputs' HS state, walks, mask, shrinks and tree tables, plus
    CBOW-NS's output table and accumulator, 64 shared negatives from the
    vocabulary's noise table and their (r1, r2); ``oov`` drops that share
    of the vertices from the mask."""
    dev = torch.device("cuda")
    hs_state, walks, mask, b_sh, tables = _hs_inputs(tree, counts, n_walks, length, dim,
                                                     window, seed, walks=walks)
    if not dead:
        walks = walks.clamp(min=0)
    rng = np.random.default_rng(seed + 1)
    n_vertices = len(counts)
    if oov:
        mask = mask & torch.from_numpy(rng.random(n_vertices) >= oov).to(dev)
    vocab = build_vocab_from_counts(counts, min_count=min(10, int(counts.max())))
    noise = (torch.from_numpy(vocab.ns_alias).to(dev), torch.from_numpy(vocab.ns_prob).to(dev))
    r1 = torch.from_numpy(rng.random(64).astype(np.float32)).to(dev)
    r2 = torch.from_numpy(rng.random(64).astype(np.float32)).to(dev)
    ns_state = [hs_state[0],
                torch.from_numpy(rng.normal(0, 0.1, (n_vertices, dim)).astype(np.float32)).to(dev),
                hs_state[2], torch.from_numpy(rng.random(n_vertices).astype(np.float32)).to(dev)]
    return dict(ns=ns_state, hs=hs_state, walks=walks, mask=mask, b_sh=b_sh, tables=tables,
                noise=noise, r=(r1, r2), neg=sg.negative_ids(r1, r2, *noise), window=window)


def _verify_cbow(inp, cbow_mean: bool, case: str) -> dict:
    """K9, K10 and K3/K4 over CBOW-HS's lists, then both whole steps, each
    against its plain version on the same inputs (check_sgns's
    tolerances: grads, tables and losses elementwise, d_no to rtol of its
    largest entry, theta_rows exact).  Returns the errors and the plain
    outputs."""
    w = inp["window"]
    ns_kw = dict(window=w, negatives=5, cbow_mean=cbow_mean)
    hs_kw = dict(window=w, cbow_mean=cbow_mean)
    ns_args = (*inp["ns"][:2], inp["walks"], inp["mask"], inp["b_sh"], inp["neg"])
    hs_args = (*inp["hs"][:2], inp["walks"], inp["mask"], inp["b_sh"], *inp["tables"])
    tag = f"({case}, cbow_mean={cbow_mean})"

    got = cbow.cbow_grads(*ns_args, **ns_kw)
    want9 = cbow.cbow_grads_plain(*ns_args, **ns_kw)
    torch.cuda.synchronize()
    errs9 = [_close(f"cbow_grads[{k}] {tag}", g, x) for k, g, x in
             zip(("g_in", "d_out", "loss"), (got[0], got[1], got[3]),
                 (want9[0], want9[1], want9[3]))]
    d_no_err = float((got[2] - want9[2]).abs().max())
    d_no_scale = float(want9[2].abs().max())
    require(d_no_err <= RTOL * d_no_scale,
            f"cbow_grads[d_no] {tag}: max abs err {d_no_err} > rtol {RTOL} * {d_no_scale}")
    errs9.append(d_no_err)

    got = cbow.cbow_hs_grads(*hs_args, **hs_kw)
    want10 = cbow.cbow_hs_grads_plain(*hs_args, **hs_kw)
    torch.cuda.synchronize()
    errs10 = [_close(f"cbow_hs_grads[{k}] {tag}", g, x) for k, g, x in
              zip(("g_in", "g_theta", "loss"), (got[0], got[1], got[3]),
                  (want10[0], want10[1], want10[3]))]
    require(torch.equal(got[2], want10[2]), f"cbow_hs_grads[theta_rows] {tag} differ")

    emb_in, theta, acc_in, acc_th = inp["hs"]
    lists = cbow.cbow_hs_lists(*want10[:3], inp["walks"])
    a_in, a_th = acc_in.clone(), acc_th.clone()
    sg.adagrad_accumulate(a_in, a_th, *lists)
    p_in, p_th = acc_in.clone(), acc_th.clone()
    sg.adagrad_accumulate_plain(p_in, p_th, *lists)
    k3_err = max(_close(f"adagrad_accumulate_cbow_hs[acc_in] {tag}", a_in, p_in),
                 _close(f"adagrad_accumulate_cbow_hs[acc_theta] {tag}", a_th, p_th))
    lr = 0.05
    t_in, t_th = emb_in.clone(), theta.clone()
    sg.adagrad_apply(t_in, t_th, p_in, p_th, *lists, lr)
    q_in, q_th = emb_in.clone(), theta.clone()
    sg.adagrad_apply_plain(q_in, q_th, p_in, p_th, *lists, lr)
    k4_err = max(_close(f"adagrad_apply_cbow_hs[emb_in] {tag}", t_in, q_in),
                 _close_to_largest(f"adagrad_apply_cbow_hs[theta] {tag}", t_th, q_th))

    steps = {}
    for name, state, fk, fp, extra, kw in (
            ("ns", inp["ns"], cbow.cbow_walk_step, cbow.cbow_walk_step_plain,
             (*inp["r"], lr, *inp["noise"], inp["mask"]), ns_kw),
            ("hs", inp["hs"], cbow.cbow_hs_step, cbow.cbow_hs_step_plain,
             (lr, *inp["tables"], inp["mask"]), hs_kw)):
        k_state = [x.clone() for x in state]
        p_state = [x.clone() for x in state]
        loss_k = fk(*k_state, inp["walks"], inp["b_sh"], *extra, **kw)
        loss_p = fp(*p_state, inp["walks"], inp["b_sh"], *extra, **kw)
        errs_step = [_close_to_largest(f"cbow {name} step[{k}] {tag}", a, b) for k, a, b in zip(
            ("emb_in", "emb_out"), k_state[:2], p_state[:2])]
        steps[name] = max(errs_step + [_close(f"cbow {name} step[{k}] {tag}", a, b)
                                       for k, a, b in zip(("acc_in", "acc_out", "loss"),
                                                          (*k_state[2:], loss_k),
                                                          (*p_state[2:], loss_p))])
    return {"errs": {"cbow_grads": max(errs9), "cbow_hs_grads": max(errs10),
                     "accumulate_cbow_hs": k3_err, "apply_cbow_hs": k4_err,
                     "ns_step": steps["ns"], "hs_step": steps["hs"]},
            "want9": want9, "want10": want10, "lists": lists, "acc": (p_in, p_th)}


def _cbow_live(inp):
    """(trainable centers, valid (center, context) pairs, live path
    entries) of a batch: what K9 and K10 compute."""
    walks, mask, b_sh = inp["walks"], inp["mask"], inp["b_sh"]
    safe = torch.where(walks >= 0, walks, 0).long()
    vpos = (walks >= 0) & mask[safe]
    cnt = torch.zeros(walks.shape, dtype=torch.int32, device=walks.device)
    for d in [d for d in range(-inp["window"], inp["window"] + 1) if d != 0]:
        cnt += vpos & sg.window_shift(vpos, d) & (abs(d) <= b_sh)
    w_c = vpos & (cnt > 0)
    plen = inp["tables"][2][safe]
    return int(w_c.sum()), int(cnt.sum()), int((plen * w_c).sum())


def check_cbow(tree, counts, n_walks: int, length: int, dim: int, window: int,
               cbow_mean: bool, timed: bool, record: bool, results: dict, case: str = "main",
               walks=None) -> None:
    """K9 cbow_grads, K10 cbow_hs_grads and K3/K4 over CBOW-HS's row lists,
    each against its plain version (``_verify_cbow``), on the tree's
    vocabulary; timed at the main paths' shapes.  K10 runs on the tree
    without its head: CBOW-HS updates every path entry per occurrence."""
    before = _build.launches.copy()
    inp = _cbow_inputs(tree, counts, n_walks, length, dim, window, seed=6, walks=walks)
    v = _verify_cbow(inp, cbow_mean, case)
    walks_from = ("random, dead tails" if walks is None else "main_path_wide's quality corpus"
                  if case.startswith("wide") else "main_path_cbow chunk 0")
    cl = int(tree.points.shape[1])
    line = {"phase": "check" if timed else "edge_case", "kernel": "cbow_grads, cbow_hs_grads "
            "+ K3/K4 (CBOW-HS)", "case": case, "cbow_mean": cbow_mean, "B": n_walks,
            "L1": length, "D": dim, "window": window, "S": 64, "V": len(counts), "CL": cl,
            "n_inner": tree.n_inner, "walks": walks_from, "max_abs_err": v["errs"],
            "rtol": RTOL, "atol": ATOL}
    if not timed:
        emit(line)
        return

    ns_kw = dict(window=window, negatives=5, cbow_mean=cbow_mean)
    hs_kw = dict(window=window, cbow_mean=cbow_mean)
    ns_args = (*inp["ns"][:2], inp["walks"], inp["mask"], inp["b_sh"], inp["neg"])
    hs_args = (*inp["hs"][:2], inp["walks"], inp["mask"], inp["b_sh"], *inp["tables"])
    k9_ms = time_ms(lambda: cbow.cbow_grads(*ns_args, **ns_kw))
    k9_plain = time_ms(lambda: cbow.cbow_grads_plain(*ns_args, **ns_kw), reps=3, warmup=1)
    k10_ms = time_ms(lambda: cbow.cbow_hs_grads(*hs_args, **hs_kw))
    k10_plain = time_ms(lambda: cbow.cbow_hs_grads_plain(*hs_args, **hs_kw), reps=2, warmup=1)
    lists = v["lists"]
    g_in, walks_flat, g_theta, theta_rows = lists[:4]
    acc_in, acc_th = inp["hs"][2:]
    p_in, p_th = v["acc"]
    lr = 0.05
    a_in, a_th = acc_in.clone(), acc_th.clone()
    k3_ms = time_ms(lambda: sg.adagrad_accumulate(a_in, a_th, *lists))
    k3_plain = time_ms(lambda: sg.adagrad_accumulate_plain(a_in, a_th, *lists))
    t_in, t_th = inp["hs"][0].clone(), inp["hs"][1].clone()
    k4_ms = time_ms(lambda: sg.adagrad_apply(t_in, t_th, p_in, p_th, *lists, lr))
    k4_plain = time_ms(lambda: sg.adagrad_apply_plain(t_in, t_th, p_in, p_th, *lists, lr))

    # library yardsticks: index_add_ of the same precomputed rows, never used by the port
    live_in = walks_flat >= 0
    live_th = theta_rows >= 0
    rows_in = walks_flat[live_in].long()
    rows_th = theta_rows[live_th].long()
    g_th = g_theta[live_th]
    sq_in, sq_th = (g_in[live_in] ** 2).mean(-1), (g_th ** 2).mean(-1)
    k3_lib = time_ms(lambda: (a_in.index_add_(0, rows_in, sq_in),
                              a_th.index_add_(0, rows_th, sq_th)))
    upd_in = -lr * g_in[live_in] * torch.rsqrt(p_in[rows_in] + 1e-12)[:, None]
    upd_th = -lr * g_th * torch.rsqrt(p_th[rows_th] + 1e-12)[:, None]
    k4_lib = time_ms(lambda: (t_in.index_add_(0, rows_in, upd_in),
                              t_th.index_add_(0, rows_th, upd_th)))

    # bounds, from this run's data.  K9 reads the batch's ids and shrinks,
    # each distinct vertex's emb_in and emb_out rows and mask byte once and
    # the S negative rows, and writes g_in and d_out of the live positions
    # and d_no; it does (6 S + 7) D flops per trainable center (its two
    # dots and d_out; the [., S] logits, g_neg . no and g_neg^T . h) and
    # 2 D per valid (center, context) pair (h and the scatter).  K10 reads
    # the same ids, each distinct vertex's emb_in row, path, codes, length
    # and mask once and each distinct theta row on the trainable centers'
    # paths once, and writes g_in of the live positions and g_theta with its
    # row for the live path entries; 5 D flops per live entry (the dot,
    # g_h, g_theta) and 2 D per pair.
    n_rows = n_walks * length
    n_ctr, n_pairs, n_entries = _cbow_live(inp)
    n_live = int(live_in.sum())
    u_in = torch.unique(rows_in)
    s = inp["neg"].numel()
    k9_bytes = (n_rows * 8 + u_in.numel() * (2 * dim * 4 + 1) + s * (dim * 4 + 4)
                + 2 * n_live * dim * 4 + s * dim * 4)
    k9_ops = dim * (n_ctr * (6 * s + 7) + 2 * n_pairs)
    u_th = int(torch.unique(rows_th).numel())
    k10_bytes = (n_rows * 8 + u_in.numel() * (dim * 4 + cl * 5 + 5) + u_th * dim * 4
                 + n_live * dim * 4 + n_entries * (dim * 4 + 4))
    k10_ops = dim * (5 * n_entries + 2 * n_pairs)
    n_grads = n_live + n_entries
    ids = (n_rows + n_rows * cl) * 4
    k3_bytes = n_grads * dim * 4 + ids + 8 * (u_in.numel() + u_th)
    k4_bytes = n_grads * dim * 4 + ids + 4 * (u_in.numel() + u_th) + 8 * dim * (u_in.numel() + u_th)
    rec = {
        "cbow_grads": (v["errs"]["cbow_grads"], k9_ms, k9_plain, bound_ms(k9_bytes, k9_ops), None),
        "cbow_hs_grads": (v["errs"]["cbow_hs_grads"], k10_ms, k10_plain,
                          bound_ms(k10_bytes, k10_ops), None),
        "adagrad_accumulate_cbow_hs": (v["errs"]["accumulate_cbow_hs"], k3_ms, k3_plain,
                                       bound_ms(k3_bytes, 2 * dim * n_grads), k3_lib),
        "adagrad_apply_cbow_hs": (v["errs"]["apply_cbow_hs"], k4_ms, k4_plain,
                                  bound_ms(k4_bytes, 3 * dim * n_grads), k4_lib),
    }
    line.update({"trainable_centers": n_ctr, "valid_pairs": n_pairs,
                 "live_path_entries": n_entries, "live_positions": n_live,
                 "distinct_vertices": int(u_in.numel()), "distinct_theta_rows": u_th})
    emit(line)
    for name, (err, ms, plain_ms, (b_ms, b_by), lib_ms) in rec.items():
        emit({"phase": "check", "kernel": name, "case": case, "cbow_mean": cbow_mean,
              "B": n_walks, "L1": length, "D": dim, "CL": cl, "max_abs_err": err,
              "rtol": RTOL, "atol": ATOL, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
              "bound_by": b_by, "library_ms": lib_ms})
        if record:
            results[name] = _with_staging(name, {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms}, before)


def edge_cases_cbow(tree, counts) -> None:
    """K9, K10 and K3/K4 over CBOW-HS's lists where the main path does not
    go, each against its plain version at both cbow_mean settings
    (``_verify_cbow``): dead lanes with 20% of the vertices out of the
    vocabulary, all-dead walks, live positions between dead ones at window
    1 (no center has a context), a window of 5 over 4-position walks, walk
    length 81, and D = 100 at window 10; then 2-position walks, where the
    CBOW-NS loss (K9) equals the SGNS loss (K2) under the same draws
    (tests/test_cbow.py:43)."""
    n_v = len(counts)
    rng = np.random.default_rng(9)
    gaps = rng.integers(0, n_v, (128, 21)).astype(np.int32)
    gaps[:, 1::2] = -1
    cases = (("dead_lanes_oov", 256, 21, 128, 5, None, 0.2),
             ("all_dead", 64, 21, 128, 5, np.full((64, 21), -1, np.int32), 0.0),
             ("no_context", 128, 21, 128, 1, gaps, 0.0),
             ("window_ge_L1", 256, 4, 128, 5, None, 0.0),
             ("walk_length_81", 64, 81, 128, 5, None, 0.1),
             ("dim_100_window_10", 96, 11, 100, 10, None, 0.1))
    for case, n_walks, length, dim, window, walks, oov in cases:
        for cbow_mean in (True, False):
            inp = _cbow_inputs(tree, counts, n_walks, length, dim, window, seed=11, walks=walks,
                               oov=oov)
            v = _verify_cbow(inp, cbow_mean, case)
            n_ctr, n_pairs, n_entries = _cbow_live(inp)
            if case in ("all_dead", "no_context"):
                require(n_ctr == 0, f"{case}: {n_ctr} trainable centers")
                require(float(v["want9"][3]) == 0 and float(v["want10"][3]) == 0,
                        f"{case}: nonzero loss")
            emit({"phase": "edge_case", "kernel": "cbow_grads, cbow_hs_grads + K3/K4 (CBOW-HS)",
                  "case": case, "cbow_mean": cbow_mean, "B": n_walks, "L1": length, "D": dim,
                  "window": window, "oov_share": oov, "trainable_centers": n_ctr,
                  "valid_pairs": n_pairs, "live_path_entries": n_entries,
                  "max_abs_err": v["errs"], "rtol": RTOL, "atol": ATOL})

    inp = _cbow_inputs(tree, counts, 512, 2, 128, 5, seed=12, dead=False)
    inp["mask"] = torch.ones_like(inp["mask"])
    b_sh = torch.full_like(inp["b_sh"], 5)
    args = (*inp["ns"][:2], inp["walks"], inp["mask"], b_sh, inp["neg"])
    loss9 = float(cbow.cbow_grads(*args, window=5, negatives=5, cbow_mean=True)[3])
    loss2 = float(sg.sgns_grads(*args, window=5, negatives=5)[3])
    require(abs(loss9 - loss2) <= RTOL * abs(loss2),
            f"2-position walks: CBOW-NS loss {loss9} != SGNS loss {loss2}")
    emit({"phase": "edge_case", "kernel": "cbow_grads vs sgns_grads", "case": "two_token",
          "B": 512, "cbow_loss": loss9, "sgns_loss": loss2, "rtol": RTOL})


def _preagg_inputs(n_vertices: int, walks_np: np.ndarray, dim: int, window: int, seed: int,
                   oov: float = 0.0):
    """One SGNS batch on the card: random tables and accumulators, the
    walks, a vocabulary mask without ``oov`` of the vertices, window
    shrinks, the noise table of the walks' counts and 64 shared negatives
    with their (r1, r2)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    length = walks_np.shape[1]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    state = [t(rng.normal(0, 0.1, (n_vertices, dim)).astype(np.float32)),
             t(rng.normal(0, 0.1, (n_vertices, dim)).astype(np.float32)),
             t(rng.random(n_vertices).astype(np.float32)),
             t(rng.random(n_vertices).astype(np.float32))]
    counts = np.bincount(walks_np[walks_np >= 0], minlength=n_vertices)
    vocab = build_vocab_from_counts(np.maximum(counts, 1), min_count=1)
    mask = rng.random(n_vertices) >= oov
    noise = (t(vocab.ns_alias), t(vocab.ns_prob))
    r1, r2 = (t(rng.random(64).astype(np.float32)) for _ in range(2))
    b_sh = t(rng.integers(1, window + 1, walks_np.shape).astype(np.int32))
    return dict(state=state, walks=t(walks_np), mask=t(mask), b_sh=b_sh, noise=noise, r=(r1, r2),
                neg=sg.negative_ids(r1, r2, *noise), window=window, V=n_vertices, L1=length)


def _verify_preagg(inp, case: str) -> dict:
    """K11 preagg_rows, sgd_apply and K3/K4 over the de-duplicated lists,
    then both pre-aggregated steps (optimizer="sgd", and preagg=True with
    Adagrad), each against its plain version on the same inputs: the sums
    to rtol of their largest entry (K2's d_no tolerance: fp32 atomics
    reorder them), heads and counts exactly, the slot map back to empty,
    tables, accumulators and losses elementwise (check_sgns's)."""
    emb_in, emb_out, acc_in, acc_out = inp["state"]
    walks, neg = inp["walks"], inp["neg"]
    kw = dict(window=inp["window"], negatives=5)
    g_in, g_out, d_no, _, pairs = sg.sgns_grads_plain(emb_in, emb_out, walks, inp["mask"],
                                                       inp["b_sh"], neg, **kw)
    flat = walks.reshape(-1)
    slot = sg.new_slot_map(inp["V"], flat.device)
    got = sg.preagg_rows(flat, g_in, g_out, slot)
    want = sg.preagg_rows_plain(flat, g_in, g_out)
    torch.cuda.synchronize()
    require(torch.equal(got[2], want[2]), f"preagg_rows[heads] ({case}) differ")
    require(torch.equal(got[3], want[3]), f"preagg_rows[cnt] ({case}) differ")
    require(bool((slot == sg.SLOT_EMPTY).all()), f"preagg_rows ({case}) left the slot map dirty")
    errs = {k: _close_to_largest(f"preagg_rows[{k}] ({case})", a, b)
            for k, a, b in (("ga_in", got[0], want[0]), ("ga_out", got[1], want[1]))}
    ga_in, ga_out, heads, cnt = want
    lr, neg_scale = 0.025, 5 / neg.numel()
    t_in, t_out = emb_in.clone(), emb_out.clone()
    sg.sgd_apply(t_in, t_out, ga_in, ga_out, heads, cnt, d_no, neg, pairs, lr, neg_scale)
    q_in, q_out = emb_in.clone(), emb_out.clone()
    sg.sgd_apply_plain(q_in, q_out, ga_in, ga_out, heads, cnt, d_no, neg, pairs, lr, neg_scale)
    errs["sgd_apply"] = max(_close(f"sgd_apply[emb_in] ({case})", t_in, q_in),
                            _close(f"sgd_apply[emb_out] ({case})", t_out, q_out))
    lists = (ga_in, heads, ga_out, heads, d_no, neg)
    a_in, a_out = acc_in.clone(), acc_out.clone()
    sg.adagrad_accumulate(a_in, a_out, *lists)
    p_in, p_out = acc_in.clone(), acc_out.clone()
    sg.adagrad_accumulate_plain(p_in, p_out, *lists)
    errs["adagrad_accumulate_preagg"] = max(_close(f"K3 preagg[acc_in] ({case})", a_in, p_in),
                                            _close(f"K3 preagg[acc_out] ({case})", a_out, p_out))
    t_in, t_out = emb_in.clone(), emb_out.clone()
    sg.adagrad_apply(t_in, t_out, p_in, p_out, *lists, lr)
    q_in, q_out = emb_in.clone(), emb_out.clone()
    sg.adagrad_apply_plain(q_in, q_out, p_in, p_out, *lists, lr)
    errs["adagrad_apply_preagg"] = max(_close(f"K4 preagg[emb_in] ({case})", t_in, q_in),
                                       _close(f"K4 preagg[emb_out] ({case})", t_out, q_out))
    for optimizer, preagg in (("sgd", False), ("adagrad", True)):
        k_state = [x.clone() for x in inp["state"]]
        p_state = [x.clone() for x in inp["state"]]
        step_kw = dict(kw, optimizer=optimizer, preagg=preagg)
        loss_k = sg.sgns_walk_step(*k_state, walks, inp["b_sh"], *inp["r"], lr, *inp["noise"],
                                   inp["mask"], slot=slot, **step_kw)
        loss_p = sg.sgns_walk_step_plain(*p_state, walks, inp["b_sh"], *inp["r"], lr,
                                         *inp["noise"], inp["mask"], **step_kw)
        errs[f"step_{optimizer}"] = max(_close(f"{optimizer} step[{k}] ({case})", a, b)
                                        for k, a, b in zip(
            ("emb_in", "emb_out", "acc_in", "acc_out", "loss"), (*k_state, loss_k),
            (*p_state, loss_p)))
        if optimizer == "sgd":
            require(torch.equal(k_state[2], acc_in) and torch.equal(k_state[3], acc_out),
                    f"the SGD step ({case}) changed an accumulator")
    return {"errs": errs, "grads": (g_in, g_out, d_no, pairs), "want": want, "slot": slot,
            "lists": lists, "acc": (p_in, p_out)}


def check_preagg(n_vertices: int, walks_np: np.ndarray, dim: int, window: int, record: bool,
                 results: dict, case: str) -> None:
    """K11 preagg_rows and sgd_apply (and K3/K4 over the de-duplicated
    lists) against their plain versions (``_verify_preagg``) and timed, on
    ``walks_np``: main_path_sgd's first chunk, shuffled.  Library
    yardsticks: index_add_ of the live gradient rows into a zeroed [V, D]
    buffer (the segment sums by direct address), and of the precomputed
    SGD updates."""
    inp = _preagg_inputs(n_vertices, walks_np, dim, window, seed=13)
    v = _verify_preagg(inp, case)
    g_in, g_out, d_no, pairs = v["grads"]
    ga_in, ga_out, heads, cnt = v["want"]
    flat, neg, slot = inp["walks"].reshape(-1), inp["neg"], v["slot"]
    emb_in, emb_out = inp["state"][:2]
    lr, neg_scale = 0.025, 5 / neg.numel()
    k11_ms = time_ms(lambda: sg.preagg_rows(flat, g_in, g_out, slot))
    k11_plain = time_ms(lambda: sg.preagg_rows_plain(flat, g_in, g_out), reps=3, warmup=1)
    live = flat >= 0
    rows_live = flat[live].long()
    gi_live, go_live = g_in[live], g_out[live]
    buf_in = torch.zeros_like(emb_in)
    buf_out = torch.zeros_like(emb_out)
    k11_lib = time_ms(lambda: (buf_in.index_add_(0, rows_live, gi_live),
                               buf_out.index_add_(0, rows_live, go_live)))
    t_in, t_out = emb_in.clone(), emb_out.clone()
    sgd_args = (ga_in, ga_out, heads, cnt, d_no, neg, pairs, lr, neg_scale)
    sgd_ms = time_ms(lambda: sg.sgd_apply(t_in, t_out, *sgd_args))
    sgd_plain = time_ms(lambda: sg.sgd_apply_plain(t_in, t_out, *sgd_args), reps=3, warmup=1)
    ok = heads >= 0
    hv = heads[ok].long()
    inv = 1.0 / torch.clamp(cnt[ok], min=1.0)
    upd_in = (-lr * ga_in[ok]) * inv[:, None]
    upd_out = torch.cat([(-lr * ga_out[ok]) * inv[:, None],
                         (-lr * d_no) / torch.clamp(pairs * neg_scale, min=1.0)])
    rows_out = torch.cat([hv, neg.long()])
    sgd_lib = time_ms(lambda: (t_in.index_add_(0, hv, upd_in),
                               t_out.index_add_(0, rows_out, upd_out)))
    lists, (p_in, p_out) = v["lists"], v["acc"]
    a_in, a_out = inp["state"][2].clone(), inp["state"][3].clone()
    k3_ms = time_ms(lambda: sg.adagrad_accumulate(a_in, a_out, *lists))
    k4_ms = time_ms(lambda: sg.adagrad_apply(t_in, t_out, p_in, p_out, *lists, lr))

    # bounds, from this run's data.  preagg_rows reads the rows and the live
    # rows' two gradients once, writes the two [N, D] sums, heads and counts
    # once, and reads and writes each touched slot entry; sgd_apply reads
    # heads, the heads' counts and sums, d_no, the negatives and pairs, and
    # reads and writes each head's emb_in row and each distinct head or
    # negative emb_out row once
    n_rows, n_live, s = flat.numel(), int(live.sum()), neg.numel()
    u = int(ok.sum())
    u_out = int(torch.unique(rows_out).numel())
    k11_bytes = 4 * n_rows + 2 * n_live * dim * 4 + 2 * n_rows * dim * 4 + 8 * n_rows + 8 * u
    sgd_bytes = (4 * n_rows + 4 * u + 2 * u * dim * 4 + s * (dim * 4 + 4) + 4
                 + 8 * dim * (u + u_out))
    rec = {
        "preagg_rows": (max(v["errs"]["ga_in"], v["errs"]["ga_out"]), k11_ms, k11_plain,
                        bound_ms(k11_bytes, 2 * n_live * dim), k11_lib),
        "sgd_apply": (v["errs"]["sgd_apply"], sgd_ms, sgd_plain,
                      bound_ms(sgd_bytes, 3 * dim * (2 * u + s)), sgd_lib),
    }
    emit({"phase": "check", "kernel": "preagg_rows + sgd_apply + K3/K4 (preaggregated)",
          "case": case, "B": walks_np.shape[0], "L1": inp["L1"], "D": dim, "S": s,
          "V": n_vertices, "live_rows": n_live, "distinct_vertices": u,
          "distinct_out_rows": u_out, "max_abs_err": v["errs"], "rtol": RTOL, "atol": ATOL,
          "adagrad_accumulate_preagg_ms": k3_ms, "adagrad_apply_preagg_ms": k4_ms})
    for name, (err, ms, plain_ms, (b_ms, b_by), lib_ms) in rec.items():
        emit({"phase": "check", "kernel": name, "case": case, "B": walks_np.shape[0],
              "L1": inp["L1"], "D": dim, "max_abs_err": err, "rtol": RTOL, "atol": ATOL,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
              "library_ms": lib_ms})
        if record:
            results[name] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms}


def edge_cases_preagg() -> None:
    """K11, sgd_apply, K3/K4 over the de-duplicated lists and both
    pre-aggregated steps where the main path does not go
    (``_verify_preagg``): dead lanes with 20% of the vertices out of the
    vocabulary (counted, with zero gradients), all-dead walks, a batch
    whose every position is one vertex, and a 48-vertex batch, where the
    64 shared negatives repeat and every one is also a head row."""
    rng = np.random.default_rng(14)
    dead = rng.integers(0, 4096, (256, 21)).astype(np.int32)
    dead[np.arange(21)[None, :] >= rng.integers(1, 22, 256)[:, None]] = -1
    small = rng.integers(0, 48, (96, 21)).astype(np.int32)
    cases = (("dead_lanes_oov", 4096, dead, 0.2),
             ("all_dead", 4096, np.full((64, 21), -1, np.int32), 0.0),
             ("one_vertex", 4096, np.full((64, 21), 7, np.int32), 0.0),
             ("negatives_are_heads", 48, small, 0.0))
    for case, n_v, walks_np, oov in cases:
        inp = _preagg_inputs(n_v, walks_np, 128, 5, seed=15, oov=oov)
        v = _verify_preagg(inp, case)
        heads, cnt = v["want"][2], v["want"][3]
        neg = inp["neg"]
        emit({"phase": "edge_case", "kernel": "preagg_rows + sgd_apply + K3/K4 (preaggregated)",
              "case": case, "B": walks_np.shape[0], "V": n_v, "oov_share": oov,
              "heads": int((heads >= 0).sum()), "counted_rows": int(cnt.sum()),
              "distinct_negatives": int(torch.unique(neg).numel()),
              "negatives_among_heads": int(torch.isin(neg, heads).sum()),
              "max_abs_err": v["errs"], "rtol": RTOL, "atol": ATOL})
        require(int(cnt.sum()) == int((walks_np >= 0).sum()), f"{case}: counts miss rows")
        if case == "negatives_are_heads":
            require(bool(torch.isin(neg, heads).all()) and torch.unique(neg).numel() < 64,
                    f"{case}: the negatives do not repeat or are not all heads")


CSR_SETTINGS = ((0.25, 4.0), (1.0, 1.0), (1.0, 5.0))  # (1, 5): K = 2 by half-even rounding


def check_csr_walk(graph, name: str, n_walkers: int, walk_length: int, record: bool,
                   results: dict) -> None:
    """K12 against its plain version on ``graph``'s DeviceGraph at every
    setting of CSR_SETTINGS: unit weights, so the paths must be bit-equal;
    its bound counts each 32-byte sector of the CSR arrays the plain run
    reads once, the starts read and the paths written."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    dg = graph.to_device(dev)
    torch.cuda.synchronize()
    deg = np.diff(graph.indptr)
    iters = csr.search_iters(int(deg.max()))
    emit({"phase": "csr_tables", "graph": name, "n_vertices": graph.n_vertices,
          "n_edges": graph.n_edges, "max_degree": int(deg.max()), "search_iters": iters,
          "device_graph_bytes": sum(t.numel() * t.element_size() for t in dg),
          "upload_s": time.perf_counter() - t0})
    starts = torch.arange(n_walkers, dtype=torch.int32, device=dev) % graph.n_vertices
    for p, q in CSR_SETTINGS:
        kw = dict(walk_length=walk_length, return_param=p, inout_param=q, max_trials=64,
                  search_iters=iters)
        got = csr.csr_walk_chunk(*dg, starts, 0, 0, **kw)
        stats: dict = {}
        want = csr.csr_walk_chunk_plain(*dg, starts, 0, 0, stats=stats, **kw)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum())
        err = int((got.long() - want.long()).abs().max())
        ms = time_ms(lambda: csr.csr_walk_chunk(*dg, starts, 0, 0, **kw), reps=5)
        plain_ms = time_ms(lambda: csr.csr_walk_chunk_plain(*dg, starts, 0, 0, **kw),
                           reps=1, warmup=0)
        steps = int((got[:, 1:] >= 0).sum())
        sectors = {k: int(m.sum()) for k, m in stats.items()}
        n_bytes = 32 * sum(sectors.values()) + n_walkers * 4 + got.numel() * 4
        b_ms, b_by = bound_ms(n_bytes, 0)
        kb, n_rounds = csr.proposal_rounds(p, q, 64)
        emit({"phase": "check", "kernel": "csr_walk", "graph": name, "p": p, "q": q,
              "K": kb, "rounds": n_rounds, "walkers": n_walkers, "walk_length": walk_length,
              "bit_equal": n_diff == 0, "entries_differing": n_diff, "walk_steps": steps,
              "sectors_read": sectors, "ms": ms, "plain_ms": plain_ms,
              "walk_steps_per_s": steps / (ms / 1e3), "bound_bytes": n_bytes, "bound_ms": b_ms,
              "bound_by": b_by})
        require(n_diff == 0, f"csr_walk differs from its plain version on {name} at p={p} q={q}")
        if record and (p, q) == CSR_SETTINGS[0]:  # main_path_csr's graph and setting
            results["csr_walk"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def edge_cases_csr() -> None:
    """K12 where the main path does not go: sinks and dead lanes on a
    dyadic directed graph at every setting of CSR_SETTINGS and (4, 0.25)
    (bit-equal to the plain version), the forced back edge at a degree-1
    vertex at (4, 0.25) and (0.25, 4) (tests/test_walk.py:173), and general
    weights by chi-square (p-value > 1e-4)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(16)
    n = 600
    src = rng.integers(0, n - 20, 9000).astype(np.int32)  # the last 20 vertices are sinks
    dst = rng.integers(0, n, 9000).astype(np.int32)
    back = rng.random(9000) < 0.5
    src, dst = np.concatenate([src, dst[back]]), np.concatenate([dst, src[back]])
    keep = (src < n - 20) & (src != dst)
    w = rng.choice(np.float32([0.5, 1.0, 2.0]), int(keep.sum()))
    g = from_edge_arrays(src[keep], dst[keep], w, n_vertices=n, directed=True)
    dg = g.to_device(dev)
    starts = torch.arange(3 * n, dtype=torch.int32, device=dev) % n
    starts[::13] = -1
    iters = csr.search_iters(int(np.diff(g.indptr).max()))
    for p, q in CSR_SETTINGS + ((4.0, 0.25),):
        kw = dict(walk_length=30, return_param=p, inout_param=q, max_trials=64,
                  search_iters=iters)
        got = csr.csr_walk_chunk(*dg, starts, 1000, 99, **kw)
        want = csr.csr_walk_chunk_plain(*dg, starts, 1000, 99, **kw)
        require(bool(torch.equal(got, want)), f"csr_walk differs with sinks at p={p} q={q}")
    emit({"phase": "edge_case", "kernel": "csr_walk", "case": "sinks_dead_lanes",
          "walkers": int(starts.numel()), "sink_ended_walks": int((got[:, -1] < 0).sum()),
          "bit_equal": True})

    chain = from_edge_arrays(np.array([0, 1, 1, 2], np.int32), np.array([1, 0, 2, 1], np.int32),
                             directed=True)
    for p, q in ((4.0, 0.25), (0.25, 4.0)):
        walks = WalkEngine(chain, Node2VecParams(num_walks=200, walk_length=8, return_param=p,
                                                 inout_param=q),
                           strategy="csr", device="cuda").run(
            seed=5, start_vertices=np.array([0], np.int32))
        at0 = walks[:, :-1] == 0
        ok = bool((walks >= 0).all() and (walks[:, 1:][at0] == 1).all())
        emit({"phase": "edge_case", "kernel": "csr_walk", "case": "degree_one_back_edge",
              "p": p, "q": q, "forced_back_moves": int(at0.sum()), "ok": ok})
        require(ok, f"degree-1 back edge not forced at p={p} q={q}")

    src = np.array([0, 0, 1, 1, 1, 2, 2, 3], dtype=np.int32)
    dst = np.array([1, 2, 0, 2, 3, 0, 1, 1], dtype=np.int32)
    w = np.array([1.0, 1.0, 1.0, 2.0, 1.5, 1, 1, 1], dtype=np.float32) * np.float32(1.3)
    g = from_edge_arrays(src, dst, w, directed=True)
    for p, q in ((0.5, 2.0), (2.0, 0.5)):
        walks = WalkEngine(g, Node2VecParams(num_walks=20000, walk_length=2, return_param=p,
                                             inout_param=q),
                           strategy="csr", device="cuda").run(
            seed=11, start_vertices=np.array([0], np.int32))
        pval = walk_transition_pvalue(g, walks, 0, 1, p, q)
        emit({"phase": "edge_case", "kernel": "csr_walk", "case": "general_weights", "p": p,
              "q": q, "general_weights_chi2_pvalue": pval})
        require(pval is not None and pval > 1e-4, f"csr_walk chi-square p-value {pval}")


# --------------------------------------------------------------------------- #
# pipeline phases
# --------------------------------------------------------------------------- #


def _pair_walks(n_vertices: int, n_walks: int, length: int, seed: int) -> np.ndarray:
    """Random walks with -1 tails; about one walk in L1 has length 1."""
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, n_vertices, (n_walks, length)).astype(np.int32)
    ends = rng.integers(1, length + 1, n_walks)
    walks[np.arange(length)[None, :] >= ends[:, None]] = -1
    return walks


def _emit_rows(rec: dict, record: bool, results: dict, before: dict, **line) -> None:
    """One check line per kernel of ``rec`` (name: (err, ms, plain ms, (bound ms, bound by),
    library ms)), kept in ``results`` for the kernels line when ``record``;
    ``before`` as _with_staging takes it."""
    for name, (err, ms, plain_ms, bound, lib_ms) in rec.items():
        row = _with_staging(name, {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                   "bound_ms": bound[0], "bound_by": bound[1],
                                   "library_ms": lib_ms}, before)
        emit({"phase": "check", "kernel": name, **line, **row})
        if record:
            results[name] = row


def _batch_inputs(n_vertices, n_walks, length, dim, window, seed, oov, batch):
    """_preagg_inputs on ``batch`` = (walks [B, L1], vocabulary mask), a
    batch of a main path's own epoch, or on random walks with -1 tails and
    ``oov`` of the vertices out of the vocabulary when ``batch`` is None."""
    if batch is None:
        return _preagg_inputs(n_vertices, _pair_walks(n_vertices, n_walks, length, seed), dim,
                              window, seed + 1, oov=oov)
    inp = _preagg_inputs(n_vertices, batch[0].cpu().numpy(), dim, window, seed + 1)
    inp["mask"] = batch[1]
    return inp


def check_pairs(n_vertices: int, n_walks: int, length: int, dim: int, window: int,
                record: bool, results: dict, case: str, shrink: bool = True,
                oov: float = 0.1, batch=None) -> None:
    """K13 (pair lists, then per-lane gradients) and K3/K4 over the pair
    lists, each against its plain version on the same inputs, and the
    whole pair step: the lists bit-equal; d_ci, d_co and the loss
    elementwise; d_no and the tables after K4, which sum many signed terms
    through atomics, to rtol of their largest entry.  The walks: ``batch``
    (_batch_inputs), whose liveness sets the times and bounds."""
    before = _build.launches.copy()
    inp = _batch_inputs(n_vertices, n_walks, length, dim, window, 11, oov, batch)
    walks, mask, neg = inp["walks"], inp["mask"], inp["neg"]
    n_walks, length = walks.shape
    emb_in, emb_out, acc_in, acc_out = inp["state"]
    b_sh = inp["b_sh"] if shrink else None
    kw = dict(window=window, negatives=5)
    lr = 0.05

    centers, contexts = sg.pair_lists(walks, b_sh, mask, window)
    pc, px = sg.pair_lists_plain(walks, b_sh, mask, window)
    n_diff = int((centers != pc).sum()) + int((contexts != px).sum())
    require(n_diff == 0, f"pair_lists differs from its plain version in {n_diff} entries ({case})")
    got = sg.sgns_pair_grads(emb_in, emb_out, walks, pc, px, neg, **kw)
    want = sg.sgns_pair_grads_plain(emb_in, emb_out, walks, pc, px, neg, **kw)
    k13_err = max(_close("sgns_pair_grads[d_ci]", got[0], want[0]),
                  _close("sgns_pair_grads[d_co]", got[1], want[1]),
                  _close_to_largest("sgns_pair_grads[d_no]", got[2], want[2]),
                  _close("sgns_pair_grads[loss]", got[3], want[3]))
    n_lanes_valid = int((pc >= 0).sum())
    require(int(got[4]) == int(want[4]) == n_lanes_valid,
            f"sgns_pair_grads counts {float(got[4])} valid lanes, not {n_lanes_valid} ({case})")
    d_ci, d_co, d_no = want[:3]
    lists = (d_ci, pc, d_co, px, d_no, neg)  # the pair step's three row lists
    a_in, a_out = acc_in.clone(), acc_out.clone()
    sg.adagrad_accumulate(a_in, a_out, *lists)
    p_in, p_out = acc_in.clone(), acc_out.clone()
    sg.adagrad_accumulate_plain(p_in, p_out, *lists)
    k3_err = max(_close("adagrad_accumulate[pairs, acc_in]", a_in, p_in),
                 _close("adagrad_accumulate[pairs, acc_out]", a_out, p_out))
    t_in, t_out = emb_in.clone(), emb_out.clone()
    sg.adagrad_apply(t_in, t_out, p_in, p_out, *lists, lr)
    q_in, q_out = emb_in.clone(), emb_out.clone()
    sg.adagrad_apply_plain(q_in, q_out, p_in, p_out, *lists, lr)
    k4_err = max(_close_to_largest("adagrad_apply[pairs, emb_in]", t_in, q_in),
                 _close_to_largest("adagrad_apply[pairs, emb_out]", t_out, q_out))
    k_state = [t.clone() for t in inp["state"]]
    p_state = [t.clone() for t in inp["state"]]
    loss_k = sg.sgns_train_step(*k_state, walks, b_sh, *inp["r"], lr, *inp["noise"], mask, **kw)
    loss_p = sg.sgns_train_step_plain(*p_state, walks, b_sh, *inp["r"], lr, *inp["noise"], mask,
                                      **kw)
    step_err = _close_state("pair step", k_state, loss_k, p_state, loss_p)

    l_ms = time_ms(lambda: sg.pair_lists(walks, b_sh, mask, window))
    l_plain = time_ms(lambda: sg.pair_lists_plain(walks, b_sh, mask, window))
    g_ms = time_ms(lambda: sg.sgns_pair_grads(emb_in, emb_out, walks, pc, px, neg, **kw))
    g_plain = time_ms(lambda: sg.sgns_pair_grads_plain(emb_in, emb_out, walks, pc, px, neg, **kw),
                      reps=3, warmup=1)
    k3_ms = time_ms(lambda: sg.adagrad_accumulate(a_in, a_out, *lists))
    k3_plain = time_ms(lambda: sg.adagrad_accumulate_plain(a_in, a_out, *lists), reps=3)
    k4_ms = time_ms(lambda: sg.adagrad_apply(t_in, t_out, p_in, p_out, *lists, lr))
    k4_plain = time_ms(lambda: sg.adagrad_apply_plain(q_in, q_out, p_in, p_out, *lists, lr),
                       reps=3)
    # library yardsticks (never used by the port): index_add_ of the valid
    # lanes' precomputed squares (K3) and updates (K4)
    ok = pc >= 0
    rows_c, rows_x, negl = pc[ok].long(), px[ok].long(), neg.long()
    sq_c = (d_ci[ok] * d_ci[ok]).mean(-1)
    sq_x = torch.cat([(d_co[ok] * d_co[ok]).mean(-1), (d_no * d_no).mean(-1)])
    rows_out = torch.cat([rows_x, negl])
    k3_lib = time_ms(lambda: (a_in.index_add_(0, rows_c, sq_c), a_out.index_add_(0, rows_out, sq_x)))
    upd_in = -lr * d_ci[ok] * torch.rsqrt(p_in[rows_c] + 1e-12)[:, None]
    upd_out = torch.cat([-lr * d_co[ok] * torch.rsqrt(p_out[rows_x] + 1e-12)[:, None],
                         -lr * d_no * torch.rsqrt(p_out[negl] + 1e-12)[:, None]])
    k4_lib = time_ms(lambda: (t_in.index_add_(0, rows_c, upd_in),
                              t_out.index_add_(0, rows_out, upd_out)))

    # bounds, from this run's data: each input read once (the rows of the
    # distinct centers, contexts and negatives), each output written once
    # (the per-lane gradients are the function's output); the gradient
    # flops counted per live center (S negative logits, gn, d_no) and per
    # valid lane (the positive logit, d_ci, d_co)
    n_lanes, n_valid, n_neg = int(pc.numel()), int(ok.sum()), int(neg.numel())
    n_pos = n_walks * length
    u_c = int(torch.unique(rows_c).numel())
    u_out = int(torch.unique(rows_out).numel())
    lane = torch.nonzero(ok).squeeze(1)
    live_centers = int(torch.unique(lane // (2 * window * length) * length + lane % length).numel())
    lists_bytes = 2 * n_pos * 4 + u_c + int(torch.unique(rows_x).numel()) + 2 * n_lanes * 4
    grads_bytes = ((n_pos + n_lanes) * 4 + (u_c + u_out) * dim * 4 + 2 * n_lanes * dim * 4
                   + n_neg * dim * 4 + n_walks * 12)
    grads_ops = 6 * live_centers * n_neg * dim + 5 * n_valid * dim
    valid_grads = (2 * n_valid + n_neg) * dim * 4
    k3_bytes = valid_grads + 2 * n_lanes * 4 + n_neg * 4 + 8 * (u_c + u_out)
    k4_bytes = (valid_grads + 2 * n_lanes * 4 + n_neg * 4 + 4 * (u_c + u_out)
                + 8 * dim * (u_c + u_out))
    emit({"phase": "check", "kernel": "sgns_train_step (K13+K3+K4)", "case": case,
          "shrink": shrink, "B": n_walks, "L1": length, "D": dim, "lanes": n_lanes,
          "valid_lanes": n_valid, "max_abs_err": step_err, "rtol": RTOL, "atol": ATOL})
    _emit_rows({
        "pair_lists": (n_diff, l_ms, l_plain, bound_ms(lists_bytes, 0), None),
        "sgns_pair_grads": (k13_err, g_ms, g_plain, bound_ms(grads_bytes, grads_ops), None),
        "adagrad_accumulate_pairs": (k3_err, k3_ms, k3_plain,
                                     bound_ms(k3_bytes, 2 * (2 * n_valid + n_neg) * dim), k3_lib),
        "adagrad_apply_pairs": (k4_err, k4_ms, k4_plain,
                                bound_ms(k4_bytes, 3 * (2 * n_valid + n_neg) * dim), k4_lib),
    }, record, results, before, case=case, B=n_walks, L1=length, D=dim, S=n_neg,
       V=n_vertices)


def _close_state(name: str, got_state, got_loss, want_state, want_loss) -> float:
    """A step's (emb_in, emb_out, acc_in, acc_out, loss) against another's:
    the tables, which sum many signed terms through atomics, to rtol of
    their largest entry; the accumulators and the loss elementwise."""
    return max(_close_to_largest(f"{name}[emb_in]", got_state[0], want_state[0]),
               _close_to_largest(f"{name}[emb_out]", got_state[1], want_state[1]),
               _close(f"{name}[acc_in]", got_state[2], want_state[2]),
               _close(f"{name}[acc_out]", got_state[3], want_state[3]),
               _close(f"{name}[loss]", got_loss, want_loss))


def _close_fused(name: str, got, want) -> float:
    """Fused tables: the vectors to rtol of their largest entry (atomics
    over repeated rows), the accumulator column elementwise."""
    return max(_close_to_largest(f"{name}[vectors]", got[:, :-1], want[:, :-1]),
               _close(f"{name}[accumulator]", got[:, -1], want[:, -1]))


def check_fused(n_vertices: int, n_walks: int, length: int, dim: int, window: int,
                record: bool, results: dict, case: str, batch=None) -> None:
    """K2 at row stride D + 1 on [V, D+1] tables against its plain version
    and against K2 at stride D on the same vectors, timed at both strides;
    K14 against its plain version with repeated rows, rows at -1 (on
    random walks) and a negative that is also a center; and the whole
    fused step.  The walks as in check_pairs."""
    before = _build.launches.copy()
    inp = _batch_inputs(n_vertices, n_walks, length, dim, window, 13, 0.1, batch)
    walks, mask, b_sh = inp["walks"], inp["mask"], inp["b_sh"]
    n_walks, length = walks.shape
    emb_in, emb_out, acc_in, acc_out = inp["state"]
    tab_in = torch.cat([emb_in, acc_in[:, None]], dim=1).contiguous()
    tab_out = torch.cat([emb_out, acc_out[:, None]], dim=1).contiguous()
    walks_flat = walks.reshape(-1)
    neg = inp["neg"].clone()
    neg[0] = walks_flat[int(torch.nonzero(walks_flat >= 0)[0])]  # a negative that is a center
    kw = dict(window=window, negatives=5)
    lr = 0.05

    got = sg.sgns_grads(tab_in, tab_out, walks, mask, b_sh, neg, dim=dim, **kw)
    want = sg.sgns_grads_plain(tab_in, tab_out, walks, mask, b_sh, neg, dim=dim, **kw)
    flat = sg.sgns_grads(emb_in, emb_out, walks, mask, b_sh, neg, **kw)
    k2_err = max(_close("sgns_grads[ld=D+1, g_in]", got[0], want[0]),
                 _close("sgns_grads[ld=D+1, g_out]", got[1], want[1]),
                 _close_to_largest("sgns_grads[ld=D+1, d_no]", got[2], want[2]),
                 _close("sgns_grads[ld=D+1, loss]", got[3], want[3]))
    same_as_ld_d = max(float((a - b).abs().max()) for a, b in zip(got[:4], flat[:4]))
    require(same_as_ld_d <= RTOL * float(flat[2].abs().max()),
            f"K2 at ld = D + 1 differs from K2 at ld = D by {same_as_ld_d}")
    g_in, g_out, d_no = want[:3]
    lists = (g_in, walks_flat, g_out, walks_flat, d_no, neg)
    t_in, t_out = tab_in.clone(), tab_out.clone()
    sg.fused_adagrad(t_in, t_out, *lists, lr)
    q_in, q_out = tab_in.clone(), tab_out.clone()
    sg.fused_adagrad_plain(q_in, q_out, *lists, lr)
    k14_err = max(_close_fused("fused_adagrad[tab_in]", t_in, q_in),
                  _close_fused("fused_adagrad[tab_out]", t_out, q_out))
    k_tabs = [tab_in.clone(), tab_out.clone()]
    p_tabs = [tab_in.clone(), tab_out.clone()]
    loss_k = sg.sgns_walk_step_fused(*k_tabs, walks, b_sh, *inp["r"], lr, *inp["noise"], mask,
                                     **kw)
    loss_p = sg.sgns_walk_step_fused_plain(*p_tabs, walks, b_sh, *inp["r"], lr, *inp["noise"],
                                           mask, **kw)
    step_err = max(_close_fused("fused step[tab_in]", k_tabs[0], p_tabs[0]),
                   _close_fused("fused step[tab_out]", k_tabs[1], p_tabs[1]),
                   _close("fused step[loss]", loss_k, loss_p))

    k2_ms = time_ms(lambda: sg.sgns_grads(tab_in, tab_out, walks, mask, b_sh, neg, dim=dim, **kw))
    k2_ms_ld_d = time_ms(lambda: sg.sgns_grads(emb_in, emb_out, walks, mask, b_sh, neg, **kw))
    k2_plain = time_ms(lambda: sg.sgns_grads_plain(tab_in, tab_out, walks, mask, b_sh, neg,
                                                   dim=dim, **kw), reps=3, warmup=1)
    k14_ms = time_ms(lambda: sg.fused_adagrad(t_in, t_out, *lists, lr))
    k14_plain = time_ms(lambda: sg.fused_adagrad_plain(q_in, q_out, *lists, lr), reps=3)
    # library yardstick: index_add_ of the precomputed (delta vector,
    # square) rows of the live occurrences into both tables
    live = walks_flat >= 0
    rows = walks_flat[live].long()
    negl = neg.long()

    def upd(tab, g, r):
        sq = (g * g).mean(-1)
        scale = torch.rsqrt(tab[r, dim] + sq + 1e-12)
        return torch.cat([-lr * g * scale[:, None], sq[:, None]], dim=1)

    u_in = upd(tab_in, g_in[live], rows)
    u_out = torch.cat([upd(tab_out, g_out[live], rows), upd(tab_out, d_no, negl)])
    rows_out = torch.cat([rows, negl])
    k14_lib = time_ms(lambda: (t_in.index_add_(0, rows, u_in),
                               t_out.index_add_(0, rows_out, u_out)))

    # bounds: K2 reads the D vector columns of each position's rows, so its
    # bound is the one at stride D (check_sgns); K14 reads the valid
    # occurrences' grads and rows once and read-modify-writes each touched
    # table row of D + 1 floats once
    n_rows, n_live, n_neg = n_walks * length, int(live.sum()), int(neg.numel())
    grads_bytes = (2 * n_rows + n_neg) * dim * 4
    k2_bytes = 2 * n_rows * dim * 4 + n_neg * dim * 4 + 2 * n_rows * 4 + grads_bytes
    k2_ops = 6 * n_rows * dim * (n_neg + 2 * window)
    u_rows = int(torch.unique(rows).numel()) + int(torch.unique(rows_out).numel())
    k14_bytes = ((2 * n_live + n_neg) * dim * 4 + (n_rows + n_neg) * 4
                 + 8 * (dim + 1) * u_rows)
    emit({"phase": "check", "kernel": "sgns_walk_step_fused (K2 at ld=D+1, K14)", "case": case,
          "B": n_walks, "L1": length, "D": dim, "max_abs_err": step_err,
          "k2_ld_d_plus_1_vs_ld_d_max_abs_diff": same_as_ld_d, "rtol": RTOL, "atol": ATOL})
    _emit_rows({
        "sgns_grads_fused": (k2_err, k2_ms, k2_plain, bound_ms(k2_bytes, k2_ops), None),
        "fused_adagrad": (k14_err, k14_ms, k14_plain,
                          bound_ms(k14_bytes, 4 * (2 * n_live + n_neg) * dim), k14_lib),
    }, record, results, before, case=case, B=n_walks, L1=length, D=dim, S=n_neg,
       V=n_vertices)
    emit({"phase": "check", "kernel": "sgns_grads at two row strides", "case": case,
          "ms_ld_d_plus_1": k2_ms, "ms_ld_d": k2_ms_ld_d, "ratio": k2_ms / k2_ms_ld_d})
    if record:
        results["sgns_grads_fused"]["ms_ld_d"] = k2_ms_ld_d


def _alias_bound(start, degree, r1, r2, dg) -> tuple:
    """K15's bound: the per-walker inputs and output, and each prob /
    alias / indices entry the draws touch, read once."""
    live = degree > 0
    deg = torch.clamp(degree, min=1)
    slot = torch.minimum((r1 * deg).to(torch.int32), deg - 1)
    e = (start + slot)[live].long()
    j = torch.where(r2[live] < dg.prob[e], slot[live], dg.alias[e])
    n_tab = 2 * int(torch.unique(e).numel()) + int(torch.unique(start[live] + j).numel())
    return bound_ms(20 * start.numel() + 4 * n_tab, 0)


def check_alias_draw(graph, record: bool, results: dict, case: str) -> None:
    """K15 against its plain version, bit-equal: a walker at every vertex
    of ``graph`` on its CSR alias tables; then a CSR with degree-0 and
    degree-1 vertices and general weights (bit-equal, degree-0 lanes -1,
    degree-1 lanes their one neighbour) and a chi-square of 131,072 draws
    at one vertex of degree 12 against its edge weights."""
    dev = torch.device("cuda")
    dg = graph.to_device(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    start = dg.indptr[:-1].contiguous()
    degree = (dg.indptr[1:] - dg.indptr[:-1]).contiguous()
    r1 = torch.rand(start.shape, generator=gen, device=dev)
    r2 = torch.rand(start.shape, generator=gen, device=dev)
    args = (start, degree, r1, r2, dg.alias, dg.prob, dg.indices)
    got = ops.alias_draw(*args)
    want = alias_mod.alias_draw_plain(*args)
    n_diff = int((got != want).sum())
    require(n_diff == 0, f"alias_draw differs from its plain version in {n_diff} lanes")
    ms = time_ms(lambda: ops.alias_draw(*args))
    plain_ms = time_ms(lambda: alias_mod.alias_draw_plain(*args))
    bound = _alias_bound(*args[:4], dg)

    rng = np.random.default_rng(6)
    deg = rng.integers(0, 13, 4096)
    deg[:64], deg[64:128], deg[128] = 0, 1, 12
    indptr = np.zeros(len(deg) + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    weights = (rng.random(int(indptr[-1])) * 3 + 0.05).astype(np.float32)
    indices = rng.integers(0, len(deg), int(indptr[-1])).astype(np.int32)
    al, pr = alias_mod.build_alias_csr(indptr, weights)
    verts = np.tile(np.arange(len(deg)), 8)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    e_args = (t(indptr[verts].astype(np.int32)), t(deg[verts].astype(np.int32)),
              t(rng.random(len(verts), dtype=np.float32)),
              t(rng.random(len(verts), dtype=np.float32)), t(al), t(pr), t(indices))
    e_got = ops.alias_draw(*e_args).cpu().numpy()
    e_diff = int((e_got != alias_mod.alias_draw_plain(*e_args).cpu().numpy()).sum())
    dv = deg[verts]
    require(e_diff == 0 and bool((e_got[dv == 0] == -1).all())
            and bool((e_got[dv == 1] == indices[indptr[verts[dv == 1]]]).all()),
            f"alias_draw edge cases: {e_diff} lanes differ, or a degree-0/1 lane is wrong")
    from scipy import stats

    n = 131072
    lo, hi = int(indptr[128]), int(indptr[129])
    c_args = (torch.full((n,), lo, dtype=torch.int32, device=dev),
              torch.full((n,), 12, dtype=torch.int32, device=dev),
              torch.rand(n, generator=gen, device=dev), torch.rand(n, generator=gen, device=dev),
              t(al), t(pr), torch.arange(len(indices), dtype=torch.int32, device=dev))
    slots = (ops.alias_draw(*c_args) - lo).cpu().numpy()
    counts = np.bincount(slots, minlength=12)
    w = weights[lo:hi].astype(np.float64)
    pval = float(stats.chisquare(counts, w / w.sum() * n).pvalue)
    require(pval > 1e-4, f"alias_draw chi-square p {pval}")
    emit({"phase": "edge_case", "kernel": "alias_draw", "case": case,
          "degree_0_and_1_lanes": int((dv <= 1).sum()), "lanes_differing": e_diff,
          "chi2_pvalue": pval})
    _emit_rows({"alias_draw": (n_diff, ms, plain_ms, bound, None)}, record, results, {},
               case=case, walkers=int(start.numel()), bit_equal=n_diff == 0)


def small_reference() -> None:
    """Quickstart on karate: the card's walks equal the CPU plain path's."""
    edges = np.array([
        (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10),
        (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21), (0, 31), (1, 2),
        (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21), (1, 30), (2, 3),
        (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28), (2, 32), (3, 7),
        (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10), (5, 16), (6, 16),
        (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32), (14, 33),
        (15, 32), (15, 33), (18, 32), (18, 33), (19, 33), (20, 32), (20, 33),
        (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32), (23, 33),
        (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33),
        (28, 31), (28, 33), (29, 32), (29, 33), (30, 32), (30, 33), (31, 32),
        (31, 33), (32, 33),
    ], dtype=np.int32)
    walks = {}
    for device, chunk in (("cuda", 64), ("cpu", 1 << 17)):  # gid_base > 0 on the card
        n2v = Node2Vec(n2v_params={"num_walks": 10, "walk_length": 20, "walker_chunk": chunk,
                                   "return_param": 0.25, "inout_param": 4.0},
                       w2v_params={"min_count": 1}, device=device)
        n2v.preprocess_input_graph((edges[:, 0], edges[:, 1]), directed=False)
        walks[device] = n2v.random_walk()
    equal = bool((walks["cuda"] == walks["cpu"]).all())
    emit({"phase": "small_reference", "graph": "karate", "walks": list(walks["cuda"].shape),
          "walks_bit_equal_cuda_vs_cpu": equal})
    require(equal, "karate walks differ between the card and the CPU plain path")


def main_path(src, dst, max_iter: int) -> dict:
    n2v = Node2Vec(
        n2v_params={"num_walks": 10, "walk_length": 20, "return_param": 0.25,
                    "inout_param": 4.0},
        w2v_params={"vector_size": 128, "window_size": 5, "negative": 5,
                    "min_count": 10, "max_iter": max_iter},
        random_seed=0,
        device="cuda",
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    graph = n2v.preprocess_input_graph((src, dst), indexed=True, directed=False)
    t1 = time.perf_counter()
    walks = n2v.random_walk()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    model = n2v.fit()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    names, vectors = n2v.embedding(as_frame=False)
    t4 = time.perf_counter()
    launches = {k: int(_build.launches[k]) for k in _build.KERNELS}
    peak = torch.cuda.max_memory_allocated()

    deg = np.diff(graph.indptr)
    steps = int((walks[:, 1:] >= 0).sum())
    p = model.params
    n_walks, length = walks.shape
    batch = _effective_batch(p.batch_walks, n_walks)
    n_batches = -(-n_walks // batch)
    pairs = sg.pairs_per_batch(batch, length - 1, p.window_size) * n_batches * max_iter
    out = {
        "phase": "main_path", "max_iter_cut_to": max_iter,
        "n_vertices": graph.n_vertices, "n_edges": graph.n_edges,
        "max_degree": int(deg.max()),
        "P": int(n2v._walk_engine().packed_adj.shape[1] // 2),
        "walks": [int(n_walks), int(length)], "walk_steps": steps,
        "batch_walks": batch, "n_batches": n_batches,
        "preprocess_s": t1 - t0, "walk_s": t2 - t1, "fit_s": t3 - t2,
        "embedding_s": t4 - t3,
        "walk_steps_per_s": steps / (t2 - t1),
        "sgns_pair_updates_per_s": pairs / (t3 - t2),
        "epoch_losses": model.losses,
        "peak_device_memory_bytes": int(peak),
        "launches": launches,
        "n_vectors": len(names), "vector_dim": int(vectors.shape[1]),
    }
    emit(out)
    # what came out is right
    require(walks.shape == (10 * graph.n_vertices, 21), f"walk corpus shape {walks.shape}")
    require(bool((walks[:, 0] >= 0).all()), "a start vertex is missing")
    check_steps(graph, walks)
    require(vectors.shape == (graph.n_vertices, 128), f"vectors shape {vectors.shape}")
    require(bool(np.isfinite(vectors).all()), "non-finite embedding values")
    require(all(np.isfinite(x) for x in model.losses), "non-finite loss")
    require(launches["dense_walk"] == -(-n_walks // 131072),
            f"dense_walk launched {launches['dense_walk']} times")
    for k in ("sgns_grads", "adagrad_accumulate", "adagrad_apply"):
        require(launches[k] == n_batches * max_iter, f"{k} launched {launches[k]} times")
    require(all(launches[k] > 0 for k in DENSE_PATH), f"a kernel never ran: {launches}")
    breakdown((("random_walk", n2v.random_walk), ("fit", n2v.fit)))
    return out, n2v


def check_steps(graph, walks: np.ndarray, n_check: int = 2000) -> None:
    """Every step of ``n_check`` random walks is an edge of the CSR."""
    rng = np.random.default_rng(0)
    for w in rng.integers(0, len(walks), n_check):
        path = walks[w][walks[w] >= 0]
        for a, b in zip(path[:-1], path[1:]):
            lo, hi = graph.indptr[a], graph.indptr[a + 1]
            require(b in graph.indices[lo:hi], f"walk {w} steps {a}->{b}, not an edge")


def main_path_blocked(src, dst, max_iter: int):
    """Node2Vec on the heavy-tail RMAT: preprocess -> run_pipeline(streaming=
    False) -> embedding, the corpus on the card from the walk to the count."""
    n2v = Node2Vec(
        n2v_params={"num_walks": 10, "walk_length": 20, "return_param": 0.25,
                    "inout_param": 4.0},
        w2v_params={"vector_size": 128, "window_size": 5, "negative": 5,
                    "min_count": 10, "max_iter": max_iter},
        max_out_degree=10_000,
        random_seed=0,
        device="cuda",
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    graph = n2v.preprocess_input_graph((src, dst), indexed=True, directed=False)
    t1 = time.perf_counter()
    engine = n2v._walk_engine()  # packs and uploads the blocked tables
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    walk_s, fit_s = [], []

    def timed(fn, into):  # a stage inside run_pipeline, synchronised
        def run(*args, **kwargs):
            ts = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            into.append(time.perf_counter() - ts)
            return out
        return run

    new_backend = n2v._new_backend

    def timed_backend(*args, **kwargs):
        backend = new_backend(*args, **kwargs)
        backend.model.fit = timed(backend.model.fit, fit_s)
        return backend

    engine.run_device = timed(engine.run_device, walk_s)
    n2v._new_backend = timed_backend
    model = n2v.run_pipeline(streaming=False)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del engine.run_device, n2v._new_backend, model.fit
    names, vectors = n2v.embedding(as_frame=False)
    t4 = time.perf_counter()
    launches = {k: int(_build.launches[k]) for k in _build.KERNELS}
    peak = torch.cuda.max_memory_allocated()

    walks = n2v.walks
    deg = np.diff(graph.indptr)
    steps = int((walks[:, 1:] >= 0).sum())
    n_walks, length = walks.shape
    p = model.params
    batch = _effective_batch(p.batch_walks, n_walks)
    n_batches = -(-n_walks // batch)
    chunk = engine._effective_chunk(n_walks)
    pairs = sg.pairs_per_batch(batch, length - 1, p.window_size) * n_batches * max_iter
    out = {
        "phase": "main_path_blocked", "cuts": {"max_iter": f"10 -> {max_iter}",
                                               "streaming": "auto (40 chunks) -> False"},
        "n_vertices": graph.n_vertices, "n_edges": graph.n_edges,
        "max_degree": int(deg.max()), "strategy": engine.strategy,
        "P": engine.bgraph.light_width, "C": engine.bgraph.block_width,
        "walks": [int(n_walks), int(length)], "walk_steps": steps,
        "walker_chunk": chunk, "batch_walks": batch, "n_batches": n_batches,
        "preprocess_s": t1 - t0, "tables_s": t2 - t1, "walk_s": walk_s[0],
        "fit_s": fit_s[0], "pipeline_s": t3 - t2, "embedding_s": t4 - t3,
        "walk_steps_per_s": steps / walk_s[0],
        "attempts_per_step": engine.attempt_count / max(steps, 1),
        "fallback_count": engine.fallback_count,
        "sgns_pair_updates_per_s": pairs / fit_s[0],
        "epoch_losses": model.losses, "vocab_kept": model.vocab.n_kept,
        "peak_device_memory_bytes": int(peak),
        "launches": launches,
        "n_vectors": len(names), "vector_dim": int(vectors.shape[1]),
    }
    emit(out)
    require(engine.strategy == "blocked", f"strategy {engine.strategy}")
    require(walks.shape == (10 * graph.n_vertices, 21), f"walk corpus shape {walks.shape}")
    require(bool((walks[:, 0] >= 0).all()), "a start vertex is missing")
    check_steps(graph, walks)
    require(vectors.shape == (graph.n_vertices, 128), f"vectors shape {vectors.shape}")
    require(bool(np.isfinite(vectors).all()), "non-finite embedding values")
    require(all(np.isfinite(x) for x in model.losses), "non-finite loss")
    require(launches["blocked_walk"] == -(-n_walks // chunk),
            f"blocked_walk launched {launches['blocked_walk']} times")
    require(launches["vertex_counts"] == 1,
            f"vertex_counts launched {launches['vertex_counts']} times")
    for k in ("sgns_grads", "adagrad_accumulate", "adagrad_apply"):
        require(launches[k] == n_batches * max_iter, f"{k} launched {launches[k]} times")
    require(launches["dense_walk"] == 0, "the blocked path launched the dense walk")
    walks_dev = torch.from_numpy(walks).cuda()
    breakdown((("random_walk", lambda: engine.run_device(seed=0)),
               ("fit", lambda: model.fit(walks_dev, n_vertices=graph.n_vertices))))
    return out, walks_dev, graph.n_vertices


def _fresh_run() -> None:
    """Counts to 0 and peak memory reset, just before a main path."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()


def _launches() -> dict:
    return {k: int(_build.launches[k]) for k in _build.KERNELS + _build.MODE_COUNTS}


def main_path_streaming(src, dst, max_iter: int):
    """Node2Vec on the heavy-tail RMAT through ``run_pipeline()`` with no
    argument: 40 walker chunks, so it streams (``fit_streaming`` over
    ``chunk_source``), the corpus never materialized."""
    n2v = Node2Vec(n2v_params=N2V_MAIN, w2v_params={**W2V_MAIN, "max_iter": max_iter},
                   max_out_degree=10_000, random_seed=0, device="cuda")
    _fresh_run()
    t0 = time.perf_counter()
    graph = n2v.preprocess_input_graph((src, dst), indexed=True, directed=False)
    t1 = time.perf_counter()
    engine = n2v._walk_engine()  # packs and uploads the blocked tables
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    walk_events = []
    run_chunk = engine._run_chunk

    def timed_chunk(*args, **kwargs):  # device time of every regenerated chunk
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_chunk(*args, **kwargs)
        end.record()
        walk_events.append((start, end))
        return out

    engine._run_chunk = timed_chunk
    model = n2v.run_pipeline()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del engine._run_chunk
    names, vectors = n2v.embedding(as_frame=False)
    t4 = time.perf_counter()
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()

    n_chunks, chunk, _ = engine.chunk_source(seed=0)
    p = model.params
    batch = _effective_batch(p.batch_walks, chunk, target_updates=max(512 // n_chunks, 1))
    n_batches = chunk // batch
    walk_s = sum(a.elapsed_time(b) for a, b in walk_events) / 1e3
    pipeline_s = t3 - t2
    pairs = sg.pairs_per_batch(batch, N2V_MAIN["walk_length"], p.window_size) * n_batches \
        * n_chunks * max_iter
    out = {
        "phase": "main_path_streaming", "cuts": {"max_iter": f"10 -> {max_iter}"},
        "n_vertices": graph.n_vertices, "n_edges": graph.n_edges, "strategy": engine.strategy,
        "walker_chunk": chunk, "n_chunks": n_chunks, "batch_walks": batch,
        "n_batches_per_chunk": n_batches, "preprocess_s": t1 - t0, "tables_s": t2 - t1,
        "pipeline_s": pipeline_s, "walk_regeneration_device_s": walk_s,
        "walk_regenerations": len(walk_events), "fit_s": pipeline_s - walk_s,
        "sgns_pair_updates_per_s": pairs / pipeline_s, "embedding_s": t4 - t3,
        "epoch_losses": model.losses, "vocab_kept": model.vocab.n_kept,
        "peak_device_memory_bytes": int(peak), "launches": launches,
        "n_vectors": len(names), "vector_dim": int(vectors.shape[1]),
    }
    emit(out)
    require(engine.strategy == "blocked", f"strategy {engine.strategy}")
    require(n2v.walks is None, "run_pipeline() did not stream")
    require(n_chunks == 40 and n_batches == 16, f"{n_chunks} chunks of {n_batches} batches")
    require(int(model.vocab.counts.sum()) > 0, "the counting pass counted nothing")
    require(vectors.shape == (graph.n_vertices, 128), f"vectors shape {vectors.shape}")
    require(bool(np.isfinite(vectors).all()), "non-finite embedding values")
    require(len(model.losses) == max_iter and all(np.isfinite(x) for x in model.losses),
            f"losses {model.losses}")
    require(launches["blocked_walk"] == n_chunks * (1 + max_iter),
            f"blocked_walk launched {launches['blocked_walk']} times")
    require(launches["vertex_counts"] == n_chunks,
            f"vertex_counts launched {launches['vertex_counts']} times")
    for k in ("sgns_grads", "adagrad_accumulate", "adagrad_apply"):
        require(launches[k] == n_chunks * n_batches * max_iter,
                f"{k} launched {launches[k]} times")
    require(launches["dense_walk"] == 0 and launches["subsample_walks"] == 0,
            f"a kernel off the streaming path ran: {launches}")
    source_token = n2v._stream_source_token(engine)
    resume_drill(engine, model, source_token, max_iter)
    breakdown((("run_pipeline (streaming)", lambda: Word2VecTorch(p, device="cuda")
                .fit_streaming(engine.chunk_source(seed=0)[2], n_chunks, graph.n_vertices)),))
    return out, engine, graph.n_vertices


def resume_drill(engine: WalkEngine, full, source_token: str, max_iter: int) -> None:
    """fit_streaming with a snapshot every 8 chunks, killed by walk_source
    at the chunk in position 20 of the first epoch (after the counting
    pass), then run again: it resumes at chunk 16 without counting."""
    ck = os.path.join(ROOT, "build", "chip_smoke_resume")
    shutil.rmtree(ck, ignore_errors=True)
    n_chunks, _, source = engine.chunk_source(seed=0)
    n_v = engine.n_vertices
    calls = [0]

    def dying(i):
        calls[0] += 1
        if calls[0] > n_chunks + 20:
            raise RuntimeError("simulated kill")
        return source(i)

    kw = dict(checkpoint_dir=ck, checkpoint_every_chunks=8, source_token=source_token)
    try:
        Word2VecTorch(full.params, device="cuda").fit_streaming(dying, n_chunks, n_v, **kw)
    except RuntimeError as exc:
        if "simulated kill" not in str(exc):
            raise
    else:
        require(False, "the drill's first run was not interrupted")
    snap = np.load(os.path.join(ck, "stream_state.npz"))
    cursor = (int(snap["epoch"]), int(snap["chunk"]))
    require(cursor == (0, 16), f"snapshot cursor {cursor}, expected (0, 16)")
    _build.reset_launches()
    t0 = time.perf_counter()
    resumed = Word2VecTorch(full.params, device="cuda").fit_streaming(source, n_chunks, n_v, **kw)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    launches = _launches()
    t0 = time.perf_counter()
    state = load_stream_state(ck, stream_fingerprint(full.params, n_chunks, n_v, source_token))
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_stream_state(ck, "timing", *state[:2], *resumed._to_host(
        (resumed._emb_in, resumed._emb_out, resumed.acc_in, resumed.acc_out)), *state[6:9],
        chunk_walks=state[9])
    save_s = time.perf_counter() - t0
    shutil.rmtree(ck, ignore_errors=True)
    vectors = resumed.vectors
    emit({"phase": "resume_drill", "killed_at_chunk_position": 20, "snapshot_every": 8,
          "resumed_from": list(cursor), "resume_s": resume_s, "snapshot_load_s": load_s,
          "snapshot_save_s": save_s, "launches": launches,
          "losses": resumed.losses, "uninterrupted_losses": full.losses,
          "max_abs_diff_vs_uninterrupted": float(np.abs(vectors - full.vectors).max())})
    require(launches["vertex_counts"] == 0, "the resumed run counted the corpus again")
    require(launches["blocked_walk"] == n_chunks - 16 + n_chunks * (max_iter - 1),
            f"the resumed run walked {launches['blocked_walk']} chunks")
    require(len(resumed.losses) == max_iter and all(np.isfinite(resumed.losses)),
            f"resumed losses {resumed.losses}")
    require(bool(np.isfinite(vectors).all()), "non-finite tables after the resume")


def _tree_line(model) -> dict:
    tree = model.tree
    n_head, k_rows = hs.head_split(model.head_offsets, tree.points.shape[1])
    return {"code_length": int(tree.points.shape[1]), "n_inner": tree.n_inner,
            "code_lengths": [int(tree.lengths.min()), int(tree.lengths.max())],
            **({} if model.params.sg == 0 else {"head_levels": n_head, "head_rows": k_rows})}


def main_path_host(src, dst, max_iter: int, phase: str = "main_path_host", w2v=None,
                   grads: str = "sgns_grads"):
    """Node2Vec(host_corpus=True) on the dense graph with sample=1e-3: the
    walks go to host memory, the engine's tables are released, fit_host
    uploads slabs double-buffered and subsamples each on the card.  SGNS
    (``main_path_host``), or CBOW-HS with ``w2v={"sg": 0, "negative": 0}``
    (``main_path_cbow_hs``: ``grads`` "cbow_hs_grads")."""
    n2v = Node2Vec(n2v_params=N2V_MAIN,
                   w2v_params={**W2V_MAIN, "max_iter": max_iter, "sample": 1e-3, **(w2v or {})},
                   random_seed=0, device="cuda", host_corpus=True)
    _fresh_run()
    t0 = time.perf_counter()
    graph = n2v.preprocess_input_graph((src, dst), indexed=True, directed=False)
    t1 = time.perf_counter()
    fit_s = []
    new_backend = n2v._new_backend

    def timed_backend(*args, **kwargs):
        backend = new_backend(*args, **kwargs)
        fit_host = backend.model.fit_host

        def timed(*a, **k):
            ts = time.perf_counter()
            out = fit_host(*a, **k)
            torch.cuda.synchronize()
            fit_s.append(time.perf_counter() - ts)
            return out
        backend.model.fit_host = timed
        return backend

    n2v._new_backend = timed_backend
    model = n2v.run_pipeline()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del n2v._new_backend, model.fit_host
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    walks = n2v.walks
    n_walks, length = walks.shape
    p = model.params
    batch = _effective_batch(p.batch_walks, n_walks)
    slab = (min(1 << 20, n_walks) // batch) * batch
    slab_batches = slab // batch
    n_slabs = -(-n_walks // slab)
    ref = model._h2d_events[0][0]
    copies = [(ref.elapsed_time(a), ref.elapsed_time(b)) for a, b in model._h2d_events]
    trains = [(ref.elapsed_time(a), ref.elapsed_time(b)) for a, b in model._slab_events]
    h2d_ms = [b - a for a, b in copies]
    hidden_ms = [sum(max(0.0, min(c1, t1) - max(c0, t0)) for t0, t1 in trains)
                 for c0, c1 in copies]
    steps = slab_batches * n_slabs * max_iter
    if p.sg == 0:  # nominal centers, B * L1 a step
        rate = {"cbow_center_updates_per_fit_s": batch * length * steps / fit_s[0]}
    else:
        rate = {"sgns_pair_updates_per_s":
                sg.pairs_per_batch(batch, length - 1, p.window_size) * steps / fit_s[0]}
    out = {
        "phase": phase, "cuts": {"max_iter": f"10 -> {max_iter}"},
        "sample": p.sample, "n_vertices": graph.n_vertices, "walks": [int(n_walks), int(length)],
        "batch_walks": batch, "slab_walks": slab, "n_slabs": n_slabs,
        "slab_batches": slab_batches, "preprocess_s": t1 - t0, "pipeline_s": t2 - t1,
        "fit_s": fit_s[0], "walk_s": t2 - t1 - fit_s[0], **rate,
        "h2d_ms_per_slab": h2d_ms, "h2d_hidden_ms_per_slab": hidden_ms,
        "h2d_hidden_share": sum(hidden_ms) / max(sum(h2d_ms), 1e-9),
        "h2d_intervals_ms": copies, "train_intervals_ms": trains,
        "h2d_bytes_per_slab": slab * length * 4,
        "epoch_losses": model.losses, "slab_losses": model._slab_losses,
        "peak_device_memory_bytes": int(peak), "launches": launches,
    }
    if model.tree is not None:
        out["tree"] = _tree_line(model)
    emit(out)
    require(n2v._engine is None, "the engine's device tables were not released")
    require(walks.shape == (10 * graph.n_vertices, 21), f"walk corpus shape {walks.shape}")
    check_steps(graph, walks)
    vectors = model.vectors
    require(vectors.shape == (graph.n_vertices, 128), f"vectors shape {vectors.shape}")
    require(bool(np.isfinite(vectors).all()), "non-finite embedding values")
    require(bool(np.isfinite(model.emb_out).all()), "non-finite output table")
    require(len(model.losses) == max_iter and all(np.isfinite(model.losses)),
            f"losses {model.losses}")
    require(launches["dense_walk"] == -(-n_walks // 131072),
            f"dense_walk launched {launches['dense_walk']} times")
    require(launches["subsample_walks"] == n_slabs * max_iter,
            f"subsample_walks launched {launches['subsample_walks']} times")
    for k in (grads, "adagrad_accumulate", "adagrad_apply"):
        require(launches[k] == n_slabs * slab_batches * max_iter,
                f"{k} launched {launches[k]} times")
    require(all(launches[k] == 0 for k in GRADS if k != grads),
            f"another objective's kernel ran: {launches}")
    path = ("dense_walk", "subsample_walks", grads, "adagrad_accumulate", "adagrad_apply")
    require(all(launches[k] > 0 for k in path), f"a kernel never ran: {launches}")
    breakdown((("fit_host" if phase == "main_path_host" else f"fit_host ({phase})",
                lambda: Word2VecTorch(p, device="cuda").fit_host(
                    walks, n_vertices=graph.n_vertices)),))
    return out, walks, model.vocab, slab


def main_path_streamed(src, dst, max_iter: int, phase: str, w2v: dict, grads: str,
                       update=ADAGRAD):
    """Node2Vec on the dense graph through ``run_pipeline()`` with no
    argument: 10 walker chunks, so it streams (K1 counting and training,
    K6's streaming form, ``grads`` and ``update`` every step).
    ``main_path_hs``: negative=0 (hierarchical softmax, the reference's
    default objective, its Huffman tree from the pass-1 counts, K8 and
    K3/K4); ``main_path_cbow``: sg=0, negative 5 (CBOW-NS, K9 and K3/K4);
    ``main_path_sgd``: SGNS with optimizer="sgd", step_size 0.025 (K2, K11
    preagg_rows and sgd_apply)."""
    n2v = Node2Vec(n2v_params=N2V_MAIN,
                   w2v_params={**W2V_MAIN, **w2v, "max_iter": max_iter},
                   random_seed=0, device="cuda")
    _fresh_run()
    t0 = time.perf_counter()
    graph = n2v.preprocess_input_graph((src, dst), indexed=True, directed=False)
    t1 = time.perf_counter()
    engine = n2v._walk_engine()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    walk_events = []
    run_chunk = engine._run_chunk

    def timed_chunk(*args, **kwargs):  # device time of every regenerated chunk
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_chunk(*args, **kwargs)
        end.record()
        walk_events.append((start, end))
        return out

    engine._run_chunk = timed_chunk
    model = n2v.run_pipeline()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del engine._run_chunk
    names, vectors = n2v.embedding(as_frame=False)
    t4 = time.perf_counter()
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()

    n_chunks, chunk, _ = engine.chunk_source(seed=0)
    p = model.params
    batch = _effective_batch(p.batch_walks, chunk, target_updates=max(512 // n_chunks, 1))
    n_batches = chunk // batch
    walk_s = sum(a.elapsed_time(b) for a, b in walk_events) / 1e3
    pipeline_s = t3 - t2
    steps = n_batches * n_chunks * max_iter
    length = N2V_MAIN["walk_length"] + 1
    pair_rate = sg.pairs_per_batch(batch, length - 1, p.window_size) * steps / (pipeline_s - walk_s)
    if p.sg == 0:  # nominal centers, B * L1 a step
        objective = "CBOW with negative sampling (sg=0)"
        rate = {"cbow_center_updates_per_fit_s": batch * length * steps / (pipeline_s - walk_s)}
    elif p.negative == 0:
        objective = "hierarchical softmax (negative=0)"
        rate = {"hs_pair_updates_per_fit_s": pair_rate}
    else:
        objective = f"SGNS with optimizer={p.optimizer}, step_size {p.step_size}"
        rate = {"sgns_pair_updates_per_fit_s": pair_rate}
    out = {
        "phase": phase, "cuts": {"max_iter": f"10 -> {max_iter}"}, "objective": objective,
        "n_vertices": graph.n_vertices, "n_edges": graph.n_edges, "strategy": engine.strategy,
        **({"tree": _tree_line(model)} if model.tree is not None else {}),
        "walker_chunk": chunk, "n_chunks": n_chunks, "batch_walks": batch,
        "n_batches_per_chunk": n_batches, "preprocess_s": t1 - t0, "tables_s": t2 - t1,
        "pipeline_s": pipeline_s, "walk_regeneration_device_s": walk_s,
        "walk_regenerations": len(walk_events), "fit_s": pipeline_s - walk_s, **rate,
        "embedding_s": t4 - t3,
        "epoch_losses": model.losses, "vocab_kept": model.vocab.n_kept,
        "peak_device_memory_bytes": int(peak), "launches": launches,
        "n_vectors": len(names), "vector_dim": int(vectors.shape[1]),
    }
    emit(out)
    n_out = model.tree.n_inner if model.tree is not None else graph.n_vertices
    require(engine.strategy == "dense", f"strategy {engine.strategy}")
    require(n2v.walks is None, "run_pipeline() did not stream")
    require(n_chunks == 10 and n_batches == 51, f"{n_chunks} chunks of {n_batches} batches")
    require(model.emb_out.shape == (n_out, 128), f"output table shape {model.emb_out.shape}")
    require(vectors.shape == (graph.n_vertices, 128), f"vectors shape {vectors.shape}")
    require(bool(np.isfinite(vectors).all()), "non-finite embedding values")
    require(bool(np.isfinite(model.emb_out).all()), "non-finite output table")
    require(len(model.losses) == max_iter and all(np.isfinite(x) for x in model.losses),
            f"losses {model.losses}")
    require(launches["dense_walk"] == n_chunks * (1 + max_iter),
            f"dense_walk launched {launches['dense_walk']} times")
    require(launches["vertex_counts"] == n_chunks,
            f"vertex_counts launched {launches['vertex_counts']} times")
    for k in (grads, *update):
        require(launches[k] == n_chunks * n_batches * max_iter,
                f"{k} launched {launches[k]} times")
    off = [k for k in (*GRADS, *ADAGRAD, *SGD, "blocked_walk", "subsample_walks", "csr_walk")
           if k != grads and k not in update]
    require(all(launches[k] == 0 for k in off), f"a kernel off the {phase} path ran: {launches}")
    path = ("dense_walk", "vertex_counts", grads, *update)
    require(all(launches[k] > 0 for k in path), f"a kernel never ran: {launches}")
    label = {"main_path_hs": "HS", "main_path_cbow": "CBOW", "main_path_sgd": "SGNS-SGD"}[phase]
    breakdown(((f"run_pipeline ({label}, streaming)", lambda: Word2VecTorch(p, device="cuda")
                .fit_streaming(engine.chunk_source(seed=0)[2], n_chunks, graph.n_vertices)),))
    return out


def main_path_csr(graph, max_iter: int) -> dict:
    """The CSR walk engine on the heavy-tail RMAT:
    ``WalkEngine(graph, params, strategy="csr", device="cuda").run_device()``
    (its DeviceGraph uploaded at the first chunk; 40 chunks of K12), then
    ``Word2VecTorch.fit`` on the corpus on the card (K6, K2-K4)."""
    params = Node2VecParams(**N2V_MAIN)
    w2v = Word2VecParams(**W2V_MAIN, max_iter=max_iter)
    _fresh_run()
    t0 = time.perf_counter()
    engine = WalkEngine(graph, params, strategy="csr", device="cuda")
    walks = engine.run_device(seed=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model = Word2VecTorch(w2v, device="cuda").fit(walks, n_vertices=graph.n_vertices)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    n_walks, length = walks.shape
    n_chunks = -(-n_walks // engine._effective_chunk(n_walks))
    steps = int((walks[:, 1:] >= 0).sum())
    batch = _effective_batch(w2v.batch_walks, n_walks)
    n_batches = -(-n_walks // batch)
    pairs = sg.pairs_per_batch(batch, length - 1, w2v.window_size) * n_batches * max_iter
    out = {
        "phase": "main_path_csr", "cuts": {"max_iter": f"10 -> {max_iter}"},
        "strategy": engine.strategy, "n_vertices": graph.n_vertices, "n_edges": graph.n_edges,
        "max_degree": engine.max_degree, "search_iters": engine.search_iters,
        "device_graph_bytes": sum(t.numel() * t.element_size() for t in engine.dgraph),
        "walks": [int(n_walks), int(length)], "walk_steps": steps,
        "walker_chunk": engine._effective_chunk(n_walks), "n_chunks": n_chunks,
        "walk_s": t1 - t0, "walk_steps_per_s": steps / (t1 - t0), "fit_s": t2 - t1,
        "batch_walks": batch, "n_batches": n_batches, "sgns_pair_updates_per_s": pairs / (t2 - t1),
        "epoch_losses": model.losses, "peak_device_memory_bytes": int(peak),
        "launches": launches,
    }
    emit(out)
    require(engine.strategy == "csr", f"strategy {engine.strategy}")
    require(walks.shape == (10 * graph.n_vertices, 21), f"walk corpus shape {walks.shape}")
    walks_np = walks.cpu().numpy()
    require(bool((walks_np[:, 0] >= 0).all()), "a start vertex is missing")
    check_steps(graph, walks_np)
    require(n_chunks == 40 and launches["csr_walk"] == n_chunks,
            f"csr_walk launched {launches['csr_walk']} times for {n_chunks} chunks")
    require(launches["dense_walk"] == 0 and launches["blocked_walk"] == 0,
            f"another walk kernel ran: {launches}")
    require(launches["vertex_counts"] == 1, f"vertex_counts launched {launches['vertex_counts']}")
    for k in ("sgns_grads", *ADAGRAD):
        require(launches[k] == n_batches * max_iter, f"{k} launched {launches[k]} times")
    vectors = model.vectors
    require(vectors.shape == (graph.n_vertices, 128) and bool(np.isfinite(vectors).all()),
            "non-finite or misshapen vectors")
    require(all(np.isfinite(model.losses)), f"losses {model.losses}")
    breakdown((("run_device (csr)", lambda: engine.run_device(seed=0)),
               ("fit (csr walks)", lambda: Word2VecTorch(w2v, device="cuda").fit(
                   walks, n_vertices=graph.n_vertices))))
    return out


def _pair_epoch(graph):
    """The corpus, noise tables and geometry of main_path_pairs and
    main_path_fused: the Quickstart walks (K1) on ``graph``, their
    vocabulary (K6), shuffled once, cut into batches of 2,560 walks."""
    dev = torch.device("cuda")
    p = Word2VecParams(**W2V_MAIN, max_iter=1)
    walks = WalkEngine(graph, Node2VecParams(**N2V_MAIN), device="cuda").run_device(seed=0)
    vocab = build_vocab(walks, graph.n_vertices, min_count=p.min_count)
    n_walks, length = walks.shape
    batch = _effective_batch(p.batch_walks, n_walks)
    gen = torch.Generator(device=dev).manual_seed(0)
    corpus = walks[torch.randperm(n_walks, generator=gen, device=dev)]
    tables = tuple(torch.from_numpy(a).to(dev) for a in (vocab.ns_alias, vocab.ns_prob,
                                                         vocab.mask))
    n_batches = n_walks // batch

    def draws(gstep: int):  # the step's (b_sh, r1, r2), from a generator seeded by the step
        g = torch.Generator(device=dev).manual_seed(1000 + gstep)
        return sg.draw_step(g, batch, length, p.window_size, 64, True, dev)

    return dict(corpus=corpus, tables=tables, batch=batch, n_batches=n_batches, draws=draws,
                lr0=p.step_size, slope=p.step_size / n_batches, min_lr=p.min_step_size,
                V=graph.n_vertices, dim=p.vector_size, window=p.window_size,
                negatives=p.negative, walks=[int(n_walks), int(length)])


def _pair_steps(state, ep, steps, step=sg.sgns_train_step, pairs=None):
    kw = dict(window=ep["window"], negatives=ep["negatives"], pairs=pairs)
    losses = []
    for b in steps:
        lr = sg.step_lr(ep["lr0"], ep["slope"], b, ep["min_lr"])
        wb = ep["corpus"][b * ep["batch"]:(b + 1) * ep["batch"]]
        losses.append(step(*state, wb, *ep["draws"](b), lr, *ep["tables"], **kw))
    return torch.stack(losses)


def _fused_epoch(tabs, ep, pairs=None):
    return sg.sgns_epoch_fused(*tabs, ep["corpus"], ep["draws"], 0, ep["lr0"], ep["slope"],
                               *ep["tables"], batch=ep["batch"], n_batches=ep["n_batches"],
                               window=ep["window"], negatives=ep["negatives"],
                               min_lr=ep["min_lr"], pairs=pairs)


def _trained_line(phase: str, ep, t0, t1, t2, losses, n_valid: int) -> dict:
    return {"phase": phase, "walks": ep["walks"], "batch_walks": ep["batch"],
            "n_batches": ep["n_batches"], "walk_and_vocab_s": t1 - t0, "train_s": t2 - t1,
            "valid_pairs": n_valid, "pair_updates_per_s": n_valid / (t2 - t1),
            "loss_first_step": float(losses[0]), "loss_last_step": float(losses[-1]),
            "peak_device_memory_bytes": int(torch.cuda.max_memory_allocated()),
            "launches": _launches()}


def main_path_pairs(graph):
    """``sgns_train_step``, the pair-based step a user drives in a loop:
    the Quickstart walks on the dense graph (K1), ``build_vocab`` on the
    card (K6), then one epoch at B = 2,560 (512 steps) with ``step_lr`` and
    draws from seeded torch.Generators: K13 (pair lists and gradients) and
    K3/K4 512 times each, K2 never.  Then the first 3 steps against
    ``sgns_train_step_plain`` from the same state, and the epoch profiled."""
    _fresh_run()
    t0 = time.perf_counter()
    ep = _pair_epoch(graph)
    state0 = sg.init_embeddings(ep["V"], ep["dim"], seed=1, device="cuda")
    state = [t.clone() for t in state0]
    pairs = torch.zeros((), dtype=torch.int64, device="cuda")  # K13's valid lanes
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = _pair_steps(state, ep, range(ep["n_batches"]), pairs=pairs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = _trained_line("main_path_pairs", ep, t0, t1, t2, losses.cpu(), int(pairs))
    launches = out["launches"]
    emit(out)
    nb = ep["n_batches"]
    for k in ("pair_lists", "sgns_pair_grads", "adagrad_accumulate", "adagrad_apply"):
        require(launches[k] == nb, f"main_path_pairs launched {k} {launches[k]} times")
    require(launches["sgns_grads"] == 0 and launches["dense_walk"] > 0
            and launches["vertex_counts"] == 1, f"main_path_pairs launches {launches}")
    require(bool(torch.isfinite(losses).all()) and all(bool(torch.isfinite(t).all())
                                                       for t in state),
            "main_path_pairs: non-finite loss or tables")
    k_state = [t.clone() for t in state0]
    p_state = [t.clone() for t in state0]
    err = 0.0
    for b in range(3):
        loss_k = _pair_steps(k_state, ep, [b])
        loss_p = _pair_steps(p_state, ep, [b], sg.sgns_train_step_plain)
        err = max(err, _close_state(f"main_path_pairs step {b}", k_state, loss_k, p_state,
                                    loss_p))
    emit({"phase": "check", "kernel": "main_path_pairs: 3 steps against sgns_train_step_plain",
          "max_abs_err": err})
    breakdown((("sgns_train_step epoch",
                lambda: _pair_steps([t.clone() for t in state0], ep, range(nb))),))
    return out, ep


def main_path_fused(ep, results: dict):
    """``sgns_epoch_fused`` on the corpus and draws of main_path_pairs,
    from ``init_fused_embeddings``: K2 at row stride 129 and K14 512 times
    each, K3/K4 never.  The JAX package documents this step as diverging on
    duplicate-dense small graphs and gates no quality on it; the losses are
    printed.  Then its first 3 steps against the plain versions, and the
    epoch profiled."""
    _fresh_run()
    tabs0 = sg.init_fused_embeddings(ep["V"], ep["dim"], seed=1, device="cuda")
    tabs = [t.clone() for t in tabs0]
    pairs = torch.zeros((), dtype=torch.int64, device="cuda")  # K2's valid pairs
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = _fused_epoch(tabs, ep, pairs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = _trained_line("main_path_fused", ep, t1, t1, t2, losses.cpu(), int(pairs))
    out["sgns_grads_ms_ld_129"] = results["sgns_grads_fused"]["ms"]
    out["sgns_grads_ms_ld_128"] = results["sgns_grads_fused"]["ms_ld_d"]
    launches = out["launches"]
    emit(out)
    nb = ep["n_batches"]
    require(launches["sgns_grads"] == nb and launches["fused_adagrad"] == nb,
            f"main_path_fused launches {launches}")
    require(launches["adagrad_accumulate"] == 0 and launches["adagrad_apply"] == 0
            and launches["sgns_pair_grads"] == 0, f"main_path_fused launches {launches}")
    require(bool(torch.isfinite(losses).all()) and all(bool(torch.isfinite(t).all())
                                                       for t in tabs),
            "main_path_fused: non-finite loss or tables")
    kw = dict(window=ep["window"], negatives=ep["negatives"])
    k_tabs = [t.clone() for t in tabs0]
    p_tabs = [t.clone() for t in tabs0]
    err = 0.0
    for b in range(3):
        lr = sg.step_lr(ep["lr0"], ep["slope"], b, ep["min_lr"])
        wb = ep["corpus"][b * ep["batch"]:(b + 1) * ep["batch"]]
        loss_k = sg.sgns_walk_step_fused(*k_tabs, wb, *ep["draws"](b), lr, *ep["tables"], **kw)
        loss_p = sg.sgns_walk_step_fused_plain(*p_tabs, wb, *ep["draws"](b), lr, *ep["tables"],
                                               **kw)
        err = max(err,
                  _close_fused(f"main_path_fused step {b}[tab_in]", k_tabs[0], p_tabs[0]),
                  _close_fused(f"main_path_fused step {b}[tab_out]", k_tabs[1], p_tabs[1]),
                  _close(f"main_path_fused step {b}[loss]", loss_k, loss_p))
    emit({"phase": "check", "kernel": "main_path_fused: 3 steps against the plain versions",
          "max_abs_err": err})
    breakdown((("sgns_epoch_fused", lambda: _fused_epoch([t.clone() for t in tabs0], ep)),))
    return out


def surface(n2v, graph, src, dst) -> dict:
    """The rest of the one-device surface a user reaches on the card:
    ``save_model`` of the dense main path's model and ``load_model`` into a
    new ``Node2Vec(device="cuda")`` (vectors, counts, mask and names
    bit-equal), ``load_vectors`` of ``save_vectors``' file, the functional
    ``trim_index`` -> ``random_walk`` on the edge list (walks equal to
    ``WalkEngine.run``'s), a ``StepTimer`` through ``WalkEngine.run`` and
    ``fit``, and one first-order ``alias_draw`` (K15) from every vertex on
    the graph's CSR alias tables."""
    import pandas as pd

    _fresh_run()
    out_dir = os.path.join(ROOT, "build", "chip_smoke_surface")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    n2v.save_model(out_dir, "model")
    loaded = Node2Vec(w2v_params=n2v.w2v_params, device="cuda")
    model = loaded.load_model(out_dir, "model")
    ref = n2v.backend.model
    same = {"vectors": bool(np.array_equal(model.vectors, ref.vectors)),
            "emb_out": bool(np.array_equal(model.emb_out, ref.emb_out)),
            "counts": bool(np.array_equal(model.vocab.counts, ref.vocab.counts)),
            "mask": bool(np.array_equal(model.vocab.mask, ref.vocab.mask)),
            "names": loaded.backend.name_id == n2v.backend.name_id}
    t1 = time.perf_counter()
    n2v.save_vectors(out_dir, "vectors.txt")
    frame = loaded.load_vectors(out_dir, "vectors.txt")
    names, vectors = n2v.embedding(as_frame=False)
    vec_err = float(np.abs(np.stack(frame["vector"]) - vectors).max() / np.abs(vectors).max())
    same["vector_names"] = frame["name"].tolist() == [str(x) for x in names]
    t2 = time.perf_counter()

    n2v_one = {**N2V_MAIN, "num_walks": 1}
    edges, _ = trim_index(pd.DataFrame({"src": src, "dst": dst}), indexed=True, directed=False)
    frame_w = random_walk(edges, n2v_one, random_seed=0, device="cuda")
    timer = StepTimer()
    walks = WalkEngine(graph, Node2VecParams(**n2v_one), device="cuda").run(seed=0, timer=timer)
    same["functional_walks"] = frame_w["walk"].tolist() == [r[r >= 0].tolist() for r in walks]
    t3 = time.perf_counter()
    Word2VecTorch(Word2VecParams(**W2V_MAIN, max_iter=2), device="cuda").fit(
        walks, n_vertices=graph.n_vertices, timer=timer)

    dg = graph.to_device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    start = dg.indptr[:-1].contiguous()
    degree = (dg.indptr[1:] - dg.indptr[:-1]).contiguous()
    r1 = torch.rand(start.shape, generator=gen, device="cuda")
    r2 = torch.rand(start.shape, generator=gen, device="cuda")
    step = ops.alias_draw(start, degree, r1, r2, dg.alias, dg.prob, dg.indices).cpu().numpy()
    launches = _launches()
    nbrs = [step[v] in graph.indices[graph.indptr[v]:graph.indptr[v + 1]]
            for v in range(0, graph.n_vertices, 97)]
    shutil.rmtree(out_dir, ignore_errors=True)
    out = {"phase": "surface", "bit_equal": same, "vectors_text_rel_err": vec_err,
           "save_load_model_s": t1 - t0, "save_load_vectors_s": t2 - t1,
           "functional_walk_s": t3 - t2, "timer_summary": timer.summary(),
           "alias_draw_walkers": int(step.size), "launches": launches}
    emit(out)
    require(all(same.values()), f"surface: not equal {same}")
    require(vec_err <= 1e-5, f"save_vectors/load_vectors relative error {vec_err}")
    require({k: len(v) for k, v in timer.times.items()} == {"walk_chunk": 1, "sgns_epoch": 2},
            f"timer recorded {timer.summary()}")
    require(launches["alias_draw"] == 1, f"surface launched alias_draw {launches['alias_draw']} times")
    require(all(nbrs), "surface: an alias_draw draw is not a neighbour")
    return out


def main_path_shared_lists(src, dst, max_iter: int):
    """``Node2Vec(..., shared_lists=True)`` on the heavy-tail RMAT through
    ``run_pipeline()`` with no argument, streamed as main_path_streaming (40
    chunks, max_iter cut to 1): K5 in its mixed shared-list mode 40 times to
    count and 40 to train, K6 streaming 40, K2-K4 40 x 16; the engine's
    walk-checkpoint token ends in "+sl"."""
    n2v = Node2Vec(n2v_params=N2V_MAIN, w2v_params={**W2V_MAIN, "max_iter": max_iter},
                   max_out_degree=10_000, random_seed=0, shared_lists=True, device="cuda")
    _fresh_run()
    t0 = time.perf_counter()
    graph = n2v.preprocess_input_graph((src, dst), indexed=True, directed=False)
    t1 = time.perf_counter()
    engine = n2v._walk_engine()  # packs the tables and lists, and uploads them
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    walk_events = []
    run_chunk = engine._run_chunk

    def timed_chunk(*args, **kwargs):  # device time of every regenerated chunk
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_chunk(*args, **kwargs)
        end.record()
        walk_events.append((start, end))
        return out

    engine._run_chunk = timed_chunk
    model = n2v.run_pipeline()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del engine._run_chunk
    names, vectors = n2v.embedding(as_frame=False)
    t4 = time.perf_counter()
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    attempts = engine.attempt_count
    fallbacks = engine.fallback_count

    n_chunks, chunk, source = engine.chunk_source(seed=0)
    p = model.params
    batch = _effective_batch(p.batch_walks, chunk, target_updates=max(512 // n_chunks, 1))
    n_batches = chunk // batch
    walk_s = sum(a.elapsed_time(b) for a, b in walk_events) / 1e3
    chunk0 = source(0)
    steps = sum(int((source(i)[:, 1:] >= 0).sum()) for i in range(1, n_chunks)) + int(
        (chunk0[:, 1:] >= 0).sum())
    bg = engine.bgraph
    out = {
        "phase": "main_path_shared_lists", "cuts": {"max_iter": f"10 -> {max_iter}"},
        "n_vertices": graph.n_vertices, "n_edges": graph.n_edges,
        "strategy_token": engine._strategy_token(), "sl_exhaustive": bg.sl_exhaustive,
        "sl_ovf_wfrac": bg.sl_ovf_wfrac, "slq_bytes": int(bg.slq.numel() * 4),
        "walker_chunk": chunk, "n_chunks": n_chunks, "batch_walks": batch,
        "n_batches_per_chunk": n_batches, "preprocess_s": t1 - t0, "tables_and_lists_s": t2 - t1,
        "pipeline_s": t3 - t2, "walk_regeneration_device_s": walk_s,
        "walk_regenerations": len(walk_events), "walk_steps_per_pass": steps,
        "walk_steps_per_s": steps * len(walk_events) / n_chunks / walk_s,
        "attempts_per_step": attempts / max(steps * len(walk_events) / n_chunks, 1),
        "fallback_count": fallbacks, "fit_s": t3 - t2 - walk_s, "embedding_s": t4 - t3,
        "epoch_losses": model.losses, "peak_device_memory_bytes": int(peak),
        "launches": launches, "n_vectors": len(names), "vector_dim": int(vectors.shape[1]),
    }
    emit(out)
    require(engine.strategy == "blocked", f"strategy {engine.strategy}")
    require(engine._strategy_token() == "blocked+sl", f"token {engine._strategy_token()}")
    require(n2v.walks is None, "run_pipeline() did not stream")
    require(n_chunks == 40 and n_batches == 16, f"{n_chunks} chunks of {n_batches} batches")
    require(vectors.shape == (graph.n_vertices, 128), f"vectors shape {vectors.shape}")
    require(bool(np.isfinite(vectors).all()), "non-finite embedding values")
    require(len(model.losses) == max_iter and all(np.isfinite(x) for x in model.losses),
            f"losses {model.losses}")
    n_walk = n_chunks * (1 + max_iter)
    require(launches["blocked_walk"] == n_walk == launches["blocked_walk_sl_mixed"],
            f"blocked_walk launched {launches['blocked_walk']} times, "
            f"{launches['blocked_walk_sl_mixed']} in the mixed shared-list mode")
    require(launches["vertex_counts"] == n_chunks,
            f"vertex_counts launched {launches['vertex_counts']} times")
    for k in ("sgns_grads", "adagrad_accumulate", "adagrad_apply"):
        require(launches[k] == n_chunks * n_batches * max_iter,
                f"{k} launched {launches[k]} times")
    require(launches["dense_walk"] == 0 and launches["sgns_grads_global"] == 0,
            f"a kernel or mode off this path ran: {launches}")
    check_steps(graph, chunk0.cpu().numpy())
    breakdown((("chunk walks (shared lists, mixed)",
                lambda: [source(i) for i in range(n_chunks)]),
               ("run_pipeline (streaming, shared lists)", lambda: Word2VecTorch(p, device="cuda")
                .fit_streaming(source, n_chunks, graph.n_vertices))))
    return out


def main_path_shared_lists_er(graph, max_iter: int) -> dict:
    """The exhaustive shared-list mode on the dense-engine ER graph, whose
    edges share far fewer than SL_K neighbours:
    ``WalkEngine(graph, params, strategy="blocked", shared_lists=True,
    device="cuda").run_device()`` (10 chunks of K5 in mode sl_exhaustive),
    then ``Word2VecTorch.fit`` for one epoch on the corpus (K6, K2-K4)."""
    params = Node2VecParams(**N2V_MAIN)
    w2v = Word2VecParams(**W2V_MAIN, max_iter=max_iter)
    _fresh_run()
    t0 = time.perf_counter()
    engine = WalkEngine(graph, params, strategy="blocked", shared_lists=True, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    walks = engine.run_device(seed=0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    model = Word2VecTorch(w2v, device="cuda").fit(walks, n_vertices=graph.n_vertices)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    n_walks, length = walks.shape
    chunk = engine._effective_chunk(n_walks)
    n_chunks = -(-n_walks // chunk)
    steps = int((walks[:, 1:] >= 0).sum())
    batch = _effective_batch(w2v.batch_walks, n_walks)
    n_batches = -(-n_walks // batch)
    bg = engine.bgraph
    out = {
        "phase": "main_path_shared_lists_er", "cuts": {"max_iter": f"10 -> {max_iter}"},
        "strategy_token": engine._strategy_token(), "sl_exhaustive": bg.sl_exhaustive,
        "n_vertices": graph.n_vertices, "n_edges": graph.n_edges, "P": bg.light_width,
        "C": bg.block_width, "slq_bytes": int(bg.slq.numel() * 4), "tables_and_lists_s": t1 - t0,
        "walks": [int(n_walks), int(length)], "walk_steps": steps, "walker_chunk": chunk,
        "n_chunks": n_chunks, "walk_s": t2 - t1, "walk_steps_per_s": steps / (t2 - t1),
        "attempts_per_step": engine.attempt_count / max(steps, 1), "fit_s": t3 - t2,
        "epoch_losses": model.losses, "peak_device_memory_bytes": int(peak),
        "launches": launches,
    }
    emit(out)
    require(engine._strategy_token() == "blocked+slx", f"token {engine._strategy_token()}")
    require(walks.shape == (10 * graph.n_vertices, 21), f"walk corpus shape {walks.shape}")
    walks_np = walks.cpu().numpy()
    require(bool((walks_np[:, 0] >= 0).all()), "a start vertex is missing")
    check_steps(graph, walks_np)
    require(launches["blocked_walk"] == n_chunks == launches["blocked_walk_sl_exhaustive"],
            f"blocked_walk launched {launches['blocked_walk']} times, "
            f"{launches['blocked_walk_sl_exhaustive']} in the exhaustive mode, {n_chunks} chunks")
    require(launches["dense_walk"] == 0 and launches["vertex_counts"] == 1,
            f"launches {launches}")
    for k in ("sgns_grads", *ADAGRAD):
        require(launches[k] == n_batches * max_iter, f"{k} launched {launches[k]} times")
    require(bool(np.isfinite(model.vectors).all()) and all(np.isfinite(model.losses)),
            "non-finite vectors or losses")
    breakdown((("run_device (blocked, exhaustive shared lists)",
                lambda: engine.run_device(seed=0)),))
    return out


def main_path_wide(graph) -> dict:
    """Training at the node2vec paper's walk_length 80 and window 10 at
    widths whose walks do not fit in shared memory: on the quality graph,
    SGNS (K2) and HS (K8) at dim 256 through fit, gated at the SGNS and HS
    limits (two trainings each: held-out and full graph), and CBOW-NS (K9)
    at dim 256 and CBOW-HS (K10) at dim 512 through fit for one epoch; on
    ``graph`` (the dense graph of 5.: few repeated rows in a batch), 8
    steps of ``sgns_train_step`` (K13) at B = 256, dim 256; losses and
    tables finite.  Every launch of the five stages in global memory."""
    dev = torch.device("cuda")
    _fresh_run()
    t0 = time.perf_counter()
    wide = dict(dim=WIDE["D"], walk_length=WIDE["L1"] - 1, window=WIDE["window"])
    gates = {"sgns": quality_gates(**wide), "hs": quality_gates(negative=0, **wide)}
    g, _ = synthetic_multilabel(2000, seed=0)
    walks = WalkEngine(g, Node2VecParams(num_walks=8, walk_length=80),
                       device="cuda").run_device(seed=0)
    w2v = dict(min_count=1, max_iter=1, window_size=WIDE["window"], sg=0)
    cbow_ns = Word2VecTorch(Word2VecParams(vector_size=WIDE["D"], **w2v),
                            device="cuda").fit(walks, n_vertices=g.n_vertices)
    cbow_hs = Word2VecTorch(Word2VecParams(vector_size=2 * WIDE["D"], negative=0, **w2v),
                            device="cuda").fit(walks, n_vertices=g.n_vertices)
    walks = WalkEngine(graph, Node2VecParams(num_walks=1, walk_length=80),
                       device="cuda").run_device(seed=0)
    vocab = build_vocab(walks, graph.n_vertices, min_count=1)
    tables = tuple(torch.from_numpy(a).to(dev) for a in (vocab.ns_alias, vocab.ns_prob,
                                                         vocab.mask))
    state = sg.init_embeddings(graph.n_vertices, WIDE["D"], seed=1, device="cuda")
    losses = []
    for b in range(8):
        draws = sg.draw_step(torch.Generator(device=dev).manual_seed(1000 + b), WIDE["B"],
                             WIDE["L1"], WIDE["window"], 64, True, dev)
        losses.append(sg.sgns_train_step(*state, walks[b * WIDE["B"]:(b + 1) * WIDE["B"]],
                                         *draws, 0.025, *tables, window=WIDE["window"],
                                         negatives=5))
    losses = torch.stack(losses).cpu()
    torch.cuda.synchronize()
    launches = _launches()
    out = {"phase": "main_path_wide", "shapes": {**WIDE, "K10 D": 2 * WIDE["D"]},
           "seconds": time.perf_counter() - t0,
           "gates": {k: {m: v[m] for m in ("holdout_link_auc", "label_cosine_gap")}
                     for k, v in gates.items()},
           "cbow_ns_losses": cbow_ns.losses, "cbow_hs_losses": cbow_hs.losses,
           "pair_step_losses": [float(x) for x in losses],
           "peak_device_memory_bytes": int(torch.cuda.max_memory_allocated()),
           "launches": launches}
    emit(out)
    for k in ("sgns_grads", "hs_grads", "cbow_grads", "cbow_hs_grads", "sgns_pair_grads"):
        require(launches[k] > 0 and launches[k + "_global"] == launches[k],
                f"main_path_wide: {k} launched {launches[k]} times, "
                f"{launches[k + '_global']} staged in global memory")
    require(all(np.isfinite(x) for x in cbow_ns.losses + cbow_hs.losses)
            and bool(torch.isfinite(losses).all())
            and all(bool(torch.isfinite(t).all()) for t in state)
            and bool(np.isfinite(cbow_ns.vectors).all() and np.isfinite(cbow_hs.vectors).all()),
            "main_path_wide: non-finite losses or tables")
    return out


# --------------------------------------------------------------------------- #
# the mesh: K16, K17 and K3's squares mode, main_path_mesh, mesh_ranks
# --------------------------------------------------------------------------- #


def _col_slices(state, dm: int):
    """The model coordinates' column slices [V, dm] of (emb_in, emb_out)."""
    dim = state[0].shape[1]
    return [(state[0][:, m * dm:(m + 1) * dm].contiguous(),
             state[1][:, m * dm:(m + 1) * dm].contiguous()) for m in range(dim // dm)]


def check_col_sgns(mesh, n_vertices: int, n_walks: int, length: int, dim: int, window: int,
                   record: bool, results: dict, case: str, batch=None) -> None:
    """K16 col_pair_logits, K17 col_pair_grads and K3's squares mode against
    their plain versions on one batch (``_batch_inputs``), at Dm = D (one
    model rank, the 1 x 1 mesh) and Dm = D / 2 (two model ranks, their
    all-reduce a sum taken here): logits, d_ci, d_co elementwise; d_no, the
    squares and the loss partials to rtol of their largest entry (fp32
    atomics); at Dm = D, K16 then K17 against K13 on the same lists; then
    ``sharded_sgns_step`` against ``sharded_sgns_step_plain`` on ``mesh``
    (1 x 1, NCCL).  Times and bounds at each Dm; the kernels line takes Dm
    = D, main_path_mesh's width."""
    before = _build.launches.copy()
    inp = _batch_inputs(n_vertices, n_walks, length, dim, window, 11, 0.1, batch)
    walks, mask, neg, b_sh = inp["walks"], inp["mask"], inp["neg"], inp["b_sh"]
    n_walks, length = walks.shape
    kw = dict(window=window, negatives=5)
    pc, px = sg.pair_lists_plain(walks, b_sh, mask, window)
    n = pc.shape[0]
    ok = pc >= 0
    n_valid, s = int(ok.sum()), int(neg.numel())
    n_pos = n_walks * length
    lane = torch.nonzero(ok).squeeze(1)
    live = int(torch.unique(lane // (2 * window * length) * length + lane % length).numel())
    u_c = int(torch.unique(pc[ok]).numel())
    u_out = int(torch.unique(torch.cat([px[ok], neg])).numel())
    for dm in (dim, dim // 2):
        slices = _col_slices(inp["state"], dm)
        lg_err, logits = 0.0, 0
        for e_in, e_out in slices:
            got = col.col_pair_logits(e_in, e_out, walks, pc, px, neg, window=window)
            want = col.col_pair_logits_plain(e_in, e_out, walks, pc, px, neg, window=window)
            lg_err = max(lg_err, _close(f"col_pair_logits[Dm={dm}]", got, want))
            logits = logits + want  # the model all-reduce
        e_in, e_out = slices[0]
        got = col.col_pair_grads(e_in, e_out, walks, pc, px, neg, logits, **kw)
        want = col.col_pair_grads_plain(e_in, e_out, walks, pc, px, neg, logits, **kw)
        gr_err = max(_close(f"col_pair_grads[Dm={dm}, d_ci]", got[0], want[0]),
                     _close(f"col_pair_grads[Dm={dm}, d_co]", got[1], want[1]),
                     _close_to_largest(f"col_pair_grads[Dm={dm}, d_no]", got[2], want[2]),
                     _close_to_largest(f"col_pair_grads[Dm={dm}, squares]", got[3], want[3]),
                     _close_to_largest(f"col_pair_grads[Dm={dm}, loss parts]", got[4], want[4]))
        sq = sum(col.col_pair_grads_plain(a, b, walks, pc, px, neg, logits, **kw)[3]
                 for a, b in slices)  # the model all-reduce of the squares
        sq_lists = (sq[:n], pc, sq[n:2 * n], px, sq[2 * n:], neg)
        acc_in, acc_out = inp["state"][2], inp["state"][3]
        k_acc = [acc_in.clone(), acc_out.clone()]
        p_acc = [acc_in.clone(), acc_out.clone()]
        sg.adagrad_accumulate_squares(*k_acc, *sq_lists, dim)
        sg.adagrad_accumulate_squares_plain(*p_acc, *sq_lists, dim)
        k3_err = max(_close(f"adagrad_accumulate_squares[Dm={dm}, acc_in]", k_acc[0], p_acc[0]),
                     _close(f"adagrad_accumulate_squares[Dm={dm}, acc_out]", k_acc[1], p_acc[1]))
        if dm == dim:  # one model rank: K16 then K17 is K13
            k13 = sg.sgns_pair_grads(e_in, e_out, walks, pc, px, neg, **kw)
            tot = got[4]
            loss = -(tot[0] + 5 / s * tot[1]) / torch.clamp(tot[2], min=1.0)
            k13_err = max(_close("K16+K17 vs K13[d_ci]", got[0], k13[0]),
                          _close("K16+K17 vs K13[d_co]", got[1], k13[1]),
                          _close_to_largest("K16+K17 vs K13[d_no]", got[2], k13[2]),
                          _close("K16+K17 vs K13[loss]", loss, k13[3]))
            emit({"phase": "check", "kernel": "col_pair_logits + col_pair_grads vs "
                  "sgns_pair_grads (n_model = 1)", "case": case, "max_abs_err": k13_err})
        lg_ms = time_ms(lambda: col.col_pair_logits(e_in, e_out, walks, pc, px, neg,
                                                    window=window))
        lg_plain = time_ms(lambda: col.col_pair_logits_plain(e_in, e_out, walks, pc, px, neg,
                                                             window=window), reps=3, warmup=1)
        gr_ms = time_ms(lambda: col.col_pair_grads(e_in, e_out, walks, pc, px, neg, logits,
                                                   **kw))
        gr_plain = time_ms(lambda: col.col_pair_grads_plain(e_in, e_out, walks, pc, px, neg,
                                                            logits, **kw), reps=3, warmup=1)
        k3_ms = time_ms(lambda: sg.adagrad_accumulate_squares(*k_acc, *sq_lists, dim))
        k3_plain = time_ms(lambda: sg.adagrad_accumulate_squares_plain(*p_acc, *sq_lists, dim),
                           reps=3)
        # library yardstick (never used by the port): index_add_ of the valid
        # lanes' squares over D
        rows_c, rows_out = pc[ok].long(), torch.cat([px[ok], neg]).long()
        sq_c = sq[:n][ok] / dim
        sq_x = torch.cat([sq[n:2 * n][ok], sq[2 * n:]]) / dim
        k3_lib = time_ms(lambda: (k_acc[0].index_add_(0, rows_c, sq_c),
                                  k_acc[1].index_add_(0, rows_out, sq_x)))
        # bounds, from this run's data: the walks and the lists read once,
        # the distinct rows of both tables at Dm columns, the outputs written
        # once (K16: P + B*L1*S logits; K17: the per-lane gradients, d_no,
        # the squares, the loss partials); flops per valid lane and per live
        # center
        rows_bytes = (n_pos + n) * 4 + (u_c + u_out) * dm * 4
        k16_bytes = rows_bytes + (n + n_pos * s) * 4
        k16_ops = 2 * dm * n_valid + 2 * dm * s * live
        k17_bytes = (rows_bytes + (n + n_pos * s) * 4 + 2 * n * dm * 4 + s * dm * 4
                     + (2 * n + s) * 4 + n_walks * 12)
        k17_ops = 4 * s * dm * live + 7 * dm * n_valid
        k3_bytes = (2 * n + s) * 8 + 8 * (u_c + u_out)
        rec = {"col_pair_logits": (lg_err, lg_ms, lg_plain, bound_ms(k16_bytes, k16_ops), None),
               "col_pair_grads": (gr_err, gr_ms, gr_plain, bound_ms(k17_bytes, k17_ops), None),
               "adagrad_accumulate_squares": (k3_err, k3_ms, k3_plain,
                                              bound_ms(k3_bytes, 2 * (2 * n_valid + s)),
                                              k3_lib)}
        _emit_rows(rec, record and dm == dim, results, before, case=case, B=n_walks, L1=length,
                   D=dim, Dm=dm, S=s, V=n_vertices, lanes=n, valid_lanes=n_valid)
    # the whole step on the 1 x 1 mesh, kernels against plain versions
    k_state = col.ShardedSGNSState(*(t.clone() for t in inp["state"]))
    p_state = col.ShardedSGNSState(*(t.clone() for t in inp["state"]))
    args = (walks, b_sh, *inp["r"], 0.05, *inp["noise"], mask)
    loss_k = col.sharded_sgns_step(mesh, k_state, *args, **kw)
    loss_p = col.sharded_sgns_step_plain(mesh, p_state, *args, **kw)
    err = _close_state("sharded_sgns_step 1x1", k_state, loss_k, p_state, loss_p)
    emit({"phase": "check", "kernel": "sharded_sgns_step (1 x 1, NCCL) vs plain", "case": case,
          "backend": mesh.backend, "max_abs_err": err})


@contextlib.contextmanager
def collective_timing(mesh):
    """While active, each collective of ``mesh`` synchronises the card
    before and after it; yields a one-entry list that sums their wall
    times."""
    total = [0.0]
    saved = {name: getattr(mesh, name) for name in ("all_reduce_sum", "all_gather",
                                                    "all_to_all")}

    def timed(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            total[0] += time.perf_counter() - ts
            return out
        return run

    for name, fn in saved.items():
        setattr(mesh, name, timed(fn))
    try:
        yield total
    finally:
        for name in saved:
            delattr(mesh, name)


def _timed_fit(model, into: list) -> None:
    """Wrap ``model.fit_sharded`` to record its synchronised wall time."""
    fit = model.fit_sharded

    def run(*args, **kwargs):
        ts = time.perf_counter()
        out = fit(*args, **kwargs)
        torch.cuda.synchronize()
        into.append(time.perf_counter() - ts)
        return out

    model.fit_sharded = run


def main_path_mesh(mesh, src, dst, main_line: dict, main_walks: np.ndarray, rmat_src, rmat_dst,
                   blocked_walks: torch.Tensor, max_iter: int) -> dict:
    """``Node2Vec(mesh=make_mesh(1, 1))`` over NCCL through
    ``run_pipeline()`` on the dense graph at main_path's parameters: the
    walks shard over the data axis (K1 through sharded_dense_walk_chunk,
    10 chunks) and ``fit_sharded`` trains the column layout (K13's pair
    lists, K16, K17, K3's squares mode and K4 512 times each, K2 never).
    Its walks equal main_path's; its rates stand beside main_path's.  Then
    the profiled fit (``breakdown``), whose trace gives the collectives'
    share of its wall time, and ``random_walk()`` on the RMAT at 1 x 1
    (K5 through sharded_blocked_walk_chunk) against main_path_blocked's
    walks."""
    n2v = Node2Vec(n2v_params=N2V_MAIN, w2v_params={**W2V_MAIN, "max_iter": max_iter},
                   random_seed=0, mesh=mesh, device="cuda")
    _fresh_run()
    mesh.collectives.clear()
    t0 = time.perf_counter()
    graph = n2v.preprocess_input_graph((src, dst), indexed=True, directed=False)
    t1 = time.perf_counter()
    engine = n2v._walk_engine()
    walk_s, fit_s = [], []
    run_device = engine.run_device

    def timed_walk(*args, **kwargs):
        ts = time.perf_counter()
        out = run_device(*args, **kwargs)
        torch.cuda.synchronize()
        walk_s.append(time.perf_counter() - ts)
        return out

    new_backend = n2v._new_backend

    def timed_backend(*args, **kwargs):
        backend = new_backend(*args, **kwargs)
        _timed_fit(backend.model, fit_s)
        return backend

    engine.run_device = timed_walk
    n2v._new_backend = timed_backend
    model = n2v.run_pipeline()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del engine.run_device, n2v._new_backend, model.fit_sharded
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    collectives = {f"{op}:{axis}": k for (op, axis), k in mesh.collectives.items()}
    names, vectors = n2v.embedding(as_frame=False)

    walks = n2v.walks
    n_walks, length = walks.shape
    steps = int((walks[:, 1:] >= 0).sum())
    p = model.params
    batch = _effective_batch(p.batch_walks, n_walks)
    n_batches = -(-n_walks // batch)
    pairs = sg.pairs_per_batch(batch, length - 1, p.window_size) * n_batches * max_iter
    n_chunks = engine.chunk_source(seed=0)[0]
    # the profiled fit, whose trace gives the collectives' share of it
    prof = breakdown((("fit_sharded (1 x 1)",
                       lambda: model.fit_sharded(walks, mesh, n_vertices=graph.n_vertices)),))[0]
    out = {
        "phase": "main_path_mesh", "mesh": mesh.shape, "backend": mesh.backend,
        "table_sharding": n2v.table_sharding, "max_iter_cut_to": max_iter,
        "n_vertices": graph.n_vertices, "walks": [int(n_walks), int(length)],
        "walk_steps": steps, "walk_chunks": n_chunks, "batch_walks": batch,
        "n_batches": n_batches, "preprocess_s": t1 - t0, "walk_s": walk_s[0],
        "fit_s": fit_s[0], "pipeline_s": t2 - t1,
        "walk_steps_per_s": steps / walk_s[0],
        "sgns_pair_updates_per_s": pairs / fit_s[0],
        "main_path_walk_steps_per_s": main_line["walk_steps_per_s"],
        "main_path_sgns_pair_updates_per_s": main_line["sgns_pair_updates_per_s"],
        "collectives": collectives, "profiled_fit_s": prof["wall_ms"] / 1e3,
        **{k: prof[k] for k in ("collective_host_share", "collective_device_share")},
        "epoch_losses": model.losses, "peak_device_memory_bytes": int(peak),
        "launches": launches, "n_vectors": len(names), "vector_dim": int(vectors.shape[1]),
    }
    emit(out)
    require(np.array_equal(walks, main_walks), "the 1 x 1 mesh's walks differ from main_path's")
    require(vectors.shape == (graph.n_vertices, 128) and bool(np.isfinite(vectors).all()),
            "main_path_mesh: bad vectors")
    require(all(np.isfinite(x) for x in model.losses), "main_path_mesh: non-finite loss")
    require(launches["dense_walk"] == launches["dense_walk_sharded"] == n_chunks,
            f"main_path_mesh: dense walks {launches}")
    for k in ("pair_lists", "col_pair_logits", "col_pair_grads", "adagrad_accumulate_squares",
              "adagrad_apply"):
        require(launches[k] == n_batches * max_iter, f"main_path_mesh launched {k} {launches[k]}")
    for k in ("sgns_grads", "sgns_pair_grads", "adagrad_accumulate"):
        require(launches[k] == 0, f"main_path_mesh launched {k} {launches[k]} times")

    _fresh_run()
    rmat = Node2Vec(n2v_params=N2V_MAIN, w2v_params=W2V_MAIN, max_out_degree=10_000,
                    random_seed=0, mesh=mesh, device="cuda")
    rmat.preprocess_input_graph((rmat_src, rmat_dst), indexed=True, directed=False)
    ts = time.perf_counter()
    rmat_walks = rmat.random_walk()
    walk_s = time.perf_counter() - ts
    r_launches = _launches()
    equal = bool(np.array_equal(rmat_walks, blocked_walks.cpu().numpy()))
    emit({"phase": "main_path_mesh", "graph": "RMAT scale 19", "entry": "random_walk()",
          "strategy": rmat._walk_engine().strategy, "walks": list(rmat_walks.shape),
          "walk_s": walk_s, "bit_equal_to_main_path_blocked": equal,
          "launches": {k: r_launches[k] for k in ("blocked_walk", "blocked_walk_sharded")}})
    require(equal, "the 1 x 1 mesh's RMAT walks differ from main_path_blocked's")
    require(r_launches["blocked_walk"] == r_launches["blocked_walk_sharded"] > 0,
            f"the RMAT walks on the mesh: {r_launches}")
    return out


# the SGNS and HS limits (PERF.md section 2); the JAX row trainers clear them by the
# margins of the single-device SGNS and HS gates (experiments/port_gate_reference.py)
MESH_GATE = dict(auc_min=0.60, gap_min=0.05)


def _recv_rows(table: torch.Tensor, plan) -> torch.Tensor:
    """The [N * cap, D] rows that ``plan``'s owners send back when every
    owner holds the whole ``table`` (one card standing for N ranks): row
    (j, c) is table[send_ids[j, c]], zeros where -1."""
    return rs.route_gather_plain(table, plan.send_ids, 1)


def _plans_equal(name: str, got, want) -> None:
    for field in rs.RoutePlan._fields:
        require(torch.equal(getattr(got, field), getattr(want, field)),
                f"{name}: {field} differs from the plain version")


def check_route(tree, head_offsets, walks_np: np.ndarray, n_vertices: int, record: bool,
                results: dict, case: str, dim: int = 128, window: int = 5,
                n_neg: int = 64) -> None:
    """K18 route_plan, K19's gather and pack, and K2's and K8's routed modes
    against their plain versions on one batch ``walks_np`` (the row main
    path's: 2,570 walks of the dense graph's first chunk, shuffled), its
    vocabulary, draws and random tables.  K18 at N = 1, 2, 4, 8 (planning
    is local, so one card checks every N) and at a capacity that drops, on
    SGNS's output requests (the positions, -1 read as 0, and the S shared
    negatives): every field bit-equal.  K19's gather bit-equal (copies);
    its pack, K2's and K8's routed modes at the tolerances of check_sgns and
    check_hs (sums over many rows to rtol of their largest entry).  At N =
    1 the routed modes against K2 and K8 direct on the same draws, and K2's
    routed mode at N = 2 (rank 0's view, the owners' rows taken from the
    whole table) with a capacity that drops rows and negatives.  Times and
    bounds at N = 1, the main path's geometry."""
    before = _build.launches.copy()
    dev = torch.device("cuda")
    rng = np.random.default_rng(31)
    walks = torch.from_numpy(np.ascontiguousarray(walks_np)).to(dev)
    n_walks, length = walks.shape
    flat = walks.reshape(-1)
    rows = torch.where(flat >= 0, flat, 0)
    n = rows.shape[0]
    vocab = build_vocab(walks, n_vertices, min_count=1)
    noise = [torch.from_numpy(a).to(dev) for a in (vocab.ns_alias, vocab.ns_prob)]
    mask = torch.from_numpy(vocab.mask).to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    b_sh, r1, r2 = sg.draw_step(gen, n_walks, length, window, n_neg, True, dev)
    neg = sg.negative_ids(r1, r2, *noise)
    ids_out = torch.cat([rows, neg])
    r = ids_out.shape[0]

    def table(n_rows):
        return torch.from_numpy(rng.normal(0, 0.1, (n_rows, dim)).astype(np.float32)).to(dev)

    emb_in, emb_out, theta = table(n_vertices), table(n_vertices), table(tree.n_inner)

    # K18 at every N, and a capacity that drops
    dropping = r // 64
    for n_dev, cap in [(k, rs.row_cap(r, k)) for k in (1, 2, 4, 8)] + [(8, dropping)]:
        got = rs.plan_routes(ids_out, n_dev, cap)
        _plans_equal(f"route_plan[N={n_dev}, cap={cap}]", got,
                     rs.plan_routes_plain(ids_out, n_dev, cap))
        emit({"phase": "check", "kernel": "route_plan", "case": case, "N": n_dev, "cap": cap,
              "R": r, "n_uniq": int(got.n_uniq), "n_dropped": int(got.n_dropped),
              "bit_equal": True})
        if cap == dropping:
            require(int(got.n_dropped) > 0, "the dropping capacity dropped nothing")
    cap = rs.row_cap(r, 1)
    plan_in, plan_out = rs.plan_routes(rows, 1, cap), rs.plan_routes(ids_out, 1, cap)
    k18_ms = time_ms(lambda: rs.plan_routes(ids_out, 1, cap))
    k18_plain = time_ms(lambda: rs.plan_routes_plain(ids_out, 1, cap), reps=3, warmup=1)
    u_out = int(plan_out.n_uniq)
    k18_bytes = r * 4 + r * (6 * 4 + 2) + cap * 4 + 8

    # K19's gather: at N = 1 the all_to_all is the identity, recv_ids = send_ids
    x_in = rs.route_gather(emb_in, plan_in.send_ids, 1)
    x_out = rs.route_gather(emb_out, plan_out.send_ids, 1)
    for name, got, tab, plan in (("x_in", x_in, emb_in, plan_in), ("x_out", x_out, emb_out,
                                                                     plan_out)):
        require(torch.equal(got, rs.route_gather_plain(tab, plan.send_ids, 1)),
                f"route_gather[{name}] differs from the plain version")
    gather_ms = time_ms(lambda: rs.route_gather(emb_out, plan_out.send_ids, 1))
    gather_plain = time_ms(lambda: rs.route_gather_plain(emb_out, plan_out.send_ids, 1))
    gather_bytes = cap * 4 + u_out * dim * 4 + cap * dim * 4

    # K2's routed mode: the plain version, K2 direct, and N = 2 with drops
    kw = dict(window=window, negatives=5)
    args = (x_in, plan_in.slot, x_out, plan_out.slot[:n], plan_out.slot[n:], walks, mask, b_sh)
    got = rs.sgns_grads_routed(*args, **kw)
    want = rs.sgns_grads_routed_plain(*args, **kw)
    errs = [_close("sgns_grads_routed[g_in]", got[0], want[0]),
            _close("sgns_grads_routed[g_out]", got[1], want[1]),
            _close_to_largest("sgns_grads_routed[d_no]", got[2], want[2]),
            _close_to_largest("sgns_grads_routed[parts]", got[3], want[3])]
    direct = sg.sgns_grads(emb_in, emb_out, walks, mask, b_sh, neg, **kw)
    loss = -(got[3][0] + 5 / n_neg * got[3][1]) / torch.clamp(got[3][2], min=1.0)
    direct_err = max(_close("sgns_grads_routed vs sgns_grads[g_in]", got[0], direct[0]),
                     _close("sgns_grads_routed vs sgns_grads[g_out]", got[1], direct[1]),
                     _close_to_largest("sgns_grads_routed vs sgns_grads[d_no]", got[2], direct[2]),
                     _close("sgns_grads_routed vs sgns_grads[loss]", loss, direct[3]))
    require(float(got[3][2]) == float(direct[4]), "routed and direct pair counts differ")
    small = r // 8
    p_in2, p_out2 = rs.plan_routes(rows, 2, small), rs.plan_routes(ids_out, 2, small)
    args2 = (_recv_rows(emb_in, p_in2), p_in2.slot, _recv_rows(emb_out, p_out2),
             p_out2.slot[:n], p_out2.slot[n:], walks, mask, b_sh)
    got2 = rs.sgns_grads_routed(*args2, **kw)
    want2 = rs.sgns_grads_routed_plain(*args2, **kw)
    errs += [_close("sgns_grads_routed[N=2, drops, g_in]", got2[0], want2[0]),
             _close("sgns_grads_routed[N=2, drops, g_out]", got2[1], want2[1]),
             _close_to_largest("sgns_grads_routed[N=2, drops, d_no]", got2[2], want2[2]),
             _close_to_largest("sgns_grads_routed[N=2, drops, parts]", got2[3], want2[3])]
    neg_dropped = bool((p_out2.slot[n:] < 0).any())
    emit({"phase": "check", "kernel": "sgns_grads_routed", "case": case + ", N = 2 (rank 0)",
          "cap": small, "dropped": int(p_in2.n_dropped) + int(p_out2.n_dropped),
          "negatives_dropped": neg_dropped, "max_abs_err": max(errs[4:])})
    emit({"phase": "check", "kernel": "sgns_grads_routed vs sgns_grads (N = 1)", "case": case,
          "max_abs_err": direct_err})
    k2r_ms = time_ms(lambda: rs.sgns_grads_routed(*args, **kw))
    k2r_plain = time_ms(lambda: rs.sgns_grads_routed_plain(*args, **kw), reps=3, warmup=1)
    k2_ms = time_ms(lambda: sg.sgns_grads(emb_in, emb_out, walks, mask, b_sh, neg, **kw))
    emit({"phase": "check", "kernel": "sgns_grads (direct mode, beside its routed mode)",
          "case": case, "B": n_walks, "ms": k2_ms, "routed_ms": k2r_ms})
    grads_bytes = (2 * n + n_neg) * dim * 4
    k2r_bytes = 2 * n * dim * 4 + n_neg * dim * 4 + (4 * n + n_neg) * 4 + grads_bytes
    k2r_ops = 6 * n * dim * (n_neg + 2 * window)

    # K19's pack of the routed gradients, against its plain version
    g_in, g_out, d_no = got[:3]
    send_out = rs.route_pack(plan_out, 1, cap, g_out, flat, d_no, None)
    pack_err = max(
        _close_to_largest("route_pack[out]", send_out,
                          rs.route_pack_plain(plan_out, 1, cap, g_out, flat, d_no, None)),
        _close_to_largest("route_pack[in]", rs.route_pack(plan_in, 1, cap, g_in, flat),
                          rs.route_pack_plain(plan_in, 1, cap, g_in, flat)))
    pack_ms = time_ms(lambda: rs.route_pack(plan_out, 1, cap, g_out, flat, d_no, None))
    pack_plain = time_ms(lambda: rs.route_pack_plain(plan_out, 1, cap, g_out, flat, d_no, None))
    live = torch.cat([(flat >= 0).float(), torch.ones(n_neg, device=dev)])
    g_all = torch.cat([g_out, d_no])
    rows_plus = torch.cat([g_all, (g_all * g_all).mean(-1, keepdim=True)], dim=1) * live[:, None]
    slots = plan_out.slot.long()
    keep = slots >= 0
    lib_send = torch.zeros_like(send_out)
    pack_lib = time_ms(lambda: lib_send.index_add_(0, slots[keep], rows_plus[keep]))
    n_live = int(live.sum())
    pack_bytes = n_live * dim * 4 + r * 12 + u_out * 9 + cap * (dim + 1) * 4

    # K8's routed mode at N = 1: the plain version and K8 direct
    tables = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (tree.points, tree.codes, tree.lengths)]
    cl = tree.points.shape[1]
    n_head, k_rows = hs.head_split(head_offsets, cl)
    clt = cl - n_head
    cap_in, cap_th = rh.hs_caps(n_walks, length, cl, head_offsets, 1)
    p_hin = rs.plan_routes(rows, 1, cap_in)
    p_th = rs.plan_routes(tables[0][rows.long()][:, n_head:].reshape(-1).contiguous(), 1, cap_th)
    hargs = (rs.route_gather(emb_in, p_hin.send_ids, 1), p_hin.slot,
             rs.route_gather(theta, p_th.send_ids, 1), p_th.slot, theta[:k_rows].contiguous(),
             walks, mask, b_sh, *tables)
    hkw = dict(window=window, head_offsets=head_offsets)
    got = rh.hs_grads_routed(*hargs, **hkw)
    want = rh.hs_grads_routed_plain(*hargs, **hkw)
    require(torch.equal(got[2], want[2]), "hs_grads_routed: tail rows differ")
    herrs = [_close("hs_grads_routed[g_in]", got[0], want[0]),
             _close("hs_grads_routed[g_tail]", got[1], want[1]),
             _close_to_largest("hs_grads_routed[d_head]", got[3], want[3]),
             _close_to_largest("hs_grads_routed[parts]", got[4], want[4])]
    direct = hs.hs_grads(emb_in, theta, walks, mask, b_sh, *tables, **hkw)
    require(torch.equal(got[2], direct[2]), "hs_grads_routed vs hs_grads: tail rows differ")
    hloss = -got[4][0] / torch.clamp(got[4][1], min=1.0)
    hdirect_err = max(_close("hs_grads_routed vs hs_grads[g_in]", got[0], direct[0]),
                      _close("hs_grads_routed vs hs_grads[g_tail]", got[1], direct[1]),
                      _close_to_largest("hs_grads_routed vs hs_grads[d_head]", got[3],
                                        direct[3]),
                      _close("hs_grads_routed vs hs_grads[loss]", hloss, direct[4]))
    emit({"phase": "check", "kernel": "hs_grads_routed vs hs_grads (N = 1)", "case": case,
          "head_levels": n_head, "head_rows": k_rows, "max_abs_err": hdirect_err})
    k8r_ms = time_ms(lambda: rh.hs_grads_routed(*hargs, **hkw))
    k8r_plain = time_ms(lambda: rh.hs_grads_routed_plain(*hargs, **hkw), reps=2, warmup=1)
    k8_ms = time_ms(lambda: hs.hs_grads(emb_in, theta, walks, mask, b_sh, *tables, **hkw))
    emit({"phase": "check", "kernel": "hs_grads (direct mode, beside its routed mode)",
          "case": case, "B": n_walks, "ms": k8_ms, "routed_ms": k8r_ms})
    _, entries = _hs_live_entries(walks, mask, b_sh, tables[2], window)
    live_tail = int((got[2] >= 0).sum())
    k8r_bytes = (n * 8 + n * (1 + clt) * 4 + int(p_hin.n_uniq) * (dim * 4 + cl * 5 + 5)
                 + int(p_th.n_uniq) * dim * 4 + 2 * k_rows * dim * 4 + n * dim * 4
                 + live_tail * (dim * 4 + 4))
    rec = {"route_plan": (0.0, k18_ms, k18_plain, bound_ms(k18_bytes, 0), None),
           "route_gather": (0.0, gather_ms, gather_plain, bound_ms(gather_bytes, 0), None),
           "route_pack": (pack_err, pack_ms, pack_plain,
                          bound_ms(pack_bytes, 3 * dim * n_live), pack_lib),
           "sgns_grads_routed": (max(errs), k2r_ms, k2r_plain, bound_ms(k2r_bytes, k2r_ops),
                                 None),
           "hs_grads_routed": (max(herrs), k8r_ms, k8r_plain,
                               bound_ms(k8r_bytes, 6 * dim * entries), None)}
    _emit_rows(rec, record, results, before, case=case, B=n_walks, L1=length, D=dim, S=n_neg,
               V=n_vertices, R=r, n_uniq=u_out, cap=cap, R_th=int(p_th.uniq.numel()),
               cap_th=cap_th)


def main_path_mesh_row(mesh, src, dst, max_iter: int, hs_objective: bool, beside: dict) -> dict:
    """``Node2Vec(mesh=make_mesh(1, 1), table_sharding="row")`` over NCCL
    through ``run_pipeline()`` on the dense graph at main_path's parameters:
    10 walker chunks, so it streams into ``fit_streaming_sharded`` (K1
    through sharded_dense_walk_chunk for counting and training, K6's
    streaming form), every step routed at N = 1: K18 and K19's two launches
    twice (two plans), K2's routed mode (K8's with ``hs_objective``:
    negative=0, its head of 9 levels all-gathered), K3's squares mode and
    K4 once (and K3 once for HS's head rows); K2 and K8 direct never.  No
    row dropped.  Its rates stand beside ``beside``'s (main_path_streaming
    and main_path_hs); then the profiled fit (``breakdown``), whose trace
    gives the collectives' share of its wall time."""
    phase = "main_path_mesh_row" + ("_hs" if hs_objective else "")
    w2v = {**W2V_MAIN, "max_iter": max_iter, **({"negative": 0} if hs_objective else {})}
    n2v = Node2Vec(n2v_params=N2V_MAIN, w2v_params=w2v, random_seed=0, mesh=mesh,
                   table_sharding="row", device="cuda")
    _fresh_run()
    mesh.collectives.clear()
    t0 = time.perf_counter()
    graph = n2v.preprocess_input_graph((src, dst), indexed=True, directed=False)
    t1 = time.perf_counter()
    engine = n2v._walk_engine()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    walk_events = []
    run_chunk = engine._run_chunk

    def timed_chunk(*args, **kwargs):  # device time of every regenerated chunk
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_chunk(*args, **kwargs)
        end.record()
        walk_events.append((start, end))
        return out

    engine._run_chunk = timed_chunk
    model = n2v.run_pipeline()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del engine._run_chunk
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    collectives = {f"{op}:{'x'.join(axis) if isinstance(axis, tuple) else axis}": k
                   for (op, axis), k in mesh.collectives.items()}
    names, vectors = n2v.embedding(as_frame=False)

    n_chunks, chunk, source = engine.chunk_source(seed=0)
    p = model.params
    batch = _effective_batch(p.batch_walks, chunk, floor=1, target_updates=max(512 // n_chunks, 1))
    n_batches = chunk // batch
    steps = n_batches * n_chunks * max_iter
    walk_s = sum(a.elapsed_time(b) for a, b in walk_events) / 1e3
    pipeline_s = t3 - t2
    pairs = sg.pairs_per_batch(batch, N2V_MAIN["walk_length"], p.window_size) * steps
    # the profiled fit, whose trace gives the collectives' share of it
    label = "HS" if hs_objective else "SGNS"
    prof = breakdown(((f"fit_streaming_sharded ({label}, row, 1 x 1)",
                       lambda: Word2VecTorch(p, device="cuda").fit_streaming_sharded(
                           source, n_chunks, mesh, graph.n_vertices)),))[0]
    key = "hs_pair_updates_per_fit_s" if hs_objective else "sgns_pair_updates_per_fit_s"
    out = {
        "phase": phase, "mesh": mesh.shape, "backend": mesh.backend,
        "table_sharding": "row", "cuts": {"max_iter": f"10 -> {max_iter}"},
        "objective": "hierarchical softmax (negative=0)" if hs_objective else "SGNS",
        **({"tree": _tree_line(model)} if model.tree is not None else {}),
        "n_vertices": graph.n_vertices, "walker_chunk": chunk, "n_chunks": n_chunks,
        "batch_walks": batch, "n_batches_per_chunk": n_batches, "preprocess_s": t1 - t0,
        "pipeline_s": pipeline_s, "walk_regeneration_device_s": walk_s,
        "fit_s": pipeline_s - walk_s, key: pairs / (pipeline_s - walk_s),
        "beside": beside, "dropped_rows": model.dropped_rows,
        "collectives": collectives, "profiled_fit_s": prof["wall_ms"] / 1e3,
        **{k: prof[k] for k in ("collective_host_share", "collective_device_share")},
        "epoch_losses": model.losses, "peak_device_memory_bytes": int(peak),
        "launches": launches, "n_vectors": len(names), "vector_dim": int(vectors.shape[1]),
    }
    emit(out)
    n_out = model.tree.n_inner if model.tree is not None else graph.n_vertices
    require(n2v.walks is None, "run_pipeline() did not stream")
    require(n_chunks == 10 and n_batches == 51, f"{n_chunks} chunks of {n_batches} batches")
    require(model.dropped_rows == 0, f"{phase} dropped {model.dropped_rows} rows")
    require(vectors.shape == (graph.n_vertices, 128) and bool(np.isfinite(vectors).all()),
            f"{phase}: bad vectors")
    require(model.emb_out.shape == (n_out, 128) and bool(np.isfinite(model.emb_out).all()),
            f"{phase}: bad output table")
    require(len(model.losses) == max_iter and all(np.isfinite(x) for x in model.losses),
            f"losses {model.losses}")
    require(launches["dense_walk"] == launches["dense_walk_sharded"] == n_chunks * (1 + max_iter),
            f"{phase}: dense walks {launches}")
    grads = "hs_grads_routed" if hs_objective else "sgns_grads_routed"
    want = {"route_plan": 2 * steps, "route_gather": 2 * steps, "route_pack": 2 * steps,
            grads: steps, "adagrad_accumulate_squares": steps, "adagrad_apply": steps,
            "adagrad_accumulate": steps if hs_objective else 0, "vertex_counts": n_chunks}
    for k, v in want.items():
        require(launches[k] == v, f"{phase} launched {k} {launches[k]} times, not {v}")
    for k in ("sgns_grads", "hs_grads", "sgns_grads_routed" if hs_objective else "hs_grads_routed",
              "pair_lists", "col_pair_logits", "col_pair_grads"):
        require(launches[k] == 0, f"{phase} launched {k} {launches[k]} times")
    return out


def _row_rank_checks(mesh, n_v: int, quick: bool) -> dict:
    """The row layout on a rank of the 2 x 1 gloo mesh: one routed SGNS step
    and one HS step at the main path's batch (2,560 walks split over the
    ranks) against the same steps through the plain versions, one SGNS step
    whose capacity drops rows (the dropped counts equal), the routed step's
    wall and collective time, and (not with ``quick``) the quality gates
    through ``Node2Vec(mesh=, table_sharding="row").run_pipeline()``."""
    out = {}
    dim, n_walks, length, window = 128, 2560, 21, 5
    rng = np.random.default_rng(6)
    full = [torch.from_numpy(rng.normal(0, 0.1, (n_v, dim)).astype(np.float32)).cuda()
            for _ in range(2)]
    accs = [torch.from_numpy(rng.random(n_v).astype(np.float32)).cuda() for _ in range(2)]
    walks = torch.from_numpy(_pair_walks(n_v, n_walks, length, 8)).cuda()
    vocab = build_vocab(walks, n_v, min_count=1)
    noise = [torch.from_numpy(a).cuda() for a in (vocab.ns_alias, vocab.ns_prob, vocab.mask)]
    b_local = n_walks // mesh.n_devices
    local = walks[mesh.rank * b_local:(mesh.rank + 1) * b_local].contiguous()
    gen = torch.Generator(device="cuda").manual_seed(2000 + mesh.rank)  # the rank's draws
    draws = sg.draw_step(gen, b_local, length, window, 64, True, "cuda")
    kw = dict(window=window, negatives=5)

    def state():
        return rs.RowShardedState(*(rs.shard_rows(mesh, t.clone()) for t in (*full, *accs)),
                                  n_v)

    errs = {}
    for name, cap in (("normal", rs.row_cap(b_local * length + 64, 2)), ("overflow", 1024)):
        k_state, p_state = state(), state()
        loss_k, drop_k = rs.row_sgns_step(mesh, k_state, local, *draws, 0.05, *noise, cap=cap,
                                          **kw)
        loss_p, drop_p = rs.row_sgns_step_plain(mesh, p_state, local, *draws, 0.05, *noise,
                                                cap=cap, **kw)
        require(float(drop_k) == float(drop_p), f"row step {name}: dropped {drop_k} vs {drop_p}")
        require((float(drop_k) > 0) == (name == "overflow"), f"row step {name}: dropped {drop_k}")
        errs[name] = max(_close(f"row step {name}[{k}]", a, b) for k, a, b in zip(
            ("emb_in", "emb_out", "acc_in", "acc_out", "loss"), (*k_state[:4], loss_k),
            (*p_state[:4], loss_p)))
        out[f"sgns_step_{name}"] = {"cap": cap, "dropped": float(drop_k),
                                    "vs_plain_max_abs_err": errs[name]}
    # the routed step's wall time and its collectives' (each synchronised)
    k_state = state()
    rs.row_sgns_step(mesh, k_state, local, *draws, 0.05, *noise,
                     cap=rs.row_cap(b_local * length + 64, 2), **kw)
    torch.cuda.synchronize()
    with collective_timing(mesh) as coll_s:
        ts = time.perf_counter()
        rs.row_sgns_step(mesh, k_state, local, *draws, 0.05, *noise,
                         cap=rs.row_cap(b_local * length + 64, 2), **kw)
        torch.cuda.synchronize()
        out["row_step_s"], out["row_step_collective_s"] = time.perf_counter() - ts, coll_s[0]
    # one HS step, the head all-gathered over the two ranks
    counts = np.bincount(walks[walks >= 0].cpu().numpy(), minlength=n_v)
    tree = hs.cap_code_length(hs.build_huffman(counts), counts)
    head = hs.head_level_offsets(tree, table_rows=-(-tree.n_inner // 2))
    tabs = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in (tree.points, tree.codes, tree.lengths)]
    theta = torch.from_numpy(rng.normal(0, 0.1, (tree.n_inner, dim)).astype(np.float32)).cuda()
    acc_th = torch.from_numpy(rng.random(tree.n_inner).astype(np.float32)).cuda()
    caps = rh.hs_caps(b_local, length, tree.points.shape[1], head, 2)
    states = [rh.RowHSState(*(rs.shard_rows(mesh, t.clone()) for t in (full[0], theta, accs[0],
                                                                        acc_th)),
                            n_v, tree.n_inner) for _ in range(2)]
    hkw = dict(cap_in=caps[0], cap_th=caps[1], window=window, head_offsets=head)
    loss_k, drop_k = rh.row_hs_step(mesh, states[0], local, draws[0], 0.05, *tabs, noise[2], **hkw)
    loss_p, drop_p = rh.row_hs_step_plain(mesh, states[1], local, draws[0], 0.05, *tabs, noise[2],
                                          **hkw)
    require(float(drop_k) == float(drop_p) == 0, f"row HS step dropped {drop_k} / {drop_p}")
    out["hs_step"] = {"head_levels": len(head) - 1, "vs_plain_max_abs_err": max(
        _close("row HS step[emb_in]", states[0].emb_in, states[1].emb_in),
        _close_to_largest("row HS step[theta]", states[0].theta, states[1].theta),
        _close("row HS step[acc_in]", states[0].acc_in, states[1].acc_in),
        _close_to_largest("row HS step[acc_theta]", states[0].acc_theta, states[1].acc_theta),
        _close("row HS step[loss]", loss_k, loss_p))}
    del full, accs, states
    if not quick:
        gq, labels = synthetic_multilabel(2000, seed=0)
        for objective in ("sgns", "hs"):
            n2v = Node2VecParams(num_walks=8, walk_length=40, walker_chunk=2048)
            w2v = Word2VecParams(min_count=1, max_iter=5, vector_size=128,
                                 negative=0 if objective == "hs" else 5)
            ts = time.perf_counter()
            auc = holdout_link_prediction(gq, n2v_params=n2v, w2v_params=w2v, seed=0,
                                          device="cuda", trainer="run_pipeline", mesh=mesh,
                                          table_sharding="row")["holdout_link_auc"]
            emb, _ = train_embeddings(gq, n2v, w2v, seed=0, device="cuda",
                                      trainer="run_pipeline", mesh=mesh, table_sharding="row")
            gap = label_cosine_gap(emb, labels, n_pairs=200_000, seed=0)
            out["quality_row_" + objective] = {
                "trainer": "Node2Vec(mesh=, table_sharding='row').run_pipeline() -> "
                           "fit_streaming_sharded", "holdout_link_auc": auc,
                "label_cosine_gap": gap, **MESH_GATE, "quality_s": time.perf_counter() - ts}
            require(auc >= MESH_GATE["auc_min"], f"row {objective}: AUC {auc}")
            require(gap >= MESH_GATE["gap_min"], f"row {objective}: gap {gap}")
    return out



def _mesh_rank(quick: bool) -> list:
    """One rank of ``mesh_ranks``: at meshes 2 x 1 and 1 x 2 over gloo on a
    card the two ranks share, the sharded walks (dense and CSR on the dense
    graph, blocked on an RMAT) against the single-device engine, one column
    step against ``sharded_sgns_step_plain``, the dense delta all-reduce
    timed, and (not with ``quick``) the quality gate through
    ``Node2Vec(mesh=).run_pipeline()``; at 2 x 1 the row layout's checks
    (``_row_rank_checks``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n_v = 4096 if quick else 131072
    g = build_graph(smoke_edges(n_v, 16 * n_v), directed=False)
    g_rmat = rmat_graph(12 if quick else 14)[2]
    lines = []
    for shape in ((2, 1), (1, 2)):
        mesh = make_mesh(*shape, device="cuda")
        line = {"phase": "mesh_ranks", "mesh": mesh.shape, "rank": mesh.rank,
                "coords": mesh.coords, "backend": mesh.backend,
                "cuda_collectives": ("copied through host memory (gloo)" if mesh.host_staged
                                     else "on the device")}
        _build.reset_launches()
        for name, graph, strategy in (("dense ER", g, "dense"), ("RMAT", g_rmat, "blocked"),
                                      ("dense ER", g, "csr")):
            params = Node2VecParams(**N2V_MAIN)
            sharded = WalkEngine(graph, params, strategy=strategy, mesh=mesh, device="cuda")
            one = WalkEngine(graph, params, strategy=strategy, device="cuda")
            equal = bool(torch.equal(sharded.run_device(seed=0), one.run_device(seed=0)))
            require(equal, f"{strategy} walks at {shape} differ from the single-device engine's")
            line[f"{strategy}_walks_bit_equal ({name})"] = equal
            if strategy == "blocked":
                require((sharded.fallback_count, sharded.attempt_count)
                        == (one.fallback_count, one.attempt_count), "blocked counts differ")
        line["walk_launches"] = {k: int(_build.launches[k]) for k in (
            "dense_walk_sharded", "blocked_walk_sharded", "csr_walk_sharded")}
        # one column step at the main path's batch, B = 2,560 split over data
        dim, n_walks, length = 128, 2560, 21
        rng = np.random.default_rng(5)
        full = [torch.from_numpy(rng.normal(0, 0.1, (n_v, dim)).astype(np.float32)).cuda()
                for _ in range(2)]
        accs = [torch.from_numpy(rng.random(n_v).astype(np.float32)).cuda() for _ in range(2)]
        walks = torch.from_numpy(_pair_walks(n_v, n_walks, length, 7)).cuda()
        vocab = build_vocab(walks, n_v, min_count=1)
        noise = [torch.from_numpy(a).cuda() for a in (vocab.ns_alias, vocab.ns_prob, vocab.mask)]
        d = mesh.coords["data"]
        b_local = n_walks // shape[0]
        local = walks[d * b_local:(d + 1) * b_local].contiguous()
        gen = torch.Generator(device="cuda").manual_seed(1000 + d)  # the data coordinate's
        draws = sg.draw_step(gen, b_local, length, 5, 64, True, "cuda")
        states = [col.ShardedSGNSState(*(col.shard_columns(mesh, t.clone()) for t in full),
                                       *(a.clone() for a in accs)) for _ in range(3)]
        kw = dict(window=5, negatives=5)
        # a first step on a spare state warms the groups and the allocator
        col.sharded_sgns_step(mesh, states[2], local, *draws, 0.05, *noise, **kw)
        torch.cuda.synchronize()
        with collective_timing(mesh) as coll_s:
            ts = time.perf_counter()
            loss_k = col.sharded_sgns_step(mesh, states[0], local, *draws, 0.05, *noise, **kw)
            torch.cuda.synchronize()
            line["step_s"], line["step_collective_s"] = time.perf_counter() - ts, coll_s[0]
        loss_p = col.sharded_sgns_step_plain(mesh, states[1], local, *draws, 0.05, *noise, **kw)
        line["step_vs_plain_max_abs_err"] = _close_state(f"column step {shape}", states[0],
                                                         loss_k, states[1], loss_p)
        if shape[0] > 1:  # the step's dense [2, V, Dm] delta all-reduce over the data axis
            delta = torch.zeros((2, n_v, dim // shape[1]), device="cuda")
            mesh.all_reduce_sum(delta, "data")
            torch.cuda.synchronize()
            ts = time.perf_counter()
            for _ in range(3):
                mesh.all_reduce_sum(delta, "data")
            torch.cuda.synchronize()
            line["dense_delta_all_reduce_ms"] = (time.perf_counter() - ts) / 3 * 1e3
            line["dense_delta_bytes"] = delta.numel() * 4
            del delta
        del full, accs, states
        if not quick:
            gq, labels = synthetic_multilabel(2000, seed=0)
            n2v = Node2VecParams(num_walks=8, walk_length=40, walker_chunk=2048)
            w2v = Word2VecParams(min_count=1, max_iter=5, vector_size=128)
            ts = time.perf_counter()
            auc = holdout_link_prediction(gq, n2v_params=n2v, w2v_params=w2v, seed=0,
                                          device="cuda", trainer="run_pipeline",
                                          mesh=mesh)["holdout_link_auc"]
            emb, _ = train_embeddings(gq, n2v, w2v, seed=0, device="cuda",
                                      trainer="run_pipeline", mesh=mesh)
            gap = label_cosine_gap(emb, labels, n_pairs=200_000, seed=0)
            line.update({"quality": "synthetic_multilabel(2000, seed=0)",
                         "trainer": "Node2Vec(mesh=).run_pipeline() -> fit_sharded (column)",
                         "holdout_link_auc": auc, "label_cosine_gap": gap, **MESH_GATE,
                         "quality_s": time.perf_counter() - ts})
            require(auc >= MESH_GATE["auc_min"], f"mesh {shape}: AUC {auc}")
            require(gap >= MESH_GATE["gap_min"], f"mesh {shape}: gap {gap}")
        if shape == (2, 1):  # the row layout over the flattened 2 x 1 mesh
            line["row"] = _row_rank_checks(mesh, n_v, quick)
        lines.append(line)
    return lines


def mesh_ranks(quick: bool = False) -> None:
    """Two ranks sharing the card over gloo (``parallel.launch.spawn``; NCCL
    refuses two ranks on one GPU), each running ``_mesh_rank``; any rank's
    failure fails the phase."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks allocate on the same card
    t0 = time.perf_counter()
    ranks = launch.spawn(_mesh_rank, 2, "gloo", "cuda", quick, timeout=900)
    for lines in ranks:
        for line in lines:
            emit({**line, "spawn_s": time.perf_counter() - t0})


def profile_sums(prof) -> dict:
    """Sums by name over a finished ``torch.profiler`` run, read from its raw
    events, which ``key_averages()`` would turn into event objects for tens
    of seconds on a fit of ~10^5 ops: "device" ms of kernels and copies,
    "ranges" ms of the GPU-side ranges of annotations (``nccl:all_to_all``:
    they overlap the work they span, which key_averages() counts twice),
    "host" self ms (an event's span less its direct children's on its
    thread, nested as torch nests them) and "host_total" ms."""
    from torch.autograd.profiler_util import _filter_name

    sums = {"device": {}, "ranges": {}, "host": {}, "host_total": {}}
    threads = {}

    def add(kind, name, ns):
        sums[kind][name] = sums[kind].get(name, 0.0) + ns / 1e6

    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if _filter_name(name) or getattr(ev, "is_hidden_event", lambda: False)():
            continue
        if ev.device_type() != torch.autograd.DeviceType.CPU:
            annotation = (name.startswith("nccl:") or getattr(ev, "activity_type", str)()
                          == "gpu_user_annotation")
            add("ranges" if annotation else "device", name, ev.duration_ns())
        elif not ev.is_async() and ev.start_thread_id() == ev.end_thread_id():
            add("host_total", name, ev.duration_ns())
            threads.setdefault(ev.start_thread_id(), []).append(
                (ev.start_ns(), -ev.end_ns(), name))
    for events in threads.values():
        events.sort()  # by start, the longer (enclosing) event first
        stack = []  # the open events, nested: [end, name, self ns]
        for start, neg_end, name in events:
            end = -neg_end
            while stack and (start >= stack[-1][0] or end > stack[-1][0]):
                add("host", *stack.pop()[1:])
            if stack:
                stack[-1][2] -= end - start
            stack.append([end, name, end - start])
        for entry in stack:
            add("host", *entry[1:])
    return sums


def breakdown(stages) -> list:
    """Device time by kernel and the idle share of each (name, fn) stage,
    from torch.profiler over a second run of it (launch counts of the main
    path were read before).  Where the stage calls collectives, the line
    adds their host time (the ``c10d::`` calls, children included) and
    their device time (NCCL's GPU-side ranges), each with its share of the
    wall time.  Returns the lines."""
    from torch.profiler import ProfilerActivity, profile

    lines = []
    for stage, fn in stages:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        sums = profile_sums(prof)
        device, host = sums["device"], sums["host"]
        busy = sum(device.values())
        top = {k[:80]: v for k, v in sorted(device.items(), key=lambda kv: -kv[1])[:8]}
        line = {"phase": "breakdown", "stage": stage, "wall_ms": wall_ms,
                "device_busy_ms": busy if busy > 0 else None,
                "idle_share": 1 - busy / wall_ms if busy > 0 else None,
                "top_device_ms": top,
                "top_host_self_ms": {k[:80]: v for k, v in sorted(
                    host.items(), key=lambda kv: -kv[1])[:6] if v > 0}}
        coll_host = sum(v for k, v in sums["host_total"].items() if k.startswith("c10d::"))
        coll_device = sum(v for k, v in sums["ranges"].items() if k.startswith("nccl:"))
        if coll_host or coll_device:
            line.update({"collective_host_ms": coll_host, "collective_device_ms": coll_device,
                         "collective_host_share": coll_host / wall_ms,
                         "collective_device_share": coll_device / wall_ms})
        emit(line)
        lines.append(line)
    return lines


def quality_gates(blocked_widths=None, trainer: str = "fit", walker_chunk=None,
                  sample: float = 0.0, negative: int = 5, sg_arch: int = 1,
                  auc_min: float = 0.60, gap_min: float = 0.05, sgd: bool = False,
                  dim: int = 128, walk_length: int = 40, window: int = 5,
                  shared_lists: bool = False, pq=(1.0, 1.0)) -> dict:
    """The gates on synthetic_multilabel(2000, seed=0), trained through
    ``trainer`` (see datasets._train); ``negative=0`` trains hierarchical
    softmax, ``sg_arch=0`` CBOW, ``sgd`` SGNS with optimizer="sgd" at
    step_size 0.025; ``shared_lists`` walks the blocked tables with the
    shared-list sampler at ``pq`` = (p, q)."""
    g, labels = synthetic_multilabel(2000, seed=0)
    n2v = Node2VecParams(num_walks=8, walk_length=walk_length, return_param=pq[0],
                         inout_param=pq[1],
                         **({"walker_chunk": walker_chunk} if walker_chunk else {}))
    w2v = Word2VecParams(min_count=1, max_iter=5, vector_size=dim, window_size=window,
                         sample=sample, negative=negative, sg=sg_arch,
                         **({"optimizer": "sgd", "step_size": 0.025} if sgd else {}))
    t0 = time.perf_counter()
    auc = holdout_link_prediction(g, n2v_params=n2v, w2v_params=w2v, seed=0, device="cuda",
                                  blocked_widths=blocked_widths, trainer=trainer,
                                  shared_lists=shared_lists)["holdout_link_auc"]
    emb, strategy = train_embeddings(g, n2v, w2v, seed=0, device="cuda",
                                     blocked_widths=blocked_widths, trainer=trainer,
                                     shared_lists=shared_lists)
    gap = label_cosine_gap(emb, labels, n_pairs=200_000, seed=0)
    deg = np.diff(g.indptr)
    out = {"phase": "quality", "graph": "synthetic_multilabel(2000, seed=0)",
           "trainer": trainer,
           "objective": (("cbow_hs" if negative == 0 else "cbow_ns") if sg_arch == 0
                         else ("hs" if negative == 0 else "sgns_sgd" if sgd else "sgns")),
           "walker_chunk": n2v.walker_chunk, "sample": sample, "dim": dim,
           "walk_length": walk_length, "window": window, "p": pq[0], "q": pq[1],
           "shared_lists": shared_lists,
           "walk_strategy": strategy, "blocked_widths": blocked_widths,
           "heavy_vertex_share": (float((deg > blocked_widths[0]).mean())
                                  if blocked_widths else None),
           "holdout_link_auc": auc, "auc_min": auc_min,
           "label_cosine_gap": gap, "gap_min": gap_min, "seconds": time.perf_counter() - t0}
    emit(out)
    require(auc >= auc_min, f"held-out link AUC {auc} < {auc_min}")
    require(gap >= gap_min, f"label cosine gap {gap} < {gap_min}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at small shapes, then stop")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch_name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "installed": {m: importlib.util.find_spec(m) is not None
                        for m in ("pandas", "sklearn", "scipy", "jax", "triton")}})

    t0 = time.perf_counter()
    _build.lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds,
          "ptxas": [ln.strip()[:160] for ln in _build.ptxas_report.splitlines()
                    if "registers" in ln or "spill" in ln or ln.startswith("==")
                    or "Compiling entry function" in ln]})

    results: dict = {}
    if args.quick:
        src, dst = smoke_edges(4096, 65536)
        g = build_graph((src, dst), directed=False)
        check_dense_walk(g, 4096, 20, results)
        check_sgns(4096, 64, 21, 128, 5, 64, True, results)
        check_sgns(512, 16, 41, 32, 5, 64, False, results)
        _, _, g_rmat = rmat_graph(12)
        check_blocked_walk(g_rmat, 4096, 20, results)
        check_blocked_walk_sl(g_rmat, "RMAT scale 12", 4096, 20, results)
        check_blocked_walk_sl(g, "dense ER, 4,096 vertices", 4096, 20, results)
        engine = WalkEngine(g_rmat, Node2VecParams(num_walks=2, walker_chunk=2048), device="cuda")
        walks = engine.run_device()
        check_vertex_counts(walks, g_rmat.n_vertices, results)
        check_streaming_counts(engine, g_rmat.n_vertices, results)
        counts = np.bincount(walks[walks >= 0].cpu().numpy(), minlength=g_rmat.n_vertices)
        check_subsample(walks.cpu().numpy(), build_vocab_from_counts(counts), 4096, results)
        tree, tree_counts = hs_tree(g)
        head = hs.head_level_offsets(tree, table_rows=tree.n_inner)
        check_hs(tree, tree_counts, 64, 21, 128, 5, head, True, True, results)
        edge_cases_hs(tree, tree_counts)
        check_cbow(tree, tree_counts, 64, 21, 128, 5, True, True, True, results)
        check_cbow(tree, tree_counts, 64, 21, 128, 5, False, False, False, results,
                   case="cbow_mean=False")
        edge_cases_cbow(tree, tree_counts)
        walks_q = WalkEngine(g, Node2VecParams(**N2V_MAIN), device="cuda").run_device()
        check_preagg(g.n_vertices, walks_q.cpu().numpy()[:64], 128, 5, True, results, "quick")
        edge_cases_preagg()
        check_csr_walk(g, "dense ER, 4,096 vertices", 4096, 20, False, results)
        check_csr_walk(g_rmat, "RMAT scale 12", 4096, 20, True, results)
        edge_cases_csr()
        check_pairs(4096, 64, 21, 128, 5, True, results, "quick")
        check_pairs(4096, 64, 21, 128, 5, False, results, "quick, no shrink", shrink=False)
        check_pairs(512, 16, 41, 32, 5, False, results, "quick, D = 32, L1 = 41")
        check_fused(4096, 64, 21, 128, 5, True, results, "quick")
        check_fused(512, 16, 41, 32, 5, False, results, "quick, D = 32, L1 = 41")
        check_alias_draw(g, True, results, "quick, dense ER 4,096 vertices")
        mesh = make_mesh(1, 1, device="cuda")  # a world of one, over NCCL
        check_col_sgns(mesh, 4096, 64, 21, 128, 5, True, results, "quick")
        check_col_sgns(mesh, 512, 16, 41, 32, 5, False, results, "quick, D = 32, L1 = 41")
        check_route(tree, head, walks_q.cpu().numpy()[:64], g.n_vertices, True, results, "quick")
        mesh_ranks(quick=True)
        edge_cases()
        edge_cases_blocked()
        edge_cases_sl()
        check_wide(g, tree, tree_counts, results)
        small_reference()
        torch.distributed.destroy_process_group()
        emit({"phase": "quick", "ok": True})
        return 0

    src, dst = smoke_edges(131072, 2_097_152)
    g = build_graph((src, dst), directed=False)
    check_dense_walk(g, 131072, 20, results)
    main_batch = _effective_batch(8192, 10 * g.n_vertices)
    check_sgns(131072, main_batch, 21, 128, 5, 64, True, results)
    if main_batch != 8192:
        check_sgns(131072, 8192, 21, 128, 5, 64, False, results)
    tree, tree_counts = hs_tree(g)
    head = hs.head_level_offsets(tree, table_rows=tree.n_inner)
    hs_batch = _effective_batch(8192, 131072, target_updates=51)  # main_path_hs's chunks
    # K8 is timed on the walks main_path_hs trains: its first chunk, shuffled
    chunk0 = WalkEngine(g, Node2VecParams(**N2V_MAIN), device="cuda").chunk_source(seed=0)[2](0)
    hs_walks = chunk0.cpu().numpy()[np.random.default_rng(0).permutation(len(chunk0))]
    del chunk0
    check_hs(tree, tree_counts, hs_batch, 21, 128, 5, head, True, True, results, walks=hs_walks)
    check_hs(tree, tree_counts, 8192, 21, 128, 5, head, True, False, results, case="B=8192",
             walks=hs_walks)
    edge_cases_hs(tree, tree_counts)
    # K9 and K10 on the same walks (main_path_cbow trains at main_path_hs's batch)
    check_cbow(tree, tree_counts, hs_batch, 21, 128, 5, True, True, True, results, walks=hs_walks)
    check_cbow(tree, tree_counts, hs_batch, 21, 128, 5, False, False, False, results,
               case="cbow_mean=False", walks=hs_walks)
    check_cbow(tree, tree_counts, 8192, 21, 128, 5, True, True, False, results, case="B=8192",
               walks=hs_walks)
    edge_cases_cbow(tree, tree_counts)
    # K11 on main_path_sgd's batches: the same walks (it trains at main_path_hs's batch)
    check_preagg(131072, hs_walks[:hs_batch], 128, 5, True, results, "main_path_sgd batch")
    check_preagg(131072, hs_walks[:8192], 128, 5, False, results, "B=8192")
    edge_cases_preagg()
    # K13 and K3/K4 over its pair lists, K2 at row stride D + 1 and K14, timed
    # on the walks main_path_pairs and main_path_fused train (their epoch's
    # first batch), then on random walks with dead tails and
    # out-of-vocabulary rows; K2-K4 at dim 64 (the TPU's packed width)
    ep = _pair_epoch(g)
    first = (ep["corpus"][:ep["batch"]].contiguous(), ep["tables"][2])
    del ep
    check_pairs(131072, main_batch, 21, 128, 5, True, results, "main_path_pairs batch 0",
                batch=first)
    check_pairs(131072, main_batch, 21, 128, 5, False, results, "random walks, dead tails")
    check_pairs(131072, main_batch, 21, 128, 5, False, results, "no shrink", shrink=False)
    check_pairs(4096, 64, 21, 128, 5, False, results, "V = 4,096, 40% out of vocabulary",
                oov=0.4)
    check_fused(131072, main_batch, 21, 128, 5, True, results, "main_path_fused batch 0",
                batch=first)
    mesh = make_mesh(1, 1, device="cuda")  # a world of one, over NCCL
    check_col_sgns(mesh, 131072, main_batch, 21, 128, 5, True, results,
                   "main_path_pairs batch 0", batch=first)
    check_col_sgns(mesh, 131072, main_batch, 21, 128, 5, False, results,
                   "random walks, dead tails")
    # K18, K19 and the routed modes on main_path_mesh_row's batch (2,570 walks
    # of the first chunk, shuffled), the HS ones on the dense graph's tree
    check_route(tree, head, hs_walks[:hs_batch], 131072, True, results,
                "main_path_mesh_row batch")
    check_fused(131072, main_batch, 21, 128, 5, False, results, "random walks, dead tails")
    del first
    check_sgns(131072, main_batch, 21, 64, 5, 64, False, results)
    check_alias_draw(g, True, results, "dense ER, a walker at every vertex")
    rmat_src, rmat_dst, g_rmat = rmat_graph(19)
    check_blocked_walk(g_rmat, 131072, 20, results)
    check_blocked_walk_sl(g_rmat, "RMAT scale 19", 131072, 20, results)
    check_blocked_walk_sl(g, "dense ER", 131072, 20, results)
    check_wide(g, tree, tree_counts, results)
    check_csr_walk(g, "dense ER", 131072, 20, False, results)
    check_csr_walk(g_rmat, "RMAT scale 19", 131072, 20, True, results)
    edge_cases_csr()
    edge_cases()
    edge_cases_blocked()
    edge_cases_sl()
    small_reference()
    paths = {}
    paths["main_path"], n2v = main_path(src, dst, max_iter=1)
    main_walks = n2v.walks
    paths["surface"] = surface(n2v, g, src, dst)
    del n2v
    paths["main_path_blocked"], walks_dev, n_v = main_path_blocked(rmat_src, rmat_dst, max_iter=1)
    check_vertex_counts(walks_dev, n_v, results)
    paths["main_path_mesh"] = main_path_mesh(mesh, src, dst, paths["main_path"], main_walks,
                                             rmat_src, rmat_dst, walks_dev, max_iter=1)
    del walks_dev, main_walks
    mesh_ranks()
    paths["main_path_streaming"], engine, n_v = main_path_streaming(rmat_src, rmat_dst, max_iter=1)
    check_streaming_counts(engine, n_v, results)
    del engine
    paths["main_path_shared_lists"] = main_path_shared_lists(rmat_src, rmat_dst, max_iter=1)
    paths["main_path_shared_lists_er"] = main_path_shared_lists_er(g, max_iter=1)
    paths["main_path_host"], walks, vocab, slab = main_path_host(src, dst, max_iter=1)
    check_subsample(walks, vocab, slab, results)
    del walks
    paths["main_path_hs"] = main_path_streamed(src, dst, 1, "main_path_hs", {"negative": 0},
                                               "hs_grads")
    paths["main_path_mesh_row"] = main_path_mesh_row(
        mesh, src, dst, 1, False, beside={
            "main_path_sgns_pair_updates_per_s": paths["main_path"]["sgns_pair_updates_per_s"],
            "main_path_streaming_sgns_pair_updates_per_s":
                paths["main_path_streaming"]["sgns_pair_updates_per_s"]})
    paths["main_path_mesh_row_hs"] = main_path_mesh_row(
        mesh, src, dst, 1, True, beside={"main_path_hs_pair_updates_per_fit_s":
                                         paths["main_path_hs"]["hs_pair_updates_per_fit_s"]})
    paths["main_path_cbow"] = main_path_streamed(src, dst, 1, "main_path_cbow", {"sg": 0},
                                                 "cbow_grads")
    paths["main_path_cbow_hs"] = main_path_host(src, dst, 1, "main_path_cbow_hs",
                                                {"sg": 0, "negative": 0}, "cbow_hs_grads")[0]
    paths["main_path_sgd"] = main_path_streamed(src, dst, 1, "main_path_sgd",
                                                {"optimizer": "sgd", "step_size": 0.025},
                                                "sgns_grads", SGD)
    paths["main_path_csr"] = main_path_csr(g_rmat, max_iter=1)
    del g_rmat
    paths["main_path_pairs"], ep = main_path_pairs(g)
    paths["main_path_fused"] = main_path_fused(ep, results)
    del ep
    quality_gates()
    quality_gates(blocked_widths=(8, 64))
    quality_gates(trainer="run_pipeline", walker_chunk=2048)
    quality_gates(trainer="host_corpus", sample=1e-3)
    quality_gates(negative=0)
    quality_gates(trainer="run_pipeline", walker_chunk=2048, negative=0)
    quality_gates(trainer="host_corpus", sample=1e-3, negative=0)
    # CBOW's own limits: two thirds of the JAX value's margin over a broken
    # trainer (AUC 0.5, gap 0), PERF.md section 2
    quality_gates(sg_arch=0, auc_min=0.57, gap_min=0.045)
    quality_gates(trainer="run_pipeline", walker_chunk=2048, negative=0, sg_arch=0,
                  auc_min=0.55, gap_min=0.033)
    # SGNS-SGD's own limits, by the same rule (PERF.md section 2)
    quality_gates(sgd=True, auc_min=0.58, gap_min=0.145)
    quality_gates(trainer="run_pipeline", walker_chunk=2048, sgd=True, auc_min=0.575,
                  gap_min=0.135)
    # the shared-list sampler on blocked tables at P = 8, C = 64, at q = 2
    # (the sampler is off at q == 1), held to the blocked SGNS limits
    quality_gates(blocked_widths=(8, 64), shared_lists=True, pq=(1.0, 2.0))
    paths["main_path_wide"] = main_path_wide(g)

    kernels = []
    for name, counter, path in ROWS:
        src_file, replaces = SOURCES[name]
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src_file,
                        "replaces": replaces, "launches": paths[path]["launches"][counter],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        **{k: r[k] for k in ("staging", "mode") if k in r}})
    emit({"kernels": kernels})
    torch.distributed.destroy_process_group()  # the 1 x 1 mesh's world of one
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
