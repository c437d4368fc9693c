"""Checkpoint/resume for walks and training (a copy of
``node2vec_tpu/utils/checkpoint.py``).

The file names, npz keys, ``TRAIN_STATE_VERSION`` and fingerprint strings
are the JAX package's, so a walk chunk, a train state or a stream state
written by one package loads in the other:

* **walk chunks**: each completed walker chunk is persisted; a restarted
  run skips chunks already on disk;
* **train state**: embedding tables + Adagrad accumulators + epoch counter,
  saved every K epochs; ``fit`` and ``fit_host`` resume from the latest;
* **stream state**: a chunk-boundary snapshot of ``fit_streaming`` (cursor,
  tables, accumulators, losses, pass-1 counts).

Everything here is numpy: tables are copied to the host before saving.
Train and stream states are written uncompressed (``np.savez``), where the
JAX package compresses them: float tables barely compress, and zlib took
20 s a snapshot of two [524178, 128] tables on the host of an H100 server
(``chip_smoke.py``'s resume drill; 0.7 s uncompressed).  ``np.load`` reads either, so the files
stay interchangeable.  Walk chunks (small ints, -1 padding) stay
compressed.
"""

from __future__ import annotations

import hashlib
import logging
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def graph_digest(indices: np.ndarray, weights: np.ndarray) -> str:
    """Cheap content digest of a CSR edge set: exact E + weight sum +
    strided samples of indices/weights (O(1k) work at any graph size)."""
    h = hashlib.sha256()
    stride = max(len(indices) // 512, 1)
    h.update(
        f"E={len(indices)}|wsum={float(np.sum(weights, dtype=np.float64))}|".encode()
    )
    h.update(np.ascontiguousarray(indices[::stride]).tobytes())
    h.update(np.ascontiguousarray(weights[::stride]).tobytes())
    return h.hexdigest()[:16]


def walk_fingerprint(
    params,
    seed: int,
    starts: np.ndarray,
    n_vertices: int,
    graph_token: str = "",
    strategy: str = "",
) -> str:
    """Hash of everything that determines walk content, so a checkpoint dir
    reused with a different configuration is detected instead of serving
    stale walks.  ``graph_token`` (from graph_digest) folds in the edge
    content and ``strategy`` the engine choice."""
    h = hashlib.sha256()
    h.update(repr(params).encode())
    h.update(
        f"|seed={seed}|V={n_vertices}|g={graph_token}|strategy={strategy}|".encode()
    )
    h.update(np.ascontiguousarray(starts, dtype=np.int32).tobytes())
    return h.hexdigest()[:32]


def _fingerprint_path(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, "walks_fingerprint.txt")


def save_walk_chunk(
    checkpoint_dir: str,
    chunk_idx: int,
    paths: np.ndarray,
    fingerprint: Optional[str] = None,
) -> str:
    os.makedirs(checkpoint_dir, exist_ok=True)
    if fingerprint is not None and not os.path.exists(_fingerprint_path(checkpoint_dir)):
        with open(_fingerprint_path(checkpoint_dir), "w") as f:
            f.write(fingerprint)
    path = os.path.join(checkpoint_dir, f"walks_chunk_{chunk_idx:06d}.npz")
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, paths=paths)
    os.replace(tmp, path)
    return path


def load_walk_chunks(
    checkpoint_dir: Optional[str], fingerprint: Optional[str] = None
) -> Dict[int, np.ndarray]:
    """All persisted walk chunks as {chunk_idx: paths}.

    If ``fingerprint`` is given and the directory's stored fingerprint does
    not match, the stale chunk files are removed: they can never be valid
    again, and a crashed rerun must not mix old and new chunks.
    """
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return {}
    if fingerprint is not None:
        fp_path = _fingerprint_path(checkpoint_dir)
        stored = open(fp_path).read().strip() if os.path.exists(fp_path) else None
        if stored != fingerprint:
            stale = [
                fn
                for fn in os.listdir(checkpoint_dir)
                if re.fullmatch(r"walks_chunk_(\d+)\.npz", fn)
            ]
            if stored is None and not stale:
                return {}  # fresh dir: nothing to discard, nothing to warn
            logger.warning(
                "walk checkpoint dir %s was written by a different "
                "configuration (fingerprint %s != %s); discarding %d stale "
                "chunk(s)", checkpoint_dir, stored, fingerprint, len(stale),
            )
            for fn in stale:
                os.remove(os.path.join(checkpoint_dir, fn))
            if stored is not None:
                os.remove(fp_path)
            return {}
    out = {}
    for fn in os.listdir(checkpoint_dir):
        m = re.fullmatch(r"walks_chunk_(\d+)\.npz", fn)
        if m:
            out[int(m.group(1))] = np.load(os.path.join(checkpoint_dir, fn))["paths"]
    return out


# Bump when the meaning of a saved table changes (the JAX package's v2:
# Huffman inner nodes renumbered breadth-first).
TRAIN_STATE_VERSION = 2


def save_train_state(
    checkpoint_dir: str,
    epoch: int,
    emb_in: np.ndarray,
    emb_out: np.ndarray,
    acc_in: np.ndarray,
    acc_out: np.ndarray,
) -> str:
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, "train_state.npz")
    tmp = path + ".tmp.npz"
    np.savez(
        tmp,
        version=np.int64(TRAIN_STATE_VERSION),
        epoch=np.int64(epoch),
        emb_in=emb_in,
        emb_out=emb_out,
        acc_in=acc_in,
        acc_out=acc_out,
    )
    os.replace(tmp, path)
    return path


def load_train_state(
    checkpoint_dir: Optional[str],
) -> Optional[Tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    if not checkpoint_dir:
        return None
    path = os.path.join(checkpoint_dir, "train_state.npz")
    if not os.path.exists(path):
        return None
    z = np.load(path)
    stored = int(z["version"]) if "version" in z else 1
    if stored != TRAIN_STATE_VERSION:
        logger.warning(
            "train-state checkpoint %s has format version %d (current %d); "
            "ignoring it and training from scratch", path, stored,
            TRAIN_STATE_VERSION,
        )
        return None
    return (
        int(z["epoch"]),
        z["emb_in"],
        z["emb_out"],
        z["acc_in"],
        z["acc_out"],
    )


def stream_fingerprint(
    params, n_chunks: int, n_vertices: int, token: str = ""
) -> str:
    """Hash of everything that determines the streaming training trajectory:
    the params, the chunk geometry (chunk orders, LR schedule and per-chunk
    shuffles are keyed on chunk indices) and ``token``, the walk source's
    identity (graph digest + walk params + walk seed)."""
    h = hashlib.sha256()
    h.update(repr(params).encode())
    h.update(f"|chunks={n_chunks}|V={n_vertices}|src={token}|".encode())
    return h.hexdigest()[:32]


def save_stream_state(
    checkpoint_dir: str,
    fingerprint: str,
    epoch: int,
    chunk: int,
    emb_in: np.ndarray,
    emb_out: np.ndarray,
    acc_in: np.ndarray,
    acc_out: np.ndarray,
    epoch_losses: np.ndarray,
    cur_losses: np.ndarray,
    counts: np.ndarray,
    chunk_walks: int,
) -> str:
    """Chunk-boundary snapshot of a streaming training run: tables + Adagrad
    state + (epoch, next-chunk) cursor + loss bookkeeping + the pass-1
    vocabulary counts (so a resume skips the counting pass)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, "stream_state.npz")
    tmp = path + ".tmp.npz"
    np.savez(
        tmp,
        version=np.int64(TRAIN_STATE_VERSION),
        fingerprint=np.str_(fingerprint),
        epoch=np.int64(epoch),
        chunk=np.int64(chunk),
        emb_in=emb_in,
        emb_out=emb_out,
        acc_in=acc_in,
        acc_out=acc_out,
        epoch_losses=np.asarray(epoch_losses, np.float32),
        cur_losses=np.asarray(cur_losses, np.float32),
        counts=np.asarray(counts, np.int64),
        chunk_walks=np.int64(chunk_walks),
    )
    os.replace(tmp, path)
    return path


def load_stream_state(checkpoint_dir: Optional[str], fingerprint: str):
    """Newest streaming snapshot, or None.  A snapshot written under a
    different configuration or an older format version is ignored with a
    warning: resuming it would splice two different training runs."""
    if not checkpoint_dir:
        return None
    path = os.path.join(checkpoint_dir, "stream_state.npz")
    if not os.path.exists(path):
        return None
    z = np.load(path)
    stored_v = int(z["version"]) if "version" in z else 1
    if stored_v != TRAIN_STATE_VERSION:
        logger.warning(
            "streaming checkpoint %s has format version %d (current %d); "
            "ignoring it", path, stored_v, TRAIN_STATE_VERSION,
        )
        return None
    stored_fp = str(z["fingerprint"])
    if stored_fp != fingerprint:
        logger.warning(
            "streaming checkpoint %s was written by a different "
            "configuration (fingerprint %s != %s); ignoring it",
            path, stored_fp, fingerprint,
        )
        return None
    return (
        int(z["epoch"]),
        int(z["chunk"]),
        z["emb_in"],
        z["emb_out"],
        z["acc_in"],
        z["acc_out"],
        z["epoch_losses"],
        z["cur_losses"],
        z["counts"],
        int(z["chunk_walks"]),
    )
