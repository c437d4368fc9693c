"""ctypes bindings to the port's copy of the native C++ graph core.

``graph_core.cpp`` beside this file is compiled with g++ at first use into
``build/node2vec_torch/libgraphcore.so`` under the checkout root (or under
``$N2V_TORCH_BUILD_DIR``), never inside a package directory.  Every caller
falls back to a numpy implementation, with a warning, when the build fails
(no toolchain): the framework degrades gracefully, but the production host
path is native.  This is host code; no device work happens here.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "graph_core.cpp")

_lib: Optional[ctypes.CDLL] = None
_tried = False

_N_THREADS = min(16, os.cpu_count() or 1)


def build_dir() -> str:
    """Where the port's native and CUDA libraries are built."""
    env = os.environ.get("N2V_TORCH_BUILD_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(_HERE))
    return os.path.join(root, "build", "node2vec_torch")


def _lib_path() -> str:
    return os.path.join(build_dir(), "libgraphcore.so")


def _compile(lib_path: str) -> bool:
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    # build under a private name and rename: concurrent test workers may
    # race here, and a half-written .so must never be loaded
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-fPIC", "-shared", "-pthread",
        "-std=c++17", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
        return True
    except Exception as exc:  # noqa: BLE001 — any toolchain failure → numpy fallback
        logger.warning("native graph core build failed (%s); using numpy fallback", exc)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib_path = _lib_path()
    needs_build = not os.path.exists(lib_path) or (
        os.path.getmtime(_SRC) > os.path.getmtime(lib_path)
    )
    if needs_build and not _compile(lib_path):
        return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError as exc:
        logger.warning("failed to load %s: %s", lib_path, exc)
        return None

    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.n2v_build_csr.restype = ctypes.c_int
    lib.n2v_build_csr.argtypes = [
        ctypes.c_int64, i32p, i32p, f32p, ctypes.c_int32, i64p, i32p, f32p,
        ctypes.c_int32,
    ]
    lib.n2v_build_alias.restype = ctypes.c_int
    lib.n2v_build_alias.argtypes = [
        ctypes.c_int32, i64p, f32p, i32p, f32p, ctypes.c_int32,
    ]
    lib.n2v_index_edges_i64.restype = ctypes.c_int64
    lib.n2v_index_edges_i64.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, i32p, i32p, ctypes.c_int32,
    ]
    lib.n2v_trim_hotspot.restype = ctypes.c_int
    lib.n2v_trim_hotspot.argtypes = [
        ctypes.c_int64, i32p, ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
    ]
    lib.n2v_mirror_dedup.restype = ctypes.c_int64
    lib.n2v_mirror_dedup.argtypes = [
        ctypes.c_int64, i32p, i32p, f32p, i32p, i32p, f32p,
    ]
    lib.n2v_edge_has_shared.restype = ctypes.c_int
    lib.n2v_edge_has_shared.argtypes = [
        ctypes.c_int32, i64p, i32p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
    ]
    lib.n2v_edge_metadata.restype = ctypes.c_int
    lib.n2v_edge_metadata.argtypes = [
        ctypes.c_int32, i64p, i32p, f32p, i32p, f32p, ctypes.c_int32,
    ]
    lib.n2v_edge_shared_list.restype = ctypes.c_int
    lib.n2v_edge_shared_list.argtypes = [ctypes.c_int32, i64p, i32p, f32p, i32p, ctypes.c_int32]
    lib.n2v_pack_blocked.restype = ctypes.c_int
    lib.n2v_pack_blocked.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, f32p, i32p, f32p, i64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, ctypes.c_int32,
    ]
    lib.n2v_huffman.restype = ctypes.c_int
    lib.n2v_huffman.argtypes = [ctypes.c_int64, i64p, i64p, ctypes.POINTER(ctypes.c_int8), i32p]
    lib.n2v_huffman_paths.restype = ctypes.c_int
    lib.n2v_huffman_paths.argtypes = [
        ctypes.c_int64, i64p, ctypes.POINTER(ctypes.c_int8), i64p, i32p, ctypes.c_int32,
        i32p, ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_csr(
    src: np.ndarray, dst: np.ndarray, weight: Optional[np.ndarray], n_vertices: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR (indptr int64, indices int32 sorted per row, weights f32) from edges."""
    lib = _load()
    assert lib is not None
    n_edges = len(src)
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    w = None if weight is None else np.ascontiguousarray(weight, dtype=np.float32)
    indptr = np.zeros(n_vertices + 1, dtype=np.int64)
    indices = np.empty(n_edges, dtype=np.int32)
    weights = np.empty(n_edges, dtype=np.float32)
    rc = lib.n2v_build_csr(
        n_edges,
        _ptr(src, ctypes.c_int32),
        _ptr(dst, ctypes.c_int32),
        _ptr(w, ctypes.c_float) if w is not None else None,
        n_vertices,
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32),
        _ptr(weights, ctypes.c_float),
        _N_THREADS,
    )
    if rc != 0:
        raise ValueError(f"n2v_build_csr failed with status {rc} (out-of-range vertex id?)")
    return indptr, indices, weights


def build_alias_csr(indptr: np.ndarray, weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Bulk per-edge (alias, prob) tables; alias slots are segment-local."""
    lib = _load()
    assert lib is not None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    n_vertices = len(indptr) - 1
    n_edges = int(indptr[-1])
    alias = np.zeros(n_edges, dtype=np.int32)
    prob = np.ones(n_edges, dtype=np.float32)
    rc = lib.n2v_build_alias(
        n_vertices,
        _ptr(indptr, ctypes.c_int64),
        _ptr(weights, ctypes.c_float),
        _ptr(alias, ctypes.c_int32),
        _ptr(prob, ctypes.c_float),
        _N_THREADS,
    )
    if rc != 0:
        raise ValueError(f"n2v_build_alias failed with status {rc} (non-positive row weight?)")
    return alias, prob


def index_edges_i64(
    src: np.ndarray, dst: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Integer-name indexing: (src_ids, dst_ids, sorted distinct names).

    Bit-compatible with the numpy ``np.unique`` fallback (both produce
    sorted-unique id order); parallel sort + binary-search relabel.
    """
    lib = _load()
    assert lib is not None
    n_edges = len(src)
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    names = np.empty(2 * n_edges, dtype=np.int64)
    src_ids = np.empty(n_edges, dtype=np.int32)
    dst_ids = np.empty(n_edges, dtype=np.int32)
    n_names = lib.n2v_index_edges_i64(
        n_edges,
        _ptr(src, ctypes.c_int64),
        _ptr(dst, ctypes.c_int64),
        _ptr(names, ctypes.c_int64),
        _ptr(src_ids, ctypes.c_int32),
        _ptr(dst_ids, ctypes.c_int32),
        _N_THREADS,
    )
    if n_names < 0:
        raise ValueError("Too many vertices for int32 ids")
    return src_ids, dst_ids, names[:n_names].copy()


def trim_hotspot(
    codes: np.ndarray, n_vertices: int, max_out_degree: int, seed: int
) -> np.ndarray:
    """uint8 keep-mask: at most ``max_out_degree`` random out-edges per vertex.

    Deterministic for a given seed (per-vertex splitmix64 streams), independent
    of thread count.  The random subset differs from the numpy fallback's
    (both are uniform samples; neither is canonical).
    """
    lib = _load()
    assert lib is not None
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    keep = np.zeros(len(codes), dtype=np.uint8)
    rc = lib.n2v_trim_hotspot(
        len(codes),
        _ptr(codes, ctypes.c_int32),
        n_vertices,
        max_out_degree,
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF),
        _ptr(keep, ctypes.c_uint8),
        _N_THREADS,
    )
    if rc != 0:
        raise ValueError(f"n2v_trim_hotspot failed with status {rc}")
    return keep


def mirror_dedup(
    src: np.ndarray, dst: np.ndarray, weight: Optional[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Undirected mirroring: emit both edge directions, dedup (src,dst) pairs."""
    lib = _load()
    assert lib is not None
    n_edges = len(src)
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    w = None if weight is None else np.ascontiguousarray(weight, dtype=np.float32)
    out_src = np.empty(2 * n_edges, dtype=np.int32)
    out_dst = np.empty(2 * n_edges, dtype=np.int32)
    out_w = np.empty(2 * n_edges, dtype=np.float32)
    count = lib.n2v_mirror_dedup(
        n_edges,
        _ptr(src, ctypes.c_int32),
        _ptr(dst, ctypes.c_int32),
        _ptr(w, ctypes.c_float) if w is not None else None,
        _ptr(out_src, ctypes.c_int32),
        _ptr(out_dst, ctypes.c_int32),
        _ptr(out_w, ctypes.c_float),
    )
    return out_src[:count].copy(), out_dst[:count].copy(), out_w[:count].copy()


def edge_has_shared(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """uint8[e] = 1 iff edge e closes a triangle (sorted-row merge)."""
    lib = _load()
    assert lib is not None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    out = np.zeros(len(indices), dtype=np.uint8)
    lib.n2v_edge_has_shared(
        len(indptr) - 1,
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32),
        _ptr(out, ctypes.c_uint8),
        _N_THREADS,
    )
    return out


def edge_metadata(
    indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-edge (rev_enc, pfx) for the blocked walk engine, one parallel pass.

    rev_enc: f32 bits of the reverse-edge weight with the triangle bit in the
    sign; pfx: weight-CDF prefix of src within N(dst).  See
    walk/blocked.py:_edge_metadata for the semantics and the numpy fallback.
    """
    lib = _load()
    assert lib is not None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    n_edges = len(indices)
    rev_enc = np.empty(n_edges, dtype=np.int32)
    pfx = np.empty(n_edges, dtype=np.float32)
    lib.n2v_edge_metadata(
        len(indptr) - 1,
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32),
        _ptr(weights, ctypes.c_float),
        _ptr(rev_enc, ctypes.c_int32),
        _ptr(pfx, ctypes.c_float),
        _N_THREADS,
    )
    return rev_enc, pfx


def edge_shared_list(
    indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray
) -> np.ndarray:
    """Per-edge shared-neighbour (slot, weight) lists and reverse edge id for
    the blocked engine's exact 3-atom mixture (walk/blocked.py shared_lists).

    Returns [E, 16] int32 in the SL_* layout documented on the C++ side: 4
    lanes of 2 x uint16 slots (0xFFFF pad), 8 lanes of f32 weight bits, the
    reverse edge id, flags (bit0 = overflow beyond K = 8 shared entries), 2
    reserved.
    """
    lib = _load()
    assert lib is not None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    out = np.empty((len(indices), 16), dtype=np.int32)
    lib.n2v_edge_shared_list(
        len(indptr) - 1,
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32),
        _ptr(weights, ctypes.c_float),
        _ptr(out, ctypes.c_int32),
        _N_THREADS,
    )
    return out


def pack_blocked(
    indptr: np.ndarray,
    indices: np.ndarray,
    weights: np.ndarray,
    rev_enc: np.ndarray,
    pfx: np.ndarray,
    lo: int,
    hi: int,
    p_l: int,
    c: int,
    row_width: int,
    block_start: np.ndarray,
    n_blocks: int,
    ebase: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Blocked-table packing (light, biw, bids, brp) for vertices [lo, hi),
    threaded.  ``block_start[i]`` is the first block of the range's i-th
    vertex (cumulative over the range's heavy vertices).  Block CDFs are
    row-local double accumulation, so they can differ from the numpy
    fallback's global-prefix difference in the last f32 ulp (both exact)."""
    lib = _load()
    assert lib is not None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    rev_enc = np.ascontiguousarray(rev_enc, dtype=np.int32)
    pfx = np.ascontiguousarray(pfx, dtype=np.float32)
    block_start = np.ascontiguousarray(block_start, dtype=np.int64)
    n_range = hi - lo
    light = np.empty((n_range, row_width), dtype=np.int32)
    biw = np.empty((max(n_blocks, 1), 2 * c), dtype=np.int32)
    bids = np.empty((max(n_blocks, 1), c), dtype=np.int32)
    brp = np.empty((max(n_blocks, 1) * c // 64, 128), dtype=np.int32)
    if n_blocks == 0:  # the numpy packer's 1-row dummy tables
        biw[:, :c] = np.int32(np.iinfo(np.int32).max)
        biw[:, c:] = 0
        bids[:] = np.int32(np.iinfo(np.int32).max)
        brp[:] = 0
    rc = lib.n2v_pack_blocked(
        lo,
        hi,
        _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int32),
        _ptr(weights, ctypes.c_float),
        _ptr(rev_enc, ctypes.c_int32),
        _ptr(pfx, ctypes.c_float),
        _ptr(block_start, ctypes.c_int64),
        p_l,
        c,
        row_width,
        1 if ebase else 0,
        _ptr(light, ctypes.c_int32),
        _ptr(biw, ctypes.c_int32),
        _ptr(bids, ctypes.c_int32),
        _ptr(brp, ctypes.c_int32),
        _N_THREADS,
    )
    if rc != 0:
        raise ValueError(f"n2v_pack_blocked failed with status {rc}")
    return light, biw, bids, brp


def huffman_merge(counts_sorted: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """word2vec's two-queue Huffman merge over counts sorted ascending.

    Returns (parent int64[2n-1], branch int8[2n-1], depth int32[2n-1]) with
    leaves 0..n-1 in the sorted order; the caller maps them back to the
    original leaf ids."""
    lib = _load()
    assert lib is not None
    counts_sorted = np.ascontiguousarray(counts_sorted, dtype=np.int64)
    n = len(counts_sorted)
    parent = np.empty(2 * n - 1, dtype=np.int64)
    branch = np.empty(2 * n - 1, dtype=np.int8)
    depth = np.empty(2 * n - 1, dtype=np.int32)
    rc = lib.n2v_huffman(
        n,
        _ptr(counts_sorted, ctypes.c_int64),
        _ptr(parent, ctypes.c_int64),
        _ptr(branch, ctypes.c_int8),
        _ptr(depth, ctypes.c_int32),
    )
    if rc != 0:
        raise ValueError(f"n2v_huffman failed with status {rc}")
    return parent, branch, depth


def huffman_paths(
    parent: np.ndarray,
    branch: np.ndarray,
    new_id: np.ndarray,
    lengths: np.ndarray,
    max_len: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Threaded leaf-to-root path extraction into the root-first padded
    (points int32 [n, max_len], codes int8 [n, max_len]) layout, padding 0."""
    lib = _load()
    assert lib is not None
    n = len(lengths)
    parent = np.ascontiguousarray(parent, dtype=np.int64)
    branch = np.ascontiguousarray(branch, dtype=np.int8)
    new_id = np.ascontiguousarray(new_id, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    points = np.empty((n, max_len), dtype=np.int32)
    codes = np.empty((n, max_len), dtype=np.int8)
    rc = lib.n2v_huffman_paths(
        n,
        _ptr(parent, ctypes.c_int64),
        _ptr(branch, ctypes.c_int8),
        _ptr(new_id, ctypes.c_int64),
        _ptr(lengths, ctypes.c_int32),
        max_len,
        _ptr(points, ctypes.c_int32),
        _ptr(codes, ctypes.c_int8),
        _N_THREADS,
    )
    if rc != 0:
        raise ValueError(f"n2v_huffman_paths failed with status {rc}")
    return points, codes
