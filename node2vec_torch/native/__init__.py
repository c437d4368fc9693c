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
