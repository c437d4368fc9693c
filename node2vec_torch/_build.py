"""Build and load the port's CUDA kernels, and count their launches.

``csrc/*.cu`` are compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a``
at first use: one ``nvcc -c`` per source, all started together, then one
link into ``build/node2vec_torch/libn2v_kernels.so`` (see
``node2vec_torch.native.build_dir``), loaded with ctypes.  Every C entry
returns ``cudaGetLastError()`` and ``check`` raises when it is not 0.  Nothing
here runs at import: the CPU tests import every module, and this machine
may have no ``nvcc``.

``launches`` counts kernel launches by name (and, under ``MODE_COUNTS``,
those in a kernel's shared-list or global-staging mode).  Each wrapper adds
one where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels.  ``staging`` picks where the
walk-at-a-time step kernels (K2, K8, K9, K10, K13, K16, K17) stage a walk.
K2's and K8's routed modes (the row-sharded steps) count under their own
names, ``sgns_grads_routed`` and ``hs_grads_routed``, not under K2's and K8's.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

from node2vec_torch.native import build_dir

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
KERNELS = ("dense_walk", "sgns_grads", "adagrad_accumulate", "adagrad_apply",
           "blocked_walk", "vertex_counts", "subsample_walks", "hs_grads", "cbow_grads",
           "cbow_hs_grads", "preagg_rows", "sgd_apply", "csr_walk", "pair_lists",
           "sgns_pair_grads", "fused_adagrad", "alias_draw", "col_pair_logits",
           "col_pair_grads", "adagrad_accumulate_squares", "route_plan", "route_gather",
           "route_pack", "sgns_grads_routed", "hs_grads_routed")
# launches of a kernel in one of its modes, counted beside the kernel's own;
# "*_sharded": a walk kernel launched for one data shard of a mesh
MODE_COUNTS = ("blocked_walk_sl_mixed", "blocked_walk_sl_exhaustive", "sgns_grads_global",
               "hs_grads_global", "cbow_grads_global", "cbow_hs_grads_global",
               "sgns_pair_grads_global", "col_pair_logits_global", "col_pair_grads_global",
               "dense_walk_sharded", "blocked_walk_sharded", "csr_walk_sharded",
               "sgns_grads_routed_global", "hs_grads_routed_global")

launches: collections.Counter = collections.Counter()
STAGING_BLOCKS_PER_SM = 4  # global staging's grid: a small multiple of the SMs
build_seconds: Optional[float] = None
ptxas_report: str = ""

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the CUDA kernels are built "
        "from node2vec_torch/csrc on a machine with the CUDA toolkit"
    )


def build() -> str:
    """Compile csrc/*.cu if the library is missing or older than a source;
    returns the library path."""
    global build_seconds, ptxas_report
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libn2v_kernels.so")
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    deps = sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= max(
        os.path.getmtime(p) for p in deps
    ):
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    procs = []
    for src in sources:
        obj = os.path.join(out_dir, os.path.basename(src)[:-3] + f".{tag}.o")
        cmd = [nvcc, *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    reports = []
    failed = []
    for src, _obj, proc in procs:
        stdout, stderr = proc.communicate(timeout=900)
        reports.append(f"== {os.path.basename(src)}\n{stdout}{stderr}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src}:\n{stderr}")
    ptxas_report = "\n".join(reports)
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = f"{lib_path}.{tag}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", tmp, *[o for _, o, _ in procs]],
        capture_output=True, text=True, timeout=300,
    )
    for _, obj, _ in procs:
        os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
    os.replace(tmp, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        handle = ctypes.CDLL(build())
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        f32, u32 = ctypes.c_float, ctypes.c_uint32
        signatures = {
            "n2v_dense_walk": [vp, i32, vp, vp, i64, i32, i64, u32, f32, f32, i32, vp],
            "n2v_sgns_grads": [vp, vp, i32, i32, vp, vp, vp, vp, i32, i32, i32, i32, f32,
                               vp, vp, vp, vp, vp, i32, vp],
            "n2v_adagrad_accumulate": [vp, vp, vp, vp, i64, vp, vp, i64, vp, vp, i64, i32,
                                       vp],
            "n2v_adagrad_apply": [vp, vp, vp, vp, vp, vp, i64, vp, vp, i64, vp, vp, i64, i32,
                                  f32, vp],
            "n2v_blocked_walk": [vp, i32, vp, vp, vp, vp, vp, vp, vp, i64, i32, i64, u32, f32,
                                 f32, f32, i32, i32, i32, i32, i32, vp],
            "n2v_vertex_counts": [vp, i64, vp, i32, vp],
            "n2v_subsample_walks": [vp, i64, vp, i32, u32, u32, i64, vp, vp],
            "n2v_hs_grads": [vp, vp, i32, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
                             i32, vp, vp, vp, vp, vp, vp, i32, vp],
            "n2v_cbow_grads": [vp, vp, i32, vp, vp, vp, vp, i32, i32, i32, i32, f32, i32,
                               vp, vp, vp, vp, vp, i32, vp],
            "n2v_cbow_hs_grads": [vp, vp, i32, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                  i32, vp, vp, vp, vp, vp, i32, vp],
            "n2v_preagg_rows": [vp, i64, vp, vp, i32, vp, vp, vp, vp, vp, vp],
            "n2v_sgd_apply": [vp, vp, i32, vp, vp, vp, vp, i64, vp, vp, i64, vp, f32, f32, vp],
            "n2v_csr_walk": [vp, vp, vp, vp, vp, vp, i64, vp, vp, i64, i32, i64, u32, f32, f32,
                             f32, i32, i32, i32, i32, vp],
            "n2v_pair_lists": [vp, vp, vp, i32, i32, i32, vp, vp, vp],
            "n2v_sgns_pair_grads": [vp, vp, i32, vp, vp, vp, i32, i32, i32, i32, f32, vp, vp,
                                    vp, vp, vp, i32, vp],
            "n2v_fused_adagrad": [vp, vp, vp, vp, i64, vp, vp, i64, vp, vp, i64, i32, f32, vp,
                                  vp, vp],
            "n2v_alias_draw": [vp, vp, vp, vp, vp, vp, vp, i64, vp, vp],
            "n2v_col_pair_logits": [vp, vp, i32, vp, vp, vp, i32, i32, i32, i32, vp, vp, vp,
                                    i32, vp],
            "n2v_col_pair_grads": [vp, vp, i32, vp, vp, vp, vp, vp, i32, i32, i32, i32, f32,
                                   vp, vp, vp, vp, vp, vp, vp, vp, vp, i32, vp],
            "n2v_adagrad_accumulate_squares": [vp, vp, vp, vp, i64, vp, vp, i64, vp, vp, i64,
                                               i32, vp],
            "n2v_route_plan": [vp, i64, i32, i32, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                               vp, vp, vp],
            "n2v_route_gather": [vp, i32, vp, i64, i32, vp, vp],
            "n2v_route_pack": [vp, vp, i64, vp, vp, i32, vp, vp, vp, vp, vp, i64, i32, vp, vp],
            "n2v_route_tile": [],
            "n2v_sgns_grads_routed": [vp, vp, i32, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                      f32, vp, vp, vp, vp, vp, i32, vp],
            "n2v_hs_grads_routed": [vp, vp, vp, i32, vp, vp, vp, vp, vp, vp, vp, vp, i32, i32,
                                    i32, i32, i32, i32, vp, vp, vp, vp, vp, vp, i32, vp],
        }
        for name, argtypes in signatures.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.n2v_sgns_grads_smem.argtypes = [i32, i32, i32, i32]
        handle.n2v_sgns_grads_smem.restype = ctypes.c_size_t
        handle.n2v_sgns_pair_grads_smem.argtypes = [i32, i32, i32, i32]
        handle.n2v_sgns_pair_grads_smem.restype = ctypes.c_size_t
        for name in ("n2v_col_pair_logits_smem", "n2v_col_pair_grads_smem"):
            getattr(handle, name).argtypes = [i32, i32, i32, i32]
            getattr(handle, name).restype = ctypes.c_size_t
        handle.n2v_hs_grads_smem.argtypes = [i32, i32, i32, i32, i32]
        handle.n2v_hs_grads_smem.restype = ctypes.c_size_t
        handle.n2v_cbow_grads_smem.argtypes = [i32, i32, i32]
        handle.n2v_cbow_grads_smem.restype = ctypes.c_size_t
        handle.n2v_cbow_hs_grads_smem.argtypes = [i32, i32]
        handle.n2v_cbow_hs_grads_smem.restype = ctypes.c_size_t
        handle.n2v_error_string.argtypes = [ctypes.c_int]
        handle.n2v_error_string.restype = ctypes.c_char_p
        _lib = handle
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib().n2v_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def staging_stride(smem: int) -> int:
    """Floats of workspace one block stages in: the shared carve of ``smem``
    bytes rounded up to 128 B (csrc/staging.cuh: n2v::staging_stride)."""
    return -(-int(smem) // 128) * 32


def staging_mode(smem: int, limit: int) -> str:
    """"shared" when a walk's ``smem`` bytes fit the card's opt-in shared
    memory per block (``limit``), "global" otherwise."""
    return "shared" if smem <= limit else "global"


def staging(smem: int, n_walks: int, device):
    """Where a step kernel stages a walk of ``smem`` bytes, chosen from its shape before the
    launch: ``(None, 0)`` for shared memory, else a workspace tensor of
    ``blocks`` slices and ``blocks``, the launch's grid (at most one block a
    walk, at most ``STAGING_BLOCKS_PER_SM`` a multiprocessor, so the
    workspace stays bounded).  Pass ``ptr_or_null(ws)`` and ``blocks`` to the
    C entry, and keep ``ws`` alive across the call."""
    import torch

    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    if staging_mode(smem, limit) == "shared":
        return None, 0
    blocks = max(1, min(int(n_walks), STAGING_BLOCKS_PER_SM * props.multi_processor_count))
    ws = torch.empty(blocks * staging_stride(smem), dtype=torch.float32, device=device)
    return ws, blocks


def ptr_or_null(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def require_cuda(name: str, *tensors) -> None:
    """Kernel inputs must be contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices ({t.device} vs {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous")
