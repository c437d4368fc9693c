"""Patched copies of a kernel source, built side by side on one card, and
A/B runs between source trees: the common part of the attribution and A/B
scripts in this directory.

``source`` reads a kernel source with its shared headers written in;
``patched`` applies text patches, each of which must match the source
exactly once, so a patch that no longer follows its kernel fails loudly.
``build`` compiles each source into a shared library of its own with nvcc
(sm_90a, one process a source, all started together) and prints ptxas's
registers and spills of the kernels named.  ``probes``, ``probe_counters``,
``probe_flush``, ``phase_read`` and ``profile`` patch ``clock64()`` phase
probes into a kernel and read them (``col_sgns_attribution.py``);
``run_trees`` runs one program a tree, in turn, each in a process of its
own (``ab_col_sgns_kernels.py``).  The port imports none of it.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "node2vec_torch", "csrc")


def source(name: str, csrc: str = CSRC) -> str:
    """The text of ``csrc/<name>`` with each local header it includes, other
    than ``staging.cuh``, written out in place, so that a patch can reach
    the code a kernel shares with others (``tf32_tiles.cuh``).  ``csrc`` is
    the kernel directory of this tree, or of another checkout's."""
    text = open(os.path.join(csrc, name)).read()
    for header in re.findall(r'#include "(\w+\.cuh)"', text):
        if header != "staging.cuh":
            text = text.replace(f'#include "{header}"', source(header, csrc), 1)
    return text


def patched(src: str, pairs) -> str:
    """``src`` with each (old, new) pair replaced; exits when an ``old`` is
    not in ``src`` exactly once."""
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"patch does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(srcs: dict, out_dir: str, kernels) -> dict:
    """Each library of ``srcs`` (name -> (CUDA source, extra nvcc flags)),
    built into ``out_dir`` beside a copy of ``staging.cuh``, as a loaded
    ``ctypes.CDLL`` by name.  ``kernels(name)`` is the part of the mangled
    kernel names whose ptxas report is printed."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    os.makedirs(out_dir, exist_ok=True)
    subprocess.run(["cp", os.path.join(CSRC, "staging.cuh"), out_dir], check=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "nvcc")
    procs = {}
    for i, (name, (text, flags)) in enumerate(srcs.items()):
        path, lib = os.path.join(out_dir, f"src_{i}.cu"), os.path.join(out_dir, f"lib_{i}.so")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = (lib, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", *flags, path, "-o", lib],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(err)
        print(json.dumps({"build": name,
                          "ptxas": chip_smoke.ptxas_summary(err, kernels(name))}), flush=True)
        libs[name] = ctypes.CDLL(lib)
    return libs


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


# ---- clock64() phase probes ------------------------------------------------
#
# A probed kernel keeps a counter a phase in registers (``_pr``, started by
# PROBE_START at the top of the block's function): at each probe the first
# lane of every warp adds the cycles since its previous probe to that
# phase, so a barrier's wait counts in the phase that ends at it and a
# load's wait where its value is first used.  ``probe_flush`` adds a warp's
# counters to the library's device array once, with one to its last entry
# (the warps counted); ``phase_read`` is the C entry that reads and resets
# it; ``profile`` turns the sums into thousands of cycles a warp a launch
# and shares.

NPH = 16  # counters a probed library keeps; the last counts the warps
PROBE_START = "long long _pr[16] = {};\n  long long _t = clock64();\n"


def probes(n: int) -> list:
    """The probe statements of phases 0 .. n - 1."""
    return [f"if ((threadIdx.x & 31) == 0) {{ const long long _n = clock64(); "
            f"_pr[{k}] += _n - _t; _t = _n; }}" for k in range(n)]


def probe_counters(prefix: str) -> str:
    """The device array of a probed library."""
    return f"__device__ unsigned long long {prefix}_phase_clk[{NPH}];\n"


def probe_flush(prefix: str, n: int) -> str:
    """A warp's counters of phases 0 .. n - 1 added to the device array."""
    return (f"  if ((threadIdx.x & 31) == 0) {{\n    for (int k = 0; k < {n}; ++k)\n"
            f"      atomicAdd(&{prefix}_phase_clk[k], (unsigned long long)_pr[k]);\n"
            f"    atomicAdd(&{prefix}_phase_clk[{NPH - 1}], 1ull);\n  }}\n")


def phase_read(prefix: str) -> str:
    """C entry ``<prefix>_phase_read(out)``: the counters, then zeros."""
    return f"""
extern "C" int {prefix}_phase_read(unsigned long long* out) {{
  cudaError_t err = cudaMemcpyFromSymbol(out, {prefix}_phase_clk, sizeof({prefix}_phase_clk));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long z[{NPH}] = {{}};
  return (int)cudaMemcpyToSymbol({prefix}_phase_clk, z, sizeof(z));
}}
"""


def profile(lib, prefix: str, call, phases, reps: int = 10) -> dict:
    """A probed library's phase sums over ``reps`` calls, thousands of
    cycles a warp a launch, with each phase's share of their total."""
    import torch

    read = getattr(lib, f"{prefix}_phase_read")
    read.argtypes = [ctypes.c_void_p]
    clk = (ctypes.c_ulonglong * NPH)()
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    read(clk)  # read and reset
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    read(clk)
    warps = max(clk[NPH - 1], 1)
    kclk = {p: clk[k] / warps / 1e3 for k, p in enumerate(phases)}
    total = sum(kclk.values())
    return {"warps_a_launch": warps / reps, "kclk_a_warp_a_launch": kclk, "total_kclk": total,
            "share": {p: v / total for p, v in kclk.items()}}


# ---- A/B between source trees ---------------------------------------------


def run_trees(trees, program: str, tag: str = "AB ", timeout: int = 1500):
    """Run ``program`` (Python source; its first argument is the tree's root)
    once a tree, in the order given (e.g. parent, change, change, parent),
    each in a process of its own, so that every tree builds and loads its
    own kernels.  Yields each run's last line that starts with ``tag``,
    parsed as JSON; exits with the run's output when one fails."""
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", program, os.path.abspath(tree)],
                             capture_output=True, text=True, timeout=timeout)
        lines = [ln[len(tag):] for ln in out.stdout.splitlines() if ln.startswith(tag)]
        if out.returncode != 0 or not lines:
            raise SystemExit(out.stdout[-3000:] + out.stderr[-3000:])
        yield json.loads(lines[-1])
