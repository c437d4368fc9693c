"""Patched copies of a kernel source, built side by side on one card: the
common part of ``k2_attribution.py`` and ``hs_attribution.py``.

``source`` reads a kernel source with its shared headers written in;
``patched`` applies text patches, each of which must match the source
exactly once, so a patch that no longer follows its kernel fails loudly.
``build`` compiles each source into a shared library of its own with nvcc
(sm_90a, one process a source, all started together) and prints ptxas's
registers and spills of the kernels named.  Neither is imported by the port.
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
