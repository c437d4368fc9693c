#!/usr/bin/env python3
"""A/B of K1 ``dense_walk`` and K20 ``ep_bucket`` between source trees, on one card.

    python3 experiments/ab_walk_kernels.py TREE [TREE ...]

Each TREE is the root of a checkout (this repository's, or an unpacked
``git archive`` of another commit).  The trees run one after another, in
the order given (e.g. parent, change, change, parent), each in a process of
its own that builds that tree's kernels into its own ``build/`` and times
them through that tree's own ``chip_smoke.py`` checks: K1 on the dense ER
graph (131,072 walkers x 20 at (p, q) = (0.25, 4), ``check_dense_walk``)
and K20 at the second superstep of the RMAT's first chunk (scale 19,
131,072 walkers, ``check_ep_walk``; its two launches a superstep summed).
Both checks also hold the kernels bit-equal to their plain versions.
Prints one JSON line a tree (times, errors, and ptxas's registers and
spills of the three kernels), then one line comparing the SASS of K1's
``dense_walk_kernel`` across the trees (``cuobjdump -sass`` of each
tree's built library; addresses and encodings dropped, branch targets
kept as written), then the card's name and power limit.  Each tree's
SASS is written to ``chiprun_out/ab_sass/<i>.sass`` for a diff.
"""

import collections
import json
import os
import re
import shutil
import subprocess
import sys

PROGRAM = r"""
import json, os, sys
tree = sys.argv[1]
sys.path.insert(0, tree)
os.chdir(tree)
import chip_smoke as cs
from node2vec_torch.graph import build_graph
results = {}
src, dst = cs.smoke_edges(131072, 2_097_152)
cs.check_dense_walk(build_graph((src, dst), directed=False), 131072, 20, results)
g_rmat = cs.rmat_graph(19)[2]
cs.check_ep_walk(cs.make_mesh(1, 1, device="cuda"), g_rmat, 131072, 20, results)
from node2vec_torch import _build
report = _build.ptxas_report.splitlines()
ptxas = {}
for i, line in enumerate(report):
    for name in ("dense_walk_kernel", "ep_bucket_count", "ep_bucket_scatter"):
        if name in line and "Compiling entry function" in line:
            ptxas[name] = " | ".join(x.split(":", 1)[-1].strip() for x in report[i + 2: i + 4])
print("AB " + json.dumps({"tree": tree, "dense_walk": results["dense_walk"],
                          "ep_bucket": results["ep_bucket"], "ptxas": ptxas}), flush=True)
"""


def _cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")


def dense_walk_sass(tree: str) -> list:
    """The instructions of K1's kernel in TREE's built library, one string
    each (predicate, opcode and operands), in program order."""
    lib = os.path.join(tree, "build", "node2vec_torch", "libn2v_kernels.so")
    dump = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out, inside = [], False
    for line in dump.splitlines():
        if "Function :" in line:
            inside = "dense_walk_kernel" in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line) if inside else None
        if m:
            out.append(" ".join(m.group(1).split()))
    return out


def _opcodes(sass: list) -> collections.Counter:
    return collections.Counter(re.sub(r"^@!?U?P[T0-9]+ ", "", ins).split(" ")[0]
                               for ins in sass)


def main() -> int:
    trees = [os.path.abspath(t) for t in sys.argv[1:]]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", PROGRAM, tree], capture_output=True,
                             text=True, timeout=1200)
        lines = [ln[3:] for ln in out.stdout.splitlines() if ln.startswith("AB ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-3000:] + out.stderr[-3000:], file=sys.stderr)
            return 1
        row = json.loads(lines[-1])
        print(json.dumps({"tree": tree, "k1_ms": row["dense_walk"]["ms"],
                          "k1_max_abs_err": row["dense_walk"]["max_abs_err"],
                          "k20_ms": row["ep_bucket"]["ms"],
                          "k20_max_abs_err": row["ep_bucket"]["max_abs_err"],
                          "ptxas": row["ptxas"]}), flush=True)
    sass_dir = os.path.join(os.getcwd(), "chiprun_out", "ab_sass")
    os.makedirs(sass_dir, exist_ok=True)
    listings = []
    for i, tree in enumerate(dict.fromkeys(trees)):
        listings.append(dense_walk_sass(tree))
        with open(os.path.join(sass_dir, f"{i}.sass"), "w") as f:
            f.write(f"// {tree}\n" + "\n".join(listings[-1]) + "\n")
    first = _opcodes(listings[0])
    print(json.dumps({"dense_walk_sass": [
        {"tree": tree, "instructions": len(sass), "same_as_first": sass == listings[0],
         "opcodes_vs_first": {op: n for op in sorted(set(first) | set(_opcodes(sass)))
                              if (n := _opcodes(sass)[op] - first[op])}}
        for tree, sass in zip(dict.fromkeys(trees), listings)]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
