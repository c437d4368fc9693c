#!/usr/bin/env python3
"""A/B of the walk kernels K1 ``dense_walk``, K5 ``blocked_walk`` (its five
modes), K20 ``ep_bucket`` and K21/K22 between source trees, on one card.

    python3 experiments/ab_walk_kernels.py TREE [TREE ...]

Each TREE is the root of a checkout (this repository's, or an unpacked
``git archive`` of another commit).  The trees run one after another, in
the order given (e.g. parent, change, change, parent), each in a process of
its own that builds that tree's kernels afresh into its own
``build/ab_walk_kernels/`` (so ptxas reports every kernel) and times
them through that tree's own ``chip_smoke.py`` checks:

* K1 on the dense ER graph (131,072 walkers x 20 at (p, q) = (0.25, 4),
  ``check_dense_walk``);
* K20, K21 ``ep_propose`` and K22 ``ep_member`` at the second superstep of
  the RMAT's first chunk (scale 19, 131,072 walkers, ``check_ep_walk``; K20's
  two launches a superstep summed);
* K5 held bit-equal to its plain version by ``check_blocked_walk`` (every
  ``BLOCKED_SETTINGS`` entry) and ``check_blocked_walk_sl`` (the RMAT, mixed
  lists; the ER graph, exhaustive), then timed in each mode through the
  tree's ``blocked_walk_chunk`` on 131,072 walkers x 20 (CUDA events over
  10 launches): mode 0 (1, 1), 1 (0.25, 1) and 2 (0.25, 4) on the RMAT's
  tables, 3 ``sl_mixed`` on the RMAT's with lists, 4 ``sl_exhaustive`` on
  the ER graph's at P = 31, both at (0.25, 4).  Each mode's digest is the
  sha256 of its paths and its two counters;
* the walk corpora of ``main_path_blocked`` (``run_device``), and of
  ``main_path_streaming`` and ``main_path_shared_lists`` (their 40 chunks,
  ``chunk_source``), and ``main_path_shared_lists_er``, each a sha256
  (chip_smoke.py's ``corpus_digest``).

Prints one JSON line a tree: times, errors, digests, ptxas's registers and
spills of K1, K20's, K5's (two: with and without shared lists), K21's and
K22's kernels, and K5's walkers resident an SM
(the tree's ``blocked_walk_geometry`` where it has one; else from K5's
registers, 8 walkers a block of 256 threads, 65,536 registers an SM).  Then
one line comparing every digest across the trees (exit code 1 if any
differs), one comparing the SASS of K1's ``dense_walk_kernel`` (addresses
and encodings dropped, branch targets kept; each tree's listing written to a
file for a diff), and the card's name and power limit.
"""

import collections
import json
import os
import re
import shutil
import subprocess
import sys

PROGRAM = r"""
import hashlib, json, os, shutil, sys
tree = sys.argv[1]
sys.path.insert(0, tree)
os.chdir(tree)
# built afresh in every run, so that ptxas reports every kernel of the tree
shutil.rmtree(os.path.join(tree, AB_BUILD), ignore_errors=True)
os.environ["N2V_TORCH_BUILD_DIR"] = os.path.join(tree, AB_BUILD)
import numpy as np, torch
import chip_smoke as cs
from node2vec_torch import Node2Vec, _build
from node2vec_torch.constants import Node2VecParams
from node2vec_torch.graph import build_graph
from node2vec_torch.walk import WalkEngine, blocked


def digest(chunks):
    h = hashlib.sha256()
    for c in chunks:
        h.update(np.ascontiguousarray(c.cpu().numpy(), dtype=np.int32).tobytes())
    return h.hexdigest()


results = {}
src, dst = cs.smoke_edges(131072, 2_097_152)
g_er = build_graph((src, dst), directed=False)
cs.check_dense_walk(g_er, 131072, 20, results)
rmat_src, rmat_dst, g_rmat = cs.rmat_graph(19)
cs.check_ep_walk(cs.make_mesh(1, 1, device="cuda"), g_rmat, 131072, 20, results)
cs.check_blocked_walk(g_rmat, 131072, 20, results)
cs.check_blocked_walk_sl(g_rmat, "RMAT scale 19", 131072, 20, results)
cs.check_blocked_walk_sl(g_er, "dense ER", 131072, 20, results)

dev = torch.device("cuda")
bg = blocked.build_blocked_graph(g_rmat.indptr, g_rmat.indices, g_rmat.weights, device=dev)
bg_sl = cs._sl_tables(g_rmat)[0]
bg_er = cs._sl_tables(g_er)[0]
k5 = {}
for name, tabs, p, q, sl in (("0 (1, 1)", bg, 1.0, 1.0, False),
                             ("1 (0.25, 1)", bg, 0.25, 1.0, False),
                             ("2 (0.25, 4)", bg, 0.25, 4.0, False),
                             ("3 sl_mixed (0.25, 4)", bg_sl, 0.25, 4.0, True),
                             ("4 sl_exhaustive, ER (0.25, 4)", bg_er, 0.25, 4.0, True)):
    starts = torch.arange(131072, dtype=torch.int32, device=dev) % tabs.light.shape[0]
    kw = dict(walk_length=20, return_param=p, inout_param=q, max_trials=64,
              light_width=tabs.light_width, block_width=tabs.block_width,
              has_heavy=tabs.has_heavy)
    if sl:
        kw.update(slq=tabs.slq, shared_lists=True, sl_exhaustive=tabs.sl_exhaustive)
    run = lambda: blocked.blocked_walk_chunk(*tabs[:4], starts, 0, 0, **kw)
    ms = cs.time_ms(run, reps=10)
    paths, n_fb, n_att = run()
    k5[name] = {"ms": ms, "sha256": digest([paths, torch.stack([n_fb, n_att])]),
                "steps": int((paths[:, 1:] >= 0).sum()), "attempts": int(n_att)}
del bg, bg_sl, bg_er

corpora = {}
n2v = Node2Vec(n2v_params=cs.N2V_MAIN, w2v_params=cs.W2V_MAIN, max_out_degree=10_000,
               random_seed=0, device="cuda")
n2v.preprocess_input_graph((rmat_src, rmat_dst), indexed=True, directed=False)
engine = n2v._walk_engine()
corpora["main_path_blocked"] = digest([engine.run_device(seed=0)])
n_chunks, _, source = engine.chunk_source(seed=0)
corpora["main_path_streaming"] = digest(source(i) for i in range(n_chunks))
del n2v, engine, source
n2v = Node2Vec(n2v_params=cs.N2V_MAIN, w2v_params=cs.W2V_MAIN, max_out_degree=10_000,
               random_seed=0, shared_lists=True, device="cuda")
n2v.preprocess_input_graph((rmat_src, rmat_dst), indexed=True, directed=False)
n_chunks, _, source = n2v._walk_engine().chunk_source(seed=0)
corpora["main_path_shared_lists"] = digest(source(i) for i in range(n_chunks))
del n2v, source
engine = WalkEngine(g_er, Node2VecParams(**cs.N2V_MAIN), strategy="blocked",
                    shared_lists=True, device="cuda")
corpora["main_path_shared_lists_er"] = digest([engine.run_device(seed=0)])

ptxas = {}
for part in ("dense_walk_kernel", "ep_bucket_count", "ep_bucket_scatter", "ep_bucket_kernel",
             "ep_propose_kernel", "ep_member_kernel", "blocked_walk_kernel"):
    ptxas.update(cs.ptxas_summary(_build.ptxas_report, part))
geometry = getattr(blocked, "blocked_walk_geometry", None)
if geometry is not None:
    resident = {f"C=256, mode {m}": geometry(256, m, 131072, "cuda")["walkers_per_sm"]
                for m in range(5)}
else:  # one warp a walker, 8 a block: registers bound it
    resident = {}
    for name, summary in ptxas.items():
        if "blocked_walk_kernel" in name:
            regs = int(summary.split("Used ")[1].split(" registers")[0])
            warps = 65536 // (-(-regs * 32 // 256) * 256)
            resident[name[-40:]] = (min(warps, 64) // 8) * 8
print("AB " + json.dumps({"tree": tree, "dense_walk": results["dense_walk"],
                          "ep": {k: results[k] for k in ("ep_bucket", "ep_propose", "ep_member")},
                          "k5": k5, "k5_check_ms": {k: results[k]["ms"] for k in (
                              "blocked_walk", "blocked_walk_sl_mixed",
                              "blocked_walk_sl_exhaustive")},
                          "corpora": corpora, "ptxas": ptxas,
                          "k5_walkers_resident_per_sm": resident}), flush=True)
torch.distributed.destroy_process_group()
""".replace("AB_BUILD", repr(os.path.join("build", "ab_walk_kernels")))


def _cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")


def dense_walk_sass(tree: str) -> list:
    """The instructions of K1's kernel in TREE's built library, one string
    each (predicate, opcode and operands), in program order."""
    lib = os.path.join(tree, "build", "ab_walk_kernels", "libn2v_kernels.so")
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
    rows = []
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", PROGRAM, tree], capture_output=True,
                             text=True, timeout=1500)
        lines = [ln[3:] for ln in out.stdout.splitlines() if ln.startswith("AB ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-3000:] + out.stderr[-3000:], file=sys.stderr)
            return 1
        row = json.loads(lines[-1])
        rows.append(row)
        print(json.dumps({"tree": tree, "k1_ms": row["dense_walk"]["ms"],
                          "k1_max_abs_err": row["dense_walk"]["max_abs_err"],
                          **{f"{k}_ms": v["ms"] for k, v in row["ep"].items()},
                          "k5": row["k5"], "k5_check_ms": row["k5_check_ms"],
                          "corpora": row["corpora"], "ptxas": row["ptxas"],
                          "k5_walkers_resident_per_sm": row["k5_walkers_resident_per_sm"]}),
              flush=True)
    same = {f"k5 mode {k}": len({r["k5"][k]["sha256"] for r in rows}) == 1 for k in rows[0]["k5"]}
    same.update({k: len({r["corpora"][k] for r in rows}) == 1 for k in rows[0]["corpora"]})
    print(json.dumps({"digests_equal_across_trees": same}), flush=True)
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
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
