#!/usr/bin/env python3
"""A/B of K2 ``sgns_grads`` between source trees, on one card.

    python3 experiments/ab_sgns_kernel.py TREE [TREE ...]

Each TREE is the root of a checkout (this repository's, or an unpacked
``git archive`` of another commit).  The trees run one after another, in
the order given (e.g. parent, change, change, parent), each in a process of
its own that builds that tree's kernels into its own ``build/`` and times
K2 through that tree's own ``chip_smoke.py`` checks, which also hold it to
its plain version:

* ``main``: B = 2,560 random walks with dead tails, L1 = 21, D = 128,
  S = 64, w = 5 (``check_sgns``, the main path's shape);
* ``dim64``: the same at D = 64;
* ``fused``: row stride D + 1 on the fused tables (``check_fused``);
* ``routed``: K2's routed mode on ``main_path_mesh_row``'s batch (2,570
  walks of the dense graph's first chunk, ``check_route``);
* ``wide``: L1 = 81, D = 256, w = 10 at B = 64 and B = 256 random walks
  (``check_sgns``; ``staging`` says where the kernel staged them).

Then ``main_path`` (the dense Quickstart pipeline, one epoch) for the fit's
wall time and pair-updates/s.  Beside each K2 time, ``neg_gemm_ms``: the
three fp32 ``torch.matmul`` products of the negative half at the same shape
(``allow_tf32`` False), a partial yardstick the port never calls.  Prints
one JSON line a tree (times, errors, ptxas's registers, shared memory and
spills of K2's kernels, and how many tensor-core ``HMMA`` instructions
``cuobjdump -sass`` finds in them), then the card's name and power limit.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the change's ptxas and SASS readers, for every tree)

PROGRAM = r"""
import json, os, sys
tree = sys.argv[1]
sys.path.insert(0, tree)
os.chdir(tree)
import numpy as np
import torch
import chip_smoke as cs
from node2vec_torch import _build
from node2vec_torch.graph import build_graph
from node2vec_torch.models import hsoftmax as hs
from node2vec_torch.walk import WalkEngine
from node2vec_torch.constants import Node2VecParams

torch.backends.cuda.matmul.allow_tf32 = False


def neg_gemm_ms(n_rows, dim, n_neg):
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((n_rows, dim), generator=g, device="cuda")
    no = torch.randn((n_neg, dim), generator=g, device="cuda")
    gn = torch.randn((n_rows, n_neg), generator=g, device="cuda")
    return cs.time_ms(lambda: (x @ no.T, gn @ no, gn.T @ x))


out = {"tree": tree}


def k2(name, row, n_rows, dim, key="sgns_grads"):
    out[name] = {"ms": row[key]["ms"], "bound_ms": row[key]["bound_ms"],
                 "max_abs_err": row[key]["max_abs_err"],
                 "staging": row[key].get("staging"),
                 "neg_gemm_ms": neg_gemm_ms(n_rows, dim, 64)}


r = {}
cs.check_sgns(131072, 2560, 21, 128, 5, 64, True, r)
k2("main", r, 2560 * 21, 128)
r = {}
cs.check_sgns(131072, 2560, 21, 64, 5, 64, True, r)
k2("dim64", r, 2560 * 21, 64)
r = {}
cs.check_fused(131072, 2560, 21, 128, 5, True, r, "random walks, dead tails")
k2("fused", r, 2560 * 21, 128, key="sgns_grads_fused")
for b in (64, 256):
    r = {}
    cs.check_sgns(4096, b, 81, 256, 10, 64, True, r)
    k2(f"wide_b{b}", r, b * 81, 256)
src, dst = cs.smoke_edges(131072, 2_097_152)
g = build_graph((src, dst), directed=False)
tree_, counts = cs.hs_tree(g)
head = hs.head_level_offsets(tree_, table_rows=tree_.n_inner)
hs_batch = cs._effective_batch(8192, 131072, target_updates=51)
chunk0 = WalkEngine(g, Node2VecParams(**cs.N2V_MAIN), device="cuda").chunk_source(seed=0)[2](0)
hs_walks = chunk0.cpu().numpy()[np.random.default_rng(0).permutation(len(chunk0))]
r = {}
cs.check_route(tree_, head, hs_walks[:hs_batch], 131072, True, r, "main_path_mesh_row batch")
k2("routed", r, hs_batch * 21, 128, key="sgns_grads_routed")
del chunk0, hs_walks, g
mp, _ = cs.main_path(src, dst, max_iter=1)
out["main_path"] = {k: mp[k] for k in ("fit_s", "sgns_pair_updates_per_s", "walk_s",
                                         "epoch_losses")}
out["ptxas_report"] = _build.ptxas_report
print("AB " + json.dumps(out), flush=True)
"""


def main() -> int:
    trees = [os.path.abspath(t) for t in sys.argv[1:]]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", PROGRAM, tree], capture_output=True,
                             text=True, timeout=1500)
        lines = [ln[3:] for ln in out.stdout.splitlines() if ln.startswith("AB ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-3000:] + out.stderr[-3000:], file=sys.stderr)
            return 1
        row = json.loads(lines[-1])
        row["ptxas"] = chip_smoke.ptxas_summary(row.pop("ptxas_report"), "sgns_grads_kernel")
        row["sass"] = chip_smoke.sass_counts(
            os.path.join(tree, "build", "node2vec_torch", "libn2v_kernels.so"),
            "sgns_grads_kernel")
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
