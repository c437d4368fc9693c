#!/usr/bin/env python3
"""A/B of K8 ``hs_grads`` and K3 ``adagrad_accumulate`` between source trees,
on one card.

    python3 experiments/ab_hs_kernel.py TREE [TREE ...]

Each TREE is the root of a checkout (this repository's, or an unpacked
``git archive`` of another commit).  The trees run one after another, in
the order given (e.g. parent, change, change, parent), each in a process of
its own that builds that tree's kernels into its own ``build/`` and times
them through that tree's own ``chip_smoke.py`` checks, which also hold each
kernel to its plain version:

* ``k8_direct``: K8 on 2,570 walks of ``main_path_hs``'s first chunk,
  shuffled, on the dense graph's Huffman tree (L1 = 21, D = 128, w = 5;
  ``check_hs``), with K3 on the step's HS lists (``k3_hs``);
* ``k8_chunked``: K8 at D = 768 (rows past 512 columns, in chunks of 512)
  on 256 of the same walks;
* ``k8_routed``: K8's routed mode on ``main_path_mesh_row_hs``'s batch (the
  same walks; ``check_route``);
* ``k8_wide``: K8 in global staging at ``main_path_wide``'s shape (64 walks
  of the quality graph's corpus, L1 = 81, D = 256, w = 10);
* ``k3_cbow_hs``: K3 on CBOW-HS's lists at the same walks (``check_cbow``);
* ``k3_sgns``: K3 on the SGNS step's lists, B = 2,560 random walks
  (``check_sgns``); ``k3_pairs``: on the pair step's lists
  (``check_pairs``);

each K3 row with its library yardstick (the live rows' mean squares and
``index_add_``, never called by the port).  Then ``main_path_hs`` (the dense
graph streamed with ``negative=0``, one epoch) for the fit's wall time and
HS pair-updates a second.  Prints one JSON line a tree (times, errors,
ptxas's registers and spills of K8's kernels), then the card's name and
power limit.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the change's ptxas reader, for every tree)

PROGRAM = r"""
import json, os, sys
tree = sys.argv[1]
sys.path.insert(0, tree)
os.chdir(tree)
import numpy as np
import torch
import chip_smoke as cs
from node2vec_torch import _build
from node2vec_torch.constants import Node2VecParams, Word2VecParams
from node2vec_torch.datasets import synthetic_multilabel
from node2vec_torch.graph import build_graph
from node2vec_torch.models import hsoftmax as hs
from node2vec_torch.models.word2vec import _effective_batch
from node2vec_torch.walk import WalkEngine

torch.backends.cuda.matmul.allow_tf32 = False
out = {"tree": tree}


def row(name, r, key):
    out[name] = {k: r[key].get(k) for k in ("ms", "bound_ms", "library_ms", "max_abs_err",
                                            "staging")}


src, dst = cs.smoke_edges(131072, 2_097_152)
g = build_graph((src, dst), directed=False)
tree_, counts = cs.hs_tree(g)
head = hs.head_level_offsets(tree_, table_rows=tree_.n_inner)
hs_batch = _effective_batch(8192, 131072, target_updates=51)
chunk0 = WalkEngine(g, Node2VecParams(**cs.N2V_MAIN), device="cuda").chunk_source(seed=0)[2](0)
hs_walks = chunk0.cpu().numpy()[np.random.default_rng(0).permutation(len(chunk0))]
del chunk0
r = {}
cs.check_hs(tree_, counts, hs_batch, 21, 128, 5, head, True, True, r, walks=hs_walks)
row("k8_direct", r, "hs_grads")
row("k3_hs", r, "adagrad_accumulate_hs")
r = {}
cs.check_hs(tree_, counts, 256, 21, 768, 5, head, True, True, r, case="dim 768", walks=hs_walks)
row("k8_chunked", r, "hs_grads")
r = {}
cs.check_route(tree_, head, hs_walks[:hs_batch], 131072, True, r, "main_path_mesh_row batch")
row("k8_routed", r, "hs_grads_routed")
r = {}
cs.check_cbow(tree_, counts, hs_batch, 21, 128, 5, True, True, True, r, walks=hs_walks)
row("k3_cbow_hs", r, "adagrad_accumulate_cbow_hs")
r = {}
cs.check_sgns(131072, 2560, 21, 128, 5, 64, True, r)
row("k3_sgns", r, "adagrad_accumulate")
r = {}
cs.check_pairs(131072, 2560, 21, 128, 5, True, r, "random walks, dead tails")
row("k3_pairs", r, "adagrad_accumulate_pairs")
# main_path_wide's K8 batch: the quality graph's corpus of 80-step walks
l1, d, w = 81, 256, 10
g_q, _ = synthetic_multilabel(2000, seed=0)
corpus = WalkEngine(g_q, Node2VecParams(num_walks=8, walk_length=l1 - 1),
                    device="cuda").run_device(seed=0).cpu().numpy()
q_counts = np.bincount(corpus[corpus >= 0], minlength=g_q.n_vertices)
q_tree = hs.cap_code_length(hs.build_huffman(q_counts), q_counts,
                            max_len=Word2VecParams().hs_max_code_length or None)
corpus = corpus[np.random.default_rng(0).permutation(len(corpus))]
q_b = _effective_batch(Word2VecParams().batch_walks, len(corpus))
r = {}
cs.check_hs(q_tree, q_counts, q_b, l1, d, w, hs.head_level_offsets(q_tree, table_rows=q_tree.n_inner),
            True, True, r, case="wide", walks=corpus)
row("k8_wide", r, "hs_grads")
del g
mp = cs.main_path_streamed(src, dst, 1, "main_path_hs", {"negative": 0}, "hs_grads")
out["main_path_hs"] = {k: mp.get(k) for k in ("fit_s", "hs_pair_updates_per_fit_s",
                                              "launches")}
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
        row["ptxas"] = {k: v for k, v in chip_smoke.ptxas_summary(
            row.pop("ptxas_report"), "hs_grads_kernel").items() if "cbow" not in k}
        launches = row["main_path_hs"].pop("launches", None) or {}
        row["main_path_hs"]["launches"] = {k: launches.get(k) for k in
                                           ("hs_grads", "adagrad_accumulate", "adagrad_apply")}
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
