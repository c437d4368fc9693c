#!/usr/bin/env python3
"""A/B of K9 ``cbow_grads`` and K13 ``sgns_pair_grads`` between source trees,
on one card.

    python3 experiments/ab_cbow_pair_kernels.py TREE [TREE ...]

Each TREE is the root of a checkout (this repository's, or an unpacked
``git archive`` of another commit).  The trees run one after another, in
the order given (e.g. parent, change, change, parent), each in a process of
its own that builds that tree's kernels into its own ``build/`` and times
them through that tree's own ``chip_smoke.py`` checks, which also hold each
kernel to its plain version:

* ``k9_main``: K9 on ``main_path_cbow``'s batch (2,570 walks of the dense
  graph's first chunk, shuffled; L1 = 21, D = 128, S = 64, w = 5,
  cbow_mean), ``check_cbow``;
* ``k9_wide``: K9 in global staging at ``main_path_wide``'s shape (B = 64 of
  the quality graph's corpus, L1 = 81, D = 256, w = 10);
* ``k13_main``: K13 on ``main_path_pairs``' first batch (2,560 walks),
  ``check_pairs``;
* ``k13_wide``: K13 in global staging at ``main_path_wide``'s shape (the
  first B = 256 of the dense graph's walks of 80, D = 256, w = 10);
* ``k2_main``: K2 at its main shape (B = 2,560 random walks with dead
  tails), ``check_sgns``, to hold the shared tile machinery.

Then ``main_path_cbow`` (the streamed CBOW-NS pipeline, one epoch) for the
fit's wall time and ``main_path_pairs`` (one epoch of ``sgns_train_step``)
for its train time.  Beside each kernel, ``neg_gemm_ms``: the three fp32
``torch.matmul`` products of the negative half (X . NO^T, G . NO, G^T . X
over the batch's positions) at the same shape, a partial yardstick the port
never calls.  Prints one JSON line a tree (times, bounds, errors, staging,
ptxas's registers and spills and the HMMA counts of the three kernels),
then the card's name and power limit.  The port never imports this script.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the change's ptxas and SASS readers, for every tree)

KERNELS = ("sgns_grads_kernel", "cbow_grads_kernel", "pair_grads_kernel")

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
from node2vec_torch.models.vocab import build_vocab
from node2vec_torch.walk import WalkEngine

torch.backends.cuda.matmul.allow_tf32 = False
out = {"tree": tree}


def row(name, r, key, n_rows):
    x = r[key]
    out[name] = {k: x.get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                                       "staging")}
    out[name]["neg_gemm_ms"] = cs.neg_gemm_ms(n_rows, r["_dim"], 64)


src, dst = cs.smoke_edges(131072, 2_097_152)
g = build_graph((src, dst), directed=False)
tree_, counts = cs.hs_tree(g)
hs_batch = cs._effective_batch(8192, 131072, target_updates=51)
chunk0 = WalkEngine(g, Node2VecParams(**cs.N2V_MAIN), device="cuda").chunk_source(seed=0)[2](0)
hs_walks = chunk0.cpu().numpy()[np.random.default_rng(0).permutation(len(chunk0))]
del chunk0
r = {"_dim": 128}
cs.check_cbow(tree_, counts, hs_batch, 21, 128, 5, True, True, True, r, walks=hs_walks)
row("k9_main", r, "cbow_grads", hs_batch * 21)

# main_path_wide's shapes (check_wide): the quality corpus for K9, the dense
# graph's walks of 80 for K13
w2v = Word2VecParams()
g_q, _ = synthetic_multilabel(2000, seed=0)
corpus = WalkEngine(g_q, Node2VecParams(num_walks=8, walk_length=80),
                    device="cuda").run_device(seed=0).cpu().numpy()
q_counts = np.bincount(corpus[corpus >= 0], minlength=g_q.n_vertices)
q_tree = hs.cap_code_length(hs.build_huffman(q_counts), q_counts,
                            max_len=w2v.hs_max_code_length or None)
corpus = corpus[np.random.default_rng(0).permutation(len(corpus))]
q_b = cs._effective_batch(w2v.batch_walks, len(corpus))
r = {"_dim": 256}
cs.check_cbow(q_tree, q_counts, q_b, 81, 256, 10, True, True, True, r, case="wide", walks=corpus)
row("k9_wide", r, "cbow_grads", q_b * 81)
pair_walks = WalkEngine(g, Node2VecParams(num_walks=1, walk_length=80),
                        device="cuda").run_device(seed=0)
pair_mask = torch.from_numpy(build_vocab(pair_walks, g.n_vertices, min_count=1).mask)
wide_batch = (pair_walks[:256].contiguous(), pair_mask.to(pair_walks.device))
del pair_walks
r = {"_dim": 256}
cs.check_pairs(g.n_vertices, 256, 81, 256, 10, True, r, "wide", batch=wide_batch)
row("k13_wide", r, "sgns_pair_grads", 256 * 81)

ep = cs._pair_epoch(g)
first = (ep["corpus"][:ep["batch"]].contiguous(), ep["tables"][2])
del ep
r = {"_dim": 128}
cs.check_pairs(131072, 2560, 21, 128, 5, True, r, "main_path_pairs batch 0", batch=first)
row("k13_main", r, "sgns_pair_grads", 2560 * 21)
del first
r = {"_dim": 128}
cs.check_sgns(131072, 2560, 21, 128, 5, 64, True, r)
row("k2_main", r, "sgns_grads", 2560 * 21)

mp = cs.main_path_streamed(src, dst, 1, "main_path_cbow", {"sg": 0}, "cbow_grads")
out["main_path_cbow"] = {k: mp.get(k) for k in ("fit_s", "cbow_center_updates_per_fit_s")}
mp, _ = cs.main_path_pairs(g)
out["main_path_pairs"] = {k: mp.get(k) for k in ("train_s", "pair_updates_per_s",
                                                  "loss_first_step", "loss_last_step")}
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
        report = row.pop("ptxas_report")
        lib = os.path.join(tree, "build", "node2vec_torch", "libn2v_kernels.so")
        for part in KERNELS:
            row[f"ptxas {part}"] = chip_smoke.ptxas_summary(report, part)
            row[f"sass {part}"] = chip_smoke.sass_counts(lib, part)
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
