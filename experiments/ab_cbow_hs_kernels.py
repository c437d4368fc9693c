#!/usr/bin/env python3
"""A/B of K10 ``cbow_hs_grads``, K4 ``adagrad_apply`` and the CBOW-HS step
between source trees, on one card.

    python3 experiments/ab_cbow_hs_kernels.py TREE [TREE ...]

Each TREE is the root of a checkout (this repository's, or an unpacked
``git archive`` of another commit).  The trees run one after another, in
the order given (e.g. parent, change, change, parent), each in a process of
its own that builds that tree's kernels into its own ``build/`` and times
them through that tree's own ``chip_smoke.py`` checks, which also hold each
kernel to its plain version:

* ``k10_main``: K10 on ``main_path_cbow_hs``'s batch (2,570 walks of the
  dense graph's first chunk, shuffled; L1 = 21, D = 128, w = 5,
  cbow_mean), ``check_cbow``, with K3 and K4 on the CBOW-HS lists the
  tree's step takes (``k3_cbow_hs``, ``k4_cbow_hs``) and, where the tree has
  them, on the per-occurrence lists (``k4_cbow_hs_occurrences``);
* ``k10_wide``: K10 at ``main_path_wide``'s shape (B = 64 of the quality
  graph's corpus, L1 = 81, D = 512, w = 10), with the staging it took;
* ``k10_global``: K10 in global staging in every tree (B = 64 random walks
  of 121, D = 512, w = 10);
* ``step``: ``cbow_hs_step`` (the tree's K10 and Adagrad launches of one
  step, and their small tensor operations) on the ``k10_main`` inputs,
  timed the same way in every tree;
* K4 on the SGNS step's lists (``k4_sgns``, B = 2,560 random walks,
  ``check_sgns``), HS's (``k4_hs``, ``check_hs`` on the same walks as
  ``k10_main``), the pair step's (``k4_pairs``, ``main_path_pairs``' first
  batch, ``check_pairs``) and K11's pre-aggregated lists (``k4_preagg``,
  ``check_preagg`` on ``main_path_sgd``'s batch), each with its
  ``index_add_`` yardstick where the check has one.

Then ``main_path_cbow_hs`` (``fit_host`` with CBOW-HS, one epoch) for the
fit's seconds, center-updates a second and the profiled fit's idle share,
and the CBOW-HS quality gate (streamed, AUC >= 0.55, gap >= 0.033).
Prints one JSON line a tree (times, bounds, errors, staging, ptxas's
registers and spills of every K10 and K4 instantiation), then the card's
name and power limit.  The port never imports this script.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the change's ptxas reader, for every tree)

PROGRAM = r"""
import contextlib, inspect, io, json, os, sys
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
from node2vec_torch.models import cbow
from node2vec_torch.models import hsoftmax as hs
from node2vec_torch.models.word2vec import _effective_batch
from node2vec_torch.walk import WalkEngine

torch.backends.cuda.matmul.allow_tf32 = False
# build this tree's kernels in this process, so that ptxas's report is read
from node2vec_torch.native import build_dir
if os.path.exists(os.path.join(build_dir(), "libn2v_kernels.so")):
    os.remove(os.path.join(build_dir(), "libn2v_kernels.so"))
_build.lib()
out = {"tree": tree}
lines = []


def quiet(fn, *args, **kwargs):
    # run a check, keeping its JSON lines for what its results do not hold
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = fn(*args, **kwargs)
    lines.extend(json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{"))
    return value


def row(name, r, key):
    if key in r:
        out[name] = {k: r[key].get(k) for k in ("ms", "bound_ms", "plain_ms", "library_ms",
                                                "max_abs_err", "staging")}


src, dst = cs.smoke_edges(131072, 2_097_152)
g = build_graph((src, dst), directed=False)
tree_, counts = cs.hs_tree(g)
batch = _effective_batch(8192, 131072, target_updates=51)
chunk0 = WalkEngine(g, Node2VecParams(**cs.N2V_MAIN), device="cuda").chunk_source(seed=0)[2](0)
walks = chunk0.cpu().numpy()[np.random.default_rng(0).permutation(len(chunk0))]
del chunk0
r = {}
quiet(cs.check_cbow, tree_, counts, batch, 21, 128, 5, True, True, True, r, walks=walks)
row("k10_main", r, "cbow_hs_grads")
row("k3_cbow_hs", r, "adagrad_accumulate_cbow_hs")
row("k4_cbow_hs", r, "adagrad_apply_cbow_hs")
row("k4_cbow_hs_occurrences", r, "adagrad_apply_cbow_hs_occurrences")
row("step_check", r, "cbow_hs_step")
inp = cs._cbow_inputs(tree_, counts, batch, 21, 128, 5, seed=6, walks=walks)
state = [x.clone() for x in inp["hs"]]
step_args = (inp["walks"], inp["b_sh"], 0.05, *inp["tables"], inp["mask"])
out["step"] = {"ms": cs.time_ms(lambda: cbow.cbow_hs_step(*state, *step_args, window=5,
                                                          cbow_mean=True), reps=20)}
del inp, state
# main_path_wide's K10 batch, then global staging in every tree
g_q, _ = synthetic_multilabel(2000, seed=0)
corpus = WalkEngine(g_q, Node2VecParams(num_walks=8, walk_length=80),
                    device="cuda").run_device(seed=0).cpu().numpy()
q_counts = np.bincount(corpus[corpus >= 0], minlength=g_q.n_vertices)
q_tree = hs.cap_code_length(hs.build_huffman(q_counts), q_counts,
                            max_len=Word2VecParams().hs_max_code_length or None)
corpus = corpus[np.random.default_rng(0).permutation(len(corpus))]
q_b = _effective_batch(Word2VecParams().batch_walks, len(corpus))
r = {}
quiet(cs.check_cbow, q_tree, q_counts, q_b, 81, 512, 10, True, True, True, r, case="wide",
      walks=corpus)
row("k10_wide", r, "cbow_hs_grads")
r = {}
quiet(cs.check_cbow, tree_, counts, 64, 121, 512, 10, True, True, True, r, case="global")
row("k10_global", r, "cbow_hs_grads")
r = {}
quiet(cs.check_sgns, 131072, 2560, 21, 128, 5, 64, True, r)
row("k4_sgns", r, "adagrad_apply")
r = {}
quiet(cs.check_hs, tree_, counts, batch, 21, 128, 5,
      hs.head_level_offsets(tree_, table_rows=tree_.n_inner), True, True, r, walks=walks)
row("k4_hs", r, "adagrad_apply_hs")
ep = cs._pair_epoch(g)
first = (ep["corpus"][:ep["batch"]].contiguous(), ep["tables"][2])
del ep
r = {}
quiet(cs.check_pairs, 131072, 2560, 21, 128, 5, True, r, "main_path_pairs batch 0", batch=first)
row("k4_pairs", r, "adagrad_apply_pairs")
r = {}
quiet(cs.check_preagg, 131072, walks[:batch], 128, 5, True, r, "main_path_sgd batch")
pre = [ln for ln in lines if ln.get("adagrad_apply_preagg_ms") is not None]
out["k4_preagg"] = {"ms": pre[-1]["adagrad_apply_preagg_ms"]} if pre else None
del g, first
# main_path_cbow_hs: fit_host with CBOW-HS, its profiled fit's idle share
kw = {}
if "update" in inspect.signature(cs.main_path_host).parameters:
    kw["update"] = cs.CBOW_HS_UPDATE
mp = quiet(cs.main_path_host, src, dst, 1, "main_path_cbow_hs", {"sg": 0, "negative": 0},
           "cbow_hs_grads", **kw)[0]
bd = [ln for ln in lines if ln.get("phase") == "breakdown"]
out["main_path_cbow_hs"] = {k: mp.get(k) for k in ("fit_s", "cbow_center_updates_per_fit_s")}
out["main_path_cbow_hs"].update({k: bd[-1].get(k) for k in ("wall_ms", "device_busy_ms",
                                                             "idle_share", "top_device_ms")})
gate = quiet(cs.quality_gates, trainer="run_pipeline", walker_chunk=2048, negative=0, sg_arch=0,
             auc_min=0.55, gap_min=0.033)
out["gate_cbow_hs"] = {k: gate.get(k) for k in ("holdout_link_auc", "auc_min",
                                                  "label_cosine_gap", "gap_min")}
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
        row["ptxas"] = {**chip_smoke.ptxas_summary(report, "cbow_hs_grads_kernel"),
                        **chip_smoke.ptxas_summary(report, "adagrad_apply_kernel")}
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
