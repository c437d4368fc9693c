#!/usr/bin/env python3
"""A/B of K16 ``col_pair_logits`` and K17 ``col_pair_grads`` between source
trees, on one card.

    python3 experiments/ab_col_sgns_kernels.py TREE [TREE ...]

Each TREE is the root of a checkout (this repository's, or an unpacked
``git archive`` of another commit).  The trees run one after another, in
the order given (e.g. parent, change, change, parent), each in a process of
its own that builds that tree's kernels into its own ``build/`` and times
them through that tree's own ``chip_smoke.py`` check, which also holds each
kernel to its plain version (``_variants.run_trees``):

* ``k16_main``, ``k17_main``: K16 and K17 on ``main_path_mesh``'s batch
  (the first batch of the Quickstart walks' epoch on the dense graph,
  ``main_path_pairs batch 0``: 2,560 walks of 21, Dm = 128, S = 64, w = 5),
  through ``check_col_sgns``, with their bounds from that run's data and
  their plain versions' times;
* ``k16_dm64``, ``k17_dm64``: the same check at Dm = 64 (the first of two
  model coordinates' column slices);
* ``k16_global``, ``k17_global``: the same batch at Dm = 128 with every
  wrapper's staging forced into a global workspace, timed alike in every
  tree (CUDA events over 10 calls of the wrapper) and held to the plain
  versions;
* ``main_path_mesh``: ``Node2Vec(mesh=make_mesh(1, 1))`` through
  ``run_pipeline()`` on the dense graph at main_path's parameters (one
  epoch): the fit's seconds, then a second, profiled ``fit_sharded`` (wall,
  device busy, idle share, the top kernels' device time).

Prints one JSON line a tree (times, bounds, errors, staging, ptxas's
registers and spills of every K16 and K17 kernel), then the card's name and
power limit.  The port never imports this script.
"""

import json
import os
import sys

from _variants import ROOT, card, run_trees

sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the change's ptxas reader, for every tree)

PROGRAM = r"""
import contextlib, io, json, os, sys, time
tree = sys.argv[1]
sys.path.insert(0, tree)
os.chdir(tree)
import numpy as np
import torch
import chip_smoke as cs
from node2vec_torch import _build, Node2Vec
from node2vec_torch.graph import build_graph
from node2vec_torch.models import skipgram as sg
from node2vec_torch.parallel import make_mesh
from node2vec_torch.parallel import sharded_sgns as col

torch.backends.cuda.matmul.allow_tf32 = False
# build this tree's kernels in this process, so that ptxas's report is read
from node2vec_torch.native import build_dir
if os.path.exists(os.path.join(build_dir(), "libn2v_kernels.so")):
    os.remove(os.path.join(build_dir(), "libn2v_kernels.so"))
_build.lib()
out = {"tree": tree}
lines = []


def quiet(fn, *args, **kwargs):
    # run a check, keeping its JSON lines
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = fn(*args, **kwargs)
    lines.extend(json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{"))
    return value


KEYS = ("ms", "bound_ms", "bound_by", "plain_ms", "max_abs_err", "staging", "valid_lanes")
src, dst = cs.smoke_edges(131072, 2_097_152)
g = build_graph((src, dst), directed=False)
ep = cs._pair_epoch(g)
first = (ep["corpus"][:ep["batch"]].contiguous(), ep["tables"][2])
del ep
mesh = make_mesh(1, 1, device="cuda")
case = "main_path_pairs batch 0"
quiet(cs.check_col_sgns, mesh, 131072, first[0].shape[0], 21, 128, 5, True, {}, case, batch=first)
for ln in lines:
    if ln.get("phase") == "check" and ln.get("case") == case and ln.get("Dm") in (128, 64):
        kern = {"col_pair_logits": "k16", "col_pair_grads": "k17"}.get(ln["kernel"])
        if kern:
            out[f"{kern}_{'main' if ln['Dm'] == 128 else 'dm64'}"] = {k: ln.get(k) for k in KEYS}

# the same batch in global staging
inp = cs._batch_inputs(131072, first[0].shape[0], 21, 128, 5, 11, 0.1, first)
walks, mask, neg, b_sh = inp["walks"], inp["mask"], inp["neg"], inp["b_sh"]
pc, px = sg.pair_lists_plain(walks, b_sh, mask, 5)
e_in, e_out = inp["state"][:2]
staging = _build.staging


def forced(smem, n_walks, device):
    props = torch.cuda.get_device_properties(device)
    blocks = max(1, min(int(n_walks),
                        _build.STAGING_BLOCKS_PER_SM * props.multi_processor_count))
    return torch.empty(blocks * _build.staging_stride(smem), dtype=torch.float32,
                       device=device), blocks


kw = dict(window=5, negatives=5)
logits = col.col_pair_logits_plain(e_in, e_out, walks, pc, px, neg, window=5)
want16 = logits
want17 = col.col_pair_grads_plain(e_in, e_out, walks, pc, px, neg, logits, **kw)
before = _build.launches.copy()
_build.staging = forced
try:
    got16 = col.col_pair_logits(e_in, e_out, walks, pc, px, neg, window=5)
    got17 = col.col_pair_grads(e_in, e_out, walks, pc, px, neg, logits, **kw)
    err16 = cs._close("col_pair_logits[global]", got16, want16)
    err17 = max(cs._close("col_pair_grads[global, d_ci]", got17[0], want17[0]),
                cs._close("col_pair_grads[global, d_co]", got17[1], want17[1]),
                cs._close_to_largest("col_pair_grads[global, d_no]", got17[2], want17[2]),
                cs._close_to_largest("col_pair_grads[global, squares]", got17[3], want17[3]))
    ms16 = cs.time_ms(lambda: col.col_pair_logits(e_in, e_out, walks, pc, px, neg, window=5))
    ms17 = cs.time_ms(lambda: col.col_pair_grads(e_in, e_out, walks, pc, px, neg, logits, **kw))
finally:
    _build.staging = staging
glob = {k: _build.launches[f"{k}_global"] - before[f"{k}_global"]
        for k in ("col_pair_logits", "col_pair_grads")}
out["k16_global"] = {"ms": ms16, "max_abs_err": err16, "global_launches": glob["col_pair_logits"]}
out["k17_global"] = {"ms": ms17, "max_abs_err": err17, "global_launches": glob["col_pair_grads"]}
for k in ("k16_main", "k17_main"):
    if k in out:
        out[k.replace("main", "global")]["bound_ms"] = out[k]["bound_ms"]
del inp, e_in, e_out, logits, want16, want17, got16, got17, first

# main_path_mesh's fit and its profiled second fit
n2v = Node2Vec(n2v_params=cs.N2V_MAIN, w2v_params={**cs.W2V_MAIN, "max_iter": 1},
               random_seed=0, mesh=mesh, device="cuda")
graph = n2v.preprocess_input_graph((src, dst), indexed=True, directed=False)
fit_s = []
new_backend = n2v._new_backend


def timed_backend(*args, **kwargs):
    backend = new_backend(*args, **kwargs)
    cs._timed_fit(backend.model, fit_s)
    return backend


n2v._new_backend = timed_backend
model = n2v.run_pipeline()
del model.fit_sharded, n2v._new_backend
walks_np = n2v.walks
prof = quiet(cs.breakdown, (("fit_sharded (1 x 1)",
                             lambda: model.fit_sharded(walks_np, mesh,
                                                       n_vertices=graph.n_vertices)),))[0]
out["main_path_mesh"] = {"fit_s": fit_s[0], "losses": model.losses,
                         **{k: prof.get(k) for k in ("wall_ms", "device_busy_ms", "idle_share",
                                                     "top_device_ms")}}
torch.distributed.destroy_process_group()
out["ptxas_report"] = _build.ptxas_report
print("AB " + json.dumps(out), flush=True)
"""


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for row in run_trees(trees, PROGRAM):
        report = row.pop("ptxas_report")
        row["ptxas"] = chip_smoke.ptxas_summary(report, "col_pair_")
        if not row["ptxas"]:  # the parent's logits_kernel and grads_kernel, staged or not
            row["ptxas"] = {k: v for k, v in chip_smoke.ptxas_summary(report, "_kernel").items()
                            if any(p in k for p in ("13logits_kernelE", "20logits_kernel_staged",
                                                    "12grads_kernelE", "19grads_kernel_staged"))}
        print(json.dumps(row), flush=True)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
