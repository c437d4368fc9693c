#!/usr/bin/env python3
"""A/B of K12 ``csr_walk`` and K19's pack (``route_pack``) between source
trees, on one card.

    python3 experiments/ab_csr_route_kernels.py TREE [TREE ...]

Each TREE is the root of a checkout (this repository's, or an unpacked
``git archive`` of another commit).  The trees run one after another, in
the order given (e.g. parent, change, change, parent), each in a process of
its own that builds that tree's kernels into its own ``build/`` and calls
them through that tree's wrappers, on inputs made by that tree's
``chip_smoke.py`` helpers:

* ``k12``: K12 at ``main_path_csr``'s launch (the scale-19 RMAT, 131,072
  walkers of 20) at (p, q) = (0.25, 4) and (1, 1), each held bit-equal to
  the tree's plain version; CUDA events over 10 launches;
* ``main_path_csr_walk``: ``WalkEngine(rmat, strategy="csr").run_device()``,
  its 40 launches, wall seconds (after a first run that uploads the graph);
* ``k19_plan_out``, ``k19_plan_th``: K19's pack on ``pack_attribution``'s
  ``pack_cases`` (``main_path_mesh_row``'s SGNS ``plan_out``, R = 54,034 at
  N = 1, and HS's ``plan_th``, R = 485,730): the time of a call (its
  buffer's allocation included), the largest error against the plain
  version (to rtol 1e-4 of its largest entry), whether two calls give equal
  buffers, and beside it
  ``index_add_`` of the live rows into a buffer that ``torch.zeros`` makes in
  the same timed call (both write the whole [N * cap, D + 1] buffer).

Prints one JSON line a tree (with ptxas's registers and spills of K12's and
K19's kernels), then the card's name and power limit.  The port never
imports this script.
"""

import json
import sys

from _variants import ROOT, card, run_trees

sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the change's ptxas reader, for every tree)

PROGRAM = r"""
import json, os, sys, time
tree = sys.argv[1]
sys.path.insert(0, tree)
sys.path.insert(1, os.path.join(%(root)r, "experiments"))
os.chdir(tree)
import numpy as np
import torch
import chip_smoke as cs
import pack_attribution as pa
from node2vec_torch import _build
from node2vec_torch.constants import Node2VecParams
from node2vec_torch.native import build_dir
from node2vec_torch.parallel import rowsharded_sgns as rs
from node2vec_torch.walk import WalkEngine, csr

if os.path.exists(os.path.join(build_dir(), "libn2v_kernels.so")):
    os.remove(os.path.join(build_dir(), "libn2v_kernels.so"))
_build.lib()
dev = torch.device("cuda")
out = {"tree": tree}

_, _, g = cs.rmat_graph(19)
dg = g.to_device(dev)
iters = csr.search_iters(int(np.diff(g.indptr).max()))
starts = torch.remainder(torch.arange(131072, dtype=torch.int32, device=dev), g.n_vertices)
for p, q in ((0.25, 4.0), (1.0, 1.0)):
    kw = dict(walk_length=20, return_param=p, inout_param=q, max_trials=64, search_iters=iters)
    got = csr.csr_walk_chunk(*dg, starts, 0, 0, **kw)
    want = csr.csr_walk_chunk_plain(*dg, starts, 0, 0, **kw)
    out[f"k12 ({p}, {q})"] = {"bit_equal": bool(torch.equal(got, want)),
                              "ms": cs.time_ms(lambda: csr.csr_walk_chunk(*dg, starts, 0, 0, **kw))}
del want
engine = WalkEngine(g, Node2VecParams(**cs.N2V_MAIN), strategy="csr", device="cuda")
engine.run_device(seed=0)
torch.cuda.synchronize()
before = _build.launches["csr_walk"]
t0 = time.perf_counter()
walks = engine.run_device(seed=0)
torch.cuda.synchronize()
out["main_path_csr_walk"] = {"walk_s": time.perf_counter() - t0,
                             "launches": _build.launches["csr_walk"] - before,
                             "walk_steps": int((walks[:, 1:] >= 0).sum())}
del walks, engine, dg

cases = pa.pack_cases()
for case, (plan, cap, args) in cases.items():
    key = "k19_" + case
    got = rs.route_pack(plan, 1, cap, *args)
    again = rs.route_pack(plan, 1, cap, *args)
    want = rs.route_pack_plain(plan, 1, cap, *args)
    err = float((got - want).abs().max())
    g_a, live_a, g_b, live_b = args
    g_all = g_a if g_b is None else torch.cat([g_a, g_b])
    live = (live_a >= 0).float()
    if g_b is not None:
        live = torch.cat([live, torch.ones(g_b.shape[0], device=dev)])
    rows_plus = torch.cat([g_all, (g_all * g_all).mean(-1, keepdim=True)], dim=1) * live[:, None]
    slots = plan.slot.long()
    keep = (slots >= 0) & (live > 0)
    sel_slots, sel_rows = slots[keep], rows_plus[keep]
    out[key] = {"R": int(plan.uniq.shape[0]), "cap": cap, "n_uniq": int(plan.n_uniq),
                "live_rows": int(keep.sum()), "max_abs_err": err,
                "within_rtol": err <= cs.RTOL * float(want.abs().max()),
                "two_calls_equal": bool(torch.equal(got, again)),
                "ms": cs.time_ms(lambda: rs.route_pack(plan, 1, cap, *args), reps=20),
                "index_add_ms": cs.time_ms(lambda: torch.zeros_like(want).index_add_(
                    0, sel_slots, sel_rows), reps=20)}
out["ptxas_report"] = _build.ptxas_report
print("AB " + json.dumps(out), flush=True)
""" % {"root": ROOT}


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for row in run_trees(trees, PROGRAM, timeout=1200):
        report = row.pop("ptxas_report")
        row["ptxas"] = {**chip_smoke.ptxas_summary(report, "csr_walk"),
                        **chip_smoke.ptxas_summary(report, "pack_kernel")}
        print(json.dumps(row), flush=True)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
