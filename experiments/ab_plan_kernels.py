#!/usr/bin/env python3
"""A/B of K20 ``ep_bucket`` and K18 ``route_plan`` between source trees, on
one card.

    python3 experiments/ab_plan_kernels.py TREE [TREE ...]

Each TREE is the root of a checkout (this repository's, or an unpacked
``git archive`` of another commit).  The trees run one after another, in
the order given (e.g. parent, change, change, parent), each in a process of
its own that builds that tree's kernels into its own ``build/`` and calls
them through that tree's wrappers, on inputs made by that tree's
``chip_smoke.py`` helpers (``plan_attribution.k20_calls``,
``k18_requests``), each result held bit-equal to the tree's plain version:

* ``k20_second``, ``k20_late``: K20 at ``main_path_ep``'s first chunk, a
  superstep's two calls (phases A and B; CUDA events over 20 supersteps) at
  the second superstep and at the first with under 10% of the lanes
  active, with the launches and device busy time of a traced superstep and
  the host time a superstep's calls take to enqueue;
* ``k18_plan_out``, ``k18_plan_th``: K18 at ``main_path_mesh_row``'s SGNS
  ``plan_out`` (R = 54,034, N = 1) and HS's ``plan_th``, with its launches
  and busy time, its host time a call, and
  ``torch.unique(sorted=True, return_inverse=True)`` on
  the same ids as a yardstick of the deduplication alone;
* ``main_path_ep``: ``Node2Vec(mesh=make_mesh(1, 1), graph_sharded=True)``
  on the scale-19 RMAT, 4 chunks walked under torch.profiler (wall, device
  busy, idle share);
* ``main_path_mesh_row``: the tree's own ``main_path_mesh_row`` (SGNS,
  ``fit_streaming_sharded``), its fit and its profiled fit's wall, device
  busy and idle share.

Prints one JSON line a tree (and ptxas's registers and spills of K20's and
K18's kernels), then the card's name and power limit.  The port never
imports this script.
"""

import json
import os
import sys

from _variants import ROOT, card, run_trees

sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the change's ptxas reader, for every tree)

PROGRAM = r"""
import contextlib, io, json, os, sys
tree = sys.argv[1]
sys.path.insert(0, tree)
sys.path.insert(1, os.path.join(%(root)r, "experiments"))
os.chdir(tree)
import torch
import chip_smoke as cs
import plan_attribution as pa
from node2vec_torch import _build, Node2Vec
from node2vec_torch.native import build_dir
from node2vec_torch.parallel import edge_partitioned_blocked as ep
from node2vec_torch.parallel import make_mesh
from node2vec_torch.parallel import rowsharded_sgns as rs

# build this tree's kernels in this process, so that ptxas's report is read
if os.path.exists(os.path.join(build_dir(), "libn2v_kernels.so")):
    os.remove(os.path.join(build_dir(), "libn2v_kernels.so"))
_build.lib()
out = {"tree": tree}
lines = []


def quiet(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = fn(*args, **kwargs)
    lines.extend(json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{"))
    return value


def traced(fn):
    t = pa.launch_trace(torch, fn)
    return {k: t.get(k) for k in ("launches", "busy_us", "span_us", "launch_us", "gaps_us")}


got, late = pa.k20_calls()
for key, calls in sorted(got.items()):
    def superstep_calls(calls=calls):
        return [ep.ep_bucket(c, seed, gid, **kw) for c, seed, gid, kw in calls]

    equal = all(torch.equal(a, b) for (c, seed, gid, kw), res in zip(calls, superstep_calls())
                for a, b in zip(res, ep.ep_bucket_plain(c, seed, gid, **kw)))
    c0 = calls[0][0]
    out["k20_" + key] = {
        "superstep": 1 if key == "second" else late[0],
        "active_lanes": int(((c0[ep.ALIVE] != 0) & (c0[ep.T] < pa.WALK_LENGTH)).sum()),
        "ms": cs.time_ms(superstep_calls, reps=20), "bit_equal": equal,
        "host_us": pa.host_us(torch, superstep_calls),
        **traced(superstep_calls)}
del got

for case, ids, cap in pa.k18_requests():
    key = "k18_plan_out" if "plan_out" in case else "k18_plan_th"
    got = rs.plan_routes(ids, 1, cap)
    want = rs.plan_routes_plain(ids, 1, cap)
    out[key] = {"R": int(ids.shape[0]), "n_uniq": int(got.n_uniq),
                "bit_equal": all(torch.equal(getattr(got, f), getattr(want, f))
                                 for f in rs.RoutePlan._fields),
                "ms": cs.time_ms(lambda: rs.plan_routes(ids, 1, cap), reps=20),
                "host_us": pa.host_us(torch, lambda: rs.plan_routes(ids, 1, cap)),
                "torch_unique_ms": cs.time_ms(
                    lambda: torch.unique(ids, sorted=True, return_inverse=True), reps=20),
                **traced(lambda: rs.plan_routes(ids, 1, cap))}

mesh = make_mesh(1, 1, device="cuda")
rmat_src, rmat_dst, _ = cs.rmat_graph(19)
n2v = Node2Vec(n2v_params=cs.N2V_MAIN, w2v_params={**cs.W2V_MAIN, "max_iter": 1},
               max_out_degree=10_000, random_seed=0, mesh=mesh, graph_sharded=True,
               device="cuda")
n2v.preprocess_input_graph((rmat_src, rmat_dst), indexed=True, directed=False)
engine = n2v._walk_engine()
_, _, source = engine.chunk_source(seed=0)
source(0)
prof = quiet(cs.breakdown, (("ep walk, 4 of the chunks (1 x 1)",
                             lambda: [source(i) for i in range(4)]),))[0]
out["main_path_ep"] = {k: prof.get(k) for k in ("wall_ms", "device_busy_ms", "idle_share")}
del engine, n2v, rmat_src, rmat_dst

src, dst = cs.smoke_edges(131072, 2_097_152)
row = quiet(cs.main_path_mesh_row, mesh, src, dst, 1, False, beside={})
fit = [ln for ln in lines if ln.get("phase") == "breakdown" and "row" in ln.get("stage", "")]
out["main_path_mesh_row"] = {"fit_s": row.get("fit_s"),
                             **{k: fit[-1].get(k) for k in ("wall_ms", "device_busy_ms",
                                                            "idle_share")}}
torch.distributed.destroy_process_group()
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
        row["ptxas"] = {**chip_smoke.ptxas_summary(report, "ep_bucket"),
                        **chip_smoke.ptxas_summary(report, "route_plan"),
                        **{k: v for k, v in chip_smoke.ptxas_summary(report, "_kernel").items()
                           if any(p in k for p in ("tile_sort", "merge_kernel", "head_count",
                                                   "slot_kernel", "owner_count", "rank_kernel",
                                                   "request_slot"))}}
        print(json.dumps(row), flush=True)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
