#!/usr/bin/env python3
"""A/B of K21 ``ep_propose`` and K11 ``preagg_rows`` between source trees, on
one card.

    python3 experiments/ab_propose_preagg.py TREE [TREE ...]

Each TREE is the root of a checkout (this repository's, or an unpacked
``git archive`` of another commit).  The trees run one after another, in the
order given (e.g. parent, change, change, parent), each in a process of its
own that builds that tree's kernels into its own ``build/`` and calls them
through that tree's wrappers, on inputs made by that tree's ``chip_smoke.py``
helpers (``propose_preagg_attribution.propose_calls``, ``preagg_inputs``):

* ``ep_propose``: K21 at every superstep of ``main_path_ep``'s first chunk
  (the scale-19 RMAT on the 1 x 1 mesh's one shard, 131,072 walkers of 20 at
  (0.25, 4)), each call timed (CUDA events, 20 calls) and held bit-equal to
  ``ep_propose_plain``: the second superstep's and the late superstep's (the
  first with under 10% of the walkers active) times and the sum over the
  chunk;
* ``ep_member``: K22 at the second superstep of the same chunk, and
  ``blocked_walk``: K5 on the same tables and walkers (the walk
  ``check_ep_walk`` holds the graph-sharded walk to), neither changed;
* ``preagg_rows``: K11 at ``main_path_sgd``'s batch (2,570 walks, D = 128),
  held to the plain version (heads and counts exact, sums to rtol of their
  largest entry, the slot map empty);
* ``main_path_ep``: ``Node2Vec(mesh=make_mesh(1, 1), graph_sharded=True)`` on
  the RMAT: the 40 chunks' walk wall (host clock, 5 times) and 4 chunks walked
  under torch.profiler (wall, device busy, idle share);
* ``sgd_fit``: ``main_path_sgd``'s streamed fit (the dense graph,
  optimizer="sgd", step_size 0.025, 10 chunks of 51 steps: K2, K11 and
  ``sgd_apply``), its wall (host clock, 5 times) and one profiled fit (wall,
  device busy, idle share).

Prints one JSON line a tree (with ptxas's registers and spills of K21, K22
and K11), then the card's name and power limit.  The port never imports
this script.
"""

import json
import sys

from _variants import ROOT, card, run_trees

sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the change's ptxas reader, for every tree)

PROGRAM = r"""
import contextlib, io, json, os, sys, time
tree = sys.argv[1]
sys.path.insert(0, tree)
sys.path.insert(1, os.path.join(%(root)r, "experiments"))
os.chdir(tree)
import torch
import chip_smoke as cs
import propose_preagg_attribution as pa
from node2vec_torch import _build, Node2Vec
from node2vec_torch.models import skipgram as sg
from node2vec_torch.models.word2vec import Word2VecTorch
from node2vec_torch.native import build_dir
from node2vec_torch.parallel import edge_partitioned_blocked as ep
from node2vec_torch.parallel import make_mesh
from node2vec_torch.walk import blocked

# build this tree's kernels in this process, so that ptxas's report is read
if os.path.exists(os.path.join(build_dir(), "libn2v_kernels.so")):
    os.remove(os.path.join(build_dir(), "libn2v_kernels.so"))
_build.lib()
out = {"tree": tree}
REPS = 5  # the host's clock moves between runs: each wall is taken 5 times


def quiet(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        return fn(*args, **kwargs)


def profiled(label, fn):
    line = quiet(cs.breakdown, ((label, fn),))[0]
    return {k: line.get(k) for k in ("wall_ms", "device_busy_ms", "idle_share")}


# K21 at every superstep of the chunk; K22 at the second; K5 on the same walkers
member_calls = []
member = ep._Kernels.member


def keep_member(recv, *tables, **kw):
    if len(member_calls) < 2:
        member_calls.append((recv.clone(), kw))
    return member(recv, *tables, **kw)


ep._Kernels.member = staticmethod(keep_member)
calls, tables, kw, active = pa.propose_calls()
ep._Kernels.member = staticmethod(member)
light, biw, bids, brp = tables
late = next(i for i, a in enumerate(active) if i > 1 and a < 0.1 * pa.WALKERS)
per_step, equal = [], True
for recv in calls:
    want = ep.ep_propose_plain(recv, light, biw, brp, **kw)
    equal &= bool(torch.equal(ep.ep_propose(recv, light, biw, brp, **kw), want))
    per_step.append(cs.time_ms(lambda: ep.ep_propose(recv, light, biw, brp, **kw), reps=20))
out["ep_propose"] = {"supersteps": len(calls), "ms_second": per_step[1], "late_superstep": late,
                     "ms_late": per_step[late], "ms_summed_over_the_chunk": sum(per_step),
                     "bit_equal_every_superstep": equal}
recv_b, kw_b = member_calls[1]
own = {k: kw_b[k] for k in ("my_shard", "rows_per_shard", "light_width", "block_width")}
out["ep_member"] = {
    "ms_second": cs.time_ms(lambda: ep.ep_member(recv_b, light, bids, **own), reps=20),
    "bit_equal": bool(torch.equal(ep.ep_member(recv_b, light, bids, **own),
                                  ep.ep_member_plain(recv_b, light, bids, **own)))}
# one shard: its rows are the graph's vertices, as check_ep_walk's K5 starts
starts = torch.arange(pa.WALKERS, dtype=torch.int32, device="cuda") %% kw["rows_per_shard"]
k5_kw = dict(walk_length=pa.WALK_LENGTH, return_param=pa.PQ[0], inout_param=pa.PQ[1],
             max_trials=64, light_width=kw["light_width"], block_width=kw["block_width"],
             has_heavy=True)
out["blocked_walk"] = {"ms": cs.time_ms(lambda: blocked.blocked_walk_chunk(
    *tables, starts, 0, 0, **k5_kw), reps=5)}
del calls, tables, light, biw, bids, brp, member_calls, recv_b

flat, g_in, g_out, n_v = pa.preagg_inputs()
want = sg.preagg_rows_plain(flat, g_in, g_out)
slot = sg.new_slot_map(n_v, flat.device)
got = sg.preagg_rows(flat, g_in, g_out, slot)
out["preagg_rows"] = {"ms": cs.time_ms(lambda: sg.preagg_rows(flat, g_in, g_out, slot), reps=20),
                      **pa.preagg_verdict(got, want, slot)}
del flat, g_in, g_out, want, got, slot

mesh = make_mesh(1, 1, device="cuda")
rmat_src, rmat_dst, _ = cs.rmat_graph(19)
n2v = Node2Vec(n2v_params=cs.N2V_MAIN, w2v_params={**cs.W2V_MAIN, "max_iter": 1},
               max_out_degree=10_000, random_seed=0, mesh=mesh, graph_sharded=True,
               device="cuda")
n2v.preprocess_input_graph((rmat_src, rmat_dst), indexed=True, directed=False)
engine = n2v._walk_engine()
walk_s = []
for rep in range(REPS):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_device(seed=0)
    torch.cuda.synchronize()
    walk_s.append(time.perf_counter() - t0)
_, _, source = engine.chunk_source(seed=0)
out["main_path_ep"] = {
    "walk_s": walk_s, "walk_s_median": sorted(walk_s)[REPS // 2],
    "unfinished": engine.unfinished_count,
    "profiled_4_chunks": profiled("ep walk, 4 of the chunks (1 x 1)",
                                  lambda: [source(i) for i in range(4)])}
del engine, n2v, rmat_src, rmat_dst
torch.distributed.destroy_process_group()

src, dst = cs.smoke_edges(131072, 2_097_152)
n2v = Node2Vec(n2v_params=cs.N2V_MAIN,
               w2v_params={**cs.W2V_MAIN, "optimizer": "sgd", "step_size": 0.025,
                           "max_iter": 1}, random_seed=0, device="cuda")
graph = n2v.preprocess_input_graph((src, dst), indexed=True, directed=False)
engine = n2v._walk_engine()
params = n2v.run_pipeline().params
n_chunks, _, source = engine.chunk_source(seed=0)


def fit():
    return Word2VecTorch(params, device="cuda").fit_streaming(source, n_chunks, graph.n_vertices)


fit_s = []
for rep in range(REPS):
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit()
    torch.cuda.synchronize()
    fit_s.append(time.perf_counter() - t0)
out["sgd_fit"] = {"wall_s": fit_s, "wall_s_median": sorted(fit_s)[REPS // 2],
                  "preagg_rows_launches": int(_build.launches["preagg_rows"]),
                  "profiled": profiled("run_pipeline (SGNS-SGD, streaming)", fit)}
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
        row["ptxas"] = {**chip_smoke.ptxas_summary(report, "ep_propose"),
                        **chip_smoke.ptxas_summary(report, "ep_member"),
                        **chip_smoke.ptxas_summary(report, "preagg")}
        print(json.dumps(row), flush=True)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
