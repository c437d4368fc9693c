#!/usr/bin/env python3
"""A/B of K23 ``ep_advance`` (with the next superstep's K20 phase A) and K14
``fused_adagrad`` between source trees, on one card.

    python3 experiments/ab_advance_adagrad.py TREE [TREE ...]

Each TREE is the root of a checkout (this repository's, or an unpacked
``git archive`` of another commit).  The trees run one after another, in the
order given (e.g. parent, change, change, parent), each in a process of its
own that builds that tree's kernels into its own ``build/`` and calls them
through that tree's wrappers, on inputs made by that tree's ``chip_smoke.py``
helpers (``advance_adagrad_attribution.advance_calls``, ``k14_inputs``):

* ``advance_second``, ``advance_late``: the advance at ``main_path_ep``'s
  first chunk (the scale-19 RMAT on the 1 x 1 mesh's one shard, 131,072
  walkers of 20 at (0.25, 4)), at the second superstep and at the first with
  under 10% of the lanes active: K23 and the next superstep's K20 phase A
  (the thread design) or the one fused launch, on the same state (CUDA
  events over 20 calls, the state restored outside the timed span), held
  bit-equal to ``ep_advance_plain`` then ``ep_bucket_plain``; the host time
  a call takes to enqueue (with the restore's, beside it), 5 times;
* ``main_path_ep``: ``Node2Vec(mesh=make_mesh(1, 1), graph_sharded=True)``
  on the RMAT: the 40 chunks' walk wall (host clock, 5 times), its
  supersteps, the host ms a superstep (the median wall over supersteps),
  one more walk with each superstep call's host time summed by name (the
  four ops, ``all_to_all``, ``all_reduce_sum``; the rest is the loop and
  the waits of the pending reads), and 4 chunks walked under
  torch.profiler (wall, device busy, idle share);
* ``fused_adagrad``: K14 at ``main_path_fused``'s first batch (B = 2,560,
  L1 = 21, D = 128, S = 64), the state restored outside the timed span, its
  largest difference from ``fused_adagrad_plain``;
* ``sgns_epoch_fused``: ``main_path_fused``'s epoch (512 steps of K2 at
  row stride 129 and K14), its wall (host clock, 5 times) and its profiled
  run's wall,
  device busy and idle share.

Prints one JSON line a tree (and ptxas's registers and spills of the
kernels), then the card's name and power limit.  The port never imports this
script.
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
sys.path.insert(1, os.path.join(%(root)r, "experiments"))
os.chdir(tree)
import torch
import chip_smoke as cs
import advance_adagrad_attribution as aa
import plan_attribution as pa
from node2vec_torch import _build, Node2Vec
from node2vec_torch.graph import build_graph
from node2vec_torch.models import skipgram as sg
from node2vec_torch.native import build_dir
from node2vec_torch.parallel import edge_partitioned_blocked as ep
from node2vec_torch.parallel import make_mesh

# build this tree's kernels in this process, so that ptxas's report is read
if os.path.exists(os.path.join(build_dir(), "libn2v_kernels.so")):
    os.remove(os.path.join(build_dir(), "libn2v_kernels.so"))
_build.lib()
out = {"tree": tree, "design": "fused" if hasattr(ep, "ep_advance_bucket") else "thread"}
REPS = 5  # the host's clock moves between runs: each wall is taken 5 times


def quiet(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        return fn(*args, **kwargs)


def profiled(label, fn):
    line = quiet(cs.breakdown, ((label, fn),))[0]
    return {k: line.get(k) for k in ("wall_ms", "device_busy_ms", "idle_share")}


got, late, geo = aa.advance_calls()
for key, (a, kw) in sorted(got.items()):
    restore, run, plain = aa.advance_runner(a, kw, geo)
    restore()
    want = plain()
    restore()
    equal = all(torch.equal(x, y) for x, y in zip(run(), want))
    c0 = a[0]

    def both(restore=restore, run=run):
        restore()
        return run()

    out["advance_" + key] = {
        "superstep": 1 if key == "second" else late[0],
        "active_lanes": int(((c0[ep.ALIVE] != 0) & (c0[ep.T] < aa.WALK_LENGTH)).sum()),
        "ms": cs.time_ms(run, reps=20, before=restore), "bit_equal": equal,
        "host_us_with_restore": [pa.host_us(torch, both, calls=20) for _ in range(REPS)],
        "host_us_restore": [pa.host_us(torch, restore, calls=20) for _ in range(REPS)]}
del got

mesh = make_mesh(1, 1, device="cuda")
rmat_src, rmat_dst, _ = cs.rmat_graph(19)
n2v = Node2Vec(n2v_params=cs.N2V_MAIN, w2v_params={**cs.W2V_MAIN, "max_iter": 1},
               max_out_degree=10_000, random_seed=0, mesh=mesh, graph_sharded=True,
               device="cuda")
n2v.preprocess_input_graph((rmat_src, rmat_dst), indexed=True, directed=False)
engine = n2v._walk_engine()
walk_s = []
for rep in range(REPS):
    _build.reset_launches()
    engine.superstep_counts = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_device(seed=0)
    torch.cuda.synchronize()
    walk_s.append(time.perf_counter() - t0)
steps = sum(engine.superstep_counts)
# one more walk with each superstep call timed on the host clock: where the
# host's time a superstep goes (the rest: the loop, the pending reads' waits)
host = {}


def timed(name, fn):
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        value = fn(*args, **kwargs)
        entry = host.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += time.perf_counter() - t0
        return value
    return call


saved = {name: ep._Kernels.__dict__[name] for name in ("bucket", "propose", "member", "advance",
                                                         "advance_bucket")
         if name in ep._Kernels.__dict__}
for name, fn in saved.items():
    setattr(ep._Kernels, name, staticmethod(timed(name, fn.__func__)))
for name in ("all_to_all", "all_reduce_sum"):
    setattr(mesh, name, timed(name, getattr(mesh, name)))
torch.cuda.synchronize()
t0 = time.perf_counter()
engine.run_device(seed=0)
torch.cuda.synchronize()
split_s = time.perf_counter() - t0
for name, fn in saved.items():
    setattr(ep._Kernels, name, fn)
for name in ("all_to_all", "all_reduce_sum"):
    delattr(mesh, name)
_, _, source = engine.chunk_source(seed=0)
med = sorted(walk_s)[REPS // 2]
out["main_path_ep"] = {
    "walk_s": walk_s, "walk_s_median": med, "supersteps": steps,
    "host_ms_a_superstep_median": med * 1e3 / steps,
    "unfinished": engine.unfinished_count,
    "host_split": {"walk_s": split_s, "calls_ms": {k: {"calls": c, "ms": t * 1e3}
                                                   for k, (c, t) in host.items()},
                   "rest_ms": (split_s - sum(t for _, t in host.values())) * 1e3},
    "launches": {k: int(v) for k, v in _build.launches.items() if k.startswith("ep_")},
    "profiled_4_chunks": profiled("ep walk, 4 of the chunks (1 x 1)",
                                  lambda: [source(i) for i in range(4)])}
del engine, n2v, rmat_src, rmat_dst
torch.distributed.destroy_process_group()

tab_in, tab_out, lists, lr = aa.k14_inputs()
t_in, t_out = tab_in.clone(), tab_out.clone()


def restore14():
    t_in.copy_(tab_in)
    t_out.copy_(tab_out)


q_in, q_out = tab_in.clone(), tab_out.clone()
sg.fused_adagrad_plain(q_in, q_out, *lists, lr)
restore14()
sg.fused_adagrad(t_in, t_out, *lists, lr)
k14 = {"ms": cs.time_ms(lambda: sg.fused_adagrad(t_in, t_out, *lists, lr), reps=20,
                        before=restore14),
       "max_abs_err": max(float((t_in - q_in).abs().max()), float((t_out - q_out).abs().max()))}
out["fused_adagrad"] = k14
del tab_in, tab_out, t_in, t_out, q_in, q_out, lists

src, dst = cs.smoke_edges(131072, 2_097_152)
g = build_graph((src, dst), directed=False)
ep_ = cs._pair_epoch(g)
tabs0 = sg.init_fused_embeddings(ep_["V"], ep_["dim"], seed=1, device="cuda")
cs._fused_epoch([t.clone() for t in tabs0], ep_)  # warm
epoch_s = []
for rep in range(REPS):
    tabs = [t.clone() for t in tabs0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = cs._fused_epoch(tabs, ep_)
    torch.cuda.synchronize()
    epoch_s.append(time.perf_counter() - t0)
out["sgns_epoch_fused"] = {
    "steps": ep_["n_batches"], "wall_s": epoch_s, "wall_s_median": sorted(epoch_s)[REPS // 2],
    "losses_finite": bool(torch.isfinite(losses).all()),
    "profiled": profiled("sgns_epoch_fused", lambda: cs._fused_epoch([t.clone() for t in tabs0],
                                                                     ep_))}
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
        row["ptxas"] = {**chip_smoke.ptxas_summary(report, "ep_bucket_kernel"),
                        **chip_smoke.ptxas_summary(report, "ep_advance_kernel"),
                        **chip_smoke.ptxas_summary(report, "fused_")}
        print(json.dumps(row), flush=True)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
