#!/usr/bin/env python3
"""A/B of K25 ``epd_serve`` and K3's squares mode ``adagrad_accumulate_squares``
between source trees, on one card.

    python3 experiments/ab_serve_squares.py TREE [TREE ...]

Each TREE is the root of a checkout (this repository's, or an unpacked
``git archive`` of another commit).  The trees run one after another, in the
order given (e.g. parent, change, change, parent), each in a process of its
own that builds that tree's kernels into its own ``build/`` and calls them
through that tree's wrappers, on inputs made by that tree's ``chip_smoke.py``
helpers (``serve_squares_attribution.serve_calls``, ``cbow_hs_lists``,
``column_lists``):

* ``epd_serve``: K25 at every superstep of ``check_ep_dense``'s chunk (the
  dense graph's packed adjacency, P = 64, 131,072 walkers of 20 at (0.25, 4)
  on one shard), each call timed (CUDA events, 20 calls) and held bit-equal
  to ``epd_serve_plain``: the second superstep's time and the sum over the
  chunk;
* ``dense_walk``: K1 on the same 131,072 starts (one chunk of 20 steps),
  unchanged by the slice;
* ``squares``: K3's squares mode at ``main_path_cbow_hs``'s batch, at the
  column step's and at the row owners', each held to the plain version
  (rtol 1e-4, atol 1e-6);
* ``main_path_epd``: ``edge_partitioned_walk`` on the 1 x 1 mesh, 10 chunks
  (``chip_smoke.main_path_epd``, 5 times): walk seconds, K1's seconds on the
  same starts, and each run's profiled walk of 2 chunks (wall, device busy,
  idle share);
* ``cbow_hs_fit``: ``main_path_cbow_hs`` (``fit_host`` with CBOW-HS, one
  epoch; ``chip_smoke.main_path_host``, 5 times): the fit's seconds and each
  run's profiled fit (wall, device busy, idle share).

Prints one JSON line a tree (with ptxas's registers and spills of K25, K1
and K3's squares mode), then the card's name and power limit.  The port
never imports this script.
"""

import json
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
import serve_squares_attribution as sa
from node2vec_torch import _build
from node2vec_torch.models import skipgram as sg
from node2vec_torch.native import build_dir
from node2vec_torch.parallel import edge_partitioned as epd
from node2vec_torch.parallel import make_mesh
from node2vec_torch.walk import dense

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


def spread(xs):
    s = sorted(xs)
    return {"runs": xs, "median": s[len(s) // 2], "min": s[0], "max": s[-1]}


# K25 at every superstep of the chunk; K1 on the same starts
calls, local, kw = sa.serve_calls()
per_step, equal = [], True
for recv in calls:
    want = epd.epd_serve_plain(recv, local, **kw)
    equal &= bool(torch.equal(epd.epd_serve(recv, local, **kw), want))
    per_step.append(cs.time_ms(lambda: epd.epd_serve(recv, local, **kw), reps=20))
out["epd_serve"] = {"supersteps": len(calls), "ms_first": per_step[0], "ms_second": per_step[1],
                    "ms_last": per_step[-1], "ms_summed_over_the_chunk": sum(per_step),
                    "bit_equal_every_superstep": equal}
del calls, local
src, dst = cs.smoke_edges(131072, 2_097_152)
g = cs.build_graph((src, dst), directed=False)
packed = torch.from_numpy(dense.build_padded_adjacency(g.indptr, g.indices, g.weights)).cuda()
starts = torch.arange(sa.WALKERS, dtype=torch.int32, device="cuda") %% g.n_vertices
k1_kw = dict(walk_length=sa.WALK_LENGTH, return_param=sa.PQ[0], inout_param=sa.PQ[1])
out["dense_walk"] = {"ms": cs.time_ms(lambda: dense.dense_walk_chunk(packed, starts, 0, 0,
                                                                     **k1_kw), reps=5)}
del packed, starts

# K3's squares mode at its three call sites
cb_lists, cb_dim, cb_acc, _, _ = sa.cbow_hs_lists()
col_lists, col_dim, col_acc, owners = sa.column_lists()
out["squares"] = {}
for site, lists, dim, acc in (("cbow_hs", cb_lists, cb_dim, cb_acc),
                              ("column step", col_lists, col_dim, col_acc),
                              ("row owners", owners, 1, col_acc)):
    got = [x.clone() for x in acc]
    want = [x.clone() for x in acc]
    sg.adagrad_accumulate_squares(*got, *lists, dim)
    sg.adagrad_accumulate_squares_plain(*want, *lists, dim)
    torch.cuda.synchronize()
    ok = all(bool(torch.allclose(a, b, rtol=cs.RTOL, atol=cs.ATOL)) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    out["squares"][site] = {
        "ms": cs.time_ms(lambda: sg.adagrad_accumulate_squares(*got, *lists, dim), reps=20),
        "within_tolerance": ok, "max_abs_err": err}
del cb_lists, col_lists, owners, cb_acc, col_acc

# the paths, 5 times each; each run's profiled breakdown read from its lines
lines = []
emit = cs.emit


def keep(obj):
    lines.append(obj)
    emit(obj)


def profiled():
    bd = [ln for ln in lines if ln.get("phase") == "breakdown"][-1]
    return {k: bd.get(k) for k in ("wall_ms", "device_busy_ms", "idle_share")}


cs.emit = keep
# main_path_epd: walk seconds, K1's on the same starts, the profiled 2 chunks
mesh = make_mesh(1, 1, device="cuda")
runs = []
for _ in range(REPS):
    last = r = quiet(cs.main_path_epd, mesh, src, dst)
    runs.append({"walk_s": r["walk_s"], "k1_walk_s": r["k1_walk_s"], **profiled()})
out["main_path_epd"] = {
    "walk_s": spread([r["walk_s"] for r in runs]), "k1_walk_s": spread([r["k1_walk_s"] for r in runs]),
    "profiled_2_chunks": runs, "launches_epd_serve": last["launches"]["epd_serve"],
    "unfinished": last["unfinished"]}
torch.distributed.destroy_process_group()

# the CBOW-HS fit (host corpus): its seconds and its profiled fit
fits = []
for _ in range(REPS):
    mp = quiet(cs.main_path_host, src, dst, 1, "main_path_cbow_hs", {"sg": 0, "negative": 0},
               "cbow_hs_grads", cs.CBOW_HS_UPDATE)[0]
    fits.append({"fit_s": mp["fit_s"], **profiled()})
cs.emit = emit
out["cbow_hs_fit"] = {"fit_s": spread([f["fit_s"] for f in fits]), "profiled": fits}
out["ptxas_report"] = _build.ptxas_report
print("AB " + json.dumps(out), flush=True)
""" % {"root": ROOT}


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for row in run_trees(trees, PROGRAM, timeout=1500):
        report = row.pop("ptxas_report")
        row["ptxas"] = {**chip_smoke.ptxas_summary(report, "epd_serve"),
                        **chip_smoke.ptxas_summary(report, "dense_walk"),
                        **chip_smoke.ptxas_summary(report, "accumulate_squares")}
        print(json.dumps(row), flush=True)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
