#!/usr/bin/env python3
"""A/B of K1 ``dense_walk`` and K24 ``epd_bucket`` between source trees, on
one card.

    python3 experiments/ab_walk_bucket.py TREE [TREE ...]

Each TREE is the root of a checkout (this repository's, or an unpacked
``git archive`` of another commit).  The trees run one after another, in the
order given (e.g. parent, change, change, parent), each in a process of its
own that builds that tree's kernels into its own ``build/`` and calls them
through that tree's wrappers, on inputs made by that tree's ``chip_smoke.py``
helpers (``walk_bucket_attribution.dense_inputs``).  Every kernel row is
timed 5 times (CUDA events, each a mean over its calls) and reported as the
median and the range:

* ``dense_walk``: K1 on 131,072 starts (vertex i mod V) of 20 steps on the
  dense ER graph's packed adjacency (P = 64) at (p, q) = (0.25, 4) and
  (1, 1), held bit-equal to ``dense_walk_chunk_plain``; and walker-sharded
  (``sharded_dense_walk_chunk`` on ``make_mesh(1, 1)`` over NCCL, as
  ``main_path_mesh`` calls it);
* ``epd``: one pass of ``check_ep_dense``'s chunk (131,072 walkers of 20 at
  (0.25, 4), full capacity, the default draws of seed 0) with every
  superstep's inputs of K24, K25 and K26 kept; K24 at the second and the
  last superstep and summed over the chunk, K25 at the second and summed,
  K26 at the second (its state restored before each call, outside the timed
  span), each held bit-equal (whole buffers) to its plain version;
* ``main_path_walk``: ``main_path``'s walk stage, 5 times (the Quickstart
  ``Node2Vec`` on the same graph: ``random_walk()``'s wall, then its
  profiled run through ``chip_smoke.breakdown``: wall, device busy, idle
  share and K1's device ms);
* ``main_path_epd``: ``chip_smoke.main_path_epd`` on the 1 x 1 mesh, 5 times:
  walk seconds of its 10 chunks and its profiled 2 chunks (wall, device
  busy, idle share).

Prints one JSON line a tree (with ptxas's registers and spills of K1 and
K24), then the card's name and power limit.  The port never imports this
script.
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
import walk_bucket_attribution as wa
from node2vec_torch import Node2Vec, _build
from node2vec_torch.native import build_dir
from node2vec_torch.parallel import edge_partitioned as epd
from node2vec_torch.parallel import make_mesh
from node2vec_torch.parallel.sharded_walk import sharded_dense_walk_chunk
from node2vec_torch.walk import dense

# build this tree's kernels in this process, so that ptxas's report is read
if os.path.exists(os.path.join(build_dir(), "libn2v_kernels.so")):
    os.remove(os.path.join(build_dir(), "libn2v_kernels.so"))
_build.lib()
out = {"tree": tree}
REPS = 5  # every row is taken 5 times


def quiet(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        return fn(*args, **kwargs)


def spread(xs):
    s = sorted(xs)
    return {"median": s[len(s) // 2], "min": s[0], "max": s[-1], "runs": xs}


def timed(fn, reps, before=None):
    return spread([cs.time_ms(fn, reps=reps, before=before) for _ in range(REPS)])


# K1, direct and walker-sharded on the 1 x 1 mesh
g, packed, starts = wa.dense_inputs()
mesh = make_mesh(1, 1, device="cuda")
out["dense_walk"] = {}
for p, q in ((0.25, 4.0), (1.0, 1.0)):
    kw = dict(walk_length=wa.WALK_LENGTH, return_param=p, inout_param=q)
    want = dense.dense_walk_chunk_plain(packed, starts, 0, 0, **kw)
    row = {"bit_equal": bool(torch.equal(dense.dense_walk_chunk(packed, starts, 0, 0, **kw),
                                         want)),
           "ms": timed(lambda: dense.dense_walk_chunk(packed, starts, 0, 0, **kw), 10)}
    if (p, q) == (0.25, 4.0):
        row["sharded_ms"] = timed(lambda: sharded_dense_walk_chunk(mesh, packed, starts, 0, 0,
                                                                   **kw), 10)
    out["dense_walk"][f"p{p}_q{q}"] = row

# one pass of check_ep_dense's chunk, every kernel's inputs kept
padded, rps = epd.partition_packed_adjacency(packed.cpu().numpy(), 1)
local = torch.from_numpy(padded).cuda()
del packed
p_cols = local.shape[1] // 2
draws = epd.default_draws(0, 0, wa.WALKERS, "cuda")
seen = {"bucket": [], "serve": [], "advance": []}


class Capture(epd._Kernels):
    @staticmethod
    def bucket(carry, prev_rows, u, **kw):
        seen["bucket"].append((carry.clone(), prev_rows.clone(), u.clone()))
        return epd.epd_bucket(carry, prev_rows, u, **kw)

    @staticmethod
    def serve(recv, adj, **kw):
        seen["serve"].append(recv.clone())
        return epd.epd_serve(recv, adj, **kw)

    @staticmethod
    def advance(carry, prev_rows, paths, slot, back, **kw):
        if len(seen["advance"]) < 2:
            seen["advance"].append([t.clone() for t in (carry, prev_rows, paths, slot, back)])
        return epd.epd_advance(carry, prev_rows, paths, slot, back, **kw)


carry = epd.init_carry(starts)
prev_rows = torch.full((wa.WALKERS, p_cols), int(dense.PAD_ID), dtype=torch.int32, device="cuda")
paths = torch.full((wa.WALKERS, wa.WALK_LENGTH + 1), -1, dtype=torch.int32, device="cuda")
paths[:, 0] = starts
skw = dict(capacity=wa.WALKERS, n_shards=1, rows_per_shard=rps, my_shard=0,
           walk_length=wa.WALK_LENGTH, return_param=wa.EP_PQ[0], inout_param=wa.EP_PQ[1])
for t in range(epd.max_supersteps(wa.WALK_LENGTH)):
    if int(epd.superstep(Capture, None, "data", local, carry, prev_rows, paths, draws(t),
                         **skw)) == 0:
        break
bkw = dict(n_shards=1, capacity=wa.WALKERS, rows_per_shard=rps, walk_length=wa.WALK_LENGTH)
vkw = dict(my_shard=0, rows_per_shard=rps, return_param=wa.EP_PQ[0], inout_param=wa.EP_PQ[1])
equal = {"epd_bucket": True, "epd_serve": True, "epd_advance": True}
for args in seen["bucket"]:
    equal["epd_bucket"] &= all(bool(torch.equal(a, b)) for a, b in zip(
        epd.epd_bucket(*args, **bkw), epd.epd_bucket_plain(*args, **bkw)))
for recv in seen["serve"]:
    equal["epd_serve"] &= bool(torch.equal(epd.epd_serve(recv, local, **vkw),
                                           epd.epd_serve_plain(recv, local, **vkw)))
n = len(seen["bucket"])
b_sum, s_sum = [], []
for _ in range(REPS):
    b_sum.append(sum(cs.time_ms(lambda: epd.epd_bucket(*a, **bkw), reps=20)
                     for a in seen["bucket"]))
    s_sum.append(sum(cs.time_ms(lambda: epd.epd_serve(r, local, **vkw), reps=20)
                     for r in seen["serve"]))
saved = seen["advance"][1]
scratch = [t.clone() for t in saved[:3]]


def restore():
    for dst, src in zip(scratch, saved[:3]):
        dst.copy_(src)


want_state = [t.clone() for t in saved[:3]]
want_pending = epd.epd_advance_plain(*want_state, *saved[3:], walk_length=wa.WALK_LENGTH)
restore()
got_pending = epd.epd_advance(*scratch, *saved[3:], walk_length=wa.WALK_LENGTH)
equal["epd_advance"] = bool(torch.equal(got_pending, want_pending)) and all(
    bool(torch.equal(a, b)) for a, b in zip(scratch, want_state))
out["epd"] = {
    "supersteps": n, "bit_equal": equal,
    "epd_bucket_second_ms": timed(lambda: epd.epd_bucket(*seen["bucket"][1], **bkw), 20),
    "epd_bucket_last_ms": timed(lambda: epd.epd_bucket(*seen["bucket"][-1], **bkw), 20),
    "epd_bucket_summed_ms": spread(b_sum),
    "epd_serve_second_ms": timed(lambda: epd.epd_serve(seen["serve"][1], local, **vkw), 20),
    "epd_serve_summed_ms": spread(s_sum),
    "epd_advance_second_ms": timed(
        lambda: epd.epd_advance(*scratch, *saved[3:], walk_length=wa.WALK_LENGTH), 20,
        before=restore)}
del seen, local, carry, prev_rows, paths, saved, scratch
torch.cuda.empty_cache()

# the paths, 5 times each; each run's profiled breakdown read from its lines
lines = []
emit = cs.emit


def keep(obj):
    lines.append(obj)
    emit(obj)


def profiled():
    bd = [ln for ln in lines if ln.get("phase") == "breakdown"][-1]
    k1 = [v for k, v in bd.get("top_device_ms", {}).items() if "dense_walk" in k]
    return {**{k: bd.get(k) for k in ("wall_ms", "device_busy_ms", "idle_share")},
            "k1_device_ms": k1[0] if k1 else None}


cs.emit = keep
src, dst = cs.smoke_edges(131072, 2_097_152)
walk = []
for _ in range(REPS):
    n2v = Node2Vec(n2v_params=dict(cs.N2V_MAIN), w2v_params={**cs.W2V_MAIN, "max_iter": 1},
                   random_seed=0, device="cuda")
    quiet(n2v.preprocess_input_graph, (src, dst), indexed=True, directed=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n2v.random_walk()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    quiet(cs.breakdown, (("random_walk", n2v.random_walk),))
    walk.append({"walk_s": wall, **profiled()})
    del n2v
out["main_path_walk"] = {"walk_s": spread([r["walk_s"] for r in walk]),
                         "profiled": walk}
runs = []
for _ in range(REPS):
    r = quiet(cs.main_path_epd, mesh, src, dst)
    runs.append({"walk_s": r["walk_s"], "k1_walk_s": r["k1_walk_s"], **profiled()})
out["main_path_epd"] = {"walk_s": spread([r["walk_s"] for r in runs]),
                        "k1_walk_s": spread([r["k1_walk_s"] for r in runs]),
                        "profiled_2_chunks": runs}
cs.emit = emit
torch.distributed.destroy_process_group()
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
        row["ptxas"] = {**chip_smoke.ptxas_summary(report, "dense_walk"),
                        **chip_smoke.ptxas_summary(report, "epd_bucket")}
        print(json.dumps(row), flush=True)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
