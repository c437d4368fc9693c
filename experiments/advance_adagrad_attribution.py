#!/usr/bin/env python3
"""Where K23 ``ep_advance`` (with the next superstep's K20 phase A) and K14
``fused_adagrad`` spend their time, on one card: ``clock64()`` at each phase,
in patched copies of their sources.

    python3 experiments/advance_adagrad_attribution.py [--tree DIR]   # measure
    python3 experiments/advance_adagrad_attribution.py --check [--tree DIR]

TREE is the root of a checkout (this repository's by default; a parent's
unpacked ``git archive`` for a before/after).  Its sources are patched
(``_variants.py``), built, and called through the tree's own wrappers with
the probed library swapped in for the port's, so both trees see the same
inputs, made by the tree's ``chip_smoke.py`` helpers.  Two patch sets a
kernel follow the designs the files have had; the set whose anchors match
is used, and ``--check`` says which (it fails when none does):

* the advance, ``thread``: K23 alone, one thread a walker over every lane
  (its phases: the state, slot and response loads; the membership answer at
  q != 1; the acceptance; the advance and the ten stores; the block counts and
  their atomics).  ``fused``: the advance inside K20's phase-A launch (its
  phases: a lane's slot, activity and request rows; a sent lane's responses
  and the rest of its state; the advance and the stores of what changed; the
  ranking in the tile; the block counts; the grid barrier; the earlier
  blocks' counts and the pending count; the slots and requests written; the
  later tiles; the -1 fill);
* K14, ``two launches``: launch 1 (a warp reads a gradient row for its mean
  square; acc0 read, scale and square stored) and launch 2 (the scale, the
  row read again and its D scalar atomics; column D's atomic).
  ``one pass``: the heavy launch (a warp's row read and its square sum;
  acc0 and the scale; the realigned row's 16-byte atomics; the head and tail
  floats and the deferred (row, square) pair).

Inputs: the advance at ``main_path_ep``'s first chunk (the scale-19 RMAT on
the 1 x 1 mesh's one shard, 131,072 walkers of 20 at (p, q) = (0.25, 4),
full capacity), captured at the second superstep and at the first with under
10% of the lanes active; K14 at ``main_path_fused``'s first batch (B = 2,560,
L1 = 21, D = 128, S = 64, V = 131,072; the gradients by the tree's K2).  For
each: the unpatched kernel's time (CUDA events; the thread design's K23 and
the next K20 phase-A call together, as the fused launch does both), and the
probed copy's phases (its results must equal the unpatched kernel's); for
K14's one pass also variants, timed only: without its 16-byte atomics,
without the column pass, with every row through the scalar path, and with
the aligned run added by one bulk reduction from shared memory
(``cp.reduce.async.bulk``; the last two held to the plain version).
Prints one JSON line a measurement, ptxas's registers and spills of each
build first, then the card's name and power limit.  Neither the port nor the
smoke imports this file.
"""

import argparse
import contextlib
import json
import os
import sys

from _variants import (ROOT, PROBE_START, build, card, patched, phase_read, probe_counters,
                       probe_flush, probes, profile, source)

WALKERS, WALK_LENGTH = 131072, 20

# ---- the advance ----------------------------------------------------------

ADV_THREAD = ["state, slot and response loads", "membership answer (q != 1)", "acceptance",
              "advance and stores", "block counts and atomics"]


def adv_thread_patches() -> list:
    p = probes(len(ADV_THREAD))
    return [
        ("  bool fb = false, still = false;\n",
         "  bool fb = false, still = false;\n  " + PROBE_START),
        ("    const bool died = send_a && a_cand < 0 && !a_take;\n",
         f"    const bool died = send_a && a_cand < 0 && !a_take;\n    {p[0]}\n"),
        ("      attempted = send_a && (sb < n_req_b || !need_b);\n    }\n    bool accept;\n",
         "      attempted = send_a && (sb < n_req_b || !need_b);\n    }\n"
         f"    {p[1]}\n    bool accept;\n"),
        ("    alive = alive && !died;\n", f"    {p[2]}\n    alive = alive && !died;\n"),
        ("    still = alive && t < walk_length;\n",
         f"    still = alive && t < walk_length;\n    {p[3]}\n"),
        ("    if (n_still) atomicAdd(pending, n_still);\n  }\n}\n",
         f"    if (n_still) atomicAdd(pending, n_still);\n  }}\n  {p[4]}\n"
         f"{probe_flush('adv', len(ADV_THREAD))}}}\n"),
    ]


ADV_FUSED = ["slot, activity and request rows", "a sent lane's responses and state",
             "advance and stores", "ranks in the tile", "block counts stored", "grid barrier",
             "earlier blocks' counts, pending", "slots and requests written", "later tiles",
             "-1 into the unfilled rows"]


def adv_fused_patches() -> list:
    p = probes(len(ADV_FUSED))
    return [
        # the probes' counters reach lane_request as arguments
        ("__device__ __forceinline__ bool lane_request(const BucketArgs& a,",
         "__device__ __forceinline__ bool lane_request(long long* _pr, long long& _t, "
         "const BucketArgs& a,"),
        ("  bool active = lane_request<kAdvance>(a, i,",
         "  bool active = lane_request<kAdvance>(_pr, _t, a, i,"),
        ("    if (lane_request<kAdvance>(a, t * kTile", "    if (lane_request<kAdvance>(_pr, _t, a, t * kTile"),
        ("    active = lane_request<false>(a, i,", "    active = lane_request<false>(_pr, _t, a, i,"),
        ("  int32_t* stage = wc + (threadIdx.x >> 5) * (F + 1) * 32;\n",
         "  int32_t* stage = wc + (threadIdx.x >> 5) * (F + 1) * 32;\n  " + PROBE_START),
        ("    const bool sent = sa < n_req;\n", f"    const bool sent = sa < n_req;\n    {p[0]}\n"),
        ("      const bool died = a_cand < 0 && !a_take;\n",
         f"      const bool died = a_cand < 0 && !a_take;\n      {p[1]}\n"),
        ("  q.f[0] = cur;\n  q.f[1] = prev;\n",
         f"  if (kAdvance) {{ {p[2]} }}\n  q.f[0] = cur;\n  q.f[1] = prev;\n"),
        ("  const int off = n2v::tile_offset<kTile>(active, dest, S, wc, tt);\n",
         f"  const int off = n2v::tile_offset<kTile>(active, dest, S, wc, tt);\n  {p[3]}\n"),
        ("  cg::this_grid().sync();\n", f"  {p[4]}\n  cg::this_grid().sync();\n  {p[5]}\n"),
        ("  emit(i, active, dest, active ? pre[dest] + off : 0, q);\n",
         f"  {p[6]}\n  emit(i, active, dest, active ? pre[dest] + off : 0, q);\n  {p[7]}\n"),
        ("  n2v::grid_fill<kTile>(a.send, F, S, a.capacity, tot, ends, -1);\n}",
         f"  {p[8]}\n  n2v::grid_fill<kTile>(a.send, F, S, a.capacity, tot, ends, -1);\n"
         f"  {p[9]}\n  if (kAdvance) {{\n{probe_flush('adv', len(ADV_FUSED))}  }}\n}}"),
    ]


# ---- K14 ------------------------------------------------------------------

K14_SCALE = ["row read, squares", "acc0 read, scale and square stored"]
K14_ADD = ["scale, row read again, D atomics", "column D atomic"]


def k14_two_patches() -> list:
    s, a = probes(len(K14_SCALE)), probes(len(K14_ADD))
    return [
        ("  if (!locate(l, r, dim, g, v, first) || v < 0) return;\n  float acc = 0.f;\n",
         "  if (!locate(l, r, dim, g, v, first) || v < 0) return;\n  " + PROBE_START
         + "  float acc = 0.f;\n"),
        ("  const float s = warp_sum(acc) / static_cast<float>(dim);\n",
         f"  const float s = warp_sum(acc) / static_cast<float>(dim);\n  {s[0]}\n"),
        ("    sq[r] = s;\n  }\n}\n",
         f"    sq[r] = s;\n  }}\n  {s[1]}\n{probe_flush('k14s', len(K14_SCALE))}}}\n"),
        ("  if (!locate(l, r, dim, g, v, first) || v < 0) return;\n  float* t = ",
         "  if (!locate(l, r, dim, g, v, first) || v < 0) return;\n  " + PROBE_START
         + "  float* t = "),
        ("  for (int k = lane; k < dim; k += 32) atomicAdd(t + k, (-lr * g[k]) * sc);\n"
         "  if (lane == 0) atomicAdd(t + dim, sq[r]);\n}\n",
         "  for (int k = lane; k < dim; k += 32) atomicAdd(t + k, (-lr * g[k]) * sc);\n"
         f"  {a[0]}\n  if (lane == 0) atomicAdd(t + dim, sq[r]);\n  {a[1]}\n"
         f"{probe_flush('k14a', len(K14_ADD))}}}\n"),
    ]


K14_ONE = ["row read, square sum", "acc0 and the scale", "16-byte atomics",
           "head, tail and the deferred pair"]


def k14_one_patches() -> list:
    p = probes(len(K14_ONE))
    return [
        ("    return;\n  }\n  float* t = (ref.first ? tab_in : tab_out) + static_cast<int64_t>(ref.v) "
         "* (dim + 1);\n  const float acc0 = t[dim];\n  const int nc = dim >> 2;\n",
         "    return;\n  }\n  " + PROBE_START + "  float* t = (ref.first ? tab_in : tab_out) + "
         "static_cast<int64_t>(ref.v) * (dim + 1);\n  const float acc0 = t[dim];\n"
         "  const int nc = dim >> 2;\n"),
        ("  const float s = warp_sum(acc) / static_cast<float>(dim);\n"
         "  const float sc = rsqrtf(acc0 + s + kEps);\n  auto upd",
         f"  const float s = warp_sum(acc) / static_cast<float>(dim);\n  {p[0]}\n"
         f"  const float sc = rsqrtf(acc0 + s + kEps);\n  {p[1]}\n  auto upd"),
        ("  // head and tail: at most 3 floats each, scalar atomics (the tail above)\n",
         f"  {p[2]}\n  // head and tail: at most 3 floats each, scalar atomics (the tail above)\n"),
        ("    pend[r] = make_int2(ref.v, __float_as_int(s));\n  }\n}\n\n// Any other row",
         f"    pend[r] = make_int2(ref.v, __float_as_int(s));\n  }}\n  {p[3]}\n"
         f"{probe_flush('k14o', len(K14_ONE))}}}\n\n// Any other row"),
    ]


# timed only, their results differ (but "scalar rows" and "bulk reduce")
K14_ONE_VARIANTS = {
    "no 16-byte atomics": [("      atomicAdd(reinterpret_cast<float4*>(t + h + 4 * j),\n"
                            "                make_float4(upd(a.x), upd(a.y), upd(a.z), upd(a.w)));\n",
                            "      if (a.x == 1234.5f) t[0] = upd(a.y);\n")],
    "no column pass": [("  fused_squares_kernel<<<", "  if (n < 0) fused_squares_kernel<<<")],
    "scalar rows": [("  if (!vec || dim > 1024) return launch<0>", "  return launch<0>")],
    # the aligned run written to shared memory and added by one bulk reduction
    # (cp.reduce.async.bulk .add.f32, Hopper's TMA) in place of 16-byte atomics
    "bulk reduce": [
        ("  const int tail = dim - h - 4 * nb;\n",
         "  const int tail = dim - h - 4 * nb;\n"
         "  __shared__ __align__(128) float4 slabs[kWarps][32 * K];\n"
         "  float4* slab = slabs[threadIdx.x >> 5];\n"),
        ("      atomicAdd(reinterpret_cast<float4*>(t + h + 4 * j),\n"
         "                make_float4(upd(a.x), upd(a.y), upd(a.z), upd(a.w)));\n",
         "      slab[j] = make_float4(upd(a.x), upd(a.y), upd(a.z), upd(a.w));\n"),
        ("  // head and tail: at most 3 floats each, scalar atomics (the tail above)\n",
         "  asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"
         "  __syncwarp();\n"
         "  if (lane == 0 && nb > 0) {\n"
         "    asm volatile(\"cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
         "[%0], [%1], %2;\\n\" :: \"l\"(t + h), "
         "\"r\"(static_cast<unsigned>(__cvta_generic_to_shared(slab))), \"r\"(nb * 16) "
         ": \"memory\");\n"
         "    asm volatile(\"cp.async.bulk.commit_group;\\n\" ::: \"memory\");\n"
         "    asm volatile(\"cp.async.bulk.wait_group.read 0;\\n\" ::: \"memory\");\n"
         "  }\n"
         "  // head and tail: at most 3 floats each, scalar atomics (the tail above)\n"),
    ],
}


def sources(csrc: str):
    """({library: (source, nvcc flags)}, {library: (design, [(prefix, phases)])})."""
    srcs, designs = {}, {}
    ep_src = source("ep_walk.cu", csrc)
    for design, patches, prefixes in (
            ("thread", adv_thread_patches, [("adv", ADV_THREAD)]),
            ("fused", adv_fused_patches, [("adv", ADV_FUSED)])):
        if all(ep_src.count(old) == 1 for old, _ in patches()):
            srcs["advance"] = (probe_counters("adv") + patched(ep_src, patches())
                               + phase_read("adv"), [])
            designs["advance"] = (design, prefixes)
            break
    else:
        raise SystemExit("no patch set applies to ep_walk.cu")
    k14_src = source("fused_adagrad.cu", csrc)
    for design, patches, prefixes in (
            ("two launches", k14_two_patches, [("k14s", K14_SCALE), ("k14a", K14_ADD)]),
            ("one pass", k14_one_patches, [("k14o", K14_ONE)])):
        if all(k14_src.count(old) == 1 for old, _ in patches()):
            counters = "".join(probe_counters(p) for p, _ in prefixes)
            reads = "".join(phase_read(p) for p, _ in prefixes)
            srcs["k14"] = (counters + patched(k14_src, patches()) + reads, [])
            designs["k14"] = (design, prefixes)
            if design == "one pass":
                for name, pairs in K14_ONE_VARIANTS.items():
                    srcs["k14: " + name] = (patched(k14_src, pairs), [])
            break
    else:
        raise SystemExit("no patch set applies to fused_adagrad.cu")
    return srcs, designs


@contextlib.contextmanager
def swapped(lib):
    """The tree's wrappers call ``lib`` (each C entry's argtypes copied from
    the port's library) while the block runs."""
    from node2vec_torch import _build

    port = _build.lib()
    for name in ("n2v_ep_bucket", "n2v_ep_advance", "n2v_ep_advance_bucket",
                 "n2v_fused_adagrad", "n2v_error_string"):
        try:
            fn, mine = getattr(port, name), getattr(lib, name)
        except AttributeError:
            continue
        mine.argtypes, mine.restype = fn.argtypes, fn.restype
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = port


def advance_calls():
    """The advance's calls at ``main_path_ep``'s first chunk, walked through
    the importing tree's kernels (its own ``_walk``): {"second": ..., "late":
    ...}, each (args, keywords) of the tree's advance (K23's, or the fused
    launch's), the state before it; the late superstep's number and active
    lanes; and K20's phase-A keywords (the thread design ranks the next
    superstep with them)."""
    import torch

    import chip_smoke as cs
    from node2vec_torch.parallel import edge_partitioned_blocked as ep
    from node2vec_torch.parallel import make_mesh

    dev = torch.device("cuda")
    _, _, g_rmat = cs.rmat_graph(19)
    mesh = make_mesh(1, 1, device="cuda")
    pg = ep.partition_blocked_graph(g_rmat.indptr, g_rmat.indices, g_rmat.weights, 1, mesh=mesh)
    starts = torch.arange(WALKERS, dtype=torch.int32, device=dev) % g_rmat.n_vertices
    fused = hasattr(ep, "ep_advance_bucket")
    kernel = ep.ep_advance_bucket if fused else ep.ep_advance

    class Capture(ep._Kernels):
        step, late, got = 0, None, {}

    def keep(*args, **kw):
        carry = args[0]
        active = int(((carry[ep.ALIVE] != 0) & (carry[ep.T] < WALK_LENGTH)).sum())
        if Capture.late is None and Capture.step > 1 and active < 0.1 * WALKERS:
            Capture.late = (Capture.step, active)
        if Capture.step == 1 or (Capture.late is not None and Capture.late[0] == Capture.step):
            Capture.got["second" if Capture.step == 1 else "late"] = (
                [a.clone() if torch.is_tensor(a) else a for a in args], dict(kw))
        Capture.step += 1
        return kernel(*args, **kw)

    setattr(Capture, "advance_bucket" if fused else "advance", staticmethod(keep))
    ep._walk(Capture, mesh, pg, starts, 0, 0, walk_length=WALK_LENGTH, return_param=0.25,
             inout_param=4.0, max_trials=64, capacity=WALKERS, slack=4, axis_name="data",
             stats=None)
    torch.distributed.destroy_process_group()
    geo = dict(n_shards=1, capacity=WALKERS, rows_per_shard=pg.rows_per_shard,
               walk_length=WALK_LENGTH)
    return Capture.got, Capture.late, geo


def advance_runner(args, kw, geo):
    """(restore, run, plain) of one captured advance: ``run()`` makes the
    tree's calls for it on a working copy of the state (the thread design: K23
    and the next superstep's K20 phase A; the fused design: its one launch),
    ``restore()`` puts the state back, ``plain()`` makes the plain versions'
    on another copy; both return (carry, paths, n_fb, send, slot, pending)."""
    from node2vec_torch.parallel import edge_partitioned_blocked as ep

    state = [a.clone() for a in args[:3]]
    work = [a.clone() for a in state]
    rest = args[3:]
    seed, gid = args[7], args[8]
    adv_kw = {k: kw[k] for k in ("walk_length", "max_trials", "return_param", "inout_param")}

    def restore():
        for w, s in zip(work, state):
            w.copy_(s)

    if hasattr(ep, "ep_advance_bucket"):
        def run():
            send, slot, pending = ep.ep_advance_bucket(*work, *rest, **kw)
            return (*work, send, slot, pending)
    else:
        def run():
            pending = ep.ep_advance(*work, *rest, **adv_kw)
            send, slot = ep.ep_bucket(work[0], seed, gid, **geo)
            return (*work, send, slot, pending)

    def plain():
        copy = [s.clone() for s in state]
        pending = ep.ep_advance_plain(*copy, *rest, **adv_kw)
        send, slot = ep.ep_bucket_plain(copy[0], seed, gid, **geo)
        return (*copy, send, slot, pending)

    return restore, run, plain


def k14_inputs():
    """(tab_in, tab_out, lists, lr) at ``main_path_fused``'s first batch, as
    ``chip_smoke.check_fused`` makes them (the gradients by the tree's K2)."""
    import torch

    import chip_smoke as cs
    from node2vec_torch.graph import build_graph
    from node2vec_torch.models import skipgram as sg
    from node2vec_torch.models.word2vec import _effective_batch

    src, dst = cs.smoke_edges(131072, 2_097_152)
    g = build_graph((src, dst), directed=False)
    ep_ = cs._pair_epoch(g)
    first = (ep_["corpus"][:ep_["batch"]].contiguous(), ep_["tables"][2])
    batch = _effective_batch(8192, 10 * 131072)
    inp = cs._batch_inputs(131072, batch, 21, 128, 5, 13, 0.1, first)
    emb_in, emb_out, acc_in, acc_out = inp["state"]
    tab_in = torch.cat([emb_in, acc_in[:, None]], dim=1).contiguous()
    tab_out = torch.cat([emb_out, acc_out[:, None]], dim=1).contiguous()
    walks_flat = inp["walks"].reshape(-1)
    neg = inp["neg"].clone()
    neg[0] = walks_flat[int(torch.nonzero(walks_flat >= 0)[0])]
    g_in, g_out, d_no = sg.sgns_grads(tab_in, tab_out, inp["walks"], inp["mask"], inp["b_sh"],
                                      neg, dim=128, window=5, negatives=5)[:3]
    return tab_in, tab_out, (g_in, walks_flat, g_out, walks_flat, d_no, neg), 0.05


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    srcs, designs = sources(os.path.join(tree, "node2vec_torch", "csrc"))
    if args.check:
        emit({"tree": tree, "designs": {k: v[0] for k, v in designs.items()},
              "patches_apply": True})
        return 0
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from node2vec_torch.models import skipgram as sg
    from node2vec_torch.parallel import edge_partitioned_blocked as ep

    libs = build(srcs, os.path.join(ROOT, "build", "advance_adagrad_attribution"),
                 lambda name: "ep_" if name == "advance" else "fused")  # ptxas of each
    got, late, geo = advance_calls()
    design, prefixes = designs["advance"]
    for key, (a, kw) in sorted(got.items()):
        restore, run, plain = advance_runner(a, kw, geo)
        restore()
        want = [t.clone() for t in plain()]
        c0 = a[0]
        line = {"kernel": "ep_advance (+ next K20 phase A)", "design": design,
                "superstep": 1 if key == "second" else late[0],
                "active_lanes": int(((c0[ep.ALIVE] != 0) & (c0[ep.T] < WALK_LENGTH)).sum()),
                "sent_lanes": int((a[3] < kw.get("capacity", WALKERS)).sum()),
                "ms": cs.time_ms(run, reps=20, before=restore)}
        restore()
        line["bit_equal_to_plain"] = all(torch.equal(x, y) for x, y in zip(run(), want))
        with swapped(libs["advance"]):
            restore()
            line["probed_bit_equal"] = all(torch.equal(x, y) for x, y in zip(run(), want))

            def probed():
                restore()
                run()
            for prefix, phases in prefixes:
                line["probes"] = profile(libs["advance"], prefix, probed, phases, reps=10)
        emit(line)
    del got

    tab_in, tab_out, lists, lr = k14_inputs()
    design, prefixes = designs["k14"]
    t_in, t_out = tab_in.clone(), tab_out.clone()

    def restore14():
        t_in.copy_(tab_in)
        t_out.copy_(tab_out)

    def run14():
        sg.fused_adagrad(t_in, t_out, *lists, lr)

    q_in, q_out = tab_in.clone(), tab_out.clone()
    sg.fused_adagrad_plain(q_in, q_out, *lists, lr)
    restore14()
    run14()
    line = {"kernel": "fused_adagrad", "design": design, "rows": int(
        sum(x.shape[0] for x in lists[1::2])), "live_rows": int(
        sum(int((x >= 0).sum()) for x in lists[1::2])),
        "ms": cs.time_ms(run14, reps=20, before=restore14),
        "max_abs_err": max(float((t_in - q_in).abs().max()), float((t_out - q_out).abs().max()))}
    with swapped(libs["k14"]):
        def probed14():
            restore14()
            run14()
        line["probes"] = {prefix: profile(libs["k14"], prefix, probed14, phases, reps=10)
                          for prefix, phases in prefixes}
    line["variants"] = {}
    for name in [k for k in libs if k.startswith("k14: ")]:
        with swapped(libs[name]):
            line["variants"][name[5:]] = {"ms": cs.time_ms(run14, reps=20, before=restore14)}
            if name.endswith(("scalar rows", "bulk reduce")):
                restore14()
                run14()
                line["variants"][name[5:]]["max_abs_err"] = max(
                    float((t_in - q_in).abs().max()), float((t_out - q_out).abs().max()))
    emit(line)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
