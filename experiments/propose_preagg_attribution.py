#!/usr/bin/env python3
"""Where K21 ``ep_propose`` and K11 ``preagg_rows`` spend their time, on one
card: ``clock64()`` at each phase, in patched copies of their sources, and
K21's time at every superstep of a chunk.

    python3 experiments/propose_preagg_attribution.py [--tree DIR] [--one-warp DIR]
    python3 experiments/propose_preagg_attribution.py --check [--tree DIR] [--one-warp DIR]

TREE is the root of a checkout (this repository's by default; a parent's
unpacked ``git archive`` for a before/after).  ``--one-warp DIR`` adds K21's
first design, a warp a request, from the kernel directory of the commit
before 1fcc9f3 (``git archive 1fcc9f3^ node2vec_torch/csrc | tar -x -C
DIR``; DIR then holds ``node2vec_torch/csrc``), built beside the tree's with
its own headers; its C entry has the same signature, so the tree's wrapper
calls it.  Each source is patched (``_variants.py``), built, and called
through the tree's wrappers with the probed library swapped in for the
port's.  The patch sets follow the designs the files have had; the set whose
anchors match is used, and ``--check`` says which (it fails when none does):

* K21, ``one warp`` (a warp a request, a lane a light column and a 32-byte
  run of a heavy block); ``groups`` (an 8-lane group a request, four a warp,
  the warp's heavy branch taken when any of its four is heavy, each lane
  reading its own 128-byte run of the block from global memory); ``staged``
  (the groups, with a heavy block copied into the group's shared buffer by
  coalesced cp.async and scanned there; timed also at 7 blocks an SM and at
  4 warps a block).  The phases of a warp with a request; warps whose slots
  are all empty are counted apart (``k21e``).
* K11, ``three launches`` (claim, sum with scalar atomics, reset; the sum's
  loads and its atomics apart) and ``one launch`` (a cooperative grid:
  claim, every row written once, the repeats added with 16-byte atomics,
  the slot map reset; a warp's ids and slots loaded 32 rows at a time, two
  rows' floats in flight, the write phase from the last rows down).  Each
  launch's or phase's time also by variants that stop after it, and the
  one-launch design without its 16-byte atomics, with every row scalar and
  with its write phase in ascending rows.

Inputs: K21 at ``main_path_ep``'s first chunk (the scale-19 RMAT on the 1 x
1 mesh's one shard, 131,072 walkers of 20 at (p, q) = (0.25, 4), full
capacity): every superstep's requests are kept, each timed (CUDA events,
20 calls), summed over the chunk and held bit-equal to
``ep_propose_plain``; the phases at the second superstep and at the first
with under 10% of the walkers active, with the requests' shape (valid,
heavy, warps by their heavy requests).  K11 at ``main_path_sgd``'s batch
(2,570 of the dense graph's first-chunk walks, shuffled, D = 128, the
gradients by ``sgns_grads_plain``), as ``chip_smoke.check_preagg`` makes it:
its time, its rows (live, distinct vertices, repeats), its phases and
variants; every result held to the plain version (heads and counts exact,
the sums to rtol of their largest entry, the slot map empty).  Prints one
JSON line a measurement, ptxas's registers and spills of each build first,
then the card's name and power limit.  Neither the port nor the smoke
imports this file.
"""

import argparse
import contextlib
import json
import os
import sys

from _variants import (ROOT, PROBE_START, build, card, patched, phase_read, probe_counters,
                       probe_flush, probes, profile, source)

WALKERS, WALK_LENGTH, PQ = 131072, 20, (0.25, 4.0)

# ---- K21 ------------------------------------------------------------------

_K21_HEAD = ("float alpha_hi, int mode, int p_l, int c) {\n"
             "  __shared__ __align__(16) int32_t rows[kReqs][n2v::kLightRow];\n")

K21_GROUPS = ["request field 0, the empty test", "light row landed", "light scan, target, pick",
              "heavy: header, block loads and scan", "heavy: prefix, id, weight, pair",
              "response stored"]


def k21_groups_patches() -> list:
    p = probes(len(K21_GROUPS))
    return [
        (_K21_HEAD, _K21_HEAD + "  " + PROBE_START),
        ("  if (!__any_sync(n2v::kFullMask, on)) return;  // warp-uniform; no block barrier below\n",
         "  if (!__any_sync(n2v::kFullMask, on)) {\n  " + probes(1)[0] + "\n"
         + probe_flush("k21e", 1) + "  return;\n  }\n  " + p[0] + "\n"),
        ("  n2v::copies_wait();\n\n  const int maxb",
         f"  n2v::copies_wait();\n  {p[1]}\n\n  const int maxb"),
        ("          pfx = row[3 * p_l + ls];\n",
         f"          pfx = row[3 * p_l + ls];\n  {p[2]}\n"),
        ("    const int below = n2v::block_below(cols, k4, resid, gl, hv, &excl);\n",
         f"    const int below = n2v::block_below(cols, k4, resid, gl, hv, &excl);\n    {p[3]}\n"),
        ("      pfx = pair.y;\n    }\n  }\n", f"      pfx = pair.y;\n    }}\n    {p[4]}\n  }}\n"),
        ("    out[5] = take_back ? 1 : 0;\n  }\n}\n",
         f"    out[5] = take_back ? 1 : 0;\n  }}\n  {p[5]}\n{probe_flush('k21', len(K21_GROUPS))}}}\n"),
    ]


K21_WARP = ["request field 0, the empty test", "light row loaded", "scan inputs, target",
            "heavy: block loads and scan", "pick, prefix, id, weight, pair", "response stored"]


def k21_warp_patches() -> list:
    p = probes(len(K21_WARP))
    return [
        (_K21_HEAD.replace("kReqs", "kReqWarps"),
         _K21_HEAD.replace("kReqs", "kReqWarps") + "  " + PROBE_START),
        ("  if (cur < 0) {\n    if (lane < kResp) out[lane] = -1;\n    return;\n  }\n",
         "  if (cur < 0) {\n    if (lane < kResp) out[lane] = -1;\n  " + probes(1)[0] + "\n"
         + probe_flush("k21e", 1) + "    return;\n  }\n  " + p[0] + "\n"),
        ("  n2v::load_row(row, light + lv * n2v::kLightRow, lane);\n\n  const int maxb",
         f"  n2v::load_row(row, light + lv * n2v::kLightRow, lane);\n  {p[1]}\n\n  const int maxb"),
        ("  int32_t cand, wbits, rev, pfx;\n  float ppfx;\n",
         f"  {p[2]}\n  int32_t cand, wbits, rev, pfx;\n  float ppfx;\n"),
        ("    const int below = n2v::block_below(w_row, col0, k, resid, lane, &excl);\n",
         f"    const int below = n2v::block_below(w_row, col0, k, resid, lane, &excl);\n    {p[3]}\n"),
        ("    pfx = pair.y;\n  }\n  if (lane == 0) {\n", f"    pfx = pair.y;\n  }}\n  {p[4]}\n"
         "  if (lane == 0) {\n"),
        ("    out[5] = take_back ? 1 : 0;\n  }\n}\n",
         f"    out[5] = take_back ? 1 : 0;\n  }}\n  {p[5]}\n{probe_flush('k21', len(K21_WARP))}}}\n"),
    ]


_K21_STAGED_HEAD = ("float alpha_hi, int mode, int p_l, int c) {\n  __shared__ __align__(16) "
                    "int32_t rows[kReqs][kStaged ? kStageCols : n2v::kLightRow];\n")

K21_STAGED = ["request field 0, the empty test", "light row landed", "light scan, target, pick",
              "heavy: header, block landed in shared memory", "heavy: block scan and prefix",
              "heavy: id, weight, pair", "response stored"]


def k21_staged_patches() -> list:
    p = probes(len(K21_STAGED))
    return [
        (_K21_STAGED_HEAD, _K21_STAGED_HEAD + "  " + PROBE_START),
        ("  if (!__any_sync(n2v::kFullMask, on)) return;  // warp-uniform; no block barrier below\n",
         "  if (!__any_sync(n2v::kFullMask, on)) {\n  " + probes(1)[0] + "\n"
         + probe_flush("k21e", 1) + "  return;\n  }\n  " + p[0] + "\n"),
        ("  n2v::copies_wait();\n\n  const int maxb",
         f"  n2v::copies_wait();\n  {p[1]}\n\n  const int maxb"),
        ("          pfx = row[3 * p_l + ls];\n",
         f"          pfx = row[3 * p_l + ls];\n  {p[2]}\n"),
        ("      n2v::copies_wait();\n      const StagedCols",
         f"      n2v::copies_wait();\n      {p[3]}\n      const StagedCols"),
        ("      pc = n2v::block_prefix_before(cols, k4, excl, slot, gl, hv);\n    } else {",
         f"      pc = n2v::block_prefix_before(cols, k4, excl, slot, gl, hv);\n      {p[4]}\n"
         "    } else {"),
        ("      pfx = pair.y;\n    }\n  }\n", f"      pfx = pair.y;\n    }}\n    {p[5]}\n  }}\n"),
        ("    out[5] = take_back ? 1 : 0;\n  }\n}\n",
         f"    out[5] = take_back ? 1 : 0;\n  }}\n  {p[6]}\n{probe_flush('k21', len(K21_STAGED))}}}\n"),
    ]


# timed only: the staged design at other occupancies
K21_STAGED_VARIANTS = {
    "7 blocks an SM (<= 36 registers)": [
        ("template <bool kStaged>\n__global__ void __launch_bounds__(kReqWarps * 32)\nep_propose_kernel",
         "template <bool kStaged>\n__global__ void __launch_bounds__(kReqWarps * 32, 7)\n"
         "ep_propose_kernel")],
    "4 warps a block": [("constexpr int kReqWarps = 8;", "constexpr int kReqWarps = 4;")],
}

K21_DESIGNS = (("groups", k21_groups_patches, K21_GROUPS),
               ("one warp", k21_warp_patches, K21_WARP),
               ("staged", k21_staged_patches, K21_STAGED))

# ---- K11 ------------------------------------------------------------------

K11_CLAIM = ["output rows zeroed", "count zeroed, atomicMin"]
K11_SUM = ["slot read, head stored", "gradient loads landed", "scalar atomics issued"]


def k11_three_patches() -> list:
    c, s = probes(len(K11_CLAIM)), probes(len(K11_SUM))
    return [
        ("  if (r >= n) return;\n  float* a = ga_in + r * dim;\n",
         "  if (r >= n) return;\n  " + PROBE_START + "  float* a = ga_in + r * dim;\n"),
        ("    b[k] = 0.f;\n  }\n", f"    b[k] = 0.f;\n  }}\n  {c[0]}\n"),
        ("    if (v >= 0) atomicMin(slot + v, static_cast<int32_t>(r));\n  }\n}\n",
         f"    if (v >= 0) atomicMin(slot + v, static_cast<int32_t>(r));\n  }}\n  {c[1]}\n"
         f"{probe_flush('k11c', len(K11_CLAIM))}}}\n"),
        ("  const int64_t rep = v >= 0 ? slot[v] : -1;\n",
         "  " + PROBE_START + "  const int64_t rep = v >= 0 ? slot[v] : -1;\n"),
        # the sum's loads first, waited for, then its atomics (the same adds)
        ("  if (v < 0) return;\n  const float* gi", f"  if (v < 0) return;\n  {s[0]}\n  const float* gi"),
        ("  for (int k = lane; k < dim; k += 32) {\n    atomicAdd(a + k, gi[k]);\n"
         "    atomicAdd(b + k, go[k]);\n  }\n  if (lane == 0) atomicAdd(cnt + rep, 1.f);\n}\n",
         "  float vi[8], vo[8], ws = 0.f;\n#pragma unroll\n  for (int j = 0; j < 8; ++j) {\n"
         "    const int k = lane + 32 * j;\n    vi[j] = k < dim ? gi[k] : 0.f;\n"
         "    vo[j] = k < dim ? go[k] : 0.f;\n  }\n#pragma unroll\n"
         "  for (int j = 0; j < 8; ++j) ws += vi[j] + vo[j];\n  int wsr;\n"
         "  asm volatile(\"mov.b32 %0, %1;\" : \"=r\"(wsr) : \"f\"(ws));\n"
         f"  {s[1]}\n#pragma unroll\n  for (int j = 0; j < 8; ++j) {{\n"
         "    const int k = lane + 32 * j;\n    if (k < dim) {\n      atomicAdd(a + k, vi[j]);\n"
         "      atomicAdd(b + k, vo[j]);\n    }\n  }\n  for (int k = lane + 256; k < dim; k += 32) {\n"
         "    atomicAdd(a + k, gi[k]);\n    atomicAdd(b + k, go[k]);\n  }\n"
         "  if (lane == 0) atomicAdd(cnt + rep, 1.f);\n"
         f"  {s[2]}\n  if (wsr == 0x7fc00001) heads[r] = -7;\n"
         f"{probe_flush('k11s', len(K11_SUM))}}}\n"),
    ]


# timed only: the launches up to one of them
K11_THREE_VARIANTS = {
    "claim only": [("  preagg_sum_kernel<<<", "  if (n < 0) preagg_sum_kernel<<<"),
                   ("  preagg_reset_kernel<<<", "  if (n < 0) preagg_reset_kernel<<<")],
    "claim and sum": [("  preagg_reset_kernel<<<", "  if (n < 0) preagg_reset_kernel<<<")],
}

K11_ONE = ["claim: atomicMin", "grid barrier 1", "write: heads' rows, zeros",
           "grid barrier 2", "add: the repeats' 16-byte atomics, slot reset"]
_SYNC1 = "  cg::this_grid().sync();\n\n  const int64_t mine"
_SYNC2 = "  cg::this_grid().sync();\n\n  for (int64_t k0 = 0;"


def k11_one_patches() -> list:
    p = probes(len(K11_ONE))
    return [
        ("  const int lane = threadIdx.x & 31;\n  const int64_t n_warps",
         "  const int lane = threadIdx.x & 31;\n  " + PROBE_START + "  const int64_t n_warps"),
        (_SYNC1, f"  {p[0]}\n" + _SYNC1.replace("\n\n", f"\n  {p[1]}\n\n")),
        (_SYNC2, f"  {p[2]}\n" + _SYNC2.replace("\n\n", f"\n  {p[3]}\n\n")),
        ("      add_rows<kVec>(a.ga_out, a.g_out, a.dim, lane, ra, ha, rb, hb);\n    }\n  }\n}\n",
         "      add_rows<kVec>(a.ga_out, a.g_out, a.dim, lane, ra, ha, rb, hb);\n    }\n  }\n"
         f"  {p[4]}\n{probe_flush('k11o', len(K11_ONE))}}}\n"),
    ]


# timed only (their sums or slot maps differ, but "scalar rows")
K11_ONE_VARIANTS = {
    "claim only": [(_SYNC1, "  return;\n  const int64_t mine")],
    "claim and write": [(_SYNC2, "  return;\n  for (int64_t k0 = 0;")],
    "no 16-byte atomics": [("      atomicAdd(d + ha * nc + c, x);\n      if (b >= 0) atomicAdd(d + hb * nc + c, y);\n",
                            "      if (x.x == 1234.5f) d[ha * nc + c] = x;\n"
                            "      if (y.x == 1234.5f) d[hb * nc + c] = y;\n")],
    "scalar rows": [("  const bool vec = dim % 4 == 0 &&", "  const bool vec = dim < 0 &&")],
    "write phase in ascending rows": [
        ("  for (int64_t k0 = (mine - 1) / 32 * 32; k0 >= 0 && mine > 0; k0 -= 32) {",
         "  for (int64_t k0 = 0; k0 < mine; k0 += 32) {")],
}

K11_DESIGNS = (("three launches", k11_three_patches,
                [("k11c", K11_CLAIM), ("k11s", K11_SUM)], K11_THREE_VARIANTS),
               ("one launch", k11_one_patches, [("k11o", K11_ONE)], K11_ONE_VARIANTS))


def _pick(src: str, designs):
    for design in designs:
        if all(src.count(old) == 1 for old, _ in design[1]()):
            return design
    return None


def sources(csrc: str, one_warp: str = None):
    """({library: (source, nvcc flags)}, {library: (design, [(prefix, phases)])})."""
    srcs, designs = {}, {}
    trees = [("k21", csrc)] + ([("k21 one warp", one_warp)] if one_warp else [])
    for lib, where in trees:
        ep_src = source("ep_walk.cu", where)
        got = _pick(ep_src, K21_DESIGNS)
        if got is None:
            raise SystemExit(f"no K21 patch set applies to {where}/ep_walk.cu")
        design, patches, phases = got
        prefixes = [("k21", phases), ("k21e", ["empty warp"])]
        srcs[lib] = (ep_src, [])
        if design == "staged":
            for name, pairs in K21_STAGED_VARIANTS.items():
                srcs[f"{lib}: {name}"] = (patched(ep_src, pairs), [])
        srcs[lib + " probed"] = ("".join(probe_counters(p) for p, _ in prefixes)
                                 + patched(ep_src, patches())
                                 + "".join(phase_read(p) for p, _ in prefixes), [])
        designs[lib] = (design, prefixes)
    k11_src = source("preagg.cu", csrc)
    got = _pick(k11_src, K11_DESIGNS)
    if got is None:
        raise SystemExit("no K11 patch set applies to preagg.cu")
    design, patches, prefixes, variants = got
    srcs["k11 probed"] = ("".join(probe_counters(p) for p, _ in prefixes)
                          + patched(k11_src, patches())
                          + "".join(phase_read(p) for p, _ in prefixes), [])
    designs["k11"] = (design, prefixes)
    for name, pairs in variants.items():
        srcs["k11: " + name] = (patched(k11_src, pairs), [])
    return srcs, designs


@contextlib.contextmanager
def swapped(lib):
    """The tree's wrappers call ``lib`` (each C entry's argtypes copied from
    the port's library) while the block runs."""
    from node2vec_torch import _build

    port = _build.lib()
    for name in ("n2v_ep_propose", "n2v_preagg_rows", "n2v_error_string"):
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


def propose_calls():
    """Every K21 call of ``main_path_ep``'s first chunk, walked through the
    tree's kernels: (a list of each superstep's requests, the tables, the
    wrapper's keywords, the walkers active at each superstep)."""
    import torch

    import chip_smoke as cs
    from node2vec_torch.parallel import edge_partitioned_blocked as ep
    from node2vec_torch.parallel import make_mesh

    dev = torch.device("cuda")
    _, _, g_rmat = cs.rmat_graph(19)
    mesh = make_mesh(1, 1, device="cuda")
    pg = ep.partition_blocked_graph(g_rmat.indptr, g_rmat.indices, g_rmat.weights, 1, mesh=mesh)
    starts = torch.arange(WALKERS, dtype=torch.int32, device=dev) % g_rmat.n_vertices

    class Capture(ep._Kernels):
        calls, active, kw = [], [], {}

    def keep_propose(recv, *tables, **kw):
        Capture.calls.append(recv.clone())
        Capture.kw = kw
        return ep.ep_propose(recv, *tables, **kw)

    def keep_bucket(carry, *args, **kw):
        if kw.get("slot_a") is not None:  # phase B: the superstep's state, before its advance
            Capture.active.append(int(((carry[ep.ALIVE] != 0) & (carry[ep.T] < WALK_LENGTH)).sum()))
        return ep.ep_bucket(carry, *args, **kw)

    Capture.propose = staticmethod(keep_propose)
    Capture.bucket = staticmethod(keep_bucket)
    ep._walk(Capture, mesh, pg, starts, 0, 0, walk_length=WALK_LENGTH, return_param=PQ[0],
             inout_param=PQ[1], max_trials=64, capacity=WALKERS, slack=4, axis_name="data",
             stats=None)
    torch.distributed.destroy_process_group()
    return Capture.calls, ep.local_tables(pg, 0), Capture.kw, Capture.active


def request_shape(recv, light, row_base: int) -> dict:
    """Valid requests, heavy ones, and the four-slot warps of the groups
    design by their heavy requests (all-empty warps apart)."""
    import torch

    valid = recv[:, 0] >= 0
    lv = (recv[:, 0].long() - row_base).clamp(0, light.shape[0] - 1)
    heavy = valid & (light[lv, 0] < -1)
    n4 = -(-recv.shape[0] // 4) * 4
    pad = torch.zeros(n4 - recv.shape[0], dtype=torch.bool, device=recv.device)
    v4 = torch.cat([valid, pad]).view(-1, 4).sum(1)
    h4 = torch.cat([heavy, pad]).view(-1, 4).sum(1)
    return {"slots": int(recv.shape[0]), "valid": int(valid.sum()), "heavy": int(heavy.sum()),
            "last_valid_slot": int(torch.nonzero(valid).max()) if bool(valid.any()) else -1,
            "warps_all_empty": int((v4 == 0).sum()),
            "warps_by_heavy": [int(((v4 > 0) & (h4 == k)).sum()) for k in range(5)]}


def preagg_inputs():
    """K11's inputs at ``main_path_sgd``'s batch, as ``check_preagg`` makes
    them: (rows [N], g_in, g_out, V)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from node2vec_torch.graph import build_graph
    from node2vec_torch.models import skipgram as sg
    from node2vec_torch.models.word2vec import _effective_batch
    from node2vec_torch.walk.engine import Node2VecParams, WalkEngine

    src, dst = cs.smoke_edges(131072, 2_097_152)
    g = build_graph((src, dst), directed=False)
    batch = _effective_batch(8192, 131072, target_updates=51)
    chunk0 = WalkEngine(g, Node2VecParams(**cs.N2V_MAIN), device="cuda").chunk_source(seed=0)[2](0)
    walks = chunk0.cpu().numpy()[np.random.default_rng(0).permutation(len(chunk0))][:batch]
    inp = cs._preagg_inputs(131072, walks, 128, 5, seed=13)
    emb_in, emb_out = inp["state"][:2]
    g_in, g_out = sg.sgns_grads_plain(emb_in, emb_out, inp["walks"], inp["mask"], inp["b_sh"],
                                      inp["neg"], window=5, negatives=5)[:2]
    del emb_in, emb_out
    torch.cuda.empty_cache()
    return inp["walks"].reshape(-1).contiguous(), g_in, g_out, 131072


def preagg_verdict(got, want, slot) -> dict:
    """K11's result against the plain version's."""
    import torch

    from node2vec_torch.models import skipgram as sg

    torch.cuda.synchronize()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    return {"heads_equal": bool(torch.equal(got[2], want[2])),
            "counts_equal": bool(torch.equal(got[3], want[3])),
            "slot_map_empty": bool((slot == sg.SLOT_EMPTY).all()),
            "sums_err_over_largest": max(rel(got[0], want[0]), rel(got[1], want[1]))}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--one-warp", default=None,
                    help="a directory holding the one-warp design's node2vec_torch/csrc")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    one_warp = (os.path.join(os.path.abspath(args.one_warp), "node2vec_torch", "csrc")
                if args.one_warp else None)
    srcs, designs = sources(os.path.join(tree, "node2vec_torch", "csrc"), one_warp)
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

    libs = build(srcs, os.path.join(ROOT, "build", "propose_preagg_attribution"),
                 lambda name: "ep_propose" if name.startswith("k21") else "preagg")
    calls, tables, kw, active = propose_calls()
    light, biw, _, brp = tables
    row_base = kw["my_shard"] * kw["rows_per_shard"]
    late = next(i for i, a in enumerate(active) if i > 1 and a < 0.1 * WALKERS)
    k21_libs = [k for k in designs if k.startswith("k21")]
    variants = [k for k in libs if k.startswith("k21") and ": " in k]
    sums = {k: 0.0 for k in k21_libs}
    equal = {k: True for k in k21_libs}
    per_step = []
    for i, recv in enumerate(calls):
        want = ep.ep_propose_plain(recv, light, biw, brp, **kw)
        row = {"superstep": i, "active": active[i], "valid": int((recv[:, 0] >= 0).sum())}
        for k in k21_libs:
            with swapped(libs[k]):
                equal[k] &= bool(torch.equal(ep.ep_propose(recv, light, biw, brp, **kw), want))
                ms = cs.time_ms(lambda: ep.ep_propose(recv, light, biw, brp, **kw), reps=20)
            row[k] = ms
            sums[k] += ms
        per_step.append(row)
    emit({"kernel": "ep_propose", "chunk": "main_path_ep's first", "supersteps": len(calls),
          "designs": {k: designs[k][0] for k in k21_libs}, "ms_summed_over_the_chunk": sums,
          "bit_equal_to_plain_every_superstep": equal, "late_superstep": late,
          "per_superstep": per_step})
    for i in (1, late):
        recv = calls[i]
        line = {"kernel": "ep_propose", "superstep": i, "active": active[i],
                **request_shape(recv, light, row_base)}
        want = ep.ep_propose_plain(recv, light, biw, brp, **kw)
        for k in k21_libs:
            design, prefixes = designs[k]
            entry = line[k] = {"design": design}
            with swapped(libs[k]):
                entry["ms"] = cs.time_ms(lambda: ep.ep_propose(recv, light, biw, brp, **kw),
                                         reps=20)
            for name in [v for v in variants if v.startswith(k + ": ")]:
                with swapped(libs[name]):
                    entry.setdefault("variants", {})[name[len(k) + 2:]] = {
                        "ms": cs.time_ms(lambda: ep.ep_propose(recv, light, biw, brp, **kw),
                                         reps=20),
                        "bit_equal": bool(torch.equal(ep.ep_propose(recv, light, biw, brp, **kw),
                                                      want))}
            with swapped(libs[k + " probed"]):
                entry["probed_bit_equal"] = bool(torch.equal(
                    ep.ep_propose(recv, light, biw, brp, **kw), want))
                for prefix, phases in prefixes:
                    entry[prefix] = profile(libs[k + " probed"], prefix,
                                            lambda: ep.ep_propose(recv, light, biw, brp, **kw),
                                            phases, reps=10)
        emit(line)
    del calls, tables, light, biw, brp

    flat, g_in, g_out, n_v = preagg_inputs()
    want = sg.preagg_rows_plain(flat, g_in, g_out)
    slot = sg.new_slot_map(n_v, flat.device)
    live = flat[flat >= 0]
    design, prefixes = designs["k11"]

    def call():
        return sg.preagg_rows(flat, g_in, g_out, slot)

    def reset():
        slot.fill_(sg.SLOT_EMPTY)

    line = {"kernel": "preagg_rows", "design": design, "rows": int(flat.numel()),
            "live_rows": int(live.numel()), "distinct_vertices": int(torch.unique(live).numel()),
            "D": int(g_in.shape[1])}
    line["repeated_rows"] = line["live_rows"] - line["distinct_vertices"]
    line.update(preagg_verdict(call(), want, slot))
    line["ms"] = cs.time_ms(call, reps=20)
    line["ms_with_reset_before"] = cs.time_ms(call, reps=20, before=reset)
    with swapped(libs["k11 probed"]):
        line["probed"] = preagg_verdict(call(), want, slot)
        for prefix, phases in prefixes:
            line[prefix] = profile(libs["k11 probed"], prefix, call, phases, reps=10)
    line["variants_ms"] = {}
    for name in [k for k in libs if k.startswith("k11: ")]:
        with swapped(libs[name]):
            line["variants_ms"][name[5:]] = cs.time_ms(call, reps=20, before=reset)
            if name.endswith("scalar rows"):
                reset()
                line["variants_ms"]["scalar rows verdict"] = preagg_verdict(call(), want, slot)
    reset()
    emit(line)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
