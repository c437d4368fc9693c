#!/usr/bin/env python3
"""Where K25 ``epd_serve`` and K3's squares mode ``adagrad_accumulate_squares``
spend their time, on one card: ``clock64()`` at each phase, in patched copies
of their sources, K25's time at every superstep of a chunk, and the shape of
K3's squares lists.

    python3 experiments/serve_squares_attribution.py [--tree DIR] [--only k25|k3s]
    python3 experiments/serve_squares_attribution.py --check [--tree DIR]

TREE is the root of a checkout (this repository's by default; a parent's
unpacked ``git archive`` for a before/after).  Each source is patched
(``_variants.py``), built, and called through the tree's wrappers with the
probed library swapped in for the port's.  The patch sets follow the designs
the files have had; the set whose anchors match is used, and ``--check`` says
which (it fails when none does):

* K25, ``warp a request`` (a warp a request, N(prev) staged in shared memory
  and scanned whole for each column: ``dense_common.cuh``'s
  ``dense_bias_total``) and ``bisect`` (a persistent grid, a warp's next
  request's header and row in flight while it serves the current one, N(prev)
  bisected where it is sorted, scanned where it is not).  The phases of a warp
  with a request: header, N(prev) staged, row landed, membership, total, scan
  and pick, response; warps whose slot is empty are counted apart (``k25e``).
* K3's squares mode, ``thread a row`` (one thread an entry: its ``locate``,
  id and square loads, one fp32 atomic) and ``hot array`` (blocks of 512
  threads, as many as the card holds, striding over quads of entries by
  16-byte loads, a quad a thread a pass, dead entries dropped, acc_out rows
  below 8,192 summed in a block's shared array flushed once where a pass
  holds 256 of them or more (sent straight out otherwise), other keys
  summed in a warp's slot by ``__match_any_sync`` where adjacent lanes repeat
  one, before their global atomic).  The phases of a warp: loads, atomics
  issued, the flush.  Variants: no global atomic (a store that never fires),
  each part of the design taken out or forced, other block sizes and hot
  ranges; and the same lists with every live id made distinct (data, not a
  patch).

Inputs: K25 at ``check_ep_dense``'s chunk (the dense graph's packed adjacency,
P = 64, as the 1 x 1 mesh's one shard, 131,072 walkers of 20 at (0.25, 4),
full capacity, the default draws of seed 0): every superstep's requests are
kept, each call timed (CUDA events, 20 calls), summed over the chunk and held
bit-equal to ``epd_serve_plain``; the phases at the second and the last
superstep, with the registers, shared memory and waves.  K3's squares mode
at ``main_path_cbow_hs``'s batch (``check_cbow``'s inputs: 2,570 of the dense
graph's first-chunk walks, shuffled, D = 128, the squares of
``cbow_hs_grads_plain``), at the column step's (``check_col_sgns``'s:
``main_path_pairs``' first batch at Dm = D) and at the row owners' (the
distinct ids of that batch's centers and of its contexts and negatives, as
K18 hands them to one owner, each with a square): its time, its lists (live,
dead, distinct; each tail level's repeats; the entries combining would save
in windows of 4 to 4,096), its phases and variants, held to the plain version
(rtol 1e-4, atol 1e-6).  Prints one JSON line a measurement, ptxas's
registers and spills of each build first, then the card's name and power
limit.  Neither the port nor the smoke imports this file.
"""

import argparse
import contextlib
import json
import os
import re
import sys

from _variants import (REPORTS, ROOT, PROBE_START, build, card, patched, phase_read,
                       probe_counters, probe_flush, probes, profile, source)

WALKERS, WALK_LENGTH, PQ = 131072, 20, (0.25, 4.0)
WARPS_A_SM, REGS_A_SM, SMEM_A_SM = 64, 65536, 228 * 1024
SMS = 132

# ---- K25 ------------------------------------------------------------------

K25_WARP = ["request header", "N(prev) staged", "row landed", "membership",
            "total, scan and pick", "response stored"]

# the membership and the total of dense_bias_total, written out so that a
# probe can sit between them (the same operations in the same order)
_K25_TOTAL_CALL = (
    "  float lane_sum;\n"
    "  const float total = n2v::dense_bias_total(ids, bw, prev_rows, prev, p_cols, k, col0, inv_p,\n"
    "                                            inv_q, uniform_bias, lane_sum);\n")


def _k25_total_split(p_member: str) -> str:
    return (
        "  float lane_sum;\n"
        "  if (!uniform_bias && prev >= 0) {\n"
        "#pragma unroll\n"
        "    for (int m = 0; m < kMaxK; ++m) {\n"
        "      if (m < k && col0 + m < p_cols) {\n"
        "        float bias;\n"
        "        if (ids[m] == prev) {\n"
        "          bias = inv_p;\n"
        "        } else {\n"
        "          bool shared = false;\n"
        "          for (int j = 0; j < p_cols; ++j) shared |= prev_rows[j] == ids[m];\n"
        "          bias = shared ? 1.f : inv_q;\n"
        "        }\n"
        "        bw[m] = __fmul_rn(bw[m], bias);\n"
        "      }\n"
        "    }\n"
        "  }\n"
        f"  {{ float _w = 0.f; for (int m = 0; m < kMaxK; ++m) _w += bw[m];\n"
        "    int _r; asm volatile(\"mov.b32 %0, %1;\" : \"=r\"(_r) : \"f\"(_w)); }\n"
        f"  {p_member}\n"
        "  lane_sum = 0.f;\n"
        "#pragma unroll\n"
        "  for (int m = 0; m < kMaxK; ++m) lane_sum = __fadd_rn(lane_sum, bw[m]);\n"
        "  float total = lane_sum;\n"
        "#pragma unroll\n"
        "  for (int off = 16; off > 0; off >>= 1)\n"
        "    total = __fadd_rn(total, __shfl_xor_sync(kFull, total, off));\n")


def k25_warp_patches() -> list:
    p = probes(len(K25_WARP))
    return [
        ("  if (r >= n_req) return;  // warp-uniform; no block barrier below\n",
         "  if (r >= n_req) return;  // warp-uniform; no block barrier below\n  " + PROBE_START),
        ("  if (cur < 0) {  // an empty slot\n    for (int c = lane; c <= p_cols; c += 32) out[c] = -1;\n"
         "    return;\n  }\n",
         "  if (cur < 0) {  // an empty slot\n    for (int c = lane; c <= p_cols; c += 32) out[c] = -1;\n"
         f"  {probes(1)[0]}\n{probe_flush('k25e', 1)}    return;\n  }}\n  {p[0]}\n"),
        ("    for (int c = lane; c < p_cols; c += 32) prev_rows[c] = rq[3 + c];\n",
         f"    for (int c = lane; c < p_cols; c += 32) prev_rows[c] = rq[3 + c];\n  {p[1]}\n"),
        ("  n2v::dense_load_row(adj + lv * 2 * p_cols, p_cols, k, col0, ids, bw, rows);\n  __syncwarp();\n",
         "  n2v::dense_load_row(adj + lv * 2 * p_cols, p_cols, k, col0, ids, bw, rows);\n  __syncwarp();\n"
         "  { float _w = 0.f; for (int m = 0; m < kMaxK; ++m) _w += bw[m];\n"
         "    int _r; asm volatile(\"mov.b32 %0, %1;\" : \"=r\"(_r) : \"f\"(_w)); }\n"
         f"  {p[2]}\n"),
        (_K25_TOTAL_CALL, _k25_total_split(p[3])),
        ("                              : -1;  // a sink (or all-zero weights)\n",
         f"                              : -1;  // a sink (or all-zero weights)\n  {p[4]}\n"),
        ("  for (int c = lane; c < p_cols; c += 32) out[1 + c] = rows[c];\n}\n",
         f"  for (int c = lane; c < p_cols; c += 32) out[1 + c] = rows[c];\n  {p[5]}\n"
         f"{probe_flush('k25', len(K25_WARP))}}}\n"),
    ]


K25_BISECT = ["request header", "N(prev) staged", "row landed", "membership",
              "total, scan and pick", "response stored"]


def k25_bisect_patches() -> list:
    p = probes(len(K25_BISECT))
    empty = probes(7)[6]
    return [
        ("  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kServeWarps;\n",
         "  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kServeWarps;\n  "
         + PROBE_START + "  bool _busy = false;\n"),
        ("    if (cur < 0) {  // an empty slot: one store a field\n",
         f"    {p[0]}\n    if (cur < 0) {{  // an empty slot: one store a field\n"),
        ("      for (int c = lane; c <= p_cols; c += 32) out[c] = -1;\n    } else {\n",
         f"      for (int c = lane; c <= p_cols; c += 32) out[c] = -1;\n      {empty}\n"
         "    } else {\n"),
        ("      serve_copies_wait();\n", f"      serve_copies_wait();\n      _busy = true;\n      {p[1]}\n"),
        ("      n2v::dense_row_from_shared(srow, p_cols, k, col0, ids, bw);\n",
         "      n2v::dense_row_from_shared(srow, p_cols, k, col0, ids, bw);\n"
         "      { float _w = 0.f; for (int m = 0; m < kK; ++m) _w += bw[m];\n"
         "        int _r; asm volatile(\"mov.b32 %0, %1;\" : \"=r\"(_r) : \"f\"(_w)); }\n"
         f"      {p[2]}\n"),
        ("      const float total = n2v::dense_total(bw, lane_sum);\n",
         "      { float _w = 0.f; for (int m = 0; m < kK; ++m) _w += bw[m];\n"
         "        int _r; asm volatile(\"mov.b32 %0, %1;\" : \"=r\"(_r) : \"f\"(_w)); }\n"
         f"      {p[3]}\n      const float total = n2v::dense_total(bw, lane_sum);\n"),
        ("                                  : -1;  // a sink (or all-zero weights)\n",
         f"                                  : -1;  // a sink (or all-zero weights)\n      {p[4]}\n"),
        ("      for (int c = lane; c < p_cols; c += 32) out[1 + c] = srow[c];\n",
         f"      for (int c = lane; c < p_cols; c += 32) out[1 + c] = srow[c];\n      {p[5]}\n"),
        ("  }  // requests\n}\n",
         "  }  // requests\n  if ((threadIdx.x & 31) == 0) {\n"
         "    for (int k2 = 0; k2 < 6; ++k2)\n"
         "      atomicAdd(&k25_phase_clk[k2], (unsigned long long)_pr[k2]);\n"
         "    atomicAdd(&k25_phase_clk[15], 1ull);\n"
         "    atomicAdd(&k25e_phase_clk[0], (unsigned long long)_pr[6]);\n"
         "    if (!_busy) atomicAdd(&k25e_phase_clk[15], 1ull);\n  }\n}\n"),
    ]


# timed only: the bisect design at other block sizes and occupancies
K25_BISECT_VARIANTS = {
    "4 warps a block": [("constexpr int kServeWarps = 8;", "constexpr int kServeWarps = 4;")],
    "16 warps a block": [("constexpr int kServeWarps = 8;", "constexpr int kServeWarps = 16;")],
    "8 blocks an SM (<= 32 registers)": [
        ("template <bool kVec, int kK>\n__global__ void __launch_bounds__(kServeWarps * 32)\n",
         "template <bool kVec, int kK>\n__global__ void __launch_bounds__(kServeWarps * 32, 8)\n")],
}

K25_DESIGNS = (("warp a request", k25_warp_patches, K25_WARP, {}),
               ("bisect", k25_bisect_patches, K25_BISECT, K25_BISECT_VARIANTS))

# ---- K3's squares mode -----------------------------------------------------

K3_THREAD = ["locate, id and square landed", "atomic issued"]


def k3_thread_patches() -> list:
    p = probes(len(K3_THREAD))
    return [
        ("  const float* sq;\n  int v;\n  bool first;\n"
         "  // each list's \"gradient row\" is one float: locate at width 1\n"
         "  if (!locate(l, r, 1, sq, v, first) || v < 0) return;\n"
         "  atomicAdd((first ? acc_in : acc_out) + v, *sq / div);\n}\n",
         "  const float* sq;\n  int v;\n  bool first;\n  " + PROBE_START
         + "  const bool live = locate(l, r, 1, sq, v, first) && v >= 0;\n"
         "  const float x = live ? *sq : 0.f;\n"
         "  { int _r; asm volatile(\"mov.b32 %0, %1;\" : \"=r\"(_r) : \"f\"(x)); }\n"
         f"  {p[0]}\n"
         "  if (live) atomicAdd((first ? acc_in : acc_out) + v, x / div);\n"
         f"  {p[1]}\n{probe_flush('k3s', len(K3_THREAD))}}}\n"),
    ]


K3_THREAD_VARIANTS = {
    "no global atomic": [
        ("  atomicAdd((first ? acc_in : acc_out) + v, *sq / div);\n}\n",
         "  const float x = *sq / div;\n"
         "  if (x == 1234.5f) (first ? acc_in : acc_out)[v] = x;\n}\n")],
}

K3_HOT = ["loads landed", "hot adds, warp match, cold atomics issued", "hot rows flushed"]
_K3_LOAD = "    const uint32_t tag = load_quad<kVec>(l, q0, q1, q2, div, g0 + threadIdx.x, v, x);\n"
_K3_PASS_END = ("      if (lead) add_square((tag ? acc_in : acc_out) + v[i], sum);\n"
                "    }\n  }\n")
_K3_FLUSH_END = "    if (hot[r] != 0.f) add_square(acc_out + r, hot[r]);\n  }\n}\n"
_K3_GATE = "      if (__any_sync(kFull, lane > 0 && below == key)) {\n"


def k3_hot_patches() -> list:
    p = probes(len(K3_HOT))
    wait = ("    { float _w = 0.f;\n      for (int i = 0; i < 4; ++i) _w += x[i] + v[i];\n"
            "      int _r; asm volatile(\"mov.b32 %0, %1;\" : \"=r\"(_r) : \"f\"(_w)); }\n")
    return [
        ("  const int lane = threadIdx.x & 31;\n  const int64_t quads",
         "  const int lane = threadIdx.x & 31;\n  " + PROBE_START + "  const int64_t quads"),
        (_K3_LOAD, _K3_LOAD + wait + f"    {p[0]}\n"),
        (_K3_PASS_END, _K3_PASS_END[:-4] + f"    {p[1]}\n  }}\n"),
        ("  if (!zeroed) return;\n",
         "  if (!zeroed) {\n" + probe_flush("k3s", len(K3_HOT)) + "    return;\n  }\n"),
        (_K3_FLUSH_END, _K3_FLUSH_END[:-2] + f"  {p[2]}\n{probe_flush('k3s', len(K3_HOT))}}}\n"),
    ]


K3_HOT_VARIANTS = {
    "no global atomic": [
        ("__device__ __forceinline__ void add_square(float* a, float x) { atomicAdd(a, x); }",
         "__device__ __forceinline__ void add_square(float* a, float x) {\n"
         "  if (x == 1234.5f) *a = x;\n}")],
    "no warp match": [(_K3_GATE, "      if (false) {\n")],
    "warp match in every slot": [(_K3_GATE, "      if (__any_sync(kFull, true)) {\n")],
    "no hot array (hot rows below 1)": [("constexpr int kSqHot = 8192;", "constexpr int kSqHot = 1;")],
    "hot array in every pass": [("constexpr int kSqHotMin = 256;", "constexpr int kSqHotMin = 0;")],
    "hot rows below 2048": [("constexpr int kSqHot = 8192;", "constexpr int kSqHot = 2048;")],
    "1024 threads": [("constexpr int kSqThreads = 512;", "constexpr int kSqThreads = 1024;")],
    "256 threads": [("constexpr int kSqThreads = 512;", "constexpr int kSqThreads = 256;")],
}

K3_DESIGNS = (("thread a row", k3_thread_patches, K3_THREAD, K3_THREAD_VARIANTS),
              ("hot array", k3_hot_patches, K3_HOT, K3_HOT_VARIANTS))


def _pick(src: str, designs):
    for design in designs:
        if all(src.count(old) == 1 for old, _ in design[1]()):
            return design
    return None


def sources(csrc: str):
    """({library: (source, nvcc flags)}, {kernel: (design, [(prefix, phases)])})."""
    srcs, designs = {}, {}
    epd_src = source("epd_walk.cu", csrc)
    got = _pick(epd_src, K25_DESIGNS)
    if got is None:
        raise SystemExit(f"no K25 patch set applies to {csrc}/epd_walk.cu")
    design, patches, phases, variants = got
    prefixes = [("k25", phases), ("k25e", ["empty slot"])]
    srcs["k25"] = (epd_src, [])
    for name, pairs in variants.items():
        srcs["k25: " + name] = (patched(epd_src, pairs), [])
    srcs["k25 probed"] = ("".join(probe_counters(p) for p, _ in prefixes)
                          + patched(epd_src, patches())
                          + "".join(phase_read(p) for p, _ in prefixes), [])
    designs["k25"] = (design, prefixes)
    k3_src = source("adagrad.cu", csrc)
    got = _pick(k3_src, K3_DESIGNS)
    if got is None:
        raise SystemExit(f"no K3 squares patch set applies to {csrc}/adagrad.cu")
    design, patches, phases, variants = got
    prefixes = [("k3s", phases)]
    srcs["k3s"] = (k3_src, [])
    srcs["k3s probed"] = ("".join(probe_counters(p) for p, _ in prefixes)
                          + patched(k3_src, patches())
                          + "".join(phase_read(p) for p, _ in prefixes), [])
    for name, pairs in variants.items():
        srcs["k3s: " + name] = (patched(k3_src, pairs), [])
    designs["k3s"] = (design, prefixes)
    return srcs, designs


@contextlib.contextmanager
def swapped(lib):
    """The tree's wrappers call ``lib`` (each C entry's argtypes copied from
    the port's library) while the block runs."""
    from node2vec_torch import _build

    port = _build.lib()
    for name in ("n2v_epd_serve", "n2v_adagrad_accumulate_squares", "n2v_error_string"):
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


def resident_blocks(regs: int, smem: int, threads: int) -> int:
    """Blocks an SM holds at once, from ptxas's registers a thread and the
    shared memory a block (an H100: 64 warps, 64k registers, 228 KB)."""
    warps = threads // 32
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = REGS_A_SM // (per_warp * warps) if regs else WARPS_A_SM // warps
    by_smem = SMEM_A_SM // (smem + 1024) if smem else 1 << 30
    return max(min(WARPS_A_SM // warps, by_regs, by_smem), 0)


def serve_geometry(ptxas: dict, n_req: int, p_cols: int) -> dict:
    """K25's launch against the card: its registers (ptxas), the blocks an
    SM holds, and the waves of the request grid (the first design: a block
    of 8 warps, a warp a request, 8 * 2P * 4 bytes of shared memory; the
    persistent design: as many blocks as the card holds)."""
    regs = max([int(m) for v in ptxas.values() for m in re.findall(r"(\d+) registers", v)]
               or [0])
    smem = 8 * 2 * p_cols * 4
    per_sm = resident_blocks(regs, smem, 256)
    blocks = -(-n_req // 8)
    return {"registers": regs, "block_threads": 256, "dynamic_smem_bytes_first_design": smem,
            "blocks_an_sm": per_sm, "request_blocks": blocks,
            "waves": blocks / max(per_sm * SMS, 1)}


def serve_calls():
    """Every K25 call of ``check_ep_dense``'s full-capacity chunk, walked
    through the tree's kernels: (each superstep's requests, the shard's
    packed adjacency, the wrapper's keywords)."""
    import torch

    import chip_smoke as cs
    from node2vec_torch.graph import build_graph
    from node2vec_torch.parallel import edge_partitioned as epd
    from node2vec_torch.walk import dense

    dev = torch.device("cuda")
    src, dst = cs.smoke_edges(131072, 2_097_152)
    graph = build_graph((src, dst), directed=False)
    packed = dense.build_padded_adjacency(graph.indptr, graph.indices, graph.weights)
    padded, rps = epd.partition_packed_adjacency(packed, 1)
    local = torch.from_numpy(padded).to(dev)
    p_cols = local.shape[1] // 2
    starts = torch.arange(WALKERS, dtype=torch.int32, device=dev) % graph.n_vertices
    draws = epd.default_draws(0, 0, WALKERS, dev)
    calls = []

    class Capture(epd._Kernels):
        @staticmethod
        def serve(recv, adj, **kw):
            calls.append(recv.clone())
            return epd.epd_serve(recv, adj, **kw)

    carry = epd.init_carry(starts)
    prev_rows = torch.full((WALKERS, p_cols), int(dense.PAD_ID), dtype=torch.int32, device=dev)
    paths = torch.full((WALKERS, WALK_LENGTH + 1), -1, dtype=torch.int32, device=dev)
    paths[:, 0] = starts
    for t in range(epd.max_supersteps(WALK_LENGTH)):
        pending = epd.superstep(Capture, None, "data", local, carry, prev_rows, paths, draws(t),
                                capacity=WALKERS, n_shards=1, rows_per_shard=rps, my_shard=0,
                                walk_length=WALK_LENGTH, return_param=PQ[0], inout_param=PQ[1])
        if int(pending) == 0:
            break
    kw = dict(my_shard=0, rows_per_shard=rps, return_param=PQ[0], inout_param=PQ[1])
    return calls, local, kw


def request_shape(recv, p_cols: int) -> dict:
    import torch

    valid = recv[:, 0] >= 0
    biased = valid & (recv[:, 1] >= 0)
    nprev = recv[:, 3:3 + p_cols]
    sorted_rows = bool((nprev[:, 1:] >= nprev[:, :-1]).all(1)[biased].all()) if biased.any() \
        else True
    return {"slots": int(recv.shape[0]), "valid": int(valid.sum()), "biased": int(biased.sum()),
            "empty": int((~valid).sum()), "every_biased_nprev_sorted": sorted_rows,
            "distinct_rows": int(torch.unique(recv[valid, 0]).numel())}


# ---- K3's squares lists ------------------------------------------------------

def cbow_hs_lists():
    """K3's squares lists at ``main_path_cbow_hs``'s batch, as
    ``check_cbow`` makes them: (squares lists, D, (acc_in, acc_theta), the
    tail's head levels H and levels a position CLT)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from node2vec_torch.graph import build_graph
    from node2vec_torch.models import cbow
    from node2vec_torch.models.word2vec import _effective_batch
    from node2vec_torch.walk.engine import Node2VecParams, WalkEngine

    src, dst = cs.smoke_edges(131072, 2_097_152)
    g = build_graph((src, dst), directed=False)
    tree, counts = cs.hs_tree(g)
    batch = _effective_batch(8192, 131072, target_updates=51)
    chunk0 = WalkEngine(g, Node2VecParams(**cs.N2V_MAIN), device="cuda").chunk_source(seed=0)[2](0)
    walks = chunk0.cpu().numpy()[np.random.default_rng(0).permutation(len(chunk0))]
    inp = cs._cbow_inputs(tree, counts, batch, 21, 128, 5, seed=6, walks=walks)
    hs_args = (*inp["hs"][:2], inp["walks"], inp["mask"], inp["b_sh"], *inp["tables"])
    want10 = cbow.cbow_hs_grads_plain(*hs_args, window=5, cbow_mean=True)
    squares, _ = cbow.cbow_hs_lists(want10, inp["walks"])
    h = cbow.cbow_hs_head(21, 128, int(tree.points.shape[1]), int(tree.n_inner))[0]
    clt = squares[3].numel() // squares[1].numel()
    acc = (inp["hs"][2], inp["hs"][3])
    del want10, inp
    torch.cuda.empty_cache()
    return tuple(x.contiguous() for x in squares), 128, acc, h, clt


def column_lists():
    """K3's squares lists at the column step's batch (``check_col_sgns`` at
    Dm = D on ``main_path_pairs``' first batch): (lists, D, accumulators),
    and the row owners' lists on the same batch (the distinct centers, and
    the distinct contexts and negatives, ascending as K18 hands them to one
    owner, each with a mean square; divided by 1)."""
    import torch

    import chip_smoke as cs
    from node2vec_torch.graph import build_graph
    from node2vec_torch.models import skipgram as sg
    from node2vec_torch.parallel import sharded_sgns as col

    src, dst = cs.smoke_edges(131072, 2_097_152)
    g = build_graph((src, dst), directed=False)
    ep = cs._pair_epoch(g)
    first = (ep["corpus"][:ep["batch"]].contiguous(), ep["tables"][2])
    batch = ep["batch"]
    del ep
    inp = cs._batch_inputs(131072, batch, 21, 128, 5, 11, 0.1, first)
    walks, mask, neg, b_sh = inp["walks"], inp["mask"], inp["neg"], inp["b_sh"]
    pc, px = sg.pair_lists_plain(walks, b_sh, mask, 5)
    n = pc.shape[0]
    e_in, e_out = inp["state"][:2]
    logits = col.col_pair_logits_plain(e_in, e_out, walks, pc, px, neg, window=5)
    sq = col.col_pair_grads_plain(e_in, e_out, walks, pc, px, neg, logits, window=5,
                                  negatives=5)[3]
    lists = (sq[:n].contiguous(), pc, sq[n:2 * n].contiguous(), px, sq[2 * n:].contiguous(), neg)
    acc = (inp["state"][2], inp["state"][3])
    gen = torch.Generator(device="cuda").manual_seed(5)
    ra = torch.unique(pc[pc >= 0]).to(torch.int32)
    rb = torch.unique(torch.cat([px[px >= 0], neg])).to(torch.int32)
    owners = (torch.rand(ra.numel(), generator=gen, device="cuda"), ra,
              torch.rand(rb.numel(), generator=gen, device="cuda"), rb,
              torch.zeros(0, device="cuda"), torch.zeros(0, dtype=torch.int32, device="cuda"))
    return lists, 128, acc, owners


def list_shape(lists, tail=None) -> dict:
    """Each list's entries, live, dead and distinct ids; the global atomics
    that combining equal ids would leave within windows of w consecutive
    entries of the lists laid end to end; with ``tail`` = (H, CLT), each tail
    level's live entries, distinct ids and largest repeat."""
    import torch

    rows = [lists[1], lists[3], lists[5]]
    out = {"lists": []}
    for r in rows:
        live = r[r >= 0]
        out["lists"].append({"entries": int(r.numel()), "live": int(live.numel()),
                             "dead": int(r.numel() - live.numel()),
                             "distinct": int(torch.unique(live).numel())})
    # key = (list is acc_in) and id; dead entries -1
    keys = torch.cat([torch.where(r >= 0, r.long() * 2 + (1 if k == 0 else 0), -1)
                      for k, r in enumerate(rows)])
    n = keys.numel()
    out["atomics_left_by_window"] = {}
    for w in (4, 128, 1024, 4096):
        pad = -(-n // w) * w - n
        kk = torch.cat([keys, torch.full((pad,), -1, dtype=keys.dtype, device=keys.device)])
        win = torch.arange(kk.numel(), device=kk.device) // w
        live = kk >= 0
        pairs = torch.unique(torch.stack([win[live], kk[live]]), dim=1)
        out["atomics_left_by_window"][str(w)] = int(pairs.shape[1])
    if tail is not None:
        h, clt = tail
        t = lists[3].view(-1, clt)
        levels = []
        for c in range(clt):
            col = t[:, c]
            live = col[col >= 0]
            if live.numel() == 0:
                levels.append({"level": h + c, "live": 0})
                continue
            _, cnt = torch.unique(live, return_counts=True)
            levels.append({"level": h + c, "live": int(live.numel()), "distinct": int(cnt.numel()),
                           "max_repeat": int(cnt.max()), "mean_repeat": float(cnt.float().mean()),
                           "id_range": [int(live.min()), int(live.max())]})
        out["tail_levels"] = levels
    return out


def distinct_copy(lists):
    """The same lists with every live id made distinct (dead kept)."""
    import torch

    out = list(lists)
    base = 0
    for k in (1, 3, 5):
        r = lists[k]
        live = r >= 0
        ids = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32) - 1 + base
        base += int(live.sum())
        out[k] = torch.where(live, ids, -1).to(torch.int32)
    return tuple(out), base


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--only", choices=("k25", "k3s"), default=None,
                    help="measure one of the two kernels")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    srcs, designs = sources(os.path.join(tree, "node2vec_torch", "csrc"))
    if args.check:
        emit({"tree": tree, "designs": {k: v[0] for k, v in designs.items()},
              "patches_apply": True})
        return 0
    sys.path.insert(0, tree)
    os.chdir(tree)
    if args.only:
        srcs = {k: v for k, v in srcs.items() if k.startswith(args.only)}
    libs = build(srcs, os.path.join(ROOT, "build", "serve_squares_attribution"),
                 lambda name: "epd_serve" if name.startswith("k25") else "accumulate_squares")
    if args.only != "k3s":
        measure_k25(libs, designs)
    if args.only != "k25":
        measure_k3s(libs, designs)
    print(card())
    return 0


def measure_k25(libs, designs) -> None:
    import torch

    import chip_smoke as cs
    from node2vec_torch.parallel import edge_partitioned as epd

    k25_ptxas = cs.ptxas_summary(REPORTS["k25"], "epd_serve")
    calls, local, kw = serve_calls()
    p_cols = local.shape[1] // 2
    design, prefixes = designs["k25"]
    per_step, total, equal = [], 0.0, True
    for i, recv in enumerate(calls):
        want = epd.epd_serve_plain(recv, local, **kw)
        with swapped(libs["k25"]):
            equal &= bool(torch.equal(epd.epd_serve(recv, local, **kw), want))
            ms = cs.time_ms(lambda: epd.epd_serve(recv, local, **kw), reps=20)
        per_step.append(ms)
        total += ms
    emit({"kernel": "epd_serve", "design": design, "chunk": "check_ep_dense's, full capacity",
          "P": p_cols, "supersteps": len(calls), "ms_per_superstep": per_step,
          "ms_summed_over_the_chunk": total, "bit_equal_to_plain_every_superstep": equal,
          "ptxas": k25_ptxas, "geometry": serve_geometry(k25_ptxas, len(calls[1]), p_cols)})
    for i in (1, len(calls) - 1):
        recv = calls[i]
        want = epd.epd_serve_plain(recv, local, **kw)
        line = {"kernel": "epd_serve", "design": design, "superstep": i,
                **request_shape(recv, p_cols)}
        with swapped(libs["k25"]):
            line["ms"] = cs.time_ms(lambda: epd.epd_serve(recv, local, **kw), reps=20)
        for name in [k for k in libs if k.startswith("k25: ")]:
            with swapped(libs[name]):
                line.setdefault("variants", {})[name[5:]] = {
                    "ms": cs.time_ms(lambda: epd.epd_serve(recv, local, **kw), reps=20),
                    "bit_equal": bool(torch.equal(epd.epd_serve(recv, local, **kw), want))}
        with swapped(libs["k25 probed"]):
            line["probed_bit_equal"] = bool(torch.equal(epd.epd_serve(recv, local, **kw), want))
            for prefix, phases in prefixes:
                line[prefix] = profile(libs["k25 probed"], prefix,
                                       lambda: epd.epd_serve(recv, local, **kw), phases, reps=10)
        busy = line["k25"]["warps_a_launch"] / max(line["valid"], 1)  # a request's share
        line["k25"]["kclk_a_request"] = {p: v * busy for p, v in
                                         line["k25"]["kclk_a_warp_a_launch"].items()}
        emit(line)
    del calls, local


def measure_k3s(libs, designs) -> None:
    import torch

    import chip_smoke as cs
    from node2vec_torch.models import skipgram as sg

    cb_lists, cb_dim, cb_acc, h, clt = cbow_hs_lists()
    col_lists, col_dim, col_acc, owners = column_lists()
    design, prefixes = designs["k3s"]
    sites = (("cbow_hs", cb_lists, cb_dim, cb_acc, (h, clt)),
             ("column step", col_lists, col_dim, col_acc, None),
             ("row owners", owners, 1, col_acc, None))
    for site, lists, dim, acc, tail in sites:
        line = {"kernel": "adagrad_accumulate_squares", "design": design, "site": site,
                "div": dim, **list_shape(lists, tail)}

        def run(ls=lists, d=dim, into=None):
            a = into if into is not None else [x.clone() for x in acc]
            sg.adagrad_accumulate_squares(*a, *ls, d)
            return a

        want = [x.clone() for x in acc]
        sg.adagrad_accumulate_squares_plain(*want, *lists, dim)

        def verdict(got, ref=want):
            torch.cuda.synchronize()
            errs = [float((g - w).abs().max()) for g, w in zip(got, ref)]
            ok = all(bool(torch.allclose(g, w, rtol=cs.RTOL, atol=cs.ATOL))
                     for g, w in zip(got, ref))
            return {"max_abs_err": max(errs), "within_tolerance": ok}

        work = [x.clone() for x in acc]
        with swapped(libs["k3s"]):
            line["verdict"] = verdict(run())
            line["ms"] = cs.time_ms(lambda: run(into=work), reps=20)
            dl, n_ids = distinct_copy(lists)
            big = [torch.zeros(max(n_ids, acc[0].numel()), device="cuda") for _ in range(2)]
            line["ms_every_live_id_distinct"] = cs.time_ms(
                lambda: sg.adagrad_accumulate_squares(*big, *dl, dim), reps=20)
            del big, dl
        line["plain_ms"] = cs.time_ms(
            lambda: sg.adagrad_accumulate_squares_plain(*work, *lists, dim), reps=5)
        live = [(lists[2 * k][lists[2 * k + 1] >= 0] / dim, lists[2 * k + 1][
            lists[2 * k + 1] >= 0].long()) for k in range(3)]
        line["library_ms"] = cs.time_ms(lambda: [a.index_add_(0, r, x) for a, (x, r) in zip(
            (work[0], work[1], work[1]), live)], reps=20)
        with swapped(libs["k3s probed"]):
            line["probed"] = verdict(run())
            for prefix, phases in prefixes:
                line[prefix] = profile(libs["k3s probed"], prefix, lambda: run(into=work),
                                       phases, reps=10)
        line["variants_ms"] = {}
        for name in [k for k in libs if k.startswith("k3s: ")]:
            with swapped(libs[name]):
                line["variants_ms"][name[5:]] = cs.time_ms(lambda: run(into=work), reps=20)
                if not name.endswith("no global atomic"):
                    line["variants_ms"][name[5:] + " verdict"] = verdict(run())
        emit(line)


if __name__ == "__main__":
    sys.exit(main())
