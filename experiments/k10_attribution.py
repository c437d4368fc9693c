#!/usr/bin/env python3
"""Where K10 ``cbow_hs_grads`` spends its time, on one card, and how much of
K4 ``adagrad_apply``'s time on CBOW-HS's per-occurrence lists is contention
on hot rows.

    python3 experiments/k10_attribution.py                  # this tree's kernels
    python3 experiments/k10_attribution.py --csrc DIR       # another tree's csrc/
    python3 experiments/k10_attribution.py --check [--csrc DIR]   # only check the patches

The libraries are built with nvcc (sm_90a, one process each, all started
together) into ``build/k10_attribution/`` from the ``csrc/`` given (this
tree's by default; a parent's unpacked ``git archive`` for a before/after):

* K10 as built, timed by CUDA events over 20 launches through its C entry,
  and (PR 17's design) copies with one part of its work cut out by a text
  patch (``VARIANTS_PR17``: wrong numbers by design, only the time read);
* K10 with ``clock64()`` probes patched in at each phase of a warp's work
  (``PHASES_PR16`` or ``PHASES_PR17``, after the design the source holds:
  the first lane of every warp adds the cycles since its previous probe to
  that phase's device counter, so a barrier's wait counts in the phase that
  ends at it, and a load's wait where its value is first used).  Printed as
  thousands of cycles a warp a launch, with each phase's share (a "part:
  sub" phase's of its part);
* K4 (``adagrad.cu`` as built) on CBOW-HS's lists in the per-occurrence
  layout (``chip_smoke.cbow_hs_occurrence_lists``), timed twice: as they
  are, and with every live theta row remapped to a row of its own in a
  table as large as the list (the same bytes, no address shared), so the
  difference is what the hot rows' contention costs.

The inputs are ``main_path_cbow_hs``'s shape (2,570 walks of the dense
graph's first chunk, shuffled, on its Huffman tree: L1 = 21, D = 128, w = 5,
cbow_mean) and ``main_path_wide``'s K10 batch (64 walks of the quality
graph's corpus, L1 = 81, D = 512, w = 10), each with N(0, 0.1) tables.
Prints ptxas's registers and spills of each build, one JSON line a timing
and a profile, then the card's name and power limit.  Neither the port nor
the smoke imports this file.
"""

import ctypes
import json
import os
import sys

from _variants import CSRC, ROOT, build, card, patched, source

OUT = os.path.join(ROOT, "build", "k10_attribution")
PROBE = "if (lane == 0) { const long long _n = clock64(); _pr[%d] += _n - _t; _t = _n; }"
NPH = 16  # device counters: phases, then the count of warps at [NPH - 1]

# PR 16's design (one warp a position, one dependent theta load a level)
PHASES_PR16 = ["row staging", "context counts and h", "theta-load wait", "dot and warp sum",
               "g_h", "g_theta stores", "barrier (descent imbalance)", "scatter to g_in",
               "block tail"]


def probes_pr16():
    p = [PROBE % k for k in range(len(PHASES_PR16))]
    return [
        ("namespace {\n\nusing namespace cbow;",
         f"__device__ unsigned long long k10_phase_clk[{NPH}];\nnamespace {{\n\n"
         "using namespace cbow;"),
        ("  float loss_acc = 0.f, ctr_acc = 0.f;\n",
         "  float loss_acc = 0.f, ctr_acc = 0.f;\n  long long _pr[16] = {};\n"
         "  long long _t = clock64();\n"),
        ("      xin[e] = emb_in[static_cast<int64_t>(rows[e / D]) * D + e % D];\n",
         "      xin[e] = emb_in[static_cast<int64_t>(rows[e / D]) * D + e % D];\n"
         f"    __syncthreads();\n    {p[0]}\n"),
        ("    context_mean(xin, vpos, bsh, cnt, L, D, window, cbow_mean != 0, h);\n"
         "    __syncthreads();\n",
         "    context_mean(xin, vpos, bsh, cnt, L, D, window, cbow_mean != 0, h);\n"
         f"    __syncthreads();\n    {p[1]}\n"),
        ("""        float g = 0.f;
        if (live) {
          const float* th = theta + static_cast<int64_t>(row) * D;
          float acc = 0.f;
          for (int k = lane; k < D; k += 32) acc += hi[k] * th[k];
          const float logit = warp_sum(acc);
          const float sgn = 1.f - 2.f * static_cast<float>(codes[path + c]);
          g = sigmoid(logit) - (1.f + sgn) * 0.5f;
          if (lane == 0) loss_acc += log_sigmoid(sgn * logit);
          for (int k = lane; k < D; k += 32) gh[k] += g * th[k];
        }
        const int64_t entry = (base + i) * cl + c;
        float* gt = g_theta + entry * D;
        for (int k = lane; k < D; k += 32) gt[k] = g * hi[k];
        if (lane == 0) theta_rows[entry] = live ? row : -1;
""", f"""        float g = 0.f, tv[16], logit = 0.f;
        const float* th = theta + static_cast<int64_t>(row) * D;
#pragma unroll
        for (int j = 0; j < 16; ++j) tv[j] = live && lane + 32 * j < D ? th[lane + 32 * j] : 0.f;
        {{
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) s += tv[j];
          asm volatile("" ::"f"(s));
        }}
        {p[2]}
        if (live) {{
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (lane + 32 * j < D) acc += hi[lane + 32 * j] * tv[j];
          logit = warp_sum(acc);
        }}
        asm volatile("" ::"f"(logit));
        {p[3]}
        if (live) {{
          const float sgn = 1.f - 2.f * static_cast<float>(codes[path + c]);
          g = sigmoid(logit) - (1.f + sgn) * 0.5f;
          if (lane == 0) loss_acc += log_sigmoid(sgn * logit);
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (lane + 32 * j < D) gh[lane + 32 * j] += g * tv[j];
        }}
        {p[4]}
        const int64_t entry = (base + i) * cl + c;
        float* gt = g_theta + entry * D;
        for (int k = lane; k < D; k += 32) gt[k] = g * hi[k];
        if (lane == 0) theta_rows[entry] = live ? row : -1;
        {p[5]}
"""),
        ("    __syncthreads();\n"
         "    scatter_context(xin, vpos, bsh, L, D, window, g_in + base * D);\n"
         "    __syncthreads();  // the next walk overwrites the shared rows\n",
         f"    __syncthreads();\n    {p[6]}\n"
         "    scatter_context(xin, vpos, bsh, L, D, window, g_in + base * D);\n"
         f"    __syncthreads();  // the next walk overwrites the shared rows\n    {p[7]}\n"),
        ("    loss_parts[2 * blockIdx.x + tid] = t;\n  }\n}\n",
         "    loss_parts[2 * blockIdx.x + tid] = t;\n  }\n"
         f"  {p[8]}\n  if (lane == 0) {{\n"
         f"    for (int k = 0; k < {len(PHASES_PR16)}; ++k)\n"
         "      atomicAdd(&k10_phase_clk[k], (unsigned long long)_pr[k]);\n"
         f"    atomicAdd(&k10_phase_clk[{NPH - 1}], 1ull);\n  }}\n}}\n"),
    ]


# PR 17's design: block phases, then the fast descent's own
PHASES_PR17 = ["tables", "h", "descent", "barrier after the descent", "scatter to g_in",
               "block end (partial flush, loss)", "descent: round setup",
               "descent: theta wait and dot", "descent: g and g_h",
               "descent: tail stores, head g", "descent: fetch issue",
               "descent: masked tail rows", "descent: barrier (round's paths)",
               "descent: head sums", "descent: barrier and g_h store"]


def probes_pr17():
    p = [PROBE % k for k in range(len(PHASES_PR17))]
    flush = ("  if (lane == 0)\n    for (int k = 0; k < %d; ++k)\n"
             "      atomicAdd(&k10_phase_clk[k], (unsigned long long)_pr[k]);\n")
    return [
        ("namespace {\n\nconstexpr int kThreads = 512;",
         f"__device__ unsigned long long k10_phase_clk[{NPH}];\nnamespace {{\n\n"
         "constexpr int kThreads = 512;"),
        # the descent's probes
        ("  float* hhb = gvb + round4(g.M * CL);  // [M] |h|^2\n",
         "  float* hhb = gvb + round4(g.M * CL);  // [M] |h|^2\n"
         "  long long _pr[16] = {};\n  long long _t = clock64();\n"),
        ("    for (int u = 0; u < PF; ++u) fetch(u, u);\n",
         f"    for (int u = 0; u < PF; ++u) fetch(u, u);\n    {p[6]}\n"),
        ("        const float logit = unit_sum<UL>(part);\n",
         f"        const float logit = unit_sum<UL>(part);\n        {p[7]}\n"),
        ("          for (int q = 0; q < NQ; ++q) fma4(gh[q], gv, ring[u][q]);\n"
         "          if (c < H) {\n            if (sub == 0) gvb[p * CL + c] = gv;",
         "          for (int q = 0; q < NQ; ++q) fma4(gh[q], gv, ring[u][q]);\n"
         f"          {p[8]}\n"
         "          if (c < H) {\n            if (sub == 0) gvb[p * CL + c] = gv;"),
        ("              a.sq_tail[tr_row] = gv * gv * hh;\n            }\n          }\n        }\n"
         "        fetch(u, c + PF);\n",
         "              a.sq_tail[tr_row] = gv * gv * hh;\n            }\n          }\n"
         f"          {p[9]}\n        }}\n        fetch(u, c + PF);\n        {p[10]}\n"),
        ("    __syncthreads();  // the round's head entries are in gvb, its h rows intact\n",
         f"    {p[11]}\n"
         "    __syncthreads();  // the round's head entries are in gvb, its h rows intact\n"
         f"    {p[12]}\n"),
        ("    __syncthreads();  // every warp is past the round's h rows\n",
         f"    {p[13]}\n    __syncthreads();  // every warp is past the round's h rows\n"),
        ("      if (sub == 0) ctr_acc += 1.f;\n    }\n  }\n  return ahead;\n}\n",
         f"      if (sub == 0) ctr_acc += 1.f;\n    }}\n    {p[14]}\n  }}\n"
         + flush % len(PHASES_PR17) + "  return ahead;\n}\n"),
        # the block's probes
        ("  float loss_acc = 0.f, ctr_acc = 0.f;\n  const int n_groups",
         "  float loss_acc = 0.f, ctr_acc = 0.f;\n  long long _pr[16] = {};\n"
         "  long long _t = clock64();\n  const int n_groups"),
        ("    build_tables(t, g);                  // ends at a barrier\n",
         f"    build_tables(t, g);                  // ends at a barrier\n    {p[0]}\n"),
        ("    context_mean(xc, hb, t, g, a, vec);  // ends at a barrier\n",
         f"    context_mean(xc, hb, t, g, a, vec);  // ends at a barrier\n    {p[1]}\n"),
        ("    __syncthreads();\n    scatter_context(ghb, t, g, a, rows, row0, vec);\n"
         "    __syncthreads();  // the next group overwrites the tables and rows\n",
         f"    {p[2]}\n    __syncthreads();\n    {p[3]}\n"
         "    scatter_context(ghb, t, g, a, rows, row0, vec);\n"
         f"    __syncthreads();  // the next group overwrites the tables and rows\n    {p[4]}\n"),
        ("    a.loss_parts[2 * blockIdx.x + tid] = s;\n  }\n}\n",
         "    a.loss_parts[2 * blockIdx.x + tid] = s;\n  }\n"
         f"  {p[5]}\n" + flush % 6
         + f"  if (lane == 0) atomicAdd(&k10_phase_clk[{NPH - 1}], 1ull);\n}}\n"),
    ]


# PR 17's design with one part of its work cut out (wrong numbers by design;
# only the time is read): what each part costs, the parts overlapping
VARIANTS_PR17 = {
    "no head sums": [("    for (int c = warp; c < H; c += kWarps)\n      head_sums<",
                      "    for (int c = warp; c < 0; c += kWarps)\n      head_sums<")],
    "no tail stores": [("              if (col < D)\n"
                        "                *reinterpret_cast<float4*>(dst + col) =",
                        "              if (col < D && gv == 12345.f)\n"
                        "                *reinterpret_cast<float4*>(dst + col) =")],
    "two theta rows in flight": [("  constexpr int PF = NQ <= 2 ? 4 : 2;",
                                  "  constexpr int PF = 2;")],
}


PHASE_READ = f"""
extern "C" int k10_phase_read(unsigned long long* out) {{  // read, then reset
  cudaError_t err = cudaMemcpyFromSymbol(out, k10_phase_clk, sizeof(k10_phase_clk));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long z[{NPH}] = {{}};
  return (int)cudaMemcpyToSymbol(k10_phase_clk, z, sizeof(z));
}}
"""


def design(csrc: str) -> str:
    """"pr16" for PR 16's K10 (which includes cbow_common.cuh), else "pr17"."""
    raw = open(os.path.join(csrc, "cbow_hs.cu")).read()
    return "pr16" if '#include "cbow_common.cuh"' in raw else "pr17"


def sources(csrc: str) -> dict:
    """Each library's name, CUDA source and extra nvcc flags."""
    text = source("cbow_hs.cu", csrc)
    probes = {"pr16": probes_pr16, "pr17": probes_pr17}[design(csrc)]()
    out = {"k10": (text, []), "k10 phases": (patched(text, probes) + PHASE_READ, []),
           "k4": (open(os.path.join(csrc, "adagrad.cu")).read(), [])}
    if design(csrc) == "pr17":
        out.update({f"k10 {name}": (patched(text, pairs), [])
                    for name, pairs in VARIANTS_PR17.items()})
    return out


def phases_of(csrc: str):
    return {"pr16": PHASES_PR16, "pr17": PHASES_PR17}[design(csrc)]


def main() -> int:
    args = sys.argv[1:]
    csrc = os.path.abspath(args[args.index("--csrc") + 1]) if "--csrc" in args else CSRC
    srcs = sources(csrc)
    if "--check" in args:
        print(json.dumps({"csrc": csrc, "design": design(csrc),
                          "libraries": list(srcs), "patches_apply": True}))
        return 0
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from node2vec_torch import _build
    from node2vec_torch.constants import Node2VecParams, Word2VecParams
    from node2vec_torch.datasets import synthetic_multilabel
    from node2vec_torch.graph import build_graph
    from node2vec_torch.models import hsoftmax as hs
    from node2vec_torch.models.word2vec import _effective_batch
    from node2vec_torch.walk import WalkEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    kind = design(csrc)
    libs = build(srcs, OUT, lambda name: "cbow_hs_grads" if name.startswith("k10")
                 else "adagrad_apply")
    phases = phases_of(csrc)
    print(json.dumps({"csrc": csrc, "design": kind}), flush=True)

    # main_path_cbow_hs's shape
    src, dst = cs.smoke_edges(131072, 2_097_152)
    g = build_graph((src, dst), directed=False)
    tree, counts = cs.hs_tree(g)
    n_walks = _effective_batch(8192, 131072, target_updates=51)
    chunk0 = WalkEngine(g, Node2VecParams(**cs.N2V_MAIN), device="cuda").chunk_source(seed=0)[2](0)
    walks_np = chunk0.cpu().numpy()[np.random.default_rng(0).permutation(len(chunk0))]
    del chunk0, g
    main_inp = cs._cbow_inputs(tree, counts, n_walks, 21, 128, 5, seed=6, walks=walks_np)
    # main_path_wide's K10 batch
    g_q, _ = synthetic_multilabel(2000, seed=0)
    corpus = WalkEngine(g_q, Node2VecParams(num_walks=8, walk_length=80),
                        device="cuda").run_device(seed=0).cpu().numpy()
    q_counts = np.bincount(corpus[corpus >= 0], minlength=g_q.n_vertices)
    q_tree = hs.cap_code_length(hs.build_huffman(q_counts), q_counts,
                                max_len=Word2VecParams().hs_max_code_length or None)
    corpus = corpus[np.random.default_rng(0).permutation(len(corpus))]
    q_b = _effective_batch(Word2VecParams().batch_walks, len(corpus))
    wide_inp = cs._cbow_inputs(q_tree, q_counts, q_b, 81, 512, 10, seed=6, walks=corpus)

    for case, inp in (("main_path_cbow_hs", main_inp), ("main_path_wide, D = 512", wide_inp)):
        run = {"pr16": k10_call_pr16, "pr17": k10_call_pr17}[kind]
        for name in [n for n in libs if n.startswith("k10")]:
            call, staging = run(libs[name], inp, _build, lib_smem=libs["k10"])
            ms = cs.time_ms(call, reps=20)
            line = {"case": case, "build": name, "staging": staging, "ms": ms}
            if name == "k10 phases":
                line.update(profile(libs[name], call, phases))
            print(json.dumps(line), flush=True)
    k4_probe(libs["k4"], main_inp, cs)
    print(card())
    return 0


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def k10_call_pr16(lib, inp, _build, lib_smem):
    """PR 16's C entry: g_in, per-occurrence g_theta and theta_rows."""
    import torch

    vp, i32 = ctypes.c_void_p, ctypes.c_int
    emb_in, theta = inp["hs"][:2]
    walks, mask, b_sh = inp["walks"], inp["mask"], inp["b_sh"]
    points, codes, lengths = inp["tables"]
    n_walks, length = walks.shape
    dim, cl = emb_in.shape[1], points.shape[1]
    lib_smem.n2v_cbow_hs_grads_smem.argtypes = [i32, i32]
    lib_smem.n2v_cbow_hs_grads_smem.restype = ctypes.c_size_t
    ws, ws_blocks = _build.staging(lib_smem.n2v_cbow_hs_grads_smem(length, dim), n_walks,
                                   emb_in.device)
    dev = emb_in.device
    g_in = torch.empty((n_walks * length, dim), device=dev)
    g_theta = torch.empty((n_walks * length * cl, dim), device=dev)
    rows = torch.empty((n_walks * length * cl,), dtype=torch.int32, device=dev)
    parts = torch.zeros((n_walks, 2), device=dev)
    fn = lib.n2v_cbow_hs_grads
    fn.argtypes = [vp, vp, i32, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp, vp, vp, vp,
                   vp, i32, vp]

    def call():
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = fn(_ptr(emb_in), _ptr(theta), dim, _ptr(walks), _ptr(mask), _ptr(b_sh),
                _ptr(points), _ptr(codes), _ptr(lengths), cl, n_walks, length, inp["window"], 1,
                _ptr(g_in), _ptr(g_theta), _ptr(rows), _ptr(parts),
                _ptr(ws) if ws is not None else None, ws_blocks, stream)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
    return call, "global" if ws is not None else "shared"


def k10_call_pr17(lib, inp, _build, lib_smem):
    """PR 17's C entry: g_in and its squares, the tail's rows and squares,
    the head's sums."""
    import torch
    from node2vec_torch.models import cbow

    vp, i32 = ctypes.c_void_p, ctypes.c_int
    emb_in, theta = inp["hs"][:2]
    walks, mask, b_sh = inp["walks"], inp["mask"], inp["b_sh"]
    points, codes, lengths = inp["tables"]
    n_walks, length = walks.shape
    dim, cl = emb_in.shape[1], points.shape[1]
    n_head, k_rows = cbow.cbow_hs_head(length, dim, cl, theta.shape[0])
    fast = int(dim % 4 == 0 and dim <= 512)
    lib_smem.n2v_cbow_hs_grads_smem.argtypes = [i32] * 5
    lib_smem.n2v_cbow_hs_grads_smem.restype = ctypes.c_size_t
    ws, ws_blocks = _build.staging(
        lib_smem.n2v_cbow_hs_grads_smem(length, dim, cl, k_rows, fast), n_walks, emb_in.device)
    dev = emb_in.device
    n_tail = n_walks * length * (cl - n_head)
    g_in = torch.empty((n_walks * length, dim), device=dev)
    sq_in = torch.empty((n_walks * length,), device=dev)
    g_tail = torch.empty((n_tail, dim), device=dev)
    sq_tail = torch.empty((n_tail,), device=dev)
    rows = torch.empty((n_tail,), dtype=torch.int32, device=dev)
    g_head = torch.zeros((k_rows, dim), device=dev)
    sq_head = torch.zeros((k_rows,), device=dev)
    parts = torch.zeros((n_walks, 2), device=dev)
    fn = lib.n2v_cbow_hs_grads
    fn.argtypes = [vp, vp, i32, vp, vp, vp, vp, vp, vp] + [i32] * 8 + [vp] * 9 + [i32, vp]

    def call():
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = fn(_ptr(emb_in), _ptr(theta), dim, _ptr(walks), _ptr(mask), _ptr(b_sh),
                _ptr(points), _ptr(codes), _ptr(lengths), cl, n_walks, length, inp["window"], 1,
                n_head, k_rows, fast, _ptr(g_in), _ptr(sq_in), _ptr(g_tail), _ptr(sq_tail),
                _ptr(rows), _ptr(g_head), _ptr(sq_head), _ptr(parts),
                _ptr(ws) if ws is not None else None, ws_blocks, stream)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
    return call, "global" if ws is not None else "shared"


def profile(lib, call, phases) -> dict:
    """The probed build's phase sums, thousands of cycles a warp a launch."""
    import torch

    lib.k10_phase_read.argtypes = [ctypes.c_void_p]
    clk = (ctypes.c_ulonglong * NPH)()
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    lib.k10_phase_read(clk)  # read and reset
    reps = 10
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    lib.k10_phase_read(clk)
    warps = max(clk[NPH - 1], 1)
    kclk = {p: clk[k] / warps / 1e3 for k, p in enumerate(phases)}
    # "part: sub" phases are shares of their part, the others of the whole
    total = sum(v for p, v in kclk.items() if ":" not in p)
    share = {p: v / (kclk[p.split(":")[0]] if ":" in p else total) for p, v in kclk.items()}
    return {"warps_a_launch": warps / reps, "kclk_a_warp_a_launch": kclk,
            "total_kclk": total, "share": share}


def k4_probe(lib, inp, cs) -> None:
    """K4 on the per-occurrence CBOW-HS lists, as they are and with every
    live theta row remapped to a row of its own."""
    import torch

    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    fn = lib.n2v_adagrad_apply
    fn.argtypes = [vp, vp, vp, vp, vp, vp, i64, vp, vp, i64, vp, vp, i64, i32, f32, vp]
    g_in, rows_in, g_th, rows_th, g_x, rows_x = cs.cbow_hs_occurrence_lists(inp, True)
    emb_in, theta, acc_in, acc_th = (x.clone() for x in inp["hs"])
    live = rows_th >= 0
    n_live = int(live.sum())
    distinct = torch.full_like(rows_th, -1)
    distinct[live] = torch.arange(n_live, dtype=torch.int32, device=rows_th.device)
    theta_d = torch.zeros((n_live, theta.shape[1]), device=theta.device)
    acc_d = torch.ones((n_live,), device=theta.device)

    def call(th, acc, rows):
        def run():
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            rc = fn(_ptr(emb_in), _ptr(th), _ptr(acc_in), _ptr(acc), _ptr(g_in), _ptr(rows_in),
                    rows_in.numel(), _ptr(g_th), _ptr(rows), rows.numel(), _ptr(g_x),
                    _ptr(rows_x), 0, g_in.shape[1], 0.05, stream)
            if rc != 0:
                raise RuntimeError(f"CUDA error {rc}")
        return run

    as_is = cs.time_ms(call(theta, acc_th, rows_th), reps=20)
    spread = cs.time_ms(call(theta_d, acc_d, distinct), reps=20)
    n_distinct = int(torch.unique(rows_th[live]).numel())
    print(json.dumps({"k4_probe": "CBOW-HS per-occurrence lists", "rows_in": rows_in.numel(),
                      "rows_theta": rows_th.numel(), "live_theta": n_live,
                      "distinct_theta": n_distinct, "ms_as_is": as_is,
                      "ms_all_distinct": spread, "contention_ms": as_is - spread}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
