#!/usr/bin/env python3
"""Where K16 ``col_pair_logits`` and K17 ``col_pair_grads`` spend their
time, on one card: ``clock64()`` at each phase of a block, in patched copies
of ``csrc/col_sgns.cu``.

    python3 experiments/col_sgns_attribution.py                  # this tree's kernels
    python3 experiments/col_sgns_attribution.py --csrc DIR       # another tree's csrc/
    python3 experiments/col_sgns_attribution.py --check [--csrc DIR]   # only check the patches

The libraries are built with nvcc (sm_90a, one process each, all started
together) into ``build/col_sgns_attribution/`` from the ``csrc/`` given (a
parent's unpacked ``git archive`` for a before/after), through
``_variants.py``:

* K16 and K17 as built, timed by CUDA events over 20 launches through their
  C entries;
* copies with one part of the work cut out by a text patch (``VARIANTS``:
  wrong numbers by design, only the time read; the parts overlap, so the
  differences do not add up to the whole);
* copies with ``clock64()`` probes at each phase (``PHASES``, after the
  design the source holds: the earlier one-walk-a-block kernels, or the
  walk groups on ``tf32_tiles.cuh``); the first lane of every warp adds the
  cycles since its previous probe to that phase, so a barrier's wait counts
  in the phase that ends at it.  Printed as thousands of cycles a warp a
  launch, with each phase's share.

The inputs: B = 2,560 random walks of 21 with -1 tails over 131,072 vertices
(10% out of the vocabulary), w = 5, S = 64, the pair lists of the walks
(``_batch_inputs`` of chip_smoke.py, as ``check_col_sgns`` takes them), at
Dm = 128 (``main_path_mesh``'s 1 x 1 width) and Dm = 64; K17 takes the
plain logits.  Prints ptxas's registers and spills of each build, one JSON
line a timing and a profile, then the card's name and power limit.  Neither
the port nor the smoke imports this file.
"""

import ctypes
import json
import os
import sys

from _variants import (CSRC, PROBE_START, ROOT, build, card, patched, phase_read,
                       probe_counters, probe_flush, probes, profile, source)

OUT = os.path.join(ROOT, "build", "col_sgns_attribution")

# the one-walk-a-block design: a 256-thread block a walk, every logit a warp's dot
PHASES_BLOCK = {
    "k16": ["negatives issue", "walk load (rows, two barriers)", "positive logits (warp dots)",
            "negative logits (warp dots)", "end barrier"],
    "k17": ["negatives load", "walk load (rows, two barriers)", "elementwise",
            "GN and d_no partial (CUDA cores)", "lane rows and squares", "end barrier",
            "epilogue (d_no atomics, ticket)"],
}


def probes_block(kernel: str):
    n = len(PHASES_BLOCK[kernel])
    p = probes(n)
    flush = probe_flush(kernel, n)
    top = "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
    head = [("namespace {\n\nconstexpr int kThreads = 256;",
             probe_counters(kernel) + "namespace {\n\nconstexpr int kThreads = 256;")]
    if kernel == "k16":
        return head + [
            (top + "  for (int i = tid; i < S * D; i += kThreads)\n    no[i]",
             "  " + PROBE_START + top + "  for (int i = tid; i < S * D; i += kThreads)\n    no[i]"),
            ("    no[i] = emb_out[static_cast<int64_t>(neg_ids[i / D]) * D + i % D];\n\n  for (int b",
             "    no[i] = emb_out[static_cast<int64_t>(neg_ids[i / D]) * D + i % D];\n"
             f"  {p[0]}\n\n  for (int b"),
            ("              live);\n    for (int q = warp; q < W2 * L; q += kWarps) {",
             f"              live);\n    {p[1]}\n    for (int q = warp; q < W2 * L; q += kWarps) {{"),
            ("      if (lane == 0) pos_part[lane0 + q] = acc;\n    }\n",
             f"      if (lane == 0) pos_part[lane0 + q] = acc;\n    }}\n    {p[2]}\n"),
            ("      if (lane == 0) neg_out[q] = acc;\n    }\n",
             f"      if (lane == 0) neg_out[q] = acc;\n    }}\n    {p[3]}\n"),
            ("    __syncthreads();  // the next walk overwrites the shared rows\n  }\n}\n\n"
             "__global__ void __launch_bounds__(kThreads)\nlogits_kernel(",
             "    __syncthreads();  // the next walk overwrites the shared rows\n"
             f"    {p[4]}\n  }}\n{flush}}}\n\n"
             "__global__ void __launch_bounds__(kThreads)\nlogits_kernel("),
        ]
    return head + [
        (top + "  for (int i = tid; i < S * D; i += kThreads) {",
         "  " + PROBE_START + top + "  for (int i = tid; i < S * D; i += kThreads) {"),
        ("    dno[i] = 0.f;\n  }\n  float pos_acc = 0.f, neg_acc = 0.f, mult_acc = 0.f;\n",
         f"    dno[i] = 0.f;\n  }}\n  float pos_acc = 0.f, neg_acc = 0.f, mult_acc = 0.f;\n  {p[0]}\n"),
        ("              live);\n    for (int i = tid; i < L; i += kThreads) mult_acc += mult[i];",
         f"              live);\n    {p[1]}\n"
         "    for (int i = tid; i < L; i += kThreads) mult_acc += mult[i];"),
        ("      gneg[q] = g;\n    }\n    __syncthreads();\n",
         f"      gneg[q] = g;\n    }}\n    __syncthreads();\n    {p[2]}\n"),
        ("      dno[e] += acc;\n    }\n    __syncthreads();\n",
         f"      dno[e] += acc;\n    }}\n    __syncthreads();\n    {p[3]}\n"),
        ("        sq_co[lane0 + q] = sc;\n      }\n    }\n",
         f"        sq_co[lane0 + q] = sc;\n      }}\n    }}\n    {p[4]}\n"),
        ("    __syncthreads();  // the next walk overwrites the shared rows\n  }\n\n"
         "  for (int i = tid; i < S * D; i += kThreads) atomicAdd(d_no + i, dno[i]);",
         "    __syncthreads();  // the next walk overwrites the shared rows\n"
         f"    {p[5]}\n  }}\n\n"
         "  for (int i = tid; i < S * D; i += kThreads) atomicAdd(d_no + i, dno[i]);"),
        ("  if (tid == 0) *last = atomicAdd(done, 1u) == gridDim.x - 1;\n  __syncthreads();\n"
         "  if (!*last) return;",
         "  if (tid == 0) *last = atomicAdd(done, 1u) == gridDim.x - 1;\n  __syncthreads();\n"
         f"  {p[6]}\n{flush}  if (!*last) return;"),
    ]


# the walk-group design: groups on tf32_tiles.cuh, a pass over a group's chunks
PHASES_GROUPS = {
    "k16": ["prologue", "top wait + barrier", "gather issue + tables", "pass 1 products",
            "mult + barrier", "outputs"],
    "k17": ["prologue", "top wait + barrier", "gather issue + tables", "elementwise",
            "pass 2 products + barrier", "store phase", "epilogue"],
}


def probes_groups(kernel: str):
    n = len(PHASES_GROUPS[kernel])
    p = probes(n)
    flush = probe_flush(kernel, n)
    head = [("namespace {\n\nusing namespace tiles;",
             probe_counters(kernel) + "namespace {\n\nusing namespace tiles;")]
    if kernel == "k16":
        return head + [
            ("  const int L = g.L, D = g.D, S = g.S, W = g.W, Mt = g.Mt, KC = g.KC, nc = g.nc;\n",
             "  const int L = g.L, D = g.D, S = g.S, W = g.W, Mt = g.Mt, KC = g.KC, nc = g.nc;\n"
             "  " + PROBE_START),
            ("  cp_commit();\n\n  for (int t = 0; t < n_items; ++t) {\n",
             f"  cp_commit();\n  {p[0]}\n\n  for (int t = 0; t < n_items; ++t) {{\n"),
            ("    __syncthreads();  // item t landed; item t - 1's stage and outputs are done\n",
             "    __syncthreads();  // item t landed; item t - 1's stage and outputs are done\n"
             f"    {p[1]}\n"),
            ("    cp_commit();\n\n    const float* xin = ring + (t % kStages) * 2 * Mt * g.ldx;\n"
             "    pass1_products",
             f"    cp_commit();\n    {p[2]}\n\n"
             "    const float* xin = ring + (t % kStages) * 2 * Mt * g.ldx;\n    pass1_products"),
            ("nl, xin + Mt * g.ldx, pl);\n", f"nl, xin + Mt * g.ldx, pl);\n    {p[3]}\n"),
            ("    __syncthreads();  // NL, PL and mult complete\n",
             f"    __syncthreads();  // NL, PL and mult complete\n    {p[4]}\n"),
            ("        neg_out[e] = mult[r] > 0.f ? nl[r * g.ldg + s] : 0.f;\n      }\n    }\n  }\n"
             "  cp_wait_all();\n}\n",
             "        neg_out[e] = mult[r] > 0.f ? nl[r * g.ldg + s] : 0.f;\n      }\n    }\n"
             f"    {p[5]}\n  }}\n  cp_wait_all();\n{flush}}}\n"),
        ]
    return head + [
        ("  const int L = g.L, D = g.D, S = g.S, W = g.W, Sp = g.Sp, KC = g.KC, nc = g.nc;\n",
         "  const int L = g.L, D = g.D, S = g.S, W = g.W, Sp = g.Sp, KC = g.KC, nc = g.nc;\n"
         "  " + PROBE_START),
        ("  cp_commit();\n  float pos_acc = 0.f, neg_acc = 0.f, mult_acc = 0.f;\n",
         f"  cp_commit();\n  float pos_acc = 0.f, neg_acc = 0.f, mult_acc = 0.f;\n  {p[0]}\n"),
        ("    __syncthreads();  // item t landed; item t - 1's stage is free\n",
         f"    __syncthreads();  // item t landed; item t - 1's stage is free\n    {p[1]}\n"),
        ("    cp_commit();\n\n    const Item it = group_of(g, a.n_walks, q);\n",
         f"    cp_commit();\n    {p[2]}\n\n    const Item it = group_of(g, a.n_walks, q);\n"),
        ("        gpos[lr] = gp;\n      }\n      __syncthreads();\n    }\n",
         f"        gpos[lr] = gp;\n      }}\n      __syncthreads();\n    }}\n    {p[3]}\n"),
        ("        accumulate_dno<kP2Tiles>(dno + c0, g, gm, xin, g.ldx, s0, n0, k_live);\n      }\n"
         "    }\n    __syncthreads();\n",
         "        accumulate_dno<kP2Tiles>(dno + c0, g, gm, xin, g.ldx, s0, n0, k_live);\n      }\n"
         f"    }}\n    __syncthreads();\n    {p[4]}\n"),
        ("          ++ql;\n        }\n    }\n  }\n  cp_wait_all();\n  __syncthreads();\n  flush_block(",
         f"          ++ql;\n        }}\n    }}\n    {p[5]}\n  }}\n  cp_wait_all();\n"
         "  __syncthreads();\n  flush_block("),
        ("  if (tid == 0) *last = atomicAdd(a.done, 1u) == gridDim.x - 1;\n  __syncthreads();\n"
         "  if (!*last) return;",
         "  if (tid == 0) *last = atomicAdd(a.done, 1u) == gridDim.x - 1;\n  __syncthreads();\n"
         f"  {p[6]}\n{flush}  if (!*last) return;"),
    ]


VARIANTS_GROUPS = {
    # both kernels' mma_tile loops empty
    "no products": [("  for (int k = k0; k < k1; k += 8) {\n    float av[4];",
                     "  for (int k = k0; k < k0; k += 8) {\n    float av[4];")],
    # K17 without its per-lane gradient stores (the bound's bytes)
    "no stores": [("        store4(a.d_ci + (lane0 + lr) * D, c0 + col, D, vec_out, ci);\n"
                   "        store4(a.d_co + (lane0 + lr) * D, c0 + col, D, vec_out, co);\n",
                   "        if (D < 0) {\n"
                   "          store4(a.d_ci + (lane0 + lr) * D, c0 + col, D, vec_out, ci);\n"
                   "          store4(a.d_co + (lane0 + lr) * D, c0 + col, D, vec_out, co);\n"
                   "        }\n")],
}
# K17 without the per-lane squares (no shuffles, no per-lane sums); and
# without the squares and the stores
NO_SQUARES = [("      for (int off = kRowThreads / 2; off > 0; off >>= 1) {",
               "      for (int off = 0; off > 0; off >>= 1) {"),
              ("      if (piece == 0) {", "      if (piece == 0 && D < 0) {")]
VARIANTS_GROUPS["no squares"] = NO_SQUARES
VARIANTS_GROUPS["no squares, no stores"] = NO_SQUARES + VARIANTS_GROUPS["no stores"]
PHASES = {"walk_block": PHASES_BLOCK, "walk_groups": PHASES_GROUPS}
PROBES = {"walk_block": probes_block, "walk_groups": probes_groups}
VARIANTS = {"walk_block": {}, "walk_groups": VARIANTS_GROUPS}


def design(csrc: str) -> str:
    """"walk_block" for the one-walk-a-block kernels, "walk_groups" for the walk groups
    on tf32_tiles.cuh."""
    raw = open(os.path.join(csrc, "col_sgns.cu")).read()
    return "walk_groups" if '#include "tf32_tiles.cuh"' in raw else "walk_block"


def sources(csrc: str) -> dict:
    """Each library's name ("k16 phases", ...), CUDA source and extra nvcc
    flags; exits when a patch does not apply."""
    kind = design(csrc)
    text = source("col_sgns.cu", csrc)
    out = {"as built": (text, [])}
    for name, pairs in VARIANTS[kind].items():
        out[name] = (patched(text, pairs), [])
    for kernel in ("k16", "k17"):
        out[f"{kernel} phases"] = (patched(text, PROBES[kind](kernel)) + phase_read(kernel), [])
    return out


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def calls(lib, inp, logits):
    """(K16 call, K17 call) through the library's C entries on ``inp``
    (chip_smoke._batch_inputs with the pair lists), shared staging."""
    import torch

    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    emb_in, emb_out = inp["e_in"], inp["e_out"]
    walks, centers, neg = inp["walks"], inp["centers"], inp["neg"]
    n_walks, length = walks.shape
    dim, s, w = emb_in.shape[1], neg.numel(), inp["window"]
    n = centers.numel()
    dev = emb_in.device
    out16 = torch.empty((n + n_walks * length * s,), device=dev)
    d_ci = torch.empty((n, dim), device=dev)
    d_co = torch.empty_like(d_ci)
    d_no = torch.zeros((s, dim), device=dev)
    sq = torch.empty((2 * n + s,), device=dev)
    parts = torch.zeros((n_walks, 3), device=dev)
    done = torch.zeros((1,), dtype=torch.int32, device=dev)
    k16, k17 = lib.n2v_col_pair_logits, lib.n2v_col_pair_grads
    k16.argtypes = [vp, vp, i32, vp, vp, vp, i32, i32, i32, i32, vp, vp, vp, i32, vp]
    k17.argtypes = [vp, vp, i32, vp, vp, vp, vp, vp, i32, i32, i32, i32, f32] + [vp] * 9 + [i32, vp]

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run16():
        rc = k16(_ptr(emb_in), _ptr(emb_out), dim, _ptr(walks), _ptr(centers), _ptr(neg),
                 n_walks, length, w, s, _ptr(out16), _ptr(out16[n:]), None, 0, stream())
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")

    def run17():
        done.zero_()  # the last block's ticket
        rc = k17(_ptr(emb_in), _ptr(emb_out), dim, _ptr(walks), _ptr(centers), _ptr(neg),
                 _ptr(logits), _ptr(logits[n:]), n_walks, length, w, s, 5.0 / s, _ptr(d_ci),
                 _ptr(d_co), _ptr(d_no), _ptr(sq), _ptr(sq[n:]), _ptr(sq[2 * n:]), _ptr(parts),
                 _ptr(done), None, 0, stream())
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
    return run16, run17


def main() -> int:
    args = sys.argv[1:]
    csrc = os.path.abspath(args[args.index("--csrc") + 1]) if "--csrc" in args else CSRC
    srcs = sources(csrc)
    kind = design(csrc)
    if "--check" in args:
        print(json.dumps({"csrc": csrc, "design": kind, "libraries": list(srcs),
                          "patches_apply": True}))
        return 0
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from node2vec_torch.models import skipgram as sg
    from node2vec_torch.parallel import sharded_sgns as col

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(srcs, OUT, lambda name: "_kernel")
    print(json.dumps({"csrc": csrc, "design": kind}), flush=True)
    base = cs._batch_inputs(131072, 2560, 21, 128, 5, 11, 0.1, None)
    centers, contexts = sg.pair_lists_plain(base["walks"], base["b_sh"], base["mask"], 5)
    for dm in (128, 64):
        e_in, e_out = (t[:, :dm].contiguous() for t in base["state"][:2])
        inp = dict(e_in=e_in, e_out=e_out, walks=base["walks"], centers=centers,
                   neg=base["neg"], window=5)
        logits = col.col_pair_logits_plain(e_in, e_out, base["walks"], centers, contexts,
                                           base["neg"], window=5)
        for name, lib in libs.items():
            run16, run17 = calls(lib, inp, logits)
            for kernel, run in (("k16", run16), ("k17", run17)):
                if name.endswith("phases") and not name.startswith(kernel):
                    continue
                line = {"Dm": dm, "kernel": kernel, "build": name,
                        "ms": cs.time_ms(run, reps=20)}
                if name.endswith("phases"):
                    line.update(profile(lib, kernel, run, PHASES[kind][kernel]))
                print(json.dumps(line), flush=True)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
