#!/usr/bin/env python3
"""Where K8 ``hs_grads`` spends its time, on one card: patched copies of its
source side by side, and ``clock64()`` at each phase of a block.

    python3 experiments/hs_attribution.py            # build, time and profile
    python3 experiments/hs_attribution.py --check    # only check that every patch applies
    python3 experiments/hs_attribution.py --alt FILE.cu ...   # also time other hs.cu drafts

Every library is built alone with nvcc (sm_90a, one process each, all
started together) into ``build/hs_attribution/`` from
``node2vec_torch/csrc/hs.cu``:

* variants: one part of the work cut out by a text patch (``VARIANTS``),
  called through the C entry ``n2v_hs_grads``.  A variant computes wrong
  numbers by design; only its time is read (CUDA events over 20 launches).
  The differences between variants say what each part costs; they do not
  add up to the whole, since the parts overlap.  The patches name exact
  source lines, so an edit of K8 makes ``--check`` fail until they follow
  it.
* phases: ``hs.cu`` with ``clock64()`` probes patched in at each phase
  boundary of a block's item loop (``PHASES``: a barrier's wait counts in
  the phase that ends at it); thread 0 of every block sums each phase's
  cycles in registers and adds them to a device counter when the block
  ends, read by ``hs_phase_read``; printed as thousands of cycles a block a
  launch.  ``--alt`` drafts are profiled only where the same patch applies.

The inputs are ``main_path_hs``'s: the dense ER graph's Huffman tree
(131,072 vertices, counts from the degrees, CL 18, H 9, K 511) and 2,570
walks of its first chunk, shuffled (L1 = 21), D = 128, w = 5, N(0, 0.1)
tables.  Prints ptxas's registers and spills of each build, one JSON line a
variant and the phase profile, then the card's name and power limit.
"""

import ctypes
import json
import os
import sys

from _variants import CSRC, ROOT, build, card, patched

OUT = os.path.join(ROOT, "build", "hs_attribution")

VARIANTS = {
    "as built": [],
    "no phase A": [("        phase_a<NQ>(g, s * P, c, xg, th, tb, wix, gcen, gi, loss_acc);\n", "")],
    "no g_in flush": [("        flush_gin<NQ>(g, s * P, gi, gis, 0);\n", "")],
    "no phase B": [("        phase_b<NQ>(g, s * P, c, xg, tb, gcen, dhs, a, rows, row0, vec_out, "
                    "64 * NQ * k);\n", "        ;\n")],
    "no head output": [("    if (id < 0) continue;\n    if (id < g.KS) {",
                        "    if (id < 0 || id >= 0) continue;\n    if (id < g.KS) {")],
    "no tail stores": [("          if (col < D) *reinterpret_cast<float4*>(dst + col) = gc[i][q];",
                        "          if (col < D && gc[i][q].x == 12345.f) "
                        "*reinterpret_cast<float4*>(dst + col) = gc[i][q];")],
    "cp.async gathers": [("  const bool bulk = kShared && vec;", "  const bool bulk = false;")],
    "head partial 63 rows": [("  g.KS = k_rows < ks ? k_rows : ks;",
                              "  ks = ks < 63 ? ks : 63;\n  g.KS = k_rows < ks ? k_rows : ks;")],
}
PHASES = ["wait + barrier", "next group's tables", "gather issue", "pair count",
          "phase A", "barrier", "phase B", "g_in out"]


PROBE = ("if (tid == 0) { const long long _n = clock64(); _pr[%d] += _n - _t; _t = _n; }")
PHASE_READ = """
extern "C" int hs_phase_read(unsigned long long* out) {  // read, then reset
  cudaError_t err = cudaMemcpyFromSymbol(out, hs_phase_clk, sizeof(hs_phase_clk));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long z[8] = {};
  return (int)cudaMemcpyToSymbol(hs_phase_clk, z, sizeof(z));
}
"""


def phase_probes():
    """(anchor, replacement) pairs for the phase profile's probes."""
    p = [PROBE % k for k in range(len(PHASES))]
    return [
        ("namespace {\n\nconstexpr int kThreads",
         "__device__ unsigned long long hs_phase_clk[8];\nnamespace {\n\nconstexpr int kThreads"),
        ("  const int CL = g.CL, Mt = g.Mt;\n",
         "  const int CL = g.CL, Mt = g.Mt;\n  long long _pr[8] = {};\n"),
        ("  for (int t = 0; t < n_items; ++t) {\n",
         "  for (int t = 0; t < n_items; ++t) {\n    long long _t = clock64();\n"),
        ("    __syncthreads();  // item t landed; item t - 1's stage is free\n",
         f"    __syncthreads();  // item t landed; item t - 1's stage is free\n    {p[0]}\n"),
        ("      if (CL == 1) __syncthreads();\n    }\n",
         f"      if (CL == 1) __syncthreads();\n    }}\n    {p[1]}\n"),
        ("tb.cinfo[i + d] >= 0) pair_acc += 1.f;\n        }\n      }\n    }\n",
         f"tb.cinfo[i + d] >= 0) pair_acc += 1.f;\n        }}\n      }}\n    }}\n    {p[3]}\n"),
        ("        flush_gin<NQ>(g, s * P, gi, gis, 0);\n      }\n    }\n",
         f"        flush_gin<NQ>(g, s * P, gi, gis, 0);\n      }}\n    }}\n    {p[4]}\n"),
        ("    cp_commit();\n    __syncthreads();  // every g of the level is in gcen\n",
         f"    cp_commit();\n    {p[2]}\n    __syncthreads();  // every g of the level is in gcen\n"
         f"    {p[5]}\n"),
        ("    if (c == CL - 1)  // the group's g_in", f"    {p[6]}\n    if (c == CL - 1)  // the group's g_in"),
        ("64 * NQ * k);\n  }\n  cp_wait_all();\n",
         f"64 * NQ * k);\n    {p[7]}\n  }}\n  cp_wait_all();\n"),
        ("    a.loss_parts[2 * blockIdx.x + tid] = s;\n  }\n}\n",
         "    a.loss_parts[2 * blockIdx.x + tid] = s;\n  }\n  if (tid == 0)\n"
         "    for (int k = 0; k < 8; ++k) atomicAdd(&hs_phase_clk[k], (unsigned long long)_pr[k]);\n}\n"),
    ]


def sources(alts=()) -> dict:
    """Each library's name, CUDA source and extra nvcc flags; ``alts``: other
    drafts of hs.cu (same C entries), each timed as built and profiled."""
    src = open(os.path.join(CSRC, "hs.cu")).read()
    out = {name: (patched(src, pairs), []) for name, pairs in VARIANTS.items()}
    out["phases"] = (patched(src, phase_probes()) + PHASE_READ, [])
    for path in alts:
        text = open(path).read()
        out[f"alt {path}"] = (text, [])
        out[f"phases {path}"] = (patched(text, phase_probes()) + PHASE_READ, [])
    return out


def main() -> int:
    args = sys.argv[1:]
    alts = args[args.index("--alt") + 1:] if "--alt" in args else []
    srcs = sources(alts)
    if "--check" in args:
        print(json.dumps({"libraries": list(srcs), "patches_apply": True}))
        return 0
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from node2vec_torch.constants import Node2VecParams
    from node2vec_torch.graph import build_graph
    from node2vec_torch.models import hsoftmax as hs
    from node2vec_torch.walk import WalkEngine

    libs = build(srcs, OUT, lambda name: "hs_grads_kernelILi2ELb0")
    dev = torch.device("cuda")
    src, dst = cs.smoke_edges(131072, 2_097_152)
    g = build_graph((src, dst), directed=False)
    tree, counts = cs.hs_tree(g)
    head = hs.head_level_offsets(tree, table_rows=tree.n_inner)
    n_head, k_rows = hs.head_split(head, tree.points.shape[1])
    n_walks, length, dim, window = cs._effective_batch(8192, 131072, target_updates=51), 21, 128, 5
    chunk0 = WalkEngine(g, Node2VecParams(**cs.N2V_MAIN), device="cuda").chunk_source(seed=0)[2](0)
    walks_np = chunk0.cpu().numpy()[np.random.default_rng(0).permutation(len(chunk0))]
    (emb_in, theta, _, _), walks, mask, b_sh, (points, codes, lengths) = cs._hs_inputs(
        tree, counts, n_walks, length, dim, window, seed=5, walks=walks_np)
    cl, clt = tree.points.shape[1], tree.points.shape[1] - n_head
    vp, i32 = ctypes.c_void_p, ctypes.c_int

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    g_in = torch.empty((n_walks * length, dim), device=dev)
    g_tail = torch.empty((n_walks * length * clt, dim), device=dev)
    tail_rows = torch.empty((n_walks * length * clt,), dtype=torch.int32, device=dev)
    d_head = torch.zeros((k_rows, dim), device=dev)
    parts = torch.zeros((n_walks, 2), device=dev)

    def k8_call(lib):
        fn = lib.n2v_hs_grads
        fn.argtypes = [vp, vp, i32, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp,
                       vp, vp, vp, vp, vp, i32, vp]
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def run():
            rc = fn(ptr(emb_in), ptr(theta), dim, ptr(walks), ptr(mask), ptr(b_sh), ptr(points),
                    ptr(codes), ptr(lengths), cl, n_walks, length, window, n_head, k_rows,
                    ptr(g_in), ptr(g_tail), ptr(tail_rows), ptr(d_head), ptr(parts), None, 0,
                    stream)
            if rc != 0:
                raise RuntimeError(f"CUDA error {rc}")
        return run

    for name in [*VARIANTS, *(f"alt {p}" for p in alts)]:
        print(json.dumps({"variant": name, "ms": cs.time_ms(k8_call(libs[name]), reps=20)}),
              flush=True)
    for name in ["phases", *(f"phases {p}" for p in alts)]:
        profile(libs[name], name, k8_call, n_walks, length, dim)
    print(card())
    return 0


def profile(lib, name, k8_call, n_walks, length, dim):
    """The phase sums of a probed build, a block a launch."""
    import ctypes
    import torch

    dev = torch.device("cuda")
    vp = ctypes.c_void_p
    lib.hs_phase_read.argtypes = [vp]
    run = k8_call(lib)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    clk = (ctypes.c_ulonglong * len(PHASES))()
    lib.hs_phase_read(clk)  # read and reset
    reps = 20
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    lib.hs_phase_read(clk)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = -(-n_walks // max(1, 64 // length))
    blocks = min(n_sm, groups)  # one block an SM (its shared memory), at most one a group
    kclk = {p: clk[k] / blocks / reps / 1e3 for k, p in enumerate(PHASES)}
    print(json.dumps({"phases": {"build": name, "B": n_walks, "L1": length, "D": dim,
                                 "blocks": blocks, "groups": groups},
                      "kclk_a_block_a_launch": kclk, "total_kclk": sum(kclk.values()),
                      "kernel_ms": start.elapsed_time(end) / reps}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
