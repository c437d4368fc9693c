#!/usr/bin/env python3
"""Where K9 ``cbow_grads`` and K13 ``sgns_pair_grads`` spend their time, on
one card: patched copies of their sources side by side, and ``clock64()`` at
each phase of a block.

    python3 experiments/cbow_pair_attribution.py            # build, time and profile
    python3 experiments/cbow_pair_attribution.py --check    # only check that every patch applies

Every library is built alone with nvcc (sm_90a, one process each, all
started together) into ``build/cbow_pair_attribution/``, from
``node2vec_torch/csrc/cbow.cu`` or ``sgns_pairs.cu`` with the shared
``tf32_tiles.cuh`` written in (``_variants.source``):

* variants: one part of the work cut out by a text patch (``VARIANTS``),
  called through the kernel's C entry at the main path's shape.  A variant
  computes wrong numbers by design; only its time is read (CUDA events over
  20 launches).  Differences between variants say what each part costs;
  they do not add up to the whole, since the parts overlap.  K13's "no
  stores" drops the per-lane gradient stores (the bound's bytes); "stores
  evict-first" writes them with ``st.global.cs``.  K9's "H remade in pass
  2" sums H_c from the ring again in pass 2 instead of reading the [Mt, D]
  H that pass 1 kept (what K9 does at shapes where that H does not fit).
* phases: ``clock64()`` probes at each phase boundary of a block's item
  loop (``PHASES``), read by the first thread of warp 0 and of warp 15,
  each adding the cycles since its previous probe to a counter of that
  phase (a barrier's wait counts in the phase that ends at it); the
  thousands of cycles a block spends in each phase a launch.

The inputs: B = 2,560 random walks with dead tails of a 131,072-vertex
vocabulary (10% out of it), L1 = 21, D = 128, S = 64, w = 5, cbow_mean for
K9, the pair lists of the same walks for K13.  Prints ptxas's registers and
spills of each build, one JSON line a variant and phase profile, then the
card's name and power limit.
"""

import ctypes
import json
import os
import sys

from _variants import ROOT, build, card, patched, source

OUT = os.path.join(ROOT, "build", "cbow_pair_attribution")

NO_PRODUCTS = ("  for (int k = k0; k < k1; k += 8) {\n    float av[4];",
               "  for (int k = k0; k < k0; k += 8) {\n    float av[4];")
VARIANTS = {
    "k9": {
        "as built": [],
        "no products": [NO_PRODUCTS],
        "no context sums": [("  if (!t.valid[r]) return h;\n  const int i = r % g.L, b",
                             "  return h;\n  const int i = r % g.L, b")],
        "no g_in scatter": [("  if (!t.valid[j]) return s;\n", "  return s;\n")],
        "no stores": [("store4(a.d_out", "if (D < 0) store4(a.d_out"),
                      ("      store4(a.g_in", "      if (D < 0) store4(a.g_in")],
        # H_c summed again in pass 2 where the kept H fits as well
        "H remade in pass 2": [("  keep_h = smem_bytes(g, true) <= kSmemOptin;",
                                "  keep_h = false;")],
    },
    "k13": {
        "as built": [],
        "no products": [NO_PRODUCTS],
        "no stores": [("      store4(a.d_ci + (lane0 + lr) * D, c0 + col, D, vec_out, ci);\n"
                       "      store4(a.d_co + (lane0 + lr) * D, c0 + col, D, vec_out, co);\n",
                       "      if (D < 0) {\n"
                       "        store4(a.d_ci + (lane0 + lr) * D, c0 + col, D, vec_out, ci);\n"
                       "        store4(a.d_co + (lane0 + lr) * D, c0 + col, D, vec_out, co);\n"
                       "      }\n")],
        "stores evict-first": [("    if (col < dim) *reinterpret_cast<float4*>(dst + col) = v;",
                                "    if (col < dim) __stcs(reinterpret_cast<float4*>(dst + col), v);")],
    },
}

PHASES = {
    "k9": ["prologue", "top wait + barrier", "gather issue + table", "pass 1 context sums",
           "pass 1 products", "elementwise", "pass 2 context sums + d_out", "pass 2 products",
           "g_in scatter + stores", "epilogue"],
    "k13": ["prologue", "top wait + barrier", "gather issue + table", "pass 1 products",
            "elementwise", "pass 2 products", "store phase", "epilogue"],
}
PROBE = ("if (threadIdx.x == 0 || threadIdx.x == 480) { const long long _n = clock64(); "
         "atomicAdd(&phase_clk[(threadIdx.x ? 16 : 0) + %d], "
         "(unsigned long long)(_n - _t)); _t = _n; }")
PHASE_READ = """
extern "C" int phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, phase_clk, sizeof(phase_clk));
}
extern "C" int phase_reset() {
  unsigned long long z[32] = {};
  return (int)cudaMemcpyToSymbol(phase_clk, z, sizeof(z));
}
"""


def phase_probes(kernel: str):
    """(anchor, replacement) pairs for a kernel's phase probes."""
    p = [PROBE % k for k in range(len(PHASES[kernel]))]
    common = [
        ("namespace {\n\nusing namespace tiles;",
         "__device__ unsigned long long phase_clk[32];\nnamespace {\n\nusing namespace tiles;"),
        ("  for (int t = 0; t < n_items; ++t) {\n", f"  {p[0]}\n  for (int t = 0; t < n_items; ++t) {{\n"),
        ("    __syncthreads();  // item t landed; item t - 1's stage is free\n",
         f"    __syncthreads();  // item t landed; item t - 1's stage is free\n    {p[1]}\n"),
        ("    cp_commit();\n\n    const float* xin = ring",
         f"    cp_commit();\n    {p[2]}\n\n    const float* xin = ring"),
    ]
    if kernel == "k9":
        return common + [
            ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n  const int D = g.D,",
             "  long long _t = clock64();\n  const int tid = threadIdx.x, lane = tid & 31, "
             "warp = tid >> 5;\n  const int D = g.D,"),
            ("      __syncthreads();\n      pass1_products(g, it.chunk, hcc, ldh, no + c0, nlg, nullptr, "
             "nullptr);\n      continue;",
             f"      __syncthreads();\n      {p[3]}\n      pass1_products(g, it.chunk, hcc, ldh, no + c0, "
             f"nlg, nullptr, nullptr);\n      {p[4]}\n      continue;"),
            ("      if (ahead) context_counts(tn, g);  // read from the next group's first item\n    }\n",
             "      if (ahead) context_counts(tn, g);  // read from the next group's first item\n"
             f"    }}\n    {p[5]}\n"),
            ("scale4(gpos[r], h));\n    }\n    __syncthreads();\n",
             f"scale4(gpos[r], h));\n    }}\n    __syncthreads();\n    {p[6]}\n"),
            ("        accumulate_dno<kP2Tiles>(dno + c0, g, nlg, hcc, ldh, s0, n0, k_live);\n      }\n"
             "    }\n    __syncthreads();\n",
             "        accumulate_dno<kP2Tiles>(dno + c0, g, nlg, hcc, ldh, s0, n0, k_live);\n      }\n"
             f"    }}\n    __syncthreads();\n    {p[7]}\n"),
            ("context_scatter(tb, g, gh, r, col));\n  }\n",
             f"context_scatter(tb, g, gh, r, col));\n    {p[8]}\n  }}\n"),
            ("  flush_block(dno, g, a.d_no, red, pos_acc, neg_acc, ctr_acc, a.loss_parts);\n}",
             f"  flush_block(dno, g, a.d_no, red, pos_acc, neg_acc, ctr_acc, a.loss_parts);\n  {p[9]}\n}}"),
        ]
    return common + [
        ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n  const int L = g.L,",
         "  long long _t = clock64();\n  const int tid = threadIdx.x, lane = tid & 31, "
         "warp = tid >> 5;\n  const int L = g.L,"),
        ("      pass1_products(g, it.chunk, xin, g.ldx, no + c0, nlg, xout, plb);\n      continue;",
         f"      pass1_products(g, it.chunk, xin, g.ldx, no + c0, nlg, xout, plb);\n      {p[3]}\n"
         "      continue;"),
        ("          gpos[o * Mt + r] = gp;\n        }\n      }\n      __syncthreads();\n    }\n",
         f"          gpos[o * Mt + r] = gp;\n        }}\n      }}\n      __syncthreads();\n    }}\n    {p[4]}\n"),
        ("        accumulate_dno<kP2Tiles>(dno + c0, g, gm, xin, g.ldx, s0, n0, k_live);\n      }\n"
         "    }\n    __syncthreads();\n",
         "        accumulate_dno<kP2Tiles>(dno + c0, g, gm, xin, g.ldx, s0, n0, k_live);\n      }\n"
         f"    }}\n    __syncthreads();\n    {p[5]}\n"),
        ("          ++ql;\n        }\n    }\n  }\n", f"          ++ql;\n        }}\n    }}\n    {p[6]}\n  }}\n"),
        ("  flush_block(dno, g, a.d_no, red, pos_acc, neg_acc, mult_acc, a.loss_parts);\n}",
         f"  flush_block(dno, g, a.d_no, red, pos_acc, neg_acc, mult_acc, a.loss_parts);\n  {p[7]}\n}}"),
    ]


FILES = {"k9": "cbow.cu", "k13": "sgns_pairs.cu"}


def sources() -> dict:
    """Each library's name ("k9: as built", ...), CUDA source and extra nvcc
    flags; exits when a patch does not apply."""
    out = {}
    for kernel, file in FILES.items():
        src = source(file)
        for name, pairs in VARIANTS[kernel].items():
            out[f"{kernel}: {name}"] = (patched(src, pairs), [])
        out[f"{kernel}: phases"] = (patched(src, phase_probes(kernel)) + PHASE_READ, [])
    return out


def main() -> int:
    srcs = sources()
    if "--check" in sys.argv[1:]:
        print(json.dumps({"libraries": list(srcs), "patches_apply": True}))
        return 0
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from node2vec_torch.models import skipgram as sg

    libs = build(srcs, OUT, lambda name: "cbow_grads_kernel" if name.startswith("k9")
                 else "sgns_pair_grads_kernel")
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(1)
    n_vertices, n_walks, length, window, n_neg, dim = 131072, 2560, 21, 5, 64, 128
    walks = rng.integers(0, n_vertices, (n_walks, length)).astype(np.int32)
    dead = rng.integers(length // 2, length + 1, n_walks)
    walks[np.arange(length)[None, :] >= dead[:, None]] = -1
    walks = torch.from_numpy(walks).to(dev)
    mask = torch.from_numpy(rng.random(n_vertices) > 0.1).to(dev)
    b_sh = torch.from_numpy(rng.integers(1, window + 1, (n_walks, length)).astype(np.int32)).to(dev)
    neg = torch.from_numpy(rng.integers(0, n_vertices, n_neg).astype(np.int32)).to(dev)
    emb_in, emb_out = (torch.from_numpy(rng.normal(0, 0.1, (n_vertices, dim)).astype(np.float32))
                       .to(dev) for _ in range(2))
    centers, _ = sg.pair_lists_plain(walks, b_sh, mask, window)
    n_lanes = centers.numel()
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    def call(kernel, lib):
        """A launch of the library's K9 or K13 entry at the shape above."""
        d_no = torch.zeros((n_neg, dim), device=dev)
        parts = torch.zeros((n_walks, 3), device=dev)
        if kernel == "k9":
            fn = lib.n2v_cbow_grads
            fn.argtypes = [vp, vp, i32, vp, vp, vp, vp, i32, i32, i32, i32, f32, i32, vp, vp, vp,
                           vp, vp, i32, vp]
            g_in = torch.empty((n_walks * length, dim), device=dev)
            d_out = torch.empty_like(g_in)
            args = (ptr(emb_in), ptr(emb_out), dim, ptr(walks), ptr(mask), ptr(b_sh), ptr(neg),
                    n_walks, length, window, n_neg, 5.0 / n_neg, 1, ptr(g_in), ptr(d_out),
                    ptr(d_no), ptr(parts), None, 0, stream)
        else:
            fn = lib.n2v_sgns_pair_grads
            fn.argtypes = [vp, vp, i32, vp, vp, vp, i32, i32, i32, i32, f32, vp, vp, vp, vp, vp,
                           i32, vp]
            d_ci = torch.empty((n_lanes, dim), device=dev)
            d_co = torch.empty_like(d_ci)
            args = (ptr(emb_in), ptr(emb_out), dim, ptr(walks), ptr(centers), ptr(neg),
                    n_walks, length, window, n_neg, 5.0 / n_neg, ptr(d_ci), ptr(d_co),
                    ptr(d_no), ptr(parts), None, 0, stream)

        def run():
            rc = fn(*args)
            if rc != 0:
                raise RuntimeError(f"CUDA error {rc}")
        return run, (locals().get("g_in"), locals().get("d_ci"))  # keep outputs alive

    for kernel in FILES:
        for name in VARIANTS[kernel]:
            run, _keep = call(kernel, libs[f"{kernel}: {name}"])
            print(json.dumps({"kernel": kernel, "variant": name,
                              "ms": chip_smoke.time_ms(run, reps=20)}), flush=True)
        lib = libs[f"{kernel}: phases"]
        run, _keep = call(kernel, lib)
        blocks = min(n_sm, -(-n_walks // (64 // length)))  # one block an SM, at most one a group
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        lib.phase_reset()
        reps = 20
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
        clk = (ctypes.c_ulonglong * 32)()
        lib.phase_read(clk)
        for warp, off in (("warp 0", 0), ("warp 15", 16)):
            kclk = {p: clk[off + k] / blocks / reps / 1e3 for k, p in enumerate(PHASES[kernel])}
            print(json.dumps({"phases": {"kernel": kernel, "warp": warp},
                              "kclk_a_block_a_launch": kclk, "total_kclk": sum(kclk.values()),
                              "kernel_ms": start.elapsed_time(end) / reps}), flush=True)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
