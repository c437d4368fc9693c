#!/usr/bin/env python3
"""Where K2 ``sgns_grads`` spends its time, on one card: patched copies of its
source side by side, ``clock64()`` at each phase of a block, and the rate of
``mma.sync`` TF32 alone.

    python3 experiments/k2_attribution.py            # build, time and profile
    python3 experiments/k2_attribution.py --check    # only check that every patch applies

Every library is built alone with nvcc (sm_90a, one process each, all
started together) into ``build/k2_attribution/``:

* variants: ``node2vec_torch/csrc/sgns.cu`` with one part of the work cut
  out by a text patch (``VARIANTS``), called through its C entry
  ``n2v_sgns_grads`` at D = 128 (row stride 128 and 129, the fused tables)
  and D = 64.  A variant computes wrong numbers by design; only its time is
  read (CUDA events over 20 launches).  The differences between variants
  say what each part costs; they do not add up to the whole, since the
  parts overlap.  The patches name exact source lines, so an edit of K2
  makes ``--check`` fail until they follow it.
* phases: ``sgns.cu`` with ``clock64()`` probes at each phase boundary of a
  block's loop (``PHASES``), read by the first thread of warp 0 and of
  warp 15, each adding the cycles since its previous probe to a counter of
  that phase (a barrier's wait counts in the phase that ends at it); the
  thousands of cycles a block spends in each phase a launch, D = 128 and 64.
  The probes cost a few percent of the kernel's time.
* mma: every warp issues independent accumulator chains of 4,096
  ``mma.sync.m16n8k8`` TF32 on register operands (no memory traffic): many
  chains a warp give the rate, one chain a warp the latency along a chain.
  K2 runs its products on this instruction (three a product, 3xTF32), so
  its peak bounds what K2's products can reach without ``wgmma``.

The inputs are the main path's shape: B = 2,560 random walks with dead
tails of a 131,072-vertex vocabulary (10% out of it), L1 = 21, S = 64,
w = 5.  Prints ptxas's registers and spills of each build, one JSON line a
variant, phase profile and mma setting, then the card's name and power limit.
"""

import ctypes
import json
import os
import sys

from _variants import ROOT, build, card, patched, source

OUT = os.path.join(ROOT, "build", "k2_attribution")

VARIANTS = {
    "as built": [],
    # the products' two lo passes gone: one TF32 pass instead of three
    "one TF32 pass": [("      mma_tf32(small[j], al, bh0, bh1);\n", ""),
                      ("      mma_tf32(small[j], ah, bl0, bl1);\n", "")],
    # no fragment loads, splits or mma at all
    "no products": [("  for (int k = k0; k < k1; k += 8) {\n    float av[4];",
                     "  for (int k = k0; k < k0; k += 8) {\n    float av[4];")],
    "no elementwise phase": [("      for (int r = warp; r < Mt; r += kWarps) {  // a warp a row",
                              "      for (int r = warp; r < 0; r += kWarps) {  // a warp a row")],
    "no grad stores": [
        ("        store_grads(acc, a.g_in, it.row0, D, it.rows, m0, c0 + n0);",
         "        if (acc[0][0] == 12345.f) store_grads(acc, a.g_in, it.row0, D, it.rows, m0, c0 + n0);"),
        ("        store_grads(acc, a.g_out, it.row0, D, it.rows, m0, c0 + n0);",
         "        if (acc[0][0] == 12345.f) store_grads(acc, a.g_out, it.row0, D, it.rows, m0, c0 + n0);")],
    "16 x 16 pass-2 tiles": [("  constexpr int kP2Tiles = kShared ? 4 : 2;",
                              "  constexpr int kP2Tiles = 2;")],
}

PHASES = ["prologue", "top wait + barrier", "gather issue", "pass 1 products",
          "pass 1 tables", "multiplicities + barrier", "elementwise + barrier",
          "pass 2 products + stores", "epilogue"]
PROBE = ("if (threadIdx.x == 0 || threadIdx.x == 480) { const long long _n = clock64(); "
         "atomicAdd(&k2_phase_clk[(threadIdx.x ? 16 : 0) + %d], "
         "(unsigned long long)(_n - _t)); _t = _n; }")
PHASE_READ = """
extern "C" int k2_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k2_phase_clk, sizeof(k2_phase_clk));
}
extern "C" int k2_phase_reset() {
  unsigned long long z[32] = {};
  return (int)cudaMemcpyToSymbol(k2_phase_clk, z, sizeof(z));
}
"""

MMA_SOURCE = r"""
#include <cstdint>
template <int kChains>
__global__ void mma_chains(float* out, int iters) {
  float acc[kChains][4] = {};
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(threadIdx.x * 1e-3f + i);
  const uint32_t b0 = __float_as_uint(1.0f), b1 = __float_as_uint(0.5f);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int j = 0; j < kChains; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int chains, float* out, int blocks, int threads, int iters) {
  if (chains == 8) mma_chains<8><<<blocks, threads>>>(out, iters);
  if (chains == 2) mma_chains<2><<<blocks, threads>>>(out, iters);
  if (chains == 1) mma_chains<1><<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def phase_probes():
    """(anchor, replacement) pairs for the phase profile's probes."""
    p = [PROBE % k for k in range(len(PHASES))]
    return [
        ("namespace {\n\nusing namespace tiles;",
         "__device__ unsigned long long k2_phase_clk[32];\nnamespace {\n\nusing namespace tiles;"),
        ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n  const int L = g.L,",
         "  long long _t = clock64();\n  const int tid = threadIdx.x, lane = tid & 31, "
         "warp = tid >> 5;\n  const int L = g.L,"),
        ("  for (int t = 0; t < n_items; ++t) {\n", f"  {p[0]}\n  for (int t = 0; t < n_items; ++t) {{\n"),
        ("    __syncthreads();  // item t landed; item t - 1's stage is free\n",
         f"    __syncthreads();  // item t landed; item t - 1's stage is free\n    {p[1]}\n"),
        ("                      t + 1, vec, smem_addr(mbars + (t + 1) % kStages));\n    cp_commit();\n",
         "                      t + 1, vec, smem_addr(mbars + (t + 1) % kStages));\n    cp_commit();\n"
         f"    {p[2]}\n"),
        ("      if (first) {\n        for (int r = tid; r < Mt; r += kThreads)",
         f"      {p[3]}\n      if (first) {{\n        for (int r = tid; r < Mt; r += kThreads)"),
        ("          store_row(tn, Mt, r, r < kThreads ? nx : load_row<kRouted>(a, nq, r));\n"
         "      }\n      continue;",
         "          store_row(tn, Mt, r, r < kThreads ? nx : load_row<kRouted>(a, nq, r));\n"
         f"      }}\n      {p[4]}\n      continue;"),
        ("        mult[r] = m;\n        mult_acc += m;\n      }\n      __syncthreads();\n",
         f"        mult[r] = m;\n        mult_acc += m;\n      }}\n      __syncthreads();\n      {p[5]}\n"),
        ("          prow[c] = out;\n        }\n      }\n      __syncthreads();\n",
         f"          prow[c] = out;\n        }}\n      }}\n      __syncthreads();\n      {p[6]}\n"),
        ("        store_grads(acc, a.g_out, it.row0, D, it.rows, m0, c0 + n0);\n      }\n    }\n  }\n",
         "        store_grads(acc, a.g_out, it.row0, D, it.rows, m0, c0 + n0);\n      }\n    }\n"
         f"    {p[7]}\n  }}\n"),
        ("  flush_block(dno, g, a.d_no, red, pos_acc, neg_acc, mult_acc, a.loss_parts);\n}",
         f"  flush_block(dno, g, a.d_no, red, pos_acc, neg_acc, mult_acc, a.loss_parts);\n  {p[8]}\n}}"),
    ]


def sources() -> dict:
    """Each library's name, CUDA source and extra nvcc flags; exits when a
    patch does not apply."""
    src = source("sgns.cu")
    out = {name: (patched(src, pairs), []) for name, pairs in VARIANTS.items()}
    out["phases"] = (patched(src, phase_probes()) + PHASE_READ, [])
    out["mma"] = (MMA_SOURCE, [])
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

    libs = build(srcs, OUT, lambda name: "mma_chains" if name == "mma" else "sgns_grads_kernel")
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    # mma.sync TF32 alone
    out = torch.zeros(2 * n_sm * 512, device=dev)
    iters = 4096
    for chains, threads, blocks in ((8, 512, n_sm), (8, 512, 2 * n_sm), (8, 128, n_sm),
                                    (1, 512, n_sm), (2, 128, n_sm), (1, 128, n_sm)):
        def launch():
            rc = libs["mma"].run(chains, ctypes.c_void_p(out.data_ptr()), blocks, threads, iters)
            if rc != 0:
                raise RuntimeError(f"CUDA error {rc}")

        ms = chip_smoke.time_ms(launch, reps=1)
        n_mma = blocks * (threads // 32) * iters * chains
        print(json.dumps({"mma": {"chains_a_warp": chains, "threads": threads, "blocks": blocks},
                          "ms": ms, "tflops": n_mma * 2048 / (ms * 1e-3) / 1e12,
                          "ns_an_mma_along_a_chain": ms * 1e6 / iters}), flush=True)

    # K2's inputs at the main path's shape
    rng = np.random.default_rng(1)
    n_vertices, n_walks, length, window, n_neg = 131072, 2560, 21, 5, 64
    walks = rng.integers(0, n_vertices, (n_walks, length)).astype(np.int32)
    dead = rng.integers(length // 2, length + 1, n_walks)
    walks[np.arange(length)[None, :] >= dead[:, None]] = -1
    walks = torch.from_numpy(walks).to(dev)
    mask = torch.from_numpy(rng.random(n_vertices) > 0.1).to(dev)
    b_sh = torch.from_numpy(rng.integers(1, window + 1, (n_walks, length)).astype(np.int32)).to(dev)
    neg = torch.from_numpy(rng.integers(0, n_vertices, n_neg).astype(np.int32)).to(dev)
    tables = {(d, ld): [torch.from_numpy(rng.normal(0, 0.1, (n_vertices, ld)).astype(np.float32))
                        .to(dev) for _ in range(2)]
              for d, ld in ((128, 128), (64, 64), (128, 129))}
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    def k2_call(lib, d, ld):
        """K2 of ``lib`` on the tables of width ``d`` at row stride ``ld``."""
        fn = lib.n2v_sgns_grads
        fn.argtypes = [vp, vp, i32, i32, vp, vp, vp, vp, i32, i32, i32, i32, f32, vp, vp, vp,
                       vp, vp, i32, vp]
        emb_in, emb_out = tables[(d, ld)]
        g_in = torch.empty((n_walks * length, d), device=dev)
        g_out = torch.empty_like(g_in)
        d_no = torch.zeros((n_neg, d), device=dev)
        parts = torch.zeros((n_walks, 3), device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def run():
            rc = fn(ptr(emb_in), ptr(emb_out), d, ld, ptr(walks), ptr(mask), ptr(b_sh), ptr(neg),
                    n_walks, length, window, n_neg, 5.0 / n_neg, ptr(g_in), ptr(g_out),
                    ptr(d_no), ptr(parts), None, 0, stream)
            if rc != 0:
                raise RuntimeError(f"CUDA error {rc}")
        return run

    # the variants
    for name in VARIANTS:
        row = {"variant": name}
        for d, ld in tables:
            row[f"ms_D{d}_ld{ld}"] = chip_smoke.time_ms(k2_call(libs[name], d, ld), reps=20)
        print(json.dumps(row), flush=True)

    # the phase profile
    lib = libs["phases"]
    blocks = min(n_sm, -(-n_walks // (64 // length)))  # one block an SM, at most one a group
    for d in (128, 64):
        run = k2_call(lib, d, d)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        lib.k2_phase_reset()
        reps = 20
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
        clk = (ctypes.c_ulonglong * 32)()
        lib.k2_phase_read(clk)
        for warp, off in (("warp 0", 0), ("warp 15", 16)):
            kclk = {p: clk[off + k] / blocks / reps / 1e3 for k, p in enumerate(PHASES)}
            print(json.dumps({"phases": {"D": d, "warp": warp}, "kclk_a_block_a_launch": kclk,
                              "total_kclk": sum(kclk.values()),
                              "kernel_ms": start.elapsed_time(end) / reps}), flush=True)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
