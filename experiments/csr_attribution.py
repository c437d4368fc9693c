#!/usr/bin/env python3
"""Where K12 ``csr_walk`` spends its time, on one card: ``clock64()`` at each
phase of a walker's step, in a patched copy of its source.

    python3 experiments/csr_attribution.py                  # this tree's kernel
    python3 experiments/csr_attribution.py --tree DIR       # another checkout's
    python3 experiments/csr_attribution.py --check [--tree DIR]   # patches only

The source is ``node2vec_torch/csrc/csr_walk.cu`` of the tree, with its
headers written in (``_variants.source``).  Two patch sets follow the two
designs the file has had: ``thread`` (one thread a walker, a step a loop
pass, every search a bisection) and ``fewer loads`` (the same loop with a
membership search only where it can change the acceptance, a bisection's
answer read from its last probe, prev's bounds carried).
The set whose anchors match is used; ``--check`` says which, and fails when
none does.

The probes are ``_variants.probes``: lane 0 of a warp adds the cycles since
its previous probe to the phase that ends there, so a load is counted in the
phase whose probe follows its first use.  In the thread design lane 0 is one
walker of the warp's 32, whose waits for the others at a reconvergence
point count in the phase that ends after it.  The phases:

  row bounds      cur's indptr pair (fewer loads: and wtot[cur]) until the
                  degree is known
  back search     prev's lower bound in cur's row and its weight (thread: and
                  prev's indptr pair issued)
  proposals       a round's draws, prob, alias and the proposed id
  membership      the proposal's search in prev's row (thread: waits on
                  prev's indptr pair too)
  store, advance  the path entry, carried state, loop overhead
  tail            after the walk: the -1 pad

Settings: ``main_path_csr``'s launch (the scale-19 RMAT, 131,072 walkers of
20 at (p, q) = (0.25, 4), search_iters from its max degree) and (1, 1).  For
each: the unpatched kernel's time (CUDA events, 5 launches), the probed
copy's phases (its paths must equal the unpatched kernel's), and, timed
only (their walks differ): "no back search" (no back edge found) and "no
membership search" (no proposal in prev's row); for the second design also
"every membership search" (a search for every non-return proposal, as the
first design makes) and "32 registers" (no 8 blocks an SM asked of the
compiler, which then holds the kernel to 32 registers): the same walks.  Then the unpatched kernel
at 131,072, 65,536, 32,768, 16,384 and 8,192 walkers: a launch whose time
falls with its walkers is limited by throughput, one whose time holds is
limited by its walkers' chains.  Prints one JSON line a measurement, then
the card's name and power limit; ptxas's registers and spills of every
build first.  Neither the port nor the smoke imports this file.
"""

import argparse
import ctypes
import json
import os
import sys

from _variants import (ROOT, PROBE_START, build, card, patched, phase_read, probe_counters,
                       probe_flush, probes, profile, source)

PHASES = ["row bounds", "back search", "proposals", "membership", "store, advance", "tail"]
PREFIX = "k12"


def thread_patches() -> list:
    p = probes(len(PHASES))
    return [
        ("  if (w >= n_walkers) return;\n",
         "  if (w >= n_walkers) return;\n  " + PROBE_START),
        ("      if (degree <= 0) break;  // the walk ends here: -1 from step t + 1\n",
         f"      if (degree <= 0) break;  // the walk ends here: -1 from step t + 1\n"
         f"      {p[0]}\n"),
        ("        p_deg = __ldg(indptr + prev + 1) - p_seg;\n      }\n",
         f"        p_deg = __ldg(indptr + prev + 1) - p_seg;\n        {p[1]}\n      }}\n"),
        ("              } else {\n                const int64_t q = lower_bound(",
         f"              }} else {{\n                {p[2]}\n"
         "                const int64_t q = lower_bound("),
        ("__ldg(indices + q) == proposal;\n",
         f"__ldg(indices + q) == proposal;\n                {p[3]}\n"),
        ("            nxt = proposal;  // the round's last proposal unless one is accepted first\n",
         f"            {p[2]}\n"
         "            nxt = proposal;  // the round's last proposal unless one is accepted first\n"),
        ("      cur = nxt;\n    }\n", f"      cur = nxt;\n      {p[4]}\n    }}\n"),
        ("  for (int s = t + 1; s <= walk_length; ++s) out[s] = -1;\n}\n",
         f"  for (int s = t + 1; s <= walk_length; ++s) out[s] = -1;\n  {p[5]}\n"
         f"{probe_flush(PREFIX, len(PHASES))}}}\n"),
    ]


THREAD_VARIANTS = {
    "no back search": [("const int64_t pos = lower_bound(indices, seg, degree, prev, search_iters);",
                        "const int64_t pos = seg;")],
    "no membership search": [("const int64_t q = lower_bound(indices, p_seg, p_deg, proposal, "
                              "search_iters);", "const int64_t q = p_seg;")],
}


def loads_patches() -> list:
    p = probes(len(PHASES))
    return [
        ("  if (w >= n_walkers) return;\n",
         "  if (w >= n_walkers) return;\n  " + PROBE_START),
        ("      if (degree <= 0) break;  // the walk ends here: -1 from step t + 1\n",
         f"      if (degree <= 0) break;  // the walk ends here: -1 from step t + 1\n"
         f"      {p[0]}\n"),
        ("        only_back = f.member && degree == 1;\n      }\n",
         f"        only_back = f.member && degree == 1;\n        {p[1]}\n      }}\n"),
        ("                const float u = __fmul_rn(",
         f"                {p[2]}\n                const float u = __fmul_rn("),
        ("                accept = shared ? in_1 : in_q;\n",
         f"                {p[3]}\n                accept = shared ? in_1 : in_q;\n"),
        ("            nxt = proposal;  // the round's last proposal unless one is accepted first\n",
         f"            {p[2]}\n"
         "            nxt = proposal;  // the round's last proposal unless one is accepted first\n"),
        ("      cur = nxt;\n    }\n", f"      cur = nxt;\n      {p[4]}\n    }}\n"),
        ("  for (int s = t + 1; s <= walk_length; ++s) out[s] = -1;\n}\n",
         f"  for (int s = t + 1; s <= walk_length; ++s) out[s] = -1;\n  {p[5]}\n"
         f"{probe_flush(PREFIX, len(PHASES))}}}\n"),
    ]


SAME_WALK = ("every membership search", "32 registers")  # walks equal to the kernel's
LOADS_VARIANTS = {
    "every membership search": [("                    in_q != in_1 &&\n", "")],
    "32 registers": [("__global__ void __launch_bounds__(kThreads, 8)\ncsr_walk_kernel(",
                      "__global__ void __launch_bounds__(kThreads)\ncsr_walk_kernel(")],
    "no back search": [("        const Found f = lower_bound(indices, seg, degree, prev, "
                        "search_iters);\n", "        const Found f{seg, false};\n")],
    "no membership search": [("                    lower_bound(indices, p_seg, p_deg, proposal, "
                              "search_iters).member;\n", "                    false;\n")],
}


def sources(csrc: str):
    """(design, {library: (source, nvcc flags)}): the kernel as built, its
    probed copy and its variants."""
    src = source("csr_walk.cu", csrc)
    for design, patches, variants in (("thread", thread_patches, THREAD_VARIANTS),
                                      ("fewer loads", loads_patches, LOADS_VARIANTS)):
        if all(src.count(old) == 1 for old, _ in patches()):
            break
    else:
        raise SystemExit("no patch set applies to csr_walk.cu")
    out = {"as built": (src, []),
           "probed": (probe_counters(PREFIX) + patched(src, patches()) + phase_read(PREFIX), [])}
    for name, pairs in variants.items():
        if all(src.count(old) == 1 for old, _ in pairs):
            out[name] = (patched(src, pairs), [])
    return design, out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    design, srcs = sources(os.path.join(tree, "node2vec_torch", "csrc"))
    if args.check:
        print(json.dumps({"tree": tree, "design": design, "libraries": list(srcs),
                          "patches_apply": True}))
        return 0
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from node2vec_torch.walk import csr

    libs = build(srcs, os.path.join(ROOT, "build", "csr_attribution", design.replace(" ", "_")),
                 lambda name: "csr_walk")
    vp, i32, i64, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32,
                              ctypes.c_float)
    for lib in libs.values():
        lib.n2v_csr_walk.argtypes = [vp] * 6 + [i64, vp, vp, i64, i32, i64, u32, f32, f32, f32,
                                                i32, i32, i32, i32, vp]
        lib.n2v_csr_walk.restype = ctypes.c_int
    dev = torch.device("cuda")
    _, _, g = cs.rmat_graph(19)
    dg = g.to_device(dev)
    iters = csr.search_iters(int(np.diff(g.indptr).max()))

    def runner(lib, starts, p, q, length=20):
        paths = torch.empty((starts.shape[0], length + 1), dtype=torch.int32, device=dev)
        kb, n_rounds = csr.proposal_rounds(p, q, 64)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def run():
            rc = lib.n2v_csr_walk(
                *[ctypes.c_void_p(t.data_ptr()) for t in dg], dg.indices.shape[0],
                ctypes.c_void_p(starts.data_ptr()), ctypes.c_void_p(paths.data_ptr()),
                starts.shape[0], length, 0, 0, float(np.float32(1 / p)),
                float(np.float32(1 / q)), float(np.float32(max(1.0, 1 / q))), kb, n_rounds,
                iters, int(p == 1.0 and q == 1.0), stream)
            if rc != 0:
                raise RuntimeError(f"CUDA error {rc}")
            return paths
        return run

    for p, q in ((0.25, 4.0), (1.0, 1.0)):
        starts = torch.arange(131072, dtype=torch.int32, device=dev) % g.n_vertices
        base = runner(libs["as built"], starts, p, q)
        want = base().clone()
        line = {"kernel": "csr_walk", "design": design, "p": p, "q": q, "walkers": 131072,
                "search_iters": iters, "ms": cs.time_ms(base, reps=5)}
        probed = runner(libs["probed"], starts, p, q)
        line["probed_same_walk"] = bool(torch.equal(probed(), want))
        line["probes"] = profile(libs["probed"], PREFIX, probed, PHASES, reps=5)
        line["variants"] = {}
        for name in libs:
            if name in ("as built", "probed"):
                continue
            run = runner(libs[name], starts, p, q)
            line["variants"][name] = {"ms": cs.time_ms(run, reps=5)}
            if name in SAME_WALK:
                line["variants"][name]["same_walk"] = bool(torch.equal(run(), want))
        print(json.dumps(line), flush=True)
    sweep = {}
    for n in (131072, 65536, 32768, 16384, 8192):
        starts = (torch.arange(131072, dtype=torch.int32, device=dev) % g.n_vertices)[
            ::131072 // n].contiguous()
        ms = cs.time_ms(runner(libs["as built"], starts, 0.25, 4.0), reps=5)
        sweep[n] = {"ms": ms, "walker_steps_per_us": n * 20 / (ms * 1e3)}
    print(json.dumps({"kernel": "csr_walk", "design": design, "walkers_sweep": sweep}),
          flush=True)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
