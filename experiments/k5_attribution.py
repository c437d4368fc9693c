#!/usr/bin/env python3
"""Where K5 ``blocked_walk`` spends its time, on one card: ``clock64()`` at
each phase of a walker's step, in a patched copy of its source.

    python3 experiments/k5_attribution.py                  # this tree's kernel
    python3 experiments/k5_attribution.py --tree DIR       # another checkout's
    python3 experiments/k5_attribution.py --check [--tree DIR]   # patches only

The source is ``node2vec_torch/csrc/blocked_walk.cu`` of the tree, with
``blocked_common.cuh`` written in (``_variants.source``).  Two patch sets
follow the two designs the file has had: ``warp`` (one warp a walker, the
whole walk in one launch, a block of 8 walkers) and ``groups`` (8-lane
groups, four walkers a warp, a persistent grid).  The set whose anchors
match the source is used; ``--check`` says which, and fails when none does.

A probe is ``clock64()`` read by lane 0 of a warp, adding the cycles since
its previous probe to the warp's counter of the phase that ends there, in
shared memory; at the end of the block the counters go to the device with
one atomic each.  A warp runs every phase for all of its walkers at once,
so the counts are warp-cycles: summed over the launch and divided by the
walkers, they say how long a warp spends on a walker in each phase.  A
load is waited for in the phase whose probe follows its first use, so the
phases end where a loaded value is used.  The phases:

  prologue      kernel start to the walk loop (a persistent grid: and the
                walker fetches)
  row load      the frontier's light row or heavy header and, with lists,
                the arrival edge's slq entry, until they are in shared memory
  light scan    a light row's weights scanned, degree and total
  header pick   a heavy header's block CDF read and counted against the target
  hashing       the three hash uniforms of an attempt
  mixture       the return / shared / proportional branch and the target
  light pick    a light proposal's slot, id, weight, prefix and (rev, pfx)
  block load    (group design) a heavy block's lane sums read (or the block
                read whole, filling them)
  block scan    a heavy block's weights summed, scanned and counted (group
                design: one lane's columns read and counted, the prefix)
  id+brp loads  the chosen heavy column's id, weight and (rev, pfx) pair
  membership    acceptance: the N(prev) probe (with its bids row's loads) or
                the list hit
  advance       trial cap, path write, carried state, loop overhead
  tail          after the walk (or the grid's last walker) ends: pad writes
                and the wait for the block's other warps

Settings: ``main_path_blocked``'s launch (RMAT scale 19, 131,072 walkers x
20, (p, q) = (0.25, 4)), (1, 1), (1, 4), ``sl_mixed`` on the RMAT and
``sl_exhaustive`` on the dense ER graph at P = 31 (both at (0.25, 4)).
Each setting runs the tree's own kernel unpatched (its time over 5 launches,
CUDA events) and the probed copy (its paths and counters must equal the
unpatched kernel's).  For the group design also four variants
(``VARIANTS``): "always whole" and the two occupancy variants walk the same
walks (their paths are checked against the kernel's), "no bids search" does
not, so only its time and attempt count are read.  Prints one JSON line a
setting, then the card's name and power limit; ptxas's registers and spills
of every build first.
"""

import argparse
import ctypes
import json
import os
import sys

from _variants import ROOT, build, card, patched, source

PHASES = ["prologue", "row load", "light scan", "header pick", "hashing", "mixture",
          "light pick", "block load", "block scan", "id+brp loads", "membership", "advance",
          "tail"]
WALKERS, ITERS, JUNK = 16, 17, 31  # counter slots: walkers started, warp iterations, unused
PROBE = ("if ((threadIdx.x & 31) == 0) { const long long _n = clock64(); "
         "k5_sclk[threadIdx.x >> 5][%d] += (unsigned long long)(_n - _t); _t = _n; }")
COUNT = "if ((threadIdx.x & 31) == 0) k5_sclk[threadIdx.x >> 5][%d] += 1;"
# a walker started by any of a warp's four groups (group design)
GROUP_COUNT = "if ((threadIdx.x & 7) == 0) atomicAdd(&k5_sclk[threadIdx.x >> 5][%d], 1ull);"
FLUSH = ("__syncthreads();\n  if (threadIdx.x < 32) { unsigned long long _s = 0; "
         "for (int _i = 0; _i < (int)(blockDim.x >> 5); ++_i) _s += k5_sclk[_i][threadIdx.x]; "
         "atomicAdd(&k5_phase_clk[threadIdx.x], _s); }\n")
DECLARE = ("  __shared__ unsigned long long k5_sclk[kWarps][32];\n"
           "  long long _t = clock64();\n"
           "  k5_sclk[threadIdx.x >> 5][threadIdx.x & 31] = 0;\n"
           "  __syncwarp();\n")
PHASE_READ = """
extern "C" int k5_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k5_phase_clk, sizeof(k5_phase_clk));
}
extern "C" int k5_phase_reset() {
  unsigned long long z[32] = {};
  return (int)cudaMemcpyToSymbol(k5_phase_clk, z, sizeof(z));
}
"""


def _p(k: int) -> str:
    return PROBE % PHASES.index(k) if isinstance(k, str) else PROBE % k


def warp_patches():
    """Probes for the one-warp-a-walker kernel (the earlier design)."""
    return [
        ("namespace {\n\nusing n2v::kPadId;",
         "__device__ unsigned long long k5_phase_clk[32];\nnamespace {\n\nusing n2v::kPadId;"),
        ("  __shared__ unsigned long long block_fb[kWarps], block_att[kWarps];\n",
         "  __shared__ unsigned long long block_fb[kWarps], block_att[kWarps];\n"
         f"{DECLARE}"),
        ("    const int32_t start = starts[w];\n",
         f"    {COUNT % WALKERS}\n    const int32_t start = starts[w];\n"),
        ("    for (uint32_t it = 0; it < it_bound && alive; ++it) {\n",
         f"    {_p('prologue')}\n    for (uint32_t it = 0; it < it_bound && alive; ++it) {{\n"
         f"      {_p('advance')}\n      {COUNT % ITERS}\n"),
        ("          sl_valid = aedge >= 0 && (sl_flags & 1) == 0;\n        }\n",
         "          sl_valid = aedge >= 0 && (sl_flags & 1) == 0;\n        }\n"
         f"        {_p('row load')}\n"),
        ("          n2v::header_cum(cur_row, lane, maxb, &cum0, &cum1);\n",
         f"          n2v::header_cum(cur_row, lane, maxb, &cum0, &cum1);\n          {_p('header pick')}\n"),
        ("          wtot = lc.wtot;\n        }\n",
         f"          wtot = lc.wtot;\n          {_p('light scan')}\n        }}\n"),
        ("      const float u_acc = n2v::hash_uniform(seed, gid, ctr + 2u);\n",
         f"      const float u_acc = n2v::hash_uniform(seed, gid, ctr + 2u);\n      {_p('hashing')}\n"),
        ("      }\n\n      // --- proposal: two-level exact inverse CDF",
         f"      }}\n      {_p('mixture')}\n\n      // --- proposal: two-level exact inverse CDF"),
        ("          pfx_c = __int_as_float(cur_row[3 * p_l + slot]);\n        }\n      } else {\n",
         "          pfx_c = __int_as_float(cur_row[3 * p_l + slot]);\n        }\n"
         f"        {_p('light pick')}\n      }} else {{\n"),
        ("        const float resid = __fsub_rn(target, base);\n",
         f"        const float resid = __fsub_rn(target, base);\n        {_p('header pick')}\n"),
        ("        ppfx = __fadd_rn(base, pc);\n",
         f"        ppfx = __fadd_rn(base, pc);\n        {_p('block scan')}\n"),
        ("          pfx_c = __int_as_float(pair.y);\n        }\n      }\n",
         "          pfx_c = __int_as_float(pair.y);\n        }\n"
         "        if (cand == -7 && rev_enc == -7 && w_cand == -7.f) k5_sclk[0][31] = 1;\n"
         f"        {_p('id+brp loads')}\n      }}\n"),
        ("      // --- trial cap: bounded-bias proportional-to-w fallback, counted ------\n",
         f"      {_p('membership')}\n"
         "      // --- trial cap: bounded-bias proportional-to-w fallback, counted ------\n"),
        ("    for (int s = t + 1 + lane; s <= walk_length; s += 32) out[s] = -1;\n",
         f"    {_p('advance')}\n    for (int s = t + 1 + lane; s <= walk_length; s += 32) out[s] = -1;\n"),
        ("  __syncthreads();\n  if (threadIdx.x == 0) {\n    unsigned long long fb = 0, at = 0;",
         f"  __syncthreads();\n  {_p('tail')}\n  {FLUSH}"
         "  if (threadIdx.x == 0) {\n    unsigned long long fb = 0, at = 0;"),
    ]


def groups_patches():
    """Probes for the 8-lane-group kernel: a warp's phases, its
    four walkers at once."""
    return [
        ("namespace {\n\nusing n2v::kGroup;",
         "__device__ unsigned long long k5_phase_clk[32];\nnamespace {\n\nusing n2v::kGroup;"),
        ("  unsigned long long n_fb = 0, n_att = 0, n_whole = 0;\n",
         f"  unsigned long long n_fb = 0, n_att = 0, n_whole = 0;\n{DECLARE}"),
        ("        have = true;\n", f"        have = true;\n        {GROUP_COUNT % WALKERS}\n"),
        ("  while (true) {\n", f"  while (true) {{\n    {_p('advance')}\n"),
        ("    if (!__any_sync(kFull, have)) break;  // every group of the warp is done\n",
         "    if (!__any_sync(kFull, have)) break;  // every group of the warp is done\n"
         f"    {_p('prologue')}\n    {COUNT % ITERS}\n"),
        ("    n2v::copies_wait();\n    if (__any_sync(kFull, ent)) {\n",
         f"    n2v::copies_wait();\n    {_p('row load')}\n    if (__any_sync(kFull, ent)) {{\n"),
        ("    const bool on = have && alive;\n",
         f"    {_p('light scan')}\n    const bool on = have && alive;\n"),
        ("    const float u_acc = n2v::hash_uniform(seed, gid, ctr + 2u);\n",
         f"    const float u_acc = n2v::hash_uniform(seed, gid, ctr + 2u);\n    {_p('hashing')}\n"),
        ("    // --- proposal: two-level exact inverse CDF",
         f"    {_p('mixture')}\n    // --- proposal: two-level exact inverse CDF"),
        ("    int row_slot = slot_l;  // the proposal's slot within N(cur)\n",
         "    int row_slot = slot_l;  // the proposal's slot within N(cur)\n"
         "    if (cand == -7 && rev_enc == -7 && w_cand == -7.f) k5_sclk[0][31] = 1;\n"
         f"    {_p('light pick')}\n"),
        ("      const float resid = __fsub_rn(target, base);\n",
         f"      const float resid = __fsub_rn(target, base);\n      {_p('header pick')}\n"),
        ("      const bool all_below = ls.y < resid;\n",
         f"      {_p('block load')}\n      const bool all_below = ls.y < resid;\n"),
        ("      if (hv) {\n        row_slot = blk * c + slot;\n",
         f"      {_p('block scan')}\n      if (hv) {{\n        row_slot = blk * c + slot;\n"),
        ("    }\n\n    // --- acceptance",
         "      if (cand == -7 && rev_enc == -7 && w_cand == -7.f) k5_sclk[0][31] = 1;\n"
         f"      {_p('id+brp loads')}\n    }}\n\n    // --- acceptance"),
        ("    // --- trial cap: bounded-bias proportional-to-w fallback, counted ------\n",
         f"    {_p('membership')}\n"
         "    // --- trial cap: bounded-bias proportional-to-w fallback, counted ------\n"),
        ("  // lane 0 of each group holds its counts: a warp's, then the block's\n",
         f"  {_p('tail')}\n  // lane 0 of each group holds its counts: a warp's, then the block's\n"),
        ("  __syncthreads();\n  if (threadIdx.x < 3) {",
         f"  __syncthreads();\n  {_p('tail')}\n  {FLUSH}  if (threadIdx.x < 3) {{"),
    ]


# Variants of the group design, timed beside it.  "always whole" reads every
# heavy block whole (the lane-sum table unused: the same walk, more bytes);
# "4 blocks an SM" asks ptxas for 64 registers (the same walk, spills);
# "4 warps a block, 7 an SM" for 72 (28 warps an SM where 80 registers
# allow 24);
# "no bids search" skips a heavy prev's bids row (its header's ids are
# compared as a light row's), so its walk differs and only its time and
# attempts are read.
VARIANTS = {
    "always whole": [("      const bool whole = hv && known < kGroup;\n",
                      "      const bool whole = hv;\n")],
    "4 blocks an SM": [("__launch_bounds__(kThreads, 3)", "__launch_bounds__(kThreads, 4)")],
    "4 warps a block, 7 an SM": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;"),
                                 ("__launch_bounds__(kThreads, 3)",
                                  "__launch_bounds__(kThreads, 7)")],
    "no bids search": [("        shared = n2v::prev_member(prev_row, mrow, c, cand, r, p_l, probe);\n",
                        "        shared = n2v::prev_member(prev_row, nullptr, c, cand, r, p_l, probe);\n")],
}


DESIGNS = {"warp": warp_patches, "groups": groups_patches}


def sources(csrc: str):
    """(design, {name: (CUDA source, flags)}) for ``csrc``'s blocked_walk.cu;
    exits when no patch set applies."""
    src = source("blocked_walk.cu", csrc)
    for design, pairs in DESIGNS.items():
        pairs = pairs()
        if pairs and all(src.count(old) == 1 for old, _ in pairs):
            out = {"as built": (src, []), "phases": (patched(src, pairs) + PHASE_READ, [])}
            if design == "groups":
                out.update({k: (patched(src, v), []) for k, v in VARIANTS.items()})
            return design, out
    raise SystemExit("no patch set applies to " + os.path.join(csrc, "blocked_walk.cu"))


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
    from node2vec_torch.graph import build_graph
    from node2vec_torch.walk import blocked

    out_dir = os.path.join(ROOT, "build", "k5_attribution", design)
    libs = build(srcs, out_dir, lambda name: "blocked_walk_kernel")
    vp, i32, i64, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32,
                              ctypes.c_float)
    lane_sums = design == "groups"  # its C entry takes the lane-sum table after slq
    for lib in libs.values():
        lib.n2v_blocked_walk.argtypes = [vp, i32, vp, vp, vp, vp] + [vp] * lane_sums + [
            vp, vp, vp, i64, i32, i64, u32, f32, f32, f32, i32, i32, i32, i32, i32, vp]
    dev = torch.device("cuda")

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    def runner(lib, bg, starts, p, q, trials, sl):
        """K5 of ``lib`` on ``bg`` as blocked_walk_chunk launches it."""
        n_w, length = starts.shape[0], 20
        paths = torch.empty((n_w, length + 1), dtype=torch.int32, device=dev)
        counters = torch.zeros(8, dtype=torch.int64, device=dev)
        mode = (4 if bg.sl_exhaustive else 3) if sl else (2 if q != 1 else (1 if p != 1 else 0))
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        table = torch.empty((bg.biw.shape[0], 16), device=dev)

        def run():
            counters.zero_()
            table.fill_(float("nan"))
            rc = lib.n2v_blocked_walk(
                ptr(bg.light), bg.light.shape[1], ptr(bg.biw), ptr(bg.bids), ptr(bg.brp),
                ptr(bg.slq if sl else None), *[ptr(table)] * lane_sums, ptr(starts), ptr(paths),
                ptr(counters), n_w,
                length, 0, 0, float(np.float32(1 / p)), float(np.float32(1 / q)),
                float(np.float32(max(1.0, 1 / q))), trials, bg.light_width, bg.block_width,
                int(bg.has_heavy), mode, stream)
            if rc != 0:
                raise RuntimeError(f"CUDA error {rc}")
            return paths, counters
        return run

    _, _, g_rmat = cs.rmat_graph(19)
    er_src, er_dst = cs.smoke_edges(131072, 2_097_152)
    g_er = build_graph((er_src, er_dst), directed=False)
    bg = blocked.build_blocked_graph(g_rmat.indptr, g_rmat.indices, g_rmat.weights, device=dev)
    bg_sl, _ = cs._sl_tables(g_rmat)
    bg_er, _ = cs._sl_tables(g_er)
    settings = (("main_path_blocked (0.25, 4)", bg, 0.25, 4.0, False),
                ("(1, 1)", bg, 1.0, 1.0, False), ("(1, 4)", bg, 1.0, 4.0, False),
                ("sl_mixed, RMAT (0.25, 4)", bg_sl, 0.25, 4.0, True),
                ("sl_exhaustive, ER P = 31 (0.25, 4)", bg_er, 0.25, 4.0, True))
    for name, tabs, p, q, sl in settings:
        n_v = tabs.light.shape[0]
        starts = torch.arange(131072, dtype=torch.int32, device=dev) % n_v
        plain = runner(libs["as built"], tabs, starts, p, q, 64, sl)
        ms = cs.time_ms(plain, reps=5)
        want_paths, want_counters = (x.clone() for x in plain())
        variants = {}
        for v in VARIANTS:
            if v in libs:
                run = runner(libs[v], tabs, starts, p, q, 64, sl)
                ms_v = cs.time_ms(run, reps=5)
                v_paths, v_counters = run()
                variants[v] = {"ms": ms_v, "attempts": int(v_counters[1]),
                               "same_walk": bool(torch.equal(v_paths, want_paths))}
        probed = runner(libs["phases"], tabs, starts, p, q, 64, sl)
        probed()
        torch.cuda.synchronize()
        libs["phases"].k5_phase_reset()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        got_paths, got_counters = probed()
        end.record()
        torch.cuda.synchronize()
        clk = (ctypes.c_ulonglong * 32)()
        libs["phases"].k5_phase_read(clk)
        walkers = max(clk[WALKERS], 1)
        kclk = {ph: clk[k] / walkers / 1e3 for k, ph in enumerate(PHASES)}
        total = sum(kclk.values())
        steps = int((want_paths[:, 1:] >= 0).sum())
        print(json.dumps({
            "setting": name, "design": design, "mode": ("sl" if sl else "") or
            ("2" if q != 1 else "1" if p != 1 else "0"), "ms": ms,
            "probed_ms": start.elapsed_time(end), "walk_steps": steps,
            "attempts": int(want_counters[1]), "fallbacks": int(want_counters[0]),
            "walkers_probed": int(clk[WALKERS]), "warp_iterations": int(clk[ITERS]),
            "probed_equal": bool(torch.equal(got_paths, want_paths)
                                 and torch.equal(got_counters[:2], want_counters[:2])),
            "warp_kclk_a_walker": total, "variants": variants,
            "share": {ph: round(v / total, 4) for ph, v in kclk.items()},
            "kclk_a_walker": {ph: round(v, 3) for ph, v in kclk.items()}}), flush=True)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
