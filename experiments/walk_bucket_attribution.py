#!/usr/bin/env python3
"""Where K1 ``dense_walk`` and K24 ``epd_bucket`` spend their time, on one
card: ``clock64()`` at each phase, in patched copies of their sources, K1's
time at two walker counts and K24's time at every superstep of a chunk.

    python3 experiments/walk_bucket_attribution.py [--tree DIR] [--only k1|k24]
    python3 experiments/walk_bucket_attribution.py --check [--tree DIR]

TREE is the root of a checkout (this repository's by default; a parent's
unpacked ``git archive`` for a before/after).  Each source is patched
(``_variants.py``), built, and called through the tree's wrappers with the
probed library swapped in for the port's.  The patch sets follow the designs
the files have had; the set whose anchors match is used, and ``--check`` says
which (it fails when none does):

* K1, ``scan`` (a warp a walker, a lane's columns in arrays of 8, each column
  tested against N(prev) by the whole scan of the warp's shared copy) and
  ``bisect`` (a lane's columns in arrays of the next power of two >= ceil(P /
  32), one launch form each; N(prev)'s order found from the lanes' registers
  when its row is loaded and carried as a warp-uniform flag; membership by a
  lockstep bisection of a sorted N(prev) (without bounds checks at a power
  of two P), the whole scan of an unsorted one; a counter of the scanned
  steps).  The phases of
  a walker's step: row landed, membership and bias, total, scan and pick,
  path store; divided by the steps a walker took.  Variants (timed only):
  other block sizes and blocks an SM.
* K24, ``two launches`` (a count launch that also fills the whole send
  buffer with -1, then a scatter launch: the earlier tiles' counts summed by
  one thread, the ranks, the three scalars, the rows copied a lane at a time
  with 4-byte accesses) and ``grid`` (one cooperative launch on
  ``bucket_common.cuh``'s grid ranking: the block's tiles counted, a grid
  barrier, the bases summed block-parallel, each lane ranked, a warp's
  sending lanes' rows staged in shared memory by 16-byte cp.async, a batch
  loading while the one before it is stored as whole requests (by 16-byte
  stores where the batch's lanes fill consecutive slots), the first batch
  issued before the barrier where every active lane sends, -1 only into
  the unfilled slots).  Their
  phases, and variants with a part taken out (timed only: their buffers
  differ).

Inputs: K1 on ``check_dense_walk``'s graph (the dense ER graph's packed
adjacency, P = 64), 131,072 starts (vertex i mod V) of 20 steps at
(p, q) = (0.25, 4) and (1, 1), and the first 8,192 of them, timed (CUDA
events) and held bit-equal to ``dense_walk_chunk_plain``; ptxas's registers
and spills, the walkers an SM holds (the runtime's occupancy of the built
kernel).  K24 at ``check_ep_dense``'s chunk (the same graph as the 1 x 1
mesh's shard, 131,072 walkers of 20 at (0.25, 4), the default draws of seed
0): every superstep's carried state at full capacity (20 supersteps) and at
1/8 of it (84, walkers deferred and left unfinished), each call timed and
held bit-equal (whole buffers) to ``epd_bucket_plain``; the phases at the
second superstep, the last one at full capacity, and a late one at 1/8.
Prints one JSON line a measurement, ptxas's registers and spills of each
build first, then the card's name and power limit.  Neither the port nor
the smoke imports this file.
"""

import argparse
import contextlib
import ctypes
import json
import os
import sys

from _variants import (REPORTS, ROOT, PROBE_START, build, card, patched, phase_read,
                       probe_counters, probe_flush, probes, profile, source)

WALKERS, WALK_LENGTH = 131072, 20
K1_SMALL = 8192
EP_PQ = (0.25, 4.0)

# a register's value used, so that a probe after it waits for its load
_WAIT = ("{{ float _w = 0.f; for (int m = 0; m < {n}; ++m) _w += {bw}[m] + (float){ids}[m];\n"
         "    int _r; asm volatile(\"mov.b32 %0, %1;\" : \"=r\"(_r) : \"f\"(_w)); }}")


def _wait(n: str, bw: str = "bw", ids: str = "ids") -> str:
    return _WAIT.format(n=n, bw=bw, ids=ids)


# ---- K1 ----------------------------------------------------------------------

K1_PHASES = ["row landed", "membership and bias", "total, scan and pick", "path store"]
_K1_SCAN_TOTAL = (
    "    float lane_sum;\n"
    "    const float total = n2v::dense_bias_total(ids, bw, prev_rows, prev, p_cols, k, col0, inv_p,\n"
    "                                              inv_q, uniform_bias, lane_sum);\n")


def k1_scan_patches() -> list:
    """The phases of the scan design (``dense_load_row``,
    ``dense_bias_total`` written out so that a probe sits between the
    membership and the total, ``dense_pick``)."""
    p = probes(len(K1_PHASES))
    return [
        ("  const uint32_t gid = static_cast<uint32_t>(gid_base + w);\n",
         "  const uint32_t gid = static_cast<uint32_t>(gid_base + w);\n  " + PROBE_START),
        ("                        bw, rows);\n    __syncwarp();\n",
         "                        bw, rows);\n    __syncwarp();\n    " + _wait("kMaxK")
         + f"\n    {p[0]}\n"),
        (_K1_SCAN_TOTAL,
         "    if (!uniform_bias && prev >= 0) {\n"
         "#pragma unroll\n"
         "      for (int m = 0; m < kMaxK; ++m) {\n"
         "        if (m < k && col0 + m < p_cols) {\n"
         "          float bias;\n"
         "          if (ids[m] == prev) {\n"
         "            bias = inv_p;\n"
         "          } else {\n"
         "            bool shared = false;\n"
         "            for (int j = 0; j < p_cols; ++j) shared |= prev_rows[j] == ids[m];\n"
         "            bias = shared ? 1.f : inv_q;\n"
         "          }\n"
         "          bw[m] = __fmul_rn(bw[m], bias);\n"
         "        }\n"
         "      }\n"
         "    }\n"
         "    " + _wait("kMaxK") + f"\n    {p[1]}\n"
         "    float lane_sum = 0.f;\n"
         "#pragma unroll\n"
         "    for (int m = 0; m < kMaxK; ++m) lane_sum = __fadd_rn(lane_sum, bw[m]);\n"
         "    float total = lane_sum;\n"
         "#pragma unroll\n"
         "    for (int off = 16; off > 0; off >>= 1)\n"
         "      total = __fadd_rn(total, __shfl_xor_sync(n2v::kDenseFull, total, off));\n"),
        ("    const int32_t nxt = rows[idx];\n",
         f"    {p[2]}\n    const int32_t nxt = rows[idx];\n"),
        ("    rows = tmp;\n  }\n", f"    rows = tmp;\n    {p[3]}\n  }}\n"),
        ("    for (int s = t_dead + 1 + lane; s <= walk_length; s += 32) out[s] = -1;\n  }\n}\n",
         "    for (int s = t_dead + 1 + lane; s <= walk_length; s += 32) out[s] = -1;\n  }\n"
         + probe_flush("k1", len(K1_PHASES)) + "}\n"),
    ]


def k1_bisect_patches() -> list:
    """The phases of the kK-templated design: the same four, the
    membership's sorted and scanned branches together."""
    p = probes(len(K1_PHASES))
    return [
        ("  const uint32_t gid = static_cast<uint32_t>(gid_base + w);\n",
         "  const uint32_t gid = static_cast<uint32_t>(gid_base + w);\n  " + PROBE_START),
        ("    const bool row_sorted = uniform_bias || n2v::dense_row_sorted(ids, p_cols, k, col0);\n",
         "    const bool row_sorted = uniform_bias || n2v::dense_row_sorted(ids, p_cols, k, col0);\n"
         "    " + _wait("kK") + f"\n    {p[0]}\n"),
        ("    float lane_sum;\n    const float total = n2v::dense_total(bw, lane_sum);\n",
         "    " + _wait("kK") + f"\n    {p[1]}\n"
         "    float lane_sum;\n    const float total = n2v::dense_total(bw, lane_sum);\n"),
        ("    const int32_t nxt = rows[idx];\n",
         f"    {p[2]}\n    const int32_t nxt = rows[idx];\n"),
        ("    rows = tmp;\n  }\n", f"    rows = tmp;\n    {p[3]}\n  }}\n"),
        ("  if (scans != nullptr && lane == 0 && n_scans) atomicAdd(scans, n_scans);\n}\n",
         "  if (scans != nullptr && lane == 0 && n_scans) atomicAdd(scans, n_scans);\n"
         + probe_flush("k1", len(K1_PHASES)) + "}\n"),
    ]


# the runtime's blocks an SM of the built kernel, at the shared memory a
# block takes at P columns
_K1_OCC_SCAN = """
extern "C" int k1_occupancy(int p_cols, int* out) {
  out[1] = kWarps;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, dense_walk_kernel, kWarps * 32, sizeof(int32_t) * kWarps * 2 * p_cols);
}
"""
_K1_OCC_BISECT = """
extern "C" int k1_occupancy(int p_cols, int* out) {
  out[1] = kWarps;
  const size_t smem = sizeof(int32_t) * kWarps * 2 * p_cols;
  const int k = (p_cols + 31) >> 5;
  const void* f = k <= 1 ? (const void*)dense_walk_kernel<1>
                : k <= 2 ? (const void*)dense_walk_kernel<2>
                : k <= 4 ? (const void*)dense_walk_kernel<4> : (const void*)dense_walk_kernel<8>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, f, kWarps * 32, smem);
}
"""

K1_BISECT_VARIANTS = {
    "4 warps a block": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "16 warps a block": [("constexpr int kWarps = 8;", "constexpr int kWarps = 16;")],
    "bounds-checked bisection at P = 64": [
        ("  const bool pow2 = top == p_cols;", "  const bool pow2 = false;")],
    "8 blocks an SM (<= 32 registers)": [
        ("template <int kK>\n__global__ void __launch_bounds__(kWarps * 32)\n",
         "template <int kK>\n__global__ void __launch_bounds__(kWarps * 32, 8)\n")],
}

K1_DESIGNS = (("scan", k1_scan_patches, _K1_OCC_SCAN, {}),
              ("bisect", k1_bisect_patches, _K1_OCC_BISECT, K1_BISECT_VARIANTS))

# ---- K24 ---------------------------------------------------------------------

K24_COUNT = ["tile counted", "send buffer filled with -1"]
K24_SCATTER = ["earlier tiles' counts (one thread's loop)", "ranks", "three scalars",
               "carried rows copied"]


def k24_two_patches() -> list:
    pc = probes(len(K24_COUNT))
    ps = probes(len(K24_SCATTER))
    return [
        ("  extern __shared__ int32_t cnt[];  // n2v::bucket_count_smem(n_shards) bytes\n",
         "  extern __shared__ int32_t cnt[];\n  " + PROBE_START),
        ("      n_shards, cnt, tiles);\n", f"      n_shards, cnt, tiles);\n  {pc[0]}\n"),
        ("  for (int64_t j = i; j < total; j += static_cast<int64_t>(gridDim.x) * kTile) send[j] = -1;\n}\n",
         "  for (int64_t j = i; j < total; j += static_cast<int64_t>(gridDim.x) * kTile) send[j] = -1;\n"
         f"  {pc[1]}\n" + probe_flush("k24c", len(K24_COUNT)) + "}\n"),
        ("  extern __shared__ int32_t sm[];  // n2v::bucket_rank_smem(n_shards) bytes\n",
         "  extern __shared__ int32_t sm[];\n  " + PROBE_START),
        ("                                                    int32_t* sm) {\n",
         "                                                    int32_t* sm, long long* _pr,\n"
         "                                                    long long& _t) {\n"),
        ("  for (int j = threadIdx.x; j < kBucketTileWarps * n_shards; j += kBucketTile) wcnt[j] = 0;\n"
         "  __syncthreads();\n",
         "  for (int j = threadIdx.x; j < kBucketTileWarps * n_shards; j += kBucketTile) wcnt[j] = 0;\n"
         f"  __syncthreads();\n  {ps[0]}\n"),
        ("    if (off < capacity) flat = dest * capacity + off;\n  }\n  return flat;\n",
         f"    if (off < capacity) flat = dest * capacity + off;\n  }}\n  {ps[1]}\n  return flat;\n"),
        ("      n_shards, capacity, tiles, sm);\n", "      n_shards, capacity, tiles, sm, _pr, _t);\n"),
        ("      out[2] = __float_as_int(u[i]);\n    }\n  }\n",
         f"      out[2] = __float_as_int(u[i]);\n    }}\n  }}\n  {ps[2]}\n"),
        ("    for (int c = lane; c < p_cols; c += 32) dst[c] = src[c];\n  }\n}\n",
         f"    for (int c = lane; c < p_cols; c += 32) dst[c] = src[c];\n  }}\n  {ps[3]}\n"
         + probe_flush("k24s", len(K24_SCATTER)) + "}\n"),
    ]


K24_TWO_VARIANTS = {
    "no fill": [("  for (int64_t j = i; j < total; j += static_cast<int64_t>(gridDim.x) * kTile) "
                 "send[j] = -1;\n", "")],
    "no row copies": [("    int32_t* dst = send + f * fields + 3;\n"
                       "    for (int c = lane; c < p_cols; c += 32) dst[c] = src[c];\n",
                       "    int32_t* dst = send + f * fields + 3;\n")],
}

K24_GRID = ["block's tiles counted", "grid barrier", "bases summed", "slots written",
            "a batch's rows waited for", "requests stored", "later tiles", "unfilled slots filled"]


def k24_grid_patches() -> list:
    p = probes(len(K24_GRID))
    return [
        ("  const int64_t n_req = S * a.capacity;\n  const int64_t t0",
         "  const int64_t n_req = S * a.capacity;\n  " + PROBE_START + "  const int64_t t0"),
        ("    a.blk[static_cast<int64_t>(blockIdx.x) * S + d] = run[d];\n  cg::this_grid().sync();\n",
         f"    a.blk[static_cast<int64_t>(blockIdx.x) * S + d] = run[d];\n  {p[0]}\n"
         f"  cg::this_grid().sync();\n  {p[1]}\n"),
        ("  n2v::grid_bases<kTile>(a.blk, S, gridDim.x, blockIdx.x, S, pre, tot);\n",
         f"  n2v::grid_bases<kTile>(a.blk, S, gridDim.x, blockIdx.x, S, pre, tot);\n  {p[2]}\n"),
        ("    const int64_t i0 = i - lane;\n", f"    const int64_t i0 = i - lane;\n    {p[3]}\n"),
        ("      __syncwarp();\n      const int j0 = b * H;\n",
         f"      __syncwarp();\n      {p[4]}\n      const int j0 = b * H;\n"),
        ("      __syncwarp();  // every lane is done with the half before it is staged again\n",
         f"      {p[5]}\n"
         "      __syncwarp();  // every lane is done with the half before it is staged again\n"),
        ("  emit(i, flat0, l, prefetch);\n", f"  emit(i, flat0, l, prefetch);\n  {p[6]}\n"),
        ("  n2v::grid_fill<kTile>(a.send, a.fields, S, a.capacity, tot, ends, -1);\n}\n",
         f"  {p[6]}\n  n2v::grid_fill<kTile>(a.send, a.fields, S, a.capacity, tot, ends, -1);\n"
         f"  {p[7]}\n" + probe_flush("k24g", len(K24_GRID)) + "}\n"),
    ]


K24_GRID_VARIANTS = {
    "no fill": [("  n2v::grid_fill<kTile>(a.send, a.fields, S, a.capacity, tot, ends, -1);\n", "")],
    "no row copies": [("    stage_rows<kVec>(half, rs,", "    if (false) stage_rows<kVec>(half, rs,")],
    "no prefetch across the barrier": [("  const bool prefetch = a.capacity >= a.n;",
                                        "  const bool prefetch = false;")],
    "prefetch at any capacity": [("  const bool prefetch = a.capacity >= a.n;",
                                  "  const bool prefetch = true;")],
    "no 16-byte stores": [("  if (kVec && all_on && !__any_sync(n2v::kDenseFull, mine)) {",
                           "  if (false) {")],
    "stage 544 ints a warp": [("constexpr int kStageInts = 1088;",
                               "constexpr int kStageInts = 544;")],
    "5 blocks an SM (<= 51 registers)": [
        ("__global__ void __launch_bounds__(kTile) epd_bucket_kernel(",
         "__global__ void __launch_bounds__(kTile, 5) epd_bucket_kernel(")],
}

K24_DESIGNS = (("two launches", k24_two_patches, [("k24c", K24_COUNT), ("k24s", K24_SCATTER)],
                K24_TWO_VARIANTS),
               ("grid", k24_grid_patches, [("k24g", K24_GRID)], K24_GRID_VARIANTS))


def _pick(src: str, designs):
    for design in designs:
        if all(src.count(old) == 1 for old, _ in design[1]()):
            return design
    return None


def sources(csrc: str):
    """({library: (source, nvcc flags)}, {kernel: (design, ...)})."""
    srcs, designs = {}, {}
    k1_src = source("dense_walk.cu", csrc)
    got = _pick(k1_src, K1_DESIGNS)
    if got is None:
        raise SystemExit(f"no K1 patch set applies to {csrc}/dense_walk.cu")
    design, patches, occupancy, variants = got
    srcs["k1"] = (k1_src + occupancy, [])
    srcs["k1 probed"] = (probe_counters("k1") + patched(k1_src, patches())
                         + phase_read("k1"), [])
    for name, pairs in variants.items():
        srcs["k1: " + name] = (patched(k1_src, pairs), [])
    designs["k1"] = (design, [("k1", K1_PHASES)])
    k24_src = source("epd_walk.cu", csrc)
    got = _pick(k24_src, K24_DESIGNS)
    if got is None:
        raise SystemExit(f"no K24 patch set applies to {csrc}/epd_walk.cu")
    design, patches, prefixes, variants = got
    srcs["k24"] = (k24_src, [])
    srcs["k24 probed"] = ("".join(probe_counters(p) for p, _ in prefixes)
                          + patched(k24_src, patches())
                          + "".join(phase_read(p) for p, _ in prefixes), [])
    for name, pairs in variants.items():
        srcs["k24: " + name] = (patched(k24_src, pairs), [])
    designs["k24"] = (design, prefixes)
    return srcs, designs


@contextlib.contextmanager
def swapped(lib, names=("n2v_dense_walk", "n2v_epd_bucket", "n2v_error_string")):
    """The tree's wrappers call ``lib`` (each C entry's argtypes copied from
    the port's library) while the block runs."""
    from node2vec_torch import _build

    port = _build.lib()
    for name in names:
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def dense_inputs():
    """The ER graph's packed adjacency on the card and 131,072 starts."""
    import torch

    import chip_smoke as cs
    from node2vec_torch.graph import build_graph
    from node2vec_torch.walk import dense

    src, dst = cs.smoke_edges(131072, 2_097_152)
    g = build_graph((src, dst), directed=False)
    packed = torch.from_numpy(dense.build_padded_adjacency(g.indptr, g.indices, g.weights)).cuda()
    starts = torch.arange(WALKERS, dtype=torch.int32, device="cuda") % g.n_vertices
    return g, packed, starts


def bucket_calls(g, packed, cap: int):
    """Every K24 call of ``check_ep_dense``'s chunk at capacity ``cap``,
    walked through the tree's kernels: [(carry, prev_rows, u)], keywords."""
    import torch

    from node2vec_torch.parallel import edge_partitioned as epd
    from node2vec_torch.walk import dense

    dev = torch.device("cuda")
    padded, rps = epd.partition_packed_adjacency(packed.cpu().numpy(), 1)
    local = torch.from_numpy(padded).to(dev)
    p_cols = local.shape[1] // 2
    starts = torch.arange(WALKERS, dtype=torch.int32, device=dev) % g.n_vertices
    draws = epd.default_draws(0, 0, WALKERS, dev)
    calls = []

    class Capture(epd._Kernels):
        @staticmethod
        def bucket(carry, prev_rows, u, **kw):
            calls.append((carry.clone(), prev_rows.clone(), u.clone()))
            return epd.epd_bucket(carry, prev_rows, u, **kw)

    carry = epd.init_carry(starts)
    prev_rows = torch.full((WALKERS, p_cols), int(dense.PAD_ID), dtype=torch.int32, device=dev)
    paths = torch.full((WALKERS, WALK_LENGTH + 1), -1, dtype=torch.int32, device=dev)
    paths[:, 0] = starts
    for t in range(epd.max_supersteps(WALK_LENGTH)):
        pending = epd.superstep(Capture, None, "data", local, carry, prev_rows, paths, draws(t),
                                capacity=cap, n_shards=1, rows_per_shard=rps, my_shard=0,
                                walk_length=WALK_LENGTH, return_param=EP_PQ[0],
                                inout_param=EP_PQ[1])
        if int(pending) == 0:
            break
    del local
    kw = dict(n_shards=1, capacity=cap, rows_per_shard=rps, walk_length=WALK_LENGTH)
    return calls, kw


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--only", choices=("k1", "k24"), default=None,
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
    libs = build(srcs, os.path.join(ROOT, "build", "walk_bucket_attribution"),
                 lambda name: "dense_walk" if name.startswith("k1") else "epd_bucket")
    if args.only != "k24":
        measure_k1(libs, designs)
    if args.only != "k1":
        measure_k24(libs, designs)
    print(card())
    return 0


def measure_k1(libs, designs) -> None:
    import torch

    import chip_smoke as cs
    from node2vec_torch.walk import dense

    g, packed, starts = dense_inputs()
    p_cols = packed.shape[1] // 2
    design, prefixes = designs["k1"]
    occ = (ctypes.c_int * 2)()
    libs["k1"].k1_occupancy.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    libs["k1"].k1_occupancy(p_cols, occ)
    geometry = {"blocks_an_sm": occ[0], "warps_a_block": occ[1],
                "walkers_an_sm": occ[0] * occ[1],
                "waves_at_131072": WALKERS / max(occ[0] * occ[1] * 132, 1)}
    for p, q in ((0.25, 4.0), (1.0, 1.0)):
        kw = dict(walk_length=WALK_LENGTH, return_param=p, inout_param=q)
        want = dense.dense_walk_chunk_plain(packed, starts, 0, 0, **kw)
        line = {"kernel": "dense_walk", "design": design, "p": p, "q": q, "P": p_cols,
                "ptxas": cs.ptxas_summary(REPORTS["k1"], "dense_walk"), "geometry": geometry}
        steps = int((want[:, 1:] >= 0).sum())
        with swapped(libs["k1"]):
            line["bit_equal"] = bool(torch.equal(dense.dense_walk_chunk(packed, starts, 0, 0,
                                                                        **kw), want))
            line["ms"] = cs.time_ms(lambda: dense.dense_walk_chunk(packed, starts, 0, 0, **kw),
                                    reps=10)
            small = starts[:K1_SMALL].contiguous()
            line["ms_at_8192_walkers"] = cs.time_ms(
                lambda: dense.dense_walk_chunk(packed, small, 0, 0, **kw), reps=20)
        line["ns_a_step"] = line["ms"] * 1e6 / steps
        line["ns_a_step_at_8192"] = line["ms_at_8192_walkers"] * 1e6 / int(
            (want[:K1_SMALL, 1:] >= 0).sum())
        for name in [k for k in libs if k.startswith("k1: ")]:
            with swapped(libs[name]):
                line.setdefault("variants", {})[name[4:]] = {
                    "ms": cs.time_ms(lambda: dense.dense_walk_chunk(packed, starts, 0, 0, **kw),
                                     reps=10),
                    "bit_equal": bool(torch.equal(dense.dense_walk_chunk(packed, starts, 0, 0,
                                                                         **kw), want))}
        with swapped(libs["k1 probed"]):
            line["probed_bit_equal"] = bool(torch.equal(
                dense.dense_walk_chunk(packed, starts, 0, 0, **kw), want))
            for prefix, phases in prefixes:
                prof = profile(libs["k1 probed"], prefix,
                               lambda: dense.dense_walk_chunk(packed, starts, 0, 0, **kw),
                               phases, reps=5)
                a_step = steps / WALKERS
                prof["kclk_a_step"] = {k: v / a_step
                                       for k, v in prof["kclk_a_warp_a_launch"].items()}
                line[prefix] = prof
        emit(line)
    del packed, starts


def measure_k24(libs, designs) -> None:
    import torch

    import chip_smoke as cs
    from node2vec_torch.parallel import edge_partitioned as epd

    g, packed, _ = dense_inputs()
    design, prefixes = designs["k24"]
    for cap in (WALKERS, WALKERS // 8):
        calls, kw = bucket_calls(g, packed, cap)
        per_step, equal = [], True
        for carry, prev_rows, u in calls:
            want = epd.epd_bucket_plain(carry, prev_rows, u, **kw)
            with swapped(libs["k24"]):
                got = epd.epd_bucket(carry, prev_rows, u, **kw)
                equal &= all(bool(torch.equal(a, b)) for a, b in zip(got, want))
                per_step.append(cs.time_ms(lambda: epd.epd_bucket(carry, prev_rows, u, **kw),
                                           reps=20))
        emit({"kernel": "epd_bucket", "design": design, "capacity": cap,
              "supersteps": len(calls), "ms_per_superstep": per_step,
              "ms_summed_over_the_chunk": sum(per_step),
              "bit_equal_to_plain_every_superstep": equal,
              "ptxas": cs.ptxas_summary(REPORTS["k24"], "epd_bucket")})
        picks = (1, len(calls) - 1) if cap == WALKERS else (len(calls) * 3 // 4,)
        for i in picks:
            carry, prev_rows, u = calls[i]
            want = epd.epd_bucket_plain(carry, prev_rows, u, **kw)
            active = (carry[epd.ALIVE] != 0) & (carry[epd.CURSOR] < WALK_LENGTH)
            line = {"kernel": "epd_bucket", "design": design, "capacity": cap, "superstep": i,
                    "active": int(active.sum()), "sent": int((want[1] < cap).sum())}
            with swapped(libs["k24"]):
                line["ms"] = cs.time_ms(lambda: epd.epd_bucket(carry, prev_rows, u, **kw),
                                        reps=20)
            for name in [k for k in libs if k.startswith("k24: ")]:
                with swapped(libs[name]):
                    got = epd.epd_bucket(carry, prev_rows, u, **kw)
                    line.setdefault("variants", {})[name[5:]] = {
                        "ms": cs.time_ms(lambda: epd.epd_bucket(carry, prev_rows, u, **kw),
                                         reps=20),
                        "bit_equal": all(bool(torch.equal(a, b)) for a, b in zip(got, want))}
            with swapped(libs["k24 probed"]):
                got = epd.epd_bucket(carry, prev_rows, u, **kw)
                line["probed_bit_equal"] = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
                for prefix, phases in prefixes:
                    line[prefix] = profile(libs["k24 probed"], prefix,
                                           lambda: epd.epd_bucket(carry, prev_rows, u, **kw),
                                           phases, reps=10)
            emit(line)
        del calls
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
