#!/usr/bin/env python3
"""Where K20 ``ep_bucket`` and K18 ``route_plan`` spend their time, on one card.

    python3 experiments/plan_attribution.py [--tree DIR]           # measure
    python3 experiments/plan_attribution.py --check [--tree DIR]   # only check the patches

TREE is the root of a checkout (this repository's by default; a parent's
unpacked ``git archive`` for a before/after).  Its kernels are built and its
wrappers called, in this process; the inputs are made by this tree's
``chip_smoke.py`` helpers, so both trees see the same ones:

* K20 at ``main_path_ep``'s first chunk (the scale-19 RMAT on one shard,
  131,072 walkers of 20 at (p, q) = (0.25, 4), capacity 131,072): the
  carried state of the second superstep, where nearly every walker proposes
  and asks for membership, and of the first superstep with under 10% of the
  lanes active; a superstep is its two calls, phases A and B;
* K18 at ``main_path_mesh_row``'s batch (2,570 walks of the dense graph's
  first chunk, shuffled): SGNS's ``plan_out`` requests (R = 54,034 at N = 1)
  and HS's ``plan_th`` (the Huffman tail path entries of the same rows).

For each: the device time by CUDA events over 20 calls (a superstep's two
calls for K20); from a ``torch.profiler`` trace of 5 calls queued behind a
spin kernel (so that the gaps are the device's, not the host's), each
launch's duration and the gaps between launches; and ``clock64()`` probes
patched into a copy of the kernel source (``_variants.py``): K20's tile
prefix and ranking in the two-launch design (the probes in
``bucket_common.cuh:bucket_tile_rank``) or the phases of the one-launch
design, and K18's phases in the one-launch design.  Beside K18,
``torch.unique(ids, sorted=True, return_inverse=True)`` as a yardstick of
the deduplication alone.  Prints one JSON line a measurement, then the
card's name and power limit.  Neither the port nor the smoke imports this
file.
"""

import ctypes
import json
import os
import sys

from _variants import (ROOT, build, card, patched, phase_read, probe_counters, probe_flush,
                       probes, profile, source, PROBE_START)

OUT = os.path.join(ROOT, "build", "plan_attribution")

# ---- K20, two launches a call: probes in bucket_tile_rank ----
K20_PHASES_TWO = ["earlier tiles' counts (one thread's loop)", "lane state and warp ranks",
                  "offsets across the tile's warps"]


def k20_patches_two():
    p = probes(len(K20_PHASES_TWO))
    return [
        ("  int32_t* base = sm;  // [n_shards]: active lanes of earlier tiles\n",
         "  " + PROBE_START + "  int32_t* base = sm;\n"),
        ("    base[d] = s;\n  }\n  for (int j = threadIdx.x; j < kBucketTileWarps * n_shards; "
         "j += kBucketTile) wcnt[j] = 0;\n  __syncthreads();\n",
         "    base[d] = s;\n  }\n  for (int j = threadIdx.x; j < kBucketTileWarps * n_shards; "
         f"j += kBucketTile) wcnt[j] = 0;\n  __syncthreads();\n  {p[0]}\n"),
        ("wcnt[warp * n_shards + dest] = __popc(peers);\n  __syncthreads();\n",
         f"wcnt[warp * n_shards + dest] = __popc(peers);\n  __syncthreads();\n  {p[1]}\n"),
        ("  return flat;\n}", f"  {p[2]}\n{probe_flush('k20', len(K20_PHASES_TWO))}"
                             "  return flat;\n}"),
    ]


# ---- K20, one cooperative launch a call ----
K20_PHASES_ONE = ["first tile: lane state, requests, ranks in the tile", "block counts stored",
                  "grid barrier", "earlier blocks' counts summed", "first tile's slots written",
                  "later tiles", "-1 into the unfilled rows"]


def k20_patches_one():
    p = probes(len(K20_PHASES_ONE))
    return [
        ("  int32_t* stage = wc + (threadIdx.x >> 5) * (F + 1) * 32;\n",
         "  int32_t* stage = wc + (threadIdx.x >> 5) * (F + 1) * 32;\n  " + PROBE_START),
        ("  const int off = n2v::tile_offset<kTile>(active, dest, S, wc, tt);\n",
         f"  const int off = n2v::tile_offset<kTile>(active, dest, S, wc, tt);\n  {p[0]}\n"),
        ("  cg::this_grid().sync();\n", f"  {p[1]}\n  cg::this_grid().sync();\n  {p[2]}\n"),
        ("  n2v::grid_bases<kTile>(a.blk, S, gridDim.x, blockIdx.x, S, pre, tot);\n",
         f"  n2v::grid_bases<kTile>(a.blk, S, gridDim.x, blockIdx.x, S, pre, tot);\n  {p[3]}\n"),
        ("  emit(i, active, dest, active ? pre[dest] + off : 0, q);\n",
         f"  emit(i, active, dest, active ? pre[dest] + off : 0, q);\n  {p[4]}\n"),
        ("  n2v::grid_fill<kTile>(a.send, F, S, a.capacity, tot, ends, -1);\n}",
         f"  {p[5]}\n  n2v::grid_fill<kTile>(a.send, F, S, a.capacity, tot, ends, -1);\n"
         f"  {p[6]}\n{probe_flush('k20', len(K20_PHASES_ONE))}}}"),
    ]


# ---- K18, one cooperative launch a call ----
K18_PHASES = ["0: digit-0 counts and bits", "barrier 0", "the bits that vary, digit 0's bases",
              "pass bases",
              "pass ranks and scatter", "pass barriers", "heads by owner", "heads barrier",
              "slots, ranks and the plan", "dead slots, n_out"]


def k18_patches():
    p = probes(len(K18_PHASES))
    return [
        ("  const PlanOut& o = a.o;\n", "  const PlanOut& o = a.o;\n  " + PROBE_START),
        ("    orand[2 * b + 1] = s_and;\n  }\n  grid.sync();\n",
         f"    orand[2 * b + 1] = s_and;\n  }}\n  {p[0]}\n  grid.sync();\n  {p[1]}\n"),
        ("  const u64* src = nullptr;\n", f"  {p[2]}\n  const u64* src = nullptr;\n"),
        ("    if (tid < nd) run[tid] = 0;\n", f"    if (tid < nd) run[tid] = 0;\n    {p[3]}\n"),
        ("    src = dst;\n    grid.sync();\n", f"    src = dst;\n    {p[4]}\n    grid.sync();\n"
                                              f"    {p[5]}\n"),
        ("  if (tid == 0) hown[static_cast<int64_t>(b) * (N + 1)] = s_count;\n  grid.sync();\n",
         f"  if (tid == 0) hown[static_cast<int64_t>(b) * (N + 1)] = s_count;\n  {p[6]}\n"
         f"  grid.sync();\n  {p[7]}\n"),
        ("  // the dead slots as JAX's argsort leaves them\n",
         f"  {p[8]}\n  // the dead slots as JAX's argsort leaves them\n"),
        ("      o.n_out[1] = s_count;\n    }\n  }\n}\n",
         f"      o.n_out[1] = s_count;\n    }}\n  }}\n  {p[9]}\n"
         f"{probe_flush('k18', len(K18_PHASES))}}}\n"),
    ]


def probed_sources(csrc: str) -> dict:
    """name -> (patched source, phases, counter prefix): K20 in the design the
    tree holds, K18 where it holds the one-launch design."""
    ep_src = source("ep_walk.cu", csrc)
    one = "ep_bucket_kernel" in ep_src
    k20 = k20_patches_one() if one else k20_patches_two()
    out = {"k20": (probe_counters("k20") + patched(ep_src, k20) + phase_read("k20"),
                   K20_PHASES_ONE if one else K20_PHASES_TWO, "k20")}
    route_src = source("route.cu", csrc)
    if "route_plan_kernel" in route_src:
        out["k18"] = (probe_counters("k18") + patched(route_src, k18_patches())
                      + phase_read("k18"), K18_PHASES, "k18")
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def host_us(torch, fn, calls: int = 50) -> float:
    """Host microseconds a call of ``fn()`` takes to enqueue its work: the
    calls are made while a spin kernel holds the stream, so none waits (50
    calls of the parent's K18, 14 launches each, stay inside the launch
    queue; more would wait on the spin)."""
    import time

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def launch_trace(torch, fn, reps: int = 5) -> dict:
    """Each launch's mean duration (us) and the mean gaps between launches
    (us) of ``fn()``, from a torch.profiler trace of ``reps`` calls, each
    queued behind a spin kernel so that the device, not the host, sets the
    gaps; and the span from the first launch's start to the last's end."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            torch.cuda._sleep(20_000_000)
            fn()
            torch.cuda.synchronize()
    events = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            continue
        name = ev.name()
        if ("spin_kernel" in name or "sleep" in name or name.startswith("nccl:")
                or "Memcpy" in name or "Memset" in name):
            continue
        events.append((ev.start_ns(), ev.duration_ns(), name))
    events.sort()
    if not events:
        return {"device_events": 0}
    groups, cur = [], [events[0]]
    for e in events[1:]:  # calls are separated by a synchronize and a spin
        if e[0] - (cur[-1][0] + cur[-1][1]) > 200_000:
            groups.append(cur)
            cur = []
        cur.append(e)
    groups.append(cur)
    n = len(groups[0])
    groups = [g for g in groups if len(g) == n]
    names = [e[2][:60] for e in groups[0]]
    dur = [sum(g[k][1] for g in groups) / len(groups) / 1e3 for k in range(n)]
    gaps = [sum(g[k + 1][0] - g[k][0] - g[k][1] for g in groups) / len(groups) / 1e3
            for k in range(n - 1)]
    span = sum(g[-1][0] + g[-1][1] - g[0][0] for g in groups) / len(groups) / 1e3
    return {"launches": n, "kernels": names, "launch_us": dur, "gaps_us": gaps,
            "busy_us": sum(dur), "span_us": span, "calls_traced": len(groups)}


WALKERS, WALK_LENGTH = 131072, 20


def k20_calls():
    """K20's calls (carry, seed, gid_base, keywords) at ``main_path_ep``'s
    first chunk, walked through the importing tree's kernels: {"second":
    the second superstep's two, "late": the first superstep's with under 10%
    of the lanes active}, and that superstep's number and active lanes."""
    import torch

    import chip_smoke as cs
    from node2vec_torch.parallel import edge_partitioned_blocked as ep
    from node2vec_torch.parallel import make_mesh

    dev = torch.device("cuda")
    _, _, g_rmat = cs.rmat_graph(19)
    mesh = make_mesh(1, 1, device="cuda")
    pg = ep.partition_blocked_graph(g_rmat.indptr, g_rmat.indices, g_rmat.weights, 1, mesh=mesh)
    tables = ep.local_tables(pg, 0)
    starts = torch.arange(WALKERS, dtype=torch.int32, device=dev) % g_rmat.n_vertices

    class Capture(ep._Kernels):
        step, late, got = 0, None, {}

        @classmethod
        def bucket(cls, carry, seed, gid_base, **kw):
            if kw.get("slot_a") is None and cls.late is None and cls.step > 1:
                active = int(((carry[ep.ALIVE] != 0) & (carry[ep.T] < WALK_LENGTH)).sum())
                if active < 0.1 * WALKERS:
                    cls.late = (cls.step, active)
            if cls.step == 1 or (cls.late is not None and cls.late[0] == cls.step):
                cls.got.setdefault("second" if cls.step == 1 else "late", []).append(
                    (carry.clone(), seed, gid_base,
                     {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()}))
            return ep.ep_bucket(carry, seed, gid_base, **kw)

        @classmethod
        def advance(cls, *a, **kw):
            cls.step += 1
            return ep.ep_advance(*a, **kw)

    carry = ep.init_carry(starts)
    paths = torch.full((WALKERS, WALK_LENGTH + 1), -1, dtype=torch.int32, device=dev)
    paths[:, 0] = starts
    n_fb = torch.zeros(1, dtype=torch.int32, device=dev)
    own = dict(my_shard=0, rows_per_shard=pg.rows_per_shard, light_width=pg.light_width,
               block_width=pg.block_width)
    for _ in range(ep.max_supersteps(WALK_LENGTH, 4.0, 4)):
        pending = ep.superstep(Capture, None, "data", tables, carry, paths, n_fb, 0, 0,
                               n_shards=1, capacity=WALKERS, walk_length=WALK_LENGTH,
                               return_param=0.25, inout_param=4.0, max_trials=64, **own)
        if int(pending) == 0:
            break
    torch.distributed.destroy_process_group()
    return Capture.got, Capture.late


def k18_requests():
    """K18's request vectors at ``main_path_mesh_row``'s batch, by the
    importing tree's helpers: [(case, ids, cap)] for SGNS's plan_out and HS's
    plan_th at N = 1."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from node2vec_torch.constants import Node2VecParams
    from node2vec_torch.graph import build_graph
    from node2vec_torch.models import hsoftmax as hs
    from node2vec_torch.models import skipgram as sg
    from node2vec_torch.models.vocab import build_vocab
    from node2vec_torch.parallel import rowsharded_hs as rh
    from node2vec_torch.parallel import rowsharded_sgns as rs
    from node2vec_torch.walk import WalkEngine

    dev = torch.device("cuda")
    src, dst = cs.smoke_edges(131072, 2_097_152)
    g = build_graph((src, dst), directed=False)
    hs_batch = cs._effective_batch(8192, 131072, target_updates=51)
    chunk0 = WalkEngine(g, Node2VecParams(**cs.N2V_MAIN), device="cuda").chunk_source(seed=0)[2](0)
    walks_np = chunk0.cpu().numpy()[np.random.default_rng(0).permutation(len(chunk0))][:hs_batch]
    walks = torch.from_numpy(np.ascontiguousarray(walks_np)).to(dev)
    n_walks, length = walks.shape
    flat = walks.reshape(-1)
    rows = torch.where(flat >= 0, flat, 0)
    vocab = build_vocab(walks, 131072, min_count=1)
    noise = [torch.from_numpy(a).to(dev) for a in (vocab.ns_alias, vocab.ns_prob)]
    gen = torch.Generator(device=dev).manual_seed(3)
    _, r1, r2 = sg.draw_step(gen, n_walks, length, 5, 64, True, dev)
    ids_out = torch.cat([rows, sg.negative_ids(r1, r2, *noise)])
    tree, _ = cs.hs_tree(g)
    head = hs.head_level_offsets(tree, table_rows=tree.n_inner)
    points = torch.from_numpy(np.ascontiguousarray(tree.points)).to(dev)
    n_head, _ = hs.head_split(head, tree.points.shape[1])
    ids_th = points[rows.long()][:, n_head:].reshape(-1).contiguous()
    _, cap_th = rh.hs_caps(n_walks, length, tree.points.shape[1], head, 1)
    return [("plan_out (SGNS)", ids_out, rs.row_cap(ids_out.shape[0], 1)),
            ("plan_th (HS tail)", ids_th, cap_th)]


def main() -> int:
    args = sys.argv[1:]
    tree = os.path.abspath(args[args.index("--tree") + 1]) if "--tree" in args else ROOT
    csrc = os.path.join(tree, "node2vec_torch", "csrc")
    srcs = probed_sources(csrc)
    if "--check" in args:
        print(json.dumps({"patches_apply": sorted(srcs), "tree": tree}))
        return 0
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from node2vec_torch import _build
    from node2vec_torch.parallel import edge_partitioned_blocked as ep
    from node2vec_torch.parallel import rowsharded_sgns as rs

    dev = torch.device("cuda")
    libs = build({k: (v[0], []) for k, v in srcs.items()}, OUT,
                 lambda name: "ep_bucket" if name == "k20" else "route_plan")
    vp, i32, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
    k20 = libs["k20"].n2v_ep_bucket
    k20.argtypes = [vp, i64, vp, vp, vp, vp, vp, i32, i64, i64, i32, i64, u32, i32, vp]
    k20.restype = ctypes.c_int
    got, late = k20_calls()
    for key, calls in sorted(got.items()):
        def superstep_calls(calls=calls):
            for c, seed, gid, kw in calls:
                ep.ep_bucket(c, seed, gid, **kw)

        def probed(calls=calls):
            for c, seed, gid, kw in calls:
                n, cap = c.shape[1], kw["capacity"]
                member = kw.get("slot_a") is not None
                send = torch.empty((cap, 2 if member else 7), dtype=torch.int32, device=dev)
                slot = torch.empty(n, dtype=torch.int32, device=dev)
                tiles = torch.empty((max(-(-n // 1024), 1), 1), dtype=torch.int32, device=dev)
                rc = k20(_build.ptr(c), n, _build.ptr_or_null(kw.get("slot_a")),
                         _build.ptr_or_null(kw.get("back")), _build.ptr(send), _build.ptr(slot),
                         _build.ptr(tiles), 1, cap, kw["rows_per_shard"], kw["walk_length"],
                         gid, seed, int(member), _build.stream_of(c))
                if rc:
                    raise SystemExit(f"probed K20 failed: {rc}")

        c0 = calls[0][0]
        emit({"kernel": "ep_bucket", "superstep": 1 if key == "second" else late[0],
              "active_lanes": int(((c0[ep.ALIVE] != 0) & (c0[ep.T] < WALK_LENGTH)).sum()),
              "calls": len(calls), "ms_a_superstep": cs.time_ms(superstep_calls, reps=20),
              "host_us_a_superstep": host_us(torch, superstep_calls),
              "trace": launch_trace(torch, superstep_calls),
              "probes": profile(libs["k20"], "k20", probed, srcs["k20"][1])})
    del got

    k18 = libs.get("k18")
    if k18 is not None:
        k18.n2v_route_plan.argtypes = [vp, i64, i32, i32] + [vp] * 14
        k18.n2v_route_plan.restype = ctypes.c_int
        k18.n2v_route_plan_ws.argtypes = [i64, i32]
        k18.n2v_route_plan_ws.restype = ctypes.c_int64
    for case, ids, cap in k18_requests():
        r = ids.shape[0]
        line = {"kernel": "route_plan", "case": case, "R": r, "cap": cap,
                "n_uniq": int(rs.plan_routes(ids, 1, cap).n_uniq),
                "ms": cs.time_ms(lambda: rs.plan_routes(ids, 1, cap), reps=20),
                "host_us": host_us(torch, lambda: rs.plan_routes(ids, 1, cap)),
                "torch_unique_ms": cs.time_ms(
                    lambda: torch.unique(ids, sorted=True, return_inverse=True), reps=20),
                "trace": launch_trace(torch, lambda: rs.plan_routes(ids, 1, cap))}
        if k18 is not None:
            i32t = dict(dtype=torch.int32, device=dev)
            ws = torch.empty((2, r), dtype=torch.int64, device=dev)
            ws_i = torch.empty((k18.n2v_route_plan_ws(r, 1),), **i32t)
            outs = [torch.empty((r,), **i32t) for _ in range(6)]
            flags = [torch.empty((r,), dtype=torch.bool, device=dev) for _ in range(2)]
            send_ids = torch.empty((1, cap), **i32t)
            n_out = torch.empty((2,), **i32t)

            def probed(ids=ids, r=r, cap=cap):
                p = _build.ptr
                rc = k18.n2v_route_plan(
                    p(ids), r, 1, cap, p(ws[0]), p(ws[1]), p(ws_i), p(outs[0]), p(outs[1]),
                    p(flags[0]), p(outs[2]), p(outs[3]), p(flags[1]), p(send_ids), p(n_out),
                    p(outs[4]), p(outs[5]), _build.stream_of(ids))
                if rc:
                    raise SystemExit(f"probed K18 failed: {rc}")

            line["probes"] = profile(k18, "k18", probed, srcs["k18"][1])
        emit(line)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
