#!/usr/bin/env python3
"""Where K19's pack (``route_pack``, csrc/route.cu) spends its time, on one
card: the kernel as built beside patched copies with a part cut out or
moved.

    python3 experiments/pack_attribution.py            # measure
    python3 experiments/pack_attribution.py --check    # only check the patches

The inputs (``pack_cases``, which ``ab_csr_route_kernels.py`` takes too):
``main_path_mesh_row``'s batch (2,570 walks of the dense graph's first
chunk, shuffled), SGNS's ``plan_out`` (the walk rows, live where the walk
position is, then the 64 shared negatives' d_no rows, R = 54,034 at N = 1)
and HS's ``plan_th`` (the Huffman tail entries of the same rows, live inside
the code's length), random gradient rows from one seed, D = 128.

Variants: "streaming stores" (the zeros stored with ``__stcs``, evict-first)
and "fill after the barrier" (the unfilled rows zeroed after the grid
barrier, not after the warp's sums): the same buffer; "no zero fill",
"zero fill only" (no request summed) and "no combine" (no run finished
across ranges).  Each library's time over 20 calls (CUDA events), whether
its buffer equals the kernel's, and ptxas's registers and spills of each
build; then the card's name and power limit.  Neither the port nor the
smoke imports this file.
"""

import ctypes
import json
import os
import sys

from _variants import ROOT, build, card, patched, source

FILL = "  zero_unfilled(a, warp, n_warps, lane);  // once the warp's sums are stored\n"
VARIANTS = {
    "streaming stores": [("  for (int64_t i = lane; i < n4; i += 32) body[i] = make_float4(0.f, 0.f, 0.f, 0.f);",
                          "  for (int64_t i = lane; i < n4; i += 32) __stcs(body + i, make_float4(0.f, 0.f, 0.f, 0.f));")],
    "fill after the barrier": [(FILL, ""), ("  cg::this_grid().sync();\n",
                                            "  cg::this_grid().sync();\n" + FILL)],
    "no zero fill": [(FILL, "")],
    "zero fill only": [("  const int64_t lo = warp * a.per_warp;\n", "  const int64_t lo = a.r;\n")],
    "no combine": [("pass through)\n  if (!seen) return;\n", "pass through)\n  return;\n")],
}
SAME_BUFFER = ("streaming stores", "fill after the barrier")


def pack_cases(dim: int = 128):
    """{name: (plan, cap, (g_a, live_a, g_b, live_b))} at N = 1 on the
    card, made by the importing tree's helpers."""
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
    batch = cs._effective_batch(8192, 131072, target_updates=51)
    chunk0 = WalkEngine(g, Node2VecParams(**cs.N2V_MAIN), device="cuda").chunk_source(seed=0)[2](0)
    walks_np = chunk0.cpu().numpy()[np.random.default_rng(0).permutation(len(chunk0))][:batch]
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
    cl = tree.points.shape[1]
    n_head, _ = hs.head_split(head, cl)
    points = torch.from_numpy(np.ascontiguousarray(tree.points)).to(dev)
    lengths = torch.from_numpy(np.ascontiguousarray(tree.lengths)).to(dev).long()
    ids_th = points[rows.long()][:, n_head:].reshape(-1).contiguous()
    inside = ((torch.arange(n_head, cl, device=dev)[None, :] < lengths[rows.long()][:, None])
              & (flat >= 0)[:, None]).reshape(-1)
    live_th = torch.where(inside, ids_th, -1).to(torch.int32)
    _, cap_th = rh.hs_caps(n_walks, length, cl, head, 1)
    gen = torch.Generator(device=dev).manual_seed(7)
    n = rows.shape[0]
    cap_out = rs.row_cap(ids_out.shape[0], 1)
    return {"plan_out": (rs.plan_routes(ids_out, 1, cap_out), cap_out,
                         (torch.randn((n, dim), generator=gen, device=dev), flat,
                          torch.randn((64, dim), generator=gen, device=dev), None)),
            "plan_th": (rs.plan_routes(ids_th, 1, cap_th), cap_th,
                        (torch.randn((ids_th.shape[0], dim), generator=gen, device=dev),
                         live_th, None, None))}


def main() -> int:
    src = source("route.cu")
    srcs = {"as built": (src, [])}
    for name, pairs in VARIANTS.items():
        srcs[name] = (patched(src, pairs), [])
    if "--check" in sys.argv:
        print(json.dumps({"libraries": list(srcs), "patches_apply": True}))
        return 0
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch

    import chip_smoke as cs
    from node2vec_torch import _build
    from node2vec_torch.parallel import rowsharded_sgns as rs

    libs = build(srcs, os.path.join(ROOT, "build", "pack_attribution"),
                 lambda name: "pack_kernel")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for lib in libs.values():
        lib.n2v_route_pack.argtypes = [vp, vp, i64, vp, vp, i32] + [vp] * 6 + [
            i64, i64, i32, vp, vp, vp, vp]
        lib.n2v_route_pack.restype = ctypes.c_int
        lib.n2v_route_pack_ws.argtypes = [i32, vp]
        lib.n2v_route_pack_ws.restype = ctypes.c_int
    for case, (plan, cap, (g_a, live_a, g_b, live_b)) in pack_cases().items():
        dim = g_a.shape[1]
        line = {"kernel": "route_pack", "case": case, "R": int(plan.uniq.shape[0]), "cap": cap,
                "wrapper_ms": cs.time_ms(lambda: rs.route_pack(plan, 1, cap, g_a, live_a, g_b,
                                                               live_b), reps=20)}
        ref = None
        for name, lib in libs.items():
            ws = (ctypes.c_int64 * 4)()
            _build.check(lib.n2v_route_pack_ws(dim, ws), name)
            lead = torch.empty((ws[0],), dtype=torch.float32, device=g_a.device)
            meta = torch.empty((ws[1],), dtype=torch.int32, device=g_a.device)
            send = torch.empty((cap, dim + 1), dtype=torch.float32, device=g_a.device)
            p = _build.ptr

            def run(lib=lib, lead=lead, meta=meta, send=send):
                rc = lib.n2v_route_pack(
                    p(g_a), _build.ptr_or_null(live_a), g_a.shape[0], _build.ptr_or_null(g_b),
                    _build.ptr_or_null(live_b), dim, p(plan.order), p(plan.inv), p(plan.owner),
                    p(plan.bucket_pos), p(plan.ok), p(plan.send_ids), plan.uniq.shape[0], cap,
                    cap, p(lead), p(meta), p(send), _build.stream_of(g_a))
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            run()
            torch.cuda.synchronize()
            if ref is None:
                ref = send.clone()
            line[name] = {"ms": cs.time_ms(run, reps=20), "blocks": ws[2]}
            if name in SAME_BUFFER:
                line[name]["same_buffer"] = bool(torch.equal(send, ref))
        print(json.dumps(line), flush=True)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
