"""Numpy models of K8's decomposition (csrc/hs.cu) and of K3's duplicate
combining (csrc/adagrad.cu) against the plain versions and the JAX steps, on
the CPU.

The CUDA kernels cannot run here, so their arithmetic is modelled as they
cut the work.  K8: walk groups of G walks filling up to 16 strips of P
positions (NQ float4s a lane, P = 8 / NQ, rows padded to the strip), the
levels one after another, and per level phase A (each context row's P
partial dot products, one per lane of 16 columns-groups, reduced by the
transposed butterfly to the lane that owns the center, g stored by
(center, offset) and g * theta_row summed into each half-warp's level sums,
added to the group's g_in once a level), then
phase B (each context's gradient from its centers' rows, out to g_tail or,
at head levels, summed within the strip, then into the block's shared
partial of d_head's first KS rows or straight to d_head), the partials
added to d_head at the end, block by block.  Dead rows are zero-filled.
Rows wider than 512 columns go in chunks of 512: each lane's partial dot
summed over the chunks before the butterfly.
K3: a block a run of 32 rows at D = 128, the rows whose id is below 512
summed in the block's array for their accumulator and added once when the
block ends, any other id added at once.

Held to ``hs_grads_plain``, ``hs_grads_routed_plain`` and
``adagrad_accumulate_plain`` at rtol 1e-5 (atol 1e-6; d_head, a sum over
the batch, to rtol of its largest entry), and through the plain Adagrad to
JAX's ``hs_walk_step_impl`` and ``cbow_hs_step_impl`` given the same draws
at the tolerances of tests/test_torch_hsoftmax.py (the JAX steps round
their gradients to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from node2vec_tpu.models import cbow as ref_cbow
from node2vec_tpu.models import hsoftmax as ref_hs
from node2vec_torch.models import cbow
from node2vec_torch.models import hsoftmax as hs
from node2vec_torch.models import skipgram as sg
from node2vec_torch.parallel import rowsharded_hs as rh

RTOL, ATOL = 1e-5, 1e-6
LOSS_RTOL, INC_TOL = 1e-5, 3e-2  # tests/test_torch_hsoftmax.py's, against JAX
CBOW_HS_LOSS_RTOL = 1e-4  # tests/test_torch_cbow.py's: the JAX step rounds h to bf16
SCALE = 0.1  # the tables' standard deviation (chip_smoke.py's check)
WARPS = 16
SMEM_FLOATS = 232448 // 4  # an H100's shared memory per block
STAGED_HEAD_ROWS = 127
K3_HOT, K3_WARPS, K3_UNROLL = 512, 8, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _round_up(a, b):
    return -(-a // b) * b


def k8_geometry(length, dim, cl, window, k_rows):
    """hs.cu's make_geo / pick_geo: NQ, P, G, Mt, ns, ld, nc (column chunks
    of 64 NQ), KS and whether the block stages in shared memory."""
    nq = 2 if dim <= 128 else 4 if dim <= 256 else 8
    p = 8 // nq
    rows = WARPS * p
    g = 1 if length >= rows else rows // length
    mt = _round_up(g * length, p)
    ns, ld = mt // p, _round_up(dim, 64 * nq)
    o = 4 + 5 * mt * ld + _round_up(mt * (2 * window + 1 + 2 * p), 4)  # rows, g_in, gcen
    o += 2 * _round_up(2 * mt + mt * cl, 4) + _round_up(mt, 4) + 2 * WARPS
    room = SMEM_FLOATS - o
    ks = room // ld if room >= ld else 0
    shared = room >= 0
    if not shared:
        ks = STAGED_HEAD_ROWS
    return dict(NQ=nq, P=p, G=g, Mt=mt, ns=ns, ld=ld, nc=ld // (64 * nq), KS=min(k_rows, ks),
                shared=shared, smem=4 * (o + min(k_rows, ks) * ld))


def butterfly(part):
    """The transposed butterfly of reduce16: part [16 lanes, P] -> the sum
    each lane ends with (lane sub: of column sub // (16 // P))."""
    v = np.array(part, np.float32)
    p = v.shape[1]
    sub = np.arange(16)
    n, m = p // 2, 8
    while n >= 1:
        up = ((sub & m) != 0)[:, None]
        send = np.where(up, v[:, :n], v[:, n:2 * n])
        keep = np.where(up, v[:, n:2 * n], v[:, :n])
        v = keep + send[sub ^ m]
        n, m = n // 2, m // 2
    s = v[:, 0]
    m = 8 // p
    while m >= 1:
        s = s + s[sub ^ m]
        m //= 2
    return s


def _sig_log1pe(x):
    e = np.exp(-np.abs(x), dtype=np.float32)
    return (np.where(x >= 0, 1 / (1 + e), e / (1 + e)).astype(np.float32),
            np.log1p(e).astype(np.float32))


def k8_model(x_rows, valid, bsh, ent_live, ent_rows, code, pts, tail_live, *, n_walks, length,
             dim, window, n_head, k_rows, grid=2, ks=None):
    """K8's decomposition on gathered sources: x_rows [B*L1, D] (read where
    valid), ent_rows [B*L1, CL, D] each path entry's row (read where
    ent_live), code, pts [B*L1, CL], bsh [B*L1], tail_live [B*L1, CL] (the
    tail_rows rule).  Returns (g_in, g_tail, tail_rows, d_head, (log-sigmoid
    sum, pairs)) as numpy."""
    cl = pts.shape[1]
    geo = k8_geometry(length, dim, cl, window, k_rows)
    nq, p_, g_, mt, ns, ld, nc = (geo[k] for k in ("NQ", "P", "G", "Mt", "ns", "ld", "nc"))
    kshare = geo["KS"] if ks is None else min(ks, k_rows)
    d, w, h_, clt = dim, window, n_head, cl - n_head
    n = n_walks * length
    g_in = np.full((n, d), np.nan, np.float32)  # every row must be written
    g_tail = np.full((n * clt, d), np.nan, np.float32)
    tail_rows = np.where(tail_live[:, h_:], pts[:, h_:], -1).reshape(-1).astype(np.int32)
    d_head = np.zeros((k_rows, d), np.float32)
    parts = np.zeros(2, np.float32)
    cols = np.array([[64 * nq * ch + 4 * (s + 16 * q) + k for ch in range(nc) for q in range(nq)
                      for k in range(4)] for s in range(16)])  # phase A: a lane's columns
    n_groups = -(-n_walks // g_)
    wix = np.arange(mt) // length
    for blk in range(grid):
        dhs = np.zeros((kshare, ld), np.float32)
        for grp in range(blk, n_groups, grid):
            rows = min(g_, n_walks - grp * g_) * length
            row0 = grp * g_ * length
            pos = row0 + np.arange(rows)
            x = np.zeros((mt, ld), np.float32)
            x[:rows, :d][valid[pos]] = x_rows[pos[valid[pos]]]
            cinfo = np.full(mt, -1)
            cinfo[:rows] = np.where(valid[pos], np.clip(bsh[pos], 0, w), -1)
            live = np.zeros((mt, cl), bool)
            live[:rows] = ent_live[pos]
            for i in range(mt):  # the group's valid pairs
                for dd in range(1, cinfo[i] + 1):
                    for j in (i - dd, i + dd):
                        parts[1] += 0 <= j < mt and wix[j] == wix[i] and cinfo[j] >= 0
            gis = np.zeros((ns, p_, ld), np.float32)  # the group's g_in
            for c in range(cl):
                th = np.zeros((mt, ld), np.float32)
                lv = np.flatnonzero(live[:rows, c])
                th[lv, :d] = ent_rows[pos[lv], c]
                gcen = np.full((mt, 2 * w), np.nan, np.float32)
                gi = np.zeros((ns, 2, p_, ld), np.float32)  # the half-warps' level sums
                for s in range(ns):  # phase A
                    s0 = s * p_
                    rlo, rhi = max(0, s0 - w), min(mt, s0 + p_ + w)
                    for rb in range(rlo, rhi, 2):
                        if not any(r < rhi and live[r, c] for r in (rb, rb + 1)):
                            continue
                        for half, r in enumerate((rb, rb + 1)):
                            if r >= rhi:
                                continue
                            tv = th[r]
                            lane_sums = butterfly(
                                (x[s0:s0 + p_][:, cols] * tv[cols][None]).sum(-1).T)
                            for i in range(p_):
                                ctr, logit = s0 + i, lane_sums[i * (16 // p_)]
                                dd = r - ctr
                                gv = np.float32(0)
                                if (live[r, c] and 1 <= abs(dd) <= cinfo[ctr]
                                        and wix[r] == wix[ctr]):
                                    sig, l1pe = _sig_log1pe(logit)
                                    cd = code[pos[r], c]
                                    gv = sig - np.float32(1) + np.float32(cd)
                                    parts[0] += min(-logit if cd else logit, 0) - l1pe
                                if 1 <= abs(dd) <= w:
                                    gcen[ctr, dd + w if dd < 0 else dd + w - 1] = gv
                                gi[s, half, i] += gv * tv
                gis += gi[:, 0] + gi[:, 1]  # once a level
                for s in range(ns):  # phase B
                    s0 = s * p_
                    rlo, rhi = max(0, s0 - w), min(mt, s0 + p_ + w)
                    ids = live[s0:s0 + p_, c].copy()
                    gc = np.zeros((p_, ld), np.float32)
                    for k in range(rlo, rhi):
                        if cinfo[k] < 1:
                            continue
                        for i in range(p_):
                            dd = s0 + i - k
                            if ids[i] and 1 <= abs(dd) <= w:
                                gv = gcen[k, dd + w if dd < 0 else dd + w - 1]
                                assert not np.isnan(gv), "phase B read an unwritten g"
                                gc[i] += gv * x[k]
                    if c >= h_:
                        for i in range(min(p_, rows - s0)):
                            g_tail[(row0 + s0 + i) * clt + c - h_] = gc[i, :d]
                        continue
                    hid = [int(pts[pos[s0 + i], c]) if ids[i] else -1 for i in range(p_)]
                    for i in range(1, p_):  # equal path nodes of the strip summed
                        for i2 in range(i):
                            if hid[i] >= 0 and hid[i2] == hid[i]:
                                gc[i2] += gc[i]
                                hid[i] = -1
                    for i in range(p_):
                        if 0 <= hid[i] < kshare:
                            dhs[hid[i]] += gc[i]
                        elif hid[i] >= kshare:
                            d_head[hid[i]] += gc[i, :d]
            for s in range(ns):
                for i in range(p_):
                    if s * p_ + i < rows:
                        g_in[row0 + s * p_ + i] = gis[s, i, :d]
        d_head[:kshare] += dhs[:, :d]
    return g_in, g_tail, tail_rows, d_head, parts


def _direct_sources(emb_in, theta, walks, mask, b_sh, points, codes, lengths):
    """K8's sources in the direct mode (hs.cu's load_table), as numpy."""
    w = walks.reshape(-1)
    safe = np.where(w >= 0, w, 0)
    cl = points.shape[1]
    valid = (w >= 0) & mask[safe]
    pts = points[safe]
    tail_live = (w >= 0)[:, None] & (np.arange(cl)[None] < lengths[safe][:, None])
    ent_live = valid[:, None] & tail_live
    return (emb_in[safe], valid, b_sh.reshape(-1), ent_live, theta[pts], codes[safe], pts,
            tail_live)


def model_grads(emb_in, theta, walks, vocab_mask, b_sh, points, codes, lengths, *, window,
                head_offsets, grid=2, ks=None):
    """The model in ``hs_grads_plain``'s signature (torch in, torch out)."""
    cl = points.shape[1]
    n_head, k_rows = hs.head_split(head_offsets, cl)
    src = _direct_sources(*(t.numpy() for t in (emb_in, theta, walks, vocab_mask, b_sh, points,
                                                 codes, lengths)))
    g_in, g_tail, tail_rows, d_head, parts = k8_model(
        *src, n_walks=walks.shape[0], length=walks.shape[1], dim=emb_in.shape[1],
        window=window, n_head=n_head, k_rows=k_rows, grid=grid, ks=ks)
    loss = -parts[0] / max(parts[1], np.float32(1))
    return tuple(torch.from_numpy(x) for x in (g_in, g_tail, tail_rows, d_head)) + (
        torch.tensor(loss, dtype=torch.float32),)


def _tree(n_vertices, seed, max_len=None):
    counts = np.random.default_rng(seed).integers(0, 30, n_vertices)
    return hs.cap_code_length(hs.build_huffman(counts), counts, max_len=max_len), counts


def _inputs(tree, counts, n_walks, length, dim, window, seed):
    rng = np.random.default_rng(seed)
    v = len(counts)
    emb_in = rng.normal(0, SCALE, (v, dim)).astype(np.float32)
    theta = rng.normal(0, SCALE, (tree.n_inner, dim)).astype(np.float32)
    walks = rng.integers(0, v, (n_walks, length)).astype(np.int32)
    ends = rng.integers(length // 2, length + 1, n_walks)
    walks[np.arange(length)[None, :] >= ends[:, None]] = -1
    mask = counts >= 3
    b_sh = rng.integers(1, window + 1, (n_walks, length)).astype(np.int32)
    return [torch.from_numpy(x) for x in (emb_in, theta, walks, mask, b_sh, tree.points,
                                          tree.codes, tree.lengths)]


def _assert_hs(got, want, names=("g_in", "g_tail", "tail_rows", "d_head", "loss")):
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if name == "tail_rows":
            np.testing.assert_array_equal(a, b)
        elif name == "d_head":
            err, scale = np.abs(a - b).max(initial=0), np.abs(b).max(initial=0)
            assert err <= RTOL * scale + ATOL, (name, err, scale)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_butterfly_ends_in_the_owning_lane(p):
    part = np.random.default_rng(p).normal(0, 1, (16, p)).astype(np.float32)
    got = butterfly(part)
    want = part.sum(0)[np.arange(16) // (16 // p)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,want", [
    ((21, 128, 18, 5, 511), dict(NQ=2, P=4, G=3, Mt=64, ns=16, KS=103, shared=True)),
    ((11, 100, 18, 10, 511), dict(NQ=2, P=4, G=5, Mt=56, ns=14, shared=True)),
    ((81, 128, 18, 5, 511), dict(G=1, Mt=84, ns=21, shared=False, KS=127)),
    ((81, 256, 16, 10, 255), dict(NQ=4, P=2, G=1, Mt=82, ns=41, shared=False)),
    ((21, 512, 18, 5, 511), dict(NQ=8, P=1, G=1, Mt=21, ns=21, nc=1, KS=6, shared=True)),
    ((21, 768, 18, 5, 511), dict(NQ=8, P=1, Mt=21, ld=1024, nc=2, KS=127, shared=False)),
    ((9, 600, 18, 2, 511), dict(NQ=8, P=1, G=1, Mt=9, ld=1024, nc=2, shared=True)),
])
def test_geometry(shape, want):
    """The main path's shape (3 walks a group in 16 strips of 4, 103 head
    rows in the block's partial: levels 0-5 and part of 6), a window of 10,
    D = 512 (six head rows fit), the shapes that stage in a global
    workspace, and rows wider than 512 in chunks (a short walk of them
    still fits shared memory)."""
    geo = k8_geometry(*shape)
    assert {k: geo[k] for k in want} == want
    assert (geo["smem"] <= 232448) == geo["shared"]


def test_kernel_shape_check():
    """K8 on the card takes any dim >= 1 (past 512 in chunks) and a code
    length >= 1; the plain versions take any width."""
    for dim in (1, 512, 600, 1024):
        hs.check_hs_kernel_shape(dim, 18)
    for dim, cl in ((0, 18), (128, 0)):
        with pytest.raises(ValueError):
            hs.check_hs_kernel_shape(dim, cl)
    tree, counts = _tree(40, seed=2)
    args = _inputs(tree, counts, 3, 11, 600, 2, seed=2)
    out = hs.hs_grads(*args, window=2, head_offsets=(0,))  # CPU tensors: the plain version
    assert out[0].shape == (33, 600)


@pytest.mark.parametrize("length,dim,window,head,ks", [
    (21, 64, 5, True, None),     # 3 walks a group in 16 strips, the head in the partial
    (21, 64, 5, True, 3),        # head rows past KS = 3 take global atomics
    (11, 100, 3, True, None),    # 5 walks a group, D not a multiple of 64
    (21, 128, 5, False, None),   # no head: every level a tail
    (70, 32, 2, True, None),     # L1 > 64: one walk, 18 strips (a warp takes two)
    (21, 200, 5, True, 2),       # NQ = 4, P = 2
    (11, 300, 2, True, None),    # NQ = 8, P = 1
    (11, 600, 2, True, None),    # two chunks of 512 columns, the second part padding
    (21, 1100, 3, True, 2),      # three chunks, one walk a group
])
def test_model_matches_plain(length, dim, window, head, ks):
    tree, counts = _tree(60, seed=length + dim)
    n_walks = 2 * max(1, 64 // length) + 1  # a ragged last group
    args = _inputs(tree, counts, n_walks, length, dim, window, seed=dim)
    ho = hs.head_level_offsets(tree, max_rows=16) if head else (0,)
    kw = dict(window=window, head_offsets=ho)
    want = hs.hs_grads_plain(*args, **kw)
    got = model_grads(*args, **kw, ks=ks)
    _assert_hs(got, want)


@pytest.mark.parametrize("case", ["dead_walk", "all_out_of_vocabulary", "one_vertex",
                                  "code_length_capped", "more_blocks_than_groups"])
def test_model_edge_cases(case):
    tree, counts = _tree(60, seed=4)
    length, dim, window, grid = 21, 64, 5, 2
    if case == "one_vertex":
        counts = np.array([7])
        tree = hs.build_huffman(counts)
    elif case == "code_length_capped":  # every level in the head, no tail
        tree = hs.cap_code_length(tree, counts, max_len=4)
    args = _inputs(tree, counts, 7, length, dim, window, seed=9)
    if case == "dead_walk":
        args[2][3] = -1
    elif case == "all_out_of_vocabulary":
        args[3][:] = False
    elif case == "more_blocks_than_groups":
        grid = 5
    ho = hs.head_level_offsets(tree, table_rows=tree.n_inner)
    if case == "code_length_capped":
        assert len(ho) - 1 >= tree.points.shape[1]
    kw = dict(window=window, head_offsets=ho)
    want = hs.hs_grads_plain(*args, **kw)
    got = model_grads(*args, **kw, grid=grid)
    _assert_hs(got, want)
    if case == "all_out_of_vocabulary":
        assert not got[0].any() and not got[3].any()


def test_model_routed_masks():
    """The routed mode: centers and tail rows through slot tables (-1:
    dropped, read as zeros), head rows from the all-gathered head."""
    tree, counts = _tree(80, seed=6)
    length, dim, window = 21, 64, 5
    emb_in, theta, walks, mask, b_sh, points, codes, lengths = _inputs(
        tree, counts, 7, length, dim, window, seed=7)
    ho = hs.head_level_offsets(tree, max_rows=16)
    cl = points.shape[1]
    n_head, k_rows = hs.head_split(ho, cl)
    clt = cl - n_head
    rng = np.random.default_rng(8)
    n = walks.numel()
    x_in, th = emb_in[:70].clone(), theta[: tree.n_inner - 3].clone()
    slot_in = torch.from_numpy(rng.integers(-1, 70, n).astype(np.int32))
    slot_th = torch.from_numpy(rng.integers(-1, th.shape[0], n * clt).astype(np.int32))
    slot_in[::9] = -1
    slot_th[4::7] = -1
    head = theta[:k_rows].clone()
    kw = dict(window=window, head_offsets=ho)
    want = rh.hs_grads_routed_plain(x_in, slot_in, th, slot_th, head, walks, mask, b_sh, points,
                                    codes, lengths, **kw)
    w = walks.numpy().reshape(-1)
    safe = np.where(w >= 0, w, 0)
    si, st = slot_in.numpy(), slot_th.numpy().reshape(n, clt)
    pts = points.numpy()[safe]
    valid = (w >= 0) & mask.numpy()[safe] & (si >= 0)
    tail_live = (w >= 0)[:, None] & (np.arange(cl)[None] < lengths.numpy()[safe][:, None])
    tail_live[:, n_head:] &= st >= 0
    rows = np.concatenate([head.numpy()[np.minimum(pts[:, :n_head], k_rows - 1)],
                           th.numpy()[np.maximum(st, 0)]], axis=1)
    g_in, g_tail, tail_rows, d_head, parts = k8_model(
        x_in.numpy()[np.maximum(si, 0)], valid, b_sh.numpy().reshape(-1),
        valid[:, None] & tail_live, rows, codes.numpy()[safe], pts, tail_live, n_walks=7,
        length=length, dim=dim, window=window, n_head=n_head, k_rows=k_rows)
    _assert_hs((g_in, g_tail, tail_rows, d_head, parts), want)  # parts: log-sigmoid sum, pairs


def _bf16_exact(x):
    x = np.array(x, dtype=np.float32)
    x.view(np.uint32)[...] &= np.uint32(0xFFFF0000)
    return x


def _assert_increments(got, want, init, names):
    for name, g, w, i in zip(names, got, want, init):
        inc, ref_inc = np.asarray(g) - i, np.asarray(w) - i
        scale = float(np.abs(ref_inc).max())
        assert scale > 0, f"{name}: no update"
        err = float(np.abs(inc - ref_inc).max())
        assert err <= INC_TOL * scale, f"{name}: increment error {err} > {INC_TOL} * {scale}"


# one compile per step instead of one per primitive: faster on the CPU
_ref_hs_step = jax.jit(ref_hs.hs_walk_step_impl,
                       static_argnames=("window", "shrink_window", "head_offsets", "packed"))
_ref_cbow_hs_step = jax.jit(ref_cbow.cbow_hs_step_impl,
                            static_argnames=("window", "shrink_window", "cbow_mean", "packed"))


@pytest.fixture(scope="module")
def jax_case():
    """One batch, state and draws, with JAX's HS and CBOW-HS steps on them
    (bf16-representable tables: the JAX steps round gradients to bf16)."""
    v, n_walks, length, dim, window = 50, 7, 21, 32, 3
    rng = np.random.default_rng(11)
    counts = rng.integers(0, 30, v)
    tree = hs.cap_code_length(hs.build_huffman(counts), counts)
    state = [_bf16_exact(rng.normal(0, 0.3, (v, dim))),
             _bf16_exact(rng.normal(0, 0.3, (tree.n_inner, dim))),
             rng.random(v).astype(np.float32), rng.random(tree.n_inner).astype(np.float32)]
    walks = rng.integers(0, v, (n_walks, length)).astype(np.int32)
    walks[rng.random((n_walks, length)) < 0.1] = -1
    mask = counts >= 3
    key = jax.random.PRNGKey(3)
    b_sh = np.asarray(jax.random.randint(key, (n_walks, length), 1, window + 1)).astype(np.int32)
    ho = hs.head_level_offsets(tree, max_rows=16)
    tabs = [jnp.asarray(a) for a in (tree.points, tree.codes, tree.lengths)]
    hs_ref = _ref_hs_step(
        *(jnp.asarray(a) for a in state), jnp.asarray(walks), key, 0.1, *tabs, jnp.asarray(mask),
        window=window, shrink_window=True, head_offsets=ho)
    cb_ref = _ref_cbow_hs_step(
        *(jnp.asarray(a) for a in state), jnp.asarray(walks), key, 0.1, *tabs, jnp.asarray(mask),
        window=window, shrink_window=True, cbow_mean=True)
    return dict(tree=tree, state=state, walks=walks, mask=mask, b_sh=b_sh, ho=ho, window=window,
                hs=[np.asarray(x) for x in hs_ref], cbow=[np.asarray(x) for x in cb_ref])


def _port_step(case, objective, grads, accumulate):
    st = [torch.from_numpy(a.copy()) for a in case["state"]]
    tree = case["tree"]
    args = (*st, torch.from_numpy(case["walks"]), torch.from_numpy(case["b_sh"]), 0.1,
            *(torch.from_numpy(a) for a in (tree.points, tree.codes, tree.lengths)),
            torch.from_numpy(case["mask"]))
    if objective == "hs":
        loss = hs._step(grads, accumulate, sg.adagrad_apply_plain, *args, case["window"],
                        case["ho"])
    else:
        loss = cbow._hs_step(grads, accumulate, sg.adagrad_apply_plain, *args, case["window"],
                             True)
    return [a.numpy() for a in st], float(loss)


def test_model_step_matches_jax(jax_case):
    """One HS step, the model's grads through the plain Adagrad, against JAX."""
    got, loss = _port_step(jax_case, "hs", model_grads, sg.adagrad_accumulate_plain)
    want = jax_case["hs"]
    np.testing.assert_allclose(loss, float(want[4]), rtol=LOSS_RTOL)
    _assert_increments(got, want[:4], jax_case["state"], ("emb_in", "theta", "acc_in",
                                                          "acc_theta"))


# --------------------------------------------------------------------------- #
# K3: duplicate rows combined before the atomics
# --------------------------------------------------------------------------- #


def k3_rows_a_block(dim: int) -> int:
    """adagrad.cu: T lanes a row (the power of two covering its 16- or 4-byte
    pieces, at most 32), 32 / T rows side by side, 4 rows a lane group."""
    pieces = dim // 4 if dim % 4 == 0 else dim
    t = 1
    while t < pieces and t < 32:
        t *= 2
    return K3_WARPS * (32 // t) * K3_UNROLL


def k3_model(acc_in, acc_out, g_in, rows_in, g_out, rows_out, g_extra, rows_extra, *,
             hot=K3_HOT, stats=None):
    """K3 in place on torch accumulators: the lists laid end to end, a block
    a run of ``k3_rows_a_block`` rows; a row whose id is below ``hot`` is
    summed into the block's array for its accumulator (each nonzero entry
    added once when the block ends), any other added at once.  (The kernel
    also sums equal ids among a lane group's rows first: an order of the
    same sums.)"""
    accs = (acc_in.numpy(), acc_out.numpy())
    gs = [g.numpy() for g in (g_in, g_out, g_extra)]
    ids = np.concatenate([r.numpy().astype(np.int64) for r in (rows_in, rows_out, rows_extra)])
    which = np.concatenate([np.full(len(r), min(k, 1)) for k, r in enumerate((rows_in, rows_out,
                                                                              rows_extra))])
    dim = g_in.shape[1]
    inv = np.float32(1) / np.float32(dim)
    sq = np.concatenate([(g * g).sum(-1, dtype=np.float32) * inv for g in gs]).astype(np.float32)
    n = len(ids)
    per = k3_rows_a_block(dim)
    counts = {"direct": 0, "flushed": 0}
    for r0 in range(0, n, per):
        arrays = np.zeros((2, hot), np.float32)
        for r in range(r0, min(n, r0 + per)):
            if ids[r] < 0:
                continue
            if ids[r] < hot:
                arrays[which[r], ids[r]] += sq[r]
            else:
                accs[which[r]][ids[r]] += sq[r]
                counts["direct"] += 1
        for k, i in zip(*np.nonzero(arrays)):
            accs[k][i] += arrays[k, i]
            counts["flushed"] += 1
    if stats is not None:
        stats.update(counts)


def _k3_lists(kind, rng, dim):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    def g(n):
        return t(rng.normal(0, 0.3, (n, dim)).astype(np.float32))

    n_in, n_out, n_x = 900, 2600, 40
    rows_in = rng.integers(-1, 300, n_in)
    rows_x = np.arange(n_x)
    if kind == "hs_theta":  # BFS numbering: the top nodes on every path
        levels = rng.integers(0, 9, n_out)
        rows_out = (2 ** levels - 1) + rng.integers(0, 2 ** levels)
    elif kind == "all_equal":  # the worst contention
        rows_in, rows_out, rows_x = np.full(n_in, 7), np.full(n_out, 7), np.full(n_x, 7)
    elif kind == "all_equal_cold":  # the same, on an id past the hot arrays
        rows_in, rows_out, rows_x = (np.full(n, 4000) for n in (n_in, n_out, n_x))
    elif kind == "all_dead":
        rows_in, rows_out, rows_x = np.full(n_in, -1), np.full(n_out, -1), np.full(n_x, -1)
    elif kind == "empty":
        n_in, n_out, n_x = 0, 0, 0
        rows_in, rows_out, rows_x = np.zeros(0), np.zeros(0), np.zeros(0)
    else:  # "wide_ids": ids spread far past any table size
        rows_in = rng.integers(0, 300, n_in) * 1000
        rows_out = rng.integers(0, 5000, n_out) * 97
    return [g(n_in), t(rows_in.astype(np.int32)), g(n_out), t(rows_out.astype(np.int32)),
            g(n_x), t(rows_x.astype(np.int32))]


@pytest.mark.parametrize("kind", ["hs_theta", "all_equal", "all_equal_cold", "all_dead", "empty",
                                  "wide_ids"])
@pytest.mark.parametrize("dim,hot", [(64, K3_HOT), (50, K3_HOT), (64, 16)])
def test_k3_model_matches_plain(kind, dim, hot):
    """Any list (all ids equal, below or past the hot arrays, all dead,
    empty, ids far apart; D = 50 the kernel's 4-byte path) gives the plain
    version's sums; hot 16 sends most ids straight to their accumulators."""
    rng = np.random.default_rng(dim + hot)
    lists = _k3_lists(kind, rng, dim)
    n_acc = max(5000 * 97, 300_000) if kind == "wide_ids" else 5000
    acc0 = rng.random((2, n_acc)).astype(np.float32)
    want = [torch.from_numpy(a.copy()) for a in acc0]
    sg.adagrad_accumulate_plain(*want, *lists)
    got = [torch.from_numpy(a.copy()) for a in acc0]
    stats = {}
    k3_model(*got, *lists, hot=hot, stats=stats)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)
    n_live = sum(int((r >= 0).sum()) for r in lists[1::2])
    if kind == "all_equal":  # one add an accumulator a block
        n_blocks = -(-sum(len(r) for r in lists[1::2]) // k3_rows_a_block(dim))
        assert stats["direct"] == 0 and n_blocks <= stats["flushed"] <= n_blocks + 1
    if kind == "all_equal_cold":  # no hot array: every row added at once
        assert stats["flushed"] == 0 and stats["direct"] == n_live
    if kind in ("all_dead", "empty"):
        assert stats["flushed"] + stats["direct"] == 0
    if kind == "hs_theta" and hot == K3_HOT:  # the top nodes combined
        assert stats["flushed"] < 0.9 * n_live
    if kind == "wide_ids":
        assert stats["direct"] > 0
    assert stats["flushed"] + stats["direct"] <= n_live


@pytest.mark.parametrize("objective", ["hs", "cbow_hs"])
def test_k3_model_step_matches_jax(jax_case, objective):
    """K3's model in the HS step (the plain grads and K4), against JAX's
    accumulators and tables; the CBOW-HS step, whose K10 emits each
    gradient row's squares, through K3's squares mode instead."""
    if objective == "hs":
        got, loss = _port_step(jax_case, objective, hs.hs_grads_plain, k3_model)
    else:
        got, loss = _port_step(jax_case, objective, cbow.cbow_hs_grads_plain,
                               sg.adagrad_accumulate_squares_plain)
    want = jax_case["hs" if objective == "hs" else "cbow"]
    np.testing.assert_allclose(loss, float(want[4]),
                               rtol=LOSS_RTOL if objective == "hs" else CBOW_HS_LOSS_RTOL)
    _assert_increments(got, want[:4], jax_case["state"], ("emb_in", "theta", "acc_in",
                                                          "acc_theta"))
