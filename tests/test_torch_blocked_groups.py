"""A numpy model of K5's lane grouping (csrc/blocked_common.cuh), held to
node2vec_torch's plain blocked walk and, through it, to node2vec_tpu's.

K5 serves a walker with an 8-lane group: lane r holds light columns 4r ..
4r + 3 and the columns [r C/8, (r+1) C/8) of a heavy block and adds its
columns in order from 0; an 8-lane scan of the lane totals (Hillis-Steele,
as the shuffles run) gives each lane its exclusive prefix, and the CDF at a
column is that prefix plus the lane's partial sum there; a row's total is
the butterfly of the lane totals.  The model makes those float32 operations in
that order.  Where every partial sum is exact (weights in {0.5, 1, 2}, p and
q powers of two) its proposals, prefixes and walks are bit-equal to
``blocked_walk_chunk_plain``'s, which are JAX's; with general weights its
walks hold the transition chi-square (p-value > 1e-4).  The kernel itself
runs only on the card (chip_smoke.py: check_blocked_walk)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from node2vec_tpu.walk import blocked as ref_blocked
from node2vec_torch import convert
from node2vec_torch.eval import walk_transition_pvalue
from node2vec_torch.graph import from_edge_arrays
from node2vec_torch.ops.hashrng import hash_uniform
from node2vec_torch.ops.sampling import prefix_sums
from node2vec_torch.walk import blocked

G = 8  # lanes a walker
LANE = np.arange(G)
F32 = np.float32
PAD = int(blocked.PAD_ID)


def _incl_scan(v):
    """The 8-lane inclusive scan of blocked_common.cuh:group_incl_scan."""
    v = v.astype(F32)
    for off in (1, 2, 4):
        u = np.zeros_like(v)
        u[..., off:] = v[..., :-off]
        v = np.where(LANE >= off, v + u, v).astype(F32)
    return v


def _group_sum(v):
    """The butterfly of blocked_common.cuh:group_sum (every lane the same bits)."""
    for off in (4, 2, 1):
        v = (v + v[..., LANE ^ off]).astype(F32)
    return v[..., 0]


def group_cdf(w):
    """The CDFs of the rows of ``w`` [n, 8k] in K5's form and their totals:
    lane r owns columns [r k, (r+1) k); L, its columns' partial sums in
    order from 0; ex, the 8-lane exclusive scan of the lanes' totals; the CDF
    at a column ex + L (blocked_common.cuh)."""
    n, cols = w.shape
    k = cols // G
    wl = w.astype(F32).reshape(n, G, k)
    part = np.empty_like(wl)
    lsum = np.zeros((n, G), F32)
    for j in range(k):
        lsum = (lsum + wl[:, :, j]).astype(F32)
        part[:, :, j] = lsum
    ex = np.zeros((n, G), F32)
    ex[:, 1:] = _incl_scan(lsum)[:, :-1]
    cdf = (ex[:, :, None] + part).astype(F32)
    return cdf.reshape(n, cols), _group_sum(lsum)


def _f32(bits):
    return np.ascontiguousarray(bits, dtype=np.int32).view(F32)


def _take(a, idx):
    return np.take_along_axis(a, np.clip(idx, 0, a.shape[1] - 1)[:, None], 1)[:, 0]


def model_rows(light, p_l, has_heavy, cur):
    """Decode the frontier rows as K5 does at entry: heavy flag, degree,
    total weight and the light CDF (K5's order)."""
    rows = light[cur]
    ids = rows[:, :p_l]
    w32 = np.zeros((len(cur), 4 * G), F32)
    w32[:, :p_l] = _f32(rows[:, p_l:2 * p_l])
    cdf, wtot_l = group_cdf(w32)
    real = (ids != PAD) & ((ids >= 0) if has_heavy else True)
    heavy = has_heavy & (rows[:, 0] < -1)
    degree = np.where(heavy, rows[:, 4], real.sum(1))
    wtot = np.where(heavy, _f32(rows[:, 3]), wtot_l).astype(F32)
    return rows, heavy, degree, wtot, cdf[:, :p_l]


def model_propose(light, biw, brp, p_l, c, has_heavy, cur, target):
    """K5's proposal at ``cur`` for ``target``: (cand, w, ppfx, rev±, pfx,
    slot in N(cur)), light rows by the light scan, heavy vertices by the
    header's block pick and the block scan."""
    maxb = (4 * p_l - 5) // 2
    rows, heavy, degree, _, cdf = model_rows(light, p_l, has_heavy, cur)
    slot = np.minimum((cdf < target[:, None]).sum(1), np.maximum(degree - 1, 0))
    cand = _take(rows[:, :p_l], slot)
    w = _f32(_take(rows[:, p_l:2 * p_l], slot))
    ppfx = np.where(slot > 0, _take(cdf, slot - 1), F32(0)).astype(F32)
    rev = _take(rows[:, 2 * p_l:3 * p_l], slot)
    pfx = _f32(_take(rows[:, 3 * p_l:4 * p_l], slot))
    if has_heavy and heavy.any():
        h = np.flatnonzero(heavy)
        hr = rows[h]
        h_cum = _f32(hr[:, 5 + maxb:5 + 2 * maxb])
        blk = np.minimum((h_cum < target[h, None]).sum(1), np.maximum(hr[:, 2] - 1, 0))
        base = np.where(blk > 0, _take(h_cum, blk - 1), F32(0)).astype(F32)
        resid = (target[h] - base).astype(F32)
        brow = hr[:, 1].astype(np.int64) + blk
        cdf_b, _ = group_cdf(_f32(biw[brow, c:]))
        nvalid = np.minimum(c, hr[:, 4] - blk * c)
        sb = np.minimum((cdf_b < resid[:, None]).sum(1), np.maximum(nvalid - 1, 0))
        pc = np.where(sb > 0, _take(cdf_b, sb - 1), F32(0)).astype(F32)
        cand[h] = _take(biw[brow, :c], sb)
        w[h] = _f32(_take(biw[brow, c:], sb))
        ppfx[h] = (base + pc).astype(F32)
        gslot = brow * c + sb
        pair = brp.reshape(-1, 2)[gslot]
        rev[h] = pair[:, 0]
        pfx[h] = _f32(pair[:, 1])
        slot[h] = blk * c + sb
    return cand, w, ppfx, rev, pfx, slot


def model_walk(bg, starts, gid_base, seed, *, walk_length, return_param, inout_param,
               max_trials):
    """K5's walk (modes 0-2) on the numpy model: the plain version's loop with
    K5's proposals.  Returns (paths, n_fallback, n_attempts)."""
    light, biw, bids, brp = (t.numpy() for t in bg[:4])
    p_l, c, has_heavy = bg.light_width, bg.block_width, bg.has_heavy
    maxb = (4 * p_l - 5) // 2
    n, el = len(starts), walk_length
    inv_p, inv_q = F32(1.0 / return_param), F32(1.0 / inout_param)
    alpha_hi = F32(max(1.0, 1.0 / inout_param))
    uniform = return_param == 1.0 and inout_param == 1.0
    gids = torch.arange(gid_base, gid_base + n, dtype=torch.int64)
    alive = starts >= 0
    paths = np.full((n, el + 1), -1, np.int32)
    paths[:, 0] = np.where(alive, starts, -1)
    t = np.zeros(n, np.int64)
    cur = np.where(alive, starts, 0)
    prev = np.full(n, -1, np.int32)
    w_fwd, fwd_pfx, w_back, back_pfx = (np.zeros(n, F32) for _ in range(4))
    back_shared = np.zeros(n, bool)
    prev_mem = np.full((n, light.shape[1]), PAD, np.int32)
    trials = np.zeros(n, np.int64)
    att = np.zeros(n, np.int64)
    n_fb = 0
    for _ in range(el * (max_trials + 2)):
        if not alive.any():
            break
        rows, _, degree, wtot, _ = model_rows(light, p_l, has_heavy, cur)
        alive &= degree != 0  # sink death (the degree of an entered row)
        ctr = torch.from_numpy(att * 4)
        u_branch, u_prop, u_acc = (hash_uniform(seed, gids, ctr + k).numpy() for k in range(3))
        if uniform:
            take_back = np.zeros(n, bool)
            target = (u_prop * wtot).astype(F32)
        else:
            alpha2 = np.where(back_shared, alpha_hi, inv_q).astype(F32)
            m1 = (w_back * inv_p).astype(F32)
            rest = np.maximum(wtot - w_back, F32(0)).astype(F32)
            m2 = (rest * alpha2).astype(F32)
            take_back = u_branch < (m1 / np.maximum(m1 + m2, F32(1e-30))).astype(F32)
            u2 = (u_prop * rest).astype(F32)
            target = np.where(u2 < back_pfx, u2, u2 + w_back).astype(F32)
        cand, w_cand, ppfx, rev, pfx, _ = model_propose(light, biw, brp, p_l, c, has_heavy,
                                                        cur, target)
        first = t == 0
        if uniform:
            accept = np.ones(n, bool)
        elif inout_param == 1.0:
            accept = take_back | first | (cand != prev)
        else:
            shared = (prev_mem[:, :p_l] == cand[:, None]).any(1)
            heavy_prev = has_heavy & (prev_mem[:, 0] < -1)
            jm = (prev_mem[:, 5:5 + maxb] <= cand[:, None]).sum(1) - 1
            jm = np.minimum(np.maximum(jm, 0), np.maximum(prev_mem[:, 2] - 1, 0))
            mrow = bids[np.where(heavy_prev, prev_mem[:, 1].astype(np.int64) + jm, 0)]
            shared = np.where(heavy_prev, (mrow == cand[:, None]).any(1), shared)
            bias2 = np.where(shared, F32(1), inv_q)
            accept = take_back | first | ((cand != prev) & ((u_acc * alpha2).astype(F32) <= bias2))
        trials = np.where(accept, 0, trials + 1)
        force = alive & (trials >= max_trials)
        n_fb += int((force & ~accept).sum())
        adv = alive & (accept | force)
        take = take_back & ~force
        nxt = np.where(take, prev, cand)
        paths[np.flatnonzero(adv), t[adv] + 1] = nxt[adv]
        if not uniform:
            nw_back = np.where(take, w_fwd, _f32(rev & int(blocked.MAG)))
            nb_pfx = np.where(take, fwd_pfx, pfx)
            nb_shared = np.where(take, back_shared, rev < 0)
            w_fwd = np.where(adv, np.where(take, w_back, w_cand), w_fwd).astype(F32)
            fwd_pfx = np.where(adv, np.where(take, back_pfx, ppfx), fwd_pfx).astype(F32)
            w_back = np.where(adv, nw_back, w_back).astype(F32)
            back_pfx = np.where(adv, nb_pfx, back_pfx).astype(F32)
            back_shared = np.where(adv, nb_shared, back_shared)
        prev_mem = np.where(adv[:, None], rows, prev_mem)
        prev = np.where(adv, cur, prev).astype(np.int32)
        cur = np.where(adv, nxt, cur)
        t = np.where(adv, t + 1, t)
        trials = np.where(adv, 0, trials)
        att += alive
        alive &= t < el
    return paths, n_fb, int(att.sum())


def _dyadic_heavy(seed=0, n=500):
    """A directed graph with weights {0.5, 1, 2}: hubs of degree 300, 520 and
    700 (several blocks at C = 64 and 256), light vertices of degree 1..40,
    reverse edges for half of the edges, and 15 sinks (chip_smoke.py's
    _dyadic_heavy_graph)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 41, n - 15)
    deg[:3] = (300, 520, 700)
    src = np.repeat(np.arange(n - 15), deg).astype(np.int32)
    dst = rng.integers(0, n, len(src)).astype(np.int32)
    back = rng.random(len(src)) < 0.5
    src, dst = np.concatenate([src, dst[back]]), np.concatenate([dst, src[back]])
    keep = src < n - 15
    w = rng.choice(F32([0.5, 1.0, 2.0]), int(keep.sum()))
    return from_edge_arrays(src[keep], dst[keep], w, n_vertices=n, directed=True)


def _hub_general(hub_deg=100, seed=3):
    """Hub 0 with ``hub_deg`` out/in edges, a ring over its neighbours and a
    far vertex the ring reaches, general weights (tests/test_torch_blocked.py)."""
    rng = np.random.default_rng(seed)
    nbrs = np.arange(1, hub_deg + 1, dtype=np.int32)
    far = np.int32(hub_deg + 1)
    src = np.concatenate([np.zeros(hub_deg, np.int32), nbrs, nbrs, nbrs % hub_deg + 1, nbrs,
                          [far]])
    dst = np.concatenate([nbrs, np.zeros(hub_deg, np.int32), nbrs % hub_deg + 1, nbrs,
                          np.full(hub_deg, far, np.int32), [1]])
    w = rng.uniform(0.5, 2.0, len(src)).astype(F32)
    return from_edge_arrays(src, dst, w, directed=True)


WIDTHS = {"P31_C256": (None, None), "P8_C64": (8, 64)}


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_group_proposals_equal_plain(widths):
    """Every vertex, 8 targets each across its total weight: the model's slot,
    candidate, weight and prefix equal the plain version's inverse CDFs
    (prefix_sums over the light row; the header's block CDF, then
    prefix_sums over the block), and its totals equal the rows' sums."""
    g = _dyadic_heavy()
    bg = blocked.build_blocked_graph(g.indptr, g.indices, g.weights, *WIDTHS[widths],
                                     device="cpu")
    light, biw, brp = bg.light.numpy(), bg.biw.numpy(), bg.brp.numpy()
    p_l, c, maxb = bg.light_width, bg.block_width, (4 * bg.light_width - 5) // 2
    deg = np.diff(g.indptr)
    cur = np.repeat(np.flatnonzero(deg > 0), 8)
    rows, heavy, degree, wtot, _ = model_rows(light, p_l, bg.has_heavy, cur)
    assert heavy.any() and (~heavy).any() and (degree == deg[cur]).all()
    u = np.random.default_rng(1).integers(0, 1 << 24, len(cur)) * F32(2.0 ** -24)
    target = (u.astype(F32) * wtot).astype(F32)
    cand, w, ppfx, _, _, slot = model_propose(light, biw, brp, p_l, c, bg.has_heavy, cur, target)

    # the plain version's ops (walk/blocked.py: blocked_walk_chunk_plain)
    t_rows = torch.from_numpy(rows)
    w_light = blocked._f32(t_rows[:, p_l:2 * p_l])
    torch.testing.assert_close(torch.from_numpy(wtot[~heavy]), w_light.sum(1)[~heavy],
                               rtol=0, atol=0)
    cdf_l = prefix_sums(w_light)
    tt = torch.from_numpy(target)
    want_slot = torch.minimum((cdf_l < tt[:, None]).sum(1), torch.from_numpy(degree) - 1)
    want_pp = torch.where(want_slot > 0, blocked._pick(cdf_l, want_slot - 1), torch.tensor(0.0))
    h_cum = blocked._f32(t_rows[:, 5 + maxb:5 + 2 * maxb])
    blk = torch.minimum((h_cum < tt[:, None]).sum(1), (t_rows[:, 2] - 1).clamp(min=0).long())
    base = torch.where(blk > 0, blocked._pick(h_cum, blk - 1), torch.tensor(0.0))
    brow = bg.biw[torch.where(torch.from_numpy(heavy), t_rows[:, 1].long() + blk, 0)]
    cdf_b = prefix_sums(blocked._f32(brow[:, c:]))
    nvalid = (brow[:, :c] != PAD).sum(1)
    sb = torch.minimum((cdf_b < (tt - base)[:, None]).sum(1), (nvalid - 1).clamp(min=0))
    hv = torch.from_numpy(heavy)
    want_slot = torch.where(hv, blk * c + sb, want_slot)
    want_pp = torch.where(hv, base + torch.where(sb > 0, blocked._pick(cdf_b, sb - 1),
                                                 torch.tensor(0.0)), want_pp)
    want_cand = torch.where(hv, blocked._pick(brow[:, :c], sb),
                            blocked._pick(t_rows[:, :p_l], want_slot))
    np.testing.assert_array_equal(slot, want_slot.numpy())
    np.testing.assert_array_equal(cand, want_cand.numpy())
    np.testing.assert_array_equal(ppfx, want_pp.numpy())
    assert (cand >= 0).all() and (w > 0).all()


@pytest.mark.parametrize("p,q,widths", [
    (0.25, 4.0, "P31_C256"),  # mode 2, the main path's setting
    (1.0, 1.0, "P8_C64"),     # mode 0
    (4.0, 1.0, "P8_C64"),     # mode 1
])
def test_model_walk_equals_plain(p, q, widths):
    g = _dyadic_heavy(1)
    bg = blocked.build_blocked_graph(g.indptr, g.indices, g.weights, *WIDTHS[widths],
                                     device="cpu")
    starts = (np.arange(1200) % g.n_vertices).astype(np.int32)
    starts[::17] = -1
    kw = dict(walk_length=12, return_param=p, inout_param=q, max_trials=64)
    got = model_walk(bg, starts, 29, 0xC0FFEE, **kw)
    want = blocked.blocked_walk_chunk_plain(
        *bg[:4], torch.from_numpy(starts), 29, 0xC0FFEE, light_width=bg.light_width,
        block_width=bg.block_width, has_heavy=bg.has_heavy, **kw)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    assert (got[1], got[2]) == (int(want[1]), int(want[2]))
    assert (got[0][:, -1] == -1).any() and np.isin(got[0][:, 1:], [0, 1, 2]).any()


def test_model_walk_equals_jax():
    """Through the plain walk, JAX's blocked_walk_chunk: the model's paths and
    counts at P = 8, C = 64, (p, q) = (0.25, 4) and a trial cap of 3."""
    g = _dyadic_heavy(2)
    bg_ref = ref_blocked.build_blocked_graph(g.indptr, g.indices, g.weights, 8, 64)
    bg = convert.blocked_graph_from_arrays(*(np.asarray(t) for t in bg_ref[:4]), 8, 64,
                                           bg_ref.has_heavy, device="cpu")
    starts = (np.arange(500) % g.n_vertices).astype(np.int32)
    kw = dict(walk_length=10, return_param=0.25, inout_param=4.0, max_trials=3)
    got = model_walk(bg, starts, 7, 99, **kw)
    want = ref_blocked.blocked_walk_chunk(
        *bg_ref[:4], ref_blocked.slq_or_dummy(bg_ref), jnp.asarray(starts),
        jnp.arange(7, 7 + len(starts), dtype=jnp.int32), jnp.uint32(99), shared_lists=False,
        light_width=8, block_width=64, has_heavy=bg_ref.has_heavy, **kw)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert (got[1], got[2]) == (int(want[1]), int(want[2])) and got[1] > 0


def test_model_walk_chi2_general_weights():
    """General weights: K5's float order samples the node2vec transition.  Hub
    0 spans two 64-wide blocks at P = 8; transitions out of it after (5, 0)
    (a heavy current vertex), and out of ring vertex 80 after (0, 80) (a
    heavy previous vertex)."""
    g = _hub_general()
    bg = blocked.build_blocked_graph(g.indptr, g.indices, g.weights, 8, 64, device="cpu")
    assert bg.has_heavy and int(bg.light[0, 2]) == 2
    p, q = 0.25, 4.0
    for prev, cur in ((5, 0), (0, 80)):
        starts = np.full(10000, prev, np.int32)
        walks, _, _ = model_walk(bg, starts, 0, 11, walk_length=2, return_param=p,
                                 inout_param=q, max_trials=64)
        pval = walk_transition_pvalue(g, walks, prev, cur, p, q)
        assert pval is not None and pval > 1e-4, (prev, cur, pval)


def test_launch_geometry():
    """The wrapper's account of K5's launch: modes, shared memory a block (one
    row buffer a walker, two where N(prev) is kept, and a lane buffer of C/4
    ints), walkers a block; bad shapes raise; the CPU path adds no kernel
    counts."""
    assert [blocked.blocked_walk_mode(*a) for a in (
        (1.0, 1.0), (0.25, 1.0), (0.25, 4.0), (0.25, 4.0, True), (0.25, 4.0, True, True),
        (0.25, 1.0, True, True))] == [0, 1, 2, 3, 4, 1]
    for c, mode, smem in ((256, 0, 25600), (256, 1, 25600), (256, 2, 43008), (256, 3, 43008),
                          (256, 4, 25600), (64, 2, 36864), (2048, 2, 100352)):
        geo = blocked.blocked_walk_geometry(c, mode, device="cpu")
        assert geo == {"walkers_per_block": 32, "smem_bytes": smem}, (c, mode)
    for c, mode in ((32, 0), (96, 2), (4096, 2), (256, 5), (256, -1)):
        with pytest.raises(ValueError):
            blocked.blocked_walk_geometry(c, mode)
    g = _dyadic_heavy()
    bg = blocked.build_blocked_graph(g.indptr, g.indices, g.weights, 8, 64, device="cpu")
    counts: dict = {}
    out = blocked.blocked_walk_chunk(*bg[:4], torch.arange(8, dtype=torch.int32), 0, 0,
                                     walk_length=3, return_param=1.0, inout_param=1.0,
                                     max_trials=4, light_width=8, block_width=64,
                                     has_heavy=True, kernel_counts=counts)
    assert counts == {} and out[0].shape == (8, 4)
