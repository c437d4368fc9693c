"""Numpy models of K12 ``csr_walk`` (csrc/csr_walk.cu) and K19's pack
(``route_pack``, csrc/route.cu) as the kernels compute them, held to the
port's plain versions and to the JAX package's functions.

K12: one thread a walker, every search the fixed bisection, whose answer
is read from its last probe (the entry that moved hi) where it finished
and loaded where search_iters cut it short; a membership search runs only
where its answer can change the acceptance (u * max(1, 1/q) between 1/q and
1).  Its positions must equal ``searchsorted_in_segments`` /
``contains_in_segments`` of both packages, and its walks (proposals in
order, the first accepted one winning, the round's last otherwise) the
plain version's and JAX ``walk_chunk``'s, bit for bit: weights in {0.5, 1,
2} and p, q powers of two (or q = 5) keep every float32 product exact.

K19's pack: one cooperative launch; two warps of each block zero the rows
no unique fills while the others each sum a range of the sorted requests
run by run (float32 adds in request order, each lane's squares of its
columns summed, one butterfly a run); a run that crosses ranges is finished, after
the grid barrier, by the warp where it begins, which adds the later ranges'
leads in range order, skipping those without a live request.  The model
writes every row once; its send buffer is within the smoke's tolerance
(rtol 1e-4 of the largest entry) of ``route_pack_plain`` and of JAX's
segment sums placed as ``_routed_apply`` places them, and is the same bits
for any two calls at one geometry.  The kernels themselves run only on the
card (chip_smoke.py: check_csr_walk, edge_cases_csr, check_route)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from node2vec_tpu.ops import sampling as ref_sampling
from node2vec_tpu.parallel import rowsharded_sgns as ref_rs
from node2vec_tpu.walk import engine as ref_engine
from node2vec_torch.graph import from_edge_arrays
from node2vec_torch.ops import sampling
from node2vec_torch.parallel import rowsharded_sgns as rs
from node2vec_torch.walk import csr

M32 = 0xFFFFFFFF
CSR_SETTINGS = [(0.25, 4.0), (1.0, 1.0), (1.0, 5.0), (4.0, 0.25)]
RTOL = 1e-4


# --------------------------------------------------------------------------- #
# K12: the search and the walk
# --------------------------------------------------------------------------- #

def row_search(data, seg: int, deg: int, v: int, n_iters: int):
    """(lower bound, member) as the kernel's lower_bound gives them: member
    from the last probe that moved hi where the bisection finished."""
    end, lo, hi, at_hi = seg + deg, seg, seg + deg, None
    for _ in range(n_iters):
        if lo >= hi:
            break
        mid = lo + ((hi - lo) >> 1)
        x = int(data[mid])
        if x < v:
            lo = mid + 1
        else:
            hi, at_hi = mid, x
    if lo < hi:  # cut short: lo lies inside the row
        return lo, int(data[lo]) == v
    return lo, lo < end and at_hi == v


def _fmix(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def uniform(seed: int, gid: int, ctr: int) -> np.float32:
    """hashrng.cuh's hash_uniform."""
    h = _fmix((ctr * 0x9E3779B9 + seed) & M32)
    return np.float32(_fmix(((gid * 0x7FEB352D) & M32) ^ h) >> 8) * np.float32(2.0 ** -24)


def walk_model(dg, starts, gid_base: int, seed: int, *, walk_length: int, p: float, q: float,
               max_trials: int, search_iters: int) -> np.ndarray:
    """K12 walker by walker, step by step, its proposals in order."""
    indptr, indices, weights, alias, prob, wtot = (t.numpy() for t in dg)
    f32 = np.float32
    inv_p, inv_q, a2 = f32(1.0 / p), f32(1.0 / q), f32(max(1.0, 1.0 / q))
    uniform_bias = p == 1.0 and q == 1.0
    kb, n_rounds = csr.proposal_rounds(p, q, max_trials)
    paths = np.full((len(starts), walk_length + 1), -1, np.int32)
    for w, start in enumerate(starts):
        gid = (gid_base + w) & M32
        paths[w, 0] = start if start >= 0 else -1
        if start < 0:
            continue
        cur, prev, att = int(start), -1, 0
        p_seg = p_deg = 0
        for t in range(walk_length):
            seg = int(indptr[cur])
            deg = int(indptr[cur + 1]) - seg
            if deg <= 0:
                break
            biased = not uniform_bias and prev >= 0
            m1 = f32(0.0)
            only_back = False
            if biased:
                pos, member = row_search(indices, seg, deg, prev, search_iters)
                m1 = (weights[pos] if member else f32(0.0)) * inv_p
                only_back = member and deg == 1
            p_branch1 = m1 / max(m1 + wtot[cur] * a2, f32(1e-30))
            nxt = prev
            if not only_back:
                for _ in range(n_rounds):
                    accepted = False
                    for k in range(kb):
                        ctr = ((att + k) * 4) & M32
                        slot = min(int(uniform(seed, gid, ctr) * f32(deg)), deg - 1)
                        e = seg + slot
                        j = slot if uniform(seed, gid, ctr + 1) < prob[e] else int(alias[e])
                        proposal = int(indices[seg + j])
                        accept = True
                        if biased:
                            if uniform(seed, gid, ctr + 2) < p_branch1:
                                proposal = prev
                            elif proposal == prev:
                                accept = False
                            else:
                                u = uniform(seed, gid, ctr + 3) * a2
                                in_q, in_1 = u <= inv_q, u <= f32(1.0)
                                # a search only where membership decides
                                shared = in_q != in_1 and row_search(
                                    indices, p_seg, p_deg, proposal, search_iters)[1]
                                accept = in_1 if shared else in_q
                        nxt = proposal
                        if accept:
                            accepted = True
                            break
                    att += kb
                    if accepted:
                        break
            paths[w, t + 1] = nxt
            p_seg, p_deg, prev, cur = seg, deg, cur, nxt
    return paths


def _hub_graph(seed=0, n=160, directed=True):
    """Weights in {0.5, 1, 2}; hub rows of about 150, 65, 64, 63, 17, 16,
    9, 8 and 7 neighbours, edges back to the hubs, vertices >= n - 8 sinks
    (directed)."""
    rng = np.random.default_rng(seed)
    src = [rng.integers(0, n - 8, 700)]
    dst = [rng.integers(0, n, 700)]
    for hub, deg in ((0, 150), (1, 65), (2, 64), (3, 63), (4, 17), (5, 16), (6, 9), (7, 8),
                     (8, 7)):
        nb = rng.choice(np.arange(9, n), deg, replace=False)
        src += [np.full(len(nb), hub), nb[: len(nb) // 2]]
        dst += [nb, np.full(len(nb) // 2, hub)]
    src, dst = np.concatenate(src).astype(np.int32), np.concatenate(dst).astype(np.int32)
    keep = (src != dst) & (src < n - 8)
    w = rng.choice(np.float32([0.5, 1.0, 2.0]), int(keep.sum()))
    return from_edge_arrays(src[keep], dst[keep], w, n_vertices=n, directed=directed)


def _rows_with_repeats(seed=3):
    """Sorted rows (ids repeated in some) of degree 0, 1, 7, 8, 9, 16, 17,
    63, 64, 65, 300 and 700, as one CSR: (indptr, data)."""
    rng = np.random.default_rng(seed)
    rows = []
    for deg in (0, 1, 7, 8, 9, 16, 17, 63, 64, 65, 300, 700):
        row = np.sort(rng.integers(0, 3 * deg + 5, deg))
        if deg > 20:
            row[deg // 3: deg // 3 + 5] = row[deg // 3]  # a run of one id
        rows.append(np.sort(row))
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
    return indptr, np.concatenate(rows).astype(np.int32)


@pytest.mark.parametrize("n_iters", [None, 1, 3, 7])
def test_k12_search_positions_equal_segment_searches(n_iters):
    indptr, data = _rows_with_repeats()
    deg = np.diff(indptr)
    iters = csr.search_iters(int(deg.max())) if n_iters is None else n_iters
    values, starts, lengths = [], [], []
    for r in range(len(deg)):
        row = data[indptr[r]:indptr[r + 1]]
        vs = np.unique(np.concatenate([row, row + 1, row - 1, [-1, 3 * deg[r] + 9]]))
        values += list(vs)
        starts += [indptr[r]] * len(vs)
        lengths += [deg[r]] * len(vs)
    values, starts, lengths = (np.asarray(x, np.int32) for x in (values, starts, lengths))
    got = np.array([row_search(data, int(s), int(n), int(v), iters)
                    for v, s, n in zip(values, starts, lengths)], dtype=np.int64)
    t = [torch.from_numpy(x) for x in (values, starts, lengths, data)]
    pos = sampling.searchsorted_in_segments(*t, iters).numpy()
    mem = sampling.contains_in_segments(*t, iters).numpy()
    j = [jnp.asarray(x) for x in (values, starts, lengths, data)]
    ref_pos = np.asarray(ref_sampling.searchsorted_in_segments(*j, iters))
    ref_mem = np.asarray(ref_sampling.contains_in_segments(*j, iters))
    np.testing.assert_array_equal(pos, ref_pos)
    np.testing.assert_array_equal(mem, ref_mem)
    np.testing.assert_array_equal(got[:, 0], pos)
    np.testing.assert_array_equal(got[:, 1].astype(bool), mem)
    if n_iters is None:  # complete: the first occurrence of every id present
        present = got[:, 1].astype(bool)
        assert present.any() and (data[got[present, 0]] == values[present]).all()
        assert (got[present, 0] == starts[present] + np.array(
            [np.searchsorted(data[s:s + n], v) for v, s, n in
             zip(values[present], starts[present], lengths[present])])).all()


@pytest.mark.parametrize("p,q", CSR_SETTINGS)
def test_k12_walks_equal_plain_and_jax(p, q):
    g = _hub_graph()
    starts = np.tile(np.arange(g.n_vertices, dtype=np.int32), 2)
    starts[::13] = -1
    deg = np.diff(g.indptr)
    assert deg.max() > 64
    gid_base, seed, iters = 11, 0xC0FFEE, csr.search_iters(int(deg.max()))
    kw = dict(walk_length=12, max_trials=64, search_iters=iters)
    dg = g.to_device("cpu")
    got = walk_model(dg, starts, gid_base, seed, p=p, q=q, **kw)
    plain = csr.csr_walk_chunk_plain(*dg, torch.from_numpy(starts), gid_base, seed,
                                     return_param=p, inout_param=q, **kw).numpy()
    rg = [jnp.asarray(t.numpy()) for t in dg]
    ref = np.asarray(ref_engine.walk_chunk(
        *rg, jnp.asarray(starts), jnp.arange(gid_base, gid_base + len(starts), dtype=jnp.int32),
        jnp.uint32(seed), return_param=p, inout_param=q, **kw))
    np.testing.assert_array_equal(plain, ref)
    np.testing.assert_array_equal(got, plain)
    hubs = np.isin(got[:, :-1], np.nonzero(deg > 64)[0])
    assert hubs.sum() > 20  # the walks step from long rows


def test_k12_walks_at_truncated_search_iters():
    g = _hub_graph(seed=5, directed=False)
    starts = np.arange(g.n_vertices, dtype=np.int32)
    dg = g.to_device("cpu")
    for iters in (1, 3, 6):
        kw = dict(walk_length=8, max_trials=64, search_iters=iters)
        got = walk_model(dg, starts, 0, 7, p=0.25, q=4.0, **kw)
        want = csr.csr_walk_chunk_plain(*dg, torch.from_numpy(starts), 0, 7, return_param=0.25,
                                        inout_param=4.0, **kw).numpy()
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# K19's pack
# --------------------------------------------------------------------------- #

def warp_sum(v: np.ndarray) -> np.float32:
    """The butterfly over 32 lanes (__shfl_xor 16, 8, 4, 2, 1), lane 0's."""
    v = v.astype(np.float32).copy()
    for off in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ off]).astype(np.float32)
    return v[0]


def lane_squares(row: np.ndarray, sq: np.ndarray) -> np.ndarray:
    """Each lane's running sum of its columns' squares (l + 32 c, c in
    order), one fma a column."""
    for c0 in range(0, row.shape[0], 32):
        v = row[c0:c0 + 32].astype(np.float64)
        sq[:len(v)] = (v * v + sq[:len(v)].astype(np.float64)).astype(np.float32)
    return sq


def pack_model(plan, n_dev, cap, g_a, live_a, g_b=None, live_b=None, *, warps: int):
    """The send buffer [N * cap, D + 1] as pack_kernel writes it with
    ``warps`` summing warps, and how many times each row was written."""
    order, inv, owner, rank, ok, send_ids = (np.asarray(getattr(plan, f)) for f in (
        "order", "inv", "owner", "bucket_pos", "ok", "send_ids"))
    g = g_a if g_b is None else np.concatenate([g_a, g_b])
    live = np.ones(len(g), bool)
    if live_a is not None:
        live[:len(g_a)] = live_a >= 0
    if g_b is not None and live_b is not None:
        live[len(g_a):] = live_b >= 0
    r, dim = len(order), g.shape[1]
    n_rows = n_dev * cap
    send = np.full((n_rows, dim + 1), np.nan, np.float32)
    writes = np.zeros(n_rows, np.int64)
    empty = send_ids.reshape(-1) < 0
    send[empty] = 0.0
    writes[empty] += 1
    chunks = -(-r // 32)
    per_warp = 32 * -(-chunks // warps)
    u_of = inv[order]  # the unique of each sorted request

    def run_sums(js):
        """(column sums, lane squares, live count) over sorted positions js, in order."""
        acc = np.zeros(dim, np.float32)
        sq = np.zeros(32, np.float32)
        n_live = 0
        for j in js:
            p = order[j]
            if ok[inv[p]] and live[p]:
                acc = (acc + g[p]).astype(np.float32)
                sq = lane_squares(g[p], sq)
                n_live += 1
        return acc, sq, n_live

    def store(u, acc, sq_total):
        if ok[u]:
            row = owner[u] * cap + rank[u]
            send[row, :dim] = acc
            send[row, dim] = np.float32(sq_total / np.float32(dim))
            writes[row] += 1

    leads = {}  # warp -> (sums, squares, live, passes through)
    tails = {}  # warp -> (u, sums, lane squares)
    for w in range(warps):
        lo, hi = w * per_warp, min((w + 1) * per_warp, r)
        if lo >= hi:
            continue
        bounds = [lo] + [j for j in range(lo + 1, hi) if u_of[j] != u_of[j - 1]] + [hi]
        for a, b in zip(bounds[:-1], bounds[1:]):
            u = u_of[a]
            began_before = a == lo and lo > 0 and u_of[lo - 1] == u
            goes_on = b == hi and hi < r and u_of[hi] == u
            acc, sq, n_live = run_sums(range(a, b))
            if began_before:
                leads[w] = (acc, warp_sum(sq), n_live, goes_on)
            elif goes_on:
                tails[w] = (u, acc, sq)
            else:
                store(u, acc, warp_sum(sq))
    for w, (u, acc, sq) in tails.items():  # after the grid barrier
        sq_total = warp_sum(sq)
        g2 = w + 1
        while True:
            l_acc, l_sq, l_live, through = leads[g2]
            if l_live > 0:
                acc = (acc + l_acc).astype(np.float32)
                sq_total = np.float32(sq_total + l_sq)
            if not through:
                break
            g2 += 1
        store(u, acc, sq_total)
    return send, writes


def _jax_send(ids, n_dev, cap, g, live):
    """JAX's segment sums (rowsharded_sgns.py:355-381) placed into the
    [N, cap, D + 1] send buffer as _routed_apply places them."""
    plan = jax.jit(ref_rs._plan_routes, static_argnums=(1, 2))(jnp.asarray(ids), n_dev, cap)
    w = jnp.asarray(live.astype(np.float32))
    gj = jnp.asarray(g)
    sq = jnp.mean(gj * gj, axis=-1) * w
    r = ids.shape[0]
    gu = jnp.zeros((r, g.shape[1]), jnp.float32).at[plan.inv].add(gj * w[:, None])
    squ = jnp.zeros((r,), jnp.float32).at[plan.inv].add(sq)
    payload = jnp.where(plan.ok[:, None], jnp.concatenate([gu, squ[:, None]], axis=1), 0.0)
    send = jnp.zeros((n_dev, cap, g.shape[1] + 1), jnp.float32).at[
        plan.owner.clip(0, n_dev - 1), plan.bucket_pos.clip(0, cap - 1)].add(payload,
                                                                             mode="drop")
    return np.asarray(send).reshape(n_dev * cap, -1)


def _close_to_largest(got, want):
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert float(np.abs(got - want).max()) <= RTOL * scale


def _requests(kind: str, seed: int = 0):
    """(ids, g_a, live_a, g_b, live_b): SGNS's output requests (walk rows
    with dead positions, then negatives that always count), or HS's tail
    entries (most ask for row 0, nearly all of those dead)."""
    rng = np.random.default_rng(seed)
    dim = 40
    if kind == "sgns":
        walks = rng.integers(0, 300, 1500).astype(np.int32)
        walks[rng.random(1500) < 0.15] = -1
        neg = rng.integers(0, 300, 64).astype(np.int32)
        ids = np.concatenate([np.where(walks >= 0, walks, 0), neg])
        return ids, rng.normal(0, 1, (1500, dim)).astype(np.float32), walks, \
            rng.normal(0, 1, (64, dim)).astype(np.float32), None
    rows = rng.integers(1, 200, 3000).astype(np.int32)
    dead = rng.random(3000) < 0.55
    rows[dead] = 0
    live = np.where(dead & (rng.random(3000) < 0.98), -1, rows)  # a few live row-0 entries
    return rows, rng.normal(0, 1, (3000, dim)).astype(np.float32), live, None, None


@pytest.mark.parametrize("kind,n_dev,cap", [("sgns", 1, None), ("sgns", 2, None),
                                            ("sgns", 4, 64), ("hs", 1, None), ("hs", 2, 40)])
@pytest.mark.parametrize("warps", [5, 96])
def test_k19_pack_model_equals_plain_and_jax(kind, n_dev, cap, warps):
    ids, g_a, live_a, g_b, live_b = _requests(kind)
    cap = cap or rs.row_cap(len(ids), n_dev)
    plan = rs.plan_routes_plain(torch.from_numpy(ids), n_dev, cap)
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    want = rs.route_pack_plain(plan, n_dev, cap, t(g_a), t(live_a), t(g_b), t(live_b)).numpy()
    got, writes = pack_model(plan, n_dev, cap, g_a, live_a, g_b, live_b, warps=warps)
    assert (writes == 1).all()  # every row written once
    _close_to_largest(got, want)
    filled = np.asarray(plan.send_ids).reshape(-1) >= 0
    assert (got[~filled] == 0).all() and (want[~filled] == 0).all()
    g = g_a if g_b is None else np.concatenate([g_a, g_b])
    live = np.ones(len(g), bool)
    live[:len(g_a)] = live_a >= 0
    _close_to_largest(got, _jax_send(ids, n_dev, cap, g, live))
    again, _ = pack_model(plan, n_dev, cap, g_a, live_a, g_b, live_b, warps=warps)
    np.testing.assert_array_equal(again, got)  # one fixed order: the same bits
    if cap < rs.row_cap(len(ids), n_dev):
        assert int(plan.n_dropped) > 0  # rows dropped at capacity


def test_k19_pack_one_unique_across_many_ranges():
    """HS's row 0: one unique's requests span most ranges; its few live
    ones are added in range order, the rest skipped."""
    ids, g_a, live_a, _, _ = _requests("hs", seed=4)
    plan = rs.plan_routes_plain(torch.from_numpy(ids), 1, rs.row_cap(len(ids), 1))
    cap = rs.row_cap(len(ids), 1)
    got, writes = pack_model(plan, 1, cap, g_a, live_a, warps=90)
    want = rs.route_pack_plain(plan, 1, cap, torch.from_numpy(g_a),
                               torch.from_numpy(live_a)).numpy()
    zero_run = int((ids == 0).sum())
    assert zero_run > 32 * 20  # the run crosses many 32-request ranges
    assert (writes == 1).all()
    _close_to_largest(got, want)


@pytest.mark.parametrize("case", ["dead requests, live_b None", "every row filled",
                                  "no row filled"])
def test_k19_pack_edges(case):
    rng = np.random.default_rng(9)
    dim = 33
    n_dev, cap = 1, 64
    if case == "dead requests, live_b None":
        ids = rng.integers(0, 50, 400).astype(np.int32)
        live_a = np.where(rng.random(300) < 0.5, -1, 1).astype(np.int32)
        g_a, g_b = (rng.normal(0, 1, (n, dim)).astype(np.float32) for n in (300, 100))
        parts = (g_a, live_a, g_b, None)
    else:  # 128 uniques, 64 rows a bucket at N = 2
        ids = rng.permutation(128).astype(np.int32)
        n_dev = 2
        parts = (rng.normal(0, 1, (128, dim)).astype(np.float32), None, None, None)
    plan = rs.plan_routes_plain(torch.from_numpy(ids), n_dev, cap)
    if case == "no row filled":  # a plan whose every unique is dropped
        plan = plan._replace(ok=torch.zeros_like(plan.ok),
                             send_ids=torch.full_like(plan.send_ids, -1))
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    want = rs.route_pack_plain(plan, n_dev, cap, *(t(x) for x in parts)).numpy()
    got, writes = pack_model(plan, n_dev, cap, *parts, warps=7)
    assert (writes == 1).all()
    filled = int((np.asarray(plan.send_ids) >= 0).sum())
    assert filled == {"every row filled": n_dev * cap, "no row filled": 0}.get(case, filled)
    if case == "no row filled":
        assert (got == 0).all() and (want == 0).all()
    else:
        _close_to_largest(got, want)
