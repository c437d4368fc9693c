"""K10 ``cbow_hs_grads``'s layout and K4 ``adagrad_apply``'s combining on
the CPU (the kernels themselves run only on the card).

K10 sums the top H path levels of every trainable center per theta row
(the head, rows 0..K-1) and emits one row per occurrence for the levels
below (the tail), each gradient row beside its sum of squares; the CBOW-HS
step feeds the squares to K3's squares mode and the rows to K4.  Here:

* that layout, summed back per theta row, equals the per-occurrence
  gradients of the layout K10 emitted before (a numpy reference of it
  below), and its squares are the sum over occurrences of D * mean((g h)^2)
  at both ``cbow_mean`` settings, where the head is deep enough that the
  tail is not empty;
* the accumulators the step fills are the per-occurrence sums (JAX's
  row-wise Adagrad), not the mean square of a head row's summed gradient
  (skip-gram HS's head rule);
* the step through the plain versions against JAX's ``cbow_hs_step_impl``
  given its draws, on bf16-exact tables at the tolerances of
  ``tests/test_torch_cbow.py``, at D = 128 and at D = 512 with L1 = 81;
* a numpy model of K4's combining (a block's run of rows, T lanes a row,
  four rows a lane group, equal rows of a group summed before their one
  atomic) against ``adagrad_apply_plain`` on SGNS-, HS-, CBOW-HS- and
  pair-shaped lists and on one id repeated everywhere;
* the edge cases: all dead, no context, window >= L1, out-of-vocabulary
  positions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from node2vec_tpu.models import cbow as ref_cbow
from node2vec_torch.models import cbow
from node2vec_torch.models import hsoftmax as hs
from node2vec_torch.models import skipgram as sg

RTOL, ATOL = 1e-5, 1e-6  # fp32 on both sides, sums in another order
LOSS_RTOL = 1e-4  # the JAX CBOW-HS step rounds h to bf16 (tests/test_torch_cbow.py)
INC_TOL = 3e-2  # of an increment's max |.|, as tests/test_torch_cbow.py holds the step
K4_ROWS_A_GROUP = 4  # csrc/adagrad.cu: kUnroll


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _bf16_exact(x) -> np.ndarray:
    x = np.array(x, dtype=np.float32)
    x.view(np.uint32)[...] &= np.uint32(0xFFFF0000)
    return x


def _case(rng, n_vertices, n_walks, length, dim, window, bf16=False, oov=0.1):
    counts = rng.zipf(1.4, n_vertices) % 5000 + 1
    tree = hs.cap_code_length(hs.build_huffman(counts), counts)
    walks = rng.integers(0, n_vertices, (n_walks, length)).astype(np.int32)
    walks[rng.random((n_walks, length)) < 0.1] = -1
    mask = rng.random(n_vertices) >= oov
    f = _bf16_exact if bf16 else (lambda a: np.asarray(a, np.float32))
    state = [f(rng.normal(0, 0.3, (n_vertices, dim))), f(rng.normal(0, 0.3, (tree.n_inner, dim))),
             rng.random(n_vertices).astype(np.float32),
             rng.random(tree.n_inner).astype(np.float32)]
    b_sh = rng.integers(1, window + 1, walks.shape).astype(np.int32)
    return dict(tree=tree, walks=walks, mask=mask, state=state, b_sh=b_sh, window=window)


def occurrence_grads(c, cbow_mean):
    """numpy, per position and path entry: the layout K10 emitted before it
    combined the top levels.  (g_in [B*L1, D], g_theta [B*L1*CL, D],
    theta_rows [B*L1*CL] (-1 where masked), loss)."""
    emb_in, theta = c["state"][:2]
    walks, mask, b_sh, w, tree = c["walks"], c["mask"], c["b_sh"], c["window"], c["tree"]
    n_walks, length = walks.shape
    dim, cl = emb_in.shape[1], tree.points.shape[1]
    g_in = np.zeros((n_walks, length, dim), np.float64)
    g_th = np.zeros((n_walks, length, cl, dim), np.float64)
    rows = np.full((n_walks, length, cl), -1, np.int64)
    loss, n_ctr = 0.0, 0
    for b in range(n_walks):
        valid = [walks[b, i] >= 0 and mask[walks[b, i]] for i in range(length)]
        for i in range(length):
            ctx = [i + d for d in range(-w, w + 1) if d != 0 and 0 <= i + d < length
                   and valid[i] and valid[i + d] and abs(d) <= b_sh[b, i]]
            if not ctx:
                continue
            n_ctr += 1
            h = emb_in[walks[b, ctx]].astype(np.float64).sum(0)
            if cbow_mean:
                h /= len(ctx)
            v = walks[b, i]
            g_h = np.zeros(dim)
            for k in range(tree.lengths[v]):
                p, code = tree.points[v, k], tree.codes[v, k]
                logit = h @ theta[p]
                sgn = 1.0 - 2.0 * code
                loss -= -np.logaddexp(0.0, -sgn * logit)
                g = 1.0 / (1.0 + np.exp(-logit)) - (1.0 + sgn) / 2.0
                g_h += g * theta[p]
                g_th[b, i, k] = g * h
                rows[b, i, k] = p
            if cbow_mean:
                g_h /= len(ctx)
            for j in ctx:
                g_in[b, j] += g_h
    return (g_in.reshape(-1, dim), g_th.reshape(-1, dim), rows.reshape(-1),
            loss / max(n_ctr, 1))


def _plain(c, cbow_mean):
    tree = c["tree"]
    return cbow.cbow_hs_grads_plain(
        *(_t(a) for a in c["state"][:2]), _t(c["walks"]), _t(c["mask"]), _t(c["b_sh"]),
        _t(tree.points), _t(tree.codes), _t(tree.lengths), window=c["window"],
        cbow_mean=cbow_mean)


def _assert_layout_is_occurrences(c, cbow_mean):
    """K10's layout, summed back per theta row, against the per-occurrence
    reference; returns (H, K, live tail rows)."""
    g_in, sq_in, g_tail, sq_tail, rows, g_head, sq_head, loss = _plain(c, cbow_mean)
    ref_in, ref_th, ref_rows, ref_loss = occurrence_grads(c, cbow_mean)
    tree, dim = c["tree"], c["state"][0].shape[1]
    n_inner, cl = tree.n_inner, tree.points.shape[1]
    n_head, k_rows = cbow.cbow_hs_head(c["walks"].shape[1], dim, cl, n_inner)
    np.testing.assert_allclose(g_in.numpy(), ref_in, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sq_in.numpy(), (ref_in ** 2).sum(-1), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=RTOL)
    lvl = np.tile(np.arange(cl), ref_rows.size // cl)
    live = ref_rows >= 0
    head, tail = live & (lvl < n_head), lvl >= n_head
    # the tail: one row per occurrence, in place; -1 and zeros where masked
    np.testing.assert_array_equal(rows.numpy(), ref_rows[tail])
    np.testing.assert_allclose(g_tail.numpy(), ref_th[tail], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sq_tail.numpy(), (ref_th[tail] ** 2).sum(-1), rtol=RTOL,
                               atol=ATOL)
    # the head: every occurrence's gradient and square summed at its row
    want_g = np.zeros((k_rows, dim))
    np.add.at(want_g, ref_rows[head], ref_th[head])
    want_sq = np.zeros(k_rows)
    np.add.at(want_sq, ref_rows[head], (ref_th[head] ** 2).sum(-1))
    np.testing.assert_allclose(g_head.numpy(), want_g, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sq_head.numpy(), want_sq, rtol=RTOL, atol=ATOL)
    return n_head, k_rows, int((rows >= 0).sum())


@pytest.mark.parametrize("cbow_mean", [True, False])
def test_layout_sums_to_the_occurrences(cbow_mean):
    """At D = 128 the head is the top 8 levels (255 rows) and the tail
    holds the rest of a 3,000-vertex tree's paths."""
    c = _case(np.random.default_rng(1), 3000, 12, 21, 128, 5)
    n_head, k_rows, n_tail = _assert_layout_is_occurrences(c, cbow_mean)
    assert (n_head, k_rows) == (8, 255) and n_tail > 0


def test_accumulators_are_per_occurrence():
    """The step's accumulators gain every occurrence's own mean square
    (JAX's row-wise Adagrad), which the mean square of a head row's summed
    gradient is not."""
    c = _case(np.random.default_rng(2), 3000, 12, 21, 128, 5)
    acc_in, acc_th = (_t(a.copy()) for a in c["state"][2:])
    out = _plain(c, True)
    squares, _ = cbow.cbow_hs_lists(out, _t(c["walks"]))
    sg.adagrad_accumulate_squares_plain(acc_in, acc_th, *squares, 128)
    ref_in, ref_th, ref_rows, _ = occurrence_grads(c, True)
    want = c["state"][3].astype(np.float64).copy()
    live = ref_rows >= 0
    np.add.at(want, ref_rows[live], (ref_th[live] ** 2).mean(-1))
    np.testing.assert_allclose(acc_th.numpy(), want, rtol=RTOL, atol=ATOL)
    want_in = c["state"][2].astype(np.float64).copy()
    flat = c["walks"].reshape(-1)
    np.add.at(want_in, flat[flat >= 0], (ref_in[flat >= 0] ** 2).mean(-1))
    np.testing.assert_allclose(acc_in.numpy(), want_in, rtol=RTOL, atol=ATOL)
    # the root is on every trainable path: its share differs under the head rule
    g_root = out[5][0].numpy()
    head_rule = c["state"][3][0] + (g_root ** 2).mean()
    assert abs(head_rule - want[0]) > 1e3 * RTOL * want[0]


_ref_step = jax.jit(ref_cbow.cbow_hs_step_impl,
                    static_argnames=("window", "shrink_window", "cbow_mean", "packed"))


@pytest.mark.parametrize("shape", [(24, 21, 128, 5), (6, 81, 512, 10)])
def test_step_matches_jax(shape):
    n_walks, length, dim, window = shape
    c = _case(np.random.default_rng(3), 3000, n_walks, length, dim, window, bf16=True)
    tree = c["tree"]
    key = jax.random.PRNGKey(7)
    want = _ref_step(*(jnp.asarray(a) for a in c["state"]), jnp.asarray(c["walks"]), key, 0.1,
                     jnp.asarray(tree.points), jnp.asarray(tree.codes),
                     jnp.asarray(tree.lengths), jnp.asarray(c["mask"]), window=window,
                     shrink_window=True, cbow_mean=True)
    b_sh = np.array(jax.random.randint(key, (n_walks, length), 1, window + 1)).astype(np.int32)
    st = [_t(a.copy()) for a in c["state"]]
    loss = cbow.cbow_hs_step_plain(*st, _t(c["walks"]), _t(b_sh), 0.1, _t(tree.points),
                                   _t(tree.codes), _t(tree.lengths), _t(c["mask"]),
                                   window=window, cbow_mean=True)
    assert cbow.cbow_hs_head(length, dim, tree.points.shape[1], tree.n_inner)[0] > 0
    np.testing.assert_allclose(float(loss), float(want[4]), rtol=LOSS_RTOL)
    for name, g, w, i in zip(("emb_in", "theta", "acc_in", "acc_theta"), st, want[:4],
                             c["state"]):
        inc, ref_inc = g.numpy() - i, np.asarray(w) - i
        scale = float(np.abs(ref_inc).max())
        assert scale > 0, f"{name}: no update"
        assert float(np.abs(inc - ref_inc).max()) <= INC_TOL * scale, name


# --------------------------------------------------------------------------- #
# K4: equal rows of a lane group combined before the atomics
# --------------------------------------------------------------------------- #


def k4_model(emb_in, emb_out, acc_in, acc_out, g_in, rows_in, g_out, rows_out, g_extra,
             rows_extra, lr, stats):
    """csrc/adagrad.cu's K4 in numpy: the lists laid end to end, a block a
    run of 8 * (32 / T) * 4 rows, a lane group the four consecutive rows
    base + 4 * side + u; a row equal to an earlier one of its group (same table,
    same id) adds into it, and each remaining live row adds g * (-lr *
    rsqrt(acc + 1e-12)) to its table row (one atomic a piece)."""
    dim = g_in.shape[1]
    pieces = dim // 4 if dim % 4 == 0 else dim
    t = 1
    while t < pieces and t < 32:
        t *= 2
    sides = 32 // t
    lists = [(0, g_in, rows_in), (1, g_out, rows_out), (1, g_extra, rows_extra)]
    flat = [(tab, g[r], int(rows[r])) for tab, g, rows in lists for r in range(len(rows))]
    tables, accs = (emb_in, emb_out), (acc_in, acc_out)
    scale = [None if v < 0 else np.float32(-lr) / np.sqrt(accs[tab][v] + np.float32(1e-12))
             for tab, _, v in flat]
    per_warp = sides * K4_ROWS_A_GROUP
    for w0 in range(0, len(flat), per_warp):
        for side in range(sides):
            group = [w0 + K4_ROWS_A_GROUP * side + u for u in range(K4_ROWS_A_GROUP)]
            group = [r for r in group if r < len(flat) and flat[r][2] >= 0]
            sums = {}
            for r in group:
                key = flat[r][0], flat[r][2]
                sums[key] = sums.get(key, 0) + flat[r][1].astype(np.float32)
            for (tab, v), g in sums.items():
                r = next(r for r in group if flat[r][:3:2] == (tab, v))
                tables[tab][v] += (g * scale[r]).astype(np.float32)
                stats[tab] += 1  # rows that take atomics, by table


def _k4_lists(kind, rng, dim):
    n_in, n_out, n_x = 700, 1500, 64
    rows_in = rng.integers(-1, 300, n_in)
    rows_out = rng.integers(-1, 300, n_out)
    rows_x = rng.integers(0, 300, n_x)
    if kind == "hs":  # BFS theta rows, the head once each
        lv = rng.integers(9, 14, n_out)
        rows_out = np.where(rng.random(n_out) < 0.2, -1, (2 ** lv - 1) + rng.integers(0, 2 ** lv))
        rows_x = np.arange(n_x)
    elif kind == "cbow_hs_occurrences":  # every path from the root, a level a row
        lv = np.tile(np.arange(15), n_out // 15 + 1)[:n_out]
        rows_out = (2 ** lv - 1) + rng.integers(0, 2 ** lv)
        rows_in = np.arange(n_in) % 300  # no two equal in a lane group
        n_x = 0
    elif kind == "pairs":  # a center 2w times in a row
        rows_in = np.repeat(rng.integers(0, 300, n_in // 10), 10)[:n_in]
    elif kind == "one_id":
        rows_in, rows_out, rows_x = np.full(n_in, 5), np.full(n_out, 5), np.full(n_x, 5)
    n_table = max(int(np.max(rows_out, initial=0)), 300) + 1
    g = [rng.normal(0, 0.3, (n, dim)).astype(np.float32) for n in (n_in, n_out, n_x)]
    return g, [a.astype(np.int32) for a in (rows_in, rows_out, rows_x[:n_x])], n_table


def test_k4_model_matches_plain():
    """SGNS-, HS-, CBOW-HS- and pair-shaped lists and one id everywhere, at
    D = 128 (16-byte pieces, 32 lanes a row), D = 50 (4-byte, 32 lanes) and
    D = 8 (16-byte, 2 lanes, 16 rows side by side): the model gives the
    plain version's tables; equal rows of a lane group take one atomic."""
    for kind in ("sgns", "hs", "cbow_hs_occurrences", "pairs", "one_id"):
        for dim in (128, 50, 8):
            rng = np.random.default_rng(dim)
            g, rows, n_table = _k4_lists(kind, rng, dim)
            tabs = [rng.normal(0, 1, (300, dim)).astype(np.float32),
                    rng.normal(0, 1, (n_table, dim)).astype(np.float32)]
            accs = [rng.random(300).astype(np.float32) + 0.5,
                    rng.random(n_table).astype(np.float32) + 0.5]
            lists = [x for pair in zip(g, rows) for x in pair]
            want = [_t(a.copy()) for a in tabs]
            sg.adagrad_apply_plain(*want, *(_t(a) for a in accs), *(_t(a) for a in lists), 0.05)
            got = [a.copy() for a in tabs]
            stats = [0, 0]
            k4_model(*got, *accs, *lists, 0.05, stats)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b.numpy(), rtol=RTOL, atol=ATOL,
                                           err_msg=f"{kind}, D = {dim}")
            live_in = int((rows[0] >= 0).sum())
            live_out = sum(int((r >= 0).sum()) for r in rows[1:])
            assert stats[0] <= live_in and stats[1] <= live_out
            if kind in ("pairs", "one_id"):  # a center's run: one atomic a lane group
                assert stats[0] <= live_in / 2, (kind, dim, stats)
            if kind == "cbow_hs_occurrences":  # a path's levels are distinct rows
                assert stats == [live_in, live_out]


# --------------------------------------------------------------------------- #
# edge cases
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", ["all_dead", "no_context", "window_ge_l1", "oov"])
def test_edge_cases(case):
    rng = np.random.default_rng(4)
    length, window, oov = (4, 5, 0.1) if case == "window_ge_l1" else (21, 5, 0.1)
    if case == "oov":
        oov = 0.6
    c = _case(rng, 3000, 10, length, 128, window, oov=oov)
    if case == "all_dead":
        c["walks"][:] = -1
    if case == "no_context":  # live positions between dead ones at window 1
        c["walks"][:, 1::2] = -1
        c["window"] = 1
        c["b_sh"][:] = 1
    for cbow_mean in (True, False):
        _, _, n_tail = _assert_layout_is_occurrences(c, cbow_mean)
        out = _plain(c, cbow_mean)
        if case in ("all_dead", "no_context"):
            assert float(out[-1]) == 0.0 and n_tail == 0
            assert all(float(x.abs().sum()) == 0 for x in out[:7] if x.dtype != torch.int32)
        else:
            assert n_tail > 0
