"""Numpy models of K9's and K13's tiled decompositions (csrc/cbow.cu,
csrc/sgns_pairs.cu) against the plain versions and the JAX steps, on the CPU.

The CUDA kernels cannot run here, so their arithmetic is modelled as they
cut the work, on K2's walk-group machinery (csrc/tf32_tiles.cuh): walk
groups of G = 64 // L1 walks padded to an M-tile of Mt rows, the rows of
dead positions and of a ragged last group's missing walks zero-filled, D in
chunks of KC columns streamed twice, per-block d_no and loss partials summed
at the end, and every tensor-core product 3xTF32 (``mma3`` of
tests/test_torch_sgns_tiles.py: hi rounded to TF32, lo read as its top 19
bits, lo.hi + hi.lo + hi.hi in float32).

K9: the group's band matrix A (A[i, j] = 1 where j is a context of i in the
same walk) gives the context sums H_c = A . X_in_c, summed on the CUDA cores
in the JAX order of offsets and divided by cnt under cbow_mean; pass 1 sums
the positive logits' partial dots and NL = H_c . NO_c^T over the chunks;
pass 2 remakes H_c, writes d_out = g_pos * H_c, makes G_h = Gneg . NO_c +
g_pos * X_out_c (/ cnt) and d_no += Gneg^T . H_c, then g_in = A^T . G_h.

K13: K2's pass 1 (NL, and PL in the 16 x 8 tiles that meet the band); the
elementwise phase reads each valid lane's logit PL[i, i + d]; pass 2 makes
GN_c = Gneg . NO_c and d_no += (mult * Gneg)^T . X_in_c, and the store phase
writes the group's lane rows in the JAX lane order (walk, offset, position):
d_ci = g_pos * X_out[i + d] + GN[i], d_co = g_pos * X_in[i], zero on
invalid lanes.

Each model is held to ``cbow_grads_plain`` / ``sgns_pair_grads_plain`` at
rtol 1e-5 (atol 1e-6; d_no, a sum over the batch, to rtol of its largest
entry) on N(0, 0.1) tables, the valid-lane count exactly, and, through the
plain Adagrad given the same draws, to JAX's ``cbow_walk_step_impl`` and
``sgns_train_step_impl`` (tables, accumulators and loss at rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from node2vec_tpu.models import cbow as ref_cbow
from node2vec_tpu.models import skipgram as ref_sg
from node2vec_tpu.ops.alias import build_alias_csr
from node2vec_torch import _build
from node2vec_torch.convert import from_reference_state, to_reference_state
from node2vec_torch.models import cbow
from node2vec_torch.models import skipgram as sg
from test_torch_sgns_tiles import (ATOL, GROUP_ROWS, RTOL, SCALE, _log_sigmoid, _round_up,
                                   _sigmoid, mma3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMEM_OPTIN = 232448  # an H100's shared memory per block


def _stride8(n):
    return n + (40 - n % 32) % 32


def smem_bytes(kernel, length, dim, n_neg, window, kc, keep_h=False):
    """Bytes a block of K9 (H kept from pass 1, or a chunk's H_c) or K13
    carves (cbow.cu / sgns_pairs.cu smem_bytes, with tf32_tiles.cuh's
    make_geo and common_floats)."""
    g = 1 if length >= GROUP_ROWS else GROUP_ROWS // length
    mt, sp, dp = _round_up(g * length, 16), _round_up(n_neg, 16), _round_up(dim, kc)
    ldn, ldx, ldg, ldb, ldc = dp + 4, kc + 4, _stride8(sp), _stride8(mt), _stride8(kc)
    common = 2 * sp * ldn + 2 * 2 * mt * ldx + 3 * 16 + 4
    if kernel == "k9":
        floats = common + mt * (ldg + (ldn if keep_h else ldx) + ldc) + 10 * mt
    else:
        w2 = 2 * window
        floats = common + 2 * mt * ldg + mt * max(ldb, ldc) + mt * (2 + w2 + 1 + w2)
    return 4 * floats


def pick_smem(kernel, length, dim, n_neg, window):
    """(bytes, chunk width, H kept): chunks of 64 columns where they fit the
    card's shared memory, else 32 (tf32_tiles.cuh pick_geo); K9 keeps H
    where it fits at that width (cbow.cu pick_geo)."""
    kc = 64 if dim > 32 and smem_bytes(kernel, length, dim, n_neg, window, 64) <= SMEM_OPTIN else 32
    keep = kernel == "k9" and smem_bytes(kernel, length, dim, n_neg, window, kc, True) <= SMEM_OPTIN
    return smem_bytes(kernel, length, dim, n_neg, window, kc, keep), kc, keep


@pytest.mark.parametrize("kernel,shape,want,mode,keep", [
    ("k9", (21, 128, 64, 5), 210_640, "shared", True),
    ("k9", (65, 128, 64, 5), 225_872, "shared", False),
    ("k9", (21, 256, 64, 5), 210_640, "shared", False),
    ("k9", (81, 256, 64, 10), 249_296, "global", False),
    ("k9", (21, 600, 64, 5), 390_864, "global", False),
    ("k9", (21, 50, 64, 3), 161_488, "shared", True),
    ("k13", (21, 128, 64, 5), 198_608, "shared", False),
    ("k13", (65, 128, 64, 5), 200_592, "shared", False),
    ("k13", (21, 256, 64, 5), 231_376, "shared", False),
    ("k13", (81, 256, 64, 10), 300_368, "global", False),
    ("k13", (21, 600, 64, 5), 411_600, "global", False),
    ("k13", (21, 128, 64, 1), 194_512, "shared", False)])
def test_geometry(kernel, shape, want, mode, keep):
    """The carve at the shapes chip_smoke.py's k9_build / k13_build and
    edge-case lines report from the C entries on the card: the main paths'
    (L1 21, D 128) and one walk a group at L1 65 stage in shared memory, the
    wide shape (L1 81, D 256, w 10) and D 600 in a global workspace; K9
    keeps H from pass 1 only where all of it fits (not at L1 65 nor at
    D 256, which stays in shared memory by remaking it), and K13 at D 256
    fits, as the parent's one-walk design did."""
    got, _, kept = pick_smem(kernel, *shape)
    assert (got, kept) == (want, keep)
    assert _build.staging_mode(got, SMEM_OPTIN) == mode


def _offsets(w):
    return [d for d in range(-w, w + 1) if d != 0]  # the JAX order


def _geometry(n_walks, length, dim, n_neg, kc):
    g = 1 if length >= GROUP_ROWS else GROUP_ROWS // length
    mt = _round_up(g * length, 16)
    sp = _round_up(n_neg, 16)
    dp = _round_up(dim, kc)
    return g, mt, sp, dp, dp // kc, -(-n_walks // g)


def _group(grp, g, length, n_walks, mt, dp, dim, walks_flat, emb_in, emb_out):
    """A group's rows, first flat position and [Mt, Dp] gathered X_in and
    X_out (zeros on dead positions, missing walks and columns past D)."""
    rows = min(g, n_walks - grp * g) * length
    row0 = grp * g * length
    ids = np.full(mt, -1)
    ids[:rows] = walks_flat[row0:row0 + rows]
    x_in = np.zeros((mt, dp), np.float32)
    x_out = np.zeros((mt, dp), np.float32)
    live = ids >= 0
    x_in[live, :dim] = emb_in[ids[live]]
    x_out[live, :dim] = emb_out[ids[live]]
    return rows, row0, ids, x_in, x_out


def band_matrix(valid, bsh, length, window):
    """The group's [Mt, Mt] context matrix: A[i, j] = 1 where j = i + d is a
    context of i (same walk, both valid, 1 <= |d| <= min(bsh[i], w))."""
    mt = len(valid)
    r = np.arange(mt)
    d = r[None, :] - r[:, None]
    same = (r[:, None] // length == r[None, :] // length)
    return (valid[:, None] & valid[None, :] & same & (d != 0)
            & (np.abs(d) <= np.minimum(bsh, window)[:, None]))


def _band_sum(a, x, window, transpose=False):
    """A . x (or A^T . x), summed row by row over the offsets in the JAX
    order, in float32, as the kernel's CUDA-core loops add them."""
    mt = a.shape[0]
    out = np.zeros_like(x)
    for d in _offsets(window):
        r = np.arange(mt)
        c = r + d if not transpose else r - d
        ok = (c >= 0) & (c < mt)
        sel = np.zeros(mt, bool)
        sel[ok] = a[r[ok], c[ok]] if not transpose else a[c[ok], r[ok]]
        out[sel] += x[c[sel]]
    return out


def tiled_cbow(emb_in, emb_out, walks, vocab_mask, b_sh, neg_ids, *, window, negatives,
               cbow_mean, kc=64, grid=2):
    """K9's decomposition in cbow_grads_plain's signature (torch in, torch
    out)."""
    e_in, e_out, no_rows = emb_in.numpy(), emb_out.numpy(), emb_out.numpy()[neg_ids.numpy()]
    w_np = walks.numpy()
    n_walks, length = w_np.shape
    dim, s = e_in.shape[1], no_rows.shape[0]
    g, mt, sp, dp, nc, n_groups = _geometry(n_walks, length, dim, s, kc)
    flat = w_np.reshape(-1)
    valid_flat = (flat >= 0) & vocab_mask.numpy()[np.where(flat >= 0, flat, 0)]
    bsh_flat = b_sh.numpy().reshape(-1)
    no = np.zeros((sp, dp), np.float32)
    no[:s, :dim] = no_rows
    neg_scale = np.float32(negatives / s)
    g_in = np.full((n_walks * length, dim), np.nan, np.float32)  # every row must be written
    d_out = np.full_like(g_in, np.nan)
    dno_parts = np.zeros((grid, sp, dp), np.float32)
    loss_parts = np.zeros((grid, 3), np.float32)
    for blk in range(grid):
        for grp in range(blk, n_groups, grid):
            rows, row0, _, x_in, x_out = _group(grp, g, length, n_walks, mt, dp, dim, flat,
                                                e_in, e_out)
            valid = np.zeros(mt, bool)
            valid[:rows] = valid_flat[row0:row0 + rows]
            bsh = np.zeros(mt, np.int64)
            bsh[:rows] = bsh_flat[row0:row0 + rows]
            a = band_matrix(valid, bsh, length, window)
            cnt = a.sum(1).astype(np.float32)
            div = np.maximum(cnt, 1)[:, None] if cbow_mean else np.float32(1)
            wc = valid & (cnt > 0)

            def h_chunk(c):
                h = _band_sum(a, x_in[:, c * kc:(c + 1) * kc], window)
                return h / div if cbow_mean else h

            nl = np.zeros((mt, sp), np.float32)
            pl = np.zeros(mt, np.float32)
            for c in range(nc):  # pass 1
                h = h_chunk(c)
                pl += np.sum(h * x_out[:, c * kc:(c + 1) * kc], axis=1, dtype=np.float32)
                nl += mma3(h, no[:, c * kc:(c + 1) * kc].T)
            live = wc[:, None] & (np.arange(sp)[None, :] < s)
            gneg = np.where(live, _sigmoid(nl) * neg_scale, np.float32(0))
            gpos = np.where(wc, _sigmoid(pl) - np.float32(1), np.float32(0))
            loss_parts[blk] += (np.sum(np.where(wc, _log_sigmoid(pl), 0), dtype=np.float32),
                                np.sum(np.where(live, _log_sigmoid(-nl), 0), dtype=np.float32),
                                wc.sum())
            k_live = min(mt, _round_up(rows, 8))
            for c in range(nc):  # pass 2
                cols = slice(c * kc, (c + 1) * kc)
                h = h_chunk(c)
                gh = mma3(gneg, no[:, cols]) + gpos[:, None] * x_out[:, cols]
                if cbow_mean:
                    gh = gh / div
                dno_parts[blk][:, cols] += mma3(gneg[:k_live].T, h[:k_live])
                gi = _band_sum(a, gh, window, transpose=True)
                hi = min(dim, (c + 1) * kc) - c * kc
                d_out[row0:row0 + rows, c * kc:c * kc + hi] = (gpos[:, None] * h)[:rows, :hi]
                g_in[row0:row0 + rows, c * kc:c * kc + hi] = gi[:rows, :hi]
    pos, neg, ctr = loss_parts.sum(0)
    loss = -(pos + neg_scale * neg) / max(ctr, np.float32(1))
    return (torch.from_numpy(g_in), torch.from_numpy(d_out),
            torch.from_numpy(dno_parts.sum(0)[:s, :dim]), torch.tensor(loss, dtype=torch.float32))


def tiled_pairs(emb_in, emb_out, walks, centers, contexts, neg_ids, *, window, negatives,
                kc=64, grid=2):
    """K13's gradient launch in sgns_pair_grads_plain's signature (torch in,
    torch out); ``contexts`` is unused, as by the kernel (a lane's rows are
    its walk's)."""
    e_in, e_out, no_rows = emb_in.numpy(), emb_out.numpy(), emb_out.numpy()[neg_ids.numpy()]
    w_np = walks.numpy()
    n_walks, length = w_np.shape
    dim, s, w, w2 = e_in.shape[1], no_rows.shape[0], window, 2 * window
    g, mt, sp, dp, nc, n_groups = _geometry(n_walks, length, dim, s, kc)
    flat = w_np.reshape(-1)
    cen_all = centers.numpy()
    no = np.zeros((sp, dp), np.float32)
    no[:s, :dim] = no_rows
    neg_scale = np.float32(negatives / s)
    n_lanes = n_walks * w2 * length
    d_ci = np.full((n_lanes, dim), np.nan, np.float32)
    d_co = np.full_like(d_ci, np.nan)
    dno_parts = np.zeros((grid, sp, dp), np.float32)
    loss_parts = np.zeros((grid, 3), np.float32)
    tile_on = np.zeros((mt, mt), bool)  # PL's 16 x 8 tiles that meet the band
    for m0 in range(0, mt, 16):
        j0, j1 = max(0, m0 - w) // 8, min(mt - 1, m0 + 15 + w) // 8
        tile_on[m0:m0 + 16, 8 * j0:8 * (j1 + 1)] = True
    offs = np.array(_offsets(w))
    for blk in range(grid):
        for grp in range(blk, n_groups, grid):
            rows, row0, _, x_in, x_out = _group(grp, g, length, n_walks, mt, dp, dim, flat,
                                                e_in, e_out)
            lane0 = row0 * w2
            # the group's lanes in lane order, lane lr = (walk q, offset o, position i)
            lr = np.arange(rows * w2)
            q, o, i = lr // (w2 * length), (lr // length) % w2, lr % length
            r = q * length + i
            live = cen_all[lane0:lane0 + rows * w2] >= 0
            assert np.all((r + offs[o])[live] >= 0) and np.all((r + offs[o])[live] < rows)
            mult = np.zeros(mt, np.float32)
            np.add.at(mult, r[live], 1)

            nl = np.zeros((mt, sp), np.float32)
            pl = np.zeros((mt, mt), np.float32)
            for c in range(nc):  # pass 1: K2's
                cols = slice(c * kc, (c + 1) * kc)
                nl += mma3(x_in[:, cols], no[:, cols].T)
                pl += np.where(tile_on, mma3(x_in[:, cols], x_out[:, cols].T), np.float32(0))
            has = (mult[:, None] > 0) & (np.arange(sp)[None, :] < s)
            gneg = np.where(has, _sigmoid(nl) * neg_scale, np.float32(0))
            gm = gneg * mult[:, None]
            c_lane = r + offs[o]
            assert tile_on[r[live], c_lane[live]].all()
            pl_lane = np.where(live, pl[r, np.clip(c_lane, 0, mt - 1)], np.float32(0))
            gpos = np.where(live, _sigmoid(pl_lane) - np.float32(1), np.float32(0))
            loss_parts[blk] += (np.sum(np.where(live, _log_sigmoid(pl_lane), 0), dtype=np.float32),
                                np.sum(np.where(has, _log_sigmoid(-nl), 0) * mult[:, None],
                                       dtype=np.float32),
                                mult.sum())
            k_live = min(mt, _round_up(rows, 8))
            for c in range(nc):  # pass 2, then the store phase
                cols = slice(c * kc, (c + 1) * kc)
                gn = mma3(gneg, no[:, cols])
                dno_parts[blk][:, cols] += mma3(gm[:k_live].T, x_in[:k_live, cols])
                ci = np.where(live[:, None], gpos[:, None] * x_out[np.clip(c_lane, 0, mt - 1), cols]
                              + gn[r], np.float32(0))
                co = np.where(live[:, None], gpos[:, None] * x_in[r, cols], np.float32(0))
                hi = min(dim, (c + 1) * kc) - c * kc
                d_ci[lane0:lane0 + rows * w2, c * kc:c * kc + hi] = ci[:, :hi]
                d_co[lane0:lane0 + rows * w2, c * kc:c * kc + hi] = co[:, :hi]
    pos, neg, pairs = loss_parts.sum(0)
    loss = -(pos + neg_scale * neg) / max(pairs, np.float32(1))
    return (torch.from_numpy(d_ci), torch.from_numpy(d_co),
            torch.from_numpy(dno_parts.sum(0)[:s, :dim]), torch.tensor(loss, dtype=torch.float32),
            torch.tensor(pairs, dtype=torch.float32))


def _inputs(n_vertices, n_walks, length, dim, window, n_neg, seed, dead_walk=None):
    rng = np.random.default_rng(seed)
    emb_in = rng.normal(0, SCALE, (n_vertices, dim)).astype(np.float32)
    emb_out = rng.normal(0, SCALE, (n_vertices, dim)).astype(np.float32)
    walks = rng.integers(0, n_vertices, (n_walks, length)).astype(np.int32)
    ends = rng.integers(length // 2, length + 1, n_walks)
    walks[np.arange(length)[None, :] >= ends[:, None]] = -1
    if dead_walk is not None:
        walks[dead_walk] = -1
    mask = rng.random(n_vertices) > 0.15
    b_sh = rng.integers(1, window + 1, (n_walks, length)).astype(np.int32)
    neg = rng.integers(0, n_vertices, n_neg).astype(np.int32)
    return [torch.from_numpy(x) for x in (emb_in, emb_out, walks, mask, b_sh, neg)]


def _assert_close(got, want, names):
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if name == "d_no":
            err, scale = np.abs(a - b).max(initial=0), np.abs(b).max(initial=0)
            assert err <= RTOL * scale + ATOL, (name, err, scale)
        elif name == "pairs":
            assert float(a) == float(b), (name, a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


# the tiling's cases: (L1, D, w, KC, B, grid) -- groups of 3 walks at L1 = 21
# with a ragged last one, 5 at L1 = 11, one walk a group at L1 = 64, 65 and
# 81 (M-tiles of 64, 80 and 96 rows), D = 100 and 600 past a whole number
# of chunks, KC = 32 where the wide shapes take it, more blocks than groups
CASES = [(21, 128, 5, 64, 7, 2), (11, 100, 5, 64, 11, 2), (64, 64, 5, 64, 3, 2),
         (65, 64, 5, 64, 3, 2), (81, 256, 10, 32, 2, 2), (21, 600, 5, 64, 4, 2),
         (21, 64, 3, 32, 2, 5)]
CASE_IDS = [f"L{c[0]}-D{c[1]}-w{c[2]}-kc{c[3]}-B{c[4]}-grid{c[5]}" for c in CASES]


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def case(request):
    length, dim, window, kc, n_walks, grid = request.param
    args = _inputs(300, n_walks, length, dim, window, 64, seed=length * dim + window,
                   dead_walk=n_walks // 2)
    return dict(args=args, window=window, kc=kc, grid=grid)


def test_band_matrix_is_the_plain_context_window():
    """A's rows count each center's contexts as ``context_mean`` does, and
    A . X / cnt is its h."""
    args = _inputs(120, 6, 21, 32, 5, 64, seed=2)
    emb_in, _, walks, mask, b_sh, _ = args
    w_np = walks.numpy()
    safe = np.where(w_np >= 0, w_np, 0)
    valid = (w_np >= 0) & mask.numpy()[safe]
    h, cnt, _ = cbow.context_mean(emb_in[torch.from_numpy(safe).long()],
                                  torch.from_numpy(valid), b_sh, 5, True)
    a = band_matrix(valid.reshape(-1), b_sh.numpy().reshape(-1), 21, 5)
    np.testing.assert_array_equal(a.sum(1), cnt.numpy().reshape(-1))
    x = np.where(valid.reshape(-1)[:, None], emb_in.numpy()[safe.reshape(-1)], 0)
    hm = (a.astype(np.float32) @ x) / np.maximum(a.sum(1), 1)[:, None]
    np.testing.assert_allclose(hm, h.numpy().reshape(-1, 32), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_band_sum(a, x, 5), a.astype(np.float32) @ x, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(_band_sum(a, x, 5, transpose=True),
                               a.T.astype(np.float32) @ x, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cbow_mean", [True, False])
def test_cbow_model_matches_plain(case, cbow_mean):
    kw = dict(window=case["window"], negatives=5, cbow_mean=cbow_mean)
    want = cbow.cbow_grads_plain(*case["args"], **kw)
    got = tiled_cbow(*case["args"], **kw, kc=case["kc"], grid=case["grid"])
    _assert_close(got, want, ("g_in", "d_out", "d_no", "loss"))


def test_pair_model_matches_plain(case):
    emb_in, emb_out, walks, mask, b_sh, neg = case["args"]
    w = case["window"]
    centers, contexts = sg.pair_lists_plain(walks, b_sh, mask, w)
    want = sg.sgns_pair_grads_plain(emb_in, emb_out, walks, centers, contexts, neg, window=w,
                                    negatives=5)
    got = tiled_pairs(emb_in, emb_out, walks, centers, contexts, neg, window=w, negatives=5,
                      kc=case["kc"], grid=case["grid"])
    _assert_close(got, want, ("d_ci", "d_co", "d_no", "loss", "pairs"))


@pytest.mark.parametrize("kind", ["all_dead", "all_out_of_vocabulary", "no_context"])
def test_models_with_nothing_to_train(kind):
    """Batches with no trainable center and no valid lane: every output
    zero, written whole, and a zero loss."""
    emb_in, emb_out, walks, mask, b_sh, neg = _inputs(80, 7, 21, 100, 5, 64, seed=4)
    if kind == "all_dead":
        walks[:] = -1
    elif kind == "all_out_of_vocabulary":
        mask[:] = False
    else:  # live positions between dead ones, window 1: no center has a context
        walks[:, 1::2] = -1
        b_sh[:] = 1
    for cbow_mean in (True, False):
        got = tiled_cbow(emb_in, emb_out, walks, mask, b_sh, neg, window=5, negatives=5,
                         cbow_mean=cbow_mean)
        assert not got[0].any() and not got[1].any() and not got[2].any()
        assert float(got[3]) == 0
    window = 1 if kind == "no_context" else 5
    centers, contexts = sg.pair_lists_plain(walks, b_sh, mask, window)
    got = tiled_pairs(emb_in, emb_out, walks, centers, contexts, neg, window=window,
                      negatives=5)
    assert float(got[4]) == 0 and not got[0].any() and not got[1].any() and not got[2].any()


def test_pair_store_phase_is_the_jax_lane_order():
    """The store phase's lane row lr of a group is (walk, offset, position)
    = (lr // (2w L1), lr // L1 % 2w, lr % L1), the flat lane of make_pairs:
    the model's rows at each lane are the lane's own center and context
    rows, scaled by its g_pos."""
    emb_in, emb_out, walks, mask, b_sh, neg = _inputs(200, 5, 9, 16, 3, 16, seed=8)
    centers, contexts = sg.pair_lists_plain(walks, b_sh, mask, 3)
    d_ci, d_co, *_ = tiled_pairs(emb_in, emb_out, walks, centers, contexts, neg, window=3,
                                 negatives=5)
    live = (centers >= 0).numpy()
    ci = emb_in.numpy()[centers.numpy()[live]]
    co = emb_out.numpy()[contexts.numpy()[live]]
    scale = d_co.numpy()[live] / ci  # g_pos of each lane, the same across the row
    np.testing.assert_allclose(scale, scale[:, :1].repeat(16, 1), rtol=1e-4)
    assert (scale < 0).all()  # sigmoid - 1
    assert not d_ci.numpy()[~live].any() and not d_co.numpy()[~live].any()
    gn = d_ci.numpy()[live] - scale[:, :1] * co  # GN of the lane's center, a row per center
    lane_center = (np.arange(len(live)) // (6 * 9)) * 9 + np.arange(len(live)) % 9
    for c in np.unique(lane_center[live]):
        rows = gn[lane_center[live] == c]
        np.testing.assert_allclose(rows, rows[:1].repeat(len(rows), 0), rtol=1e-4, atol=1e-6)


# one compile per static configuration instead of one per primitive
_ref_cbow_step = jax.jit(ref_cbow.cbow_walk_step_impl, static_argnames=(
    "window", "negatives", "shared_negatives", "shrink_window", "cbow_mean"))
_ref_pair_step = jax.jit(ref_sg.sgns_train_step_impl, static_argnames=(
    "window", "negatives", "shared_negatives", "shrink_window"))


def _jax_draws(key, n_walks, length, window, n_neg, shape):
    k_neg1, k_neg2, k_shrink = jax.random.split(key, 3)
    b_sh = jax.random.randint(k_shrink, shape, 1, window + 1).astype(jnp.int32)
    return (torch.from_numpy(np.array(b_sh)),
            torch.from_numpy(np.array(jax.random.uniform(k_neg1, (n_neg,)))),
            torch.from_numpy(np.array(jax.random.uniform(k_neg2, (n_neg,)))))


def _step_batch(length, dim, seed):
    n_vertices = 60
    rng = np.random.default_rng(seed)
    n_walks = 2 * (GROUP_ROWS // length) + 1  # a ragged last group
    walks = rng.integers(0, n_vertices, (n_walks, length)).astype(np.int32)
    ends = rng.integers(3, length + 1, n_walks)
    walks[np.arange(length)[None, :] >= ends[:, None]] = -1
    mask = rng.random(n_vertices) > 0.1
    tables = (rng.normal(0, 0.3, (n_vertices, dim)).astype(np.float32),
              rng.normal(0, 0.3, (n_vertices, dim)).astype(np.float32),
              rng.random(n_vertices).astype(np.float32),
              rng.random(n_vertices).astype(np.float32))
    alias, prob = build_alias_csr(np.array([0, n_vertices]),
                                  rng.random(n_vertices).astype(np.float32) + 0.1)
    return walks, mask, tables, alias, prob


@pytest.mark.parametrize("length,dim,cbow_mean", [(11, 64, True), (21, 100, False)])
def test_cbow_model_step_matches_jax(length, dim, cbow_mean):
    """One CBOW-NS step, the model's grads through the plain Adagrad, against
    JAX's ``cbow_walk_step_impl`` given the same draws."""
    walks, mask, tables, alias, prob = _step_batch(length, dim, seed=length + dim)
    window, n_neg, negatives, lr = 5, 64, 5, np.float32(0.1)
    key = jax.random.PRNGKey(length * dim)
    want = _ref_cbow_step(
        *(jnp.asarray(t) for t in tables), jnp.asarray(walks), key, jnp.float32(lr),
        jnp.asarray(alias), jnp.asarray(prob), jnp.asarray(mask), window=window,
        negatives=negatives, shared_negatives=n_neg, shrink_window=True, cbow_mean=cbow_mean)
    b_sh, r1, r2 = _jax_draws(key, *walks.shape, window, n_neg, walks.shape)
    state = from_reference_state(*tables, device="cpu")

    def grads(*args, **kw):
        return tiled_cbow(*args, **kw, cbow_mean=cbow_mean)

    loss = sg._step(grads, sg.adagrad_accumulate_plain, sg.adagrad_apply_plain, *state,
                    torch.from_numpy(walks), b_sh, r1, r2, float(lr), torch.from_numpy(alias),
                    torch.from_numpy(prob), torch.from_numpy(mask), window, negatives)
    for name, a, b in zip(("emb_in", "emb_out", "acc_in", "acc_out", "loss"),
                          (*to_reference_state(*state), loss.numpy()), want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("length,dim", [(11, 64), (21, 100)])
def test_pair_model_step_matches_jax(length, dim):
    """One pair-based SGNS step, the model's grads through the plain Adagrad,
    against JAX's ``sgns_train_step_impl`` given the same draws."""
    walks, mask, tables, alias, prob = _step_batch(length, dim, seed=3 * length + dim)
    window, n_neg, negatives, lr = 5, 64, 5, np.float32(0.05)
    key = jax.random.PRNGKey(length + dim)
    want = _ref_pair_step(
        *(jnp.asarray(t) for t in tables), jnp.asarray(walks), key, jnp.float32(lr),
        jnp.asarray(alias), jnp.asarray(prob), jnp.asarray(mask), window=window,
        negatives=negatives, shared_negatives=n_neg, shrink_window=True)
    n_walks = walks.shape[0]
    b, r1, r2 = _jax_draws(key, n_walks, length, window, n_neg, (n_walks, 1, length))
    state = from_reference_state(*tables, device="cpu")
    pairs = torch.zeros((), dtype=torch.int64)
    loss = sg._pair_step(sg.pair_lists_plain, tiled_pairs, sg.adagrad_accumulate_plain,
                         sg.adagrad_apply_plain, *state, torch.from_numpy(walks), b, r1, r2,
                         float(lr), torch.from_numpy(alias), torch.from_numpy(prob),
                         torch.from_numpy(mask), window, negatives, pairs)
    for name, x, y in zip(("emb_in", "emb_out", "acc_in", "acc_out", "loss"),
                          (*to_reference_state(*state), loss.numpy()), want):
        np.testing.assert_allclose(x, np.asarray(y), rtol=RTOL, atol=ATOL, err_msg=name)
    valid = sg.make_pairs(torch.from_numpy(walks), b, torch.from_numpy(mask), window)[2]
    assert int(pairs) == int(valid.sum()) > 0
