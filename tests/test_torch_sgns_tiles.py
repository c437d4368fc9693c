"""A numpy model of K2's tiled decomposition (csrc/sgns.cu) against the
plain step and the JAX step, on the CPU.

The CUDA kernel cannot run here, so its arithmetic is modelled as it cuts
the work: walk groups of G = 64 // L1 walks padded to an M-tile of Mt rows,
D in chunks of KC columns streamed twice (pass 1 accumulates the negative
logits NL and, in the 16 x 8 tiles that meet the band, the positive logits
PL; pass 2 makes each chunk's columns of g_in, g_out and d_no), the banded
positive products over the kernel's k ranges, the rows of dead positions,
dropped routed slots and a ragged last group's missing walks zero-filled
(out-of-vocabulary rows read and masked), and per-block d_no and loss
partials summed at the end.  Every
product is 3xTF32: both operands split as x = hi + lo, hi rounded to TF32
(nearest, ties away) and lo = x - hi read by the tensor cores as its top 19
bits (truncated), lo.hi + hi.lo + hi.hi summed in float32.

The model is held to ``sgns_grads_plain`` / ``sgns_grads_routed_plain``
and, through the plain Adagrad, to JAX's ``sgns_walk_step_impl`` given the
same draws, at rtol 1e-5 (atol 1e-6; d_no, a sum over every position, to
rtol of its largest entry): 3xTF32 keeps about 22 bits of each product.
The tables are N(0, 0.1), the scale of chip_smoke.py's check of the kernel.
At N(0, 0.3) and D = 256, w = 10, exact fp32 products summed in another
order than the plain version's already exceed rtol 1e-5 elementwise (2.8x
the tolerance at the worst element of these cases); at 0.1 they reach
0.24x, and these 3xTF32 products 0.57x (0.68x with lo rounded as well,
1.08x with hi truncated too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from node2vec_tpu.models import skipgram as ref_sg
from node2vec_tpu.ops.alias import build_alias_csr
from node2vec_torch.convert import from_reference_state, to_reference_state
from node2vec_torch.models import skipgram as sg
from node2vec_torch.parallel import rowsharded_sgns as rs

RTOL, ATOL = 1e-5, 1e-6
GROUP_ROWS = 64
SCALE = 0.1  # the tables' standard deviation


def _round_up(a, b):
    return -(-a // b) * b


def tf32(x):
    """x rounded to TF32 (10 mantissa bits; nearest, ties away from zero),
    as ``cvt.rna.tf32.f32``."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_truncated(x):
    """What the tensor cores read of a float32 handed over as TF32: its top
    19 bits."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def mma3(a, b):
    """a @ b as the kernel's 3xTF32 products: a_lo.b_hi + a_hi.b_lo + a_hi.b_hi."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32_truncated(a - a_hi), tf32_truncated(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi).astype(np.float32)


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def _log_sigmoid(x):
    return (np.minimum(x, 0) - np.log1p(np.exp(-np.abs(x)))).astype(np.float32)


def tiled_grads(x_in_of, x_out_of, no_rows, walks, row_read, row_ok, b_sh, *, dim, window,
                negatives, neg_live=1.0, kc=64, grid=2):
    """K2's decomposition.  ``x_in_of(p)``, ``x_out_of(p)``: the gathered
    rows of flat positions p [n]; ``row_read`` [B*L1] says which rows are
    read (the others are zero-filled), ``row_ok`` which carry pairs;
    ``no_rows`` [S, D] the negatives' rows.  Returns (g_in, g_out, d_no,
    (pos, neg, mult)) as float32 numpy."""
    n_walks, length = walks.shape
    d, s, w = dim, no_rows.shape[0], window
    g = 1 if length >= GROUP_ROWS else GROUP_ROWS // length
    mt = _round_up(g * length, 16)
    sp = _round_up(s, 16)
    dp = _round_up(d, kc)
    nc = dp // kc
    no = np.zeros((sp, dp), np.float32)
    no[:s, :d] = no_rows
    neg_scale = np.float32(negatives / s)
    n_groups = -(-n_walks // g)
    g_in = np.full((n_walks * length, d), np.nan, np.float32)  # every row must be written
    g_out = np.full_like(g_in, np.nan)
    dno_parts = np.zeros((grid, sp, dp), np.float32)
    loss_parts = np.zeros((grid, 3), np.float32)
    r = np.arange(mt)
    # PL's 16 x 8 tiles that meet the band |i - j| <= w (pass 1)
    tile_on = np.zeros((mt, mt), bool)
    for m0 in range(0, mt, 16):
        j0, j1 = max(0, m0 - w) // 8, min(mt - 1, m0 + 15 + w) // 8
        tile_on[m0:m0 + 16, 8 * j0:8 * (j1 + 1)] = True
    for blk in range(grid):
        for grp in range(blk, n_groups, grid):
            rows = min(g, n_walks - grp * g) * length
            row0 = grp * g * length
            p = row0 + np.arange(rows)
            ok = np.zeros(mt, bool)
            ok[:rows] = row_ok[p]
            read = row_read[p]
            x_in = np.zeros((mt, dp), np.float32)
            x_out = np.zeros((mt, dp), np.float32)
            x_in[:rows, :d][read] = x_in_of(p[read])
            x_out[:rows, :d][read] = x_out_of(p[read])
            bsh = np.zeros(mt, np.int64)
            bsh[:rows] = b_sh.reshape(-1)[p]

            nl = np.zeros((mt, sp), np.float32)
            pl = np.zeros((mt, mt), np.float32)
            for c in range(nc):  # pass 1
                cols = slice(c * kc, (c + 1) * kc)
                nl += mma3(x_in[:, cols], no[:, cols].T)
                pl += np.where(tile_on, mma3(x_in[:, cols], x_out[:, cols].T), np.float32(0))

            off = r[None, :] - r[:, None]
            ad = np.abs(off)
            pv = (ok[:, None] & ok[None, :] & (r[:, None] // length == r[None, :] // length)
                  & (ad >= 1) & (ad <= w) & (ad <= bsh[:, None]))
            assert tile_on[pv].all()
            mult = pv.sum(1).astype(np.float32)
            band = np.where(pv, _sigmoid(pl) - np.float32(1), np.float32(0))
            m = mult * np.float32(neg_live)
            live = (np.arange(sp)[None, :] < s) & (m[:, None] > 0)
            gneg = np.where(live, _sigmoid(nl) * m[:, None] * neg_scale, np.float32(0))
            loss_parts[blk] += (np.sum(np.where(pv, _log_sigmoid(pl), 0), dtype=np.float32),
                                np.sum(np.where(live, _log_sigmoid(-nl) * m[:, None], 0),
                                       dtype=np.float32),
                                mult.sum())

            k_live = min(mt, _round_up(rows, 8))
            for c in range(nc):  # pass 2
                cols = slice(c * kc, (c + 1) * kc)
                gi = np.zeros((mt, kc), np.float32)
                go = np.zeros((mt, kc), np.float32)
                for m0 in range(0, mt, 16):
                    tile = slice(m0, m0 + 16)
                    kb = slice(max(0, m0 - w) // 8 * 8, min(mt, _round_up(m0 + 16 + w, 8)))
                    gi[tile] = (mma3(gneg[tile], no[:, cols])
                                + mma3(band[tile, kb], x_out[kb, cols]))
                    go[tile] = mma3(band[kb, tile].T, x_in[kb, cols])
                dno_parts[blk][:, cols] += mma3(gneg[:k_live].T, x_in[:k_live, cols])
                hi = min(d, (c + 1) * kc) - c * kc
                g_in[row0:row0 + rows, c * kc:c * kc + hi] = gi[:rows, :hi]
                g_out[row0:row0 + rows, c * kc:c * kc + hi] = go[:rows, :hi]
    d_no = dno_parts.sum(0)[:s, :d]
    return g_in, g_out, d_no, loss_parts.sum(0)


def model_grads(emb_in, emb_out, walks, vocab_mask, b_sh, neg_ids, *, window, negatives,
                dim=None, kc=64, grid=2):
    """The model in ``sgns_grads_plain``'s signature (torch in, torch out)."""
    e_in, e_out = emb_in.numpy(), emb_out.numpy()
    d = e_in.shape[1] if dim is None else dim
    w_np = walks.numpy()
    flat = w_np.reshape(-1)
    safe = np.where(flat >= 0, flat, 0)
    row_ok = (flat >= 0) & vocab_mask.numpy()[safe]
    g_in, g_out, d_no, (pos, neg, mult) = tiled_grads(
        lambda p: e_in[flat[p], :d], lambda p: e_out[flat[p], :d], e_out[neg_ids.numpy(), :d],
        w_np, flat >= 0, row_ok, b_sh.numpy(), dim=d, window=window, negatives=negatives,
        kc=kc, grid=grid)
    neg_scale = np.float32(negatives / neg_ids.shape[0])
    loss = -(pos + neg_scale * neg) / max(mult, np.float32(1))
    return (*(torch.from_numpy(x) for x in (g_in, g_out, d_no)),
            torch.tensor(loss, dtype=torch.float32), torch.tensor(mult, dtype=torch.float32))


def _inputs(n_vertices, n_walks, length, dim, window, n_neg, seed, width=None):
    rng = np.random.default_rng(seed)
    width = dim if width is None else width
    emb_in = rng.normal(0, SCALE, (n_vertices, width)).astype(np.float32)
    emb_out = rng.normal(0, SCALE, (n_vertices, width)).astype(np.float32)
    walks = rng.integers(0, n_vertices, (n_walks, length)).astype(np.int32)
    ends = rng.integers(length // 2, length + 1, n_walks)
    walks[np.arange(length)[None, :] >= ends[:, None]] = -1
    mask = rng.random(n_vertices) > 0.15
    b_sh = rng.integers(1, window + 1, (n_walks, length)).astype(np.int32)
    neg = rng.integers(0, n_vertices, n_neg).astype(np.int32)
    return [torch.from_numpy(x) for x in (emb_in, emb_out, walks, mask, b_sh, neg)]


def _assert_grads(got, want, names=("g_in", "g_out", "d_no", "loss", "pairs")):
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a), np.asarray(b)
        if name == "d_no":
            err, scale = np.abs(a - b).max(initial=0), np.abs(b).max(initial=0)
            assert err <= RTOL * scale + ATOL, (name, err, scale)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


def test_tf32_split_keeps_fp32_accuracy():
    x = np.random.default_rng(0).normal(0, 1, 10_000).astype(np.float32)
    hi = tf32(x)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.abs(hi - x).max() <= np.abs(x).max() * 2.0 ** -11
    lo = tf32_truncated(x - hi)
    assert np.all(np.abs(hi + lo - x) <= np.abs(x) * 2.0 ** -21)
    y = np.random.default_rng(1).normal(0, 1, (10_000, 64)).astype(np.float32)
    exact = y.astype(np.float64) @ x[:64].astype(np.float64)
    err3 = np.abs(mma3(y, x[:64]) - exact).max()
    err1 = np.abs(tf32(y) @ tf32(x[:64]) - exact).max()
    assert err3 < err1 / 100


@pytest.mark.parametrize("n_neg", [5, 64])
@pytest.mark.parametrize("dim", [64, 100, 128, 256])
@pytest.mark.parametrize("length", [11, 21, 81])
def test_model_matches_plain(length, dim, n_neg):
    """Groups padded to the M-tile (L1 = 11: 5 walks, 55 of 64 rows; 21: 3,
    63 of 64; 81: one walk, 81 of 96), a ragged last group, D in chunks
    (KC = 32 at D = 256, 64 below: D = 100 leaves a part chunk), S padded
    to 16, dead tails and out-of-vocabulary rows."""
    g = 1 if length >= GROUP_ROWS else GROUP_ROWS // length
    window = 10 if length == 81 else 5
    args = _inputs(300, 2 * g + 1, length, dim, window, n_neg, seed=length * dim + n_neg)
    kw = dict(window=window, negatives=5)
    want = sg.sgns_grads_plain(*args, **kw)
    got = model_grads(*args, **kw, kc=32 if dim == 256 else 64, grid=2)
    _assert_grads(got, want)


@pytest.mark.parametrize("case", ["dead_walk", "one_walk", "all_out_of_vocabulary",
                                  "more_blocks_than_groups", "fused_stride"])
def test_model_edge_cases(case):
    dim, length, window = 100, 21, 5
    emb_in, emb_out, walks, mask, b_sh, neg = _inputs(80, 7, length, dim, window, 64, seed=3)
    kw = dict(window=window, negatives=5)
    grid, extra = 2, {}
    if case == "dead_walk":
        walks[3] = -1
    elif case == "one_walk":
        walks, b_sh = walks[:1].contiguous(), b_sh[:1].contiguous()
    elif case == "all_out_of_vocabulary":
        mask[:] = False
    elif case == "more_blocks_than_groups":
        grid = 5
    else:  # the fused [V, D+1] tables, their first D columns read
        acc = torch.rand(emb_in.shape[0], 1)
        emb_in, emb_out = torch.cat([emb_in, acc], 1), torch.cat([emb_out, acc], 1)
        extra = {"dim": dim}
    args = (emb_in, emb_out, walks, mask, b_sh, neg)
    want = sg.sgns_grads_plain(*args, **kw, **extra)
    got = model_grads(*args, **kw, **extra, grid=grid)
    _assert_grads(got, want)
    if case == "all_out_of_vocabulary":
        assert float(got[4]) == 0 and not got[0].any() and not got[2].any()


@pytest.mark.parametrize("drop_negative", [False, True])
def test_model_routed_masks(drop_negative):
    """The routed mode: slots -1 read as zeros, a position valid only where
    both its slots are live, one dropped negative masking every negative
    term (``neg_live``)."""
    dim, length, window, n_neg = 64, 21, 5, 64
    emb_in, emb_out, walks, mask, b_sh, _ = _inputs(120, 7, length, dim, window, n_neg, seed=5)
    rng = np.random.default_rng(6)
    n = walks.numel()
    x_in, x_out = emb_in[:90].clone(), emb_out[:90].clone()  # the owners' buffers
    slot_in = torch.from_numpy(rng.integers(-1, 90, n).astype(np.int32))
    slot_out = torch.from_numpy(rng.integers(-1, 90, n).astype(np.int32))
    slot_neg = torch.from_numpy(rng.integers(0, 90, n_neg).astype(np.int32))
    slot_in[::11] = -1
    slot_out[5::13] = -1
    if drop_negative:
        slot_neg[7] = -1
    kw = dict(window=window, negatives=5)
    want = rs.sgns_grads_routed_plain(x_in, slot_in, x_out, slot_out, slot_neg, walks, mask,
                                      b_sh, **kw)
    flat = walks.numpy().reshape(-1)
    si, so, sn = slot_in.numpy(), slot_out.numpy(), slot_neg.numpy()
    row_read = (flat >= 0) & (si >= 0) & (so >= 0)
    row_ok = row_read & mask.numpy()[np.where(flat >= 0, flat, 0)]
    no = np.where((sn >= 0)[:, None], x_out.numpy()[np.maximum(sn, 0)], 0).astype(np.float32)
    g_in, g_out, d_no, parts = tiled_grads(
        lambda p: x_in.numpy()[si[p]], lambda p: x_out.numpy()[so[p]], no, walks.numpy(),
        row_read, row_ok, b_sh.numpy(), dim=dim, window=window, negatives=5,
        neg_live=0.0 if drop_negative else 1.0)
    _assert_grads((g_in, g_out, d_no), want[:3])
    np.testing.assert_allclose(parts, want[3].numpy(), rtol=RTOL, atol=ATOL)
    if drop_negative:
        assert parts[1] == 0 and not d_no.any()


@pytest.mark.parametrize("length,dim,shrink", [(11, 64, True), (21, 100, True),
                                               (21, 128, False)])
def test_model_step_matches_jax(length, dim, shrink):
    """One SGNS step, the model's grads through the plain Adagrad, against
    JAX's ``sgns_walk_step_impl`` given the same draws."""
    n_vertices, n_walks, window, n_neg, negatives = 60, 2 * (GROUP_ROWS // length) + 1, 5, 64, 5
    rng = np.random.default_rng(length + dim)
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
    key = jax.random.PRNGKey(length * dim)
    lr = np.float32(0.1)
    want = ref_sg.sgns_walk_step_impl(
        *(jnp.asarray(t) for t in tables), jnp.asarray(walks), key, jnp.float32(lr),
        jnp.asarray(alias), jnp.asarray(prob), jnp.asarray(mask),
        window=window, negatives=negatives, shared_negatives=n_neg, shrink_window=shrink)
    k_neg1, k_neg2, k_shrink = jax.random.split(key, 3)  # the JAX step's own draws
    if shrink:
        b_sh = jax.random.randint(k_shrink, (n_walks, length), 1, window + 1)
    else:
        b_sh = jnp.full((n_walks, length), window, dtype=jnp.int32)
    b_sh = torch.from_numpy(np.array(b_sh.astype(jnp.int32)))
    r1 = torch.from_numpy(np.array(jax.random.uniform(k_neg1, (n_neg,))))
    r2 = torch.from_numpy(np.array(jax.random.uniform(k_neg2, (n_neg,))))
    state = from_reference_state(*tables, device="cpu")
    loss = sg._step(model_grads, sg.adagrad_accumulate_plain, sg.adagrad_apply_plain, *state,
                    torch.from_numpy(walks), b_sh, r1, r2, float(lr), torch.from_numpy(alias),
                    torch.from_numpy(prob), torch.from_numpy(mask), window, negatives)
    for name, a, b in zip(("emb_in", "emb_out", "acc_in", "acc_out", "loss"),
                          (*to_reference_state(*state), loss.numpy()), want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=name)
