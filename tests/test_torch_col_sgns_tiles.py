"""Numpy models of K16's and K17's tiled decompositions (csrc/col_sgns.cu)
against the plain versions, K13's model and the JAX step, on the CPU.

The CUDA kernels cannot run here, so their arithmetic is modelled as they
cut the work, on K13's walk-group machinery (csrc/tf32_tiles.cuh): walk
groups of G = 64 // L1 walks padded to an M-tile of Mt rows, the rows of
dead positions and of a ragged last group's missing walks zero-filled, Dm
in chunks of KC columns (zero-padded past Dm), one pass over a group's
chunks, and every tensor-core product 3xTF32 (``mma3`` of
tests/test_torch_sgns_tiles.py).

K16 is K13's pass 1: NL += X_in . NO_c^T and PL += X_in . X_out^T in the
16 x 8 tiles that meet the band; after the last chunk each valid lane's
PL[i, i + d] goes to pos_part in the JAX lane order (walk, offset,
position), 0 on an invalid lane, and each position's NL row to neg_part, 0
where the position has no valid lane.

K17 reads a group's logits (its lanes' positive logits, its positions'
negative rows), makes g_pos, Gneg and mult * Gneg with the loss partials
in its elementwise phase, then a chunk at a time GN_c = Gneg . NO_c and the
block's d_no partial += (mult * Gneg)^T . X_in_c; the store phase writes
the lane rows d_ci = g_pos * X_out[i + d] + GN[i], d_co = g_pos * X_in[i]
and adds each row's squares over the chunk (8 threads a row, summed over
them by a butterfly) to the lane's sum; the last block
sums the squares of the whole d_no.

Each model is held to ``col_pair_logits_plain`` / ``col_pair_grads_plain``
at Dm = D and D / 2 at rtol 1e-5 and atol 1e-6 (d_no, the squares and the
loss partials to rtol of their largest entry), K16 then K17 at n_model = 1
to the K13 model of tests/test_torch_cbow_pair_tiles.py, and a step built
from the models, through the plain K3 squares mode and K4, to JAX's
``sharded_sgns_step`` at 1 x 1 and 1 x 2 given JAX's draws.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as Pspec

from node2vec_tpu.ops.alias import build_alias_csr
from node2vec_tpu.parallel import make_mesh as ref_make_mesh
from node2vec_tpu.parallel.sharded_sgns import (ShardedSGNSState as RefState,
                                                sharded_sgns_step as ref_sharded_sgns_step)
from node2vec_torch import _build
from node2vec_torch.models import skipgram as sg
from node2vec_torch.parallel import sharded_sgns as col
from test_torch_cbow_pair_tiles import _inputs, tiled_pairs
from test_torch_sgns_tiles import ATOL, GROUP_ROWS, RTOL, _log_sigmoid, _round_up, _sigmoid, mma3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMEM_OPTIN = 232448  # an H100's shared memory per block
WARPS = 16  # a block's warps (tf32_tiles.cuh kThreads = 512)


def _stride8(n):
    return n + (40 - n % 32) % 32


def geometry(length, dim, n_neg, window, kc):
    """tf32_tiles.cuh make_geo."""
    g = 1 if length >= GROUP_ROWS else GROUP_ROWS // length
    mt, sp, dp = _round_up(g * length, 16), _round_up(n_neg, 16), _round_up(dim, kc)
    return dict(G=g, Mt=mt, Sp=sp, Dp=dp, nc=dp // kc, KC=kc, ldn=dp + 4, ldx=kc + 4,
                ldg=_stride8(sp), ldb=_stride8(mt), ldc=_stride8(kc))


def smem_bytes(kernel, length, dim, n_neg, window, kc):
    """Bytes a block of K16 or K17 carves (col_sgns.cu logits_smem_bytes,
    grads_smem_bytes)."""
    g = geometry(length, dim, n_neg, window, kc)
    mt, ring = g["Mt"], 2 * 2 * g["Mt"] * g["ldx"]
    group = mt * (3 + 4 * window + 1) + 4  # rows tables, centers, mult, mbarriers
    if kernel == "k16":
        floats = g["Sp"] * g["ldn"] + ring + mt * (g["ldg"] + g["ldb"]) + group
    else:
        floats = (2 * g["Sp"] * g["ldn"] + ring + 2 * mt * g["ldg"] + mt * g["ldc"]
                  + 8 * window * mt + 3 * WARPS + 4 + group)
    return 4 * floats


def pick_kc(kernel, length, dim, n_neg, window):
    """Chunks of 64 columns where they fit the card's shared memory, else 32
    (tf32_tiles.cuh pick_geo)."""
    if dim > 32 and smem_bytes(kernel, length, dim, n_neg, window, 64) <= SMEM_OPTIN:
        return 64
    return 32


@pytest.mark.parametrize("kernel,shape,want,mode", [
    ("k16", (21, 128, 64, 5), 146_448, "shared"),
    ("k17", (21, 128, 64, 5), 209_120, "shared"),
    ("k16", (21, 64, 64, 5), 130_064, "shared"),
    ("k17", (21, 64, 64, 5), 176_352, "shared"),
    ("k16", (81, 128, 64, 5), 215_056, "shared"),
    ("k17", (81, 128, 64, 5), 218_336, "shared"),
    ("k16", (41, 16, 64, 5), 69_136, "shared"),
    ("k17", (41, 16, 64, 5), 93_920, "shared"),
    ("k16", (21, 256, 64, 5), 179_216, "shared"),
    ("k17", (21, 256, 64, 5), 233_696, "global"),
    ("k16", (81, 256, 64, 10), 206_352, "shared"),
    ("k17", (81, 256, 64, 10), 306_912, "global")])
def test_geometry(kernel, shape, want, mode):
    """The carve at the shapes chip_smoke.py's col_build line reports from
    the C entries on the card: the main shape (L1 21, Dm 128), Dm 64, one
    walk a group at L1 81 (K17 in 32-column chunks) and the quick smoke's
    Dm 16 stage in shared memory, K16 also at Dm 256 and at the wide shape
    (L1 81, Dm 256, w 10); K17 there in a global workspace (at Dm 256, 1,248
    bytes past the card)."""
    got = smem_bytes(kernel, *shape, pick_kc(kernel, *shape))
    assert got == want
    assert _build.staging_mode(got, SMEM_OPTIN) == mode


def test_chunk_widths():
    """64-column chunks where they fit, 32 otherwise and at Dm <= 32: K17 at
    L1 = 81 and Dm = 128 needs 32 (its 64-column carve is past the card)."""
    assert pick_kc("k16", 21, 128, 64, 5) == pick_kc("k17", 21, 128, 64, 5) == 64
    assert pick_kc("k16", 81, 128, 64, 5) == 64 and pick_kc("k17", 81, 128, 64, 5) == 32
    assert pick_kc("k16", 21, 48, 64, 5) == 64 and pick_kc("k17", 41, 16, 64, 5) == 32


def _offsets(w):
    return np.array([d for d in range(-w, w + 1) if d != 0])  # the JAX order


def _band_tiles(mt, w):
    """PL's 16 x 8 tiles that meet the band (tf32_tiles.cuh pass1_products)."""
    on = np.zeros((mt, mt), bool)
    for m0 in range(0, mt, 16):
        j0, j1 = max(0, m0 - w) // 8, min(mt - 1, m0 + 15 + w) // 8
        on[m0:m0 + 16, 8 * j0:8 * (j1 + 1)] = True
    return on


class _Groups:
    """A launch's groups: each one's rows, lanes and gathered [Mt, Dp]
    X_in and X_out (zeros on dead positions, missing walks and columns past
    Dm), and NO [Sp, Dp]."""

    def __init__(self, emb_in, emb_out, walks, centers, neg_ids, window, kernel):
        self.e_in, self.e_out = emb_in.numpy(), emb_out.numpy()
        self.flat = walks.numpy().reshape(-1)
        self.n_walks, self.length = walks.shape
        self.dim, self.s, self.w = self.e_in.shape[1], neg_ids.shape[0], window
        self.kc = pick_kc(kernel, self.length, self.dim, self.s, window)
        geo = geometry(self.length, self.dim, self.s, window, self.kc)
        self.G, self.mt, self.sp, self.dp, self.nc = (geo[k] for k in ("G", "Mt", "Sp", "Dp", "nc"))
        self.n_groups = -(-self.n_walks // self.G)
        self.cen = centers.numpy()
        self.no = np.zeros((self.sp, self.dp), np.float32)
        self.no[:self.s, :self.dim] = self.e_out[neg_ids.numpy()]

    def group(self, q):
        L, w2, mt = self.length, 2 * self.w, self.mt
        rows = min(self.G, self.n_walks - q * self.G) * L
        row0 = q * self.G * L
        ids = np.full(mt, -1)
        ids[:rows] = self.flat[row0:row0 + rows]
        x_in = np.zeros((mt, self.dp), np.float32)
        x_out = np.zeros((mt, self.dp), np.float32)
        live_row = ids >= 0
        x_in[live_row, :self.dim] = self.e_in[ids[live_row]]
        x_out[live_row, :self.dim] = self.e_out[ids[live_row]]
        lr = np.arange(rows * w2)
        o, i, ql = (lr // L) % w2, lr % L, lr // (w2 * L)
        r = ql * L + i  # the lane's tile row
        live = self.cen[row0 * w2:(row0 + rows) * w2] >= 0
        mult = np.zeros(mt, np.float32)
        np.add.at(mult, r[live], 1)
        return dict(rows=rows, row0=row0, x_in=x_in, x_out=x_out, r=r,
                    c=r + _offsets(self.w)[o], live=live, mult=mult)

    def cols(self, c):
        return slice(c * self.kc, (c + 1) * self.kc)


def tiled_logits(emb_in, emb_out, walks, centers, contexts, neg_ids, *, window):
    """K16 in col_pair_logits_plain's signature (torch in, torch out);
    ``contexts`` is unused, as by the kernel (a lane's rows are its walk's)."""
    t = _Groups(emb_in, emb_out, walks, centers, neg_ids, window, "k16")
    n_lanes = t.n_walks * 2 * window * t.length
    pos = np.full(n_lanes, np.nan, np.float32)  # every entry must be written
    neg = np.full((t.n_walks * t.length, t.s), np.nan, np.float32)
    tile_on = _band_tiles(t.mt, window)
    for q in range(t.n_groups):
        gr = t.group(q)
        nl = np.zeros((t.mt, t.sp), np.float32)
        pl = np.zeros((t.mt, t.mt), np.float32)
        for c in range(t.nc):
            cols = t.cols(c)
            nl += mma3(gr["x_in"][:, cols], t.no[:, cols].T)
            pl += np.where(tile_on, mma3(gr["x_in"][:, cols], gr["x_out"][:, cols].T),
                           np.float32(0))
        live, r, cl = gr["live"], gr["r"], gr["c"]
        assert tile_on[r[live], cl[live]].all()
        lane0, rows = gr["row0"] * 2 * window, gr["rows"]
        pos[lane0:lane0 + rows * 2 * window] = np.where(
            live, pl[r, np.clip(cl, 0, t.mt - 1)], np.float32(0))
        neg[gr["row0"]:gr["row0"] + rows] = np.where(gr["mult"][:rows, None] > 0,
                                                     nl[:rows, :t.s], np.float32(0))
    return torch.from_numpy(np.concatenate([pos, neg.reshape(-1)]))


def _row_squares(x):
    """A lane row's squares over a chunk as the store phase sums them: 8
    threads a row, thread p's k-th 4 columns at 4p + 32k, then a butterfly
    over the 8 threads."""
    part = np.sum((x * x).reshape(x.shape[0], -1, 8, 4), axis=(1, 3), dtype=np.float32)
    for off in (4, 2, 1):
        part = part + part[:, np.arange(8) ^ off]
    return part[:, 0]


def tiled_grads(emb_in, emb_out, walks, centers, contexts, neg_ids, logits, *, window,
                negatives, grid=2):
    """K17 in col_pair_grads_plain's signature (torch in, torch out): d_ci,
    d_co, d_no, the squares [2P + S] and the loss partials [3] summed over
    the blocks (``grid`` of them, taking the groups in turn)."""
    t = _Groups(emb_in, emb_out, walks, centers, neg_ids, window, "k17")
    w2, L = 2 * window, t.length
    n_lanes = t.n_walks * w2 * L
    lg = logits.numpy()
    neg_scale = np.float32(negatives / t.s)
    d_ci = np.full((n_lanes, t.dim), np.nan, np.float32)
    d_co = np.full_like(d_ci, np.nan)
    sq_ci = np.full(n_lanes, np.nan, np.float32)
    sq_co = np.full_like(sq_ci, np.nan)
    dno_parts = np.zeros((grid, t.sp, t.dp), np.float32)
    loss_parts = np.zeros((grid, 3), np.float32)
    for blk in range(grid):
        for q in range(blk, t.n_groups, grid):
            gr = t.group(q)
            rows, row0, live, r, cl, mult = (gr[k] for k in ("rows", "row0", "live", "r", "c",
                                                             "mult"))
            lane0 = row0 * w2
            # the group's logits, as they land a group ahead
            nl = np.zeros((t.mt, t.sp), np.float32)
            nl[:rows, :t.s] = lg[n_lanes + row0 * t.s:n_lanes + (row0 + rows) * t.s].reshape(
                rows, t.s)
            pl = lg[lane0:lane0 + rows * w2]
            has = (mult[:, None] > 0) & (np.arange(t.sp)[None, :] < t.s)
            gneg = np.where(has, _sigmoid(nl) * neg_scale, np.float32(0))
            gm = gneg * mult[:, None]
            gpos = np.where(live, _sigmoid(pl) - np.float32(1), np.float32(0))
            loss_parts[blk] += (np.sum(np.where(live, _log_sigmoid(pl), 0), dtype=np.float32),
                                np.sum(np.where(has, _log_sigmoid(-nl), 0) * mult[:, None],
                                       dtype=np.float32),
                                mult.sum())
            k_live = min(t.mt, _round_up(rows, 8))
            sa = np.zeros(rows * w2, np.float32)
            sc = np.zeros(rows * w2, np.float32)
            x_in, x_out = gr["x_in"], gr["x_out"]
            for c in range(t.nc):
                cols = t.cols(c)
                gn = mma3(gneg, t.no[:, cols])
                dno_parts[blk][:, cols] += mma3(gm[:k_live].T, x_in[:k_live, cols])
                ci = np.where(live[:, None], gpos[:, None] * x_out[np.clip(cl, 0, t.mt - 1), cols]
                              + gn[r], np.float32(0))
                co = np.where(live[:, None], gpos[:, None] * x_in[r, cols], np.float32(0))
                hi = min(t.dim, (c + 1) * t.kc) - c * t.kc
                d_ci[lane0:lane0 + rows * w2, c * t.kc:c * t.kc + hi] = ci[:, :hi]
                d_co[lane0:lane0 + rows * w2, c * t.kc:c * t.kc + hi] = co[:, :hi]
                sa += _row_squares(ci)
                sc += _row_squares(co)
            sq_ci[lane0:lane0 + rows * w2] = sa
            sq_co[lane0:lane0 + rows * w2] = sc
    d_no = dno_parts.sum(0)[:t.s, :t.dim]
    sq_no = np.sum(d_no * d_no, axis=1, dtype=np.float32)
    return (torch.from_numpy(d_ci), torch.from_numpy(d_co), torch.from_numpy(d_no),
            torch.from_numpy(np.concatenate([sq_ci, sq_co, sq_no])),
            torch.from_numpy(loss_parts.sum(0)))


def _slices(emb, dm):
    return [emb[:, m * dm:(m + 1) * dm].contiguous() for m in range(emb.shape[1] // dm)]


def _check_grads(got, want):
    for name, a, b in zip(("d_ci", "d_co", "d_no", "squares", "loss parts"), got, want):
        a, b = a.numpy(), b.numpy()
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if name in ("d_ci", "d_co"):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
        else:
            err, scale = np.abs(a - b).max(initial=0), np.abs(b).max(initial=0)
            assert err <= RTOL * scale + ATOL, (name, err, scale)
    assert float(got[4][2]) == float(want[4][2])  # the valid lanes, exactly


# the tiling's cases: (L1, D, w, B) -- groups of 3 walks at L1 = 21 with a
# ragged last one, 5 at L1 = 11, one walk a group at L1 = 41, 64 and 81;
# Dm = D and D / 2 in chunks of 64 or 32 columns: 16, 32, 48 and 96 fill
# none of theirs (48 and 96 in 64-column chunks)
CASES = [(21, 64, 5, 7), (11, 32, 3, 11), (41, 32, 5, 3), (64, 64, 5, 3), (81, 96, 5, 2)]
CASE_IDS = [f"L{c[0]}-D{c[1]}-w{c[2]}-B{c[3]}" for c in CASES]


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def case(request):
    length, dim, window, n_walks = request.param
    emb_in, emb_out, walks, mask, b_sh, neg = _inputs(300, n_walks, length, dim, window, 64,
                                                      seed=length * dim + window,
                                                      dead_walk=n_walks // 2)
    centers, contexts = sg.pair_lists_plain(walks, b_sh, mask, window)
    assert (centers >= 0).any() and (~mask).any() and (walks < 0).any()
    return dict(emb_in=emb_in, emb_out=emb_out, walks=walks, centers=centers,
                contexts=contexts, neg=neg, window=window)


@pytest.mark.parametrize("split", [1, 2], ids=["Dm=D", "Dm=D/2"])
def test_logits_model_matches_plain(case, split):
    w, lists = case["window"], (case["walks"], case["centers"], case["contexts"], case["neg"])
    dm = case["emb_in"].shape[1] // split
    for e_in, e_out in zip(_slices(case["emb_in"], dm), _slices(case["emb_out"], dm)):
        got = tiled_logits(e_in, e_out, *lists, window=w)
        want = col.col_pair_logits_plain(e_in, e_out, *lists, window=w)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("split", [1, 2], ids=["Dm=D", "Dm=D/2"])
def test_grads_model_matches_plain(case, split):
    """K17's model on the model-summed logits (the plain partials summed over
    the column slices), a rank's slice at a time."""
    w, lists = case["window"], (case["walks"], case["centers"], case["contexts"], case["neg"])
    dm = case["emb_in"].shape[1] // split
    parts = list(zip(_slices(case["emb_in"], dm), _slices(case["emb_out"], dm)))
    logits = sum(col.col_pair_logits_plain(a, b, *lists, window=w) for a, b in parts)
    for e_in, e_out in parts:
        got = tiled_grads(e_in, e_out, *lists, logits, window=w, negatives=5)
        want = col.col_pair_grads_plain(e_in, e_out, *lists, logits, window=w, negatives=5)
        _check_grads(got, want)


def test_one_model_rank_is_the_k13_model(case):
    """At n_model = 1, K16's model then K17's is K13's (the model of
    tests/test_torch_cbow_pair_tiles.py): the same gradients, d_no and loss."""
    w, lists = case["window"], (case["walks"], case["centers"], case["contexts"], case["neg"])
    e_in, e_out = case["emb_in"], case["emb_out"]
    logits = tiled_logits(e_in, e_out, *lists, window=w)
    d_ci, d_co, d_no, _, parts = tiled_grads(e_in, e_out, *lists, logits, window=w, negatives=5)
    k13 = tiled_pairs(e_in, e_out, *lists, window=w, negatives=5,
                      kc=pick_kc("k17", case["walks"].shape[1], e_in.shape[1], 64, w))
    np.testing.assert_allclose(d_ci.numpy(), k13[0].numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(d_co.numpy(), k13[1].numpy(), rtol=RTOL, atol=ATOL)
    err, scale = np.abs(d_no.numpy() - k13[2].numpy()).max(), np.abs(k13[2].numpy()).max()
    assert err <= RTOL * scale + ATOL
    loss = -(parts[0] + 5 / 64 * parts[1]) / max(float(parts[2]), 1.0)
    np.testing.assert_allclose(float(loss), float(k13[3]), rtol=RTOL, atol=ATOL)
    assert float(parts[2]) == float(k13[4]) > 0


@pytest.mark.parametrize("kind", ["all_dead", "all_out_of_vocabulary", "no_context"])
def test_models_with_no_valid_lane(kind):
    """Batches with no valid lane: every logit, gradient, square and loss
    partial zero, written whole."""
    emb_in, emb_out, walks, mask, b_sh, neg = _inputs(80, 7, 21, 48, 5, 64, seed=4)
    window = 5
    if kind == "all_dead":
        walks[:] = -1
    elif kind == "all_out_of_vocabulary":
        mask[:] = False
    else:  # live positions between dead ones, window 1: no center has a context
        walks[:, 1::2] = -1
        b_sh[:] = 1
        window = 1
    centers, contexts = sg.pair_lists_plain(walks, b_sh, mask, window)
    assert not (centers >= 0).any()
    lists = (walks, centers, contexts, neg)
    logits = tiled_logits(emb_in, emb_out, *lists, window=window)
    assert not logits.any()
    got = tiled_grads(emb_in, emb_out, *lists, logits, window=window, negatives=5)
    for x in got:
        assert not x.any()


def test_lane_order_of_both_outputs():
    """pos_part's lane lr of a group is (walk, offset, position) = (lr //
    (2w L1), lr // L1 % 2w, lr % L1), make_pairs' flat lane: the model's
    positive logit at each valid lane is its own center . context, and
    neg_part's row b * L1 + i is position i of walk b."""
    emb_in, emb_out, walks, mask, b_sh, neg = _inputs(200, 5, 9, 16, 3, 16, seed=8)
    centers, contexts = sg.pair_lists_plain(walks, b_sh, mask, 3)
    logits = tiled_logits(emb_in, emb_out, walks, centers, contexts, neg, window=3).numpy()
    live = (centers >= 0).numpy()
    n = live.size
    want = np.sum(emb_in.numpy()[centers.numpy()[live]] * emb_out.numpy()[contexts.numpy()[live]],
                  axis=1)
    np.testing.assert_allclose(logits[:n][live], want, rtol=1e-5, atol=1e-6)
    assert not logits[:n][~live].any()
    neg_rows = logits[n:].reshape(5 * 9, 16)
    xin = emb_in.numpy()[np.where(walks.numpy() >= 0, walks.numpy(), 0).reshape(-1)]
    mult = live.reshape(5, 6, 9).sum(1).reshape(-1)
    np.testing.assert_allclose(neg_rows[mult > 0], (xin @ emb_out.numpy()[neg.numpy()].T)[mult > 0],
                               rtol=1e-5, atol=1e-6)
    assert not neg_rows[mult == 0].any()


# --------------------------------------------------------------------------- #
# the step, against JAX's sharded_sgns_step at 1 x 1 and 1 x 2
# --------------------------------------------------------------------------- #

V, D, B, L1, W, S, K, LR = 40, 32, 8, 11, 5, 16, 5, 0.05


class _ThreadMesh:
    """One model rank of an n_model x 1 column mesh run in a thread: the
    all-reduce over the model axis sums the ranks' tensors in coordinate
    order (a barrier before and after); the data axis is one rank."""

    def __init__(self, n_model, m, shared):
        self.shape = {"data": 1, "model": n_model}
        self.coords = {"data": 0, "model": m}
        self._shared = shared

    def all_reduce_sum(self, t, axis):
        if axis == "data" or self.shape["model"] == 1:
            return t
        slots, barrier = self._shared
        slots[self.coords["model"]] = t.clone()
        barrier.wait()
        total = slots[0].clone()
        for x in slots[1:]:
            total += x
        barrier.wait()
        t.copy_(total)
        return t


def _step_inputs():
    rng = np.random.default_rng(0)
    walks = rng.integers(0, V, (B, L1)).astype(np.int32)
    ends = rng.integers(1, L1 + 1, B)
    walks[np.arange(L1)[None, :] >= ends[:, None]] = -1
    walks[3] = -1
    mask = rng.random(V) > 0.15
    tables = (rng.normal(0, 0.3, (V, D)).astype(np.float32),
              rng.normal(0, 0.3, (V, D)).astype(np.float32),
              rng.random(V).astype(np.float32), rng.random(V).astype(np.float32))
    alias, prob = build_alias_csr(np.array([0, V]), rng.random(V).astype(np.float32) + 0.1)
    return walks, mask, tables, np.asarray(alias, np.int32), np.asarray(prob, np.float32)


@pytest.mark.parametrize("n_model", [1, 2], ids=["1x1", "1x2"])
def test_model_step_matches_jax(n_model):
    """Two steps of the column step with K16 and K17 as their models, K13's
    plain lists, K3's plain squares mode and K4's plain version, each model
    rank in a thread with its column slices, against JAX's
    ``sharded_sgns_step`` on the virtual CPU devices given the same draws:
    every rank's slices, the accumulators and the losses at rtol 1e-5."""
    walks, mask, tables, alias, prob = _step_inputs()
    mesh = ref_make_mesh(1, n_model, devices=jax.devices()[:n_model])
    cols = NamedSharding(mesh, Pspec(None, "model"))
    rep = NamedSharding(mesh, Pspec())
    state = RefState(*(jax.device_put(jnp.asarray(t), cols) for t in tables[:2]),
                     *(jax.device_put(jnp.asarray(t), rep) for t in tables[2:]))
    draws, want_losses = [], []
    for k in range(2):
        key = jax.random.PRNGKey(k)
        k_neg1, k_neg2, k_shrink = jax.random.split(jax.random.fold_in(key, 0), 3)
        draws.append(tuple(torch.from_numpy(np.array(x)) for x in (
            jax.random.randint(k_shrink, (B, 1, L1), 1, W + 1).astype(jnp.int32),
            jax.random.uniform(k_neg1, (S,)), jax.random.uniform(k_neg2, (S,)))))
        state, loss = ref_sharded_sgns_step(
            mesh, state, jnp.asarray(walks), key, jnp.float32(LR), jnp.asarray(alias),
            jnp.asarray(prob), jnp.asarray(mask), window=W, negatives=K, shared_negatives=S,
            shrink_window=True)
        want_losses.append(float(loss))
    want = [np.asarray(t) for t in state]

    ops = (sg.pair_lists_plain, tiled_logits, tiled_grads, sg.adagrad_accumulate_squares_plain,
           sg.adagrad_apply_plain)
    dm = D // n_model
    shared = ([None] * n_model, threading.Barrier(n_model))
    out, errors = [None] * n_model, []

    def rank(m):
        try:
            st = col.ShardedSGNSState(
                *(torch.from_numpy(t[:, m * dm:(m + 1) * dm].copy()) for t in tables[:2]),
                *(torch.from_numpy(t.copy()) for t in tables[2:]))
            mesh_m = _ThreadMesh(n_model, m, shared)
            losses = [float(col._col_step(ops, mesh_m, st, torch.from_numpy(walks), b_sh, r1, r2,
                                          LR, torch.from_numpy(alias), torch.from_numpy(prob),
                                          torch.from_numpy(mask), W, K, None))
                      for b_sh, r1, r2 in draws]
            out[m] = ([t.numpy() for t in st], losses)
        except Exception as e:  # noqa: BLE001  (re-raised below)
            errors.append(e)
            shared[1].abort()

    threads = [threading.Thread(target=rank, args=(m,)) for m in range(n_model)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    for m, (st, losses) in enumerate(out):
        for name, got, full in zip(("emb_in", "emb_out"), st[:2], want[:2]):
            np.testing.assert_allclose(got, full[:, m * dm:(m + 1) * dm], rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        for name, got, full in zip(("acc_in", "acc_out"), st[2:], want[2:]):
            np.testing.assert_allclose(got, full, rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL, err_msg="losses")
