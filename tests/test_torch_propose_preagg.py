"""Numpy models of two designs, held to the port's plain versions and to the
JAX package:

* K21 ``ep_propose`` (csrc/ep_walk.cu): owner(cur) serves a proposal with
  an 8-lane group a request, four a warp (blocked_common.cuh's grouping,
  the float operations of ``test_torch_blocked_groups``'s model).  Every
  group computes the light pick from its row; a warp with any heavy request
  among its four takes the heavy branch, in which a heavy group's buffer
  takes its block's C weights over its light row (C <= 256): 16-byte chunk
  i = 8 j + lane goes to lane i // k4's int4 m = i % k4 at r k4 + (m ^
  swz(r)), and lane r reads its k4 int4s back in column order, so the
  group's CDF (ex_r + L_r(j)) is the one of the block's columns; past 256
  columns the lanes read their runs from global memory.  The chosen weight
  comes from the buffer, the id and the (rev, pfx) pair from global memory.
  An empty slot (cur < 0) answers -1 in every field.  Bit-equal to
  ``ep_propose_plain`` and to the JAX serve (``edge_partitioned_blocked.py``
  :401-500, written out here in jnp with the JAX package's ``prefix_sums``,
  as it is inline in ``shard_fn``) on dyadic weights, in modes 0-2, with
  first-order requests, warps of 0-4 heavy requests, empty slots in every
  position, 1, 2 and 3 shards, light widths 31 and 12 and C = 64, 256, 512;
  the model serving a single-shard walk gives JAX's
  ``edge_partitioned_blocked_walk``'s paths;
* K11 ``preagg_rows`` (csrc/preagg.cu): one cooperative launch, warp w of W
  taking rows w, w + W, ... in every phase, 32 at a time: claim
  (``atomicMin`` of each live row on its vertex's slot), write (from the
  warp's last batch down: a head copies its gradient rows, every other row
  stores zeros, a repeat keeps -2 - head in ``heads``), add (a repeat adds
  its rows into its head's, float4 chunks a lane where D % 4 == 0, counts
  itself there and writes -1; a head resets its slot).  Heads
  and counts exact, the sums to rtol of their largest entry against
  ``preagg_rows_plain`` and JAX's segment sums (:409-423, :431-433), every
  column of every row written once, the slot map restored; the model in the
  pre-aggregated steps against JAX's ``sgns_walk_step``.

The kernels themselves run only on the card (chip_smoke.py:
``edge_cases_ep_propose``, ``check_ep_walk``, ``edge_cases_preagg``,
``check_preagg``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from node2vec_tpu.models import skipgram as ref_sg
from node2vec_tpu.ops.sampling import prefix_sums as ref_prefix_sums
from node2vec_tpu.parallel import edge_partitioned_blocked as ref_ep
from node2vec_torch.convert import from_reference_state, to_reference_state
from node2vec_torch.graph import from_edge_arrays
from node2vec_torch.models import skipgram as sg
from node2vec_torch.parallel import edge_partitioned_blocked as ep
from test_torch_blocked import _ref_native_loaded
from test_torch_blocked_groups import group_cdf
from test_torch_sgd import _batch, _draws

F32 = np.float32
G = 8  # lanes a request
STAGE_COLS = 256  # ep_walk.cu: kStageCols
PAD = 0x7FFFFFFF
MAG = 0x7FFFFFFF


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(bits):
    return np.ascontiguousarray(bits, dtype=np.int32).view(F32)


def _bits(x):
    return np.asarray(x, dtype=F32).view(np.int32)


# --------------------------------------------------------------------------- #
# K21: the staged heavy block
# --------------------------------------------------------------------------- #

def swz(r: int, k4: int) -> int:
    return (r & (k4 - 1)) if (k4 & (k4 - 1)) == 0 else 0


def staged_buffer(w_row, k4: int):
    """block_issue: the group's buffer after its lanes copy the block's
    8 k4 16-byte chunks, chunk i = 8 j + lane."""
    buf = np.full(4 * G * k4, -7, np.int32)
    for j in range(k4):
        for lane in range(G):
            i = G * j + lane
            r, m = divmod(i, k4)
            pos = r * k4 + (m ^ swz(r, k4))
            buf[4 * pos: 4 * pos + 4] = w_row[4 * i: 4 * i + 4]
    return buf


def staged_lane_runs(buf, k4: int):
    """StagedCols: what lane r reads, int4 m after int4 m, [8, 4 k4]."""
    runs = np.empty((G, 4 * k4), np.int32)
    for r in range(G):
        for m in range(k4):
            pos = r * k4 + (m ^ swz(r, k4))
            runs[r, 4 * m: 4 * m + 4] = buf[4 * pos: 4 * pos + 4]
    return runs


def staged_at(buf, j: int, k4: int) -> int:
    i = j >> 2
    r, m = divmod(i, k4)
    return int(buf[4 * (r * k4 + (m ^ swz(r, k4))) + (j & 3)])


def _take(a, idx):
    return np.take_along_axis(a, np.clip(idx, 0, a.shape[1] - 1)[:, None], 1)[:, 0]


def model_serve(recv, light, biw, brp, *, row_base, p_l, c, p, q):
    """ep_propose_kernel, a warp of four groups at a time: [n_req, 6]."""
    n_req = recv.shape[0]
    maxb = (4 * p_l - 5) // 2
    mode = 0 if p == 1.0 and q == 1.0 else (1 if q == 1.0 else 2)
    inv_p, inv_q, alpha_hi = F32(1.0 / p), F32(1.0 / q), F32(max(1.0, 1.0 / q))
    resp = np.full((n_req, 6), -1, np.int32)
    k4 = c // (4 * G)
    staged = c <= STAGE_COLS
    for w0 in range(0, n_req, 4):
        quad = np.arange(w0, min(w0 + 4, n_req))
        on = recv[quad, 0] >= 0
        if not on.any():  # an all-empty warp: every slot's response -1
            continue
        rq = recv[quad]
        lv = np.clip(rq[:, 0].astype(np.int64) - row_base, 0, light.shape[0] - 1)
        rows = light[lv]
        w32 = np.zeros((len(quad), 4 * G), F32)
        w32[:, :p_l] = _f32(rows[:, p_l: 2 * p_l])
        cdf_l, wtot_l = group_cdf(w32)
        ids = rows[:, :p_l]
        is_heavy = rows[:, 0] < -1
        degree = np.where(is_heavy, rows[:, 4], ((ids != PAD) & (ids >= 0)).sum(1))
        wtot = np.where(is_heavy, _f32(rows[:, 3]), wtot_l).astype(F32)
        wb = _f32(rq[:, 2] & MAG)
        first = rq[:, 6] == 0
        if mode == 0:
            take_back = np.zeros(len(quad), bool)
            target = (_f32(rq[:, 5]) * wtot).astype(F32)
        else:
            m1 = np.where(first, F32(0), (wb * inv_p).astype(F32))
            alpha2 = np.where(rq[:, 2] < 0, alpha_hi, inv_q)
            rest = np.maximum((wtot - wb).astype(F32), F32(0))
            m2 = (rest * alpha2).astype(F32)
            take_back = ~first & (_f32(rq[:, 4]) < (m1 / np.maximum((m1 + m2).astype(F32),
                                                                      F32(1e-30))).astype(F32))
            u2 = (_f32(rq[:, 5]) * rest).astype(F32)
            target = np.where(u2 < _f32(rq[:, 3]), u2, (u2 + wb).astype(F32))
        slot_l = np.minimum((cdf_l[:, :p_l] < target[:, None]).sum(1),
                            np.maximum(degree - 1, 0))
        ls = np.minimum(slot_l, 31)
        ppfx = np.where(ls > 0, _take(cdf_l, np.maximum(ls - 1, 0)), F32(0)).astype(F32)
        out = np.stack([_take(rows, ls), _take(rows, p_l + ls), _take(rows, 2 * p_l + ls),
                        _take(rows, 3 * p_l + ls), _bits(ppfx), take_back.astype(np.int32)], 1)
        if (on & is_heavy).any():  # the warp's heavy branch; its light groups keep their pick
            for k in np.flatnonzero(on & is_heavy):
                row = rows[k]
                h_cum = _f32(row[5 + maxb: 5 + 2 * maxb])
                blk = min(int((h_cum < target[k]).sum()), max(int(row[2]) - 1, 0), maxb)
                base = h_cum[blk - 1] if blk > 0 else F32(0)
                resid = F32(target[k] - base)
                brow = int(row[1]) + blk
                w_row = biw[brow, c:]
                if staged:  # the block over the light row, read back by lane runs
                    buf = staged_buffer(w_row, k4)
                    cols = staged_lane_runs(buf, k4).reshape(-1)
                else:
                    buf, cols = None, w_row
                cdf_b, _ = group_cdf(_f32(cols)[None, :])
                nvalid = min(c, int(degree[k]) - blk * c)
                sb = min(int((cdf_b[0] < resid).sum()), max(nvalid - 1, 0))
                pc = cdf_b[0, sb - 1] if sb > 0 else F32(0)
                gslot = brow * c + sb
                out[k] = (biw[brow, sb], staged_at(buf, sb, k4) if staged else w_row[sb],
                          brp.reshape(-1)[2 * gslot], brp.reshape(-1)[2 * gslot + 1],
                          _bits(F32(base + pc)), out[k, 5])
        out[:, 0] = np.where(degree == 0, -1, out[:, 0])
        resp[quad[on]] = out[on]
    return resp


def jax_serve(recv, light, biw, brp, *, my, rows_per_shard, p_l, c, p, q):
    """The JAX package's serve (edge_partitioned_blocked.py:401-500), its
    jnp operations and ``prefix_sums`` on these tables; -1 rows where the
    slot is empty (the kernels' and the plain version's convention)."""
    maxb = (4 * p_l - 5) // 2
    n_req = recv.shape[0]
    recv, light, biw, brp = (jnp.asarray(a) for a in (recv, light, biw, brp))
    lane_c = jax.lax.broadcasted_iota(jnp.int32, (n_req, c), 1)
    lane_p = jax.lax.broadcasted_iota(jnp.int32, (n_req, p_l), 1)
    lane_b = jax.lax.broadcasted_iota(jnp.int32, (n_req, maxb), 1)
    lane_q = jax.lax.broadcasted_iota(jnp.int32, (n_req, 128), 1)

    def select(row, iota, idx):
        return jnp.sum(jnp.where(iota == idx[:, None], row, 0), axis=1)

    def bc_f32(x):
        return jax.lax.bitcast_convert_type(x, jnp.float32)

    inv_p, inv_q = jnp.float32(1.0 / p), jnp.float32(1.0 / q)
    alpha_hi = jnp.float32(max(1.0, 1.0 / q))
    r_cur = recv[:, 0]
    r_valid = r_cur >= 0
    r_wb = bc_f32(recv[:, 2] & MAG)
    r_bpfx, r_ub, r_up = bc_f32(recv[:, 3]), bc_f32(recv[:, 4]), bc_f32(recv[:, 5])
    r_first = recv[:, 6] == 0
    local_v = jnp.clip(jnp.where(r_valid, r_cur - my * rows_per_shard, 0), 0,
                       rows_per_shard - 1)
    row = light[local_v]
    ids = row[:, :p_l]
    w_light = bc_f32(row[:, p_l: 2 * p_l])
    is_heavy = row[:, 0] < -1
    h_nb = row[:, 2]
    h_cum = bc_f32(row[:, 5 + maxb: 5 + 2 * maxb])
    light_deg = jnp.sum((ids != PAD) & (ids >= 0), axis=1)
    degree = jnp.where(is_heavy, row[:, 4], light_deg)
    wtot = jnp.where(is_heavy, bc_f32(row[:, 3]), jnp.sum(w_light, axis=1))
    if p == 1.0 and q == 1.0:
        take_back = jnp.zeros((n_req,), bool)
        target = r_up * wtot
    else:
        m1 = jnp.where(r_first, 0.0, r_wb * inv_p)
        alpha2 = jnp.where(recv[:, 2] < 0, alpha_hi, inv_q)
        rest = jnp.maximum(wtot - r_wb, 0.0)
        m2 = rest * alpha2
        take_back = (~r_first) & (r_ub < m1 / jnp.maximum(m1 + m2, 1e-30))
        u2 = r_up * rest
        target = jnp.where(u2 < r_bpfx, u2, u2 + r_wb)
    cdf_l = ref_prefix_sums(w_light)
    slot_l = jnp.minimum(jnp.sum((cdf_l < target[:, None]).astype(jnp.int32), axis=1),
                         jnp.maximum(degree - 1, 0))
    cand_l = select(ids, lane_p, slot_l)
    w_l = select(row[:, p_l: 2 * p_l], lane_p, slot_l)
    rev_l = select(row[:, 2 * p_l: 3 * p_l], lane_p, slot_l)
    pfx_l = select(row[:, 3 * p_l: 4 * p_l], lane_p, slot_l)
    ppfx_l = jnp.where(slot_l > 0, select(cdf_l, lane_p, slot_l - 1), 0.0)
    blk = jnp.minimum(jnp.sum((h_cum < target[:, None]).astype(jnp.int32), axis=1),
                      jnp.maximum(h_nb - 1, 0))
    base = jnp.where(blk > 0, bc_f32(select(row[:, 5 + maxb: 5 + 2 * maxb], lane_b, blk - 1)),
                     0.0)
    resid = target - base
    local_b = jnp.where(r_valid & is_heavy, row[:, 1] + blk, 0)
    brow = biw[jnp.clip(local_b, 0, biw.shape[0] - 1)]
    nvalid = jnp.sum(brow[:, :c] != PAD, axis=1)
    cdf_b = ref_prefix_sums(bc_f32(brow[:, c:]))
    slot_b = jnp.minimum(jnp.sum((cdf_b < resid[:, None]).astype(jnp.int32), axis=1),
                         jnp.maximum(nvalid - 1, 0))
    cand_h = select(brow[:, :c], lane_c, slot_b)
    w_h = select(brow[:, c:], lane_c, slot_b)
    gslot = local_b * c + slot_b
    qrow = brp[jnp.clip(gslot // ep.QUADS_PER_ROW, 0, brp.shape[0] - 1)]
    qpos = 2 * (gslot % ep.QUADS_PER_ROW)
    rev_h, pfx_h = select(qrow, lane_q, qpos), select(qrow, lane_q, qpos + 1)
    ppfx_h = base + jnp.where(slot_b > 0, select(cdf_b, lane_c, slot_b - 1), 0.0)
    resp = jnp.stack([
        jnp.where(r_valid & (degree == 0), -1, jnp.where(is_heavy, cand_h, cand_l)),
        jnp.where(is_heavy, w_h, w_l),
        jnp.where(is_heavy, rev_h, rev_l),
        jnp.where(is_heavy, pfx_h, pfx_l),
        jax.lax.bitcast_convert_type(jnp.where(is_heavy, ppfx_h, ppfx_l), jnp.int32),
        take_back.astype(jnp.int32)], axis=1)
    return np.where(np.asarray(r_valid)[:, None], np.asarray(resp), -1)


def hub_graph(seed: int = 0, n: int = 1500, hubs=(40, 90, 300, 700, 1200)):
    """A directed graph with dyadic weights: hub vertices of the given
    out-degrees spread over the ids (heavy at light width 31 and 12, in
    every shard), the others of degree 0-20, every partial sum exact."""
    rng = np.random.default_rng(seed)
    hub_ids = [i * (n // len(hubs)) + 3 for i in range(len(hubs))]
    src, dst = [], []
    for v in range(n):
        deg = hubs[hub_ids.index(v)] if v in hub_ids else int(rng.integers(0, 21))
        src.append(np.full(deg, v))
        dst.append(rng.choice(n, deg, replace=False))
    src, dst = np.concatenate(src).astype(np.int32), np.concatenate(dst).astype(np.int32)
    w = rng.choice(np.array([0.5, 1.0, 2.0], F32), len(src))
    return from_edge_arrays(src, dst, w, directed=True)


QUAD_PATTERNS = (  # a warp's four slots: H heavy, L light, E empty
    "LLLL", "HLLL", "LHLH", "HHHL", "HHHH", "EEEE", "ELLL", "LELH", "HHEL", "HHHE",
    "EHEH", "EEEH", "LEEE", "HEHE")


def requests(g, rows_per_shard: int, shard: int, p_l: int, layout: str, seed: int):
    """Proposal requests [n_req, 7] owned by ``shard``: in QUAD_PATTERNS'
    warps ("quads"), or a valid prefix then empty slots ("prefix", as K20
    fills a source's capacity); -1 rows for empty slots.  First-order
    requests (t = 0) among them; w_back and back_pfx dyadic."""
    rng = np.random.default_rng(seed)
    deg = np.diff(g.indptr)
    lo, hi = shard * rows_per_shard, min((shard + 1) * rows_per_shard, len(deg))
    verts = np.arange(lo, hi)
    heavy, light = verts[deg[verts] > p_l], verts[deg[verts] <= p_l]
    if layout == "quads":
        kinds = "".join(QUAD_PATTERNS[i % len(QUAD_PATTERNS)] for i in range(3 * len(
            QUAD_PATTERNS)))
    else:
        kinds = "".join(rng.choice(list("HL"), 40)) + "E" * 25
    recv = np.full((len(kinds), 7), -1, np.int32)
    for i, k in enumerate(kinds):
        if k == "E":
            continue
        pool = heavy if (k == "H" and len(heavy)) else light
        t = 0 if rng.random() < 0.25 else int(rng.integers(1, 6))
        shared_bit = -2 ** 31 if rng.random() < 0.5 else 0  # W_BACK_ENC's sign: prev shared
        recv[i] = (int(rng.choice(pool)), int(rng.integers(-1, len(deg))),
                   int(_bits(rng.choice(np.array([0.5, 1.0, 2.0], F32)))) | shared_bit,
                   int(_bits(F32(0.5 * rng.integers(0, 6)))),
                   int(_bits(F32(rng.random()))), int(_bits(F32(rng.random()))), t)
    return recv


K21_CASES = [  # (light width, C, shards, (p, q), layout)
    (31, 256, 1, (0.25, 4.0), "quads"), (31, 256, 1, (1.0, 1.0), "quads"),
    (31, 256, 1, (0.25, 1.0), "quads"), (31, 256, 1, (0.25, 4.0), "prefix"),
    (31, 256, 2, (0.25, 4.0), "quads"), (31, 256, 3, (4.0, 0.25), "quads"),
    (31, 64, 1, (0.25, 4.0), "quads"), (31, 64, 3, (1.0, 1.0), "prefix"),
    (31, 512, 2, (0.25, 4.0), "quads"), (12, 128, 1, (0.25, 4.0), "quads"),
    (12, 64, 2, (0.25, 1.0), "quads"), (12, 256, 3, (0.25, 4.0), "prefix"),
]


@pytest.mark.parametrize("p_l,c,n_shards,pq,layout", K21_CASES)
def test_k21_model_bitequal_plain_and_jax(p_l, c, n_shards, pq, layout):
    g = hub_graph()
    pg = ep.partition_blocked_graph(g.indptr, g.indices, g.weights, n_shards, light_width=p_l,
                                    block_width=c)
    seen_heavy = 0
    for s in range(n_shards):
        light, biw, _, brp = (t.numpy() for t in ep.local_tables(pg, s))
        recv = requests(g, pg.rows_per_shard, s, p_l, layout, seed=10 * s + c)
        got = model_serve(recv, light, biw, brp, row_base=s * pg.rows_per_shard, p_l=p_l, c=c,
                          p=pq[0], q=pq[1])
        want = ep.ep_propose_plain(torch.from_numpy(recv), *(torch.from_numpy(a) for a in (
            light, biw, brp)), my_shard=s, rows_per_shard=pg.rows_per_shard, light_width=p_l,
            block_width=c, return_param=pq[0], inout_param=pq[1]).numpy()
        np.testing.assert_array_equal(got, want)
        ref = jax_serve(recv, light, biw, brp, my=s, rows_per_shard=pg.rows_per_shard, p_l=p_l,
                        c=c, p=pq[0], q=pq[1])
        np.testing.assert_array_equal(got, ref)
        empty = recv[:, 0] < 0
        assert (got[empty] == -1).all() and (got[~empty, 5] >= 0).all()
        lv = np.clip(recv[:, 0] - s * pg.rows_per_shard, 0, light.shape[0] - 1)
        seen_heavy += int(((light[lv, 0] < -1) & ~empty).sum())
    assert seen_heavy > 0


@pytest.mark.parametrize("k4", [2, 4, 6, 8, 16])
def test_k21_staged_layout_is_a_bijection_read_in_column_order(k4):
    """block_issue then StagedCols: each lane reads its own columns in
    order, staged_at finds every column, and at k4 = 8 (C = 256) the eight
    lanes of a group read eight different 16-byte bank quads at every m."""
    w_row = np.arange(32 * k4, dtype=np.int32) * 3 + 1
    buf = staged_buffer(w_row, k4)
    np.testing.assert_array_equal(staged_lane_runs(buf, k4).reshape(-1), w_row)
    assert [staged_at(buf, j, k4) for j in range(32 * k4)] == w_row.tolist()
    if k4 == 8:
        for m in range(k4):
            quads = {(r * k4 + (m ^ swz(r, k4))) % 8 for r in range(G)}
            assert len(quads) == G


def test_k21_model_walk_equals_jax_ep_walk():
    """The model as the single-shard walk's serve (the plain K20, K22 and
    advance around it) gives JAX's edge_partitioned_blocked_walk's paths on
    dyadic weights at (p, q) = (0.25, 4)."""
    g = hub_graph(seed=3, n=400, hubs=(60, 200))
    n, el, seed = 256, 6, 11
    starts = np.random.default_rng(5).integers(0, g.n_vertices, n).astype(np.int32)
    pg = ep.partition_blocked_graph(g.indptr, g.indices, g.weights, 1)
    tables = ep.local_tables(pg, 0)

    class ModelOps(ep._Plain):
        @staticmethod
        def propose(recv, light, biw, brp, **kw):
            return torch.from_numpy(model_serve(
                recv.numpy(), light.numpy(), biw.numpy(), brp.numpy(), row_base=0,
                p_l=kw["light_width"], c=kw["block_width"], p=kw["return_param"],
                q=kw["inout_param"]))

    walk_kw = dict(walk_length=el, return_param=0.25, inout_param=4.0, max_trials=64)
    carry = ep.init_carry(torch.from_numpy(starts))
    paths = torch.full((n, el + 1), -1, dtype=torch.int32)
    paths[:, 0] = torch.from_numpy(starts)
    n_fb = torch.zeros(1, dtype=torch.int32)
    geo = dict(n_shards=1, capacity=n, rows_per_shard=pg.rows_per_shard)
    ranked = ModelOps.bucket(carry, seed, 0, walk_length=el, **geo)
    for _ in range(ep.max_supersteps(el, 4.0)):
        ranked, pending = ep.superstep(ModelOps, None, "data", tables, carry, paths, n_fb,
                                       ranked, seed, 0, my_shard=0,
                                       light_width=pg.light_width, block_width=pg.block_width,
                                       **geo, **walk_kw)
        if int(pending) == 0:
            break
    _ref_native_loaded()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    ref_pg = ref_ep.partition_blocked_graph(g.indptr, g.indices, g.weights, 1, mesh=mesh)
    want, unfin, _ = ref_ep.edge_partitioned_blocked_walk(
        mesh, ref_pg, jnp.asarray(starts), jnp.arange(n, dtype=jnp.int32), jnp.uint32(seed),
        **walk_kw)
    np.testing.assert_array_equal(paths.numpy(), np.asarray(want))
    assert int(np.asarray(unfin).sum()) == 0


# --------------------------------------------------------------------------- #
# K11: one cooperative launch
# --------------------------------------------------------------------------- #

EMPTY = int(sg.SLOT_EMPTY)


def model_preagg(rows, g_in, g_out, n_vertices: int, n_warps: int):
    """preagg_kernel's three phases, warp w taking rows w + k W in batches
    of 32 (a lane a row's id, slot and head): (ga_in, ga_out, heads, cnt,
    the slot map after, writes of each column in the write phase, adds of
    each column in the add phase)."""
    n, d = g_in.shape
    slot = np.full(n_vertices, EMPTY, np.int64)
    for r in range(n):  # claim: the first occurrence wins
        if rows[r] >= 0:
            slot[rows[r]] = min(slot[rows[r]], r)
    ga_in, ga_out = np.empty_like(g_in), np.empty_like(g_out)
    heads = np.empty(n, np.int32)
    cnt = np.empty(n, F32)
    writes = np.zeros((n, d), np.int32)
    adds = np.zeros((n, d), np.int32)
    if d % 4 == 0:  # lane l takes float4 chunks l, l + 32, ...
        cols = [np.concatenate([np.arange(4 * ch, 4 * ch + 4) for ch in range(lane, d // 4, 32)]
                               or [np.zeros(0, np.int64)]) for lane in range(32)]
    else:  # scalar rows: floats l, l + 32, ...
        cols = [np.arange(lane, d, 32) for lane in range(32)]
    batches = [[list(range(w + k0 * n_warps, min(w + (k0 + 32) * n_warps, n), n_warps))
                for k0 in range(0, -(-(n - w) // n_warps), 32)] for w in range(min(n_warps, n))]
    for w_batches in batches:  # write: a warp's batches from the last down
        for batch in reversed(w_batches):
            for r in batch:
                v = rows[r]
                rep = slot[v] if v >= 0 else -1
                head = v >= 0 and rep == r
                for cl in cols:
                    ga_in[r, cl] = g_in[r, cl] if head else 0
                    ga_out[r, cl] = g_out[r, cl] if head else 0
                    writes[r, cl] += 1
                heads[r] = v if head else (-2 - rep if v >= 0 else -1)
                cnt[r] = 1 if head else 0
    for b in range(max(len(x) for x in batches) if batches else 0):  # add: batch by batch
        for w_batches in batches:
            for r in (w_batches[b] if b < len(w_batches) else []):
                h = int(heads[r])
                if h >= 0:
                    slot[h] = EMPTY
                elif h < -1:
                    rep = -2 - h
                    for cl in cols:
                        ga_in[rep, cl] = (ga_in[rep, cl] + g_in[r, cl]).astype(F32)
                        ga_out[rep, cl] = (ga_out[rep, cl] + g_out[r, cl]).astype(F32)
                        adds[r, cl] += 1
                    cnt[rep] += 1
                    heads[r] = -1
    return ga_in, ga_out, heads, cnt, slot, writes, adds


def jax_segment_sums(rows, g_in, g_out):
    """skipgram.py:409-423 and :431-433: {vertex: (sum g_in, sum g_out,
    count)} from JAX's sorted segments."""
    rows_j = jnp.asarray(np.where(rows >= 0, rows, 0))
    row_valid = jnp.asarray((rows >= 0).astype(np.float32))
    n = rows.shape[0]
    order = jnp.argsort(rows_j)
    r_s = rows_j[order]
    is_first = jnp.concatenate([jnp.ones((1,), bool), r_s[1:] != r_s[:-1]])
    seg = jnp.cumsum(is_first.astype(jnp.int32)) - 1
    head_v = jax.ops.segment_min(r_s, seg, num_segments=n)

    def agg(g):
        return jax.ops.segment_sum((jnp.asarray(g) * row_valid[:, None])[order], seg,
                                   num_segments=n)

    cnt = jax.ops.segment_sum(row_valid[order], seg, num_segments=n)
    ga_in, ga_out = np.asarray(agg(g_in)), np.asarray(agg(g_out))
    head_v, cnt = np.asarray(head_v), np.asarray(cnt)
    n_seg = int(np.asarray(seg)[-1]) + 1
    return {int(head_v[s]): (ga_in[s], ga_out[s], cnt[s]) for s in range(n_seg) if cnt[s] > 0}


def _preagg_rows(case: str, n: int, d: int, n_vertices: int, seed: int):
    rng = np.random.default_rng(seed)
    if case == "distinct":
        rows = rng.permutation(n_vertices)[:n].astype(np.int32)
    elif case == "one_vertex":
        rows = np.full(n, 7, np.int32)
    elif case == "all_dead":
        rows = np.full(n, -1, np.int32)
    else:  # repeats, dead rows (walks < 0) and out-of-vocabulary rows (zero gradients)
        rows = rng.integers(0, n_vertices // 4, n).astype(np.int32)
        rows[rng.random(n) < 0.15] = -1
    g_in = rng.normal(0, 1, (n, d)).astype(F32)
    g_out = rng.normal(0, 1, (n, d)).astype(F32)
    if case == "oov":
        oov = np.isin(rows, np.arange(0, n_vertices // 4, 5))
        g_in[oov] = 0.0
        g_out[oov] = 0.0
    return rows, g_in, g_out


K11_CASES = [  # (case, N, D, warps in the grid)
    ("mixed", 300, 128, 16), ("mixed", 300, 100, 7), ("mixed", 200, 50, 16),
    ("mixed", 90, 600, 3), ("distinct", 256, 128, 16), ("one_vertex", 150, 128, 16),
    ("one_vertex", 150, 100, 5), ("all_dead", 120, 128, 8), ("oov", 300, 128, 16),
    ("oov", 250, 50, 4),
]


@pytest.mark.parametrize("case,n,d,n_warps", K11_CASES)
def test_k11_model_matches_plain_and_jax(case, n, d, n_warps):
    n_v = 400
    rows, g_in, g_out = _preagg_rows(case, n, d, n_v, seed=n + d)
    ga_in, ga_out, heads, cnt, slot, writes, adds = model_preagg(rows, g_in, g_out, n_v,
                                                                n_warps)
    assert (slot == EMPTY).all()  # the map as it was found
    assert (writes == 1).all()  # every column of every row written once
    live = rows >= 0
    first = np.zeros(n, bool)
    first[[int(np.flatnonzero(rows == v)[0]) for v in np.unique(rows[live])]] = True
    np.testing.assert_array_equal(adds.sum(1) > 0, live & ~first)  # the repeats, and only they
    assert (adds[live & ~first] == 1).all()
    want = sg.preagg_rows_plain(torch.from_numpy(rows), torch.from_numpy(g_in),
                                torch.from_numpy(g_out))
    np.testing.assert_array_equal(heads, want[2].numpy())
    np.testing.assert_array_equal(cnt, want[3].numpy())
    for got, ref in ((ga_in, want[0].numpy()), (ga_out, want[1].numpy())):
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(got - ref).max()) <= 1e-5 * scale
    segs = jax_segment_sums(rows, g_in, g_out)
    assert sorted(segs) == sorted(int(v) for v in heads[heads >= 0])
    for r in np.flatnonzero(heads >= 0):
        a, b, c = segs[int(heads[r])]
        assert cnt[r] == c
        np.testing.assert_allclose(ga_in[r], a, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ga_out[r], b, rtol=1e-5, atol=1e-5)
    assert (ga_in[heads < 0] == 0).all() and (cnt[heads < 0] == 0).all()


@pytest.mark.parametrize("optimizer,preagg", [("sgd", False), ("adagrad", True)])
def test_k11_model_in_the_step_matches_jax(monkeypatch, optimizer, preagg):
    """The pre-aggregated steps with the model as K11 (4 warps in the grid)
    against JAX's ``sgns_walk_step`` given JAX's draws (test_torch_sgd's
    batch: dead lanes, out-of-vocabulary positions, repeated negatives)."""
    def model_rows(walks_flat, g_in, g_out, slot=None):
        got = model_preagg(walks_flat.numpy(), g_in.numpy(), g_out.numpy(),
                           int(walks_flat.max()) + 1, 4)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in got[:4])

    monkeypatch.setattr(sg, "preagg_rows", model_rows)
    walks, mask, tables, alias, prob = _batch()
    key = jax.random.PRNGKey(7)
    lr = np.float32(0.1)
    w, s, k = 5, 64, 5
    want = ref_sg.sgns_walk_step(
        *(jnp.asarray(t) for t in tables), jnp.asarray(walks), key, jnp.float32(lr),
        jnp.asarray(alias), jnp.asarray(prob), jnp.asarray(mask), window=w, negatives=k,
        shared_negatives=s, shrink_window=True, preagg=preagg, optimizer=optimizer)
    b_sh, r1, r2 = _draws(key, walks.shape[0], walks.shape[1], w, s)
    state = from_reference_state(*tables, device="cpu")
    loss = sg.sgns_walk_step(*state, torch.from_numpy(walks), b_sh, r1, r2, float(lr),
                             torch.from_numpy(alias), torch.from_numpy(prob),
                             torch.from_numpy(mask), window=w, negatives=k, optimizer=optimizer,
                             preagg=preagg)
    for name, a, b in zip(("emb_in", "emb_out", "acc_in", "acc_out", "loss"),
                          (*to_reference_state(*state), loss.numpy()), want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=name)
