"""Numpy models of two designs, held to the port's plain versions and to the
JAX package:

* K1 ``dense_walk`` (csrc/dense_walk.cu): a warp a walker, lane l owning
  columns [l k, l k + k) of the packed row (k = ceil(P / 32)) in arrays of
  kK, the next power of two >= k.  Whether a row is non-decreasing is
  found when the row is loaded, from the lanes' columns, one shuffle to the
  next lane and one ballot (``dense_row_sorted``), and carried to the next
  step, where it picks the membership test of that step's columns in
  N(prev): a lockstep bisection where N(prev) is sorted (steps of P / 2 ..
  1 and one compare at a power of two P; steps of top .. 1 with bounds
  checks, top the largest power of two <= P, otherwise), the whole scan
  where it is not, and ``scans`` counts those steps.
  The float operations are dense_common.cuh's, in its order (``dense_bias``
  in place, the lane's sum, the xor butterfly, the lanes' inclusive scan,
  the pick of u * total clamped to degree - 1).  Bit-equal to
  ``dense_walk_chunk_plain`` and to JAX's ``dense_walk_chunk`` on dyadic
  graphs with sorted, permuted and repeated-id rows, sinks and dead lanes;
  the counter equal to ``dense.unsorted_steps``.
* K24 ``epd_bucket`` (csrc/epd_walk.cu): one cooperative launch of G blocks
  over tiles of 256 lanes (block b takes ceil(n_tiles / most) contiguous
  tiles), each block's count of each owner before the grid barrier, the
  bases summed over the blocks after it, each lane ranked in its tile
  (within its warp, then across the warps' counts), a warp's sending lanes
  staged H at a time as [cur, prev, u bits, pad, row] in two halves of its
  stage and stored in the send buffer's order (by 16-byte stores on the
  card where a batch fills consecutive slots: the same ints, each once),
  -1 only into the slots past each owner's count.
  Every int of the send buffer written exactly once; bit-equal to
  ``epd_bucket_plain`` and to JAX's bucketing and request pack
  (``edge_partitioned.py:110-136``, written out here in jnp as it is
  inline in ``shard_fn``).

The kernels themselves run only on the card (chip_smoke.py:
``check_dense_walk``, ``edge_cases``, ``edge_cases_k1_orders``,
``check_ep_dense``, ``edge_cases_epd_bucket``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from node2vec_tpu.walk import dense as ref_dense
from node2vec_torch.ops.hashrng import hash_uniform
from node2vec_torch.parallel import edge_partitioned as epd
from node2vec_torch.walk import dense

F32 = np.float32
PAD = 0x7FFFFFFF
TILE, STAGE_INTS = 256, 1088  # epd_walk.cu: kTile, kStageInts


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# K1: the walk
# --------------------------------------------------------------------------- #

def lane_layout(p_cols: int):
    """(k, kK, top, [32, kK] column of each lane's slot, [32, kK] slot on)."""
    k = (p_cols + 31) >> 5
    kk = 1 if k <= 1 else 2 if k <= 2 else 4 if k <= 4 else 8
    top = 1
    while 2 * top <= p_cols:
        top *= 2
    col = np.arange(32)[:, None] * k + np.arange(kk)[None, :]
    on = (np.arange(kk)[None, :] < k) & (col < p_cols)
    return k, kk, top, col, on


def row_sorted_lanes(ids, on, k: int, p_cols: int):
    """dense_row_sorted over [n, 32, kK] lane columns."""
    n, _, kk = ids.shape
    bad = np.zeros((n, 32), bool)
    last = ids[:, :, 0].copy()
    for m in range(1, kk):
        v = on[None, :, m]
        bad |= v & (last > ids[:, :, m])
        last = np.where(v, ids[:, :, m], last)
    nxt = np.concatenate([ids[:, 1:, 0], ids[:, 31:, 0]], 1)  # __shfl_down_sync by 1
    has_next = np.arange(32) * k + k < p_cols
    bad |= has_next[None, :] & (last > nxt)
    return ~bad.any(1)


def members_sorted_lanes(nprev, top: int, ids, pow2: bool):
    """dense_members_sorted<kK, kPow2> over [n, 32, kK] lane columns."""
    p = nprev.shape[1]
    assert not pow2 or p == top
    rows = np.arange(nprev.shape[0])[:, None, None]
    pos = np.zeros(ids.shape, np.int64)
    step = top >> 1 if pow2 else top
    while step > 0:
        s = pos + step
        assert not pow2 or (s <= p).all()  # never past the end
        probe = nprev[rows, np.minimum(s - 1, p - 1)]
        pos = np.where((s <= p) & (probe < ids), s, pos)
        step >>= 1
    return (pos < p) & (nprev[rows, np.minimum(pos, p - 1)] == ids)


def lane_pick(bw, ids, on, k: int, u01):
    """dense_total and dense_pick_k: (total, picked column)."""
    n, _, kk = bw.shape
    lane_sum = np.zeros((n, 32), F32)
    for m in range(kk):
        lane_sum = (lane_sum + bw[:, :, m]).astype(F32)
    total = lane_sum.copy()
    for off in (16, 8, 4, 2, 1):
        total = (total + total[:, np.arange(32) ^ off]).astype(F32)
    tot = total[:, 0]
    incl = lane_sum.copy()
    for off in (1, 2, 4, 8, 16):
        shifted = np.concatenate([np.zeros((n, off), F32), incl[:, :-off]], 1)
        incl = np.where(np.arange(32)[None, :] >= off, (incl + shifted).astype(F32), incl)
    run = np.concatenate([np.zeros((n, 1), F32), incl[:, :-1]], 1)
    u = (u01 * tot).astype(F32)
    below = np.zeros(n, np.int64)
    deg = np.zeros(n, np.int64)
    for m in range(min(k, kk)):
        run = np.where(on[None, :, m], (run + bw[:, :, m]).astype(F32), run)
        below += (on[None, :, m] & (run < u[:, None])).sum(1)
        deg += (on[None, :, m] & (ids[:, :, m] != PAD)).sum(1)
    return tot, np.minimum(below, np.maximum(deg - 1, 0))


def model_dense_walk(adj, starts, gid_base: int, seed: int, *, walk_length: int, p: float,
                     q: float, pow2_search: bool = True):
    """dense_walk_kernel<kK> over every walker at once: (paths, scans)."""
    n_w = starts.shape[0]
    p_cols = adj.shape[1] // 2
    k, kk, top, col, on = lane_layout(p_cols)
    cc = np.minimum(col, p_cols - 1)
    uniform = p == 1.0 and q == 1.0
    inv_p, inv_q = F32(1.0 / p), F32(1.0 / q)
    gids = torch.arange(gid_base, gid_base + n_w, dtype=torch.int64)
    alive = starts >= 0
    paths = np.full((n_w, walk_length + 1), -1, np.int32)
    paths[:, 0] = np.where(alive, starts, -1)
    cur = np.where(alive, starts, 0).astype(np.int64)
    prev = np.full(n_w, -1, np.int64)
    nprev = np.full((n_w, p_cols), PAD, np.int64)
    prev_sorted = np.ones(n_w, bool)
    pow2 = pow2_search and top == p_cols
    scans = 0
    for t in range(walk_length):
        act = alive.copy()
        if not act.any():
            break
        u01 = hash_uniform(seed & 0xFFFFFFFF, gids, t).numpy()
        row = adj[cur]
        ids = np.where(on, row[:, cc], PAD).astype(np.int64)
        bw = np.where(on, row[:, p_cols + cc], 0).astype(np.int32).view(F32)
        row_sorted = np.ones(n_w, bool) if uniform else row_sorted_lanes(ids, on, k, p_cols)
        biased = act & (prev >= 0) & (not uniform)
        scans += int((biased & ~prev_sorted).sum())
        bis = members_sorted_lanes(nprev, top, ids, pow2)
        scan = (nprev[:, None, None, :] == ids[..., None]).any(-1)
        found = np.where(prev_sorted[:, None, None], bis, scan)
        bias = np.where(ids == prev[:, None, None], inv_p, np.where(found, F32(1.0), inv_q))
        bw = np.where(biased[:, None, None] & on, (bw * bias.astype(F32)).astype(F32), bw)
        tot, idx = lane_pick(bw, ids, on, k, u01)
        step = act & (tot > 0)
        alive = act & (tot > 0)
        nxt = row[np.arange(n_w), idx]
        paths[step, t + 1] = nxt[step]
        nprev = np.where(step[:, None], row[:, :p_cols], nprev)
        prev_sorted = np.where(step, row_sorted, prev_sorted)
        prev = np.where(step, cur, prev)
        cur = np.where(step, nxt, cur)
    return paths, scans


def _rows(rng, n: int, p_cols: int, kinds: str):
    """[n, 2P] packed rows, weights {0.5, 1, 2}, every 9th vertex a sink; a
    vertex's row ``sorted`` (ascending, pads at the tail), ``permuted`` (its
    live (id, weight) columns shuffled) or ``repeats`` (sorted with repeated
    ids), taken from ``kinds`` in turn."""
    adj = np.full((n, 2 * p_cols), PAD, np.int32)
    adj[:, p_cols:] = F32(0).view(np.int32)
    kind = {"s": "sorted", "p": "permuted", "r": "repeats"}
    for v in range(n):
        if v % 9 == 4:
            continue
        d = int(rng.integers(1, min(p_cols, 40) + 1))
        how = kind[kinds[v % len(kinds)]]
        if how == "repeats":
            ids = np.sort(rng.integers(0, max(d // 2, 1), d) * 5 % n)
        else:
            ids = np.sort(rng.choice(n, d, replace=False))
        adj[v, :d] = ids
        adj[v, p_cols:p_cols + d] = rng.choice(F32([0.5, 1.0, 2.0]), d).view(np.int32)
        if how == "permuted":  # pads stay at the tail, where the pick's clamp needs them
            perm = rng.permutation(d)
            adj[v, :d] = adj[v, perm]
            adj[v, p_cols:p_cols + d] = adj[v, p_cols + perm]
    return adj


def _starts(n: int, n_w: int):
    starts = (np.arange(n_w) % n).astype(np.int32)
    starts[::7] = -1  # dead lanes
    return starts


PQ = [(0.25, 4.0), (1.0, 1.0), (4.0, 0.25)]


@pytest.mark.parametrize("p_cols", [8, 48, 64, 256])
@pytest.mark.parametrize("pq", PQ)
def test_k1_model_bit_equal_to_plain_and_jax(p_cols, pq):
    """Rows of all three kinds in one graph (so a walk moves between sorted
    and unsorted N(prev)s): the model's paths, the plain version's and
    JAX's are equal, and the model scans exactly the plain count."""
    rng = np.random.default_rng(p_cols + int(pq[0] * 8))
    n = 60
    adj = _rows(rng, n, p_cols, "spr")
    starts = _starts(n, 150)
    p, q = pq
    kw = dict(walk_length=9, return_param=p, inout_param=q)
    got, scans = model_dense_walk(adj, starts, 21, 0xBEEF, walk_length=9, p=p, q=q)
    counter = torch.zeros(1, dtype=torch.int32)
    plain = dense.dense_walk_chunk(torch.from_numpy(adj), torch.from_numpy(starts), 21, 0xBEEF,
                                   scans=counter, **kw).numpy()
    np.testing.assert_array_equal(got, plain)
    want = np.asarray(ref_dense.dense_walk_chunk(
        jnp.asarray(adj), jnp.asarray(starts),
        jnp.arange(21, 21 + len(starts), dtype=jnp.int32), jnp.uint32(0xBEEF), **kw))
    np.testing.assert_array_equal(got, want)
    assert int(counter) == scans
    assert (got[::7] == -1).all() and (got[:, -1] == -1).any()  # dead lanes, sinks
    if pq == (1.0, 1.0):
        assert scans == 0
    else:
        assert scans > 0


@pytest.mark.parametrize("p_cols", [8, 48, 64, 256])
@pytest.mark.parametrize("kinds", ["s", "p", "r"])
def test_k1_model_on_one_kind_of_row(p_cols, kinds):
    """Graphs of one kind of row at (0.25, 4): bit-equal to the plain
    version; no scan where every row is sorted (repeated ids included), and
    the bisection with bounds checks answers what the one without does."""
    rng = np.random.default_rng(3 * p_cols + len(kinds))
    n = 50
    adj = _rows(rng, n, p_cols, kinds)
    starts = _starts(n, 120)
    got, scans = model_dense_walk(adj, starts, 0, 5, walk_length=8, p=0.25, q=4.0)
    again, _ = model_dense_walk(adj, starts, 0, 5, walk_length=8, p=0.25, q=4.0,
                                pow2_search=False)
    plain = dense.dense_walk_chunk_plain(torch.from_numpy(adj), torch.from_numpy(starts), 0, 5,
                                         walk_length=8, return_param=0.25,
                                         inout_param=4.0).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(again, plain)
    assert scans == dense.unsorted_steps(torch.from_numpy(adj), torch.from_numpy(plain), False)
    assert (scans > 0) == (kinds == "p")


@pytest.mark.parametrize("p_cols", [8, 33, 48, 64, 256])
def test_k1_row_order_from_the_lanes(p_cols):
    """dense_row_sorted's lanes, a shuffle and a ballot, answer whether the
    row is non-decreasing, on sorted rows (pads at the tail), rows with one
    adjacent pair swapped anywhere (within a lane's columns or across two
    lanes), repeated ids and all-pad rows."""
    rng = np.random.default_rng(p_cols)
    k, _, _, col, on = lane_layout(p_cols)
    rows = []
    for d in (0, 1, p_cols // 2, p_cols):
        base = np.full(p_cols, PAD, np.int64)
        base[:d] = np.sort(rng.integers(0, 4 * p_cols, d))
        rows.append(base)
        for c in range(p_cols - 1):
            if base[c] != base[c + 1]:
                sw = base.copy()
                sw[c], sw[c + 1] = sw[c + 1], sw[c]
                rows.append(sw)
    rows = np.stack(rows)
    ids = np.where(on, rows[:, np.minimum(col, p_cols - 1)], PAD)
    srt = row_sorted_lanes(ids, on, k, p_cols)
    np.testing.assert_array_equal(srt, ~(rows[:, 1:] < rows[:, :-1]).any(1))


@pytest.mark.parametrize("p_cols", [8, 64, 256])
def test_k1_bisection_without_bounds_equals_set_membership(p_cols):
    """At a power of two P, dense_members_sorted<kK, true> (steps of P / 2
    .. 1, one compare) and the bounded form both answer set membership, on
    sorted rows with pads at the tail and repeated ids, for every id in the
    row, around it, and the pad."""
    rng = np.random.default_rng(p_cols + 1)
    for trial in range(30):
        d = int(rng.integers(0, p_cols + 1))
        hi = 3 * p_cols if trial % 2 else max(d // 3, 1)
        nprev = np.full(p_cols, PAD, np.int64)
        nprev[:d] = np.sort(rng.integers(0, hi, d))
        xs = np.array(sorted(set(nprev[:d].tolist()) | set(range(-2, hi + 2)) | {PAD, PAD - 1}),
                      np.int64)
        want = (nprev[None, :] == xs[:, None]).any(1)
        for pow2 in (True, False):
            got = members_sorted_lanes(nprev[None, :], p_cols, xs[None, :, None], pow2)
            np.testing.assert_array_equal(got[0, :, 0], want)


def test_k1_scans_counter_through_the_wrapper():
    """``dense_walk_chunk(scans=)`` on CPU tensors adds the unsorted steps
    to the counter, call after call, and refuses nothing it should take."""
    rng = np.random.default_rng(9)
    adj = torch.from_numpy(_rows(rng, 40, 16, "sp"))
    starts = torch.from_numpy(_starts(40, 80))
    counter = torch.zeros(1, dtype=torch.int32)
    paths = dense.dense_walk_chunk(adj, starts, 0, 1, walk_length=6, return_param=0.5,
                                   inout_param=2.0, scans=counter)
    once = int(counter)
    assert once == dense.unsorted_steps(adj, paths, False) > 0
    dense.dense_walk_chunk(adj, starts, 0, 1, walk_length=6, return_param=0.5, inout_param=2.0,
                           scans=counter)
    assert int(counter) == 2 * once
    assert dense.unsorted_steps(adj, paths, True) == 0


# --------------------------------------------------------------------------- #
# K24: the bucketing
# --------------------------------------------------------------------------- #

def tile_offsets(active, dest, n_shards: int):
    """tile_offset over one tile: the active lanes of each lane's bucket
    earlier in the tile (within its warp by the match, across the warps by
    the scan of the per-warp counts) and the tile's count of each bucket."""
    m = active.shape[0]
    wc = np.zeros((n_shards, -(-m // 32)), np.int64)
    below = np.zeros(m, np.int64)
    for w0 in range(0, m, 32):
        a, d = active[w0:w0 + 32], dest[w0:w0 + 32]
        for j in range(len(a)):
            below[w0 + j] = int((a[:j] & (d[:j] == d[j])).sum())
        for b in np.unique(d[a]):
            wc[b, w0 // 32] = int((a & (d == b)).sum())
    excl = np.cumsum(wc, 1) - wc
    return excl[dest, np.arange(m) // 32] + below, wc.sum(1)


def model_bucket(carry, prev_rows, u, *, n_shards: int, capacity: int, rows_per_shard: int,
                 walk_length: int, most: int):
    """epd_bucket_kernel on a grid of at most ``most`` resident blocks:
    (send, slot, writes a send int got)."""
    n, p_cols = prev_rows.shape
    F, rs = 3 + p_cols, p_cols + 4
    H = min(STAGE_INTS // (2 * rs), 32)  # lanes a batch, a half of the stage
    n_req = n_shards * capacity
    n_tiles = max(-(-n // TILE), 1)
    per = -(-n_tiles // most)
    grid = -(-n_tiles // per)
    lanes = np.arange(n_tiles * TILE)
    live = lanes < n
    li = np.minimum(lanes, max(n - 1, 0))
    alive = live & (carry[2, li] != 0) if n else live
    active = alive & (carry[3, li] < walk_length) if n else live
    owner = np.minimum(np.maximum(carry[0, li], 0) // rows_per_shard, n_shards - 1) if n else li
    dest = np.where(active, owner, 0)
    blk = np.zeros((grid, n_shards), np.int64)
    for b in range(grid):
        sel = slice(b * per * TILE, min((b + 1) * per, n_tiles) * TILE)
        blk[b] = np.bincount(dest[sel][active[sel]], minlength=n_shards)
    pre = np.cumsum(blk, 0) - blk
    tot = blk.sum(0)
    send = np.full((n_req, F), 0x5A5A5A5A, np.int64)
    writes = np.zeros((n_req, F), np.int64)
    slot = np.zeros(n, np.int64)
    for b in range(grid):
        run = pre[b].copy()
        for t in range(b * per, min((b + 1) * per, n_tiles)):
            sel = slice(t * TILE, (t + 1) * TILE)
            off, tt = tile_offsets(active[sel], dest[sel], n_shards)
            rank = run[dest[sel]] + off
            flat = np.where(active[sel] & (rank < capacity), dest[sel] * capacity + rank, n_req)
            i = lanes[sel]
            slot[i[i < n]] = flat[i < n]
            for w0 in range(0, TILE, 32):  # a warp: batches of H lanes staged
                fl = np.where(flat[w0:w0 + 32] < n_req, flat[w0:w0 + 32], -1)
                for j0 in range(0, 32, H):
                    g = min(H, 32 - j0)
                    if (fl[j0:j0 + g] < 0).all():
                        continue
                    st = np.zeros((g, rs), np.int64)
                    for r in range(g):
                        lane = t * TILE + w0 + j0 + r
                        if fl[j0 + r] >= 0:
                            st[r, :3] = (carry[0, lane], carry[1, lane],
                                         u[lane:lane + 1].view(np.int32)[0])
                            st[r, 4:] = prev_rows[lane]
                    q = np.arange(g * F)
                    r, f = q // F, q % F
                    dst = fl[j0 + r]
                    keep = dst >= 0
                    vals = st.reshape(-1)[r * rs + f + (f >= 3)]
                    send[dst[keep], f[keep]] = vals[keep]
                    np.add.at(writes, (dst[keep], f[keep]), 1)
            run += tt
    # grid_fill: the unfilled slots of each bucket, as a flat run over the grid
    filled = np.minimum(tot, capacity)
    ends = np.concatenate([[0], np.cumsum((capacity - filled) * F)])
    for v in range(int(ends[-1])):
        lo = int(np.searchsorted(ends, v, side="right")) - 1
        flat_int = (lo * capacity + filled[lo]) * F + (v - ends[lo])
        send.reshape(-1)[flat_int] = -1
        writes.reshape(-1)[flat_int] += 1
    return send.astype(np.int32), slot.astype(np.int32), writes


def jax_bucket(carry, prev_rows, u, *, n_shards: int, capacity: int, rows_per_shard: int,
               walk_length: int):
    """The JAX bucketing and request pack (``edge_partitioned.py:110-136``)
    written out in jnp: (send [S*cap, 3 + P], flat slot [n])."""
    cur, prev, alive, cursor = (jnp.asarray(carry[r]) for r in range(4))
    active = (alive != 0) & (cursor < walk_length)
    owner = jnp.clip(jnp.maximum(cur, 0) // rows_per_shard, 0, n_shards - 1)
    dest = jnp.where(active, owner, 0)
    onehot = (dest[:, None] == jnp.arange(n_shards)[None, :]) & active[:, None]
    slot_in_dest = jnp.cumsum(onehot.astype(jnp.int32), axis=0) - 1
    my_slot = jnp.sum(jnp.where(onehot, slot_in_dest, 0), axis=1)
    sendable = active & (my_slot < capacity)
    flat_slot = jnp.where(sendable, dest * capacity + my_slot, n_shards * capacity)
    req = jnp.concatenate([cur[:, None], prev[:, None],
                           jax.lax.bitcast_convert_type(jnp.asarray(u), jnp.int32)[:, None],
                           jnp.asarray(prev_rows)], axis=1)
    send = jnp.full((n_shards * capacity + 1, req.shape[1]), -1, jnp.int32).at[flat_slot].set(
        jnp.where(sendable[:, None], req, -1))[:-1]
    return np.asarray(send), np.asarray(flat_slot)


def _carry(rng, n: int, p_cols: int, n_vertices: int, walk_length: int):
    """A mid-walk state: dead lanes, finished lanes (cursor = L), lanes at
    first order (prev -1), carried rows of ids, uniforms in [0, 1)."""
    carry = np.zeros((4, n), np.int32)
    carry[0] = rng.integers(0, n_vertices, n)
    carry[1] = np.where(rng.random(n) < 0.2, -1, rng.integers(0, n_vertices, n))
    carry[2] = rng.random(n) > 0.15
    carry[3] = np.where(rng.random(n) < 0.2, walk_length, rng.integers(0, walk_length, n))
    prev_rows = rng.integers(0, n_vertices, (n, p_cols)).astype(np.int32)
    u = rng.random(n).astype(F32)
    return carry, prev_rows, u


@pytest.mark.parametrize("n", [1, 1000, 1300])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("cap_part", [1, 4])
def test_k24_model_bit_equal_to_plain_and_jax(n, n_shards, cap_part):
    """Whole buffers: the model's send and slot, the plain version's and
    JAX's are equal; every int of the send buffer is written once (a
    request's or a fill's); capacities that overflow defer lanes."""
    rng = np.random.default_rng(n + 10 * n_shards + cap_part)
    p_cols, L, n_v = 8 if n_shards == 8 else 64 if n_shards == 1 else 48, 10, 5000
    carry, prev_rows, u = _carry(rng, n, p_cols, n_v, L)
    rps = -(-n_v // n_shards)
    capacity = max(n // (n_shards * cap_part), 1)
    kw = dict(n_shards=n_shards, capacity=capacity, rows_per_shard=rps, walk_length=L)
    plain_send, plain_slot = (x.numpy() for x in epd.epd_bucket_plain(
        torch.from_numpy(carry), torch.from_numpy(prev_rows), torch.from_numpy(u), **kw))
    want_send, want_slot = jax_bucket(carry, prev_rows, u, **kw)
    np.testing.assert_array_equal(plain_send, want_send)
    np.testing.assert_array_equal(plain_slot, want_slot)
    for most in (1, 3, 7):
        send, slot, writes = model_bucket(carry, prev_rows, u, most=most, **kw)
        np.testing.assert_array_equal(send, plain_send)
        np.testing.assert_array_equal(slot, plain_slot)
        assert (writes == 1).all()
    if cap_part > 1 and n > 1:
        assert (plain_slot == n_shards * capacity).sum() > ((carry[2] == 0) | (carry[3] >= L)).sum()


def test_k24_model_with_no_lane_and_no_active_lane():
    """A rank with no walker still fills its send buffer with -1, and so
    does one whose every lane is dead or finished."""
    for n in (0, 40):
        carry = np.zeros((4, n), np.int32)
        carry[3] = 5
        prev_rows = np.zeros((n, 16), np.int32)
        u = np.zeros(n, F32)
        kw = dict(n_shards=2, capacity=3, rows_per_shard=10, walk_length=5)
        send, slot, writes = model_bucket(carry, prev_rows, u, most=4, **kw)
        assert (send == -1).all() and (writes == 1).all() and (slot == 6).all()
        plain = epd.epd_bucket_plain(torch.from_numpy(carry), torch.from_numpy(prev_rows),
                                     torch.from_numpy(u), **kw)
        np.testing.assert_array_equal(send, plain[0].numpy())
