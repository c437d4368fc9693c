"""Numpy models of two designs, held to the port's plain versions and to the
JAX package:

* K25 ``epd_serve`` (csrc/epd_walk.cu): owner(cur) serves a request with a
  warp, lane l owning columns [l K, l K + K) of the staged row (K =
  ceil(P / 32)).  N(prev) is tested for order with one ballot over its
  adjacent pairs; a sorted N(prev) answers each column's membership by a
  bisection (steps of top, top / 2, ..., 1, top the largest power of two <=
  P, then one compare), an unsorted one by the whole scan, and ``scans``
  counts those requests.  The float operations are dense_common.cuh's: the
  bias multiplied in place, the lane's sum of its columns, the total as a
  xor butterfly, the lanes' inclusive scan, the pick of u * total clamped to
  degree - 1.  Bit-equal to ``epd_serve_plain`` and to the JAX serve
  (``edge_partitioned.py:143-177``, written out here in jnp as it is inline
  in ``shard_fn``) on dyadic weights, on sorted rows with pads, unsorted rows
  and rows with repeated ids, first-order requests and empty slots, at
  P = 8, 48 and 64; the model serving a single-shard walk gives JAX's
  ``edge_partitioned_walk``'s paths;
* K3's squares mode ``adagrad_accumulate_squares`` (csrc/adagrad.cu): a few
  large blocks striding over quads of entries, dead entries dropped, an
  acc_out row below the hot bound summed in the block's array (flushed once,
  from the block's own offset), any other key summed among a warp's lanes
  that hold it in the same slot (``peers_sum``'s order) and added at once.
  Equal to ``adagrad_accumulate_squares_plain`` where every sum is exact and
  within rtol 1e-5 of it and of JAX's ``.at[].add`` (``cbow.py:306-320``,
  ``sharded_sgns.py:106-117``), every entry counted once.

The kernels themselves run only on the card (chip_smoke.py:
``check_ep_dense``, ``edge_cases_wide_rows``, ``edge_cases_epd_serve``,
``edge_cases_k3``, ``check_cbow``, ``check_col_sgns``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from node2vec_torch.parallel import edge_partitioned as epd
from test_torch_edge_partitioned import SEED, L, W, _jax_draws, _jax_walk, _packed

F32 = np.float32
PAD = 0x7FFFFFFF
MAX_K = 8  # dense_common.cuh: kDenseMaxK


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# K25: the serve
# --------------------------------------------------------------------------- #

def member_sorted(nprev, top: int, x: int) -> bool:
    """dense_member_sorted: the lower bound by steps of top .. 1, one compare."""
    p = len(nprev)
    pos, step = 0, top
    while step > 0:
        if pos + step <= p and nprev[pos + step - 1] < x:
            pos += step
        step >>= 1
    return pos < p and nprev[pos] == x


def nprev_sorted(nprev) -> bool:
    """dense_nprev_sorted: no adjacent pair falls (the lanes' ballot)."""
    return not any(nprev[c] > nprev[c + 1] for c in range(len(nprev) - 1))


def member_sorted_lanes(nprev, top: int, x):
    """dense_member_sorted over arrays: nprev [n, P], x [n, ...]."""
    p = nprev.shape[1]
    rows = np.arange(nprev.shape[0]).reshape((-1,) + (1,) * (x.ndim - 1))
    pos = np.zeros(x.shape, np.int64)
    step = top
    while step > 0:
        ok = pos + step <= p
        probe = nprev[rows, np.minimum(pos + step - 1, p - 1)]
        pos = np.where(ok & (probe < x), pos + step, pos)
        step >>= 1
    return (pos < p) & (nprev[rows, np.minimum(pos, p - 1)] == x)


def model_serve(recv, adj, *, row_base: int, p: float, q: float):
    """epd_serve_kernel over every request at once (each independent of the
    others; lanes and a lane's columns as the kernel lays them out): ([n_req,
    1 + P], requests served by the whole scan)."""
    n_req = recv.shape[0]
    p_cols = adj.shape[1] // 2
    k = (p_cols + 31) >> 5
    top = 1
    while 2 * top <= p_cols:
        top *= 2
    inv_p, inv_q = F32(1.0 / p), F32(1.0 / q)
    uniform = p == 1.0 and q == 1.0
    resp = np.full((n_req, 1 + p_cols), -1, np.int32)
    valid = recv[:, 0] >= 0
    rq = recv[valid]
    n = rq.shape[0]
    if n == 0:
        return resp, 0
    prev = rq[:, 1].astype(np.int64)
    u01 = rq[:, 2].copy().view(F32)
    lv = np.clip(rq[:, 0].astype(np.int64) - row_base, 0, adj.shape[0] - 1)
    srow = adj[lv]
    nprev = rq[:, 3:3 + p_cols].astype(np.int64)
    col = np.arange(32)[:, None] * k + np.arange(MAX_K)[None, :]  # [lane, m]
    on = (np.arange(MAX_K)[None, :] < k) & (col < p_cols)
    cc = np.minimum(col, p_cols - 1)
    ids = np.where(on, srow[:, cc], PAD).astype(np.int64)  # [n, 32, MAX_K]
    bw = np.where(on, srow[:, p_cols + cc], 0).astype(np.int32).view(F32)
    biased = (prev >= 0) & (not uniform)
    srt = ~(nprev[:, 1:] < nprev[:, :-1]).any(1)
    scans = int((biased & ~srt).sum())
    bis = member_sorted_lanes(nprev, top, ids)
    scan = (nprev[:, None, None, :] == ids[..., None]).any(-1)
    shared = np.where(srt[:, None, None], bis, scan)
    bias = np.where(ids == prev[:, None, None], inv_p, np.where(shared, F32(1.0), inv_q))
    bw = np.where(biased[:, None, None] & on, (bw * bias.astype(F32)).astype(F32), bw)
    lane_sum = np.zeros((n, 32), F32)
    for m in range(MAX_K):
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
    for m in range(min(k, MAX_K)):
        run = np.where(on[None, :, m], (run + bw[:, :, m]).astype(F32), run)
        below += (on[None, :, m] & (run < u[:, None])).sum(1)
        deg += (on[None, :, m] & (ids[:, :, m] != PAD)).sum(1)
    idx = np.minimum(below, np.maximum(deg - 1, 0))
    out = resp[valid]
    out[:, 0] = np.where(tot > 0, srow[np.arange(n), idx], -1)
    out[:, 1:] = srow[:, :p_cols]
    resp[valid] = out
    return resp, scans


def jax_serve(recv, adj, *, row_base: int, p: float, q: float):
    """The JAX serve (``edge_partitioned.py:143-177``) written out in jnp:
    [n_req, 1 + P]; an empty slot answers -1 in field 0 and the clamped
    row in the others, which the home never reads."""
    from node2vec_tpu.ops.sampling import prefix_sums
    from node2vec_tpu.walk.dense import shared_neighbor_mask

    recv, adj = jnp.asarray(recv), jnp.asarray(adj)
    p_cols = adj.shape[1] // 2
    lane = jax.lax.broadcasted_iota(jnp.int32, (recv.shape[0], p_cols), 1)
    r_cur = recv[:, 0]
    r_valid = r_cur >= 0
    r_prev = recv[:, 1]
    r_u = jax.lax.bitcast_convert_type(recv[:, 2], jnp.float32)
    local_row = jnp.clip(jnp.where(r_valid, r_cur - row_base, 0), 0, adj.shape[0] - 1)
    packed = adj[local_row]
    rows = packed[:, :p_cols]
    wts = jax.lax.bitcast_convert_type(packed[:, p_cols:], jnp.float32)
    uniform = p == 1.0 and q == 1.0
    inv_p, inv_q = (1.0, 1.0) if uniform else (np.float32(1.0 / p), np.float32(1.0 / q))
    back = rows == r_prev[:, None]
    shared = shared_neighbor_mask(rows, recv[:, 3:])
    bias = jnp.where(back, inv_p, jnp.where(shared, 1.0, inv_q))
    bias = jnp.where((r_prev < 0)[:, None], 1.0, bias)
    bw = wts * bias
    total = jnp.sum(bw, axis=1)
    cdf = prefix_sums(bw)
    degree = jnp.sum((rows != PAD).astype(jnp.int32), axis=1)
    pick = jnp.minimum(jnp.sum((cdf < (r_u * total)[:, None]).astype(jnp.int32), axis=1),
                       jnp.maximum(degree - 1, 0))
    nxt = jnp.sum(jnp.where(lane == pick[:, None], rows, 0), axis=1)
    nxt = jnp.where(r_valid & (total > 0), nxt, -1)
    return np.asarray(jnp.concatenate([nxt[:, None], rows], axis=1))


def _dyadic_adjacency(rng, n: int, p_cols: int, max_deg: int, order: str):
    """[n, 2P] packed rows of 1..max_deg neighbours (some sinks), weights
    {0.5, 1, 2}: ``sorted`` ascending with pads at the tail, ``unsorted``
    shuffled (pads kept at the tail), ``repeats`` with repeated ids."""
    adj = np.full((n, 2 * p_cols), PAD, np.int32)
    adj[:, p_cols:] = np.float32(0).view(np.int32)
    for v in range(n):
        if v % 11 == 5:
            continue  # a sink
        d = int(rng.integers(1, max_deg + 1))
        if order == "repeats":
            ids = np.sort(rng.integers(0, max(d // 2, 1), d) * 7 % n)
        else:
            ids = np.sort(rng.choice(n, d, replace=False))
            if order == "unsorted":
                rng.shuffle(ids)
        adj[v, :d] = ids
        adj[v, p_cols:p_cols + d] = rng.choice(F32([0.5, 1.0, 2.0]), d).view(np.int32)
    return adj


def _requests(rng, adj, n_req: int, empty_every: int = 5):
    """Requests at one shard: cur a vertex, prev one of its neighbours (or
    -1, first order), N(prev) = prev's row ids, u dyadic; every
    ``empty_every``-th slot empty."""
    n, p2 = adj.shape
    p_cols = p2 // 2
    recv = np.full((n_req, 3 + p_cols), -1, np.int32)
    for r in range(n_req):
        if r % empty_every == 3:
            continue
        prev = int(rng.integers(0, n)) if r % 7 else -1
        cur = int(rng.integers(0, n))
        if prev >= 0:
            row = adj[prev, :p_cols]
            live = row[row != PAD]
            if len(live):
                cur = int(live[rng.integers(0, len(live))]) % n
        recv[r, 0], recv[r, 1] = cur, prev
        recv[r, 2] = np.array([rng.integers(0, 256) / 256.0], F32).view(np.int32)[0]
        recv[r, 3:] = adj[prev, :p_cols] if prev >= 0 else PAD
    return recv


@pytest.mark.parametrize("p_cols", [8, 48, 64])
@pytest.mark.parametrize("order", ["sorted", "unsorted", "repeats"])
@pytest.mark.parametrize("pq", [(0.25, 4.0), (1.0, 1.0), (2.0, 0.5)])
def test_k25_model_bit_equal_to_plain_and_jax(p_cols, order, pq):
    """The model's responses, the plain version's and JAX's are equal in
    every field of a valid request (JAX's empty slots carry a row nobody
    reads), and the model scans exactly the unsorted biased requests."""
    rng = np.random.default_rng(p_cols * 7 + len(order))
    n = 40
    adj = _dyadic_adjacency(rng, n, p_cols, min(p_cols, 30), order)
    recv = _requests(rng, adj, 90)
    p, q = pq
    got, scans = model_serve(recv, adj, row_base=0, p=p, q=q)
    kw = dict(my_shard=0, rows_per_shard=n, return_param=p, inout_param=q)
    plain = epd.epd_serve_plain(torch.from_numpy(recv), torch.from_numpy(adj), **kw).numpy()
    np.testing.assert_array_equal(got, plain)
    want = jax_serve(recv, adj, row_base=0, p=p, q=q)
    valid = recv[:, 0] >= 0
    np.testing.assert_array_equal(got[valid], want[valid])
    np.testing.assert_array_equal(got[~valid, 0], want[~valid, 0])
    uniform = p == 1.0 and q == 1.0
    assert scans == epd.unsorted_requests(torch.from_numpy(recv), p_cols, uniform)
    if order == "unsorted" and not uniform:
        assert scans > 0
    else:
        assert scans == 0
    counter = torch.zeros(1, dtype=torch.int32)
    again = epd.epd_serve(torch.from_numpy(recv), torch.from_numpy(adj), scans=counter, **kw)
    np.testing.assert_array_equal(again.numpy(), plain)
    assert int(counter) == scans


@pytest.mark.parametrize("p_cols", [8, 48, 64, 256])
def test_k25_bisection_equals_set_membership(p_cols):
    """dense_member_sorted on sorted N(prev)s with pads at the tail and with
    repeated ids: every id in the row and around it, and the pad itself."""
    rng = np.random.default_rng(p_cols)
    top = 1
    while 2 * top <= p_cols:
        top *= 2
    for trial in range(40):
        d = int(rng.integers(0, p_cols + 1))
        hi = 3 * p_cols if trial % 2 else max(d // 3, 1)
        nprev = np.full(p_cols, PAD, np.int64)
        nprev[:d] = np.sort(rng.integers(0, hi, d))
        assert nprev_sorted(nprev)
        probes = set(nprev[:d].tolist()) | set(range(-2, hi + 2)) | {PAD, PAD - 1}
        xs = np.array(sorted(probes), np.int64)
        got = member_sorted_lanes(nprev[None, :], top, xs[None, :])[0]
        np.testing.assert_array_equal(got, (nprev[None, :] == xs[:, None]).any(1))
        assert all(member_sorted(nprev, top, int(x)) == g for x, g in zip(xs[:8], got[:8]))


def test_k25_model_serves_a_walk_equal_to_jax():
    """The model as the serve of the port's superstep at one shard (K24 and
    K26 by their plain versions), given JAX's draws, walks JAX's
    ``edge_partitioned_walk``'s paths."""
    rng = np.random.default_rng(2)
    n = 64
    src = rng.integers(0, n, 500).astype(np.int32)
    dst = rng.integers(0, n, 500).astype(np.int32)
    keep = src != dst
    w = rng.choice(F32([0.5, 1.0, 2.0]), int(keep.sum()))
    _, packed = _packed(src[keep], dst[keep], w, n_vertices=n)
    starts = (np.arange(W) % n).astype(np.int32)
    p, q = 0.5, 2.0
    want = _jax_walk(packed, 1, starts, p, q, 0)
    draws = _jax_draws(1)[0]

    class ModelOps(epd._Plain):
        @staticmethod
        def serve(recv, adj, *, my_shard, rows_per_shard, return_param, inout_param):
            resp, _ = model_serve(recv.numpy(), adj.numpy(), row_base=my_shard * rows_per_shard,
                                  p=return_param, q=inout_param)
            return torch.from_numpy(resp)

    adj = torch.from_numpy(packed)
    st = torch.from_numpy(starts)
    carry = epd.init_carry(st)
    prev_rows = torch.full((W, packed.shape[1] // 2), PAD, dtype=torch.int32)
    paths = torch.full((W, L + 1), -1, dtype=torch.int32)
    paths[:, 0] = st
    for t in range(epd.max_supersteps(L)):
        pending = epd.superstep(ModelOps, None, "data", adj, carry, prev_rows, paths,
                                torch.from_numpy(draws[t]), n_shards=1, capacity=W,
                                rows_per_shard=n, my_shard=0, walk_length=L, return_param=p,
                                inout_param=q)
        if int(pending) == 0:
            break
    np.testing.assert_array_equal(paths.numpy(), want)
    assert SEED == 7 and (want[:, 1] >= 0).any()


# --------------------------------------------------------------------------- #
# K3's squares mode: quads, dead entries dropped, a warp's slot, a block's table
# --------------------------------------------------------------------------- #

SQ_THREADS, SQ_HOT, SQ_HOT_MIN = 512, 8192, 256  # adagrad.cu: kSqThreads, kSqHot, kSqHotMin
TAG_IN = 0x80000000


def peers_sum(x, peers_of):
    """peers_sum over a warp: x [32] float32, peers_of [32] bitmasks; the
    kernel's loop (each lane adds the next remaining peer above it, lanes of
    odd rank leave) run lane by lane, so its float order is the kernel's."""
    x = x.astype(F32).copy()
    lanes = np.arange(32)
    rank = np.array([bin(peers_of[l] & ((1 << l) - 1)).count("1") for l in lanes])
    above = np.array([peers_of[l] & ((0xFFFFFFFE << l) & 0xFFFFFFFF) for l in lanes], np.int64)
    while (above != 0).any():
        nxt = np.array([(int(a) & -int(a)).bit_length() for a in above])  # __ffs
        t = np.array([x[n - 1] if n > 0 else x[l] for l, n in zip(lanes, nxt)], F32)
        x = np.where(nxt > 0, (x + t).astype(F32), x)
        done = sum(1 << int(l) for l in lanes if rank[l] & 1)
        above &= ~done
        rank >>= 1
    return x


def model_squares(acc_in, acc_out, lists, div, threads=SQ_THREADS, unroll=1, grid=528,
                  hot=SQ_HOT, hot_min=SQ_HOT_MIN):
    """adagrad_accumulate_squares_kernel, block by block and pass by pass
    (``grid`` the blocks the card holds; ``unroll`` quads a thread a pass, 1
    in the kernel, 2 to hold a thread's quads apart), in place on numpy
    accumulators: an acc_out row below ``hot`` into the block's array where
    the pass holds ``hot_min`` such entries or more (the array flushed once,
    from the block's own offset), any other live key added at once, summed
    first with its equals in its warp's slot where two adjacent lanes of the
    slot hold one key.  Returns the global atomics issued."""
    div = F32(div)
    lens = [-(-len(lists[2 * k + 1]) // 4) for k in range(3)]
    n_quads = sum(lens)
    per_pass = threads * unroll
    blocks = min(grid, -(-n_quads // per_pass))
    atomics = 0

    def entry(g):
        """(tags, ids, squares over D) of quad g, ids -1 where dead or past the lists."""
        for k in range(3):
            if g < lens[k]:
                sq, rows = lists[2 * k], lists[2 * k + 1]
                ids = np.full(4, -1, np.int64)
                xs = np.zeros(4, F32)
                e = np.arange(4 * g, min(4 * g + 4, len(rows)))
                ids[:len(e)] = rows[e]
                xs[:len(e)] = (sq[e] / div).astype(F32)
                return (TAG_IN if k == 0 else 0), ids, xs
            g -= lens[k]
        return 0, np.full(4, -1, np.int64), np.zeros(4, F32)

    for b in range(blocks):
        arr = np.zeros(hot, F32)
        zeroed = False
        for base in range(b * per_pass, n_quads, blocks * per_pass):
            passq = [[entry(base + j * threads + t) for t in range(threads)]
                     for j in range(unroll)]
            n_hot = sum(int(((q[1] >= 0) & (q[1] < hot)).sum()) for qs in passq for q in qs
                        if q[0] == 0)
            use = n_hot >= hot_min
            zeroed |= use
            for j in range(unroll):
                quads = passq[j]
                for i in range(4):
                    for w in range(threads // 32):
                        tags = [quads[32 * w + l][0] for l in range(32)]
                        ids = [int(quads[32 * w + l][1][i]) for l in range(32)]
                        xs = np.array([quads[32 * w + l][2][i] for l in range(32)], F32)
                        cold = []
                        for l in range(32):
                            if use and ids[l] >= 0 and tags[l] == 0 and ids[l] < hot:
                                arr[ids[l]] = F32(arr[ids[l]] + xs[l])
                                cold.append(None)
                            else:
                                cold.append((ids[l] | tags[l]) if ids[l] >= 0 else None)
                        keys = [c if c is not None else -1 - l for l, c in enumerate(cold)]
                        if any(keys[l] == keys[l - 1] for l in range(1, 32)):  # the gate
                            peers = np.array([sum(1 << m for m in range(32)
                                                  if keys[m] == keys[l]) for l in range(32)])
                        else:
                            peers = np.array([1 << l for l in range(32)])
                        sums = peers_sum(xs, peers)
                        for l in range(32):
                            lead = (int(peers[l]) & -int(peers[l])).bit_length() - 1 == l
                            if cold[l] is not None and lead:
                                acc = acc_in if tags[l] else acc_out
                                acc[ids[l]] = F32(acc[ids[l]] + sums[l])
                                atomics += 1
        start = (b * hot // blocks) & ~31
        for i in range(hot if zeroed else 0):
            r = (start + i) % hot
            if arr[r] != 0:
                acc_out[r] = F32(acc_out[r] + arr[r])
                atomics += 1
    return atomics


def _square_lists(rng, kind: str, n=(700, 2300, 40), n_acc=600):
    """(sq_in, rows_in, sq_out, rows_out, sq_extra, rows_extra) as numpy."""
    out = []
    for k, m in enumerate(n):
        if kind == "one_id":
            rows = np.full(m, 3, np.int32)
        elif kind == "dead":
            rows = np.full(m, -1, np.int32)
        elif kind == "tail":  # a CBOW-HS tail: levels of a BFS tree, dead past a code
            lvl = np.arange(m) % 9
            rows = ((1 << lvl) - 1 + rng.integers(0, 1 << lvl, m) % 64).astype(np.int32) % n_acc
            rows[rng.random(m) < 0.1] = -1
        else:  # "pairs": a pair list's centers, repeated, with dead lanes
            rows = np.repeat(rng.integers(0, n_acc, -(-m // 10)), 10)[:m].astype(np.int32)
            rows[rng.random(m) < 0.4] = -1
        sq = rng.integers(1, 64, m).astype(F32) / F32(4)  # sums exact in fp32
        out += [sq, rows]
    return out


@pytest.mark.parametrize("kind", ["pairs", "tail", "one_id", "dead"])
@pytest.mark.parametrize("geometry", [(64, 1, 4, 256, 16), (32, 2, 3, 64, 8),
                                      (64, 1, 4, 256, SQ_HOT_MIN)])
def test_k3_squares_model_to_plain_and_jax(kind, geometry):
    """The model's accumulators equal the plain version's (every entry
    counted once: its squares and the accumulators are quarters, so every
    sum is exact in fp32), and JAX's ``.at[].add`` within rtol 1e-5 of
    them; combining leaves fewer global atomics than live entries wherever
    ids repeat, and one id everywhere costs at most one atomic a warp's slot
    or a block's array.  Blocks of 64 or 32 threads stand for the kernel's
    512, so that a few thousand entries take several passes of several
    blocks, with ids on both sides of the hot bound, and passes that put the
    array to use and passes that do not (a low threshold, and the kernel's)."""
    rng = np.random.default_rng(len(kind) + geometry[0])
    lists = _square_lists(rng, kind)
    n_acc, div = 600, 128
    acc0 = (rng.integers(0, 64, (2, n_acc)) / 4).astype(F32)
    got_in, got_out = acc0[0].copy(), acc0[1].copy()
    atomics = model_squares(got_in, got_out, lists, div, *geometry)
    want = [torch.from_numpy(a.copy()) for a in acc0]
    from node2vec_torch.models import skipgram as sg

    sg.adagrad_accumulate_squares(*want, *[torch.from_numpy(x) for x in lists], div)
    np.testing.assert_array_equal(got_in, want[0].numpy())
    np.testing.assert_array_equal(got_out, want[1].numpy())
    ja = [jnp.asarray(a) for a in acc0]
    for k, acc_k in ((0, 0), (1, 1), (2, 1)):
        sq, rows = lists[2 * k], lists[2 * k + 1]
        valid = (rows >= 0).astype(F32)
        ja[acc_k] = ja[acc_k].at[np.where(rows >= 0, rows, 0)].add(sq / div * valid)
    np.testing.assert_allclose(got_in, np.asarray(ja[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_out, np.asarray(ja[1]), rtol=1e-5, atol=1e-7)
    live = sum(int((lists[2 * k + 1] >= 0).sum()) for k in range(3))
    threads, unroll, grid, _, hot_min = geometry
    if kind == "dead":
        assert atomics == 0
    elif kind == "one_id":
        passes = -(-sum(-(-len(lists[2 * k + 1]) // 4) for k in range(3)) // (threads * unroll))
        assert atomics <= passes * unroll * 4 * (threads // 32) + grid
    elif hot_min < SQ_HOT_MIN or kind == "pairs":
        assert atomics < live
    else:  # a pass of 256 entries never reaches the kernel's threshold
        assert atomics == live


def test_k3_squares_model_general_floats():
    """General squares (rounding differs by order): the model within rtol
    1e-5 of the plain version."""
    rng = np.random.default_rng(9)
    lists = _square_lists(rng, "tail", n=(1501, 3333, 7))
    for k in range(3):
        lists[2 * k] = rng.normal(0, 0.3, len(lists[2 * k])).astype(F32) ** 2
    acc0 = rng.random((2, 600)).astype(F32)
    got_in, got_out = acc0[0].copy(), acc0[1].copy()
    model_squares(got_in, got_out, lists, 128, 64, 2, 5, 256, 16)
    want = [torch.from_numpy(a.copy()) for a in acc0]
    from node2vec_torch.models import skipgram as sg

    sg.adagrad_accumulate_squares_plain(*want, *[torch.from_numpy(x) for x in lists], 128)
    np.testing.assert_allclose(got_in, want[0].numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_out, want[1].numpy(), rtol=1e-5, atol=1e-7)
