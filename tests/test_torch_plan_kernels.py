"""Numpy models of the one-launch designs of K20 ``ep_bucket``
(csrc/ep_walk.cu) and K18 ``route_plan`` (csrc/route.cu) on
bucket_common.cuh's grid ranking, held bit-equal to the port's plain
versions and to the JAX package's functions.

Both kernels run a persistent grid of resident blocks: block b takes the
tiles [b k, min((b + 1) k, n_tiles)), one item a thread, and ranks its
items stably by bucket: within a warp by ``__match_any_sync``, across the
tile's warps by an exclusive scan of the per-warp counts, across the grid by
the counts of the blocks before it, summed after a grid barrier.  K20 ranks
lanes by destination shard and writes -1 only into the rows no lane fills;
K18 sorts the (id, position) keys by LSD radix passes over the bits of the
ids that vary (digit 0 is 6 bits, the rest at most 6 each), each key adding
itself to the next pass's count of the block that reads it, then ranks the
heads (first keys of an id) by owner.  The models make those steps in that
order, at the kernels' tiles and at small tiles with few resident blocks, so
that a block takes several tiles.  The kernels themselves run only on the
card (chip_smoke.py: check_ep_walk, check_route)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from node2vec_tpu.parallel import edge_partitioned_blocked as ref_ep
from node2vec_tpu.parallel import rowsharded_sgns as ref_rs
from node2vec_torch.ops.hashrng import hash_uniform
from node2vec_torch.parallel import edge_partitioned_blocked as ep
from node2vec_torch.parallel import rowsharded_sgns as rs

K20_GEOMETRY = (1024, 132)  # lanes a tile, resident blocks (one 1,024-thread block an SM)
K18_GEOMETRY = (512, 264)  # keys a tile, resident blocks (two 512-thread blocks an SM)
SMALL_GEOMETRY = (64, 3)  # a block takes several tiles
DIGIT_BITS = 6


# --------------------------------------------------------------------------- #
# bucket_common.cuh's grid ranking
# --------------------------------------------------------------------------- #

def grid_layout(n_items: int, tile: int, resident: int):
    """(n_tiles, tiles a block, grid) of grid_geometry: every block resident."""
    n_tiles = max(-(-n_items // tile), 1)
    per_block = -(-n_tiles // resident)
    return n_tiles, per_block, -(-n_tiles // per_block)


def tile_offset(active, bucket, n_buckets: int):
    """tile_offset: for each item, the active items of its bucket earlier in
    the tile (its own item active or not), and the tile's count of each
    bucket.  Within a warp, the active peers below the lane
    (``__match_any_sync`` and a ballot); across the warps, the exclusive scan
    of the per-warp counts."""
    warps = active.shape[0] // 32
    onehot = np.zeros((active.shape[0], n_buckets), np.int64)
    onehot[np.nonzero(active)[0], bucket[active]] = 1
    per_warp = onehot.reshape(warps, 32, n_buckets)
    below = (np.cumsum(per_warp, axis=1) - per_warp).reshape(-1, n_buckets)
    counts = per_warp.sum(1)  # [warps, buckets]
    before = np.cumsum(counts, axis=0) - counts
    warp = np.arange(active.shape[0]) // 32
    return before[warp, bucket] + below[np.arange(active.shape[0]), bucket], counts.sum(0)


def block_counts(active, bucket, n_buckets: int, tile: int, resident: int):
    """Each block's count of each bucket over its tiles: [grid, buckets]."""
    n_tiles, per_block, grid = grid_layout(active.shape[0], tile, resident)
    blk = np.zeros((grid, n_buckets), np.int64)
    items = np.nonzero(active)[0]
    np.add.at(blk, (items // (tile * per_block), bucket[items]), 1)
    return blk


def grid_rank(active, bucket, n_buckets: int, tile: int, resident: int, blk=None):
    """Each active item's stable rank within its bucket over the whole grid
    and the buckets' totals: each block's counts (``blk``, as the kernel
    stored them before the barrier; they must equal the items' own), the sums
    of the blocks before it after, then its tiles in order."""
    n_tiles, per_block, grid = grid_layout(active.shape[0], tile, resident)
    own = block_counts(active, bucket, n_buckets, tile, resident)
    if blk is None:
        blk = own
    np.testing.assert_array_equal(blk[:, :n_buckets], own)
    blk = blk[:, :n_buckets]
    pad = n_tiles * tile - active.shape[0]
    act = np.concatenate([active, np.zeros(pad, bool)])
    bkt = np.concatenate([bucket, np.zeros(pad, np.int64)])
    rank = np.zeros(act.shape[0], np.int64)
    for b in range(grid):
        run = blk[:b].sum(0)
        for t in range(b * per_block, min((b + 1) * per_block, n_tiles)):
            lanes = slice(t * tile, (t + 1) * tile)
            off, counts = tile_offset(act[lanes], bkt[lanes], n_buckets)
            rank[lanes] = run[bkt[lanes]] + off
            run = run + counts
    return rank[:active.shape[0]], blk.sum(0)


def grid_fill(out, cap: int, tot):
    """-1 into the rows [d cap + min(tot[d], cap), (d + 1) cap) of ``out``."""
    for d, count in enumerate(tot):
        out[d * cap + min(int(count), cap):(d + 1) * cap] = -1
    return out


# --------------------------------------------------------------------------- #
# K20
# --------------------------------------------------------------------------- #

def k20_lanes(carry, n_shards, capacity, rows_per_shard, walk_length, slot_a, back):
    """bucket_lane: each lane's activity and destination."""
    t, cur, prev = carry[ep.T], carry[ep.CUR], carry[ep.PREV]

    def owner(v):
        return np.minimum(np.maximum(v, 0) // rows_per_shard, n_shards - 1)

    if slot_a is None:
        active = (carry[ep.ALIVE] != 0) & (t < walk_length)
        return active, np.where(active, owner(cur), 0)
    n_req = n_shards * capacity
    sent = slot_a < n_req
    got = back[np.clip(slot_a, 0, n_req - 1)]
    take = got[:, 5] > 0
    active = sent & ~((got[:, 0] < 0) & ~take) & ~take & (t != 0)
    return active, np.where(active, owner(prev), 0)


def k20_requests(carry, seed, gid_base, slot_a, back, n_req):
    """load_request: phase A's 7 fields, phase B's 2, a row a lane."""
    n = carry.shape[1]
    if slot_a is None:
        gids = torch.arange(gid_base, gid_base + n, dtype=torch.int64)
        ctr = (torch.from_numpy(carry[ep.ATT]).long() & 0xFFFFFFFF) * 4
        u = [hash_uniform(seed, gids, ctr + k).view(torch.int32).numpy() for k in (0, 1)]
        return np.stack([carry[ep.CUR], carry[ep.PREV], carry[ep.W_BACK_ENC],
                         carry[ep.BACK_PFX], u[0], u[1], carry[ep.T]], axis=1)
    return np.stack([carry[ep.PREV], back[np.clip(slot_a, 0, n_req - 1), 0]], axis=1)


def k20_model(carry, seed, gid_base, *, n_shards, capacity, rows_per_shard, walk_length,
              slot_a=None, back=None, geometry=K20_GEOMETRY):
    """K20's one launch: (send [S cap, F], slot [n])."""
    n_req = n_shards * capacity
    active, dest = k20_lanes(carry, n_shards, capacity, rows_per_shard, walk_length, slot_a,
                             back)
    rank, tot = grid_rank(active, dest, n_shards, *geometry)
    sendable = active & (rank < capacity)
    slot = np.where(sendable, dest * capacity + rank, n_req).astype(np.int32)
    req = k20_requests(carry, seed, gid_base, slot_a, back, n_req)
    send = np.empty((n_req, req.shape[1]), np.int32)
    send[slot[sendable]] = req[sendable]  # each filled row written once, by its lane
    return grid_fill(send, capacity, tot), slot


def jax_bucket(carry, seed, gid_base, *, n_shards, capacity, rows_per_shard, walk_length,
               slot_a=None, back=None):
    """JAX's _bucket_by_dest and the request pack of phase A (:380-399) or
    B (:511-526), the pack in numpy."""
    active, dest = k20_lanes(carry, n_shards, capacity, rows_per_shard, walk_length, slot_a,
                             back)
    flat, send_ok = jax.jit(ref_ep._bucket_by_dest, static_argnums=(2, 3))(
        jnp.asarray(dest), jnp.asarray(active), n_shards, capacity)
    flat, send_ok = np.asarray(flat), np.asarray(send_ok)
    n_req = n_shards * capacity
    req = k20_requests(carry, seed, gid_base, slot_a, back, n_req)
    req[:, 0] = np.where(send_ok, req[:, 0], -1)
    send = np.full((n_req + 1, req.shape[1]), -1, np.int32)
    send[flat[send_ok]] = req[send_ok]
    return send[:-1], flat


def ep_carry(n: int, v: int, rng, active_share: float):
    """A carry of ``n`` lanes over ``v`` vertices with ``active_share`` of them
    active (alive, t < 5)."""
    carry = np.zeros((ep.CARRY_ROWS, n), np.int32)
    carry[ep.CUR] = rng.integers(0, v, n)
    carry[ep.PREV] = rng.integers(-1, v, n)
    carry[ep.W_BACK_ENC] = rng.integers(-2 ** 31, 2 ** 31 - 1, n)
    carry[ep.BACK_PFX] = rng.integers(0, 2 ** 30, n)
    carry[ep.ATT] = rng.integers(0, 40, n)
    carry[ep.ALIVE] = rng.random(n) < active_share
    carry[ep.T] = np.where(rng.random(n) < 0.9, rng.integers(0, 5, n), 5)
    return carry


def phase_b_inputs(carry, slot_a, n_req, rng):
    """Responses to phase A: cand (-1 where the walker dies), take_back."""
    back = rng.integers(-1, 1000, (n_req, ep.RESPONSE_FIELDS)).astype(np.int32)
    back[:, 5] = rng.random(n_req) < 0.2
    return slot_a, back


K20_CASES = {  # n lanes, n_shards, capacity a shard (None: n), share of lanes active
    "one shard, ragged last tile": (3000, 1, None, 0.8),
    "two shards, capacity n / 8 defers": (3000, 2, 3000 // 8, 0.9),
    "three shards": (2500, 3, None, 0.7),
    "256 shards, capacity that defers": (4096, 256, 8, 0.8),
    "no active lane": (2048, 3, None, 0.0),
    "every lane active": (2048, 2, 2048 // 8, 1.0),
}


@pytest.mark.parametrize("geometry", [K20_GEOMETRY, SMALL_GEOMETRY], ids=["kernel", "small"])
@pytest.mark.parametrize("case", sorted(K20_CASES))
def test_k20_model_bit_equal_plain_and_jax(case, geometry):
    n, n_shards, cap, share = K20_CASES[case]
    cap = n if cap is None else cap
    rng = np.random.default_rng(n + n_shards)
    v = 4000
    carry = ep_carry(n, v, rng, share)
    if share == 1.0:
        carry[ep.ALIVE] = 1
        carry[ep.T] = np.where(carry[ep.T] >= 5, 1, carry[ep.T])
    kw = dict(n_shards=n_shards, capacity=cap, rows_per_shard=-(-v // n_shards), walk_length=5)
    n_req = n_shards * cap
    send_a, slot_a = k20_model(carry, 9, 1000, geometry=geometry, **kw)
    plain_a = ep.ep_bucket_plain(torch.from_numpy(carry), 9, 1000, **kw)
    want_a = jax_bucket(carry, 9, 1000, **kw)
    for got, want in ((send_a, plain_a[0].numpy()), (slot_a, plain_a[1].numpy()),
                      (send_a, want_a[0]), (slot_a, want_a[1])):
        np.testing.assert_array_equal(got, want)
    n_active = int(((carry[ep.ALIVE] != 0) & (carry[ep.T] < 5)).sum())
    if share == 0.0:
        assert (send_a == -1).all() and (slot_a == n_req).all()
    if cap < n and share > 0:
        assert int((slot_a < n_req).sum()) < n_active  # some lanes defer

    slot_in, back = phase_b_inputs(carry, slot_a, n_req, rng)
    kw_b = dict(kw, slot_a=slot_in, back=back)
    send_b, slot_b = k20_model(carry, 9, 1000, geometry=geometry, **kw_b)
    plain_b = ep.ep_bucket_plain(torch.from_numpy(carry), 9, 1000, **dict(
        kw, slot_a=torch.from_numpy(slot_in), back=torch.from_numpy(back)))
    want_b = jax_bucket(carry, 9, 1000, **kw_b)
    for got, want in ((send_b, plain_b[0].numpy()), (slot_b, plain_b[1].numpy()),
                      (send_b, want_b[0]), (slot_b, want_b[1])):
        np.testing.assert_array_equal(got, want)


def test_k20_geometry():
    """The kernel's grid at the main path's 131,072 lanes is one tile a
    block, all 128 blocks resident; past the resident blocks a block takes
    several tiles; no lane still makes a tile, so the buffer is filled."""
    assert grid_layout(131072, *K20_GEOMETRY) == (128, 1, 128)
    assert grid_layout(1 << 20, *K20_GEOMETRY) == (1024, 8, 128)
    assert grid_layout(0, *K20_GEOMETRY) == (1, 1, 1)


# --------------------------------------------------------------------------- #
# K18
# --------------------------------------------------------------------------- #

def radix_schedule(bits: int):
    """(shift, width) of each pass: digit 0 is bits [0, 6), the rest split
    evenly into digits of at most 6 bits; no pass when no bit varies."""
    if bits == 0:
        return []
    rest = max(bits - DIGIT_BITS, 0)
    n_rest = -(-rest // DIGIT_BITS)
    w = -(-rest // n_rest) if n_rest else 0
    out = [(0, DIGIT_BITS)]
    for p in range(n_rest):
        shift = DIGIT_BITS + p * w
        out.append((shift, min(w, bits - shift)))
    return out


def k18_model(ids, n_dev: int, cap: int, geometry=K18_GEOMETRY):
    """K18's one launch: the RoutePlan's fields as numpy arrays."""
    tile, resident = geometry
    r = ids.shape[0]
    n_tiles, per_block, grid = grid_layout(r, tile, resident)
    f = ids.view(np.uint32) ^ np.uint32(0x80000000)
    keys = (f.astype(np.uint64) << np.uint64(32)) | np.arange(r, dtype=np.uint64)
    every = np.ones(r, bool)

    def digits(k, shift, width):
        return ((k >> np.uint64(32 + shift)) & np.uint64((1 << width) - 1)).astype(np.int64)

    # 0. each block's digit-0 counts; the bits that vary over all ids
    hist = block_counts(every, digits(keys, 0, DIGIT_BITS), 1 << DIGIT_BITS, tile, resident)
    vary = int(np.bitwise_or.reduce(f)) ^ int(np.bitwise_and.reduce(f))
    passes = radix_schedule(vary.bit_length())
    # 1. the radix passes; each key adds itself to the next pass's count of
    # the block that reads its new position
    src = keys
    for p, (shift, width) in enumerate(passes):
        d = digits(src, shift, width)
        rank, tot = grid_rank(every, d, 1 << width, tile, resident, blk=hist)
        pos = (np.cumsum(tot) - tot)[d] + rank  # the digit's base, then the stable rank
        dst = np.empty_like(src)
        dst[pos] = src
        if p + 1 < len(passes):
            hist = np.zeros((grid, 1 << DIGIT_BITS), np.int64)
            np.add.at(hist, (pos // (tile * per_block), digits(src, *passes[p + 1])), 1)
        src = dst
    sid = ((src >> np.uint64(32)).astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
    spos = (src & np.uint64(0xFFFFFFFF)).astype(np.int64)
    head = np.ones(r, bool)
    head[1:] = sid[1:] != sid[:-1]
    own = np.mod(sid.astype(np.int64), n_dev)

    # 2. each block's heads and heads by owner; 3. its tiles in order: the
    # unique slot and owner rank of each head, a key's rank its head's (in
    # the tile, or the last of its owner before the tile)
    blk_h = block_counts(head, np.zeros(r, np.int64), 1, tile, resident)[:, 0]
    blk_o = block_counts(head, own, n_dev, tile, resident)
    u = np.zeros(r, np.int64)
    rk = np.zeros(r, np.int64)
    for b in range(grid):
        h_run = int(blk_h[:b].sum())
        run = blk_o[:b].sum(0)
        for t in range(b * per_block, min((b + 1) * per_block, n_tiles)):
            lanes = np.arange(t * tile, (t + 1) * tile)
            valid = lanes < r
            li = np.minimum(lanes, r - 1)
            hd = head[li] & valid
            h_off, h_cnt = tile_offset(hd, np.zeros(tile, np.int64), 1)
            o_off, o_cnt = tile_offset(hd, own[li], n_dev)
            head_rank = np.zeros(tile, np.int64)
            head_rank[h_off[hd]] = run[own[li][hd]] + o_off[hd]
            k_rank = np.where(hd, run[own[li]] + o_off,
                              np.where(h_off > 0, head_rank[np.maximum(h_off - 1, 0)],
                                       run[own[li]] - 1))
            u[li[valid]] = (h_run + h_off + hd - 1)[valid]
            rk[li[valid]] = k_rank[valid]
            h_run += int(h_cnt[0])
            run = run + o_cnt
    n_uniq = int(blk_h.sum())
    o_tot = blk_o.sum(0)
    uniq = np.zeros(r, np.int32)
    inv = np.zeros(r, np.int32)
    owner = np.full(r, n_dev, np.int32)
    rank = np.arange(r, dtype=np.int32) - n_uniq  # the dead slots
    ok = np.zeros(r, bool)
    send_ids = np.empty(n_dev * cap, np.int32)
    fits = rk < cap
    uniq[u[head]] = sid[head]
    inv[spos] = u
    owner[u[head]] = own[head]
    rank[u[head]] = rk[head]
    ok[u[head]] = fits[head]
    send_ids[(own * cap + rk)[head & fits]] = sid[head & fits]
    grid_fill(send_ids, cap, o_tot)
    slot = np.full(r, -1, np.int32)
    slot[spos] = np.where(fits, own * cap + rk, -1)
    return dict(uniq=uniq, inv=inv, is_uniq=np.arange(r) < n_uniq, owner=owner,
                bucket_pos=rank, ok=ok, send_ids=send_ids.reshape(n_dev, cap),
                n_dropped=int(np.maximum(o_tot - cap, 0).sum()), slot=slot,
                order=spos.astype(np.int32), n_uniq=n_uniq)


INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1
K18_CASES = {  # ids from a seed, n_dev, capacity (None: row_cap)
    "under one tile": (lambda rng: rng.integers(0, 300, 100), 2, None),
    "ragged last tile": (lambda rng: rng.integers(0, 131072, 3 * 512 + 77), 4, None),
    "17 bits, N = 8": (lambda rng: rng.integers(0, 131072, 5000), 8, None),
    "N = 1": (lambda rng: rng.integers(0, 5000, 2000), 1, None),
    "a capacity that drops": (lambda rng: rng.integers(0, 3000, 4000), 8, 64),
    "row 0 across most of R": (lambda rng: np.where(rng.random(3000) < 0.9, 0,
                                                    rng.integers(0, 255, 3000)), 2, None),
    "every id equal": (lambda rng: np.full(1500, 7), 4, None),
    "int32 extremes": (lambda rng: rng.choice(np.array([INT_MIN, INT_MIN + 1, -1, 0, 1,
                                                        INT_MAX - 1, INT_MAX]), 1200), 4, 16),
}
PLAN_FIELDS = ("uniq", "inv", "is_uniq", "owner", "bucket_pos", "ok", "send_ids", "n_dropped")


@pytest.mark.parametrize("geometry", [K18_GEOMETRY, SMALL_GEOMETRY], ids=["kernel", "small"])
@pytest.mark.parametrize("case", sorted(K18_CASES))
def test_k18_model_bit_equal_plain_and_jax(case, geometry):
    make, n_dev, cap = K18_CASES[case]
    ids = make(np.random.default_rng(len(case))).astype(np.int32)
    cap = rs.row_cap(ids.shape[0], n_dev) if cap is None else cap
    got = k18_model(ids, n_dev, cap, geometry)
    plain = rs.plan_routes_plain(torch.from_numpy(ids), n_dev, cap)
    for field in got:
        np.testing.assert_array_equal(got[field], np.asarray(getattr(plain, field)),
                                      err_msg=field)
    if geometry != K18_GEOMETRY:
        return
    want = jax.jit(ref_rs._plan_routes, static_argnums=(1, 2))(jnp.asarray(ids), n_dev, cap)
    for field in PLAN_FIELDS:
        np.testing.assert_array_equal(got[field], np.asarray(getattr(want, field)),
                                      err_msg=field)
    if case == "a capacity that drops":
        assert got["n_dropped"] > 0


def test_k18_radix_schedule():
    """17 bits (V = 131,072) take three passes of 6, 6 and 5 bits; 32 bits
    six; one varying bit one pass; equal ids none, so the keys stay in
    position order."""
    assert radix_schedule(17) == [(0, 6), (6, 6), (12, 5)]
    assert radix_schedule(32) == [(0, 6), (6, 6), (12, 6), (18, 6), (24, 6), (30, 2)]
    assert radix_schedule(1) == [(0, 6)]
    assert radix_schedule(0) == []
    assert grid_layout(54034, *K18_GEOMETRY) == (106, 1, 106)


def test_k18_workspace_is_o_of_r():
    """The wrapper's int workspace is tiles x (6 x 64 + 3 + N), a few ints a
    key: O(R) at every N the plan takes, never O(V)."""
    tiles = -(-54034 // 512)
    assert tiles * (6 * 64 + 3 + 1) < 54034 and tiles * (6 * 64 + 3 + 8) < 54034

