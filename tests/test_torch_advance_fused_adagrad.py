"""Numpy models of two one-launch designs, held to the port's plain versions
and to the JAX package's functions:

* the fused launch of the graph-sharded walk (csrc/ep_walk.cu,
  ``ep_advance_bucket``): K23's advance in each lane's first read of K20's
  phase-A grid, then the ranking of the next superstep's proposals.  A lane
  that sent a proposal takes its step from its response (and at q != 1 its
  membership answer) in registers and writes back only the rows that changed
  and its path entry; a lane that sent nothing changes nothing; the request
  is made from the advanced registers and ranked on bucket_common.cuh's grid
  (the model of ``test_torch_plan_kernels.py``); the pending count is the
  grid's total of active lanes.  Bit-equal to ``ep_advance_plain`` then
  ``ep_bucket_plain``, and the ranking to JAX's ``_bucket_by_dest``, at the
  kernel's tile and at small tiles (a block takes several), in modes 0-2,
  with a ragged tile, no lane sent, deferring capacities and a trial cap
  that forces fallbacks;
* K14 ``fused_adagrad`` (csrc/fused_adagrad.cu): a warp a gradient row, the
  row in float4 chunks (chunk k * 32 + lane in a lane's v[k]), its squares
  summed lane by lane and across the warp, acc0 read from column D, the
  update realigned to the table row's 16-byte run (h = 0-3 floats in: chunk
  j's last 4 - h floats and chunk j + 1's first h, passed by the next lane,
  or the next group's lane 0 for lane 31), the head and tail floats apart,
  column D's increments deferred to a pass after the rows.  Every column
  of a live row updated once, held to ``fused_adagrad_plain`` and, through
  the plain gradients, to JAX's ``sgns_walk_step_fused_impl`` at D != 64
  (the JAX package packs dim-64 tables), rtol 1e-5.

The kernels themselves run only on the card (chip_smoke.py:
``edge_cases_ep_advance``, ``check_ep_walk``, ``edge_cases_fused_adagrad``,
``check_fused``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from node2vec_tpu.models import skipgram as ref_sg
from node2vec_tpu.ops.alias import build_alias_csr
from node2vec_torch import convert
from node2vec_torch.models import skipgram as sg
from node2vec_torch.ops.hashrng import hash_uniform
from node2vec_torch.parallel import edge_partitioned_blocked as ep
from test_torch_plan_kernels import (K20_GEOMETRY, SMALL_GEOMETRY, grid_fill, grid_rank,
                                     jax_bucket, k20_requests)

RTOL, ATOL = 1e-5, 1e-6
WALK_LENGTH = 5
V = 4000


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# the fused launch
# --------------------------------------------------------------------------- #

def advance_model(carry, paths, n_fb, slot_a, back, slot_b, resp_b, seed, gid_base, *,
                  n_req, max_trials, p, q):
    """lane_request<true>'s advance, every lane at once: (state, paths,
    fallbacks, the entries written).  The state is written only where a row
    changed; ``written`` counts those entries."""
    c = carry.copy()
    paths = paths.copy()
    n = c.shape[1]
    mode = 2 if q != 1.0 else (1 if p != 1.0 else 0)
    t, alive, cur, prev = c[ep.T], c[ep.ALIVE], c[ep.CUR], c[ep.PREV]
    wbe, bpfx, att = c[ep.W_BACK_ENC], c[ep.BACK_PFX], c[ep.ATT].view(np.uint32)
    sent = slot_a < n_req
    lanes = np.nonzero(sent)[0]  # a lane that sent nothing changes nothing
    g = back[slot_a[lanes]]
    a_cand, a_take = g[:, 0], g[:, 5] > 0
    first = t[lanes] == 0
    died = (a_cand < 0) & ~a_take
    if mode == 2:
        sb = slot_b[lanes]
        shared = resp_b[np.clip(sb, 0, n_req - 1), 0] > 0
        attempted = (sb < n_req) | died | a_take | first
    else:
        shared = np.zeros(lanes.shape[0], bool)
        attempted = np.ones(lanes.shape[0], bool)
    if mode == 0:
        accept = attempted
    elif mode == 1:
        accept = attempted & (a_take | first | (a_cand != prev[lanes]))
    else:
        u = hash_uniform(seed, torch.from_numpy(gid_base + lanes.astype(np.int64)),
                         torch.from_numpy(att[lanes].astype(np.int64) * 4 + 2)).numpy()
        inv_q = np.float32(1.0 / q)
        alpha2 = np.where(wbe[lanes] < 0, np.float32(max(1.0, 1.0 / q)), inv_q)
        bias2 = np.where(shared, np.float32(1.0), inv_q)
        accept = attempted & (a_take | first | ((a_cand != prev[lanes])
                                                & (u * alpha2 <= bias2)))
    lives = (alive[lanes] != 0) & ~died
    trials0 = c[ep.TRIALS, lanes]
    trials = np.where(attempted, np.where(accept, 0, trials0 + 1), trials0)
    force = attempted & lives & (trials >= max_trials)
    fb = int((force & ~accept).sum())
    adv = (accept | force) & lives
    take = a_take & ~force
    nxt = np.where(take, prev[lanes], a_cand)
    new = {r: c[r, lanes].copy() for r in range(ep.CARRY_ROWS)}
    a_l = lanes[adv]
    paths[a_l, t[a_l] + 1] = nxt[adv]
    sign = np.where(wbe[lanes] < 0, np.int32(-2 ** 31), np.int32(0))
    for row, val in ((ep.W_FWD, np.where(take, wbe[lanes] & 0x7FFFFFFF, g[:, 1])),
                     (ep.FWD_PFX, np.where(take, bpfx[lanes], g[:, 4])),
                     (ep.W_BACK_ENC, np.where(take, c[ep.W_FWD, lanes] | sign, g[:, 2])),
                     (ep.BACK_PFX, np.where(take, c[ep.FWD_PFX, lanes], g[:, 3])),
                     (ep.PREV, cur[lanes]), (ep.CUR, nxt), (ep.T, t[lanes] + 1)):
        new[row] = np.where(adv, val, new[row])
    new[ep.TRIALS] = np.where(adv, 0, trials)
    new[ep.ATT] = np.where(attempted & lives, c[ep.ATT, lanes] + 1, c[ep.ATT, lanes])
    new[ep.ALIVE] = np.where(lives, alive[lanes], 0)
    written = 0
    for r in range(ep.CARRY_ROWS):  # only the rows that changed
        changed = new[r] != c[r, lanes]
        c[r, lanes[changed]] = new[r][changed]
        written += int(changed.sum())
    assert (c[:, ~sent] == carry[:, ~sent]).all()
    return c, paths, n_fb + fb, written


def fused_model(carry, paths, n_fb, slot_a, back, slot_b, resp_b, seed, gid_base, *, n_shards,
                capacity, rows_per_shard, walk_length, max_trials, p, q, geometry):
    """The fused launch: the advance, then the grid ranking of the requests
    made from the advanced state; (state, paths, n_fb, send, slot,
    pending)."""
    n_req = n_shards * capacity
    c, pth, fb, _ = advance_model(carry, paths, n_fb, slot_a, back, slot_b, resp_b, seed,
                                  gid_base, n_req=n_req, max_trials=max_trials, p=p, q=q)
    active = (c[ep.ALIVE] != 0) & (c[ep.T] < walk_length)
    dest = np.where(active, np.minimum(np.maximum(c[ep.CUR], 0) // rows_per_shard,
                                       n_shards - 1), 0)
    rank, tot = grid_rank(active, dest, n_shards, *geometry)
    sendable = active & (rank < capacity)
    slot = np.where(sendable, dest * capacity + rank, n_req).astype(np.int32)
    req = k20_requests(c, seed, gid_base, None, None, n_req)
    send = np.empty((n_req, ep.PROPOSE_FIELDS), np.int32)
    send[slot[sendable]] = req[sendable]
    return c, pth, fb, grid_fill(send, capacity, tot), slot, int(tot.sum())


def superstep_inputs(n, n_shards, cap, p, q, trials, none_sent, seed):
    """A state of ``n`` lanes, its proposal round ranked by the plain K20
    (the lanes that sent are active), responses drawn (cand -1 where the
    walker dies, take_back 1 in 5), at q != 1 the membership round ranked
    and answered 0 / 1."""
    rng = np.random.default_rng(seed)
    carry = np.zeros((ep.CARRY_ROWS, n), np.int32)
    carry[ep.CUR] = rng.integers(0, V, n)
    carry[ep.PREV] = rng.integers(-1, V, n)
    carry[ep.W_FWD] = rng.integers(0, 2 ** 30, n)
    carry[ep.FWD_PFX] = rng.integers(0, 2 ** 30, n)
    carry[ep.W_BACK_ENC] = rng.integers(-2 ** 31, 2 ** 31 - 1, n)
    carry[ep.BACK_PFX] = rng.integers(0, 2 ** 30, n)
    carry[ep.ATT] = rng.integers(0, 40, n)
    carry[ep.TRIALS] = rng.integers(0, trials, n)
    carry[ep.ALIVE] = rng.random(n) < 0.9
    carry[ep.T] = np.where(rng.random(n) < 0.1, WALK_LENGTH,
                           rng.integers(0, WALK_LENGTH, n))
    paths = rng.integers(-1, V, (n, WALK_LENGTH + 1)).astype(np.int32)
    geo = dict(n_shards=n_shards, capacity=cap, rows_per_shard=-(-V // n_shards),
               walk_length=WALK_LENGTH)
    n_req = n_shards * cap
    slot_a = ep.ep_bucket_plain(torch.from_numpy(carry), 9, 1000, **geo)[1].numpy()
    if none_sent:
        slot_a = np.full_like(slot_a, n_req)
    back = rng.integers(-1, V, (n_req, ep.RESPONSE_FIELDS)).astype(np.int32)
    back[:, 5] = rng.random(n_req) < 0.2
    slot_b = resp_b = None
    if q != 1.0:
        slot_b = ep.ep_bucket_plain(torch.from_numpy(carry), 9, 1000, slot_a=torch.from_numpy(
            slot_a), back=torch.from_numpy(back), **geo)[1].numpy()
        resp_b = rng.integers(0, 2, (n_req, 1)).astype(np.int32)
    return carry, paths, slot_a, back, slot_b, resp_b, geo


FUSED_CASES = {  # n, n_shards, capacity (None: n), (p, q), max_trials, no lane sent
    "mode 0 (p = q = 1)": (2500, 1, None, (1.0, 1.0), 64, False),
    "mode 1 (q = 1), two shards": (2500, 2, None, (0.25, 1.0), 64, False),
    "mode 2, a ragged tile": (3000 + 37, 3, None, (0.25, 4.0), 64, False),
    "mode 2, no lane sent": (2048, 2, None, (0.25, 4.0), 64, True),
    "mode 2, capacity n / 8 defers": (2500, 3, 2500 // 8, (0.25, 4.0), 64, False),
    "mode 1, 256 shards, capacity 4 defers": (3000, 256, 4, (4.0, 1.0), 64, False),
    "mode 2, a trial cap of 1 forces fallbacks": (2500, 1, None, (0.25, 4.0), 1, False),
}


@pytest.mark.parametrize("geometry", [K20_GEOMETRY, SMALL_GEOMETRY], ids=["kernel", "small"])
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_launch_model_bit_equal_plain_and_jax(case, geometry):
    n, n_shards, cap, (p, q), trials, none_sent = FUSED_CASES[case]
    cap = n if cap is None else cap
    carry, paths, slot_a, back, slot_b, resp_b, geo = superstep_inputs(
        n, n_shards, cap, p, q, trials, none_sent, seed=n + n_shards + trials)
    kw = dict(max_trials=trials, return_param=p, inout_param=q, **geo)
    got = fused_model(carry, paths, 3, slot_a, back, slot_b, resp_b, 9, 1000, max_trials=trials,
                      p=p, q=q, geometry=geometry, **geo)
    t = [torch.from_numpy(x.copy()) for x in (carry, paths)]
    n_fb = torch.full((1,), 3, dtype=torch.int32)
    send, slot, pending = ep.ep_advance_bucket_plain(
        *t, n_fb, torch.from_numpy(slot_a), torch.from_numpy(back),
        None if slot_b is None else torch.from_numpy(slot_b),
        None if resp_b is None else torch.from_numpy(resp_b), 9, 1000, **kw)
    want = (t[0].numpy(), t[1].numpy(), int(n_fb), send.numpy(), slot.numpy(), int(pending))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the ranking of the advanced state is JAX's _bucket_by_dest's
    j_send, j_slot = jax_bucket(got[0], 9, 1000, **geo)
    np.testing.assert_array_equal(got[3], j_send)
    np.testing.assert_array_equal(got[4], j_slot)
    if none_sent:
        np.testing.assert_array_equal(got[0], carry)
    if trials == 1:
        assert got[2] > 3  # fallbacks forced
    if cap < n:
        assert int((got[4] < n_shards * cap).sum()) < got[5]  # lanes deferred


def test_fused_launch_writes_only_what_changed():
    """A lane that sent writes the rows its step changed (a step: at most
    the ten rows; a rejected attempt: TRIALS and ATT; a death: ALIVE), and
    its path entry; the entries written are the entries that differ."""
    carry, paths, slot_a, back, slot_b, resp_b, geo = superstep_inputs(
        2500, 1, 2500, 0.25, 4.0, 64, False, seed=4)
    c, pth, _, written = advance_model(carry, paths, 0, slot_a, back, slot_b, resp_b, 9, 1000,
                                       n_req=2500, max_trials=64, p=0.25, q=4.0)
    assert written == int((c != carry).sum()) > 0
    sent = slot_a < 2500
    assert written < 10 * int(sent.sum())
    stepped = c[ep.T] > carry[ep.T]
    assert (pth[~stepped] == paths[~stepped]).all()
    assert ((pth != paths).sum(1) <= 1).all()


# --------------------------------------------------------------------------- #
# K14
# --------------------------------------------------------------------------- #

def k14_row(tab, base: int, v: int, g, lr, counts):
    """One warp's row: the float4 chunks of g, each lane's squares then the
    warp's butterfly, the scale from column D, the realigned run of 16-byte
    adds, the head and tail floats.  ``base``: the table's address in floats
    (mod 4).  Adds into ``tab`` row v's first D columns (not column D);
    returns the row's mean square.  ``counts`` counts each column's adds."""
    dim = g.shape[0]
    nc = dim // 4
    k_groups = 1 << max(0, int(np.ceil(np.log2(-(-nc // 32)))))
    chunks = np.zeros((k_groups * 32, 4), np.float32)
    chunks[:nc] = g.reshape(nc, 4)
    v4 = chunks.reshape(k_groups, 32, 4)  # v4[k, lane]: chunk k * 32 + lane
    part = np.zeros(32, np.float32)
    for k in range(k_groups):
        part = part + (v4[k] * v4[k]).sum(1, dtype=np.float32)
    for off in (16, 8, 4, 2, 1):  # __shfl_xor_sync butterfly
        part = part + part[np.arange(32) ^ off]
    s = np.float32(part[0] / np.float32(dim))
    row = tab[v]
    sc = np.float32(1.0) / np.sqrt(np.float32(row[dim] + s + np.float32(1e-12)))

    def upd(x):
        return (np.float32(-lr) * x) * sc

    h = min((4 - (base + v * (dim + 1)) % 4) % 4, dim)
    nb = (dim - h) // 4
    tail = dim - h - 4 * nb
    for k in range(k_groups):
        for lane in range(32):
            j = k * 32 + lane
            own = v4[k, lane]
            if lane < 31:  # __shfl_down_sync by 1
                nx = v4[k, lane + 1]
            else:  # the next group's lane 0 (__shfl_sync), zeros past the row
                nx = v4[k + 1, 0] if k + 1 < k_groups else np.zeros(4, np.float32)
            a = np.concatenate([own[h:], nx[:h]])
            if j < nb:
                cols = h + 4 * j + np.arange(4)
                row[cols] += upd(a)
                counts[cols] += 1
            elif j == nb and tail:
                cols = 4 * j + np.arange(h, 4)
                row[cols] += upd(own[h:])
                counts[cols] += 1
    cols = np.arange(h)  # the head: chunk 0's first h floats, lane 0
    row[cols] += upd(v4[0, 0, :h])
    counts[cols] += 1
    return s


def k14_model(tab_in, tab_out, lists, lr, bases=(0, 0)):
    """K14's two passes over the lists laid end to end: the rows (each
    scale reads column D as it stood before the batch: no row writes it),
    then the deferred (row, square) pairs into column D."""
    tabs = (tab_in, tab_out)
    dim = tab_in.shape[1] - 1
    pend = []
    for li, (g, rows) in enumerate(zip(lists[0::2], lists[1::2])):
        ti = 0 if li == 0 else 1
        for r in range(rows.shape[0]):
            v = int(rows[r])
            if v < 0:
                continue
            counts = np.zeros(dim + 1, np.int64)
            s = k14_row(tabs[ti], bases[ti], v, g[r], lr, counts)
            assert (counts[:dim] == 1).all() and counts[dim] == 0
            pend.append((ti, v, s))
    for ti, v, s in pend:
        tabs[ti][v, dim] += s


def _k14_lists(dim, rng, n=60, s=16, v=50):
    def rows_of(m):
        rows = rng.integers(0, v, m).astype(np.int32)
        rows[:4] = np.arange(4)  # every residue mod 4
        rows[rng.random(m) < 0.15] = -1
        rows[5:12] = 7  # repeated
        return rows

    return [rng.normal(0, 0.5, (n, dim)).astype(np.float32), rows_of(n),
            rng.normal(0, 0.5, (n, dim)).astype(np.float32), rows_of(n),
            rng.normal(0, 0.5, (s, dim)).astype(np.float32), rows_of(s)]


@pytest.mark.parametrize("dim", [48, 100, 128, 256])
def test_k14_model_equals_plain(dim):
    rng = np.random.default_rng(dim)
    tabs = [rng.normal(0, 0.3, (50, dim + 1)).astype(np.float32) for _ in range(2)]
    for t in tabs:
        t[:, dim] = rng.random(50).astype(np.float32)
    lists = _k14_lists(dim, rng)
    want = [torch.from_numpy(t.copy()) for t in tabs]
    sg.fused_adagrad_plain(*want, *[torch.from_numpy(x) for x in lists], 0.05)
    got = [t.copy() for t in tabs]
    # a table whose base sits 1, 2, 3 floats past a 16-byte boundary shifts
    # every row's head: the model takes the base as the kernel reads it
    k14_model(*got, lists, 0.05, bases=(dim % 4 + 1, 3))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=RTOL, atol=ATOL)


W, S, K, B, L1, VJ = 5, 64, 5, 12, 9, 40


@pytest.mark.parametrize("dim", [48, 100])
def test_k14_model_step_equals_jax(dim):
    """The fused step, its gradients by the plain K2 given JAX's draws and
    its update by the K14 model, against JAX's sgns_walk_step_fused_impl."""
    rng = np.random.default_rng(dim + 1)
    walks = rng.integers(0, VJ, (B, L1)).astype(np.int32)
    walks[np.arange(L1)[None, :] >= rng.integers(1, L1 + 1, B)[:, None]] = -1
    mask = rng.random(VJ) > 0.15
    f_in = rng.normal(0, 0.3, (VJ, dim + 1)).astype(np.float32)
    f_out = rng.normal(0, 0.3, (VJ, dim + 1)).astype(np.float32)
    f_in[:, dim] = rng.random(VJ)
    f_out[:, dim] = rng.random(VJ)
    alias, prob = build_alias_csr(np.array([0, VJ]), rng.random(VJ).astype(np.float32) + 0.1)
    key = jax.random.PRNGKey(dim)
    want = ref_sg.sgns_walk_step_fused_impl(
        jnp.asarray(f_in), jnp.asarray(f_out), jnp.asarray(walks), key, jnp.float32(0.05),
        jnp.asarray(alias), jnp.asarray(prob), jnp.asarray(mask), window=W, negatives=K,
        shared_negatives=S, shrink_window=True)
    k_neg1, k_neg2, k_shrink = jax.random.split(key, 3)
    b_sh = torch.from_numpy(np.array(jax.random.randint(k_shrink, (B, L1), 1, W + 1)
                                     .astype(jnp.int32)))
    r1 = torch.from_numpy(np.array(jax.random.uniform(k_neg1, (S,))))
    r2 = torch.from_numpy(np.array(jax.random.uniform(k_neg2, (S,))))
    t_in, t_out = convert.from_reference_fused(f_in, f_out, device="cpu")
    neg = sg.negative_ids(r1, r2, torch.from_numpy(alias), torch.from_numpy(prob))
    g_in, g_out, d_no = sg.sgns_grads_plain(t_in, t_out, torch.from_numpy(walks),
                                            torch.from_numpy(mask), b_sh, neg, window=W,
                                            negatives=K, dim=dim)[:3]
    flat = walks.reshape(-1)
    got = [t_in.numpy().copy(), t_out.numpy().copy()]
    k14_model(*got, [g_in.numpy(), flat, g_out.numpy(), flat, d_no.numpy(),
                     neg.numpy().astype(np.int32)], 0.05)
    for g, w in zip(got, want[:2]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)
