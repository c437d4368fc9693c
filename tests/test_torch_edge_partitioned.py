"""node2vec_torch's dense graph-sharded walk (parallel/edge_partitioned.py)
against node2vec_tpu's ``edge_partitioned_walk`` on the CPU.

The port's walk takes its uniforms as ``draws(t)``; here it is given the
JAX walk's own draws (``fold_in`` of the key with the data coordinate, one
``split`` a superstep), so on karate with unit weights and p, q powers of
two (every partial sum exact) the paths must be bit-equal: at a data axis
of 1 in this process (a gloo world of one), at 2 and 4 in spawned ranks
(``tests/torch_partition_ranks.py``, no JAX) while this process computes
JAX's walks on its virtual CPU devices; at the full capacity and at one
that defers.  Then, as the JAX package's tests/test_edge_partitioned.py
does with its own draws: sinks, validity under deferral, and the analytic
second-order distribution by chi-square, here with the port's own draws.
"""

import concurrent.futures
import pickle

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from node2vec_tpu.parallel import edge_partitioned as ref_epd
from node2vec_torch.graph import from_edge_arrays
from node2vec_torch.parallel import edge_partitioned as epd
from node2vec_torch.parallel import launch, make_mesh
from node2vec_torch.walk.dense import build_padded_adjacency

import torch_partition_ranks
from torch_mesh_ranks import karate

WORLDS = (1, 2, 4)
PQ = ((0.5, 2.0), (0.25, 4.0))
W, L, SEED = 64, 8, 7


def _packed(src, dst, w=None, n_vertices=None, directed=False):
    g = from_edge_arrays(src, dst, w, n_vertices=n_vertices, directed=directed)
    return g, build_padded_adjacency(g.indptr, g.indices, g.weights)


def _capacity(name: str, n: int) -> int:
    """0 (the full W / S, never defers) or a quarter of it (defers)."""
    return 0 if name == "full" else W // n // 4


def _jax_mesh(n: int) -> JaxMesh:
    return JaxMesh(np.array(jax.devices()[:n]), ("data",))


def _jax_draws(n: int) -> list:
    """Each data shard's uniforms in superstep order, as JAX's shard_fn
    draws them (``:105-106``, ``:213``), for every superstep the bound
    allows."""
    out = []
    for s in range(n):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), s)
        draws = []
        for _ in range(epd.max_supersteps(L)):
            key, k_u = jax.random.split(key)
            draws.append(np.array(jax.random.uniform(k_u, (W // n,))))
        out.append(draws)
    return out


def _jax_walk(packed, n, starts, p, q, capacity):
    mesh = _jax_mesh(n)
    padded, rps = ref_epd.partition_packed_adjacency(packed, n)
    adj = jax.device_put(jnp.asarray(padded), NamedSharding(mesh, P("data", None)))
    st = jax.device_put(jnp.asarray(starts), NamedSharding(mesh, P("data")))
    return np.asarray(ref_epd.edge_partitioned_walk(
        mesh, adj, rps, st, jax.random.PRNGKey(SEED), walk_length=L, return_param=p,
        inout_param=q, capacity=capacity))


def _cases(packed, starts, n: int, draws) -> dict:
    return {(p, q, cap): dict(packed=packed, starts=starts, seed=SEED, walk_length=L, p=p, q=q,
                              capacity=_capacity(cap, n), draws=draws)
            for p, q in PQ for cap in ("full", "deferring")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The walks at data axes 1 (in process), 2 and 4 (spawned ranks, each
    running while this process computes JAX's walks), and JAX's."""
    _, packed = _packed(*karate())
    starts = (np.arange(W) % 34).astype(np.int32)
    draws = {n: _jax_draws(n) for n in WORLDS}
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {}
    for n in (4, 2):
        path = str(tmp_path_factory.mktemp("epd") / f"world{n}.pkl")
        with open(path, "wb") as f:
            pickle.dump({"epd": _cases(packed, starts, n, draws[n])}, f)
        futures[n] = pool.submit(launch.spawn, torch_partition_ranks.programs, n, "gloo", "cpu",
                                 path, timeout=300)
    jax_walks = {(n, key): _jax_walk(packed, n, starts, key[0], key[1], _capacity(key[2], n))
                 for n in WORLDS for key in _cases(packed, starts, n, None)}
    mesh = make_mesh(device="cpu")  # a gloo world of one in this process
    ranks = {1: [{"epd": {key: torch_partition_ranks.epd_walk(mesh, case) for key, case in
                          _cases(packed, starts, 1, draws[1]).items()}}]}
    ranks.update({n: f.result() for n, f in futures.items()})
    pool.shutdown()
    return dict(jax=jax_walks, ranks=ranks)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_partition_packed_adjacency_bit_equal(n_shards):
    """The padded array and rows per shard equal JAX's (PAD_ID ids and 0.0
    weights in the pad rows), on karate (34 rows: padding at 3 and 4)."""
    _, packed = _packed(*karate())
    got, rps = epd.partition_packed_adjacency(packed, n_shards)
    want, want_rps = ref_epd.partition_packed_adjacency(packed, n_shards)
    assert rps == want_rps and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("p,q", PQ)
@pytest.mark.parametrize("cap", ["full", "deferring"])
def test_walk_bit_equal_to_jax(runs, n, p, q, cap):
    """Every rank's gathered corpus equals JAX's ``edge_partitioned_walk``
    at the same data axis, given its draws; the deferring capacity (a
    quarter of the walkers a rank may send each owner) still finishes every
    walk within the bound."""
    want = runs["jax"][(n, (p, q, cap))]
    for rank in runs["ranks"][n]:
        paths, supersteps, unfinished = rank["epd"][(p, q, cap)]
        np.testing.assert_array_equal(paths, want)
        assert unfinished == 0 and (paths >= 0).all()
        assert supersteps <= epd.max_supersteps(L)
        if cap == "full":
            assert supersteps == L  # no lane ever defers
        else:
            assert supersteps > L


def test_walk_bit_equal_to_jax_at_a_width_not_a_power_of_two():
    """A packed adjacency at P = 48, which ``build_padded_adjacency`` never
    makes but a caller may pass (rows of 20 to 40 neighbours packed at
    P = 64 and cut to 48 columns, unit weights): given JAX's draws, the
    walk equals JAX's at one shard.  K1 and K25 give a lane ceil(P / 32)
    columns, so that no neighbour is left out at such a width."""
    rng = np.random.default_rng(4)
    n = 64
    deg = rng.integers(20, 41, n)
    src = np.repeat(np.arange(n), deg).astype(np.int32)
    dst = rng.integers(0, n, len(src)).astype(np.int32)
    g, packed = _packed(src, dst, n_vertices=n, directed=True)
    assert packed.shape[1] == 128 and np.diff(g.indptr).max() > 32
    packed = np.ascontiguousarray(np.concatenate([packed[:, :48], packed[:, 64:112]], 1))
    starts = np.arange(W, dtype=np.int32) % n
    want = _jax_walk(packed, 1, starts, 0.5, 2.0, 0)
    draws = _jax_draws(1)[0]
    got = epd.edge_partitioned_walk(
        make_mesh(device="cpu"), torch.from_numpy(packed), n, torch.from_numpy(starts), SEED,
        walk_length=L, return_param=0.5, inout_param=2.0,
        draws=lambda t: torch.from_numpy(draws[t]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).all()


def test_truncation_counts_unfinished():
    """A capacity of 3 at one shard cannot finish 64 walks of 8 steps in the
    36 supersteps the bound allows: the paths still equal JAX's, and the
    walkers left pending are counted in ``stats``, not cut silently."""
    _, packed = _packed(*karate())
    starts = (np.arange(W) % 34).astype(np.int32)
    want = _jax_walk(packed, 1, starts, 0.5, 2.0, 3)
    draws = _jax_draws(1)[0]
    st: dict = {}
    got = epd.edge_partitioned_walk(
        make_mesh(device="cpu"), torch.from_numpy(packed), 34, torch.from_numpy(starts), SEED,
        walk_length=L, return_param=0.5, inout_param=2.0, capacity=3,
        draws=lambda t: torch.from_numpy(draws[t]), stats=st)
    np.testing.assert_array_equal(got.numpy(), want)
    assert st == {"supersteps": epd.max_supersteps(L), "unfinished": int((want[:, -1] < 0).sum())}
    assert 0 < st["unfinished"] < W


def test_sinks_and_dead_lanes():
    """A chain 0 -> 1 -> 2 (a sink) among isolated vertices: walkers die at
    the sink and pad with -1; a dead lane (start -1) stays dead (JAX's
    test_edge_partitioned_walk_sinks, with the port's draws)."""
    _, packed = _packed(np.array([0, 1], np.int32), np.array([1, 2], np.int32), n_vertices=8,
                        directed=True)
    starts = torch.tensor([0, 1, 2, 3, -1, 5, 6, 7], dtype=torch.int32)
    st: dict = {}
    got = epd.edge_partitioned_walk(make_mesh(device="cpu"), torch.from_numpy(packed), 8, starts,
                                    1, walk_length=4, return_param=1.0, inout_param=1.0,
                                    stats=st).numpy()
    np.testing.assert_array_equal(got[:5], [[0, 1, 2, -1, -1], [1, 2, -1, -1, -1],
                                            [2, -1, -1, -1, -1], [3, -1, -1, -1, -1],
                                            [-1, -1, -1, -1, -1]])
    assert st["unfinished"] == 0


def test_validity_under_deferral():
    """With the port's own draws at a capacity of 16 (64 walkers, 12
    supersteps of the bound's 16): every path completes contiguously and
    every hop is an edge of karate."""
    g, packed = _packed(*karate())
    starts = torch.arange(W, dtype=torch.int32) % 34
    st: dict = {}
    got = epd.edge_partitioned_walk(make_mesh(device="cpu"), torch.from_numpy(packed), 34,
                                    starts, 5, walk_length=3, return_param=0.5, inout_param=2.0,
                                    capacity=16, stats=st).numpy()
    assert (got >= 0).all() and st["unfinished"] == 0 and st["supersteps"] > 3
    adj = {v: set(g.neighbors(v)[0].tolist()) for v in range(g.n_vertices)}
    for row in got:
        for a, b in zip(row[:-1], row[1:]):
            assert b in adj[int(a)], row


def test_matches_analytic_distribution():
    """The exact p/q distribution after (0, 1), with the port's draws on
    weights that are not dyadic (JAX's
    test_edge_partitioned_matches_analytic_distribution)."""
    src = np.array([0, 0, 1, 1, 1, 2, 2, 3], dtype=np.int32)
    dst = np.array([1, 2, 0, 2, 3, 1, 0, 1], dtype=np.int32)
    w = np.array([1.0, 1.0, 1.0, 2.0, 1.5, 1, 1, 1], dtype=np.float32)
    _, packed = _packed(src, dst, w, directed=True)
    p, q = 0.5, 2.0
    paths = epd.edge_partitioned_walk(make_mesh(device="cpu"), torch.from_numpy(packed), 4,
                                      torch.zeros(8192, dtype=torch.int32), 3, walk_length=2,
                                      return_param=p, inout_param=q).numpy()
    nxt = paths[paths[:, 1] == 1, 2]
    # N(1) = {0 back, 2 shared with N(0) = {1, 2}, 3 far}, weights 1, 2, 1.5
    target = np.array([1.0 / p, 2.0, 1.5 / q])
    target /= target.sum()
    counts = np.array([(nxt == v).sum() for v in (0, 2, 3)], dtype=np.float64)
    assert stats.chisquare(counts, target * counts.sum()).pvalue > 1e-4


def test_default_draws_keyed_on_seed_and_coordinate():
    """The default draws are a pure function of (seed, data coordinate):
    the same pair repeats them, another seed or coordinate does not."""
    a = epd.default_draws(3, 0, 16, "cpu")
    b = epd.default_draws(3, 0, 16, "cpu")
    first = a(0)
    np.testing.assert_array_equal(first.numpy(), b(0).numpy())
    assert not torch.equal(a(1), first)
    for seed, coord in ((4, 0), (3, 1)):
        assert not torch.equal(epd.default_draws(seed, coord, 16, "cpu")(0), first)


def test_superstep_stages_on_cpu_are_the_plain_versions():
    """On CPU tensors K24, K25 and K26's wrappers give their plain versions'
    buffers: empty slots answer -1 in every field, a deferred lane keeps its
    slot at S·cap."""
    _, packed = _packed(*karate())
    starts = torch.arange(0, 32, 2, dtype=torch.int32)  # 9 on owner 0, 7 on owner 1
    carry = epd.init_carry(starts)
    prev_rows = torch.full((16, packed.shape[1] // 2), int(epd.PAD_ID), dtype=torch.int32)
    u = torch.rand(16, generator=torch.Generator().manual_seed(0))
    kw = dict(n_shards=2, capacity=4, rows_per_shard=17, walk_length=L)
    send, slot = epd.epd_bucket(carry, prev_rows, u, **kw)
    want_send, want_slot = epd.epd_bucket_plain(carry, prev_rows, u, **kw)
    assert torch.equal(send, want_send) and torch.equal(slot, want_slot)
    assert int((slot == 8).sum()) == 8  # 16 lanes, 2 owners x capacity 4 placed: 8 defer
    resp = epd.epd_serve(send[:4], torch.from_numpy(packed[:17]), my_shard=0,
                         rows_per_shard=17, return_param=0.5, inout_param=2.0)
    assert (resp[:, 0] >= 0).all()
    empty = epd.epd_serve(torch.full((2, send.shape[1]), -1, dtype=torch.int32),
                          torch.from_numpy(packed[:17]), my_shard=0, rows_per_shard=17,
                          return_param=0.5, inout_param=2.0)
    assert (empty == -1).all()
