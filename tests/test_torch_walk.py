"""node2vec_torch's dense walks against node2vec_tpu's on the CPU.

Weights in {0.5, 1, 2} and p, q powers of two make every partial sum of the
inverse CDF exact, so the paths must be bit-equal (no tolerance).  General
weights are checked by the chi-square transition test instead."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from node2vec_tpu import WalkEngine as RefWalkEngine
from node2vec_tpu.constants import Node2VecParams as RefParams
from node2vec_tpu.walk import dense as ref_dense
from node2vec_torch.constants import Node2VecParams
from node2vec_torch.eval import walk_transition_pvalue
from node2vec_torch.graph import from_edge_arrays
from node2vec_torch.walk import WalkEngine, random_walks
from node2vec_torch.walk import dense

PQ = [(1.0, 1.0), (0.25, 4.0), (4.0, 0.25)]


def _dyadic_graph(seed=0, n=120, m=900):
    """Directed graph with weights in {0.5, 1, 2}; vertices >= n-10 are sinks."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 10, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    w = rng.choice(np.float32([0.5, 1.0, 2.0]), m)
    return from_edge_arrays(src, dst, w, n_vertices=n, directed=True)


@pytest.mark.parametrize("p,q", PQ)
def test_dense_walk_chunk_bit_equal(p, q):
    g = _dyadic_graph()
    packed = dense.build_padded_adjacency(g.indptr, g.indices, g.weights)
    starts = np.tile(np.arange(g.n_vertices, dtype=np.int32), 3)
    starts[::11] = -1  # dead lanes
    gid_base, seed = 37, 0xDEADBEEF
    want = np.asarray(ref_dense.dense_walk_chunk(
        jnp.asarray(packed), jnp.asarray(starts),
        jnp.arange(gid_base, gid_base + len(starts), dtype=jnp.int32),
        jnp.uint32(seed), walk_length=15, return_param=p, inout_param=q,
    ))
    got = dense.dense_walk_chunk(
        torch.from_numpy(packed), torch.from_numpy(starts), gid_base, seed,
        walk_length=15, return_param=p, inout_param=q,
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[::11] == -1).all()  # dead lanes stay dead
    assert (got[:, -1] == -1).any()  # some walkers hit a sink


@pytest.mark.parametrize("p,q", PQ)
def test_walk_engine_run_equal_and_chunk_invariant(p, q):
    g = _dyadic_graph(1)
    kw = dict(num_walks=3, walk_length=9, return_param=p, inout_param=q)
    want = RefWalkEngine(g, RefParams(**kw), strategy="dense").run(seed=5)
    got = WalkEngine(g, Node2VecParams(**kw), device="cpu").run(seed=5)
    np.testing.assert_array_equal(got, want)
    small = WalkEngine(g, Node2VecParams(walker_chunk=50, **kw), device="cpu")
    np.testing.assert_array_equal(small.run(seed=5), want)
    starts = np.array([3, 8, 40], dtype=np.int32)
    np.testing.assert_array_equal(
        small.run(seed=5, start_vertices=starts),
        RefWalkEngine(g, RefParams(**kw), strategy="dense").run(seed=5, start_vertices=starts),
    )


def test_run_device_matches_run(karate_edges):
    g = from_edge_arrays(*karate_edges, directed=False)
    eng = WalkEngine(g, Node2VecParams(num_walks=2, walk_length=6, walker_chunk=20), device="cpu")
    dev = eng.run_device(seed=3)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.int32
    np.testing.assert_array_equal(dev.numpy(), eng.run(seed=3))


@pytest.mark.parametrize("p,q", [(0.5, 2.0), (2.0, 0.5)])
def test_walk_transition_pvalue_general_weights(p, q):
    """Chi-square against the analytic p/q distribution (p-value > 1e-4)."""
    src = np.array([0, 0, 1, 1, 1, 2, 2, 3], dtype=np.int32)
    dst = np.array([1, 2, 0, 2, 3, 0, 1, 1], dtype=np.int32)
    w = np.array([1.0, 1.0, 1.0, 2.0, 1.5, 1, 1, 1], dtype=np.float32) * np.float32(1.3)
    g = from_edge_arrays(src, dst, w, directed=True)
    params = Node2VecParams(num_walks=8000, walk_length=2, return_param=p, inout_param=q)
    walks = random_walks(g, params, seed=11, start_vertices=np.array([0], np.int32), device="cpu")
    pval = walk_transition_pvalue(g, walks, 0, 1, p, q)
    assert pval is not None and pval > 1e-4, pval


def test_unported_strategies_raise():
    """ep_blocked without a mesh is a ValueError; with one (a world of
    one) the walker-sharded engine walks the single-device corpus and
    ep_blocked the single-device blocked engine's;
    "csr" builds (its DeviceGraph uploaded at the first chunk); "blocked"
    and a graph above dense_max_degree select the blocked engine."""
    from node2vec_torch.parallel import make_mesh

    g = _dyadic_graph()
    with pytest.raises(ValueError, match="requires a mesh"):
        WalkEngine(g, Node2VecParams(), strategy="ep_blocked", device="cpu")
    mesh = make_mesh(device="cpu")
    params = Node2VecParams(num_walks=2, walk_length=6, return_param=0.25, inout_param=4.0)
    want = WalkEngine(g, params, device="cpu").run(seed=5)
    np.testing.assert_array_equal(WalkEngine(g, params, mesh=mesh, device="cpu").run(seed=5), want)
    want = WalkEngine(g, params, strategy="blocked", device="cpu").run(seed=5)
    for kw in (dict(graph_sharded=True), dict(strategy="ep_blocked")):
        ep = WalkEngine(g, params, mesh=mesh, device="cpu", **kw)
        assert ep.strategy == "ep_blocked" and ep.pgraph.shards == (0,)
        np.testing.assert_array_equal(ep.run(seed=5), want)
    csr = WalkEngine(g, Node2VecParams(), strategy="csr", device="cpu")
    assert csr.strategy == "csr" and csr._dgraph is None
    assert csr.packed_adj is None and csr.bgraph is None
    assert csr.dgraph.n_edges == g.n_edges and csr._dgraph is not None
    forced = WalkEngine(g, Node2VecParams(), strategy="blocked", device="cpu")
    assert forced.strategy == "blocked" and forced.bgraph is not None
    assert forced.packed_adj is None
    hub = np.zeros(300, dtype=np.int32)
    heavy = from_edge_arrays(hub, np.arange(1, 301, dtype=np.int32), directed=True)
    auto = WalkEngine(heavy, Node2VecParams(), device="cpu")
    assert auto.strategy == "blocked" and auto.bgraph.has_heavy
