"""node2vec_torch's CSR walk engine (``strategy="csr"``, K12's plain
version), its segment searches and ``DeviceGraph`` against node2vec_tpu's
on the CPU, and the JAX ``WalkEngine`` signature (ROADMAP Queue C 2).

Weights in {0.5, 1, 2} and p, q powers of two (or q = 5, whose 1/q only
meets exact products) make every float32 product of the sampler exact, so
the paths must be bit-equal to JAX ``walk_chunk``'s (no tolerance).  The
JAX package's own distribution and degree-one tests (tests/test_walk.py:147
and :173) run on the port's engine.  The JAX graphs here are built from the
port's arrays, so the JAX native library is never loaded."""

from unittest import mock

import numpy as np
import pytest
import torch
from scipy import stats

import jax.numpy as jnp

from node2vec_tpu.constants import Node2VecParams as RefParams
from node2vec_tpu.graph import csr as ref_csr
from node2vec_tpu.ops import sampling as ref_sampling
from node2vec_tpu.walk import WalkEngine as RefWalkEngine
from node2vec_tpu.walk import engine as ref_engine
from node2vec_torch import _build
from node2vec_torch.constants import Node2VecParams
from node2vec_torch.graph import from_edge_arrays
from node2vec_torch.graph.csr import DeviceGraph, Graph
from node2vec_torch.ops import sampling
from node2vec_torch.walk import WalkEngine
from node2vec_torch.walk import csr

PQ = [(1.0, 1.0), (0.25, 4.0), (4.0, 0.25), (1.0, 5.0)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dyadic_graph(seed=0, n=120, m=900, directed=True):
    """Weights in {0.5, 1, 2}; vertices >= n - 10 are sinks (directed)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 10, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    keep = src != dst
    w = rng.choice(np.float32([0.5, 1.0, 2.0]), int(keep.sum()))
    return from_edge_arrays(src[keep], dst[keep], w, n_vertices=n, directed=directed)


def _ref_graph(g: Graph) -> ref_csr.Graph:
    """The JAX package's Graph over the port's arrays."""
    return ref_csr.Graph(indptr=g.indptr, indices=g.indices, weights=g.weights, alias=g.alias,
                         prob=g.prob, directed=g.directed)


@pytest.mark.parametrize("p,q", PQ)
def test_csr_walk_chunk_bit_equal(p, q):
    g = _dyadic_graph()
    starts = np.tile(np.arange(g.n_vertices, dtype=np.int32), 3)
    starts[::11] = -1  # dead lanes
    gid_base, seed, iters = 37, 0xDEADBEEF, csr.search_iters(int(np.diff(g.indptr).max()))
    kw = dict(walk_length=15, return_param=p, inout_param=q, max_trials=64, search_iters=iters)
    rg = _ref_graph(g).to_device()
    want = np.asarray(ref_engine.walk_chunk(
        rg.indptr, rg.indices, rg.weights, rg.alias, rg.prob, rg.wtot, jnp.asarray(starts),
        jnp.arange(gid_base, gid_base + len(starts), dtype=jnp.int32), jnp.uint32(seed), **kw))
    dg = g.to_device("cpu")
    _build.reset_launches()
    got = csr.csr_walk_chunk(*dg, torch.from_numpy(starts), gid_base, seed, **kw).numpy()
    assert sum(_build.launches.values()) == 0  # CPU tensors: the plain version
    np.testing.assert_array_equal(got, want)
    assert (got[::11] == -1).all() and (got[:, -1] == -1).any()  # dead lanes, sinks
    assert csr.proposal_rounds(p, q, 64)[0] == (1 if (p, q) == (1.0, 1.0) else 2)


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.25, 4.0), (1.0, 5.0)])
def test_csr_engine_run_equal_jax_and_chunk_invariant(p, q):
    g = _dyadic_graph(1, directed=False)
    kw = dict(num_walks=3, walk_length=9, return_param=p, inout_param=q)
    want = RefWalkEngine(_ref_graph(g), RefParams(**kw), strategy="csr").run(seed=5)
    eng = WalkEngine(g, Node2VecParams(**kw), strategy="csr", device="cpu")
    np.testing.assert_array_equal(eng.run(seed=5), want)
    small = WalkEngine(g, Node2VecParams(walker_chunk=50, **kw), strategy="csr", device="cpu")
    assert small._effective_chunk(360) == 50
    np.testing.assert_array_equal(small.run(seed=5), want)
    np.testing.assert_array_equal(small.run_device(seed=5).numpy(), want)
    starts = np.array([3, 8, 40], dtype=np.int32)
    np.testing.assert_array_equal(
        small.run(seed=5, start_vertices=starts),
        RefWalkEngine(_ref_graph(g), RefParams(**kw), strategy="csr").run(
            seed=5, start_vertices=starts))


@pytest.mark.parametrize("strategy", ["dense", "csr"])
def test_both_strategies_match_analytic_distribution(strategy):
    """tests/test_walk.py:147 on the port: the second step from 0 -> 1 is
    distributed as w * bias over N(1) = {0, 2, 3}."""
    src = np.array([0, 0, 1, 1, 1, 2, 2, 3], dtype=np.int32)
    dst = np.array([1, 2, 0, 2, 3, 1, 0, 1], dtype=np.int32)
    w = np.array([1.0, 1.0, 1.0, 2.0, 1.5, 1, 1, 1], dtype=np.float32)
    g = from_edge_arrays(src, dst, w, directed=True)
    p, q = 0.5, 2.0
    params = Node2VecParams(num_walks=6000, walk_length=2, return_param=p, inout_param=q,
                            walker_chunk=1 << 14)
    engine = WalkEngine(g, params, strategy=strategy, device="cpu")
    assert engine.strategy == strategy
    walks = engine.run(seed=13, start_vertices=np.array([0], dtype=np.int32))
    nxt = walks[walks[:, 1] == 1, 2]
    target = np.array([1.0 / p, 2.0, 1.5 / q])
    target /= target.sum()
    counts = np.array([(nxt == v).sum() for v in (0, 2, 3)], dtype=np.float64)
    res = stats.chisquare(counts, target * counts.sum())
    assert res.pvalue > 1e-4, (strategy, counts, target * counts.sum())


@pytest.mark.parametrize("p,q", [(4.0, 0.25), (0.25, 4.0)])
def test_csr_degree_one_back_edge_forced(p, q):
    """tests/test_walk.py:173 on the port: at a degree-1 vertex whose one
    neighbour is prev the walker moves back at once."""
    src = np.array([0, 1, 1, 2], dtype=np.int32)
    dst = np.array([1, 0, 2, 1], dtype=np.int32)
    g = from_edge_arrays(src, dst, directed=True)
    params = Node2VecParams(num_walks=200, walk_length=8, return_param=p, inout_param=q,
                            walker_chunk=1 << 10)
    walks = WalkEngine(g, params, strategy="csr", device="cpu").run(
        seed=5, start_vertices=np.array([0], dtype=np.int32))
    assert (walks >= 0).all()
    at0 = walks[:, :-1] == 0
    assert (walks[:, 1:][at0] == 1).all()


def test_general_weights_chi_square():
    from node2vec_torch.eval import walk_transition_pvalue

    src = np.array([0, 0, 1, 1, 1, 2, 2, 3], dtype=np.int32)
    dst = np.array([1, 2, 0, 2, 3, 0, 1, 1], dtype=np.int32)
    w = np.array([1.0, 1.0, 1.0, 2.0, 1.5, 1, 1, 1], dtype=np.float32) * np.float32(1.3)
    g = from_edge_arrays(src, dst, w, directed=True)
    params = Node2VecParams(num_walks=8000, walk_length=2, return_param=0.5, inout_param=2.0)
    walks = WalkEngine(g, params, strategy="csr", device="cpu").run(
        seed=11, start_vertices=np.array([0], np.int32))
    pval = walk_transition_pvalue(g, walks, 0, 1, 0.5, 2.0)
    assert pval is not None and pval > 1e-4, pval


# --------------------------------------------------------------------------- #
# segment searches and the DeviceGraph
# --------------------------------------------------------------------------- #


def test_segment_searches_equal_jax():
    """Random values in random segments, empty and one-element segments
    among them, and values below, inside and above each segment."""
    rng = np.random.default_rng(0)
    data = np.sort(rng.integers(0, 50, 40)).astype(np.int32)
    start = rng.integers(0, 40, 300).astype(np.int32)
    length = np.minimum(rng.integers(0, 6, 300), 40 - start).astype(np.int32)
    length[:40] = 0  # empty segments
    length[40:80] = np.minimum(1, 40 - start[40:80])  # one element
    values = rng.integers(-2, 53, 300).astype(np.int32)
    length[80:120] = np.maximum(length[80:120], 1)
    values[80:120] = data[start[80:120]]  # present
    args = [values, start, length, data]
    for n_iters in (1, 3, 32):
        want_pos = np.asarray(ref_sampling.searchsorted_in_segments(
            *map(jnp.asarray, args), n_iters=n_iters))
        want_in = np.asarray(ref_sampling.contains_in_segments(
            *map(jnp.asarray, args), n_iters=n_iters))
        t = list(map(torch.from_numpy, args))
        np.testing.assert_array_equal(
            sampling.searchsorted_in_segments(*t, n_iters=n_iters).numpy(), want_pos)
        np.testing.assert_array_equal(
            sampling.contains_in_segments(*t, n_iters=n_iters).numpy(), want_in)
    assert want_in[80:120].all() and not want_in[:40].any()


def test_device_graph_equals_jax_to_device():
    g = _dyadic_graph(2)
    g.weights = np.random.default_rng(1).random(g.n_edges).astype(np.float32)  # wtot rounding
    want = _ref_graph(g).to_device()
    got = g.to_device("cpu")
    assert isinstance(got, DeviceGraph)
    assert (got.n_vertices, got.n_edges) == (want.n_vertices, want.n_edges)
    for name in DeviceGraph._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    with mock.patch.object(Graph, "n_edges", new_callable=mock.PropertyMock,
                           return_value=1 << 31):
        with pytest.raises(ValueError, match="2\\^31"):
            g.to_device("cpu")


def test_edgeless_graph_walks_end_at_their_starts():
    g = from_edge_arrays(np.zeros(0, np.int32), np.zeros(0, np.int32), n_vertices=5)
    walks = WalkEngine(g, Node2VecParams(num_walks=2, walk_length=4, return_param=0.5),
                       strategy="csr", device="cpu").run(seed=1)
    np.testing.assert_array_equal(walks[:, 0], np.tile(np.arange(5), 2))
    assert (walks[:, 1:] == -1).all()


# --------------------------------------------------------------------------- #
# the engine: signature, DeviceGraph input, checkpoints
# --------------------------------------------------------------------------- #


def test_walk_engine_takes_the_jax_signature():
    """graph_sharded / partitioned_graph as the JAX engine takes them
    (ROADMAP Queue C 2; with a mesh, the graph-sharded engine), and a
    DeviceGraph as the graph."""
    g = _dyadic_graph()
    eng = WalkEngine(g, Node2VecParams(), graph_sharded=False, partitioned_graph=None,
                     device="cpu")
    assert eng.strategy == "dense"
    with pytest.raises(ValueError, match="requires a mesh"):
        WalkEngine(g, Node2VecParams(), graph_sharded=True, device="cpu")
    from node2vec_torch.parallel import make_mesh

    sharded = WalkEngine(g, Node2VecParams(), mesh=make_mesh(device="cpu"), graph_sharded=True,
                         partitioned_graph=None, device="cpu")
    assert sharded.strategy == "ep_blocked" and sharded.bgraph is None
    kw = dict(num_walks=2, walk_length=7, return_param=0.25, inout_param=4.0)
    dg = g.to_device("cpu")
    for strategy in ("csr", "dense", "blocked"):
        from_dev = WalkEngine(dg, Node2VecParams(**kw), strategy=strategy, device="cpu")
        from_host = WalkEngine(g, Node2VecParams(**kw), strategy=strategy, device="cpu")
        assert from_dev.graph_token == from_host.graph_token
        assert from_dev.search_iters == from_host.search_iters == 5
        np.testing.assert_array_equal(from_dev.run(seed=3), from_host.run(seed=3))
    assert WalkEngine(dg, Node2VecParams(), strategy="csr", device="cpu").dgraph is dg


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_csr_walk_checkpoints_interchange(tmp_path, monkeypatch, writer):
    """Walk chunks written by one package with strategy="csr" are resumed
    by the other without walking (same fingerprint, same strategy token)."""
    g = _dyadic_graph(3, directed=False)
    kw = dict(num_walks=2, walk_length=6, walker_chunk=64, return_param=0.25, inout_param=4.0)
    port = WalkEngine(g, Node2VecParams(**kw), strategy="csr", device="cpu")
    ref = RefWalkEngine(_ref_graph(g), RefParams(**kw), strategy="csr")
    assert port._strategy_token() == ref._strategy_token() == "csr"
    assert port.graph_token == ref.graph_token
    src, dst = (ref, port) if writer == "jax" else (port, ref)
    d = str(tmp_path)
    full = src.run(seed=4, checkpoint_dir=d)

    def no_walk(*a, **k):
        raise AssertionError("a saved chunk was walked again")

    monkeypatch.setattr(dst, "_run_chunk", no_walk)
    np.testing.assert_array_equal(dst.run(seed=4, checkpoint_dir=d), full)
