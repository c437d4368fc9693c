"""node2vec_torch's blocked walk engine and vertex counts against
node2vec_tpu's on the CPU.

Weights in {0.5, 1, 2} and p, q powers of two make every partial sum of the
inverse CDFs exact, so the tables, paths and counters must be bit-equal (no
tolerance).  General weights are held by the chi-square transition test
(p-value > 1e-4).  The slice end to end is held to the dense slice's
quality tolerance: micro-F1@0.5 within 0.05 of the JAX package's."""

import importlib.util
import os
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import node2vec_tpu
from node2vec_tpu import native as ref_native
from node2vec_tpu.constants import Node2VecParams as RefParams
from node2vec_tpu.graph import from_edge_arrays as ref_from_edge_arrays
from node2vec_tpu.models import vocab as ref_vocab
from node2vec_tpu.walk import WalkEngine as RefWalkEngine
from node2vec_tpu.walk import blocked as ref_blocked
from node2vec_torch import Node2Vec, convert, native
from node2vec_torch.constants import Node2VecParams
from node2vec_torch.datasets import multilabel_f1, synthetic_multilabel
from node2vec_torch.eval import walk_transition_pvalue
from node2vec_torch.graph import from_edge_arrays
from node2vec_torch.models import vocab
from node2vec_torch.walk import WalkEngine
from node2vec_torch.walk import blocked

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DYADIC = np.float32([0.5, 1.0, 2.0])


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault(name, mod)
    spec.loader.exec_module(mod)
    return mod


def _ref_native_loaded(deadline_s: float = 120.0) -> None:
    """Load the JAX package's native library, waiting out a concurrent build.

    Its loader compiles libgraphcore.so in place with g++ and, after one
    failed load, gives up for the life of the process; under xdist another
    worker may still be writing the file when this one first loads it.  The
    file is then newer than its source, so each retry only reloads it.
    Fails (never skips) naming the library if it does not load in time."""
    t_end = time.monotonic() + deadline_s
    while not ref_native.available():
        if time.monotonic() > t_end:
            pytest.fail(f"{ref_native._LIB_PATH} did not load within {deadline_s:.0f} s")
        time.sleep(0.5)
        ref_native._tried = False


def _hub_graph(hub_deg=600, seed=0, with_far=False, weights=None):
    """tests/test_blocked.py's hub: vertex 0 with ``hub_deg`` out/in edges
    and a ring over its neighbours; ``with_far`` adds a vertex every ring
    vertex reaches that is not the hub's neighbour (the 1/q class)."""
    rng = np.random.default_rng(seed)
    nbrs = np.arange(1, hub_deg + 1, dtype=np.int32)
    src = np.concatenate([np.zeros(hub_deg, np.int32), nbrs, nbrs, nbrs % hub_deg + 1])
    dst = np.concatenate([nbrs, np.zeros(hub_deg, np.int32), nbrs % hub_deg + 1, nbrs])
    if with_far:
        far = np.int32(hub_deg + 1)
        src = np.concatenate([src, nbrs, [far]])
        dst = np.concatenate([dst, np.full(hub_deg, far, np.int32), [1]])
    if weights is None:
        w = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    else:
        w = rng.choice(weights, len(src))
    return src, dst, w


def _rmat(scale):
    src, dst = _load("scale_test", "examples/scale_test.py").rmat_edges(scale, 8 << scale)
    return src, dst, np.ones(len(src), np.float32)


def _dyadic_heavy(seed=0, n=500):
    """Directed graph with weights {0.5, 1, 2}: three multi-block hubs, light
    vertices of degree 1..40 (so some are heavy at P = 31), and sinks
    (vertices >= n - 15 have no out-edges)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 41, n - 15)
    deg[:3] = (300, 520, 700)
    src = np.repeat(np.arange(n - 15), deg).astype(np.int32)
    dst = rng.integers(0, n, len(src)).astype(np.int32)
    back = rng.random(len(src)) < 0.5  # many reverse edges: 1/p atoms, triangles
    src, dst = np.concatenate([src, dst[back]]), np.concatenate([dst, src[back]])
    keep = src < n - 15
    return src[keep], dst[keep], rng.choice(DYADIC, int(keep.sum()))


def _both_graphs(src, dst, w, directed=True):
    g = from_edge_arrays(src, dst, w, directed=directed)
    return g, ref_from_edge_arrays(src, dst, w, directed=directed)


GRAPHS = {
    "hub600": lambda: _hub_graph(600),
    "hub20000": lambda: _hub_graph(20000),
    "rmat10": lambda: _rmat(10),
}


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_tables_equal_jax(name, use_native):
    src, dst, w = GRAPHS[name]()
    g, _ = _both_graphs(src, dst, w, directed=name != "rmat10")
    if use_native:
        _ref_native_loaded()
    with mock.patch.object(native, "available", return_value=use_native), \
            mock.patch.object(ref_native, "available", return_value=use_native):
        want = ref_blocked.build_blocked_graph(g.indptr, g.indices, g.weights)
        got = blocked.build_blocked_graph(g.indptr, g.indices, g.weights, device="cpu")
    assert (got.light_width, got.block_width, got.has_heavy) == (
        want.light_width, want.block_width, want.has_heavy)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if name == "hub20000":
        assert got.block_width == 512


@pytest.mark.parametrize("name", ["hub600", "rmat10"])
def test_native_edge_has_shared_equals_fallback(name):
    """The bound n2v_edge_has_shared (no caller until the shared-list
    sampler) gives the numpy fallback's and the JAX binding's triangle bits."""
    g, _ = _both_graphs(*GRAPHS[name](), directed=name != "rmat10")
    got = native.edge_has_shared(g.indptr, g.indices).astype(bool)
    want = blocked._edge_has_shared(g.indptr, g.indices, np.diff(g.indptr))
    np.testing.assert_array_equal(got, want)
    _ref_native_loaded()
    np.testing.assert_array_equal(got, ref_native.edge_has_shared(g.indptr, g.indices) != 0)
    assert got.any()


def test_chip_smoke_rmat_is_the_reference_generator():
    smoke = _load("chip_smoke", "chip_smoke.py")
    ref = _load("scale_test", "examples/scale_test.py")
    for a, b in zip(smoke.rmat_edges(8, 2048, seed=3), ref.rmat_edges(8, 2048, seed=3)):
        np.testing.assert_array_equal(a, b)


def _walk_both(bg_ref, starts, gid_base, seed, **kw):
    bg = convert.blocked_graph_from_arrays(
        *(np.asarray(t) for t in bg_ref[:4]), bg_ref.light_width, bg_ref.block_width,
        bg_ref.has_heavy, device="cpu",
    )
    shapes = dict(light_width=bg.light_width, block_width=bg.block_width,
                  has_heavy=bg.has_heavy)
    want = ref_blocked.blocked_walk_chunk(
        *bg_ref[:4], ref_blocked.slq_or_dummy(bg_ref), jnp.asarray(starts),
        jnp.arange(gid_base, gid_base + len(starts), dtype=jnp.int32), jnp.uint32(seed),
        shared_lists=False, **shapes, **kw,
    )
    got = blocked.blocked_walk_chunk(
        *bg[:4], torch.from_numpy(starts), gid_base, seed, **shapes, **kw
    )
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


@pytest.mark.parametrize("p,q,n_walkers,max_trials", [
    (1.0, 1.0, 1500, 64),
    (0.25, 4.0, 1500, 64),
    (4.0, 0.25, 1500, 64),
    (1.0, 4.0, 1500, 64),
    (0.25, 4.0, 8192, 64),  # the JAX tail-compaction cascade runs
    (0.25, 4.0, 1500, 2),  # trial cap: counted fallbacks
])
def test_blocked_walk_bit_equal(p, q, n_walkers, max_trials):
    g, _ = _both_graphs(*_dyadic_heavy())
    bg_ref = ref_blocked.build_blocked_graph(g.indptr, g.indices, g.weights)
    starts = (np.arange(n_walkers) % g.n_vertices).astype(np.int32)
    starts[::17] = -1  # dead lanes
    (paths, n_fb, n_att), (w_paths, w_fb, w_att) = _walk_both(
        bg_ref, starts, 29, 0xC0FFEE, walk_length=12, return_param=p,
        inout_param=q, max_trials=max_trials,
    )
    np.testing.assert_array_equal(paths, w_paths)
    assert int(n_fb) == int(w_fb) and int(n_att) == int(w_att)
    assert (paths[::17] == -1).all()
    assert (paths[:, -1] == -1).any()  # some walkers end at a sink
    assert np.isin(paths[:, 1:], [0, 1, 2]).any()  # the hubs are walked
    if max_trials == 2:
        assert int(n_fb) > 0


@pytest.mark.parametrize("chunk", [300, 1 << 17])
def test_engine_equals_jax(chunk):
    g, g_ref = _both_graphs(*_dyadic_heavy(1))
    kw = dict(num_walks=3, walk_length=10, return_param=0.5, inout_param=2.0,
              max_rejection_trials=3, walker_chunk=chunk)
    ref = RefWalkEngine(g_ref, RefParams(**kw))
    port = WalkEngine(g, Node2VecParams(**kw), device="cpu")
    assert port.strategy == ref.strategy == "blocked"
    np.testing.assert_array_equal(port.run(seed=8), ref.run(seed=8))
    assert port.fallback_count == ref.fallback_count > 0
    assert port.attempt_count == ref.attempt_count
    port.fallback_count = 0
    port.attempt_count = 5
    assert (port.fallback_count, port.attempt_count) == (0, 5)


@pytest.mark.parametrize("p,q", [(0.25, 4.0), (2.0, 0.5)])
@pytest.mark.parametrize("role", ["heavy_cur", "heavy_prev"])
def test_transition_chi2_general_weights(role, p, q):
    """Hub 0 of degree 100 spans two 64-wide blocks at P = 8: transitions
    out of it after (5, 0), and out of ring vertex 80 after (0, 80), whose
    ring neighbours lie in the hub's second block."""
    g = from_edge_arrays(*_hub_graph(100, seed=3, with_far=True), directed=True)
    bg = blocked.build_blocked_graph(g.indptr, g.indices, g.weights, 8, 64, device="cpu")
    assert bg.has_heavy and int(bg.light[0, 2]) == 2
    prev, cur, start = (5, 0, 5) if role == "heavy_cur" else (0, 80, 0)
    params = Node2VecParams(num_walks=20000, walk_length=2, return_param=p, inout_param=q)
    engine = WalkEngine(g, params, strategy="blocked", device="cpu", blocked_graph=bg)
    walks = engine.run(seed=11, start_vertices=np.array([start], np.int32))
    pval = walk_transition_pvalue(g, walks, prev, cur, p, q)
    assert pval is not None and pval > 1e-4, pval


@pytest.mark.parametrize("given", [True, False])
def test_vertex_counts_equal_jax_device_path(given):
    walks = np.random.default_rng(5).integers(-1, 300, (400, 13)).astype(np.int32)
    n_v = 320 if given else None
    want = ref_vocab.build_vocab(jnp.asarray(walks), n_v, min_count=4)
    got = vocab.build_vocab(torch.from_numpy(walks), n_v, min_count=4)
    for field in ("counts", "mask", "ns_alias", "ns_prob"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.n_vertices == (320 if given else int(walks.max()) + 1)
    counts = vocab.vertex_counts(torch.from_numpy(walks), 200)  # entries >= V dropped
    np.testing.assert_array_equal(counts.numpy(), np.bincount(walks[(walks >= 0) & (walks < 200)],
                                                              minlength=200))


def test_pipeline_blocked_end_to_end():
    """Node2Vec.run_pipeline on a graph with hubs above degree 256 takes the
    blocked engine in both packages: walks and vocabulary equal, quality
    within the dense slice's tolerance (micro-F1@0.5 within 0.05)."""
    g, labels = synthetic_multilabel(600, avg_degree=12, n_labels=4, degree_skew=1.0, seed=0)
    assert np.diff(g.indptr).max() > 256
    src = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr)).astype(np.int32)
    n2v = {"num_walks": 6, "walk_length": 20, "return_param": 0.5, "inout_param": 2.0}
    w2v = {"vector_size": 32, "max_iter": 3, "min_count": 1}
    ref = node2vec_tpu.Node2Vec(n2v_params=n2v, w2v_params=w2v, random_seed=1)
    ref.preprocess_input_graph((src, g.indices), indexed=True, directed=True)
    want = ref.run_pipeline(streaming=False)
    port = Node2Vec(n2v_params=n2v, w2v_params=w2v, random_seed=1, device="cpu")
    port.preprocess_input_graph((src, g.indices), indexed=True, directed=True)
    got = port.run_pipeline(streaming=False)
    assert port._walk_engine().strategy == ref._walk_engine().strategy == "blocked"
    np.testing.assert_array_equal(port.walks, np.asarray(ref.walks))
    for field in ("counts", "mask", "ns_alias", "ns_prob"):
        np.testing.assert_array_equal(getattr(got.vocab, field), getattr(want.vocab, field))
    f1_port = multilabel_f1(got.vectors, labels)["micro_f1"]
    f1_ref = multilabel_f1(np.asarray(want.vectors), labels)["micro_f1"]
    assert abs(f1_port - f1_ref) <= 0.05, (f1_port, f1_ref)


def test_unported_and_invalid_inputs_raise():
    g = from_edge_arrays(*_hub_graph(1000)[:2], directed=True)  # 1000 > MAXB(8) * 64
    with pytest.raises(ValueError, match="capacity"):
        blocked.build_blocked_graph(g.indptr, g.indices, g.weights, 8, 64, device="cpu")
    bg = blocked.build_blocked_graph(g.indptr, g.indices, g.weights, device="cpu")
    kw = dict(walk_length=3, return_param=1.0, inout_param=1.0, max_trials=4,
              light_width=bg.light_width, block_width=bg.block_width, has_heavy=True)
    starts = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        blocked.blocked_walk_chunk(*bg[:4], starts.long(), 0, 0, **kw)
    with pytest.raises(ValueError):
        blocked.blocked_walk_chunk(bg.light, bg.biw, bg.biw, bg.brp, starts, 0, 0, **kw)
    with pytest.raises(ValueError):
        convert.blocked_graph_from_arrays(*(t.numpy() for t in bg[:4]), bg.light_width, 128,
                                          True, device="cpu")
