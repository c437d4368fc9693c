"""node2vec_torch's host graph build against node2vec_tpu.build_graph:
equal CSR arrays, alias tables and name tables (no tolerance)."""

import numpy as np
import pandas as pd
import pytest

import node2vec_tpu
from node2vec_tpu.walk.dense import build_padded_adjacency as ref_padded
from node2vec_torch import native
from node2vec_torch.graph import build_graph, from_edge_arrays
from node2vec_torch.walk.dense import build_padded_adjacency

FIELDS = ("indptr", "indices", "weights", "alias", "prob")


def _assert_graphs_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert got.directed == want.directed
    if want.names is None:
        assert got.names is None
    else:
        np.testing.assert_array_equal(got.names, want.names)


def _random_edges(seed, n=300, m=2000):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    w = rng.choice(np.float32([0.5, 1.0, 2.0]), m)
    return src, dst, w


@pytest.mark.parametrize("directed", [True, False])
def test_toy_graph_equal(toy_graph_edges, directed):
    src, dst, w = toy_graph_edges
    _assert_graphs_equal(
        build_graph((src, dst, w), directed=directed),
        node2vec_tpu.build_graph((src, dst, w), directed=directed),
    )


@pytest.mark.parametrize("directed", [True, False])
def test_karate_graph_equal(karate_edges, directed):
    src, dst = karate_edges
    _assert_graphs_equal(
        build_graph((src, dst), directed=directed),
        node2vec_tpu.build_graph((src, dst), directed=directed),
    )


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("indexed", [True, False])
def test_random_graph_equal(directed, indexed):
    src, dst, w = _random_edges(3)
    if not indexed:  # sparse integer names: the native indexer relabels them
        src, dst = src.astype(np.int64) * 1009 + 5, dst.astype(np.int64) * 1009 + 5
    _assert_graphs_equal(
        build_graph((src, dst, w), directed=directed, indexed=indexed),
        node2vec_tpu.build_graph((src, dst, w), directed=directed, indexed=indexed),
    )


def test_string_names_equal():
    df = pd.DataFrame({"src": ["a", "b", "c", "zz", "b"], "dst": ["b", "c", "a", "a", "q"]})
    got = build_graph(df, indexed=False, directed=False)
    want = node2vec_tpu.build_graph(df, indexed=False, directed=False)
    _assert_graphs_equal(got, want)
    assert got.id_of("zz") == want.id_of("zz")


def test_hotspot_trim_equal_native():
    """Native trim on both sides draws the same subset for the same seed."""
    assert native.available()
    rng = np.random.default_rng(5)
    hub = np.zeros(400, dtype=np.int32)
    src = np.concatenate([hub, rng.integers(1, 200, 600).astype(np.int32)])
    dst = np.concatenate([rng.integers(1, 200, 400), rng.integers(0, 200, 600)]).astype(np.int32)
    for directed in (True, False):
        got = build_graph((src, dst), directed=directed, max_out_degree=50, random_seed=11)
        want = node2vec_tpu.build_graph(
            (src, dst), directed=directed, max_out_degree=50, random_seed=11
        )
        _assert_graphs_equal(got, want)
        assert np.diff(got.indptr).max() <= 50


def test_edge_file_and_npz_inputs(tmp_path):
    src, dst, w = _random_edges(7, n=50, m=200)
    txt = tmp_path / "edges.txt"
    txt.write_text("\n".join(f"{a} {b} {c}" for a, b, c in zip(src, dst, w)))
    npz = tmp_path / "edges.npz"
    np.savez(npz, src=src, dst=dst, weight=w)
    for path in (str(txt), str(npz)):
        _assert_graphs_equal(
            build_graph(path, directed=False), node2vec_tpu.build_graph(path, directed=False)
        )


def test_from_edge_arrays_equal():
    src, dst, w = _random_edges(9)
    got = from_edge_arrays(src, dst, w, n_vertices=320, directed=False)
    want = node2vec_tpu.graph.from_edge_arrays(src, dst, w, n_vertices=320, directed=False)
    _assert_graphs_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_build_padded_adjacency_equal(seed):
    src, dst, w = _random_edges(seed)
    g = from_edge_arrays(src, dst, w, directed=bool(seed))
    np.testing.assert_array_equal(
        build_padded_adjacency(g.indptr, g.indices, g.weights),
        ref_padded(g.indptr, g.indices, g.weights),
    )


def test_numpy_fallback_matches_native(monkeypatch):
    """Without the C++ core the numpy fallback builds the same graph (no trim:
    the two trims draw different subsets by design)."""
    src, dst, w = _random_edges(4)
    want = node2vec_tpu.build_graph((src, dst, w), directed=False, indexed=False)
    monkeypatch.setattr(native, "available", lambda: False)
    _assert_graphs_equal(build_graph((src, dst, w), directed=False, indexed=False), want)
