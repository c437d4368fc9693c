"""The port's Quickstart path against node2vec_tpu's on the CPU: bit-equal
walks, embedding quality within 0.05 micro-F1 of the JAX package, vector
files interchangeable, and no silent CPU run."""

import numpy as np
import pandas as pd
import pytest
import torch

import node2vec_tpu
from node2vec_tpu.constants import Node2VecParams as RefN2V
from node2vec_tpu.constants import Word2VecParams as RefW2V
from node2vec_tpu.datasets import run_quality as ref_run_quality
from node2vec_tpu.embedding import Node2VecTPUEmbedding
import node2vec_torch
from node2vec_torch import Node2Vec, Node2VecParams, Word2VecParams
from node2vec_torch.datasets import run_quality, synthetic_multilabel
from node2vec_torch.embedding import Node2VecTorchEmbedding

N2V = {"num_walks": 4, "walk_length": 12, "return_param": 0.25, "inout_param": 4.0}
W2V = {"vector_size": 32, "max_iter": 2, "min_count": 1}


def test_quickstart_walks_bit_equal_to_jax(karate_edges):
    src, dst = karate_edges
    ref = node2vec_tpu.Node2Vec(n2v_params=N2V, w2v_params=W2V, random_seed=3)
    ref.preprocess_input_graph((src, dst), directed=False)
    port = Node2Vec(n2v_params=N2V, w2v_params=W2V, random_seed=3, device="cpu")
    port.preprocess_input_graph((src, dst), directed=False)
    np.testing.assert_array_equal(port.random_walk(), ref.random_walk())
    port.fit()
    emb = port.embedding()
    assert list(emb.columns) == ["name", "vector"] and len(emb) == 34
    names, vectors = port.embedding(as_frame=False)
    np.testing.assert_array_equal(np.stack(emb["vector"]), vectors)
    np.testing.assert_array_equal(port.get_vector(5), vectors[5])


def test_string_names_quickstart():
    df = pd.DataFrame({"src": ["a", "b", "c"], "dst": ["b", "c", "a"]})
    n2v = Node2Vec(n2v_params=N2V, w2v_params=W2V, device="cpu")
    n2v.preprocess_input_graph(df, indexed=False, directed=False)
    n2v.random_walk()
    n2v.fit()
    assert sorted(n2v.embedding()["name"]) == ["a", "b", "c"]
    assert n2v.get_vector("a").shape == (32,)
    with pytest.raises(KeyError):
        n2v.get_vector("zz")


def test_run_pipeline_matches_random_walk(karate_edges):
    n2v = Node2Vec(n2v_params=N2V, w2v_params=W2V, device="cpu")
    n2v.preprocess_input_graph(karate_edges, directed=False)
    model = n2v.run_pipeline()
    walks = n2v.walks.copy()
    np.testing.assert_array_equal(n2v.random_walk(), walks)
    assert np.isfinite(model.vectors).all()
    streamed = n2v.run_pipeline(streaming=True)  # one chunk, streamed on request
    assert n2v.walks is None and np.isfinite(streamed.vectors).all()


@pytest.mark.parametrize("streaming,chunk,n_chunks,streams", [
    (None, 1 << 17, 1, False), (None, 64, 3, True), (True, 1 << 17, 1, True)])
def test_run_pipeline_streaming_decision(karate_edges, streaming, chunk, n_chunks, streams):
    """streaming=None decides as the JAX package does: one walker chunk
    trains in memory exactly as streaming=False; several chunks stream, as
    streaming=True does, and give the vectors of fit_streaming over
    chunk_source.  The chunk count is the JAX engine's."""
    kw = dict(n2v_params={**N2V, "walker_chunk": chunk}, w2v_params=W2V, device="cpu")
    n2v = Node2Vec(**kw)
    n2v.preprocess_input_graph(karate_edges, directed=False)
    ref_n2v = node2vec_tpu.Node2Vec(n2v_params={**N2V, "walker_chunk": chunk}, w2v_params=W2V)
    ref_n2v.preprocess_input_graph(karate_edges, directed=False)
    ref_chunks = ref_n2v._walk_engine().chunk_source()[0]
    assert n2v._walk_engine().chunk_source()[0] == ref_chunks == n_chunks
    got = n2v.run_pipeline(streaming=streaming)
    if streams:
        assert n2v.walks is None
        engine = node2vec_torch.WalkEngine(n2v.graph, n2v.n2v_params, device="cpu")
        count, _, source = engine.chunk_source(seed=0)
        want = node2vec_torch.Word2VecTorch(n2v.w2v_params, device="cpu").fit_streaming(
            source, count, n2v.graph.n_vertices)
        np.testing.assert_array_equal(got.vectors, want.vectors)
        return
    ref = Node2Vec(**kw)
    ref.preprocess_input_graph(karate_edges, directed=False)
    want = ref.run_pipeline(streaming=False)
    np.testing.assert_array_equal(n2v.walks, ref.walks)
    np.testing.assert_array_equal(got.vectors, want.vectors)


def test_fit_counts_numpy_and_tensor_corpora_alike(karate_edges):
    """fit() counts a numpy corpus on the host before the upload and a
    tensor where it lies (K6's plain version on the CPU): same vocabulary."""
    walks = np.random.default_rng(4).integers(-1, 34, (300, 9)).astype(np.int32)
    a = node2vec_torch.Word2VecTorch(Word2VecParams(**{**W2V, "min_count": 3}), device="cpu")
    b = node2vec_torch.Word2VecTorch(Word2VecParams(**{**W2V, "min_count": 3}), device="cpu")
    a.fit(walks, n_vertices=40)
    b.fit(torch.from_numpy(walks), n_vertices=40)
    for field in ("counts", "mask", "ns_alias", "ns_prob"):
        np.testing.assert_array_equal(getattr(a.vocab, field), getattr(b.vocab, field))
    np.testing.assert_array_equal(a.vectors, b.vectors)


def test_multilabel_quality_close_to_jax():
    """micro-F1@0.5 >= 0.55 (the bench gate) and within 0.05 of the JAX value."""
    g, labels = synthetic_multilabel(600, seed=0)
    kw_n2v = dict(num_walks=6, walk_length=20)
    kw_w2v = dict(min_count=1, max_iter=3, vector_size=32)
    got = run_quality(g, labels, Node2VecParams(**kw_n2v), Word2VecParams(**kw_w2v),
                      train_ratios=(0.5,), device="cpu")["micro_f1@0.5"]
    ref_g, ref_labels = node2vec_tpu.datasets.synthetic_multilabel(600, seed=0)
    np.testing.assert_array_equal(ref_labels, labels)
    want = ref_run_quality(ref_g, ref_labels, RefN2V(**kw_n2v), RefW2V(**kw_w2v),
                           train_ratios=(0.5,))["micro_f1@0.5"]
    assert got >= 0.55, got
    assert abs(got - want) <= 0.05, (got, want)


def test_vectors_interchange_both_ways(tmp_path, karate_edges):
    walks = np.random.default_rng(0).integers(0, 34, (200, 8)).astype(np.int32)
    names = np.array([f"v{i}" for i in range(34)])
    ref = Node2VecTPUEmbedding(walks, name_id=names, w2v_params=W2V)
    ref.fit()
    ref.save_vectors(str(tmp_path), "ref.txt")
    port = Node2VecTorchEmbedding(walks, name_id=names, w2v_params=W2V, device="cpu")
    port.fit()
    port.save_vectors(str(tmp_path), "port.txt")
    got = port.load_vectors(str(tmp_path), "ref.txt")
    want = ref.load_vectors(str(tmp_path), "ref.txt")
    assert list(got["name"]) == list(want["name"]) == list(names)
    np.testing.assert_array_equal(np.stack(got["vector"]), np.stack(want["vector"]))
    back = ref.load_vectors(str(tmp_path), "port.txt")
    assert list(back["name"]) == list(names)
    np.testing.assert_allclose(np.stack(back["vector"]), port.model.vectors, rtol=1e-5, atol=1e-6)


def test_no_silent_cpu_run(karate_edges):
    """Without CUDA the entry points raise unless device='cpu' is passed."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    g = node2vec_torch.from_edge_arrays(*karate_edges, directed=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Node2Vec()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        node2vec_torch.WalkEngine(g, Node2VecParams())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        node2vec_torch.Word2VecTorch()


def test_unported_pipeline_options_raise(karate_edges):
    """On a mesh the graph-sharded walks raise naming ROADMAP item 12;
    without one, graph_sharded=True is the JAX engine's ValueError when the
    walks start; host_corpus with a mesh is JAX's ValueError; a mesh with
    the default column layout now walks and trains (a world of one)."""
    from node2vec_torch.parallel import make_mesh

    mesh = make_mesh(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 12"):
        Node2Vec(mesh=mesh, graph_sharded=True, device="cpu")
    no_mesh = Node2Vec(graph_sharded=True, device="cpu")
    no_mesh.preprocess_input_graph(karate_edges, directed=False)
    with pytest.raises(ValueError, match="requires a mesh"):
        no_mesh.random_walk()
    with pytest.raises(ValueError, match="host_corpus"):
        Node2Vec(mesh=mesh, host_corpus=True, device="cpu")
    port = Node2Vec(n2v_params=N2V, w2v_params=W2V, random_seed=3, mesh=mesh, device="cpu")
    port.preprocess_input_graph(karate_edges, directed=False)
    one = Node2Vec(n2v_params=N2V, w2v_params=W2V, random_seed=3, device="cpu")
    one.preprocess_input_graph(karate_edges, directed=False)
    np.testing.assert_array_equal(port.random_walk(), one.random_walk())
    assert len(port.fit().losses) == W2V["max_iter"]
    assert np.isfinite(port.embedding(as_frame=False)[1]).all()


def test_table_sharding_is_validated_as_in_jax(karate_edges):
    """Node2Vec takes the JAX default table_sharding="column" and "row",
    and refuses anything else with or without a mesh (ROADMAP Queue C 2;
    node2vec_tpu/api.py:84-87)."""
    for layout in ("column", "row"):
        assert Node2Vec(table_sharding=layout, device="cpu").table_sharding == layout
    from node2vec_torch.parallel import make_mesh

    mesh = make_mesh(device="cpu")
    for kw in ({}, {"mesh": mesh}):
        with pytest.raises(ValueError, match="table_sharding"):
            Node2Vec(table_sharding="diagonal", device="cpu", **kw)
    # "row" on a mesh trains (the row-sharded trainers)
    row = Node2Vec(n2v_params=N2V, w2v_params=W2V, table_sharding="row", mesh=mesh,
                   device="cpu")
    row.preprocess_input_graph(karate_edges, directed=False)
    row.random_walk()
    model = row.fit()
    assert all(np.isfinite(model.losses)) and np.isfinite(model.vectors).all()
