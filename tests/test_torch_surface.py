"""The rest of the one-device surface of node2vec_torch against node2vec_tpu
on the CPU: model files across packages, word2vec text files, the
``Node2VecBase`` contract, the functional ``trim_index`` / ``random_walk``,
``node_classification_f1``, ``load_mat_dataset``, ``StepTimer`` with the
``timer=`` of the trainers and the walk engine, and the exports.

A model file written by either package loads in the other with equal
tables, counts, mask, names and noise tables (the keys and dtypes are the
JAX package's).  Walks bit-match on the dense engine: dyadic weights and
p, q powers of two make every partial sum exact (ROADMAP North star).
F1 scores are equal (the same sklearn fit on the same inputs).  The timer
test runs each JAX trainer once, SGNS at a small size, and compares the
names and counts recorded."""

import os

import numpy as np
import pandas as pd
import pytest
import scipy.io as sio
import torch
from scipy import sparse

import jax  # noqa: F401  (the JAX package runs on the CPU: tests/conftest.py)

import node2vec_torch
import node2vec_tpu
from node2vec_torch import Node2Vec, Node2VecBase, Node2VecTorchEmbedding
from node2vec_torch import datasets, eval as port_eval, models, ops
from node2vec_torch.models.word2vec import Word2VecTorch
from node2vec_torch.utils import StepTimer, profiler_trace
from node2vec_torch.walk import WalkEngine
from node2vec_tpu import api as ref_api
from node2vec_tpu import datasets as ref_datasets
from node2vec_tpu import eval as ref_eval
from node2vec_tpu import models as ref_models
from node2vec_tpu import ops as ref_ops
from node2vec_tpu.constants import Node2VecParams as RefN2V, Word2VecParams as RefW2V
from node2vec_tpu.embedding import Node2VecTPUEmbedding
from node2vec_tpu.models.vocab import build_vocab_from_counts as ref_vocab_from_counts
from node2vec_tpu.models.word2vec import Word2VecTPU
from node2vec_tpu.utils import StepTimer as RefStepTimer
from node2vec_tpu.walk import WalkEngine as RefWalkEngine

W2V = {"vector_size": 32, "window_size": 5, "negative": 5, "min_count": 1, "max_iter": 1}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread each keeps parallel test workers
    from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _named_karate(karate_edges):
    src, dst = karate_edges
    return np.array([f"v{i}" for i in src]), np.array([f"v{i}" for i in dst])


def _trained_port(karate_edges) -> Node2Vec:
    n2v = Node2Vec(n2v_params={"num_walks": 2, "walk_length": 8}, w2v_params=W2V,
                   random_seed=0, device="cpu")
    n2v.preprocess_input_graph(_named_karate(karate_edges), indexed=False, directed=False)
    n2v.random_walk()
    n2v.fit()
    return n2v


# --------------------------------------------------------------------------- #
# model and vector files across packages
# --------------------------------------------------------------------------- #


def _assert_same_model(port_model, ref_model):
    np.testing.assert_array_equal(port_model.emb_in, np.asarray(ref_model.emb_in))
    np.testing.assert_array_equal(port_model.emb_out, np.asarray(ref_model.emb_out))
    for key in ("counts", "mask", "ns_alias", "ns_prob"):
        a, b = getattr(port_model.vocab, key), getattr(ref_model.vocab, key)
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b)


def test_port_model_file_loads_in_jax(karate_edges, tmp_path):
    n2v = _trained_port(karate_edges)
    n2v.save_model(str(tmp_path), "m")
    ref = ref_api.Node2Vec(w2v_params=W2V)
    ref_model = ref.load_model(str(tmp_path), "m")
    _assert_same_model(n2v.backend.model, ref_model)
    assert ref.backend.name_id == n2v.backend.name_id
    np.testing.assert_array_equal(ref.get_vector("v7"), n2v.get_vector("v7"))


def test_jax_model_file_loads_in_the_port(tmp_path):
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 6, 30)
    names = np.array([f"n{i}" for i in range(30)])
    ref = Node2VecTPUEmbedding(name_id=names, w2v_params={**W2V, "min_count": 2})
    ref.model.emb_in = rng.normal(size=(30, 32)).astype(np.float32)
    ref.model.emb_out = rng.normal(size=(30, 32)).astype(np.float32)
    ref.model.vocab = ref_vocab_from_counts(counts, min_count=2)
    ref.save_model(str(tmp_path), "jax_model.npz")
    n2v = Node2Vec(w2v_params={**W2V, "min_count": 2}, device="cpu")
    model = n2v.load_model(str(tmp_path), "jax_model")
    _assert_same_model(model, ref.model)
    assert n2v.backend.name_id == ref.name_id
    kept = int(np.argmax(counts >= 2))
    np.testing.assert_array_equal(n2v.get_vector(f"n{kept}"), ref.model.emb_in[kept])
    names_p, vectors_p = n2v.embedding(as_frame=False)
    assert names_p == ref.embedding()["name"].tolist()
    # the port writes the same keys, dtypes and values back
    n2v.save_model(str(tmp_path), "port_model")
    with np.load(tmp_path / "jax_model.npz") as a, np.load(tmp_path / "port_model.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


def test_vectors_files_load_in_both_packages(karate_edges, tmp_path):
    n2v = _trained_port(karate_edges)
    n2v.save_vectors(str(tmp_path), "port.txt")
    ref_frame = ref_api.Node2Vec().load_vectors(str(tmp_path), "port.txt")
    port_frame = Node2Vec(device="cpu").load_vectors(str(tmp_path), "port.txt")
    assert port_frame["name"].tolist() == ref_frame["name"].tolist()
    np.testing.assert_array_equal(np.stack(port_frame["vector"]), np.stack(ref_frame["vector"]))
    names, vectors = n2v.embedding(as_frame=False)
    assert port_frame["name"].tolist() == [str(x) for x in names]
    np.testing.assert_allclose(np.stack(port_frame["vector"]), vectors, rtol=1e-5, atol=1e-7)
    # and the JAX package's file in the port
    ref = Node2VecTPUEmbedding(w2v_params=W2V)
    ref.model.emb_in = vectors[:5]
    ref.model.vocab = ref_vocab_from_counts(np.ones(5, np.int64))
    ref.save_vectors(str(tmp_path), "jax.txt")
    got = Node2Vec(device="cpu").load_vectors(str(tmp_path), "jax.txt")
    want = ref.load_vectors(str(tmp_path), "jax.txt")
    assert got["name"].tolist() == want["name"].tolist()
    np.testing.assert_array_equal(np.stack(got["vector"]), np.stack(want["vector"]))


def test_node2vec_base_contract():
    base = Node2VecBase()
    for name, args in (("fit", ()), ("embedding", ()), ("get_vector", ("a",)),
                       ("save_model", ("d", "m")), ("load_model", ("d", "m"))):
        with pytest.raises(NotImplementedError):
            getattr(base, name)(*args)
    assert issubclass(Node2VecTorchEmbedding, Node2VecBase)
    assert Node2VecTorchEmbedding.MODEL_SUFFIX == Node2VecTPUEmbedding.MODEL_SUFFIX
    ref_methods = {m for m in vars(node2vec_tpu.Node2VecBase) if not m.startswith("_")}
    assert ref_methods == {m for m in vars(Node2VecBase) if not m.startswith("_")}
    with pytest.raises(RuntimeError):  # nothing fitted, nothing to save
        Node2VecTorchEmbedding(device="cpu").save_model("unused", "m")


# --------------------------------------------------------------------------- #
# the functional API
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("indexed,directed", [(False, False), (True, True)])
def test_trim_index_equals_jax(indexed, directed):
    rng = np.random.default_rng(2)
    src = rng.integers(0, 40, 400)
    dst = rng.integers(0, 40, 400)
    src[:60] = 7  # a hotspot that max_out_deg trims
    df = pd.DataFrame({"src": src if indexed else [f"x{i}" for i in src],
                       "dst": dst if indexed else [f"x{i}" for i in dst],
                       "weight": rng.choice([0.5, 1.0, 2.0], 400).astype(np.float32)})
    got = node2vec_torch.trim_index(df, indexed=indexed, directed=directed, max_out_deg=20,
                                    random_seed=3)
    want = ref_api.trim_index(df, indexed=indexed, directed=directed, max_out_deg=20,
                              random_seed=3)
    pd.testing.assert_frame_equal(got[0], want[0])
    if indexed:
        assert got[1] is None and want[1] is None
    else:
        pd.testing.assert_frame_equal(got[1], want[1])


def test_random_walk_equals_jax(karate_edges):
    """Dyadic weights, p = 0.5, q = 2: bit-equal walks on the dense engine."""
    src, dst = karate_edges
    rng = np.random.default_rng(4)
    df = pd.DataFrame({"src": src, "dst": dst,
                       "weight": rng.choice([0.5, 1.0, 2.0], len(src)).astype(np.float32)})
    edges, _ = node2vec_torch.trim_index(df, indexed=True, directed=False)
    params = {"num_walks": 2, "walk_length": 6, "return_param": 0.5, "inout_param": 2.0}
    got = node2vec_torch.random_walk(edges, params, random_seed=5, device="cpu")
    want = node2vec_tpu.random_walk(edges, params, random_seed=5)
    assert got["src"].tolist() == want["src"].tolist()
    assert got["walk"].tolist() == want["walk"].tolist()
    starts = np.array([0, 3, 9], dtype=np.int32)
    got_s = node2vec_torch.random_walk(edges, params, walk_seed=starts, random_seed=5,
                                       device="cpu")
    assert got_s["walk"].tolist() == node2vec_tpu.random_walk(
        edges, params, walk_seed=starts, random_seed=5)["walk"].tolist()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            node2vec_torch.random_walk(edges, params)


# --------------------------------------------------------------------------- #
# eval and datasets
# --------------------------------------------------------------------------- #


def test_node_classification_f1_equals_jax():
    rng = np.random.default_rng(6)
    labels = rng.integers(0, 3, 120)
    emb = (rng.normal(size=(120, 8)) + labels[:, None]).astype(np.float32)
    got = port_eval.node_classification_f1(emb, labels, train_ratio=0.5, seed=1)
    assert got == ref_eval.node_classification_f1(emb, labels, train_ratio=0.5, seed=1)
    assert set(got) == {"micro_f1", "macro_f1"} and got["micro_f1"] > 0.5


def test_load_mat_dataset_equals_jax(tmp_path):
    rng = np.random.default_rng(7)
    n = 30
    a = sparse.random(n, n, density=0.15, random_state=7, format="csr")
    adj = ((a + a.T) > 0).astype(np.float64)
    group = sparse.csr_matrix((rng.random((n, 4)) < 0.3).astype(np.float64))
    path = str(tmp_path / "toy.mat")
    sio.savemat(path, {"network": adj, "group": group})
    g, labels = datasets.load_mat_dataset(path)
    rg, rlabels = ref_datasets.load_mat_dataset(path)
    for k in ("indptr", "indices", "weights", "alias", "prob"):
        np.testing.assert_array_equal(getattr(g, k), getattr(rg, k))
    np.testing.assert_array_equal(labels, rlabels)
    assert labels.dtype == bool and labels.shape == (n, 4) and g.n_vertices == n
    sio.savemat(str(tmp_path / "bad.mat"), {"network": adj})
    with pytest.raises(ValueError, match="DeepWalk-format"):
        datasets.load_mat_dataset(str(tmp_path / "bad.mat"))


# --------------------------------------------------------------------------- #
# StepTimer and timer=
# --------------------------------------------------------------------------- #


def test_step_timer_api(tmp_path):
    t = StepTimer()
    for dt in (0.02, 0.001, 0.001):
        with t.measure("step"):
            pass
        t.times["step"][-1] = dt  # fixed durations for exact arithmetic
    assert t.count("step") == 3 and t.count("none") == 0
    assert t.total("step") == pytest.approx(0.022) and t.mean("none") == 0.0
    assert t.throughput("step", 10) == pytest.approx(10 * 2 / 0.002)  # first call left out
    assert t.throughput("none", 10) == 0.0
    assert t.summary() == {"step": {"count": 3, "total_s": pytest.approx(0.022),
                                    "mean_s": pytest.approx(0.022 / 3)}}
    ref = RefStepTimer()
    ref.times = {k: list(v) for k, v in t.times.items()}
    assert ref.summary() == t.summary() and ref.throughput("step", 10) == t.throughput("step", 10)
    with profiler_trace(None):
        pass
    with profiler_trace(str(tmp_path / "trace")):
        torch.ones(3).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def _counts(timer) -> dict:
    return {k: len(v) for k, v in timer.times.items()}


def test_timers_record_what_the_jax_package_records(karate_edges):
    src, dst = karate_edges
    g_port = node2vec_torch.build_graph((src, dst), directed=False)
    g_ref = node2vec_tpu.build_graph((src, dst), directed=False)
    n2v = {"num_walks": 4, "walk_length": 6, "walker_chunk": 64}  # 3 chunks (JAX's rule)
    t_port, t_ref = StepTimer(), StepTimer()
    walks = WalkEngine(g_port, node2vec_torch.Node2VecParams(**n2v), device="cpu").run(
        timer=t_port)
    RefWalkEngine(g_ref, RefN2V(**n2v)).run(timer=t_ref)
    w2v = {**W2V, "max_iter": 2, "batch_walks": 32}
    port = Word2VecTorch(node2vec_torch.Word2VecParams(**w2v), device="cpu")
    ref = Word2VecTPU(RefW2V(**w2v))
    port.fit(walks, n_vertices=34, timer=t_port)
    ref.fit(walks, n_vertices=34, timer=t_ref)
    port.fit_host(walks, n_vertices=34, slab_walks=64, timer=t_port)
    ref.fit_host(walks, n_vertices=34, slab_walks=64, timer=t_ref)
    chunks = np.array_split(walks, 2)
    port.fit_streaming(lambda i: torch.from_numpy(chunks[i]), 2, 34, timer=t_port)
    ref.fit_streaming(lambda i: jax.numpy.asarray(chunks[i]), 2, 34, timer=t_ref)
    assert _counts(t_port) == _counts(t_ref) == {
        "walk_chunk": 3, "sgns_epoch": 2, "host_epoch": 2, "stream_chunk": 4}
    assert all(x >= 0 for v in t_port.times.values() for x in v)


@pytest.mark.parametrize("extra,name", [({"negative": 0}, "hs_epoch"),
                                        ({"sg": 0}, "cbow_epoch"),
                                        ({"sg": 0, "negative": 0}, "cbow_epoch")])
def test_fit_timer_names_each_objective(extra, name):
    """word2vec.py:878 and :1000: HS records hs_epoch, CBOW (NS and HS)
    cbow_epoch."""
    walks = np.random.default_rng(8).integers(0, 20, (40, 7)).astype(np.int32)
    timer = StepTimer()
    Word2VecTorch(node2vec_torch.Word2VecParams(**{**W2V, **extra}), device="cpu").fit(
        walks, n_vertices=20, timer=timer)
    assert _counts(timer) == {name: 1}


# --------------------------------------------------------------------------- #
# exports
# --------------------------------------------------------------------------- #

RENAMED = {"Node2VecTPUEmbedding": "Node2VecTorchEmbedding", "Word2VecTPU": "Word2VecTorch"}


@pytest.mark.parametrize("port,ref", [(node2vec_torch, node2vec_tpu), (models, ref_models),
                                      (ops, ref_ops)], ids=["top", "models", "ops"])
def test_exports_cover_the_jax_package(port, ref):
    want = {RENAMED.get(n, n) for n in ref.__all__}
    assert want <= set(port.__all__), sorted(want - set(port.__all__))
    for n in port.__all__:
        assert hasattr(port, n), n
    if port is node2vec_torch:
        assert node2vec_torch.__version__ == node2vec_tpu.__version__
        for k in ("MAX_OUT_DEGREES", "NODE2VEC_PARAMS", "WORD2VEC_PARAMS", "GENSIM_PARAMS"):
            assert getattr(node2vec_torch, k) == getattr(node2vec_tpu, k), k
        from node2vec_torch import constants
        from node2vec_tpu import constants as ref_constants

        for k in ("MAX_OUT_DEGREES_NATIVE", "NODE2VEC_PARAMS_NATIVE"):
            assert getattr(constants, k) == getattr(ref_constants, k), k
