"""node2vec_torch's SGNS step and epoch against node2vec_tpu's on the CPU.

Both sides start from the same tables (carried over by
from_reference_state) and the same random draws (made with jax.random from
the JAX step's own key splits).  Tolerance rtol 1e-5, atol 1e-6: the sums
and scatters run in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from node2vec_tpu.models import skipgram as ref_sg
from node2vec_tpu.models.vocab import build_vocab as ref_build_vocab
from node2vec_tpu.ops.alias import build_alias_csr
from node2vec_torch.constants import Word2VecParams
from node2vec_torch.convert import from_reference_state, to_reference_state
from node2vec_torch.models import skipgram as sg
from node2vec_torch.models.vocab import build_vocab
from node2vec_torch.models.word2vec import Word2VecTorch

RTOL, ATOL = 1e-5, 1e-6
V, B, L1, W, S, K = 40, 32, 11, 5, 64, 5


def _state(dim, seed=0):
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, V, (B, L1)).astype(np.int32)
    ends = rng.integers(3, L1 + 1, B)
    walks[np.arange(L1)[None, :] >= ends[:, None]] = -1
    mask = rng.random(V) > 0.1
    tables = (
        rng.normal(0, 0.3, (V, dim)).astype(np.float32),
        rng.normal(0, 0.3, (V, dim)).astype(np.float32),
        rng.random(V).astype(np.float32),
        rng.random(V).astype(np.float32),
    )
    alias, prob = build_alias_csr(np.array([0, V]), rng.random(V).astype(np.float32) + 0.1)
    return walks, mask, tables, alias, prob


def _draws(key, n_walks, shrink):
    """The JAX step's own draws (skipgram.py:342,351,380-381)."""
    k_neg1, k_neg2, k_shrink = jax.random.split(key, 3)
    if shrink:
        b_sh = jax.random.randint(k_shrink, (n_walks, L1), 1, W + 1)
    else:
        b_sh = jnp.full((n_walks, L1), W, dtype=jnp.int32)
    r1 = jax.random.uniform(k_neg1, (S,))
    r2 = jax.random.uniform(k_neg2, (S,))
    return tuple(torch.from_numpy(np.array(x)) for x in (b_sh.astype(jnp.int32), r1, r2))


def _assert_close(got, want):
    for name, a, b in zip(("emb_in", "emb_out", "acc_in", "acc_out", "loss"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=name)


def test_build_vocab_equal():
    walks = np.random.default_rng(0).integers(-1, 50, (200, 9)).astype(np.int32)
    want = ref_build_vocab(walks, 60, min_count=3)
    for arg in (walks, torch.from_numpy(walks)):
        got = build_vocab(arg, 60, min_count=3)
        for f in ("counts", "mask", "ns_alias", "ns_prob"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("dim", [32, 128])
@pytest.mark.parametrize("shrink", [True, False])
def test_sgns_walk_step_matches_jax(dim, shrink):
    walks, mask, tables, alias, prob = _state(dim)
    key = jax.random.PRNGKey(dim + shrink)
    lr = np.float32(0.1)
    want = ref_sg.sgns_walk_step_impl(
        *(jnp.asarray(t) for t in tables), jnp.asarray(walks), key, jnp.float32(lr),
        jnp.asarray(alias), jnp.asarray(prob), jnp.asarray(mask),
        window=W, negatives=K, shared_negatives=S, shrink_window=shrink,
    )
    b_sh, r1, r2 = _draws(key, B, shrink)
    neg = sg.negative_ids(r1, r2, torch.from_numpy(alias), torch.from_numpy(prob))
    assert len(torch.unique(neg)) < S  # S > V: repeated negatives accumulate
    state = from_reference_state(*tables, device="cpu")
    loss = sg.sgns_walk_step(
        *state, torch.from_numpy(walks), b_sh, r1, r2, float(lr),
        torch.from_numpy(alias), torch.from_numpy(prob), torch.from_numpy(mask),
        window=W, negatives=K,
    )
    _assert_close((*to_reference_state(*state), loss.numpy()), want)


def test_sgns_epoch_matches_jax():
    """3 batches with the linear lr decay; draws per fold_in(key, gstep)."""
    dim, n_batches = 32, 3
    walks, mask, tables, alias, prob = _state(dim, seed=1)
    corpus = np.concatenate([walks] * n_batches)
    key = jax.random.PRNGKey(9)
    step0, lr0, slope, min_lr = 4, 0.2, 0.01, 0.145  # the floor binds at the last step
    want = ref_sg.sgns_epoch(
        *(jnp.asarray(t) for t in tables), jnp.asarray(corpus), key, jnp.int32(step0),
        jnp.float32(lr0), jnp.float32(slope), jnp.asarray(alias), jnp.asarray(prob),
        jnp.asarray(mask), batch=B, n_batches=n_batches, window=W, negatives=K,
        shared_negatives=S, shrink_window=True, min_lr=min_lr,
    )
    state = from_reference_state(*tables, device="cpu")
    losses = sg.sgns_epoch(
        *state, torch.from_numpy(corpus),
        lambda gstep: _draws(jax.random.fold_in(key, gstep), B, True),
        step0, lr0, slope, torch.from_numpy(alias), torch.from_numpy(prob),
        torch.from_numpy(mask), batch=B, n_batches=n_batches, window=W, negatives=K,
        min_lr=min_lr,
    )
    assert sg.step_lr(lr0, slope, step0 + 2, min_lr) == np.float32(min_lr)
    _assert_close((*to_reference_state(*state), losses.numpy()), want)


def test_convert_round_trip():
    _, _, tables, _, _ = _state(32)
    state = from_reference_state(*tables, device="cpu")
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in state)
    for a, b in zip(to_reference_state(*state), tables):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        from_reference_state(tables[0], tables[1][:5], tables[2], tables[3], device="cpu")


def test_fit_runs_and_is_deterministic(karate_edges):
    from node2vec_torch.graph import from_edge_arrays
    from node2vec_torch.walk import random_walks
    from node2vec_torch.constants import Node2VecParams

    g = from_edge_arrays(*karate_edges, directed=False)
    walks = random_walks(g, Node2VecParams(num_walks=4, walk_length=10), seed=0, device="cpu")
    params = Word2VecParams(min_count=1, max_iter=3, vector_size=32)
    m1 = Word2VecTorch(params, device="cpu").fit(walks, n_vertices=g.n_vertices)
    m2 = Word2VecTorch(params, device="cpu").fit(walks, n_vertices=g.n_vertices)
    np.testing.assert_array_equal(m1.vectors, m2.vectors)
    assert m1.vectors.shape == (34, 32) and np.isfinite(m1.vectors).all()
    assert m1.losses[-1] < m1.losses[0]


@pytest.mark.parametrize("override", [{"optimizer": "sgd"}])
def test_unported_trainer_options_raise(override, karate_edges):
    """SGNS with optimizer="sgd" trains through the three trainers (finite
    tables, a falling loss, accumulators untouched; tests/test_skipgram.py:69
    on the port); fit_sharded's row layout, ported since, trains too (with
    row-wise Adagrad whatever ``optimizer`` says, as the JAX row trainer)."""
    from node2vec_torch.constants import Node2VecParams
    from node2vec_torch.graph import from_edge_arrays
    from node2vec_torch.walk import random_walks

    g = from_edge_arrays(*karate_edges, directed=False)
    walks = random_walks(g, Node2VecParams(num_walks=10, walk_length=10), seed=0, device="cpu")
    params = Word2VecParams(min_count=1, max_iter=5, vector_size=32, batch_walks=128, seed=3,
                            step_size=0.025, **override)
    for fit in (lambda m: m.fit(walks), lambda m: m.fit_host(walks),
                lambda m: m.fit_streaming(lambda i: torch.from_numpy(walks), 1, 34)):
        model = fit(Word2VecTorch(params, device="cpu"))
        assert np.isfinite(model.vectors).all() and model.losses[-1] < model.losses[0]
        assert not model.acc_in.any() and not model.acc_out.any()
    from node2vec_torch.parallel import make_mesh

    row = Word2VecTorch(params, device="cpu").fit_sharded(walks, make_mesh(device="cpu"),
                                                          table_sharding="row")
    assert np.isfinite(row.vectors).all() and row.losses[-1] < row.losses[0]
    assert row.acc_in.any()  # Adagrad's accumulators


def test_sample_fits(karate_edges):
    """sample > 0 trains (frequent-vertex subsampling through K7's plain
    version here) and drops occurrences: its loss differs from sample 0."""
    from node2vec_torch.graph import from_edge_arrays
    from node2vec_torch.walk import random_walks
    from node2vec_torch.constants import Node2VecParams

    g = from_edge_arrays(*karate_edges, directed=False)
    walks = random_walks(g, Node2VecParams(num_walks=4, walk_length=10), seed=0, device="cpu")
    kw = dict(min_count=1, max_iter=3, vector_size=32)
    m = Word2VecTorch(Word2VecParams(sample=1e-2, **kw), device="cpu").fit(walks, n_vertices=34)
    plain = Word2VecTorch(Word2VecParams(**kw), device="cpu").fit(walks, n_vertices=34)
    assert np.isfinite(m.vectors).all() and m.losses[-1] < m.losses[0]
    assert m.losses != plain.losses


def test_effective_batch_equal():
    from node2vec_tpu.models.word2vec import _effective_batch as ref_effective_batch
    from node2vec_torch.models.word2vec import _effective_batch

    for batch_walks, n_walks in [(8192, 1_310_720), (8192, 16_000), (8192, 5 * 10**6),
                                 (100, 50), (8192, 0)]:
        assert _effective_batch(batch_walks, n_walks) == ref_effective_batch(batch_walks, n_walks)


def test_cpu_tensors_launch_no_kernel(karate_edges):
    """On CPU tensors every wrapper runs its plain version: no launch counted."""
    from node2vec_torch import Node2Vec, _build

    _build.reset_launches()
    n2v = Node2Vec(n2v_params={"num_walks": 2, "walk_length": 6},
                   w2v_params={"min_count": 1, "max_iter": 1, "vector_size": 32}, device="cpu")
    n2v.preprocess_input_graph(karate_edges, directed=False)
    n2v.run_pipeline()
    assert sum(_build.launches.values()) == 0


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from node2vec_torch import _build

    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
