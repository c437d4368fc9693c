"""node2vec_torch's pre-aggregated SGNS step (``optimizer="sgd"``, and
``preagg=True`` with Adagrad) against node2vec_tpu's on the CPU, and the
cached, assignable tables of ``Word2VecTorch``.

Both steps start from the same tables and take JAX's own draws
(``fold_in(PRNGKey(seed), gstep)`` split three ways, skipgram.py:342):
tables, accumulators and loss at the SGNS step's rtol 1e-5, atol 1e-6
(sums and scatters run in another order).  The batches hold dead lanes,
out-of-vocabulary positions (counted by SGD, with zero gradients) and
repeated negatives (S > V).  K11's plain version is held to a numpy
segment sum; the three trainers, handed JAX's draws, to
``Word2VecTPU(Word2VecParams(optimizer="sgd", step_size=0.025))``; a killed
and resumed SGD run is bit-equal to an uninterrupted one, and resumes from
a JAX SGD train state.  Dim 32: the JAX package packs dim-64 tables."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from node2vec_tpu.constants import Word2VecParams as RefW2V
from node2vec_tpu.models import skipgram as ref_sg
from node2vec_tpu.models import word2vec as ref_w2v
from node2vec_tpu.ops.alias import build_alias_csr
from node2vec_torch import Node2Vec, _build
from node2vec_torch.constants import Word2VecParams
from node2vec_torch.convert import from_reference_state, to_reference_state
from node2vec_torch.models import skipgram as sg
from node2vec_torch.models import word2vec as w2v
from node2vec_torch.models.word2vec import Word2VecTorch

RTOL, ATOL = 1e-5, 1e-6
V, D, B, L1, W, S, K = 40, 32, 24, 11, 5, 64, 5
SGD_W2V = dict(min_count=1, vector_size=32, window_size=5, batch_walks=32, max_iter=2,
               optimizer="sgd", step_size=0.025)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread each keeps parallel test workers
    from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


class JaxDraws(w2v.Draws):
    """The JAX trainers' own draws, keyed as they key them."""

    def __init__(self, params, shared_negatives, device):
        super().__init__(params, shared_negatives, device)
        self.key = jax.random.PRNGKey(params.seed)

    def init(self, n_vertices, dim):
        return tuple(_t(a) for a in ref_sg.init_embeddings(n_vertices, dim, seed=self.params.seed))

    def permutation(self, tag, n):
        return _t(jax.random.permutation(jax.random.fold_in(self.key, tag), n)).long()

    def step(self, gstep, n_walks, length):
        return _draws(jax.random.fold_in(self.key, gstep), n_walks, length,
                      self.params.window_size, self.shared_negatives)


def _draws(key, n_walks, length, window, s):
    """(b_sh, r1, r2) as sgns_walk_step_impl draws them (:342, :351, :380)."""
    k_neg1, k_neg2, k_shrink = jax.random.split(key, 3)
    b_sh = jax.random.randint(k_shrink, (n_walks, length), 1, window + 1)
    return (_t(b_sh.astype(jnp.int32)), _t(jax.random.uniform(k_neg1, (s,))),
            _t(jax.random.uniform(k_neg2, (s,))))


def _with_jax_draws(model: Word2VecTorch) -> Word2VecTorch:
    model._new_draws = lambda: JaxDraws(model.params, model.shared_negatives, model.device)
    return model


def _corpus(n_walks=150, n_vertices=48, length=9, seed=0):
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, n_vertices, (n_walks, length)).astype(np.int32)
    ends = rng.integers(2, length + 1, n_walks)
    walks[np.arange(length)[None, :] >= ends[:, None]] = -1
    walks[:, 0] = np.arange(n_walks) % n_vertices
    return walks


# --------------------------------------------------------------------------- #
# the step
# --------------------------------------------------------------------------- #


def _batch(seed=0):
    """A batch with dead lanes (walks ending early, one all dead), vertices
    outside the vocabulary, tables, accumulators and the noise table."""
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, V, (B, L1)).astype(np.int32)
    ends = rng.integers(2, L1 + 1, B)
    walks[np.arange(L1)[None, :] >= ends[:, None]] = -1
    walks[3] = -1
    mask = rng.random(V) > 0.15
    tables = (rng.normal(0, 0.3, (V, D)).astype(np.float32),
              rng.normal(0, 0.3, (V, D)).astype(np.float32),
              rng.random(V).astype(np.float32), rng.random(V).astype(np.float32))
    alias, prob = build_alias_csr(np.array([0, V]), rng.random(V).astype(np.float32) + 0.1)
    return walks, mask, tables, alias, prob


@pytest.mark.parametrize("optimizer,preagg", [("sgd", False), ("sgd", True),
                                              ("adagrad", True)])
def test_preaggregated_step_matches_jax(optimizer, preagg):
    walks, mask, tables, alias, prob = _batch()
    assert (~mask[walks[walks >= 0]]).any()  # out-of-vocabulary positions
    key = jax.random.PRNGKey(7)
    lr = np.float32(0.1)
    want = ref_sg.sgns_walk_step(
        *(jnp.asarray(t) for t in tables), jnp.asarray(walks), key, jnp.float32(lr),
        jnp.asarray(alias), jnp.asarray(prob), jnp.asarray(mask), window=W, negatives=K,
        shared_negatives=S, shrink_window=True, preagg=preagg, optimizer=optimizer,
    )
    b_sh, r1, r2 = _draws(key, B, L1, W, S)
    noise = (torch.from_numpy(alias), torch.from_numpy(prob), torch.from_numpy(mask))
    assert len(torch.unique(sg.negative_ids(r1, r2, *noise[:2]))) < S  # repeated negatives
    for step in (sg.sgns_walk_step, sg.sgns_walk_step_plain):
        state = from_reference_state(*tables, device="cpu")
        loss = step(*state, torch.from_numpy(walks), b_sh, r1, r2, float(lr), *noise,
                    window=W, negatives=K, optimizer=optimizer, preagg=preagg)
        for name, a, b in zip(("emb_in", "emb_out", "acc_in", "acc_out", "loss"),
                              (*to_reference_state(*state), loss.numpy()), want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=name)
        if optimizer == "sgd":  # SGD changes no accumulator
            np.testing.assert_array_equal(state[2].numpy(), tables[2])
            np.testing.assert_array_equal(state[3].numpy(), tables[3])


def test_step_rejects_an_unknown_optimizer():
    walks, mask, tables, alias, prob = _batch()
    state = from_reference_state(*tables, device="cpu")
    b_sh, r1, r2 = _draws(jax.random.PRNGKey(0), B, L1, W, S)
    with pytest.raises(ValueError, match="unknown optimizer"):
        sg.sgns_walk_step(*state, torch.from_numpy(walks), b_sh, r1, r2, 0.1,
                          torch.from_numpy(alias), torch.from_numpy(prob),
                          torch.from_numpy(mask), window=W, negatives=K, optimizer="adam")
    assert sg.resolve_optimizer("sgd", False) and not sg.resolve_optimizer("adagrad", False)


def _segment_sums(rows, g_in, g_out):
    """numpy: {vertex: (sum g_in, sum g_out, count, first row)} over rows >= 0."""
    out = {}
    for r, v in enumerate(rows):
        if v < 0:
            continue
        a, b, c, first = out.get(v, (0.0, 0.0, 0, r))
        out[v] = (a + g_in[r].astype(np.float64), b + g_out[r].astype(np.float64), c + 1, first)
    return out


@pytest.mark.parametrize("case", ["mixed", "all_dead", "one_vertex", "oov_zero_grads"])
def test_preagg_rows_plain_equals_numpy_segment_sum(case):
    rng = np.random.default_rng({"mixed": 0, "all_dead": 1, "one_vertex": 2,
                                 "oov_zero_grads": 3}[case])
    n = 90
    rows = rng.integers(-1, 12, n).astype(np.int32)
    if case == "all_dead":
        rows[:] = -1
    elif case == "one_vertex":
        rows[:] = 5
    g_in = rng.normal(0, 1, (n, 8)).astype(np.float32)
    g_out = rng.normal(0, 1, (n, 8)).astype(np.float32)
    if case == "oov_zero_grads":  # counted, adding nothing
        g_in[rows == 3] = 0.0
        g_out[rows == 3] = 0.0
    ga_in, ga_out, heads, cnt = sg.preagg_rows(
        torch.from_numpy(rows), torch.from_numpy(g_in), torch.from_numpy(g_out))
    want = _segment_sums(rows, g_in, g_out)
    assert sorted(heads[heads >= 0].tolist()) == sorted(want)
    for v, (a, b, c, first) in want.items():
        assert heads[first] == v and cnt[first] == c
        np.testing.assert_allclose(ga_in[first].numpy(), a, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ga_out[first].numpy(), b, rtol=1e-5, atol=1e-5)
    dead = (heads < 0).numpy()
    assert (ga_in.numpy()[dead] == 0).all() and (cnt.numpy()[dead] == 0).all()
    assert int(cnt.sum()) == int((rows >= 0).sum())


# --------------------------------------------------------------------------- #
# the trainers
# --------------------------------------------------------------------------- #


def _fit(model, trainer, walks, chunks, **kw):
    if trainer == "fit":
        return model.fit(walks, n_vertices=48, **kw)
    if trainer == "fit_host":
        return model.fit_host(walks, n_vertices=48, slab_walks=64, **kw)
    source = (lambda i: jnp.asarray(chunks[i])) if isinstance(model, ref_w2v.Word2VecTPU) \
        else (lambda i: torch.from_numpy(chunks[i]))
    return model.fit_streaming(source, 3, 48, **kw)


@pytest.mark.parametrize("trainer", ["fit", "fit_host", "fit_streaming"])
def test_sgd_trainers_match_jax_given_its_draws(trainer):
    walks = _corpus(150, 48, 9, seed=1)
    chunks = np.stack([_corpus(100, 48, 9, seed=s) for s in range(3)])
    model = _with_jax_draws(Word2VecTorch(Word2VecParams(**SGD_W2V), device="cpu"))
    ref = ref_w2v.Word2VecTPU(RefW2V(**SGD_W2V))
    _fit(model, trainer, walks, chunks)
    _fit(ref, trainer, walks, chunks)
    for name in ("emb_in", "emb_out"):
        np.testing.assert_allclose(getattr(model, name), np.asarray(getattr(ref, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(model.losses, ref._losses, rtol=RTOL, atol=ATOL)
    assert not model.acc_in.any() and not model.acc_out.any()


def _kill_after(model, n_calls):
    real, count = model._train, [0]

    def train(*args):
        count[0] += 1
        if count[0] > n_calls:
            raise RuntimeError("simulated kill")
        return real(*args)

    model._train = train
    return model


@pytest.mark.parametrize("trainer", ["fit", "fit_host", "fit_streaming"])
def test_sgd_kill_and_resume_bit_equal(tmp_path, trainer):
    """A killed SGD run resumes bit-equal; its snapshots carry the
    accumulators, which SGD leaves at zero."""
    params = Word2VecParams(**dict(SGD_W2V, max_iter=3, sample=1e-3))
    walks = _corpus(150, 48, 9, seed=3)
    chunks = np.stack([_corpus(100, 48, 9, seed=s) for s in range(3)])
    extra = {"fit_streaming": dict(checkpoint_every_chunks=1, source_token="tok")}.get(trainer, {})
    full = _fit(Word2VecTorch(params, device="cpu"), trainer, walks, chunks)
    d = str(tmp_path / trainer)
    kill = {"fit": 2, "fit_host": 7, "fit_streaming": 4}[trainer]
    with pytest.raises(RuntimeError, match="simulated kill"):
        _fit(_kill_after(Word2VecTorch(params, device="cpu"), kill), trainer, walks, chunks,
             checkpoint_dir=d, **extra)
    snap = np.load(os.path.join(d, os.listdir(d)[0]))
    assert not snap["acc_in"].any() and not snap["acc_out"].any()
    resumed = _fit(Word2VecTorch(params, device="cpu"), trainer, walks, chunks,
                   checkpoint_dir=d, **extra)
    for name in ("_emb_in", "_emb_out", "acc_in", "acc_out"):
        np.testing.assert_array_equal(getattr(resumed, name).numpy(),
                                      getattr(full, name).numpy(), err_msg=name)
    first = {"fit": 2, "fit_host": 2, "fit_streaming": 0}[trainer]
    assert resumed.losses == full.losses[first:]


def test_jax_sgd_train_state_resumes_in_the_port(tmp_path, monkeypatch):
    """The JAX package trains an SGD epoch with checkpoint_dir and dies in
    the second; the port, handed JAX's draws, resumes from its file and
    ends where the uninterrupted JAX run ends."""
    walks = _corpus(150, 48, 9, seed=4)
    want = ref_w2v.Word2VecTPU(RefW2V(**SGD_W2V)).fit(walks, n_vertices=48)
    real, calls = ref_w2v.sgns_epoch, []

    def dying(*args, **kwargs):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("simulated kill")
        return real(*args, **kwargs)

    monkeypatch.setattr(ref_w2v, "sgns_epoch", dying)
    d = str(tmp_path)
    with pytest.raises(RuntimeError, match="simulated kill"):
        ref_w2v.Word2VecTPU(RefW2V(**SGD_W2V)).fit(walks, n_vertices=48, checkpoint_dir=d)
    got = _with_jax_draws(Word2VecTorch(Word2VecParams(**SGD_W2V), device="cpu")).fit(
        walks, n_vertices=48, checkpoint_dir=d)
    assert len(got.losses) == 1
    np.testing.assert_allclose(got.losses, want._losses[1:], rtol=RTOL, atol=ATOL)
    for name in ("emb_in", "emb_out"):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("mode", ["in_memory", "streaming", "host_corpus"])
def test_pipeline_trains_sgd_and_resumes(karate_edges, tmp_path, mode):
    """run_pipeline(optimizer="sgd") on every branch: finite tables, a
    falling loss, no kernel launch on the CPU, and a second run resumes
    from the checkpoints to the same tables."""
    kw = dict(n2v_params={"num_walks": 4, "walk_length": 8, "walker_chunk": 64},
              w2v_params={"vector_size": 32, "min_count": 1, "max_iter": 4,
                          "optimizer": "sgd", "step_size": 0.025},
              device="cpu", checkpoint_dir=str(tmp_path), host_corpus=mode == "host_corpus")
    streaming = None if mode != "in_memory" else False
    _build.reset_launches()
    n2v = Node2Vec(**kw)
    n2v.preprocess_input_graph(karate_edges, directed=False)
    model = n2v.run_pipeline(streaming=streaming)
    assert (n2v.walks is None) == (mode == "streaming")
    assert model.vectors.shape == (34, 32) and np.isfinite(model.vectors).all()
    assert model.losses[-1] < model.losses[0] and not model.acc_in.any()
    assert sum(_build.launches.values()) == 0
    again = Node2Vec(**kw)
    again.preprocess_input_graph(karate_edges, directed=False)
    np.testing.assert_array_equal(again.run_pipeline(streaming=streaming).vectors,
                                  model.vectors)


# --------------------------------------------------------------------------- #
# the tables: one cached host copy, setters (ROADMAP Queue C 1)
# --------------------------------------------------------------------------- #


def test_tables_are_cached_assignable_and_refreshed_by_training():
    walks = _corpus(150, 48, 9, seed=5)
    model = Word2VecTorch(Word2VecParams(**dict(SGD_W2V, max_iter=1)), device="cpu")
    with pytest.raises(RuntimeError, match="not fitted"):
        model.vectors
    model.fit(walks, n_vertices=48)
    first = model.vectors
    assert model.vectors is first and model.emb_in is first  # one host copy
    assert model.emb_out is model.emb_out
    np.testing.assert_array_equal(model.vector(7), first[7])
    x = np.random.default_rng(0).normal(size=(48, 32)).astype(np.float32)
    model.emb_in = x
    np.testing.assert_array_equal(model.vectors, x)
    np.testing.assert_array_equal(model.vector(3), x[3])
    assert model._emb_in.device == model.device and model._emb_in.dtype == torch.float32
    model.emb_out = torch.from_numpy(2 * x)
    np.testing.assert_array_equal(model.emb_out, 2 * x)
    model.fit(walks[::-1].copy(), n_vertices=48)  # a second fit writes new tables
    assert model.vectors is not first
    np.testing.assert_array_equal(model.vectors, model._emb_in.numpy())
    assert not np.array_equal(model.vectors, x)
    model.vocab.mask[5] = False
    with pytest.raises(KeyError):
        model.vector(5)
    with pytest.raises(IndexError):  # the JAX order: the index before the vocabulary
        model.vector(48)
