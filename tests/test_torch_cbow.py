"""node2vec_torch's CBOW (sg=0) against node2vec_tpu's on the CPU.

Both steps start from the same tables and take JAX's own draws
(``fold_in(PRNGKey(seed), gstep)``: split in three for negative sampling,
the key itself for hierarchical softmax).  The CBOW-NS step is fp32 on both
sides: tables, accumulators and loss at rtol 1e-5, atol 1e-6, as the SGNS
step is held (sums and scatters run in another order).  The JAX CBOW-HS
step rounds h, theta and the path gradients to bf16
(node2vec_tpu/models/cbow.py:287-301) where the port keeps fp32; on
bf16-representable tables its step is held as tests/test_torch_hsoftmax.py
holds the skip-gram HS step for the same gap, every table and accumulator
increment to 3e-2 of its largest magnitude, and the loss at rtol 1e-4:
h, a mean or sum of bf16 rows, is not itself bf16-representable, so the
JAX logits carry its rounding (1.0e-5 relative measured, where skip-gram
HS, scoring table rows directly, holds 1e-5).  The three
trainers, handed JAX's draws, match ``Word2VecTPU(sg=0)`` to the same
tolerances per objective (epoch losses at 2e-2 for HS); a killed and
resumed run is bit-equal to an uninterrupted one; JAX CBOW train states
load in the port; ``optimizer`` moves no objective but SGNS, as in the JAX
package.  Dims 16 and 32: the JAX package packs dim-64 tables."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from node2vec_tpu.constants import Word2VecParams as RefW2V
from node2vec_tpu.models import cbow as ref_cbow
from node2vec_tpu.models import skipgram as ref_sg
from node2vec_tpu.models import word2vec as ref_w2v
from node2vec_torch import Node2Vec, _build, convert
from node2vec_torch.constants import Word2VecParams
from node2vec_torch.models import cbow, vocab
from node2vec_torch.models import hsoftmax as hs
from node2vec_torch.models import skipgram as sg
from node2vec_torch.models import word2vec as w2v
from node2vec_torch.models.word2vec import Word2VecTorch
from node2vec_torch.utils.checkpoint import load_train_state

RTOL, ATOL = 1e-5, 1e-6  # CBOW-NS: fp32 on both sides
LOSS_RTOL = 1e-4  # CBOW-HS loss: the JAX step rounds h to bf16
INC_TOL = 3e-2  # of an increment's max |.|: the JAX CBOW-HS step rounds to bf16
EPOCH_LOSS_RTOL = 2e-2  # several steps of the bf16-rounded JAX gradients

V, D, B, L1, W, S, K = 60, 16, 12, 9, 3, 8, 5


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


def _bf16_exact(x) -> np.ndarray:
    """fp32 values with the low 16 bits cleared: bf16 casts are exact."""
    x = np.array(x, dtype=np.float32)
    x.view(np.uint32)[...] &= np.uint32(0xFFFF0000)
    return x


# --------------------------------------------------------------------------- #
# one step
# --------------------------------------------------------------------------- #


def _walks(rng) -> np.ndarray:
    """Dead lanes, a walk that ends early, a live position between dead
    ones and a walk of one live position (centers with no context)."""
    walks = rng.integers(0, V, (B, L1)).astype(np.int32)
    walks[rng.random((B, L1)) < 0.15] = -1
    walks[-1, 1:] = -1
    walks[-2, 4:] = -1
    walks[-3, :] = -1
    walks[-3, 5] = 7
    return walks


@pytest.fixture(scope="module")
def step_inputs():
    rng = np.random.default_rng(1)
    counts = rng.integers(0, 30, V)
    tree = hs.cap_code_length(hs.build_huffman(counts), counts)
    walks = _walks(rng)
    mask = counts >= 3  # out-of-vocabulary positions
    assert (~mask[walks[walks >= 0]]).any()
    ns = [rng.normal(0, 0.3, (V, D)).astype(np.float32),
          rng.normal(0, 0.3, (V, D)).astype(np.float32),
          rng.random(V).astype(np.float32), rng.random(V).astype(np.float32)]
    hs_state = [_bf16_exact(rng.normal(0, 0.3, (V, D))),
                _bf16_exact(rng.normal(0, 0.3, (tree.n_inner, D))),
                rng.random(V).astype(np.float32), rng.random(tree.n_inner).astype(np.float32)]
    alias = rng.integers(0, V, V).astype(np.int32)
    prob = rng.random(V).astype(np.float32)
    return dict(tree=tree, walks=walks, mask=mask, ns=ns, hs=hs_state, alias=alias, prob=prob)


def _ns_draws(key, n_walks, length, shrink=True):
    """The JAX step's own draws (cbow.py:146, :154, :168-169)."""
    k_neg1, k_neg2, k_shrink = jax.random.split(key, 3)
    b_sh = (jax.random.randint(k_shrink, (n_walks, length), 1, W + 1) if shrink
            else jnp.full((n_walks, length), W, jnp.int32))
    return (_t(b_sh.astype(jnp.int32)), _t(jax.random.uniform(k_neg1, (S,))),
            _t(jax.random.uniform(k_neg2, (S,))))


# one compile per static configuration instead of one per primitive
_ref_ns_step = jax.jit(ref_cbow.cbow_walk_step_impl, static_argnames=(
    "window", "negatives", "shared_negatives", "shrink_window", "cbow_mean", "packed"))
_ref_hs_step = jax.jit(ref_cbow.cbow_hs_step_impl,
                       static_argnames=("window", "shrink_window", "cbow_mean", "packed"))


def _port_ns_step(inp, b_sh, r1, r2, cbow_mean, step=cbow.cbow_walk_step):
    st = [_t(a) for a in inp["ns"]]
    loss = step(*st, _t(inp["walks"]), b_sh, r1, r2, 0.1, _t(inp["alias"]), _t(inp["prob"]),
                _t(inp["mask"]), window=W, negatives=K, cbow_mean=cbow_mean)
    return [a.numpy() for a in st], float(loss)


def _port_hs_step(inp, b_sh, cbow_mean, walks=None):
    tree = inp["tree"]
    st = [_t(a) for a in inp["hs"]]
    loss = cbow.cbow_hs_step(*st, _t(inp["walks"] if walks is None else walks), _t(b_sh), 0.1,
                             _t(tree.points), _t(tree.codes), _t(tree.lengths), _t(inp["mask"]),
                             window=W, cbow_mean=cbow_mean)
    return [a.numpy() for a in st], float(loss)


def _assert_increments_close(got, want, init, names) -> None:
    for name, g, w, i in zip(names, got, want, init):
        inc, ref_inc = np.asarray(g) - i, np.asarray(w) - i
        scale = float(np.abs(ref_inc).max())
        assert scale > 0, f"{name}: no update"
        err = float(np.abs(inc - ref_inc).max())
        assert err <= INC_TOL * scale, f"{name}: increment error {err} > {INC_TOL} * {scale}"


@pytest.mark.parametrize("cbow_mean", [True, False])
def test_ns_step_matches_jax(step_inputs, cbow_mean):
    inp = step_inputs
    key = jax.random.PRNGKey(5)
    want = _ref_ns_step(
        *(jnp.asarray(a) for a in inp["ns"]), jnp.asarray(inp["walks"]), key, 0.1,
        jnp.asarray(inp["alias"]), jnp.asarray(inp["prob"]), jnp.asarray(inp["mask"]),
        window=W, negatives=K, shared_negatives=S, shrink_window=True, cbow_mean=cbow_mean)
    got, loss = _port_ns_step(inp, *_ns_draws(key, B, L1), cbow_mean)
    for name, a, b in zip(("emb_in", "emb_out", "acc_in", "acc_out", "loss"), (*got, loss),
                          want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("cbow_mean", [True, False])
def test_hs_step_matches_jax(step_inputs, cbow_mean):
    inp = step_inputs
    tree = inp["tree"]
    key = jax.random.PRNGKey(6)
    want = _ref_hs_step(
        *(jnp.asarray(a) for a in inp["hs"]), jnp.asarray(inp["walks"]), key, 0.1,
        jnp.asarray(tree.points), jnp.asarray(tree.codes), jnp.asarray(tree.lengths),
        jnp.asarray(inp["mask"]), window=W, shrink_window=True, cbow_mean=cbow_mean)
    b_sh = np.array(jax.random.randint(key, (B, L1), 1, W + 1)).astype(np.int32)
    got, loss = _port_hs_step(inp, b_sh, cbow_mean)
    np.testing.assert_allclose(loss, float(want[4]), rtol=LOSS_RTOL)
    _assert_increments_close(got, want[:4], inp["hs"], ("emb_in", "theta", "acc_in", "acc_theta"))


def test_two_token_walks_equal_sgns(step_inputs):
    """On 2-token walks every center has one context, so h is that
    context's input row and the CBOW-NS loss is SGNS's under the same draws
    (tests/test_cbow.py:43)."""
    inp = dict(step_inputs)
    rng = np.random.default_rng(3)
    inp["walks"] = rng.integers(0, V, (16, 2)).astype(np.int32)
    inp["mask"] = np.ones(V, bool)
    b_sh, r1, r2 = _ns_draws(jax.random.PRNGKey(7), 16, 2, shrink=False)
    _, loss = _port_ns_step(inp, b_sh, r1, r2, True)
    st = [_t(a) for a in inp["ns"]]
    sgns = sg.sgns_walk_step(*st, _t(inp["walks"]), b_sh, r1, r2, 0.1, _t(inp["alias"]),
                             _t(inp["prob"]), _t(inp["mask"]), window=W, negatives=K)
    np.testing.assert_allclose(loss, float(sgns), rtol=1e-6)


@pytest.mark.parametrize("objective", ["ns", "hs"])
def test_untouched_rows_and_dead_walks(objective):
    """-1 padding and context-less centers contribute nothing: the loss is
    finite and the rows of vertices that never appear keep their values
    (tests/test_cbow.py:110); an all-dead batch changes nothing."""
    walks = np.array([[0, 1, 2, -1, -1, -1], [-1] * 6], np.int32)
    n_v, dim = 10, 32
    counts = np.bincount(walks[walks >= 0], minlength=n_v)
    mask = torch.ones(n_v, dtype=torch.bool)
    tree = hs.build_huffman(counts)
    for batch in (walks, np.full_like(walks, -1)):
        rng = np.random.default_rng(0)
        if objective == "ns":
            st = [_t(rng.normal(0, 0.3, (n_v, dim)).astype(np.float32)) for _ in range(2)]
            st += [torch.zeros(n_v), torch.zeros(n_v)]
            before = [a.clone() for a in st]
            loss = cbow.cbow_walk_step(
                *st, _t(batch), torch.full(batch.shape, 5, dtype=torch.int32),
                torch.rand(4), torch.rand(4), 0.025, torch.arange(n_v, dtype=torch.int32),
                torch.ones(n_v), mask, window=5, negatives=5, cbow_mean=True)
        else:
            st = [_t(rng.normal(0, 0.3, (n_v, dim)).astype(np.float32)),
                  _t(rng.normal(0, 0.3, (tree.n_inner, dim)).astype(np.float32)),
                  torch.zeros(n_v), torch.zeros(tree.n_inner)]
            before = [a.clone() for a in st]
            loss = cbow.cbow_hs_step(
                *st, _t(batch), torch.full(batch.shape, 5, dtype=torch.int32), 0.025,
                _t(tree.points), _t(tree.codes), _t(tree.lengths), mask, window=5,
                cbow_mean=True)
        assert np.isfinite(float(loss))
        torch.testing.assert_close(st[0][3:], before[0][3:], rtol=0, atol=0)
        if (batch < 0).all():
            assert float(loss) == 0.0
            for a, b in zip(st, before):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert not torch.equal(st[0][:3], before[0][:3])


def test_cpu_grads_launch_no_kernel_and_shapes(step_inputs):
    inp = step_inputs
    tree = inp["tree"]
    _build.reset_launches()
    b_sh = _t(np.full((B, L1), W, np.int32))
    neg = torch.arange(S, dtype=torch.int32)
    g_in, d_out, d_no, _ = cbow.cbow_grads(
        *(_t(a) for a in inp["ns"][:2]), _t(inp["walks"]), _t(inp["mask"]), b_sh, neg,
        window=W, negatives=K, cbow_mean=True)
    assert g_in.shape == d_out.shape == (B * L1, D) and d_no.shape == (S, D)
    g_in, g_theta, rows, _ = cbow.cbow_hs_grads(
        *(_t(a) for a in inp["hs"][:2]), _t(inp["walks"]), _t(inp["mask"]), b_sh,
        _t(tree.points), _t(tree.codes), _t(tree.lengths), window=W, cbow_mean=True)
    cl = tree.points.shape[1]
    assert g_in.shape == (B * L1, D) and g_theta.shape == (B * L1 * cl, D)
    rows = rows.numpy().reshape(B, L1, cl)
    assert (rows[inp["walks"] < 0] == -1).all()
    assert (rows[-1, 0] == -1).all()  # a center with no context trains no path entry
    dead = g_theta.numpy().reshape(B, L1, cl, D)[rows < 0]
    assert (dead == 0).all()
    assert sum(_build.launches.values()) == 0


# --------------------------------------------------------------------------- #
# the trainers against JAX's, given JAX's draws
# --------------------------------------------------------------------------- #


class JaxDraws(w2v.Draws):
    """The JAX trainers' draws, keyed as they key them: fold_in(PRNGKey(seed),
    tag) for shuffles and subsampling; fold_in(key, gstep) split in three
    for a CBOW-NS step (cbow.py:146), itself for a CBOW-HS step (:262)."""

    def __init__(self, params, shared_negatives, device):
        super().__init__(params, shared_negatives, device)
        self.key = jax.random.PRNGKey(params.seed)

    def init(self, n_vertices, dim):
        return tuple(_t(a) for a in ref_sg.init_embeddings(n_vertices, dim, seed=self.params.seed))

    def permutation(self, tag, n):
        return _t(jax.random.permutation(jax.random.fold_in(self.key, tag), n)).long()

    def step(self, gstep, n_walks, length):
        k_neg1, k_neg2, k_shrink = jax.random.split(jax.random.fold_in(self.key, gstep), 3)
        p, s = self.params, self.shared_negatives
        b_sh = jax.random.randint(k_shrink, (n_walks, length), 1, p.window_size + 1)
        return (_t(b_sh.astype(jnp.int32)), _t(jax.random.uniform(k_neg1, (s,))),
                _t(jax.random.uniform(k_neg2, (s,))))

    def window_shrink(self, gstep, n_walks, length):
        key = jax.random.fold_in(self.key, gstep)
        return _t(jax.random.randint(key, (n_walks, length), 1, self.params.window_size + 1)
                  .astype(jnp.int32))

    def subsample(self, walks, keep_prob, tag):
        u = _t(jax.random.uniform(jax.random.fold_in(self.key, tag), tuple(walks.shape)))
        return vocab.subsample_walks_plain(walks, keep_prob, self.params.seed, tag, u=u)


def _corpus(n_walks=150, n_vertices=48, length=9, seed=0):
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, n_vertices, (n_walks, length)).astype(np.int32)
    ends = rng.integers(2, length + 1, n_walks)
    walks[np.arange(length)[None, :] >= ends[:, None]] = -1
    walks[:, 0] = np.arange(n_walks) % n_vertices
    return walks


CBOW_W2V = dict(sg=0, min_count=1, vector_size=32, window_size=5, batch_walks=32, max_iter=2,
                sample=1e-3)
OBJECTIVES = {"ns": {}, "hs": {"negative": 0}}


def _fit(model, trainer, walks, chunks, **kw):
    if trainer == "fit":
        return model.fit(walks, n_vertices=48, **kw)
    if trainer == "fit_host":
        return model.fit_host(walks, n_vertices=48, slab_walks=64, **kw)
    source = (lambda i: jnp.asarray(chunks[i])) if isinstance(model, ref_w2v.Word2VecTPU) \
        else (lambda i: torch.from_numpy(chunks[i]))
    return model.fit_streaming(source, 3, 48, **kw)


@pytest.mark.parametrize("trainer", ["fit", "fit_host", "fit_streaming"])
@pytest.mark.parametrize("objective", ["ns", "hs"])
def test_trainers_match_jax_given_its_draws(objective, trainer):
    walks = _corpus(150, 48, 9, seed=1)
    chunks = np.stack([_corpus(100, 48, 9, seed=s) for s in range(3)])
    kw = dict(CBOW_W2V, **OBJECTIVES[objective])
    model = Word2VecTorch(Word2VecParams(**kw), device="cpu")
    model._new_draws = lambda: JaxDraws(model.params, model.shared_negatives, model.device)
    ref = ref_w2v.Word2VecTPU(RefW2V(**kw))
    _fit(model, trainer, walks, chunks)
    _fit(ref, trainer, walks, chunks)
    if objective == "ns":
        for name in ("emb_in", "emb_out"):
            np.testing.assert_allclose(getattr(model, name), np.asarray(getattr(ref, name)),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(model.losses, ref._losses, rtol=RTOL, atol=ATOL)
        return
    assert model.tree.n_inner == 47 and model.emb_out.shape == np.asarray(ref.emb_out).shape
    np.testing.assert_allclose(model.losses, ref._losses, rtol=EPOCH_LOSS_RTOL)
    init = JaxDraws(model.params, 0, "cpu").init(48, 32)[0].numpy()
    _assert_increments_close((model.emb_in, model.emb_out),
                             (np.asarray(ref.emb_in), np.asarray(ref.emb_out)),
                             (init, np.zeros_like(model.emb_out)), ("emb_in", "theta"))


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
@pytest.mark.parametrize("objective", ["ns", "hs"])
def test_kill_and_resume_bit_equal(tmp_path, objective, trainer):
    params = Word2VecParams(**dict(CBOW_W2V, max_iter=3, **OBJECTIVES[objective]))
    walks = _corpus(150, 48, 9, seed=3)
    chunks = np.stack([_corpus(100, 48, 9, seed=s) for s in range(3)])
    extra = {"fit_streaming": dict(checkpoint_every_chunks=1, source_token="tok")}.get(trainer, {})
    full = _fit(Word2VecTorch(params, device="cpu"), trainer, walks, chunks)
    d = str(tmp_path / trainer)
    kill = {"fit": 2, "fit_host": 7, "fit_streaming": 4}[trainer]
    with pytest.raises(RuntimeError, match="simulated kill"):
        _fit(_kill_after(Word2VecTorch(params, device="cpu"), kill), trainer, walks, chunks,
             checkpoint_dir=d, **extra)
    resumed = _fit(Word2VecTorch(params, device="cpu"), trainer, walks, chunks,
                   checkpoint_dir=d, **extra)
    for name in ("_emb_in", "_emb_out", "acc_in", "acc_out"):
        np.testing.assert_array_equal(getattr(resumed, name).numpy(),
                                      getattr(full, name).numpy(), err_msg=name)
    assert resumed._emb_out.shape[0] == (47 if objective == "hs" else 48)
    first = {"fit": 2, "fit_host": 2, "fit_streaming": 0}[trainer]
    assert resumed.losses == full.losses[first:]


@pytest.mark.parametrize("objective", ["ns", "hs"])
def test_jax_cbow_train_state_resumes_in_the_port(tmp_path, objective):
    """The JAX package trains an epoch of CBOW with checkpoint_dir; the port
    resumes from its file at epoch 1 (theta of n_inner rows for HS), and
    ``convert.from_reference_state`` takes the file's four tables as they
    are."""
    walks = _corpus(150, 48, 9, seed=4)
    kw = dict(CBOW_W2V, sample=0.0, **OBJECTIVES[objective])
    d = str(tmp_path)
    ref_w2v.Word2VecTPU(RefW2V(**dict(kw, max_iter=1))).fit(walks, n_vertices=48,
                                                             checkpoint_dir=d)
    _, *tables = load_train_state(d)
    state = convert.from_reference_state(*tables, device="cpu")
    n_out = 47 if objective == "hs" else 48
    assert [tuple(t.shape) for t in state] == [(48, 32), (n_out, 32), (48,), (n_out,)]
    for a, b in zip(convert.to_reference_state(*state), tables):
        np.testing.assert_array_equal(a, b)
    model = Word2VecTorch(Word2VecParams(**kw), device="cpu").fit(walks, n_vertices=48,
                                                                  checkpoint_dir=d)
    assert len(model.losses) == 1
    assert model.emb_out.shape == (n_out, 32)
    assert np.isfinite(model.vectors).all()


# --------------------------------------------------------------------------- #
# optimizer is read by SGNS alone
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("trainer", ["fit", "fit_host", "fit_streaming"])
@pytest.mark.parametrize("objective", ["hs", "cbow_ns", "cbow_hs"])
def test_optimizer_moves_only_sgns(objective, trainer):
    """HS and CBOW train row-wise Adagrad whatever ``optimizer`` says, as
    the JAX package does (it passes ``optimizer`` to the SGNS epoch alone,
    node2vec_tpu/models/word2vec.py:167-182, :394-424, :711-746); SGNS with
    "sgd" trains otherwise than with Adagrad."""
    walks = _corpus(64, 48, 7, seed=5)
    chunks = np.stack([_corpus(64, 48, 7, seed=s) for s in range(3)])
    kw = dict(min_count=1, vector_size=32, max_iter=1, batch_walks=32,
              **{"hs": {"negative": 0}, "cbow_ns": {"sg": 0},
                 "cbow_hs": {"sg": 0, "negative": 0}}[objective])
    sgd, adagrad = (_fit(Word2VecTorch(Word2VecParams(optimizer=o, **kw), device="cpu"),
                         trainer, walks, chunks) for o in ("sgd", "adagrad"))
    for name in ("_emb_in", "_emb_out", "acc_in", "acc_out"):
        np.testing.assert_array_equal(getattr(sgd, name).numpy(), getattr(adagrad, name).numpy(),
                                      err_msg=name)
    sgns_kw = dict(min_count=1, vector_size=32, max_iter=1, batch_walks=32)
    sgns_sgd, sgns_ada = (_fit(Word2VecTorch(Word2VecParams(optimizer=o, **sgns_kw),
                                             device="cpu"), trainer, walks, chunks)
                          for o in ("sgd", "adagrad"))
    assert not np.allclose(sgns_sgd.vectors, sgns_ada.vectors)
    assert not sgns_sgd.acc_in.any() and sgns_ada.acc_in.any()


# --------------------------------------------------------------------------- #
# the pipeline and what it learns
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mode", ["in_memory", "streaming", "host_corpus"])
@pytest.mark.parametrize("objective", ["ns", "hs"])
def test_pipeline_trains_cbow_and_resumes(karate_edges, tmp_path, objective, mode):
    kw = dict(n2v_params={"num_walks": 4, "walk_length": 8, "walker_chunk": 64},
              w2v_params={"sg": 0, "vector_size": 32, "min_count": 1, "max_iter": 4,
                          **OBJECTIVES[objective]},
              device="cpu", checkpoint_dir=str(tmp_path), host_corpus=mode == "host_corpus")
    streaming = None if mode != "in_memory" else False
    _build.reset_launches()
    n2v = Node2Vec(**kw)
    n2v.preprocess_input_graph(karate_edges, directed=False)
    model = n2v.run_pipeline(streaming=streaming)
    assert (n2v.walks is None) == (mode == "streaming")
    assert model.emb_out.shape == ((33 if objective == "hs" else 34), 32)
    assert model.vectors.shape == (34, 32)
    assert np.isfinite(model.vectors).all() and model.losses[-1] < model.losses[0]
    assert sum(_build.launches.values()) == 0
    again = Node2Vec(**kw)
    again.preprocess_input_graph(karate_edges, directed=False)
    np.testing.assert_array_equal(again.run_pipeline(streaming=streaming).vectors,
                                  model.vectors)


def _community_walks(rng, n_comm=3, size=10, n_walks=60, length=12):
    """Walks confined to one community each (tests/test_cbow.py:21)."""
    return np.array([rng.integers(c * size, (c + 1) * size, length)
                     for c in range(n_comm) for _ in range(n_walks)], dtype=np.int32)


@pytest.mark.parametrize("objective", ["ns", "hs"])
def test_trains_communities(objective):
    """tests/test_cbow.py:70/:84 in the port: CBOW separates three
    communities of walks (intra-community cosine above inter by 0.1)."""
    walks = _community_walks(np.random.default_rng({"ns": 0, "hs": 1}[objective]))
    p = Word2VecParams(sg=0, min_count=1, vector_size=32,
                       max_iter={"ns": 8, "hs": 4}[objective], **OBJECTIVES[objective])
    m = Word2VecTorch(p, device="cpu").fit(walks, n_vertices=30)
    e = m.vectors / np.linalg.norm(m.vectors, axis=1, keepdims=True)
    sim = e @ e.T
    comm = np.arange(30) // 10
    same = comm[:, None] == comm[None, :]
    off = ~np.eye(30, dtype=bool)
    assert sim[same & off].mean() > sim[~same].mean() + 0.1
    assert m.losses[-1] < m.losses[0]
