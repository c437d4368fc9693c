"""node2vec_torch's hierarchical softmax against node2vec_tpu's on the CPU.

Trees, code caps and head splits are bit-equal on both merge branches
(heapq below 65,536 vertices, the native two-queue merge above).  One step
matches ``hs_walk_step_impl`` on bf16-representable tables: the loss at
rtol 1e-5 (the JAX forward pass is then fp32 arithmetic on the same
numbers), and every table and accumulator increment to 3e-2 of that
increment's largest magnitude, because the JAX step still rounds its
gradients to bf16 (node2vec_tpu/models/hsoftmax.py:343,349-350,375) where
the port keeps fp32.  The trainers, handed JAX's draws, match the JAX
trainers at rtol 2e-2 on the epoch losses and to the same increment
tolerance on the tables; a killed and resumed run is bit-equal to an
uninterrupted one; train states load across the packages; quality is held
to the JAX trainer's micro-F1 within 0.05."""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from node2vec_tpu import native as ref_native
from node2vec_tpu.constants import Word2VecParams as RefW2V
from node2vec_tpu.models import hsoftmax as ref_hs
from node2vec_tpu.models import skipgram as ref_sg
from node2vec_tpu.models import word2vec as ref_w2v
from node2vec_torch import Node2Vec, _build, convert, native
from node2vec_torch.constants import Node2VecParams, Word2VecParams
from node2vec_torch.datasets import multilabel_f1, synthetic_multilabel
from node2vec_torch.models import hsoftmax as hs
from node2vec_torch.models import vocab
from node2vec_torch.models import word2vec as w2v
from node2vec_torch.models.word2vec import Word2VecTorch
from node2vec_torch.walk import WalkEngine

LOSS_RTOL = 1e-5  # fp32 forward pass on bf16-representable tables
INC_TOL = 3e-2  # of an increment's max |.|: the JAX step rounds gradients to bf16
EPOCH_LOSS_RTOL = 2e-2  # several steps of the bf16-rounded JAX gradients


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread each keeps parallel test workers
    from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_native_loaded(deadline_s: float = 120.0) -> None:
    """Load the JAX package's native library, waiting out a concurrent build
    (tests/test_torch_blocked.py:50): without it the JAX package quietly
    takes the heapq merge, which breaks count ties differently.  Fails
    (never skips) naming the library if it does not load in time."""
    t_end = time.monotonic() + deadline_s
    while not ref_native.available():
        if time.monotonic() > t_end:
            pytest.fail(f"{ref_native._LIB_PATH} did not load within {deadline_s:.0f} s")
        time.sleep(0.5)
        ref_native._tried = False


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _assert_trees_equal(got, want) -> None:
    for name in ("points", "codes", "lengths", "level_offsets"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)
        assert getattr(got, name).dtype == np.asarray(getattr(want, name)).dtype, name
    assert got.n_inner == want.n_inner


def _counts(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "heapq":  # 300 counts with many ties, some zero
        return rng.integers(0, 12, 300)
    return np.minimum(rng.zipf(1.3, 65_536), 10**6)  # native branch, ties in the tail


# --------------------------------------------------------------------------- #
# the tree
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("max_len", [None, 6])
@pytest.mark.parametrize("kind", ["heapq", "native"])
def test_tree_cap_and_head_equal_jax(kind, max_len):
    _ref_native_loaded()  # both packages extract the paths natively
    assert native.available(), "the port's native core did not build"
    counts = _counts(kind)
    tree, ref_tree = hs.build_huffman(counts), ref_hs.build_huffman(counts)
    _assert_trees_equal(tree, ref_tree)
    capped = hs.cap_code_length(tree, counts, max_len=max_len)
    ref_capped = ref_hs.cap_code_length(ref_tree, counts, max_len=max_len)
    _assert_trees_equal(capped, ref_capped)
    if max_len:
        assert capped.points.shape[1] == max_len
    for max_rows in (16, 512):
        assert (hs.head_level_offsets(capped, max_rows=max_rows, table_rows=capped.n_inner)
                == ref_hs.head_level_offsets(ref_capped, max_rows=max_rows,
                                             table_rows=ref_capped.n_inner))
    big = hs.DENSE_HEAD_MAX_ROWS + 1
    assert hs.DENSE_HEAD_MAX_ROWS == ref_hs.DENSE_HEAD_MAX_ROWS
    assert hs.head_level_offsets(capped, table_rows=big) == (0,) == \
        ref_hs.head_level_offsets(ref_capped, table_rows=big)


def test_native_huffman_bindings_equal_jax():
    _ref_native_loaded()
    counts = np.sort(_counts("heapq"))
    merged, ref_merged = native.huffman_merge(counts), ref_native.huffman_merge(counts)
    for a, b in zip(merged, ref_merged):
        np.testing.assert_array_equal(a, b)
    parent, branch, depth = merged
    n = len(counts)
    new_id = np.arange(n - 1, dtype=np.int64)
    lengths = depth[:n].astype(np.int32)
    for a, b in zip(native.huffman_paths(parent, branch, new_id, lengths, int(lengths.max())),
                    ref_native.huffman_paths(parent, branch, new_id, lengths,
                                             int(lengths.max()))):
        np.testing.assert_array_equal(a, b)


def test_one_vertex_tree_equals_jax():
    _assert_trees_equal(hs.build_huffman(np.array([5])), ref_hs.build_huffman(np.array([5])))


# --------------------------------------------------------------------------- #
# one step
# --------------------------------------------------------------------------- #

V, D, B, L1, W = 60, 16, 12, 9, 3


def _bf16_exact(x) -> np.ndarray:
    """fp32 values with the low 16 bits cleared: bf16 casts are exact."""
    x = np.array(x, dtype=np.float32)
    x.view(np.uint32)[...] &= np.uint32(0xFFFF0000)
    return x


def _step_inputs(seed: int):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 30, V)
    tree = hs.cap_code_length(hs.build_huffman(counts), counts)
    state = [_bf16_exact(rng.normal(0, 0.3, (V, D))),
             _bf16_exact(rng.normal(0, 0.3, (tree.n_inner, D))),
             rng.random(V).astype(np.float32), rng.random(tree.n_inner).astype(np.float32)]
    walks = rng.integers(0, V, (B, L1)).astype(np.int32)
    walks[rng.random((B, L1)) < 0.1] = -1  # dead lanes
    walks[-1, 4:] = -1  # a walk that ends early
    mask = counts >= 3  # out-of-vocabulary positions
    assert (~mask[walks[walks >= 0]]).any()
    return tree, state, walks, mask


def _heads(tree, head: str):
    return hs.head_level_offsets(tree, max_rows=16) if head == "head" else (0,)


def _port_step(tree, state, walks, b_sh, mask, head_offsets, lr=0.1):
    st = [_t(a) for a in state]
    loss = hs.hs_walk_step(*st, _t(walks), _t(b_sh), lr, _t(tree.points), _t(tree.codes),
                           _t(tree.lengths), _t(mask), window=W, head_offsets=head_offsets)
    return [a.numpy() for a in st], float(loss)


def _assert_increments_close(got, want, init, names) -> None:
    for name, g, w, i in zip(names, got, want, init):
        inc, ref_inc = np.asarray(g) - i, np.asarray(w) - i
        scale = float(np.abs(ref_inc).max())
        assert scale > 0, f"{name}: no update"
        err = float(np.abs(inc - ref_inc).max())
        assert err <= INC_TOL * scale, f"{name}: increment error {err} > {INC_TOL} * {scale}"


# one compile per (head, shrink) instead of one per primitive: faster on the CPU
_ref_step = jax.jit(ref_hs.hs_walk_step_impl,
                    static_argnames=("window", "shrink_window", "head_offsets", "packed"))


@pytest.mark.parametrize("shrink", [True, False])
@pytest.mark.parametrize("head", ["head", "no_head"])
def test_step_matches_jax(head, shrink):
    tree, state, walks, mask = _step_inputs(1)
    ho = _heads(tree, head)
    if head == "head":
        assert len(ho) > 2 and ho[-1] < tree.n_inner  # a head and a tail
    key = jax.random.PRNGKey(5)
    ref = _ref_step(
        *(jnp.asarray(a) for a in state), jnp.asarray(walks), key, 0.1,
        jnp.asarray(tree.points), jnp.asarray(tree.codes), jnp.asarray(tree.lengths),
        jnp.asarray(mask), window=W, shrink_window=shrink, head_offsets=ho)
    b_sh = (np.asarray(jax.random.randint(key, (B, L1), 1, W + 1)) if shrink
            else np.full((B, L1), W)).astype(np.int32)
    got, loss = _port_step(tree, state, walks, b_sh, mask, ho)
    np.testing.assert_allclose(loss, float(ref[4]), rtol=LOSS_RTOL)
    _assert_increments_close(got, ref[:4], state, ("emb_in", "theta", "acc_in", "acc_theta"))


def test_head_equals_gather_in_the_port():
    """The dense head changes only how head rows are updated (one
    pre-aggregated step per batch): the loss, emb_in and every row at levels
    >= H are those of the all-gather step."""
    tree, state, walks, mask = _step_inputs(2)
    b_sh = np.random.default_rng(3).integers(1, W + 1, (B, L1)).astype(np.int32)
    ho = _heads(tree, "head")
    k = ho[-1]
    with_head, loss_h = _port_step(tree, state, walks, b_sh, mask, ho)
    gather, loss_g = _port_step(tree, state, walks, b_sh, mask, (0,))
    np.testing.assert_allclose(loss_h, loss_g, rtol=1e-6)
    for a, b, rows in zip(with_head, gather, (slice(None), slice(k, None)) * 2):
        np.testing.assert_allclose(a[rows], b[rows], rtol=1e-6, atol=1e-7)
    assert not np.allclose(with_head[1][:k], gather[1][:k])  # the head rule differs


def test_cpu_step_launches_no_kernel_and_grads_shapes():
    tree, state, walks, mask = _step_inputs(4)
    ho = _heads(tree, "head")
    _build.reset_launches()
    g_in, g_tail, tail_rows, d_head, _ = hs.hs_grads(
        *(_t(a) for a in state[:2]), _t(walks), _t(mask), _t(np.full((B, L1), W, np.int32)),
        _t(tree.points), _t(tree.codes), _t(tree.lengths), window=W, head_offsets=ho)
    n_head, k = hs.head_split(ho, tree.points.shape[1])
    clt = tree.points.shape[1] - n_head
    assert g_in.shape == (B * L1, D) and d_head.shape == (k, D)
    assert g_tail.shape == (B * L1 * clt, D) and tail_rows.shape == (B * L1 * clt,)
    rows = tail_rows.numpy().reshape(B, L1, clt)
    assert (rows[walks < 0] == -1).all() and (rows[rows >= 0] >= k).all()
    assert sum(_build.launches.values()) == 0


# --------------------------------------------------------------------------- #
# the trainers against JAX's, given JAX's draws
# --------------------------------------------------------------------------- #


class JaxDraws(w2v.Draws):
    """The JAX trainers' draws, keyed as they key them: fold_in(PRNGKey(seed),
    tag) for shuffles and subsampling, fold_in(key, gstep) itself for the HS
    step's window shrink (hsoftmax.py:309, :481)."""

    def __init__(self, params, shared_negatives, device):
        super().__init__(params, shared_negatives, device)
        self.key = jax.random.PRNGKey(params.seed)

    def init(self, n_vertices, dim):
        return tuple(_t(a) for a in ref_sg.init_embeddings(n_vertices, dim, seed=self.params.seed))

    def permutation(self, tag, n):
        return _t(jax.random.permutation(jax.random.fold_in(self.key, tag), n)).long()

    def window_shrink(self, gstep, n_walks, length):
        p = self.params
        key = jax.random.fold_in(self.key, gstep)
        return _t(jax.random.randint(key, (n_walks, length), 1, p.window_size + 1)
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


HS_W2V = dict(negative=0, min_count=1, vector_size=32, window_size=5, batch_walks=32,
              max_iter=2, sample=1e-3)


@pytest.mark.parametrize("trainer", ["fit", "fit_host", "fit_streaming"])
def test_trainers_match_jax_given_its_draws(trainer):
    walks = _corpus(150, 48, 9, seed=1)
    chunks = np.stack([_corpus(100, 48, 9, seed=s) for s in range(3)])
    model = Word2VecTorch(Word2VecParams(**HS_W2V), device="cpu")
    model._new_draws = lambda: JaxDraws(model.params, model.shared_negatives, model.device)
    ref = ref_w2v.Word2VecTPU(RefW2V(**HS_W2V))
    if trainer == "fit":
        model.fit(walks, n_vertices=48)
        ref.fit(walks, n_vertices=48)
    elif trainer == "fit_host":
        model.fit_host(walks, n_vertices=48, slab_walks=64)
        ref.fit_host(walks, n_vertices=48, slab_walks=64)
    else:
        model.fit_streaming(lambda i: torch.from_numpy(chunks[i]), 3, 48)
        ref.fit_streaming(lambda i: jnp.asarray(chunks[i]), 3, 48)
    assert model.emb_out.shape == (model.tree.n_inner, 32) == np.asarray(ref.emb_out).shape
    assert model.tree.n_inner == 47
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
def test_kill_and_resume_bit_equal(tmp_path, trainer):
    params = Word2VecParams(**dict(HS_W2V, max_iter=3))
    walks = _corpus(150, 48, 9, seed=3)
    chunks = np.stack([_corpus(100, 48, 9, seed=s) for s in range(3)])

    def run(model, d=None):
        if trainer == "fit":
            return model.fit(walks, n_vertices=48, checkpoint_dir=d)
        if trainer == "fit_host":
            return model.fit_host(walks, n_vertices=48, slab_walks=64, checkpoint_dir=d)
        return model.fit_streaming(lambda i: torch.from_numpy(chunks[i]), 3, 48,
                                   checkpoint_dir=d, checkpoint_every_chunks=1,
                                   source_token="tok")

    full = run(Word2VecTorch(params, device="cpu"))
    d = str(tmp_path / trainer)
    kill = {"fit": 2, "fit_host": 7, "fit_streaming": 4}[trainer]
    with pytest.raises(RuntimeError, match="simulated kill"):
        run(_kill_after(Word2VecTorch(params, device="cpu"), kill), d)
    resumed = run(Word2VecTorch(params, device="cpu"), d)
    for name in ("_emb_in", "_emb_out", "acc_in", "acc_out"):
        np.testing.assert_array_equal(getattr(resumed, name).numpy(),
                                      getattr(full, name).numpy(), err_msg=name)
    assert resumed._emb_out.shape[0] == full.tree.n_inner
    first = {"fit": 2, "fit_host": 2, "fit_streaming": 0}[trainer]
    assert resumed.losses == full.losses[first:]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_hs_train_state_resumes_across_packages(tmp_path, writer):
    """One package trains an epoch of HS with checkpoint_dir; the other
    resumes from its file at epoch 1 with theta of n_inner rows."""
    walks = _corpus(150, 48, 9, seed=4)
    kw = dict(HS_W2V, sample=0.0)
    d = str(tmp_path)
    if writer == "jax":
        ref_w2v.Word2VecTPU(RefW2V(**dict(kw, max_iter=1))).fit(walks, n_vertices=48,
                                                                 checkpoint_dir=d)
        model = Word2VecTorch(Word2VecParams(**kw), device="cpu").fit(
            walks, n_vertices=48, checkpoint_dir=d)
        assert len(model.losses) == 1 and model.emb_out.shape == (47, 32)
        return
    Word2VecTorch(Word2VecParams(**dict(kw, max_iter=1)), device="cpu").fit(
        walks, n_vertices=48, checkpoint_dir=d)
    ref = ref_w2v.Word2VecTPU(RefW2V(**kw)).fit(walks, n_vertices=48, checkpoint_dir=d)
    assert len(ref._losses) == 1 and np.asarray(ref.emb_out).shape == (47, 32)


def test_sgns_checkpoint_refused_by_hs(tmp_path):
    walks = _corpus(150, 48, 9, seed=4)
    d = str(tmp_path)
    Word2VecTorch(Word2VecParams(min_count=1, vector_size=32, max_iter=1),
                  device="cpu").fit(walks, n_vertices=48, checkpoint_dir=d)
    with pytest.raises(ValueError, match="47"):
        Word2VecTorch(Word2VecParams(**HS_W2V), device="cpu").fit(walks, n_vertices=48,
                                                                  checkpoint_dir=d)


# --------------------------------------------------------------------------- #
# state conversion, the pipeline and quality
# --------------------------------------------------------------------------- #


def test_reference_state_with_theta_rows():
    rng = np.random.default_rng(0)
    tables = [rng.random((20, 8)), rng.random((19, 8)), rng.random(20), rng.random(19)]
    state = convert.from_reference_state(*tables, device="cpu")
    assert [tuple(t.shape) for t in state] == [(20, 8), (19, 8), (20,), (19,)]
    for a, b in zip(convert.to_reference_state(*state), tables):
        np.testing.assert_array_equal(a, b.astype(np.float32))
    with pytest.raises(ValueError, match="D"):
        convert.from_reference_state(tables[0], rng.random((19, 7)), *tables[2:], device="cpu")
    with pytest.raises(ValueError):
        convert.from_reference_state(*tables[:3], rng.random(18), device="cpu")
    with pytest.raises(ValueError):
        convert.from_reference_state(tables[0], tables[1], rng.random(21), tables[3],
                                     device="cpu")


@pytest.mark.parametrize("mode", ["in_memory", "streaming", "host_corpus"])
def test_pipeline_trains_hs_and_resumes(karate_edges, tmp_path, mode):
    kw = dict(n2v_params={"num_walks": 4, "walk_length": 8, "walker_chunk": 64},
              w2v_params={"negative": 0, "vector_size": 32, "min_count": 1, "max_iter": 2},
              device="cpu", checkpoint_dir=str(tmp_path), host_corpus=mode == "host_corpus")
    _build.reset_launches()
    n2v = Node2Vec(**kw)
    n2v.preprocess_input_graph(karate_edges, directed=False)
    model = n2v.run_pipeline(streaming=None if mode != "in_memory" else False)
    assert (n2v.walks is None) == (mode == "streaming")
    assert model.emb_out.shape == (33, 32) and model.vectors.shape == (34, 32)
    assert np.isfinite(model.vectors).all() and model.losses[-1] < model.losses[0]
    assert sum(_build.launches.values()) == 0
    again = Node2Vec(**kw)
    again.preprocess_input_graph(karate_edges, directed=False)
    np.testing.assert_array_equal(
        again.run_pipeline(streaming=None if mode != "in_memory" else False).vectors,
        model.vectors)


def test_multilabel_quality_close_to_jax():
    """Micro-F1@0.5 within 0.05 of the JAX HS trainer's on
    synthetic_multilabel(600), both on the same walks with trainer seed 1
    (HS spans 0.88-0.91 across trainer seeds 1-3 there, in both packages)."""
    g, labels = synthetic_multilabel(600, seed=0)
    walks = WalkEngine(g, Node2VecParams(num_walks=4, walk_length=20), device="cpu").run(seed=0)
    kw = dict(negative=0, min_count=1, max_iter=2, vector_size=32, seed=1)
    port = Word2VecTorch(Word2VecParams(**kw), device="cpu").fit(walks, n_vertices=g.n_vertices)
    ref = ref_w2v.Word2VecTPU(RefW2V(**kw)).fit(walks, n_vertices=g.n_vertices)
    scores = {name: multilabel_f1(emb, labels, train_ratio=0.5)["micro_f1"]
              for name, emb in (("port", port.vectors), ("jax", np.asarray(ref.emb_in)))}
    assert scores["port"] >= 0.55, scores
    assert abs(scores["port"] - scores["jax"]) <= 0.05, scores


def test_init_state_outputs_theta_rows():
    walks = _corpus(64, 20, 6)
    model = Word2VecTorch(Word2VecParams(**dict(HS_W2V, max_iter=1)), device="cpu")
    model.fit(walks, n_vertices=20)
    assert model.tree.n_inner == 19 and model.acc_out.shape == (19,)
    assert model.head_offsets == hs.head_level_offsets(model.tree, table_rows=19)
