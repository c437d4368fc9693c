"""node2vec_torch's out-of-core trainers, K7 subsampling, the streaming form
of K6 and the checkpoint files against node2vec_tpu's on the CPU.

Exact where the two packages draw the same numbers (numpy chunk orders and
host permutations, walk chunks on dyadic graphs, vertex counts, K7's plain
version given JAX's uniforms, fingerprints and checkpoint files).  The
trainers, handed JAX's own draws (``JaxDraws``), match the JAX trainers
within rtol 1e-5, atol 1e-6 (sums and scatters run in another order).  A
killed and resumed run is bit-equal to an uninterrupted one.  Quality is
held to the JAX trainers' micro-F1 within 0.05."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import node2vec_tpu
from node2vec_tpu.constants import Node2VecParams as RefN2V
from node2vec_tpu.constants import Word2VecParams as RefW2V
from node2vec_tpu.graph import from_edge_arrays as ref_from_edge_arrays
from node2vec_tpu.models import skipgram as ref_sg
from node2vec_tpu.models import word2vec as ref_w2v
from node2vec_tpu.utils import checkpoint as ref_ck
from node2vec_tpu.walk import WalkEngine as RefWalkEngine
from node2vec_torch import Node2Vec
from node2vec_torch.constants import Node2VecParams, Word2VecParams
from node2vec_torch.datasets import multilabel_f1, synthetic_multilabel
from node2vec_torch.graph import from_edge_arrays
from node2vec_torch.models import vocab
from node2vec_torch.models import word2vec as w2v
from node2vec_torch.models.word2vec import Word2VecTorch
from node2vec_torch.utils import checkpoint as ck
from node2vec_torch.walk import WalkEngine

RTOL, ATOL = 1e-5, 1e-6
DYADIC = np.float32([0.5, 1.0, 2.0])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run small tensors, as fast on one intra-op thread; one
    thread each keeps parallel test workers from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


class JaxDraws(w2v.Draws):
    """The JAX trainers' own draws, keyed as they key them:
    fold_in(PRNGKey(seed), tag) for shuffles, subsampling and steps."""

    def __init__(self, params, shared_negatives, device):
        super().__init__(params, shared_negatives, device)
        self.key = jax.random.PRNGKey(params.seed)

    def init(self, n_vertices, dim):
        return tuple(_t(a) for a in ref_sg.init_embeddings(n_vertices, dim, seed=self.params.seed))

    def permutation(self, tag, n):
        return _t(jax.random.permutation(jax.random.fold_in(self.key, tag), n)).long()

    def step(self, gstep, n_walks, length):
        p = self.params
        k_neg1, k_neg2, k_shrink = jax.random.split(jax.random.fold_in(self.key, gstep), 3)
        if p.shrink_window:
            b_sh = jax.random.randint(k_shrink, (n_walks, length), 1, p.window_size + 1)
        else:
            b_sh = jnp.full((n_walks, length), p.window_size, jnp.int32)
        s = self.shared_negatives
        return (_t(b_sh.astype(jnp.int32)), _t(jax.random.uniform(k_neg1, (s,))),
                _t(jax.random.uniform(k_neg2, (s,))))

    def subsample(self, walks, keep_prob, tag):
        u = _t(jax.random.uniform(jax.random.fold_in(self.key, tag), tuple(walks.shape)))
        return vocab.subsample_walks_plain(walks, keep_prob, self.params.seed, tag, u=u)


def _with_jax_draws(model: Word2VecTorch) -> Word2VecTorch:
    model._new_draws = lambda: JaxDraws(model.params, model.shared_negatives, model.device)
    return model


def _assert_tables_close(got: Word2VecTorch, want) -> None:
    for name in ("emb_in", "emb_out"):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(got.losses, want._losses, rtol=RTOL, atol=ATOL)


def _corpus(n_walks=150, n_vertices=48, length=9, seed=0):
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, n_vertices, (n_walks, length)).astype(np.int32)
    ends = rng.integers(2, length + 1, n_walks)
    walks[np.arange(length)[None, :] >= ends[:, None]] = -1
    walks[:, 0] = np.arange(n_walks) % n_vertices  # every vertex occurs
    return walks


# --------------------------------------------------------------------------- #
# params, fingerprints and checkpoint files
# --------------------------------------------------------------------------- #


def test_params_repr_and_fingerprints_equal_jax():
    """repr(params) enters every fingerprint, so it must be the JAX one."""
    kw_w = dict(min_count=3, max_iter=4, vector_size=48, sample=1e-3, seed=7)
    kw_n = dict(num_walks=3, walk_length=11, return_param=0.5, walker_chunk=999)
    for mine, ref in ((Word2VecParams(), RefW2V()), (Word2VecParams(**kw_w), RefW2V(**kw_w)),
                      (Node2VecParams(), RefN2V()), (Node2VecParams(**kw_n), RefN2V(**kw_n))):
        assert repr(mine) == repr(ref)
    rng = np.random.default_rng(0)
    indices = rng.integers(0, 100, 3000).astype(np.int32)
    weights = rng.random(3000).astype(np.float32)
    assert ck.graph_digest(indices, weights) == ref_ck.graph_digest(indices, weights)
    starts = np.arange(40, dtype=np.int32)
    assert (ck.walk_fingerprint(Node2VecParams(**kw_n), 3, starts, 100, "g", "blocked")
            == ref_ck.walk_fingerprint(RefN2V(**kw_n), 3, starts, 100, "g", "blocked"))
    assert (ck.stream_fingerprint(Word2VecParams(**kw_w), 40, 100, token="t")
            == ref_ck.stream_fingerprint(RefW2V(**kw_w), 40, 100, token="t"))
    assert ck.TRAIN_STATE_VERSION == ref_ck.TRAIN_STATE_VERSION


def _files(rng):
    tables = [rng.random((20, 8)).astype(np.float32), rng.random((20, 8)).astype(np.float32),
              rng.random(20).astype(np.float32), rng.random(20).astype(np.float32)]
    return {
        "walk_chunk": dict(paths=rng.integers(-1, 20, (30, 7)).astype(np.int32)),
        "train_state": dict(tables=tables),
        "stream_state": dict(tables=tables, losses=rng.random(5).astype(np.float32),
                             cur=rng.random(3).astype(np.float32),
                             counts=rng.integers(0, 1 << 40, 20)),
    }


@pytest.mark.parametrize("kind", ["walk_chunk", "train_state", "stream_state"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_files_interchange(tmp_path, kind, writer):
    """Every file kind written by one package loads in the other."""
    src, dst = (ref_ck, ck) if writer == "jax" else (ck, ref_ck)
    f = _files(np.random.default_rng(1))[kind]
    d = str(tmp_path)
    if kind == "walk_chunk":
        src.save_walk_chunk(d, 3, f["paths"], fingerprint="fp")
        got = dst.load_walk_chunks(d, fingerprint="fp")
        assert list(got) == [3]
        np.testing.assert_array_equal(got[3], f["paths"])
        assert dst.load_walk_chunks(d, fingerprint="other") == {}  # stale: discarded
        return
    if kind == "train_state":
        src.save_train_state(d, 5, *f["tables"])
        got = dst.load_train_state(d)
        assert got[0] == 5
        for a, b in zip(got[1:], f["tables"]):
            np.testing.assert_array_equal(a, b)
        return
    src.save_stream_state(d, "fp", 2, 7, *f["tables"], f["losses"], f["cur"],
                          counts=f["counts"], chunk_walks=1234)
    got = dst.load_stream_state(d, "fp")
    assert got[:2] == (2, 7) and got[-1] == 1234
    for a, b in zip(got[2:9], [*f["tables"], f["losses"], f["cur"], f["counts"]]):
        np.testing.assert_array_equal(a, b)
    assert dst.load_stream_state(d, "other") is None


# --------------------------------------------------------------------------- #
# chunk_source and the walk checkpoints
# --------------------------------------------------------------------------- #


def _hub600():
    rng = np.random.default_rng(0)
    nbrs = np.arange(1, 601, dtype=np.int32)
    src = np.concatenate([np.zeros(600, np.int32), nbrs, nbrs, nbrs % 600 + 1])
    dst = np.concatenate([nbrs, np.zeros(600, np.int32), nbrs % 600 + 1, nbrs])
    return src, dst, rng.choice(DYADIC, len(src))


def _engines(name, karate_edges):
    """(port engine, JAX engine) on karate (dense) or the hub600 graph
    (blocked), dyadic weights and p, q powers of two."""
    if name == "karate":
        src, dst = karate_edges
        w, directed, kw = np.ones(len(src), np.float32), False, dict(num_walks=4, walker_chunk=64)
    else:
        (src, dst, w), directed, kw = _hub600(), True, dict(num_walks=1, walker_chunk=256)
    kw.update(walk_length=8, return_param=0.25, inout_param=4.0)
    g = from_edge_arrays(src, dst, w, directed=directed)
    rg = ref_from_edge_arrays(src, dst, w, directed=directed)
    return (WalkEngine(g, Node2VecParams(**kw), device="cpu"),
            RefWalkEngine(rg, RefN2V(**kw)))


@pytest.mark.parametrize("name,strategy", [("karate", "dense"), ("hub600", "blocked")])
def test_chunk_source_equals_jax(name, strategy, karate_edges):
    eng, ref = _engines(name, karate_edges)
    assert eng.strategy == ref.strategy == strategy
    assert eng.graph_token == ref.graph_token
    assert eng._strategy_token() == ref._strategy_token()
    n_chunks, chunk, source = eng.chunk_source(seed=5)
    ref_n, ref_chunk, ref_source = ref.chunk_source(seed=5)
    assert (n_chunks, chunk) == (ref_n, ref_chunk) and n_chunks == 3
    for i in range(n_chunks):
        got = source(i)
        assert got.shape == (chunk, 9)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_source(i)))
    assert (got[-(n_chunks * chunk - len(eng._starts(None))):] == -1).all()  # dead tail
    np.testing.assert_array_equal(source(1).numpy(), source(1).numpy())


def test_walk_checkpoint_skips_done_chunks_and_interchanges(tmp_path, monkeypatch,
                                                            karate_edges):
    """A walk run with checkpoint_dir skips the chunks on disk, and the
    JAX engine reads the port's chunks without walking."""
    eng, ref = _engines("karate", karate_edges)
    d = str(tmp_path / "walks")
    full = eng.run(seed=2, checkpoint_dir=d)
    np.testing.assert_array_equal(full, eng.run(seed=2))
    os.remove(os.path.join(d, "walks_chunk_000001.npz"))
    walked = []
    real = eng._run_chunk
    monkeypatch.setattr(eng, "_run_chunk", lambda s, gid_base, seed: walked.append(gid_base)
                        or real(s, gid_base=gid_base, seed=seed))
    np.testing.assert_array_equal(eng.run(seed=2, checkpoint_dir=d), full)
    assert walked == [64]  # only the removed chunk walked again

    def no_walk(*a, **k):
        raise AssertionError("the JAX engine walked a chunk the port had saved")

    monkeypatch.setattr(ref, "_run_chunk", no_walk)
    np.testing.assert_array_equal(ref.run(seed=2, checkpoint_dir=d), full)


# --------------------------------------------------------------------------- #
# _streaming_counts (K6 with out=) and K7
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("source_kind", ["karate_chunks", "300_tiny_chunks"])
def test_streaming_counts_equal_jax(source_kind, karate_edges):
    if source_kind == "karate_chunks":
        eng, ref = _engines("karate", karate_edges)
        n_chunks, _, source = eng.chunk_source(seed=1)
        ref_source = ref.chunk_source(seed=1)[2]
        n_v = eng.n_vertices
    else:  # more than 256 chunks: the int32 counts spill to the host total
        rng = np.random.default_rng(3)
        chunks = rng.integers(-1, 11, (300, 4, 5)).astype(np.int32)
        n_chunks, n_v = len(chunks), 11
        source = lambda i: torch.from_numpy(chunks[i])  # noqa: E731
        ref_source = lambda i: jnp.asarray(chunks[i])  # noqa: E731
    got, length = w2v._streaming_counts(source, n_chunks, n_v)
    want, ref_length = ref_w2v._streaming_counts(ref_source, n_chunks, n_v)
    assert got.dtype == np.int64 and length == ref_length
    np.testing.assert_array_equal(got, want)


def test_vertex_counts_out_accumulates():
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.integers(-1, 9, (6, 5)).astype(np.int32)) for _ in range(2))
    out = torch.zeros(9, dtype=torch.int32)
    assert vocab.vertex_counts(a, 9, out=out) is out
    vocab.vertex_counts(b, 9, out=out)
    want = np.bincount(np.concatenate([a.numpy().ravel(), b.numpy().ravel()]) + 1, minlength=10)
    np.testing.assert_array_equal(out.numpy(), want[1:])
    with pytest.raises(ValueError, match="out must be"):
        vocab.vertex_counts(a, 9, out=torch.zeros(8, dtype=torch.int32))


@pytest.mark.parametrize("tag", [2_000_001, 4_000_003, 8_000_007])
def test_subsample_plain_given_jax_uniforms_equals_jax(tag):
    walks = _corpus(400, 30, 11, seed=5)
    counts = np.bincount(walks[walks >= 0], minlength=30)
    keep = vocab.subsample_keep_prob(counts, 1e-3)
    assert keep.max() < 0.5
    key = jax.random.fold_in(jax.random.PRNGKey(1), tag)
    want = np.asarray(ref_w2v._subsample_walks(jnp.asarray(walks), key, jnp.asarray(keep)))
    u = _t(jax.random.uniform(key, walks.shape))
    got = vocab.subsample_walks_plain(torch.from_numpy(walks), torch.from_numpy(keep), 1, tag, u=u)
    np.testing.assert_array_equal(got.numpy(), want)


def test_subsample_statistics_and_edges():
    """tests/test_subsample.py:49 on K7's own draws: a hub is kept at about
    p_keep, padding untouched, survivors unchanged; the CPU wrapper is the
    plain version; an all-dead corpus and a keep table of ones pass
    through unchanged."""
    rng = np.random.default_rng(0)
    walks = rng.integers(0, 4, (40_000, 8)).astype(np.int32)
    walks[:, -1] = -1
    counts = np.bincount(walks[walks >= 0], minlength=4)
    keep = torch.from_numpy(vocab.subsample_keep_prob(counts, 5e-2))
    assert keep[0] < 0.9
    w = torch.from_numpy(walks)
    out = vocab.subsample_walks(w, keep, 1, 2_000_000)
    np.testing.assert_array_equal(out.numpy(), vocab.subsample_walks_plain(w, keep, 1, 2_000_000))
    assert not np.array_equal(out.numpy(), vocab.subsample_walks(w, keep, 1, 2_000_001).numpy())
    out = out.numpy()
    assert (out[:, -1] == -1).all()
    for v in range(4):
        assert abs((out == v).sum() / (walks == v).sum() - float(keep[v])) < 0.02
    changed = walks != out
    assert (out[changed] == -1).all()
    dead = torch.full((64, 8), -1, dtype=torch.int32)
    np.testing.assert_array_equal(vocab.subsample_walks(dead, keep, 1, 5).numpy(), dead.numpy())
    np.testing.assert_array_equal(
        vocab.subsample_walks(w, torch.ones(4), 1, 5).numpy(), walks)
    inplace = w.clone()
    assert vocab.subsample_walks(inplace, keep, 1, 9, out=inplace) is inplace
    np.testing.assert_array_equal(inplace.numpy(), vocab.subsample_walks(w, keep, 1, 9).numpy())


# --------------------------------------------------------------------------- #
# the trainers against JAX's, given JAX's draws
# --------------------------------------------------------------------------- #

# D = 32 and window 5 are the smallest the params allow
W2V = dict(min_count=1, vector_size=32, window_size=5, batch_walks=32, max_iter=2)
SAMPLE = 1e-3  # drops about two thirds of these small corpora (see _assert_subsampled)


def _assert_subsampled(model: Word2VecTorch) -> None:
    """The comparison is not vacuous: subsampling dropped entries."""
    assert float(model._keep_table().max()) < 0.5


def _spy_epochs(monkeypatch, model):
    """Record what each trainer hands its SGNS epoch: (corpus, step0, LR
    slope, batch, n_batches), on the JAX side and the port's."""
    ref_calls, calls = [], []
    real_ref, real = ref_w2v.sgns_epoch, model._train

    def ref_spy(e1, e2, a1, a2, corpus, key, step0, lr0, slope, *rest, **kw):
        ref_calls.append((np.asarray(corpus), int(step0), np.float32(slope), kw["batch"],
                          kw["n_batches"]))
        return real_ref(e1, e2, a1, a2, corpus, key, step0, lr0, slope, *rest, **kw)

    def spy(state, corpus, draws, step0, slope, batch, n_batches, noise):
        calls.append((corpus.numpy().copy(), step0, np.float32(slope), batch, n_batches))
        return real(state, corpus, draws, step0, slope, batch, n_batches, noise)

    monkeypatch.setattr(ref_w2v, "sgns_epoch", ref_spy)
    monkeypatch.setattr(model, "_train", spy)
    return calls, ref_calls


def _assert_same_epochs(calls, ref_calls):
    """The same corpora (bit for bit: shuffles, slabs and subsampling drawn
    alike) and the same geometry, call for call."""
    assert len(calls) == len(ref_calls)
    for (c, *geo), (rc, *ref_geo) in zip(calls, ref_calls):
        np.testing.assert_array_equal(c, rc)
        assert geo == ref_geo


def test_fit_streaming_matches_jax_given_its_draws(monkeypatch):
    """3 chunks x 2 epochs at V = 48, D = 32: the pass-1 counts, the numpy
    chunk orders, the batch geometry (truncating each 100-row chunk to
    3 x 32), the LR slope and step0 bookkeeping, and the SGNS steps."""
    chunks = np.stack([_corpus(100, 48, 9, seed=s) for s in range(3)])
    params = dict(W2V, sample=SAMPLE)
    seen, ref_seen = [], []
    model = _with_jax_draws(Word2VecTorch(Word2VecParams(**params), device="cpu"))
    calls, ref_calls = _spy_epochs(monkeypatch, model)
    want = ref_w2v.Word2VecTPU(RefW2V(**params)).fit_streaming(
        lambda i: ref_seen.append(i) or jnp.asarray(chunks[i]), 3, 48)
    got = model.fit_streaming(lambda i: seen.append(i) or torch.from_numpy(chunks[i]), 3, 48)
    assert seen == ref_seen  # counting pass, then the numpy chunk orders, prefetched
    orders = np.random.default_rng(1)
    assert seen[3:] == [int(c) for _ in range(2) for c in orders.permutation(3)]
    slope = np.float32(0.2 / (2 * 3 * 3))
    assert [(c.shape, *geo) for c, *geo in calls] == [
        ((96, 9), 3 * k, slope, 32, 3) for k in range(6)]
    _assert_same_epochs(calls, ref_calls)
    np.testing.assert_array_equal(got.vocab.counts, np.bincount(chunks[chunks >= 0], minlength=48))
    _assert_subsampled(got)
    _assert_tables_close(got, want)


def test_fit_host_matches_jax_given_its_draws(monkeypatch):
    """Slabs of 64 rows over 150 walks (3 slabs, the tail holding 22 real
    rows and one all-dead batch): the slab geometry and the host
    permutations (the slabs equal bit for bit), the tail-loss trimming and
    the per-slab losses."""
    walks = _corpus(150, 48, 9, seed=1)
    params = dict(W2V, sample=SAMPLE)
    model = _with_jax_draws(Word2VecTorch(Word2VecParams(**params), device="cpu"))
    calls, ref_calls = _spy_epochs(monkeypatch, model)
    want = ref_w2v.Word2VecTPU(RefW2V(**params)).fit_host(walks, n_vertices=48, slab_walks=64)
    got = model.fit_host(walks, n_vertices=48, slab_walks=64)
    assert [(c.shape, *geo[2:]) for c, *geo in calls] == [((64, 9), 32, 2)] * 6
    _assert_same_epochs(calls, ref_calls)
    assert [len(x) for x in got._slab_losses] == [3, 3]
    np.testing.assert_allclose(got._slab_losses, want._slab_losses, rtol=RTOL, atol=ATOL)
    _assert_subsampled(got)
    _assert_tables_close(got, want)


def test_fit_with_sample_matches_jax_given_its_draws():
    walks = _corpus(150, 48, 9, seed=2)
    params = dict(W2V, sample=SAMPLE, max_iter=3)
    want = ref_w2v.Word2VecTPU(RefW2V(**params)).fit(walks, n_vertices=48)
    got = _with_jax_draws(Word2VecTorch(Word2VecParams(**params), device="cpu")).fit(
        walks, n_vertices=48)
    _assert_subsampled(got)
    _assert_tables_close(got, want)


# --------------------------------------------------------------------------- #
# kill and resume
# --------------------------------------------------------------------------- #


def _kill_after(model, n_calls):
    """Make the model's (n_calls + 1)-th training call raise."""
    real, count = model._train, [0]

    def train(*args):
        count[0] += 1
        if count[0] > n_calls:
            raise RuntimeError("simulated kill")
        return real(*args)

    model._train = train
    return model


RESUME_W2V = dict(W2V, max_iter=3, sample=SAMPLE)


@pytest.mark.parametrize("trainer", ["fit", "fit_host", "fit_streaming"])
def test_kill_and_resume_bit_equal(tmp_path, trainer):
    """A run killed after a snapshot and run again ends bit-equal to an
    uninterrupted run: tables, accumulators and losses (fit and fit_host
    report the resumed epochs' losses, as in the JAX package)."""
    params = Word2VecParams(**RESUME_W2V)
    walks = _corpus(150, 48, 9, seed=3)
    chunks = np.stack([_corpus(100, 48, 9, seed=s) for s in range(3)])
    calls = []

    def source(i):
        calls.append(i)
        return torch.from_numpy(chunks[i])

    def run(model, d=None):
        if trainer == "fit":
            return model.fit(walks, n_vertices=48, checkpoint_dir=d)
        if trainer == "fit_host":
            return model.fit_host(walks, n_vertices=48, slab_walks=64, checkpoint_dir=d)
        return model.fit_streaming(source, 3, 48, checkpoint_dir=d, checkpoint_every_chunks=1,
                                   source_token="tok")

    full = run(Word2VecTorch(params, device="cpu"))
    d = str(tmp_path / trainer)
    # fit: 1 call an epoch; fit_host: 3 slabs; fit_streaming: 3 chunks
    kill = {"fit": 2, "fit_host": 7, "fit_streaming": 4}[trainer]
    with pytest.raises(RuntimeError, match="simulated kill"):
        run(_kill_after(Word2VecTorch(params, device="cpu"), kill), d)
    calls.clear()
    resumed = run(Word2VecTorch(params, device="cpu"), d)
    for name in ("_emb_in", "_emb_out", "acc_in", "acc_out"):
        np.testing.assert_array_equal(getattr(resumed, name).numpy(),
                                      getattr(full, name).numpy(), err_msg=name)
    _assert_subsampled(resumed)
    first = {"fit": 2, "fit_host": 2, "fit_streaming": 0}[trainer]
    assert resumed.losses == full.losses[first:]
    if trainer == "fit_streaming":  # no counting pass: the 5 chunks after the snapshot
        rng = np.random.default_rng(1)
        orders = [list(rng.permutation(3)) for _ in range(3)]
        assert calls == orders[1][1:] + orders[2]


# --------------------------------------------------------------------------- #
# the pipeline's new branches and quality
# --------------------------------------------------------------------------- #


def test_host_corpus_pipeline_equals_fit_host(karate_edges, tmp_path):
    """Node2Vec(host_corpus=True).run_pipeline() walks to the host, drops
    the engine and trains with fit_host; with checkpoint_dir a second run
    resumes from the walk chunks and the train state."""
    kw = dict(n2v_params={"num_walks": 4, "walk_length": 8, "walker_chunk": 64},
              w2v_params={"vector_size": 32, "min_count": 1, "max_iter": 2, "sample": 1e-2},
              device="cpu")
    n2v = Node2Vec(host_corpus=True, checkpoint_dir=str(tmp_path), **kw)
    n2v.preprocess_input_graph(karate_edges, directed=False)
    model = n2v.run_pipeline()
    assert n2v._engine is None and n2v.walks.shape == (136, 9)
    plain = Node2Vec(**kw)
    plain.preprocess_input_graph(karate_edges, directed=False)
    np.testing.assert_array_equal(plain.random_walk(), n2v.walks)
    want = Word2VecTorch(model.params, device="cpu").fit_host(n2v.walks, n_vertices=34)
    np.testing.assert_array_equal(model.vectors, want.vectors)
    assert {"train_state.npz", "walks_chunk_000002.npz"} <= set(os.listdir(tmp_path))
    again = Node2Vec(host_corpus=True, checkpoint_dir=str(tmp_path), **kw)
    again.preprocess_input_graph(karate_edges, directed=False)
    np.testing.assert_array_equal(again.run_pipeline().vectors, model.vectors)


def test_streaming_pipeline_resumes_from_checkpoint(karate_edges, tmp_path):
    kw = dict(n2v_params={"num_walks": 4, "walk_length": 8, "walker_chunk": 64},
              w2v_params={"vector_size": 32, "min_count": 1, "max_iter": 2}, device="cpu")
    n2v = Node2Vec(checkpoint_dir=str(tmp_path), **kw)
    n2v.preprocess_input_graph(karate_edges, directed=False)
    model = n2v.run_pipeline()
    assert n2v.walks is None and os.path.exists(tmp_path / "stream_state.npz")
    ref = node2vec_tpu.Node2Vec(n2v_params=kw["n2v_params"], w2v_params=kw["w2v_params"])
    ref.preprocess_input_graph(karate_edges, directed=False)
    assert n2v._stream_source_token(n2v._walk_engine()) == \
        ref._stream_source_token(ref._walk_engine())
    again = Node2Vec(checkpoint_dir=str(tmp_path), **kw)
    again.preprocess_input_graph(karate_edges, directed=False)
    np.testing.assert_array_equal(again.run_pipeline().vectors, model.vectors)


def _quality_walks(g, seed=0):
    return WalkEngine(g, Node2VecParams(num_walks=6, walk_length=20), device="cpu").run(seed=seed)


@pytest.mark.parametrize("trainer", ["fit_streaming", "fit_host", "fit_sample"])
def test_multilabel_quality_close_to_jax(trainer):
    """Mean micro-F1@0.5 over trainer seeds 1-3 within 0.05 of the JAX
    trainer's on synthetic_multilabel(600), both on the same walks
    (bit-equal walks of the two engines, tests/test_torch_pipeline.py).
    One seed is not enough: the JAX trainer alone spans 0.80-0.84 there."""
    g, labels = synthetic_multilabel(600, seed=0)
    walks = _quality_walks(g)
    parts = np.array_split(walks, 4)  # fit_streaming: four chunks of the corpus
    scores = {"port": [], "jax": []}
    for seed in (1, 2, 3):
        kw = dict(min_count=1, max_iter=3, vector_size=32, seed=seed)
        if trainer == "fit_sample":
            kw["sample"] = 1e-3
        port = Word2VecTorch(Word2VecParams(**kw), device="cpu")
        ref = ref_w2v.Word2VecTPU(RefW2V(**kw))
        if trainer == "fit_streaming":
            port.fit_streaming(lambda i: torch.from_numpy(parts[i]), 4, g.n_vertices)
            ref.fit_streaming(lambda i: jnp.asarray(parts[i]), 4, g.n_vertices)
        elif trainer == "fit_host":
            port.fit_host(walks, n_vertices=g.n_vertices, slab_walks=1024)
            ref.fit_host(walks, n_vertices=g.n_vertices, slab_walks=1024)
        else:
            port.fit(walks, n_vertices=g.n_vertices)
            ref.fit(walks, n_vertices=g.n_vertices)
        for name, emb in (("port", port.vectors), ("jax", np.asarray(ref.emb_in))):
            scores[name].append(multilabel_f1(emb, labels, train_ratio=0.5)["micro_f1"])
    got, want = np.mean(scores["port"]), np.mean(scores["jax"])
    assert got >= 0.55, scores
    assert abs(got - want) <= 0.05, scores


def test_trainers_raise_for_unported_objectives():
    """optimizer="sgd" (SGNS's pre-aggregated SGD) no longer raises: the
    host-corpus and streaming trainers train with it, away from Adagrad."""
    walks = _corpus(64, 20, 6)
    for override in ({"optimizer": "sgd", "step_size": 0.025},):
        kw = dict(min_count=1, max_iter=2, vector_size=32, **override)
        for train in (lambda m: m.fit_host(walks),
                      lambda m: m.fit_streaming(lambda i: torch.from_numpy(walks), 1, 20)):
            model = train(Word2VecTorch(Word2VecParams(**kw), device="cpu"))
            ada = train(Word2VecTorch(Word2VecParams(min_count=1, max_iter=2, vector_size=32),
                                      device="cpu"))
            assert np.isfinite(model.vectors).all() and len(model.losses) == 2
            assert not np.allclose(model.vectors, ada.vectors)
