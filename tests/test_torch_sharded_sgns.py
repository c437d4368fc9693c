"""node2vec_torch's column-sharded SGNS (``parallel.sharded_sgns``,
``Word2VecTorch.fit_sharded``) against node2vec_tpu's on the CPU.

The port's ranks run in spawned processes over gloo
(``node2vec_torch.parallel.launch.spawn``, world sizes 1, 2 and 4), from
``tests/torch_mesh_ranks.py``, which imports no JAX; the JAX package runs
in this process on its 8 virtual CPU devices at the same mesh shapes.

``sharded_sgns_step`` at 1 × 1, 2 × 1, 1 × 2 and 2 × 2 and
``col_sgns_epoch`` start from JAX's state (``convert``'s column slices) and
take JAX's draws under its key splits: a step's key folded with the data
index, ``fold_in(key, d)``, then ``split(·, 3)`` into (negatives 1,
negatives 2, shrink), the shrink drawn [B / n_data, 1, L1]
(sharded_sgns.py:62-77); the epoch's step keys ``fold_in(key, gstep)`` and
each shard's shuffle ``permutation(fold_in(fold_in(key, 0x5F5E2), d))``
(:203-214).  Each rank's column slices, the accumulators and the losses are
held to rtol 1e-5, atol 1e-6 (sums and scatters in another order), as
tests/test_torch_pair_step.py holds the one-device pair step.  The batches
hold -1 tails, an all-dead walk and vertices out of the vocabulary.  Dim 32:
the JAX package packs dim-64 tables.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as Pspec

from node2vec_tpu.constants import Word2VecParams as RefW2V
from node2vec_tpu.models import Word2VecTPU
from node2vec_tpu.ops.alias import build_alias_csr
from node2vec_tpu.parallel import make_mesh as ref_make_mesh
from node2vec_tpu.parallel.sharded_sgns import (
    ShardedSGNSState as RefState,
    col_sgns_epoch as ref_col_sgns_epoch,
    sharded_sgns_step as ref_sharded_sgns_step,
)
from node2vec_torch.constants import Node2VecParams
from node2vec_torch.graph import from_edge_arrays
from node2vec_torch.models import skipgram as sg
from node2vec_torch.models.vocab import subsample_walks_plain
from node2vec_torch.parallel import launch, sharded_sgns
from node2vec_torch.walk import random_walks

import torch_mesh_ranks

RTOL, ATOL = 1e-5, 1e-6
V, D, B, L1, W, S, K = 40, 32, 8, 11, 5, 16, 5
LR, N_STEPS = 0.05, 3
STEP_SHAPES = {1: [(1, 1)], 2: [(2, 1), (1, 2)], 4: [(2, 2)]}
FIT_SHAPES = [(2, 1), (1, 2)]
EPOCH = dict(key=77, step0=5, lr0=0.05, lr_slope=0.001, min_lr=1e-4, n_batches=3)
W2V = dict(min_count=1, vector_size=32, max_iter=4, batch_walks=64, step_size=0.05)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mesh(shape):
    return ref_make_mesh(*shape, devices=jax.devices()[: shape[0] * shape[1]])


def _tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def _inputs(seed=0):
    """Walks with -1 tails and an all-dead walk, a vocabulary mask leaving
    some vertices out, tables, accumulators and the noise table."""
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, V, (B, L1)).astype(np.int32)
    ends = rng.integers(1, L1 + 1, B)
    walks[np.arange(L1)[None, :] >= ends[:, None]] = -1
    walks[3] = -1
    mask = rng.random(V) > 0.15
    tables = (rng.normal(0, 0.3, (V, D)).astype(np.float32),
              rng.normal(0, 0.3, (V, D)).astype(np.float32),
              rng.random(V).astype(np.float32), rng.random(V).astype(np.float32))
    alias, prob = build_alias_csr(np.array([0, V]), rng.random(V).astype(np.float32) + 0.1)
    corpus = rng.integers(-1, V, (EPOCH["n_batches"] * B, L1)).astype(np.int32)
    return walks, mask, tables, np.asarray(alias, np.int32), np.asarray(prob, np.float32), corpus


def _draws(key, n_data, b_local):
    """Each data index's (b [B / n_data, 1, L1], r1 [S], r2 [S]) under the
    JAX step's key splits."""
    out = []
    for d in range(n_data):
        k_neg1, k_neg2, k_shrink = jax.random.split(jax.random.fold_in(key, d), 3)
        out.append((np.asarray(jax.random.randint(k_shrink, (b_local, 1, L1), 1, W + 1),
                               np.int32),
                    np.asarray(jax.random.uniform(k_neg1, (S,))),
                    np.asarray(jax.random.uniform(k_neg2, (S,)))))
    return out


def _ref_state(mesh, tables):
    col = NamedSharding(mesh, Pspec(None, "model"))
    rep = NamedSharding(mesh, Pspec())
    return RefState(*(jax.device_put(jnp.asarray(t), col) for t in tables[:2]),
                    *(jax.device_put(jnp.asarray(t), rep) for t in tables[2:]))


def _jax_step_and_epoch(shape, inp):
    """JAX's N_STEPS steps on the batch and its epoch on the corpus at
    ``shape``, and the draws the port is given."""
    walks, mask, tables, alias, prob, corpus = inp
    mesh = _jax_mesh(shape)
    ns = (jnp.asarray(alias), jnp.asarray(prob), jnp.asarray(mask))
    kw = dict(window=W, negatives=K, shared_negatives=S, shrink_window=True)
    state = _ref_state(mesh, tables)
    losses, step_draws = [], [[] for _ in range(shape[0])]
    for k in range(N_STEPS):
        key = jax.random.PRNGKey(k)
        for d, dr in enumerate(_draws(key, shape[0], B // shape[0])):
            step_draws[d].append(dr)
        state, loss = ref_sharded_sgns_step(mesh, state, jnp.asarray(walks), key,
                                            jnp.float32(LR), *ns, **kw)
        losses.append(float(loss))
    step = ([np.asarray(t) for t in state], losses)
    key = jax.random.PRNGKey(EPOCH["key"])
    n_local = corpus.shape[0] // shape[0]
    perms = [np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.fold_in(key, 0x5F5E2), d), n_local)) for d in range(shape[0])]
    ep_draws = [{} for _ in range(shape[0])]
    for b in range(EPOCH["n_batches"]):
        gstep = EPOCH["step0"] + b
        for d, dr in enumerate(_draws(jax.random.fold_in(key, gstep), shape[0], B // shape[0])):
            ep_draws[d][gstep] = dr
    state, ep_losses = ref_col_sgns_epoch(
        mesh, _ref_state(mesh, tables),
        jax.device_put(jnp.asarray(corpus), NamedSharding(mesh, Pspec("data", None))), key,
        EPOCH["step0"], EPOCH["lr0"], EPOCH["lr_slope"], *ns, batch_local=B // shape[0],
        n_batches=EPOCH["n_batches"], min_lr=EPOCH["min_lr"], **kw)
    epoch = ([np.asarray(t) for t in state], np.asarray(ep_losses))
    port_case = dict(draws=ep_draws, perm=perms, corpus=corpus, step0=EPOCH["step0"],
                     lr0=EPOCH["lr0"], lr_slope=EPOCH["lr_slope"], min_lr=EPOCH["min_lr"],
                     n_batches=EPOCH["n_batches"], batch_local=B // shape[0])
    return step, epoch, step_draws, port_case


def _dump(tmp_path_factory, name, obj) -> str:
    path = str(tmp_path_factory.mktemp("sgns") / f"{name}.pkl")
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return path


def _karate_walks():
    src, dst = torch_mesh_ranks.karate()
    g = from_edge_arrays(src, dst, directed=False)
    return random_walks(g, Node2VecParams(num_walks=6, walk_length=10), seed=0, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's steps and epochs at every shape, and the ranks' (world 1, 2,
    4; world 2 runs the fit_sharded checks too), one spawn a world."""
    inp = _inputs()
    walks, mask, tables, alias, prob, _ = inp
    jax_out, step_draws, epochs = {}, {}, {}
    for shapes in STEP_SHAPES.values():
        for shape in shapes:
            step, epoch, step_draws[_tag(shape)], epochs[_tag(shape)] = \
                _jax_step_and_epoch(shape, inp)
            jax_out[_tag(shape)] = (step, epoch)
    step_path = _dump(tmp_path_factory, "step", dict(
        tables=tables, ns_alias=alias, ns_prob=prob, mask=mask, walks=walks, window=W,
        negatives=K, lr=LR, n_steps=N_STEPS, step_draws=step_draws, epoch=epochs,
        shapes=sum(STEP_SHAPES.values(), [])))
    # fit_sharded: JAX writes a checkpoint at epoch 1 for the port to resume
    kwalks = _karate_walks()
    jax_ckpt = str(tmp_path_factory.mktemp("jax_ckpt"))
    Word2VecTPU(RefW2V(**{**W2V, "max_iter": 1}), shared_negatives=16).fit_sharded(
        kwalks, _jax_mesh((2, 1)), n_vertices=34, checkpoint_dir=jax_ckpt)
    rng = np.random.default_rng(5)
    fit_path = _dump(tmp_path_factory, "fit", dict(
        walks=kwalks, n_vertices=34, w2v=W2V, shapes=FIT_SHAPES, jax_ckpt=jax_ckpt,
        jax_ckpt_epoch=1, port_ckpt=str(tmp_path_factory.mktemp("port_ckpt")),
        sub_corpus=rng.integers(-1, 30, (64, 9)).astype(np.int32),
        keep=rng.random(30).astype(np.float32)))
    ranks = {}
    for world in STEP_SHAPES:
        calls = [("col_step_and_epoch", step_path)]
        if world == 2:
            calls.append(("fit_sharded_checks", fit_path))
        ranks[world] = launch.spawn(torch_mesh_ranks.programs, world, "gloo", "cpu", calls,
                                    timeout=600)
    fit = [r[1] for r in ranks[2]]
    return dict(jax=jax_out, ranks={w: [r[0] for r in rs] for w, rs in ranks.items()},
                fit=fit, fit_case=pickle.load(open(fit_path, "rb")), kwalks=kwalks)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _check_state(got, want, coords, shape):
    """A rank's column slices of the tables and its accumulators."""
    m, dm = coords["model"], D // shape[1]
    for i, name in enumerate(("emb_in", "emb_out")):
        _close(got[i], want[i][:, m * dm: (m + 1) * dm], name)
    _close(got[2], want[2], "acc_in")
    _close(got[3], want[3], "acc_out")


ALL_SHAPES = sum(STEP_SHAPES.values(), [])


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=_tag)
def test_sharded_step_matches_jax(runs, shape):
    (want_state, want_losses), _ = runs["jax"][_tag(shape)]
    ranks = runs["ranks"][shape[0] * shape[1]]
    for res in (r[_tag(shape)] for r in ranks):
        state, losses, pairs = res["step"]
        _check_state(state, want_state, res["coords"], shape)
        _close(np.asarray(losses), np.asarray(want_losses), "losses")
        assert pairs > 0


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=_tag)
def test_col_sgns_epoch_matches_jax(runs, shape):
    _, (want_state, want_losses) = runs["jax"][_tag(shape)]
    ranks = runs["ranks"][shape[0] * shape[1]]
    for res in (r[_tag(shape)] for r in ranks):
        state, losses = res["epoch"]
        _check_state(state, want_state, res["coords"], shape)
        _close(losses, want_losses, "epoch losses")
        for got, want in zip(res["full"], want_state):  # gathered over the model axis
            _close(got, want, "gathered state")


def test_plain_col_kernels_at_one_model_rank_equal_the_pair_step():
    """At n_model = 1 K16's then K17's plain versions are K13's
    (sgns_pair_grads_plain): the same gradients, d_no and loss, with each
    row's sum of squares; K3's squares mode over them is K3."""
    walks, mask, (e_in, e_out, a_in, a_out), alias, prob, _ = _inputs(1)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    walks, mask = t(walks), t(mask)
    e_in, e_out = t(e_in), t(e_out)
    rng = np.random.default_rng(2)
    b_sh = t(rng.integers(1, W + 1, (B, L1)).astype(np.int32))
    neg_ids = sg.negative_ids(t(rng.random(S).astype(np.float32)),
                              t(rng.random(S).astype(np.float32)), t(alias), t(prob))
    centers, contexts = sg.pair_lists_plain(walks, b_sh, mask, W)
    logits = sharded_sgns.col_pair_logits_plain(e_in, e_out, walks, centers, contexts, neg_ids,
                                                window=W)
    n = centers.shape[0]
    assert logits.shape == (n + B * L1 * S,)
    d_ci, d_co, d_no, sq, parts = sharded_sgns.col_pair_grads_plain(
        e_in, e_out, walks, centers, contexts, neg_ids, logits, window=W, negatives=K)
    w_ci, w_co, w_no, w_loss, w_pairs = sg.sgns_pair_grads_plain(
        e_in, e_out, walks, centers, contexts, neg_ids, window=W, negatives=K)
    for got, want, name in ((d_ci, w_ci, "d_ci"), (d_co, w_co, "d_co"), (d_no, w_no, "d_no")):
        _close(got.numpy(), want.numpy(), name)
    loss = -(parts[0] + K / S * parts[1]) / torch.clamp(parts[2], min=1.0)
    _close(float(loss), float(w_loss), "loss")
    assert float(parts[2]) == float(w_pairs) > 0
    _close(sq.numpy(), torch.cat([(w_ci ** 2).sum(1), (w_co ** 2).sum(1),
                                  (w_no ** 2).sum(1)]).numpy(), "squares")
    got = [torch.from_numpy(a_in.copy()), torch.from_numpy(a_out.copy())]
    want = [torch.from_numpy(a_in.copy()), torch.from_numpy(a_out.copy())]
    sg.adagrad_accumulate_squares_plain(*got, sq[:n], centers, sq[n: 2 * n], contexts,
                                        sq[2 * n:], neg_ids, D)
    sg.adagrad_accumulate_plain(*want, w_ci, centers, w_co, contexts, w_no, neg_ids)
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy(), "accumulators")


def test_fit_sharded_trains_and_keeps_replicas_equal(runs):
    """fit_sharded at 2 × 1 and 1 × 2 (tests/test_sharded.py:161-180): one
    finite, falling loss an epoch, the same full tables on every rank."""
    for shape in FIT_SHAPES:
        results = [r[_tag(shape)] for r in runs["fit"]]
        losses, vectors, emb_out = results[0]["fit"]
        assert len(losses) == W2V["max_iter"] and all(np.isfinite(losses))
        assert losses[-1] < losses[0]
        assert vectors.shape == emb_out.shape == (34, 32) and np.isfinite(vectors).all()
        for res in results[1:]:
            np.testing.assert_array_equal(res["fit"][1], vectors)
            np.testing.assert_array_equal(res["fit"][2], emb_out)
        sampled = results[0]["sampled"]
        assert len(sampled) == 2 and all(np.isfinite(sampled))


def test_fit_sharded_keeps_the_jax_guards(runs):
    for shape in FIT_SHAPES:
        guards = runs["fit"][0][_tag(shape)]["guards"]
        assert "skip-gram only" in guards["cbow"]
        assert "requires table_sharding='row'" in guards["hs_column"]
        for name in ("hs_row", "row"):  # the row layout trains (SGNS and HS)
            assert len(guards[name]) == W2V["max_iter"] and all(np.isfinite(guards[name]))
        if shape[1] > 1:
            assert "not divisible by model axis 2" in guards["dim"]


def test_k7_with_a_base_equals_k7_on_the_whole_corpus(runs):
    """Each data shard subsampling its rows from their flat position draws
    what K7 draws on the whole corpus (the single-device base 0)."""
    case = runs["fit_case"]
    want = subsample_walks_plain(torch.from_numpy(case["sub_corpus"]),
                                 torch.from_numpy(case["keep"]), 7, 2_500_003).numpy()
    for shape in FIT_SHAPES:
        n_local = want.shape[0] // shape[0]
        got = [r[_tag(shape)]["k7"] for r in runs["fit"]]
        for rank, block in enumerate(got):
            d = rank // shape[1]
            np.testing.assert_array_equal(block, want[d * n_local: (d + 1) * n_local])
    assert (want == -1).sum() > (case["sub_corpus"] == -1).sum()


def test_checkpoints_cross_packages_both_ways(runs):
    """A train state written by JAX's fit_sharded resumes in the port (with
    no epoch left, the tables are the file's; with one more, training goes
    on), and the port's resumes in JAX's fit_sharded."""
    case = runs["fit_case"]
    saved = np.load(os.path.join(case["jax_ckpt"], "train_state.npz"))
    keys = [k for k in saved.files if k.startswith(("emb", "acc"))]
    assert sorted(keys) == ["acc_in", "acc_out", "emb_in", "emb_out"]
    for shape in FIT_SHAPES:
        for res in (r[_tag(shape)] for r in runs["fit"]):
            for got, key in zip(res["resumed"], ("emb_in", "emb_out", "acc_in", "acc_out")):
                np.testing.assert_array_equal(got, saved[key])
            more = res["resumed_more"]
            assert len(more) == 1 and np.isfinite(more[0])
        port_dir, emb_in, emb_out = runs["fit"][0][_tag(shape)]["written"]
        ref = Word2VecTPU(RefW2V(**{**W2V, "max_iter": 1}), shared_negatives=16)
        ref.fit_sharded(runs["kwalks"], _jax_mesh(shape), n_vertices=34,
                        checkpoint_dir=port_dir)
        np.testing.assert_array_equal(np.asarray(ref.emb_in), emb_in)
        np.testing.assert_array_equal(np.asarray(ref.emb_out), emb_out)
