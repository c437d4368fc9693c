"""node2vec_torch's pair-based SGNS step (``sgns_train_step``, with
``make_pairs``), ``sgns_corpus_step`` and the fused-table step and epoch
against node2vec_tpu's on the CPU.

Both sides start from the same tables and take JAX's own draws, under the
JAX key splits: ``split(key, 3)`` into (negatives 1, negatives 2, shrink),
the pair step's shrink draw shaped [B, 1, L1] (skipgram.py:155, :199), the
positional and fused steps' [B, L1] (:351, :552), and the fused epoch keyed
``fold_in(key, gstep)`` (:645).  Tables, accumulators and loss are held to
rtol 1e-5, atol 1e-6: sums and scatters run in another order.  The batches
hold -1 tails, an all-dead walk, vertices outside the vocabulary and
repeated negatives (S > V); a walk of length 1 has no pair.  Dim 32: the
JAX package packs dim-64 tables."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from node2vec_tpu.models import skipgram as ref_sg
from node2vec_tpu.ops.alias import build_alias_csr
from node2vec_torch import convert
from node2vec_torch.models import skipgram as sg

RTOL, ATOL = 1e-5, 1e-6
V, D, B, L1, W, S, K = 40, 32, 24, 11, 5, 64, 5
LR = 0.05


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


def _batch(seed=0, n_walks=B, length=L1):
    """Walks with -1 tails and one all-dead walk, a vocabulary mask that
    leaves some vertices out, tables, accumulators and the noise table."""
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, V, (n_walks, length)).astype(np.int32)
    ends = rng.integers(1, length + 1, n_walks)
    walks[np.arange(length)[None, :] >= ends[:, None]] = -1
    walks[min(3, n_walks - 1)] = -1
    mask = rng.random(V) > 0.15
    tables = (rng.normal(0, 0.3, (V, D)).astype(np.float32),
              rng.normal(0, 0.3, (V, D)).astype(np.float32),
              rng.random(V).astype(np.float32), rng.random(V).astype(np.float32))
    alias, prob = build_alias_csr(np.array([0, V]), rng.random(V).astype(np.float32) + 0.1)
    return walks, mask, tables, alias, prob


def _pair_draws(key, n_walks, length):
    """(b [B, 1, L1], r1, r2) as sgns_train_step_impl draws them."""
    k_neg1, k_neg2, k_shrink = jax.random.split(key, 3)
    b = jax.random.randint(k_shrink, (n_walks, 1, length), 1, W + 1)
    return (_t(b.astype(jnp.int32)), _t(jax.random.uniform(k_neg1, (S,))),
            _t(jax.random.uniform(k_neg2, (S,))))


def _walk_draws(key, n_walks, length, shrink=True):
    """(b_sh [B, L1], r1, r2) as the positional and fused steps draw them."""
    k_neg1, k_neg2, k_shrink = jax.random.split(key, 3)
    if shrink:
        b_sh = jax.random.randint(k_shrink, (n_walks, length), 1, W + 1).astype(jnp.int32)
    else:
        b_sh = jnp.full((n_walks, length), W, jnp.int32)
    return (_t(b_sh), _t(jax.random.uniform(k_neg1, (S,))),
            _t(jax.random.uniform(k_neg2, (S,))))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------- #
# make_pairs and the pair step
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shrink", [True, False])
@pytest.mark.parametrize("length", [L1, 1])
def test_make_pairs_equals_jax(shrink, length):
    walks, mask, *_ = _batch(1, length=length)
    key = jax.random.PRNGKey(3)
    want = ref_sg.make_pairs(jnp.asarray(walks), key, jnp.asarray(mask), W, shrink)
    b = _t(jax.random.randint(key, (B, 1, length), 1, W + 1).astype(jnp.int32))
    got = sg.make_pairs(_t(walks), b if shrink else None, _t(mask), W)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
    assert got[2].shape == (B * 2 * W * length,)
    if length == 1:
        assert not bool(got[2].any())


@pytest.mark.parametrize("shrink", [True, False])
def test_sgns_train_step_matches_jax(shrink):
    walks, mask, tables, alias, prob = _batch(2)
    key = jax.random.PRNGKey(11)
    e_in, e_out, a_in, a_out, loss = ref_sg.sgns_train_step_impl(
        *map(jnp.asarray, tables), jnp.asarray(walks), key, jnp.float32(LR),
        jnp.asarray(alias), jnp.asarray(prob), jnp.asarray(mask),
        window=W, negatives=K, shared_negatives=S, shrink_window=shrink,
    )
    b, r1, r2 = _pair_draws(key, B, L1)
    state = [_t(a) for a in tables]
    pairs = torch.zeros((), dtype=torch.int64)
    got = sg.sgns_train_step(*state, _t(walks), b if shrink else None, r1, r2, LR, _t(alias),
                             _t(prob), _t(mask), window=W, negatives=K, pairs=pairs)
    for g, w in zip((*state, got), (e_in, e_out, a_in, a_out, loss)):
        _close(g, w)
    # the step adds its valid-lane count to ``pairs``
    valid = sg.make_pairs(_t(walks), b if shrink else None, _t(mask), W)[2]
    assert int(pairs) == int(valid.sum()) > 0
    # the plain path is the same function
    plain = [_t(a) for a in tables]
    loss_p = sg.sgns_train_step_plain(*plain, _t(walks), b if shrink else None, r1, r2, LR,
                                      _t(alias), _t(prob), _t(mask), window=W, negatives=K)
    for g, w in zip((*plain, loss_p), (*state, got)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_pair_grads_are_zero_on_invalid_lanes():
    walks, mask, tables, alias, prob = _batch(4)
    b, r1, r2 = _pair_draws(jax.random.PRNGKey(5), B, L1)
    centers, contexts = sg.pair_lists(_t(walks), b, _t(mask), W)
    neg = sg.negative_ids(r1, r2, _t(alias), _t(prob))
    d_ci, d_co, d_no, loss, pairs = sg.sgns_pair_grads(
        _t(tables[0]), _t(tables[1]), _t(walks), centers, contexts, neg, window=W, negatives=K)
    dead = centers < 0
    assert pairs.dtype == torch.float32 and int(pairs) == int((~dead).sum())
    assert bool(dead.any()) and bool((~dead).any())
    assert bool((contexts[dead] == -1).all())
    assert float(d_ci[dead].abs().max()) == 0.0 and float(d_co[dead].abs().max()) == 0.0
    assert d_no.shape == (S, D) and bool(torch.isfinite(loss))


# --------------------------------------------------------------------------- #
# sgns_corpus_step
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("offset", [8, 20])  # 20 + 16 > 30: the slice start clamps to 14
def test_sgns_corpus_step_matches_jax(offset):
    walks, mask, tables, alias, prob = _batch(6, n_walks=30)
    key = jax.random.PRNGKey(7)
    want = ref_sg._sgns_corpus_step_impl(
        *map(jnp.asarray, tables), jnp.asarray(walks), jnp.int32(offset), key,
        jnp.float32(LR), jnp.asarray(alias), jnp.asarray(prob), jnp.asarray(mask),
        batch=16, window=W, negatives=K, shared_negatives=S, shrink_window=True,
    )
    state = [_t(a) for a in tables]
    loss = sg.sgns_corpus_step(*state, _t(walks), offset, *_walk_draws(key, 16, L1), LR,
                               _t(alias), _t(prob), _t(mask), batch=16, window=W, negatives=K)
    for g, w in zip((*state, loss), want):
        _close(g, w)


# --------------------------------------------------------------------------- #
# the fused-table step and epoch
# --------------------------------------------------------------------------- #


def _fused(tables):
    e_in, e_out, a_in, a_out = tables
    return (np.concatenate([e_in, a_in[:, None]], axis=1),
            np.concatenate([e_out, a_out[:, None]], axis=1))


@pytest.mark.parametrize("shrink", [True, False])
def test_sgns_walk_step_fused_matches_jax(shrink):
    walks, mask, tables, alias, prob = _batch(8)
    f_in, f_out = _fused(tables)
    key = jax.random.PRNGKey(13)
    want = ref_sg.sgns_walk_step_fused_impl(
        jnp.asarray(f_in), jnp.asarray(f_out), jnp.asarray(walks), key, jnp.float32(LR),
        jnp.asarray(alias), jnp.asarray(prob), jnp.asarray(mask),
        window=W, negatives=K, shared_negatives=S, shrink_window=shrink,
    )
    t_in, t_out = convert.from_reference_fused(f_in, f_out, device="cpu")
    loss = sg.sgns_walk_step_fused(t_in, t_out, _t(walks), *_walk_draws(key, B, L1, shrink),
                                   LR, _t(alias), _t(prob), _t(mask), window=W, negatives=K)
    for g, w in zip((t_in, t_out, loss), want):
        _close(g, w)
    # the accumulator column moved, and only where the batch touched a row
    touched = np.unique(walks[walks >= 0])
    untouched = np.setdiff1d(np.arange(V), touched)
    np.testing.assert_array_equal(t_in[untouched].numpy(), f_in[untouched])


def test_sgns_epoch_fused_matches_jax():
    walks, mask, tables, alias, prob = _batch(9, n_walks=3 * 16)
    f_in, f_out = _fused(tables)
    key = jax.random.PRNGKey(17)
    lr0, slope, min_lr = 0.05, 1e-3, 1e-4
    want = ref_sg._sgns_epoch_fused_impl(
        jnp.asarray(f_in), jnp.asarray(f_out), jnp.asarray(walks), key, jnp.int32(5),
        jnp.float32(lr0), jnp.float32(slope), jnp.asarray(alias), jnp.asarray(prob),
        jnp.asarray(mask), batch=16, n_batches=3, window=W, negatives=K,
        shared_negatives=S, shrink_window=True, min_lr=min_lr,
    )
    t_in, t_out = convert.from_reference_fused(f_in, f_out, device="cpu")
    pairs = torch.zeros((), dtype=torch.int64)

    def draws(gstep):
        return _walk_draws(jax.random.fold_in(key, gstep), 16, L1)

    losses = sg.sgns_epoch_fused(
        t_in, t_out, _t(walks), draws, 5, lr0, slope, _t(alias), _t(prob), _t(mask), batch=16,
        n_batches=3, window=W, negatives=K, min_lr=min_lr, pairs=pairs,
    )
    assert losses.shape == (3,)
    for g, w in zip((t_in, t_out, losses), want):
        _close(g, w)
    # the epoch adds each step's valid-pair count, the pair step's lanes
    # under the same draws, to ``pairs``
    assert int(pairs) == sum(
        int(sg.make_pairs(_t(walks[16 * b: 16 * (b + 1)]), draws(5 + b)[0], _t(mask), W)[2].sum())
        for b in range(3))
    back = convert.to_reference_fused(t_in, t_out)
    assert back[0].dtype == np.float32 and back[0].shape == (V, D + 1)


def test_init_and_split_fused():
    t_in, t_out = sg.init_fused_embeddings(V, D, seed=3, device="cpu")
    e_in, e_out, a_in, a_out = sg.init_embeddings(V, D, seed=3, device="cpu")
    assert t_in.shape == (V, D + 1) and t_out.shape == (V, D + 1)
    for (emb, acc), (we, wa) in zip((sg.split_fused(t_in), sg.split_fused(t_out)),
                                    ((e_in, a_in), (e_out, a_out))):
        np.testing.assert_array_equal(emb.numpy(), we.numpy())
        np.testing.assert_array_equal(acc.numpy(), wa.numpy())
    # the JAX layout: vectors then the accumulator, so a JAX table splits the same way
    ref_in, _ = ref_sg.init_fused_embeddings(V, D, seed=3)
    r_emb, r_acc = ref_sg.split_fused(ref_in)
    p_emb, p_acc = sg.split_fused(convert.from_reference_fused(ref_in, ref_in, device="cpu")[0])
    np.testing.assert_array_equal(p_emb.numpy(), np.asarray(r_emb))
    np.testing.assert_array_equal(p_acc.numpy(), np.asarray(r_acc))
    with pytest.raises(ValueError):
        convert.from_reference_fused(np.zeros((V, D + 1)), np.zeros((V, D + 2)),
                                     device="cpu")


@pytest.mark.parametrize("make", [
    lambda: sg.init_embeddings(V, D),
    lambda: sg.init_fused_embeddings(V, D),
    lambda: convert.from_reference_state(*_batch()[2]),
    lambda: convert.from_reference_fused(*_fused(_batch()[2])),
    lambda: convert.blocked_graph_from_arrays(*[np.zeros((1, 128), np.int32)] * 4, 1, 64,
                                              False),
], ids=["init_embeddings", "init_fused_embeddings", "from_reference_state",
        "from_reference_fused", "blocked_graph_from_arrays"])
def test_tables_default_to_the_card(make):
    """The table builders put their tensors on the card unless given
    device="cpu": without CUDA they raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_sgns_grads_plain_with_a_row_stride_equals_the_positional_grads():
    """K2's plain version on [V, D+1] tables reading D columns is the
    positional step's gradient half on the [V, D] tables."""
    walks, mask, tables, alias, prob = _batch(10)
    f_in, f_out = _fused(tables)
    b_sh, r1, r2 = _walk_draws(jax.random.PRNGKey(19), B, L1)
    neg = sg.negative_ids(r1, r2, _t(alias), _t(prob))
    kw = dict(window=W, negatives=K)
    strided = sg.sgns_grads(_t(f_in), _t(f_out), _t(walks), _t(mask), b_sh, neg, dim=D, **kw)
    flat = sg.sgns_grads(_t(tables[0]), _t(tables[1]), _t(walks), _t(mask), b_sh, neg, **kw)
    for g, w in zip(strided, flat):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_fused_adagrad_reads_the_accumulator_from_before_the_batch():
    """A repeated row and a negative that is also a center each scale by
    their own square over acc0, never by the batch's other squares."""
    tab_in = torch.zeros((3, 3))
    tab_out = torch.zeros((3, 3))
    tab_out[:, 2] = 1.0
    g = torch.tensor([[1.0, 1.0], [3.0, 3.0]])
    rows = torch.tensor([1, 1], dtype=torch.int32)
    dead = torch.tensor([-1, -1], dtype=torch.int32)
    d_no = torch.tensor([[2.0, 2.0]])
    neg = torch.tensor([1], dtype=torch.int32)
    sg.fused_adagrad(tab_in, tab_out, g, rows, g, dead, d_no, neg, 0.5)
    # tab_in row 1: acc0 = 0, squares 1 and 9: -0.5 * (1 / 1 + 3 / 3) per column
    np.testing.assert_allclose(tab_in[1].numpy(), [-1.0, -1.0, 10.0], rtol=1e-6)
    # tab_out row 1: only the negative (the walk list is dead): acc0 1, square 4
    np.testing.assert_allclose(tab_out[1].numpy(), [-0.5 * 2 / np.sqrt(5.0)] * 2 + [5.0],
                               rtol=1e-6)
    assert float(tab_in[[0, 2]].abs().max()) == 0.0
