"""node2vec_torch.ops.alias against node2vec_tpu.ops.alias on the CPU (the
counterpart of tests/test_alias.py).

The host table constructors give the JAX package's tables (the reference's goldens,
and equal tables on random weights); the scalar draws give its draws; the
batched ``alias_draw``, handed the uniforms JAX's own ``split(key)`` draws
(ops/alias.py:185-190), is bit-equal to JAX's on every walker with a
neighbour, over degrees 0, 1 and up to 40 with general weights, and -1
where the degree is 0 (JAX returns an unspecified id there).  A chi-square
test holds the draw frequencies to the weights."""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from node2vec_tpu import native as ref_native
from node2vec_tpu.ops import alias as ref_alias
from node2vec_torch.ops import alias


def _ref_native_loaded(deadline_s: float = 120.0) -> None:
    """Load the JAX package's native library, waiting out a concurrent build
    (as in tests/test_torch_blocked.py: its loader compiles the library in
    place, and another xdist worker may still be writing it)."""
    t_end = time.monotonic() + deadline_s
    while not ref_native.available():
        if time.monotonic() > t_end:
            pytest.fail(f"{ref_native._LIB_PATH} did not load within {deadline_s:.0f} s")
        time.sleep(0.5)
        ref_native._tried = False


@pytest.mark.parametrize(
    "weights,exp_alias,exp_probs",
    [
        ([0.5, 0.8, 1.0], [2, 0, 1], [0.6521739, 1.0, 0.9565217]),
        ([0.5, 0.2], [0, 0], [1.0, 0.5714285714285715]),
        ([0.2], [0], [1.0]),
        ([], [], []),
    ],
)
def test_generate_alias_tables_golden(weights, exp_alias, exp_probs):
    got = alias.generate_alias_tables(weights)
    assert got[0] == exp_alias
    np.testing.assert_almost_equal(got[1], exp_probs, decimal=7)
    assert got == ref_alias.generate_alias_tables(weights)


def test_generate_alias_tables_equal_jax_on_random_weights():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 33):
        w = (rng.random(n) + 0.01).tolist()
        assert alias.generate_alias_tables(w) == ref_alias.generate_alias_tables(w)
    with pytest.raises(ValueError):
        alias.generate_alias_tables([0.0, 0.0])


@pytest.mark.parametrize(
    "src_id,shd_ids,dst_nbs,p,q",
    [
        (0, {2}, ([0, 2], [0.5, 0.2]), 1.0, 1.0),
        (1, set(), ([1], [0.2]), 0.8, 1.5),
        (3, set(), ([1, 3], [0.5, 1.0]), 2.0, 4.0),
        (4, {1, 5}, ([1, 2, 4, 5, 9], [0.5, 1.0, 2.0, 0.25, 3.0]), 0.25, 4.0),
    ],
)
def test_generate_edge_alias_tables_equal_jax(src_id, shd_ids, dst_nbs, p, q):
    got = alias.generate_edge_alias_tables(src_id, shd_ids, dst_nbs, p, q)
    assert got == ref_alias.generate_edge_alias_tables(src_id, shd_ids, dst_nbs, p, q)


def test_generate_edge_alias_tables_errors():
    pytest.raises(ValueError, alias.generate_edge_alias_tables, 0, set(), ([0], [1.0]), 0)
    pytest.raises(ValueError, alias.generate_edge_alias_tables, 0, set(), ([0], [1.0]), 1.0, 0)
    pytest.raises(ValueError, alias.generate_edge_alias_tables, 0, set(), ([0, 1], [1.0]))


def test_scalar_draws_equal_jax():
    a, pr = alias.generate_alias_tables([0.5, 0.8, 1.0, 2.0, 0.1])
    for r1 in np.linspace(0.0, 0.999, 37):
        assert alias.alias_draw_single_wiki(a, pr, r1) == ref_alias.alias_draw_single_wiki(
            a, pr, r1)
        for r2 in (0.0, 0.3, 0.7, 0.99):
            assert alias.alias_draw_single(a, pr, r1, r2) == ref_alias.alias_draw_single(
                a, pr, r1, r2)


def _csr(seed=0, n_vertices=200):
    """A CSR with degrees 0, 1 and up to 40, general weights, its alias
    tables and one walker per vertex and per repeat."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 41, n_vertices)
    deg[:5] = 0
    deg[5:10] = 1
    indptr = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n_vertices, int(indptr[-1])).astype(np.int32)
    weights = (rng.random(int(indptr[-1])) * 3 + 0.05).astype(np.float32)
    a, pr = alias.build_alias_csr(indptr, weights)
    return indptr, indices, weights, a, pr


def test_alias_draw_bit_equal_to_jax():
    _ref_native_loaded()  # both packages build the tables natively
    indptr, indices, weights, a, pr = _csr()
    ref_a, ref_pr = ref_alias.build_alias_csr(indptr, weights)
    np.testing.assert_array_equal(a, ref_a)
    np.testing.assert_array_equal(pr, ref_pr)
    verts = np.tile(np.arange(len(indptr) - 1), 50)
    start = indptr[verts].astype(np.int32)
    degree = np.diff(indptr)[verts].astype(np.int32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(ref_alias.alias_draw(key, jnp.asarray(start), jnp.asarray(degree),
                                           jnp.asarray(a), jnp.asarray(pr),
                                           jnp.asarray(indices)))
    k1, k2 = jax.random.split(key)
    r1 = np.asarray(jax.random.uniform(k1, start.shape))
    r2 = np.asarray(jax.random.uniform(k2, start.shape))
    got = alias.alias_draw(*(torch.from_numpy(np.array(x)) for x in (start, degree, r1, r2, a,
                                                                     pr, indices))).numpy()
    live = degree > 0
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[live], want[live])
    assert bool((got[~live] == -1).all())
    # a degree-1 walker always takes its one neighbour
    one = degree == 1
    np.testing.assert_array_equal(got[one], indices[start[one]])


def test_alias_draw_distribution():
    """Draw frequencies match the weights (chi-square)."""
    from scipy import stats

    weights = np.array([0.5, 1.0, 2.0, 4.0, 0.25], dtype=np.float32)
    indptr = np.array([0, 5], dtype=np.int64)
    a, pr = alias.build_alias_csr(indptr, weights)
    n = 40_000
    rng = np.random.default_rng(1)
    got = alias.alias_draw(
        torch.zeros(n, dtype=torch.int32), torch.full((n,), 5, dtype=torch.int32),
        torch.from_numpy(rng.random(n, dtype=np.float32)),
        torch.from_numpy(rng.random(n, dtype=np.float32)), torch.from_numpy(a),
        torch.from_numpy(pr), torch.arange(5, dtype=torch.int32),
    )
    counts = np.bincount(got.numpy(), minlength=5)
    expected = weights.astype(np.float64) / weights.sum() * n
    assert stats.chisquare(counts, expected).pvalue > 1e-4, counts
