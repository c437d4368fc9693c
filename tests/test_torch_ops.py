"""node2vec_torch.ops against node2vec_tpu.ops on the CPU: the counter hash
is bit-equal, prefix sums are exact on dyadic rows, and the host alias
tables are equal (native and numpy paths)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from node2vec_tpu.ops import alias as ref_alias
from node2vec_tpu.ops import hashrng as ref_hash
from node2vec_tpu.ops.sampling import prefix_sums as ref_prefix_sums
from node2vec_torch.ops import alias, hashrng
from node2vec_torch.ops.sampling import prefix_sums

GIDS = np.arange(100_000, dtype=np.int32)


@pytest.mark.parametrize("seed", [0, 7, 123456789, 0xFFFFFFFF])
def test_hash_bits_and_uniform_bit_equal(seed):
    """Tolerance: none — bits and uniforms must be identical."""
    g = torch.from_numpy(GIDS)
    for ctr in (0, 1, 19, 2**31 + 5, 2**32 - 1):
        want = np.asarray(ref_hash.hash_bits(jnp.uint32(seed), jnp.asarray(GIDS), ctr))
        got = hashrng.hash_bits(seed, g, ctr).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64), err_msg=f"ctr={ctr}")
        want_u = np.asarray(ref_hash.hash_uniform(jnp.uint32(seed), jnp.asarray(GIDS), ctr))
        got_u = hashrng.hash_uniform(seed, g, ctr).numpy()
        assert got_u.dtype == np.float32
        np.testing.assert_array_equal(got_u, want_u, err_msg=f"ctr={ctr}")


def test_hash_counter_tensor_and_fmix32():
    """Counters may be tensors; fmix32 alone is bit-equal too (no tolerance)."""
    x = np.random.default_rng(0).integers(0, 2**32, 50_000, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(ref_hash.fmix32(jnp.asarray(x)))
    got = hashrng.fmix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    ctr = np.arange(50, dtype=np.uint32)
    want = np.asarray(ref_hash.hash_bits(jnp.uint32(3), jnp.asarray(GIDS[:50]), jnp.asarray(ctr)))
    got = hashrng.hash_bits(3, torch.from_numpy(GIDS[:50]), torch.from_numpy(ctr.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("width", [8, 64, 256])
def test_prefix_sums_exact_on_dyadic_rows(width):
    """Dyadic entries make every partial sum exact: equal to the float64
    cumsum and to the JAX matmul/cumsum prefix sums, bit for bit."""
    rng = np.random.default_rng(width)
    x = rng.choice(np.float32([0.0, 0.125, 0.5, 1.0, 2.0, 8.0]), (300, width))
    got = prefix_sums(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.cumsum(x.astype(np.float64), axis=1).astype(np.float32))
    np.testing.assert_array_equal(got, np.asarray(ref_prefix_sums(jnp.asarray(x))))


def _random_csr(seed):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 12, 60)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    weights = rng.random(int(indptr[-1])).astype(np.float32) + 0.05
    return indptr, weights


def test_alias_tables_equal_native():
    indptr, weights = _random_csr(1)
    got = alias.build_alias_csr(indptr, weights)
    want = ref_alias.build_alias_csr(indptr, weights)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_alias_tables_equal_numpy_fallback():
    indptr, weights = _random_csr(2)
    got = alias._build_alias_csr_numpy(indptr, weights)
    want = ref_alias._build_alias_csr_numpy(indptr, weights)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
