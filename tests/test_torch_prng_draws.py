"""``permutation``, ``choice``, ``uniform`` and ``rademacher`` bit for bit
against jax (tests/test_torch_prng.py holds the helpers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

from test_torch_prng import SEEDS
from torch_priority import lower_priority  # noqa: F401 (autouse)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (333,), (3, 7, 5), (4096,)])
def test_uniform_rademacher_bitwise(seed, shape):
    jk = jax.random.fold_in(jax.random.key(seed), 5)
    pk = prng.fold_in(prng.key(seed), 5)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = prng.uniform(pk, shape, "cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    want = np.asarray(jax.random.rademacher(jk, shape, dtype=jnp.float32))
    np.testing.assert_array_equal(prng.rademacher(pk, shape, "cpu").numpy(), want)
    want = np.asarray(jax.random.bits(jk, shape, dtype=jnp.uint32))
    np.testing.assert_array_equal(prng.random_bits(pk, shape, "cpu").numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("n", [1, 2, 1000, 90_432, 1 << 20])
def test_permutation_and_choice_without_replacement_bitwise(n):
    """jax's shuffle: rounds of a sort by fresh 32-bit keys (two rounds at
    n = 2**20, where ~128 keys of a round tie and the sort's stability
    decides their order; the test asserts ties occur)."""
    jk = jax.random.fold_in(jax.random.key(3), n)
    pk = prng.fold_in(prng.key(3), n)
    want = np.asarray(jax.random.permutation(jk, n))
    got = prng.permutation(pk, n, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(n))
    if n == 1 << 20:
        keys = prng.random_bits(prng.split(pk)[1], (n,), "cpu")
        assert n - torch.unique(keys).numel() > 50          # tied keys
    for m in ([n // 20] if n == 1 << 20 else sorted({1, max(1, n // 20), n})):
        want = np.asarray(jax.random.choice(jk, n, (m,), replace=False))
        got = prng.choice(pk, n, (m,), "cpu").numpy()
        np.testing.assert_array_equal(got, want)
