"""repro_torch.prng against jax.random: every stream bit for bit.

The port's sketch operators and batches are only the reference's if the
threefry2x32 streams agree exactly, so every comparison here is bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from repro_torch import prng

torch.set_num_threads(2)

SEEDS = [0, 42, 2**31 + 5]


def _kd(k) -> tuple:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bitwise(seed):
    jk, pk = jax.random.key(seed), prng.key(seed)
    assert _kd(jk) == pk
    for data in (0, 1, 7, 123456, 2**32 - 1):
        assert _kd(jax.random.fold_in(jk, data)) == prng.fold_in(pk, data)
    jk, pk = jax.random.fold_in(jk, 3), prng.fold_in(pk, 3)
    for num in (1, 2, 5, 127):
        got = prng.split(pk, num)
        want = [tuple(int(w) for w in r)
                for r in np.asarray(jax.random.key_data(jax.random.split(jk, num)))]
        assert got == want


@pytest.mark.parametrize("seed", SEEDS[1:])
@pytest.mark.parametrize("span", [1, 2, 7, 64, 300, 65537, 1000003, 2**20,
                                  30592, 2**31 - 1])
def test_randint_bitwise(seed, span):
    jk = jax.random.fold_in(jax.random.key(seed), 11)
    pk = prng.fold_in(prng.key(seed), 11)
    want = np.asarray(jax.random.randint(jk, (1001,), 0, span))
    got = prng.randint(pk, (1001,), 0, span, "cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_uniform_many_matches_per_key():
    pk = prng.fold_in(prng.key(9), 2)
    keys = prng.split(pk, 6)
    jks = jax.random.split(jax.random.fold_in(jax.random.key(9), 2), 6)
    want = np.stack([np.asarray(jax.random.uniform(k, (4, 3))) for k in jks])
    got = prng.uniform_many(keys, (4, 3), "cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_key_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        prng.key(-1)


@pytest.mark.parametrize("p", [0.1, 0.25, 1 / 3, 0.999])
@pytest.mark.parametrize("shape", [(), (7,), (3, 50), (100_000,)])
def test_bernoulli_bitwise(p, shape):
    """``uniform < float32(p)``; shape () is MARINA's one draw a round."""
    for seed in (1, 12):
        jk = jax.random.fold_in(jax.random.key(seed), 2)
        pk = prng.fold_in(prng.key(seed), 2)
        want = np.asarray(jax.random.bernoulli(jk, p, shape))
        got = prng.bernoulli(pk, p, shape, "cpu").numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_choice_shape_and_limit():
    pk = prng.key(5)
    assert prng.choice(pk, 4, (2, 2), "cpu").shape == (2, 2)
    with pytest.raises(ValueError):
        prng.choice(pk, 3, (4,), "cpu")
