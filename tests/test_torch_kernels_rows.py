"""The kernels' plain versions over rows against the reference's Pallas
kernels in interpret mode (tests/test_torch_kernels.py holds the helpers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.countsketch import countsketch_clients_pallas
from repro.kernels.fwht import fwht_pallas, fwht_rows_pallas
from repro_torch.kernels import fwht as fw
from repro_torch.kernels import ops

from test_torch_kernels import CS_TOL, _cs_inputs
from torch_priority import lower_priority  # noqa: F401 (autouse)


@pytest.mark.parametrize("g,n,b", [(1, 100, 16), (3, 700, 40)])
def test_countsketch_clients_vs_pallas_interpret(g, n, b):
    x, h = _cs_inputs(g, n, b, g + n)
    want = np.asarray(countsketch_clients_pallas(jnp.asarray(x), jnp.asarray(h), b))
    got = ops.countsketch_clients(torch.from_numpy(x), torch.from_numpy(h), b)
    np.testing.assert_allclose(got.numpy(), want, **CS_TOL)


@pytest.mark.parametrize("g,n,b", [(5, 2000, 64), (9, 1500, 3000)])
def test_countsketch_clients_vs_ref_rows(g, n, b):
    x, h = _cs_inputs(g, n, b, g * n)
    want = np.stack([np.asarray(ref.countsketch_ref(jnp.asarray(r),
                                                    jnp.asarray(h), b))
                     for r in x])
    got = ops.countsketch_clients(torch.from_numpy(x), torch.from_numpy(h), b)
    np.testing.assert_allclose(got.numpy(), want, **CS_TOL)


@pytest.mark.parametrize("shape", [(1, 8), (3, 64), (9, 256)])
def test_fwht_rows_vs_pallas_interpret(shape):
    x = np.random.RandomState(shape[1]).randn(*shape).astype(np.float32)
    want = np.asarray(fwht_rows_pallas(jnp.asarray(x)))
    got = ops.fwht_rows(torch.from_numpy(x)).numpy()
    # the same butterfly additions in the same order: bit for bit
    np.testing.assert_array_equal(got, want)


def test_fwht_kronecker_vs_pallas_interpret():
    x = np.random.RandomState(3).randn(8192).astype(np.float32)
    want = np.asarray(fwht_pallas(jnp.asarray(x)))
    got = ops.fwht(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 8), (9, 4096), (20, 512), (4, 2048)])
def test_fwht_rows_vs_ref(shape):
    x = np.random.RandomState(shape[0] * shape[1]).randn(*shape).astype(np.float32)
    got = ops.fwht_rows(torch.from_numpy(x)).numpy()
    # float64 oracle vs float32 butterflies: log2(C) rounding steps
    np.testing.assert_allclose(got, ref.fwht_ref(x), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n", [8192, 32768])
def test_fwht_long_vs_ref_and_involution(n):
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    got = ops.fwht(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref.fwht_ref(x), rtol=1e-4, atol=1e-3)
    back = ops.fwht(got) / n                     # H(Hx) = n x
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-4, atol=1e-4)


def test_fwht_rejects_beyond_kronecker_limit():
    with pytest.raises(ValueError):
        ops.fwht_rows(torch.empty((1, 2 * fw.MAX_N), device="meta"))
