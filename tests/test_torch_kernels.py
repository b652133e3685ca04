"""The port's kernel functions against the reference's kernels.

On the CPU the port's wrappers (``repro_torch.kernels.ops``) run the plain
PyTorch versions; they are held here against the reference's Pallas
kernels in interpret mode (small shapes: interpret mode is slow) and
against the ``repro.kernels.ref`` oracles at the shapes of
tests/test_kernels.py.  The CUDA kernels themselves run only on a card
(tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import ops

torch.set_num_threads(2)

# float32 segment sums of the same terms in another order: a few ulps of
# the slot's absolute sum (inputs are unit normals, slots sum <= 625 terms)
CS_TOL = dict(rtol=1e-5, atol=1e-4)


def _cs_inputs(g, n, b, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(g, n).astype(np.float32),
            rng.randint(0, b, n).astype(np.int32))


@pytest.mark.parametrize("n", [17, 1000, 1024, 5000])
@pytest.mark.parametrize("b", [8, 128, 300, 2049, 4096])
def test_countsketch_vs_ref(n, b):
    x, h = _cs_inputs(1, n, b, n + b)
    want = np.asarray(ref.countsketch_ref(jnp.asarray(x[0]), jnp.asarray(h), b))
    got = ops.countsketch(torch.from_numpy(x[0]), torch.from_numpy(h), b)
    np.testing.assert_allclose(got.numpy(), want, **CS_TOL)
