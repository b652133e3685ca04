"""Every config's parameter shapes, counts and init rules against the
reference's (tests/test_torch_configs.py holds the helpers)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R
import repro_torch.configs as T
from repro.models import count_params_analytic as r_count
from repro.models import init_params as r_init
from repro_torch.models.model import count_params_analytic as t_count
from repro_torch.models.model import init_params as t_init
from repro_torch.models.model import param_shapes as t_shapes

from test_torch_configs import _paths
from torch_priority import lower_priority  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_param_shapes_and_counts_match_reference(arch):
    """``param_shapes`` of the full config against the reference's
    ``jax.eval_shape`` of its init, keys in order and dtypes; the analytic
    counts, total and active."""
    rc, tc = R.get_config(arch), T.get_config(arch)
    want = _paths(jax.eval_shape(lambda: r_init(rc, jax.random.key(0))))
    got = t_shapes(tc)
    assert list(got) == list(want)
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    assert {v.dtype for v in want.values()} == {jnp.dtype(rc.dtype)}
    for active in (False, True):
        assert t_count(tc, active_only=active) == r_count(rc, active_only=active)
    assert tc.param_count() == rc.param_count()
    assert tc.active_param_count() == rc.active_param_count()


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "deepseek_v3_671b",
                                  "whisper_large_v3", "llama3_2_1b"])
def test_init_rules_match_reference(arch):
    """The deterministic leaves (norm scales, biases, the SSM's D skip,
    conv bias, dt bias and A log) equal the reference's; the random ones
    have its dtype, a zero mean and its scale (the port draws its own
    numbers)."""
    rc = dataclasses.replace(R.get_config(arch, smoke=True), dtype=jnp.bfloat16)
    tc = dataclasses.replace(T.get_config(arch, smoke=True), dtype=torch.bfloat16)
    want = _paths(jax.jit(lambda: r_init(rc, jax.random.key(0)))())
    got = t_init(tc, torch.Generator().manual_seed(0), device="cpu")
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.bfloat16, k
        w32 = np.asarray(w, np.float32)
        g32 = g.to(torch.float32).numpy()
        if np.all(w32 == w32.reshape(-1)[0]) or k.endswith("a_log"):
            np.testing.assert_array_equal(g32, w32, err_msg=k)
        else:
            # scale to 15% (each leaf has >= 256 draws), mean within 4 sigma
            assert abs(g32.std() / w32.std() - 1) < 0.15, k
            assert abs(g32.mean()) < 4 * w32.std() / np.sqrt(w32.size), k
