"""The baselines under partial participation against the reference's
(tests/test_torch_baselines.py holds the helpers)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as rb
from repro_torch import prng
from repro_torch.core import baselines as tb

from test_torch_baselines import (G, KEY0, LINEAR, ROUND_TOL, _assert_close,
                                  _both, _linear_batch, _linear_params,
                                  _r_linear, _t_linear, _to_port)
from torch_priority import lower_priority  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", ["topk_ef", "cocktail", "onebit_adam", "fetchsgd"])
def test_partial_participation_matches_reference(name):
    """Under a cohort mask the unsampled clients' error memories stay
    frozen (bit for bit their input), and the round is the reference's."""
    rcfg, tcfg = _both(name=name, **{**LINEAR[name], "onebit_warmup": 1})
    mask = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    rparams = _linear_params()
    rstate = rb.init_baseline_state(rcfg, rparams, G)
    rj = jax.jit(functools.partial(rb.baseline_round, rcfg, _r_linear))
    for t in range(3):
        batch = _linear_batch(t, rcfg.local_steps)
        tparams, tstate, _ = tb.baseline_round(
            tcfg, _t_linear, _to_port(rparams), _to_port(rstate), _to_port(batch),
            prng.key(KEY0 + t), part_mask=torch.from_numpy(mask))
        before = rstate
        rparams, rstate, _ = rj(rparams, rstate, batch, jax.random.key(KEY0 + t),
                                part_mask=jnp.asarray(mask))
        _assert_close(tparams, rparams, f"round {t} params", **ROUND_TOL)
        _assert_close(tstate, rstate, f"round {t} state", **ROUND_TOL)
        if "err" in before:
            frozen = tstate["err"]["W"][mask == 0].numpy()
            np.testing.assert_array_equal(frozen, np.asarray(before["err"]["W"])[mask == 0])
