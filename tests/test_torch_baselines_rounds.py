"""Each baseline's branches one round at a time from the reference's state,
and the all-ones mask (tests/test_torch_baselines.py holds the helpers)."""

import functools

import jax
import pytest
import torch

from repro.core import baselines as rb
from repro_torch import prng
from repro_torch.core import baselines as tb

from test_torch_baselines import (G, KEY0, LINEAR, MARINA_TOL, NAMES, ROUNDS,
                                  ROUND_TOL, _assert_close, _both,
                                  _linear_batch, _linear_params, _r_linear,
                                  _t_linear, _to_port)
from torch_priority import lower_priority  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", NAMES)
def test_rounds_from_reference_state_match(name):
    rcfg, tcfg = _both(name=name, **LINEAR[name])
    if name == "marina":
        full = [bool(prng.bernoulli(prng.key(KEY0 + t), tcfg.marina_p, (), "cpu"))
                for t in range(ROUNDS)]
        assert full[0] and not all(full)
    rparams = _linear_params()
    rstate = rb.init_baseline_state(rcfg, rparams, G)
    _assert_close(tb.init_baseline_state(tcfg, _to_port(rparams), G), rstate, "init")
    rj = jax.jit(functools.partial(rb.baseline_round, rcfg, _r_linear))
    for t in range(ROUNDS):
        batch = _linear_batch(t, rcfg.local_steps)
        tparams, tstate, tm = tb.baseline_round(
            tcfg, _t_linear, _to_port(rparams), _to_port(rstate), _to_port(batch),
            prng.key(KEY0 + t))
        rparams, rstate, rm = rj(rparams, rstate, batch, jax.random.key(KEY0 + t))
        tol = MARINA_TOL if name == "marina" else ROUND_TOL
        _assert_close(tm, rm, f"round {t} metrics", **tol)
        _assert_close(tparams, rparams, f"round {t} params", **tol)
        _assert_close(tstate, rstate, f"round {t} state", **tol)
    assert int(rstate["round"]) == ROUNDS


@pytest.mark.parametrize("name", NAMES)
def test_all_ones_mask_is_no_mask_and_state_is_not_mutated(name):
    _, tcfg = _both(name=name, **LINEAR[name])
    params = _to_port(_linear_params())
    state = tb.init_baseline_state(tcfg, params, G)
    for t in range(2):      # a second round starts from non-zero memories
        batch = _to_port(_linear_batch(t, tcfg.local_steps))
        snapshot = jax.tree.map(lambda x: x.clone(), state)
        p1, s1, m1 = tb.baseline_round(tcfg, _t_linear, params, state, batch,
                                       prng.key(KEY0 + t))
        p2, s2, m2 = tb.baseline_round(tcfg, _t_linear, params, state, batch,
                                       prng.key(KEY0 + t), part_mask=torch.ones(G))
        for a, b in ((p1, p2), (s1, s2), (m1, m2), (state, snapshot)):
            flat_a, flat_b = jax.tree.leaves(a), jax.tree.leaves(b)
            assert jax.tree.structure(a) == jax.tree.structure(b)
            assert all(torch.equal(x, y) for x, y in zip(flat_a, flat_b)), name
        params, state = p1, s1
