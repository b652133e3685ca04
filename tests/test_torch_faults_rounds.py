"""Guarded rounds, fault specs and billing of the port against the
reference's, and the guard's bitwise pins (tests/test_torch_faults.py
holds the helpers)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.safl import init_safl as r_init_safl
from repro.fed import FaultTable as RFaultTable
from repro.launch.driver import run_scan as r_run_scan
from repro_torch import prng
from repro_torch.core.packed import make_packing_plan as t_plan
from repro_torch.core.safl import init_safl, safl_round
from repro_torch.fed.faults import DROP, INF, NAN, OK
from repro_torch.fed.faults import FaultConfig as TFaultConfig
from repro_torch.fed.faults import FaultTable as TFaultTable
from repro_torch.fed.robust import SentinelConfig as TSentinel
from repro_torch.launch.driver import run_scan

from test_torch_faults import (FAULT_POLICIES, FAULT_ROWS, G, KEY,
                               _PortSampler, _assert_same, _policies,
                               _port_round, cls_cfgs, cls_params, cls_sampler,
                               port_batch, reference_run, round_fns,
                               rounds_from_reference, t_cls_loss)
from torch_priority import lower_priority  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", list(FAULT_POLICIES))
def test_fault_specs_bitwise_rounds_0_to_31(name):
    rpol, tpol = _policies(name)
    spec = jax.jit(rpol.spec)
    fired = 0
    for t in range(32):
        want = spec(jnp.int32(t), jax.random.key(11))
        got = tpol.spec(t, prng.key(11), "cpu")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"round {t} {k}")
        fired += int((got["arrive"] == 0).sum() + got["nan"].sum()
                     + got["inf"].sum() + (got["scale"] != 1).sum())
    assert fired > 0


@pytest.mark.parametrize("which,norm_mult", [("safl", 0.0), ("safl", 10.0),
                                             ("sacfl", 3.0)])
def test_guarded_rounds_match_reference(which, norm_mult):
    """Four materialized rounds under ``FAULT_ROWS`` and a sentinel: the
    NaN and Inf clients are rejected (both branches), the Byzantine one
    by the norm sentinel only, and round 3 drops everyone, so the server
    is carried through unchanged."""
    rcfg, tcfg = cls_cfgs()
    rfn, tfn = round_fns(which, rcfg, tcfg, sentinel=dict(norm_mult=norm_mult))
    rparams, _ = cls_params()
    states, rh = reference_run(rfn, r_init_safl(rcfg, rparams), 4,
                               faults=RFaultTable(FAULT_ROWS))
    ms = rounds_from_reference(tfn, states, rh, r_init_safl(rcfg, rparams),
                               faults=TFaultTable(FAULT_ROWS))
    assert [float(m["n_dropped"]) for m in ms] == [0.0, 1.0, 0.0, 5.0]
    assert [int(m["n_rejected"]) for m in ms] == [2 if norm_mult else 1, 1, 0, 0]
    for k, v in states[3][0].items():                # the all-drop round
        np.testing.assert_array_equal(v, states[2][0][k])


def test_all_drop_round_carries_the_server_through():
    """Under a sentinel a round in which no client survives returns the
    params and the server state it was given, bit for bit; without one the
    adaptive server still moves."""
    _, tcfg = cls_cfgs()
    _, tp = cls_params()
    batch = port_batch(cls_sampler(), 0)
    spec = TFaultTable(((DROP,) * G,)).spec(0, prng.key(0), "cpu")
    state = init_safl(tcfg, tp)
    state["m"] = {k: torch.full_like(v, 0.01) for k, v in state["m"].items()}
    fn = functools.partial(safl_round, tcfg, t_cls_loss, plan=t_plan(tcfg.sketch, tp))
    p2, s2, m = fn(tp, state, batch, prng.key(1), fault_spec=spec,
                   sentinel=TSentinel())
    for k in tp:
        assert torch.equal(p2[k], tp[k]), k
    assert int(s2["step"]) == 0 and torch.equal(s2["m"]["W"], state["m"]["W"])
    assert float(m["n_dropped"]) == G and float(m["loss"]) == 0.0
    p3, _, _ = fn(tp, state, batch, prng.key(1), fault_spec=spec)
    assert not torch.equal(p3["W"], tp["W"])        # moment decay moves it


@pytest.mark.parametrize("which", ["safl", "sacfl"])
def test_neutral_faults_equal_the_hookless_round_bitwise(which):
    spec = TFaultConfig(num_clients=G).spec(0, prng.key(KEY), "cpu")
    p1, s1, m1 = _port_round(which)
    p2, s2, m2 = _port_round(which, fault_spec=spec)
    _assert_same(p1, p2)
    _assert_same(s1, s2)
    assert torch.equal(m1["loss"], m2["loss"]) and float(m2["n_dropped"]) == 0.0


@pytest.mark.parametrize("code", [NAN, INF])
def test_poisoned_client_equals_the_client_dropped_bitwise(code):
    """The sentinel zeroes a non-finite row and folds it out of the mask;
    the norm median pools only arrived rows, so both rounds see one."""
    row = lambda c: tuple(c if i == 1 else OK for i in range(G))
    out = {}
    for c in (code, DROP):
        spec = TFaultTable((row(c),)).spec(0, prng.key(0), "cpu")
        out[c] = _port_round(fault_spec=spec, sentinel=TSentinel(norm_mult=10.0))
    (p1, s1, m1), (p2, s2, m2) = out[code], out[DROP]
    _assert_same(p1, p2)
    _assert_same(s1, s2)
    assert torch.equal(m1["loss"], m2["loss"])
    assert (int(m1["n_rejected"]), float(m1["n_dropped"])) == (1, 0.0)
    assert (int(m2["n_rejected"]), float(m2["n_dropped"])) == (0, 1.0)


@pytest.mark.parametrize("participation", [False, True])
def test_uplink_bits_bill_the_effective_cohort(participation):
    """``run_scan``'s ``uplink_bits`` drop the round's fault drops and
    sentinel rejections, with a mask (per-client bits x survivors) and
    without one (the cohort's bits x the surviving fraction), equal to
    the reference's history."""
    from repro.fed import UniformParticipation as RUniform
    from repro_torch.fed import UniformParticipation as TUniform
    rcfg, tcfg = cls_cfgs()
    rfn, tfn = round_fns("safl", rcfg, tcfg, sentinel=dict(norm_mult=10.0))
    rp, tp = cls_params()
    bits = 1000 if participation else 5000
    pols = ((RUniform(G, frac=0.8, seed=2), TUniform(G, frac=0.8, seed=2))
            if participation else (None, None))
    _, _, rh = r_run_scan(rfn, cls_sampler(), rp, r_init_safl(rcfg, rp), rounds=3,
                          key=jax.random.key(KEY), donate=False, bits_per_round=bits,
                          faults=RFaultTable(FAULT_ROWS), participation=pols[0])
    _, _, th = run_scan(tfn, _PortSampler(), tp, init_safl(tcfg, tp), rounds=3,
                        key=prng.key(KEY), bits_per_round=bits,
                        faults=TFaultTable(FAULT_ROWS), participation=pols[1])
    np.testing.assert_array_equal(th["uplink_bits"], rh["uplink_bits"])
    np.testing.assert_array_equal(th["n_rejected"], rh["n_rejected"])
    assert th["uplink_bits"][0] < bits * (4 if participation else 1)
