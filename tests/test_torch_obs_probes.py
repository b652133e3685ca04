"""The telemetry probes against the reference's ``telemetry_probes`` round by
round (tests/test_torch_obs.py holds the helpers)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packed import make_packing_plan as r_plan
from repro.core.safl import init_safl as r_init_safl
from repro.core.safl import safl_round as r_round
from repro.fed.faults import _spec_from_codes as r_spec_from_codes
from repro.fed.robust import SentinelConfig as RSentinel
from repro.models import ModelConfig as RModel
from repro.models import loss_fn as r_loss
from repro.obs import Telemetry as RTel
from repro.obs import telemetry_probes as r_probes
from repro_torch import prng
from repro_torch.core.packed import make_packing_plan as t_plan
from repro_torch.core.safl import init_safl, safl_round
from repro_torch.fed.faults import NAN, OK
from repro_torch.fed.faults import _spec_from_codes as t_spec_from_codes
from repro_torch.fed.robust import SentinelConfig as TSentinel
from repro_torch.models.config import ModelConfig as TModel
from repro_torch.models.model import loss_fn as t_loss
from repro_torch.obs import PROBE_KEYS, telemetry_probes

from test_torch_safl import DATA, QUICK_KW, _cfgs, _flat, _samplers, _weights
from test_torch_obs import (BASELINE_CASES, G, LINEAR_CASES, MASKS, TEL,
                            compare_probes, port_setup, run_from_reference,
                            run_port, to_port)
from torch_priority import lower_priority  # noqa: F401 (autouse)


def test_telemetry_off_emits_no_probe_keys():
    _, _, h = run_port(*port_setup())
    assert set(h) == {"loss"}


@pytest.mark.parametrize("case", list(LINEAR_CASES))
def test_probes_match_reference_linear(case):
    rfn, tfn, rparams, rstate = LINEAR_CASES[case]()
    for t, (tm, rm) in enumerate(run_from_reference(rfn, tfn, rparams, rstate, 3)):
        compare_probes(tm, rm, f"{case} round {t}")
        assert float(tm["cohort"]) == G and "delta_norm" in tm
        if case in BASELINE_CASES:      # no update or residual probe there
            assert "ef_norm" in tm and "residual" not in tm
        else:
            assert {"update_norm", "residual", "vhat_norm"} <= set(tm)
    if case == "fedopt":
        assert float(tm["residual"]) == float(rm["residual"]) == 0.0
    if case.startswith("sacfl"):
        want = 1.0 if case.endswith("1e-6") else 0.0
        assert float(tm["clip_frac"]) == float(rm["clip_frac"]) == want
    else:
        assert "clip_frac" not in tm


def test_probes_match_reference_under_the_guard():
    """The probes read the EFFECTIVE mask: a cohort mask of 3 of 4 with a
    NaN client rejected by the sentinel leaves 2 (both packages)."""
    rfn, tfn, rparams, rstate = LINEAR_CASES["safl_countsketch"]()
    codes = np.array([NAN, OK, OK, OK], np.int32)
    mask = np.array([1, 1, 0, 1], np.float32)
    rkw = dict(part_mask=jnp.asarray(mask),
               fault_spec=r_spec_from_codes(jnp.asarray(codes), 1e3))
    tkw = dict(part_mask=torch.from_numpy(mask),
               fault_spec=t_spec_from_codes(torch.from_numpy(codes), 1e3))
    rfn = functools.partial(rfn, sentinel=RSentinel(norm_mult=0.0))
    tfn = functools.partial(tfn, sentinel=TSentinel(norm_mult=0.0))
    for t, (tm, rm) in enumerate(run_from_reference(rfn, tfn, rparams, rstate,
                                                    2, rkw, tkw)):
        compare_probes(tm, rm, f"guarded round {t}")
        assert float(tm["cohort"]) == 2.0 and float(tm["n_rejected"]) == 1.0


def test_probes_match_reference_on_the_bench_lm():
    """Sixteen leaves, the norms summed in the reference's leaf order; the
    second round from the reference's state."""
    rcfg, tcfg = _cfgs(kind="countsketch", cs_hash="independent")
    _, tsmp = _samplers({**DATA, "vocab_size": 128, "seq_len": 16}, 2)
    tmodel, rmodel = TModel(**QUICK_KW), RModel(**QUICK_KW)
    rparams, tparams = _weights(tmodel, 0)
    rj = jax.jit(functools.partial(r_round, rcfg, lambda p, b: r_loss(rmodel, p, b),
                                   plan=r_plan(rcfg.sketch, rparams), telemetry=RTel()))
    tfn = functools.partial(safl_round, tcfg, lambda p, b: t_loss(tmodel, p, b),
                            plan=t_plan(tcfg.sketch, tparams), telemetry=TEL)
    rstate = r_init_safl(rcfg, rparams)
    state = init_safl(tcfg, tparams)
    for t in range(2):
        batch = tsmp.round_batch(t, device="cpu")
        _, _, tm = tfn(tparams, state, batch, prng.key(t))
        rparams, rstate, rm = rj(rparams, rstate,
                                 {"tokens": jnp.asarray(batch["tokens"].numpy())},
                                 jax.random.key(t))
        compare_probes(tm, rm, f"bench LM round {t}")
        tparams = to_port(_flat(rparams))
        state = {"step": to_port(rstate["step"]),
                 **{m: to_port(_flat(rstate[m])) for m in ("m", "v", "vhat")}}


@pytest.mark.parametrize("mask", list(MASKS))
def test_telemetry_probes_on_shared_inputs(mask):
    """``telemetry_probes`` itself, both packages on the same numpy
    deltas, update, mask and state (nested EF memory included)."""
    rng = np.random.RandomState(3)
    deltas = {"b": rng.randn(G, 3).astype(np.float32),
              "a/w": rng.randn(G, 2, 5).astype(np.float32)}
    update = {k: v[0] * 0.5 for k, v in deltas.items()}
    moments = lambda: {k: rng.rand(*v.shape[1:]).astype(np.float32)
                       for k, v in deltas.items()}
    state = {"opt": {"step": np.int32(2), "m": moments(), "v": moments(),
                     "vhat": moments()},
             "err": {k: rng.randn(*v.shape).astype(np.float32) for k, v in deltas.items()}}
    m = MASKS[mask]

    def nest(tree):       # "/"-joined keys as the reference's nested dicts
        out = {}
        for k, v in tree.items():
            *parents, leaf = k.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
        return out

    rmask = (None if m is None else {**m, "w": jnp.asarray(m["w"])}
             if isinstance(m, dict) else jnp.asarray(m))
    tmask = (None if m is None else {**m, "w": torch.from_numpy(m["w"])}
             if isinstance(m, dict) else torch.from_numpy(m))
    want = r_probes(RTel(), deltas=nest(deltas), update=nest(update), part_mask=rmask,
                    state={"opt": {"step": 2, **{k: nest(state["opt"][k])
                                                 for k in ("m", "v", "vhat")}},
                           "err": nest(state["err"])},
                    clip_frac=jnp.float32(0.25))
    got = telemetry_probes(TEL, deltas=to_port(deltas), update=to_port(update),
                           part_mask=tmask, state=to_port(state),
                           clip_frac=torch.tensor(0.25))
    compare_probes(got, want, mask)
    assert set(got) == set(PROBE_KEYS)
