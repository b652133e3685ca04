"""``launch.driver``'s cohort masks and billing against the reference's
(tests/test_torch_participation.py holds the helpers)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import participation as rpart
from repro.launch.driver import _with_bits as r_with_bits
from repro_torch import prng
from repro_torch.core import safl as tsafl
from repro_torch.core.clipped import ClippedSAFLConfig, clipped_safl_round
from repro_torch.core.packed import make_packing_plan
from repro_torch.core.sketch import total_sketch_bits
from repro_torch.fed import participation as tpart
from repro_torch.launch.driver import _with_bits, run_host_loop, run_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, loss_fn

from test_torch_safl import DATA, QUICK_KW, _cfgs, _samplers
from test_torch_participation import G, _policies
from torch_priority import lower_priority  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", ["uniform", "importance", "trace", "full"])
def test_with_bits_bills_the_sampled_cohort(name):
    """Per-client bits times the cohort: the mask's sum, or a weighted
    mask's static ``n``; the same float32 as the reference's ``_with_bits``."""
    rpol, tpol = _policies(rpart)[name], _policies(tpart)[name]
    for t in range(4):
        rm, tm = rpol.mask(jnp.int32(t)), tpol.mask(t, "cpu")
        want = r_with_bits({"loss": jnp.float32(0.0)}, 12_345_678, rm)
        got = _with_bits({"loss": torch.tensor(0.0)}, 12_345_678, tm)
        assert got["uplink_bits"].dtype == torch.float32
        assert float(got["uplink_bits"]) == float(want["uplink_bits"])
        n = tm["n"] if isinstance(tm, dict) else int(tm.sum())
        assert float(got["uplink_bits"]) == np.float32(12_345_678) * np.float32(n)


@pytest.mark.parametrize("which", ["safl", "sacfl", "fedopt"])
def test_driver_passes_masks_and_bills_cohorts(which):
    """Both drivers hand the round ``part_mask = policy.mask(t)`` and bill
    per-client bits times the sampled cohort; scan and host loop agree bit
    for bit, for SAFL, SACFL (whose global norm sums its leaves in one
    fixed order) and FedOPT."""
    model = ModelConfig(**QUICK_KW)
    tcfg = _cfgs(kind="countsketch", cs_hash="independent")[1]
    _, smp = _samplers({**DATA, "vocab_size": 128, "num_clients": G}, 2)
    fresh = lambda: init_params(model, torch.Generator().manual_seed(0), "cpu")
    pol = tpart.AvailabilityTrace.round_robin(G, 2)     # cohorts 3, 2, 3, ...
    loss = lambda p, b: loss_fn(model, p, b)
    rounds = {
        "safl": lambda *a, **kw: tsafl.safl_round(
            tcfg, loss, *a, plan=make_packing_plan(tcfg.sketch, a[0]), **kw),
        "sacfl": lambda *a, **kw: clipped_safl_round(
            ClippedSAFLConfig(base=tcfg, clip_tau=0.5), loss, *a,
            plan=make_packing_plan(tcfg.sketch, a[0]), **kw),
        "fedopt": lambda *a, **kw: tsafl.fedopt_round(tcfg, loss, *a, **kw)}
    seen = []

    def round_fn(params, state, batch, key, part_mask):
        seen.append(part_mask)
        return rounds[which](params, state, batch, key, part_mask=part_mask)

    bits = total_sketch_bits(tcfg.sketch, fresh())
    runs = [drive(round_fn, smp, fresh(), tsafl.init_safl(tcfg, fresh()),
                  rounds=3, key=prng.key(2), bits_per_round=bits,
                  participation=pol)
            for drive in (functools.partial(run_scan, chunk_size=2), run_host_loop)]
    for t, m in enumerate(seen[:3]):
        assert torch.equal(m, pol.mask(t, "cpu"))
    (p1, _, h1), (p2, _, h2) = runs
    np.testing.assert_array_equal(h1["uplink_bits"], [3 * bits, 2 * bits, 3 * bits])
    np.testing.assert_array_equal(h1["uplink_bits"], h2["uplink_bits"])
    np.testing.assert_array_equal(h1["loss"], h2["loss"])
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
