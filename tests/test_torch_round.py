"""Single SAFL rounds of the port against the reference's other routes.

One round of each package from the same weights, batch and key, against
the port's kernel route (its plain versions on the CPU): here the
reference's Pallas count-sketch route (interpret mode, quickstart
model); tests/test_torch_srht.py runs the SRHT family.  Tolerances as in
tests/test_torch_safl.py.
"""

import functools

import jax
import numpy as np
import torch

from repro.core.safl import init_safl as r_init_safl
from repro.core.safl import safl_round as r_round
from repro.models import ModelConfig as RModel
from repro.models import loss_fn as r_loss
from repro_torch import prng
from repro_torch.core.safl import init_safl as t_init_safl
from repro_torch.core.safl import safl_round as t_round
from repro_torch.models.config import ModelConfig as TModel
from repro_torch.models.model import loss_fn as t_loss
from test_torch_safl import (DATA, LOSS_TOL, PARAM_TOL, QUICK_KW, _cfgs,
                             _flat, _samplers, _weights)
from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)


def one_round(vocab, rmodel, tmodel, batch_per_client, **sketch):
    """One round of each package from the same weights, batch and key."""
    rcfg, tcfg = _cfgs(**sketch)
    rsmp, tsmp = _samplers({**DATA, "vocab_size": vocab}, batch_per_client)
    rparams, tparams = _weights(tmodel, 1)
    rb = jax.jit(rsmp.sample)(rsmp.init_state(), 0)[1]
    rfn = jax.jit(functools.partial(r_round, rcfg,
                                    lambda p, b: r_loss(rmodel, p, b)))
    rp, _, rm = rfn(rparams, r_init_safl(rcfg, rparams), rb,
                    jax.random.fold_in(jax.random.key(3), 0))
    tb = {"tokens": torch.from_numpy(np.asarray(rb["tokens"]).astype(np.int64))}
    tp, _, tm = t_round(tcfg, lambda p, b: t_loss(tmodel, p, b), tparams,
                        t_init_safl(tcfg, tparams), tb,
                        prng.fold_in(prng.key(3), 0))
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), **LOSS_TOL)
    for k, v in _flat(rp).items():
        np.testing.assert_allclose(tp[k].numpy(), v, err_msg=k, **PARAM_TOL)


def test_round_vs_reference_pallas_route_quickstart():
    """The reference's Pallas count-sketch (interpret mode) against the
    port's kernel route."""
    one_round(QUICK_KW["vocab_size"], RModel(**QUICK_KW), TModel(**QUICK_KW),
              2, ref_kernels=True, kind="countsketch", cs_hash="independent")
