"""The model zoo's Mamba families against the reference: falcon-mamba
(Mamba-1) and jamba (the 8-layer Mamba/attention/MoE hybrid).

The SMOKE configs' loss and every gradient from carried weights, as in
tests/test_torch_zoo_dense.py, and the Mamba state across chunk
boundaries.
"""

import jax
import numpy as np
import torch

import repro.models.layers as RL
import repro_torch.models.layers as TL
from repro.configs import get_config as r_config
from repro_torch.configs import get_config as t_config
from test_torch_zoo_dense import (check_against_reference, layer0_params,
                                  smoke_batch)
from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)


def test_falcon_mamba_smoke_loss_and_grads_match_reference():
    rcfg = r_config("falcon_mamba_7b", smoke=True)
    check_against_reference(rcfg, t_config("falcon_mamba_7b", smoke=True),
                            smoke_batch(rcfg))


def test_jamba_smoke_loss_and_grads_match_reference():
    """jamba's seven Mamba layers each run the recurrence in the port's
    order and the reference's associative scan in its own; both are
    within ~2e-6 of a float64 run of the same layer at S = 600, and the
    gap grows through the stack to ~1.3e-5 at the embedding gradient
    (1e-5 of its largest entry), so the gradients' absolute tolerance is
    2e-5 here against 1e-6 elsewhere."""
    rcfg = r_config("jamba_1_5_large_398b", smoke=True)
    check_against_reference(rcfg, t_config("jamba_1_5_large_398b", smoke=True),
                            smoke_batch(rcfg), grad_tol=dict(rtol=1e-4, atol=2e-5))


def test_mamba_state_across_chunk_boundaries(monkeypatch):
    """300 steps through falcon-mamba's layer 0: two chunks of 256 in both
    packages agree to float32 order (the reference scans each chunk
    associatively, the port runs the recurrence), and the port in chunks
    of 8 carries h across 37 boundaries to the same values."""
    rcfg, tcfg = r_config("falcon_mamba_7b", smoke=True), t_config("falcon_mamba_7b", smoke=True)
    rp, tp = layer0_params(rcfg, "mamba")
    x = np.random.RandomState(5).randn(2, 300, rcfg.d_model).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: RL.mamba(rcfg, rp, v))(x))
    got = TL.mamba(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(TL, "MAMBA_CHUNK", 8)
    torch.testing.assert_close(TL.mamba(tcfg, tp, torch.from_numpy(x)), got,
                               rtol=1e-6, atol=1e-6)
