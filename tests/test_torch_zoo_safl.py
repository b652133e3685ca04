"""SAFL rounds of the model zoo in the port: every architecture's SMOKE
config through one round (tests/test_smoke_archs.py's round), and dbrx's
round against the reference's from the same weights, batch and key."""

import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as r_config
from repro_torch import prng
from repro_torch.configs import get_config as t_config
from repro_torch.core.adaptive import AdaConfig
from repro_torch.core.safl import SAFLConfig, init_safl, safl_round
from repro_torch.core.sketch import SketchConfig
from repro_torch.models.model import count_params_analytic, init_params, loss_fn
from test_torch_round import one_round
from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)

SAFL = SAFLConfig(sketch=SketchConfig(kind="countsketch", ratio=0.05, min_b=16),
                  server=AdaConfig(name="amsgrad", lr=1e-3),
                  client_lr=0.02, local_steps=2)


def client_batch(cfg, G=2, K=2, mb=2, S=16) -> dict:
    """(G, K, mb, ...) leaves: tokens and the frontend's embeddings."""
    gen = torch.Generator().manual_seed(0)
    P = cfg.num_frontend_tokens if cfg.frontend == "vision" else 0
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (G, K, mb, S), generator=gen)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.randn((G, K, mb, P, cfg.d_model),
                                            generator=gen) * 0.02
    if cfg.frontend == "audio":
        batch["audio_embeds"] = torch.randn((G, K, mb, cfg.encoder_seq, cfg.d_model),
                                            generator=gen) * 0.02
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_safl_round(arch):
    """One round of 2 clients x 2 local steps: a finite loss, every
    parameter moved somewhere, finite, in its shape and dtype."""
    cfg = t_config(arch, smoke=True)
    assert count_params_analytic(cfg) < 50e6
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p2, opt2, m = safl_round(SAFL, lambda p, b: loss_fn(cfg, p, b), params,
                             init_safl(SAFL, params), client_batch(cfg),
                             prng.key(1))
    assert np.isfinite(float(m["loss"])), (arch, m)
    assert int(opt2["step"]) == 1
    assert sum(float((p2[k].float() - v.float()).abs().sum())
               for k, v in params.items()) > 0
    for k, v in params.items():
        assert p2[k].shape == v.shape and p2[k].dtype == v.dtype, k
        assert bool(torch.isfinite(p2[k]).all()), k


def test_dbrx_round_matches_reference():
    """dbrx SMOKE (top-2 of 4 experts): one round of 5 clients from the
    same weights, bigram batch and key in both packages, at
    tests/test_torch_safl.py's tolerances; the routing of each client's
    local steps is discrete, and agrees."""
    one_round(256, r_config("dbrx_132b", smoke=True),
              t_config("dbrx_132b", smoke=True), 2, kind="countsketch",
              cs_hash="independent")
