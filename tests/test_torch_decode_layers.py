"""Each decode layer one step and several from random weights and caches
against the reference's (tests/test_torch_decode.py holds the helpers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as RL
import repro_torch.models.layers as TL
from repro_torch.models.model import _attn_shapes, _mamba_shapes

from test_torch_decode import (ATTN_CASES, B, LAYER_TOL, MLA, SSM, TINY, both,
                               flat_shapes, layer_weights, random_cache,
                               run_steps)
from torch_priority import lower_priority  # noqa: F401 (autouse)


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("steps", ["one", "several"])
def test_attention_decode_matches_reference(case, steps):
    kw, sc, one, several = ATTN_CASES[case]
    rcfg, tcfg = both(**kw)
    rp, tp = layer_weights(tcfg, flat_shapes(_attn_shapes, tcfg))
    shapes = {"k": (B, sc, tcfg.num_kv_heads, tcfg.hd),
              "v": (B, sc, tcfg.num_kv_heads, tcfg.hd)}
    rcache, tcache = random_cache(shapes, seed=2)
    window = tcfg.sliding_window
    run_steps(rcfg, tcfg,
              lambda c, p, x, pos, ca: RL.attention_decode(c, p, x, pos, ca, window=window),
              lambda c, p, x, pos, ca: TL.attention_decode(c, p, x, pos, ca, window=window),
              rp, tp, rcache, tcache, one if steps == "one" else several)


def test_cross_attention_decode_matches_reference():
    """Against a random encoder cache of 7 frames (GQA): no rotary, no
    mask, and no query bias even where the config has attention biases."""
    rcfg, tcfg = both(**{**TINY, "attn_bias": True})
    rp, tp = layer_weights(tcfg, flat_shapes(_attn_shapes, tcfg, cross=True))
    assert "bq" not in tp
    shapes = {"xk": (B, 7, tcfg.num_kv_heads, tcfg.hd),
              "xv": (B, 7, tcfg.num_kv_heads, tcfg.hd)}
    rcache, tcache = random_cache(shapes, seed=3)
    x = (np.random.RandomState(4).randn(B, 1, tcfg.d_model) * 0.5).astype(np.float32)
    want = RL.cross_attention_decode(rcfg, rp, jnp.asarray(x), rcache)
    got = TL.cross_attention_decode(tcfg, tp, torch.from_numpy(x), tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("positions", [[5], list(range(8))], ids=["one", "several"])
def test_mla_attention_decode_matches_reference(positions):
    rcfg, tcfg = both(**MLA)
    rp, tp = layer_weights(tcfg, flat_shapes(_attn_shapes, tcfg))
    rcache, tcache = random_cache({"ckv": (B, 12, 16), "kpe": (B, 12, 8)}, seed=5)
    run_steps(rcfg, tcfg, RL.mla_attention_decode, TL.mla_attention_decode,
              rp, tp, rcache, tcache, positions)


@pytest.mark.parametrize("steps", [1, 6])
def test_mamba_decode_matches_reference(steps):
    """From a random float32 state and conv window (a_log kept positive
    under the exp so the state decays)."""
    rcfg, tcfg = both(**SSM)
    shapes = flat_shapes(_mamba_shapes, tcfg)
    rp, tp = layer_weights(tcfg, shapes)
    a_log = np.log(np.arange(1, 5, dtype=np.float32))[None].repeat(tcfg.d_inner, 0)
    rp["a_log"], tp["a_log"] = jnp.asarray(a_log), torch.from_numpy(a_log)
    rcache, tcache = random_cache({"h": (B, tcfg.d_inner, 4),
                                   "conv": (B, tcfg.ssm_conv - 1, tcfg.d_inner)}, seed=6)
    run_steps(rcfg, tcfg,
              lambda c, p, x, pos, ca: RL.mamba_decode(c, p, x, ca),
              lambda c, p, x, pos, ca: TL.mamba_decode(c, p, x, ca),
              rp, tp, rcache, tcache, range(steps))
