"""Every SMOKE arch's ``decode_step`` teacher-forced against the reference's,
``encode_for_decode`` and the greedy server token for token
(tests/test_torch_serve.py holds the helpers)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as r_config
from repro.models import init_cache as r_init_cache
from repro.models.model import encode_for_decode as r_encode_for_decode
from repro_torch import prng
from repro_torch.configs import get_config as t_config
from repro_torch.data.synthetic import synthetic_lm_batch
from repro_torch.launch import serve
from repro_torch.models import init_cache
from repro_torch.models.model import encode_for_decode

from test_torch_serve import (B, BF16_TOL, F32_TOL, GREEDY_TOL, JAMBA_TOL,
                              MAX_SEQ, assert_margins, audio_for, flat,
                              ref_greedy, teacher_forced, weights)
from torch_priority import lower_priority  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    teacher_forced(r_config(arch, smoke=True), t_config(arch, smoke=True),
                   JAMBA_TOL if arch.startswith("jamba") else F32_TOL)


def test_decode_step_bfloat16_matches_reference():
    """llama3.2-1b SMOKE in its published dtype, bfloat16, at a measured
    tolerance (see BF16_TOL)."""
    rcfg = dataclasses.replace(r_config("llama3_2_1b", smoke=True), dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(t_config("llama3_2_1b", smoke=True), dtype=torch.bfloat16)
    teacher_forced(rcfg, tcfg, BF16_TOL)


def test_encode_for_decode_matches_reference():
    """whisper SMOKE: the encoder's cross-attention caches, every block,
    and the other entries left zero."""
    rcfg, tcfg = r_config("whisper_large_v3", smoke=True), t_config("whisper_large_v3", smoke=True)
    tp, rp = weights(tcfg)
    audio = audio_for(rcfg, seed=4)
    want = flat(r_encode_for_decode(rcfg, rp, r_init_cache(rcfg, B, MAX_SEQ),
                                    jnp.asarray(audio)))
    cache = init_cache(tcfg, B, MAX_SEQ, device="cpu")
    got = encode_for_decode(tcfg, tp, cache,
                            torch.from_numpy(audio))
    assert got is cache and list(got) == list(want)
    for k, w in want.items():
        assert k.endswith(("xk", "xv")) or not w.any(), k
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **F32_TOL)


@pytest.mark.parametrize("arch,P", [("llama3_2_1b", 4), ("h2o_danube_1_8b", 6),
                                    ("whisper_large_v3", 3)])
def test_serve_run_reproduces_reference_greedy(arch, P):
    """The port's server from the reference's weights: the same prompt
    (tokens from ``synthetic_lm_batch``), then greedy tokens equal to the
    reference's loop, token for token; h2o-danube's 16-slot ring wraps."""
    rcfg, tcfg = r_config(arch, smoke=True), t_config(arch, smoke=True)
    tp, rp = weights(tcfg)
    prompt = synthetic_lm_batch(prng.key(2), B, P, tcfg.vocab_size, device="cpu")["tokens"]
    audio = audio_for(rcfg) if rcfg.encoder_layers else None
    steps = MAX_SEQ - P + 1 - 8
    want, want_logits = ref_greedy(rcfg, rp, prompt.numpy(), steps, MAX_SEQ, audio)
    out = serve.run(tcfg, batch=B, steps=steps, max_seq=MAX_SEQ, prompt=prompt,
                    params=tp,
                    audio=None if audio is None else torch.from_numpy(audio),
                    device="cpu", keep_logits=True)
    assert len(out["step_ms"]) == P - 1 + steps and out["tokens_per_s"] > 0
    np.testing.assert_allclose(out["all_logits"].numpy(), want_logits, **GREEDY_TOL)
    assert_margins(want_logits[P - 1:])
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
    assert out["cache_bytes"] == sum(c.numel() * c.element_size()
                                     for c in out["cache"].values())


def test_serve_example_matches_reference_example():
    """``serve.example()`` (examples/serve.py's model and run) from the
    reference's weights gives the reference example's greedy tokens; its
    first tokens come from key 1, as there."""
    from repro.models import ModelConfig as RModel
    rcfg = RModel(**{f.name: getattr(serve.EXAMPLE, f.name)
                     for f in dataclasses.fields(serve.EXAMPLE) if f.name != "dtype"})
    tp, rp = weights(serve.EXAMPLE)
    first = np.asarray(jax.random.randint(jax.random.key(1), (8, 1), 0, 1024))
    want, want_logits = ref_greedy(rcfg, rp, first, serve.EXAMPLE_STEPS,
                                   serve.EXAMPLE_MAX_SEQ)
    out = serve.example(device="cpu", params=tp,
                        keep_logits=True)
    np.testing.assert_allclose(out["all_logits"].numpy(), want_logits, **GREEDY_TOL)
    assert_margins(want_logits)
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
