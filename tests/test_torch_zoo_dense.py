"""The model zoo's attention families against the reference: dense
decoders (GQA, QKV bias, sliding window, tied embeddings), the VLM
(M-RoPE, patch embeddings in front of the text) and the audio
encoder-decoder (bidirectional encoder, cross-attention).

Both packages run from the same weights, carried across by
``params_from_numpy``: the SMOKE configs' loss and every gradient agree up
to float32 summation order.  tests/test_torch_zoo_moe.py holds the MoE
and MLA/MTP families the same way, tests/test_torch_zoo_ssm.py the Mamba
families.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as RL
import repro_torch.models.layers as TL
from repro.configs import get_config as r_config
from repro.models import init_params as r_init
from repro.models import loss_fn as r_loss
from repro.models.model import _positions_for as r_positions
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_config as t_config
from repro_torch.models.config import ModelConfig as TModel
from repro_torch.models.model import _positions_for as t_positions
from repro_torch.models.model import forward as t_forward
from repro_torch.models.model import init_params
from repro_torch.models.model import loss_fn as t_loss
from repro_torch.models.model import param_shapes as t_shapes

from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)

ATTN_ARCHS = ["whisper_large_v3", "qwen2_vl_7b", "h2o_danube_1_8b",
              "llama3_2_1b", "qwen1_5_4b", "qwen2_7b", "bert_100m",
              "vit_base_86m"]
# float32 matmuls and reductions in other orders: ~1e-6 relative
LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def flat(tree) -> dict:
    f, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(l)
            for path, l in f}


def smoke_batch(cfg, B: int = 2, S: int = 20, seed: int = 0) -> dict:
    """Tokens, and the frontend's embeddings where the family has one."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = (rng.randn(B, cfg.num_frontend_tokens, cfg.d_model)
                                 * 0.02).astype(np.float32)
    if cfg.frontend == "audio":
        batch["audio_embeds"] = (rng.randn(B, cfg.encoder_seq, cfg.d_model)
                                 * 0.02).astype(np.float32)
    return batch


def ref_value_and_grad(rcfg, rparams, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(jax.value_and_grad(lambda p: r_loss(rcfg, p, jb)))(rparams)


def port_value_and_grad(tcfg, tparams, batch):
    for p in tparams.values():
        p.requires_grad_(True)
    loss = t_loss(tcfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(tparams.values()), allow_unused=True)
    return loss, dict(zip(tparams, grads))


@functools.lru_cache(maxsize=None)
def ref_init(rcfg, seed: int):
    """The reference's init of ``rcfg`` from ``seed``, drawn once a process
    and shared between the cases (its arrays are immutable)."""
    return r_init(rcfg, jax.random.key(seed))


def check_against_reference(rcfg, tcfg, batch, seed=1, loss_tol=LOSS_TOL,
                            grad_tol=GRAD_TOL):
    """Loss and every gradient of both packages from the reference's init
    carried across; the keys in jax's flatten order."""
    rparams = ref_init(rcfg, seed)
    rl, rg = ref_value_and_grad(rcfg, rparams, batch)
    tparams = params_from_numpy(flat(rparams), "cpu")
    assert list(tparams) == list(t_shapes(tcfg))
    tl, tg = port_value_and_grad(tcfg, tparams, batch)
    np.testing.assert_allclose(tl.item(), float(rl), **loss_tol)
    for k, want in flat(rg).items():
        got = tg[k]
        got = np.zeros_like(want) if got is None else got.numpy()
        np.testing.assert_allclose(got, want, err_msg=k, **grad_tol)


def layer0_params(rcfg, kind: str):
    """Layer 0's ``kind`` sub-tree of the reference's init, and the port's
    flat dict of the same arrays."""
    rp = jax.tree.map(lambda x: x[0], ref_init(rcfg, 0)["layers"]["l0"][kind])
    flat, _ = jax.tree_util.tree_flatten_with_path(rp)
    tp = {"/".join(str(getattr(k, "key", k)) for k in path): torch.tensor(np.asarray(l))
          for path, l in flat}
    return rp, tp


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_smoke_loss_and_grads_match_reference(arch):
    check_against_reference(r_config(arch, smoke=True),
                            t_config(arch, smoke=True),
                            smoke_batch(r_config(arch, smoke=True)))


def test_sliding_window_beyond_its_width_in_query_chunks(monkeypatch):
    """h2o-danube's window (16 in SMOKE) over 40 tokens, in query chunks of
    8 in both packages: each chunk attends to its sliced keys."""
    monkeypatch.setattr(RL, "Q_CHUNK", 8)
    monkeypatch.setattr(TL, "Q_CHUNK", 8)
    rcfg = r_config("h2o_danube_1_8b", smoke=True)
    check_against_reference(rcfg, t_config("h2o_danube_1_8b", smoke=True),
                            smoke_batch(rcfg, S=40))


# positions that must not see a change agree to the reference tests'
# 1e-5 (tests/test_models.py): the CPU GEMM's blocking may differ between
# calls by an ulp
UNSEEN_TOL = dict(rtol=0, atol=1e-5)
TINY = dict(name="t", arch_type="dense", num_layers=1, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)


def _last_hidden(cfg, tokens):
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return t_forward(cfg, params, {"tokens": tokens})[0]


def test_sliding_window_hides_tokens_outside_it():
    """A token outside the window of the last position does not reach it
    (tests/test_models.py::test_swa_attention_is_windowed)."""
    cfg = TModel(**TINY, sliding_window=4)
    t1 = torch.zeros((1, 12), dtype=torch.int64)
    t2 = t1.clone()
    t2[:, 0] = 7
    h1, h2 = _last_hidden(cfg, t1), _last_hidden(cfg, t2)
    torch.testing.assert_close(h1[:, -1], h2[:, -1], **UNSEEN_TOL)
    assert not torch.allclose(h1[:, 0], h2[:, 0])


def test_causality():
    """Future tokens do not affect earlier positions
    (tests/test_models.py::test_causality)."""
    cfg = TModel(**{**TINY, "num_layers": 2})
    t1 = torch.zeros((1, 8), dtype=torch.int64)
    t2 = t1.clone()
    t2[:, -1] = 9
    h1, h2 = _last_hidden(cfg, t1), _last_hidden(cfg, t2)
    torch.testing.assert_close(h1[:, :-1], h2[:, :-1], **UNSEEN_TOL)


def test_vlm_patch_positions_and_loss_mask():
    """The M-RoPE positions equal the reference's (patches on a 4 x 4
    grid at t = 0, text after it); the loss runs over the text positions
    only: it is the mean next-token cross-entropy of the hidden states
    after the patches."""
    rcfg = r_config("qwen2_vl_7b", smoke=True)
    tcfg = t_config("qwen2_vl_7b", smoke=True)
    P, S = tcfg.num_frontend_tokens, 16 + tcfg.num_frontend_tokens
    want = np.asarray(r_positions(rcfg, {}, 2, S))
    got = t_positions(tcfg, 2, S, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:, 0, :P].tolist() == [[0] * P, [i // 4 for i in range(P)],
                                      [i % 4 for i in range(P)]]
    # the mrope tables against the reference's
    cos_r, sin_r = RL.rope_cos_sin(rcfg, jnp.asarray(want), tcfg.hd)
    cos_t, sin_t = TL.rope_cos_sin(tcfg, got, tcfg.hd)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_r), atol=2e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_r), atol=2e-6)

    params = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(v) for k, v in smoke_batch(tcfg, S=16).items()}
    h, aux = t_forward(tcfg, params, b)
    assert h.shape == (2, S, tcfg.d_model)
    logits = (h[:, P:-1] @ params["lm_head"]).to(torch.float32)
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), b["tokens"][:, 1:].reshape(-1).long())
    torch.testing.assert_close(t_loss(tcfg, params, b), ce + aux,
                               rtol=1e-6, atol=1e-6)


def test_cross_attention_reads_the_encoder():
    """Whisper's decoder sees the audio through cross-attention: other
    audio moves every decoder position; the decoder stays causal."""
    tcfg = t_config("whisper_large_v3", smoke=True)
    params = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(v) for k, v in smoke_batch(tcfg, S=10).items()}
    h1 = t_forward(tcfg, params, b)[0]
    b2 = dict(b, audio_embeds=torch.randn(b["audio_embeds"].shape,
                                          generator=torch.Generator().manual_seed(1)))
    h2 = t_forward(tcfg, params, b2)[0]
    assert bool((h1 - h2).abs().amax(dim=-1).gt(1e-3).all())
    b3 = dict(b, tokens=b["tokens"].clone())
    b3["tokens"][:, -1] = (b3["tokens"][:, -1] + 1) % tcfg.vocab_size
    h3 = t_forward(tcfg, params, b3)[0]
    torch.testing.assert_close(h1[:, :-1], h3[:, :-1], **UNSEEN_TOL)


def test_llama_bfloat16_smoke_matches_reference():
    """llama3.2-1b SMOKE in its own bfloat16 through both packages.  Each
    package rounds every matmul and elementwise output to bfloat16 (8
    significant bits, 2^-9 ~ 2e-3 relative a rounding), at other points of
    other orders: the loss (a float32 reduction) is held to 1e-3
    relative, each gradient leaf to 3e-2 relative in l2 norm and a cosine
    of at least 0.999 (measured: ~1.5e-2 and 0.9999)."""
    rcfg = dataclasses.replace(r_config("llama3_2_1b", smoke=True), dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(t_config("llama3_2_1b", smoke=True), dtype=torch.bfloat16)
    batch = smoke_batch(rcfg, S=24)
    rparams = r_init(rcfg, jax.random.key(1))
    rl, rg = ref_value_and_grad(rcfg, rparams, batch)
    tparams = params_from_numpy(flat(rparams), "cpu")
    assert all(p.dtype == torch.bfloat16 for p in tparams.values())
    tl, tg = port_value_and_grad(tcfg, tparams, batch)
    np.testing.assert_allclose(tl.item(), float(rl), rtol=1e-3)
    for k, want in flat(rg).items():
        assert tg[k].dtype == torch.bfloat16, k
        w = np.asarray(want, np.float64).ravel()
        g = tg[k].to(torch.float64).numpy().ravel()
        assert np.linalg.norm(g - w) <= 3e-2 * np.linalg.norm(w), k
        assert g @ w >= 0.999 * np.linalg.norm(g) * np.linalg.norm(w), k
