"""The port's cached decode layers and cache layout against the reference,
and its decode against its own forward.

Each decode layer (``attention_decode`` with GQA, MHA with a bias, rope,
M-RoPE and a sliding-window ring; ``cross_attention_decode``;
``mla_attention_decode``; ``mamba_decode``) runs in both packages from
the same random weights and the same random cache, one step and several
steps, the port writing into its cache in place.  The cache shapes and
dtypes of every config equal the reference's.  The decode-against-forward
cases of tests/test_models.py run on the port's own model:
tests/test_torch_serve.py holds ``decode_step`` and the server to the
reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.models.layers as TL
from repro.configs import ARCHS
from repro.configs import get_config as r_config
from repro.models import ModelConfig as RModel
from repro.models import cache_shapes as r_cache_shapes
from repro.models import init_cache as r_init_cache
from repro.models.model import _cache_dtype as r_cache_dtype
from repro_torch.configs import get_config as t_config
from repro_torch.models import ModelConfig as TModel
from repro_torch.models import cache_shapes, decode_step, forward, init_cache
from repro_torch.models import init_params
from repro_torch.models.model import _cache_dtype, _logits, encode_for_decode

torch.set_num_threads(2)

# float32 matmuls and reductions in other orders: the random weights give
# outputs up to ~5 in size, and the largest gap measured is 1.6e-6 (MLA,
# several steps)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
# the reference's own decode-against-forward tolerance (tests/test_models.py)
FWD_TOL = dict(rtol=2e-2, atol=2e-3)
B = 2


def both(**kw):
    """The same config in both packages (float32)."""
    return RModel(**kw), TModel(**kw)


def tree_flat(tree) -> dict:
    f, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in f}


def random_arrays(shapes: dict, seed: int, scale: float = 0.3) -> dict:
    """numpy float32 normals of each shape (biases included: nonzero)."""
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()}


def layer_weights(tcfg, shapes: dict, seed: int = 0):
    """One layer's weights without its norm, as jax and torch leaves."""
    w = random_arrays({k: s for k, s in shapes.items() if not k.startswith("ln")}, seed)
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v.copy()) for k, v in w.items()})


def random_cache(shapes: dict, seed: int):
    c = random_arrays(shapes, seed, scale=1.0)
    return ({k: jnp.asarray(v) for k, v in c.items()},
            {k: torch.from_numpy(v.copy()) for k, v in c.items()})


def flat_shapes(cfg_fn, tcfg, **kw) -> dict:
    out, stack = {}, [("", cfg_fn(tcfg, **kw))]
    while stack:
        prefix, tree = stack.pop()
        for k, v in tree.items():
            if isinstance(v, dict):
                stack.append((f"{prefix}{k}/", v))
            else:
                out[prefix + k] = v
    return out


def run_steps(rcfg, tcfg, r_fn, t_fn, rp, tp, rcache, tcache, positions, seed=1):
    """Feed a random (B, 1, D) input at each position through both
    packages' layer; compare every output and the cache after each step.
    The port's cache is written in place."""
    rng = np.random.RandomState(seed)
    for pos in positions:
        x = (rng.randn(B, 1, rcfg.d_model) * 0.5).astype(np.float32)
        r_out, r_upd = r_fn(rcfg, rp, jnp.asarray(x), jnp.asarray(pos, jnp.int32), rcache)
        rcache = {**rcache, **r_upd}
        before = {k: v.data_ptr() for k, v in tcache.items()}
        t_out, t_ret = t_fn(tcfg, tp, torch.from_numpy(x), torch.tensor(pos), tcache)
        assert t_ret is tcache and all(tcache[k].data_ptr() == p for k, p in before.items())
        np.testing.assert_allclose(t_out.numpy(), np.asarray(r_out),
                                   err_msg=f"pos {pos}", **LAYER_TOL)
        for k in rcache:
            np.testing.assert_allclose(tcache[k].numpy(), np.asarray(rcache[k]),
                                       err_msg=f"{k} at pos {pos}", **LAYER_TOL)


TINY = dict(name="t", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
# (config, cache slots, positions): one step at a position past the start
# (the random cache's earlier slots are attended to), then several steps
ATTN_CASES = {
    "gqa": (TINY, 16, [5], [0, 1, 2, 3, 4, 5]),
    "mha_bias": ({**TINY, "num_kv_heads": 4, "attn_bias": True}, 16, [7], range(6)),
    "rope_theta": ({**TINY, "rope_theta": 5e5}, 16, [9], range(3, 9)),
    "mrope": ({**TINY, "pos_kind": "mrope", "mrope_sections": (4, 2, 2)}, 16, [6],
              range(6)),
    # the ring holds the window's 6 slots only: positions 4..15 wrap it twice
    "swa_ring": ({**TINY, "sliding_window": 6}, 6, [13], range(4, 16)),
    # a ring longer than the window: the window hides slots still valid
    "swa_window_in_ring": ({**TINY, "sliding_window": 6}, 16, [12], range(8, 20)),
}


MLA = dict(name="m", arch_type="dense", num_layers=2, d_model=64, num_heads=4,
           num_kv_heads=4, d_ff=128, vocab_size=64, mla=True, q_lora_rank=32,
           kv_lora_rank=16, qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16)


SSM = dict(name="s", arch_type="ssm", num_layers=2, d_model=32, vocab_size=64,
           ssm_state=4)


# ---------------------------------------------------------------------------
# cache layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cache_matches_reference(arch):
    """``init_cache`` of every SMOKE config: the reference's paths (jax's
    flatten order), shapes and dtypes, zeros."""
    want = tree_flat(r_init_cache(r_config(arch, smoke=True), B, 32))
    got = init_cache(t_config(arch, smoke=True), B, 32, device="cpu")
    assert list(got) == list(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == np.dtype(w.dtype).name, k
        assert not got[k].any(), k


@pytest.mark.parametrize("arch", ARCHS)
def test_full_cache_shapes_match_reference(arch):
    """The published configs' cache shapes at decode_32k's batch and
    length (nothing allocated), and the dtype rule on every path."""
    rcfg, tcfg = r_config(arch), t_config(arch)
    want = tree_flat(r_cache_shapes(rcfg, 128, 32768))
    got = cache_shapes(tcfg, 128, 32768)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k] == tuple(w), k
        assert str(_cache_dtype(tcfg, k)).removeprefix("torch.") == \
            np.dtype(r_cache_dtype(rcfg, k)).name, k


# ---------------------------------------------------------------------------
# decode against the port's own forward (tests/test_models.py's cases)
# ---------------------------------------------------------------------------

def forward_logits(cfg, params, tokens, extra=None):
    h, _ = forward(cfg, params, {"tokens": tokens, **(extra or {})})
    return _logits(cfg, params, h)[..., :cfg.vocab_size]


def decode_all(cfg, params, cache, tokens):
    outs = []
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1],
                                    torch.tensor(t))
        outs.append(logits)
    return torch.stack(outs, dim=1)


def setup(cfg, S, b=B, seed=1):
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (b, S),
                           generator=torch.Generator().manual_seed(seed))
    return params, tokens


@pytest.mark.parametrize("cfg_kw", [
    {},                                        # plain GQA
    {"sliding_window": 8},                     # SWA
    {"attn_bias": True, "num_kv_heads": 4},    # MHA + bias
    {"tie_embeddings": True},
], ids=["gqa", "swa", "mha_bias", "tied"])
def test_decode_matches_forward_dense(cfg_kw):
    cfg = TModel(**{**TINY, **cfg_kw})
    params, toks = setup(cfg, 12)
    dec = decode_all(cfg, params, init_cache(cfg, B, 32, device="cpu"), toks)
    np.testing.assert_allclose(dec.numpy(), forward_logits(cfg, params, toks).numpy(),
                               **FWD_TOL)


def test_decode_matches_forward_ssm():
    cfg = TModel(**{**SSM, "ssm_state": 8, "d_model": 64})
    params, toks = setup(cfg, 10)
    dec = decode_all(cfg, params, init_cache(cfg, B, 32, device="cpu"), toks)
    np.testing.assert_allclose(dec.numpy(), forward_logits(cfg, params, toks).numpy(),
                               **FWD_TOL)


def test_decode_matches_forward_mla():
    cfg = TModel(**MLA)
    params, toks = setup(cfg, 8)
    dec = decode_all(cfg, params, init_cache(cfg, B, 16, device="cpu"), toks)
    np.testing.assert_allclose(dec.numpy(), forward_logits(cfg, params, toks).numpy(),
                               **FWD_TOL)


def test_swa_ring_buffer_beyond_window():
    """16 tokens through a cache of the window's 6 slots: the last logits
    equal the forward's, which masks to the window."""
    cfg = TModel(**{**TINY, "sliding_window": 6})
    params, toks = setup(cfg, 16, b=1)
    cache = init_cache(cfg, 1, 6, device="cpu")
    assert cache["layers/l0/k"].shape[2] == 6
    dec = decode_all(cfg, params, cache, toks)
    np.testing.assert_allclose(dec[:, -1].numpy(),
                               forward_logits(cfg, params, toks)[:, -1].numpy(),
                               **FWD_TOL)


def test_whisper_encode_for_decode_consistency():
    cfg = TModel(name="w", arch_type="audio", num_layers=2, d_model=64,
                 num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=64,
                 norm_kind="ln", mlp_kind="gelu", pos_kind="sinusoidal",
                 encoder_layers=2, encoder_seq=12, cross_attention=True,
                 frontend="audio")
    params, toks = setup(cfg, 8)
    audio = torch.randn((B, 12, 64), generator=torch.Generator().manual_seed(3))
    cache = encode_for_decode(cfg, params, init_cache(cfg, B, 16, device="cpu"), audio)
    dec = decode_all(cfg, params, cache, toks)
    full = forward_logits(cfg, params, toks, {"audio_embeds": audio})
    np.testing.assert_allclose(dec[:, -1].numpy(), full[:, -1].numpy(), **FWD_TOL)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **FWD_TOL)


def test_mamba_chunk_boundary_consistency(monkeypatch):
    """A sequence across several of the full path's chunks equals the
    one-token recurrence."""
    cfg = TModel(**{**SSM, "num_layers": 1, "vocab_size": 16})
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = {k.removeprefix("layers/l0/mamba/"): v[0] for k, v in params.items()
         if k.startswith("layers/l0/mamba/")}
    x = torch.randn((1, 20, 32), generator=torch.Generator().manual_seed(5))
    monkeypatch.setattr(TL, "MAMBA_CHUNK", 8)
    y_full = TL.mamba(cfg, p, x)
    cache = {"h": torch.zeros((1, cfg.d_inner, 4)),
             "conv": torch.zeros((1, cfg.ssm_conv - 1, cfg.d_inner))}
    y_dec = torch.cat([TL.mamba_decode(cfg, p, x[:, t], cache)[0] for t in range(20)], 1)
    np.testing.assert_allclose(y_dec.numpy(), y_full.numpy(), **FWD_TOL)
