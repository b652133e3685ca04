"""The port's serving path against the reference: ``decode_step`` of every
SMOKE architecture teacher-forced from the reference's weights (logits at
each step and the final caches), one bfloat16 case, ``encode_for_decode``,
``input_specs``, ``synthetic_lm_batch`` and the greedy server
(``launch/serve.py``: ``run``, ``main``, ``example``).

The reference's ``decode_step`` is jitted once per architecture and cache
size (``pos`` a traced int32, as in ``repro/launch/serve.py``) and reused
for every step and test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, INPUT_SHAPES
from repro.configs import get_config as r_config
from repro.configs import input_specs as r_input_specs
from repro.data.synthetic import synthetic_lm_batch as r_synthetic_lm_batch
from repro.models import decode_step as r_decode_step
from repro.models import init_cache as r_init_cache
from repro.models.model import encode_for_decode as r_encode_for_decode
from repro_torch import prng
from repro_torch.checkpoint.io import params_to_numpy
from repro_torch.configs import get_config as t_config
from repro_torch.configs import input_specs
from repro_torch.data.synthetic import synthetic_lm_batch
from repro_torch.launch import serve
from repro_torch.models import decode_step, init_cache, init_params
from repro_torch.models.model import encode_for_decode

torch.set_num_threads(2)

B, MAX_SEQ, STEPS = 2, 32, 10
# float32 sums in other orders: the largest gaps measured over 10 steps,
# outside jamba, are 8.9e-7 in the logits (deepseek-v3) and 3.7e-6 in a
# cache (falcon-mamba's state)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# jamba's seven Mamba layers carry the gap into the last one's state: 1.6e-5
# measured in layers/l7/h (its logits 2.5e-6); tests/test_torch_zoo_ssm.py's atol
JAMBA_TOL = dict(rtol=1e-5, atol=2e-5)
# the greedy server's logits, every call: the largest gap measured is
# 1.8e-6 (the example's model; 3.9e-7 to 8.3e-7 for the SMOKE archs).  A
# top-2 margin above twice this atol cannot flip an argmax
GREEDY_TOL = dict(rtol=0, atol=5e-6)
# llama3.2-1b SMOKE in bfloat16 (8 significant bits): measured over 10
# steps, the logits differ by up to 9.8e-3 (|logit| <= 0.73, where a bf16
# ulp is 3.9e-3) and the caches by up to 3.1e-2 (|entry| <= 4.2, where an
# ulp is 3.1e-2), 11% of the cache's entries by at least an ulp
BF16_TOL = dict(rtol=1e-2, atol=4e-2)


def flat(tree) -> dict:
    f, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(l)
            for path, l in f}


def as_f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def t_numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def nest(flat_arrays: dict) -> dict:
    """"/"-joined paths -> the reference's nested dict of jax arrays."""
    tree = {}
    for path, a in flat_arrays.items():
        *heads, leaf = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(a)
    return tree


@functools.lru_cache(maxsize=None)
def weights(tcfg):
    """The port's init of ``tcfg`` (seed 1) and the same arrays as the
    reference's tree (its own init compiles a draw per leaf shape: ~9 s for
    deepseek-v3 SMOKE)."""
    tp = init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    return tp, nest(params_to_numpy(tp))


@functools.lru_cache(maxsize=None)
def ref_step(rcfg):
    return jax.jit(lambda p, c, t, i: r_decode_step(rcfg, p, c, t, i))


def audio_for(cfg, seed=3):
    return (np.random.RandomState(seed).randn(B, cfg.encoder_seq, cfg.d_model)
            * 0.02).astype(np.float32)


def teacher_forced(rcfg, tcfg, tol, steps=STEPS):
    """Both packages' decode from the reference's weights and caches (the
    encoder's too), fed the same tokens; every step's logits, then every
    cache entry."""
    tp, rp = weights(tcfg)
    rcache = r_init_cache(rcfg, B, MAX_SEQ)
    tcache = init_cache(tcfg, B, MAX_SEQ, device="cpu")
    if rcfg.encoder_layers:
        audio = audio_for(rcfg)
        rcache = r_encode_for_decode(rcfg, rp, rcache, jnp.asarray(audio).astype(rcfg.dtype))
        tcache = encode_for_decode(tcfg, tp, tcache,
                                   torch.from_numpy(audio).to(tcfg.dtype))
    toks = np.random.RandomState(0).randint(0, rcfg.vocab_size, (B, steps)).astype(np.int32)
    step = ref_step(rcfg)
    for t in range(steps):
        want, rcache = step(rp, rcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(t, jnp.int32))
        got, tcache = decode_step(tcfg, tp, tcache, torch.from_numpy(toks[:, t:t + 1]),
                                  torch.tensor(t))
        assert got.shape == (B, tcfg.vocab_size)
        np.testing.assert_allclose(t_numpy(got), as_f32(want), err_msg=f"step {t}", **tol)
    want_cache = flat(rcache)
    assert list(tcache) == list(want_cache)
    for k, w in want_cache.items():
        assert str(tcache[k].dtype).removeprefix("torch.") == w.dtype.name, k
        np.testing.assert_allclose(t_numpy(tcache[k]), as_f32(w), err_msg=k, **tol)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    """Every input of every published config and shape: the reference's
    tree, shapes and dtypes, as ``meta`` tensors (nothing allocated)."""
    want = r_input_specs(r_config(arch), shape)
    got = input_specs(t_config(arch), shape)
    assert set(got) == set(want)
    if "cache" in want:
        leaves, _ = jax.tree_util.tree_flatten_with_path(want["cache"])
        want = {**want, "cache": {"/".join(k.key for k in path): v for path, v in leaves}}
    for part, w in want.items():
        pairs = [(k, got[part][k], v) for k, v in w.items()] if isinstance(w, dict) \
            else [(part, got[part], w)]
        if isinstance(w, dict):
            assert list(got[part]) == list(w), part
        for k, g, v in pairs:
            assert g.device.type == "meta", k
            assert tuple(g.shape) == tuple(v.shape), k
            assert str(g.dtype).removeprefix("torch.") == np.dtype(v.dtype).name, k


@pytest.mark.parametrize("seed,batch,seq,vocab", [
    (0, 4, 16, 256), (7, 3, 33, 128256), (123, 1, 1, 2), (5, 8, 32, 51866)])
def test_synthetic_lm_batch_bit_for_bit(seed, batch, seq, vocab):
    want = np.asarray(r_synthetic_lm_batch(jax.random.key(seed), batch, seq, vocab)["tokens"])
    got = synthetic_lm_batch(prng.key(seed), batch, seq, vocab, device="cpu")["tokens"]
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def ref_greedy(rcfg, rp, prompt: np.ndarray, steps: int, max_seq: int, audio=None):
    """The reference's serve loop (repro/launch/serve.py), fed a prompt one
    token at a time first.  Returns (tokens, every call's logits)."""
    b, P = prompt.shape
    cache = r_init_cache(rcfg, b, max_seq)
    if audio is not None:
        cache = r_encode_for_decode(rcfg, rp, cache, jnp.asarray(audio))
    step = ref_step(rcfg)
    seq, logits_all = [prompt[:, t] for t in range(P)], []
    for t in range(P - 1 + steps):
        logits, cache = step(rp, cache, jnp.asarray(seq[t][:, None].astype(np.int32)),
                             jnp.asarray(t, jnp.int32))
        logits_all.append(np.asarray(logits))
        if t >= P - 1:
            seq.append(np.asarray(jnp.argmax(logits, axis=-1)))
    return np.stack(seq, axis=1), np.stack(logits_all)


def assert_margins(logits: np.ndarray):
    """Each call's top-2 gap exceeds twice ``GREEDY_TOL``, so two logits
    within it cannot swap an argmax between the packages."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 2 * GREEDY_TOL["atol"]


def test_serve_main_prints_its_line(capsys):
    out = serve.main(["--arch", "qwen2-7b", "--batch", "2", "--steps", "5",
                      "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("qwen2-7b: 2x5 tokens in ") and line.endswith("tok/s, CPU)")
    assert out["tokens"].shape == (2, 6)


def test_serve_smoke_flag_can_be_switched_off():
    """``--smoke`` is on by default and ``--no-smoke`` turns it off (the
    reference's ``store_true`` flag with default True cannot be)."""
    assert serve.parser().parse_args([]).smoke is True
    assert serve.parser().parse_args(["--no-smoke"]).smoke is False
    assert serve.parser().parse_args([]).device == "cuda"
