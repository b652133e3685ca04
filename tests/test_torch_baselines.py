"""The paper's comparison baselines (``repro_torch.core.baselines``) against
the reference (``repro.core.baselines``).

Tolerances, each with its reason:

* Compressors on shared numpy inputs: ``kth_largest_abs``, ``topk_mask``,
  ``randk_unbiased`` and ``randp_unbiased`` bit for bit (integer counts,
  elementwise float32 operations, the reference's key streams);
  ``sign_quant``'s signs bit for bit and its scale within rtol 1e-6 (one
  float32 mean, summed in another order).
* Each branch one round at a time from the reference's state, on the
  reference's linear task (tests/test_baselines.py: y = x W, squared
  loss, G = 4 clients), same batch and key: parameters, losses and every
  state leaf at ROUND_TOL, rtol 1e-5 and atol 1e-6 of the leaf's largest
  magnitude (float32 gradient sums in another order; ~1e-7 measured;
  MARINA's g at MARINA_TOL, whose comment gives the reason).  A
  top-k coordinate kept by one package and not the other (topk_ef, cdadam,
  fetchsgd) would move by its own size, far outside it: none does here.

Five free rounds of each algorithm on the bench LM, through both
packages' ``run_scan``, are in tests/test_torch_baselines_free.py.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as rb
from repro.core.adaptive import AdaConfig as RAda
from repro.core.sketch import SketchConfig as RSketch
from repro_torch import prng
from repro_torch.core import baselines as tb
from repro_torch.core.adaptive import AdaConfig as TAda
from repro_torch.core.sketch import SketchConfig as TSketch
from repro_torch.models.config import ModelConfig as TModel
from test_torch_safl import QUICK_KW, _weights
from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)

G = 4
ROUNDS = 4
NAMES = ["fedavg", "fedopt", "topk_ef", "cdadam", "fetchsgd", "onebit_adam",
         "marina", "cocktail"]


def _both(**kw):
    """The same settings as (reference, port) objects: ``server`` and
    ``sketch`` given as dicts."""
    def make(ada, sketch, cfg):
        k = dict(kw)
        if "server" in k:
            k["server"] = ada(**k["server"])
        if "sketch" in k:
            k["sketch"] = sketch(**k["sketch"])
        return cfg(**k)
    return (make(RAda, RSketch, rb.BaselineConfig),
            make(TAda, TSketch, tb.BaselineConfig))


# the reference's test configs (tests/test_baselines.py), with fedopt and
# cdadam added, the independent hash for fetchsgd, onebit_adam's warmup
# inside the 4 rounds and MARINA's full-sync probability raised so both
# of their branches run
LINEAR = {
    "fedavg": dict(client_lr=0.05, local_steps=2),
    "fedopt": dict(client_lr=0.05, local_steps=2,
                   server=dict(name="amsgrad", lr=0.01)),
    "topk_ef": dict(client_lr=0.05, local_steps=2, topk_ratio=0.25),
    "cdadam": dict(client_lr=0.05, local_steps=2, topk_ratio=0.25,
                   server=dict(name="adam", lr=0.05)),
    "fetchsgd": dict(client_lr=0.05, local_steps=2, topk_ratio=0.25,
                     fetchsgd_momentum=0.9,
                     sketch=dict(kind="countsketch", ratio=0.25, min_b=8,
                                 cs_hash="independent")),
    "onebit_adam": dict(client_lr=0.05, local_steps=2, onebit_warmup=2,
                        server=dict(name="adam", lr=0.05)),
    "marina": dict(client_lr=0.05, local_steps=1, topk_ratio=0.25,
                   marina_p=0.3, server=dict(name="sgd", lr=0.5)),
    "cocktail": dict(client_lr=0.05, local_steps=2, topk_ratio=0.25,
                     server=dict(name="sgd", lr=0.5)),
}
# round t runs under key(KEY0 + t): MARINA's draws are full sync at t = 0,
# then compressed differences (asserted below)
KEY0 = 101
ROUND_TOL = dict(rtol=1e-5, atol_scale=1e-6)
# MARINA's compressed round adds the difference of two gradients (each
# ~1e-7 relative off the reference's), scaled by 1/p = 10/3, to g: the
# error is relative to the gradients, not to g (2.4e-6 at |g| <= 1.2
# measured)
MARINA_TOL = dict(rtol=1e-5, atol_scale=1e-5)

_W_TRUE = np.random.RandomState(0).randn(16, 4).astype(np.float32)


def _linear_batch(t, k):
    """Round t's (G, K, 8, ...) batch of the linear task, from numpy."""
    x = np.random.RandomState(1000 + t).randn(G, k, 8, 16).astype(np.float32)
    return {"x": x, "y": x @ _W_TRUE}


def _r_linear(params, batch):
    return jnp.mean((batch["x"] @ params["W"] - batch["y"]) ** 2)


def _t_linear(params, batch):
    return torch.mean((batch["x"] @ params["W"] - batch["y"]) ** 2)


def _to_port(tree):
    """A reference tree (nested dicts of arrays) as the port's tensors."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _assert_close(got, want, what="", rtol=1e-5, atol_scale=1e-6):
    """Every leaf of a port tree against the reference's at the tolerance
    (integer leaves exactly)."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_close(got[k], want[k], f"{what}/{k}", rtol, atol_scale)
        return
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    atol = atol_scale * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# compressors
# ---------------------------------------------------------------------------

def _vectors():
    rng = np.random.RandomState(3)
    ties = np.repeat(rng.randn(50).astype(np.float32), 40)
    rng.shuffle(ties)
    zeros = rng.randn(1000).astype(np.float32)
    zeros[rng.rand(1000) < 0.7] = 0.0
    zeros[::97] = -0.0
    return {"normal": rng.randn(3000).astype(np.float32),
            "ties": ties,                              # 40 copies of each value
            "zeros": zeros,                            # 70% +-0
            "all_zero": np.zeros(64, np.float32),
            "tiny": (rng.randn(500) * 1e-39).astype(np.float32),  # subnormal
            "one": np.array([-2.5], np.float32)}


@pytest.mark.parametrize("which", list(_vectors()))
def test_kth_largest_abs_and_topk_mask_bitwise(which):
    v = _vectors()[which]
    n = v.shape[0]
    for k in sorted({1, max(1, n // 10), n - 1 or 1, n + 5}):
        kk = min(k, n)
        want = np.asarray(rb.kth_largest_abs(jnp.asarray(v), kk))
        thresh = tb.kth_largest_abs(torch.from_numpy(v), kk).numpy()
        assert thresh.view(np.uint32) == want.view(np.uint32), (which, k)
        assert thresh == np.sort(np.abs(v))[::-1][kk - 1]
        got = tb.topk_mask(torch.from_numpy(v), k).numpy()
        if which != "tiny":
            # XLA:CPU compares subnormals as zero, so the reference's mask
            # keeps every subnormal entry; the port keeps the k largest
            want = np.asarray(rb.topk_mask(jnp.asarray(v), k))
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        kept = np.abs(v) >= thresh              # ties at the threshold all kept
        assert kept.sum() >= kk
        np.testing.assert_array_equal(got, np.where(kept, v, 0.0))


def test_kth_largest_abs_rows_are_independent():
    """The port searches each row of a (G, n) buffer (topk_ef's packed
    clients) at once: row by row the reference's result."""
    v = np.random.RandomState(5).randn(5, 777).astype(np.float32)
    v[2] = 0.0
    v[3, :400] = 1.5
    got = tb.topk_mask(torch.from_numpy(v), 60).numpy()
    for r in range(5):
        want = np.asarray(rb.topk_mask(jnp.asarray(v[r]), 60))
        np.testing.assert_array_equal(got[r].view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n,k", [(10, 3), (1000, 1000), (4096, 1), (90_432, 4521)])
def test_randk_unbiased_bitwise(n, k):
    v = np.random.RandomState(n).randn(n).astype(np.float32)
    for seed in (0, 7):
        want = np.asarray(rb.randk_unbiased(jax.random.key(seed), jnp.asarray(v), k))
        got = tb.randk_unbiased(prng.key(seed), torch.from_numpy(v), k).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        assert np.count_nonzero(got) == k


@pytest.mark.parametrize("p", [0.25, 0.05, 1 / 3, 0.999])
def test_randp_unbiased_bitwise(p):
    v = np.random.RandomState(2).randn(20_000).astype(np.float32)
    for seed in (1, 12):
        jk = jax.random.fold_in(jax.random.key(seed), 3)
        pk = prng.fold_in(prng.key(seed), 3)
        want = np.asarray(rb.randp_unbiased(jk, jnp.asarray(v), p))
        got = tb.randp_unbiased(pk, torch.from_numpy(v), p).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_sign_quant_and_per_leaf():
    v = np.random.RandomState(4).randn(3, 1001).astype(np.float32)
    v[1, ::3] = 0.0
    got = tb.sign_quant(torch.from_numpy(v)).numpy()
    for r in range(3):
        want = np.asarray(rb.sign_quant(jnp.asarray(v[r])))
        np.testing.assert_array_equal(np.sign(got[r]), np.sign(want))
        np.testing.assert_allclose(got[r], want, rtol=1e-6, atol=0)
    tree = {"b": torch.arange(6.0).reshape(2, 3), "a": torch.ones(4)}
    out = tb._per_leaf(lambda i, x: x * (i + 1), tree)
    assert torch.equal(out["a"], torch.ones(4))           # leaf 0: "a"
    assert torch.equal(out["b"], 2 * tree["b"])


# ---------------------------------------------------------------------------
# one round at a time from the reference's state
# ---------------------------------------------------------------------------

def _linear_params():
    w0 = np.random.RandomState(9).randn(16, 4).astype(np.float32) * 0.1
    return {"W": jnp.asarray(w0)}


def test_uplink_bits_match_reference_for_every_name():
    rparams, tparams = _weights(TModel(**QUICK_KW), 0)
    for name in NAMES:
        for ratio in (0.01, 0.05):
            rcfg, tcfg = _both(name=name, topk_ratio=ratio,
                               sketch=dict(kind="countsketch", ratio=ratio, min_b=8))
            assert tb.uplink_bits(tcfg, tparams) == rb.uplink_bits(rcfg, rparams)
    with pytest.raises(ValueError):
        tb.uplink_bits(tb.BaselineConfig(name="nope"), tparams)
