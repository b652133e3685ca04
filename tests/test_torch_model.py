"""repro_torch models, optimizer and checkpoint bridge against the reference.

Both packages run from the same weights, carried across by
``params_from_numpy`` (and by the reference's own checkpoint format):
loss and gradients must agree up to float32 summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import save_checkpoint
from repro.configs import bert_100m as rbert
from repro.core.adaptive import AdaConfig as RAda
from repro.core.adaptive import apply_update as r_apply
from repro.core.adaptive import init_opt_state as r_init_opt
from repro.models import ModelConfig as RModel
from repro.models import init_params as r_init
from repro.models import loss_fn as r_loss
from repro_torch.checkpoint.io import (params_from_numpy, params_to_numpy,
                                       restore_checkpoint)
from repro_torch.configs import bert_100m as tbert
from repro_torch.core.adaptive import AdaConfig as TAda
from repro_torch.core.adaptive import apply_update as t_apply
from repro_torch.core.adaptive import init_opt_state as t_init_opt
from repro_torch.models.config import ModelConfig as TModel
from repro_torch.models.model import init_params as t_init
from repro_torch.models.model import loss_fn as t_loss
from repro_torch.models.model import param_shapes as t_param_shapes

from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)

QUICK_KW = dict(name="tiny", arch_type="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128)
MODELS = {"bert_smoke": (rbert.SMOKE, tbert.SMOKE),       # ln/gelu/sinusoidal/bias
          "quickstart": (RModel(**QUICK_KW), TModel(**QUICK_KW))}  # rms/swiglu/rope/GQA


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(l)
            for path, l in flat}


@pytest.mark.parametrize("which", list(MODELS))
def test_loss_and_grads_match_reference(which):
    rmodel, tmodel = MODELS[which]
    rparams = r_init(rmodel, jax.random.key(1))
    tokens = np.random.RandomState(0).randint(0, rmodel.vocab_size, (2, 24))
    rl, rg = jax.jit(jax.value_and_grad(
        lambda p: r_loss(rmodel, p, {"tokens": jnp.asarray(tokens)})))(rparams)

    tparams = params_from_numpy(_flat(rparams), "cpu")
    assert list(tparams) == list(t_param_shapes(tmodel))
    for p in tparams.values():
        p.requires_grad_(True)
    tl = t_loss(tmodel, tparams, {"tokens": torch.from_numpy(tokens)})
    tg = torch.autograd.grad(tl, list(tparams.values()), allow_unused=True)
    # float32 matmuls and reductions in other orders: ~1e-6 relative
    np.testing.assert_allclose(tl.item(), float(rl), rtol=1e-5)
    for (k, want), got in zip(_flat(rg).items(), tg):
        got = np.zeros_like(want) if got is None else got.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=k)


def test_init_params_shapes_and_cuda_raises_without_a_card():
    tp = t_init(tbert.SMOKE, torch.Generator().manual_seed(0), device="cpu")
    rp = _flat(jax.tree.map(lambda s: np.empty(s.shape, np.float32),
                            jax.eval_shape(lambda: r_init(rbert.SMOKE,
                                                          jax.random.key(0)))))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in rp.items()}
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises((RuntimeError, AssertionError)):
        t_init(tbert.SMOKE, torch.Generator().manual_seed(0))


def test_restore_reference_checkpoint(tmp_path):
    rparams = r_init(RModel(**QUICK_KW), jax.random.key(2))
    state = {"params": rparams, "opt": r_init_opt(RAda(), rparams)}
    save_checkpoint(str(tmp_path / "ck"), state, step=7)
    like = {"params": t_init(TModel(**QUICK_KW),
                             torch.Generator().manual_seed(0), device="cpu")}
    like["opt"] = t_init_opt(TAda(), like["params"])
    got, step = restore_checkpoint(str(tmp_path / "ck"), like)
    assert step == 7
    want = _flat(state)
    got_flat = _flat_torch(got)
    assert set(got_flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got_flat[k], v, err_msg=k)


def _flat_torch(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_torch(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", ["amsgrad", "adam", "adagrad", "sgd", "sgdm"])
def test_apply_update_matches_reference(name):
    kw = dict(name=name, lr=0.05, weight_decay=0.01,
              bias_correction=name == "adam")
    rcfg, tcfg = RAda(**kw), TAda(**kw)
    rng = np.random.RandomState(4)
    params = {"w": rng.randn(6, 5).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rs = r_init_opt(rcfg, rp)
    tp = params_from_numpy(params, "cpu")
    ts = t_init_opt(tcfg, tp)
    for _ in range(4):
        u = {k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        rp, rs = r_apply(rcfg, rs, rp, {k: jnp.asarray(v) for k, v in u.items()})
        tp, ts = t_apply(tcfg, ts, tp, params_from_numpy(u, "cpu"))
    # elementwise float32 arithmetic in the reference's order
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                   rtol=1e-6, atol=1e-6)
    got = _flat_torch(params_to_numpy(ts))
    assert set(got) == set(_flat(rs))
    for k, v in _flat(rs).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6, err_msg=k)


def test_bfloat16_tree_crosses_the_bridge_bit_for_bit():
    """A bfloat16 tree of the reference crosses ``params_from_numpy`` as
    torch.bfloat16 and comes back through ``params_to_numpy`` with the
    same bits (numpy has no bfloat16 of its own; jax's is ml_dtypes')."""
    vals = jax.random.normal(jax.random.key(5), (3, 7)) * 40.0
    tree = {"w": np.array(vals.astype(jnp.bfloat16)),
            "opt": {"m": np.array(jnp.asarray([1e-30, -0.0, 3.5e38, 1.0],
                                              jnp.bfloat16))}}
    got = params_from_numpy(tree, "cpu")
    assert got["w"].dtype == got["opt"]["m"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].to(torch.float32).numpy(),
                                  np.asarray(vals.astype(jnp.bfloat16), np.float32))
    back = params_to_numpy(got)
    for a, b in ((back["w"], tree["w"]), (back["opt"]["m"], tree["opt"]["m"])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))
