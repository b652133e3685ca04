"""The model zoo's MoE and MLA/MTP families against the reference: dbrx
(top-4 of 16 experts) and deepseek-v3 (MLA, a shared expert, leading
dense blocks, the MTP loss).

The SMOKE configs' loss and every gradient from carried weights, as in
tests/test_torch_zoo_dense.py, and the MoE routing (top-k experts,
capacity slots, the kept mask) bit for bit against the reference's own
ops.  tests/test_torch_zoo_ssm.py holds the Mamba families.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import repro.models.layers as RL
import repro_torch.models.layers as TL
from repro.configs import get_config as r_config
from repro_torch.configs import get_config as t_config
from repro_torch.models.model import init_params as t_init
from repro_torch.models.model import loss_fn as t_loss
from test_torch_zoo_dense import (check_against_reference, layer0_params,
                                  smoke_batch)
from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ["dbrx_132b", "deepseek_v3_671b"])
def test_smoke_loss_and_grads_match_reference(arch):
    rcfg = r_config(arch, smoke=True)
    check_against_reference(rcfg, t_config(arch, smoke=True), smoke_batch(rcfg))


def ref_routing(cfg, p, xf):
    """The reference's routing, in its own ops (repro/models/layers.py
    ``moe``: the router, ``lax.top_k``, the capacity and the one-hot cumsum
    slots, chunk by chunk).  Returns (topw, topi, [(slot, keep)] a
    chunk)."""
    E, k = cfg.num_experts, cfg.moe_top_k
    T = xf.shape[0]
    probs = jax.nn.softmax((xf @ p["router"]).astype(jnp.float32), axis=-1)
    topw, topi = lax.top_k(probs, k)
    topw = topw / (jnp.sum(topw, axis=-1, keepdims=True) + 1e-9)
    tc = min(RL.MOE_CHUNK, T)
    cap = max(8, int(tc * k / E * cfg.capacity_factor))
    ip = jnp.pad(topi, ((0, -(-T // tc) * tc - T), (0, 0)))
    chunks = []
    for c0 in range(0, ip.shape[0], tc):
        fi = ip[c0:c0 + tc].reshape(-1)
        pos_mat = jnp.cumsum(jax.nn.one_hot(fi, E, dtype=jnp.int32), axis=0) - 1
        posn = jnp.take_along_axis(pos_mat, fi[:, None], axis=1)[:, 0]
        keep = posn < cap
        chunks.append((np.asarray(jnp.where(keep, fi * cap + posn, E * cap)),
                       np.asarray(keep)))
    return np.asarray(topw), np.asarray(topi), chunks


@pytest.mark.parametrize("arch", ["dbrx_132b", "deepseek_v3_671b"])
@pytest.mark.parametrize("chunk", [None, 32])
@pytest.mark.parametrize("skew", [False, True])
def test_moe_routing_bit_for_bit(monkeypatch, arch, chunk, skew):
    """80 tokens through layer 0's MoE: the top-k experts, each choice's
    buffer row and the kept mask equal the reference's bit for bit, in one
    chunk and in chunks of 32 (the last padded); ``skew`` sends every
    token's first choice to expert 0, past its capacity, so the dump row
    takes the overflow.  The output and the aux loss agree to float32
    order."""
    if chunk:
        monkeypatch.setattr(RL, "MOE_CHUNK", chunk)
        monkeypatch.setattr(TL, "MOE_CHUNK", chunk)
    rcfg, tcfg = r_config(arch, smoke=True), t_config(arch, smoke=True)
    rp, tp = layer0_params(rcfg, "moe")
    x = np.random.RandomState(3).randn(2, 40, rcfg.d_model).astype(np.float32)
    if skew:
        x += 1.0
        router = np.asarray(rp["router"]).copy()
        router[:, 0] += 0.5
        rp = {**rp, "router": jnp.asarray(router)}
        tp["router"] = torch.from_numpy(router)
    topw_r, topi_r, chunks_r = ref_routing(rcfg, rp, jnp.asarray(x.reshape(80, -1)))
    topw_t, topi_t, aux_t = TL.moe_route(tcfg, tp, torch.from_numpy(x.reshape(80, -1)))
    np.testing.assert_array_equal(topi_t.numpy(), topi_r)
    np.testing.assert_allclose(topw_t.numpy(), topw_r, rtol=1e-6, atol=1e-7)
    tc, cap = TL.moe_capacity(tcfg, 80)
    ip = torch.nn.functional.pad(topi_t, (0, 0, 0, len(chunks_r) * tc - 80))
    kept = []
    for i, (slot_r, keep_r) in enumerate(chunks_r):
        slot_t, keep_t = TL.moe_slots(tcfg, ip[i * tc:(i + 1) * tc], cap)
        np.testing.assert_array_equal(slot_t.numpy(), slot_r)
        np.testing.assert_array_equal(keep_t.numpy(), keep_r)
        kept.append(keep_r)
    if skew:      # some of the real tokens' choices overflow
        assert not np.concatenate(kept)[:80 * tcfg.moe_top_k].all()
    out_r, aux_r = RL.moe(rcfg, rp, jnp.asarray(x))
    out_t, aux_t2 = TL.moe(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_r), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux_t.item(), float(aux_r), rtol=1e-6)
    assert aux_t2.item() == aux_t.item()


def test_moe_aux_loss_contributes():
    """The load-balance term raises the loss
    (tests/test_models.py::test_moe_capacity_and_aux_loss)."""
    cfg = dataclasses.replace(t_config("dbrx_132b", smoke=True),
                              router_aux_weight=0.1)
    params = t_init(cfg, torch.Generator().manual_seed(0), "cpu")
    b = {"tokens": torch.from_numpy(smoke_batch(cfg, S=16)["tokens"])}
    loss = t_loss(cfg, params, b)
    loss0 = t_loss(dataclasses.replace(cfg, router_aux_weight=0.0), params, b)
    assert torch.isfinite(loss) and loss.item() > loss0.item()
