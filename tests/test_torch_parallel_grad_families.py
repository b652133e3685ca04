"""The mesh client step's loss and gradients of the other model families on
four gloo CPU ranks against the reference's one-process
``jax.value_and_grad(loss_fn)``, with ``test_torch_parallel_grad.py``'s
checks and tolerances: dbrx (MoE) at capacity factor 0.5, whose experts
drop choices, so that with the rows over ``data`` (``cross_silo``) or
``model`` (``cross_device_dp``) each shard's choices take their slots
after the earlier shard's, as the reference's one global cumsum gives
them, and the load-balance aux loss's means are over the whole batch;
deepseek-v3 (MLA, a first dense layer, shared experts, the MTP head),
jamba (Mamba + MoE + attention, atol 2e-5), whisper (the encoder and
cross-attention) and qwen2-vl (the vision patches, M-RoPE).  Each config's
reference gradient is computed once and held against all three
topologies.  ONE ``spawn`` for every case; no jax at the top.
"""

import dataclasses

import pytest
import torch

import repro_torch.models.layers as L
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models.model import loss_fn
from test_torch_parallel_grad import (TOPOLOGIES, check_model, model_inputs,
                                      run_cases)
from torch_priority import lower_priority  # noqa: F401 (autouse)

DROPS = {"capacity_factor": 0.5}        # 16 slots an expert for 32 choices on average
HERE = (("dbrx_132b", DROPS), ("deepseek_v3_671b", {}), ("jamba_1_5_large_398b", {}),
        ("whisper_large_v3", {}), ("qwen2_vl_7b", {}))
ARCHS = [a for a, _ in HERE]


def dropped_choices(arch: str, overrides: dict, ins: dict) -> list[int]:
    """The choices past their expert's capacity in each MoE layer of the
    one-process loss (``layers.moe_slots``'s ``keep``)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
    orig, dropped = L.moe_slots, []

    def slots(cfg, ic, cap):
        slot, keep = orig(cfg, ic, cap)
        dropped.append(int((~keep).sum()))
        return slot, keep
    L.moe_slots = slots
    try:
        batch = {k: torch.from_numpy(v) for k, v in ins["batch"].items()}
        batch["tokens"] = batch["tokens"].long()
        loss_fn(cfg, params_from_numpy(ins["weights"], "cpu"), batch)
    finally:
        L.moe_slots = orig
    return dropped


@pytest.fixture(scope="module")
def results():
    cases = {arch: ("model", (arch, over), model_inputs(arch, over)) for arch, over in HERE}
    return (*run_cases(cases), cases)


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_grads_match_reference(results, arch, topology):
    ref, port, _ = results
    check_model(ref[arch], port[arch][topology], arch)


def test_moe_case_drops_choices_at_capacity(results):
    _, _, cases = results
    dropped = dropped_choices(*cases["dbrx_132b"][1], cases["dbrx_132b"][2])
    assert len(dropped) == 2 and min(dropped) > 0, dropped    # both MoE layers drop
