"""Sharded serving on four gloo CPU ranks against the reference: the other
six SMOKE architectures in the default, FSDP and flat layouts (decode) and
the default and FSDP layouts (prefill), with the checks and tolerances of
``test_torch_serve_mesh.py``; and dbrx's prefill at capacity factor 0.5,
whose experts drop choices, with the batch over ``data``: each rank
places its tokens' choices after the earlier data shard's, as the
reference's one (global) cumsum does, so the kept choices are the
reference's.  ONE ``spawn`` for every case; no jax at the top.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.models.layers as L
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import train as T
from test_torch_serve_mesh import (check_decode, check_prefill, decode_runs,
                                   inputs, run_cases)
from torch_priority import lower_priority  # noqa: F401 (autouse)

HERE = ARCHS[6:]
DROPS = "dbrx_132b/drops"
DROP_CFG = {"capacity_factor": 0.5}        # 16 slots an expert for 32 choices on average


def dropped_choices(arch: str, overrides: dict, ins: dict) -> list[int]:
    """The choices past their expert's capacity in each MoE layer of the
    one-process prefill (``layers.moe_slots``'s ``keep``)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
    orig, dropped = L.moe_slots, []

    def slots(cfg, ic, cap):
        slot, keep = orig(cfg, ic, cap)
        dropped.append(int((~keep).sum()))
        return slot, keep
    L.moe_slots = slots
    try:
        batch = {k: torch.from_numpy(v) for k, v in ins["prefill"].items()}
        T.make_prefill_step(cfg)(params_from_numpy(ins["weights"], "cpu"), batch)
    finally:
        L.moe_slots = orig
    return dropped


@pytest.fixture(scope="module")
def results():
    cases = {arch: (arch, {}, inputs(arch)) for arch in HERE}
    cfg = dataclasses.replace(get_config("dbrx_132b", smoke=True), **DROP_CFG)
    cases[DROPS] = ("dbrx_132b", DROP_CFG, inputs("dbrx_132b", cfg))
    return (*run_cases(cases), cases)


@pytest.mark.parametrize("arch", HERE)
def test_sharded_decode_matches_reference(results, arch):
    ref, port, _ = results
    check_decode(ref[arch], port[arch], arch)


@pytest.mark.parametrize("arch", HERE)
def test_sharded_prefill_matches_reference(results, arch):
    ref, port, _ = results
    check_prefill(ref[arch], port[arch], arch)


def test_moe_prefill_with_drops_keeps_the_global_slot_order(results):
    ref, port, cases = results
    dropped = dropped_choices(*cases[DROPS])
    assert len(dropped) == 2 and min(dropped) > 0, dropped    # both MoE layers drop
    check_prefill(ref[DROPS], port[DROPS], "dbrx_132b")


def test_rank_blocks_are_local_shards(results):
    for arch in HERE:
        for layout in decode_runs(results[1][arch]):
            assert results[1][arch][layout]["blocks_ok"], (arch, layout)


def test_no_gather_exceeds_the_logits(results):
    for arch in HERE:
        res = results[1][arch]
        for layout in decode_runs(res):
            assert res[layout]["gathers_ok"], (arch, layout, res[layout]["largest_gather"])


def test_reference_cases_cover_every_architecture():
    """The two modules together serve all twelve SMOKE architectures."""
    from test_torch_serve_mesh import HERE as FIRST
    assert sorted(FIRST + HERE) == sorted(ARCHS)
