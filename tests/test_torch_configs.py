"""The port's config registry, the twelve configs, parameter shapes,
counts and init rules against the reference's.

Every check here is exact: the configs are data, and the shapes and
counts follow from them."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as R
import repro_torch.configs as T

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat}


def test_registry_matches_reference():
    assert T.ARCHS == R.ARCHS and T.ASSIGNED == R.ASSIGNED
    for name in ("qwen2-vl-7b", "llama3.2-1b", "jamba-1.5-large-398b", "bert_100m"):
        assert T.canon(name) == R.canon(name)
    assert {k: dataclasses.astuple(v) for k, v in T.INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in R.INPUT_SHAPES.items()}
    for arch in R.ARCHS:
        rc, tc = R.get_config(arch), T.get_config(arch)
        assert T.long_context_eligible(tc) == R.long_context_eligible(rc), arch
        for shape in R.INPUT_SHAPES:
            assert T.shape_eligible(tc, shape) == R.shape_eligible(rc, shape)


@pytest.mark.parametrize("arch", R.ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_match_reference(arch, smoke):
    """Field for field, the dtype mapped; the derived widths too."""
    rc, tc = R.get_config(arch, smoke), T.get_config(arch, smoke)
    want = dataclasses.asdict(rc)
    want["dtype"] = DTYPES[rc.dtype]
    assert dataclasses.asdict(tc) == want
    for prop in ("padded_vocab", "hd", "d_inner", "dt_rank", "moe_ff"):
        assert getattr(tc, prop) == getattr(rc, prop), prop
    assert tc.layer_kinds() == rc.layer_kinds()
    assert tc.scan_blocks() == rc.scan_blocks()
    assert tc.uses_swa(0) == rc.uses_swa(0)
