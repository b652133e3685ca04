"""The port's serving layouts and one-process prefill against the reference.

``infer_batch_pspecs``, ``cache_pspecs``, ``flat_tp_pspecs`` and
``flat_tp_cache_pspecs`` of ``launch/train.py`` equal the reference's
entry for entry (a ``PartitionSpec`` read as a tuple) for all twelve
configs at full width, on the inputs of ``configs.input_specs``
(``prefill_32k``, ``decode_32k``, and ``long_500k``, whose B = 1 leaves
the batch replicated) and the meshes 16 x 16, 2 x 16 x 16 and (2, 2).  The
shapes are abstract (``meta`` tensors, ``ShapeDtypeStruct``s), and the
reference is handed a stand-in with ``.shape`` and ``.axis_names``: no
device is needed.  Every SMOKE config and llama3.2-1b at full width cut
evenly on (2, 2) under each serving layout (the port's blocks are whole
blocks: nothing is padded).  Then ``make_prefill_step`` of one config of
each family against the reference's at SMOKE size in float32.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS
from repro.configs import get_config as r_config
from repro.configs import input_specs as r_input_specs
from repro.launch import train as R
from repro.models.model import param_shapes as r_param_shapes
from repro.models.sharding import param_pspecs as r_param_pspecs
from repro_torch.checkpoint.io import params_to_numpy
from repro_torch.configs import get_config as t_config
from repro_torch.configs import input_specs
from repro_torch.launch import train as T
from repro_torch.launch.mesh import Mesh
from repro_torch.models import init_params
from repro_torch.models.model import cache_shapes, param_shapes
from repro_torch.models.sharding import _block, param_pspecs

from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
SHAPES = ("prefill_32k", "decode_32k", "long_500k")
# one config of each family the port serves
FAMILIES = ("llama3_2_1b", "qwen2_vl_7b", "whisper_large_v3", "dbrx_132b",
            "falcon_mamba_7b", "jamba_1_5_large_398b", "deepseek_v3_671b")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# jamba's Mamba layers in other summation orders: tests/test_torch_zoo_ssm.py's atol
JAMBA_TOL = dict(rtol=1e-5, atol=2e-5)


def ref_flat(tree) -> dict:
    """A reference spec tree as the port's flat dict of tuples."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(p)
            for path, p in leaves}


def ref_mesh(name: str):
    sizes, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, sizes)), axis_names=axes)


def ref_abstract(rcfg):
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(tuple(s), rcfg.dtype),
                        r_param_shapes(rcfg), is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_input_layouts_match_reference(mesh_name, shape):
    """The batch's specs (prefill) and both cache layouts (decode) of every
    config, with the mesh and without it."""
    rmesh, tmesh = ref_mesh(mesh_name), Mesh(*MESHES[mesh_name])
    daxes = T.data_axes_of(tmesh)
    assert daxes == R.data_axes_of(rmesh)
    for arch in ARCHS:
        want, got = r_input_specs(r_config(arch), shape), input_specs(t_config(arch), shape)
        for m_ref, m_port in ((rmesh, tmesh), (None, None)):
            if "batch" in want:
                pairs = [(R.infer_batch_pspecs(want["batch"], daxes, m_ref),
                          T.infer_batch_pspecs(got["batch"], daxes, m_port))]
            else:
                pairs = [(R.cache_pspecs(want["cache"], daxes, m_ref),
                          T.cache_pspecs(got["cache"], daxes, m_port)),
                         (R.flat_tp_cache_pspecs(want["cache"], m_ref),
                          T.flat_tp_cache_pspecs(got["cache"], m_port))]
            for r, t in pairs:
                r = ref_flat(r)
                assert sorted(t) == sorted(r), arch
                for k, spec in r.items():
                    assert t[k] == spec, (arch, mesh_name, shape, k, t[k], spec)
    if shape == "long_500k":     # B = 1 divides no data axis: replicated batch
        assert all(s[1] is None for s in T.cache_pspecs(got["cache"], daxes, tmesh).values())


def test_flat_tp_pspecs_match_reference():
    """The flat layout of every config's weights, from the default and the
    FSDP specs: the contracting dim over (data, model), experts over E, the
    embedding over V, the rest replicated."""
    for arch in ARCHS:
        rcfg, tcfg = r_config(arch), t_config(arch)
        abstract = {k: torch.empty(s, device="meta") for k, s in param_shapes(tcfg).items()}
        for fsdp in (False, True):
            want = ref_flat(R.flat_tp_pspecs(r_param_pspecs(ref_abstract(rcfg), fsdp=fsdp)))
            got = T.flat_tp_pspecs(param_pspecs(abstract, fsdp=fsdp))
            assert list(got) == list(want), arch
            for k, spec in want.items():
                assert got[k] == spec, (arch, fsdp, k, got[k], spec)


def test_serving_layouts_cut_evenly_on_2x2():
    """Every block the CPU and card runs cut is a whole block: every leaf
    of every SMOKE config (B = 4, max_seq 32) and of llama3.2-1b at full
    width (B = 8, max_seq 128) divides its axes on (data 2, model 2),
    weights and cache, in the default, FSDP and flat layouts (``_block``
    raises on a remainder; GSPMD would pad)."""
    mesh = Mesh((2, 2), ("data", "model"))
    runs = [(t_config(a, smoke=True), 4, 32) for a in ARCHS]
    for cfg, b, max_seq in runs + [(t_config("llama3_2_1b"), 8, 128)]:
        for layout, fsdp in (("default", False), ("default", True), ("flat", False)):
            pspecs, cspecs, tspec = T.serve_specs(cfg, mesh, b, max_seq, layout=layout,
                                                  fsdp=fsdp)
            shapes = {**param_shapes(cfg), **cache_shapes(cfg, b, max_seq)}
            for k, spec in {**pspecs, **cspecs}.items():
                for r in range(4):
                    _block(mesh, shapes[k], spec, r)
            assert tspec[0] == (None if layout == "flat" else "data")


@functools.lru_cache(maxsize=None)
def weights(arch: str):
    tcfg = t_config(arch, smoke=True)
    tp = init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    rp = {}
    for path, a in params_to_numpy(tp).items():
        *heads, leaf = path.split("/")
        node = rp
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(a)
    return tp, rp


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_step_matches_reference(arch):
    """The one-process prefill step (B = 2, 16 tokens; a VLM's patches and
    an audio model's frames in front) against the reference's, jitted:
    the last token's logits over the padded vocabulary."""
    rcfg, tcfg = r_config(arch, smoke=True), t_config(arch, smoke=True)
    tp, rp = weights(arch)
    rs = np.random.RandomState(0)
    batch = {"tokens": rs.randint(0, tcfg.vocab_size, (2, 16)).astype(np.int32)}
    if tcfg.frontend == "vision":
        batch["patch_embeds"] = rs.randn(2, tcfg.num_frontend_tokens,
                                         tcfg.d_model).astype(np.float32)
    if tcfg.encoder_layers:
        batch["audio_embeds"] = (rs.randn(2, tcfg.encoder_seq, tcfg.d_model)
                                 * 0.02).astype(np.float32)
    want = jax.jit(R.make_prefill_step(rcfg))(rp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = T.make_prefill_step(tcfg)(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tuple(got.shape) == (2, tcfg.padded_vocab) == tuple(want.shape)
    tol = JAMBA_TOL if arch.startswith("jamba") else F32_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
