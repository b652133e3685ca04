"""The shard-local operator, the stacked sketch, the per-leaf route's layer
chunks and the one-rank mesh round against the reference
(tests/test_torch_mesh.py holds the helpers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as r_train
from repro.core.packed import derive_round_params as r_derive
from repro.core.packed import make_sharded_packing_plan as r_sharded_plan
from repro.core.safl import masked_psum_mean as r_masked_psum_mean
from repro.core.sketch import SketchConfig as RSketch
from repro.core.sketch import desk_leaf_stacked as r_desk_stacked
from repro.core.sketch import sk_leaf_stacked as r_sk_stacked
from repro_torch import prng
from repro_torch.core.adaptive import AdaConfig
from repro_torch.core.packed import (derive_round_params,
                                     make_sharded_packing_plan)
from repro_torch.core.safl import (SAFLConfig, init_safl, masked_psum_mean,
                                   safl_round)
from repro_torch.core.sketch import (SketchConfig, desk_leaf_stacked,
                                     sk_leaf_stacked)
from repro_torch.data.synthetic import BigramLMData, LMDataConfig
from repro_torch.launch import train as T
from repro_torch.launch.driver import run_scan
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, loss_fn

from test_torch_mesh import GRID, MAIN, STACKED, TINY, _abstract, _flat
from torch_priority import lower_priority  # noqa: F401 (autouse)


@pytest.mark.parametrize("cs_hash", ["independent", "balanced"])
def test_shard_local_round_operator_bitwise(cs_hash):
    """``derive_round_params`` over the tiny model's 2 x 2 local plan."""
    from repro.models import ModelConfig as RModel
    kw = dict(MAIN, cs_hash=cs_hash, ratio=0.1, min_b=8)
    r_abs, r_specs = r_train._mesh_pspecs(RModel(**TINY), "cross_device")
    abstract, pspecs = T._mesh_pspecs(ModelConfig(**TINY), "cross_device")
    r_plan = r_sharded_plan(RSketch(**kw), r_abs, r_specs, GRID)
    want = jax.jit(lambda k: r_derive(r_plan, k))(
        jax.random.fold_in(jax.random.key(3), 1))
    got = derive_round_params(
        make_sharded_packing_plan(SketchConfig(**kw), abstract, pspecs, GRID),
        prng.fold_in(prng.key(3), 1), "cpu")
    assert got.keys() == want.keys()
    for k in got:
        g = jax.tree.leaves(got[k])
        w = jax.tree.leaves(want[k])
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kw", STACKED, ids=["cs-independent", "cs-balanced", "srht"])
def test_stacked_sketch_matches_reference(kw):
    """Row j under ``fold_in(key, j)``: sk (L, n) -> (L, b) and desk back."""
    rows = np.random.default_rng(0).standard_normal((3, 1000)).astype(np.float32)
    s = np.random.default_rng(1).standard_normal((3, 40)).astype(np.float32)
    r_cfg, t_cfg = RSketch(ratio=0.04, min_b=8, **kw), SketchConfig(ratio=0.04, min_b=8, **kw)
    rk, tk = jax.random.fold_in(jax.random.key(5), 2), prng.fold_in(prng.key(5), 2)
    np.testing.assert_allclose(sk_leaf_stacked(t_cfg, tk, torch.as_tensor(rows)).numpy(),
                               np.asarray(r_sk_stacked(r_cfg, rk, jnp.asarray(rows))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(desk_leaf_stacked(t_cfg, tk, torch.as_tensor(s), 1000).numpy(),
                               np.asarray(r_desk_stacked(r_cfg, rk, jnp.asarray(s), 1000)),
                               rtol=1e-5, atol=1e-5)


def test_per_leaf_route_layer_chunks_match_reference(monkeypatch):
    """The per-leaf route with the chunk threshold lowered so the tiny
    model's stacked leaves take ``sk_leaf_stacked`` (as bert_100m's 28 M-
    element leaves do at full width with one model shard)."""
    monkeypatch.setattr(r_train, "SKETCH_CHUNK_NUMEL", 2_000)
    monkeypatch.setattr(T, "SKETCH_CHUNK_NUMEL", 2_000)
    shapes = {k: v.shape for k, v in _abstract(ModelConfig(**TINY)).items()}
    assert sum(len(s) >= 2 and np.prod(s) > 2_000 and s[0] > 1
               for s in shapes.values()) >= 4
    rng = np.random.default_rng(2)
    deltas = {k: (1e-3 * rng.standard_normal((1,) + tuple(s))).astype(np.float32)
              for k, s in shapes.items()}
    nested = {}
    for path, arr in deltas.items():
        *parents, leaf = path.split("/")
        node = nested
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    sk = dict(kind="countsketch", ratio=0.05, min_b=16)
    want = _flat(jax.jit(lambda d, k: r_train._sketch_avg_desk_local(
        RSketch(**sk), (), d, k))(nested, jax.random.fold_in(jax.random.key(9), 4)))
    got = T._sketch_avg_desk_local(
        SketchConfig(**sk), None, 1, {k: torch.as_tensor(v) for k, v in deltas.items()},
        prng.fold_in(prng.key(9), 4))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)


@pytest.mark.parametrize("den", [None, 2.5], ids=["cohort", "weighted"])
def test_masked_psum_mean_without_group_matches_reference(den):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 7)).astype(np.float32)
    w = (np.array([1.0, 0.0, 1.0]) if den is None
         else rng.uniform(0.5, 2.0, 3)).astype(np.float32)
    want = r_masked_psum_mean(jnp.asarray(x), jnp.asarray(w), den, ())
    got = masked_psum_mean(torch.as_tensor(x), torch.as_tensor(w), den, None)
    assert got.shape == (1, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_host_mesh_round_is_the_single_host_round():
    """On the one-rank host mesh (no group, no collective) the mesh round
    of one client is the single-host ``safl_round`` of that client, bit
    for bit: same gather-free client step, plan, operator and update."""
    model = ModelConfig(name="tiny", arch_type="dense", num_layers=1, d_model=32,
                        num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64)
    cfg = SAFLConfig(sketch=SketchConfig(kind="countsketch", ratio=0.1, min_b=8,
                                         cs_hash="independent", use_kernels=True),
                     server=AdaConfig(name="amsgrad", lr=0.01), client_lr=0.5,
                     local_steps=2)
    mesh = make_host_mesh("cpu")
    sampler = BigramLMData(LMDataConfig(vocab_size=64, seq_len=16, num_clients=1,
                                        alpha=0.05)).device_sampler(8, 2)
    key = prng.key(11)

    def fresh():
        p = init_params(model, torch.Generator().manual_seed(0), "cpu")
        return p, init_safl(cfg, p)

    p1, o1, h1 = T.run_mesh_scan(model, cfg, mesh, T.mesh_sampler(mesh, sampler),
                                 *fresh(), rounds=3, key=key)
    from repro_torch.core.packed import make_packing_plan
    params, opt = fresh()
    p2, o2, h2 = run_scan(
        lambda p, s, b, k: safl_round(cfg, lambda q, x: loss_fn(model, q, x), p, s,
                                      b, k, plan=make_packing_plan(cfg.sketch, p)),
        sampler, params, opt, rounds=3, key=key)
    np.testing.assert_array_equal(h1["loss"], h2["loss"])
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    for k in ("m", "v", "vhat"):
        for n in p1:
            assert torch.equal(o1[k][n], o2[k][n]), (k, n)
