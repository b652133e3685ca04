"""The mesh's layout pieces against the reference's, with no process started.

Partition specs of all twelve configs (fsdp off and on) and of the three
mesh topologies spec for spec; shard-local shapes and packing plans field
for field (bert_100m's 2 x 2 plan against the numbers the reference gives
it); the shard-local round operator bit for bit; the stacked sketch and
the per-leaf route's layer-chunked path; ``masked_psum_mean`` without a
group (the reference's empty ``client_axes``); ``_clean_spec`` under
manual axes and flat-TP substitution; the batch and optimizer specs; a
rank's ``local_shard`` blocks; and the one-rank host mesh's round against
the single-host round, bit for bit.  The collectives run in the spawned
ranks of tests/test_torch_mesh_round.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as r_train
from repro.configs import ARCHS as R_ARCHS
from repro.configs import get_config as r_get_config
from repro.core.packed import make_sharded_packing_plan as r_sharded_plan
from repro.core.packed import shard_local_abstract as r_local_abstract
from repro.core.sketch import SketchConfig as RSketch
from repro.launch.mesh import _mesh as r_mesh
from repro.models import sharding as r_sharding
from repro.models.model import param_shapes as r_param_shapes
from repro_torch.configs import get_config
from repro_torch.core.adaptive import AdaConfig
from repro_torch.core.packed import (make_sharded_packing_plan,
                                     shard_local_abstract)
from repro_torch.core.sketch import SketchConfig
from repro_torch.data.device import ShardedSampler
from repro_torch.data.synthetic import (BigramLMData, ClsDataConfig,
                                      GaussianClsData, LMDataConfig)
from repro_torch.launch import train as T
from repro_torch.launch.mesh import Mesh
from repro_torch.models import sharding
from repro_torch.models.sharding import local_shard

torch.set_num_threads(2)

MAIN = dict(kind="countsketch", ratio=0.02, min_b=64, cs_hash="independent")
# two stacked blocks of test_mesh_scan.py's tiny model: the reference's
# eager operator and per-leaf route stay quick at this size
TINY = dict(name="tiny", arch_type="dense", num_layers=2, d_model=32,
            num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64)
GRID = {"data": 2, "model": 2}
SILO = {"pod": 2, "data": 2, "model": 1}


def _r_abstract(cfg):
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(tuple(s), cfg.dtype),
                        r_param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))


def _flat(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat}


def _r_specs(tree):
    return {k: tuple(p) for k, p in
            _flat(tree, lambda x: isinstance(x, jax.sharding.PartitionSpec)).items()}


def _abstract(cfg):
    return T._mesh_pspecs(cfg, "cross_device")[0]


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("arch", R_ARCHS)
def test_param_pspecs_match_reference(arch, fsdp):
    want = _r_specs(r_sharding.param_pspecs(_r_abstract(r_get_config(arch)),
                                            fsdp=fsdp))
    got = sharding.param_pspecs(_abstract(get_config(arch)), fsdp=fsdp)
    assert got == want


@pytest.mark.parametrize("topology", T.TOPOLOGIES)
def test_mesh_pspecs_match_reference(topology):
    r_abs, r_specs = r_train._mesh_pspecs(r_get_config("bert_100m"), topology)
    abstract, pspecs = T._mesh_pspecs(get_config("bert_100m"), topology)
    assert pspecs == _r_specs(r_specs)
    assert {k: tuple(v.shape) for k, v in abstract.items()} == \
        {k: tuple(v.shape) for k, v in _flat(r_abs).items()}


PLAN_CASES = (("bert_100m", False, GRID, "cross_device"),
              ("bert_100m", False, SILO, "cross_silo"),
              ("dbrx_132b", True, {"pod": 2, "data": 2, "model": 2}, "cross_silo"),
              ("llama3.2-1b", True, GRID, "cross_device"))


@pytest.mark.parametrize("arch,smoke,sizes,topology", PLAN_CASES,
                         ids=[f"{a}-{t}" for a, _, _, t in PLAN_CASES])
def test_shard_local_plan_matches_reference(arch, smoke, sizes, topology):
    """Every LeafSpec and OpSpec field of the shard-local plan."""
    r_abs, r_specs = r_train._mesh_pspecs(r_get_config(arch, smoke=smoke), topology)
    abstract, pspecs = T._mesh_pspecs(get_config(arch, smoke=smoke), topology)
    r_local = _flat(r_local_abstract(r_abs, r_specs, sizes))
    local = shard_local_abstract(abstract, pspecs, sizes)
    assert {k: tuple(v.shape) for k, v in local.items()} == \
        {k: tuple(v.shape) for k, v in r_local.items()}
    want = r_sharded_plan(RSketch(**MAIN), r_abs, r_specs, sizes)
    got = make_sharded_packing_plan(SketchConfig(**MAIN), abstract, pspecs, sizes)
    assert (got.d_total, got.b_total) == (want.d_total, want.b_total)
    assert [l.name for l in got.leaves] == list(r_local)
    for g, w in zip(got.leaves, want.leaves, strict=True):
        assert (g.shape, g.n, g.in_off) == (tuple(w.shape), w.n, w.in_off)
        assert str(g.dtype).split(".")[-1] == np.dtype(w.dtype).name
    assert [tuple(vars(o).values()) for o in got.ops] == \
        [tuple(vars(o).values()) for o in want.ops]
    if (arch, topology) == ("bert_100m", "cross_device"):
        # the 2 x 2 round's uplink: B1 at G_loc = 1 on every rank
        assert (got.d_total, got.b_total) == (66_046_464, 1_321_033)
        assert max(l.n for l in got.leaves) == 14_155_776


def test_shard_local_abstract_refuses_an_indivisible_dim():
    tree = {"w": torch.empty((6, 5), device="meta")}
    with pytest.raises(ValueError, match="not divisible"):
        shard_local_abstract(tree, {"w": (None, "model")}, {"model": 2})
    with pytest.raises(ValueError, match="not divisible"):
        r_local_abstract({"w": jax.ShapeDtypeStruct((6, 5), jnp.float32)},
                         {"w": jax.sharding.PartitionSpec(None, "model")},
                         {"model": 2})


STACKED = [dict(kind="countsketch", cs_hash="independent"),
           dict(kind="countsketch", cs_hash="balanced"), dict(kind="srht")]


SPECS = ((("pod", "data"), None, "model"), (("pod", "data"), "model"),
         (("data", "model"), None), ("pod",), ("model", "data"), (None, None))
CONTEXTS = ("plain", "manual_data", "flat_tp")


@pytest.mark.parametrize("context", CONTEXTS)
@pytest.mark.parametrize("axes", [("data", "model"), ("pod", "data", "model")])
def test_clean_spec_matches_reference(axes, context):
    """On a layout-only mesh, against the reference's on a one-device mesh
    with the same axis names (``_clean_spec`` reads the names only)."""
    r_ctx = {"plain": None, "manual_data": r_sharding.manual_axes(("data",)),
             "flat_tp": r_sharding.model_axis_substitution(("data", "model"))}
    t_ctx = {"plain": None, "manual_data": sharding.manual_axes(("data",)),
             "flat_tp": sharding.model_axis_substitution(("data", "model"))}
    with r_sharding.use_mesh(r_mesh((1,) * len(axes), axes)):
        if r_ctx[context] is None:
            want = [tuple(r_sharding._clean_spec(s)) for s in SPECS]
        else:
            with r_ctx[context]:
                want = [tuple(r_sharding._clean_spec(s)) for s in SPECS]
    assert sharding._clean_spec(SPECS[0]) is None          # no active mesh
    with sharding.use_mesh(Mesh((2,) * len(axes), axes)):
        if t_ctx[context] is None:
            got = [sharding._clean_spec(s) for s in SPECS]
        else:
            with t_ctx[context]:
                got = [sharding._clean_spec(s) for s in SPECS]
    assert got == want
    x = torch.ones(3)
    assert sharding.hint(x, "model") is x and sharding.hint_replicated(x) is x


@pytest.mark.parametrize("topology", T.TOPOLOGIES)
def test_batch_and_opt_pspecs_match_reference(topology):
    axes = ("pod", "data", "model")
    batch = {"tokens": np.zeros((2, 2, 4, 16), np.int32)}
    want = r_train.batch_pspecs({"tokens": jnp.zeros((2, 2, 4, 16))},
                                r_mesh((1, 1, 1), axes), topology)
    got = T.batch_pspecs(batch, Mesh((2, 2, 2), axes), topology)
    assert got == _r_specs(want)
    server = AdaConfig(name="amsgrad")
    r_specs = r_train._mesh_pspecs(r_get_config("bert_100m", smoke=True), topology)[1]
    t_specs = T._mesh_pspecs(get_config("bert_100m", smoke=True), topology)[1]
    from repro.core.adaptive import AdaConfig as RAda
    got = {f"{k}/{n}" if isinstance(v, dict) else k: s
           for k, v in T.opt_pspecs(server, t_specs).items()
           for n, s in (v.items() if isinstance(v, dict) else [(None, v)])}
    assert got == _r_specs(r_train.opt_pspecs(RAda(name="amsgrad"), r_specs))
    assert T.num_clients_of(Mesh((2, 2, 2), axes), topology) == \
        r_train.num_clients_of(r_mesh((1, 1, 1), axes), topology) * (
            2 if topology == "cross_silo" else 4)


def test_mesh_layout_and_local_shards():
    """Row-major coordinates, group members, and the blocks of a leaf the
    ranks of a (pod 2, data 2, model 2) mesh hold under a 2-D spec: each
    rank's ``local_shard`` is its block, and the blocks tile the leaf."""
    layout = Mesh((2, 2, 2), ("pod", "data", "model"))
    assert layout.shape == {"pod": 2, "data": 2, "model": 2}
    assert layout.coords_of(5) == {"pod": 1, "data": 0, "model": 1}
    assert layout.ranks_over(("model",), 5) == [4, 5]
    assert layout.ranks_over(("pod", "data"), 5) == [1, 3, 5, 7]
    assert layout.index_over(("pod", "data"), 6) == 3
    x = torch.arange(4 * 8 * 2, dtype=torch.float32).reshape(4, 8, 2)
    spec = {"w": ("model", ("pod", "data"))}
    seen = torch.zeros_like(x)
    for r in range(8):
        m = Mesh(layout.sizes, layout.axis_names, rank=r)
        block = local_shard(m, {"w": x}, spec)["w"]
        assert block.shape == (2, 2, 2)
        c = m.coords
        i, j = c["model"], 2 * c["pod"] + c["data"]
        assert torch.equal(block, x[2 * i:2 * i + 2, 2 * j:2 * j + 2])
        seen[2 * i:2 * i + 2, 2 * j:2 * j + 2] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("family", ["bigram", "gaussian"])
def test_sharded_sampler_draws_its_clients_only(family):
    """A rank's ``ShardedSampler`` draws clients ``[start, stop)`` alone,
    bit for bit those rows of the base sampler's whole batch."""
    base = (BigramLMData(LMDataConfig(vocab_size=64, seq_len=16, num_clients=4,
                                      alpha=0.05)) if family == "bigram"
            else GaussianClsData(ClsDataConfig(num_clients=4,
                                               dirichlet_alpha=0.3))
            ).device_sampler(8, 2)
    state = base.init_state("cpu")
    for t in (0, 3):
        whole = base.sample(state, t)[1]
        for start, stop in ((0, 1), (1, 3), (2, 4)):
            rows = ShardedSampler(base, start, stop).sample(state, t)[1]
            assert rows.keys() == whole.keys()
            for k in whole:
                assert rows[k].shape[0] == stop - start
                assert torch.equal(rows[k], whole[k][start:stop]), (t, k)
