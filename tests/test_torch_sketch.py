"""repro_torch.core.sketch / core.packed against the reference.

Under one key the port must derive bit-identical operators (hashes,
signs, rotations, SRHT indices) and lay the payload out slot for slot as
the reference does; sketches and desketches then agree up to float32
summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packed as rpk
from repro.core import sketch as rsk
from repro.models import ModelConfig as RModel
from repro.models import param_shapes as r_param_shapes
from repro.configs import bert_100m as rbert
from repro_torch import prng
from repro_torch.configs import bert_100m as tbert
from repro_torch.core import packed as tpk
from repro_torch.core import sketch as tsk
from repro_torch.models.config import ModelConfig as TModel
from repro_torch.models.model import param_shapes as t_param_shapes

from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)

# sums of the same float32 terms in another order (segment sums of a few
# dozen unit-scale terms, FWHT scaled by 1/sqrt(n2)): a few ulps
TOL = dict(rtol=1e-5, atol=1e-5)

CONFIGS = [
    dict(kind="countsketch", cs_hash="balanced"),
    dict(kind="countsketch", cs_hash="independent"),
    dict(kind="srht"),
    dict(kind="none"),
]
MODES = ["per_tensor", "concat"]


def _cfgs(kw, mode, **extra):
    base = dict(ratio=0.1, min_b=8, mode=mode, **kw)
    return rsk.SketchConfig(**base), tsk.SketchConfig(**base, **extra)


def _tree(seed=0):
    """A small nested reference tree and the port's flat view of it."""
    rng = np.random.RandomState(seed)
    # "b/w" is raw (n < min_b); "b" sorts before "b_x" as jax orders it
    shapes = {"a": (40, 12), "b": {"w": (7,)}, "b_x": (5, 33)}
    nested = jax.tree.map(lambda s: rng.randn(*s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    return nested, _flat(nested)


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): np.asarray(l) for path, l in flat}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("mode", MODES)
def test_packed_matches_reference(kw, mode):
    rcfg, tcfg = _cfgs(kw, mode, use_kernels=True)
    nested, flat = _tree(1)
    rplan = rpk.make_packing_plan(rcfg, nested)
    tplan = tpk.make_packing_plan(tcfg, _t(flat))
    assert (rplan.d_total, rplan.b_total) == (tplan.d_total, tplan.b_total)
    # three stacked clients: the batched sketch of the G-client uplink
    stacked = jax.tree.map(lambda x: np.stack([x * (i + 1) for i in range(3)]),
                           nested)

    @jax.jit
    def ref(key, tree, stacked):
        rp = rpk.derive_round_params(rplan, key)
        payload = rpk.sk_packed(rplan, rp, tree)
        return (rp, payload, rpk.desk_packed(rplan, rp, payload),
                rpk.sk_packed_clients(rplan, rp, stacked))

    rrp, payload, back, clients = ref(jax.random.key(5), nested, stacked)
    trp = tpk.derive_round_params(tplan, prng.key(5), "cpu")
    _assert_params_bitwise(rrp, trp)
    tpay = tpk.sk_packed(tplan, trp, _t(flat))
    np.testing.assert_allclose(tpay.numpy(), np.asarray(payload), **TOL)
    tback = tpk.desk_packed(tplan, trp, torch.from_numpy(np.array(payload)))
    for k, v in _flat(back).items():
        np.testing.assert_allclose(tback[k].numpy(), v, **TOL)
    got = tpk.sk_packed_clients(tplan, trp, _t(_flat(stacked)))
    np.testing.assert_allclose(got.numpy(), np.asarray(clients), **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_srht_clients_batch_one_fwht_per_group(mode, monkeypatch):
    """The G-client SRHT uplink is one FWHT call per padded-length group
    over all G clients' rows, bit-identical to sketching each client alone."""
    _, tcfg = _cfgs(dict(kind="srht"), mode, use_kernels=True)
    _, flat = _tree(2)
    plan = tpk.make_packing_plan(tcfg, _t(flat))
    rp = tpk.derive_round_params(plan, prng.key(6), "cpu")
    stacked = {k: torch.stack([torch.from_numpy(v) * (i + 1) for i in range(4)])
               for k, v in flat.items()}
    calls = []
    fwht_rows = tpk.kops.fwht_rows
    monkeypatch.setattr(tpk.kops, "fwht_rows",
                        lambda x: calls.append(tuple(x.shape)) or fwht_rows(x))
    got = tpk.sk_packed_clients(plan, rp, stacked)
    groups = tpk._srht_groups(plan)
    assert sorted(calls) == sorted((4 * len(ops), n2) for n2, ops in groups.items())
    flat2 = torch.cat([stacked[s.name].reshape(4, -1) for s in plan.leaves], 1)
    for g in range(4):
        assert torch.equal(got[g], tpk.sk_flat(plan, rp, flat2[g])), g


def _assert_params_bitwise(rrp, trp):
    assert set(rrp) == set(trp)
    if "h" in rrp:
        np.testing.assert_array_equal(trp["h"].numpy(), np.asarray(rrp["h"]))
        np.testing.assert_array_equal(trp["s"].numpy(), np.asarray(rrp["s"]))
    for fam in ("bal", "srht"):
        for r_op, t_op in zip(rrp.get(fam, ()), trp.get(fam, ())):
            assert (r_op is None) == (t_op is None)
            if r_op is None:
                continue
            for a, b in zip(r_op, t_op):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _r_shapes(cfg):
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                        r_param_shapes(cfg),
                        is_leaf=lambda x: isinstance(x, tuple))


@dataclasses.dataclass(frozen=True)
class _Spec:
    shape: tuple
    dtype: torch.dtype = torch.float32


QUICK_KW = dict(name="tiny", arch_type="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128)


@pytest.mark.parametrize("which", ["bert_smoke", "quickstart"])
@pytest.mark.parametrize("kw", CONFIGS[:3])
def test_plan_layout_matches_reference(which, kw):
    """Leaf order, offsets and b_total on the two models the SAFL tests run."""
    rmodel, tmodel = ((rbert.SMOKE, tbert.SMOKE) if which == "bert_smoke"
                      else (RModel(**QUICK_KW), TModel(**QUICK_KW)))
    rcfg, tcfg = _cfgs(kw, "per_tensor")
    rcfg = dataclasses.replace(rcfg, ratio=0.02, min_b=64)
    tcfg = dataclasses.replace(tcfg, ratio=0.02, min_b=64)
    rplan = rpk.make_packing_plan(rcfg, _r_shapes(rmodel))
    tplan = tpk.make_packing_plan(
        tcfg, {k: _Spec(s) for k, s in t_param_shapes(tmodel).items()})
    r_names = list(_flat(jax.tree.map(lambda s: np.zeros(0), _r_shapes(rmodel))))
    assert [s.name for s in tplan.leaves] == r_names
    assert [s.shape for s in tplan.leaves] == [s.shape for s in rplan.leaves]
    assert ([(o.in_off, o.n, o.b, o.pay_off, o.raw, o.tag) for o in tplan.ops]
            == [(o.in_off, o.n, o.b, o.pay_off, o.raw, o.tag) for o in rplan.ops])
    assert (tplan.d_total, tplan.b_total) == (rplan.d_total, rplan.b_total)
    assert (tsk.total_sketch_bits(tcfg, t_param_shapes_as_specs(tmodel))
            == rsk.total_sketch_bits(rcfg, _r_shapes(rmodel)))


def t_param_shapes_as_specs(model):
    return {k: _Spec(s) for k, s in t_param_shapes(model).items()}
