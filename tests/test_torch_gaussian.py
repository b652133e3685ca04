"""The Gaussian sketch family of the port against the reference.

Two R's live here, as in the reference:

* the family of ``core/sketch.py``/``core/packed.py`` draws R chunk by
  chunk with ``jax.random.normal``; the port's ``prng.normal`` gives the
  same uniforms bit for bit, and ``erfinv`` within ~1e-5 relative;
* the on-the-fly kernels (``kernels/gaussian_sketch.py``) regenerate R from
  splitmix32 counters; the port's plain versions give the same counters and
  mixed bits bit for bit, and the floats within an ulp or two.

Shapes are small: the port's threefry runs as PyTorch integer ops here.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packed as rpk
from repro.core import sketch as rsk
from repro.core.safl import init_safl as r_init_safl
from repro.core.safl import safl_round as r_round
from repro.kernels import ref
from repro.kernels import gaussian_sketch as rgs
from repro.models import ModelConfig as RModel
from repro.models import loss_fn as r_loss
from repro_torch import prng
from repro_torch.core import packed as tpk
from repro_torch.core import sketch as tsk
from repro_torch.core.safl import init_safl as t_init_safl
from repro_torch.core.safl import safl_round as t_round
from repro_torch.kernels import gaussian_sketch as tgs
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig as TModel
from repro_torch.models.model import loss_fn as t_loss
from test_torch_safl import (DATA, LOSS_TOL, QUICK_KW, _cfgs, _samplers,
                             _weights)
from test_torch_sketch import _flat, _t, _tree

torch.set_num_threads(2)

# XLA's float32 erf_inv is a polynomial good to ~1e-5 relative in the
# tails (|u| near 1); torch.erfinv is closer to exact.  Measured: <= 6e-6.
NORMAL_TOL = dict(rtol=2e-5, atol=1e-6)
# log/cos of two float32 libraries differ by an ulp or two; near a zero of
# cos the difference is absolute, ~|r| * ulp(2 pi) <= 5.8 * 4.8e-7
TILE_TOL = dict(rtol=1e-6, atol=5e-6)
# float32 sums of up to 2000 products in another order (plain: matmul per
# tile group; Pallas: dot per tile), outputs of size ~10: a few ulps
SK_TOL = dict(rtol=1e-5, atol=1e-5)
# sketches of the family: sums of a few hundred unit-scale products in
# another order, plus the erfinv gap above, random in sign
FAMILY_TOL = dict(rtol=1e-4, atol=1e-5)
CHUNK = 128  # small gaussian_chunk on both sides: several chunks per leaf

KERNEL_SHAPES = [(100, 16), (513, 64), (2000, 128), (1500, 128), (900, 64)]


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5])
@pytest.mark.parametrize("shape", [(1,), (333,), (129, 40)])
def test_normal_matches_jax(seed, shape):
    jk = jax.random.fold_in(jax.random.key(seed), 5)
    pk = prng.fold_in(prng.key(seed), 5)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, 1.0))
    got = prng.normal_uniform(pk, shape, "cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_allclose(prng.normal(pk, shape, "cpu").numpy(),
                               np.asarray(jax.random.normal(jk, shape)),
                               **NORMAL_TOL)


@pytest.mark.parametrize("seed,tile,tile_n,b", [(7, 0, 512, 128), (11, 3, 64, 16),
                                                (2**32 - 1, 5, 512, 70)])
def test_gauss_tile_plain_matches_reference(seed, tile, tile_n, b):
    """Counters and mixed bits bitwise (numpy's uint64 formula of
    ``ref.gaussian_tile_ref``; the Pallas module's ``_splitmix32``), the
    tile allclose to the float64 oracle and to ``_gauss_tile``."""
    ctr = tgs.tile_counters(seed, torch.tensor([tile]), tile_n, b)[0]
    rows, cols = np.meshgrid(np.arange(tile_n, dtype=np.uint64),
                             np.arange(b, dtype=np.uint64), indexing="ij")
    base = (np.uint64(seed) * np.uint64(0x9E3779B1)
            + np.uint64(tile) * np.uint64(0x85EBCA77)) & np.uint64(0xFFFFFFFF)
    want = (base + rows * np.uint64(2 * b) + cols * np.uint64(2)) & np.uint64(0xFFFFFFFF)
    np.testing.assert_array_equal(ctr.numpy(), want.astype(np.int64))
    for c in (ctr, (ctr + 1) & tgs.M32):
        bits = np.asarray(rgs._splitmix32(jnp.asarray(c.numpy().astype(np.uint32))))
        np.testing.assert_array_equal(tgs.splitmix32(c).numpy(), bits.astype(np.int64))
    got = tgs.gauss_tile_plain(seed, tile, tile_n, b).numpy()
    np.testing.assert_allclose(got, ref.gaussian_tile_ref(seed, tile, tile_n, b),
                               **TILE_TOL)
    jt = rgs._gauss_tile(jnp.uint32(seed), jnp.int32(tile), tile_n, b)
    np.testing.assert_allclose(got, np.asarray(jt), **TILE_TOL)


@pytest.mark.parametrize("n,b", KERNEL_SHAPES)
def test_gaussian_kernels_plain_vs_pallas_interpret(n, b):
    rng = np.random.RandomState(n + b)
    x = rng.randn(n).astype(np.float32)
    s = rng.randn(b).astype(np.float32)
    seed = jnp.array(11, jnp.uint32)
    want = np.asarray(rgs.gaussian_sk_pallas(seed, jnp.asarray(x), b))
    np.testing.assert_allclose(ops.gaussian_sk(11, torch.from_numpy(x), b).numpy(),
                               want, **SK_TOL)
    want = np.asarray(rgs.gaussian_desk_pallas(seed, jnp.asarray(s), n))
    np.testing.assert_allclose(ops.gaussian_desk(11, torch.from_numpy(s), n).numpy(),
                               want, **SK_TOL)


def test_gaussian_kernels_plain_adjoint():
    """<sk(v), s> == <v, desk(s)> iff sk and desk regenerate one R."""
    n, b = 900, 64
    rng = np.random.RandomState(6)
    v = torch.from_numpy(rng.randn(n).astype(np.float32))
    s = torch.from_numpy(rng.randn(b).astype(np.float32))
    lhs = float(ops.gaussian_sk(42, v, b) @ s)
    rhs = float(v @ ops.gaussian_desk(42, s, n))
    assert abs(lhs - rhs) < 1e-4 * max(1.0, abs(lhs))


def _gcfgs(mode, **extra):
    base = dict(kind="gaussian", ratio=0.1, min_b=8, mode=mode,
                gaussian_chunk=CHUNK)
    return rsk.SketchConfig(**base), tsk.SketchConfig(**base, **extra)


@pytest.mark.parametrize("mode", ["per_tensor", "concat"])
def test_gaussian_family_matches_reference(mode):
    """Per leaf (``sketch_tree``/``desketch_tree``) and packed
    (``sk_packed``, ``desk_packed``, ``sk_packed_clients``) against the
    reference under one key, and packed == per-leaf in the port."""
    rcfg, tcfg = _gcfgs(mode)
    nested, flat = _tree(3)
    stacked = jax.tree.map(lambda x: np.stack([x * (i + 1) for i in range(3)]),
                           nested)
    rplan = rpk.make_packing_plan(rcfg, nested)
    tplan = tpk.make_packing_plan(tcfg, _t(flat))

    @jax.jit
    def reference(key, tree, stacked):
        s = rsk.sketch_tree(rcfg, key, tree)
        rp = rpk.derive_round_params(rplan, key)
        payload = rpk.sk_packed(rplan, rp, tree)
        return (s, rsk.desketch_tree(rcfg, key, s, tree), payload,
                rpk.desk_packed(rplan, rp, payload),
                rpk.sk_packed_clients(rplan, rp, stacked))

    rs, rd, rpay, rback, rclients = reference(jax.random.key(9), nested, stacked)
    key = prng.key(9)
    ts = tsk.sketch_tree(tcfg, key, _t(flat))
    td = tsk.desketch_tree(tcfg, key, ts, _t(flat))
    rp = tpk.derive_round_params(tplan, key, "cpu")
    assert [k is None for k in rp["keys"]] == [op.raw for op in tplan.ops]
    tpay = tpk.sk_packed(tplan, rp, _t(flat))
    tback = tpk.desk_packed(tplan, rp, tpay)
    tclients = tpk.sk_packed_clients(tplan, rp, _t(_flat(stacked)))

    if mode == "concat":
        np.testing.assert_allclose(ts.numpy(), np.asarray(rs), **FAMILY_TOL)
        per_leaf = ts
    else:
        for k, v in _flat(rs).items():
            np.testing.assert_allclose(ts[k].numpy(), v, **FAMILY_TOL)
        per_leaf = torch.cat([ts[s.name] for s in tplan.leaves])
    for k, v in _flat(rd).items():
        np.testing.assert_allclose(td[k].numpy(), v, **FAMILY_TOL)
    np.testing.assert_allclose(tpay.numpy(), np.asarray(rpay), **FAMILY_TOL)
    for k, v in _flat(rback).items():
        np.testing.assert_allclose(tback[k].numpy(), v, **FAMILY_TOL)
    np.testing.assert_allclose(tclients.numpy(), np.asarray(rclients), **FAMILY_TOL)
    # packed == per-leaf: one key derivation, the same draws, the same sums
    assert torch.equal(tpay, per_leaf)
    for k in flat:
        assert torch.equal(tback[k], td[k]), k


def test_gaussian_clients_draw_each_chunk_once(monkeypatch):
    """``sk_packed_clients`` multiplies all G clients by one draw of each
    R chunk, as the reference's vmap with an unbatched key does."""
    _, tcfg = _gcfgs("per_tensor")
    _, flat = _tree(4)
    plan = tpk.make_packing_plan(tcfg, _t(flat))
    rp = tpk.derive_round_params(plan, prng.key(2), "cpu")
    draws = []
    normal = prng.normal
    monkeypatch.setattr(prng, "normal",
                        lambda k, shape, dev: draws.append(k) or normal(k, shape, dev))
    tpk.sk_flat(plan, rp, tpk.pack_tree(plan, _t(flat)))
    one = list(draws)
    draws.clear()
    stacked = {k: torch.stack([torch.from_numpy(v) * (i + 1) for i in range(4)])
               for k, v in flat.items()}
    got = tpk.sk_packed_clients(plan, rp, stacked)
    assert draws == one
    flat2 = torch.cat([stacked[s.name].reshape(4, -1) for s in plan.leaves], 1)
    for g in range(4):
        # (4, c) @ (c, b) against (1, c) @ (c, b): another summation order
        torch.testing.assert_close(got[g], tpk.sk_flat(plan, rp, flat2[g]),
                                   **SK_TOL)


def test_two_gaussian_rounds_match_reference():
    """Two SAFL rounds of a one-layer bench model with the Gaussian family, each
    package from the same weights, batches and round keys.

    The server is plain SGD, which carries the desketched update linearly:
    AMSGrad's per-coordinate normalization turns the erfinv gap into sign
    flips of the few coordinates whose update is near zero (a few move by
    more than ``PARAM_TOL``'s 2e-3 in two rounds), and the count-sketch
    trajectories (tests/test_torch_safl.py) already hold AMSGrad."""
    # a small ratio keeps the port's threefry draws (~2e6 per sk) quick
    small = dict(ratio=0.002, min_b=4)
    rcfg, tcfg = _cfgs(kind="gaussian", gaussian_chunk=512)
    rcfg = dataclasses.replace(rcfg, server=dataclasses.replace(rcfg.server, name="sgd"),
                               sketch=dataclasses.replace(rcfg.sketch, **small))
    tcfg = dataclasses.replace(tcfg, server=dataclasses.replace(tcfg.server, name="sgd"),
                               sketch=dataclasses.replace(tcfg.sketch, **small))
    # one layer: compiling the reference's round is most of this test's time
    kw = dict(QUICK_KW, num_layers=1)
    rmodel, tmodel = RModel(**kw), TModel(**kw)
    rsmp, _ = _samplers({**DATA, "vocab_size": QUICK_KW["vocab_size"]}, 2)
    rparams, tparams = _weights(tmodel, 2)
    rfn = jax.jit(functools.partial(r_round, rcfg,
                                    lambda p, b: r_loss(rmodel, p, b)))
    rstate, tstate = r_init_safl(rcfg, rparams), t_init_safl(tcfg, tparams)
    rsample = jax.jit(rsmp.sample)
    for t in range(2):
        rb = rsample(rsmp.init_state(), t)[1]
        tb = {"tokens": torch.from_numpy(np.asarray(rb["tokens"]).astype(np.int64))}
        rparams, rstate, rm = rfn(rparams, rstate, rb,
                                  jax.random.fold_in(jax.random.key(8), t))
        tparams, tstate, tm = t_round(tcfg, lambda p, b: t_loss(tmodel, p, b),
                                      tparams, tstate, tb,
                                      prng.fold_in(prng.key(8), t))
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), **LOSS_TOL)
    # float32 noise only: the update is linear in the desketched mean
    for k, v in _flat(rparams).items():
        np.testing.assert_allclose(tparams[k].numpy(), v, err_msg=k,
                                   rtol=1e-5, atol=1e-6)
