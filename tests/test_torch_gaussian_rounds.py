"""The Gaussian family's rounds and plan, and the kernels' counter walks,
against the reference (tests/test_torch_gaussian.py holds the helpers)."""

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
from test_torch_gaussian import (FAMILY_TOL, SK_TOL, _GOLDEN, _SEED_MUL,
                                 _TILE_MUL, _U32, _gcfgs, _hold_to_reference,
                                 _reference_counters, _uniforms)
from torch_priority import lower_priority  # noqa: F401 (autouse)


def test_gaussian_kernels_plain_adjoint():
    """<sk(v), s> == <v, desk(s)> iff sk and desk regenerate one R."""
    n, b = 900, 64
    rng = np.random.RandomState(6)
    v = torch.from_numpy(rng.randn(n).astype(np.float32))
    s = torch.from_numpy(rng.randn(b).astype(np.float32))
    lhs = float(ops.gaussian_sk(42, v, b) @ s)
    rhs = float(v @ ops.gaussian_desk(42, s, n))
    assert abs(lhs - rhs) < 1e-4 * max(1.0, abs(lhs))


def test_kernel_uniforms_exact_for_every_k():
    """For all 2**24 values k of the top 24 bits (the low 8 bits anything),
    u1 equals the reference's _uniform01 bit for bit, and u2 - 1/2 is
    exactly it less one half."""
    for k0 in range(0, 1 << 24, 1 << 22):
        k = np.arange(k0, k0 + (1 << 22), dtype=np.uint32)
        bits = (k << _U32(8)) | ((k * _U32(2654435761)) >> _U32(24))
        u1, v2 = _uniforms(bits & _U32(0xFFFFFF00))
        want = np.asarray(rgs._uniform01(jnp.asarray(bits)))
        np.testing.assert_array_equal(u1.view(np.uint32), want.view(np.uint32))
        np.testing.assert_array_equal(v2.astype(np.float64),
                                      want.astype(np.float64) - 0.5)


@pytest.mark.parametrize("seed,b", [(7, 64), (2**32 - 1, 70_779),
                                    (123_456_789, (1 << 23) - 1)])
def test_sk_counter_walk_is_the_reference_counters(seed, b):
    """sk: a thread's x for its SK_COLS adjacent columns starts at each tile
    from seed * 0x9E3779B1 + 0x9E3779B9 + 2 c + t * 0x85EBCA77 and steps by
    2b a row; over two whole tiles (their boundary included), for the first
    and last columns."""
    tiles = np.array([0, 1, 7, 8, 4095], dtype=np.uint32)
    cols = np.array([0, 1, 2, 3, b - 2, b - 1], dtype=np.uint32)
    for t in tiles:
        x = (_U32((seed * _SEED_MUL + _GOLDEN + int(t) * _TILE_MUL) & 0xFFFFFFFF)
             + _U32(2) * cols)
        walked = []
        for _ in range(tgs.TILE_N):
            walked.append(x.copy())
            x = x + _U32(2 * b)
        rows = np.arange(tgs.TILE_N, dtype=np.uint32)[:, None]
        _hold_to_reference(np.stack(walked), _reference_counters(seed, t, rows, cols, b))


@pytest.mark.parametrize("seed,b", [(7, 64), (2**32 - 1, 70_779),
                                    (123_456_789, (1 << 23) - 1)])
def test_desk_counter_walk_is_the_reference_counters(seed, b):
    """desk: row i's x starts at seed * 0x9E3779B1 + 0x9E3779B9 +
    (i / 512) * 0x85EBCA77 + (i % 512) * 2b and steps by 2 a column; for
    rows on both sides of tile boundaries, over the first 64 columns, and
    from column b - 64 to the last."""
    rows = np.array([0, 511, 512, 513, 5 * 512 + 300, 3_538_943], dtype=np.uint64)
    tile, r = (rows // 512).astype(np.uint32), (rows % 512).astype(np.uint32)
    x0 = (_U32((seed * _SEED_MUL + _GOLDEN) & 0xFFFFFFFF) + tile * _U32(_TILE_MUL)
          + r * _U32(2 * b))
    for j0 in (0, b - 64):
        x = x0 + _U32(2 * j0)
        walked = []
        for _ in range(64):
            walked.append(x.copy())
            x = x + _U32(2)
        cols = np.arange(j0, j0 + 64, dtype=np.uint32)[:, None]
        _hold_to_reference(np.stack(walked),
                           _reference_counters(seed, tile, r, cols, b))


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
