"""The async staleness buffer of the port (``repro_torch.fed.async_buffer``)
against the reference on the CPU.

* The delay policies over rounds -3..31 (stagger and uniform) and
  ``arrival_weight``: bit for bit.  The uniform delays are integer
  threefry draws; the discount ``(1 + d) ** -alpha`` is rounded to
  float32 before the multiply, as jax rounds the weakly typed scalar.
* ``derive_generation_params``: the generation's hashes bit for bit.
* Async rounds of the linear classifier (tests/test_torch_faults.py's
  harness) under stagger and uniform delays, staged whole or through
  ``microbatch``, with faults, the sentinel and the EF codec: each round
  of the port from the reference's state (the ring included) on its
  batch; parameters at PARAM_TOL (tests/test_torch_safl.py states why),
  the ring and the EF memory at that tolerance scaled to their largest
  entry, ``arrival_weight`` and the guard's counters exactly.
* Within the port, bit for bit: ``delay="zero"`` with ``codec=None`` (and
  with the EF codec) is ``safl_round``; a weighted mask raises
  ``TypeError``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clipped import ClippedSAFLConfig as RClip
from repro.core.packed import derive_generation_params as r_derive_gen
from repro.core.packed import make_packing_plan as r_plan
from repro.fed import AsyncConfig as RAsync
from repro.fed import CodecConfig as RCodec
from repro.fed import FaultTable as RFaultTable
from repro.fed import SentinelConfig as RSentinel
from repro.fed import arrival_weight as r_arrival_weight
from repro.fed import init_async_state as r_init_async
from repro.fed import make_async_round as r_make_async
from repro_torch import prng
from repro_torch.core.clipped import ClippedSAFLConfig as TClip
from repro_torch.core.packed import (derive_generation_params,
                                     derive_round_params)
from repro_torch.core.packed import make_packing_plan as t_plan
from repro_torch.core.safl import init_safl
from repro_torch.fed import (AsyncConfig, ImportanceParticipation,
                             arrival_weight, init_async_state, make_async_round)
from repro_torch.fed.codec import CodecConfig as TCodec
from repro_torch.fed.faults import FaultTable as TFaultTable
from repro_torch.fed.robust import SentinelConfig as TSentinel
from repro_torch.launch.driver import run_scan
from test_torch_faults import (FAULT_ROWS, G, KEY, _PortSampler, cls_cfgs,
                               cls_params, cls_sampler, port_batch, r_cls_loss,
                               reference_run, round_fns, rounds_from_reference,
                               t_cls_loss)
from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)


@pytest.mark.parametrize("delay,max_delay,seed", [("stagger", 2, 0), ("stagger", 3, 0),
                                                  ("uniform", 2, 0), ("uniform", 3, 5)])
def test_delays_and_arrival_weights_bitwise(delay, max_delay, seed):
    racfg = RAsync(max_delay=max_delay, delay=delay, staleness_alpha=0.7, seed=seed)
    tacfg = AsyncConfig(max_delay=max_delay, delay=delay, staleness_alpha=0.7, seed=seed)
    delays = jax.jit(racfg.delays, static_argnums=1)
    aw = jax.jit(functools.partial(r_arrival_weight, racfg), static_argnums=(1, 2))
    for g in range(-3, 32):
        want = np.asarray(delays(jnp.int32(g), 7))
        got = tacfg.delays(g, 7, "cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"generation {g}")
        for d in range(max_delay + 1):
            if d == 0 and g < 0:
                continue              # d = 0 pops the round just pushed: g >= 0
            np.testing.assert_array_equal(
                arrival_weight(tacfg, g, d, 7, "cpu").numpy(),
                np.asarray(aw(jnp.int32(g), d, 7)), err_msg=f"g {g} d {d}")
    assert len(set(tacfg.delays(4, 7, "cpu").tolist())) > 1


def test_zero_delay_and_validation():
    z = AsyncConfig(max_delay=3, delay="zero")
    assert not z.delays(9, 4, "cpu").any()
    assert torch.equal(arrival_weight(z, 5, 0, 4, "cpu"), torch.ones(4))
    for bad in (dict(max_delay=-1), dict(delay="poisson"), dict(staleness_alpha=-0.5)):
        with pytest.raises(ValueError):
            AsyncConfig(**bad)


def test_derive_generation_params_bitwise():
    rcfg, tcfg = cls_cfgs()
    rp, tp = cls_params()
    rplan, tplan = r_plan(rcfg.sketch, rp), t_plan(tcfg.sketch, tp)
    base = prng.fold_in(prng.key(KEY), 3)
    rbase = jax.random.fold_in(jax.random.key(KEY), 3)
    for g in (-2, 0, 5):
        got = derive_generation_params(tplan, base, g, "cpu")
        want = r_derive_gen(rplan, rbase, jnp.int32(g))
        np.testing.assert_array_equal(got["h"].numpy(), np.asarray(want["h"]))
        np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
        same = derive_round_params(tplan, prng.fold_in(base, g), "cpu")
        assert torch.equal(got["h"], same["h"])


def _async_fns(clip, acfg_kw, microbatch=None, codec=None):
    rcfg, tcfg = cls_cfgs()
    rp, tp = cls_params()
    rc = rcfg if not clip else RClip(base=rcfg, clip_tau=0.5)
    tc = tcfg if not clip else TClip(base=tcfg, clip_tau=0.5)
    rplan, tplan = r_plan(rcfg.sketch, rp), t_plan(tcfg.sketch, tp)
    rcodec = None if codec is None else RCodec(**codec)
    tcodec = None if codec is None else TCodec(**codec)
    rfn = r_make_async(rc, r_cls_loss, RAsync(**acfg_kw), rplan,
                       microbatch=microbatch, codec=rcodec)
    tfn = make_async_round(tc, t_cls_loss, AsyncConfig(**acfg_kw), tplan,
                           microbatch=microbatch, codec=tcodec)
    return (rfn, tfn, r_init_async(rc, RAsync(**acfg_kw), rp, rplan, G, codec=rcodec),
            init_async_state(tc, AsyncConfig(**acfg_kw), tp, tplan, G, codec=tcodec))


ASYNC_RUNS = {
    "safl_stagger": (False, dict(max_delay=2, delay="stagger"), None, None, False),
    "safl_uniform_mb2": (False, dict(max_delay=2, delay="uniform", seed=1), 2, None,
                         False),
    "sacfl_stagger_mb3_guarded_int8_ef": (
        True, dict(max_delay=2, delay="stagger", staleness_alpha=0.7), 3,
        dict(bits=8), True),
    "safl_uniform3_1bit_guarded": (False, dict(max_delay=3, delay="uniform"), None,
                                   dict(bits=1, error_feedback=False), True),
}


@pytest.mark.parametrize("name", list(ASYNC_RUNS))
def test_async_rounds_match_reference(name):
    clip, acfg_kw, mb, codec, guarded = ASYNC_RUNS[name]
    rfn, tfn, r0, _ = _async_fns(clip, acfg_kw, mb, codec)
    run_kw, port_kw = {}, {}
    if guarded:
        rfn = functools.partial(rfn, sentinel=RSentinel(norm_mult=10.0))
        tfn = functools.partial(tfn, sentinel=TSentinel(norm_mult=10.0))
        run_kw["faults"], port_kw["faults"] = RFaultTable(FAULT_ROWS), TFaultTable(FAULT_ROWS)
    states, rh = reference_run(rfn, r0, 4, buffer=True, **run_kw)
    ms = rounds_from_reference(tfn, states, rh, r0, buffer=True, **port_kw)
    w = [float(m["arrival_weight"]) for m in ms]
    assert len(set(w)) > 1
    if acfg_kw["delay"] == "stagger":
        # closed form: generation g's client c arrives after (c + g) % D
        # rounds, each at (1 + d) ** -alpha; the scripted drops and the
        # sentinel's rejections store weight 0
        D, a = acfg_kw["max_delay"] + 1, acfg_kw.get("staleness_alpha", 0.5)
        kept = [[0.0 if guarded and FAULT_ROWS[g][c] != 0 else 1.0 for c in range(G)]
                for g in range(4)]
        want = [sum(float(np.float32((1.0 + d) ** -a)) * kept[t - d][c]
                    for d in range(D) if t - d >= 0
                    for c in range(G) if (c + t - d) % D == d) for t in range(4)]
        np.testing.assert_allclose(w, want, rtol=1e-6)


def _sync_vs_async(codec=None):
    rcfg, tcfg = cls_cfgs()
    _, tp = cls_params()
    plan = t_plan(tcfg.sketch, tp)
    acfg = AsyncConfig(max_delay=2, delay="zero")
    tc = None if codec is None else TCodec(**codec)
    afn = make_async_round(tcfg, t_cls_loss, acfg, plan, codec=tc)
    sfn = round_fns("safl", rcfg, tcfg)[1]
    astate = init_async_state(tcfg, acfg, tp, plan, G, codec=tc)
    sstate = init_safl(tcfg, tp)
    if tc is not None and tc.error_feedback:
        sstate = {"opt": sstate, "ef": astate["ef"]}
    ap, sp = tp, tp
    for t in range(3):
        batch, key = port_batch(cls_sampler(), t), prng.fold_in(prng.key(KEY), t)
        ap, astate, am = afn(ap, astate, batch, key, t=t, base_key=prng.key(KEY))
        sp, sstate, sm = sfn(sp, sstate, batch, key, codec=tc)
        for k in ap:
            assert torch.equal(ap[k], sp[k]), (t, k)
        sopt = sstate["opt"] if "ef" in sstate else sstate
        for name in ("m", "v", "vhat"):
            for k in ap:
                assert torch.equal(astate["opt"][name][k], sopt[name][k])
        assert torch.equal(am["loss"], sm["loss"])
        assert float(am["arrival_weight"]) == G
        if "ef" in sstate:
            assert torch.equal(astate["ef"], sstate["ef"])
            assert torch.equal(am["uplink_bits"], sm["uplink_bits"])


@pytest.mark.parametrize("codec", [None, dict(bits=8)])
def test_zero_delay_is_the_synchronous_round_bitwise(codec):
    _sync_vs_async(codec)


def test_async_rejects_weighted_masks():
    _, tfn, _, s0 = _async_fns(False, dict(max_delay=1, delay="stagger"))
    _, tp = cls_params()
    mask = ImportanceParticipation(G, (0.1, 0.3, 0.2, 0.15, 0.25), frac=0.4).mask(0, "cpu")
    with pytest.raises(TypeError):
        tfn(tp, s0, port_batch(cls_sampler(), 0), prng.key(0), t=0,
            base_key=prng.key(0), part_mask=mask)


def test_async_through_run_scan_bills_the_arrivals():
    """The driver's ``buffer=True`` hook hands the round ``t`` and the base
    key; every round's ``arrival_weight`` lands in the history."""
    _, tfn, _, s0 = _async_fns(False, dict(max_delay=2, delay="stagger"), 2)
    _, tp = cls_params()
    _, _, h = run_scan(tfn, _PortSampler(), tp, s0, rounds=4, key=prng.key(KEY),
                       buffer=True, chunk_size=3)
    assert set(h) == {"loss", "arrival_weight"}
    assert h["arrival_weight"].shape == (4,) and (h["arrival_weight"] > 0).all()
