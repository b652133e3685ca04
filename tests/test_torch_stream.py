"""The streamed client-microbatch fold (``microbatch=``) and the Gaussian
classification data of the port, against the reference on the CPU.

* Streamed SAFL, SACFL and FedOPT rounds at G = 5 with microbatches of 1
  to 4 clients (the tail chunk masked wherever 5 % mb != 0), under
  scripted faults with both sentinel branches (finite-only, one pass;
  norm outliers, two passes), both codecs and an all-drop round: each
  round of the port from the reference's state on its batch, parameters
  at PARAM_TOL (rtol 1e-3, atol 2e-3; tests/test_torch_safl.py states
  why), losses at LOSS_TOL, counters and measured bits exactly.
* Within the port, bit for bit: ``microbatch >= G`` is the materialized
  round, ``run_scan`` equals ``run_host_loop`` on the streamed fold, a
  two-pass round repeats itself, and the fold equals a hand fold over
  short chunks (a padded tail chunk sums to what a short one does).
* ``GaussianClsData``'s centers and label probabilities and the
  ``DeviceGaussianClsSampler`` labels bit for bit (numpy's generator,
  integer threefry draws compared with float32 cumulative rows); its
  features within ``prng.normal``'s tolerance, NORMAL_TOL of
  tests/test_torch_gaussian.py (``erfinv`` differs from XLA's in the
  tails), plus one float32 ulp of the center's add.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packed import make_packing_plan as r_plan
from repro.core.packed import sk_packed_clients_wsum as r_wsum
from repro.core.packed import derive_round_params as r_derive
from repro.core.safl import chunk_clients as r_chunk_clients
from repro.data.synthetic import ClsDataConfig as RClsCfg
from repro.data.synthetic import GaussianClsData as RCls
from repro_torch import prng
from repro_torch.core.adaptive import apply_update
from repro_torch.core.packed import derive_round_params, desk_packed
from repro_torch.core.packed import make_packing_plan as t_plan
from repro_torch.core.packed import sk_packed_clients_wsum
from repro_torch.core.safl import (chunk_clients, client_deltas, init_safl,
                                   resolve_microbatch)
from repro_torch.data.synthetic import ClsDataConfig as TClsCfg
from repro_torch.data.synthetic import GaussianClsData as TCls
from repro_torch.fed.codec import CodecConfig as TCodec
from repro_torch.fed.faults import FaultTable as TFaultTable
from repro_torch.launch.driver import run_host_loop, run_scan
from test_torch_faults import (FAULT_ROWS, G, KEY, cls_cfgs, cls_params,
                               cls_sampler, port_batch, round_fns, t_cls_loss)
from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)

NORMAL_TOL = dict(rtol=2e-5, atol=1e-6)


# (round, microbatch, faults, sentinel norm_mult, codec, participation)
STREAM_RUNS = {
    "safl_mb1_guard1": ("safl", 1, True, 0.0, None, False),
    "safl_mb2_guard2": ("safl", 2, True, 10.0, None, False),
    "safl_mb3_int8_ef": ("safl", 3, False, None, dict(bits=8), False),
    "safl_mb4_1bit_cohort": ("safl", 4, False, None,
                             dict(bits=1, error_feedback=False), True),
    "sacfl_mb2_guard2_int8_ef": ("sacfl", 2, True, 3.0, dict(bits=8, seed=1), False),
    "sacfl_mb3_guard1": ("sacfl", 3, True, 0.0, None, False),
    "sacfl_mb1_1bit_ef_cohort": ("sacfl", 1, False, None, dict(bits=1), True),
    "fedopt_mb1": ("fedopt", 1, False, None, None, False),
    "fedopt_mb2_cohort": ("fedopt", 2, False, None, None, True),
    "fedopt_mb3": ("fedopt", 3, False, None, None, False),
    "fedopt_mb4": ("fedopt", 4, False, None, None, False),
}


def test_resolve_microbatch_and_chunk_clients():
    assert resolve_microbatch(None, 5) is None
    assert resolve_microbatch(5, 5) is None and resolve_microbatch(9, 5) is None
    assert resolve_microbatch(2, 5) == 2
    for bad in (0, -3):
        with pytest.raises(ValueError):
            resolve_microbatch(bad, 5)
    x = np.arange(5 * 3 * 2, dtype=np.float32).reshape(5, 3, 2)
    for mb, pad in ((2, 1), (5, 0), (3, 1)):
        want = r_chunk_clients({"x": jnp.asarray(x)}, mb, pad)["x"]
        got = chunk_clients({"x": torch.from_numpy(x)}, mb, pad)["x"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _round(which="safl", **kw):
    rcfg, tcfg = cls_cfgs()
    _, tfn = round_fns(which, rcfg, tcfg)
    _, tp = cls_params()
    state = init_safl(tcfg, tp)
    codec = kw.get("codec")
    if codec is not None and codec.error_feedback:
        state = {"opt": state,
                 "ef": torch.full((G, t_plan(tcfg.sketch, tp).b_total), 1e-3)}
    return tfn(tp, state, port_batch(cls_sampler(), 1),
               prng.fold_in(prng.key(KEY), 1), **kw)


def _assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b, strict=True):
            _assert_same(x, y)
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["safl", "sacfl", "fedopt"])
@pytest.mark.parametrize("mb", [5, 8])
def test_microbatch_covering_the_cohort_is_the_materialized_round(which, mb):
    _assert_same(_round(which), _round(which, microbatch=mb))


def test_two_pass_round_repeats_bitwise():
    """Pass 2 recomputes pass 1's payloads, so two runs of the two-pass
    round (faults, norm sentinel, int8 codec with EF) are bit for bit."""
    from repro_torch.fed.robust import SentinelConfig
    kw = dict(microbatch=2, sentinel=SentinelConfig(norm_mult=10.0),
              fault_spec=TFaultTable(FAULT_ROWS).spec(0, None, "cpu"),
              codec=TCodec(bits=8))
    a, b = _round(**kw), _round(**kw)
    _assert_same(a, b)
    assert int(a[2]["n_rejected"]) == 2


def test_streamed_run_scan_equals_host_loop_bitwise():
    """The streamed fold under faults, the norm sentinel and the EF codec
    through both drivers: histories, params and the wrapped state."""
    from repro_torch.fed.robust import SentinelConfig
    _, tcfg = cls_cfgs()
    _, tp = cls_params()
    _, tfn = round_fns("safl", cls_cfgs()[0], tcfg)
    fn = functools.partial(tfn, sentinel=SentinelConfig(norm_mult=10.0))
    codec = TCodec(bits=8)
    b_total = t_plan(tcfg.sketch, tp).b_total
    fresh = lambda: (cls_params()[1], {"opt": init_safl(tcfg, tp),
                                       "ef": torch.zeros((G, b_total))})
    smp = TCls(TClsCfg(num_clients=G, dirichlet_alpha=0.5)).device_sampler(8, 2)
    kw = dict(rounds=4, key=prng.key(3), bits_per_round=100, microbatch=2,
              codec=codec, faults=TFaultTable(FAULT_ROWS))
    p1, s1, h1 = run_scan(fn, smp, *fresh(), chunk_size=3, **kw)
    p2, s2, h2 = run_host_loop(fn, smp, *fresh(), **kw)
    assert set(h1) == set(h2) == {"loss", "uplink_bits", "n_dropped", "n_rejected",
                                  "diverged"}
    for k in h1:
        np.testing.assert_array_equal(h1[k], h2[k])
    _assert_same(p1, p2)
    _assert_same(s1, s2)
    np.testing.assert_array_equal(
        h1["uplink_bits"], np.float32(codec.payload_bits(b_total)) * np.array(
            [3, 3, 5, 0], np.float32))


def test_streamed_fold_equals_a_hand_fold_over_short_chunks():
    """The fold's padded tail chunk (zero payload rows of weight 0) gives
    the sums a short tail chunk gives: the streamed round at G = 5, mb = 2
    equals chunks [0, 2), [2, 4), [4, 5) folded by ``sk_packed_clients_wsum``
    and desketched once, bit for bit."""
    _, tcfg = cls_cfgs()
    _, tp = cls_params()
    plan = t_plan(tcfg.sketch, tp)
    batch = port_batch(cls_sampler(), 1)
    key = prng.fold_in(prng.key(KEY), 1)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0])
    state = init_safl(tcfg, tp)
    fn = round_fns("safl", cls_cfgs()[0], tcfg)[1]
    got = fn(tp, state, batch, key, part_mask=mask, microbatch=2)
    rp = derive_round_params(plan, key, "cpu")
    S = torch.zeros(plan.b_total)
    W = L = torch.zeros(())
    for c0, c1 in ((0, 2), (2, 4), (4, 5)):
        d, losses = client_deltas(tcfg, t_cls_loss, tp,
                                  {k: v[c0:c1] for k, v in batch.items()},
                                  float(np.float32(tcfg.client_lr)))
        s, w = sk_packed_clients_wsum(plan, rp, d, mask[c0:c1])
        if c1 - c0 == 1:        # the padded form of the tail: a zero row, weight 0
            pad = {k: torch.cat([v, torch.zeros_like(v)]) for k, v in d.items()}
            s2, w2 = sk_packed_clients_wsum(plan, rp, pad, torch.cat([mask[c0:c1],
                                                                      torch.zeros(1)]))
            assert torch.equal(S + s2, S + s) and torch.equal(W + w2, W + w)
        S, W, L = S + s, W + w, L + torch.sum(mask[c0:c1] * losses)
    den = torch.clamp(W, min=1.0)
    params, opt = apply_update(tcfg.server, state, tp, desk_packed(plan, rp, S / den))
    _assert_same(got[0], params)
    _assert_same(got[1], opt)
    assert torch.equal(got[2]["loss"], L / den)


def test_sk_packed_clients_wsum_matches_reference():
    rcfg, tcfg = cls_cfgs()
    rp, tp = cls_params()
    rng = np.random.RandomState(4)
    stacked = {"W": rng.randn(3, 32, 10).astype(np.float32),
               "b": rng.randn(3, 10).astype(np.float32)}
    w = np.array([1.0, 0.0, 0.5], np.float32)
    rplan, tplan = r_plan(rcfg.sketch, rp), t_plan(tcfg.sketch, tp)
    want_s, want_w = r_wsum(rplan, r_derive(rplan, jax.random.key(3)),
                            {k: jnp.asarray(v) for k, v in stacked.items()}, jnp.asarray(w))
    got_s, got_w = sk_packed_clients_wsum(
        tplan, derive_round_params(tplan, prng.key(3), "cpu"),
        {k: torch.from_numpy(v) for k, v in stacked.items()}, torch.from_numpy(w))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=1e-6)
    assert float(got_w) == float(want_w) == 1.5


# ---------------------------------------------------------------------------
# Gaussian classification data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.0, 0.3])
def test_gaussian_cls_data_and_sampler_match_reference(alpha):
    kw = dict(num_features=12, num_classes=7, num_clients=6, dirichlet_alpha=alpha,
              seed=4)
    rdata, tdata = RCls(RClsCfg(**kw)), TCls(TClsCfg(**kw))
    np.testing.assert_array_equal(tdata.centers, rdata.centers)
    np.testing.assert_array_equal(tdata.label_probs, rdata.label_probs)
    rsmp, tsmp = rdata.device_sampler(6, 3), tdata.device_sampler(6, 3)
    np.testing.assert_array_equal(tsmp.label_cum, rsmp.label_cum)
    sample = jax.jit(rsmp.sample)
    for t in (0, 1, 17):
        want = sample(rsmp.init_state(), jnp.int32(t))[1]
        got = tsmp.round_batch(t, device="cpu")
        assert got["x"].shape == want["x"].shape == (6, 3, 2, 12)
        np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))
        wx = np.asarray(want["x"])
        noise = wx - tsmp.centers[np.asarray(want["y"])]
        err = np.abs(got["x"].numpy() - wx)
        bound = (NORMAL_TOL["atol"] + NORMAL_TOL["rtol"] * np.abs(noise)
                 + np.spacing(np.abs(wx)))
        assert (err <= bound).all(), float((err / bound).max())
        host = tsmp.host_round_batch(t)
        for k in host:
            np.testing.assert_array_equal(host[k], got[k].numpy())
    assert len(np.unique(np.asarray(want["y"]))) > 1
