"""The payload codec of the port against the reference
(``repro_torch.fed.codec``) on the CPU.

* ``quantize_rows`` and ``encode_decode``, 8-bit and 1-bit, with and
  without error feedback, on identical rows: the decoded rows bit for bit
  against the reference's compiled program (the rounding uniforms are
  integer-derived threefry draws keyed by the global client index, the
  rest the same float32 elementwise arithmetic and an exact max); the
  8-bit EF residual within one float32 ulp of the row's largest entry,
  because XLA:CPU contracts the reference's ``x - q * s`` into one fused
  multiply-add (ROADMAP §C).
* Codec rounds of the linear classifier (tests/test_torch_faults.py's
  harness), each round of the port run from the reference's state on its
  batch: parameters at PARAM_TOL (tests/test_torch_safl.py states why),
  the EF memory at the same tolerance scaled to its largest entry
  (stochastic rounding turns float32 noise at a rounding boundary into
  one quantization step in that coordinate; on these inputs none
  flipped), the measured ``uplink_bits`` exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.safl import init_safl as r_init_safl
from repro.fed import CodecConfig as RCodec
from repro.fed import FaultTable as RFaultTable
from repro.fed import UniformParticipation as RUniform
from repro.fed import codec as rcodec
from repro_torch import prng
from repro_torch.core.packed import make_packing_plan as t_plan
from repro_torch.core.safl import init_safl
from repro_torch.fed import UniformParticipation as TUniform
from repro_torch.fed import codec as tcodec
from repro_torch.fed.codec import CodecConfig as TCodec
from repro_torch.fed.faults import FaultTable as TFaultTable
from test_torch_faults import (FAULT_ROWS, G, cls_cfgs, cls_params,
                               cls_sampler, port_batch, reference_run,
                               round_fns, rounds_from_reference)
from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)


def _rows(seed, n=6, b=257):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, b) * rng.uniform(1e-3, 10, (n, 1))).astype(np.float32)
    x[2] = 0.0                   # an all-zero row decodes to exactly 0
    x[4, :7] = 0.0
    return x


@pytest.mark.parametrize("bits", [1, 8])
@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("ids", [None, (3, 0, 7, 11, 2, 100)])
def test_encode_decode_bitwise(bits, ef, ids):
    x = _rows(bits + 2 * ef)
    e = _rows(9)[::-1].copy() * 0.01 if ef else None
    rkey = jax.random.fold_in(jax.random.key(5), 0)
    tkey = prng.fold_in(prng.key(5), 0)
    rc, tc = RCodec(bits=bits, seed=4), TCodec(bits=bits, seed=4)
    want, want_ef = jax.jit(functools.partial(rcodec.encode_decode, rc))(
        rkey, jnp.asarray(x), None if e is None else jnp.asarray(e),
        None if ids is None else jnp.asarray(ids, jnp.int32))
    got, got_ef = tcodec.encode_decode(tc, tkey, torch.from_numpy(x),
                                       None if e is None else torch.from_numpy(e), ids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got_ef is None) == (want_ef is None)
    if ef:
        # the 1-bit residual x - (+-s) is one rounding in both packages; the
        # 8-bit one x - q * s is one fused multiply-add in the reference's
        # compiled program (XLA:CPU contracts it) and two roundings in the
        # port: at most one float32 ulp of the row's largest |x| apart
        diff = np.abs(got_ef.numpy() - np.asarray(want_ef))
        ulp = np.spacing(np.abs(x + e).max(axis=1, keepdims=True))
        if bits == 1:
            np.testing.assert_array_equal(got_ef.numpy(), np.asarray(want_ef))
        assert (diff <= ulp).all(), float((diff / ulp).max())
    else:
        assert not got[2].any()          # -0.0 in the 1-bit code, as in the reference
    xe = torch.from_numpy(x if e is None else x + e)
    assert torch.equal(tcodec.quantize_rows(tc, tkey, xe, ids or range(6)), got)
    levels = torch.unique(torch.round(got[0] / got[0].abs().max()
                                      * (127 if bits == 8 else 1)))
    assert len(levels) <= (255 if bits == 8 else 2)


def test_quantize_rows_bitwise_per_client_key():
    """A row's uniforms depend only on its global client id: rows quantized
    together or one at a time give the same bits (the streamed fold's
    premise), as in the reference."""
    x = torch.from_numpy(_rows(3))
    c = TCodec(bits=8)
    key = prng.key(2)
    whole = tcodec.quantize_rows(c, key, x, range(10, 16))
    for i in range(6):
        one = tcodec.quantize_rows(c, key, x[i:i + 1], [10 + i])
        assert torch.equal(one[0], whole[i])


def test_codec_config_validates_bits_and_payload_bits():
    for bits in (0, 2, 4, 16):
        with pytest.raises(ValueError):
            TCodec(bits=bits)
    for bits in (1, 8):
        assert TCodec(bits=bits).payload_bits(2_640_275) == RCodec(bits=bits).payload_bits(
            2_640_275) == 2_640_275 * bits + 32
    assert tcodec.init_codec_state(None, 5, 10, "cpu") is None
    assert tcodec.init_codec_state(TCodec(error_feedback=False), 5, 10, "cpu") is None
    assert tcodec.init_codec_state(TCodec(), 5, 10, "cpu").shape == (5, 10)


def _wrapped(rcfg, rparams, codec, b_total):
    st = r_init_safl(rcfg, rparams)
    return {"opt": st, "ef": jnp.zeros((G, b_total), jnp.float32)} if codec.error_feedback else st


CODEC_RUNS = {
    "safl_int8_ef": ("safl", dict(bits=8), {}),
    "safl_1bit": ("safl", dict(bits=1, error_feedback=False), {}),
    "safl_1bit_ef_cohort": ("safl", dict(bits=1), dict(participation=True)),
    "sacfl_int8_ef_guarded": ("sacfl", dict(bits=8, seed=3),
                              dict(faults=True, sentinel=dict(norm_mult=10.0))),
}


@pytest.mark.parametrize("name", list(CODEC_RUNS))
def test_codec_rounds_match_reference(name):
    """Three materialized codec rounds: the decoded payload, the EF memory
    (frozen for unsampled clients) and the measured bits, which bill the
    effective cohort (a drop and a rejection fewer under the guard)."""
    which, ckw, hooks = CODEC_RUNS[name]
    rc, tc = RCodec(**ckw), TCodec(**ckw)
    rcfg, tcfg = cls_cfgs()
    rfn, tfn = round_fns(which, rcfg, tcfg, sentinel=hooks.get("sentinel"))
    rfn = functools.partial(rfn, codec=rc)
    tfn = functools.partial(tfn, codec=tc)
    rp, tp = cls_params()
    b_total = t_plan(tcfg.sketch, tp).b_total
    run_kw, port_kw = {}, {}
    if hooks.get("faults"):
        run_kw["faults"], port_kw["faults"] = RFaultTable(FAULT_ROWS), TFaultTable(FAULT_ROWS)
    if hooks.get("participation"):
        run_kw["participation"] = RUniform(G, frac=0.6, seed=1)
        port_kw["participation"] = TUniform(G, frac=0.6, seed=1)
    r0 = _wrapped(rcfg, rp, rc, b_total)
    states, rh = reference_run(rfn, r0, 3, **run_kw)
    ms = rounds_from_reference(tfn, states, rh, r0, **port_kw)
    per = tc.payload_bits(b_total)
    n = [5, 5, 5]
    if hooks.get("faults"):
        n = [3, 3, 5]
    if hooks.get("participation"):
        n = [3, 3, 3]
    assert [float(m["uplink_bits"]) for m in ms] == [float(np.float32(per * k)) for k in n]
    if hooks.get("participation") and tc.error_feedback:
        # unsampled clients keep their memory: round 1 from round 0's state
        mask = port_kw["participation"].mask(1, "cpu")
        ef0, ef1 = states[0][1]["ef"], states[1][1]["ef"]
        for c in range(G):
            assert np.array_equal(ef1[c], ef0[c]) == (float(mask[c]) == 0.0)


def test_codec_round_bills_measured_bits_without_a_mask():
    """No cohort and no guard: the whole cohort's encoded rows, float32."""
    _, tcfg = cls_cfgs()
    _, tp = cls_params()
    _, tfn = round_fns("safl", cls_cfgs()[0], tcfg)
    codec = TCodec(bits=1, error_feedback=False)
    _, state, m = tfn(tp, init_safl(tcfg, tp), port_batch(cls_sampler(), 0),
                      prng.key(3), codec=codec)
    b_total = t_plan(tcfg.sketch, tp).b_total
    assert m["uplink_bits"].dtype == torch.float32
    assert float(m["uplink_bits"]) == float(codec.payload_bits(b_total) * G)
    assert set(state) == {"step", "m", "v", "vhat"}     # no EF: unwrapped
