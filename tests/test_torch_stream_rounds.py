"""Streamed SAFL, SACFL and FedOPT rounds of the port against the reference's,
each from the reference's state (tests/test_torch_stream.py holds the
helpers and the fold's bitwise pins)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.safl import init_safl as r_init_safl
from repro.fed import CodecConfig as RCodec
from repro.fed import FaultTable as RFaultTable
from repro.fed import UniformParticipation as RUniform
from repro_torch.core.packed import make_packing_plan as t_plan
from repro_torch.fed import UniformParticipation as TUniform
from repro_torch.fed.codec import CodecConfig as TCodec
from repro_torch.fed.faults import FaultTable as TFaultTable

from test_torch_faults import (FAULT_ROWS, G, cls_cfgs, cls_params,
                               reference_run, round_fns,
                               rounds_from_reference)
from test_torch_stream import STREAM_RUNS
from torch_priority import lower_priority  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", list(STREAM_RUNS))
def test_streamed_rounds_match_reference(name):
    which, mb, faults, norm_mult, codec, cohort = STREAM_RUNS[name]
    rcfg, tcfg = cls_cfgs()
    sentinel = None if norm_mult is None else dict(norm_mult=norm_mult)
    rfn, tfn = round_fns(which, rcfg, tcfg, sentinel=sentinel, microbatch=mb)
    rp, tp = cls_params()
    r0 = r_init_safl(rcfg, rp)
    run_kw, port_kw = {}, {}
    if codec is not None:
        rfn = functools.partial(rfn, codec=RCodec(**codec))
        tfn = functools.partial(tfn, codec=TCodec(**codec))
        if TCodec(**codec).error_feedback:
            r0 = {"opt": r0, "ef": jnp.zeros((G, t_plan(tcfg.sketch, tp).b_total))}
    if faults:
        run_kw["faults"], port_kw["faults"] = RFaultTable(FAULT_ROWS), TFaultTable(FAULT_ROWS)
    if cohort:
        run_kw["participation"] = RUniform(G, frac=0.6, seed=1)
        port_kw["participation"] = TUniform(G, frac=0.6, seed=1)
    rounds = 4 if faults else 2
    states, rh = reference_run(rfn, r0, rounds, **run_kw)
    ms = rounds_from_reference(tfn, states, rh, r0, **port_kw)
    if faults:
        assert [int(m["n_rejected"]) for m in ms] == [2 if norm_mult else 1, 1, 0, 0]
        for k, v in states[3][0].items():            # the all-drop round
            np.testing.assert_array_equal(v, states[2][0][k])
