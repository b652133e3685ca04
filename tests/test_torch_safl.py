"""The slice as a whole: SAFL rounds of the port against the reference.

Three rounds of bert_100m SMOKE (G=5 clients, K=2 local steps, the
independent-hash count-sketch) through each package's ``run_scan``, from
the same weights and the same round keys.  Tokens and derived operators
are bit-identical; losses, parameters and moments agree up to float32
summation order.  The port's kernel route runs its plain versions here
(CPU tensors); the reference runs its plain route (``use_pallas=False``),
which computes the same function as its Pallas route
(tests/test_torch_round.py holds single rounds against its Pallas route
and its SRHT family).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert_100m as rbert
from repro.core.adaptive import AdaConfig as RAda
from repro.core.packed import make_packing_plan as r_plan
from repro.core.safl import SAFLConfig as RSAFL
from repro.core.safl import init_safl as r_init_safl
from repro.core.safl import masked_mean as r_masked_mean
from repro.core.safl import safl_round as r_round
from repro.core.safl import split_client_batches as r_split
from repro.core.sketch import SketchConfig as RSketch
from repro.data import BigramLMData as RData
from repro.data import LMDataConfig as RDataCfg
from repro.launch.driver import run_scan as r_run_scan
from repro.models import loss_fn as r_loss
from repro_torch import prng
from repro_torch.checkpoint.io import params_to_numpy
from repro_torch.configs import bert_100m as tbert
from repro_torch.core.adaptive import AdaConfig as TAda
from repro_torch.core.packed import make_packing_plan as t_plan
from repro_torch.core.safl import SAFLConfig as TSAFL
from repro_torch.core.safl import init_safl as t_init_safl
from repro_torch.core.safl import masked_mean as t_masked_mean
from repro_torch.core.safl import safl_round as t_round
from repro_torch.core.safl import split_client_batches as t_split
from repro_torch.core.sketch import SketchConfig as TSketch
from repro_torch.data.synthetic import BigramLMData as TData
from repro_torch.data.synthetic import LMDataConfig as TDataCfg
from repro_torch.launch.driver import (COUNTER_KEYS, HISTORY_KEYS,
                                      run_host_loop, run_scan)
from repro_torch.models.config import ModelConfig as TModel
from repro_torch.models.model import init_params
from repro_torch.models.model import loss_fn as t_loss
from repro_torch.obs import PROBE_KEYS

from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)

ROUNDS = 3
DATA = dict(vocab_size=256, seq_len=32, num_clients=5, heterogeneity=0.3,
            alpha=0.05)
QUICK_KW = dict(name="tiny", arch_type="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128)
# Losses and per-round deltas agree to ~1e-6 relative (float32 matmul and
# segment-sum orders).  AMSGrad normalizes each coordinate's step
# (|m / sqrt(vhat)| <= 3.2 in round one), so a sketch slot whose mean is
# near zero turns that ~1e-6 noise into a visible step difference: the
# parameters are held to 2e-3 absolute after three lr=0.01 rounds, against
# steps of up to 3e-2 per round.
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=2e-3)


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(l)
            for path, l in flat}


def _cfgs(ref_kernels=False, **sketch):
    """(reference, port) configs; the port always takes its kernel route."""
    kw = dict(ratio=0.05, min_b=16, **sketch)
    # remat changes no value; off, the reference compiles faster
    common = dict(client_lr=0.5, local_steps=2, remat_local=False)
    return (RSAFL(sketch=RSketch(**kw, use_pallas=ref_kernels),
                  server=RAda(name="amsgrad", lr=0.01), **common),
            TSAFL(sketch=TSketch(**kw, use_kernels=True),
                  server=TAda(name="amsgrad", lr=0.01), **common))


def _samplers(data=DATA, batch_per_client=4):
    return (RData(RDataCfg(**data)).device_sampler(batch_per_client, 2),
            TData(TDataCfg(**data)).device_sampler(batch_per_client, 2))


def _weights(tmodel, seed):
    """The same random weights for both packages: the port's init on the
    host, carried to the reference as its nested dict of arrays."""
    tparams = init_params(tmodel, torch.Generator().manual_seed(seed), "cpu")
    nested = {}
    for path, arr in params_to_numpy(tparams).items():
        *parents, leaf = path.split("/")
        node = nested
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return nested, tparams


@pytest.fixture(scope="module")
def trajectories():
    """One 3-round trajectory per package on bert_100m SMOKE."""
    rcfg, tcfg = _cfgs(kind="countsketch", cs_hash="independent")
    rsmp, tsmp = _samplers()
    rparams, tparams = _weights(tbert.SMOKE, 0)
    rfn = functools.partial(r_round, rcfg, lambda p, b: r_loss(rbert.SMOKE, p, b),
                            plan=r_plan(rcfg.sketch, rparams))
    ref = r_run_scan(rfn, rsmp, rparams, r_init_safl(rcfg, rparams),
                     rounds=ROUNDS, key=jax.random.key(7), donate=False)
    tfn = functools.partial(t_round, tcfg, lambda p, b: t_loss(tbert.SMOKE, p, b),
                            plan=t_plan(tcfg.sketch, tparams))
    port = run_scan(tfn, tsmp, tparams, t_init_safl(tcfg, tparams),
                    rounds=ROUNDS, key=prng.key(7), chunk_size=2)
    return ref, port, (rsmp, tsmp)


def test_tokens_bitwise(trajectories):
    rsmp, tsmp = trajectories[2]
    sample = jax.jit(rsmp.sample)
    for t in range(ROUNDS):
        want = np.asarray(sample(rsmp.init_state(), jnp.int32(t))[1]["tokens"])
        got = tsmp.round_batch(t, device="cpu")["tokens"].numpy()
        np.testing.assert_array_equal(got, want)


def test_three_round_trajectory_matches_reference(trajectories):
    (rp, rs, rh), (tp, ts, th), _ = trajectories
    np.testing.assert_allclose(th["loss"], rh["loss"], **LOSS_TOL)
    for k, v in _flat(rp).items():
        np.testing.assert_allclose(tp[k].numpy(), v, err_msg=k, **PARAM_TOL)
    assert int(ts["step"]) == int(rs["step"]) == ROUNDS
    # moments: m is 0.1-weighted deltas, v and vhat their squares
    for name in ("m", "v", "vhat"):
        for k, v in _flat(rs[name]).items():
            scale = float(np.abs(v).max()) or 1.0
            np.testing.assert_allclose(ts[name][k].numpy(), v, rtol=1e-3,
                                       atol=1e-4 * scale, err_msg=f"{name}/{k}")


def test_port_scan_equals_host_loop_bitwise():
    _, tcfg = _cfgs(kind="countsketch", cs_hash="independent")
    model = TModel(**QUICK_KW)
    _, tsmp = _samplers({**DATA, "vocab_size": 128, "num_clients": 3}, 4)
    fresh = lambda: init_params(model, torch.Generator().manual_seed(0), "cpu")
    fn = functools.partial(t_round, tcfg, lambda p, b: t_loss(model, p, b),
                           plan=t_plan(tcfg.sketch, fresh()))
    p1, s1, h1 = run_scan(fn, tsmp, fresh(), t_init_safl(tcfg, fresh()),
                          rounds=3, key=prng.key(4), chunk_size=2,
                          bits_per_round=123)
    p2, s2, h2 = run_host_loop(fn, tsmp, fresh(), t_init_safl(tcfg, fresh()),
                               rounds=3, key=prng.key(4), bits_per_round=123)
    assert set(h1) == set(h2) == {"loss", "uplink_bits"}
    assert set(HISTORY_KEYS) == ({"loss", "uplink_bits"} | set(COUNTER_KEYS)
                                 | set(PROBE_KEYS))
    for k in h1:
        np.testing.assert_array_equal(h1[k], h2[k])
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    for name in ("m", "v", "vhat"):
        for k in s1[name]:
            assert torch.equal(s1[name][k], s2[name][k]), (name, k)


@pytest.mark.parametrize("mask", [None, [1.0, 0.0, 1.0, 1.0, 0.0],
                                  [0.0, 0.0, 0.0, 0.0, 0.0]])
def test_masked_mean_and_client_split_match_reference(mask):
    x = np.random.RandomState(0).randn(5, 3, 4).astype(np.float32)
    want = r_masked_mean(jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    got = t_masked_mean(torch.from_numpy(x),
                        None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    batch = {"tokens": np.arange(40 * 3).reshape(40, 3)}
    want = r_split(batch, 5, 2)["tokens"]
    got = t_split({"tokens": torch.from_numpy(batch["tokens"])}, 5, 2)["tokens"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampler_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    _, tsmp = _samplers()
    with pytest.raises((RuntimeError, AssertionError)):
        tsmp.init_state()
