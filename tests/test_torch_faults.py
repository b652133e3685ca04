"""Fault injection and payload sentinels of the port against the reference
(``repro_torch.fed.faults``, ``repro_torch.fed.robust``) on the CPU.

* Fault specs over rounds 0..31 (``FaultConfig`` transient, persistent
  and windowed; ``FaultTable`` cyclic and not), ``corrupt_payload``,
  ``fold_arrivals``, ``n_dropped``, ``masked_median`` and
  ``guard_uplink``: bit for bit.  The draws are integer-derived threefry
  uniforms compared with float32-rounded thresholds, and the guard's
  arithmetic is elementwise or a sort on identical numpy payloads.
* Rounds of the 330-parameter linear classifier (the reference's stream
  workload, ``benchmarks/run.py::stream_rows``) with a ``FaultTable`` and
  both sentinel branches, each round of the port run from the
  reference's state on the reference's batch: parameters at PARAM_TOL
  (rtol 1e-3, atol 2e-3, tests/test_torch_safl.py states why: AMSGrad
  turns float32 noise in a near-zero update into a step difference),
  losses at LOSS_TOL (1e-5, float32 reductions in another order), the
  guard's counters exactly (the faults are scripted far from the norm
  threshold: x1e3 against norm_mult 3 and 10).
* Within the port, bit for bit: a neutral fault spec against the hookless
  round, a NaN client against the same client dropped, and the all-drop
  round carrying the server through.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.adaptive import AdaConfig as RAda
from repro.core.clipped import ClippedSAFLConfig as RClip
from repro.core.clipped import clipped_safl_round as r_clipped
from repro.core.packed import make_packing_plan as r_plan
from repro.core.safl import SAFLConfig as RSAFL
from repro.core.safl import fedopt_round as r_fedopt
from repro.core.safl import safl_round as r_round
from repro.core.sketch import SketchConfig as RSketch
from repro.data.synthetic import ClsDataConfig as RClsCfg
from repro.data.synthetic import GaussianClsData as RCls
from repro.fed import FaultConfig as RFaultConfig
from repro.fed import FaultTable as RFaultTable
from repro.fed import SentinelConfig as RSentinel
from repro.fed import faults as rfaults
from repro.fed import robust as rrobust
from repro.launch.driver import run_scan as r_run_scan
from repro_torch import prng
from repro_torch.core.adaptive import AdaConfig as TAda
from repro_torch.core.clipped import ClippedSAFLConfig as TClip
from repro_torch.core.clipped import clipped_safl_round
from repro_torch.core.packed import make_packing_plan as t_plan
from repro_torch.core.safl import SAFLConfig as TSAFL
from repro_torch.core.safl import fedopt_round, init_safl, safl_round
from repro_torch.core.sketch import SketchConfig as TSketch
from repro_torch.fed import faults as tfaults
from repro_torch.fed import robust as trobust
from repro_torch.fed.faults import BYZANTINE, DROP, INF, NAN, OK
from repro_torch.fed.faults import FaultConfig as TFaultConfig
from repro_torch.fed.faults import FaultTable as TFaultTable
from repro_torch.fed.robust import SentinelConfig as TSentinel

from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)

G, F, C = 5, 32, 10
KEY = 7
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=2e-3)
COUNTERS = ("n_dropped", "n_rejected", "diverged", "arrival_weight",
            "uplink_bits")

# scripted faults: round 0 a NaN client and a Byzantine (x1e3) one, round 1
# a drop and an Inf, round 2 clean, round 3 every client dropped
FAULT_ROWS = ((OK, NAN, OK, BYZANTINE, OK), (DROP, OK, INF, OK, OK),
              (OK,) * G, (DROP,) * G)


# ---------------------------------------------------------------------------
# the linear classifier on Gaussian-mixture data, in both packages
# ---------------------------------------------------------------------------

def r_cls_loss(p, b):
    logits = b["x"] @ p["W"] + p["b"]
    return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                         b["y"][..., None], axis=-1))


def t_cls_loss(p, b):
    logits = b["x"] @ p["W"] + p["b"]
    return -torch.mean(torch.gather(torch.log_softmax(logits, dim=-1), -1,
                                    b["y"][..., None]))


def cls_params(seed=0):
    """Small random weights of the (F, C) linear classifier, both forms."""
    rng = np.random.RandomState(seed)
    p = {"W": rng.randn(F, C).astype(np.float32) * 0.1,
         "b": rng.randn(C).astype(np.float32) * 0.1}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


def cls_cfgs(server="amsgrad"):
    """(reference, port) configs: independent-hash count-sketch at ratio
    0.25 (b_total 88; the port's kernel route runs its plain version on
    CPU tensors), client lr 0.1, K = 2."""
    kw = dict(kind="countsketch", ratio=0.25, min_b=8, cs_hash="independent")
    return (RSAFL(sketch=RSketch(**kw), server=RAda(name=server, lr=0.05),
                  client_lr=0.1, local_steps=2, remat_local=False),
            TSAFL(sketch=TSketch(**kw, use_kernels=True),
                  server=TAda(name=server, lr=0.05), client_lr=0.1,
                  local_steps=2))


def cls_sampler(num_clients=G):
    """The reference's Gaussian-mixture sampler: 8 samples a client, K = 2."""
    return RCls(RClsCfg(num_features=F, num_classes=C, num_clients=num_clients,
                        dirichlet_alpha=0.5)).device_sampler(8, 2)


def port_batch(rsmp, t):
    """The reference's round-t batch as the port's tensors."""
    return {k: torch.from_numpy(np.array(v)).to(torch.int64 if k == "y" else torch.float32)
            for k, v in rsmp.round_batch(t).items()}


def round_fns(which, rcfg, tcfg, sentinel=None, **bound):
    """(reference, port) round functions of ``which`` (safl, sacfl,
    fedopt), the sentinel and ``bound`` keywords bound in."""
    rp, tp = cls_params()
    rs = None if sentinel is None else RSentinel(**sentinel)
    ts = None if sentinel is None else TSentinel(**sentinel)
    if which == "fedopt":
        return (functools.partial(r_fedopt, rcfg, r_cls_loss, **bound),
                functools.partial(fedopt_round, tcfg, t_cls_loss, **bound))
    if which == "sacfl":
        return (functools.partial(r_clipped, RClip(base=rcfg, clip_tau=0.5),
                                  r_cls_loss, plan=r_plan(rcfg.sketch, rp),
                                  sentinel=rs, **bound),
                functools.partial(clipped_safl_round, TClip(base=tcfg, clip_tau=0.5),
                                  t_cls_loss, plan=t_plan(tcfg.sketch, tp),
                                  sentinel=ts, **bound))
    return (functools.partial(r_round, rcfg, r_cls_loss, plan=r_plan(rcfg.sketch, rp),
                              sentinel=rs, **bound),
            functools.partial(safl_round, tcfg, t_cls_loss, plan=t_plan(tcfg.sketch, tp),
                              sentinel=ts, **bound))


def to_port(tree):
    """A reference state (nested dicts of arrays; params keyed flat here)
    as the port's tensors."""
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def reference_run(rfn, rstate, rounds, rsmp=None, **run_kw):
    """The reference's ``run_scan``, one round a chunk; returns each round's
    (params, state) as numpy and the history."""
    states = []
    rparams, _ = cls_params()
    _, _, hist = r_run_scan(
        rfn, rsmp or cls_sampler(), rparams, rstate, rounds=rounds,
        key=jax.random.key(KEY), chunk_size=1, donate=False,
        on_chunk=lambda t, p, s, h: states.append(jax.tree.map(np.asarray, (p, s))),
        **run_kw)
    return states, hist


def assert_state_close(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_state_close(got[k], want[k], f"{what}/{k}")
        return
    want = np.asarray(want)
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
    else:
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                   atol=max(2e-3 * min(scale, 1.0), 1e-4 * scale),
                                   err_msg=what)


def rounds_from_reference(tfn, states, rhist, rstate0, *, faults=None,
                          rsmp=None, buffer=False, participation=None):
    """Each round of the port from the reference's state before it, on the
    reference's batch and key: parameters at PARAM_TOL, the state's
    leaves at its tolerance (integers exactly), the loss at LOSS_TOL and
    every counter exactly.  Returns the port's metrics."""
    rsmp = rsmp or cls_sampler()
    params, state = cls_params()[1], to_port(jax.tree.map(np.asarray, rstate0))
    got = []
    for t, (rp, rs) in enumerate(states):
        kw = {}
        if faults is not None:
            kw["fault_spec"] = faults.spec(t, prng.key(KEY), "cpu")
        if participation is not None:
            kw["part_mask"] = participation.mask(t, "cpu")
        if buffer:
            kw.update(t=t, base_key=prng.key(KEY))
        p2, s2, m = tfn(params, state, port_batch(rsmp, t),
                        prng.fold_in(prng.key(KEY), t), **kw)
        for k, v in rp.items():
            np.testing.assert_allclose(p2[k].numpy(), v, err_msg=f"round {t} {k}",
                                       **PARAM_TOL)
        assert_state_close(s2, rs, f"round {t} state")
        np.testing.assert_allclose(float(m["loss"]), rhist["loss"][t], **LOSS_TOL)
        for k in COUNTERS:
            assert (k in m) == (k in rhist), k
            if k in m:
                assert float(m[k]) == float(rhist[k][t]), (t, k, m[k], rhist[k][t])
        got.append(m)
        params, state = to_port(rp), to_port(rs)
    return got


# ---------------------------------------------------------------------------
# fault specs and the guard, bit for bit
# ---------------------------------------------------------------------------

FAULT_POLICIES = {
    "transient": dict(drop_rate=0.1, nan_rate=0.1, inf_rate=0.05,
                      byzantine_rate=0.15, seed=3),
    "persistent": dict(drop_rate=0.2, nan_rate=0.05, byzantine_rate=0.1,
                       byzantine_scale=50.0, persistent=True, seed=1),
    "windowed": dict(drop_rate=0.3, nan_rate=0.3, start=5, stop=11),
    "table": (FAULT_ROWS, False),
    "table_cyclic": (FAULT_ROWS, True),
}


def _policies(name):
    kw = FAULT_POLICIES[name]
    if name.startswith("table"):
        rows, cyclic = kw
        return (RFaultTable(rows, byzantine_scale=7.5, cyclic=cyclic),
                TFaultTable(rows, byzantine_scale=7.5, cyclic=cyclic))
    return RFaultConfig(num_clients=7, **kw), TFaultConfig(num_clients=7, **kw)


def _payload(seed, g=6, b=40):
    rng = np.random.RandomState(seed)
    x = rng.randn(g, b).astype(np.float32)
    x[2] *= 1e3                  # a norm outlier
    return x


SPEC_ROWS = {"clean": (OK,) * 6, "mixed": (OK, NAN, DROP, BYZANTINE, INF, OK),
             "nan_drop": (NAN, OK, OK, DROP, OK, OK)}
MASKS = {"none": None, "mask": np.array([1, 1, 0, 1, 1, 1], np.float32),
         "weighted": {"w": np.array([0.5, 2, 1, 0, 1.5, 1], np.float32),
                      "den": 4.0, "n": 4}}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("rows", list(SPEC_ROWS))
@pytest.mark.parametrize("norm_mult", [0.0, 3.0])
def test_guard_uplink_bitwise(rows, mask, norm_mult):
    """``corrupt_payload``, ``fold_arrivals``, ``n_dropped``,
    ``masked_median`` and ``guard_uplink`` on identical numpy payloads."""
    x = _payload(sum(map(ord, rows)))
    codes = np.array(SPEC_ROWS[rows], np.int32)
    rspec = rfaults._spec_from_codes(jnp.asarray(codes), 1e3)
    tspec = tfaults._spec_from_codes(torch.from_numpy(codes), 1e3)
    m = MASKS[mask]
    rmask = (None if m is None else {**m, "w": jnp.asarray(m["w"])}
             if isinstance(m, dict) else jnp.asarray(m))
    tmask = (None if m is None else {**m, "w": torch.from_numpy(m["w"])}
             if isinstance(m, dict) else torch.from_numpy(m))

    def same(got, want, what):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)

    same(tfaults.corrupt_payload(tspec, torch.from_numpy(x)),
         rfaults.corrupt_payload(rspec, jnp.asarray(x)), "corrupt_payload")
    same(tfaults.n_dropped(tspec, tmask), rfaults.n_dropped(rspec, rmask), "n_dropped")
    fa_t, fa_r = (tfaults.fold_arrivals(tspec, tmask),
                  rfaults.fold_arrivals(rspec, rmask))
    same(fa_t["w"] if isinstance(fa_t, dict) else fa_t,
         fa_r["w"] if isinstance(fa_r, dict) else fa_r, "fold_arrivals")
    nrm2 = np.sum(x * x, axis=1)
    pool = np.array([True, False, True, True, False, True])
    same(trobust.masked_median(torch.from_numpy(nrm2), torch.from_numpy(pool)),
         rrobust.masked_median(jnp.asarray(nrm2), jnp.asarray(pool)), "masked_median")

    sent = dict(norm_mult=norm_mult)
    rp, rm, rc = rrobust.guard_uplink(jnp.asarray(x), rmask, rspec, RSentinel(**sent))
    tp, tm, tc = trobust.guard_uplink(torch.from_numpy(x), tmask, tspec, TSentinel(**sent))
    same(tp, rp, "guarded payload")
    same(tm["w"] if isinstance(tm, dict) else tm, rm["w"] if isinstance(rm, dict) else rm,
         "effective mask")
    assert set(tc) == set(rc) == {"n_dropped", "n_rejected"}
    for k in rc:
        assert float(tc[k]) == float(rc[k]), k
    assert tc["n_rejected"].dtype == torch.int32


# ---------------------------------------------------------------------------
# rounds against the reference
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# within the port, bit for bit
# ---------------------------------------------------------------------------

def _port_round(which="safl", **kw):
    _, tcfg = cls_cfgs()
    _, tp = cls_params()
    fn = round_fns(which, cls_cfgs()[0], tcfg)[1]
    return fn(tp, init_safl(tcfg, tp), port_batch(cls_sampler(), 0),
              prng.fold_in(prng.key(KEY), 0), **kw)


def _assert_same(a, b, keys=None):
    for k in keys or a:
        if isinstance(a[k], dict):
            _assert_same(a[k], b[k])
        else:
            assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# errors and bits billed
# ---------------------------------------------------------------------------


class _PortSampler:
    """The reference's batches through the port's sampler protocol."""

    def __init__(self, rsmp=None):
        self.rsmp = rsmp or cls_sampler()

    def init_state(self, device):
        return {}

    def sample(self, state, t):
        return state, port_batch(self.rsmp, t)
