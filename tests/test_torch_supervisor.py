"""The port's rollback supervisor (``repro_torch.launch.supervisor``) and its
training launcher (``repro_torch.launch.train_lm``) against the
reference's (``repro.launch.supervisor``, ``examples/train_lm.py``), on
the CPU, on tests/test_obs.py's linear task (its batches a numpy table,
``test_torch_obs.PortLinear``/``RefLinear``).

* tests/test_faults.py's supervisor pins, within the port: a transient
  fault escaped by a rekeyed rollback (``t_resume`` 4, checkpoint files
  written), a persistent fault exhausting the budget with a deepening
  rollback, a clean run passing through bit for bit, the ``chunk_is_bad``
  verdicts (the reference's reason strings), and the acceptance scenario
  (a NaN client every round and a forced divergence, ``t_resume`` [6, 4]).
* The same supervised scenarios through both packages: the recovery log
  exactly (``retry``, ``t_fault``, ``t_resume``, ``reason``), the final
  parameters at PARAM_TOL (rtol 1e-3, atol 2e-3, tests/test_torch_safl.py
  states why), the loss histories at rtol 1e-5.
* A supervised checkpoint the port wrote restores with the reference's
  ``restore_checkpoint``, its cursor the reference's ``key_data``.
* ``train_lm.main`` refuses the reference's four flag combinations with
  the reference's messages.
"""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as r_restore
from repro.core.packed import make_packing_plan as r_plan
from repro.core.safl import init_safl as r_init_safl
from repro.core.safl import safl_round as r_round
from repro.fed import BYZANTINE as R_BYZANTINE
from repro.fed import NAN as R_NAN
from repro.fed import OK as R_OK
from repro.fed import FaultConfig as RFaultConfig
from repro.fed import SentinelConfig as RSentinel
from repro.fed.faults import _spec_from_codes as r_spec_from_codes
from repro.launch.driver import run_scan as r_run_scan
from repro.launch.supervisor import SupervisorConfig as RSupConfig
from repro.launch.supervisor import chunk_is_bad as r_chunk_is_bad
from repro.launch.supervisor import run_supervised as r_run_supervised
from repro_torch import prng
from repro_torch.core.packed import make_packing_plan as t_plan
from repro_torch.core.safl import init_safl, safl_round
from repro_torch.fed.faults import BYZANTINE, NAN, OK, FaultConfig
from repro_torch.fed.faults import _spec_from_codes as t_spec_from_codes
from repro_torch.fed.robust import SentinelConfig
from repro_torch.launch import train_lm
from repro_torch.launch.driver import run_scan
from repro_torch.launch.supervisor import (SupervisorConfig, SupervisorError,
                                           chunk_is_bad, format_recovery_log,
                                           run_supervised)
from test_torch_obs import (G, PortLinear, RefLinear, TransientFaults, linear_cfgs,
                            port_setup, r_linear, t_linear)
from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)

ROUNDS, CHUNK = 8, 2
PARAM_TOL = dict(rtol=1e-3, atol=2e-3)
REPO = os.path.join(os.path.dirname(__file__), "..")


def finite(tree) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in tree.values())


def launcher(round_fn, faults, stream=None):
    def launch(p, s, *, key, start_round, on_chunk):
        return run_scan(round_fn, PortLinear(), p, s, rounds=ROUNDS, key=key,
                        chunk_size=CHUNK, start_round=start_round,
                        on_chunk=on_chunk, faults=faults, stream=stream)
    return launch


def r_launcher(round_fn, faults):
    def launch(p, s, *, key, start_round, on_chunk):
        return r_run_scan(round_fn, RefLinear(), p, s, rounds=ROUNDS, key=key,
                          chunk_size=CHUNK, start_round=start_round,
                          on_chunk=on_chunk, faults=faults)
    return launch


def test_supervisor_escapes_transient_fault(tmp_path):
    """Unguarded NaN payloads in rounds 4 and 5 poison the run; the
    supervisor rolls back to round 4, rekeys, and finishes finite."""
    round_fn, fresh = port_setup()
    key = prng.key(0)
    faults = TransientFaults(key, (OK, NAN, OK, OK))
    pX, _, _ = run_scan(round_fn, PortLinear(), *fresh(), rounds=ROUNDS,
                        key=key, chunk_size=CHUNK, faults=faults)
    assert not finite(pX)
    ckpt = str(tmp_path / "sup")
    p, _, hist, log = run_supervised(
        launcher(round_fn, faults), *fresh(), rounds=ROUNDS, key=key,
        config=SupervisorConfig(max_retries=3), ckpt_path=ckpt)
    assert finite(p)
    assert len(hist["loss"]) == ROUNDS and np.isfinite(hist["loss"]).all()
    assert len(log) == 1
    assert log[0]["retry"] == 1 and log[0]["t_resume"] == 4
    assert "non-finite" in log[0]["reason"]
    assert os.path.exists(ckpt + ".npz") and os.path.exists(ckpt + ".json")
    assert "1 rollback" in format_recovery_log(log)


def test_supervisor_exhausts_on_persistent_fault():
    round_fn, fresh = port_setup()
    faults = FaultConfig(num_clients=G, nan_rate=0.9, start=4, stop=6,
                         persistent=True)
    with pytest.raises(SupervisorError) as e:
        run_supervised(launcher(round_fn, faults), *fresh(), rounds=ROUNDS,
                       key=prng.key(0), config=SupervisorConfig(max_retries=2))
    assert len(e.value.log) == 2
    # the repeat fault distrusts the first cursor and deepens past it
    assert e.value.log[0]["t_resume"] == 4
    assert e.value.log[1]["t_resume"] <= 4


def test_supervisor_clean_run_is_passthrough():
    round_fn, fresh = port_setup()
    key = prng.key(0)
    pA, sA, hA = run_scan(round_fn, PortLinear(), *fresh(), rounds=ROUNDS,
                          key=key, chunk_size=CHUNK)
    pB, sB, hB, log = run_supervised(launcher(round_fn, None), *fresh(),
                                     rounds=ROUNDS, key=key)
    assert all(torch.equal(pA[k], pB[k]) for k in pA)
    assert all(torch.equal(sA[k], sB[k]) for k in ("step",))
    for m in ("m", "v", "vhat"):
        assert all(torch.equal(sA[m][k], sB[m][k]) for k in sA[m])
    np.testing.assert_array_equal(hA["loss"], hB["loss"])
    assert log == [] and "clean run" in format_recovery_log(log)


VERDICTS = {
    "ok": ({"loss": [1.0, 0.5]}, 0.0),
    "nan": ({"loss": [1.0, np.nan]}, 0.0),
    "inf_first": ({"loss": [np.inf, 1.0]}, 0.0),
    "threshold": ({"loss": [1.0, 9.0]}, 5.0),
    "below_threshold": ({"loss": [1.0, 4.0]}, 5.0),
    "sentinel": ({"loss": [1.0], "diverged": [1.0]}, 0.0),
    "empty": ({}, 0.0),
}


@pytest.mark.parametrize("case", list(VERDICTS))
def test_chunk_is_bad_verdicts(case):
    hist, div = VERDICTS[case]
    hist = {k: np.asarray(v, np.float32) for k, v in hist.items()}
    assert chunk_is_bad(hist, div) == r_chunk_is_bad(hist, div)
    assert chunk_is_bad(hist, div)[0] == (case not in ("ok", "below_threshold",
                                                       "empty"))


# the acceptance scenario (tests/test_faults.py): an SGD server, a NaN
# client every round under the sentinel, and under the run's original key
# an all-client Byzantine round 5 that the median rule cannot reject and
# that blows the loss past the divergence threshold one chunk later
ACCEPT_KEY = 2


class Acceptance:
    def __init__(self, key0):
        self.key0 = key0

    def spec(self, t, base_key, device):
        blow = base_key == self.key0 and t == 5
        codes = (BYZANTINE,) * G if blow else (OK, OK, NAN, OK)
        return t_spec_from_codes(torch.tensor(codes, dtype=torch.int32,
                                              device=device), 1e6)


class RAcceptance:
    def __init__(self, key0):
        self.kd0 = np.asarray(jax.random.key_data(key0))

    def spec(self, t, base_key):
        codes = jnp.where(jnp.arange(G) == 2, R_NAN, R_OK)
        blow = jnp.all(jax.random.key_data(base_key) == self.kd0) & (t == 5)
        return r_spec_from_codes(jnp.where(blow, R_BYZANTINE, codes),
                                 jnp.float32(1e6))


class RTransient:
    """tests/test_faults.py::_TransientFaults (client 1 NaN in rounds 4, 5
    under the original key)."""

    def __init__(self, key0):
        self.kd0 = np.asarray(jax.random.key_data(key0))

    def spec(self, t, base_key):
        hit = (jnp.all(jax.random.key_data(base_key) == self.kd0)
               & (t >= 4) & (t < 6))
        row = jnp.asarray([R_OK, R_NAN, R_OK, R_OK], jnp.int32)
        return r_spec_from_codes(jnp.where(hit, row, R_OK), 1e3)


def scenario(name):
    """(port round_fn, fresh, faults, key; reference round_fn, fresh,
    faults, key; supervisor kwargs) of a supervised scenario."""
    if name == "transient":
        rcfg, tcfg = linear_cfgs()
        sent_t = sent_r = None
        tkey, rkey = prng.key(0), jax.random.key(0)
        tf, rf = TransientFaults(tkey, (OK, NAN, OK, OK)), RTransient(rkey)
        sup = dict(max_retries=3)
    else:
        rcfg, tcfg = linear_cfgs(server="sgd", lr=0.5)
        sent_t = SentinelConfig(norm_mult=10.0, divergence=1e3)
        sent_r = RSentinel(norm_mult=10.0, divergence=1e3)
        tkey, rkey = prng.key(ACCEPT_KEY), jax.random.key(ACCEPT_KEY)
        tf, rf = Acceptance(tkey), RAcceptance(rkey)
        sup = dict(max_retries=4)
    tp0 = lambda: {"W": torch.zeros((16, 4))}
    rp0 = lambda: {"W": jnp.zeros((16, 4))}
    tfn = functools.partial(safl_round, tcfg, t_linear, plan=t_plan(tcfg.sketch, tp0()),
                            sentinel=sent_t)
    rfn = functools.partial(r_round, rcfg, r_linear, plan=r_plan(rcfg.sketch, rp0()),
                            sentinel=sent_r)
    return ((tfn, lambda: (tp0(), init_safl(tcfg, tp0())), tf, tkey),
            (rfn, lambda: (rp0(), r_init_safl(rcfg, rp0())), rf, rkey), sup)


def test_acceptance_nan_plus_forced_divergence(tmp_path):
    (tfn, fresh, faults, key), _, sup = scenario("acceptance")
    p, _, hist, log = run_supervised(
        launcher(tfn, faults), *fresh(), rounds=ROUNDS, key=key,
        config=SupervisorConfig(**sup), ckpt_path=str(tmp_path / "acc"))
    assert finite(p)
    assert len(hist["loss"]) == ROUNDS and np.isfinite(hist["loss"]).all()
    assert (hist["loss"] < 1e3).all()
    assert hist["n_rejected"].sum() == ROUNDS       # the NaN client each round
    assert [e["t_resume"] for e in log] == [6, 4]   # deepening rollback
    assert all("sentinel" in e["reason"] for e in log)
    assert os.path.exists(str(tmp_path / "acc") + ".npz")


@pytest.mark.parametrize("name", ["transient", "acceptance"])
def test_supervised_scenario_matches_reference(name, tmp_path):
    """Both packages' supervisors over the same scenario: the same
    rollbacks (the rekeyed keys are jax's bit for bit), the same recovery
    log, and parameters and losses at the stated tolerances."""
    (tfn, tfresh, tf, tkey), (rfn, rfresh, rf, rkey), sup = scenario(name)
    p, s, hist, log = run_supervised(
        launcher(tfn, tf), *tfresh(), rounds=ROUNDS, key=tkey,
        config=SupervisorConfig(**sup), ckpt_path=str(tmp_path / "t"))
    rp, rs, rhist, rlog = r_run_supervised(
        r_launcher(rfn, rf), *rfresh(), rounds=ROUNDS, key=rkey,
        config=RSupConfig(**sup))
    assert log == rlog
    assert len(log) == {"transient": 1, "acceptance": 2}[name]
    assert set(hist) == set(rhist)
    np.testing.assert_allclose(hist["loss"], rhist["loss"], rtol=1e-5, atol=1e-6)
    for k in hist:
        if k != "loss":
            np.testing.assert_array_equal(hist[k], rhist[k], err_msg=k)
    np.testing.assert_allclose(p["W"].numpy(), np.asarray(rp["W"]), **PARAM_TOL)
    assert int(s["step"]) == int(rs["step"])

    # the port's last supervised checkpoint restores in the reference
    like = {"params": rp, "opt": rs,
            "cursor": {"t": jnp.asarray(0), "key": jax.random.key_data(rkey)}}
    tree, step = r_restore(str(tmp_path / "t"), like)
    assert step == ROUNDS and int(tree["cursor"]["t"]) == ROUNDS
    rekeyed = jax.random.fold_in(rkey, 0x5AFE + len(log))
    np.testing.assert_array_equal(np.asarray(tree["cursor"]["key"]),
                                  np.asarray(jax.random.key_data(rekeyed)))
    np.testing.assert_array_equal(np.asarray(tree["params"]["W"]), p["W"].numpy())
    np.testing.assert_array_equal(np.asarray(tree["opt"]["step"]), s["step"].numpy())


def test_persistent_fault_log_matches_reference():
    """Rekeyed retries of a persistent fault re-fire in both packages: the
    same exhausted log."""
    (tfn, tfresh, _, _), (rfn, rfresh, _, _), _ = scenario("transient")
    kw = dict(nan_rate=0.9, start=4, stop=6, persistent=True)
    with pytest.raises(SupervisorError) as e:
        run_supervised(launcher(tfn, FaultConfig(num_clients=G, **kw)), *tfresh(),
                       rounds=ROUNDS, key=prng.key(0),
                       config=SupervisorConfig(max_retries=2))
    with pytest.raises(Exception) as re:
        r_run_supervised(r_launcher(rfn, RFaultConfig(num_clients=G, **kw)),
                         *rfresh(), rounds=ROUNDS, key=jax.random.key(0),
                         config=RSupConfig(max_retries=2))
    assert e.value.log == re.value.log
    assert str(e.value) == str(re.value)


def _reference_refusals() -> list[str]:
    """The messages of ``ap.error`` in examples/train_lm.py, in order."""
    with open(os.path.join(REPO, "examples", "train_lm.py")) as f:
        tree = ast.parse(f.read())
    return [ast.literal_eval(n.args[0]) for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "error"]


REFUSALS = [["--fedopt", "--async-buffer", "2"], ["--fedopt", "--faults", "0.1"],
            ["--fedopt", "--codec", "int8"], ["--codec", "1bit", "--telemetry"]]


@pytest.mark.parametrize("i", range(len(REFUSALS)))
def test_train_lm_refuses_the_reference_combinations(i, capsys):
    """Each refusal exits 2 with the reference's message, before any model
    is built."""
    want = _reference_refusals()
    assert len(want) == len(REFUSALS)
    with pytest.raises(SystemExit) as e:
        train_lm.main(REFUSALS[i] + ["--device", "cpu"])
    assert e.value.code == 2
    assert f"error: {want[i]}" in capsys.readouterr().err
