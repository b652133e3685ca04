"""Telemetry, metric shards, manifests and the report of the port
(``repro_torch.obs``, ``launch.driver``'s ``stream=``) against the
reference (``repro.obs``), on the CPU.

* Within the port, bit for bit (tests/test_obs.py's pins): telemetry off
  emits no probe key; ``stream=`` is host I/O only (parameters, state and
  the shard rows equal the unstreamed run's); streamed rows equal the
  in-memory history; a chunk-split run's rows equal a one-chunk run's.
* Each probe against the reference's ``telemetry_probes`` on the same
  inputs, each round from the reference's state (the linear task of
  tests/test_obs.py on a table of numpy batches, and the bench LM):
  ``cohort`` and ``clip_frac`` exactly, FedOPT's ``residual`` exactly 0
  in both, the norms at PROBE_TOL (rtol 1e-5: float32 sums in another
  order; the moment norms follow parameters that agree to ~1e-6).
* ``HISTORY_KEYS``, ``PROBE_KEYS``, ``REQUIRED_KEYS``, ``span_stats``,
  ``format_summary`` and the report's metric and span sections equal the
  reference's; ``tools/check_telemetry.py``, unchanged, accepts a run
  directory the port wrote (duplicate rounds across shards included) and
  rejects the reference test's corruptions of it.
* The host batches (``client_batch``/``round_batch``), ``opt_state_bytes``
  and ``count_params_analytic`` equal the reference's.
"""

import functools
import glob
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert_100m as rbert
from repro.core import baselines as rb
from repro.core.adaptive import AdaConfig as RAda
from repro.core.adaptive import opt_state_bytes as r_opt_state_bytes
from repro.core.clipped import ClippedSAFLConfig as RClip
from repro.core.clipped import clipped_safl_round as r_clipped
from repro.core.packed import make_packing_plan as r_plan
from repro.core.safl import SAFLConfig as RSAFL
from repro.core.safl import fedopt_round as r_fedopt
from repro.core.safl import init_safl as r_init_safl
from repro.core.safl import safl_round as r_round
from repro.core.sketch import SketchConfig as RSketch
from repro.data.synthetic import BigramLMData as RBigram
from repro.data.synthetic import ClsDataConfig as RClsCfg
from repro.data.synthetic import GaussianClsData as RCls
from repro.data.synthetic import LMDataConfig as RLMCfg
from repro.launch.driver import HISTORY_KEYS as R_HISTORY_KEYS
from repro.models import ModelConfig as RModel
from repro.models.model import count_params_analytic as r_count_params
from repro.obs import PROBE_KEYS as R_PROBE_KEYS
from repro.obs import REQUIRED_KEYS as R_REQUIRED_KEYS
from repro.obs import Telemetry as RTel
from repro.obs import format_summary as r_format_summary
from repro.obs import span_stats as r_span_stats
from repro.obs.report import render as r_render
from repro_torch import prng
from repro_torch.configs import bert_100m as tbert
from repro_torch.core import baselines as tb
from repro_torch.core.adaptive import AdaConfig as TAda
from repro_torch.core.adaptive import opt_state_bytes
from repro_torch.core.clipped import ClippedSAFLConfig as TClip
from repro_torch.core.clipped import clipped_safl_round
from repro_torch.core.packed import make_packing_plan as t_plan
from repro_torch.core.safl import SAFLConfig as TSAFL
from repro_torch.core.safl import fedopt_round, init_safl, safl_round
from repro_torch.core.sketch import SketchConfig as TSketch
from repro_torch.data.synthetic import BigramLMData as TBigram
from repro_torch.data.synthetic import ClsDataConfig as TClsCfg
from repro_torch.data.synthetic import GaussianClsData as TCls
from repro_torch.data.synthetic import LMDataConfig as TLMCfg
from repro_torch.fed import CodecConfig
from repro_torch.fed.faults import NAN, OK
from repro_torch.fed.faults import _spec_from_codes as t_spec_from_codes
from repro_torch.launch.driver import HISTORY_KEYS, run_scan
from repro_torch.launch.supervisor import SupervisorConfig, run_supervised
from repro_torch.models.config import ModelConfig as TModel
from repro_torch.models.model import count_params_analytic
from repro_torch.obs import (PROBE_KEYS, REQUIRED_KEYS, ShardWriter,
                             Telemetry, format_summary, span_stats,
                             write_manifest)
from repro_torch.obs.report import load_run, render
from test_torch_baselines import LINEAR, _both
from test_torch_safl import QUICK_KW

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import check_telemetry  # noqa: E402  (tools/ is not a package)

torch.set_num_threads(2)

TEL = Telemetry()
PROBE_TOL = dict(rtol=1e-5, atol=1e-7)

# ---------------------------------------------------------------------------
# the linear task (tests/test_fed.py's: y = x W, G = 4, K = 2, 4 samples a
# step), its batches a numpy table both packages index by round
# ---------------------------------------------------------------------------

G = 4
TABLE_ROUNDS = 8
_W_TRUE = np.random.RandomState(0).randn(16, 4).astype(np.float32)
_X = np.random.RandomState(11).randn(TABLE_ROUNDS, G, 2, 4, 16).astype(np.float32)
_Y = _X @ _W_TRUE


class PortLinear:
    """The port's driver sampler over the table: round t's batch."""

    def init_state(self, device="cpu"):
        return {"x": torch.from_numpy(_X).to(device),
                "y": torch.from_numpy(_Y).to(device)}

    def sample(self, state, t):
        return state, {"x": state["x"][t], "y": state["y"][t]}


class RefLinear:
    """The reference's scan sampler over the same table."""

    def init_state(self):
        return {"x": jnp.asarray(_X), "y": jnp.asarray(_Y)}

    def sample(self, state, t):
        return state, {"x": state["x"][t], "y": state["y"][t]}


def t_linear(p, b):
    return torch.mean((b["x"] @ p["W"] - b["y"]) ** 2)


def r_linear(p, b):
    return jnp.mean((b["x"] @ p["W"] - b["y"]) ** 2)


SK = dict(kind="countsketch", ratio=0.25, min_b=8)


def linear_cfgs(server="amsgrad", lr=0.05, **sketch):
    """(reference, port) SAFL configs of the linear task."""
    sk = {**SK, **sketch}
    common = dict(client_lr=0.05, local_steps=2)
    return (RSAFL(sketch=RSketch(**sk), server=RAda(name=server, lr=lr), **common),
            TSAFL(sketch=TSketch(**sk), server=TAda(name=server, lr=lr), **common))


def port_setup(telemetry=None, **sketch):
    """(round_fn, fresh) of the port's SAFL round on the linear task."""
    _, cfg = linear_cfgs(**sketch)
    p0 = lambda: {"W": torch.zeros((16, 4))}
    round_fn = functools.partial(safl_round, cfg, t_linear,
                                 plan=t_plan(cfg.sketch, p0()), telemetry=telemetry)
    return round_fn, lambda: (p0(), init_safl(cfg, p0()))


def run_port(round_fn, fresh, *, rounds=4, chunk_size=0, key=0, **kw):
    return run_scan(round_fn, PortLinear(), *fresh(), rounds=rounds,
                    key=prng.key(key), chunk_size=chunk_size, **kw)


def to_port(tree):
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_same(a[k], b[k])
    else:
        assert torch.equal(a, b)


def rows_of(run_dir):
    rows = []
    for path in sorted(glob.glob(os.path.join(run_dir, "metrics-*.jsonl"))):
        with open(path) as f:
            rows += [json.loads(ln) for ln in f if ln.strip()]
    return rows


def events_of(run_dir, kind=None):
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        evs = [json.loads(ln) for ln in f if ln.strip()]
    return [e for e in evs if kind is None or e["kind"] == kind]


# ---------------------------------------------------------------------------
# within the port: telemetry off, and stream= as host I/O only
# ---------------------------------------------------------------------------


def test_stream_is_host_side_io_only(tmp_path):
    round_fn, fresh = port_setup()
    pA, sA, hA = run_port(round_fn, fresh, chunk_size=2, bits_per_round=64)
    stream = ShardWriter(str(tmp_path / "run"))
    pB, sB, hB = run_port(round_fn, fresh, chunk_size=2, bits_per_round=64,
                          stream=stream)
    assert_same(pA, pB)
    assert_same(sA, sB)
    assert hB == {}                       # the shards are the record
    rows = rows_of(str(tmp_path / "run"))
    assert [r["t"] for r in rows] == list(range(4))
    np.testing.assert_array_equal([r["loss"] for r in rows], hA["loss"])
    np.testing.assert_array_equal([r["uplink_bits"] for r in rows],
                                  hA["uplink_bits"])


def test_streamed_rows_match_in_memory_history(tmp_path):
    round_fn, fresh = port_setup(TEL)
    pA, _, hA = run_port(round_fn, fresh, chunk_size=2)
    seen = []
    stream = ShardWriter(str(tmp_path / "run"))
    pB, _, hB = run_port(round_fn, fresh, chunk_size=2, stream=stream,
                         on_chunk=lambda t, p, s, h: seen.append(h))
    assert_same(pA, pB)
    assert hB == {} and len(seen) == 2
    rows = rows_of(str(tmp_path / "run"))
    assert len(rows) == 4
    for i, row in enumerate(rows):
        assert row["kind"] == "metrics" and row["t"] == i
        assert set(row) - {"kind", "t"} == set(hA)
        for k in hA:
            assert row[k] == float(hA[k][i])
            assert seen[i // 2][k][i % 2] == hA[k][i]


def test_chunk_split_shard_invariance(tmp_path):
    round_fn, fresh = port_setup(TEL)
    s1 = ShardWriter(str(tmp_path / "one"))
    p1, _, _ = run_port(round_fn, fresh, stream=s1)
    s2 = ShardWriter(str(tmp_path / "split"))
    p2, _, _ = run_port(round_fn, fresh, chunk_size=2, stream=s2)
    assert_same(p1, p2)
    assert s1._shard == 1 and s2._shard == 2
    assert rows_of(str(tmp_path / "one")) == rows_of(str(tmp_path / "split"))
    spans = events_of(str(tmp_path / "split"), "span")
    assert [s["compile"] for s in spans] == [True, False]
    assert [(s["t0"], s["t1"]) for s in spans] == [(0, 2), (2, 4)]


# ---------------------------------------------------------------------------
# each probe against the reference's, round by round from its state
# ---------------------------------------------------------------------------

def _linear_cases():
    def safl(**sketch):
        def make():
            rcfg, tcfg = linear_cfgs(**sketch)
            rp = {"W": jnp.zeros((16, 4))}
            return (functools.partial(r_round, rcfg, r_linear, plan=r_plan(rcfg.sketch, rp)),
                    functools.partial(safl_round, tcfg, t_linear,
                                      plan=t_plan(tcfg.sketch, to_port(rp))),
                    rp, r_init_safl(rcfg, rp))
        return make

    def fedopt():
        rcfg, tcfg = linear_cfgs()
        rp = {"W": jnp.zeros((16, 4))}
        return (functools.partial(r_fedopt, rcfg, r_linear),
                functools.partial(fedopt_round, tcfg, t_linear), rp,
                r_init_safl(rcfg, rp))

    def sacfl(tau):
        def make():
            rcfg, tcfg = linear_cfgs()
            rp = {"W": jnp.zeros((16, 4))}
            return (functools.partial(r_clipped, RClip(base=rcfg, clip_tau=tau), r_linear,
                                      plan=r_plan(rcfg.sketch, rp)),
                    functools.partial(clipped_safl_round, TClip(base=tcfg, clip_tau=tau),
                                      t_linear, plan=t_plan(tcfg.sketch, to_port(rp))),
                    rp, r_init_safl(rcfg, rp))
        return make

    def baseline(name):
        def make():
            rcfg, tcfg = _both(name=name, **LINEAR[name])
            rp = {"W": jnp.asarray(np.random.RandomState(9).randn(16, 4)
                                   .astype(np.float32) * 0.1)}
            return (functools.partial(rb.baseline_round, rcfg, r_linear,
                                      plan=r_plan(rcfg.sketch, rp)),
                    functools.partial(tb.baseline_round, tcfg, t_linear,
                                      plan=t_plan(tcfg.sketch, to_port(rp))),
                    rp, rb.init_baseline_state(rcfg, rp, G))
        return make

    return {"safl_countsketch": safl(), "safl_srht": safl(kind="srht"),
            "fedopt": fedopt, "sacfl_tau_1e-6": sacfl(1e-6),
            "sacfl_tau_1e6": sacfl(1e6), "topk_ef": baseline("topk_ef"),
            "fetchsgd": baseline("fetchsgd")}


LINEAR_CASES = _linear_cases()
BASELINE_CASES = ("topk_ef", "fetchsgd")


def compare_probes(got: dict, want: dict, what: str) -> None:
    """The port's metrics against the reference's: the same keys, the
    counts and fractions exactly, the norms at PROBE_TOL."""
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k in want:
        g, w = float(got[k]), float(np.asarray(want[k]))
        if k in PROBE_KEYS:
            assert got[k].dtype == torch.float32, (what, k)
        if k in ("cohort", "clip_frac", "n_rejected", "n_dropped"):
            assert g == w, (what, k, g, w)
        else:
            np.testing.assert_allclose(g, w, err_msg=f"{what} {k}", **PROBE_TOL)


def run_from_reference(rfn, tfn, rparams, rstate, rounds, rkw=None, tkw=None):
    """Each of ``rounds`` rounds of the port from the reference's state on
    the table's batch and the key ``100 + t``; returns the per-round
    (port, reference) metrics."""
    rj = jax.jit(functools.partial(rfn, telemetry=RTel()))
    out = []
    for t in range(rounds):
        _, _, tm = tfn(to_port(rparams), to_port(rstate),
                       {"x": torch.from_numpy(_X[t]), "y": torch.from_numpy(_Y[t])},
                       prng.key(100 + t), telemetry=TEL, **(tkw or {}))
        rparams, rstate, rm = rj(rparams, rstate, {"x": _X[t], "y": _Y[t]},
                                 jax.random.key(100 + t), **(rkw or {}))
        out.append((tm, rm))
    return out


MASKS = {"none": None, "mask": np.array([1, 0, 1, 1], np.float32),
         "weighted": {"w": np.array([0.5, 2.0, 0.0, 1.5], np.float32),
                      "den": 4.0, "n": 3}}


@pytest.mark.parametrize("which", ["safl", "sacfl", "fedopt"])
def test_telemetry_refuses_the_streamed_fold_and_the_codec(which):
    """The reference's refusals: the streamed fold never builds the delta
    stack the probes read, and the codec wraps the state they read."""
    _, tcfg = linear_cfgs()
    p = {"W": torch.zeros((16, 4))}
    fn = {"safl": functools.partial(safl_round, tcfg, t_linear),
          "sacfl": functools.partial(clipped_safl_round, TClip(base=tcfg), t_linear),
          "fedopt": functools.partial(fedopt_round, tcfg, t_linear)}[which]
    batch = {"x": torch.from_numpy(_X[0]), "y": torch.from_numpy(_Y[0])}
    with pytest.raises(ValueError, match="microbatch"):
        fn(p, init_safl(tcfg, p), batch, prng.key(0), telemetry=TEL, microbatch=2)
    with pytest.raises(ValueError, match="codec"):
        fn(p, init_safl(tcfg, p), batch, prng.key(0), telemetry=TEL,
           codec=CodecConfig(bits=8, error_feedback=False))
    # a microbatch covering the cohort is the materialized round
    _, _, m = fn(p, init_safl(tcfg, p), batch, prng.key(0), telemetry=TEL,
                 microbatch=G)
    assert "delta_norm" in m


# ---------------------------------------------------------------------------
# key sets, run directories, the schema tool and the report
# ---------------------------------------------------------------------------

def test_key_sets_equal_the_reference():
    assert HISTORY_KEYS == R_HISTORY_KEYS
    assert PROBE_KEYS == R_PROBE_KEYS
    assert REQUIRED_KEYS == R_REQUIRED_KEYS


class TransientFaults:
    """The port's twin of tests/test_faults.py::_TransientFaults: the
    scripted ``codes_row`` fires in rounds [lo, hi) only under the run's
    original key, so any rekeyed retry is clean."""

    def __init__(self, key0, codes_row, rounds=(4, 6), scale=1e3):
        self.key0, self.codes_row = key0, codes_row
        self.lo, self.hi = rounds
        self.scale = scale

    def spec(self, t, base_key, device):
        hit = base_key == self.key0 and self.lo <= t < self.hi
        codes = self.codes_row if hit else (OK,) * len(self.codes_row)
        return t_spec_from_codes(torch.tensor(codes, dtype=torch.int32,
                                              device=device), self.scale)


def supervised_run_dir(run_dir: str, telemetry=TEL):
    """A supervised, streamed 8-round run with one transient NaN fault
    (rounds 4 and 5 under the original key) and a manifest."""
    round_fn, fresh = port_setup(telemetry)
    key = prng.key(0)
    faults = TransientFaults(key, (OK, NAN, OK, OK))
    stream = ShardWriter(run_dir)
    write_manifest(run_dir, run="test", sketch=TSketch(**SK), guard_pins=None)

    def launch(p, s, *, key, start_round, on_chunk):
        return run_scan(round_fn, PortLinear(), p, s, rounds=8, key=key,
                        chunk_size=2, start_round=start_round,
                        on_chunk=on_chunk, faults=faults, stream=stream)

    out = run_supervised(launch, *fresh(), rounds=8, key=key,
                         config=SupervisorConfig(max_retries=3), stream=stream)
    return out, stream


def test_supervised_run_dir_passes_check_telemetry(tmp_path):
    """The rollback lands in the event log as a recovery event, the retried
    span re-emits its rounds in new shards (duplicate t, last-wins), and
    tools/check_telemetry.py accepts the directory as it is."""
    run_dir = str(tmp_path / "sup")
    (_, _, hist, log), stream = supervised_run_dir(run_dir)
    assert hist == {} and len(log) == 1
    recs = events_of(run_dir, "recovery")
    assert len(recs) == 1
    for field in check_telemetry.RECOVERY_FIELDS + ("rekey",):
        assert field in recs[0], field
    assert recs[0]["retry"] == 1 and recs[0]["t_resume"] == 4
    assert recs[0]["depth"] == recs[0]["t_fault"] - recs[0]["t_resume"] >= 0
    ts = [r["t"] for r in rows_of(run_dir)]
    assert len(ts) > 8 and sorted(set(ts)) == list(range(8))
    assert check_telemetry.check(run_dir, rounds=8) == []
    assert check_telemetry.main([run_dir, "--rounds", "8"]) == 0
    assert stream.summary()["recoveries"] == 1


def test_check_telemetry_rejects_corruptions_of_a_port_run(tmp_path):
    """tests/test_obs.py's corruptions, made to a run directory the port
    wrote: the tool finds each."""
    good = str(tmp_path / "good")
    round_fn, fresh = port_setup(TEL)
    write_manifest(good, run="test", guard_pins=None)
    run_port(round_fn, fresh, chunk_size=2, stream=ShardWriter(good))
    assert check_telemetry.check(good, rounds=4) == []
    bad = str(tmp_path / "bad")
    shutil.copytree(good, bad)
    os.remove(os.path.join(bad, "manifest.json"))
    path = os.path.join(bad, "metrics-00000.jsonl")
    rows = rows_of(bad)[:2]
    rows[1] = {**rows[1], "t": 2, "bogus_key": 3.0}
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    os.remove(os.path.join(bad, "metrics-00001.jsonl"))
    with open(os.path.join(bad, "events.jsonl"), "a") as f:
        f.write(json.dumps({"kind": "span", "t0": 0}) + "\n")
        f.write(json.dumps({"kind": "mystery"}) + "\n")
    text = "\n".join(check_telemetry.check(bad, rounds=4))
    for msg in ("manifest.json missing", "not consecutive", "bogus_key",
                "missing 't1'", "unknown kind",
                "distinct metric rounds 2 != expected 4"):
        assert msg in text, msg
    assert check_telemetry.main([bad]) == 1


def test_manifest_schema(tmp_path):
    path = write_manifest(str(tmp_path / "m"), run="unit", sketch=TSketch(**SK),
                          config={"rounds": 4}, topology="single-host",
                          guard_pins=None)
    with open(path) as f:
        man = json.load(f)
    for k in REQUIRED_KEYS:
        assert k in man, k
    assert man["jax"] == man["jaxlib"] == ""
    assert man["torch"] == torch.__version__
    assert man["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert man["device_count"] == torch.cuda.device_count()
    assert "cuda" in man and "device_name" in man
    assert man["sketch"]["kind"] == "countsketch"
    assert man["config"]["rounds"] == 4
    assert man["topology"] == "single-host"


def test_guard_pins_are_embedded(tmp_path):
    pins = tmp_path / "bench.json"
    pins.write_text(json.dumps({"fig1/safl.final_loss": 1.5, "fig1/safl.us": 3}))
    with open(write_manifest(str(tmp_path / "m"), run="unit",
                             guard_pins=str(pins))) as f:
        assert json.load(f)["guard_pins"] == {"fig1/safl.final_loss": 1.5}


def test_shard_writer_summary_and_span_stats_match_reference(tmp_path):
    w = ShardWriter(str(tmp_path / "w"))
    w.write_chunk(0, {"loss": np.asarray([4.0, 2.0]),
                      "residual": np.asarray([0.5, 0.3]),
                      "n_rejected": np.asarray([1.0, 0.0])})
    w.write_chunk(2, {"loss": np.asarray([1.0]), "residual": np.asarray([0.1]),
                      "n_rejected": np.asarray([2.0])})
    w.write_event("recovery", retry=1)
    s = w.summary()
    assert s == {"rounds": 3, "shards": 2, "final_loss": 1.0,
                 "mean_residual": pytest.approx(0.3), "total_rejected": 3.0,
                 "recoveries": 1}
    assert format_summary(s) == r_format_summary(s)
    empty = ShardWriter(str(tmp_path / "e")).summary()
    assert format_summary(empty) == r_format_summary(empty)
    for xs in ([], [1e-3, 2e-3, 3e-3], [5e-4] * 7 + [9e-3]):
        assert span_stats(xs) == r_span_stats(xs)


def test_render_matches_the_reference_sections(tmp_path):
    """``render(profile=False)``: the manifest section names the port's
    stack; the metric and span sections (recovery included) are the
    reference's, line for line, on the same directory."""
    run_dir = str(tmp_path / "sup")
    supervised_run_dir(run_dir)
    got, want = render(run_dir, profile=False), r_render(run_dir, profile=False)
    assert f"torch={torch.__version__}" in got and "backend=cpu" in got
    assert got.split("-- metrics --")[1] == want.split("-- metrics --")[1]
    assert "recovery: retry 1 fault<6 resume@4 depth=2" in got
    run = load_run(run_dir)
    assert run["manifest"]["run"] == "test" and len(run["events"]) >= 5
    assert render(str(tmp_path / "nothing"), profile=False).count("(no ") == 3


# ---------------------------------------------------------------------------
# host batches and the size functions
# ---------------------------------------------------------------------------

def test_lm_host_batches_bitwise():
    cfg = dict(vocab_size=64, seq_len=12, num_clients=3, heterogeneity=0.3,
               alpha=0.05)
    ref, port = RBigram(RLMCfg(**cfg)), TBigram(TLMCfg(**cfg))
    for seed in (0, 7):
        want = np.asarray(ref.round_batch(4, 2, seed=seed)["tokens"])
        got = port.round_batch(4, 2, seed=seed, device="cpu")["tokens"]
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            port.client_batch(1, 5, seed, device="cpu")["tokens"].numpy(),
            np.asarray(ref.client_batch(1, 5, seed)["tokens"]))


def test_cls_host_batches_bitwise():
    cfg = dict(num_features=6, num_classes=4, num_clients=3, dirichlet_alpha=0.5)
    ref, port = RCls(RClsCfg(**cfg)), TCls(TClsCfg(**cfg))
    for seed in (0, 5):
        want = ref.round_batch(4, 2, seed=seed)
        got = port.round_batch(4, 2, seed=seed, device="cpu")
        np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
        np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))
        one = port.client_batch(2, 3, seed, device="cpu")
        np.testing.assert_array_equal(one["x"].numpy(),
                                      np.asarray(ref.client_batch(2, 3, seed)["x"]))


@pytest.mark.parametrize("server", ["sgd", "sgdm", "adagrad", "adam", "amsgrad"])
def test_opt_state_bytes_matches_reference(server):
    shapes = {"a": (3, 4), "b": (7,)}
    r = r_opt_state_bytes(RAda(name=server), {k: jnp.zeros(s) for k, s in shapes.items()})
    t = opt_state_bytes(TAda(name=server), {k: torch.zeros(s) for k, s in shapes.items()})
    assert t == r


@pytest.mark.parametrize("which", ["quick", "bert_100m", "bert_100m_smoke"])
def test_count_params_analytic_matches_reference(which):
    cfg = {"quick": (RModel(**QUICK_KW), TModel(**QUICK_KW)),
           "bert_100m": (rbert.CONFIG, tbert.CONFIG),
           "bert_100m_smoke": (rbert.SMOKE, tbert.SMOKE)}[which]
    for active in (False, True):
        assert count_params_analytic(cfg[1], active) == r_count_params(cfg[0], active)
