"""The port's mesh hooks on four ranks against the reference's mesh.

The reference runs ``run_mesh_scan`` with each hook on four forced CPU
devices (``--xla_force_host_platform_device_count=4``) in two concurrent
subprocesses (``REF_GROUPS``); the port runs the same cases in ONE
``launch.mesh.spawn`` of four gloo ranks on the CPU at the same time:
three rounds a case of tests/test_torch_mesh_round.py's one-layer model
(bert_100m SMOKE compiles ~15-25 s a case in the reference, this one
~5 s; chip_smoke 13c runs every hook at bert_100m SMOKE on the card), from
the same weights and keys:

* the streamed fold (``microbatch=1``) and the int8 payload codec (no error
  feedback) on ``cross_silo`` (pod 2, data 2, model 1) with G = 4, two
  clients a pod, so a pod's fold takes two chunks and its two FSDP shards
  encode their own slices of one partial sum;
* the guard (a ``FaultTable`` with drops, a NaN and an empty cohort; the
  norm sentinel at ``norm_mult=3``), the staleness ring (``stagger``,
  ``max_delay=2``), the ring with the guard (``uniform``, a Byzantine
  client), and telemetry, on (data 2, model 2) in ``cross_device`` with
  G = 2, and telemetry in ``cross_device_dp``.

The reference's ``cross_device`` client step takes one client a client
shard (the first of a shard's rows), and its guard and ring size their
(G,) vectors by the client shards, so those cases run at G_loc = 1;
``tests/test_torch_mesh_hook_pins.py`` runs the port at G_loc = 2.  The
reference aborts on a (2, 1, 2) ``cross_silo`` mesh (ROADMAP §C).

Counters (``n_dropped``, ``n_rejected``, ``diverged``), ``uplink_bits`` and
the tokens are exact; losses within atol 2e-3 and parameters within atol
2e-3 / rtol 1e-3, as in tests/test_torch_mesh_round.py (the reference's
client step runs under GSPMD in another summation order and AMSGrad's
normalized step amplifies ulp-level gaps in near-zero sketch slots);
``arrival_weight`` and the probes within rtol ``PROBE_RTOL``.

This module imports no jax at its top: the ranks import it by name, and
the reference's half imports jax inside its subprocesses only.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.checkpoint.io import params_to_numpy
from repro_torch.core.adaptive import AdaConfig
from repro_torch.core.safl import SAFLConfig, init_safl
from repro_torch.core.sketch import SketchConfig
from repro_torch.data.synthetic import BigramLMData, LMDataConfig
from repro_torch.fed import (BYZANTINE, DROP, NAN, OK, AsyncConfig,
                             CodecConfig, arrival_weight)
from repro_torch.launch import train as T
from repro_torch.launch.mesh import Mesh, make_mesh, spawn
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.models.sharding import gather_tree, local_shard
from repro_torch.obs.telemetry import Telemetry

from torch_priority import lower_priority  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODEL_KW = dict(name="meshscan", arch_type="dense", num_layers=1, d_model=32,
                num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64)
MODEL = ModelConfig(**MODEL_KW)
ROUNDS, KEY = 3, 42
GRID = ((2, 2), ("data", "model"))
SILO = ((2, 2, 1), ("pod", "data", "model"))
# the guard's script: round 0 drops client 0, round 1 poisons client 1,
# round 2 leaves no client (a NaN and a drop): the server carries through
GUARD_CODES = ((DROP, OK), (OK, NAN), (NAN, DROP))
# the ring's guard: a Byzantine payload (x1e3) the norm sentinel rejects
RING_CODES = ((OK, BYZANTINE), (NAN, OK), (OK, DROP))
NORM_MULT = 3.0
# (name, mesh, topology, G, hooks); the hooks are named, built per package
CASES = (("microbatch", SILO, "cross_silo", 4, ("microbatch",)),
         ("codec", SILO, "cross_silo", 4, ("codec",)),
         ("guard", GRID, "cross_device", 2, ("guard",)),
         ("buffer", GRID, "cross_device", 2, ("stagger",)),
         ("buffer_guard", GRID, "cross_device", 2, ("uniform", "ring_guard")),
         ("telemetry", GRID, "cross_device", 2, ("telemetry",)),
         ("telemetry_dp", GRID, "cross_device_dp", 2, ("telemetry",)))
# the reference's cases split over its two subprocesses (compile-bound)
REF_GROUPS = (("microbatch", "codec", "guard", "telemetry_dp"),
              ("buffer", "buffer_guard", "telemetry"))
# cases whose rounds after the first are held one at a time, the port's
# and the reference's each from the reference's params and AMSGrad state
# after the round before (test_mesh_codec_rounds_from_reference_state).
# The codec's rounding turns float noise into whole levels, and the
# reference's own trajectory moves with its program's input layout: its
# scanned run and the same rounds from states round-tripped through the
# host differ by ~1e-3 relative in round 2's partial sums and ~70 levels.
# So the reference runs these cases as one jitted step a round from the
# host's state, and the port's params are held round by round from it
STEPWISE = ("codec",)
COUNTERS = ("n_dropped", "n_rejected", "diverged", "uplink_bits")
PROBES = ("delta_norm", "update_norm", "residual", "m_norm", "v_norm",
          "vhat_norm", "cohort")
TOL = dict(rtol=1e-3, atol=2e-3)
LOSS_TOL = dict(rtol=0.0, atol=2e-3)
PROBE_RTOL = 1e-3


def _cfg(SAFL, Sketch, Ada):
    # remat changes no value; off, the reference compiles faster
    return SAFL(sketch=Sketch(kind="countsketch", ratio=0.05, min_b=16),
                server=Ada(name="amsgrad", lr=0.01), client_lr=0.5,
                local_steps=2, remat_local=False)


def _hooks(names, fed, Telemetry_):
    """The keyword arguments of a case's hooks, from one package's
    ``fed`` module and ``Telemetry`` class."""
    kw = {}
    for name in names:
        if name == "microbatch":
            kw["microbatch"] = 1
        elif name == "codec":
            kw["codec"] = fed.CodecConfig(bits=8, error_feedback=False)
        elif name in ("guard", "ring_guard"):
            codes = GUARD_CODES if name == "guard" else RING_CODES
            kw["faults"] = fed.FaultTable(codes=codes)
            kw["sentinel"] = fed.SentinelConfig(norm_mult=NORM_MULT)
        elif name in ("stagger", "uniform"):
            kw["buffer"] = fed.AsyncConfig(max_delay=2, delay=name,
                                           staleness_alpha=0.5)
        elif name == "telemetry":
            kw["telemetry"] = Telemetry_()
    return kw


def _data(G: int) -> LMDataConfig:
    return LMDataConfig(vocab_size=MODEL.vocab_size, seq_len=16, num_clients=G,
                        alpha=0.05)


def _weights() -> dict:
    return params_to_numpy(init_params(MODEL, torch.Generator().manual_seed(0),
                                       "cpu"))


# ---------------------------------------------------------------------------
# the reference, in its own process on four forced CPU devices
# ---------------------------------------------------------------------------

def _nest(flat: dict, wrap) -> dict:
    """A nested dict from "/"-joined paths, each leaf through ``wrap``."""
    out = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = wrap(leaf)
    return out


def _reference_main(weights_path: str, out_path: str, names) -> None:
    import jax
    import jax.numpy as jnp
    from repro import fed as rfed
    from repro.core.adaptive import AdaConfig as RAda
    from repro.core.safl import SAFLConfig as RSAFL
    from repro.core.safl import init_safl as r_init_safl
    from repro.core.sketch import SketchConfig as RSketch
    from repro.data import BigramLMData as RData
    from repro.data import LMDataConfig as RDataCfg
    from repro.launch.mesh import _mesh
    from repro.models import ModelConfig as RModel
    from repro.launch.train import (init_mesh_async_state,
                                    make_safl_train_step, mesh_sampler,
                                    run_mesh_scan)
    from repro.models.sharding import use_mesh
    from repro.obs import Telemetry as RTelemetry

    def flat(kind, tree):
        return {f"{kind}{'/'.join(str(getattr(k, 'key', k)) for k in path)}":
                np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

    assert jax.device_count() == 4, jax.devices()
    weights = _nest(dict(np.load(weights_path)), jnp.asarray)
    cfg = _cfg(RSAFL, RSketch, RAda)
    rmodel = RModel(**MODEL_KW)
    key = jax.random.key(KEY)
    out = {}
    for name, (shape, axes), topology, G, hooks in CASES:
        if name not in names:
            continue
        mesh = _mesh(shape, axes)
        d = _data(G)
        base = RData(RDataCfg(vocab_size=d.vocab_size, seq_len=d.seq_len,
                              num_clients=G, alpha=d.alpha)).device_sampler(8, 2)
        smp = mesh_sampler(mesh, base, topology)
        kw = _hooks(hooks, rfed, RTelemetry)
        hists = []
        with use_mesh(mesh):
            if name in STEPWISE:
                # one jitted step a round, each round's inputs the state
                # after the round before as the host holds it (one program)
                step = jax.jit(make_safl_train_step(rmodel, cfg, mesh,
                                                    topology, **kw)[0])
                host = {**flat("p/", weights), **flat("o/", r_init_safl(cfg, weights))}
                dstate = smp.init_state()
                for t in range(ROUNDS):
                    dstate, batch = smp.sample(dstate, jnp.int32(t))
                    tree = _nest(host, jnp.asarray)
                    params, opt, m = step(tree["p"], tree["o"], batch,
                                          jax.random.key_data(jax.random.fold_in(key, t)))
                    host = {**flat("p/", params), **flat("o/", opt)}
                    hists.append(m)
                    for k, v in host.items():
                        out[f"{name}/{k[0]}{t}/{k[2:]}"] = v
            else:
                state = (init_mesh_async_state(rmodel, cfg, kw["buffer"],
                                               mesh, weights, topology)
                         if "buffer" in kw else r_init_safl(cfg, weights))

                params, _, hist = run_mesh_scan(
                    rmodel, cfg, mesh, smp, weights, state, rounds=ROUNDS,
                    key=key, topology=topology, donate=False, **kw)
                hists.append(hist)
                for k, v in flat("", params).items():
                    out[f"{name}/p{ROUNDS - 1}/{k}"] = v
        for k in hists[0]:
            out[f"{name}/h/{k}"] = np.concatenate(
                [np.asarray(h[k]).reshape(-1) for h in hists])
        for t in range(ROUNDS):
            out[f"{name}/tokens/{t}"] = np.asarray(base.round_batch(t)["tokens"])
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port, one function a rank
# ---------------------------------------------------------------------------

class _Recording:
    """A sampler that keeps the batches it hands out."""

    def __init__(self, sampler):
        self.sampler, self.tokens = sampler, []
        self.num_clients = sampler.num_clients

    def init_state(self, device):
        return self.sampler.init_state(device)

    def sample(self, state, t):
        state, batch = self.sampler.sample(state, t)
        self.tokens.append(batch["tokens"])
        return state, batch


def _port_ranks(mesh, weights):
    os.nice(10)
    from repro_torch import fed
    meshes = {GRID[1]: mesh, SILO[1]: make_mesh(*SILO, device="cpu")}
    cfg = _cfg(SAFLConfig, SketchConfig, AdaConfig)
    key = prng.key(KEY)
    out = {}
    for name, (_, axes), topology, G, hooks in CASES:
        m = meshes[axes]
        _, pspecs = T._mesh_pspecs(MODEL, topology)
        params = local_shard(m, {k: torch.as_tensor(v) for k, v in weights.items()},
                             pspecs)
        kw = _hooks(hooks, fed, Telemetry)
        state = (T.init_mesh_async_state(MODEL, cfg, kw["buffer"], m, params,
                                         topology, num_clients=G)
                 if "buffer" in kw else init_safl(cfg, params))
        rec = _Recording(T.mesh_sampler(m, BigramLMData(_data(G)).device_sampler(8, 2),
                                        topology))
        params, _, hist = T.run_mesh_scan(MODEL, cfg, m, rec, params, state,
                                          rounds=ROUNDS, key=key,
                                          topology=topology, **kw)
        full = gather_tree(m, params, pspecs)
        local = torch.stack(rec.tokens)                 # (R, G_loc, K, mb, S)
        group = m.group(T.client_axes_of(m, topology))
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, local, group=group)
        out[name] = {"h": hist, "p": {k: v.numpy() for k, v in full.items()},
                     "tokens": torch.cat(parts, dim=1).numpy()}
    return out


def _port_stepwise(mesh, ref, weights):
    """Every round of each ``STEPWISE`` case, each one round from the
    reference's params and AMSGrad state after the round before (round 0
    from ``weights``); returns each round's gathered params."""
    os.nice(10)
    from repro_torch import fed
    meshes = {GRID[1]: mesh, SILO[1]: make_mesh(*SILO, device="cpu")}
    cfg = _cfg(SAFLConfig, SketchConfig, AdaConfig)
    out = {}
    for name, (_, axes), topology, G, hooks in CASES:
        if name not in STEPWISE:
            continue
        m = meshes[axes]
        _, pspecs = T._mesh_pspecs(MODEL, topology)
        smp = T.mesh_sampler(m, BigramLMData(_data(G)).device_sampler(8, 2),
                             topology)
        for t in range(ROUNDS):
            if t == 0:
                params = local_shard(m, {k: torch.as_tensor(v)
                                         for k, v in weights.items()}, pspecs)
                state = init_safl(cfg, params)
            else:
                tree = {kind: {k[len(f"{name}/{kind}{t - 1}/"):]: torch.as_tensor(v)
                               for k, v in ref.items()
                               if k.startswith(f"{name}/{kind}{t - 1}/")}
                        for kind in ("p", "o")}
                params = local_shard(m, tree["p"], pspecs)
                state = {"step": tree["o"]["step"]}
                for mom in ("m", "v", "vhat"):
                    state[mom] = local_shard(
                        m, {k[len(mom) + 1:]: v for k, v in tree["o"].items()
                            if k.startswith(mom + "/")}, pspecs)
            params, _, _ = T.run_mesh_scan(
                MODEL, cfg, m, smp, params, state,
                rounds=t + 1, key=prng.key(KEY), topology=topology,
                start_round=t, **_hooks(hooks, fed, Telemetry))
            out[f"{name}/{t}"] = {k: v.numpy() for k, v in
                                  gather_tree(m, params, pspecs).items()}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_hooks")
    weights = _weights()
    np.savez(tmp / "weights.npz", **weights)
    # the reference's LLVM passes at their lowest level compile its scans
    # faster; the values move far inside the tolerance
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
        " --xla_backend_optimization_level=0"
        " --xla_llvm_disable_expensive_passes=true").strip())
    paths = [str(ROOT / "src"), str(ROOT / "tests")]
    # at a lower priority: they share the machine with the suite's other
    # workers, whose longest file sets the suite's wall time
    procs = []
    for i, names in enumerate(REF_GROUPS):
        code = ("import os, sys; os.nice(10); "
                f"sys.path[:0] = {paths!r}; "
                "import test_torch_mesh_hooks as m; "
                f"m._reference_main({str(tmp / 'weights.npz')!r}, "
                f"{str(tmp / f'ref{i}.npz')!r}, {names!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        port = spawn(_port_ranks, *GRID, weights, device="cpu", timeout=300)
    finally:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    ref = {}
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log
        with np.load(tmp / f"ref{i}.npz") as z:
            ref.update(z)
    port["stepwise"] = spawn(
        _port_stepwise, *GRID,
        {k: v for k, v in ref.items() if k.split("/")[0] in STEPWISE
         and k.split("/")[1][0] in "po"}, weights,
        device="cpu", timeout=300)
    return ref, port


def _ref_hist(ref, case):
    pre = f"{case}/h/"
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_mesh_hooks_match_reference(results, case):
    """Losses and parameters within the stated tolerance; the counters,
    ``uplink_bits``, ``arrival_weight`` and the probes as the module
    docstring states; every key of the reference's history present (the
    port's buffered rounds also report ``arrival_weight`` unguarded)."""
    ref, port = results
    got, want = port[case]["h"], _ref_hist(ref, case)
    assert set(want) <= set(got), (sorted(want), sorted(got))
    np.testing.assert_allclose(got["loss"], want["loss"], **LOSS_TOL)
    assert np.isfinite(got["loss"]).all()
    for k in COUNTERS:
        if k in want:
            np.testing.assert_array_equal(np.asarray(got[k], np.float64),
                                          np.asarray(want[k], np.float64), err_msg=k)
    for k in PROBES + ("arrival_weight",):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=PROBE_RTOL, err_msg=k)
    # the last round's params; a STEPWISE case's rounds after the first are
    # held from the reference's state in the test below
    if case in STEPWISE:
        return
    pre = f"{case}/p{ROUNDS - 1}/"
    params = port[case]["p"]
    assert sorted(params) == sorted(k[len(pre):] for k in ref if k.startswith(pre))
    for k, v in params.items():
        np.testing.assert_allclose(v, ref[pre + k], **TOL, err_msg=k)


def test_mesh_codec_rounds_from_reference_state(results):
    """The codec's rounds, each one round from the reference's params and
    AMSGrad state (round 0 from the shared weights), against the
    reference's same round from the same state.  A coordinate outside the
    tolerance comes from a rounding level that flipped between the packages
    (``floor(S / s + u)`` with S a float sum in another order), which moves
    the ~d/b coordinates hashed to its slot; the flips, counted as those
    coordinates over d/b of a rank's shard-local plan, stay below one in a
    thousand of b_total a round."""
    ref, port = results
    plan = T._mesh_plan(MODEL, _cfg(SAFLConfig, SketchConfig, AdaConfig),
                        Mesh(*SILO), "cross_silo")[2]
    for t in range(ROUNDS):
        got = port["stepwise"][f"codec/{t}"]
        outside = sum(int((~np.isclose(v, ref[f"codec/p{t}/{k}"], **TOL)).sum())
                      for k, v in got.items())
        flips = outside * plan.b_total / plan.d_total
        print(f"codec round {t}: {outside} coordinates outside the "
              f"tolerance, ~{flips:.1f} level flips of b_total {plan.b_total}")
        assert flips <= plan.b_total / 1000, (t, outside, flips)


def test_mesh_hook_tokens_and_counters(results):
    """Each rank trained on its own clients' rows, gathered in client order
    the reference's batches; the guard's counters are the script's (round
    2 of the guard keeps no client, and the server carries through), the
    codec bills one encoded row a pod, and the unguarded ring's
    ``arrival_weight`` is its closed form."""
    ref, port = results
    for name, *_ in CASES:
        want = np.stack([ref[f"{name}/tokens/{t}"] for t in range(ROUNDS)])
        np.testing.assert_array_equal(port[name]["tokens"], want, err_msg=name)
    h = port["guard"]["h"]
    np.testing.assert_array_equal(h["n_dropped"], [1.0, 0.0, 1.0])
    np.testing.assert_array_equal(h["n_rejected"], [0, 1, 1])
    np.testing.assert_array_equal(h["diverged"], [0.0, 0.0, 0.0])
    h = port["buffer_guard"]["h"]
    np.testing.assert_array_equal(h["n_rejected"], [1, 1, 0])
    plan = T._mesh_plan(MODEL, _cfg(SAFLConfig, SketchConfig, AdaConfig),
                        Mesh(*SILO), "cross_silo")[2]
    np.testing.assert_array_equal(
        port["codec"]["h"]["uplink_bits"],
        float(CodecConfig(bits=8, error_feedback=False).payload_bits(plan.b_total) * 2))
    acfg = AsyncConfig(max_delay=2, delay="stagger", staleness_alpha=0.5)
    W = [sum(float(arrival_weight(acfg, t - d, d, 2, "cpu").sum())
             for d in range(acfg.buffer_rounds)) for t in range(ROUNDS)]
    np.testing.assert_allclose(port["buffer"]["h"]["arrival_weight"], W,
                               rtol=1e-6)

