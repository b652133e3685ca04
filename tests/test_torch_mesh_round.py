"""The port's mesh rounds on four ranks against the reference's mesh.

The reference runs ``run_mesh_scan`` on four forced CPU devices
(``--xla_force_host_platform_device_count=4``) in two subprocesses, each
compiling half of the cases; the port runs the same cases in ONE
``launch.mesh.spawn`` of four gloo ranks on the CPU, all at the same time: ``cross_device`` on (data 2, model 2), ``cross_device_dp``
on (2, 2), ``cross_silo`` on (pod 2, data 2, model 1) (the reference's
XLA aborts on (2, 1, 2): ROADMAP §C), FedOPT, and a cohort of 1 of 2,
three rounds each of ``test_mesh_scan.py``'s tiny dense model from the
same weights and keys.  Tokens and cohort masks agree exactly; losses and
parameters within atol 2e-3 (the class of the three-round lr 0.01 pins
of tests/test_torch_safl.py: the reference's client step runs under GSPMD
in another summation order, and AMSGrad's normalized step amplifies
ulp-level gaps in near-zero sketch slots).

Inside the port, bit for bit: the scanned driver against the host loop
(SAFL, FedOPT, and under the cohort policy), chunks 1 + 2 against one
chunk of 3, an all-ones mask against no mask, and the packed route
against the per-leaf route below the chunk threshold.

This module imports no jax at its top: the ranks import it by name (the
spawned processes unpickle their function from it), and the reference's
half imports jax inside its subprocess only.
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
from repro_torch.fed import FullParticipation, UniformParticipation
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_mesh, spawn
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.models.sharding import gather_tree, local_shard

from torch_priority import lower_priority  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODEL_KW = dict(name="meshscan", arch_type="dense", num_layers=1, d_model=32,
                num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64)
ROUNDS, KEY, POLICY_SEED = 3, 42, 5
GRID = ((2, 2), ("data", "model"))
SILO = ((2, 2, 1), ("pod", "data", "model"))
# (name, mesh, topology, sketch kind, cohort size or None)
CASES = (("cross_device", GRID, "cross_device", "countsketch", None),
         ("cross_device_dp", GRID, "cross_device_dp", "countsketch", None),
         ("cross_silo", SILO, "cross_silo", "countsketch", None),
         ("fedopt", GRID, "cross_device", "none", None),
         ("cohort", GRID, "cross_device", "countsketch", 1))
# the reference's cases split over its two subprocesses (~20 s each alone)
REF_GROUPS = (("cross_device", "cross_device_dp", "fedopt"),
              ("cross_silo", "cohort"))
PINS = ("scan_vs_host_loop", "chunks_1_2_vs_3", "all_ones_mask_vs_none",
        "packed_vs_per_leaf", "cohort_scan_vs_host_loop",
        "fedopt_scan_vs_host_loop")
TOL = dict(rtol=1e-3, atol=2e-3)
LOSS_TOL = dict(rtol=0.0, atol=2e-3)


def _cfg(kind: str, SAFL, Sketch, Ada):
    # remat changes no value; off, the reference compiles faster
    return SAFL(sketch=Sketch(kind=kind, ratio=0.1, min_b=8),
                server=Ada(name="amsgrad", lr=0.01), client_lr=0.5,
                local_steps=2, remat_local=False)


def _weights() -> dict:
    model = ModelConfig(**MODEL_KW)
    return params_to_numpy(init_params(model, torch.Generator().manual_seed(0),
                                       "cpu"))


# ---------------------------------------------------------------------------
# the reference, in its own process on four forced CPU devices
# ---------------------------------------------------------------------------

def _reference_main(weights_path: str, out_path: str, names) -> None:
    import jax
    import jax.numpy as jnp
    from repro.core.adaptive import AdaConfig as RAda
    from repro.core.safl import SAFLConfig as RSAFL
    from repro.core.safl import init_safl as r_init_safl
    from repro.core.sketch import SketchConfig as RSketch
    from repro.data import BigramLMData as RData
    from repro.data import LMDataConfig as RDataCfg
    from repro.fed import UniformParticipation as RUniform
    from repro.launch.mesh import _mesh
    from repro.launch.train import mesh_sampler, num_clients_of, run_mesh_scan
    from repro.models import ModelConfig as RModel
    from repro.models.sharding import use_mesh

    assert jax.device_count() == 4, jax.devices()
    nested = {}
    for path, arr in np.load(weights_path).items():
        *parents, leaf = path.split("/")
        node = nested
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    model = RModel(**MODEL_KW)
    out = {}
    for name, (shape, axes), topology, kind, cohort in CASES:
        if name not in names:
            continue
        mesh = _mesh(shape, axes)
        cfg = _cfg(kind, RSAFL, RSketch, RAda)
        g = num_clients_of(mesh, topology)
        base = RData(RDataCfg(vocab_size=64, seq_len=16, num_clients=g,
                              alpha=0.05)).device_sampler(8, 2)
        policy = (None if cohort is None
                  else RUniform(g, frac=cohort / g, seed=POLICY_SEED))
        with use_mesh(mesh):
            params, _, hist = run_mesh_scan(
                model, cfg, mesh, mesh_sampler(mesh, base, topology), nested,
                r_init_safl(cfg, nested), rounds=ROUNDS,
                key=jax.random.key(KEY), topology=topology,
                participation=policy, donate=False)
        out[f"{name}/loss"] = np.asarray(hist["loss"])
        flat, _ = jax.tree_util.tree_flatten_with_path(params)
        for path, leaf in flat:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            out[f"{name}/p/{key}"] = np.asarray(leaf)
        for t in range(ROUNDS):
            out[f"{name}/tokens/{t}"] = np.asarray(base.round_batch(t)["tokens"])
            if policy is not None:
                out[f"{name}/mask/{t}"] = np.asarray(policy.mask(t))
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port, one function a rank
# ---------------------------------------------------------------------------

class _Recording:
    """A sampler that keeps the batches it hands out."""

    def __init__(self, sampler):
        self.sampler, self.tokens = sampler, []

    def init_state(self, device):
        return self.sampler.init_state(device)

    def sample(self, state, t):
        state, batch = self.sampler.sample(state, t)
        self.tokens.append(batch["tokens"])
        return state, batch


def _setup(mesh, topology, kind, weights):
    cfg = _cfg(kind, SAFLConfig, SketchConfig, AdaConfig)
    g = T.num_clients_of(mesh, topology)
    base = BigramLMData(LMDataConfig(vocab_size=64, seq_len=16, num_clients=g,
                                     alpha=0.05)).device_sampler(8, 2)
    _, pspecs = T._mesh_pspecs(ModelConfig(**MODEL_KW), topology)

    def fresh():
        full = {k: torch.as_tensor(v) for k, v in weights.items()}
        p = local_shard(mesh, full, pspecs)
        return p, init_safl(cfg, p)

    return cfg, T.mesh_sampler(mesh, base, topology), pspecs, fresh


def _same(a, b) -> bool:
    """Bitwise equality of two (nested) trees or arrays on this rank."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def _all_ranks(ok: bool) -> bool:
    """True when ``ok`` holds on every rank."""
    flag = torch.tensor([1.0 if ok else 0.0])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item() == 1.0)


def _port_ranks(mesh, weights):
    os.nice(10)
    model = ModelConfig(**MODEL_KW)
    meshes = {GRID[1]: mesh, SILO[1]: make_mesh(*SILO, device="cpu")}
    key = prng.key(KEY)
    out, runs = {}, {}
    for name, (_, axes), topology, kind, cohort in CASES:
        m = meshes[axes]
        cfg, smp, pspecs, fresh = _setup(m, topology, kind, weights)
        g = T.num_clients_of(m, topology)
        policy = (None if cohort is None
                  else UniformParticipation(g, frac=cohort / g, seed=POLICY_SEED))
        rec = _Recording(smp)
        params, opt, hist = T.run_mesh_scan(
            model, cfg, m, rec, *fresh(), rounds=ROUNDS, key=key,
            topology=topology, participation=policy)
        runs[name] = (params, opt, hist)
        full = gather_tree(m, params, pspecs)
        group = m.group(T.client_axes_of(m, topology))
        local = torch.stack(rec.tokens)                 # (R, G_loc, K, mb, S)
        parts = [torch.empty_like(local) for _ in range(g)]
        dist.all_gather(parts, local, group=group)
        out[f"{name}/loss"] = hist["loss"]
        out[f"{name}/p"] = {k: v.numpy() for k, v in full.items()}
        out[f"{name}/tokens"] = torch.cat(parts, dim=1).numpy()
        if policy is not None:
            out[f"{name}/mask"] = np.stack([policy.mask(t, "cpu").numpy()
                                            for t in range(ROUNDS)])

    # the port's own bitwise pins, on the (data 2, model 2) grid
    pins = {}
    cfg, smp, pspecs, fresh = _setup(mesh, "cross_device", "countsketch", weights)
    ref = runs["cross_device"]
    step, _ = T.make_safl_train_step(model, cfg, mesh, "cross_device")
    pins["scan_vs_host_loop"] = _same(
        T.run_mesh_host_loop(step, smp, *fresh(), rounds=ROUNDS, key=key), ref)
    p, o, h1 = T.run_mesh_scan(model, cfg, mesh, smp, *fresh(), rounds=1,
                               key=key)
    p, o, h2 = T.run_mesh_scan(model, cfg, mesh, smp, p, o, rounds=ROUNDS,
                               key=key, start_round=1, chunk_size=2)
    pins["chunks_1_2_vs_3"] = _same(
        (p, o, {"loss": np.concatenate([h1["loss"], h2["loss"]])}), ref)
    pins["all_ones_mask_vs_none"] = _same(T.run_mesh_scan(
        model, cfg, mesh, smp, *fresh(), rounds=ROUNDS, key=key,
        participation=FullParticipation(2)), ref)

    plan = T._mesh_plan(model, cfg, mesh, "cross_device")[2]
    gen = torch.Generator().manual_seed(1 + mesh.rank)
    deltas = {k: torch.randn((1,) + v.shape, generator=gen)
              for k, v in fresh()[0].items()}
    same = True
    for mask in (None, torch.tensor([1.0, 0.0])):
        a, b = (T.sharded_sketch_avg_desk(mesh, cfg.sketch, pspecs, deltas,
                                          prng.fold_in(key, 3), plan=pl,
                                          part_mask=mask)
                for pl in (plan, None))
        same = same and _same(a, b)
    pins["packed_vs_per_leaf"] = same

    policy = UniformParticipation(2, frac=0.5, seed=POLICY_SEED)
    step, _ = T.make_safl_train_step(model, cfg, mesh, "cross_device",
                                     participation=policy)
    pins["cohort_scan_vs_host_loop"] = _same(T.run_mesh_host_loop(
        step, smp, *fresh(), rounds=ROUNDS, key=key, participation=policy),
        runs["cohort"])
    step, _ = T.make_fedopt_train_step(model, cfg, mesh, "cross_device")
    pins["fedopt_scan_vs_host_loop"] = _same(T.run_mesh_host_loop(
        step, smp, *fresh(), rounds=ROUNDS, key=key), runs["fedopt"])
    out["pins"] = {k: _all_ranks(v) for k, v in pins.items()}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_round")
    weights = _weights()
    np.savez(tmp / "weights.npz", **weights)
    # the reference's LLVM passes at their lowest level compile its five
    # scans ~20% faster; the values move by ~1e-5 of the tolerance
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
        " --xla_backend_optimization_level=0"
        " --xla_llvm_disable_expensive_passes=true").strip())
    paths = [str(ROOT / "src"), str(ROOT / "tests")]
    # both halves run at a lower priority: they share the machine with the
    # suite's other workers, whose longest file sets the suite's wall time
    procs = []
    for i, names in enumerate(REF_GROUPS):
        code = ("import os, sys; os.nice(10); "
                f"sys.path[:0] = {paths!r}; "
                "import test_torch_mesh_round as m; "
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
    return ref, port


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_mesh_rounds_match_reference(results, case):
    ref, port = results
    np.testing.assert_allclose(port[f"{case}/loss"], ref[f"{case}/loss"],
                               **LOSS_TOL)
    assert np.isfinite(port[f"{case}/loss"]).all()
    params = port[f"{case}/p"]
    assert sorted(params) == sorted(k[len(f"{case}/p/"):] for k in ref
                                    if k.startswith(f"{case}/p/"))
    for k, v in params.items():
        np.testing.assert_allclose(v, ref[f"{case}/p/{k}"], **TOL, err_msg=k)


def test_tokens_and_masks_exact(results):
    """Each rank trained on its own client's rows: the rows the ranks
    consumed, gathered in client order, are the reference's batches; the
    port's cohort masks are the reference's."""
    ref, port = results
    for name, *_ in CASES:
        want = np.stack([ref[f"{name}/tokens/{t}"] for t in range(ROUNDS)])
        np.testing.assert_array_equal(port[f"{name}/tokens"], want)
    masks = np.stack([ref[f"cohort/mask/{t}"] for t in range(ROUNDS)])
    np.testing.assert_array_equal(port["cohort/mask"], masks)
    assert (masks.sum(axis=1) == 1).all()


@pytest.mark.parametrize("pin", PINS)
def test_port_mesh_pins_bitwise(results, pin):
    assert results[1]["pins"][pin]
