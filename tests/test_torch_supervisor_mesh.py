"""The rollback supervisor over the mesh driver against the reference's.

The reference runs its ``run_supervised`` over its ``run_mesh_scan`` on
four forced CPU devices (``--xla_force_host_platform_device_count=4``) in
a subprocess; the port runs its own on four gloo CPU ranks (one
``launch.mesh.spawn``), every rank supervising its own shards, at the
same time.  Both use ``cross_device`` on (data 2, model 2), G = 2, six
rounds in chunks of two, tests/test_torch_mesh_hooks.py's one-layer
model and weights, and tests/test_faults.py's supervised scenarios:

* the clean run: the port's supervised run is its unsupervised
  ``run_mesh_scan`` bit for bit with an empty log, and the reference's
  within the mesh tests' tolerance (rtol 1e-3, atol 2e-3);
* a transient NaN payload (client 1 in rounds 2 and 3, under the run's
  original key only): one rollback; the recovery log (``retry``,
  ``t_fault``, ``t_resume``, ``reason``) is the reference's on every rank,
  the final params within the tolerance, and the checkpoint rank 0 wrote
  holds the whole tree: the one-process loader reads it, equal to the
  gathered params;
* a persistent fault (``FaultConfig(persistent=True)``): ``SupervisorError``
  on every rank, every rank's log the reference's.

Port only: a NaN written into rank 1's shard at the end of the chunk that
ends at round 4 (under the original key).  Only rank 1 sees it, and every
rank rolls back together to round 2.

This module imports no jax at its top: the ranks import it by name.
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
from repro_torch.checkpoint.io import restore_checkpoint
from repro_torch.core.adaptive import AdaConfig
from repro_torch.core.safl import SAFLConfig, init_safl
from repro_torch.core.sketch import SketchConfig
from repro_torch.data.synthetic import BigramLMData
from repro_torch.launch import train as T
from repro_torch.launch.mesh import spawn
from repro_torch.launch.supervisor import (SupervisorConfig, SupervisorError,
                                           run_supervised)
from repro_torch.models.sharding import gather_tree, local_shard
from test_torch_mesh_hooks import (GRID, KEY, MODEL, MODEL_KW, TOL, _cfg, _data,
                                   _nest, _weights)

from torch_priority import lower_priority  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROUNDS, CHUNK, G = 6, 2, 2
TOPOLOGY = "cross_device"
FAULT_ROUNDS = (2, 4)           # client 1's NaN payload, original key only
TRANSIENT_ROW = (0, 2)          # (OK, NAN) in fed's codes
PERSISTENT = dict(nan_rate=0.9, start=2, stop=4, persistent=True)
SCENARIOS = ("clean", "transient", "persistent")
SHARD_NAN_AT = 4                # the chunk end at which rank 1's shard is poisoned
SHARD_NAN_RANK = 1


def _supervisor_cfg(SupCfg, name):
    return SupCfg(max_retries=2 if name == "persistent" else 3)


# ---------------------------------------------------------------------------
# the reference, in its own process on four forced CPU devices
# ---------------------------------------------------------------------------

def _reference_main(weights_path: str, out_path: str, ckpt_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from repro import fed as rfed
    from repro.core.adaptive import AdaConfig as RAda
    from repro.core.safl import SAFLConfig as RSAFL
    from repro.core.safl import init_safl as r_init_safl
    from repro.core.sketch import SketchConfig as RSketch
    from repro.data import BigramLMData as RData
    from repro.data import LMDataConfig as RDataCfg
    from repro.fed.faults import _spec_from_codes
    from repro.launch.mesh import _mesh
    from repro.launch.supervisor import SupervisorConfig as RSupCfg
    from repro.launch.supervisor import SupervisorError as RSupError
    from repro.launch.supervisor import run_supervised as r_run_supervised
    from repro.launch.train import mesh_sampler, run_mesh_scan
    from repro.models import ModelConfig as RModel
    from repro.models.sharding import use_mesh

    class Transient:
        num_clients = G

        def __init__(self, key0):
            self.kd0 = np.asarray(jax.random.key_data(key0))
            self.row = jnp.asarray(TRANSIENT_ROW, jnp.int32)

        def spec(self, t, base_key):
            same = jnp.all(jax.random.key_data(base_key) == self.kd0)
            hit = same & (t >= FAULT_ROUNDS[0]) & (t < FAULT_ROUNDS[1])
            return _spec_from_codes(jnp.where(hit, self.row, 0), 1e3)

    assert jax.device_count() == 4, jax.devices()
    weights = _nest(dict(np.load(weights_path)), jnp.asarray)
    cfg = _cfg(RSAFL, RSketch, RAda)
    rmodel = RModel(**MODEL_KW)
    key = jax.random.key(KEY)
    mesh = _mesh(*GRID)
    d = _data(G)
    smp = mesh_sampler(mesh, RData(RDataCfg(
        vocab_size=d.vocab_size, seq_len=d.seq_len, num_clients=G,
        alpha=d.alpha)).device_sampler(8, 2), TOPOLOGY)
    out = {}
    for name in SCENARIOS:
        faults = {"clean": None, "transient": Transient(key),
                  "persistent": rfed.FaultConfig(num_clients=G, **PERSISTENT)}[name]

        def launch(p, s, *, key, start_round, on_chunk):
            return run_mesh_scan(rmodel, cfg, mesh, smp, p, s, rounds=ROUNDS,
                                 key=key, topology=TOPOLOGY, chunk_size=CHUNK,
                                 start_round=start_round, donate=False,
                                 on_chunk=on_chunk, faults=faults)

        with use_mesh(mesh):
            try:
                params, _, hist, log = r_run_supervised(
                    launch, weights, r_init_safl(cfg, weights), rounds=ROUNDS,
                    key=key, config=_supervisor_cfg(RSupCfg, name))
            except RSupError as e:
                params, hist, log = None, {}, e.log
        out[f"{name}/log"] = np.asarray(repr(log))
        if params is not None:
            out[f"{name}/loss"] = np.asarray(hist["loss"])
            for k, v in params.items():
                for path, leaf in jax.tree_util.tree_flatten_with_path(v)[0]:
                    sub = "/".join(str(getattr(x, "key", x)) for x in path)
                    out[f"{name}/p/{k}" + (f"/{sub}" if sub else "")] = np.asarray(leaf)
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port, one function a rank
# ---------------------------------------------------------------------------

class Transient:
    """tests/test_faults.py's scripted transient fault: client 1's NaN
    payload in ``FAULT_ROUNDS``, under the run's original key only."""
    num_clients = G

    def __init__(self, key0):
        self.key0 = key0

    def spec(self, t, base_key, device):
        from repro_torch.fed.faults import _spec_from_codes
        hit = base_key == self.key0 and FAULT_ROUNDS[0] <= t < FAULT_ROUNDS[1]
        row = TRANSIENT_ROW if hit else (0,) * G
        return _spec_from_codes(torch.tensor(row, dtype=torch.int32, device=device), 1e3)


def _every_rank(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _port_ranks(mesh, weights, ckpt_dir):
    os.nice(10)
    from repro_torch import fed
    cfg = _cfg(SAFLConfig, SketchConfig, AdaConfig)
    key = prng.key(KEY)
    _, pspecs = T._mesh_pspecs(MODEL, TOPOLOGY)
    smp = T.mesh_sampler(mesh, BigramLMData(_data(G)).device_sampler(8, 2), TOPOLOGY)

    def fresh():
        p = local_shard(mesh, {k: torch.as_tensor(v) for k, v in weights.items()},
                        pspecs)
        return p, init_safl(cfg, p)

    def launcher(faults, poison=False):
        def launch(p, s, *, key, start_round, on_chunk):
            def chunk(t_done, p, s, hist):
                if poison and key == prng.key(KEY) and t_done == SHARD_NAN_AT \
                        and mesh.rank == SHARD_NAN_RANK:
                    next(iter(p.values())).view(-1)[0] = float("nan")
                on_chunk(t_done, p, s, hist)
            return T.run_mesh_scan(MODEL, cfg, mesh, smp, p, s, rounds=ROUNDS,
                                   key=key, topology=TOPOLOGY, chunk_size=CHUNK,
                                   start_round=start_round, on_chunk=chunk,
                                   faults=faults)
        return launch

    out = {}
    plain_p, plain_s, plain_h = T.run_mesh_scan(MODEL, cfg, mesh, smp, *fresh(),
                                                rounds=ROUNDS, key=key,
                                                topology=TOPOLOGY, chunk_size=CHUNK)
    cases = {"clean": (None, False), "transient": (Transient(key), False),
             "persistent": (fed.FaultConfig(num_clients=G, **PERSISTENT), False),
             "shard_nan": (None, True)}
    for name, (faults, poison) in cases.items():
        ckpt = os.path.join(ckpt_dir, name) if name == "transient" else None
        try:
            p, s, hist, log = run_supervised(
                launcher(faults, poison), *fresh(), rounds=ROUNDS, key=key,
                config=_supervisor_cfg(SupervisorConfig, name), ckpt_path=ckpt,
                mesh=mesh, pspecs=pspecs)
        except SupervisorError as e:
            out[name] = {"logs": _every_rank(e.log)}
            continue
        res = {"logs": _every_rank(log), "loss": hist["loss"],
               "p": {k: v.numpy() for k, v in gather_tree(mesh, p, pspecs).items()}}
        if name == "clean":
            same = (np.array_equal(hist["loss"], plain_h["loss"])
                    and all(torch.equal(p[k], plain_p[k]) for k in p)
                    and all(torch.equal(s[m][k], plain_s[m][k])
                            for m in ("m", "v", "vhat") for k in p)
                    and torch.equal(s["step"], plain_s["step"]))
            res["bitwise_unsupervised"] = _every_rank(same)
        out[name] = res
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("supervisor_mesh")
    weights = _weights()
    np.savez(tmp / "weights.npz", **weights)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
        " --xla_backend_optimization_level=0"
        " --xla_llvm_disable_expensive_passes=true").strip())
    paths = [str(ROOT / "src"), str(ROOT / "tests")]
    code = ("import os, sys; os.nice(10); "
            f"sys.path[:0] = {paths!r}; "
            "import test_torch_supervisor_mesh as m; "
            f"m._reference_main({str(tmp / 'weights.npz')!r}, "
            f"{str(tmp / 'ref.npz')!r}, {str(tmp)!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        port = spawn(_port_ranks, *GRID, weights, str(tmp), device="cpu",
                     timeout=300)
    finally:
        log = proc.communicate(timeout=300)[0]
    assert proc.returncode == 0, log
    with np.load(tmp / "ref.npz") as z:
        ref = dict(z)
    return ref, port, tmp


def _ref_log(ref, name) -> list:
    return eval(str(ref[f"{name}/log"]))        # noqa: S307 (our own repr)


def _ref_params(ref, name) -> dict:
    pre = f"{name}/p/"
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


def _held(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], **TOL, err_msg=k)


def test_clean_run_is_the_unsupervised_run(results):
    """Bit for bit the port's unsupervised ``run_mesh_scan`` on every rank,
    an empty log, and the reference's supervised run within TOL."""
    ref, port, _ = results
    got = port["clean"]
    assert got["bitwise_unsupervised"] == [True] * 4
    assert got["logs"] == [[]] * 4 and _ref_log(ref, "clean") == []
    np.testing.assert_allclose(got["loss"], ref["clean/loss"], rtol=0, atol=2e-3)
    _held(got["p"], _ref_params(ref, "clean"))


def test_transient_fault_log_is_the_references_on_every_rank(results):
    ref, port, _ = results
    want = _ref_log(ref, "transient")
    assert len(want) == 1 and want[0]["t_resume"] == FAULT_ROUNDS[0]
    assert port["transient"]["logs"] == [want] * 4


def test_transient_fault_params_match_reference(results):
    ref, port, _ = results
    got = port["transient"]
    assert np.isfinite(got["loss"]).all() and len(got["loss"]) == ROUNDS
    np.testing.assert_allclose(got["loss"], ref["transient/loss"], rtol=0, atol=2e-3)
    _held(got["p"], _ref_params(ref, "transient"))


def test_transient_checkpoint_holds_the_whole_tree(results):
    """Rank 0 wrote the gathered tree of the last good chunk: the
    one-process loader reads it into whole leaves equal to the final
    gathered params, with the cursor at the last round."""
    _, port, tmp = results
    full = port["transient"]["p"]
    like = {"params": {k: torch.empty(v.shape) for k, v in full.items()},
            "opt": {"step": torch.zeros((), dtype=torch.int32),
                    **{m: {k: torch.empty(v.shape) for k, v in full.items()}
                       for m in ("m", "v", "vhat")}},
            "cursor": {"t": torch.zeros((), dtype=torch.int64),
                       "key": torch.zeros(2, dtype=torch.int64)}}
    tree, step = restore_checkpoint(str(tmp / "transient"), like)
    assert step == ROUNDS and int(tree["cursor"]["t"]) == ROUNDS
    for k, v in full.items():
        np.testing.assert_array_equal(tree["params"][k].numpy(), v, err_msg=k)
    assert int(tree["opt"]["step"]) == ROUNDS


def test_persistent_fault_raises_on_every_rank_with_the_references_log(results):
    ref, port, _ = results
    want = _ref_log(ref, "persistent")
    assert len(want) == 2 and want[0]["t_resume"] == FAULT_ROUNDS[0]
    assert "p" not in port["persistent"]
    assert port["persistent"]["logs"] == [want] * 4


def test_one_ranks_shard_nan_rolls_every_rank_back(results):
    """Only rank 1's shard went non-finite; every rank raised the same
    fault, rolled back to the same cursor, rekeyed and finished finite."""
    _, port, _ = results
    got = port["shard_nan"]
    want = [{"retry": 1, "t_fault": SHARD_NAN_AT, "t_resume": SHARD_NAN_AT - CHUNK,
             "reason": "non-finite params at chunk end"}]
    assert got["logs"] == [want] * 4
    assert np.isfinite(got["loss"]).all() and len(got["loss"]) == ROUNDS
    assert all(np.isfinite(v).all() for v in got["p"].values())
