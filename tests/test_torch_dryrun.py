"""The port's dry run (``repro_torch.launch.dryrun``) against the reference's
spec arithmetic, on the CPU.

* Shard shapes: for every assigned arch on 16 x 16 and 2 x 16 x 16 under
  ``topology_for``, rank 0's ``meta`` shards (``rank_inputs`` on the mesh
  layout) equal the reference's specs' arithmetic -- each dim divided by
  the sizes of its axes under the reference's ``param_pspecs``,
  ``opt_pspecs``, ``batch_pspecs``, ``cache_pspecs``, ``flat_tp_pspecs``
  and ``flat_tp_cache_pspecs`` (handed a stand-in mesh, no device): the
  weights and the AMSGrad state (bfloat16 moments above ``MEGA_PARAMS``),
  the train batch, and the decode cache in both serve layouts.  Where the
  reference's dims do not divide, the port refuses (``UNEVEN``).
* Status: the ok/SKIP status of every arch x shape equals the
  reference's ``shape_eligible``, and the port cuts every one the
  reference lowers (``rank_inputs``), the train and prefill steps of the
  eight archs whose heads a 16-way model axis splits too (``PART_HEADS``:
  their attention gathers whole heads, ``models.parallel.head_plan``).
* The mini dry run (the counterpart of tests/test_sharding_and_dryrun.py's
  ``test_mini_dryrun_8_devices``), in a subprocess so the fake default
  group never reaches the pytest worker: llama3.2-1b SMOKE's train step
  (K = 2, the uplink through B1's meta route) and decode step under a fake
  group of 8.  The train step runs on the reference's (2, 4) mesh, which
  cuts the SMOKE config's 2 KV heads over 4 ranks, and on (4, 2); the
  decode step on (2, 4).  Rank 0's argument bytes equal a real CPU
  ``local_shard``'s ``nbytes`` exactly, and the 8 ranks' matmul FLOPs on
  (4, 2) sum to the one-process client steps' of the same 4 clients'
  batches.  And a part-head step: llama3.2-1b SMOKE's client step on
  (data 1, model 4), its dry run's collective calls, bytes and FLOPs
  those of the live step on four gloo CPU ranks (``spawn`` from the same
  subprocess; ``test_torch_part_heads.live_client_counts``).
* The meta route of ``kernels/ops.py``: B1-B4 on ``meta`` return the
  kernel's output shape and record one launch and chip_smoke's bytes.
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as r_config
from repro.configs import input_specs as r_input_specs
from repro.configs import shape_eligible as r_eligible
from repro.core.adaptive import AdaConfig as RAda
from repro.launch import train as R
from repro.models.model import param_shapes as r_param_shapes
from repro.models.sharding import param_pspecs as r_param_pspecs
from repro_torch.configs import ASSIGNED, INPUT_SHAPES, get_config, input_specs
from repro_torch.configs import shape_eligible
from repro_torch.kernels import countsketch as cs
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.op_costs import OpCosts
from repro_torch.launch.train import num_clients_of

from torch_priority import lower_priority  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"16x16": False, "2x16x16": True}
# the configurations whose dims do not divide under the flat serving layout
# (both meshes: the layout cuts over (data, model) = 256 ranks)
UNEVEN = {("jamba_1_5_large_398b", "flat"): "dim 16 of (9, 16, 8192, 24576)",
          ("qwen1_5_4b", "flat"): "dim 151936 of (151936, 2560)",
          ("dbrx_132b", "flat"): "dim 16 of (40, 16, 6144, 10752)"}
# the archs whose heads a 16-way model axis splits: a rank's q or k/v
# columns are part heads, and its train and prefill steps' attention gathers
# whole heads (GSPMD reshards)
PART_HEADS = {"whisper_large_v3": "20 query and 20 key/value",
              "jamba_1_5_large_398b": "64 query and 8 key/value",
              "qwen2_vl_7b": "28 query and 4 key/value",
              "h2o_danube_1_8b": "32 query and 8 key/value",
              "llama3_2_1b": "32 query and 8 key/value",
              "qwen1_5_4b": "20 query and 20 key/value",
              "qwen2_7b": "28 query and 4 key/value",
              "dbrx_132b": "48 query and 8 key/value"}


def _ref_mesh(multi_pod: bool):
    m = make_production_mesh(multi_pod=multi_pod)
    return types.SimpleNamespace(shape=m.shape, axis_names=m.axis_names)


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (P, jax.ShapeDtypeStruct)))
    return {"/".join(str(getattr(k, "key", k)) for k in path): x for path, x in leaves}


def _cut(shape, spec, sizes) -> tuple | None:
    """The reference's block shape of a leaf under ``spec``; None where a
    dim does not divide."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for d, e in zip(shape, spec):
        n = int(np.prod([sizes[a] for a in ((e,) if isinstance(e, str) else e or ())]))
        if d % n:
            return None
        out.append(d // n)
    return tuple(out)


def _ref_blocks(abstract: dict, specs: dict, sizes) -> dict | None:
    out = {k: _cut(abstract[k].shape, tuple(specs[k]), sizes) for k in abstract}
    return None if any(v is None for v in out.values()) else out


def _port_flat(tree: dict, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _ref_trees(arch, multi_pod, topology, shape, layout):
    """The reference's abstract trees and spec trees of a step's inputs,
    flat: {name: (abstract, specs)}."""
    rcfg = r_config(arch)
    rmesh = _ref_mesh(multi_pod)
    fsdp = topology == "cross_silo"
    pa = jax.tree.map(lambda s: jax.ShapeDtypeStruct(tuple(s), rcfg.dtype),
                      r_param_shapes(rcfg), is_leaf=lambda x: isinstance(x, tuple))
    ps = r_param_pspecs(pa, fsdp=fsdp)
    sh = INPUT_SHAPES[shape]
    if sh.kind == "train":
        mega = D.count_params_analytic(get_config(arch)) > D.MEGA_PARAMS
        server = RAda(name="amsgrad", moment_dtype=jnp.bfloat16 if mega else jnp.float32)
        batch = r_input_specs(rcfg, shape, num_clients=num_clients_of(
            make_production_mesh(multi_pod=multi_pod), topology))["batch"]
        opt = {"step": jax.ShapeDtypeStruct((), jnp.int32),
               **{m: jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, server.moment_dtype), pa)
                  for m in ("m", "v", "vhat")}}
        return {"params": (pa, ps), "opt": (opt, R.opt_pspecs(server, ps)),
                "batch": (batch, R.batch_pspecs(batch, rmesh, topology))}
    cache = r_input_specs(rcfg, shape)["cache"]
    daxes = R.data_axes_of(rmesh)
    if layout == "flat":
        return {"params": (pa, R.flat_tp_pspecs(ps)),
                "cache": (cache, R.flat_tp_cache_pspecs(cache, rmesh))}
    return {"params": (pa, ps), "cache": (cache, R.cache_pspecs(cache, daxes, rmesh))}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shard_shapes_match_reference_spec_arithmetic(mesh_name):
    mp = MESHES[mesh_name]
    lay = make_production_mesh(multi_pod=mp)
    rank0 = Mesh(lay.sizes, lay.axis_names, rank=0)
    refused = {}
    for arch in ASSIGNED:
        cfg = get_config(arch)
        topo = D.topology_for(cfg)
        for shape, layout in (("train_4k", "default"), ("decode_32k", "default"),
                              ("decode_32k", "flat")):
            sh = INPUT_SHAPES[shape]
            inputs = (input_specs(cfg, shape, num_clients=num_clients_of(lay, topo))
                      if sh.kind == "train" else input_specs(cfg, shape))
            want = {name: _ref_blocks(_flat(a), _flat(s), lay.shape)
                    for name, (a, s) in _ref_trees(arch, mp, topo, shape, layout).items()}
            try:
                got = D.rank_inputs(cfg, rank0, inputs, kind=sh.kind, topology=topo,
                                    serve_layout=layout, max_seq=sh.seq_len)
            except ValueError as e:
                refused[(arch, layout)] = str(e)
                assert any(w is None for w in want.values()), (arch, shape, layout, e)
                continue
            assert all(w is not None for w in want.values()), (arch, shape, layout)
            for name, w in want.items():
                g = {k: tuple(v.shape) for k, v in _port_flat(got[name]).items()}
                assert g == w, (arch, shape, layout, name)
            if sh.kind == "train":
                mom = got["opt"]["m"]
                big = D.count_params_analytic(cfg) > D.MEGA_PARAMS
                assert {v.dtype for v in mom.values()} == {
                    torch.bfloat16 if big else torch.float32}, arch
    assert sorted(refused) == sorted(UNEVEN)
    for k, why in UNEVEN.items():
        assert why in refused[k] and "not divisible" in refused[k], refused[k]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_status_matches_reference(mesh_name):
    """Every arch x shape: SKIP exactly where the reference skips; the
    port's cut (``rank_inputs``, what ``lower_one`` runs before the step) ok
    everywhere else, the part-head archs' train and prefill steps too."""
    lay = make_production_mesh(multi_pod=MESHES[mesh_name])
    rank0 = Mesh(lay.sizes, lay.axis_names, rank=0)
    for arch in ASSIGNED:
        cfg = get_config(arch)
        topo = D.topology_for(cfg)
        for shape, sh in INPUT_SHAPES.items():
            ok, why = shape_eligible(cfg, shape)
            assert (ok, why) == r_eligible(r_config(arch), shape), (arch, shape)
            if not ok:
                continue
            inputs = (input_specs(cfg, shape, num_clients=num_clients_of(lay, topo))
                      if sh.kind == "train" else input_specs(cfg, shape))
            D.rank_inputs(cfg, rank0, inputs, kind=sh.kind, topology=topo,
                          max_seq=sh.seq_len)               # an uneven cut raises
            if sh.kind != "decode" and arch in PART_HEADS:
                heads = f"{cfg.num_heads} query and {cfg.num_kv_heads} key/value"
                assert heads == PART_HEADS[arch], arch
                assert (cfg.num_heads * cfg.hd // lay.shape["model"] % cfg.hd
                        or cfg.num_kv_heads * cfg.hd // lay.shape["model"] % cfg.hd), arch


def test_meta_route_records_launch_and_bytes():
    """B1-B4 on ``meta``: the kernel's output shape, one launch each, and
    the bytes chip_smoke's ``bound_ms`` counts for that shape."""
    g, n, b, r, c = 5, 1000, 37, 3, 4096
    x = torch.empty((g, n), device="meta")
    h = torch.empty((n,), dtype=torch.int32, device="meta")
    with OpCosts() as oc:
        assert ops.countsketch_clients(x, h, b).shape == (g, b)
        assert ops.fwht_rows(torch.empty((r, c), device="meta")).shape == (r, c)
        assert ops.gaussian_sk(7, torch.empty((n,), device="meta"), b).shape == (b,)
        assert ops.gaussian_desk(7, torch.empty((b,), device="meta"), n).shape == (n,)
    k = oc.counts()["kernels"]
    assert k["countsketch_clients"] == {"launches": 1, "bytes": g * n * 4 + n * 4 + g * b * 4}
    # B1's int32 workspace was held while it ran, beside its output
    work = cs.work_ints(n, -(-b // cs.route(n, b)[0]), cs.route(n, b)[1]) * 4
    assert oc.counts()["memory"]["peak_bytes"] >= g * n * 4 + n * 4 + g * b * 4 + work
    assert k["fwht_rows"] == {"launches": 1, "bytes": 2 * r * c * 4}
    assert k["gaussian_sk"] == {"launches": 1, "bytes": (n + b) * 4}
    assert k["gaussian_desk"] == {"launches": 1, "bytes": (n + b) * 4}
    assert oc.counts()["flops"] == 0            # the plain versions were not traced
    # a CPU tensor still takes the plain version
    xc = torch.randn(g, n)
    hc = torch.randint(0, b, (n,), dtype=torch.int32)
    want = torch.zeros(g, b).index_add_(1, hc.long(), xc)
    torch.testing.assert_close(ops.countsketch_clients(xc, hc, b), want)


# ---------------------------------------------------------------------------
# the mini dry run, in its own process
# ---------------------------------------------------------------------------

def _mini_main(out_path: str) -> None:
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.adaptive import AdaConfig
    from repro_torch.core.safl import SAFLConfig, _f32, client_delta, init_safl
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.launch import train as T
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.models.sharding import local_shard
    cfg = get_config("llama3_2_1b", smoke=True)
    safl = SAFLConfig(sketch=SketchConfig(kind="countsketch", ratio=0.01,
                                          use_kernels=True, cs_hash="independent"),
                      server=AdaConfig(name="amsgrad", lr=1e-3),
                      client_lr=0.01, local_steps=2)
    axes = ("data", "model")
    out = {}
    meta = lambda s: torch.empty(s, dtype=torch.int32, device="meta")
    out["counts_2x4"] = D.dry_run(cfg, (2, 4), axes,
                                  {"batch": {"tokens": meta((2, 2, 4, 64))}},
                                  kind="train", safl=safl)["counts"]
    out["initialized_after"] = torch.distributed.is_initialized()
    runs = [D.dry_run(cfg, (4, 2), axes, {"batch": {"tokens": meta((4, 2, 4, 64))}},
                      kind="train", safl=safl, rank=r) for r in range(8)]
    out["flops"] = [r["counts"]["flops"] for r in runs]
    out["counts0"] = runs[0]["counts"]
    plan = T._mesh_plan(cfg, safl, Mesh((4, 2), axes, rank=0), "cross_device")[2]
    out["plan"] = [plan.d_total, plan.b_total]
    # the same step's arguments, real, on the CPU
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 2, 4, 64), generator=gen,
                           dtype=torch.int32)
    rank0 = Mesh((4, 2), axes, rank=0)
    _, pspecs = T._mesh_pspecs(cfg, "cross_device")
    lp = local_shard(rank0, params, pspecs)
    rows = local_shard(rank0, {"tokens": tokens}, {"tokens": ("data", None, None, None)})
    seen, nbytes = set(), 0
    for t in [*lp.values(), *rows.values(),
              *[x for v in init_safl(safl, lp).values()
                for x in (v.values() if isinstance(v, dict) else [v])]]:
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            nbytes += t.untyped_storage().nbytes()
    out["cpu_argument_bytes"] = nbytes
    # the one-process client steps of the same 4 clients
    with FlopCounterMode(display=False) as fc:
        for c in range(4):
            client_delta(safl, lambda p, b: loss_fn(cfg, p, b), params,
                         {"tokens": tokens[c]}, _f32(safl.client_lr))
    out["one_process_flops"] = int(fc.get_total_flops())
    out["one_process_by_op"] = {str(k): int(v) for k, v in
                                fc.get_flop_counts()["Global"].items()}
    dec = D.dry_run(cfg, (2, 4), axes,
                    {"cache": T._meta_cache(cfg, 8, 128), "tokens": meta((8, 1)),
                     "pos": meta(())}, kind="decode")
    out["decode"] = dec["counts"]
    out["decode_shards"] = dec["shards"]["cache"]
    # a part-head step, dry and live: the client step on (data 1, model 4)
    from repro_torch.launch.mesh import spawn
    from test_torch_part_heads import live_client_counts
    live = spawn(live_client_counts, (1, 4), axes, "llama3_2_1b", {},
                 tokens[:1, :1, :, :16].numpy(), device="cpu", timeout=300)
    out["part_heads"] = {
        str(remat): {"dry": D.dry_run(cfg, (1, 4), axes,
                                      {"batch": {"tokens": meta((1, 1, 4, 16))}},
                                      kind="client", remat=remat)["counts"],
                     "live": live[remat]}
        for remat in (False, True)}
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    path = tmp_path_factory.mktemp("mini_dryrun") / "out.json"
    code = ("import os, sys; os.nice(10); "
            f"sys.path[:0] = {[str(ROOT / 'src'), str(ROOT / 'tests')]!r}; "
            "import test_torch_dryrun as m; "
            f"m._mini_main({str(path)!r})")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads(path.read_text())


def test_mini_dryrun_train_and_decode_run_to_their_end(mini):
    # (2, 4) cuts the 2 KV heads: one gather of k and v an attention layer,
    # a reduce-scatter in the backward
    c24 = mini["counts_2x4"]["collective_calls"]
    assert c24["all_gather"] > 0 and c24["reduce_scatter"] > 0, c24
    assert mini["initialized_after"] is False       # the fake group was destroyed
    c = mini["counts0"]
    # one payload all_reduce (+ its weight) and the losses' all_gather a round,
    # the client step's sums over the two-rank model group
    assert c["collective_calls"]["all_reduce"] > 0 and c["collective_calls"]["all_gather"] > 0
    n, b = mini["plan"]
    assert c["kernels"] == {"countsketch_clients": {"launches": 1,
                                                    "bytes": n * 4 + n * 4 + b * 4}}
    d = mini["decode"]
    assert d["flops"] > 0 and d["collective_calls"]["all_reduce"] > 0
    assert d["kernels"] == {}
    assert d["memory"]["argument_bytes"] > 0


def test_mini_dryrun_argument_bytes_are_the_real_shards(mini):
    assert mini["counts0"]["memory"]["argument_bytes"] == mini["cpu_argument_bytes"]


def test_mini_dryrun_flops_sum_to_the_one_process_step(mini):
    """The 8 ranks' matmul FLOPs (4 clients x 2 model shards; the sketch and
    the server step do no matmul) sum to the one-process client steps'."""
    assert sum(mini["flops"]) == mini["one_process_flops"], (
        mini["flops"], mini["one_process_flops"], mini["one_process_by_op"])


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_mini_dryrun_part_head_step_counts_the_live_steps(mini, remat):
    """The dry run of a part-head client step counts the gathers (and every
    other collective), their bytes and the FLOPs of the same step run live
    on four gloo ranks; with and without the blocks' recompute."""
    dry, live = mini["part_heads"][str(remat)]["dry"], mini["part_heads"][str(remat)]["live"]
    # llama3.2-1b SMOKE: 2 layers, each kv gather a reduce-scatter backward;
    # the recompute gathers each layer's k and v again
    gathers = 4 if remat else 2
    assert dry["collective_calls"]["all_gather"] == gathers, dry["collective_calls"]
    assert dry["collective_calls"]["reduce_scatter"] == 2, dry["collective_calls"]
    assert dry["collective_calls"] == live["collective_calls"]
    assert dry["collective_bytes"] == live["collective_bytes"]
    assert dry["flops"] == live["flops"] > 0
