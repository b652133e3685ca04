"""Dry run: trace one rank's step of every (architecture x input shape x mesh)
on ``meta`` tensors under a fake process group, count what it does, and
emit roofline terms.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
step against ``ShapeDtypeStruct`` stand-ins on 512 forced host devices.
The port has no compiler: it starts PyTorch's ``fake`` process group of
``mesh.size`` ranks in this one process (every collective returns at
once), takes one rank of the production mesh (rank 0 unless ``--rank``
says otherwise), cuts that rank's ``meta`` shards of the weights, the
server state, the batch and the cache with ``local_shard`` under the
port's specs, and runs the port's own step on them once under
``launch.op_costs.OpCosts``: the SAFL/FedOPT mesh round for ``train``,
the sharded prefill or decode step for ``prefill``/``decode``.  Nothing is
allocated.  A configuration the port cannot cut (a dimension its axes do
not divide) returns the error as its status and counts as a failure, as
the reference counts one.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k [--multi-pod] [--step safl|fedopt|client] [--json out.json]

runs on the CPU.  ``--fits`` says which configurations' per-rank bytes
fit the card's 80 GiB.  ``dry_run`` is the Python entry for a config, a
mesh and inputs of any shape.  The times are predictions from the H100's
data-sheet constants (``launch/roofline.py``), not measurements; the dry
run never runs on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.configs import (ASSIGNED, INPUT_SHAPES, get_config,
                                 input_specs, shape_eligible)
from repro_torch.core.adaptive import AdaConfig
from repro_torch.core.safl import SAFLConfig, _f32
from repro_torch.core.sketch import SketchConfig
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh
from repro_torch.launch.op_costs import OpCosts
from repro_torch.launch.train import (_mesh_pspecs, _spec_entry, batch_pspecs,
                                      client_axes_of, client_deltas_sharded,
                                      data_axes_of,
                                      infer_batch_pspecs,
                                      make_fedopt_train_step,
                                      make_prefill_step, make_safl_train_step,
                                      make_serve_step, num_clients_of,
                                      opt_pspecs, serve_specs)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import count_params_analytic, param_shapes
from repro_torch.models.sharding import local_shard, param_pspecs

MEGA_PARAMS = 60e9  # configs above this use bf16 server moments


def build_safl_cfg(cfg, *, sketch_kind="countsketch", ratio=1e-3,
                   local_steps=1, server="amsgrad") -> SAFLConfig:
    mega = count_params_analytic(cfg) > MEGA_PARAMS
    return SAFLConfig(
        sketch=SketchConfig(kind=sketch_kind, ratio=ratio, min_b=64),
        server=AdaConfig(name=server, lr=1e-3,
                         moment_dtype=torch.bfloat16 if mega else torch.float32),
        client_lr=0.01, local_steps=local_steps)


def abstract_params(cfg) -> dict:
    return {k: torch.empty(s, dtype=cfg.dtype, device="meta")
            for k, s in param_shapes(cfg).items()}


def abstract_opt_state(server: AdaConfig, params_abs) -> dict:
    mom = lambda: {k: torch.empty(p.shape, dtype=server.moment_dtype, device="meta")
                   for k, p in params_abs.items()}
    out = {"step": torch.empty((), dtype=torch.int32, device="meta")}
    if server.name in ("amsgrad", "adam", "sgdm"):
        out["m"] = mom()
    if server.name in ("amsgrad", "adam", "adagrad"):
        out["v"] = mom()
    if server.name == "amsgrad":
        out["vhat"] = mom()
    return out


def topology_for(cfg) -> str:
    return "cross_silo" if count_params_analytic(cfg) > MEGA_PARAMS \
        else "cross_device"


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """A ``fake`` default process group of ``size`` ranks in this process,
    as ``rank``; destroyed on the way out, whatever happens, so the caller's
    process is left as it was."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry run needs PyTorch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg), "
                           f"which this PyTorch {torch.__version__} lacks") from e
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake default process "
                           "group; one is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _shapes(tree) -> dict:
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()}


def rank_inputs(model_cfg: ModelConfig, mesh, inputs: dict, *, kind: str,
                topology: str = "cross_device", safl: Optional[SAFLConfig] = None,
                serve_layout: str = "default", fsdp: Optional[bool] = None,
                max_seq: Optional[int] = None) -> dict:
    """A rank's ``meta`` shards of a step's arguments under the port's specs
    (``mesh``: a live mesh, or a layout with its ``rank`` set).  ``train``:
    ``params`` and ``opt`` (``param_pspecs``/``opt_pspecs`` of the
    topology), ``rows`` (its client group's rows, which every rank of the
    group takes whole: ``mesh_sampler``'s layout) and ``batch`` (the rows
    under ``batch_pspecs``, the block the client step computes on);
    ``prefill``: ``params`` and ``batch`` (``infer_batch_pspecs``);
    ``decode``: ``params``, ``cache``, ``tokens`` and ``pos`` under
    ``serve_specs`` of ``serve_layout`` (``max_seq``: the cache length it
    was built for, by default its attention leaves').  An uneven cut
    raises."""
    if fsdp is None:
        fsdp = topology == "cross_silo"
    if kind in ("train", "client"):
        batch = inputs["batch"]
        safl = safl or build_safl_cfg(model_cfg)
        abstract, pspecs = _mesh_pspecs(model_cfg, topology)
        lead = _spec_entry(client_axes_of(mesh, topology))
        out = {"params": local_shard(mesh, abstract, pspecs),
               "rows": local_shard(mesh, batch, {k: (lead,) + (None,) * (v.dim() - 1)
                                                 for k, v in batch.items()}),
               "batch": local_shard(mesh, batch, batch_pspecs(batch, mesh, topology))}
        if kind == "train":
            out["opt"] = local_shard(mesh, abstract_opt_state(safl.server, abstract),
                                     opt_pspecs(safl.server, pspecs))
        return out
    if kind == "prefill":
        batch, abstract = inputs["batch"], abstract_params(model_cfg)
        return {"params": local_shard(mesh, abstract, param_pspecs(abstract, fsdp=fsdp)),
                "batch": local_shard(mesh, batch, infer_batch_pspecs(
                    batch, data_axes_of(mesh), mesh))}
    if kind == "decode":
        cache, tokens = inputs["cache"], inputs["tokens"]
        pspecs, cspecs, tspec = serve_specs(model_cfg, mesh, tokens.shape[0],
                                            max_seq or _cache_len(cache),
                                            layout=serve_layout, fsdp=fsdp)
        return {"params": local_shard(mesh, abstract_params(model_cfg), pspecs),
                "cache": local_shard(mesh, cache, cspecs),
                "tokens": local_shard(mesh, {"t": tokens}, {"t": tspec})["t"],
                "pos": inputs["pos"]}
    raise ValueError(f"unknown step kind {kind!r}")


def dry_run(model_cfg: ModelConfig, sizes, axes, inputs: dict, *, kind: str,
            topology: str = "cross_device", safl: Optional[SAFLConfig] = None,
            step_kind: str = "safl", serve_layout: str = "default",
            fsdp: Optional[bool] = None, rank: int = 0,
            max_seq: Optional[int] = None, remat: bool = True) -> dict:
    """Run one rank's step of ``model_cfg`` on a mesh of ``sizes`` over
    ``axes`` under a fake group, on ``meta`` shards, and count it.

    ``inputs`` are the step's global inputs as ``meta`` tensors, in
    ``configs.input_specs``' layout: ``{"batch": {...}}`` with (G, K, mb,
    ...) leaves for ``kind="train"`` (G the round's clients) or
    ``"client"`` (``launch.train.client_deltas_sharded`` alone) and (B, ...)
    for ``"prefill"``; ``{"cache", "tokens", "pos"}`` for ``"decode"``.
    ``fsdp`` (serving) defaults to ``topology == "cross_silo"``;
    ``max_seq`` is a decode cache's length (``rank_inputs``); ``remat`` is
    the client step's (``client_deltas_sharded``: on, as every train step's).

    Returns ``{"counts": OpCosts.counts(), "shards": the shapes of the
    rank's ``rank_inputs``, "seconds": the step's wall time}``; the port's
    own exceptions (an uneven cut) propagate."""
    if fsdp is None:
        fsdp = topology == "cross_silo"
    safl = safl or build_safl_cfg(model_cfg)
    with fake_world(math.prod(sizes), rank):
        mesh = make_mesh(sizes, axes, device="meta")
        a = rank_inputs(model_cfg, mesh, inputs, kind=kind, topology=topology,
                        safl=safl, serve_layout=serve_layout, fsdp=fsdp,
                        max_seq=max_seq)
        if kind == "train":
            G = next(iter(inputs["batch"].values())).shape[0]
            make = make_fedopt_train_step if step_kind == "fedopt" else make_safl_train_step
            step, _ = make(model_cfg, safl, mesh, topology, num_clients=G)
            args = (a["params"], a["opt"], a["rows"], prng.key(0))
        elif kind == "client":
            pspecs = _mesh_pspecs(model_cfg, topology)[1]
            step = functools.partial(client_deltas_sharded, model_cfg, safl, mesh,
                                     topology, eta=_f32(safl.client_lr), pspecs=pspecs,
                                     remat=remat)
            args = (a["params"], a["rows"])
        elif kind == "prefill":
            B = next(iter(inputs["batch"].values())).shape[0]
            step = make_prefill_step(model_cfg, mesh, fsdp=fsdp, batch=B)
            args = (a["params"], a["batch"])
        else:
            step = make_serve_step(model_cfg, mesh, layout=serve_layout, fsdp=fsdp,
                                   batch=inputs["tokens"].shape[0],
                                   max_seq=max_seq or _cache_len(inputs["cache"]))
            args = (a["params"], a["cache"], a["tokens"], a["pos"])
        shards = {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
                  for k, v in a.items()}
        del a
        t0 = time.perf_counter()
        with OpCosts(args) as oc:
            out = step(*args)
            oc.set_outputs(out)
        del out, args
        return {"counts": oc.counts(), "shards": shards,
                "seconds": time.perf_counter() - t0}


def _cache_len(cache: dict) -> int:
    """The cache length a decode cache was built for (its self-attention
    or MLA leaves' sequence dim; an SSM-only model has none: 1)."""
    for path, leaf in cache.items():
        if path.rpartition("/")[2] in ("k", "v", "ckv", "kpe") and \
                not path.startswith("enc"):
            return leaf.shape[2]
    return 1


def lower_one(arch: str, shape: str, *, multi_pod: bool, step_kind: str,
              local_steps: int = 1, ratio: float = 1e-3,
              sketch_kind: str = "countsketch", topology: str = "auto",
              serve_layout: str = "default", verbose: bool = True,
              rank: int = 0, long_scans: bool = False):
    """Returns (RooflineReport | None, status string).  Without
    ``long_scans``, a train or prefill step through Mamba layers is cut
    (``rank_inputs``) but not traced: its recurrence is a Python loop over
    every token of every layer, minutes on ``meta``."""
    cfg = get_config(arch)
    ok, why = shape_eligible(cfg, shape)
    if not ok:
        return None, why
    sh = INPUT_SHAPES[shape]
    layout = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = layout.size
    if topology == "auto":
        topology = topology_for(cfg)
    G = num_clients_of(layout, topology)
    if sh.kind == "train":
        inputs = input_specs(cfg, shape, num_clients=G, local_steps=local_steps)
    else:
        inputs = input_specs(cfg, shape)
    safl = build_safl_cfg(cfg, sketch_kind=sketch_kind, ratio=ratio,
                          local_steps=local_steps)
    scan = sh.kind != "decode" and any(m == "mamba" for m, _ in cfg.layer_kinds())
    try:
        if scan and not long_scans:
            layout0 = Mesh(layout.sizes, layout.axis_names, rank=rank)
            rank_inputs(cfg, layout0, inputs, kind=sh.kind, topology=topology, safl=safl,
                        serve_layout=serve_layout, max_seq=sh.seq_len)
            steps = sh.seq_len * sum(m == "mamba" for m, _ in cfg.layer_kinds())
            return None, (f"SKIP(cuts; the Mamba recurrence's {steps:,} Python "
                          f"steps not traced: --long-scans)")
        kind = "client" if sh.kind == "train" and step_kind == "client" else sh.kind
        run = dry_run(cfg, layout.sizes, layout.axis_names, inputs, kind=kind,
                      topology=topology, safl=safl, step_kind=step_kind,
                      serve_layout=serve_layout, rank=rank, max_seq=sh.seq_len)
    except (ValueError, NotImplementedError) as e:
        return None, f"FAIL({type(e).__name__}: {e})"
    model_flops = RL.model_flops_for(cfg, sh, local_steps=local_steps)
    mom_b = 2 if topology == "cross_silo" else 4
    amem = RL.analytic_memory_bytes(cfg, sh, chips, moment_bytes=mom_b,
                                    local_steps=local_steps)
    rep = RL.analyze(run["counts"], arch=arch, shape=shape, mesh_name=mesh_name,
                     chips=chips, model_flops=model_flops, analytic_mem_bytes=amem,
                     note=(f"step={step_kind if sh.kind == 'train' else sh.kind} "
                           f"topo={topology} serve={serve_layout} rank={rank} "
                           f"trace={run['seconds']:.1f}s"))
    if verbose:
        c = run["counts"]
        print(f"--- {arch} x {shape} x {mesh_name} [{step_kind}] (rank {rank}'s "
              f"step traced in {run['seconds']:.1f} s) ---")
        print("memory_analysis:", rep.memory_report)
        print("cost_analysis: flops=%.3e bytes=%.3e" % (rep.flops_per_device,
                                                         rep.bytes_per_device))
        print("collectives:", {k: v for k, v in rep.coll_breakdown.items()
                               if k != "counts"}, "calls", c["collective_calls"])
        if c["kernels"]:
            print("kernels:", c["kernels"])
        print(RL.format_row(rep))
        sys.stdout.flush()
    return rep, "ok"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--step", default="safl", choices=["safl", "fedopt", "client"],
                    help="a train shape's step: the SAFL or FedOPT round, or the "
                         "client step alone (client_deltas_sharded on the rank's rows)")
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--ratio", type=float, default=1e-3)
    ap.add_argument("--sketch", default="countsketch")
    ap.add_argument("--topology", default="auto",
                    choices=["auto", "cross_device", "cross_device_dp",
                             "cross_silo"])
    ap.add_argument("--serve-layout", default="default",
                    choices=["default", "flat"])
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the mesh whose step is traced")
    ap.add_argument("--long-scans", action="store_true",
                    help="also trace train/prefill steps through Mamba layers "
                         "(a Python step a token a layer: minutes each)")
    ap.add_argument("--fits", action="store_true",
                    help="say which configurations fit the card's 80 GiB a rank")
    ap.add_argument("--json", default=None, help="append reports to this file")
    args = ap.parse_args(argv)

    archs = ASSIGNED if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    reports, failures = [], []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                name = "2x16x16" if mp else "16x16"
                try:
                    rep, status = lower_one(
                        arch, shape, multi_pod=mp, step_kind=args.step,
                        local_steps=args.local_steps, ratio=args.ratio,
                        sketch_kind=args.sketch, topology=args.topology,
                        serve_layout=args.serve_layout, rank=args.rank,
                        long_scans=args.long_scans)
                except Exception as e:  # noqa: BLE001
                    rep, status = None, f"FAIL({e!r})"
                if rep is not None:
                    reports.append(rep)
                elif status.startswith("SKIP"):
                    print(f"--- {arch} x {shape} x {name}: {status}")
                else:
                    failures.append((arch, shape, mp, status))
                    print(f"!!! FAIL {arch} x {shape} mp={mp}: {status}")
    if args.fits:
        print("\nper-rank bytes (arguments + outputs + temporaries) against "
              f"the card's {RL.HBM_BYTES / 2**30:.0f} GiB:")
        for r in reports:
            print(f"  {r.arch:24s} {r.shape:12s} {r.mesh:8s} "
                  f"{r.bytes_per_device_hbm / 2**30:10.2f} GiB  "
                  f"{'fits' if r.bytes_per_device_hbm <= RL.HBM_BYTES else 'does not fit'}")
    if args.json:
        with open(args.json, "a") as f:
            for r in reports:
                f.write(json.dumps(r.to_json()) + "\n")
    print(f"\n{len(reports)} ok, {len(failures)} failed")
    if failures:
        for arch, shape, mp, status in failures:
            print(f"  {arch} x {shape} x {'2x16x16' if mp else '16x16'}: {status}")
        sys.exit(1)


if __name__ == "__main__":
    main()
