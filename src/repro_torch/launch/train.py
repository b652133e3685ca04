"""SAFL training on the mesh (``torch.distributed``), and the single-host trainer.

Counterpart of ``repro/launch/train.py``: the mesh layout helpers, the
shard-local sketch with its one payload ``all_reduce`` a round, the SAFL
and FedOPT mesh steps (hookless, or with a participation policy), the
scanned driver ``run_mesh_scan`` and the host-loop driver
``run_mesh_host_loop`` in the three topologies, and ``train_loop``.

The FL topology maps onto the mesh (DESIGN §3): one client a (pod, data)
index in ``cross_device`` and ``cross_device_dp``, one a pod in
``cross_silo``.  Every rank runs ``fn(mesh, ...)`` on its own shards
(``launch.mesh.spawn``); a rank's client is the row-major index of its
coordinates over the client axes, the order in which the reference's
``shard_map`` splits the client axis.  One round on each rank:

  1. all-gather its client's weights over the non-client axes (the
     server's downlink; ``models.sharding.gather_tree``);
  2. run ``core.safl.client_deltas`` on its client's full microbatches;
  3. keep the local shard of the delta;
  4. sketch it with the round's operator over the SHARD-LOCAL plan
     (``core.packed.make_sharded_packing_plan``; every model/FSDP shard
     applies the same operator to its own slice, as the reference's
     ``shard_map`` does with a replicated key), so the uplink is ONE
     ``all_reduce`` of the ``(b_total,)`` payload over the client group,
     plus the scalar weight sum under a mask;
  5. desketch locally and step AMSGrad on the local shard.

The server state stays sharded: params, m, v and vhat per ``opt_pspecs``.
FedOPT is the same round with the identity compressor, an O(d)
``all_reduce`` of the raw local delta shard.  The reference computes the
client step with GSPMD over the model and FSDP axes; the port has no
partitioner, so every rank of a client group runs the whole client step on
the gathered weights (its numbers are the unsharded step's, as the
reference's are up to summation order).  Tensor-parallel and FSDP compute
inside the client step (so that no rank holds a whole replica) is left
for later (ROADMAP A-11 step 3); it matters only on more than one card,
and jamba and deepseek-v3 at full width exceed one card even as one block.

The mesh round is a round function of ``launch.driver``: the scanned
driver is ``driver.run_scan`` over it (the port compiles nothing, so a
chunk is the host loop's rounds with the metrics fetched once per chunk)
and the host loop ``driver.run_host_loop``; both give the same bits.
The hooks ``buffer``, ``faults``, ``sentinel``, ``telemetry``, ``stream``,
``microbatch`` and ``codec`` are ROADMAP A-11 step 2 and raise
``NotImplementedError`` here.

Run as a module for a single-host training run:
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --smoke
(on the card; ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import functools
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.core.adaptive import AdaConfig, apply_update
from repro_torch.core.packed import (PackingPlan, derive_round_params,
                                     desk_flat, make_packing_plan,
                                     make_sharded_packing_plan,
                                     shard_local_abstract, sk_packed_clients,
                                     unpack_rows)
from repro_torch.core.safl import (SAFLConfig, _f32, client_deltas,
                                   init_safl, mask_weights, masked_mean,
                                   masked_psum_mean, safl_round)
from repro_torch.core.sketch import (SKETCH_CHUNK_NUMEL, SketchConfig,
                                     desk_leaf, desk_leaf_stacked, leaf_names,
                                     numel, sk_leaf, sk_leaf_stacked)
from repro_torch.data.device import ShardedSampler
from repro_torch.fed.participation import check_policy_clients, is_weighted_mask
from repro_torch.launch.driver import run_host_loop, run_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, loss_fn, param_shapes
from repro_torch.models.sharding import gather_tree, local_shard, param_pspecs

Tree = Mapping[str, torch.Tensor]

TOPOLOGIES = ("cross_device", "cross_device_dp", "cross_silo")

_STEP_2 = ("is ROADMAP A-11 step 2 and not on the port's mesh yet; run the "
           "hook on the single-host driver (launch.driver.run_scan)")


def data_axes_of(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def client_axes_of(mesh, topology: str) -> tuple[str, ...]:
    """Mesh axes that enumerate FL clients.

    cross_device: every (pod, data) index is a client (weights replicated
    over data, sharded over model).  cross_device_dp: the same clients
    with fully replicated weights (the reference runs the client's own
    batch data-parallel over the model axis).  cross_silo: each pod is
    one client (weights FSDP-sharded within the pod) -- the mapping for
    100B+ configs."""
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}; one of {TOPOLOGIES}")
    if topology == "cross_silo":
        return tuple(a for a in ("pod",) if a in mesh.axis_names)
    return data_axes_of(mesh)


def _axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def num_clients_of(mesh, topology: str) -> int:
    return _axes_size(mesh, client_axes_of(mesh, topology))


def _refuse_hooks(**hooks) -> None:
    for name, value in hooks.items():
        if value is not None:
            raise NotImplementedError(f"the mesh hook {name}= {_STEP_2}")


# ---------------------------------------------------------------------------
# shard-local sketch -> ONE b-dim all_reduce -> desk  (the compressed uplink)
# ---------------------------------------------------------------------------

def _collect(s: torch.Tensor, group, n_shards: int, w_loc=None,
             den=None) -> torch.Tensor:
    """The compressed uplink collective over the client group: the mean
    over the client shards (``all_reduce`` then divide by their count)
    when the round has no cohort mask, else the masked cohort mean
    (``core.safl.masked_psum_mean``, one payload ``all_reduce``).  ``s``
    keeps its leading local-client axis either way (one row after
    masking: every rank holds the same cohort mean)."""
    if w_loc is not None:
        return masked_psum_mean(s, w_loc, den, group)
    if group is None:
        return s
    dist.all_reduce(s, group=group)
    return s / n_shards


def _sketch_avg_desk_local(skcfg: SketchConfig, group, n_shards: int,
                           deltas: Tree, key: prng.Key, w_loc=None,
                           den=None) -> dict[str, torch.Tensor]:
    """The per-leaf route, one rank's shards: deltas leaves (G_loc,
    *local_shard).  Leaf i uses the operator of ``fold_in(key, i)``; a
    leaf whose local shard exceeds ``SKETCH_CHUNK_NUMEL`` is sketched per
    slice of its leading (layer-stack) axis (``sk_leaf_stacked``), which
    bounds the hash/sign temporaries to one layer.  Every leaf's payload
    is laid end to end into one buffer, so the uplink is one
    ``all_reduce`` here too.  As in the reference, the local client axis
    is flattened into the leaf, and a cohort mask needs one client row a
    rank."""
    names = leaf_names(deltas)
    if w_loc is not None and deltas[names[0]].shape[0] != 1:
        raise NotImplementedError(
            f"masked per-leaf sketch path needs one client row per rank, got "
            f"G_loc={deltas[names[0]].shape[0]}; use the packed plan route")
    payload, units = [], []
    for i, name in enumerate(names):
        leaf = deltas[name]
        lk = prng.fold_in(key, i)
        lshape = leaf.shape[1:]                    # drop local client dim
        n = numel(lshape)
        n0 = lshape[0] if len(lshape) else 1
        if n > SKETCH_CHUNK_NUMEL and len(lshape) >= 2 and n0 > 1:
            s = sk_leaf_stacked(skcfg, lk, leaf.reshape(n0, n // n0)
                                .to(torch.float32))
            units.append((name, lk, True, n // n0, s.shape))
        else:
            v = leaf.reshape(-1).to(torch.float32)
            s = sk_leaf(skcfg, lk, v)
            units.append((name, lk, False, v.shape[0], s.shape))
        payload.append(s.reshape(-1))
    buf = _collect(torch.cat(payload)[None], group, n_shards, w_loc, den)[0]
    out, off = {}, 0
    for name, lk, stacked, n, shape in units:
        size = numel(shape)
        s = buf[off:off + size].reshape(shape)
        off += size
        u = (desk_leaf_stacked(skcfg, lk, s, n) if stacked
             else desk_leaf(skcfg, lk, s, n))
        out[name] = u.reshape(deltas[name].shape)
    return out


def _sketch_avg_desk_local_packed(plan: PackingPlan, group, n_shards: int,
                                  deltas: Tree, key: prng.Key, w_loc=None,
                                  den=None) -> dict[str, torch.Tensor]:
    """The plan route, one rank's shards: the round's operator is derived
    once over the shard-local ``plan`` (shared by sk and desk; per-leaf
    tags as in the per-leaf route), the local client rows are packed and
    sketched in one pass (B1 for the independent count-sketch with
    kernels), and ONE ``(G_loc, b_total)`` payload crosses the collective
    (one row under a mask).  Returns leaves with a leading row axis."""
    device = next(iter(deltas.values())).device
    rp = derive_round_params(plan, key, device)
    s = sk_packed_clients(plan, rp, deltas)             # (G_loc, b_total)
    s = _collect(s, group, n_shards, w_loc, den)        # <-- the uplink
    u = torch.stack([desk_flat(plan, rp, row) for row in s])
    return unpack_rows(plan, u)


def sharded_sketch_avg_desk(mesh, skcfg: SketchConfig, pspecs, deltas: Tree,
                            key: prng.Key, topology: str = "cross_device",
                            plan: Optional[PackingPlan] = None, part_mask=None,
                            microbatch=None, codec=None) -> dict[str, torch.Tensor]:
    """Sketch each client delta (shard-local), cohort-mean over the client
    group, desketch.

    ``deltas`` leaves are this rank's ``(G_loc, *local_shard)`` blocks:
    its G_loc clients' rows, its shard of each leaf under ``pspecs``.
    Returns this rank's shard of the update.  ``plan`` (the shard-local
    ``PackingPlan`` of ``core.packed.make_sharded_packing_plan``) takes the
    packed route; ``plan=None`` the per-leaf route.  Both give the same
    bits for shards below the layer-chunk threshold.  ``part_mask`` (the
    round's (G,) cohort mask, or the weighted dict) makes the aggregate
    the masked cohort mean, in the same one collective; an all-ones mask
    gives the unmasked bits."""
    _refuse_hooks(microbatch=microbatch, codec=codec)
    caxes = client_axes_of(mesh, topology)
    group, n_shards = mesh.group(caxes), _axes_size(mesh, caxes)
    w_loc = den = None
    if part_mask is not None:
        g_loc = next(iter(deltas.values())).shape[0]
        c = mesh.index_over(caxes)
        w_loc = mask_weights(part_mask)[c * g_loc:(c + 1) * g_loc]
        den = float(part_mask["den"]) if is_weighted_mask(part_mask) else None
    if plan is not None:
        upd = _sketch_avg_desk_local_packed(plan, group, n_shards, deltas, key,
                                            w_loc, den)
    else:
        upd = _sketch_avg_desk_local(skcfg, group, n_shards, deltas, key,
                                     w_loc, den)
    # fold the local client axis (one row when G == #client shards, or
    # under a mask; the mean over the rows otherwise)
    return {k: torch.mean(u, dim=0) for k, u in upd.items()}


# ---------------------------------------------------------------------------
# the round and its step functions
# ---------------------------------------------------------------------------

def client_deltas_sharded(model_cfg: ModelConfig, safl_cfg: SAFLConfig, mesh,
                          topology: str, params: Tree, batch, eta: float,
                          pspecs) -> tuple[dict, torch.Tensor]:
    """This rank's clients' local training: gather the whole weights over
    the non-client axes (the downlink), run K local SGD steps on each of
    the rank's clients' full microbatches, and keep the local shard of
    each delta.  Returns (deltas (G_loc, *local_shard), losses (G_loc,))."""
    full = gather_tree(mesh, params, pspecs)
    deltas, losses = client_deltas(safl_cfg,
                                   lambda p, b: loss_fn(model_cfg, p, b),
                                   full, batch, eta)
    del full
    lead = {k: (None,) + tuple(s) for k, s in pspecs.items()}
    return local_shard(mesh, deltas, lead), losses


def _gather_losses(mesh, topology: str, losses: torch.Tensor) -> torch.Tensor:
    """The (G,) client losses from every rank's (G_loc,) block, in client
    order (a metric, off the uplink)."""
    group = mesh.group(client_axes_of(mesh, topology))
    if group is None:
        return losses
    parts = [torch.empty_like(losses) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, losses.contiguous(), group=group)
    return torch.cat(parts)


def _mesh_pspecs(model_cfg: ModelConfig, topology: str):
    """(abstract params as ``meta`` tensors, their specs) of a topology:
    model-sharded (cross_device), replicated (cross_device_dp), or model-
    and FSDP-sharded (cross_silo)."""
    abstract = {k: torch.empty(s, dtype=model_cfg.dtype, device="meta")
                for k, s in param_shapes(model_cfg).items()}
    if topology == "cross_device_dp":
        pspecs = {k: (None,) * len(p.shape) for k, p in abstract.items()}
    else:
        pspecs = param_pspecs(abstract, fsdp=(topology == "cross_silo"))
    return abstract, pspecs


def _mesh_plan(model_cfg: ModelConfig, safl_cfg: SAFLConfig, mesh,
               topology: str):
    """(abstract, pspecs, plan) for one mesh round family.

    The shard-local ``PackingPlan`` is built once, outside the rounds.
    Models with a local shard above ``SKETCH_CHUNK_NUMEL`` keep the
    per-leaf route (``plan=None``): its layer-chunked sketch bounds the
    operator's temporaries to one layer slice, which the whole-leaf packed
    route would not.  FedOPT (``sketch.kind == "none"``) gets the identity
    plan: its raw local delta shard crosses the same packed collective."""
    abstract, pspecs = _mesh_pspecs(model_cfg, topology)
    sizes = mesh.shape
    if safl_cfg.sketch.kind != "none":
        local = shard_local_abstract(abstract, pspecs, sizes)
        if any(numel(l.shape) > SKETCH_CHUNK_NUMEL for l in local.values()):
            return abstract, pspecs, None
    return abstract, pspecs, make_sharded_packing_plan(safl_cfg.sketch, abstract,
                                                       pspecs, sizes)


def _make_round_core(model_cfg: ModelConfig, safl_cfg: SAFLConfig, mesh,
                     topology: str = "cross_device", *, participation=None,
                     buffer=None, faults=None, sentinel=None, telemetry=None,
                     microbatch=None, codec=None):
    """The SAFL mesh round ``core(params, state, batch, round_key, *,
    part_mask=None) -> (params, state, {"loss": loss})`` on this rank's
    shards (params and state per ``pspecs``/``opt_pspecs``, batch its
    clients' rows): a round function of ``launch.driver``, which draws the
    batch, derives the round key and evaluates the cohort mask.  Returns
    ``(core, pspecs)``.  ``participation`` only checks the policy's client
    count."""
    _refuse_hooks(buffer=buffer, faults=faults, sentinel=sentinel,
                  telemetry=telemetry, microbatch=microbatch, codec=codec)
    _, pspecs, plan = _mesh_plan(model_cfg, safl_cfg, mesh, topology)
    if participation is not None:
        check_policy_clients(participation, num_clients_of(mesh, topology),
                             "mesh driver")
    eta = _f32(safl_cfg.client_lr)

    def core(params, state, batch, key, *, part_mask=None):
        deltas, losses = client_deltas_sharded(
            model_cfg, safl_cfg, mesh, topology, params, batch, eta, pspecs)
        update = sharded_sketch_avg_desk(
            mesh, safl_cfg.sketch, pspecs, deltas, key, topology, plan=plan,
            part_mask=part_mask)
        del deltas
        params, state = apply_update(safl_cfg.server, state, params, update)
        loss = masked_mean(_gather_losses(mesh, topology, losses), part_mask)
        return params, state, {"loss": loss}

    return core, pspecs


def make_safl_train_step(model_cfg: ModelConfig, safl_cfg: SAFLConfig, mesh,
                         topology: str = "cross_device", *,
                         participation=None, buffer=None, faults=None,
                         sentinel=None, telemetry=None, microbatch=None,
                         codec=None):
    """SAFL round on the mesh, on this rank's shards; its batch leaves are
    ``(G_loc, K, mb, ...)``, its clients' rows (``mesh_sampler``).

    The step is the driver's round function ``step(params, state, batch,
    round_key, *, part_mask=None) -> (params, state, {"loss": loss})``:
    ``run_mesh_host_loop`` (``launch.driver.run_host_loop``) feeds it the
    round key ``fold_in(key, t)`` and, under ``participation=``, the
    round's cohort mask, the chain the scanned driver uses.  Returns
    ``(step, pspecs)``."""
    return _make_round_core(model_cfg, safl_cfg, mesh, topology,
                            participation=participation, buffer=buffer,
                            faults=faults, sentinel=sentinel,
                            telemetry=telemetry, microbatch=microbatch,
                            codec=codec)


def _fedopt_cfg(safl_cfg: SAFLConfig) -> SAFLConfig:
    return SAFLConfig(sketch=SketchConfig(kind="none"),
                      server=safl_cfg.server,
                      client_lr=safl_cfg.client_lr,
                      local_steps=safl_cfg.local_steps,
                      remat_local=safl_cfg.remat_local)


def make_fedopt_train_step(model_cfg: ModelConfig, safl_cfg: SAFLConfig, mesh,
                           topology: str = "cross_device", **hooks):
    """Uncompressed FedOPT baseline: raw-delta mean = O(d) all-reduce."""
    return make_safl_train_step(model_cfg, _fedopt_cfg(safl_cfg), mesh,
                                topology, **hooks)


# ---------------------------------------------------------------------------
# the scanned mesh driver
# ---------------------------------------------------------------------------

def mesh_sampler(mesh, sampler, topology: str = "cross_device") -> ShardedSampler:
    """This rank's view of a sampler: its clients' rows of each batch (the
    G clients split evenly over the client shards, row-major)."""
    caxes = client_axes_of(mesh, topology)
    n = _axes_size(mesh, caxes)
    g = sampler.num_clients
    if g % n:
        raise ValueError(f"{g} clients do not split over {n} client shards "
                         f"{caxes}")
    c = mesh.index_over(caxes)
    return ShardedSampler(sampler, c * (g // n), (c + 1) * (g // n))


def make_safl_scan_fn(model_cfg: ModelConfig, safl_cfg: SAFLConfig, mesh,
                      topology: str = "cross_device", *, sampler,
                      num_rounds: int = 0, participation=None, buffer=None,
                      faults=None, sentinel=None, telemetry=None,
                      microbatch=None, codec=None):
    """The scanned mesh driver: ``launch.driver.run_scan`` bound to this
    rank's mesh round, its ``mesh_sampler`` and the cohort policy, in
    chunks of ``num_rounds`` (0 = all in one).  The port compiles nothing,
    so a chunk is the host loop's rounds with the metrics fetched once per
    chunk, and chunked and per-round trajectories are bit-identical.

    Signature of the returned fn: ``(params, opt_state, *, rounds, key,
    start_round=0, on_chunk=None) -> (params, opt_state, history)``.
    Returns ``(run, pspecs)``."""
    core, pspecs = _make_round_core(model_cfg, safl_cfg, mesh, topology,
                                    participation=participation,
                                    buffer=buffer, faults=faults,
                                    sentinel=sentinel, telemetry=telemetry,
                                    microbatch=microbatch, codec=codec)
    return functools.partial(run_scan, core, sampler, chunk_size=num_rounds,
                             participation=participation), pspecs


def make_fedopt_scan_fn(model_cfg: ModelConfig, safl_cfg: SAFLConfig, mesh,
                        topology: str = "cross_device", **kw):
    """Chunked uncompressed FedOPT mesh rounds (``sketch.kind == "none"``:
    the raw-delta O(d) all-reduce in the same layout)."""
    return make_safl_scan_fn(model_cfg, _fedopt_cfg(safl_cfg), mesh,
                             topology, **kw)


def run_mesh_scan(model_cfg: ModelConfig, safl_cfg: SAFLConfig, mesh, sampler,
                  params, opt_state, *, rounds: int, key: prng.Key,
                  topology: str = "cross_device", chunk_size: int = 0,
                  start_round: int = 0, on_chunk=None, participation=None,
                  buffer=None, faults=None, sentinel=None, telemetry=None,
                  stream=None, microbatch=None, codec=None):
    """Run rounds ``start_round .. rounds - 1`` on this rank in chunks of
    ``chunk_size`` (0 = all in one), the metrics fetched to the host once
    per chunk; ``on_chunk(t_done, params, opt_state, chunk_hist)`` runs
    between chunks.  ``params``/``opt_state`` are this rank's shards,
    ``sampler`` its ``mesh_sampler``.  Every per-round stream (data,
    cohorts, sketch operators) is a pure function of the absolute round
    index under ``key``, so a run resumed at ``start_round`` from a
    checkpoint follows the uninterrupted trajectory bit for bit.

    ``participation=`` (a ``fed.participation`` policy) masks the server
    aggregation over each round's cohort; ``None`` is the hookless
    round, and an all-ones mask gives its bits.  ``sketch.kind == "none"``
    is FedOPT.  Returns ``(params, opt_state, history)`` with host
    ``(rounds - start_round,)`` arrays."""
    _refuse_hooks(stream=stream)
    run, _ = make_safl_scan_fn(
        model_cfg, safl_cfg, mesh, topology, sampler=sampler,
        num_rounds=chunk_size, participation=participation, buffer=buffer,
        faults=faults, sentinel=sentinel, telemetry=telemetry,
        microbatch=microbatch, codec=codec)
    return run(params, opt_state, rounds=rounds, key=key,
               start_round=start_round, on_chunk=on_chunk)


def run_mesh_host_loop(step, sampler, params, opt_state, *, rounds: int,
                       key: prng.Key, start_round: int = 0,
                       participation=None, buffer=None, faults=None,
                       sentinel=None):
    """One step call a round (``launch.driver.run_host_loop``), with the
    scanned driver's exact key/batch/cohort sequence, each round's loss
    fetched before the next.  ``step`` comes from ``make_safl_train_step``
    / ``make_fedopt_train_step``, built with the same ``participation``.
    The trajectories agree with ``run_mesh_scan`` bit for bit."""
    _refuse_hooks(buffer=buffer, faults=faults, sentinel=sentinel)
    return run_host_loop(step, sampler, params, opt_state, rounds=rounds,
                         key=key, start_round=start_round,
                         participation=participation)


# ---------------------------------------------------------------------------
# layout records
# ---------------------------------------------------------------------------

def batch_pspecs(batch_tree, mesh, topology: str = "cross_device") -> dict:
    """The reference's train-batch specs, (G, K, mb, ...): G over the
    client axes, mb over data in cross_silo and over model in
    cross_device_dp.  A layout record: every rank of a client group takes
    its client's whole rows here (``mesh_sampler``)."""
    caxes = client_axes_of(mesh, topology)
    lead = (caxes if len(caxes) > 1 else caxes[0]) if caxes else None
    inner = None
    if topology == "cross_silo":
        inner = "data" if "data" in mesh.axis_names else None
    elif topology == "cross_device_dp":
        inner = "model"
    out = {}
    for k, x in batch_tree.items():
        nd = len(x.shape)
        if topology == "cross_device":
            out[k] = (lead,) + (None,) * (nd - 1)
        else:
            out[k] = (lead, None, inner) + (None,) * (nd - 3)
    return out


def opt_pspecs(server: AdaConfig, pspecs) -> dict:
    """The server state's specs: each moment tree laid out as the params."""
    out = {"step": ()}
    for k in ("m", "v", "vhat"):
        if (server.name in ("amsgrad", "adam", "sgdm") and k == "m") or \
           (server.name in ("amsgrad", "adam", "adagrad") and k == "v") or \
           (server.name == "amsgrad" and k == "vhat"):
            out[k] = pspecs
    return out


# ---------------------------------------------------------------------------
# runnable single-host trainer
# ---------------------------------------------------------------------------

def train_loop(model_cfg: ModelConfig, safl_cfg: SAFLConfig, data,
               rounds: int, *, batch_per_client: int = 8, log_every: int = 10,
               seed: int = 0, scan: bool = True, chunk_size: int = 0,
               device="cuda"):
    """SAFL training on synthetic-dataset batches in one process, on
    ``device``.  With ``data.device_sampler`` the run goes through the
    driver's ``run_scan`` (batches drawn on the device, metrics fetched
    once per chunk); otherwise one host batch a round.  Returns
    ``(params, opt_state, [loss per round])``."""
    key = prng.key(seed)
    params = init_params(model_cfg, torch.Generator().manual_seed(seed),
                         device=device)
    opt = init_safl(safl_cfg, params)
    loss = lambda p, b: loss_fn(model_cfg, p, b)
    # static sketch layout built ONCE
    plan = make_packing_plan(safl_cfg.sketch, params)
    round_fn = functools.partial(safl_round, safl_cfg, loss, plan=plan)

    if scan and hasattr(data, "device_sampler"):
        sampler = data.device_sampler(batch_per_client, safl_cfg.local_steps)

        def on_chunk(t_done, _params, _opt, hist):
            if log_every:
                print(f"round {t_done - 1:4d}  loss {hist['loss'][-1]:.4f}")

        params, opt, hist = run_scan(
            round_fn, sampler, params, opt, rounds=rounds, key=key,
            chunk_size=chunk_size or (log_every or rounds), on_chunk=on_chunk)
        return params, opt, [float(x) for x in hist["loss"]]

    history = []
    for t in range(rounds):
        batch = data.round_batch(batch_per_client, safl_cfg.local_steps, t,
                                 device=device)
        params, opt, m = round_fn(params, opt, batch, prng.fold_in(key, t))
        history.append(float(m["loss"]))
        if log_every and (t % log_every == 0 or t == rounds - 1):
            print(f"round {t:4d}  loss {history[-1]:.4f}")
    return params, opt, history


def _main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--sketch", default="countsketch")
    ap.add_argument("--ratio", type=float, default=0.1)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import BigramLMData, LMDataConfig
    cfg = get_config(args.arch, smoke=args.smoke)
    safl = SAFLConfig(
        sketch=SketchConfig(kind=args.sketch, ratio=args.ratio,
                            use_kernels=True),
        server=AdaConfig(name="amsgrad", lr=0.003),
        client_lr=0.05, local_steps=args.local_steps)
    data = BigramLMData(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, num_clients=args.clients))
    return train_loop(cfg, safl, data, args.rounds, device=args.device)


if __name__ == "__main__":
    _main()
