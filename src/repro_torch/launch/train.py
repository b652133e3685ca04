"""SAFL training and serving on the mesh (``torch.distributed``), and the
single-host trainer.

Counterpart of ``repro/launch/train.py``: the mesh layout helpers, the
shard-local sketch with its one payload ``all_reduce`` a round, the SAFL
and FedOPT mesh steps with every federated hook, the scanned driver
``run_mesh_scan`` and the host-loop driver ``run_mesh_host_loop`` in the
three topologies, the serving steps (``make_prefill_step``,
``make_serve_step``: one process, or each rank on its own blocks through
``models.parallel``) with the reference's serving layouts
(``infer_batch_pspecs``, ``cache_pspecs``, ``flat_tp_pspecs``,
``flat_tp_cache_pspecs``), and ``train_loop``.

The FL topology maps onto the mesh (DESIGN §3): the clients are split
row-major over the client axes (the (pod, data) indices in
``cross_device`` and ``cross_device_dp``, the pods in ``cross_silo``), in
the order in which the reference's ``shard_map`` splits the client axis.
The reference's layout is one client a client shard; a mesh round built
with ``num_clients=G`` (the scanned driver takes its sampler's count)
gives each rank G_loc = G / #client shards rows.  Every rank runs
``fn(mesh, ...)`` on its own shards (``launch.mesh.spawn``).  One round
on each rank:

  1. run its clients' K local SGD steps on its own shards
     (``client_deltas_sharded``: ``models.parallel.loss_fn`` under
     ``train_par``, in lockstep with the other ranks of the client group;
     no weight is gathered whole): ``cross_device`` tensor-parallel over
     ``model`` on the client's whole microbatch, ``cross_device_dp`` the
     whole weights on the rank's rows of each microbatch (cut over
     ``model``; the gradients summed over it, one ``all_reduce`` a step),
     ``cross_silo`` tensor-parallel over ``model`` and FSDP over ``data`` on
     the rank's rows (cut over ``data``; FSDP's gather reduce-scatters the
     gradients of the leaves cut over ``data``, one ``all_reduce`` sums the
     rest).  The delta of a leaf is the rank's shard of it;
  2. sketch the deltas with the round's operator over the SHARD-LOCAL plan
     (``core.packed.make_sharded_packing_plan``; every model/FSDP shard
     applies the same operator to its own slice, as the reference's
     ``shard_map`` does with a replicated key), so the uplink is ONE
     ``all_reduce`` of the ``(b_total,)`` payload over the client group,
     plus the scalar weight sum under a mask;
  3. desketch locally and step AMSGrad on the local shard.

The server state stays sharded: params, m, v and vhat per ``opt_pspecs``.
FedOPT is the same round with the identity compressor, an O(d)
``all_reduce`` of the raw local delta shard.  The reference computes the
client step with GSPMD over the model and FSDP axes; the port runs the
collectives of ``models.parallel``'s layers itself (Megatron's pairs:
row-parallel sums, a copy where a replicated tensor enters rank-specific
work, a vocab-parallel cross-entropy).

The hooks act on a rank's own rows and shards, each with the reference's
collectives:

* ``participation=``: the round's (G,) cohort mask, its slice of weights
  fused into the payload ``all_reduce``;
* ``faults=``/``sentinel=`` (the guard, DESIGN §10): each rank corrupts and
  vets its own payload rows (``fed.faults.take_rows``); the sentinel's
  stats cross one ``all_reduce`` over every mesh axis
  (``fed.robust.sentinel_validity``) before the one payload ``all_reduce``;
* ``buffer=`` (``fed.async_buffer.AsyncConfig``): the staleness ring, a
  rank's ``(D, G_loc, b_total)`` block in the round state
  (``init_mesh_async_state``), pushed after the guard, every generation's
  partial sums in one fused ``all_reduce``;
* ``microbatch=``: the streamed fold over chunks of a rank's rows, one
  ``all_reduce`` of the ``(b_total,)`` sum and its weight;
* ``codec=`` (``fed.codec.CodecConfig`` without error feedback): each
  rank's weighted partial sum encoded before the one ``all_reduce``, its
  rounding stream keyed by the client shard's flat index;
* ``telemetry=`` (``obs.Telemetry``): the probes; Δ̄ costs one O(d_local)
  ``all_reduce``, and each norm sums a leaf's squares over the axes that
  shard it (opt-in, as in the reference);
* ``stream=`` (``obs.shards.ShardWriter``): rank 0 writes the shards.

The mesh round is a round function of ``launch.driver``: the scanned
driver is ``driver.run_scan`` over it (the port compiles nothing, so a
chunk is the host loop's rounds with the metrics fetched once per chunk)
and the host loop ``driver.run_host_loop``; both give the same bits.

Run as a module for a single-host training run:
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --smoke
(on the card; ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import functools
import operator
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.core.adaptive import (AdaConfig, apply_update,
                                       init_opt_state)
from repro_torch.core.packed import (PackingPlan, derive_generation_params,
                                     derive_round_params, desk_flat,
                                     make_packing_plan,
                                     make_sharded_packing_plan,
                                     shard_local_abstract, sk_packed_clients,
                                     sk_packed_clients_wsum, unpack_rows,
                                     unpack_tree)
from repro_torch.core.safl import (SAFLConfig, _f32, chunk_clients,
                                   init_safl, mask_weights,
                                   masked_mean, masked_psum_mean,
                                   resolve_microbatch, safl_round, tree_sub)
from repro_torch.core.sketch import (SKETCH_CHUNK_NUMEL, SketchConfig,
                                     desk_leaf, desk_leaf_stacked, leaf_names,
                                     numel, sk_leaf, sk_leaf_stacked)
from repro_torch.data.device import ShardedSampler
from repro_torch.fed.async_buffer import arrival_weight
from repro_torch.fed.codec import encode_decode
from repro_torch.fed.faults import corrupt_payload, n_dropped, take_rows
from repro_torch.fed.participation import check_policy_clients, is_weighted_mask
from repro_torch.fed.robust import (carry_if_empty, divergence_flag,
                                    sentinel_validity, tree_where)
from repro_torch.launch.driver import run_host_loop, run_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models import parallel
from repro_torch.models.model import (_cache_dtype, cache_shapes, decode_step,
                                      forward, init_params, loss_fn, param_shapes)
from repro_torch.models.sharding import _entry_axes, local_shard, param_pspecs
from repro_torch.obs.telemetry import effective_cohort

Tree = Mapping[str, torch.Tensor]

TOPOLOGIES = ("cross_device", "cross_device_dp", "cross_silo")


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


def _round_clients(mesh, topology: str, num_clients: Optional[int]) -> int:
    """The round's client count G: ``num_clients``, or one client a client
    shard (the reference's layout).  G must split evenly over the shards."""
    n = num_clients_of(mesh, topology)
    g = n if num_clients is None else int(num_clients)
    if g < 1 or g % n:
        raise ValueError(f"{g} clients do not split over {n} client shards "
                         f"{client_axes_of(mesh, topology)}")
    return g


def _client_rows(mesh, caxes, g_loc: int, device) -> torch.Tensor:
    """The global indices of this rank's client rows."""
    c = mesh.index_over(caxes)
    return torch.arange(c * g_loc, (c + 1) * g_loc, device=device)


def _rows_of(tree: Tree) -> int:
    return next(iter(tree.values())).shape[0]


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
                                  den=None, mb: Optional[int] = None,
                                  codec=None, cid: int = 0) -> dict[str, torch.Tensor]:
    """The plan route, one rank's shards: the round's operator is derived
    once over the shard-local ``plan`` (shared by sk and desk; per-leaf
    tags as in the per-leaf route), the local client rows are packed and
    sketched in one pass (B1 for the independent count-sketch with
    kernels), and ONE ``(G_loc, b_total)`` payload crosses the collective
    (one row under a mask).  Returns leaves with a leading row axis.

    ``mb`` streams the sketch over chunks of ``mb`` of the rank's rows
    (DESIGN §12): each chunk's weighted sketch sum (B1 at G = mb) folds
    into a running ``(b_total,)`` sum, a short tail chunk padded with
    zero-weight rows, and the sum and its scalar weight cross ONE
    ``all_reduce``.  ``codec`` encodes the rank's weighted partial sum
    right before that one ``all_reduce`` (DESIGN §13), its rounding stream
    keyed by ``cid``, the client shard's flat index, so every model shard
    of a client group draws the same uniforms for its own slice.  Both
    return the cohort mean as one row."""
    device = next(iter(deltas.values())).device
    rp = derive_round_params(plan, key, device)
    if mb is None and codec is None:
        s = sk_packed_clients(plan, rp, deltas)             # (G_loc, b_total)
        s = _collect(s, group, n_shards, w_loc, den)        # <-- the uplink
        u = torch.stack([desk_flat(plan, rp, row) for row in s])
        return unpack_rows(plan, u)
    g_loc = _rows_of(deltas)
    w = (torch.ones(g_loc, dtype=torch.float32, device=device)
         if w_loc is None else w_loc.to(torch.float32))
    if mb is not None:
        n_mb = -(-g_loc // mb)
        pad = n_mb * mb - g_loc
        chunks = chunk_clients(deltas, mb, pad)             # (n_mb, mb, ...)
        wc = torch.cat([w, w.new_zeros(pad)]).reshape(n_mb, mb)  # pads weigh 0
        S = torch.zeros(plan.b_total, dtype=torch.float32, device=device)
        W = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(n_mb):
            dS, dW = sk_packed_clients_wsum(
                plan, rp, {k: v[i] for k, v in chunks.items()}, wc[i])
            S, W = S + dS, W + dW
        del chunks
    else:
        s = sk_packed_clients(plan, rp, deltas).to(torch.float32)
        S, W = torch.sum(s * w[:, None], dim=0), torch.sum(w)
        del s
    if codec is not None:     # encode what the collective moves
        S = encode_decode(codec, key, S[None], client_ids=[cid])[0][0]
    if group is not None:     # <-- the uplink: the sum and its weight
        SW = torch.cat([S, W.reshape(1)])
        dist.all_reduce(SW, group=group)
        S, W = SW[:-1], SW[-1]
    denom = float(den) if den is not None else torch.clamp(W, min=1.0)
    u = desk_flat(plan, rp, S / denom)
    return {k: v[None] for k, v in unpack_tree(plan, u, cast=False).items()}


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
    gives the unmasked bits.

    ``microbatch`` below G_loc streams the sketch over chunks of the
    rank's rows (``None`` or >= G_loc is the materialized path, bit for
    bit); ``codec`` (without error feedback: a rank's payload is a partial
    sum, not a client's) quantizes each rank's partial sum before the one
    collective.  Both need the packed plan."""
    caxes = client_axes_of(mesh, topology)
    group, n_shards = mesh.group(caxes), _axes_size(mesh, caxes)
    g_loc = _rows_of(deltas)
    mb = None
    if microbatch is not None:
        mb = resolve_microbatch(microbatch, g_loc)
        if mb is not None and plan is None:
            raise ValueError(
                "microbatch streaming needs the packed plan route; build one "
                "with make_sharded_packing_plan (the per-leaf route folds the "
                "client axis leaf by leaf and cannot stream)")
    if codec is not None:
        if plan is None:
            raise ValueError("the mesh payload codec needs the packed plan "
                             "route; build one with make_sharded_packing_plan")
        if codec.error_feedback:
            raise ValueError(
                "the mesh uplink quantizes SHARD-LOCAL partial sums; "
                "per-client error feedback does not exist at that "
                "granularity -- use CodecConfig(..., error_feedback=False)")
    w_loc = den = None
    if part_mask is not None:
        c = mesh.index_over(caxes)
        w_loc = mask_weights(part_mask)[c * g_loc:(c + 1) * g_loc]
        den = float(part_mask["den"]) if is_weighted_mask(part_mask) else None
    if plan is not None:
        upd = _sketch_avg_desk_local_packed(plan, group, n_shards, deltas, key,
                                            w_loc, den, mb=mb, codec=codec,
                                            cid=mesh.index_over(caxes))
    else:
        upd = _sketch_avg_desk_local(skcfg, group, n_shards, deltas, key,
                                     w_loc, den)
    # fold the local client axis (one row when G == #client shards, under
    # a mask, streamed or encoded; the mean over the rows otherwise)
    return {k: torch.mean(u, dim=0) for k, u in upd.items()}


def _sharded_sketch_guarded(mesh, plan: PackingPlan, deltas: Tree,
                            key: prng.Key, topology: str, part_mask,
                            fault_spec, sentinel):
    """The compressed uplink with the guard (DESIGN §10) on this rank's
    rows: faults -> sentinels -> cohort mask -> ONE payload ``all_reduce``.

    The (G,) fault spec and mask are the same on every rank; each rank
    corrupts and vets its own payload rows, and the sentinel's verdicts
    cost one more ``all_reduce``, of two (G,) stats arrays over every mesh
    axis (``fed.robust.sentinel_validity``: a client is valid only if
    every model shard of its row is, or the shards would divide by
    different cohort weights).  The weighted local sum then crosses the
    one payload ``all_reduce`` over the client axes.

    Returns ``(update, eff_w (G,), n_rejected)``: the effective weights
    the caller's loss metric and empty-cohort carry read."""
    caxes = client_axes_of(mesh, topology)
    group = mesh.group(caxes)
    g_loc = _rows_of(deltas)
    G = g_loc * _axes_size(mesh, caxes)
    device = next(iter(deltas.values())).device
    w_full = (torch.ones(G, dtype=torch.float32, device=device)
              if part_mask is None else mask_weights(part_mask))
    den = float(part_mask["den"]) if is_weighted_mask(part_mask) else None
    rp = derive_round_params(plan, key, device)
    s = sk_packed_clients(plan, rp, deltas)                 # (G_loc, b_loc)
    rows = _client_rows(mesh, caxes, g_loc, device)
    w_arr = w_full
    if fault_spec is not None:
        s = corrupt_payload(take_rows(fault_spec, rows), s)
        w_arr = w_full * fault_spec["arrive"]
    if sentinel is not None:
        valid, s, n_rej = sentinel_validity(sentinel, s, rows, w_arr, G,
                                            mesh.group(mesh.axis_names))
        w_eff = w_arr * valid.to(torch.float32)
    else:
        n_rej = torch.zeros((), dtype=torch.float32, device=device)
        w_eff = w_arr
    sw = torch.sum(s * w_eff[rows][:, None].to(s.dtype), dim=0)
    if group is not None:
        dist.all_reduce(sw, group=group)          # <-- the ONE payload all_reduce
    if den is not None:       # static Horvitz-Thompson denominator
        mean = sw / den
    else:                     # w_eff is the same on every rank
        mean = sw / torch.clamp(torch.sum(w_eff), min=1.0).to(sw.dtype)
    u = desk_flat(plan, rp, mean)
    return unpack_tree(plan, u, cast=False), w_eff, n_rej


# ---------------------------------------------------------------------------
# the staleness ring on the mesh
# ---------------------------------------------------------------------------

def init_mesh_async_state(model_cfg: ModelConfig, safl_cfg: SAFLConfig, acfg,
                          mesh, params, topology: str = "cross_device",
                          num_clients: Optional[int] = None) -> dict:
    """This rank's round state for ``buffer=acfg``: the server state of its
    ``params`` shards and its block of the staleness ring, the last
    ``D = max_delay + 1`` generations' ``(D, G_loc, b_total)`` payload rows
    of its clients over its shard-local plan, and their ``(D, G_loc)``
    cohort weights."""
    _, _, plan = _mesh_plan(model_cfg, safl_cfg, mesh, topology)
    if safl_cfg.sketch.kind == "none" or plan is None:
        raise ValueError(
            "the mesh staleness buffer stores packed (G, b_total) sketch "
            "payloads: it needs the packed plan route (sketch.kind != "
            "'none' and every local shard <= SKETCH_CHUNK_NUMEL)")
    caxes = client_axes_of(mesh, topology)
    if not caxes:
        raise ValueError("the mesh staleness buffer needs client mesh axes")
    g_loc = _round_clients(mesh, topology, num_clients) // _axes_size(mesh, caxes)
    device = next(iter(params.values())).device
    D = acfg.buffer_rounds
    return {"opt": init_opt_state(safl_cfg.server, params),
            "buf": torch.zeros((D, g_loc, plan.b_total), dtype=torch.float32,
                               device=device),
            "bufw": torch.zeros((D, g_loc), dtype=torch.float32, device=device)}


def sharded_sketch_buffered(mesh, acfg, plan: PackingPlan, deltas: Tree, buf,
                            bufw, round_key: prng.Key, base_key: prng.Key,
                            t: int, topology: str = "cross_device",
                            part_mask=None, fault_spec=None, sentinel=None):
    """The FedBuff-style staleness-buffered uplink on this rank (DESIGN §9).

    Sketch the rank's rows with round t's operator, guard them (faults,
    then sentinels, BEFORE the push: the ring never stores a poisoned row,
    and a dropped or rejected client stores weight 0), push them and their
    weights into slot ``t % D``, recompute every generation's arrivals from
    the delay policy (``fed.async_buffer.arrival_weight``, pure in (g, c,
    seed)), sum each arriving generation in its own sketch space, and send
    every generation's partial sum and weight through ONE fused
    ``all_reduce`` over the client axes.  Each generation is desketched
    with its own operator re-derived from ``fold_in(base_key, g)``
    (``core.packed.derive_generation_params``).  ``delay="zero"`` skips the
    d > 0 generations, so the round is the synchronous masked round.

    Returns ``(update, buf, bufw, W, n_rejected)``: ``W`` the total arrival
    weight (a zero update when 0), ``n_rejected`` None without a guard."""
    if is_weighted_mask(part_mask):
        raise TypeError(
            "the mesh staleness buffer stores 0/1 cohort masks per "
            "generation; weighted (importance-sampling) masks are not "
            "supported -- use a 0/1 participation policy")
    caxes = client_axes_of(mesh, topology)
    if not caxes:
        raise ValueError("the mesh staleness buffer needs client mesh axes")
    group = mesh.group(caxes)
    g_loc = _rows_of(deltas)
    G = g_loc * _axes_size(mesh, caxes)
    D = acfg.buffer_rounds
    device = next(iter(deltas.values())).device
    rp_t = derive_round_params(plan, round_key, device)
    sks = sk_packed_clients(plan, rp_t, deltas).to(torch.float32)  # (G_loc, b_loc)
    rows = _client_rows(mesh, caxes, g_loc, device)
    w_full = (torch.ones(G, dtype=torch.float32, device=device)
              if part_mask is None else part_mask)
    n_rej = None
    if fault_spec is not None or sentinel is not None:
        if fault_spec is not None:
            sks = corrupt_payload(take_rows(fault_spec, rows), sks)
            w_full = w_full * fault_spec["arrive"]
        if sentinel is not None:
            valid, sks, n_rej = sentinel_validity(
                sentinel, sks, rows, w_full, G, mesh.group(mesh.axis_names))
            w_full = w_full * valid.to(torch.float32)
        else:
            n_rej = torch.zeros((), dtype=torch.float32, device=device)
    w_loc = w_full[rows]
    # push: generation t takes slot t % D (its tenant, generation t - D,
    # was fully drained by round t - 1)
    buf, bufw = buf.clone(), bufw.clone()
    buf[t % D] = sks
    bufw[t % D] = w_loc
    # pop: each generation's arrivals summed in its own sketch space; d = 0
    # reads the rows just pushed
    gens, sums, weights = [], [], []
    for d in range(D):
        if acfg.delay == "zero" and d > 0:
            continue                              # no arrival at d > 0
        g = t - d
        payload, w_in = (sks, w_loc) if d == 0 else (buf[g % D], bufw[g % D])
        w = w_in * arrival_weight(acfg, g, d, G, device)[rows]
        gens.append(g)
        sums.append(torch.sum(w[:, None] * payload, dim=0))
        weights.append(torch.sum(w))
    n, b = len(gens), sks.shape[1]
    flat = torch.cat([torch.stack(sums).reshape(-1), torch.stack(weights)])
    del sums
    if group is not None:
        dist.all_reduce(flat, group=group)        # <-- one fused all_reduce
    S, Wd = flat[:n * b].reshape(n, b), flat[n * b:]
    W = torch.sum(Wd)
    W_safe = torch.where(W > 0, W, 1.0)           # no arrival: a zero update
    upd = functools.reduce(operator.add, (
        desk_flat(plan, rp_t if g == t else
                  derive_generation_params(plan, base_key, g, device),
                  S[i] / W_safe)
        for i, g in enumerate(gens)))
    return unpack_tree(plan, upd, cast=False), buf, bufw, W, n_rej


# ---------------------------------------------------------------------------
# telemetry on the mesh
# ---------------------------------------------------------------------------

def _mesh_cohort_mean(mesh, caxes, deltas: Tree, mask, G: int) -> dict:
    """``masked_mean_tree`` of every client's delta, from this rank's rows:
    the local (weighted) sums of every leaf laid end to end cross ONE
    ``all_reduce`` over the client axes (O(d_local)), then divide as
    ``core.safl.masked_mean`` does."""
    names = list(deltas)
    g_loc = _rows_of(deltas)
    w = None
    if mask is not None:
        c = mesh.index_over(caxes)
        w = mask_weights(mask)[c * g_loc:(c + 1) * g_loc]
    parts = []
    for k in names:
        x = deltas[k]
        if w is not None:
            x = x * w.reshape((g_loc,) + (1,) * (x.dim() - 1)).to(x.dtype)
        parts.append(torch.sum(x, dim=0).reshape(-1))
    flat = torch.cat(parts)
    del parts
    group = mesh.group(caxes)
    if group is not None:
        dist.all_reduce(flat, group=group)
    if mask is None:
        flat = flat / G
    elif isinstance(mask, dict):
        flat = flat / float(mask["den"])
    else:
        flat = flat / torch.clamp(torch.sum(mask_weights(mask)), min=1.0)
    out, off = {}, 0
    for k in names:
        shape = deltas[k].shape[1:]
        out[k] = flat[off:off + numel(shape)].reshape(shape)
        off += numel(shape)
    return out


def _mesh_tree_norm(mesh, tree: Tree, pspecs) -> torch.Tensor:
    """The l2 norm of a tree of this rank's shards (float32): each leaf's
    sum of squares is summed over only the axes that shard it (its spec),
    one ``all_reduce`` for each set of such axes, so a replicated leaf
    counts once; then the leaves add in ``obs.telemetry.tree_leaves``'s
    order (paths sorted component by component)."""
    names = sorted(tree, key=lambda k: k.split("/"))
    sq = {k: torch.sum(torch.square(tree[k].to(torch.float32))) for k in names}
    by_axes: dict[tuple, list] = {}
    for k in names:
        axes = tuple(a for e in pspecs[k] for a in _entry_axes(e))
        by_axes.setdefault(tuple(a for a in mesh.axis_names if a in axes),
                           []).append(k)
    for axes, ks in by_axes.items():
        group = mesh.group(axes)
        if group is None:
            continue
        v = torch.stack([sq[k] for k in ks])
        dist.all_reduce(v, group=group)
        sq.update(zip(ks, v))
    return torch.sqrt(sum(sq[k] for k in names))


def _mesh_probes(tel, mesh, topology: str, pspecs, deltas: Tree, update: Tree,
                 mask, state) -> dict:
    """``obs.telemetry.telemetry_probes`` of a mesh round, the same on every
    rank: Δ̄ over all G clients (``_mesh_cohort_mean``), and the norms of
    Δ̄, the update and the server's moments over their shards
    (``_mesh_tree_norm``).  ``mask`` is the round's effective mask."""
    caxes = client_axes_of(mesh, topology)
    G = _rows_of(deltas) * _axes_size(mesh, caxes)
    device = next(iter(deltas.values())).device
    out = {}
    dbar = dn = None
    if tel.delta_norm or tel.residual:
        dbar = _mesh_cohort_mean(mesh, caxes, deltas, mask, G)
        dn = _mesh_tree_norm(mesh, dbar, pspecs)
        if tel.delta_norm:
            out["delta_norm"] = dn
    if tel.update_norm:
        out["update_norm"] = _mesh_tree_norm(mesh, update, pspecs)
    if tel.residual:
        diff = {k: a - update[k].to(torch.float32) for k, a in dbar.items()}
        out["residual"] = (_mesh_tree_norm(mesh, diff, pspecs)
                           / torch.clamp(dn, min=1e-12))
        del diff
    if tel.moments:
        opt = state.get("opt", state)
        for k, name in (("m", "m_norm"), ("v", "v_norm"), ("vhat", "vhat_norm")):
            if k in opt:
                out[name] = _mesh_tree_norm(mesh, opt[k], pspecs)
    if tel.cohort:
        out["cohort"] = effective_cohort(mask, G, device)
    return {k: v.to(torch.float32) for k, v in out.items()}


# ---------------------------------------------------------------------------
# the round and its step functions
# ---------------------------------------------------------------------------

def train_par(model_cfg: ModelConfig, mesh, topology: str, pspecs) -> parallel.Par:
    """The client step's layout on this rank (``models.parallel.Par``):
    ``cross_device`` the weights over ``model`` and the client's whole
    microbatch on every rank of its group; ``cross_device_dp`` the weights
    whole and the microbatch's rows over ``model``; ``cross_silo`` the
    weights over ``model`` and FSDP over ``data``, the rows over ``data``.
    The rows of a microbatch are cut as ``batch_pspecs`` records them."""
    inner = {"cross_device_dp": "model", "cross_silo": "data"}.get(topology)
    return parallel.Par(mesh, model_cfg, pspecs, {},
                        batch_axes=(inner,) if inner in mesh.axis_names else (),
                        fsdp=topology == "cross_silo",
                        replicated=topology == "cross_device_dp")


def _sum_over_batch(par: parallel.Par, names, grads) -> list:
    """The gradients with every leaf not cut over the batch axes summed
    over them, in ONE fused float32 ``all_reduce`` (a leaf no step reads
    has none on any rank); a leaf cut over them has its sum from FSDP's
    reduce-scatter already."""
    group = par.mesh.group(par.batch_axes)
    if group is None:
        return list(grads)
    cut = set(par.batch_axes)
    mine = [i for i, n in enumerate(names)
            if not cut & {a for e in par.pspecs[n] for a in _entry_axes(e)}]
    mine = [i for i in mine if grads[i] is not None]      # the same on every rank
    if not mine:
        return list(grads)
    flat = parallel._reduce_(torch.cat([grads[i].to(torch.float32).reshape(-1)
                                        for i in mine]), group)
    out, off = list(grads), 0
    for i in mine:
        n = grads[i].numel()
        out[i] = flat[off:off + n].reshape(grads[i].shape).to(grads[i].dtype)
        off += n
    return out


def shard_rows(par: parallel.Par, batch: Tree, dim: int) -> dict:
    """The rank's contiguous block of each leaf's rows (dim ``dim``) over
    ``par.batch_axes``, in mesh order; the leaves themselves when the batch
    is not cut.  A count that does not divide raises."""
    if not par.batch_axes:
        return dict(batch)
    spec = (None,) * dim + (_spec_entry(par.batch_axes),)
    return local_shard(par.mesh, batch, {k: spec for k in batch})


def sharded_value_and_grad(par: parallel.Par, params: Tree, batch: Tree, *,
                           remat: bool = True):
    """``parallel.loss_fn``'s value and gradients on the rank's shards and
    rows (each block recomputed in the backward under ``remat``): (the
    client's loss, the same on every rank; the gradients of the rank's
    shards, each summed over the batch axes)."""
    names = list(params)
    leaves = [params[n].detach().requires_grad_(True) for n in names]
    loss, client = parallel.loss_fn(par, dict(zip(names, leaves)), batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return client, dict(zip(names, _sum_over_batch(par, names, grads)))


def _client_delta_sharded(cfg: SAFLConfig, par: parallel.Par, params: Tree,
                          microbatches, eta: float,
                          remat: bool = True) -> tuple[dict, torch.Tensor]:
    """``core.safl.client_delta`` on the rank's shards and rows: K local SGD
    steps of ``sharded_value_and_grad``; returns (the shard's x_0 - x_K,
    the client's mean loss)."""
    p = dict(params)
    losses = []
    for k in range(next(iter(microbatches.values())).shape[0]):
        loss, grads = sharded_value_and_grad(
            par, p, {key: v[k] for key, v in microbatches.items()}, remat=remat)
        with torch.no_grad():
            p = {n: x if grads[n] is None else
                 (x.to(torch.float32) - eta * grads[n].to(torch.float32)).to(x.dtype)
                 for n, x in p.items()}
        losses.append(loss)
    with torch.no_grad():
        return tree_sub(params, p), torch.mean(torch.stack(losses))


def client_deltas_sharded(model_cfg: ModelConfig, safl_cfg: SAFLConfig, mesh,
                          topology: str, params: Tree, batch, eta: float,
                          pspecs, *, remat: bool = True) -> tuple[dict, torch.Tensor]:
    """This rank's clients' local training on its own shards
    (``models.parallel.loss_fn`` under ``train_par``): K local SGD steps
    of each of the rank's clients, in lockstep with its client group, on
    the rank's rows of each microbatch; no weight is gathered whole.  The
    delta of a leaf is the rank's shard itself.  ``remat`` (the
    reference's default, on) recomputes each block in the backward.
    Returns (deltas (G_loc, *local_shard), losses (G_loc,): each client's
    loss, the same on every rank of its group)."""
    par = train_par(model_cfg, mesh, topology, pspecs)
    batch = shard_rows(par, batch, 2)
    deltas, losses = [], []
    for c in range(_rows_of(batch)):
        d, l = _client_delta_sharded(safl_cfg, par, params,
                                     {k: v[c] for k, v in batch.items()}, eta, remat)
        deltas.append(d)
        losses.append(l)
    return ({k: torch.stack([d[k] for d in deltas]) for k in params},
            torch.stack(losses))


def _sync_copies(mesh, topology: str, pspecs, trees: list) -> None:
    """Give every copy of a leaf replicated over a non-client axis that cuts
    other leaves the value of its group's first member, in place: one
    ``broadcast`` of the leaves' bytes for each set of such axes.  A codec
    round scales each shard's partial sum by its own range, so the copies
    of a replicated leaf drift apart over the shards that hold other
    slices; the reference declares the leaf replicated and its host reads
    the first device's copy.  The client step computes one model from the
    copies it holds, so they must agree."""
    cut = {a for spec in pspecs.values() for e in spec for a in _entry_axes(e)}
    cut -= set(client_axes_of(mesh, topology))
    by_axes: dict[tuple, list] = {}
    for k, spec in pspecs.items():
        own = {a for e in spec for a in _entry_axes(e)}
        axes = tuple(a for a in mesh.axis_names if a in cut and a not in own)
        if mesh.group(axes) is not None:
            by_axes.setdefault(axes, []).append(k)
    for axes, ks in by_axes.items():
        leaves = [t[k] for t in trees for k in ks]
        flat = torch.cat([x.contiguous().view(torch.uint8).reshape(-1) for x in leaves])
        dist.broadcast(flat, src=mesh.ranks_over(axes)[0], group=mesh.group(axes))
        off = 0
        for x in leaves:
            n = x.numel() * x.element_size()
            x.copy_(flat[off:off + n].view(x.dtype).reshape(x.shape))
            off += n


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
    abstract = _meta_params(model_cfg)
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


def _check_hooks(safl_cfg: SAFLConfig, plan, G: int, *, participation, buffer,
                 faults, sentinel, telemetry, microbatch, codec) -> None:
    """The reference's hook matrix, in its order and with its exception
    types: the codec and the streamed fold run only on plain sketched
    rounds, the guard and the ring need the packed plan, and every client
    count must be the round's."""
    sketched = safl_cfg.sketch.kind != "none"
    guarded = faults is not None or sentinel is not None
    if codec is not None:
        if buffer is not None or guarded:
            raise NotImplementedError(
                "the mesh payload codec quantizes shard-local partial sums; "
                "the staleness buffer and the fault/sentinel guard operate on "
                "materialized per-client payload rows -- run those hooks "
                "without codec=")
        if telemetry is not None:
            raise ValueError("telemetry probes read the unquantized delta "
                             "tree; drop telemetry= or codec=")
        if not sketched:
            raise ValueError(
                "the payload codec quantizes the packed sketch uplink; "
                "fedopt (sketch.kind='none') has no sketch payload")
        if plan is None:
            raise ValueError("the mesh payload codec needs the packed plan "
                             "route (every local shard <= SKETCH_CHUNK_NUMEL)")
        if codec.error_feedback:
            raise ValueError(
                "the mesh uplink quantizes SHARD-LOCAL partial sums; "
                "per-client error feedback does not exist at that "
                "granularity -- use CodecConfig(..., error_feedback=False)")
    if microbatch is not None:
        resolve_microbatch(microbatch, G)       # rejects mb <= 0 at build time
        if buffer is not None or guarded:
            raise NotImplementedError(
                "mesh microbatch streaming folds the payload before any "
                "per-client row exists; the staleness buffer and the "
                "fault/sentinel guard operate on materialized payload rows "
                "-- run those hooks without microbatch=")
        if telemetry is not None:
            raise ValueError("telemetry probes read the materialized cohort "
                             "delta tree; drop telemetry= or microbatch=")
        if not sketched:
            raise ValueError(
                "mesh microbatch streaming folds in sketch space; fedopt "
                "(sketch.kind='none') has no sketch payload")
        if plan is None:
            raise ValueError("mesh microbatch streaming needs the packed plan "
                             "route (every local shard <= SKETCH_CHUNK_NUMEL)")
    if participation is not None:
        check_policy_clients(participation, G, "mesh driver")
    if guarded:
        if not sketched:
            raise ValueError(
                "fault injection / payload sentinels act on the packed sketch "
                "uplink; fedopt (sketch.kind='none') has no sketch payload")
        if plan is None:
            raise ValueError("the mesh fault/sentinel hooks need the packed "
                             "plan route (every local shard <= "
                             "SKETCH_CHUNK_NUMEL)")
        if faults is not None and faults.num_clients != G:
            raise ValueError(f"fault policy covers {faults.num_clients} "
                             f"clients, the mesh topology has {G}")
    if buffer is not None:
        if not sketched:
            raise ValueError("the staleness buffer aggregates in sketch "
                             "space; fedopt (sketch.kind='none') cannot ride it")
        if plan is None:
            raise ValueError("the mesh staleness buffer needs the packed plan "
                             "route (every local shard <= SKETCH_CHUNK_NUMEL)")


def _make_round_core(model_cfg: ModelConfig, safl_cfg: SAFLConfig, mesh,
                     topology: str = "cross_device", *, participation=None,
                     buffer=None, faults=None, sentinel=None, telemetry=None,
                     microbatch=None, codec=None,
                     num_clients: Optional[int] = None):
    """The SAFL mesh round ``core(params, state, batch, round_key, *, t=None,
    base_key=None, part_mask=None, fault_spec=None) -> (params, state,
    metrics)`` on this rank's shards (params and state per
    ``pspecs``/``opt_pspecs``, batch its clients' rows): a round function
    of ``launch.driver``, which draws the batch, derives the round key and
    evaluates the cohort mask, the fault spec and, under ``buffer=``, hands
    in ``t`` and the base key.  Returns ``(core, pspecs)``.

    The metrics are the loss, and: ``n_rejected``, ``n_dropped`` (with
    ``faults``) and ``diverged`` (with ``sentinel``) from a guarded round;
    ``arrival_weight`` from a buffered one (the state is then
    ``init_mesh_async_state``'s dict); ``uplink_bits`` from a codec round,
    the measured size of one encoded ``(b_total,)`` row a client shard;
    the probes with ``telemetry``.  A guarded round with no surviving
    client, or a guarded buffered round with no arrival, carries the
    server through.  ``num_clients`` is G (default one client a client
    shard); every hook combination the reference rejects raises here, at
    build time."""
    _, pspecs, plan = _mesh_plan(model_cfg, safl_cfg, mesh, topology)
    G = _round_clients(mesh, topology, num_clients)
    _check_hooks(safl_cfg, plan, G, participation=participation,
                 buffer=buffer, faults=faults, sentinel=sentinel,
                 telemetry=telemetry, microbatch=microbatch, codec=codec)
    guarded = faults is not None or sentinel is not None
    eta = _f32(safl_cfg.client_lr)
    n_shards = num_clients_of(mesh, topology)
    server = safl_cfg.server

    def probes(metrics, deltas, update, state, mask):
        if telemetry is None:
            return metrics
        return {**metrics, **_mesh_probes(telemetry, mesh, topology, pspecs,
                                          deltas, update, mask, state)}

    def core(params, state, batch, key, *, t=None, base_key=None,
             part_mask=None, fault_spec=None):
        if _rows_of(batch) * n_shards != G:
            raise ValueError(
                f"the batch holds {_rows_of(batch)} clients a rank on "
                f"{n_shards} client shards; the round was built for {G} "
                f"(num_clients=)")
        deltas, losses = client_deltas_sharded(
            model_cfg, safl_cfg, mesh, topology, params, batch, eta, pspecs)
        losses = _gather_losses(mesh, topology, losses)
        kept = deltas if telemetry is not None else None
        if buffer is not None:
            update, buf, bufw, W, n_rej = sharded_sketch_buffered(
                mesh, buffer, plan, deltas, state["buf"], state["bufw"], key,
                base_key, t, topology, part_mask=part_mask,
                fault_spec=fault_spec, sentinel=sentinel)
            del deltas
            new_params, opt = apply_update(server, state["opt"], params, update)
            loss = masked_mean(losses, part_mask)
            metrics = {"loss": loss, "arrival_weight": W}
            if guarded:
                metrics["n_rejected"] = n_rej
            if fault_spec is not None:
                metrics["n_dropped"] = n_dropped(fault_spec, part_mask)
            if sentinel is not None:
                # a round with no arrival carries the server through
                new_params, opt = tree_where(W > 0, (new_params, opt),
                                             (params, state["opt"]))
                metrics["diverged"] = divergence_flag(sentinel, loss)
            new_state = {"opt": opt, "buf": buf, "bufw": bufw}
            return new_params, new_state, probes(metrics, kept, update,
                                                 new_state, part_mask)
        if guarded:
            update, eff_w, n_rej = _sharded_sketch_guarded(
                mesh, plan, deltas, key, topology, part_mask, fault_spec,
                sentinel)
            del deltas
            eff_mask = ({**part_mask, "w": eff_w}
                        if is_weighted_mask(part_mask) else eff_w)
            new_params, new_state = apply_update(server, state, params, update)
            loss = masked_mean(losses, eff_mask)
            metrics = {"loss": loss, "n_rejected": n_rej}
            if fault_spec is not None:
                metrics["n_dropped"] = n_dropped(fault_spec, part_mask)
            if sentinel is not None:
                new_params, new_state = carry_if_empty(
                    eff_mask, (new_params, new_state), (params, state))
                metrics["diverged"] = divergence_flag(sentinel, loss)
            return new_params, new_state, probes(metrics, kept, update,
                                                 new_state, eff_mask)
        update = sharded_sketch_avg_desk(
            mesh, safl_cfg.sketch, pspecs, deltas, key, topology, plan=plan,
            part_mask=part_mask, microbatch=microbatch, codec=codec)
        del deltas
        params, state = apply_update(server, state, params, update)
        metrics = {"loss": masked_mean(losses, part_mask)}
        if codec is not None:
            _sync_copies(mesh, topology, pspecs,
                         [params] + [state[m] for m in ("m", "v", "vhat") if m in state])
            # the measured wire size: one encoded (b_total,) partial sum a
            # client shard crosses the collective, whatever the mask
            metrics["uplink_bits"] = torch.tensor(
                float(codec.payload_bits(plan.b_total) * n_shards),
                dtype=torch.float32, device=metrics["loss"].device)
        return params, state, probes(metrics, kept, update, state, part_mask)

    return core, pspecs


def make_safl_train_step(model_cfg: ModelConfig, safl_cfg: SAFLConfig, mesh,
                         topology: str = "cross_device", *,
                         participation=None, buffer=None, faults=None,
                         sentinel=None, telemetry=None, microbatch=None,
                         codec=None, num_clients: Optional[int] = None):
    """SAFL round on the mesh, on this rank's shards; its batch leaves are
    ``(G_loc, K, mb, ...)``, its clients' rows (``mesh_sampler``).

    The step is the driver's round function ``step(params, state, batch,
    round_key, *, t=None, base_key=None, part_mask=None, fault_spec=None)
    -> (params, state, metrics)`` (``_make_round_core``):
    ``run_mesh_host_loop`` (``launch.driver.run_host_loop``) feeds it the
    round key ``fold_in(key, t)`` and the hooks' arguments, the chain the
    scanned driver uses, when given the same ``participation``,
    ``buffer`` and ``faults``.  Returns ``(step, pspecs)``."""
    return _make_round_core(model_cfg, safl_cfg, mesh, topology,
                            participation=participation, buffer=buffer,
                            faults=faults, sentinel=sentinel,
                            telemetry=telemetry, microbatch=microbatch,
                            codec=codec, num_clients=num_clients)


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
    rank's mesh round, its ``mesh_sampler``, the cohort policy, the fault
    policy and the ring's ``t``/base key (``buffer``), in chunks of
    ``num_rounds`` (0 = all in one).  The port compiles nothing, so a
    chunk is the host loop's rounds with the metrics fetched once per
    chunk, and chunked and per-round trajectories are bit-identical.  The
    round's G is the sampler's ``num_clients`` (one client a client shard
    when it has none).

    Signature of the returned fn: ``(params, opt_state, *, rounds, key,
    start_round=0, on_chunk=None, stream=None) -> (params, opt_state,
    history)``.  Returns ``(run, pspecs)``."""
    core, pspecs = _make_round_core(
        model_cfg, safl_cfg, mesh, topology, participation=participation,
        buffer=buffer, faults=faults, sentinel=sentinel, telemetry=telemetry,
        microbatch=microbatch, codec=codec,
        num_clients=getattr(sampler, "num_clients", None))
    return functools.partial(run_scan, core, sampler, chunk_size=num_rounds,
                             participation=participation,
                             buffer=buffer is not None, faults=faults), pspecs


def make_fedopt_scan_fn(model_cfg: ModelConfig, safl_cfg: SAFLConfig, mesh,
                        topology: str = "cross_device", **kw):
    """Chunked uncompressed FedOPT mesh rounds (``sketch.kind == "none"``:
    the raw-delta O(d) all-reduce in the same layout)."""
    return make_safl_scan_fn(model_cfg, _fedopt_cfg(safl_cfg), mesh,
                             topology, **kw)


class _NoStream:
    """The ``stream=`` of a rank other than 0: takes every chunk and span
    and writes nothing."""

    def write_chunk(self, t0: int, hist: dict) -> str:
        return ""

    def write_span(self, *args, **kwargs) -> None:
        pass


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
    cohorts, faults, delays, sketch operators) is a pure function of the
    absolute round index under ``key``, so a run resumed at
    ``start_round`` from a checkpoint follows the uninterrupted trajectory
    bit for bit.

    The hooks, as in the reference: ``participation=`` (a
    ``fed.participation`` policy; ``None`` is the hookless round and an
    all-ones mask gives its bits), ``buffer=`` (``opt_state`` is then
    ``init_mesh_async_state``'s dict; a ``delay="zero"`` buffer gives the
    hookless bits), ``faults=``/``sentinel=`` (counters beside the loss; a
    neutral fault policy gives the hookless bits), ``telemetry=``,
    ``microbatch=`` (``None`` or >= G_loc is the materialized round, bit
    for bit), ``codec=`` (its measured ``uplink_bits``), and ``stream=``
    (an ``obs.shards.ShardWriter``: rank 0 writes each chunk's metrics
    shard and span, the other ranks write nothing, and every rank returns
    ``history == {}``; parameters and state are the unstreamed run's, bit
    for bit).  ``sketch.kind == "none"`` is FedOPT.  Returns ``(params,
    opt_state, history)`` with host ``(rounds - start_round,)`` arrays."""
    if stream is not None and mesh.rank != 0:
        stream = _NoStream()
    run, _ = make_safl_scan_fn(
        model_cfg, safl_cfg, mesh, topology, sampler=sampler,
        num_rounds=chunk_size, participation=participation, buffer=buffer,
        faults=faults, sentinel=sentinel, telemetry=telemetry,
        microbatch=microbatch, codec=codec)
    return run(params, opt_state, rounds=rounds, key=key,
               start_round=start_round, on_chunk=on_chunk, stream=stream)


def run_mesh_host_loop(step, sampler, params, opt_state, *, rounds: int,
                       key: prng.Key, start_round: int = 0,
                       participation=None, buffer=None, faults=None,
                       sentinel=None):
    """One step call a round (``launch.driver.run_host_loop``), with the
    scanned driver's exact key/batch/cohort/fault sequence, each round's
    metrics fetched before the next.  ``step`` comes from
    ``make_safl_train_step`` / ``make_fedopt_train_step``, built with the
    same hooks (the sentinel is bound into it; ``buffer`` hands the step
    ``t`` and the base key).  The trajectories agree with
    ``run_mesh_scan`` bit for bit."""
    del sentinel
    return run_host_loop(step, sampler, params, opt_state, rounds=rounds,
                         key=key, start_round=start_round,
                         participation=participation,
                         buffer=buffer is not None, faults=faults)


# ---------------------------------------------------------------------------
# serving steps: one process, or each rank on its own shards
# ---------------------------------------------------------------------------

def _spec_entry(axes):
    """A spec entry for a dim cut over ``axes``: the name, a tuple of two
    or more names, or None (as a ``PartitionSpec`` reads back)."""
    axes = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
    axes = tuple(a for a in axes if a is not None)
    return (axes[0] if len(axes) == 1 else axes) if axes else None


def _meta_params(model_cfg: ModelConfig) -> dict:
    return {k: torch.empty(s, dtype=model_cfg.dtype, device="meta")
            for k, s in param_shapes(model_cfg).items()}


def _meta_cache(model_cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    return {k: torch.empty(s, dtype=_cache_dtype(model_cfg, k), device="meta")
            for k, s in cache_shapes(model_cfg, batch, max_seq).items()}


def make_prefill_step(model_cfg: ModelConfig, mesh=None, *, fsdp: bool = False,
                      batch: Optional[int] = None):
    """The prefill step: ``forward`` with ``remat=False``, as the
    reference's (nothing is differentiated), then the last token's logits
    through the tied or untied head, (B, padded vocab).

    With a live ``mesh`` (``batch``: the global batch size), the step
    ``step(local_params, local_batch)`` runs ``models.parallel.forward`` on
    the rank's blocks under ``param_pspecs(fsdp=fsdp)`` and its rows of
    the batch (``infer_batch_pspecs``), and returns its (B_loc, V_loc)
    block, the reference's ``out_shardings=P(daxes, "model")``.  The
    step's ``par`` holds its layout (``par.pspecs`` for ``local_shard``)."""
    if mesh is None:
        def step(params, batch):
            h, _ = forward(model_cfg, params, batch, remat=False)
            head = (params["embed"].T if model_cfg.tie_embeddings
                    else params["lm_head"])
            return h[:, -1] @ head                  # (B, V) last-token logits
        return step
    daxes = data_axes_of(mesh)
    tokens = torch.empty((int(batch), 1), device="meta")
    bspec = infer_batch_pspecs({"tokens": tokens}, daxes, mesh)["tokens"]
    par = parallel.Par(mesh, model_cfg, param_pspecs(_meta_params(model_cfg), fsdp=fsdp),
                       {}, batch_axes=_entry_axes(bspec[0]), fsdp=fsdp)

    def step(local_params, local_batch):
        return parallel.prefill_logits(par, local_params, local_batch)
    step.par = par
    return step


SERVE_LAYOUTS = ("default", "flat")      # dryrun's --serve-layout


def serve_specs(model_cfg: ModelConfig, mesh, batch: int, max_seq: int, *,
                layout: str = "default", fsdp: bool = False) -> tuple:
    """(weights' specs, cache's specs, tokens' spec) of a decode layout, as
    ``launch/dryrun.py`` lays the serve step out: ``param_pspecs`` with
    the cache over ``cache_pspecs`` (the tokens' batch over the data axes
    where it divides), or ``flat_tp_pspecs`` with ``flat_tp_cache_pspecs``.
    Under the flat layout every rank takes the whole (B, 1) tokens: the
    cache's batch is replicated (the reference hands GSPMD batch-sharded
    tokens and its partitioner gathers them)."""
    if layout not in SERVE_LAYOUTS:
        raise ValueError(f"unknown serve layout {layout!r}; one of {SERVE_LAYOUTS}")
    pspecs = param_pspecs(_meta_params(model_cfg), fsdp=fsdp)
    cache = _meta_cache(model_cfg, batch, max_seq)
    if layout == "flat":
        return (flat_tp_pspecs(pspecs), flat_tp_cache_pspecs(cache, mesh),
                (None, None))
    daxes = data_axes_of(mesh)
    tok = _spec_entry(daxes) if batch % _axes_size(mesh, daxes) == 0 else None
    return pspecs, cache_pspecs(cache, daxes, mesh), (tok, None)


def make_serve_step(model_cfg: ModelConfig, mesh=None, *, layout: str = "default",
                    fsdp: bool = False, batch: Optional[int] = None,
                    max_seq: Optional[int] = None):
    """The decode step ``step(params, cache, tokens, pos)``: the port's
    ``decode_step``.

    With a live ``mesh`` (``batch``, ``max_seq``: the global batch and
    cache length the layout is cut for), the step
    ``step(local_params, local_cache, local_tokens, pos)`` runs
    ``models.parallel.decode_step`` on the rank's blocks under
    ``serve_specs(layout=, fsdp=)`` and returns (its rows of the logits,
    every column; its cache blocks, written in place).  The step's ``par``
    holds the layout: ``par.pspecs``/``par.cspecs`` for ``local_shard``,
    and ``parallel.encode_for_decode(step.par, ...)`` fills an
    encoder-decoder's cross-attention blocks."""
    if mesh is None:
        def step(params, cache, tokens, pos):
            return decode_step(model_cfg, params, cache, tokens, pos)
        return step
    pspecs, cspecs, tspec = serve_specs(model_cfg, mesh, int(batch), int(max_seq),
                                        layout=layout, fsdp=fsdp)
    par = parallel.Par(mesh, model_cfg, pspecs, cspecs,
                       batch_axes=_entry_axes(tspec[0]), flat=layout == "flat",
                       fsdp=fsdp)

    def step(local_params, local_cache, local_tokens, pos):
        return parallel.decode_step(par, local_params, local_cache, local_tokens, pos)
    step.par = par
    return step


# ---------------------------------------------------------------------------
# layout records
# ---------------------------------------------------------------------------

def batch_pspecs(batch_tree, mesh, topology: str = "cross_device") -> dict:
    """The reference's train-batch specs, (G, K, mb, ...): G over the
    client axes, mb over data in cross_silo and over model in
    cross_device_dp.  The sampler hands every rank of a client group its
    client's whole rows (``mesh_sampler``); the client step takes the
    rank's block of mb (``shard_rows`` under ``train_par``)."""
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


def infer_batch_pspecs(batch_tree, data_axes, mesh=None) -> dict:
    """Inference batch: leading batch dim over (pod, data); left replicated
    when the batch does not divide the axes (e.g. long_500k with B=1)."""
    out = {}
    for k, x in batch_tree.items():
        axes = _spec_entry(data_axes)
        if mesh is not None and x.shape[0] % _axes_size(mesh, data_axes):
            axes = None
        out[k] = (axes,) + (None,) * (len(x.shape) - 1)
    return out


def _fit(spec: tuple, shape, mesh) -> tuple:
    """Drop the axes of any entry whose dim they do not divide (e.g.
    whisper's 1500-frame cross cache on a 16-way model axis)."""
    if mesh is None:
        return spec
    return tuple(None if e is None or d % _axes_size(mesh, _entry_axes(e)) else e
                 for d, e in zip(shape, spec))


def cache_pspecs(cache_tree, data_axes, mesh=None) -> dict:
    """KV caches are sequence-sharded over the model axis (flash-decoding
    style partial softmax); SSM state shards d_inner.  The batch dim falls
    back to replicated when it does not divide the data axes.  k/v/xk/xv
    (nb, B, S, Hk, hd) and ckv/kpe (nb, B, S, r) cut S, Mamba's h (nb, B,
    di, ds) dim 2, its conv (nb, B, kw - 1, di) dim 3."""
    out = {}
    for path, leaf in cache_tree.items():
        name = path.rpartition("/")[2]
        nd = len(leaf.shape)
        baxes = _spec_entry(data_axes)
        if mesh is not None and leaf.shape[1] % _axes_size(mesh, data_axes):
            baxes = None
        if name in ("k", "v", "xk", "xv"):
            sp = (None, baxes, "model", None, None)
        elif name in ("ckv", "kpe", "h"):
            sp = (None, baxes, "model", None)
        elif name == "conv":
            sp = (None, baxes, None, "model")
        else:
            sp = (None,) * nd
        out[path] = _fit(sp[:nd], leaf.shape, mesh)
    return out


# the weights the flat layout cuts on their contracting dim
_FLAT_W = {"wq", "wk", "wv", "wo", "wi", "wg", "w_dq", "w_uq", "w_dkv",
           "w_kr", "w_uk", "w_uv", "lm_head", "mtp_head", "router",
           "x_proj", "dt_proj", "out_proj", "wx", "wz"}
_FLAT_TP = ("data", "model")


def flat_tp_pspecs(pspecs, params_abs=None) -> dict:
    """Beyond-paper serving layout: fold the data axis into the model axis
    (pure TP over data x model), sharding every weight's CONTRACTING
    (input) dim, so the weights stay resident and the cache sequence-
    sharded; every matmul sums its (batch x features) decode activation.
    Stacked MoE experts (nb, E, in, out) are cut over E, the embedding
    over V; the rest is replicated."""
    out = {}
    for path, p in pspecs.items():
        parts = path.split("/")
        name, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
        nd = len(p)
        if name in ("wi", "wg", "wo") and parent == "moe" and nd >= 3:
            out[path] = (None,) * (nd - 3) + (_FLAT_TP, None, None)
        elif name == "embed":
            out[path] = (_FLAT_TP, None)
        elif name in _FLAT_W and nd >= 2:
            out[path] = (None,) * (nd - 2) + (_FLAT_TP, None)
        else:
            out[path] = (None,) * nd
    return out


def flat_tp_cache_pspecs(cache_tree, mesh=None) -> dict:
    """Cache layout for flat-TP serving: sequence dim over (data, model),
    batch replicated."""
    out = {}
    for path, leaf in cache_tree.items():
        name = path.rpartition("/")[2]
        nd = len(leaf.shape)
        if name in ("k", "v", "xk", "xv"):
            sp = (None, None, _FLAT_TP, None, None)
        elif name in ("ckv", "kpe", "h"):
            sp = (None, None, _FLAT_TP, None)
        elif name == "conv":
            sp = (None, None, None, _FLAT_TP)
        else:
            sp = (None,) * nd
        out[path] = _fit(sp[:nd], leaf.shape, mesh)
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


# The reference's ``to_shardings(mesh, pspec_tree)`` wraps each spec in a
# ``NamedSharding`` for ``jax.jit``; a rank places a tree under a spec tree
# itself: ``models.sharding.local_shard(mesh, tree, specs)``.


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
