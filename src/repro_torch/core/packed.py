"""Packed sketch engine: the whole tree sketched as one contiguous buffer.

Counterpart of ``repro/core/packed.py``.  ``PackingPlan`` lays every leaf's
flat vector into one ``(d_total,)`` buffer and every leaf's sketch into one
``(b_total,)`` payload; ``derive_round_params`` derives the round's hashes,
signs and SRHT parameters once, for sk and desk; ``sk_flat``/``desk_flat``
sketch and desketch the packed buffers.  Leaf tags and offsets follow
jax's ``tree_flatten`` order (``sketch.leaf_names``), so the payload of the
port and the payload of the reference line up slot for slot.

The independent count-sketch family collapses the tree to one segment sum
over a global hash (leaf-local slot plus the leaf's payload offset); with
``use_kernels`` the G clients' uplink is one launch of the batched
count-sketch kernel (``sk_packed_clients``).  The Gaussian family's round
parameters are the ops' keys; its R chunks are drawn in sk and desk.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch

from repro_torch import prng
from repro_torch.core.sketch import (SketchConfig, _balanced_cs_params,
                                     _balanced_desk_core, _balanced_sk_core,
                                     _cs_hashes, _gaussian_desk, _gaussian_sk,
                                     _keys, _srht_params, f32_sqrt, fwht,
                                     leaf_names, leaf_sketch_size, next_pow2,
                                     numel, scatter_add)
from repro_torch.kernels import ops as kops

Tree = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Static layout of one leaf inside the packed (d_total,) buffer."""
    name: str
    shape: tuple[int, ...]
    dtype: Any
    n: int
    in_off: int


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One sketch unit: a leaf (per_tensor) or the whole packed vector
    (concat).  ``raw`` units are transmitted uncompressed (b == n)."""
    index: int                 # position in op/payload order
    in_off: int                # offset into the packed input buffer
    n: int                     # input length
    b: int                     # payload slots (== n when raw)
    pay_off: int               # offset into the packed payload
    raw: bool
    tag: Optional[int]         # fold_in tag (leaf index); None -> round key
    n2: int                    # next_pow2(n), used by srht


@dataclasses.dataclass(frozen=True)
class PackingPlan:
    """Static packing of a tree under one SketchConfig, shared by every
    round.  ``b_total`` is the uplink payload length in slots."""
    cfg: SketchConfig
    leaves: tuple[LeafSpec, ...]
    ops: tuple[OpSpec, ...]
    d_total: int
    b_total: int

    @property
    def all_raw(self) -> bool:
        return all(op.raw for op in self.ops)


def shard_local_abstract(tree: Mapping[str, Any], pspecs: Mapping[str, tuple],
                         axis_sizes: Mapping[str, int]) -> dict[str, torch.Tensor]:
    """A rank's local shard shapes of ``tree`` under ``pspecs``, as tensors
    on the ``meta`` device (shape and dtype, no storage).

    ``axis_sizes`` maps mesh axis name -> size (``mesh.shape``).  Dim i of
    a leaf is the global dim divided by the product of the mesh axes
    sharding it; every sharded dim must divide evenly."""
    out = {}
    for name, leaf in tree.items():
        shape = tuple(leaf.shape)
        # a spec may be shorter than the leaf rank (trailing dims implicitly
        # replicated): pad with None so no dim is silently dropped
        spec = tuple(pspecs[name]) + (None,) * (len(shape) - len(pspecs[name]))
        dims = []
        for d, e in zip(shape, spec):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            sz = 1
            for a in axes:
                sz *= axis_sizes[a]
            if d % sz:
                raise ValueError(
                    f"dim {d} of {shape} not divisible by mesh axes {axes} "
                    f"(size {sz})")
            dims.append(d // sz)
        out[name] = torch.empty(dims, dtype=leaf.dtype, device="meta")
    return out


def make_sharded_packing_plan(cfg: SketchConfig, tree: Mapping[str, Any],
                              pspecs: Mapping[str, tuple],
                              axis_sizes: Mapping[str, int]) -> PackingPlan:
    """PackingPlan over the SHARD-LOCAL slices of ``tree``: the mesh round
    sketches each rank's local shard of every leaf (no gather of the
    d-dim delta), so the packed layout comes from the local shapes.  Leaf
    tags are the leaf indices, as in the per-leaf route of
    ``launch.train.sharded_sketch_avg_desk``."""
    return make_packing_plan(cfg, shard_local_abstract(tree, pspecs, axis_sizes))


def make_packing_plan(cfg: SketchConfig, tree: Mapping[str, Any]) -> PackingPlan:
    """Lay out every leaf of ``tree`` (anything with ``.shape``/``.dtype``)
    into the packed input/payload buffers."""
    leaves, in_off = [], 0
    for name in leaf_names(tree):
        shape = tuple(tree[name].shape)
        n = numel(shape)
        leaves.append(LeafSpec(name, shape, tree[name].dtype, n, in_off))
        in_off += n
    d_total = in_off

    ops, pay_off = [], 0
    if cfg.mode == "concat":
        b = d_total if cfg.kind == "none" else leaf_sketch_size(d_total, cfg)
        ops.append(OpSpec(0, 0, d_total, b, 0, b >= d_total, None,
                          next_pow2(d_total)))
        pay_off = b
    else:
        for i, spec in enumerate(leaves):
            n = spec.n
            b = n if cfg.kind == "none" else leaf_sketch_size(n, cfg)
            ops.append(OpSpec(i, spec.in_off, n, b, pay_off, b >= n, i,
                              next_pow2(n)))
            pay_off += b
    return PackingPlan(cfg, tuple(leaves), tuple(ops), d_total, pay_off)


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def pack_tree(plan: PackingPlan, tree: Tree) -> torch.Tensor:
    """Flatten ``tree`` into the contiguous f32 (d_total,) buffer."""
    return torch.cat([tree[s.name].reshape(-1).to(torch.float32)
                      for s in plan.leaves])


def unpack_tree(plan: PackingPlan, flat: torch.Tensor,
                cast: bool = True) -> dict[str, torch.Tensor]:
    """Slice the (d_total,) buffer back into leaf shapes (plan dtypes)."""
    out = {}
    for s in plan.leaves:
        v = flat[s.in_off:s.in_off + s.n].reshape(s.shape)
        out[s.name] = v.to(s.dtype) if cast else v
    return out


def pack_rows(plan: PackingPlan, stacked: Tree) -> torch.Tensor:
    """Flatten G stacked trees (leaves (G, ...)) into the (G, d_total) f32
    buffer, one row a tree."""
    g = stacked[plan.leaves[0].name].shape[0]
    return torch.cat([stacked[s.name].reshape(g, -1).to(torch.float32)
                      for s in plan.leaves], dim=1)


def unpack_rows(plan: PackingPlan, flat2: torch.Tensor) -> dict[str, torch.Tensor]:
    """Slice the (G, d_total) buffer back into (G, ...) leaves (views into
    ``flat2``, its dtype)."""
    g = flat2.shape[0]
    return {s.name: flat2[:, s.in_off:s.in_off + s.n].reshape((g,) + s.shape)
            for s in plan.leaves}


# ---------------------------------------------------------------------------
# per-round operator parameters (derived once, shared by sk and desk)
# ---------------------------------------------------------------------------

def _op_key(key: prng.Key, op: OpSpec) -> prng.Key:
    return key if op.tag is None else _keys(key, op.tag)


def derive_round_params(plan: PackingPlan, key: prng.Key, device) -> dict:
    """Derive the round's sketch operator once, on ``device``; consumed by
    both ``sk_flat`` and ``desk_flat``."""
    cfg = plan.cfg
    if cfg.kind == "none" or plan.all_raw:
        return {}
    live = [op for op in plan.ops if not op.raw]

    if cfg.kind == "countsketch":
        if cfg.cs_hash == "balanced":
            params: list = [None] * len(plan.ops)
            for op in live:
                params[op.index] = _balanced_cs_params(_op_key(key, op), op.n,
                                                       op.b, device)
            return {"bal": tuple(params)}
        h_parts: list = [None] * len(plan.ops)
        s_parts: list = [None] * len(plan.ops)
        for op in plan.ops:
            if op.raw:
                h_parts[op.index] = op.pay_off + torch.arange(
                    op.n, dtype=torch.int32, device=device)
                s_parts[op.index] = torch.ones(op.n, dtype=torch.float32,
                                               device=device)
            else:
                h, s = _cs_hashes(_op_key(key, op), op.n, op.b, device)
                h_parts[op.index] = h + op.pay_off
                s_parts[op.index] = s
        return {"h": torch.cat(h_parts), "s": torch.cat(s_parts)}

    if cfg.kind == "srht":
        params = [None] * len(plan.ops)
        for op in live:
            params[op.index] = _srht_params(_op_key(key, op), op.n, op.b,
                                            device)[1:]
        return {"srht": tuple(params)}

    if cfg.kind == "gaussian":
        keys: list = [None] * len(plan.ops)
        for op in live:
            keys[op.index] = _op_key(key, op)
        return {"keys": tuple(keys)}

    raise ValueError(f"unknown sketch kind: {cfg.kind}")


def derive_generation_params(plan: PackingPlan, base_key: prng.Key, g: int,
                             device) -> dict:
    """Generation round ``g``'s operator from the run's base key,
    ``derive_round_params(plan, fold_in(base_key, g))``: a delayed payload
    sketched in round g is desketched with round g's own operator, which
    the async buffer re-derives at pop time instead of storing it."""
    return derive_round_params(plan, prng.fold_in(base_key, g), device)


# ---------------------------------------------------------------------------
# fused sk / desk over the packed buffers
# ---------------------------------------------------------------------------

def _srht_groups(plan: PackingPlan) -> dict[int, list[OpSpec]]:
    """Non-raw ops grouped by padded FWHT length (batched transform rows)."""
    groups: dict[int, list[OpSpec]] = {}
    for op in plan.ops:
        if not op.raw:
            groups.setdefault(op.n2, []).append(op)
    return groups


def _batched_fwht(cfg: SketchConfig, rows: torch.Tensor) -> torch.Tensor:
    """FWHT along the last axis of (L, n2) rows; the kernel when routed."""
    return kops.fwht_rows(rows) if cfg.use_kernels else fwht(rows)


def _srht_sk_rows(plan: PackingPlan, rp: dict, flat2: torch.Tensor) -> torch.Tensor:
    """SRHT sk of G packed rows (G, d_total) -> (G, b_total): one batched
    FWHT over the (G * L, n2) padded, sign-multiplied rows of each group of
    L ops that share the padded length n2, as the reference's vmap does."""
    cfg = plan.cfg
    g = flat2.shape[0]
    parts: list = [None] * len(plan.ops)
    for n2, group in _srht_groups(plan).items():
        rows = torch.stack([
            torch.nn.functional.pad(flat2[:, op.in_off:op.in_off + op.n],
                                    (0, n2 - op.n))
            * rp["srht"][op.index][0] for op in group], dim=1)   # (G, L, n2)
        u = (_batched_fwht(cfg, rows.reshape(g * len(group), n2))
             .reshape(g, len(group), n2) / f32_sqrt(n2))
        for r, op in enumerate(group):
            parts[op.index] = (u[:, r][:, rp["srht"][op.index][1]]
                               * f32_sqrt(n2 / op.b))
    for op in plan.ops:
        if op.raw:
            parts[op.index] = flat2[:, op.in_off:op.in_off + op.n]
    return torch.cat(parts, dim=1).to(cfg.transport_dtype)


def _gaussian_sk_rows(plan: PackingPlan, rp: dict,
                      flat2: torch.Tensor) -> torch.Tensor:
    """Gaussian sk of G packed rows (G, d_total) -> (G, b_total): each op's
    R chunks are drawn once and multiply all G rows, ``(G, c) @ (c, b)``."""
    parts: list = [None] * len(plan.ops)
    for op in plan.ops:
        v = flat2[:, op.in_off:op.in_off + op.n]
        parts[op.index] = v if op.raw else _gaussian_sk(
            plan.cfg, rp["keys"][op.index], v, op.b)
    return torch.cat(parts, dim=1).to(plan.cfg.transport_dtype)


def sk_flat(plan: PackingPlan, rp: dict, flat: torch.Tensor) -> torch.Tensor:
    """Fused sk of the packed (d_total,) buffer -> (b_total,) payload."""
    cfg = plan.cfg
    if cfg.kind == "none" or plan.all_raw:
        return flat.to(cfg.transport_dtype)

    if cfg.kind == "countsketch":
        if cfg.cs_hash == "balanced":
            parts: list = [None] * len(plan.ops)
            for op in plan.ops:
                v = flat[op.in_off:op.in_off + op.n]
                if op.raw:
                    parts[op.index] = v
                    continue
                r, s = rp["bal"][op.index]
                parts[op.index] = _balanced_sk_core(v, r, s, op.b)
            return torch.cat(parts).to(cfg.transport_dtype)
        out = scatter_add(cfg, flat * rp["s"], rp["h"], plan.b_total)
        return out.to(cfg.transport_dtype)

    if cfg.kind == "srht":
        return _srht_sk_rows(plan, rp, flat[None])[0]

    if cfg.kind == "gaussian":
        return _gaussian_sk_rows(plan, rp, flat[None])[0]

    raise ValueError(f"unknown sketch kind: {cfg.kind}")


def desk_flat(plan: PackingPlan, rp: dict, payload: torch.Tensor) -> torch.Tensor:
    """Fused desk of the (b_total,) payload -> packed (d_total,) buffer."""
    cfg = plan.cfg
    s = payload.to(torch.float32)
    if cfg.kind == "none" or plan.all_raw:
        return s

    if cfg.kind == "countsketch":
        if cfg.cs_hash == "balanced":
            parts: list = [None] * len(plan.ops)
            for op in plan.ops:
                u = s[op.pay_off:op.pay_off + op.b]
                if op.raw:
                    parts[op.index] = u
                    continue
                r, sg = rp["bal"][op.index]
                parts[op.index] = _balanced_desk_core(u, r, sg, op.n)
            return torch.cat(parts)
        return torch.index_select(s, 0, rp["h"]) * rp["s"]

    if cfg.kind == "srht":
        parts = [None] * len(plan.ops)
        for n2, group in _srht_groups(plan).items():
            rows = [scatter_add(cfg, s[op.pay_off:op.pay_off + op.b]
                                * f32_sqrt(n2 / op.b), rp["srht"][op.index][1], n2)
                    for op in group]
            w = _batched_fwht(cfg, torch.stack(rows)) / f32_sqrt(n2)
            for r, op in enumerate(group):
                parts[op.index] = (w[r] * rp["srht"][op.index][0])[:op.n]
        for op in plan.ops:
            if op.raw:
                parts[op.index] = s[op.pay_off:op.pay_off + op.b]
        return torch.cat(parts)

    if cfg.kind == "gaussian":
        parts = [None] * len(plan.ops)
        for op in plan.ops:
            u = s[op.pay_off:op.pay_off + op.b]
            parts[op.index] = u if op.raw else _gaussian_desk(
                cfg, rp["keys"][op.index], u, op.n)
        return torch.cat(parts)

    raise ValueError(f"unknown sketch kind: {cfg.kind}")


# ---------------------------------------------------------------------------
# tree-level entry points
# ---------------------------------------------------------------------------

def sk_packed(plan: PackingPlan, rp: dict, tree: Tree) -> torch.Tensor:
    """Sketch a whole tree in one fused pass -> (b_total,) payload."""
    return sk_flat(plan, rp, pack_tree(plan, tree))


def desk_packed(plan: PackingPlan, rp: dict, payload: torch.Tensor) -> dict:
    """Desketch the (b_total,) payload back to the plan's tree."""
    return unpack_tree(plan, desk_flat(plan, rp, payload))


def sk_packed_clients(plan: PackingPlan, rp: dict, stacked: Tree) -> torch.Tensor:
    """Sketch G stacked client trees (leaves (G, ...)) -> (G, b_total).

    The independent count-sketch family with ``use_kernels`` is one launch
    of the batched count-sketch kernel over all G rows, SRHT is one
    batched FWHT per padded-length group over all G rows, and the Gaussian
    family draws each R chunk once for all G rows; the balanced family
    sketches the rows one by one.  The sign multiply runs in place on
    the freshly packed ``(G, d_total)`` buffer, saving one buffer of that
    size.
    """
    cfg = plan.cfg
    flat2 = pack_rows(plan, stacked)
    if (cfg.kind == "countsketch" and cfg.cs_hash == "independent"
            and cfg.use_kernels and not plan.all_raw):
        out = kops.countsketch_clients(flat2.mul_(rp["s"]), rp["h"],
                                       plan.b_total)
        return out.to(cfg.transport_dtype)
    if cfg.kind == "srht" and not plan.all_raw:
        return _srht_sk_rows(plan, rp, flat2)
    if cfg.kind == "gaussian" and not plan.all_raw:
        return _gaussian_sk_rows(plan, rp, flat2)
    return torch.stack([sk_flat(plan, rp, f) for f in flat2])


def sk_packed_clients_wsum(plan: PackingPlan, rp: dict, stacked: Tree,
                           w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The sketch of a chunk of stacked client trees reduced to its
    weighted payload sum ``(b_total,)`` and its weight sum: the unit of
    work of the streamed fold.  By linearity the chunk sums add up to the
    sketch of the cohort's weighted delta sum."""
    s = sk_packed_clients(plan, rp, stacked).to(torch.float32)
    return torch.sum(s * w[:, None].to(s.dtype), dim=0), torch.sum(w)


def roundtrip_packed(plan: PackingPlan, key: prng.Key, tree: Tree) -> dict:
    """desk(sk(tree)) with the round's parameters derived once, on the
    tree's device."""
    rp = derive_round_params(plan, key, next(iter(tree.values())).device)
    return desk_packed(plan, rp, sk_packed(plan, rp, tree))
