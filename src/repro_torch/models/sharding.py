"""Mesh context, partition rules, and the shards a rank holds.

Counterpart of ``repro/models/sharding.py``.  The partition rules
(``_RULES``, ``param_pspecs``) are the reference's, regex for regex, over
the same "/"-joined leaf paths the port's flat dicts use as keys.  A spec
is a plain tuple with one entry per dimension: an axis name, a tuple of
axis names, or None (replicated).

No partitioner exists here: the reference's ``hint`` asks GSPMD to lay an
activation out over the mesh, while the port's ranks hold explicit shards
and run explicit collectives (``launch.mesh``), so ``hint`` and
``hint_replicated`` return their input.  In place of the reference's
``named_shardings``, ``local_shard`` cuts a rank's slice of each leaf and
``gather_tree`` all-gathers the whole leaves back.

Axis convention (DESIGN §3):
  * ``pod``, ``data`` -- batch / client-group axes (FSDP weight sharding
    also uses ``data``)
  * ``model``         -- tensor/expert parallel axis
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

_ACTIVE_MESH = None                      # launch.mesh.Mesh, or None
_MANUAL_AXES: frozenset = frozenset()    # axes currently manual
_MODEL_SUBST = None                      # flat-TP: what "model" expands to

BATCH = ("pod", "data")   # canonical batch axes (pod may be absent)
MODEL = "model"
FSDP = "data"             # weights' secondary shard axis


def active_mesh():
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the one ``_clean_spec`` resolves axis names against."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield
    finally:
        _ACTIVE_MESH = prev


@contextlib.contextmanager
def model_axis_substitution(axes):
    """Flat-TP serving (DESIGN §7): every "model" entry of a spec expands to
    the given axis tuple, e.g. ("data", "model")."""
    global _MODEL_SUBST
    prev = _MODEL_SUBST
    _MODEL_SUBST = tuple(axes)
    try:
        yield
    finally:
        _MODEL_SUBST = prev


@contextlib.contextmanager
def manual_axes(axes):
    """Mark mesh axes as manual: ``_clean_spec`` drops them."""
    global _MANUAL_AXES
    prev = _MANUAL_AXES
    _MANUAL_AXES = frozenset(axes)
    try:
        yield
    finally:
        _MANUAL_AXES = prev


def _clean_spec(spec) -> Optional[tuple]:
    """Drop axis names not present in the active mesh; None if no mesh."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return None
    names = set(mesh.axis_names) - _MANUAL_AXES
    out = []
    for e in spec:
        if e is None:
            out.append(None)
            continue
        t = e if isinstance(e, tuple) else (e,)
        if _MODEL_SUBST is not None:
            if MODEL in t:
                t2 = []
                for a in t:
                    if a == MODEL:
                        t2.extend(_MODEL_SUBST)
                    else:
                        t2.append(a)
                t = tuple(dict.fromkeys(t2))
            else:
                # batch-axis entries: axes consumed by the flat TP product
                # cannot also shard the batch -> drop them (replicated)
                t = tuple(a for a in t if a not in _MODEL_SUBST)
        t = tuple(a for a in t if a in names)
        out.append(t if len(t) > 1 else (t[0] if t else None))
    return tuple(out)


def hint_replicated(x: torch.Tensor) -> torch.Tensor:
    """The reference's replication constraint; the identity here (ranks
    hold explicit shards, no partitioner lays ``x`` out)."""
    return x


def hint(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference's sharding constraint; the identity here."""
    return x


def batch_spec(*rest) -> tuple:
    """((pod, data), *rest) -- batch-sharded leading dim."""
    return (BATCH,) + rest


# ---------------------------------------------------------------------------
# Parameter partition rules (name-based; see DESIGN §3).
# Keys are regexes over the "/"-joined path; first match wins.  Every
# weight is 2-D sharded: one dim on "model" (TP/EP) and one on "data"
# (FSDP/ZeRO).
# ---------------------------------------------------------------------------

_RULES: list[tuple[str, tuple]] = [
    # embeddings / heads
    (r"embed$",            (MODEL, FSDP)),           # (V, D)
    (r"lm_head$",          (FSDP, MODEL)),           # (D, V)
    (r"mtp_head$",         (FSDP, MODEL)),
    (r"pos_embed$",        (None, MODEL)),
    # MoE experts: (E, in, out) -- experts over model (EP), in-dim over data
    (r"moe/w[ig]$",        (MODEL, FSDP, None)),
    (r"moe/wo$",           (MODEL, None, FSDP)),
    (r"moe/router$",       (FSDP, None)),
    (r"shared/w[ig]$",     (FSDP, MODEL)),
    (r"shared/wo$",        (MODEL, FSDP)),
    # attention (col-parallel in, row-parallel out)
    (r"attn/w[qkv]$",      (FSDP, MODEL)),
    (r"attn/wo$",          (MODEL, FSDP)),
    (r"attn/w_dq$",        (FSDP, None)),            # MLA down-projections
    (r"attn/w_uq$",        (None, MODEL)),
    (r"attn/w_dkv$",       (FSDP, None)),
    (r"attn/w_kr$",        (FSDP, None)),
    (r"attn/w_uk$",        (None, MODEL)),
    (r"attn/w_uv$",        (None, MODEL)),
    # dense MLP
    (r"mlp/w[ig]$",        (FSDP, MODEL)),
    (r"mlp/wo$",           (MODEL, FSDP)),
    # mamba
    (r"mamba/w[xz]$",      (FSDP, MODEL)),           # (D, d_inner)
    (r"mamba/out_proj$",   (MODEL, FSDP)),           # (d_inner, D)
    (r"mamba/x_proj$",     (MODEL, None)),           # (d_inner, dtr+2ds)
    (r"mamba/dt_proj$",    (None, MODEL)),           # (dtr, d_inner)
    (r"mamba/conv_w$",     (None, MODEL)),           # (k, d_inner)
    (r"mamba/(conv_b|dt_bias|d_skip)$", (MODEL,)),
    (r"mamba/a_log$",      (MODEL, None)),           # (d_inner, d_state)
    # biases on col-parallel projections
    (r"attn/b[qkv]$",      (MODEL,)),
    # everything else (norms, small biases): replicated
]


def _pspec_for(path: str, ndim: int, stacked: bool) -> tuple:
    for pat, spec in _RULES:
        if re.search(pat, path):
            spec = tuple(spec)
            if stacked:
                spec = (None,) + spec  # leading layer-stack dim
            spec = spec + (None,) * (ndim - len(spec))
            return spec[:ndim]
    return (None,) * ndim


def param_pspecs(params: Mapping[str, Any], fsdp: bool = False) -> dict[str, tuple]:
    """The spec of every leaf of a flat param dict (anything with
    ``.shape``), keyed like it.

    fsdp=False: weights sharded over ``model`` only, replicated over data --
    the cross-device FL mapping (every data group = one client owns a full
    replica).  fsdp=True: weights additionally ZeRO-sharded over ``data`` --
    the cross-silo mapping (client = pod).  See DESIGN §3."""
    specs = {}
    for path, leaf in params.items():
        stacked = bool({"layers", "dense_layers", "enc_layers"}
                       & set(path.split("/")))
        spec = _pspec_for(path, len(leaf.shape), stacked)
        if not fsdp:
            spec = tuple(None if e == FSDP else e for e in spec)
        specs[path] = spec
    return specs


# ---------------------------------------------------------------------------
# a rank's shards
# ---------------------------------------------------------------------------

def _entry_axes(e) -> tuple[str, ...]:
    return () if e is None else (e if isinstance(e, tuple) else (e,))


def _block(mesh, shape, spec, rank: Optional[int] = None) -> tuple:
    """The slice of a leaf of ``shape`` that ``rank`` (default: this one)
    holds under ``spec``: dim i is cut into ``prod(sizes of its axes)``
    blocks, the rank's block its row-major index over those axes."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for d, e in zip(shape, spec):
        axes = _entry_axes(e)
        n = math.prod(mesh.shape[a] for a in axes)
        if d % n:
            raise ValueError(f"dim {d} of {tuple(shape)} not divisible by mesh "
                             f"axes {axes} (size {n})")
        i = mesh.index_over(axes, rank)
        out.append(slice(i * (d // n), (i + 1) * (d // n)))
    return tuple(out)


def local_shard(mesh, tree: Mapping[str, Any], pspecs: Mapping[str, Any]) -> dict:
    """This rank's slice of every leaf (nested dicts allowed; ``pspecs``
    mirrors ``tree``).  A sliced leaf is a copy, so the whole leaf can be
    freed; an unsharded one is returned as it is."""
    out = {}
    for k, x in tree.items():
        spec = pspecs[k]
        if not isinstance(spec, tuple):
            out[k] = local_shard(mesh, x, spec)
            continue
        sl = _block(mesh, x.shape, spec)
        sharded = any(s.stop - s.start != d for s, d in zip(sl, x.shape))
        out[k] = x[sl].clone() if sharded else x
    return out


def gather_tree(mesh, tree: Mapping[str, Any], pspecs: Mapping[str, Any]) -> dict:
    """The whole leaves from every rank's shards: each sharded leaf is
    all-gathered over the group of the axes its spec names, and each
    member's block put back in place.  Collective: every rank of the mesh
    calls it with the same tree structure."""
    out = {}
    for k, x in tree.items():
        spec = pspecs[k]
        if not isinstance(spec, tuple):
            out[k] = gather_tree(mesh, x, spec)
            continue
        axes = tuple(a for e in spec for a in _entry_axes(e))
        group = mesh.group(axes)
        if group is None:
            out[k] = x
            continue
        members = mesh.ranks_over(axes)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in members]
        dist.all_gather(parts, x, group=group)
        shape = tuple(d * math.prod(mesh.shape[a] for a in _entry_axes(e))
                      for d, e in zip(x.shape, tuple(spec) + (None,) * (x.dim() - len(spec))))
        full = torch.empty(shape, dtype=x.dtype, device=x.device)
        for r, part in zip(members, parts):
            full[_block(mesh, shape, spec, r)] = part
        out[k] = full
    return out
