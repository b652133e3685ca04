"""Random linear sketching operators for SAFL (paper §3.2), in PyTorch.

Counterpart of ``repro/core/sketch.py``: the ``gaussian``, ``srht`` and
``countsketch`` families (both hash families) and ``none``, per tensor or
over the concatenated vector, with the reference's key derivation
(``fold_in`` on the leaf index, ``split`` inside each family), so a sketch
of the port and a sketch of the reference under one key use bit-identical
hashes, signs, SRHT indices and Gaussian uniforms.

A tree is a flat ``dict[str, Tensor]`` keyed by the reference's
"/"-joined leaf paths; ``leaf_names`` orders it as jax's ``tree_flatten``
orders the nested dict, which fixes the leaf tags and payload offsets.

With ``use_kernels`` the FWHT and the count-sketch segment sums go through
``repro_torch.kernels.ops``: the Hopper kernels for CUDA tensors, their
plain versions for CPU tensors.  The SRHT desketch's scatter of ``b``
payload slots into ``n2`` rows is a count-sketch segment sum too; on that
route it uses the same deterministic kernel, where ``index_add_`` on CUDA
would add repeated indices in no fixed order.  The Gaussian family draws
its R chunk by chunk with ``prng.normal`` on either route: the on-the-fly
Gaussian kernels (``kernels.ops.gaussian_sk``/``gaussian_desk``) generate
another R and stay unwired, as the reference's Pallas pair does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels import ops as kops
from repro_torch.kernels.fwht import fwht_plain as fwht

Tree = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Configuration of the sketching compressor (the reference's fields;
    ``use_kernels`` is its ``use_pallas``)."""

    kind: str = "countsketch"  # none | gaussian | srht | countsketch
    ratio: float = 0.01        # b = ceil(n * ratio) per tensor
    min_b: int = 64            # floor on per-tensor sketch size
    max_b: Optional[int] = None
    mode: str = "per_tensor"   # per_tensor | concat
    transport_dtype: Any = torch.float32  # dtype of the transmitted sketch
    use_kernels: bool = False  # route hot loops through the Hopper kernels
    gaussian_chunk: int = 8192  # column chunk for on-the-fly Gaussian R
    # "balanced" (block-sparse JL, gather/reshape/sum) or "independent"
    # (per-element uniform hash + segment sum); see the reference.
    cs_hash: str = "balanced"

    def __post_init__(self):
        if self.kind not in ("none", "gaussian", "srht", "countsketch"):
            raise ValueError(f"unknown sketch kind: {self.kind}")
        if self.mode not in ("per_tensor", "concat"):
            raise ValueError(f"unknown sketch mode: {self.mode}")
        if not (self.kind == "none" or 0.0 < self.ratio <= 1.0):
            raise ValueError("ratio must be in (0, 1]")
        if self.cs_hash not in ("balanced", "independent"):
            raise ValueError(f"unknown cs_hash family: {self.cs_hash}")


def leaf_names(tree: Mapping[str, Any]) -> list[str]:
    """Leaf order of jax's ``tree_flatten`` on the nested dict the
    "/"-joined paths stand for: sorted path by path component."""
    return sorted(tree, key=lambda name: name.split("/"))


def numel(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def leaf_sketch_size(n: int, cfg: SketchConfig) -> int:
    """Sketch size for a tensor with n elements."""
    if cfg.kind == "none":
        return n
    b = max(cfg.min_b, int(math.ceil(n * cfg.ratio)))
    if cfg.max_b is not None:
        b = min(b, cfg.max_b)
    return min(b, n)


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def f32_sqrt(x: float) -> float:
    """``sqrt(float32(x))`` rounded to float32, the scalar the reference
    computes with ``jnp.sqrt(jnp.asarray(x, float32))``."""
    return float(np.sqrt(np.float32(x)))


# ---------------------------------------------------------------------------
# Per-leaf sk / desk
# ---------------------------------------------------------------------------

def _keys(key: prng.Key, *tags: int) -> prng.Key:
    for t in tags:
        key = prng.fold_in(key, t)
    return key


def _gaussian_chunk(key: prng.Key, i: int, c: int, n: int, b: int,
                    device) -> torch.Tensor:
    """Rows ``i*c`` up to ``min((i+1)*c, n)`` of R^T: chunk i is
    ``normal(fold_in(key, i), (c, b))``.  The stream hashes the flat
    element index, so the last chunk draws only the rows it keeps; the
    reference draws all c and multiplies its padding rows by zeros."""
    return prng.normal(prng.fold_in(key, i), (min(c, n - i * c), b), device)


def _gaussian_sk(cfg: SketchConfig, key: prng.Key, v: torch.Tensor,
                 b: int) -> torch.Tensor:
    """sk(v) = R v / sqrt(b), R ~ N(0,1)^{b x n}, generated chunk-wise.
    ``v`` is (n,) or (G, n); G rows are sketched against one draw of each
    chunk, as the reference's vmap with an unbatched key does."""
    n, c = v.shape[-1], cfg.gaussian_chunk
    acc = torch.zeros(v.shape[:-1] + (b,), dtype=v.dtype, device=v.device)
    for i in range(-(-n // c)):
        r = _gaussian_chunk(key, i, c, n, b, v.device).to(v.dtype)
        acc = acc + v[..., i * c:(i + 1) * c] @ r
    return acc / f32_sqrt(b)


def _gaussian_desk(cfg: SketchConfig, key: prng.Key, s: torch.Tensor,
                   n: int) -> torch.Tensor:
    """desk(s) = R^T s / sqrt(b) (so desk(sk(v)) = R^T R v / b, unbiased)."""
    b, c = s.shape[0], cfg.gaussian_chunk
    chunks = [_gaussian_chunk(key, i, c, n, b, s.device).to(s.dtype) @ s
              for i in range(-(-n // c))]
    return torch.cat(chunks) / f32_sqrt(b)


def _srht_params(key: prng.Key, n: int, b: int, device):
    n2 = next_pow2(n)
    sign_key, idx_key = prng.split(key)
    signs = prng.rademacher(sign_key, (n2,), device)
    idx = prng.randint(idx_key, (b,), 0, n2, device)
    return n2, signs, idx


def _fwht(cfg: SketchConfig, x: torch.Tensor) -> torch.Tensor:
    return kops.fwht(x) if cfg.use_kernels else fwht(x)


def scatter_add(cfg: SketchConfig, x: torch.Tensor, idx: torch.Tensor,
                size: int) -> torch.Tensor:
    """``zeros(size).at[idx].add(x)`` -- a count-sketch segment sum, so the
    kernel route takes the deterministic count-sketch kernel."""
    if cfg.use_kernels:
        return kops.countsketch(x.contiguous(), idx, size)
    return torch.zeros(size, dtype=x.dtype, device=x.device).index_add_(0, idx, x)


def _srht_sk(cfg: SketchConfig, key: prng.Key, v: torch.Tensor, b: int) -> torch.Tensor:
    n = v.shape[0]
    n2, signs, idx = _srht_params(key, n, b, v.device)
    vp = torch.nn.functional.pad(v, (0, n2 - n)) * signs.to(v.dtype)
    u = _fwht(cfg, vp) / f32_sqrt(n2)
    return u[idx] * f32_sqrt(n2 / b)


def _srht_desk(cfg: SketchConfig, key: prng.Key, s: torch.Tensor, n: int) -> torch.Tensor:
    b = s.shape[0]
    n2, signs, idx = _srht_params(key, n, b, s.device)
    u = scatter_add(cfg, s * f32_sqrt(n2 / b), idx, n2)
    w = _fwht(cfg, u) / f32_sqrt(n2)
    return (w * signs.to(s.dtype))[:n]


def _cs_hashes(key: prng.Key, n: int, b: int, device):
    """Independent family: h (n,) int32 in [0, b), signs s (n,) float32."""
    hkey, skey = prng.split(key)
    h = prng.randint(hkey, (n,), 0, b, device).to(torch.int32)
    s = prng.rademacher(skey, (n,), device)
    return h, s


def _balanced_cs_params(key: prng.Key, n: int, b: int, device):
    """Balanced family: m = ceil(n/b) rows of b columns; row k is rotated by
    r_k, so element (k, c) hashes to slot (c + r_k) mod b."""
    m = -(-n // b)
    rkey, skey = prng.split(key)
    r = prng.randint(rkey, (m,), 0, b, device)
    s = prng.rademacher(skey, (n,), device)
    return r, s


def _balanced_sk_core(v: torch.Tensor, r: torch.Tensor, s: torch.Tensor,
                      b: int) -> torch.Tensor:
    """out[j] = sum_k x[k, (j - r_k) mod b]: gather + row sum, no scatter."""
    n = v.shape[0]
    m = r.shape[0]
    x = torch.nn.functional.pad(v * s.to(v.dtype), (0, m * b - n)).reshape(m, b)
    idx = (torch.arange(b, device=v.device)[None, :] - r[:, None]) % b
    return torch.gather(x, 1, idx).sum(dim=0)


def _balanced_desk_core(u: torch.Tensor, r: torch.Tensor, s: torch.Tensor,
                        n: int) -> torch.Tensor:
    """Element (k, c) reads slot (c + r_k) mod b."""
    b = u.shape[0]
    idx = (torch.arange(b, device=u.device)[None, :] + r[:, None]) % b
    return u[idx].reshape(-1)[:n] * s.to(u.dtype)


def _countsketch_sk(cfg: SketchConfig, key: prng.Key, v: torch.Tensor, b: int) -> torch.Tensor:
    if cfg.cs_hash == "balanced":
        r, s = _balanced_cs_params(key, v.shape[0], b, v.device)
        return _balanced_sk_core(v, r, s, b)
    h, s = _cs_hashes(key, v.shape[0], b, v.device)
    return scatter_add(cfg, v * s.to(v.dtype), h, b)


def _countsketch_desk(cfg: SketchConfig, key: prng.Key, u: torch.Tensor, n: int) -> torch.Tensor:
    if cfg.cs_hash == "balanced":
        r, s = _balanced_cs_params(key, n, u.shape[0], u.device)
        return _balanced_desk_core(u, r, s, n)
    h, s = _cs_hashes(key, n, u.shape[0], u.device)
    return u[h] * s.to(u.dtype)


def sk_leaf(cfg: SketchConfig, key: prng.Key, v: torch.Tensor) -> torch.Tensor:
    """Sketch one flat vector v -> (b,)."""
    assert v.dim() == 1
    n = v.shape[0]
    if cfg.kind == "none":
        return v.to(cfg.transport_dtype)
    b = leaf_sketch_size(n, cfg)
    if b >= n:  # sketch would not compress; transmit raw
        return v.to(cfg.transport_dtype)
    fn = {"gaussian": _gaussian_sk, "srht": _srht_sk,
          "countsketch": _countsketch_sk}[cfg.kind]
    return fn(cfg, key, v, b).to(cfg.transport_dtype)


def desk_leaf(cfg: SketchConfig, key: prng.Key, s: torch.Tensor, n: int,
              dtype=torch.float32) -> torch.Tensor:
    """Desketch (b,) -> flat (n,)."""
    s = s.to(dtype)
    if cfg.kind == "none" or s.shape[0] >= n:
        return s[:n]
    fn = {"gaussian": _gaussian_desk, "srht": _srht_desk,
          "countsketch": _countsketch_desk}[cfg.kind]
    return fn(cfg, key, s, n)


SKETCH_CHUNK_NUMEL = 1 << 24    # leaves above this sketch per layer slice


def sk_leaf_stacked(cfg: SketchConfig, key: prng.Key,
                    rows: torch.Tensor) -> torch.Tensor:
    """sk each row of ``rows`` (L, n) with the per-row operator
    ``fold_in(key, j)`` -> (L, b): the layer-wise path for leaves whose
    flat size would make one hash/sign temporary too large (one row's
    temporaries at a time), shared by the mesh round's per-leaf route."""
    return torch.stack([sk_leaf(cfg, prng.fold_in(key, j), rows[j])
                        for j in range(rows.shape[0])])


def desk_leaf_stacked(cfg: SketchConfig, key: prng.Key, s: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Row-wise desk of ``s`` (L, b) back to (L, n): the adjoint of
    ``sk_leaf_stacked`` under the same per-row ``fold_in(key, j)`` chain."""
    return torch.stack([desk_leaf(cfg, prng.fold_in(key, j), s[j], n)
                        for j in range(s.shape[0])])


# ---------------------------------------------------------------------------
# Tree-level sketching
# ---------------------------------------------------------------------------

def tree_sketch_sizes(cfg: SketchConfig, tree: Mapping[str, Any]) -> list[int]:
    """Per-leaf sketch sizes, in ``leaf_names`` order."""
    return [leaf_sketch_size(numel(tree[k].shape), cfg) for k in leaf_names(tree)]


def total_sketch_bits(cfg: SketchConfig, tree: Mapping[str, Any]) -> int:
    """Uplink payload in bits per round: the packed ``(b_total,)`` payload."""
    from repro_torch.core.packed import make_packing_plan
    itemsize = torch.empty((), dtype=cfg.transport_dtype).element_size()
    return make_packing_plan(cfg, tree).b_total * itemsize * 8


def sketch_tree(cfg: SketchConfig, key: prng.Key, tree: Tree):
    """sk over every leaf (per_tensor: dict of sketches) or over the
    concatenation (concat: one sketch)."""
    names = leaf_names(tree)
    if cfg.mode == "concat":
        flat = torch.cat([tree[k].reshape(-1).to(torch.float32) for k in names])
        return sk_leaf(cfg, key, flat)
    return {k: sk_leaf(cfg, _keys(key, i), tree[k].reshape(-1).to(torch.float32))
            for i, k in enumerate(names)}


def desketch_tree(cfg: SketchConfig, key: prng.Key, sketches,
                  like: Tree) -> dict[str, torch.Tensor]:
    """desk back to the shapes/dtypes of ``like``."""
    names = leaf_names(like)
    if cfg.mode == "concat":
        sizes = [numel(like[k].shape) for k in names]
        flat = desk_leaf(cfg, key, sketches, sum(sizes))
        out, off = {}, 0
        for k, n in zip(names, sizes):
            out[k] = flat[off:off + n].reshape(like[k].shape).to(like[k].dtype)
            off += n
        return out
    return {k: desk_leaf(cfg, _keys(key, i), sketches[k], numel(like[k].shape))
            .reshape(like[k].shape).to(like[k].dtype)
            for i, k in enumerate(names)}


def roundtrip_tree(cfg: SketchConfig, key: prng.Key, tree: Tree) -> dict[str, torch.Tensor]:
    """desk(sk(tree)) -- the lossy replicate the server optimizer consumes."""
    return desketch_tree(cfg, key, sketch_tree(cfg, key, tree), tree)
