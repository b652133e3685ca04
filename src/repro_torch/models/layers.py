"""Model layers of the dense transformer, in PyTorch.

Counterpart of ``repro/models/layers.py`` for ``arch_type="dense"``:
norms, rotary and sinusoidal positions, blockwise exact GQA attention
(causal, optional sliding window) and the MLPs.  Arithmetic follows the
reference: float32 norms with ``rsqrt(var + eps)`` of the biased
variance, masked scores set to -1e30 before the softmax, tanh-approximate
GELU (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

Q_CHUNK = 512          # query chunk for blockwise attention
Params = Mapping[str, torch.Tensor]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * w.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_kind == "ln":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# positions: RoPE, sinusoidal
# ---------------------------------------------------------------------------

def _inv_freq(base: float, half: int, device) -> torch.Tensor:
    return 1.0 / (base ** (torch.arange(half, dtype=torch.float32,
                                        device=device) / half))


def rope_cos_sin(cfg: ModelConfig, positions: torch.Tensor, rot_dim: int):
    """cos/sin tables for positions (B, S): each (B, S, rot_dim // 2)."""
    if cfg.pos_kind != "rope":
        raise NotImplementedError(
            f"pos_kind={cfg.pos_kind!r} is not ported yet (ROADMAP A18)")
    inv = _inv_freq(cfg.rope_theta, rot_dim // 2, positions.device)
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, rot) rotated pairwise (half-split convention)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def sinusoidal_embed(positions: torch.Tensor, d: int) -> torch.Tensor:
    inv = _inv_freq(10000.0, d // 2, positions.device)
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# attention (GQA + optional sliding window) -- full-sequence path
# ---------------------------------------------------------------------------

def _attend_chunked(q, k, v, *, causal: bool, window: int, q_offset: int,
                    num_kv: int) -> torch.Tensor:
    """Blockwise exact attention: q (B, S, H, hd), k/v (B, T, Hk, hd) ->
    (B, S, H, hd).  Softmax is over keys, so chunking queries is exact; a
    sliding window slices the keys per chunk."""
    B, S, H, hd = q.shape
    hd_v = v.shape[-1]
    T = k.shape[1]
    g = H // num_kv
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))   # float32, as the reference
    cq = min(Q_CHUNK, S)
    n_chunks = -(-S // cq)
    s_pad = n_chunks * cq
    if s_pad != S:
        q = F.pad(q, (0, 0, 0, 0, 0, s_pad - S))
    use_window = causal and window > 0 and T > window
    lk = min(T, window + cq) if use_window else T
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)

    outs = []
    for c in range(n_chunks):
        c0 = c * cq
        qc = q[:, c0:c0 + cq]
        start = (min(max(c0 + q_offset - (lk - cq), 0), T - lk)
                 if use_window else 0)
        kc, vc = k[:, start:start + lk], v[:, start:start + lk]
        scores = torch.einsum("bqhd,bthd->bhqt", qc, kc).to(torch.float32)
        scores = scores * scale
        iabs = c0 + q_offset + torch.arange(cq, device=q.device)
        jabs = start + torch.arange(lk, device=q.device)
        mask = torch.ones((cq, lk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= jabs[None, :] <= iabs[:, None]
            if window > 0:
                mask &= jabs[None, :] > iabs[:, None] - window
        scores = torch.where(mask[None, None], scores,
                             torch.tensor(-1e30, dtype=torch.float32,
                                          device=q.device))
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqt,bthd->bqhd", probs, vc)
                    .reshape(B, cq, H, hd_v))
    return torch.cat(outs, dim=1)[:, :S]


def attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              window: int = 0) -> torch.Tensor:
    """Full-sequence GQA self-attention."""
    B, S, D = x.shape
    H, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Hk, hd)
    v = v.reshape(B, S, Hk, hd)
    if cfg.pos_kind == "rope":
        cos, sin = rope_cos_sin(cfg, positions, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = _attend_chunked(q, k, v, causal=causal, window=window, q_offset=0,
                          num_kv=Hk)
    return out.reshape(B, S, H * hd) @ p["wo"]


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """GELU MLP (the reference adds ``bi`` and leaves ``bo`` unused) or
    SwiGLU."""
    if cfg.mlp_kind == "gelu":
        h = x @ p["wi"]
        if "bi" in p:
            h = h + p["bi"]
        return F.gelu(h, approximate="tanh") @ p["wo"]
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
