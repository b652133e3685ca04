"""Model layers of every family, in PyTorch: the full-sequence path
(train and prefill) and the cached decode path (one new token).

Counterpart of ``repro/models/layers.py``: norms, rotary (and the VLM's
multimodal M-RoPE) and sinusoidal positions, blockwise exact GQA attention
(causal, optional sliding window, or cross-attention to an encoder),
DeepSeek's MLA in its unabsorbed form, the MLPs, token-choice top-k MoE
with capacity and scatter dispatch, and the Mamba-1 selective SSM; and
their one-token decode layers: ``attention_decode`` (a ring-buffered KV
cache for the sliding window, keys stored rotated), ``cross_attention_decode``
(against the encoder's cached keys and values), ``mla_attention_decode``
(the absorbed form, caching only the kv latent and the rotary key) and
``mamba_decode`` (one recurrence step, a float32 state and a conv window).
Arithmetic follows the reference: float32 norms with ``rsqrt(var + eps)``
of the biased variance, masked scores set to -1e30 before the softmax,
tanh-approximate GELU (``jax.nn.gelu``'s default), a float32 router and
SSM state, and the reference's casts in each decode layer.  The decode
layers write the new token's entries into the caller's cache in place.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

Q_CHUNK = 512          # query chunk for blockwise attention
MAMBA_CHUNK = 256      # seq chunk for the selective scan
MOE_CHUNK = 4096       # token chunk for MoE dispatch
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
# positions: RoPE, M-RoPE, sinusoidal
# ---------------------------------------------------------------------------

def _inv_freq(base: float, half: int, device) -> torch.Tensor:
    return 1.0 / (base ** (torch.arange(half, dtype=torch.float32,
                                        device=device) / half))


def rope_cos_sin(cfg: ModelConfig, positions: torch.Tensor, rot_dim: int):
    """cos/sin tables, each (B, S, rot_dim // 2).  positions: (B, S) for
    rope; (3, B, S) for mrope, whose (t, h, w) rows rotate the
    ``mrope_sections`` of the frequencies in turn."""
    half = rot_dim // 2
    inv = _inv_freq(cfg.rope_theta, half, positions.device)
    if cfg.pos_kind == "mrope":
        secs = cfg.mrope_sections
        assert sum(secs) == half, (secs, half)
        parts, off = [], 0
        for i, s in enumerate(secs):
            parts.append(positions[i][..., None].to(torch.float32)
                         * inv[off:off + s])
            off += s
        ang = torch.cat(parts, dim=-1)
    else:
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
# attention (GQA + optional sliding window / cross) -- full-sequence path
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
              window: int = 0,
              enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence GQA attention; with ``enc_out``, cross-attention: keys
    and values from the encoder's output, no rotary and no causal mask."""
    B, S, D = x.shape
    H, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = x @ p["wq"]
    if cfg.attn_bias:
        q = q + p["bq"]
    q = q.reshape(B, S, H, hd)
    src = x if enc_out is None else enc_out
    k = src @ p["wk"]
    v = src @ p["wv"]
    if cfg.attn_bias:
        k, v = k + p["bk"], v + p["bv"]
    T = src.shape[1]
    k = k.reshape(B, T, Hk, hd)
    v = v.reshape(B, T, Hk, hd)
    if cfg.pos_kind in ("rope", "mrope") and enc_out is None:
        cos, sin = rope_cos_sin(cfg, positions, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = _attend_chunked(q, k, v, causal=causal and enc_out is None,
                          window=window, q_offset=0, num_kv=Hk)
    return out.reshape(B, S, H * hd) @ p["wo"]


def _sqrt32(n: int, device) -> torch.Tensor:
    """sqrt(n) rounded to float32, as a 0-d tensor on ``device``: dividing
    by a tensor divides, where CUDA multiplies by the reciprocal of a
    Python scalar divisor."""
    return torch.full((), float(np.sqrt(np.float32(n))), dtype=torch.float32,
                      device=device)


def _ring(pos: torch.Tensor, Sc: int, window: int = 0):
    """The slot (a 1-element index) that ``pos`` writes in a cache ring of
    ``Sc`` entries, and the entries the query at ``pos`` may see: slot j
    holds position pj = pos - ((pos - j) mod Sc), unwritten while pj < 0;
    a window shorter than the ring also hides pj <= pos - window.  All on
    ``pos``'s device, with no host sync."""
    pj = pos - torch.remainder(pos - torch.arange(Sc, device=pos.device), Sc)
    valid = pj >= 0
    if window > 0 and Sc > window:
        valid &= pj > pos - window
    return torch.remainder(pos, Sc).reshape(1).long(), valid


def attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     pos: torch.Tensor, cache: dict, *, window: int = 0):
    """One-token GQA decode against a (ring-buffered, for a sliding
    window) KV cache.  x: (B, 1, D); pos: 0-d tensor, the position of this
    token; cache ``k``/``v``: (B, Sc, Hk, hd), Sc the window for SWA layers
    and max_seq otherwise.  Keys are stored rotated.  The new key and
    value are written into ``cache`` in place (the reference returns an
    updated copy).  Returns (out (B, 1, D), cache)."""
    B = x.shape[0]
    H, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    ck, cv = cache["k"], cache["v"]
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, 1, H, hd)
    k = k.reshape(B, 1, Hk, hd)
    v = v.reshape(B, 1, Hk, hd)
    if cfg.pos_kind in ("rope", "mrope"):
        # M-RoPE: the reference gives a text token pos on all three rows
        cos, sin = rope_cos_sin(
            cfg, pos.expand((3, B, 1) if cfg.pos_kind == "mrope" else (B, 1)), hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    slot, valid = _ring(pos, ck.shape[1], window)
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    qg = q.reshape(B, Hk, H // Hk, hd)
    scores = torch.einsum("bkgh,btkh->bkgt", qg, ck.to(q.dtype))
    scores = scores.to(torch.float32) / _sqrt32(hd, x.device)
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bkgt,btkh->bkgh", probs, cv)
    return out.reshape(B, 1, H * hd) @ p["wo"], cache


def cross_attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                           cache: dict) -> torch.Tensor:
    """One-token cross-attention against the encoder's cached ``xk``/``xv``
    (B, Te, Hk, hd): no rotary, no mask and, as in the reference, no
    query bias.  Returns (B, 1, D)."""
    B = x.shape[0]
    H, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    qg = (x @ p["wq"]).reshape(B, Hk, H // Hk, hd)
    scores = torch.einsum("bkgh,btkh->bkgt", qg, cache["xk"].to(qg.dtype))
    scores = scores.to(torch.float32) / _sqrt32(hd, x.device)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkgt,btkh->bkgh", probs, cache["xv"].to(x.dtype))
    return out.reshape(B, 1, H * hd) @ p["wo"]


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 Multi-head Latent Attention)
# ---------------------------------------------------------------------------

def mla_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence MLA (training/prefill, unabsorbed form): queries
    through the q LoRA, keys and values up-projected from the kv latent,
    one rotary key part shared by every head."""
    B, S, D = x.shape
    H = cfg.num_heads
    nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q = ((x @ p["w_dq"]) @ p["w_uq"]).reshape(B, S, H, nope + rdim)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    ckv = x @ p["w_dkv"]                                     # (B,S,kvr)
    k_pe = (x @ p["w_kr"]).reshape(B, S, 1, rdim)
    k_nope = (ckv @ p["w_uk"]).reshape(B, S, H, nope)
    v = (ckv @ p["w_uv"]).reshape(B, S, H, vdim)
    cos, sin = rope_cos_sin(cfg, positions, rdim)
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe, cos, sin)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    k_full = torch.cat([k_nope, k_pe.expand(B, S, H, rdim)], dim=-1)
    out = _attend_chunked(q_full, k_full, v, causal=True, window=0,
                          q_offset=0, num_kv=H)
    return out.reshape(B, S, H * vdim) @ p["wo"]


def mla_attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                         pos: torch.Tensor, cache: dict):
    """One-token MLA decode in the absorbed form: the cache holds only the
    kv latent ``ckv`` (B, Sc, kv_lora_rank) and the rotated rotary key
    ``kpe`` (B, Sc, qk_rope_dim); ``W_uk`` is folded into the query and
    ``W_uv`` applied after the softmax, whose scale is sqrt(nope + rdim).
    The new entries are written into ``cache`` in place.  Returns
    (out (B, 1, D), cache)."""
    B = x.shape[0]
    H = cfg.num_heads
    nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    ckv, kpe = cache["ckv"], cache["kpe"]
    q = ((x @ p["w_dq"]) @ p["w_uq"]).reshape(B, H, nope + rdim)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    ckv_t = x @ p["w_dkv"]                                   # (B,1,kvr)
    kpe_t = (x @ p["w_kr"]).reshape(B, 1, 1, rdim)
    cos, sin = rope_cos_sin(cfg, pos.expand(B, 1), rdim)
    q_pe = apply_rope(q_pe.reshape(B, 1, H, rdim), cos, sin).reshape(B, H, rdim)
    kpe_t = apply_rope(kpe_t, cos, sin).reshape(B, 1, rdim)
    slot, valid = _ring(pos, ckv.shape[1])
    ckv.index_copy_(1, slot, ckv_t.to(ckv.dtype))
    kpe.index_copy_(1, slot, kpe_t.to(kpe.dtype))
    q_tilde = torch.einsum("bhn,rhn->bhr", q_nope, p["w_uk"].reshape(kvr, H, nope))
    scores = (torch.einsum("bhr,btr->bht", q_tilde, ckv.to(q_tilde.dtype))
              + torch.einsum("bhr,btr->bht", q_pe, kpe.to(q_pe.dtype)))
    scores = scores.to(torch.float32) / _sqrt32(nope + rdim, x.device)
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    attn_c = torch.einsum("bht,btr->bhr", probs, ckv.to(x.dtype))
    out = torch.einsum("bhr,rhv->bhv", attn_c, p["w_uv"].reshape(kvr, H, vdim))
    return out.reshape(B, 1, H * vdim) @ p["wo"], cache


# ---------------------------------------------------------------------------
# MLPs and MoE
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


def _expert_ffn(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, D) -> (E, C, D) through per-expert SwiGLU."""
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p["wg"]))
    h = h * torch.einsum("ecd,edf->ecf", xe, p["wi"])
    return torch.einsum("ecf,efd->ecd", h, p["wo"])


def moe_route(cfg: ModelConfig, p: Params, xf: torch.Tensor):
    """The float32 router of (T, D) tokens: (renormalised top-k weights
    (T, k), top-k experts (T, k), Switch-style load-balance aux loss)."""
    E, k = cfg.num_experts, cfg.moe_top_k
    probs = torch.softmax((xf @ p["router"]).to(torch.float32), dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = topw / (torch.sum(topw, dim=-1, keepdim=True) + 1e-9)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(topi[:, 0], E).to(torch.float32), dim=0)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)
    return topw, topi, aux


def moe_capacity(cfg: ModelConfig, tokens: int) -> tuple[int, int]:
    """(token chunk, slots per expert in a chunk)."""
    tc = min(MOE_CHUNK, tokens)
    return tc, max(8, int(tc * cfg.moe_top_k / cfg.num_experts
                          * cfg.capacity_factor))


def moe_slots(cfg: ModelConfig, ic: torch.Tensor, cap: int):
    """Dispatch of one chunk's (tc, k) choices, in (token, choice) order:
    each choice's row in the (E * cap + 1, D) buffer, its expert's slot
    number from the one-hot cumsum, and whether it fits; choices past an
    expert's capacity go to the last (dump) row."""
    E = cfg.num_experts
    fi = ic.reshape(-1)
    pos_mat = torch.cumsum(F.one_hot(fi, E).to(torch.int32), dim=0) - 1
    posn = torch.gather(pos_mat, 1, fi[:, None])[:, 0]
    keep = posn < cap
    return torch.where(keep, fi * cap + posn, E * cap), keep


def moe(cfg: ModelConfig, p: Params, x: torch.Tensor
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with capacity and scatter dispatch, in token
    chunks of ``MOE_CHUNK``.  Returns (out (B, S, D), aux_loss).  A kept
    choice is written once into its own buffer row, so the scatter-add has
    no order to get wrong."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    T = B * S
    xf = x.reshape(T, D)
    topw, topi, aux = moe_route(cfg, p, xf)
    tc, cap = moe_capacity(cfg, T)
    t_pad = -(-T // tc) * tc
    xp, wp, ip = (F.pad(t, (0, 0, 0, t_pad - T)) for t in (xf, topw, topi))
    outs = []
    for c0 in range(0, t_pad, tc):
        xc, wc, ic = xp[c0:c0 + tc], wp[c0:c0 + tc], ip[c0:c0 + tc]
        slot, keep = moe_slots(cfg, ic, cap)
        xrep = torch.repeat_interleave(xc, k, dim=0)             # (tc*k, D)
        buf = torch.zeros((E * cap + 1, D), dtype=xc.dtype,
                          device=xc.device).index_add(0, slot, xrep)
        ye = _expert_ffn(p, buf[:E * cap].reshape(E, cap, D))
        yrep = ye.reshape(E * cap, D)[torch.clamp(slot, 0, E * cap - 1)]
        yrep = torch.where(keep[:, None], yrep, 0.0)
        yrep = yrep * wc.reshape(-1)[:, None].to(xc.dtype)
        outs.append(yrep.reshape(tc, k, D).sum(dim=1))
    out = torch.cat(outs)[:T]
    if cfg.num_shared_experts:
        out = out + (F.silu(xf @ p["shared/wg"]) * (xf @ p["shared/wi"])) \
            @ p["shared/wo"]
    return out.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Mamba-1 selective SSM
# ---------------------------------------------------------------------------

def mamba(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba-1 block.  The state h_t = a_t * h_{t-1} + b_t
    runs in float32 as a sequential recurrence in chunks of
    ``MAMBA_CHUNK`` (h carried across chunks); the reference scans each
    chunk associatively, which sums in another order."""
    B, S, D = x.shape
    di, ds, dtr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    kw = cfg.ssm_conv
    u = x @ p["wx"]                                          # (B,S,di)
    z = x @ p["wz"]
    upad = F.pad(u, (0, 0, kw - 1, 0))                       # causal conv
    conv = 0
    for i in range(kw):
        conv = conv + upad[:, i:i + S] * p["conv_w"][i]
    u = F.silu(conv + p["conv_b"])
    xdb = u @ p["x_proj"]                                    # (B,S,dtr+2ds)
    dt = F.softplus(xdb[..., :dtr] @ p["dt_proj"] + p["dt_bias"])
    Bs = xdb[..., dtr:dtr + ds]
    Cs = xdb[..., dtr + ds:].to(torch.float32)
    A = -torch.exp(p["a_log"].to(torch.float32))             # (di,ds)
    a = torch.exp(dt[..., None].to(torch.float32) * A)       # (B,S,di,ds)
    b = (dt[..., None] * Bs[:, :, None, :] * u[..., None]).to(torch.float32)
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, MAMBA_CHUNK):
        hs = []
        for t in range(c0, min(c0 + MAMBA_CHUNK, S)):
            h = a[:, t] * h + b[:, t]
            hs.append(h)
        ys.append(torch.einsum("blds,bls->bld", torch.stack(hs, dim=1),
                               Cs[:, c0:c0 + len(hs)]))
    y = (torch.cat(ys, dim=1) + u.to(torch.float32) * p["d_skip"]).to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"]


def mamba_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, cache: dict):
    """One Mamba-1 step.  x: (B, 1, D) or (B, D); cache ``h`` (B, di, ds)
    float32 and ``conv`` (B, ssm_conv - 1, di), the last inputs of the
    causal conv, both updated in place.  Returns (out (B, 1, D), cache)."""
    B = x.shape[0]
    di, ds, dtr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    u = (x @ p["wx"]).reshape(B, di)
    z = (x @ p["wz"]).reshape(B, di)
    win = torch.cat([cache["conv"], u[:, None]], dim=1)      # (B,kw,di)
    u = F.silu(torch.einsum("bkd,kd->bd", win, p["conv_w"]) + p["conv_b"])
    xdb = u @ p["x_proj"]
    dt = F.softplus(xdb[..., :dtr] @ p["dt_proj"] + p["dt_bias"])
    Bs, Cs = xdb[..., dtr:dtr + ds], xdb[..., dtr + ds:]
    A = -torch.exp(p["a_log"].to(torch.float32))
    a = torch.exp(dt[..., None].to(torch.float32) * A)       # (B,di,ds)
    hb = dt[..., None] * Bs[:, None, :] * u[..., None]
    h = a * cache["h"] + hb.to(torch.float32)
    y = torch.einsum("bds,bs->bd", h, Cs.to(torch.float32))
    y = (y + u.to(torch.float32) * p["d_skip"]).to(x.dtype)
    y = y * F.silu(z)
    cache["h"].copy_(h)
    cache["conv"].copy_(win[:, 1:])
    return (y @ p["out_proj"])[:, None, :], cache
