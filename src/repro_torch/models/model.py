"""The model of every assigned family: parameter shapes, init, forward and
loss (the training path), and the cached decode (the serving path).

Counterpart of ``repro/models/model.py``.  Parameters are a flat
``dict[str, Tensor]`` keyed by the reference's "/"-joined leaf paths
(``embed``, ``layers/l0/attn/wq``, ``layers/l1/moe/shared/wi``, ...), in
jax's flatten order, with each stack of blocks over depth as ``(L, ...)``
tensors exactly as the reference's ``param_shapes`` makes them: the
sketch operators are per leaf, and a leaf is the whole stack.  The forward
pass loops over a stack in Python where the reference scans it.

The decode cache has the same form: a flat dict keyed by the reference's
cache paths (``layers/l0/k`` of shape ``(n_blocks, B, Sc, Hk, hd)``,
``dense_layers/...`` for DeepSeek's leading dense blocks; ``ckv``/``kpe``
for MLA, ``h``/``conv`` for Mamba, ``xk``/``xv`` for cross-attention).
``decode_step`` runs one token through every block, writing each layer's
new entries into the cache in place, and ``encode_for_decode`` fills the
cross-attention caches from the audio encoder.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

LOSS_CHUNK = 1024  # sequence chunk for the vocab-softmax loss
Params = Mapping[str, torch.Tensor]
DENSE = [("attn", "dense")]   # the pattern of leading dense and encoder blocks


# ---------------------------------------------------------------------------
# parameter shapes / init
# ---------------------------------------------------------------------------

def _norm_shape(cfg: ModelConfig, d: int) -> dict:
    if cfg.norm_kind == "ln":
        return {"scale": (d,), "bias": (d,)}
    return {"scale": (d,)}


def _attn_shapes(cfg: ModelConfig, cross: bool = False) -> dict:
    D, H, Hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    if cfg.mla and not cross:
        return {
            "ln": _norm_shape(cfg, D),
            "w_dq": (D, cfg.q_lora_rank),
            "w_uq": (cfg.q_lora_rank, H * (cfg.qk_nope_dim + cfg.qk_rope_dim)),
            "w_dkv": (D, cfg.kv_lora_rank),
            "w_kr": (D, cfg.qk_rope_dim),
            "w_uk": (cfg.kv_lora_rank, H * cfg.qk_nope_dim),
            "w_uv": (cfg.kv_lora_rank, H * cfg.v_head_dim),
            "wo": (H * cfg.v_head_dim, D),
        }
    s = {"ln": _norm_shape(cfg, D),
         "wq": (D, H * hd), "wk": (D, Hk * hd), "wv": (D, Hk * hd),
         "wo": (H * hd, D)}
    if cfg.attn_bias and not cross:
        s.update({"bq": (H * hd,), "bk": (Hk * hd,), "bv": (Hk * hd,)})
    return s


def _mlp_shapes(cfg: ModelConfig) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "gelu":
        return {"ln": _norm_shape(cfg, D), "wi": (D, F_), "bi": (F_,),
                "wo": (F_, D), "bo": (D,)}
    return {"ln": _norm_shape(cfg, D), "wi": (D, F_), "wg": (D, F_),
            "wo": (F_, D)}


def _moe_shapes(cfg: ModelConfig) -> dict:
    D, F_, E = cfg.d_model, cfg.moe_ff, cfg.num_experts
    s = {"ln": _norm_shape(cfg, D), "router": (D, E),
         "wi": (E, D, F_), "wg": (E, D, F_), "wo": (E, F_, D)}
    if cfg.num_shared_experts:
        Fs = F_ * cfg.num_shared_experts
        s["shared"] = {"wi": (D, Fs), "wg": (D, Fs), "wo": (Fs, D)}
    return s


def _mamba_shapes(cfg: ModelConfig) -> dict:
    D, di, ds, dtr, kw = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.dt_rank, cfg.ssm_conv)
    return {"ln": _norm_shape(cfg, D),
            "wx": (D, di), "wz": (D, di),
            "conv_w": (kw, di), "conv_b": (di,),
            "x_proj": (di, dtr + 2 * ds), "dt_proj": (dtr, di),
            "dt_bias": (di,), "a_log": (di, ds), "d_skip": (di,),
            "out_proj": (di, D)}


def _block_shapes(cfg: ModelConfig, pattern, cross: bool = False) -> dict:
    blk = {}
    for i, (mixer, mlp_kind) in enumerate(pattern):
        sub = {}
        if mixer == "attn":
            sub["attn"] = _attn_shapes(cfg)
            if cross:
                sub["xattn"] = _attn_shapes(cfg, cross=True)
        else:
            sub["mamba"] = _mamba_shapes(cfg)
        if mlp_kind == "dense":
            sub["mlp"] = _mlp_shapes(cfg)
        elif mlp_kind == "moe":
            sub["moe"] = _moe_shapes(cfg)
        blk[f"l{i}"] = sub
    return blk


def _flatten(prefix: str, tree: dict, out: dict) -> dict:
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            _flatten(path + "/", v, out)
        else:
            out[path] = v
    return out


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Leaf path -> shape, each stack of blocks with its leading depth
    axis: ``layers`` (the scan blocks), ``dense_layers`` (DeepSeek's
    leading dense blocks) and ``enc_layers`` (Whisper's encoder)."""
    D, V = cfg.d_model, cfg.padded_vocab
    n_blocks, pattern = cfg.scan_blocks()

    def stack(prefix: str, tree: dict, n: int) -> dict:
        return {k: (n,) + s for k, s in _flatten(prefix, tree, {}).items()}

    shapes = {"embed": (V, D),
              **_flatten("final_norm/", _norm_shape(cfg, D), {}),
              **stack("layers/", _block_shapes(cfg, pattern,
                                               cross=cfg.cross_attention),
                      n_blocks)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, V)
    if cfg.first_dense_layers:
        shapes.update(stack("dense_layers/", _block_shapes(cfg, DENSE),
                            cfg.first_dense_layers))
    if cfg.encoder_layers:
        shapes.update(stack("enc_layers/", _block_shapes(cfg, DENSE),
                            cfg.encoder_layers))
        shapes.update(_flatten("enc_norm/", _norm_shape(cfg, D), {}))
    if cfg.mtp:
        shapes["mtp_head"] = (D, V)
    # jax's tree_flatten order of the nested dict: sorted path by component
    return {k: shapes[k] for k in sorted(shapes, key=lambda p: p.split("/"))}


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """The parameter count from the shapes alone.  ``active_only`` counts
    the expert weights a token reaches, top-k of the experts, with the
    reference's rule (every ``wi``/``wg``/``wo`` under ``moe``, the shared
    expert's included)."""
    total = 0
    for path, shape in param_shapes(cfg).items():
        n = math.prod(shape)
        if active_only and "/moe/" in path and \
                path.split("/")[-1] in ("wi", "wg", "wo"):
            n = int(n * cfg.moe_top_k / max(cfg.num_experts, 1))
        total += n
    return total


def _init_leaf(generator: torch.Generator, path: str, shape,
               cfg: ModelConfig) -> torch.Tensor:
    """The reference's rules: ones for scales and the SSM's D skip, zeros
    for biases (``dt_bias`` among them: the reference's "bias" rule comes
    before its -4.6 rule), ``a_log`` = log(1..ds) on every channel, else a
    fan-in scaled normal (0.02 for the embedding and output heads, output
    projections scaled down with depth).  The port draws its own numbers
    from ``generator``, on the generator's device."""
    dev = generator.device
    if path.endswith(("scale", "d_skip")):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)
    if path.endswith(("bias", "conv_b", "bq", "bk", "bv", "bi", "bo")):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)
    if path.endswith("a_log"):
        a = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                   device=dev))
        return a.expand(shape).to(cfg.dtype)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 0.02 if path.endswith(("embed", "lm_head", "mtp_head")) else \
        1.0 / math.sqrt(max(fan_in, 1))
    if path.endswith(("wo", "out_proj")):
        std /= math.sqrt(2.0 * max(cfg.num_layers, 1))
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=dev) * std
    return w.to(cfg.dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict[str, torch.Tensor]:
    """Random parameters drawn from ``generator`` on its own device (a CPU
    generator gives the same numbers wherever they go), then moved to
    ``device`` (CUDA unless the caller asks for another)."""
    return {path: _init_leaf(generator, path, shape, cfg).to(device)
            for path, shape in param_shapes(cfg).items()}


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def _sub(params: Params, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def _apply_block(cfg: ModelConfig, pattern, blk: Params, x: torch.Tensor,
                 positions: torch.Tensor, *,
                 enc_out: Optional[torch.Tensor] = None,
                 bidirectional: bool = False):
    """All sub-layers of one block (one depth slice of a stack).  Returns
    (x, the MoE layers' aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (mixer, mlp_kind) in enumerate(pattern):
        sub = _sub(blk, f"l{i}/")
        if mixer == "attn":
            p = _sub(sub, "attn/")
            h = L.apply_norm(cfg, _sub(p, "ln/"), x)
            if cfg.mla:
                h = L.mla_attention(cfg, p, h, positions)
            else:
                h = L.attention(cfg, p, h, positions, causal=not bidirectional,
                                window=cfg.sliding_window)
            x = x + h
            xp = _sub(sub, "xattn/")
            if enc_out is not None and xp:
                h = L.apply_norm(cfg, _sub(xp, "ln/"), x)
                x = x + L.attention(cfg, xp, h, positions, enc_out=enc_out)
        else:
            p = _sub(sub, "mamba/")
            x = x + L.mamba(cfg, p, L.apply_norm(cfg, _sub(p, "ln/"), x))
        if mlp_kind == "dense":
            p = _sub(sub, "mlp/")
            x = x + L.mlp(cfg, p, L.apply_norm(cfg, _sub(p, "ln/"), x))
        elif mlp_kind == "moe":
            p = _sub(sub, "moe/")
            h, a = L.moe(cfg, p, L.apply_norm(cfg, _sub(p, "ln/"), x))
            x = x + h
            aux = aux + a
    return x, aux


def remat_block(remat: bool, fn, *args, **kw):
    """``fn(*args, **kw)``, one block; with ``remat`` and grad on, under
    ``torch.utils.checkpoint``: the reference's ``jax.checkpoint`` around
    each block, whose default policy keeps nothing inside it.  The backward
    keeps the block's arguments, runs the block again where it first needs
    an activation, and stops at the last one it needs (PyTorch's early
    stop; XLA drops the recompute no gradient reads).  Non-reentrant,
    since the weights reach the block inside dicts and ``Blocks``, whose
    gradients the reentrant form would drop; no RNG state, since no block
    draws random numbers.  Under ``no_grad`` the block runs plainly.  A
    ``torch.func`` transform cannot run a checkpointed block (PyTorch
    refuses its saved-tensor hooks): its callers pass ``remat=False``."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          **kw)
    return fn(*args, **kw)


def _run_blocks(cfg: ModelConfig, pattern, params: Params, prefix: str,
                x: torch.Tensor, positions: torch.Tensor, *, remat: bool = True,
                **kw):
    """Every block of the stack under ``prefix``, in depth order, each
    recomputed in the backward under ``remat`` (``remat_block``)."""
    stack = _sub(params, prefix)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(next(iter(stack.values())).shape[0]):
        x, a = remat_block(remat, _apply_block, cfg, pattern,
                           {k: v[layer] for k, v in stack.items()}, x, positions,
                           **kw)
        aux = aux + a
    return x, aux


def _positions_for(cfg: ModelConfig, B: int, S: int, device) -> torch.Tensor:
    """(B, S) positions; for M-RoPE (3, B, S): the patches on a square
    grid at t = 0, the text after the grid on all three rows."""
    if cfg.pos_kind == "mrope":
        P = cfg.num_frontend_tokens
        grid = max(1, math.isqrt(max(P, 1)))
        pidx = torch.arange(P, dtype=torch.int32, device=device)
        text = torch.arange(S - P, dtype=torch.int32, device=device) + grid
        pos = torch.stack([torch.cat([torch.zeros_like(pidx), text]),
                           torch.cat([pidx // grid, text]),
                           torch.cat([pidx % grid, text])])      # (3, S)
        return pos[:, None, :].expand(3, B, S)
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def forward(cfg: ModelConfig, params: Params, batch: Mapping[str, torch.Tensor],
            *, remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (hidden (B, S, D), aux_loss).  A
    vision model's ``patch_embeds`` go in front of the tokens; an audio
    model's ``audio_embeds`` run through the bidirectional encoder, whose
    output the decoder blocks cross-attend to.  ``remat`` (the reference's
    default, on) recomputes every block of the encoder, the leading dense
    layers and the main stack in the backward (``remat_block``)."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    dev = tokens.device
    n_blocks, pattern = cfg.scan_blocks()
    x = params["embed"][tokens]
    if cfg.frontend == "vision":
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = _positions_for(cfg, B, S, dev)
    if cfg.pos_kind == "sinusoidal":
        x = x + L.sinusoidal_embed(torch.arange(S, device=dev),
                                   cfg.d_model)[None].to(x.dtype)
    enc_out = None
    if cfg.encoder_layers:
        e = batch["audio_embeds"].to(x.dtype)
        Te = e.shape[1]
        e = e + L.sinusoidal_embed(torch.arange(Te, device=dev),
                                   cfg.d_model)[None].to(e.dtype)
        e, _ = _run_blocks(cfg, DENSE, params, "enc_layers/", e,
                           _positions_for(cfg, B, Te, dev), bidirectional=True,
                           remat=remat)
        enc_out = L.apply_norm(cfg, _sub(params, "enc_norm/"), e)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.first_dense_layers:
        x, a = _run_blocks(cfg, DENSE, params, "dense_layers/", x, positions,
                           remat=remat)
        aux = aux + a
    x, a = _run_blocks(cfg, pattern, params, "layers/", x, positions,
                       enc_out=enc_out, remat=remat)
    aux = aux + a
    return L.apply_norm(cfg, _sub(params, "final_norm/"), x), aux


def _logits(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocabulary (the tied embedding or the head)."""
    return h @ (params["embed"].T if cfg.tie_embeddings else params["lm_head"])


def _ce_loss_chunked(cfg: ModelConfig, params: Params, h: torch.Tensor,
                     labels: torch.Tensor, mask: torch.Tensor,
                     head_name: str = "lm_head") -> torch.Tensor:
    """Cross-entropy over the padded vocab, chunked along the sequence."""
    head = params["embed"].T if cfg.tie_embeddings else params[head_name]
    S = h.shape[1]
    sc = min(LOSS_CHUNK, S)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, sc):
        logits = (h[:, c0:c0 + sc] @ head).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, c0:c0 + sc, None].long())[..., 0]
        mc = mask[:, c0:c0 + sc].to(torch.float32)
        tot = tot + torch.sum((lse - gold) * mc)
        cnt = cnt + torch.sum(mc)
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(cfg: ModelConfig, params: Params,
            batch: Mapping[str, torch.Tensor], *, remat: bool = True) -> torch.Tensor:
    """Next-token LM loss over the text positions (a VLM's patches carry
    none; the last position has no label), plus DeepSeek's MTP term (the
    token two ahead through ``mtp_head``, weighted ``mtp_weight``) and the
    MoE aux loss.  ``remat`` goes to ``forward``: the same value, and the
    same gradients bit for bit, from less memory."""
    tokens = batch["tokens"]
    B, St = tokens.shape
    h, aux = forward(cfg, params, batch, remat=remat)
    P = cfg.num_frontend_tokens if cfg.frontend == "vision" else 0
    ht = h[:, P:]
    labels = F.pad(tokens[:, 1:], (0, 1))
    mask = torch.ones((B, St), dtype=torch.bool, device=tokens.device)
    mask[:, -1] = False
    loss = _ce_loss_chunked(cfg, params, ht, labels, mask)
    if cfg.mtp:
        labels2 = F.pad(tokens[:, 2:], (0, 2))
        mask2 = torch.ones((B, St), dtype=torch.bool, device=tokens.device)
        mask2[:, -2:] = False
        loss = loss + cfg.mtp_weight * _ce_loss_chunked(
            cfg, params, ht, labels2, mask2, head_name="mtp_head")
    return loss + aux


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def _cache_shapes_block(cfg: ModelConfig, pattern, B: int, max_seq: int,
                        cross: bool) -> dict:
    """One block's cache shapes by path (``l0/k``, ...): an attention
    layer keeps ``min(max_seq, sliding_window)`` slots (a ring) or
    max_seq, MLA its latent and rotary key, cross-attention the encoder's
    ``encoder_seq`` keys and values, Mamba its state and conv window."""
    Hk, hd = cfg.num_kv_heads, cfg.hd
    out = {}
    for i, (mixer, _) in enumerate(pattern):
        if mixer == "attn":
            if cfg.mla:
                out[f"l{i}/ckv"] = (B, max_seq, cfg.kv_lora_rank)
                out[f"l{i}/kpe"] = (B, max_seq, cfg.qk_rope_dim)
            else:
                sc = min(max_seq, cfg.sliding_window) if cfg.sliding_window \
                    else max_seq
                out[f"l{i}/k"] = (B, sc, Hk, hd)
                out[f"l{i}/v"] = (B, sc, Hk, hd)
            if cross:
                out[f"l{i}/xk"] = (B, cfg.encoder_seq, Hk, hd)
                out[f"l{i}/xv"] = (B, cfg.encoder_seq, Hk, hd)
        else:
            out[f"l{i}/h"] = (B, cfg.d_inner, cfg.ssm_state)
            out[f"l{i}/conv"] = (B, cfg.ssm_conv - 1, cfg.d_inner)
    return out


def cache_shapes(cfg: ModelConfig, B: int, max_seq: int) -> dict[str, tuple[int, ...]]:
    """Cache path -> shape, each stack with its leading depth axis, in
    jax's flatten order."""
    n_blocks, pattern = cfg.scan_blocks()
    shapes = {f"layers/{k}": (n_blocks,) + s for k, s in _cache_shapes_block(
        cfg, pattern, B, max_seq, cfg.cross_attention).items()}
    if cfg.first_dense_layers:
        shapes.update({f"dense_layers/{k}": (cfg.first_dense_layers,) + s
                       for k, s in _cache_shapes_block(
                           cfg, DENSE, B, max_seq, False).items()})
    return {k: shapes[k] for k in sorted(shapes, key=lambda p: p.split("/"))}


def _cache_dtype(cfg: ModelConfig, path: str) -> torch.dtype:
    """The reference's rule, a suffix match: a path ending in ``h`` (the
    Mamba state) is float32, every other entry ``cfg.dtype``."""
    return torch.float32 if path.endswith(("h",)) else cfg.dtype


def init_cache(cfg: ModelConfig, B: int, max_seq: int,
               device="cuda") -> dict[str, torch.Tensor]:
    """A zero cache for ``B`` sequences of up to ``max_seq`` positions, on
    ``device`` (CUDA unless the caller asks for another)."""
    return {path: torch.zeros(shape, dtype=_cache_dtype(cfg, path), device=device)
            for path, shape in cache_shapes(cfg, B, max_seq).items()}


def _decode_block(cfg: ModelConfig, pattern, blk: Params, cache_blk: dict,
                  x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One token through one block (one depth slice of a stack); the
    layers write their entries into ``cache_blk``'s views in place."""
    for i, (mixer, mlp_kind) in enumerate(pattern):
        sub, csub = _sub(blk, f"l{i}/"), _sub(cache_blk, f"l{i}/")
        if mixer == "attn":
            p = _sub(sub, "attn/")
            h = L.apply_norm(cfg, _sub(p, "ln/"), x)
            if cfg.mla:
                h, _ = L.mla_attention_decode(cfg, p, h, pos, csub)
            else:
                h, _ = L.attention_decode(cfg, p, h, pos, csub,
                                          window=cfg.sliding_window)
            x = x + h
            xp = _sub(sub, "xattn/")
            if "xk" in csub and xp:
                h = L.apply_norm(cfg, _sub(xp, "ln/"), x)
                x = x + L.cross_attention_decode(cfg, xp, h, csub)
        else:
            p = _sub(sub, "mamba/")
            h, _ = L.mamba_decode(cfg, p, L.apply_norm(cfg, _sub(p, "ln/"), x), csub)
            x = x + h
        if mlp_kind == "dense":
            p = _sub(sub, "mlp/")
            x = x + L.mlp(cfg, p, L.apply_norm(cfg, _sub(p, "ln/"), x))
        elif mlp_kind == "moe":
            p = _sub(sub, "moe/")
            x = x + L.moe(cfg, p, L.apply_norm(cfg, _sub(p, "ln/"), x))[0]
    return x


def _decode_blocks(cfg: ModelConfig, pattern, params: Params, cache: dict,
                   prefix: str, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One token through every block of the stack under ``prefix``."""
    stack, cstack = _sub(params, prefix), _sub(cache, prefix)
    for layer in range(next(iter(stack.values())).shape[0]):
        x = _decode_block(cfg, pattern, {k: v[layer] for k, v in stack.items()},
                          {k: v[layer] for k, v in cstack.items()}, x, pos)
    return x


@torch.no_grad()
def encode_for_decode(cfg: ModelConfig, params: Params, cache: dict,
                      audio_embeds: torch.Tensor) -> dict:
    """Run the encoder once, bidirectionally, and fill every decoder
    block's cross-attention cache: ``xk``/``xv`` = enc_out @ wk / wv, with
    no bias, as the reference does (Whisper-style serving).  Writes into
    ``cache`` in place and returns it."""
    B, Te, _ = audio_embeds.shape
    dev = audio_embeds.device
    e = audio_embeds + L.sinusoidal_embed(
        torch.arange(Te, device=dev), cfg.d_model)[None].to(audio_embeds.dtype)
    e, _ = _run_blocks(cfg, DENSE, params, "enc_layers/", e,
                       _positions_for(cfg, B, Te, dev), bidirectional=True)
    enc_out = L.apply_norm(cfg, _sub(params, "enc_norm/"), e)
    Hk, hd = cfg.num_kv_heads, cfg.hd
    for path, c in cache.items():
        head, _, leaf = path.rpartition("/")
        if leaf in ("xk", "xv"):
            w = params[f"{head}/xattn/w{leaf[1]}"]           # (n_blocks, D, Hk*hd)
            for layer in range(c.shape[0]):
                c[layer].copy_((enc_out @ w[layer]).reshape(B, Te, Hk, hd))
    return cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Params, cache: dict,
                tokens: torch.Tensor, pos: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode.  tokens: (B, 1); pos: 0-d integer tensor on the
    cache's device, the position to fill (kept on the device: no host
    sync).  Unlike the reference, which returns an updated copy, the
    caller's ``cache`` is updated in place, and returned.  Returns
    (logits (B, vocab_size), cache); the logits are the padded
    vocabulary's first ``vocab_size`` columns."""
    n_blocks, pattern = cfg.scan_blocks()
    x = params["embed"][tokens]                              # (B,1,D)
    if cfg.pos_kind == "sinusoidal":
        x = x + L.sinusoidal_embed(pos[None], cfg.d_model)[None].to(x.dtype)
    if cfg.first_dense_layers:
        x = _decode_blocks(cfg, DENSE, params, cache, "dense_layers/", x, pos)
    x = _decode_blocks(cfg, pattern, params, cache, "layers/", x, pos)
    x = L.apply_norm(cfg, _sub(params, "final_norm/"), x)
    return _logits(cfg, params, x)[:, 0, :cfg.vocab_size], cache
