"""The dense transformer LM: parameter shapes, init, forward and loss.

Counterpart of ``repro/models/model.py`` for ``arch_type="dense"``.
Parameters are a flat ``dict[str, Tensor]`` keyed by the reference's
"/"-joined leaf paths (``embed``, ``layers/l0/attn/wq``, ...), with the
layers stacked over depth as ``(L, ...)`` tensors exactly as the
reference's ``param_shapes`` makes them: the sketch operators are per
leaf, and a leaf is the whole stack.  The forward pass loops over the
stack in Python where the reference scans it.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

LOSS_CHUNK = 1024  # sequence chunk for the vocab-softmax loss
Params = Mapping[str, torch.Tensor]


def _check_dense(cfg: ModelConfig) -> None:
    if (cfg.arch_type != "dense" or cfg.mla or cfg.num_experts
            or cfg.encoder_layers or cfg.cross_attention or cfg.mtp
            or cfg.first_dense_layers or cfg.frontend != "none"
            or cfg.pos_kind == "mrope"):
        raise NotImplementedError(
            f"model {cfg.name!r}: only the dense decoder-only family is "
            "ported yet (ROADMAP A18)")


def _norm_shape(cfg: ModelConfig, d: int) -> dict:
    if cfg.norm_kind == "ln":
        return {"scale": (d,), "bias": (d,)}
    return {"scale": (d,)}


def _flatten(prefix: str, tree: dict, out: dict) -> dict:
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            _flatten(path + "/", v, out)
        else:
            out[path] = v
    return out


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Leaf path -> shape, with the layer stack's leading depth axis."""
    _check_dense(cfg)
    D, H, Hk, hd, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                       cfg.d_ff)
    attn = {"ln": _norm_shape(cfg, D), "wq": (D, H * hd),
            "wk": (D, Hk * hd), "wv": (D, Hk * hd), "wo": (H * hd, D)}
    if cfg.attn_bias:
        attn.update({"bq": (H * hd,), "bk": (Hk * hd,), "bv": (Hk * hd,)})
    if cfg.mlp_kind == "gelu":
        mlp = {"ln": _norm_shape(cfg, D), "wi": (D, F), "bi": (F,),
               "wo": (F, D), "bo": (D,)}
    else:
        mlp = {"ln": _norm_shape(cfg, D), "wi": (D, F), "wg": (D, F),
               "wo": (F, D)}
    n_blocks, _ = cfg.scan_blocks()
    layers = _flatten("layers/l0/", {"attn": attn, "mlp": mlp}, {})
    shapes = {"embed": (cfg.padded_vocab, D),
              **_flatten("final_norm/", _norm_shape(cfg, D), {}),
              **{k: (n_blocks,) + s for k, s in layers.items()}}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, cfg.padded_vocab)
    # jax's tree_flatten order of the nested dict: sorted path by component
    return {k: shapes[k] for k in sorted(shapes, key=lambda p: p.split("/"))}


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """The parameter count from the shapes alone.  ``active_only`` counts
    the parameters a token reaches, which differs from the total only for
    mixture-of-experts layers; the dense family here has none."""
    return sum(math.prod(s) for s in param_shapes(cfg).values())


def _init_leaf(generator: torch.Generator, path: str, shape,
               cfg: ModelConfig) -> torch.Tensor:
    """Fan-in scaled normal, ones for scales, zeros for biases (the
    reference's rules; the port draws its own numbers from ``generator``)."""
    if path.endswith("scale"):
        return torch.ones(shape, dtype=cfg.dtype)
    if path.endswith(("bias", "bq", "bk", "bv", "bi", "bo")):
        return torch.zeros(shape, dtype=cfg.dtype)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 0.02 if path.endswith(("embed", "lm_head")) else \
        1.0 / math.sqrt(max(fan_in, 1))
    if path.endswith("wo"):
        std /= math.sqrt(2.0 * max(cfg.num_layers, 1))
    w = torch.randn(shape, generator=generator, dtype=torch.float32) * std
    return w.to(cfg.dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict[str, torch.Tensor]:
    """Random parameters drawn on the host from ``generator``, then moved
    to ``device`` (CUDA unless the caller asks for another)."""
    return {path: _init_leaf(generator, path, shape, cfg).to(device)
            for path, shape in param_shapes(cfg).items()}


def _block(params: Params, prefix: str, layer: int) -> dict:
    """The ``prefix`` sub-dict of one depth slice of the layer stack."""
    return {k[len(prefix):]: v[layer] for k, v in params.items()
            if k.startswith(prefix)}


def _norm(params: Params, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def forward(cfg: ModelConfig, params: Params, batch: Mapping[str, torch.Tensor]
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (hidden (B, S, D), aux_loss)."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"][tokens]
    pos = torch.arange(S, device=tokens.device)
    if cfg.pos_kind == "sinusoidal":
        x = x + L.sinusoidal_embed(pos, cfg.d_model)[None].to(x.dtype)
    positions = pos[None].expand(B, S)
    n_blocks, _ = cfg.scan_blocks()
    window = cfg.sliding_window
    for layer in range(n_blocks):
        attn = _block(params, "layers/l0/attn/", layer)
        mlp = _block(params, "layers/l0/mlp/", layer)
        h = L.apply_norm(cfg, _norm(attn, "ln/"), x)
        x = x + L.attention(cfg, attn, h, positions, causal=True, window=window)
        h = L.apply_norm(cfg, _norm(mlp, "ln/"), x)
        x = x + L.mlp(cfg, mlp, h)
    x = L.apply_norm(cfg, _norm(params, "final_norm/"), x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _logits(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head


def _ce_loss_chunked(cfg: ModelConfig, params: Params, h: torch.Tensor,
                     labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over the padded vocab, chunked along the sequence."""
    S = h.shape[1]
    sc = min(LOSS_CHUNK, S)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, sc):
        logits = _logits(cfg, params, h[:, c0:c0 + sc]).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, c0:c0 + sc, None].long())[..., 0]
        mc = mask[:, c0:c0 + sc].to(torch.float32)
        tot = tot + torch.sum((lse - gold) * mc)
        cnt = cnt + torch.sum(mc)
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(cfg: ModelConfig, params: Params,
            batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Next-token LM loss; the last position has no label and is masked."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    h, aux = forward(cfg, params, batch)
    labels = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
    mask = torch.ones((B, S), dtype=torch.bool, device=tokens.device)
    mask[:, -1] = False
    return _ce_loss_chunked(cfg, params, h, labels, mask) + aux
