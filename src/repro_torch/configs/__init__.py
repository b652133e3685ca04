"""Architecture registry, input-shape table and input specs (counterpart
of ``repro/configs/__init__.py``).

Every assigned architecture is a module exposing ``CONFIG`` (the exact
published configuration, source cited in ``ModelConfig.source``) and
``SMOKE`` (a reduced same-family variant: <=2 scan blocks, d_model<=512,
<=4 experts) for the CPU tests.  ``input_specs`` gives every model input
of a named shape as a tensor on the ``meta`` device (PyTorch's
counterpart of a ``ShapeDtypeStruct``): nothing is allocated.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import ModelConfig

ARCHS = [
    "falcon_mamba_7b",
    "whisper_large_v3",
    "jamba_1_5_large_398b",
    "qwen2_vl_7b",
    "h2o_danube_1_8b",
    "llama3_2_1b",
    "qwen1_5_4b",
    "deepseek_v3_671b",
    "qwen2_7b",
    "dbrx_132b",
    # the paper's own experimental backbones (§5), LM-adapted
    "bert_100m",
    "vit_base_86m",
]

ASSIGNED = ARCHS[:10]


def canon(name: str) -> str:
    """Canonical module id: dashes and dots as underscores."""
    return name.replace("-", "_").replace(".", "_")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524288, 1,   "decode"),
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canon(name)}")
    return mod.SMOKE if smoke else mod.CONFIG


def long_context_eligible(cfg: ModelConfig) -> bool:
    """long_500k needs sub-quadratic attention: SSM, hybrid, or native
    sliding-window.  Pure full-attention archs are skipped."""
    if cfg.arch_type in ("ssm", "hybrid"):
        return True
    return cfg.sliding_window > 0


def shape_eligible(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and not long_context_eligible(cfg):
        return False, "SKIP(full-attention: no sub-quadratic variant)"
    return True, ""


def input_specs(cfg: ModelConfig, shape: str, *, num_clients: int = 16,
                local_steps: int = 1) -> dict:
    """``meta`` tensors for every model input of ``shape`` (no allocation),
    with the reference's shapes and dtypes (int32 tokens and position):
    ``{"batch": {...}}`` for train (``(G, K, mb, ...)``) and prefill; for
    decode ``{"cache": {path: ...}, "tokens": (b, 1), "pos": ()}``, the
    cache from ``cache_shapes`` and ``_cache_dtype``."""
    from repro_torch.models.model import _cache_dtype, cache_shapes
    sh = INPUT_SHAPES[shape]
    f = lambda s, d=torch.int32: torch.empty(tuple(s), dtype=d, device="meta")
    P = cfg.num_frontend_tokens if cfg.frontend == "vision" else 0

    if sh.kind in ("train", "prefill"):
        if sh.kind == "train":
            g, k = num_clients, local_steps
            assert sh.global_batch % (g * k) == 0
            lead = (g, k, sh.global_batch // (g * k))
        else:
            lead = (sh.global_batch,)
        batch = {"tokens": f(lead + (sh.seq_len - P,))}
        if cfg.frontend == "vision":
            batch["patch_embeds"] = f(lead + (P, cfg.d_model), cfg.dtype)
        if cfg.frontend == "audio":
            batch["audio_embeds"] = f(lead + (cfg.encoder_seq, cfg.d_model),
                                      cfg.dtype)
        return {"batch": batch}

    # decode: one new token against a seq_len-deep cache
    b = sh.global_batch
    cache = {path: f(s, _cache_dtype(cfg, path))
             for path, s in cache_shapes(cfg, b, sh.seq_len).items()}
    return {"cache": cache, "tokens": f((b, 1)), "pos": f(())}
