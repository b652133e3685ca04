"""ADA_OPT: server-side adaptive optimizers (paper Algorithm 2), in PyTorch.

Counterpart of ``repro/core/adaptive.py``: amsgrad, adam, adagrad, sgd and
sgdm over flat ``dict[str, Tensor]`` trees, with the reference's update
arithmetic (float32 math, ``eps`` outside the square root, no bias
correction unless asked).  Pure functions: new tensors out, inputs
untouched.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch

Tree = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdaConfig:
    name: str = "amsgrad"      # amsgrad | adam | adagrad | sgd | sgdm
    lr: float = 1e-2           # kappa in Alg. 2
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    bias_correction: bool = False  # Alg. 2 uses none; Adam-mode may enable
    weight_decay: float = 0.0
    moment_dtype: Any = torch.float32

    def __post_init__(self):
        if self.name not in ("amsgrad", "adam", "adagrad", "sgd", "sgdm"):
            raise ValueError(f"unknown optimizer {self.name}")


def init_opt_state(cfg: AdaConfig, params: Tree) -> dict:
    """``{"step": 0, "m"/"v"/"vhat": zeros like params}`` as the optimizer
    needs them, on the parameters' device."""
    zeros = lambda: {k: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                    device=p.device)
                     for k, p in params.items()}
    device = next(iter(params.values())).device
    state = {"step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.name in ("amsgrad", "adam", "sgdm"):
        state["m"] = zeros()
    if cfg.name in ("amsgrad", "adam", "adagrad"):
        state["v"] = zeros()
    if cfg.name == "amsgrad":
        state["vhat"] = zeros()
    return state


def apply_update(cfg: AdaConfig, state: dict, params: Tree, update: Tree,
                 lr_scale: float = 1.0) -> tuple[dict, dict]:
    """One ADA_OPT step with the (pseudo-)gradient ``update``.  Returns
    (new_params, new_state)."""
    step = state["step"] + 1
    lr = cfg.lr * lr_scale
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
    md = cfg.moment_dtype
    f32 = lambda t: t.to(torch.float32)
    u32 = {k: f32(u) for k, u in update.items()}

    if cfg.name == "sgd":
        direction = u32
        new_state = {"step": step}
    elif cfg.name == "sgdm":
        m = {k: (b1 * f32(state["m"][k]) + u).to(md) for k, u in u32.items()}
        direction = {k: f32(x) for k, x in m.items()}
        new_state = {"step": step, "m": m}
    elif cfg.name == "adagrad":
        v = {k: (f32(state["v"][k]) + u * u).to(md) for k, u in u32.items()}
        direction = {k: u / (torch.sqrt(f32(v[k])) + eps) for k, u in u32.items()}
        new_state = {"step": step, "v": v}
    else:  # adam / amsgrad (Alg. 2)
        m = {k: (b1 * f32(state["m"][k]) + (1 - b1) * u).to(md)
             for k, u in u32.items()}
        v = {k: (b2 * f32(state["v"][k]) + (1 - b2) * u * u).to(md)
             for k, u in u32.items()}
        new_state = {"step": step, "m": m, "v": v}
        if cfg.name == "amsgrad":
            vhat = {k: torch.maximum(state["vhat"][k], v[k]) for k in v}
            new_state["vhat"] = vhat
            precond = vhat
        else:
            precond = v
        if cfg.bias_correction:
            t = step.to(torch.float32)
            c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                            device=t.device), t)
            c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                            device=t.device), t)
        else:
            c1 = c2 = 1.0
        direction = {k: (f32(m[k]) / c1) / (torch.sqrt(f32(precond[k]) / c2) + eps)
                     for k in m}

    if cfg.weight_decay:
        direction = {k: d + cfg.weight_decay * f32(params[k])
                     for k, d in direction.items()}

    new_params = {k: (f32(p) - lr * direction[k]).to(p.dtype)
                  for k, p in params.items()}
    return new_params, new_state


def opt_state_bytes(cfg: AdaConfig, params: Mapping[str, Any]) -> int:
    """The optimizer state's memory in bytes (``params``: anything with
    ``.shape``): one moment tree per buffer the optimizer keeps."""
    n = sum(math.prod(p.shape) for p in params.values())
    per = {"sgd": 0, "sgdm": 1, "adagrad": 1, "adam": 2, "amsgrad": 3}[cfg.name]
    return n * per * torch.empty((), dtype=cfg.moment_dtype).element_size()
