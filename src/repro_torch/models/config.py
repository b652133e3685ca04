"""Model configuration (counterpart of ``repro/models/config.py``).

The same fields as the reference, with torch dtypes, so a config file of
the reference copies over unchanged apart from its dtype.  The port's
model trains and serves (cached decode) every family."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0        # 0 => attention-free (pure SSM)
    num_kv_heads: int = 0
    head_dim: int = 0         # 0 => d_model // num_heads
    d_ff: int = 0

    # -- attention options -------------------------------------------------
    attn_bias: bool = False           # Qwen-style QKV bias
    sliding_window: int = 0           # 0 = full attention
    swa_every: int = 1                # SWA on layers where (l % swa_every)!=0
    rope_theta: float = 10000.0
    pos_kind: str = "rope"            # rope | mrope | sinusoidal
    mrope_sections: tuple = (16, 24, 24)  # head_dim split (t, h, w)

    # -- MLA (DeepSeek) -----------------------------------------------------
    mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # -- MLP / MoE ----------------------------------------------------------
    norm_kind: str = "rms"            # rms | ln
    mlp_kind: str = "swiglu"          # swiglu | gelu
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                 # expert hidden dim (defaults to d_ff)
    first_dense_layers: int = 0       # DeepSeek: leading dense layers
    moe_every: int = 1                # MoE on layers where (l % moe_every)==moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01   # load-balance aux loss

    # -- SSM (Mamba-1) / hybrid ----------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0              # 0 => ceil(d_model / 16)
    attn_every: int = 0               # hybrid: one attn layer per this many
    attn_offset: int = 4              # position of the attn layer in a block

    # -- encoder-decoder (Whisper) -------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0              # precomputed frame embeddings (stub)
    cross_attention: bool = False

    # -- modality frontend stubs ----------------------------------------------
    frontend: str = "none"            # none | audio | vision
    num_frontend_tokens: int = 0      # patch embeddings prepended (vision)

    # -- extras ----------------------------------------------------------------
    pad_vocab_to: int = 128           # embedding rows padded to this multiple
    mtp: bool = False                 # DeepSeek multi-token prediction loss
    mtp_weight: float = 0.3
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: Any = torch.float32          # parameter/activation dtype
    source: str = ""                  # citation for the config

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def moe_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def layer_kinds(self) -> list[tuple[str, str]]:
        """Static per-depth (mixer, mlp) descriptors.

        mixer in {attn, mamba}; mlp in {dense, moe, none}.
        Pure-SSM archs (mamba1) have no separate MLP (mixer includes it).
        """
        kinds = []
        for l in range(self.num_layers):
            if self.arch_type == "ssm":
                kinds.append(("mamba", "none"))
                continue
            if self.attn_every:  # hybrid
                mixer = "attn" if (l % self.attn_every) == self.attn_offset else "mamba"
            elif self.num_heads:
                mixer = "attn"
            else:
                mixer = "mamba"
            if self.num_experts and l >= self.first_dense_layers and \
                    (l % self.moe_every) == self.moe_offset:
                mlp = "moe"
            else:
                mlp = "dense"
            kinds.append((mixer, mlp))
        return kinds

    def scan_blocks(self) -> tuple[int, list[tuple[str, str]]]:
        """(num_blocks, block_pattern): the smallest repeating suffix
        pattern; parameters are stacked over the num_blocks repeats.
        Leading non-repeating layers (first_dense_layers) are handled
        separately by the model."""
        kinds = self.layer_kinds()[self.first_dense_layers:]
        n = len(kinds)
        for plen in range(1, n + 1):
            if n % plen == 0 and kinds == kinds[:plen] * (n // plen):
                return n // plen, kinds[:plen]
        return 1, kinds

    def uses_swa(self, l: int) -> bool:
        return self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-flops accounting)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self, active_only=True)
