"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192, 64H (GQA kv=8),
d_ff=24576, vocab=65536, MoE 16e top-2, Mamba:attention 7:1 interleave
(attn at position 4 of each 8-layer block), MoE every other layer.
[arXiv:2403.19887]
Counterpart of ``repro/configs/jamba_1_5_large_398b.py``, with torch dtypes."""
import dataclasses
import torch
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", arch_type="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    num_experts=16, moe_top_k=2, moe_every=2, moe_offset=1,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    attn_every=8, attn_offset=4,
    dtype=torch.bfloat16, source="arXiv:2403.19887",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=8, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=256, num_experts=4, ssm_state=8,
    dtype=torch.float32)
