"""dbrx-132b [moe]: 40L d_model=6144, 48H (GQA kv=8), d_ff=10752,
vocab=100352, fine-grained MoE 16 experts top-4, LayerNorm.
[hf:databricks/dbrx-base]
Counterpart of ``repro/configs/dbrx_132b.py``, with torch dtypes."""
import dataclasses
import torch
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", arch_type="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352, norm_kind="ln",
    num_experts=16, moe_top_k=4, moe_d_ff=10752, rope_theta=5e5,
    dtype=torch.bfloat16, source="hf:databricks/dbrx-base",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=256, num_experts=4, moe_top_k=2,
    moe_d_ff=64, dtype=torch.float32)
