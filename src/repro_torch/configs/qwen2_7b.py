"""qwen2-7b [dense]: 28L d_model=3584, 28H (GQA kv=4), d_ff=18944,
vocab=152064, QKV bias.  [arXiv:2407.10671]
Counterpart of ``repro/configs/qwen2_7b.py``, with torch dtypes."""
import dataclasses
import torch
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", arch_type="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064, attn_bias=True, rope_theta=1e6,
    dtype=torch.bfloat16, source="arXiv:2407.10671",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=256, dtype=torch.float32)
