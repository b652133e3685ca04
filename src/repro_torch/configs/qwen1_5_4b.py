"""qwen1.5-4b [dense]: 40L d_model=2560, 20H (kv=20, MHA), d_ff=6912,
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family scaling]
Counterpart of ``repro/configs/qwen1_5_4b.py``, with torch dtypes."""
import dataclasses
import torch
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", arch_type="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
    d_ff=6912, vocab_size=151936, attn_bias=True,
    dtype=torch.bfloat16, source="hf:Qwen/Qwen1.5-0.5B",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=256, dtype=torch.float32)
