"""llama3.2-1b [dense]: 16L d_model=2048, 32H (GQA kv=8), d_ff=8192,
vocab=128256, tied embeddings, rope theta 5e5.
[hf:meta-llama/Llama-3.2-1B]
Counterpart of ``repro/configs/llama3_2_1b.py``, with torch dtypes."""
import dataclasses
import torch
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", arch_type="dense",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=128256, rope_theta=500000.0, tie_embeddings=True,
    dtype=torch.bfloat16, source="hf:meta-llama/Llama-3.2-1B",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=256, dtype=torch.float32)
