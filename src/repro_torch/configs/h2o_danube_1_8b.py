"""h2o-danube-1.8b [dense]: 24L d_model=2560, 32H (GQA kv=8), d_ff=6912,
vocab=32000, llama+mistral mix with sliding-window attention (window=4096)
=> long_500k eligible.  [arXiv:2401.16818]
Counterpart of ``repro/configs/h2o_danube_1_8b.py``, with torch dtypes."""
import dataclasses
import torch
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", arch_type="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=6912, vocab_size=32000, sliding_window=4096,
    dtype=torch.bfloat16, source="arXiv:2401.16818",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=256, sliding_window=16, dtype=torch.float32)
