"""falcon-mamba-7b [ssm]: 64L d_model=4096 attention-free Mamba-1,
ssm_state=16, vocab=65024.  [arXiv:2410.05355]
Counterpart of ``repro/configs/falcon_mamba_7b.py``, with torch dtypes."""
import dataclasses
import torch
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", arch_type="ssm",
    num_layers=64, d_model=4096, vocab_size=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    dtype=torch.bfloat16, source="arXiv:2410.05355",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, vocab_size=256, ssm_state=8,
    dtype=torch.float32)
