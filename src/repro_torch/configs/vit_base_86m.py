"""vit_base_86m: the paper's §5 vision backbone (ViT-Base, 86M),
LM-adapted transformer of the same shape (the paper finetunes it on
CIFAR-10).  [paper §5; arXiv:2010.11929]
Counterpart of ``repro/configs/vit_base_86m.py``, with torch dtypes."""
import dataclasses
import torch
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="vit-base-86m", arch_type="dense",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=1000, norm_kind="ln", mlp_kind="gelu",
    pos_kind="sinusoidal",
    dtype=torch.float32, source="paper §5 / arXiv:2010.11929",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=256)
