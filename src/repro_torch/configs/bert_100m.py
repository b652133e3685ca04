"""bert_100m: the paper's §5 language backbone (BERT-base scale, 100M),
LM-adapted (decoder-only).  Counterpart of
``repro/configs/bert_100m.py``, with torch dtypes.
[paper §5; arXiv:1810.04805]"""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="bert-100m", arch_type="dense",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=30522, norm_kind="ln", mlp_kind="gelu",
    pos_kind="sinusoidal",
    dtype=torch.float32, source="paper §5 / arXiv:1810.04805",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=256)
