"""whisper-large-v3 [audio]: 32L enc + 32L dec, d_model=1280, 20H (kv=20),
d_ff=5120, vocab=51866; conv/mel frontend is a STUB -- input_specs provides
precomputed frame embeddings (1500 frames).  [arXiv:2212.04356]
Counterpart of ``repro/configs/whisper_large_v3.py``, with torch dtypes."""
import dataclasses
import torch
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", arch_type="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    norm_kind="ln", mlp_kind="gelu", pos_kind="sinusoidal",
    encoder_layers=32, encoder_seq=1500, cross_attention=True,
    frontend="audio", dtype=torch.bfloat16, source="arXiv:2212.04356",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, encoder_layers=2, d_model=128, num_heads=4,
    num_kv_heads=4, d_ff=256, vocab_size=256, encoder_seq=24,
    dtype=torch.float32)
