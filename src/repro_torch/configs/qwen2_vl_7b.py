"""qwen2-vl-7b [vlm]: 28L d_model=3584, 28H (GQA kv=4), d_ff=18944,
vocab=152064, M-RoPE; the ViT frontend is a STUB -- input_specs provides
patch embeddings (256 tokens, 16x16 grid stand-in for dynamic resolution).
[arXiv:2409.12191]
Counterpart of ``repro/configs/qwen2_vl_7b.py``, with torch dtypes."""
import dataclasses
import torch
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", arch_type="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064,
    attn_bias=True, pos_kind="mrope", mrope_sections=(16, 24, 24),
    rope_theta=1e6, frontend="vision", num_frontend_tokens=256,
    dtype=torch.bfloat16, source="arXiv:2409.12191",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=256, mrope_sections=(8, 4, 4),
    num_frontend_tokens=16, dtype=torch.float32)
