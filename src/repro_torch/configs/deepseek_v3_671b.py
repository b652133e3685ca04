"""deepseek-v3-671b [moe]: 61L d_model=7168, 128H MLA, vocab=129280,
MoE 256 routed experts top-8 + 1 shared, expert d_ff=2048 (assigned),
dense d_ff=18432 on the 3 leading dense layers, MTP auxiliary head.
[arXiv:2412.19437]
Counterpart of ``repro/configs/deepseek_v3_671b.py``, with torch dtypes."""
import dataclasses
import torch
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", arch_type="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432, vocab_size=129280,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
    num_experts=256, moe_top_k=8, num_shared_experts=1, moe_d_ff=2048,
    first_dense_layers=3, mtp=True,
    dtype=torch.bfloat16, source="arXiv:2412.19437",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, first_dense_layers=1, d_model=128, num_heads=4,
    num_kv_heads=4, d_ff=256, vocab_size=256,
    q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8, qk_nope_dim=16,
    v_head_dim=16, num_experts=4, moe_top_k=2, moe_d_ff=64,
    dtype=torch.float32)
