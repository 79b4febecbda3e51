"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B; hf].

48L, d_model=2048, 32H (GQA kv=4), vocab=151936.
MoE on every layer: 128 experts, top-8, expert d_ff=768.
"""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, d_ff=768,
    vocab_size=151936,
    num_experts=128, experts_per_token=8, moe_period=1, moe_d_ff=768,
    qk_norm=True, rope_theta=1000000.0,
)
