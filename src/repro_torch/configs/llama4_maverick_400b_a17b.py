"""Llama-4 Maverick 400B-A17B [hf:meta-llama; unverified].

48L, d_model=5120, 40H (GQA kv=8), d_ff=8192, vocab=202048.
MoE: 128 experts, top-1 routing, shared expert, dense/MoE layers
alternating (period 2) -> ~400B total / ~17B active parameters.
"""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, d_ff=8192,
    vocab_size=202048,
    num_experts=128, experts_per_token=1, moe_period=2, shared_expert=True,
    rope_theta=500000.0,
)
