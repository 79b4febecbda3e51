"""RWKV-6 "Finch" 3B [arXiv:2404.05892; hf].

32L, d_model=2560 (40 heads x 64), channel-mix d_ff=8960, vocab=65536.
Attention-free data-dependent-decay linear recurrence; O(1) decode state.
"""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40, d_ff=8960,
    vocab_size=65536,
    block_pattern=("rwkv",), rwkv_head_dim=64, norm="layernorm",
)
