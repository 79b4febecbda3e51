"""Qwen3-1.7B [hf:Qwen/Qwen3-8B; hf].

28L, d_model=2048, 16H (GQA kv=8), d_ff=6144, vocab=151936, qk-norm.
"""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8, d_ff=6144,
    vocab_size=151936,
    qk_norm=True, rope_theta=1000000.0, tie_embeddings=True,
)
