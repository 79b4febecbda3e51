"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427; unverified].

38L, d_model=4096, 16H (GQA kv=1 on attention layers), d_ff=12288,
vocab=256000.  Block pattern 2 recurrent (RG-LRU) : 1 local attention
(window 2048); 38 = 12 cycles of 3 + 2 remainder recurrent layers.
Sub-quadratic -> runs the long_500k shape.
"""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1, d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"), window=2048, lru_width=4096,
    conv_width=4, act="gelu", tie_embeddings=True,
)
