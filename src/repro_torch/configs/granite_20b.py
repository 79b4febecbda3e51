"""Granite-20B code [arXiv:2405.04324; hf].

52L, d_model=6144, 48H (MQA kv=1), d_ff=24576, vocab=49152.
gpt-bigcode lineage: LayerNorm, classic 4x FFN (non-gated, gelu).
"""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1, d_ff=24576,
    vocab_size=49152,
    norm="layernorm", act="gelu", gated_mlp=False,
)
