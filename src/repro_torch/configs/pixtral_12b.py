"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409; unverified].

40L, d_model=5120, 32H (GQA kv=8, head size 160), d_ff=14336,
vocab=131072.  Vision frontend (pixtral ViT) is a stub: batches carry
precomputed patch embeddings prepended to the text sequence.
"""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, d_ff=14336,
    vocab_size=131072,
    rope_theta=1000000.0, frontend="vision", frontend_len=1024,
)
