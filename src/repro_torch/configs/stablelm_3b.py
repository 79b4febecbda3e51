"""StableLM-2 3B-class [hf:stabilityai/stablelm-2-1_6b; unverified].

32L, d_model=2560, 32H (MHA, head size 80), d_ff=6912, vocab=50304.
LayerNorm + partial rotary (25%).
"""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32, d_ff=6912,
    vocab_size=50304,
    norm="layernorm", rope_fraction=0.25,
)
