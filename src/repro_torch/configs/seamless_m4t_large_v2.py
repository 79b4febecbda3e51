"""SeamlessM4T-large-v2 backbone [arXiv:2308.11596; hf].

Enc-dec multimodal: 24 encoder + 24 decoder layers, d_model=1024, 16H
(GQA kv=16 = MHA), d_ff=8192, vocab=256206.  Speech frontend is a stub
(precomputed frame embeddings feed the encoder).
"""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, encoder_layers=24,
    d_model=1024, num_heads=16, num_kv_heads=16, d_ff=8192,
    vocab_size=256206,
    norm="layernorm", act="gelu", gated_mlp=False,
    tie_embeddings=True, frontend="audio", frontend_len=4096,
)
