"""DeepSeek-LLM 7B [arXiv:2401.02954; hf].

30L, d_model=4096, 32H (MHA), d_ff=11008, vocab=102400.  Llama
architecture: RMSNorm + SwiGLU + RoPE.
"""
from repro_torch.models.types import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32, d_ff=11008,
    vocab_size=102400,
)
