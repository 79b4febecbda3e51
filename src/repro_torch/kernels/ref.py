"""The plain PyTorch oracles of the LM kernels (counterpart of
``repro/kernels/ref.py``).  Each lives beside its kernel's wrapper."""
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.rwkv6_scan import wkv6_scan_ref

__all__ = ["attention_ref", "wkv6_scan_ref"]
