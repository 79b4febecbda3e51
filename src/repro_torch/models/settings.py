"""Thread-local model execution settings (the port's own copy of
``repro/models/settings.py``).

Training reads ``vocab_chunk``: with it set, ``LM.loss`` computes the head
and the cross-entropy over vocabulary chunks (:func:`repro_torch.models.
lm.fused_xent`), so the (B, T, V) float32 logits never exist at once, on
one device or on any mesh (a head split over the model axis runs each
rank's slice chunk by chunk, and the ranks combine their results).
``q_chunk``, ``kv_chunk`` and ``wkv_chunk`` keep the reference's names and
defaults as constants only: the port's attention and WKV recurrence are
kernels with tiles of their own, so :func:`use` refuses them rather than
accept a setting that would change nothing.  The reference's
``layer_unroll`` and ``unroll_attn`` shape its traced loops and have no
counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading


@dataclasses.dataclass(frozen=True)
class Settings:
    q_chunk: int = 512
    kv_chunk: int = 512
    wkv_chunk: int = 128
    #: fused cross-entropy: compute head matmul + logsumexp over vocab
    #: chunks so the (B, T, V) f32 logits tensor never materialises.
    vocab_chunk: int = 0          # 0 = disabled (plain head + loss)


#: the fields the port reads; :func:`use` refuses every other one
SETTABLE = frozenset({"vocab_chunk"})

_TLS = threading.local()
_DEFAULT = Settings()


def get() -> Settings:
    return getattr(_TLS, "settings", _DEFAULT)


@contextlib.contextmanager
def use(**kwargs):
    ignored = sorted(set(kwargs) - SETTABLE)
    if ignored:
        raise ValueError(f"the port reads no setting {ignored}: only "
                         f"{sorted(SETTABLE)} can be set")
    old = get()
    _TLS.settings = dataclasses.replace(old, **kwargs)
    try:
        yield
    finally:
        _TLS.settings = old
