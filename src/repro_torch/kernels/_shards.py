"""A DTensor's call of a kernel operator, told apart from a plain one.

DTensor picks the layout of the local shards it hands an operator's
CUDA kernel: a redistribution inside the operator's dispatch may leave a
strided chunk of the heads.  So while :func:`call` runs an operator on
DTensors, :func:`dense` gives the launchers their inputs dense.  A plain
tensor keeps the launchers' contract: a strided one raises there, never
copied without a word.
"""
from __future__ import annotations

import threading

import torch

_TLS = threading.local()


def call(op, *args):
    """``op(*args)``, marked as a DTensor's call when ``args[0]`` is
    one (on this thread: DTensor runs the local kernel on it)."""
    if type(args[0]) is torch.Tensor or getattr(_TLS, "on", False):
        return op(*args)
    _TLS.on = True
    try:
        return op(*args)
    finally:
        _TLS.on = False


def dense(args):
    """``args`` with every tensor contiguous inside a DTensor's
    :func:`call`, as they are outside it."""
    if not getattr(_TLS, "on", False):
        return list(args)
    return [a.contiguous() if isinstance(a, torch.Tensor) else a
            for a in args]
