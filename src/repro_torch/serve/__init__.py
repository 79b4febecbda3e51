"""LM serving on the port: :class:`Engine` (prefill + greedy decode over a
fixed slot batch) and :func:`plan_decode_placement`.  Run it with
``python -m repro_torch.serve``."""
from repro_torch.serve.engine import (Completion, Engine, Request,
                                      make_serve_step, plan_decode_placement)

__all__ = ["Completion", "Engine", "Request", "make_serve_step",
           "plan_decode_placement"]
