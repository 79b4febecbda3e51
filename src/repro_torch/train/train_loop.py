"""The train step and the host training loop (counterpart of
``repro/train/train_loop.py``).

``make_train_step`` builds ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)`` for a port :class:`~repro_torch.models.LM`
or :class:`~repro_torch.models.EncDec`: the model's loss and its
gradients by autograd (``torch.autograd.grad``; on the card attention's
backward is the hand-written kernel), optional gradient accumulation over
``microbatches`` (summed in float32, divided by n; the metrics are the
last microbatch's, as the reference's), an optional ``compress_fn`` over
the gradients, and the optimizer's update.  ``params`` is the model's own
``named_parameters()`` dict (:func:`trainable_params`, which turns their
gradients on: the port's models are frozen for serving); the update
writes them in place, so the model holds the new weights.  The loss is
the model's, so the step refuses a ``params`` holding any tensor that is
not one of the model's parameters (a copy, such as a checkpoint restored
into a fresh dict): autograd would give it no gradient, and the update
would apply weight decay alone.

``train_loop`` adds the reference's fault tolerance: periodic asynchronous
checkpoints, a checkpoint on SIGTERM (:class:`PreemptionHandler`) and a
straggler watchdog (:class:`StragglerWatchdog`).  With an ``obs``
registry each step's wall time lands in the ``train.step`` histogram and
each watchdog flag in the ``train.slow_steps`` counter, timed on the
registry's injectable clock.  Each step ends by reading the loss to the
host, which waits for the card (the reference's ``block_until_ready``).
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.obs import MetricsRegistry
from repro_torch.train import optimizer as opt_lib

__all__ = ["PreemptionHandler", "StragglerWatchdog", "TrainConfig",
           "make_train_step", "to_device", "train_loop", "trainable_params"]

Tensors = Dict[str, torch.Tensor]

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    moment_dtype: str = "float32"      # "bfloat16" halves optimizer memory
    microbatches: int = 1              # gradient accumulation
    remat: bool = True
    grad_compression: bool = False     # int8 error-feedback compression

    def make_optimizer(self, groups=None):
        """The optimizer; ``groups`` (a model's ``param_groups()``) gives
        Adafactor the reference's leaves."""
        return opt_lib.make_optimizer(
            self.optimizer, peak_lr=self.peak_lr,
            total_steps=self.total_steps, warmup_steps=self.warmup_steps,
            moment_dtype=_MOMENT_DTYPES[self.moment_dtype],
            weight_decay=self.weight_decay, groups=groups)


def trainable_params(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The model's parameters by name, with gradients turned on."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def _split_microbatches(batch: Tensors, n: int):
    """The batch cut along its leading dim into ``n`` equal parts."""
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} does not split into {n} "
                         f"microbatches")
    parts = {k: v.chunk(n, dim=0) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def make_train_step(model: nn.Module, tcfg: TrainConfig,
                    compress_fn: Optional[Callable[[Tensors], Tensors]]
                    = None):
    """Returns (train_step, optimizer); see the module's note."""
    opt = tcfg.make_optimizer(groups=model.param_groups())
    device = next(model.parameters()).device

    def grads_of(params: Tensors, batch: Tensors):
        loss, metrics = model.loss(batch, remat=tcfg.remat)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True)
        grads = {k: g if g is not None else torch.zeros_like(params[k])
                 for k, g in zip(names, grads)}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return grads, metrics

    def check_own(params: Tensors) -> None:
        own = {id(p) for p in model.parameters()}
        for k, p in params.items():
            if id(p) not in own:
                raise ValueError(
                    f"params[{k!r}] is not a parameter of the model: the "
                    f"step differentiates the model's own tensors, so a "
                    f"copy gets no gradient (pass trainable_params(model), "
                    f"and restore checkpoints into it)")

    def train_step(params: Tensors, opt_state, batch):
        check_own(params)
        batch = to_device(batch, device)
        n = tcfg.microbatches
        if n > 1:
            acc = {k: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for k, p in params.items()}
            for mb in _split_microbatches(batch, n):
                g, metrics = grads_of(params, mb)
                for k, a in acc.items():
                    a.add_(g.pop(k).float())
            grads = {k: a / n for k, a in acc.items()}
            del acc
        else:
            grads, metrics = grads_of(params, batch)
        if compress_fn is not None:
            grads = compress_fn(grads)
        params, opt_state, opt_metrics = opt.update(grads, opt_state,
                                                    params)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step, opt


# ---------------------------------------------------------------------------
# host-side loop with fault-tolerance hooks
# ---------------------------------------------------------------------------

class StragglerWatchdog:
    """Flags steps exceeding ``factor`` x the rolling median step time.

    On a cluster the flag feeds the job controller (restart the slow host
    or leave it out of the next resize); here it records events so tests
    and the launcher can observe the decisions."""

    def __init__(self, factor: float = 3.0, history: int = 32):
        self.factor = factor
        self.history = history
        self.times: list = []
        self.events: list = []

    def observe(self, step: int, seconds: float) -> bool:
        slow = False
        if len(self.times) >= 5:
            med = sorted(self.times)[len(self.times) // 2]
            if seconds > self.factor * med:
                self.events.append((step, seconds, med))
                slow = True
        self.times.append(seconds)
        if len(self.times) > self.history:
            self.times.pop(0)
        return slow


class PreemptionHandler:
    """SIGTERM -> request a checkpoint at the next step boundary."""

    def __init__(self):
        self.requested = threading.Event()
        try:
            signal.signal(signal.SIGTERM, self._on_signal)
        except ValueError:
            pass   # not the main thread (tests)

    def _on_signal(self, signum, frame):
        self.requested.set()


def train_loop(model: nn.Module, tcfg: TrainConfig, params: Tensors,
               opt_state, batches: Iterator, *, steps: int,
               checkpointer=None, checkpoint_every: int = 100,
               watchdog: Optional[StragglerWatchdog] = None,
               log_every: int = 10, start_step: int = 0, train_step=None,
               obs: Optional[MetricsRegistry] = None
               ) -> Tuple[Tensors, Any, Dict[str, list]]:
    """Step, log, checkpoint and watch for stragglers from ``start_step``
    up to ``steps``.  ``batches`` yields ready batches (numpy arrays or
    tensors).  Returns (params, opt_state, {"loss": [...], "step_time":
    [...]})."""
    if train_step is None:
        train_step, _ = make_train_step(model, tcfg)
    preempt = PreemptionHandler()
    history: Dict[str, list] = {"loss": [], "step_time": []}
    clock = obs.clock if obs is not None else time.perf_counter
    h_step = obs.histogram("train.step") if obs is not None else None
    c_slow = obs.counter("train.slow_steps") if obs is not None else None

    for step in range(start_step, steps):
        batch = next(batches)
        t0 = clock()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])      # waits for the card
        dt = clock() - t0
        history["loss"].append(loss)
        history["step_time"].append(dt)
        if h_step is not None:
            h_step.observe(dt)
        if watchdog is not None:
            if watchdog.observe(step, dt) and c_slow is not None:
                c_slow.inc()
        if log_every and step % log_every == 0:
            print(f"step {step:6d} loss {loss:.4f} "
                  f"grad_norm {float(metrics['grad_norm']):.3f} "
                  f"{dt * 1e3:.1f} ms")
        want_ckpt = checkpointer is not None and (
            (step + 1) % checkpoint_every == 0 or preempt.requested.is_set())
        if want_ckpt:
            checkpointer.save(step + 1, params, opt_state)
            if preempt.requested.is_set():
                print(f"preemption checkpoint at step {step + 1}; exiting")
                break
    return params, opt_state, history
