"""Optimizers (AdamW, Adafactor) and the warmup-cosine schedule, as plain
functions over a dict of named tensors (counterpart of
``repro/train/optimizer.py``; no ``torch.optim``).

``params`` is a dict ``{name: tensor}`` (an ``LM``'s or ``EncDec``'s
``named_parameters()``), ``grads`` a dict with the same names.  The
reference's updates are pure and return new trees; here ``update``
writes each parameter and each moment in place, leaf by leaf, so one
card holds one copy of each (it returns the same dicts).  As in the
reference: the moments are kept in ``moment_dtype``, every update runs in
float32, each new parameter is cast back to its own dtype (bf16 at full
width), and the schedule is computed in float32 from an int32 count.

On a mesh the parameters, gradients and moments are DTensors alike
placed (the gradients put on their parameters' placements by the train
step): the elementwise updates run on each rank's slices, and the global
norm, Adafactor's row and column statistics and its update clip's RMS
are reduced over the shards by DTensor as the reference's jitted update
reduces them.

Adafactor is not leaf-local in the reference: its leaves are the
cycle-stacked layer tensors ``(n_cycles, ...)``, so a stacked norm scale
``(n_cycles, d)`` is factored as a matrix whose rows are the layers, and
the update clip's RMS spans every layer of a stack.  The port keeps one
tensor per layer, so :class:`Adafactor` takes ``groups`` (the model's
``param_groups()``): the statistics of one reference leaf are taken over
the port's per-layer tensors stacked in cycle order (a remainder layer
alone), which gives the reference's updates.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["AdamW", "Adafactor", "WarmupCosine", "clip_by_global_norm",
           "global_norm", "make_optimizer"]

Tensors = Dict[str, torch.Tensor]
Groups = Sequence[Tuple[Tuple[str, ...], List[str]]]


# --- schedules -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WarmupCosine:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    final_frac: float = 0.1

    def __call__(self, step: torch.Tensor) -> torch.Tensor:
        """The learning rate (float32 scalar) at an int32 step count."""
        step = step.to(torch.float32)
        warm = self.peak_lr * step / max(1, self.warmup_steps)
        progress = torch.clamp((step - self.warmup_steps)
                               / max(1, self.total_steps - self.warmup_steps),
                               0.0, 1.0)
        cos = self.final_frac + (1 - self.final_frac) * 0.5 * (
            1 + torch.cos(math.pi * progress))
        return torch.where(step < self.warmup_steps, warm,
                           self.peak_lr * cos)


# --- global-norm clipping ---------------------------------------------------------

def global_norm(tree: Tensors) -> torch.Tensor:
    """The float32 L2 norm over every tensor of ``tree``."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


def clip_by_global_norm(tree: Tensors, max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """``tree`` scaled in place to at most ``max_norm`` global norm (each
    tensor in its own dtype, scaled in float32), and the norm before.
    In place, so a step holds one copy of its gradients."""
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    for g in tree.values():
        g.copy_(g.float() * scale)
    return tree, norm


def _settled(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's partial sums reduced (a plain tensor as it is)."""
    placements = getattr(t, "placements", None)
    if placements is None or not any(p.is_partial() for p in placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in placements])


def _assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, a DTensor ``src`` first put on ``dst``'s
    placements."""
    placements = getattr(dst, "placements", None)
    if placements is not None and src.placements != placements:
        src = src.redistribute(dst.device_mesh, placements)
    dst.copy_(src)


def _advance(state) -> torch.Tensor:
    """The state's int32 step count, advanced by one."""
    state["count"] = state["count"] + 1
    return state["count"]


# --- AdamW --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: torch.dtype = torch.float32
    max_grad_norm: float = 1.0

    def init(self, params: Tensors) -> Dict:
        """``{"m": {name: zeros}, "v": {name: zeros}, "count": int32 0}``,
        on each parameter's device (a DTensor parameter's moments placed
        as it is)."""
        zeros = lambda p: torch.zeros_like(
            p, dtype=self.moment_dtype, memory_format=torch.contiguous_format)
        device = next(iter(params.values())).device
        return {"m": {k: zeros(p) for k, p in params.items()},
                "v": {k: zeros(p) for k, p in params.items()},
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update(self, grads: Tensors, state: Dict, params: Tensors
               ) -> Tuple[Tensors, Dict, Dict[str, torch.Tensor]]:
        """One step, in place: ``params`` and ``state`` are updated and
        returned, with ``{"grad_norm", "lr"}``."""
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
        count = _advance(state)
        b1c = 1 - self.b1 ** count.to(torch.float32)
        b2c = 1 - self.b2 ** count.to(torch.float32)
        lr = self.schedule(count)
        for k, p in params.items():
            g32 = grads.pop(k).float()
            m32 = self.b1 * state["m"][k].float() + (1 - self.b1) * g32
            v32 = self.b2 * state["v"][k].float() \
                + (1 - self.b2) * g32 * g32
            del g32
            step = (m32 / b1c) / (torch.sqrt(v32 / b2c) + self.eps)
            step = step + self.weight_decay * p.float()
            p.copy_(p.float() - lr * step)
            state["m"][k].copy_(m32)
            state["v"][k].copy_(v32)
        return params, state, {"grad_norm": gnorm, "lr": lr}


# --- Adafactor (factored second moment: O(n+m) state for (n,m) matrices) ----------

@dataclasses.dataclass(frozen=True)
class Adafactor:
    schedule: Callable[[torch.Tensor], torch.Tensor]
    decay: float = 0.99
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    #: the reference leaves as groups of parameter names (a model's
    #: ``param_groups()``); None: each parameter is a leaf of its own
    groups: Optional[Groups] = None

    def _factored(self, shape) -> bool:
        return len(shape) >= 2

    def leaves(self, params: Tensors) -> List[Tuple[List[str], bool]]:
        """Each reference leaf as (its parameter names, whether it is a
        cycle-stacked layer leaf), in the order of the state's ``"f"``
        list."""
        if self.groups is None:
            return [([k], False) for k in params]
        names = [n for _, members in self.groups for n in members]
        if sorted(names) != sorted(params):
            raise ValueError("the optimizer's groups do not cover the "
                             "parameters exactly")
        return [(list(members), path[1:2] == ("cycles",))
                for path, members in self.groups]

    def init(self, params: Tensors) -> Dict:
        """``{"f": [per-leaf dicts], "count": int32 0}``: a factored leaf
        keeps row and column statistics ``vr``, ``vc``, any other leaf
        ``v``, all float32 (on a mesh placed as the update computes them
        from the leaf's placements)."""
        f = []
        for members, stacked in self.leaves(params):
            zeros = [torch.zeros_like(params[n], dtype=torch.float32)
                     for n in (members if stacked else members[:1])]
            z = torch.stack(zeros) if stacked else zeros[0]
            if self._factored(z.shape):
                f.append({"vr": _settled(z.mean(-1)),
                          "vc": _settled(z.mean(-2))})
            else:
                f.append({"v": z})
        device = next(iter(params.values())).device
        return {"f": f, "count": torch.zeros((), dtype=torch.int32,
                                             device=device)}

    @torch.no_grad()
    def update(self, grads: Tensors, state: Dict, params: Tensors
               ) -> Tuple[Tensors, Dict, Dict[str, torch.Tensor]]:
        """One step, in place (see the module's note on the grouping)."""
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
        lr = self.schedule(_advance(state))
        for (members, stacked), f in zip(self.leaves(params), state["f"]):
            if stacked and params[members[0]].dim() >= 2:
                self._update_layers(members, f, grads, params, lr)
                continue
            g32 = torch.stack([grads.pop(n).float() for n in members]) \
                if stacked else grads.pop(members[0]).float()
            p32 = torch.stack([params[n].float() for n in members]) \
                if stacked else params[members[0]].float()
            m = self._moments(g32, f)
            for k, v in m.items():
                _assign(f[k], v)
            step = self._step(g32, m)
            new = self._moved(p32, step / self._clip(torch.mean(step * step)),
                              lr)
            if stacked:
                for i, n in enumerate(members):
                    _assign(params[n], new[i])
            else:
                _assign(params[members[0]], new)
        return params, state, {"grad_norm": gnorm, "lr": lr}

    def _moments(self, g32: torch.Tensor, old: Dict) -> Dict:
        """The new second-moment statistics from the old ones (``vr``,
        ``vc`` of a factored leaf, else ``v``)."""
        beta, g2 = self.decay, g32 * g32 + self.eps
        if "vr" in old:
            return {"vr": beta * old["vr"] + (1 - beta) * g2.mean(-1),
                    "vc": beta * old["vc"] + (1 - beta) * g2.mean(-2)}
        return {"v": beta * old["v"] + (1 - beta) * g2}

    def _step(self, g32: torch.Tensor, m: Dict) -> torch.Tensor:
        """The gradient over the root of its second moment's estimate."""
        if "vr" in m:
            vr, vc = m["vr"], m["vc"]
            denom = (vr[..., None] / torch.clamp_min(
                vr.mean(-1, keepdim=True)[..., None], self.eps)) \
                * vc[..., None, :]
        else:
            denom = m["v"]
        return g32 * torch.rsqrt(torch.clamp_min(denom, self.eps))

    def _clip(self, mean_square: torch.Tensor) -> torch.Tensor:
        """The update clip's divisor from the step's mean square."""
        rms = torch.sqrt(mean_square + 1e-12)
        return torch.clamp_min(rms / self.clip_threshold, 1.0)

    def _moved(self, p32: torch.Tensor, step: torch.Tensor,
               lr: torch.Tensor) -> torch.Tensor:
        return p32 - lr * (step + self.weight_decay * p32)

    def _update_layers(self, members: List[str], f: Dict, grads: Tensors,
                       params: Tensors, lr: torch.Tensor) -> None:
        """A cycle-stacked leaf of matrices (or larger) a layer at a time,
        never stacked in float32: each layer's statistics are its own, and
        the update clip's RMS spans every layer, so a first pass sums the
        steps' squares and a second takes the steps (each computed twice,
        in float32, one layer at a time)."""
        ms = [self._moments(grads[n].float(), {k: v[i] for k, v in f.items()})
              for i, n in enumerate(members)]
        total = sum(torch.sum(torch.square(self._step(grads[n].float(), m)))
                    for n, m in zip(members, ms))
        for k in f:
            _assign(f[k], torch.stack([m[k] for m in ms]))
        clip = self._clip(total / (len(members) * grads[members[0]].numel()))
        for n, m in zip(members, ms):
            step = self._step(grads.pop(n).float(), m)
            _assign(params[n], self._moved(params[n].float(), step / clip,
                                           lr))


def make_optimizer(kind: str = "adamw", *, peak_lr: float = 3e-4,
                   total_steps: int = 10000, warmup_steps: int = 100,
                   moment_dtype: torch.dtype = torch.float32,
                   weight_decay: float = 0.1,
                   groups: Optional[Groups] = None):
    sched = WarmupCosine(peak_lr=peak_lr, warmup_steps=warmup_steps,
                         total_steps=total_steps)
    if kind == "adamw":
        return AdamW(schedule=sched, moment_dtype=moment_dtype,
                     weight_decay=weight_decay)
    if kind == "adafactor":
        return Adafactor(schedule=sched, weight_decay=weight_decay,
                         groups=groups)
    raise ValueError(kind)
