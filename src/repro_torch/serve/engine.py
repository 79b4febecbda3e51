"""Batched serving engine: prefill + greedy decode over a fixed slot batch
(counterpart of ``repro/serve/engine.py``).

The engine keeps a decode batch of ``slots``; requests are served in
waves of up to ``slots`` equal-length prompts, and every sequence of a
wave shares the position counter (the reference's static-batching
contract).  It runs the port's :class:`~repro_torch.models.LM` or
:class:`~repro_torch.models.EncDec` eagerly under
:func:`torch.inference_mode` (the reference jits prefill and decode):
prefill attention (and an encoder-decoder model's every attention but
self-attention decode) goes through the flash-attention kernel and every
RWKV-6 time mix through the WKV6 kernel.

An encoder-decoder model (``enc_len > 0``) serves requests that carry
their source ``frames`` (``(enc_len, d_model)`` frame embeddings): a
wave stacks them into ``frontend_embeds`` beside the target prompts.
The reference's engine accepts ``enc_len`` but never passes the frames
to ``EncDec.prefill``, which reads them, so it cannot serve such a
model; the port's ``Request`` carries them (ROADMAP.md §C, entry 6).

A vision-language model (``cfg.frontend == "vision"``) serves requests
whose ``frames`` are their image's ``(F, d_model)`` patch embeddings:
a wave stacks them into ``frontend_embeds``, which the model prepends
to the prompts, and decoding continues at ``F + T_p``.  A wave is all
with patches of one length or all text only.  The reference's engine
has no field for patches and decodes from ``T_p``, so it serves only
the text (ROADMAP.md §C, entry 7).

Fleet placement: :func:`plan_decode_placement` asks the port's
:class:`~repro_torch.selector.SelectionService` which profiled mesh the
decode fleet should run on under current prices; the resulting
:class:`~repro_torch.selector.Decision` can be attached to the engine as
``placement``.
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.market.migration import should_migrate
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM
from repro_torch.models.types import ModelConfig
from repro_torch.obs import MetricsRegistry
from repro_torch.selector import Decision, SelectionService
from repro_torch.selector.fused_rank import resolve_device

__all__ = ["Completion", "Engine", "Request", "make_serve_step",
           "plan_decode_placement"]


def plan_decode_placement(service: SelectionService,
                          shape_name: str = "decode_32k",
                          *, annotation=None,
                          exclude_archs: Tuple[str, ...] = (),
                          current: Optional[Decision] = None,
                          switch_cost_hours: float = 0.25,
                          horizon_hours: float = 24.0,
                          hysteresis: float = 1.25) -> Decision:
    """Pick the mesh for a decode fleet via the selection service.

    ``shape_name`` is the workload cell the fleet serves (class A unless
    annotated otherwise).  With ``current`` (the fleet's standing
    decision), :func:`~repro_torch.market.should_migrate` gates the move:
    the fleet switches mesh only when projected savings over
    ``horizon_hours`` beat ``hysteresis`` times the cost of
    ``switch_cost_hours`` of dual-running.  When it says stay, the
    returned Decision keeps the current mesh, re-stamped with today's
    ranking, $/h and price epoch.
    """
    decision = service.submit(shape_name, annotation=annotation,
                              exclude_groups=exclude_archs)
    if current is None or decision.config_id == current.config_id:
        return decision
    try:
        # quote savings off today's rate, not the one stamped on `current`
        current_rate: Optional[float] = service.catalog.hourly_cost(
            current.config_id, service.price_source)
    except KeyError:
        # deprovisioned entry: the advisor forces the move
        current_rate = None
    advice = should_migrate(current, decision.ranking, switch_cost_hours,
                            horizon_hours=horizon_hours,
                            hysteresis=hysteresis,
                            current_hourly_cost=current_rate)
    if advice.migrate:
        return decision
    return dataclasses.replace(
        decision, config_id=current.config_id,
        entry=service.catalog.entry(current.config_id),
        hourly_cost=current_rate)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: Any                    # (T,) ints: a tensor, array or list
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    #: (F, d_model) embeddings, a tensor or array: an encoder-decoder
    #: model's source frames (every request carries them), or a
    #: vision-language model's image patches (prepended to the prompt;
    #: None serves the text alone); other models' requests carry none
    frames: Any = None


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: List[int]
    prefill_ms: float
    decode_ms: float


class Engine:
    """Greedy-decoding engine over a fixed slot batch.

    ``device`` defaults to the card; with no CUDA device that raises
    :class:`~repro_torch.selector.BackendUnavailableError`.  The model
    must live on the same device.  ``enc_len`` is an encoder-decoder
    model's source length, as in the reference: it sizes the cross
    caches, and is otherwise only a check on the frames the requests
    carry (every request's must have that many); a decoder-only model
    ignores it.  A vision-language model's patches share the self
    caches with the prompt, so ``max_len`` must hold F + prompt + new
    tokens.
    :attr:`prefills` and :attr:`decode_steps` count the model calls the
    engine made.
    """

    def __init__(self, model: Union[LM, EncDec], *, slots: int,
                 max_len: int, enc_len: int = 0,
                 placement: Optional[Decision] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the engine "
                             f"on {self.device}")
        if slots < 1 or max_len < 1:
            raise ValueError("slots and max_len must be positive")
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.slots = slots
        self.max_len = max_len
        self.enc_len = enc_len
        #: where this fleet is meant to run (selector decision), if planned
        self.placement = placement
        #: telemetry: per-wave ``serve.prefill`` / ``serve.decode``
        #: histograms beside the Completion ms fields, timed off the
        #: registry's clock
        self.metrics = metrics
        self._clock = metrics.clock if metrics is not None \
            else time.perf_counter
        self._h_prefill = metrics.histogram("serve.prefill") \
            if metrics is not None else None
        self._h_decode = metrics.histogram("serve.decode") \
            if metrics is not None else None
        self.prefills = 0
        self.decode_steps = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prompts(self, reqs: List[Request]) -> torch.Tensor:
        rows = [torch.as_tensor(r.prompt, dtype=torch.long).reshape(-1)
                for r in reqs]
        if len({len(r) for r in rows}) != 1:
            raise ValueError("a wave's prompts must be of equal length")
        return torch.stack(rows).to(self.device)

    def _patches(self, reqs: List[Request]) -> Optional[torch.Tensor]:
        """A vision-language wave's patch embeddings (B, F, d_model), or
        None for a text-only wave."""
        with_patches = [r.frames is not None for r in reqs]
        if not any(with_patches):
            return None
        if not all(with_patches):
            raise ValueError("a wave's requests must all carry patches or "
                             "none (frames)")
        rows = [torch.as_tensor(r.frames) for r in reqs]
        for r, f in zip(reqs, rows):
            if f.dim() != 2 or f.shape[1] != self.cfg.d_model:
                raise ValueError(f"request {r.uid}: frames of shape "
                                 f"{tuple(f.shape)}, expected (F, "
                                 f"{self.cfg.d_model}) patch embeddings")
        if len({f.shape[0] for f in rows}) != 1:
            raise ValueError("a wave's patches (frames) must be of equal "
                             "length")
        return torch.stack(rows).to(self.device)

    def _batch(self, reqs: List[Request]) -> Dict[str, torch.Tensor]:
        """A wave's model batch: the prompts, and the requests' frames as
        ``frontend_embeds`` (an encoder-decoder model's sources, a
        vision-language model's patches)."""
        batch = {"tokens": self._prompts(reqs)}
        if self.cfg.frontend == "vision":
            patches = self._patches(reqs)
            if patches is not None:
                batch["frontend_embeds"] = patches
            return batch
        if not self.cfg.is_encdec:
            if any(r.frames is not None for r in reqs):
                raise ValueError(f"{self.cfg.name} has no encoder: its "
                                 f"requests carry no frames")
            return batch
        rows = []
        for r in reqs:
            if r.frames is None:
                raise ValueError(f"request {r.uid} carries no frames: "
                                 f"{self.cfg.name} needs its source")
            f = torch.as_tensor(r.frames)
            if tuple(f.shape) != (self.enc_len, self.cfg.d_model):
                raise ValueError(f"request {r.uid}: frames of shape "
                                 f"{tuple(f.shape)}, the engine takes "
                                 f"({self.enc_len}, {self.cfg.d_model})")
            rows.append(f)
        batch["frontend_embeds"] = torch.stack(rows).to(self.device)
        return batch

    def _init_state(self):
        if self.cfg.is_encdec:
            return self.model.init_state(self.slots, self.max_len,
                                         self.enc_len)
        return self.model.init_state(self.slots, self.max_len)

    @torch.inference_mode()
    def generate_batch(self, requests: List[Request]) -> List[Completion]:
        """Serve a wave of requests of equal prompt length (greedy)."""
        if not 0 < len(requests) <= self.slots:
            raise ValueError(f"a wave holds 1 to {self.slots} requests, "
                             f"got {len(requests)}")
        reqs = list(requests)
        while len(reqs) < self.slots:       # pad with a copy; discarded later
            reqs.append(dataclasses.replace(reqs[-1], uid=-1))
        batch = self._batch(reqs)
        prompts = batch["tokens"]
        # a vision-language wave's patches come first in the self caches
        F = batch["frontend_embeds"].shape[1] \
            if self.cfg.frontend == "vision" and "frontend_embeds" in batch \
            else 0
        if F and F + prompts.shape[1] > self.max_len:
            raise ValueError(f"{F} patches and a {prompts.shape[1]}-token "
                             f"prompt exceed max_len {self.max_len}")
        t0 = self._clock()
        state = self._init_state()
        logits, state = self.model.prefill(batch, state)
        self.prefills += 1
        self._sync()
        t1 = self._clock()
        if self._h_prefill is not None:
            self._h_prefill.observe(t1 - t0)

        start = F + prompts.shape[1]     # the first decode position
        max_new = max(r.max_new_tokens for r in reqs)
        out_tokens: List[List[int]] = [[] for _ in reqs]
        done = [False] * len(reqs)
        tok = torch.argmax(logits, dim=-1)
        for step in range(max_new):
            for i, (r, t) in enumerate(zip(reqs, tok.tolist())):
                if not done[i]:
                    out_tokens[i].append(t)
                    if (r.eos_id is not None and t == r.eos_id) or \
                            len(out_tokens[i]) >= r.max_new_tokens:
                        done[i] = True
            if all(done):
                break
            pos = start + step
            if pos >= self.max_len:
                break
            logits, state = self.model.decode_step(tok, pos, state)
            self.decode_steps += 1
            tok = torch.argmax(logits, dim=-1)
        self._sync()
        t2 = self._clock()
        if self._h_decode is not None:
            self._h_decode.observe(t2 - t1)
        return [Completion(uid=r.uid, tokens=out_tokens[i],
                           prefill_ms=(t1 - t0) * 1e3,
                           decode_ms=(t2 - t1) * 1e3)
                for i, r in enumerate(reqs) if r.uid >= 0]

    def serve(self, requests: List[Request]) -> List[Completion]:
        """Continuous admission: waves of up to ``slots`` requests."""
        out: List[Completion] = []
        pending: "queue.SimpleQueue[Request]" = queue.SimpleQueue()
        for r in requests:
            pending.put(r)
        while not pending.empty():
            wave = []
            while len(wave) < self.slots and not pending.empty():
                wave.append(pending.get())
            out.extend(self.generate_batch(wave))
        return out


def make_serve_step(model: Union[LM, EncDec]) -> Callable:
    """One token for the whole batch against the state (the unit the
    reference's dry-run lowers for decode cells)."""
    def serve_step(token, pos, state):
        return model.decode_step(token, pos, state)
    return serve_step
