"""Encoder-decoder model, the SeamlessM4T-v2 text/speech backbone
(counterpart of ``repro/models/encdec.py``).

The speech frontend is a stub, as in the reference: batches carry
precomputed frame embeddings ``frontend_embeds`` of shape ``(B, F,
d_model)``, which feed the encoder.  The encoder is a stack of
bidirectional attention layers (RoPE over the frame positions) closed by
``enc_norm``; the decoder is a causal stack whose layers also attend to
the encoder's output.  Decoding keeps each decoder layer's self-attention
KV cache and its cross-attention cache ``xk``, ``xv``, which the prefill
computes once from the encoder's output.  Every attention of both stacks
(the encoder's, the decoder's causal self-attention, its cross-attention
and the one-token cross-attention of a decode step) runs on the
flash-attention kernel; self-attention decode stays plain
(:func:`repro_torch.models.layers.sdpa_decode`).

The parameter tree is ``{"embed", "enc_layers", "enc_norm",
"dec_layers", "final_norm"}`` with one dict per layer;
:func:`repro_torch.convert.encdec_params_from_reference` unstacks the
reference's ``enc_stack`` and ``dec_stack`` into it.  ``loss`` is the
reference's: the plain head, no aux term in the total.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.lm import (Block, Group, LayerPlan, State,
                                   _parameter_dict, block_cache_specs,
                                   block_specs, layer_plans, load_values,
                                   param_groups, plain_xent, run_stack,
                                   seq_positions, xent_loss, zeros_state)
from repro_torch.models.types import ModelConfig, SpecTree
from repro_torch.selector.fused_rank import resolve_device

__all__ = ["EncDec", "model_groups", "param_specs"]


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config, as the reference builds it."""
    return dataclasses.replace(cfg, num_layers=cfg.encoder_layers,
                               encoder_layers=0)


def param_specs(cfg: ModelConfig) -> SpecTree:
    """The model's spec tree, without allocating anything."""
    enc_cfg = encoder_config(cfg)
    return {
        "embed": L.embed_specs(cfg),
        "enc_layers": [block_specs(enc_cfg, LayerPlan(kind="attn"))
                       for _ in range(cfg.encoder_layers)],
        "enc_norm": L.norm_specs(cfg),
        "dec_layers": [block_specs(cfg, plan)
                       for plan in layer_plans(cfg, cross=True)],
        "final_norm": L.norm_specs(cfg),
    }


def model_groups(cfg: ModelConfig) -> List[Group]:
    """:meth:`EncDec.param_groups` for ``cfg``, without building the
    model."""
    return param_groups(param_specs(cfg), {
        "enc_layers": ("enc_blocks", "enc_stack", encoder_config(cfg)),
        "dec_layers": ("dec_blocks", "dec_stack", cfg)})


class EncDec(nn.Module):
    """Encoder-decoder LM on one device (``cfg.encoder_layers`` encoder
    layers, ``cfg.num_layers`` decoder layers).

    ``device`` defaults to the card; with no CUDA device that raises
    :class:`~repro_torch.selector.BackendUnavailableError`.  ``params``
    (the tree of :func:`param_specs`, tensors or numpy arrays) loads
    given weights; without it the weights are drawn from a
    :class:`torch.Generator` seeded with ``seed`` on ``device``.
    """

    def __init__(self, cfg: ModelConfig, *,
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 params: Optional[Mapping[str, Any]] = None):
        super().__init__()
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name} has no encoder layers: build it "
                             f"as an LM")
        self.cfg = cfg
        self.enc_plans = [LayerPlan(kind="attn")
                          for _ in range(cfg.encoder_layers)]
        self.dec_plans = layer_plans(cfg, cross=True)
        self.device = resolve_device(device)
        values = load_values(self.param_specs(), cfg, self.device, seed,
                             params)
        self.embed = _parameter_dict(values["embed"])
        self.enc_blocks = nn.ModuleList(Block(v)
                                        for v in values["enc_layers"])
        self.enc_norm = _parameter_dict(values["enc_norm"])
        self.dec_blocks = nn.ModuleList(Block(v)
                                        for v in values["dec_layers"])
        self.final_norm = _parameter_dict(values["final_norm"])

    # -- specs ----------------------------------------------------------------
    def param_specs(self) -> SpecTree:
        return param_specs(self.cfg)

    def state_specs(self, batch: int, max_len: int, enc_len: int
                    ) -> List[Dict]:
        return [block_cache_specs(self.cfg, plan, batch, max_len, enc_len)
                for plan in self.dec_plans]

    def init_state(self, batch: int, max_len: int, enc_len: int) -> State:
        return zeros_state(self.cfg,
                           self.state_specs(batch, max_len, enc_len),
                           self.device)

    # -- encoder --------------------------------------------------------------
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder's output (B, F, d_model) for frame embeddings
        (B, F, d_model): cast to the compute dtype, not scaled.  (The
        encoder runs in mode ``encode``, which the reference never
        rematerialises.)"""
        x = frames.to(device=self.device, dtype=self.cfg.compute_dtype)
        B, F = x.shape[:2]
        x, _, _ = run_stack(self.cfg, self.enc_plans, self.enc_blocks, x,
                            mode="encode",
                            positions=seq_positions(B, F, 0, x.device),
                            state=None)
        return L.norm_apply(self.enc_norm, x, self.cfg.norm)

    # -- decoder --------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = L.embed_apply(self.embed, tokens)
        return x * math.sqrt(self.cfg.d_model)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = L.norm_apply(self.final_norm, x, self.cfg.norm)
        return L.head_apply(self.embed, self.cfg, x)

    def _train_hidden(self, batch: Mapping[str, torch.Tensor], remat: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        enc_out = self.encode(batch["frontend_embeds"])
        x = self._embed(batch["tokens"])
        B, T = x.shape[:2]
        return run_stack(self.cfg, self.dec_plans, self.dec_blocks, x,
                         mode="train",
                         positions=seq_positions(B, T, 0, x.device),
                         state=None, enc_out=enc_out, remat=remat)[:2]

    def forward(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Training-mode logits (B, T, V) of ``batch["tokens"]`` given
        ``batch["frontend_embeds"]``."""
        return self._head(self._train_hidden(batch, remat=False)[0])

    def loss(self, batch: Mapping[str, torch.Tensor], *, remat: bool = True
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss (the reference's ``EncDec.loss``): the
        encoder runs bidirectional over ``batch["frontend_embeds"]``, the
        decoder causal over ``batch["tokens"]`` with cross-attention, and
        the plain head's cross-entropy over ``batch["labels"]`` (-1
        masked) with the z-loss.  The decoder's aux term is reported, not
        added.  Returns (total, {xent, z_loss, aux, tokens})."""
        x, aux = self._train_hidden(batch, remat=remat)
        labels = batch["labels"].to(device=x.device, dtype=torch.long)
        lse, ll = plain_xent(self._head(x), labels.clamp_min(0))
        return xent_loss(lse, ll, labels, aux, 0.0)

    def param_groups(self) -> List[Group]:
        """The parameters as the reference's leaves hold them (each stack's
        cycle-stacked layers), in its flatten order."""
        return model_groups(self.cfg)

    # -- serving --------------------------------------------------------------
    def prefill(self, batch: Mapping[str, torch.Tensor], state: State
                ) -> Tuple[torch.Tensor, State]:
        """Encode the source and run the target prompt, filling the self
        and cross caches.  Returns (last-position logits (B, V), new
        state).  The frames' length must be the state's ``enc_len``."""
        frames = batch["frontend_embeds"]
        enc_len = state[0]["xk"].shape[1] if state else 0
        if frames.dim() != 3 or frames.shape[1] != enc_len:
            raise ValueError(f"frames of shape {tuple(frames.shape)} do not "
                             f"fit a state of enc_len {enc_len}")
        enc_out = self.encode(frames)
        x = self._embed(batch["tokens"])
        B, T = x.shape[:2]
        x, _, new_state = run_stack(
            self.cfg, self.dec_plans, self.dec_blocks, x, mode="prefill",
            positions=seq_positions(B, T, 0, x.device), state=state,
            enc_out=enc_out)
        return self._head(x[:, -1:])[:, 0], new_state

    def decode_step(self, token: torch.Tensor, pos: int, state: State
                    ) -> Tuple[torch.Tensor, State]:
        """One decode step.  token: (B,) ints; pos: the index at which the
        new token is written (cache entries [0, pos] valid)."""
        pos = int(pos)
        x = self._embed(token[:, None])
        x, _, new_state = run_stack(
            self.cfg, self.dec_plans, self.dec_blocks, x, mode="decode",
            positions=seq_positions(x.shape[0], 1, pos, x.device),
            state=state, pos=pos)
        return self._head(x)[:, 0], new_state
