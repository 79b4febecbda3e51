"""Data pipeline: deterministic sharded token streams with host prefetch
(the port's own copy of ``repro/data/pipeline.py``).

A :class:`TokenStream` is addressed by step, so a restart resumes
mid-epoch from the checkpointed step with no iterator state saved.  Each
host materialises only its shard of the global batch; a background
thread keeps ``prefetch`` batches ready.  The synthetic backend draws
Zipf-like token ids from numpy's counter-based Philox generator keyed by
(seed, step, host), so its batches equal the reference's byte for byte.
:class:`PrefetchIterator` takes a ``device`` (batches arrive as tensors
there) and, as the reference, ``shardings`` (the rules'
``batch_shardings``): on a mesh, one process a rank, each batch arrives
as DTensors of which each rank holds the rows the reference's
``device_put`` gives its device (:func:`repro_torch.sharding.place.
place`), on ``device``.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.models.types import ModelConfig, ShapeSpec

__all__ = ["DataConfig", "PrefetchIterator", "TokenStream", "for_model"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2           # token frequency skew
    host_count: int = 1
    host_index: int = 0
    prefetch: int = 2


class TokenStream:
    """Deterministic, seekable synthetic LM token stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.host_count == 0
        self.host_batch = cfg.global_batch // cfg.host_count

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The (host-local) batch for a global step — a pure function of
        (seed, step, host_index), so restarts are exact."""
        c = self.cfg
        rng = np.random.Generator(np.random.Philox(
            key=c.seed, counter=[0, 0, step, c.host_index]))
        # Zipf-like ids folded into the vocab
        raw = rng.zipf(c.zipf_a, size=(self.host_batch, c.seq_len + 1))
        tokens = (raw % (c.vocab_size - 2)).astype(np.int32) + 2
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:].copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchIterator:
    """Background-thread prefetch of ready batches, as tensors on
    ``device`` when one is given (numpy arrays otherwise), placed by
    ``shardings`` when they are given (see the module's note)."""

    def __init__(self, stream: TokenStream, *, start_step: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 shardings: Optional[Dict[str, Any]] = None):
        self.stream = stream
        self.device = torch.device(device) if device is not None else None
        self.shardings = shardings
        self._q: "queue.Queue" = queue.Queue(stream.cfg.prefetch)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self._make(step)
            except Exception as e:      # raised by __next__
                self._q.put(e)
                return
            try:
                self._q.put(batch, timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def _make(self, step: int):
        batch = self.stream.batch_at(step)
        if self.shardings is not None:
            from repro_torch.sharding.place import place
            return {k: place(v, self.shardings[k], device=self.device)
                    for k, v in batch.items()}
        if self.device is not None:
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in batch.items()}
        return batch

    def __iter__(self):
        return self

    def __next__(self):
        batch = self._q.get()
        if isinstance(batch, Exception):
            raise batch
        return batch

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)


def for_model(cfg: ModelConfig, shape: ShapeSpec, *, seed: int = 0,
              host_count: int = 1, host_index: int = 0) -> TokenStream:
    return TokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=seed,
        host_count=host_count, host_index=host_index))
