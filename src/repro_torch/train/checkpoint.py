"""Fault-tolerant checkpoints: atomic, asynchronous, keep-k (counterpart
of ``repro/train/checkpoint.py``).

* **Layout**: one directory a step, ``step_00000123/arrays.npz`` and
  ``manifest.json`` (step, leaf keys, each leaf's dtype, time, extra).
* **Atomicity**: written to ``step_N.tmp-<pid>``, fsynced, renamed; a
  crashed save is never taken for a whole one.  ``LATEST`` is updated,
  also by a rename, after the directory lands.
* **Asynchronous**: ``save()`` copies every tensor to the host at once
  (so the next step may overwrite the device buffers) and hands the file
  I/O to a thread; ``wait()`` joins it and raises what it raised.
* **Keep-k**: the oldest checkpoints beyond ``keep`` go after each save.

The tree is the port's: nested dicts and lists of tensors (a model's
named parameters, an optimizer state).  numpy has no bfloat16, so a bf16
leaf is stored as its raw 16 bits (``int16``) with its dtype in the
manifest, and comes back bit for bit.  ``restore(template)`` returns new
tensors of the template's dtypes on its devices; ``restore_into`` copies a
checkpoint into a live model's parameters and optimizer state in place.

On a mesh (DTensor leaves, one process a rank) every rank calls ``save``:
each DTensor leaf is gathered whole (``full_tensor``), one leaf at a
time, rank 0 keeps the host copy and writes, the other ranks keep
nothing, and every rank waits for rank 0's write (a barrier in
``wait()``, which ``save`` calls first) before the next save or a
restore.  The format is the one-process one, whole arrays, so a
checkpoint saved on one card restores onto a mesh and back.  The elastic
restore is the reference's: ``restore(template, shardings=)`` places
each saved whole array onto a mesh that may differ from the one that
saved (``shardings`` a tree of :class:`~repro_torch.sharding.rules.
NamedSharding` parallel to ``template``), each rank keeping its slice;
without ``shardings`` a DTensor template leaf is placed as it is, so
``restore_into`` copies into placed parameters and moments.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["Checkpointer"]


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in the tree's order, keys as the reference
    writes them (``['params']['embed.embedding']``, ``['f'][0]``)."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _flatten(v, f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(tree: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(tree)


def _is_placed(t: Any) -> bool:
    return isinstance(t, torch.Tensor) and hasattr(t, "placements")


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _to_host(t: Any) -> Tuple[np.ndarray, str]:
    if not isinstance(t, torch.Tensor):
        a = np.asarray(t)
        return a, str(a.dtype)
    t = t.detach()
    if _is_placed(t):
        t = t.full_tensor()       # every rank gathers; rank 0 keeps it
        if _rank():
            return None, str(t.dtype).split(".")[-1]
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy(), "bfloat16"
    return t.cpu().numpy(), str(t.dtype).split(".")[-1]


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: the last save was a mesh's: wait() is a barrier
        self._collective = False

    # -- save ---------------------------------------------------------------
    def save(self, step: int, params: Any, opt_state: Any = None,
             extra: Optional[Dict[str, Any]] = None,
             block: bool = False) -> None:
        self.wait()
        tree = {"params": params}
        if opt_state is not None:
            tree["opt_state"] = opt_state
        leaves = _flatten(tree)
        self._collective = any(_is_placed(v) for _, v in leaves)
        # the host copy is synchronous: the next step may overwrite the
        # device buffers
        host = [(k, *_to_host(v)) for k, v in leaves]
        if _rank():
            return                 # rank 0 writes
        manifest = {"step": step, "keys": [k for k, _, _ in host],
                    "dtypes": {k: d for k, _, d in host},
                    "time": time.time(), "extra": extra or {}}
        t = threading.Thread(target=self._write,
                             args=(step, [(k, a) for k, a, _ in host],
                                   manifest), daemon=True)
        self._thread = t
        t.start()
        if block:
            self.wait()

    def _write(self, step: int, host, manifest) -> None:
        try:
            final = os.path.join(self.directory, f"step_{step:08d}")
            tmp = f"{final}.tmp-{os.getpid()}"
            os.makedirs(tmp, exist_ok=True)
            # keys by position: a key path is no valid npz member name
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{f"a{i}": a for i, (_, a) in enumerate(host)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            latest_tmp = os.path.join(self.directory,
                                      f".LATEST.tmp-{os.getpid()}")
            with open(latest_tmp, "w") as f:
                f.write(os.path.basename(final))
            os.rename(latest_tmp, os.path.join(self.directory, "LATEST"))
            self._gc()
        except BaseException as e:   # surfaced on the next wait()
            self._error = e

    def wait(self) -> None:
        """Join the write (on a mesh: every rank waits for rank 0's)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._collective:
            import torch.distributed as dist
            dist.barrier()
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_") and ".tmp" not in d)
        for d in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, d),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.directory, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            name = f.read().strip()
        if not os.path.exists(os.path.join(self.directory, name,
                                           "manifest.json")):
            return None
        return int(name.split("_")[1])

    def restore(self, template: Any, *, step: Optional[int] = None,
                shardings: Any = None) -> Tuple[Any, int]:
        """The checkpoint at ``step`` (default: the latest) in the
        structure of ``template``, each leaf a new tensor of the template
        leaf's dtype on its device: placed by ``shardings`` (a parallel
        tree of NamedShardings, the elastic path: the mesh may differ from
        the one that saved), else a DTensor template leaf's placements,
        each rank keeping its slice.  Returns (tree, step)."""
        step, leaves = self._leaves(template, step, shardings)
        return _unflatten(template, list(leaves)), step

    def _leaves(self, template: Any, step: Optional[int], shardings: Any
                ) -> Tuple[int, Iterator[torch.Tensor]]:
        """The step, and :meth:`restore`'s leaves in ``template``'s order,
        read one at a time."""
        from repro_torch.sharding.place import place, place_on
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in "
                                        f"{self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        index = {k: i for i, k in enumerate(manifest["keys"])}
        flat = _flatten(template)
        placing = [s for _, s in _flatten(shardings)] if shardings \
            is not None else [None] * len(flat)
        if len(placing) != len(flat):
            raise ValueError(f"{len(placing)} shardings for {len(flat)} "
                             f"leaves")
        for k, _ in flat:
            if k not in index:
                raise KeyError(f"checkpoint missing leaf {k}")

        def read():
            with np.load(os.path.join(d, "arrays.npz")) as z:
                for (k, tmpl), sharding in zip(flat, placing):
                    arr = z[f"a{index[k]}"]
                    if tuple(arr.shape) != tuple(tmpl.shape):
                        raise ValueError(f"shape mismatch for {k}: ckpt "
                                         f"{arr.shape} vs template "
                                         f"{tuple(tmpl.shape)}")
                    t = torch.from_numpy(arr)
                    if manifest["dtypes"][k] == "bfloat16":
                        t = t.view(torch.bfloat16)
                    kw = dict(device=tmpl.device, dtype=tmpl.dtype)
                    if sharding is not None:
                        yield place(t, sharding, **kw)
                    elif _is_placed(tmpl):
                        yield place_on(t, tmpl.device_mesh, tmpl.placements,
                                       **kw)
                    else:
                        yield t.to(**kw)
        return step, read()

    def restore_into(self, params: Any, opt_state: Any = None, *,
                     step: Optional[int] = None) -> int:
        """Copy the checkpoint at ``step`` (default: the latest) into the
        tensors of ``params`` (a model's named parameters, whose model
        then holds the checkpoint's weights) and ``opt_state``, in place.
        Returns the step."""
        tree = {"params": params}
        if opt_state is not None:
            tree["opt_state"] = opt_state
        step, leaves = self._leaves(tree, step, None)
        with torch.no_grad():
            for (_, dst), src in zip(_flatten(tree), leaves):
                dst.copy_(src)       # one leaf at a time
        return step
