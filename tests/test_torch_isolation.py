"""The port stands alone: no JAX, nothing of the reference package, and no
quiet fall-back to the CPU.

A subprocess blocks ``jax`` and ``repro`` (the exact name or a ``repro.``
prefix) on ``sys.meta_path``, imports every module of ``repro_torch``, and
then builds the entry points without ``device=`` (the fleet state, the
selection service, the LM and the serving engine); with CUDA hidden each
must raise ``BackendUnavailableError``.  The sources of the package
and of ``chip_smoke.py`` are also scanned for such imports, including the
ones inside functions that an import does not execute.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "src" / "repro_torch"
BLOCKED = ("jax", "jaxlib", "repro")

CHILD = r"""
import importlib, importlib.abc, json, pkgutil, sys

BLOCKED = %(blocked)r

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import torch
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))

from repro_torch.selector import (BackendUnavailableError, IdentityCatalog,
                                  PriceTable, ProfilingStore,
                                  SelectionService, TorchFusedRankState)
raised = {}
hours = np.ones((2, 3))
mask = np.ones((2, 3), bool)
try:
    TorchFusedRankState(hours, mask, np.ones(3), ["a", "b", "c"])
    raised["state"] = None
except BackendUnavailableError as e:
    raised["state"] = type(e).__name__
store = ProfilingStore(config_ids=["a", "b"])
store.add("j0", "a", 1.0)
try:
    SelectionService(IdentityCatalog(["a", "b"]), store,
                     PriceTable({"a": 1.0, "b": 2.0}), backend="torch_fused")
    raised["service"] = None
except BackendUnavailableError as e:
    raised["service"] = type(e).__name__
from repro_torch import configs
from repro_torch.models import LM, build_model
from repro_torch.serve import Engine
cfg = configs.reduced(configs.get("qwen3-1.7b"))
for name, make in (("lm", lambda: LM(cfg)),
                   ("build_model", lambda: build_model(cfg)),
                   ("engine", lambda: Engine(LM(cfg, device="cpu"), slots=1,
                                             max_len=8))):
    try:
        make()
        raised[name] = None
    except BackendUnavailableError as e:
        raised[name] = type(e).__name__
print(json.dumps({"modules": names, "leaked": leaked, "raised": raised,
                  "cuda": torch.cuda.is_available()}))
"""


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""          # no card, whatever the host
    return env


def test_every_module_imports_without_jax_or_reference():
    out = subprocess.run(
        [sys.executable, "-c", CHILD % {"blocked": BLOCKED}],
        capture_output=True, text=True, timeout=300, env=_child_env(),
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {"repro_torch.convert", "repro_torch.kernels.rank_delta",
                "repro_torch.kernels._build",
                "repro_torch.selector.fused_rank",
                "repro_torch.selector.service", "repro_torch.market.replay",
                "repro_torch.market.daemon", "repro_torch.obs.registry",
                "repro_torch.core.trace", "repro_torch.selector.store",
                "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.rwkv6_scan", "repro_torch.kernels.ops",
                "repro_torch.kernels.ref", "repro_torch.models.types",
                "repro_torch.models.layers", "repro_torch.models.recurrent",
                "repro_torch.models.lm", "repro_torch.models.registry",
                "repro_torch.configs", "repro_torch.configs.qwen3_1_7b",
                "repro_torch.configs.rwkv6_3b",
                "repro_torch.configs.stablelm_3b", "repro_torch.core.tpu_flora",
                "repro_torch.market.migration", "repro_torch.serve.engine",
                "repro_torch.serve.__main__"}
    assert expected <= set(res["modules"])
    assert res["leaked"] == []
    assert res["cuda"] is False
    assert res["raised"] == dict.fromkeys(
        ("state", "service", "lm", "build_model", "engine"),
        "BackendUnavailableError")


def _imported_modules(path: Path):
    """Every module name an ``import`` statement in ``path`` names,
    wherever the statement sits (top level or inside a function)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_name_no_jax_or_reference_import():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 35
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert bad == []


def test_chip_smoke_refuses_to_run_without_a_card():
    """Without CUDA the chip script exits non-zero and prints no result
    line (no ``"ok"`` record, no ``kernels`` record)."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
        text=True, timeout=300, env=_child_env(), cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
