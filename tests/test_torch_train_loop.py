"""The port's training substrate against the reference's: the schedule,
microbatching, the data pipeline, gradient compression, checkpoints, the
straggler watchdog and the launcher.

* ``WarmupCosine`` equals the reference's at every step of a run.
* ``microbatches=2`` against 1 on reduced qwen3-1.7b, within the
  reference's own tolerances (``tests/test_train_substrate.py``: atol
  5e-4, rtol 5e-3), and the accumulated gradients against the whole
  batch's within relative L2 1e-5.
* ``TokenStream`` batches byte-equal to the reference's for 3 steps and
  2 hosts; ``PrefetchIterator`` hands them over as tensors on a device.
* ``quantise_int8``, ``dequantise`` and ``ErrorFeedback`` equal to the
  reference's on the same numpy inputs.
* Checkpoints: the reference's round trip, keep-k and atomicity cases,
  bf16 leaves bit for bit, and ``restore_into`` a live model.
* The watchdog and the ``train.step`` / ``train.slow_steps`` metrics on a
  scripted clock, as the reference's ``tests/test_obs.py`` holds them.
* The launcher, ``python -m repro_torch.launch.train --reduced --steps 3
  --device cpu``, and ``--resume`` from its checkpoints; a preempted run
  labels its last checkpoint with the step it reached, so ``--resume``
  runs the rest (the reference's launcher labels it ``--steps``).
* The train step refuses a ``params`` that is not the model's own
  parameters (a copy would get zero gradients).
"""
import dataclasses
import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.data import pipeline as ref_pipeline
from repro.models import settings as ref_settings
from repro.models.types import ShapeSpec as RefShapeSpec
from repro.train import compression as ref_comp
from repro.train import optimizer as ref_opt
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.launch import train as launcher
from repro_torch.models import LM, ShapeSpec
from repro_torch.models import settings
from repro_torch.obs import MetricsRegistry
from repro_torch.train import compression, optimizer
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train import train_loop as train_loop_mod
from repro_torch.train.train_loop import (StragglerWatchdog, TrainConfig,
                                          make_train_step, train_loop,
                                          trainable_params)


def test_settings_keep_reference_names_and_refuse_what_the_port_ignores():
    """The port's settings carry the reference's chunk names and defaults;
    ``use`` sets ``vocab_chunk`` and refuses every field nothing reads."""
    port = {f.name: f.default for f in dataclasses.fields(settings.Settings)}
    ref = {f.name: f.default
           for f in dataclasses.fields(ref_settings.Settings)}
    assert set(port) == {"q_chunk", "kv_chunk", "wkv_chunk", "vocab_chunk"}
    assert all(ref[name] == default for name, default in port.items())
    for name in ("q_chunk", "kv_chunk", "wkv_chunk", "layer_unroll"):
        with pytest.raises(ValueError, match=name):
            with settings.use(**{name: 32}):
                pass
    with settings.use(vocab_chunk=7):
        assert settings.get().vocab_chunk == 7
    assert settings.get() == settings.Settings()


def test_schedule_matches_reference():
    ref = ref_opt.WarmupCosine(peak_lr=3e-3, warmup_steps=10,
                               total_steps=50)
    port = optimizer.WarmupCosine(peak_lr=3e-3, warmup_steps=10,
                                  total_steps=50)
    for step in (0, 1, 5, 10, 11, 30, 50, 60):
        got = port(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got),
                                   float(ref(jnp.int32(step))), rtol=1e-6)


def test_grad_accumulation_matches_full_batch():
    cfg = configs.reduced(configs.get("qwen3-1.7b"))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (4, 16)).astype(
                 np.int32)}
    out = []
    for n in (1, 2):
        model = LM(cfg, device="cpu", seed=0)
        params = trainable_params(model)
        step, opt = make_train_step(model, TrainConfig(microbatches=n,
                                                       peak_lr=1e-3))
        captured = {}
        update = opt.update

        def spy(grads, state, p, update=update, captured=captured):
            captured.update({k: g.clone() for k, g in grads.items()})
            return update(grads, state, p)
        object.__setattr__(opt, "update", spy)
        step(params, opt.init(params), batch)
        out.append(({k: p.detach().clone() for k, p in params.items()},
                    captured))
    (p1, g1), (p2, g2) = out
    for k in p1:
        assert g2[k].dtype == torch.float32
        diff = (g2[k] - g1[k]).norm() / g1[k].norm().clamp_min(1e-30)
        assert float(diff) <= 1e-5, k
        np.testing.assert_allclose(p2[k].numpy(), p1[k].numpy(), atol=5e-4,
                                   rtol=5e-3)


@pytest.mark.parametrize("host", [0, 1])
def test_token_stream_matches_reference(host):
    rcfg = RC.reduced(RC.get("qwen3-1.7b"))
    cfg = configs.reduced(configs.get("qwen3-1.7b"))
    ref = ref_pipeline.for_model(rcfg, RefShapeSpec("s", 33, 4, "train"),
                                 seed=7, host_count=2, host_index=host)
    port = pipeline.for_model(cfg, ShapeSpec("s", 33, 4, "train"), seed=7,
                              host_count=2, host_index=host)
    for step in range(3):
        a, b = ref.batch_at(step), port.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()


def test_prefetch_iterator_hands_tensors_to_the_device():
    cfg = configs.reduced(configs.get("qwen3-1.7b"))
    stream = pipeline.for_model(cfg, ShapeSpec("s", 8, 2, "train"))
    it = pipeline.PrefetchIterator(stream, start_step=2, device="cpu")
    try:
        first = next(it)
    finally:
        it.close()
    assert isinstance(first["tokens"], torch.Tensor)
    np.testing.assert_array_equal(first["tokens"].numpy(),
                                  stream.batch_at(2)["tokens"])


def test_compression_matches_reference():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(257) * 10.0).astype(np.float32)
    q, s = compression.quantise_int8(torch.from_numpy(x))
    rq, rs = ref_comp.quantise_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(
        compression.dequantise(q, s).numpy(),
        np.asarray(ref_comp.dequantise(rq, rs)))
    ef, ref_ef = compression.ErrorFeedback(), ref_comp.ErrorFeedback()
    res = ef.init({"w": torch.zeros(64)})
    ref_res = ref_ef.init({"w": jnp.zeros(64)})
    for i in range(5):
        g = (rng.standard_normal(64) * 10.0 ** (i % 3)).astype(np.float32)
        deq, res = ef.compress({"w": torch.from_numpy(g)}, res)
        ref_deq, ref_res = ref_ef.compress({"w": jnp.asarray(g)}, ref_res)
        np.testing.assert_allclose(deq["w"].numpy(),
                                   np.asarray(ref_deq["w"]), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(g).max()))
        np.testing.assert_allclose(res["w"].numpy(),
                                   np.asarray(ref_res["w"]), rtol=1e-5,
                                   atol=1e-6 * float(np.abs(g).max()))


# --- checkpoints ----------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "nested": {"b": torch.randn(4).to(torch.bfloat16)}}
    opt_state = {"m": {"a": torch.zeros(2, 3)},
                 "f": [{"v": torch.ones(3)}],
                 "count": torch.tensor(7, dtype=torch.int32)}
    ck.save(3, params, opt_state, block=True)
    tree, step = ck.restore({"params": params, "opt_state": opt_state})
    assert step == 3
    assert torch.equal(tree["params"]["a"], params["a"])
    b = tree["params"]["nested"]["b"]
    assert b.dtype == torch.bfloat16
    assert torch.equal(b.view(torch.int16),
                       params["nested"]["b"].view(torch.int16))
    assert int(tree["opt_state"]["count"]) == 7
    assert torch.equal(tree["opt_state"]["f"][0]["v"], torch.ones(3))


def test_checkpoint_keep_k_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    params = {"w": torch.zeros(2)}
    for step in (1, 2, 3, 4):
        ck.save(step, params, block=True)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]
    assert ck.latest_step() == 4


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(1, {"w": torch.ones(128, 128)}, block=True)
    assert not [d for d in os.listdir(tmp_path) if ".tmp" in d]


def test_checkpoint_restores_into_a_live_model(tmp_path):
    cfg = configs.reduced(configs.get("qwen3-1.7b"))
    a, b = LM(cfg, device="cpu", seed=0), LM(cfg, device="cpu", seed=1)
    pa, pb = trainable_params(a), trainable_params(b)
    ck = Checkpointer(str(tmp_path))
    ck.save(5, pa, block=True)
    assert ck.restore_into(pb) == 5
    for k in pa:
        assert torch.equal(pa[k], pb[k])


# --- the host loop and the launcher ---------------------------------------------

def test_train_loop_records_step_spans_and_slow_steps():
    durations = [0.001] * 6 + [0.05] + [0.001]
    reads, t = [], 0.0
    for d in durations:
        reads.append(t)
        t += d
        reads.append(t)
    reg = MetricsRegistry(clock=iter(reads).__next__)

    def fake_step(params, opt_state, batch):
        return params, opt_state, {"loss": torch.tensor(1.0),
                                   "grad_norm": torch.tensor(0.0)}

    wd = StragglerWatchdog(factor=3.0)
    _, _, history = train_loop(
        None, TrainConfig(), {"w": torch.zeros(1)}, {"t": torch.zeros(())},
        iter([{}] * len(durations)), steps=len(durations), watchdog=wd,
        log_every=0, train_step=fake_step, obs=reg)
    assert history["step_time"] == pytest.approx(durations)
    assert reg.histogram("train.step").count == len(durations)
    assert len(wd.events) == 1
    assert reg.counter("train.slow_steps").value == 1


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    launcher.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "3",
                   "--device", "cpu", "--ckpt-dir", ck, "--ckpt-every",
                   "2"])
    out = capsys.readouterr().out
    assert "over 3 steps" in out
    assert Checkpointer(ck).latest_step() == 3
    launcher.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "5",
                   "--device", "cpu", "--ckpt-dir", ck, "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "over 2 steps" in out
    assert Checkpointer(ck).latest_step() == 5


def _preempt_on_batch(monkeypatch, loop_mod, launcher_mod, n):
    """Stop ``loop_mod.train_loop`` as SIGTERM would, when the launcher's
    prefetch iterator hands over its ``n``-th batch: the loop's
    :class:`PreemptionHandler` shares an event that the batch sets."""
    stop = threading.Event()

    class Handler:
        def __init__(self):
            self.requested = stop

    base = launcher_mod.data_lib.PrefetchIterator

    class Stopping(base):
        drawn = 0

        def __next__(self):
            batch = super().__next__()
            Stopping.drawn += 1
            if Stopping.drawn == n:
                stop.set()
            return batch
    monkeypatch.setattr(loop_mod, "PreemptionHandler", Handler)
    monkeypatch.setattr(launcher_mod.data_lib, "PrefetchIterator", Stopping)


def test_preempted_launcher_resumes_where_it_stopped(tmp_path, capsys,
                                                     monkeypatch):
    """ROADMAP.md §C, entry 10: preempted on its third batch of 8, the
    port's launcher leaves step 3 as the latest checkpoint, and
    ``--resume`` runs steps 3 to 8."""
    ck = str(tmp_path / "ck")
    with monkeypatch.context() as mp:
        _preempt_on_batch(mp, train_loop_mod, launcher, 3)
        launcher.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "8",
                       "--device", "cpu", "--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert "preemption checkpoint at step 3" in out and "over 3 steps" in out
    assert Checkpointer(ck).latest_step() == 3
    assert not os.path.exists(os.path.join(ck, "step_00000008"))
    launcher.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "8",
                   "--device", "cpu", "--ckpt-dir", ck, "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "over 5 steps" in out
    assert Checkpointer(ck).latest_step() == 8


def test_reference_launcher_labels_a_preempted_run_as_finished(
        tmp_path, capsys, monkeypatch):
    """The reference's launcher (``src/repro/launch/train.py``, run as it
    is) preempted on its third batch of 8 saves step 3, then the same
    weights again as ``step_00000008``, which ``LATEST`` names: its
    ``--resume`` would run nothing."""
    from repro.launch import train as ref_launcher
    from repro.train import train_loop as ref_loop
    from repro.train.checkpoint import Checkpointer as RefCheckpointer
    ck = str(tmp_path / "ck")
    _preempt_on_batch(monkeypatch, ref_loop, ref_launcher, 3)
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "qwen3-1.7b", "--reduced", "--steps", "8",
        "--ckpt-dir", ck])
    ref_launcher.main()
    out = capsys.readouterr().out
    assert "preemption checkpoint at step 3" in out and "over 3 steps" in out
    assert sorted(d for d in os.listdir(ck) if d.startswith("step_")) == [
        "step_00000003", "step_00000008"]
    assert RefCheckpointer(ck).latest_step() == 8


def test_train_step_refuses_params_that_are_not_the_models():
    """ROADMAP.md §C, entry 12: the step's loss is the model's, so a dict
    of copies would get zero gradients and weight decay alone; the step
    refuses it, naming the first foreign key.  The model's own
    parameters step as before, with the model's loss."""
    cfg = configs.reduced(configs.get("qwen3-1.7b"))
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
                 np.int32)}
    model = LM(cfg, device="cpu", seed=0)
    params = trainable_params(model)
    step, opt = make_train_step(model, TrainConfig())
    copies = {k: p.detach().clone().requires_grad_() for k, p in
              params.items()}
    first = next(iter(copies))
    with pytest.raises(ValueError, match=f"params\\['{first}'\\] is not a "
                       f"parameter of the model"):
        step(copies, opt.init(copies), batch)
    mixed = dict(params)
    last = list(mixed)[-1]
    mixed[last] = copies[last]
    with pytest.raises(ValueError, match=f"params\\['{last}'\\]"):
        step(mixed, opt.init(mixed), batch)
    with torch.no_grad():
        want = float(model.loss({k: torch.from_numpy(v)
                                 for k, v in batch.items()})[0])
    before = {k: p.detach().clone() for k, p in params.items()}
    _, _, m = step(params, opt.init(params), batch)
    assert float(m["loss"]) == pytest.approx(want, rel=1e-6)
    assert float(m["grad_norm"]) > 0
    assert any(not torch.equal(before[k], p) for k, p in params.items())


def test_launcher_auto_mesh_picks_the_reference_mesh(tmp_path, capsys):
    """``--auto-mesh --report``: the training job (class B) ranked over a
    dry-run report's meshes through the port's selection service picks
    the reference launcher's mesh (``tests/test_system.py``'s report:
    32x8 trains faster at the same price)."""
    import json
    from repro.launch.train import select_mesh as ref_select_mesh
    report = {"cells": [
        {"arch": "a", "shape": "train_4k", "mesh": mesh, "ok": True,
         "roofline": {"compute_s": c, "memory_s": 0.1,
                      "collective_s": s}}
        for mesh, c, s in (("16x16", 0.2, 0.05), ("32x8", 0.15, 0.02))]}
    path = tmp_path / "report.json"
    path.write_text(json.dumps(report))
    want = ref_select_mesh(str(path), "ondemand")
    capsys.readouterr()
    assert launcher.select_mesh(str(path), "ondemand", "cpu") == want
    launcher.main(["--reduced", "--steps", "1", "--device", "cpu",
                   "--auto-mesh", "--report", str(path)])
    out = capsys.readouterr().out
    assert f"-> mesh {want} at" in out and "over 1 steps" in out
