"""The port's serving engine and decode-fleet placement against the
reference's.

The reference ``Engine`` and the port's ``Engine`` serve the same seeded
prompts on the same converted weights (reduced configs, float32) and must
emit the same greedy tokens; waves cover every request and EOS stops a
sequence early (``tests/test_serve_and_tpu_flora.py`` for the
reference).  ``plan_decode_placement`` through the port's
``tpu_flora.service_from_dryrun_report`` must pick the reference's mesh.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.core.costmodel import TpuPriceModel as RefTpuPriceModel
from repro.core.tpu_flora import \
    service_from_dryrun_report as ref_service_from_report
from repro.models import build_model as ref_build_model
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import plan_decode_placement as ref_plan
from repro.selector.rank import NothingRankableError as RefNothingRankable
from repro_torch import convert
from repro_torch.core.costmodel import TpuPriceModel
from repro_torch.core.tpu_flora import (MeshOption, TpuFlora, WorkloadRecord,
                                        records_from_dryrun_report,
                                        service_from_dryrun_report)
from repro_torch.obs import FakeClock, MetricsRegistry
from repro_torch.selector import NothingRankableError
from repro_torch.serve import (Engine, Request, make_serve_step,
                               plan_decode_placement)
from repro_torch.serve.__main__ import main as serve_main

ARCHS = ["qwen3-1.7b", "stablelm-3b", "rwkv6-3b"]
SLOTS, MAX_LEN = 2, 32


@pytest.fixture(scope="module", params=ARCHS)
def engines(request):
    """(reference engine, port engine) on the same reduced weights."""
    rcfg = RC.reduced(RC.get(request.param))
    ref_model = ref_build_model(rcfg)
    params = ref_model.init(jax.random.PRNGKey(0))
    cfg = convert.model_config_from_reference(dataclasses.asdict(rcfg))
    lm = convert.lm_params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return (RefEngine(ref_model, params, slots=SLOTS, max_len=MAX_LEN),
            Engine(lm, slots=SLOTS, max_len=MAX_LEN, device="cpu"))


def _prompts(n, T, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, T).astype(np.int32) for _ in range(n)]


def test_greedy_tokens_match_reference_engine(engines):
    ref, port = engines
    prompts = _prompts(5, 8, port.cfg.vocab_size)
    want = ref.serve([RefRequest(uid=i, prompt=jnp.asarray(p),
                                 max_new_tokens=5 + i % 2)
                      for i, p in enumerate(prompts)])
    got = port.serve([Request(uid=i, prompt=p, max_new_tokens=5 + i % 2)
                      for i, p in enumerate(prompts)])
    assert sorted((c.uid, c.tokens) for c in got) == \
        sorted((c.uid, c.tokens) for c in want)
    # 3 waves of 2, 2, 1 requests: max_new - 1 decode steps each (6, 6, 5)
    assert port.prefills == 3 and port.decode_steps == 5 + 5 + 4


def test_engine_greedy_matches_manual_decode(engines):
    _, eng = engines
    prompt = torch.arange(8) % eng.cfg.vocab_size
    [comp] = eng.generate_batch([Request(uid=1, prompt=prompt,
                                         max_new_tokens=5)])
    assert len(comp.tokens) == 5
    model = eng.model
    state = model.init_state(eng.slots, eng.max_len)
    logits, state = model.prefill({"tokens": torch.stack([prompt, prompt])},
                                  state)
    toks = []
    tok = torch.argmax(logits, -1)
    serve_step = make_serve_step(model)
    for step in range(5):
        toks.append(int(tok[0]))
        logits, state = serve_step(tok, 8 + step, state)
        tok = torch.argmax(logits, -1)
    assert comp.tokens == toks


def test_engine_waves_cover_all_requests(engines):
    _, eng = engines
    reqs = [Request(uid=i, prompt=np.arange(4), max_new_tokens=2)
            for i in range(5)]
    comps = eng.serve(reqs)
    assert sorted(c.uid for c in comps) == [0, 1, 2, 3, 4]
    assert all(len(c.tokens) == 2 for c in comps)


def test_engine_eos_stops_early(engines):
    _, eng = engines
    prompt = torch.arange(4)
    state = eng.model.init_state(eng.slots, eng.max_len)
    logits, _ = eng.model.prefill({"tokens": torch.stack([prompt, prompt])},
                                  state)
    first = int(torch.argmax(logits, -1)[0])
    [comp] = eng.generate_batch([Request(uid=1, prompt=prompt,
                                         max_new_tokens=8, eos_id=first)])
    assert comp.tokens == [first]


def test_engine_records_spans_and_refuses_bad_waves(engines):
    _, eng = engines
    clock = FakeClock()
    metrics = MetricsRegistry(clock=clock)
    timed = Engine(eng.model, slots=2, max_len=16, metrics=metrics,
                   device="cpu")
    timed.serve([Request(uid=i, prompt=np.arange(3), max_new_tokens=2)
                 for i in range(3)])
    snap = metrics.snapshot()["histograms"]
    assert snap["serve.prefill"]["count"] == 2
    assert snap["serve.decode"]["count"] == 2
    with pytest.raises(ValueError):
        timed.generate_batch([Request(uid=0, prompt=np.arange(3)),
                              Request(uid=1, prompt=np.arange(4))])
    with pytest.raises(ValueError):
        timed.generate_batch([])


# --- decode-fleet placement ---------------------------------------------------

#: the report of tests/test_system.py::test_dryrun_report_flows_into_...
SYSTEM_REPORT = {"cells": [
    {"arch": "a", "shape": "train_4k", "mesh": "16x16", "ok": True,
     "roofline": {"compute_s": 0.2, "memory_s": 0.1, "collective_s": 0.05}},
    {"arch": "a", "shape": "train_4k", "mesh": "32x8", "ok": True,
     "roofline": {"compute_s": 0.15, "memory_s": 0.1,
                  "collective_s": 0.02}},
    {"arch": "a", "shape": "decode_32k", "mesh": "16x16", "ok": False,
     "error": "x"},
]}


def _decode_report():
    """Decode and train cells of three archs on four meshes: the high-TP
    split decodes fastest, the high-DP one trains fastest."""
    speed = {"dp256xtp1": (1.0, 4.0), "dp32xtp8": (1.2, 1.5),
             "dp16xtp16": (1.5, 1.0), "dp8xtp32": (2.5, 0.9)}
    cells = []
    for arch in ("a1", "a2", "a3"):
        for mesh, (train, decode) in speed.items():
            for shape, s in (("train_4k", train), ("decode_32k", decode)):
                cells.append({"arch": arch, "shape": shape, "mesh": mesh,
                              "ok": True, "roofline": {
                                  "compute_s": s, "memory_s": s / 2,
                                  "collective_s": s / 4}})
    return {"cells": cells}


BACKENDS = [("numpy", "cpu"), ("torch_fused", "cpu")]


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_placement_on_the_system_report_matches_reference(backend, device):
    ref = ref_service_from_report(SYSTEM_REPORT, RefTpuPriceModel())
    port = service_from_dryrun_report(SYSTEM_REPORT, TpuPriceModel(),
                                      backend=backend, device=device)
    # the report profiles no decode job: neither can place a decode fleet
    with pytest.raises(RefNothingRankable):
        ref_plan(ref)
    with pytest.raises(NothingRankableError):
        plan_decode_placement(port)
    want = ref_plan(ref, "train_4k")
    got = plan_decode_placement(port, "train_4k")
    assert got.config_id == want.config_id == "32x8"
    assert got.hourly_cost == pytest.approx(want.hourly_cost)
    assert got.job_class.value == want.job_class.value


@pytest.mark.parametrize("backend,device", BACKENDS)
@pytest.mark.parametrize("market", ["ondemand", "spot"])
def test_decode_placement_and_hysteresis_match_reference(backend, device,
                                                         market):
    report = _decode_report()
    ref = ref_service_from_report(report, RefTpuPriceModel(market))
    port = service_from_dryrun_report(report, TpuPriceModel(market),
                                      backend=backend, device=device)
    want, got = ref_plan(ref), plan_decode_placement(port)
    assert got.config_id == want.config_id
    assert [r.config_id for r in got.ranking] == \
        [r.config_id for r in want.ranking]
    # a fleet standing on the worst mesh moves; one near the best stays
    for current in (want.ranking[-1].config_id, want.ranking[1].config_id):
        rc = dataclasses.replace(want, config_id=current)
        pc = dataclasses.replace(got, config_id=current)
        w = ref_plan(ref, current=rc, switch_cost_hours=2.0)
        g = plan_decode_placement(port, current=pc, switch_cost_hours=2.0)
        assert g.config_id == w.config_id
        assert g.hourly_cost == pytest.approx(w.hourly_cost)


def test_tpu_flora_adapter_matches_reference():
    """Records, and per-class picks with v5p meshes at 3.5x the price."""
    from repro.core import tpu_flora as ref_tf
    report = _decode_report()
    recs = records_from_dryrun_report(report)
    assert [dataclasses.astuple(r) for r in recs] == \
        [dataclasses.astuple(r) for r in ref_tf.records_from_dryrun_report(
            report)]
    assert isinstance(recs[0], WorkloadRecord)
    meshes = sorted({r.mesh for r in recs})
    gen = {m: "v5p" if m == "dp8xtp32" else "v5e" for m in meshes}
    flora = TpuFlora([MeshOption(m, gen[m], 256, (1,), ("data",))
                      for m in meshes], recs, TpuPriceModel())
    ref = ref_tf.TpuFlora([ref_tf.MeshOption(m, gen[m], 256, (1,), ("data",))
                           for m in meshes],
                          ref_tf.records_from_dryrun_report(report),
                          RefTpuPriceModel())
    for shape in ("decode_32k", "train_4k"):
        assert flora.select(shape).name == ref.select(shape).name
        assert flora.select(shape, exclude_archs=("a1",)).name == \
            ref.select(shape, exclude_archs=("a1",)).name
    assert flora.select("decode_32k").name == "dp16xtp16"
    assert flora.select("train_4k").name == "dp256xtp1"


def test_serve_cli_runs_the_reduced_example(tmp_path, capsys):
    report = tmp_path / "report.json"
    report.write_text(json.dumps(_decode_report()))
    serve_main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
                "--requests", "3", "--max-new", "2", "--report",
                str(report)])
    out = capsys.readouterr().out
    assert "placement: mesh dp8xtp32" in out
    assert out.count("  req ") == 3
    assert "2 prefills, 2 decode steps" in out
