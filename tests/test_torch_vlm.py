"""The port's vision-language model (pixtral-12b) against the reference's,
on the same weights.

``reduced(pixtral-12b)`` (2 layers, d_model 64, 4 query heads on one KV
head of 16, untied embeddings, rope_theta 1e6, 8 patches) and a variant
at pixtral's real head size 160 (d_model 320, 2 query heads on one KV
head; ``dataclasses.replace`` on both packages' reduced configs), in
float32.  The reference's ``LM.init(PRNGKey(0))`` parameters go to the
port through ``repro_torch.convert.lm_params_from_reference`` (the
reference's vision tower is a stub and has no parameters, so no new
leaves); seeded numpy patch embeddings and tokens go to both.  The
reference's models run their jnp ``sdpa``, not Pallas, so nothing here
runs in interpret mode.

* ``forward`` with the patches prepended, within 1e-5 of the
  reference's in relative L2 over the logits (and every logit within
  1e-4: float32 sums taken in another order over 2 layers move logits of
  up to about 4 by up to 3.4e-5, 2e-6 of their norm); a text-only batch
  likewise.
* ``prefill`` over F patches and 6 prompt tokens (logits and every
  cache, which ``lm_state_from_reference`` also carries across), then 6
  decode steps at ``F + t``, within the decode-parity tolerance (atol
  2e-3, ``tests/test_decode_parity.py``) of the reference's ``prefill``
  and ``decode_step`` and of the port's own ``forward``.
* The port's plain attention at D = 160 against the reference's oracle
  ``repro.kernels.ref.attention_ref``: causal, GQA, a window, ragged T
  and bidirectional Tq != Tk, within 1e-5.
* The engine: requests with patches give the reference model's greedy
  tokens (its ``prefill`` and ``decode_step`` driven from ``F + T_p``);
  a wave with mixed or unequal patches is refused.  The reference's
  engine has no field for patches and serves the text alone
  (ROADMAP.md §C, entry 7): its wave equals the port's text-only wave.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.kernels import ref as jref
from repro.models import build_model as ref_build_model
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro_torch import configs, convert
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import LM, build_model, count_params
from repro_torch.serve import Engine, Request
from repro_torch.serve.__main__ import main as serve_main

NAME = "pixtral-12b"
ATOL = 2e-3
#: the forward's bound: relative L2 over the logits, and each logit
FORWARD_REL_L2, FORWARD_ATOL = 1e-5, 1e-4
B, T_TOTAL, T_PROMPT = 2, 12, 6


def _reduced(head_dim):
    """Both packages' reduced pixtral, at its own head size (16) or at
    pixtral's real 160 (d_model 320, 2 query heads on one KV head)."""
    out = []
    for pkg in (RC, configs):
        cfg = pkg.reduced(pkg.get(NAME))
        if head_dim == 160:
            cfg = dataclasses.replace(pkg.reduced(pkg.get(NAME), d_model=320),
                                      num_heads=2, num_kv_heads=1,
                                      head_dim=160)
        out.append(cfg)
    return out


@pytest.fixture(scope="module", params=[16, 160], ids=["d16", "d160"])
def pair(request):
    """(reference model, its params, port LM on the same weights, patches
    (B, F, d_model), tokens (B, T_TOTAL))."""
    rcfg, cfg = _reduced(request.param)
    ref = ref_build_model(rcfg)
    params = ref.init(jax.random.PRNGKey(0))
    lm = convert.lm_params_from_reference(
        convert.model_config_from_reference(dataclasses.asdict(rcfg)),
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    assert lm.cfg == cfg
    rng = np.random.default_rng(24 + request.param)
    patches = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)
                                  ).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, T_TOTAL)).astype(np.int32)
    return ref, params, lm, patches, tokens


def _t(a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.long() if t.dtype == torch.int32 else t


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               **(tol or dict(atol=ATOL, rtol=0)))


def _ref_batch(patches, tokens):
    return {"frontend_embeds": jnp.asarray(patches),
            "tokens": jnp.asarray(tokens)}


def _batch(patches, tokens):
    return {"frontend_embeds": _t(patches), "tokens": _t(tokens)}


def _forward_close(got, want):
    got, want = got.numpy(), np.asarray(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < FORWARD_REL_L2, rel
    np.testing.assert_allclose(got, want, atol=FORWARD_ATOL, rtol=0)


# --- the model ---------------------------------------------------------------

def test_config_and_parameters_carry_across(pair):
    """``get`` gives pixtral; ``convert`` carries its reduced weights with
    no new leaves (the vision tower is a stub), as many parameters as the
    reference's."""
    ref, params, lm, _, _ = pair
    cfg = lm.cfg
    assert (cfg.family, cfg.frontend, cfg.frontend_len) == ("vlm", "vision",
                                                            8)
    assert cfg.head_dim in (16, 160) and cfg.num_layers == 2
    n_ref = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in lm.parameters()) == n_ref == \
        count_params(lm.param_specs())
    full = configs.get(NAME)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size, full.rope_theta,
            full.frontend_len) == (40, 5120, 32, 8, 160, 14336, 131072, 1e6,
                                   1024)
    assert full.head_dim in fa.HEAD_DIMS and full.head_dim in fa.TC_HEAD_DIMS


def test_forward_with_patches_matches_reference(pair):
    """(B, F + T, V) logits, the patches first, within relative L2
    1e-5."""
    ref, params, lm, patches, tokens = pair
    want, _ = ref.forward(params, _ref_batch(patches, tokens), remat=False)
    got = lm(_batch(patches, tokens))
    F = patches.shape[1]
    assert got.shape == want.shape == (B, F + T_TOTAL, lm.cfg.vocab_size)
    _forward_close(got, want)


def test_text_only_batch_matches_reference(pair):
    """Without ``frontend_embeds`` the VLM serves text alone, as the
    reference's does."""
    ref, params, lm, _, tokens = pair
    want, _ = ref.forward(params, {"tokens": jnp.asarray(tokens)},
                          remat=False)
    got = lm({"tokens": _t(tokens)})
    assert got.shape == (B, T_TOTAL, lm.cfg.vocab_size)
    _forward_close(got, want)


def test_prefill_and_decode_match_reference_and_own_forward(pair):
    """Prefill over F patches and 6 prompt tokens fills F + 6 cache
    entries; 6 decode steps at ``F + t``; every logit within 2e-3 of the
    reference's and of the port's own forward, every cache entry of the
    reference's (carried across by ``lm_state_from_reference``)."""
    ref, params, lm, patches, tokens = pair
    cfg = lm.cfg
    F = patches.shape[1]
    max_len = F + T_TOTAL
    rlog, rstate = ref.prefill(
        params, _ref_batch(patches, tokens[:, :T_PROMPT]),
        ref.init_state(B, max_len))
    state = lm.init_state(B, max_len)
    log, state = lm.prefill(_batch(patches, tokens[:, :T_PROMPT]), state)
    _close(log, rlog)
    want_state = convert.lm_state_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rstate), device="cpu")
    assert len(state) == len(want_state) == cfg.num_layers
    for got_l, want_l in zip(state, want_state):
        assert set(got_l) == set(want_l) == {"k", "v"}
        assert got_l["k"].shape == (B, max_len, cfg.num_kv_heads,
                                    cfg.head_dim)
        assert float(got_l["k"][:, F + T_PROMPT:].abs().max()) == 0.0
        for key in got_l:
            _close(got_l[key], want_l[key].numpy())
    full = lm(_batch(patches, tokens))
    assert float((log - full[:, F + T_PROMPT - 1]).abs().max()) < ATOL
    for t in range(T_PROMPT, T_TOTAL):
        rlog, rstate = ref.decode_step(params, jnp.asarray(tokens[:, t]),
                                       jnp.int32(F + t), rstate)
        log, state = lm.decode_step(_t(tokens[:, t]), F + t, state)
        _close(log, rlog)
        assert float((log - full[:, F + t]).abs().max()) < ATOL, t


def test_reference_prefill_state_carries_into_the_port(pair):
    ref, params, lm, patches, tokens = pair
    F = patches.shape[1]
    _, rstate = ref.prefill(params, _ref_batch(patches, tokens[:, :T_PROMPT]),
                            ref.init_state(B, F + T_TOTAL))
    state = convert.lm_state_from_reference(
        lm.cfg, jax.tree_util.tree_map(np.asarray, rstate), device="cpu")
    for t in range(T_PROMPT, T_TOTAL):
        rlog, rstate = ref.decode_step(params, jnp.asarray(tokens[:, t]),
                                       jnp.int32(F + t), rstate)
        log, state = lm.decode_step(_t(tokens[:, t]), F + t, state)
        _close(log, rlog)


def test_bf16_patches_are_cast_to_the_compute_dtype():
    """float32 patches on a bf16 model go in as bf16, unscaled: the same
    logits as patches handed over in bf16."""
    cfg = dataclasses.replace(configs.reduced(configs.get(NAME)),
                              dtype="bfloat16")
    lm = build_model(cfg, device="cpu", seed=1)
    assert isinstance(lm, LM)
    patches = torch.randn(2, cfg.frontend_len, cfg.d_model)
    tokens = torch.zeros((2, 3), dtype=torch.long)
    a = lm({"frontend_embeds": patches, "tokens": tokens})
    b = lm({"frontend_embeds": patches.bfloat16(), "tokens": tokens})
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert a.shape == (2, cfg.frontend_len + 3, cfg.vocab_size)
    state = lm.init_state(2, cfg.frontend_len + 5)
    logits, state = lm.prefill({"frontend_embeds": patches,
                                "tokens": tokens}, state)
    assert torch.isfinite(logits.float()).all()
    assert state[0]["k"].dtype == torch.bfloat16


def test_patches_of_another_width_are_refused():
    cfg = configs.reduced(configs.get(NAME))
    lm = LM(cfg, device="cpu", seed=1)
    with pytest.raises(ValueError, match="frontend_embeds"):
        lm({"frontend_embeds": torch.zeros((2, 4, cfg.d_model + 1)),
            "tokens": torch.zeros((2, 3), dtype=torch.long)})


# --- the plain attention at D = 160 --------------------------------------------

#: (B, Tq, Tk, H, G, causal, window) at D = 160: causal, GQA, a window,
#: ragged T (one past a 64-row tile) and bidirectional Tq != Tk
D160_CASES = [(2, 64, 64, 4, 4, True, None), (1, 100, 100, 8, 2, True, None),
              (1, 130, 130, 4, 2, True, 48), (1, 65, 65, 4, 1, True, None),
              (1, 29, 70, 4, 4, False, None), (2, 1, 37, 4, 2, False, None)]


@pytest.mark.parametrize("case", D160_CASES, ids=str)
def test_plain_attention_at_head_size_160_matches_reference_oracle(case):
    Bq, Tq, Tk, H, G, causal, window = case
    rng = np.random.default_rng(sum(case[:5]))
    q = rng.standard_normal((Bq, Tq, H, 160)).astype(np.float32)
    k = rng.standard_normal((Bq, Tk, G, 160)).astype(np.float32)
    v = rng.standard_normal((Bq, Tk, G, 160)).astype(np.float32)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             window=window)
    assert got.shape == (Bq, Tq, H, 160)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(
        fa.attention_ref(_t(q), _t(k), _t(v), causal=causal,
                         window=window).numpy(), got.numpy())


# --- the engine --------------------------------------------------------------

def _requests(cfg, n, F, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, T_PROMPT),
                    max_new_tokens=4,
                    frames=rng.standard_normal((F, cfg.d_model)).astype(
                        np.float32), **kw)
            for i in range(n)]


def _ref_greedy(ref, params, prompt, patches, n, max_len):
    """The reference model's greedy tokens: its ``prefill`` over the
    patches and the prompt, then ``decode_step`` from ``F + T_p``."""
    batch = {"tokens": jnp.asarray(prompt[None].astype(np.int32))}
    F = 0
    if patches is not None:
        batch["frontend_embeds"] = jnp.asarray(patches[None])
        F = patches.shape[0]
    logits, rstate = ref.prefill(params, batch, ref.init_state(1, max_len))
    want = [int(jnp.argmax(logits[0]))]
    for step in range(n - 1):
        logits, rstate = ref.decode_step(
            params, jnp.asarray([want[-1]], jnp.int32),
            jnp.int32(F + len(prompt) + step), rstate)
        want.append(int(jnp.argmax(logits[0])))
    return want


def test_engine_serves_patches_with_the_reference_models_greedy_tokens(pair):
    """Three requests over two slots (a wave padded with a copy), each
    with its image's patches: every completion equals the reference
    model's greedy decode of the same patches and prompt."""
    ref, params, lm, _, _ = pair
    cfg = lm.cfg
    F = cfg.frontend_len
    max_len = F + T_PROMPT + 4
    eng = Engine(lm, slots=2, max_len=max_len, device="cpu")
    reqs = _requests(cfg, 3, F)
    comps = eng.serve(reqs)
    assert sorted(c.uid for c in comps) == [0, 1, 2]
    assert eng.prefills == 2 and eng.decode_steps == 6
    for c in comps:
        r = reqs[c.uid]
        assert c.tokens == _ref_greedy(ref, params, r.prompt, r.frames,
                                       r.max_new_tokens, max_len), c.uid


def test_engine_decodes_up_to_max_len_counting_the_patches(pair):
    """``max_len`` holds the patches too: with room for two new tokens
    after F patches and the prompt, a request asking for four gets
    three (the prefill's and two decode steps, the last at max_len - 1)."""
    _, _, lm, _, _ = pair
    F = lm.cfg.frontend_len
    eng = Engine(lm, slots=1, max_len=F + T_PROMPT + 2, device="cpu")
    (c,) = eng.generate_batch(_requests(lm.cfg, 1, F))
    assert len(c.tokens) == 3 and eng.decode_steps == 2
    with pytest.raises(ValueError, match="max_len"):
        Engine(lm, slots=1, max_len=F + T_PROMPT - 1,
               device="cpu").generate_batch(_requests(lm.cfg, 1, F))


@pytest.mark.parametrize("bad", ["mixed", "length", "width"])
def test_engine_refuses_mixed_or_unequal_patches(bad):
    cfg = configs.reduced(configs.get(NAME))
    lm = LM(cfg, device="cpu", seed=2)
    F = cfg.frontend_len
    eng = Engine(lm, slots=2, max_len=F + 16, device="cpu")
    reqs = _requests(cfg, 2, F)
    if bad == "mixed":
        reqs[1] = dataclasses.replace(reqs[1], frames=None)
    elif bad == "length":
        reqs[1] = dataclasses.replace(reqs[1], frames=reqs[1].frames[:-1])
    else:
        reqs[1] = dataclasses.replace(reqs[1], frames=reqs[1].frames[:, :-1])
    with pytest.raises(ValueError, match="frames"):
        eng.generate_batch(reqs)
    assert eng.prefills == 0


def test_reference_engine_serves_the_text_alone(pair):
    """The recorded fault of the reference (ROADMAP.md §C, entry 7): its
    ``Request`` has no field for patches, and its wave (prompts only,
    decoding from ``T_p``) equals the port's text-only wave, not the wave
    with the image's patches."""
    ref, params, lm, _, _ = pair
    cfg = lm.cfg
    F = cfg.frontend_len
    reqs = _requests(cfg, 2, F)
    with pytest.raises(TypeError, match="frames"):
        RefRequest(uid=0, prompt=jnp.zeros((T_PROMPT,), jnp.int32),
                   frames=reqs[0].frames)
    ref_comps = RefEngine(ref, params, slots=2, max_len=F + 16).serve(
        [RefRequest(uid=r.uid, prompt=jnp.asarray(r.prompt, jnp.int32),
                    max_new_tokens=r.max_new_tokens) for r in reqs])
    text = Engine(lm, slots=2, max_len=F + 16, device="cpu").serve(
        [dataclasses.replace(r, frames=None) for r in reqs])
    image = Engine(lm, slots=2, max_len=F + 16, device="cpu").serve(reqs)
    assert [c.tokens for c in ref_comps] == [c.tokens for c in text]
    assert [c.tokens for c in text] != [c.tokens for c in image]


def test_serve_cli_serves_the_vlm_on_the_cpu(capsys):
    serve_main(["--arch", NAME, "--reduced", "--device", "cpu",
                "--requests", "3", "--max-new", "3", "--frames", "20"])
    out = capsys.readouterr().out
    assert f"{NAME} (reduced, float32) on cpu" in out
    assert out.count("  req ") == 3
    assert "2 prefills, 4 decode steps" in out
