"""The port's encoder-decoder model against the reference's, on the same
weights.

``reduced(seamless-m4t-large-v2)`` (2 encoder and 2 decoder layers,
d_model 64, 4 heads of 16, layernorm, the ungated gelu MLP, tied
embeddings, 8 source frames) in float32.  The reference's
``EncDec.init(PRNGKey(0))`` parameters go to the port through
``repro_torch.convert.encdec_params_from_reference``; seeded numpy frames
and tokens go to both.  The reference's models run their jnp ``sdpa``,
not Pallas, so nothing here runs in interpret mode.

* Each attention mode the encoder-decoder adds (``full``, ``cross``,
  ``cross_decode``) against the reference's ``attn_apply``, within atol
  1e-5 and rtol 1e-5.  At F = 600 frames (past the reference's 512-key
  chunk, and ragged) the reference's ``sdpa`` misreads its last chunk
  (ROADMAP.md §C, entry 2), so there the reference's layer runs with its
  kernel oracle ``repro.kernels.ref.attention_ref`` in place of ``sdpa``.
* The whole model: ``encode``, the ``forward`` logits, the ``prefill``
  logits and every cache (``k``, ``v``, ``xk``, ``xv``), then 6 decode
  steps, within the decode-parity tolerance (atol 2e-3, rtol 0,
  ``tests/test_decode_parity.py``); and the port's prefill + decode
  against its own forward.
* A reference prefill state carried into the port, and the decode after
  it.
* The engine: an encoder-decoder model served with its requests' frames
  (the greedy tokens of the reference model), refusing a request without
  frames or with another length; the reference's engine cannot serve the
  model at all (ROADMAP.md §C, entry 6).
* The flash-attention wrapper: bidirectional Tq != Tk against the
  reference's oracle, and a causal call with Tq != Tk refused.
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
from repro.models import layers as jl
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro_torch import configs, convert
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import EncDec, LM, build_model
from repro_torch.models import layers as tl
from repro_torch.serve import Engine, Request
from repro_torch.serve.__main__ import main as serve_main

NAME = "seamless-m4t-large-v2"
ATOL = 2e-3
B, T_TOTAL, T_PROMPT = 2, 12, 6
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)


def _configs():
    rcfg = RC.reduced(RC.get(NAME))
    return rcfg, convert.model_config_from_reference(dataclasses.asdict(rcfg))


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, port EncDec on the same weights,
    frames, tokens)."""
    rcfg, cfg = _configs()
    ref = ref_build_model(rcfg)
    params = ref.init(jax.random.PRNGKey(0))
    model = convert.encdec_params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(23)
    frames = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)
                                 ).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, T_TOTAL)).astype(np.int32)
    return ref, params, model, frames, tokens


def _t(a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.long() if t.dtype == torch.int32 else t


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               **(tol or dict(atol=ATOL, rtol=0)))


# --- single attention modes --------------------------------------------------

def _attn_weights(cfg, seed, cross):
    rng = np.random.default_rng(seed)
    specs = tl.attn_specs(cfg, cross=cross)
    return {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
                ).astype(np.float32) for k, s in specs.items()}


def _oracle_sdpa(q, k, v, *, causal, window=None, **_):
    return jref.attention_ref(q, k, v, causal=causal, window=window)


@pytest.mark.parametrize("F", [8, 100, 600])
@pytest.mark.parametrize("mode", ["full", "cross", "cross_decode"])
def test_attention_modes_match_reference(mode, F, monkeypatch):
    """``full`` over F frames (RoPE at positions 0..F-1), ``cross`` from 5
    target tokens over F encoder outputs (no RoPE; the returned cache is
    the projected K and V), ``cross_decode`` from one token over that
    cache."""
    rcfg, cfg = _configs()
    w = _attn_weights(cfg, 3 + F, cross=mode != "full")
    rng = np.random.default_rng(F)
    T = {"full": F, "cross": 5, "cross_decode": 1}[mode]
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, F, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    kw, tkw = {}, {}
    if mode == "full":
        kw["positions"], tkw["positions"] = jnp.asarray(pos), _t(pos)
    elif mode == "cross":
        kw["kv_x"], tkw["kv_x"] = jnp.asarray(enc), torch.from_numpy(enc)
    else:
        k = rng.standard_normal((B, F, cfg.num_kv_heads, cfg.head_dim)
                                ).astype(np.float32)
        v = rng.standard_normal(k.shape).astype(np.float32)
        kw["cache"] = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
        tkw["cache"] = {"k": torch.from_numpy(k), "v": torch.from_numpy(v)}
    if F > 512:
        # the reference's chunked sdpa misreads a ragged last chunk here
        buggy, _ = jl.attn_apply(jw, rcfg, jnp.asarray(x), mode=mode, **kw)
        monkeypatch.setattr(jl, "sdpa", _oracle_sdpa)
    want, want_cache = jl.attn_apply(jw, rcfg, jnp.asarray(x), mode=mode,
                                     **kw)
    got, got_cache = tl.attn_apply(tw, cfg, torch.from_numpy(x), mode=mode,
                                   **tkw)
    assert got.shape == (B, T, cfg.d_model)
    _close(got, want, **LAYER_TOL)
    if F > 512:
        assert float(jnp.abs(buggy - want).max()) > 1e-3
    if mode == "full":
        assert got_cache is None and want_cache is None
    else:
        assert set(got_cache) == set(want_cache) == {"k", "v"}
        for key in ("k", "v"):
            _close(got_cache[key], want_cache[key], **LAYER_TOL)


def test_cross_layers_have_no_qk_norm():
    """A cross layer's specs drop the q/k norm (the reference's rule),
    which a qk-norm config's self-attention keeps."""
    cfg = configs.reduced(configs.get("qwen3-1.7b"))
    assert {"q_norm", "k_norm"} <= set(tl.attn_specs(cfg))
    assert not {"q_norm", "k_norm"} & set(tl.attn_specs(cfg, cross=True))
    ref = jl.attn_specs(RC.reduced(RC.get("qwen3-1.7b")), cross=True)
    assert set(tl.attn_specs(cfg, cross=True)) == set(ref)


# --- the whole model ---------------------------------------------------------

def test_config_and_parameter_tree_match_reference(pair):
    ref, params, model, _, _ = pair
    assert model.cfg == configs.reduced(configs.get(NAME))
    assert (model.cfg.encoder_layers, model.cfg.num_layers) == (2, 2)
    assert len(model.enc_blocks) == 2 and len(model.dec_blocks) == 2
    assert "cross" in model.dec_blocks[0] and "ln_cross" in model.dec_blocks[0]
    assert "cross" not in model.enc_blocks[0]
    n_ref = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref


def test_encode_and_forward_match_reference(pair):
    ref, params, model, frames, tokens = pair
    want_enc = ref.encode(params, jnp.asarray(frames), remat=False)
    got_enc = model.encode(torch.from_numpy(frames))
    assert got_enc.shape == frames.shape
    _close(got_enc, want_enc)
    batch = {"frontend_embeds": frames, "tokens": tokens}
    want, _ = ref.forward(params, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, remat=False)
    got = model({k: _t(v) for k, v in batch.items()})
    assert got.shape == want.shape == (B, T_TOTAL, model.cfg.vocab_size)
    _close(got, want)


def _ref_prefill(ref, params, frames, tokens):
    rstate = ref.init_state(B, T_TOTAL, frames.shape[1])
    return ref.prefill(params, {"frontend_embeds": jnp.asarray(frames),
                                "tokens": jnp.asarray(tokens[:, :T_PROMPT])},
                       rstate)


def test_prefill_caches_and_decode_match_reference(pair):
    ref, params, model, frames, tokens = pair
    cfg = model.cfg
    rlog, rstate = _ref_prefill(ref, params, frames, tokens)
    state = model.init_state(B, T_TOTAL, frames.shape[1])
    log, state = model.prefill({"frontend_embeds": torch.from_numpy(frames),
                                "tokens": _t(tokens[:, :T_PROMPT])}, state)
    _close(log, rlog)
    want_state = convert.encdec_state_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rstate), device="cpu")
    assert len(state) == len(want_state) == cfg.num_layers
    for got_l, want_l in zip(state, want_state):
        assert set(got_l) == set(want_l) == {"k", "v", "xk", "xv"}
        assert got_l["xk"].shape == (B, frames.shape[1], cfg.num_kv_heads,
                                     cfg.head_dim)
        for key in got_l:
            _close(got_l[key], want_l[key].numpy())
    full = model({"frontend_embeds": torch.from_numpy(frames),
                  "tokens": _t(tokens)})
    assert float((log - full[:, T_PROMPT - 1]).abs().max()) < ATOL
    for t in range(T_PROMPT, T_TOTAL):
        rlog, rstate = ref.decode_step(params, jnp.asarray(tokens[:, t]),
                                       jnp.int32(t), rstate)
        log, state = model.decode_step(_t(tokens[:, t]), t, state)
        _close(log, rlog)
        assert float((log - full[:, t]).abs().max()) < ATOL, t


def test_reference_prefill_state_carries_into_the_port(pair):
    ref, params, model, frames, tokens = pair
    _, rstate = _ref_prefill(ref, params, frames, tokens)
    state = convert.encdec_state_from_reference(
        model.cfg, jax.tree_util.tree_map(np.asarray, rstate), device="cpu")
    assert all(leaf.dtype == torch.float32 for layer in state
               for leaf in layer.values())
    for t in range(T_PROMPT, T_TOTAL):
        rlog, rstate = ref.decode_step(params, jnp.asarray(tokens[:, t]),
                                       jnp.int32(t), rstate)
        log, state = model.decode_step(_t(tokens[:, t]), t, state)
        _close(log, rlog)


def test_bf16_cross_cache_is_in_the_compute_dtype():
    cfg = dataclasses.replace(configs.reduced(configs.get(NAME)),
                              dtype="bfloat16")
    model = EncDec(cfg, device="cpu", seed=1)
    state = model.init_state(2, 8, 5)
    assert state[0]["xk"].dtype == state[0]["k"].dtype == torch.bfloat16
    assert state[0]["xv"].shape == (2, 5, cfg.num_kv_heads, cfg.head_dim)
    frames = torch.randn(2, 5, cfg.d_model)
    logits, state = model.prefill({"frontend_embeds": frames,
                                   "tokens": torch.zeros((2, 3),
                                                         dtype=torch.long)},
                                  state)
    assert logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()
    assert state[1]["xk"].abs().sum() > 0


def test_prefill_refuses_frames_of_another_length(pair):
    _, _, model, frames, tokens = pair
    state = model.init_state(B, T_TOTAL, frames.shape[1] + 1)
    with pytest.raises(ValueError, match="enc_len"):
        model.prefill({"frontend_embeds": torch.from_numpy(frames),
                       "tokens": _t(tokens[:, :T_PROMPT])}, state)


def test_build_model_gives_encdec_and_lm_refuses_it():
    cfg = configs.reduced(configs.get(NAME))
    assert isinstance(build_model(cfg, device="cpu"), EncDec)
    with pytest.raises(ValueError, match="EncDec"):
        LM(cfg, device="cpu")
    with pytest.raises(ValueError, match="LM"):
        EncDec(configs.reduced(configs.get("qwen3-1.7b")), device="cpu")


# --- the engine --------------------------------------------------------------

def _requests(cfg, n, F, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, T_PROMPT),
                    max_new_tokens=4,
                    frames=rng.standard_normal((F, cfg.d_model)).astype(
                        np.float32), **kw)
            for i in range(n)]


def test_engine_serves_frames_with_the_reference_models_greedy_tokens(pair):
    """Three requests over two slots (a wave padded with a copy): each
    completion equals the reference model's greedy decode of the same
    source and prompt."""
    ref, params, model, _, _ = pair
    cfg = model.cfg
    F = cfg.frontend_len
    eng = Engine(model, slots=2, max_len=16, enc_len=F, device="cpu")
    reqs = _requests(cfg, 3, F)
    comps = eng.serve(reqs)
    assert sorted(c.uid for c in comps) == [0, 1, 2]
    assert eng.prefills == 2 and eng.decode_steps == 6
    for c in comps:
        r = reqs[c.uid]
        rstate = ref.init_state(1, 16, F)
        logits, rstate = ref.prefill(
            params, {"frontend_embeds": jnp.asarray(r.frames[None]),
                     "tokens": jnp.asarray(r.prompt[None].astype(np.int32))},
            rstate)
        want = [int(jnp.argmax(logits[0]))]
        for step in range(r.max_new_tokens - 1):
            logits, rstate = ref.decode_step(
                params, jnp.asarray([want[-1]], jnp.int32),
                jnp.int32(T_PROMPT + step), rstate)
            want.append(int(jnp.argmax(logits[0])))
        assert c.tokens == want, c.uid


def test_reference_engine_cannot_serve_the_model(pair):
    """The recorded fault of the reference (ROADMAP.md §C, entry 6): its
    ``generate_batch`` passes the prompts alone, and ``EncDec.prefill``
    reads ``frontend_embeds``."""
    ref, params, model, _, _ = pair
    eng = RefEngine(ref, params, slots=1, max_len=16,
                    enc_len=model.cfg.frontend_len)
    with pytest.raises(KeyError, match="frontend_embeds"):
        eng.generate_batch([RefRequest(uid=0, prompt=jnp.zeros(
            (T_PROMPT,), jnp.int32), max_new_tokens=2)])


@pytest.mark.parametrize("bad", ["missing", "length", "width"])
def test_engine_refuses_a_wave_without_fitting_frames(pair, bad):
    _, _, model, _, _ = pair
    cfg = model.cfg
    F = cfg.frontend_len
    eng = Engine(model, slots=2, max_len=16, enc_len=F, device="cpu")
    reqs = _requests(cfg, 2, F)
    if bad == "missing":
        reqs[1] = dataclasses.replace(reqs[1], frames=None)
    elif bad == "length":
        reqs[1] = dataclasses.replace(reqs[1], frames=reqs[1].frames[:-1])
    else:
        reqs[1] = dataclasses.replace(reqs[1], frames=reqs[1].frames[:, :-1])
    with pytest.raises(ValueError, match="frames"):
        eng.generate_batch(reqs)
    assert eng.prefills == 0


def test_decoder_only_engine_is_unchanged_and_refuses_frames():
    cfg = configs.reduced(configs.get("qwen3-1.7b"))
    lm = LM(cfg, device="cpu", seed=2)
    reqs = _requests(cfg, 3, 4)
    plain = [dataclasses.replace(r, frames=None) for r in reqs]
    a = Engine(lm, slots=2, max_len=16, device="cpu").serve(plain)
    b = Engine(lm, slots=2, max_len=16, enc_len=4, device="cpu").serve(plain)
    assert [c.tokens for c in a] == [c.tokens for c in b]
    with pytest.raises(ValueError, match="no encoder"):
        Engine(lm, slots=2, max_len=16, device="cpu").serve(reqs)


def test_serve_cli_serves_the_encoder_decoder_model_on_the_cpu(capsys):
    serve_main(["--arch", NAME, "--reduced", "--device", "cpu",
                "--requests", "3", "--max-new", "3", "--frames", "20"])
    out = capsys.readouterr().out
    assert f"{NAME} (reduced, float32) on cpu" in out
    assert out.count("  req ") == 3
    assert "2 prefills, 4 decode steps" in out


# --- the wrapper -------------------------------------------------------------

#: (B, Tq, Tk, H, G, D): the encoder-decoder's shapes in small: a prompt
#: over a source, one decode token over it, a ragged source, Tk < Tq
BIDIR_CASES = [(2, 6, 40, 4, 4, 16), (2, 1, 130, 4, 1, 64),
               (1, 7, 1000, 4, 2, 64), (1, 100, 37, 4, 2, 128),
               (1, 129, 300, 4, 4, 80)]


@pytest.mark.parametrize("case", BIDIR_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bidirectional_tq_ne_tk_matches_reference_oracle(case, dtype):
    """The wrapper's CPU version with Tq != Tk against the reference's
    oracle (the reference kernel tests' tolerances: fp32 atol 2e-5, bf16
    atol 2e-2, rtol 1e-2)."""
    Bq, Tq, Tk, H, G, D = case
    rng = np.random.default_rng(sum(case))
    arrays = (rng.standard_normal((Bq, Tq, H, D)).astype(np.float32),
              rng.standard_normal((Bq, Tk, G, D)).astype(np.float32),
              rng.standard_normal((Bq, Tk, G, D)).astype(np.float32))
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = jref.attention_ref(*(jnp.asarray(a).astype(jdt) for a in arrays),
                              causal=False)
    got = fa.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrays),
                             causal=False)
    assert got.shape == (Bq, Tq, H, D) and got.dtype == tdt
    atol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=1e-2)


@pytest.mark.parametrize("Tq,Tk", [(1, 40), (40, 1), (6, 7)])
def test_causal_call_with_tq_ne_tk_is_refused(Tq, Tk):
    q = torch.zeros((1, Tq, 2, 16))
    k = torch.zeros((1, Tk, 2, 16))
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="causal"):
        fa._launch(q, k, k, True, None)
    assert fa.flash_attention(q, k, k, causal=False).shape == q.shape


def test_reset_launches_clears_the_counts_by_shape():
    """A CPU call launches nothing, so it counts nothing; ``reset_launches``
    zeroes the totals and empties the counts by (variant, Tq, Tk,
    causal)."""
    fa.reset_launches()
    q, k = torch.zeros((1, 3, 2, 16)), torch.zeros((1, 5, 2, 16))
    fa.flash_attention(q, k, k, causal=False)
    assert fa.SHAPE_LAUNCHES == {} and set(fa.LAUNCHES.values()) == {0}
    fa.SHAPE_LAUNCHES[("tc", 3, 5, False)] = 1
    fa.LAUNCHES["flash_attention_tc"] = 1
    fa.reset_launches()
    assert fa.SHAPE_LAUNCHES == {} and set(fa.LAUNCHES.values()) == {0}
