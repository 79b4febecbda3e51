"""The port's RG-LRU block (RecurrentGemma) and its local attention against
the reference's, on the same float32 inputs.

The same numpy-seeded inputs go to ``repro.models.recurrent`` and to
``repro_torch.models.recurrent``: the scan (``rglru_scan``, the port's
Hillis-Steele doubling against the reference's ``lax.associative_scan``,
both with the same ``combine``) within rel 1e-5 / abs 1e-6, the float32
sums taken in two tree orders being all that may differ; the depthwise
conv, the gates and the whole block within 1e-4.  Then the model: a
reduced ``recurrentgemma-9b`` at window 4 over 14 tokens (the reference's
``test_window_ring_cache_parity``: the ring cache wraps), the decode
ring's slot and valid mask step by step, and a reference prefill state
carried into the port in bf16 (``h`` must stay float32).  The whole
model's forward, prefill and decode are held in ``tests/test_torch_lm.py``
and its engine in ``tests/test_torch_engine.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import build_model as ref_build_model
from repro.models import layers as JL
from repro.models import recurrent as JR
from repro_torch import convert
from repro_torch.models import layers as TL
from repro_torch.models import recurrent as TR

SCAN_RTOL, SCAN_ATOL = 1e-5, 1e-6
BLOCK_TOL = 1e-4
#: the reference's decode-parity tolerance
PARITY_ATOL = 2e-3
W = 48
#: -8 softplus(1): the most negative log a_t the block can make (lam in
#: [-1, 1], r in (0, 1))
LOG_A_MIN = -JR.RGLRU_C * float(np.log1p(np.e))


def _scan_inputs(seed, B, T, regime):
    """gated ~ N(0, 1), h0 ~ N(0, 1), and log_a by ``regime``: ``strong``
    uniform in [LOG_A_MIN, -0.01] (a_t from 3e-5 to 0.99), ``weak`` in
    [-0.05, -0.01] (a_t from 0.95 to 0.99: a memory of some hundred
    steps) and ``unit`` exactly 0 (a_t = 1, where the reference's clamp
    of 1 - a_t^2 at 1e-12 takes over).  Not between -0.01 and 0: both
    packages take 1 - exp(2 log_a) as written, and there one float32 ulp
    of exp (1.2e-7 near 1, where the two libraries' exp may differ by
    one) is a growing share of 1 - a_t^2 (3e-5 of it at log_a = -1e-3),
    a difference of the formula's conditioning and not of the scan."""
    rng = np.random.default_rng(seed)
    lo, hi = {"strong": (LOG_A_MIN, -0.01), "weak": (-0.05, -0.01),
              "unit": (0.0, 0.0)}[regime]
    log_a = rng.uniform(lo, hi, (B, T, W)).astype(np.float32)
    gated = rng.standard_normal((B, T, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return log_a, gated, h0


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("regime", ["strong", "weak", "unit"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("T", [1, 7, 64, 257])
def test_rglru_scan_matches_reference(T, with_h0, regime):
    log_a, gated, h0 = _scan_inputs(T, 2, T, regime)
    want_h, want_last = JR.rglru_scan(
        jnp.asarray(log_a), jnp.asarray(gated),
        jnp.asarray(h0) if with_h0 else None)
    got_h, got_last = TR.rglru_scan(_t(log_a), _t(gated),
                                    _t(h0) if with_h0 else None)
    assert got_h.dtype == got_last.dtype == torch.float32
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               rtol=SCAN_RTOL, atol=SCAN_ATOL)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               rtol=SCAN_RTOL, atol=SCAN_ATOL)
    # the final state is its own storage, not a view into the scan
    assert got_last.untyped_storage().data_ptr() != \
        got_h.untyped_storage().data_ptr()


def test_rglru_scan_leaves_its_inputs_alone():
    log_a, gated, h0 = (_t(a) for a in _scan_inputs(0, 2, 33, "strong"))
    before = [a.clone() for a in (log_a, gated, h0)]
    TR.rglru_scan(log_a, gated, h0)
    for a, b in zip((log_a, gated, h0), before):
        assert torch.equal(a, b)


def _block_params(seed, d, w, conv_width=4):
    """Float32 numpy weights of one RG-LRU block at 1/sqrt(fan in),
    nonzero biases and conv bias, ``lam`` uniform in [-1, 1]."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=None):
        s = scale if scale is not None else shape[0] ** -0.5
        return (rng.standard_normal(shape) * s).astype(np.float32)
    return {"w_in_gate": normal(d, w), "w_in_rec": normal(d, w),
            "conv_w": normal(conv_width, w, scale=0.1),
            "conv_b": normal(w, scale=0.1),
            "w_a": normal(w, w), "b_a": normal(w, scale=0.1),
            "w_x": normal(w, w), "b_x": normal(w, scale=0.1),
            "lam": rng.uniform(-1.0, 1.0, w).astype(np.float32),
            "w_out": normal(w, d)}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()})


@pytest.mark.parametrize("with_state", [False, True], ids=["none", "state"])
def test_depthwise_conv_matches_reference(with_state):
    jp, tp = _both(_block_params(1, 16, W))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, W)).astype(np.float32)
    st = rng.standard_normal((2, 3, W)).astype(np.float32)
    want_y, want_s = JR._depthwise_conv(
        jp, jnp.asarray(x), jnp.asarray(st) if with_state else None)
    got_y, got_s = TR._depthwise_conv(tp, _t(x),
                                      _t(st) if with_state else None)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=BLOCK_TOL, rtol=BLOCK_TOL)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("split", [1, 2, 5, 8])
def test_depthwise_conv_state_carries_a_split_call(split):
    """The conv over 9 steps in one call equals two calls that carry the
    state, split after 1 (fewer steps than the W - 1 = 3 of history), 2,
    5 and 8 steps."""
    _, tp = _both(_block_params(3, 16, W))
    x = _t(np.random.default_rng(4).standard_normal((2, 9, W)).astype(
        np.float32))
    whole, s_whole = TR._depthwise_conv(tp, x, None)
    y1, s1 = TR._depthwise_conv(tp, x[:, :split], None)
    y2, s2 = TR._depthwise_conv(tp, x[:, split:], s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               whole.numpy(), atol=1e-6, rtol=1e-6)
    assert torch.equal(s2, s_whole)


def test_rglru_gates_match_reference():
    jp, tp = _both(_block_params(5, 16, W))
    x = np.random.default_rng(6).standard_normal((2, 11, W)).astype(
        np.float32)
    want = JR._rglru_gates(jp, jnp.asarray(x))
    got = TR._rglru_gates(tp, _t(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=BLOCK_TOL, rtol=BLOCK_TOL)
    assert float(got[0].min()) >= LOG_A_MIN and float(got[0].max()) <= 0


def _block_cfg():
    return convert.model_config_from_reference(dataclasses.asdict(
        dataclasses.replace(RC.reduced(RC.get("recurrentgemma-9b")),
                            d_model=32, lru_width=W)))


def test_rglru_block_train_mode_matches_reference():
    cfg = _block_cfg()
    jp, tp = _both(_block_params(7, cfg.d_model, W))
    x = np.random.default_rng(8).standard_normal((2, 23, cfg.d_model)
                                                 ).astype(np.float32)
    want, want_s = JR.rglru_block_apply(jp, cfg, jnp.asarray(x))
    got, got_s = TR.rglru_block_apply(tp, cfg, _t(x))
    assert want_s is None and got_s is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=BLOCK_TOL, rtol=BLOCK_TOL)


def test_rglru_block_prefill_and_decode_match_reference():
    """A 9-step prefill from a zero state, then 5 one-step decodes, each
    carrying the state: outputs and states within 1e-4 at every step,
    and the steps together equal to the train-mode pass over all 14."""
    cfg = _block_cfg()
    jp, tp = _both(_block_params(9, cfg.d_model, W))
    x = np.random.default_rng(10).standard_normal((2, 14, cfg.d_model)
                                                  ).astype(np.float32)
    shapes = TR.rglru_state_shapes(cfg, 2)
    assert shapes["h"][2] == torch.float32 and shapes["conv"][2] is None
    zeros = {k: np.zeros(v[0], np.float32) for k, v in shapes.items()}
    jst = {k: jnp.asarray(v) for k, v in zeros.items()}
    tst = {k: _t(v) for k, v in zeros.items()}
    outs = []
    for lo, hi in [(0, 9)] + [(t, t + 1) for t in range(9, 14)]:
        want, jst = JR.rglru_block_apply(jp, cfg, jnp.asarray(x[:, lo:hi]),
                                         state=jst)
        got, tst = TR.rglru_block_apply(tp, cfg, _t(x[:, lo:hi]),
                                        state=tst)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=BLOCK_TOL, rtol=BLOCK_TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       atol=BLOCK_TOL, rtol=BLOCK_TOL)
        outs.append(got)
    whole, _ = TR.rglru_block_apply(tp, cfg, _t(x))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), whole.numpy(),
                               atol=BLOCK_TOL, rtol=BLOCK_TOL)


# --- the local-attention ring cache ----------------------------------------------

def _window_pair(window, seed):
    """(reference model, params, port LM) for reduced recurrentgemma-9b at
    ``window``, float32, the reference's ``PRNGKey(seed)`` weights."""
    rcfg = dataclasses.replace(RC.reduced(RC.get("recurrentgemma-9b")),
                               window=window)
    ref = ref_build_model(rcfg)
    params = ref.init(jax.random.PRNGKey(seed))
    cfg = convert.model_config_from_reference(dataclasses.asdict(rcfg))
    lm = convert.lm_params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return ref, params, lm


def test_window_ring_cache_parity():
    """The reference's ``test_window_ring_cache_parity`` on the port: a
    window of 4 over 14 tokens, a 6-token prompt, so the 4-slot ring
    wraps in the prefill write and twice more in decode.  The port's
    prefill and decode logits equal the reference's forward logits within
    2e-3, and the reference's own prefill and decode too."""
    B, T, T_PROMPT = 2, 14, 6
    ref, params, lm = _window_pair(4, 3)
    tokens = np.random.default_rng(3).integers(
        0, lm.cfg.vocab_size, (B, T)).astype(np.int32)
    full, _ = ref.forward(params, {"tokens": jnp.asarray(tokens)},
                          remat=False)
    full = np.asarray(full)
    state = lm.init_state(B, T)
    assert [tuple(s["k"].shape) for s in state if "k" in s] == \
        [(B, 4, 1, lm.cfg.head_dim)] * 2
    rstate = ref.init_state(B, T)
    logits, state = lm.prefill(
        {"tokens": torch.as_tensor(tokens[:, :T_PROMPT], dtype=torch.long)},
        state)
    rlogits, rstate = ref.prefill(
        params, {"tokens": jnp.asarray(tokens[:, :T_PROMPT])}, rstate)
    for want in (full[:, T_PROMPT - 1], np.asarray(rlogits)):
        np.testing.assert_allclose(logits.numpy(), want, atol=PARITY_ATOL,
                                   rtol=0)
    for t in range(T_PROMPT, T):
        logits, state = lm.decode_step(
            torch.as_tensor(tokens[:, t], dtype=torch.long), t, state)
        rlogits, rstate = ref.decode_step(params, jnp.asarray(tokens[:, t]),
                                          jnp.int32(t), rstate)
        for want in (full[:, t], np.asarray(rlogits)):
            np.testing.assert_allclose(logits.numpy(), want,
                                       atol=PARITY_ATOL, rtol=0,
                                       err_msg=f"decode step {t}")


@pytest.mark.parametrize("S,window", [(4, 4), (6, 4), (16, 4), (16, None)])
def test_decode_ring_slot_and_mask_match_reference(S, window):
    """One attention layer decoding positions 0 to 13 into a cache of S
    slots (a ring when S < 14) after no prefill: the cache written and
    the output at each step equal the reference's."""
    rcfg = dataclasses.replace(RC.reduced(RC.get("recurrentgemma-9b")),
                               window=window)
    cfg = convert.model_config_from_reference(dataclasses.asdict(rcfg))
    rng = np.random.default_rng(S)
    p = {k: rng.standard_normal(s.shape).astype(np.float32) * 0.3
         for k, s in TL.attn_specs(cfg).items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    shape = (2, S, cfg.num_kv_heads, cfg.head_dim)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for pos in range(14):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        positions = np.full((2, 1), pos, np.int32)
        want, jc = JL.attn_apply(jp, cfg, jnp.asarray(x), mode="decode",
                                 positions=jnp.asarray(positions),
                                 window=window, cache=jc,
                                 pos=jnp.int32(pos))
        got, tc = TL.attn_apply(tp, cfg, _t(x), mode="decode",
                                positions=_t(positions), window=window,
                                cache=tc, pos=pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5, err_msg=str(pos))
        for k in ("k", "v"):      # the same slots written, empty ones zero
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=1e-5, rtol=1e-5)


def test_reference_prefill_state_carries_into_the_port_in_bf16():
    """A reduced recurrentgemma-9b in bf16: the reference's prefill state,
    carried across by ``convert.lm_state_from_reference``, keeps RG-LRU's
    ``h`` in float32 bit for bit (the reference holds it in float32;
    rounding it to bf16 moved it by up to 2^-9 of its size), the conv and
    KV leaves in bf16, and the port decodes from it: 4 finite steps whose
    logits stay within 0.05 relative L2 of the reference's decode from
    the same state (0.016 to 0.019 measured: the two frameworks round
    their bf16 products at other places, which no state can remove; the
    bit-for-bit ``h`` is what tells the float32 state from a rounded
    one)."""
    rcfg = dataclasses.replace(RC.reduced(RC.get("recurrentgemma-9b")),
                               dtype="bfloat16")
    ref = ref_build_model(rcfg)
    params = ref.init(jax.random.PRNGKey(1))
    cfg = convert.model_config_from_reference(dataclasses.asdict(rcfg))
    lm = convert.lm_params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    _, rstate = ref.prefill(params, {"tokens": jnp.asarray(tokens[:, :8])},
                            ref.init_state(2, 12))
    host = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), rstate)
    state = convert.lm_state_from_reference(cfg, host, device="cpu")
    flat = convert._unstack_layers(cfg, host)
    for layer, want in zip(state, flat):
        for k, v in layer.items():
            assert v.dtype == (torch.float32 if k == "h" else torch.bfloat16)
            np.testing.assert_array_equal(v.float().numpy(), want[k])
    assert sum("h" in layer for layer in state) == 5
    for t in range(8, 12):
        rlog, rstate = ref.decode_step(params, jnp.asarray(tokens[:, t]),
                                       jnp.int32(t), rstate)
        log, state = lm.decode_step(
            torch.as_tensor(tokens[:, t], dtype=torch.long), t, state)
        want = np.asarray(rlog.astype(jnp.float32))
        got = log.float().numpy()
        assert np.isfinite(got).all()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 0.05, (t, rel)
