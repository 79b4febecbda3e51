"""The port's LM against the reference LM, on the same weights.

For ``reduced(qwen3-1.7b)`` (dense attention, GQA, qk-norm, tied
embeddings), ``reduced(stablelm-3b)`` (layernorm with bias, 25% rotary,
untied embeddings; also at its real head size 80) and
``reduced(rwkv6-3b)`` (RWKV-6 time and channel mixes), in float32: the reference's ``LM.init(PRNGKey(0))`` parameters go to the
port through ``repro_torch.convert``, the same seeded tokens go to both,
and ``forward``, ``prefill`` (logits and state) and six ``decode_step``
logits must agree within the reference's decode-parity tolerance
(atol 2e-3, ``tests/test_decode_parity.py``).  The port's own prefill +
decode must also reproduce its own forward, the reference's strongest
serving invariant.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import build_model as ref_build_model
from repro.models.types import count_params as ref_count_params
from repro_torch import configs, convert
from repro_torch.models import LM, NotPortedError, build_model, count_params
from repro_torch.models.lm import param_specs

ARCHS = ["qwen3-1.7b", "stablelm-3b", "rwkv6-3b"]
ATOL = 2e-3
B, T_TOTAL, T_PROMPT = 2, 12, 6


def _pair(name, rcfg):
    """(name, reference model, its params, port LM on the same weights,
    tokens) for the reference config ``rcfg``."""
    ref = ref_build_model(rcfg)
    params = ref.init(jax.random.PRNGKey(0))
    cfg = convert.model_config_from_reference(dataclasses.asdict(rcfg))
    lm = convert.lm_params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    tokens = np.random.default_rng(len(name)).integers(
        0, cfg.vocab_size, (B, T_TOTAL)).astype(np.int32)
    return name, ref, params, lm, tokens


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param, RC.reduced(RC.get(request.param)))


def _t(tokens):
    return torch.as_tensor(np.asarray(tokens), dtype=torch.long)


def test_config_conversion_matches_ports_own_registry(pair):
    name, ref, _, lm, _ = pair
    assert lm.cfg == configs.reduced(configs.get(name))
    assert lm.cfg.compute_dtype == torch.float32
    assert count_params(lm.param_specs()) == \
        ref_count_params(ref.param_specs())


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_parameter_count_matches_reference(name):
    """Specs only, nothing allocated: 1.72 B for qwen3-1.7b, 2.80 B for
    stablelm-3b, 3.08 B for rwkv6-3b, the same as the reference's."""
    ours = count_params(param_specs(configs.get(name)))
    theirs = ref_count_params(ref_build_model(RC.get(name)).param_specs())
    assert ours == theirs
    assert ours == pytest.approx({"qwen3-1.7b": 1.72e9,
                                  "stablelm-3b": 2.795e9,
                                  "rwkv6-3b": 3.08e9}[name], rel=0.01)


def test_forward_matches_reference(pair):
    _check_forward(pair)


def _check_forward(pair):
    _, ref, params, lm, tokens = pair
    want, _ = ref.forward(params, {"tokens": jnp.asarray(tokens)},
                          remat=False)
    got = lm({"tokens": _t(tokens)})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_prefill_and_decode_match_reference(pair):
    _check_prefill_and_decode(pair)


def _check_prefill_and_decode(pair):
    _, ref, params, lm, tokens = pair
    cfg = lm.cfg
    rstate = ref.init_state(B, T_TOTAL)
    rlog, rstate = ref.prefill(params,
                               {"tokens": jnp.asarray(tokens[:, :T_PROMPT])},
                               rstate)
    state = lm.init_state(B, T_TOTAL)
    log, state = lm.prefill({"tokens": _t(tokens[:, :T_PROMPT])}, state)
    np.testing.assert_allclose(log.numpy(), np.asarray(rlog), atol=ATOL,
                               rtol=0)
    want_state = convert.lm_state_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rstate), device="cpu")
    assert len(state) == len(want_state) == cfg.num_layers
    for got_l, want_l in zip(state, want_state):
        assert set(got_l) == set(want_l)
        for key in got_l:
            np.testing.assert_allclose(got_l[key].float().numpy(),
                                       want_l[key].float().numpy(),
                                       atol=ATOL, rtol=1e-3)
    for t in range(T_PROMPT, T_TOTAL):
        rlog, rstate = ref.decode_step(params, jnp.asarray(tokens[:, t]),
                                       jnp.int32(t), rstate)
        log, state = lm.decode_step(_t(tokens[:, t]), t, state)
        np.testing.assert_allclose(log.numpy(), np.asarray(rlog), atol=ATOL,
                                   rtol=0, err_msg=f"decode step {t}")


def test_stablelm_at_head_size_80_matches_reference():
    """stablelm-3b's real head size (2560 / 32 = 80) at a small width: 2
    layers of 2 heads, d_model 160, rotary over 20 of the 80 dims.  The
    forward and prefill + decode match the reference's through the port's
    plain attention (the CPU path of the kernel that serves D = 80)."""
    rcfg = dataclasses.replace(
        RC.reduced(RC.get("stablelm-3b"), d_model=160), num_heads=2,
        num_kv_heads=2, head_dim=80)
    pair = _pair("stablelm-3b", rcfg)
    cfg = pair[3].cfg
    assert (cfg.num_layers, cfg.num_heads, cfg.head_dim) == (2, 2, 80)
    assert int(cfg.head_dim * cfg.rope_fraction) == 20
    _check_forward(pair)
    _check_prefill_and_decode(pair)


def test_own_prefill_and_decode_match_own_forward(pair):
    """The port's serving path reproduces its own training-mode forward
    (``tests/test_decode_parity.py`` for the reference)."""
    _, _, _, lm, tokens = pair
    full = lm({"tokens": _t(tokens)})
    state = lm.init_state(B, T_TOTAL)
    log, state = lm.prefill({"tokens": _t(tokens[:, :T_PROMPT])}, state)
    assert float((log - full[:, T_PROMPT - 1]).abs().max()) < ATOL
    for t in range(T_PROMPT, T_TOTAL):
        log, state = lm.decode_step(_t(tokens[:, t]), t, state)
        assert float((log - full[:, t]).abs().max()) < ATOL, t


def test_seeded_init_is_deterministic_and_follows_the_specs():
    cfg = configs.reduced(configs.get("qwen3-1.7b"))
    a, b = LM(cfg, device="cpu", seed=3), LM(cfg, device="cpu", seed=3)
    c = build_model(cfg, device="cpu", seed=4)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        assert not pa.requires_grad
    wq = a.blocks[0]["attn"]["wq"]
    assert not torch.equal(wq, c.blocks[0]["attn"]["wq"])
    assert float(wq.std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.1)
    assert torch.equal(a.blocks[0]["ln1"]["scale"],
                       torch.ones(cfg.d_model))


def test_bf16_config_stores_weights_as_its_uses_read_them():
    """Matmul weights in the compute dtype, the float32-read leaves (norm
    scales, the RWKV decay base and bonus) in float32; the reference
    stores float32 and casts per use, which is the same values."""
    cfg = dataclasses.replace(configs.reduced(configs.get("rwkv6-3b")),
                              dtype="bfloat16")
    lm = LM(cfg, device="cpu")
    tm = lm.blocks[0]["tm"]
    assert tm["wr"].dtype == torch.bfloat16
    assert lm.embed["embedding"].dtype == torch.bfloat16
    for leaf in ("decay_base", "u", "ln_scale", "ln_bias"):
        assert tm[leaf].dtype == torch.float32, leaf
    assert lm.blocks[0]["ln1"]["scale"].dtype == torch.float32
    state = lm.init_state(2, 8)
    assert state[0]["wkv"].dtype == torch.float32
    assert state[0]["tm_shift"].dtype == torch.bfloat16
    logits, state = lm.prefill({"tokens": torch.zeros((2, 5),
                                                      dtype=torch.long)},
                               state)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(
        logits.float()).all()


@pytest.mark.parametrize("name", [n for n in RC.ARCH_NAMES
                                  if n not in ARCHS])
def test_unported_architectures_say_so(name):
    with pytest.raises(NotPortedError, match="ROADMAP"):
        configs.get(name)


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "qwen3-moe-30b-a3b",
                                  "seamless-m4t-large-v2"])
def test_unported_layers_say_so(name):
    """``build_model`` refuses RG-LRU, MoE and encoder-decoder models."""
    rcfg = RC.reduced(RC.get(name))
    cfg = convert.model_config_from_reference(dataclasses.asdict(rcfg))
    with pytest.raises(NotPortedError):
        build_model(cfg, device="cpu")


def test_unknown_architecture_is_a_key_error():
    with pytest.raises(KeyError):
        configs.get("gpt-5")
    assert configs.ARCH_NAMES == RC.ARCH_NAMES


# --- single layers against the reference's --------------------------------------

@pytest.mark.parametrize("fraction", [1.0, 0.25])
def test_rope_matches_reference(fraction):
    """Full and partial rotary embedding (stablelm's 0.25)."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(7) + 5]).astype(np.int32)
    want = jl.rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6,
                   fraction=fraction)
    got = tl.rope(torch.from_numpy(x), torch.from_numpy(pos), theta=1e6,
                  fraction=fraction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind):
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(24).astype(np.float32),
         "bias": rng.standard_normal(24).astype(np.float32)}
    want = jl.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind)
    got = tl.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    want = jl.rms_norm_1d(jnp.asarray(x), jnp.asarray(p["scale"]))
    got = tl.rms_norm_1d(torch.from_numpy(x), torch.from_numpy(p["scale"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("T,S", [(5, 8), (8, 8), (13, 4)])
def test_prefill_cache_write_matches_reference(T, S):
    """A plain write at offset 0, and the ring case (S < T) keeping the
    last S tokens at slot = position % S."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(T)
    cache = rng.standard_normal((2, S, 3, 4)).astype(np.float32)
    k = rng.standard_normal((2, T, 3, 4)).astype(np.float32)
    want = jl._cache_write_prefill(jnp.asarray(cache), jnp.asarray(k))
    got = tl._cache_write_prefill(torch.from_numpy(cache.copy()),
                                  torch.from_numpy(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
