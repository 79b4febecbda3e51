"""The port's MoE layer against the reference's, on the same weights.

``repro_torch.models.layers.moe_apply`` and ``repro.models.layers.
moe_apply`` get the same numpy-seeded weights and inputs in float32 (a
reduced ``qwen3-moe-30b-a3b`` at 8 experts): ``y`` and the load-balance
term agree within atol 1e-5 for K = 1, 2 and 4, with and without the
shared expert, with capacity to spare and at the default capacity
factor.  The weights are drawn at 1/sqrt(contraction width), so ``y`` is
of order 1 and 1e-5 is some tens of float32 ulps of its largest entries:
the two packages sum their products in another order, and nothing else
may differ.  Under heavy drops (the reference test's E = 4, K = 1,
capacity factor 0.0801) the kept set is the reference's exactly.  A zero
router makes every probability equal: the picks must be experts
0..K-1, as ``lax.top_k`` breaks ties (``torch.topk`` promises no order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import layers as JL
from repro_torch import configs, convert
from repro_torch.models import layers as TL
from repro_torch.models.lm import block_specs, layer_plans

ATOL = 1e-5


def _cfgs(E=8, K=2, cap=1.25, shared=False):
    """(reference config, port config): reduced qwen3-moe with E experts,
    top-K, capacity factor ``cap``."""
    rcfg = dataclasses.replace(RC.reduced(RC.get("qwen3-moe-30b-a3b")),
                               num_experts=E, experts_per_token=K,
                               capacity_factor=cap, shared_expert=shared)
    return rcfg, convert.model_config_from_reference(dataclasses.asdict(rcfg))


def _weights(specs, rng):
    """A numpy leaf per spec, at 1/sqrt(the contraction width) (the
    router at its own 0.02)."""
    if isinstance(specs, dict):
        return {k: _weights(v, rng) for k, v in specs.items()}
    scale = specs.scale or 1.0 / np.sqrt(specs.shape[-2])
    return (rng.standard_normal(specs.shape) * scale).astype(np.float32)


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


def _both(rcfg, cfg, weights, x):
    """(reference (y, aux), port (y, aux)) as numpy."""
    yj, aj = JL.moe_apply(_to(weights, jnp.asarray), rcfg, jnp.asarray(x))
    yt, at = TL.moe_apply(_to(weights, torch.from_numpy), cfg,
                          torch.from_numpy(x))
    return (np.asarray(yj), float(aj)), (yt.numpy(), float(at))


def _case(seed, B, T, **kw):
    rcfg, cfg = _cfgs(**kw)
    rng = np.random.default_rng(seed)
    weights = _weights(JL.moe_specs(rcfg), rng)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, weights, x


@pytest.mark.parametrize("cap", [64.0, 1.25], ids=["spare", "default"])
@pytest.mark.parametrize("shared", [False, True], ids=["plain", "shared"])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_moe_apply_matches_reference(K, shared, cap):
    rcfg, cfg, weights, x = _case(10 * K + shared, 2, 16, K=K, cap=cap,
                                  shared=shared)
    (yj, aj), (yt, at) = _both(rcfg, cfg, weights, x)
    assert yt.shape == yj.shape == x.shape
    assert np.abs(yj).max() > 0.5       # y of order 1: atol is meaningful
    np.testing.assert_allclose(yt, yj, atol=ATOL, rtol=0)
    assert at == pytest.approx(aj, abs=ATOL, rel=0)
    assert at > 0.5


def test_moe_capacity_drops_keep_the_references_set():
    """E = 4, K = 1, capacity factor 0.0801 over 50 tokens: C = 2 a
    expert, so most tokens are dropped; the port keeps exactly the
    reference's tokens, and their outputs agree."""
    rcfg, cfg, weights, x = _case(5, 1, 50, E=4, K=1, cap=0.0801)
    (yj, _), (yt, _) = _both(rcfg, cfg, weights, x)
    kept_j = np.abs(yj).sum(-1) > 1e-9
    kept_t = np.abs(yt).sum(-1) > 1e-9
    np.testing.assert_array_equal(kept_t, kept_j)
    assert 0 < kept_j.sum() <= 4 * 2 and (~kept_j).sum() > 0
    np.testing.assert_allclose(yt, yj, atol=ATOL, rtol=0)
    # the kept tokens are the first two arrivals at each expert
    _, _, idx = TL.moe_route(_to(weights, torch.from_numpy), cfg,
                             torch.from_numpy(x))
    ids = idx[0, :, 0].numpy()
    first = np.zeros(50, bool)
    for e in range(4):
        first[np.flatnonzero(ids == e)[:2]] = True
    np.testing.assert_array_equal(kept_t[0], first)


@pytest.mark.parametrize("K", [1, 2, 4])
def test_zero_router_picks_the_lowest_experts(K):
    """Every probability equal: the top K are experts 0..K-1 for every
    token, as ``lax.top_k`` picks them, and y is the reference's."""
    rcfg, cfg, weights, x = _case(7, 2, 8, K=K, cap=64.0)
    weights["router"][:] = 0.0
    p = _to(weights, torch.from_numpy)
    _, gates, idx = TL.moe_route(p, cfg, torch.from_numpy(x))
    _, want = jax.lax.top_k(jnp.full((2, 8, cfg.num_experts), 0.5), K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    assert (idx.numpy() == np.arange(K)).all()
    (yj, _), (yt, _) = _both(rcfg, cfg, weights, x)
    np.testing.assert_allclose(yt, yj, atol=ATOL, rtol=0)


def test_router_ties_go_to_the_lower_expert():
    """p = [0.1, 0.3, 0.3, 0.1, 0.3, 0.2] at K = 4: ``lax.top_k`` picks
    [1, 2, 4, 5]; the port's router picks the same.  (``torch.topk`` on
    the CPU picks [2, 4, 1, 5] here.)"""
    probs = np.array([0.1, 0.3, 0.3, 0.1, 0.3, 0.2], np.float32)
    rcfg, cfg, weights, _ = _case(0, 1, 1, E=6, K=4)
    weights["router"][:] = 0.0
    weights["router"][0] = np.log(probs)
    x = np.zeros((1, 1, cfg.d_model), np.float32)
    x[0, 0, 0] = 1.0
    _, _, idx = TL.moe_route(_to(weights, torch.from_numpy), cfg,
                             torch.from_numpy(x))
    _, want = jax.lax.top_k(jnp.asarray(probs), 4)
    assert idx[0, 0].tolist() == np.asarray(want).tolist() == [1, 2, 4, 5]


@pytest.mark.parametrize("B,n,E", [(1, 1, 4), (3, 50, 4), (2, 200, 16),
                                   (4, 64, 128)])
def test_positions_in_expert_matches_reference(B, n, E):
    ids = np.random.default_rng(n + E).integers(0, E, (B, n)).astype(
        np.int32)
    want = np.asarray(jax.vmap(JL._positions_in_expert)(jnp.asarray(ids)))
    got = TL._positions_in_expert(torch.from_numpy(ids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_step_gets_capacity_one():
    """At T = 1 the capacity is 1 a sequence: every token keeps its K
    routes (K <= E distinct experts), so y is the reference's."""
    rcfg, cfg, weights, x = _case(3, 4, 1, K=2)
    assert max(1, int(np.ceil(1 * 2 / 8 * 1.25))) == 1
    (yj, _), (yt, _) = _both(rcfg, cfg, weights, x)
    assert (np.abs(yt).sum(-1) > 0).all()
    np.testing.assert_allclose(yt, yj, atol=ATOL, rtol=0)


def _layout(specs):
    return {k: _layout(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in specs.items()}


@pytest.mark.parametrize("d_ff,gated", [(None, True), (None, False),
                                        (96, True), (96, False)])
def test_mlp_specs_layout_matches_reference(d_ff, gated):
    rcfg, cfg = _cfgs()
    assert _layout(TL.mlp_specs(cfg, d_ff=d_ff, gated=gated)) == \
        _layout(JL.mlp_specs(rcfg, d_ff=d_ff, gated=gated))


@pytest.mark.parametrize("name", ["granite-20b", "deepseek-7b",
                                  "qwen3-moe-30b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_block_layouts_match_reference(name):
    """Each layer's groups and leaf shapes, at full width (specs only):
    granite's ungated gelu MLP keeps ``w_up``/``w_down``, qwen3-moe's
    every layer is ``moe``, llama4 alternates ``mlp`` and ``moe`` with a
    gated shared expert."""
    from repro.models.lm import block_specs as ref_block_specs
    from repro.models.lm import layer_plans as ref_layer_plans
    cfg, rcfg = configs.get(name), RC.get(name)
    ours = [_layout(block_specs(cfg, p)) for p in layer_plans(cfg)[:2]]
    theirs = [_layout(ref_block_specs(rcfg, p))
              for p in ref_layer_plans(rcfg)[:2]]
    assert ours == theirs
    kinds = [("moe" in b, "mlp" in b) for b in ours]
    if name == "granite-20b":
        assert set(ours[0]["mlp"]) == {"w_up", "w_down"}
    if name == "llama4-maverick-400b-a17b":
        assert kinds == [(False, True), (True, False)]
        assert set(ours[1]["moe"]["shared"]) == {"w_gate", "w_up", "w_down"}
    if name == "qwen3-moe-30b-a3b":
        assert kinds == [(True, False)] * 2


@pytest.mark.parametrize("name", ["deepseek-7b", "granite-20b",
                                  "qwen3-moe-30b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_config_matches_reference_field_for_field(name):
    assert dataclasses.asdict(configs.get(name)) == \
        dataclasses.asdict(RC.get(name))
    assert name in configs.PORTED


def test_moe_defaults_match_reference():
    from repro.models.types import ModelConfig as RefConfig
    from repro_torch.models.types import ModelConfig
    fields = ("num_experts", "experts_per_token", "moe_period", "moe_d_ff",
              "shared_expert", "capacity_factor")
    ref = RefConfig("x", "dense", 1, 8, 1, 1, 8, 8)
    ours = ModelConfig("x", "dense", 1, 8, 1, 1, 8, 8)
    assert [getattr(ours, f) for f in fields] == \
        [getattr(ref, f) for f in fields]
    assert ours.capacity_factor == 1.25
