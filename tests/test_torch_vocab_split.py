"""The head over a vocabulary split as a mesh's model axis splits it, on one
device: ``lm.sliced_xent`` (each slice's local pass,
``xent_slice_stats``, then ``xent_combine``, the arithmetic the ranks of
``fused_xent``'s split path run) against the one-process ``fused_xent``,
the plain head and the reference's ``fused_xent``.

Reduced qwen3-1.7b (tied: the table (V, d) cut by rows) and rwkv6-3b
(untied: the head (d, V) cut by columns), V = 512 in 2 and 4 slices,
chunks of 100 (each slice's last chunk ragged), float32, labels on every
slice's and chunk's edges: per-token (lse, ll) and the gradients of the
hidden states and the head's weight under the training loss within
relative L2 1e-5.  Also: a head that is not split (a DTensor on a 1 x 1
mesh) takes the whole head's path, bit for bit the plain tensors'
``fused_xent``; and ``chip_smoke.phase_head`` rehearsed at a reduced size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import lm as ref_lm
from repro_torch import configs as TC
from repro_torch.models import layers as L
from repro_torch.models import lm

ARCHS = ("qwen3-1.7b", "rwkv6-3b")
PARTS = (2, 4)
B, T, CHUNK = 2, 24, 100
LIMIT = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs(arch, seed=0):
    """The reduced config, the head's weights, hidden states and labels
    (each slice's first and last id, its first chunk's edge, the rest
    random), as numpy."""
    cfg = TC.reduced(TC.get(arch))
    V, d = cfg.vocab_size, cfg.d_model
    rng = np.random.default_rng(seed)
    embed = {"embedding": (rng.standard_normal((V, d)) * 0.5)
             .astype(np.float32)}
    if not cfg.tie_embeddings:
        embed["head"] = (rng.standard_normal((d, V)) * 0.5).astype(np.float32)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    labels = rng.integers(0, V, (B, T))
    edges = sorted({e for m in PARTS for k in range(m)
                    for e in (k * V // m, k * V // m + CHUNK - 1,
                              k * V // m + CHUNK, (k + 1) * V // m - 1)
                    if e < (k + 1) * V // m})
    labels[0, :len(edges)] = edges
    return cfg, embed, x, labels


def _port(cfg, embed, x, labels, head):
    """(lse, ll, dx, dw) of ``head`` under the training loss."""
    e = {k: torch.from_numpy(v).requires_grad_(True) for k, v in embed.items()}
    w = e["embedding" if cfg.tie_embeddings else "head"]
    xt = torch.from_numpy(x).requires_grad_(True)
    lt = torch.from_numpy(labels)
    lse, ll = head(e, xt, lt)
    loss, _ = lm.xent_loss(lse, ll, lt, 0.0, 0.0)
    dx, dw = torch.autograd.grad(loss, [xt, w])
    return [t.detach().numpy() for t in (lse, ll, dx, dw)]


def _reference(arch, embed, x, labels):
    """The reference's ``fused_xent`` under its loss's cross-entropy and
    z-loss (every label unmasked), through ``jax.grad``."""
    rcfg = RC.reduced(RC.get(arch))
    key = "embedding" if rcfg.tie_embeddings else "head"
    e = {k: jnp.asarray(v) for k, v in embed.items()}
    lab = jnp.asarray(labels, jnp.int32)

    def loss(x, w):
        lse, ll = ref_lm.fused_xent({**e, key: w}, rcfg, x, lab, CHUNK)
        return jnp.mean(lse - ll) + lm.Z_LOSS_WEIGHT * jnp.mean(lse ** 2), \
            (lse, ll)
    (_, (lse, ll)), (dx, dw) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), e[key])
    return [np.asarray(t) for t in (lse, ll, dx, dw)]


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sliced_head_matches_fused_plain_and_reference(arch, parts):
    cfg, embed, x, labels = _inputs(arch)
    got = _port(cfg, embed, x, labels, lambda e, xt, lt: lm.sliced_xent(
        e, cfg, xt, lt, CHUNK, parts))
    fused = _port(cfg, embed, x, labels, lambda e, xt, lt: lm.fused_xent(
        e, cfg, xt, lt, CHUNK))
    plain = _port(cfg, embed, x, labels, lambda e, xt, lt: lm.plain_xent(
        L.head_apply(e, cfg, xt), lt))
    ref = _reference(arch, embed, x, labels)
    for want in (fused, plain, ref):
        for name, a, b in zip(("lse", "ll", "dx", "dw"), got, want):
            assert a.shape == b.shape, name
            assert _rel(a, b) <= LIMIT, (name, _rel(a, b))


def test_slice_stats_combine_into_the_whole_heads():
    """Each slice's local pass alone: its max, rescaled sum and pick over
    its own ids; the combine of the slices' stacked stats gives the
    whole vocabulary's logsumexp and label logit, and a label outside a
    slice picks 0 there."""
    cfg, embed, x, labels = _inputs("qwen3-1.7b", seed=1)
    w = torch.from_numpy(embed["embedding"])
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels)
    V = cfg.vocab_size
    stats = [lm.xent_slice_stats(xt, s, lt, i * V // 4, CHUNK, True)
             for i, s in enumerate(w.split(V // 4))]
    logits = (xt @ w.t()).double()
    for i, (m, s, ll) in enumerate(stats):
        own = logits[..., i * V // 4:(i + 1) * V // 4]
        np.testing.assert_allclose(m, own.amax(-1), rtol=1e-6)
        np.testing.assert_allclose(
            s, torch.exp(own - own.amax(-1, keepdim=True)).sum(-1),
            rtol=1e-5)
        inside = (lt >= i * V // 4) & (lt < (i + 1) * V // 4)
        assert torch.all(ll[~inside] == 0)
    lse, ll = lm.xent_combine(*(torch.stack(t) for t in zip(*stats)))
    np.testing.assert_allclose(lse, torch.logsumexp(logits, -1), rtol=1e-6)
    np.testing.assert_allclose(ll, logits.gather(-1, lt[..., None])[..., 0],
                               rtol=1e-6)


def test_a_whole_head_on_a_1x1_mesh_is_the_plain_tensors_path():
    """A DTensor head that no mesh dimension splits over the vocabulary
    takes the whole head's path: bit for bit the plain tensors'."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding import ctx
    cfg, embed, x, labels = _inputs("qwen3-1.7b", seed=2)
    want = _port(cfg, embed, x, labels, lambda e, xt, lt: lm.fused_xent(
        e, cfg, xt, lt, CHUNK))
    with mesh_lib.fake_world(1):
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"),
                                  device_type="cpu")

        def placed(t):
            return DTensor.from_local(t, mesh, [Replicate(), Replicate()],
                                      run_check=False)

        def head(e, xt, lt):
            lse, ll = lm.fused_xent({k: placed(v) for k, v in e.items()},
                                    cfg, placed(xt), placed(lt), CHUNK)
            return lse.to_local(), ll.to_local()
        with ctx.spmd():     # as the sharded train step runs it
            got = _port(cfg, embed, x, labels, head)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tied", [True, False])
def test_chip_head_phase_rehearses_on_the_cpu(tied):
    """``chip_smoke.phase_head`` at a reduced size on the CPU: every cut
    head within its dtype's limit of the fused and plain heads (the
    phase's own checks), in float32 and bf16."""
    import chip_smoke as cs
    cfg = dataclasses.replace(TC.reduced(TC.get("qwen3-1.7b")),
                              tie_embeddings=tied)
    peaks = cs.phase_head(torch, 0, "cpu", dev="cpu", cfg=cfg, B=2, T=48,
                          chunk=100)
    assert set(peaks) == {"float32", "bfloat16"}
    assert set(peaks["float32"]) == {"plain", "fused", "split2", "split4"}

