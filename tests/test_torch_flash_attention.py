"""The port's flash-attention plain version against the reference.

The same seeded numpy inputs go to ``repro.kernels.ref.attention_ref`` and
the reference model's chunked ``repro.models.layers.sdpa`` on one side,
and to the port's ``attention_ref`` and its CPU dispatch
(``repro_torch.kernels.ops.flash_attention``) on the other.  The reference
Pallas kernel does not trace on this jax, so it is not a party here; its
oracle is.  Tolerances are the reference kernel tests' own: fp32 atol
2e-5, bf16 atol 2e-2, rtol 1e-2; for ``sdpa`` atol 3e-5, rtol 1e-3.  The
CUDA kernel itself is held to the same plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models.layers import sdpa as jax_sdpa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import layers as tl

#: the reference kernel tests' cases (B, T, H, G, D, causal, window), then
#: ragged lengths the TPU kernel's divisibility assert refused
ATTN_CASES = [
    (2, 128, 4, 4, 32, True, None),
    (1, 256, 4, 2, 64, True, None),      # GQA
    (2, 128, 8, 1, 32, True, None),      # MQA
    (1, 128, 2, 2, 32, False, None),     # bidirectional
    (1, 256, 4, 4, 32, True, 64),        # local window
    (1, 64, 2, 2, 128, True, None),      # full head dim
    (2, 12, 4, 2, 16, True, None),       # the engine's 12-token prompts
    (1, 100, 4, 2, 64, True, None),      # ragged GQA
    (1, 100, 4, 4, 32, True, 16),        # ragged window
    (1, 77, 2, 1, 80, False, None),      # ragged bidirectional MQA
    (1, 64, 2, 2, 256, True, None),      # recurrentgemma's head size
    (1, 100, 4, 1, 256, True, 32),       # ragged MQA, T past the window
]

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _qkv(seed, B, T, H, G, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D)).astype(np.float32),
            rng.standard_normal((B, T, G, D)).astype(np.float32),
            rng.standard_normal((B, T, G, D)).astype(np.float32))


def _both(arrays, dtype):
    jx = [jnp.asarray(a).astype(JAX_DTYPES[dtype]) for a in arrays]
    th = [torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays]
    return jx, th


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_oracle(case, dtype):
    B, T, H, G, D, causal, window = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(sum(case[:5]), B, T, H, G, D),
                                       dtype)
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    got = fa.attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (B, T, H, D)
    atol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=1e-2)


def _chunk(T: int) -> int:
    """The largest chunk of at most 32 that divides T: the reference's
    ``sdpa`` reads a ragged last KV chunk from a clamped offset."""
    return max(c for c in range(1, min(T, 32) + 1) if T % c == 0)


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_dispatch_matches_reference_model_sdpa(case):
    """The port's ``sdpa`` (the kernel's CPU dispatch) against the
    reference model's chunked online softmax, in fp32, with chunks that
    split the sequence."""
    B, T, H, G, D, causal, window = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(7 + T, B, T, H, G, D),
                                       "float32")
    want = jax_sdpa(jq, jk, jv, causal=causal, window=window,
                    q_chunk=_chunk(T), kv_chunk=_chunk(T))
    before = dict(fa.LAUNCHES)
    got = tl.sdpa(tq, tk, tv, causal=causal, window=window)
    assert fa.LAUNCHES == before          # the CPU never counts a launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=1e-3)


def test_gqa_equals_repeated_kv_heads():
    """Repeating the KV heads R times and running MHA equals GQA (the
    reference's grouping property)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 64, 4, 2, 32))
    out = ops.flash_attention(q, k, v, causal=True)
    rep = ops.flash_attention(q, k.repeat_interleave(2, dim=2),
                              v.repeat_interleave(2, dim=2), causal=True)
    np.testing.assert_allclose(out.numpy(), rep.numpy(), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("bad", ["dtype", "heads", "window", "rank", "d"])
def test_wrapper_rejects_what_no_version_takes(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 4, 2, 16))
    kw = dict(causal=True)
    if bad == "dtype":
        k = k.double()
    elif bad == "heads":
        k, v = k[:, :, :1].repeat(1, 1, 3, 1), v[:, :, :1].repeat(1, 1, 3, 1)
    elif bad == "window":
        kw["window"] = 0
    elif bad == "rank":
        q = q[0]
    else:
        k, v = k[..., :8], v[..., :8]
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention(q, k, v, **kw)


def test_kernel_head_sizes_cover_the_repository():
    """The kernel is built for every head size the ported configs and the
    reference kernel tests use."""
    from repro_torch import configs
    dims = {configs.get(n).head_dim for n in configs.PORTED
            if "attn" in configs.get(n).block_pattern}
    dims |= {configs.reduced(configs.get(n)).head_dim
             for n in configs.PORTED}
    dims |= {case[4] for case in ATTN_CASES}
    assert dims <= set(fa.HEAD_DIMS)


def test_variant_is_chosen_by_dtype_and_head_size_alone():
    """bf16 at every head size (80 included) goes to the tensor-core
    kernel, fp32 at every head size to the split one (three bf16 pieces
    an operand on the tensor cores); the scalar kernel only by name.  The
    qwen3-1.7b (D = 128) and stablelm-3b (D = 80) prefills are
    tensor-core calls."""
    from repro_torch import configs
    for D in fa.HEAD_DIMS:
        assert fa.variant(torch.float32, D) == "split"
        assert fa.variant(torch.bfloat16, D) == "tc"
    assert set(fa.TC_HEAD_DIMS) == set(fa.HEAD_DIMS)
    for name in ("qwen3-1.7b", "stablelm-3b"):
        cfg = configs.get(name)
        assert fa.variant(cfg.compute_dtype, cfg.head_dim) == "tc", name
    assert set(fa.LAUNCHES) == {"flash_attention", "flash_attention_tc",
                                "flash_attention_split",
                                "flash_attention_scalar",
                                "flash_attention_bwd",
                                "flash_attention_bwd_tc",
                                "flash_attention_bwd_split",
                                "flash_attention_bwd_scalar"}
