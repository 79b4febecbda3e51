"""fp32 attention on the tensor cores: the three-piece split and its
six-product arithmetic, against float64 and against the reference.

The split kernels (``csrc/flash_attention.cu``'s ``flash_fwd_sm90<D, 3>``
and ``csrc/flash_attention_bwd.cu``'s passes at NP = 3) split every fp32
operand into three bf16 pieces and take each product as six bf16 piece
products in fp32.  CUDA does not run here, so their arithmetic is held
through its plain model in ``repro_torch.kernels.flash_attention``:

* ``split_pieces`` rebuilds fp32 values exactly: signed, across the
  exponent range, near the largest float (where ``p0`` rounds toward
  zero) and down to 2^-110, the smallest magnitude whose last bit a bf16
  piece can hold (below it the third piece loses bits, shown too);
* ``piece_einsum``'s six products sit within 4 times fp32's own relative
  L2 distance from float64, and the one-piece (bf16) product does not;
* ``attention_split_model`` against the reference's
  ``repro.kernels.ref.attention_ref`` in fp32 within atol 2e-5, and
  ``attention_bwd_split_model`` against ``jax.vjp`` of it within relative
  L2 1e-5 for each of dq, dk, dv, over causal, windowed, bidirectional
  (Tq != Tk, fully masked rows), GQA, MQA and Tq = 1 cases, at D = 160
  and 256 with S and dP summed from two column halves as the column
  pair's two blocks add them; the one-piece models fail those limits.

The kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  The wrappers' refusals
of what the split variant does not take come before any build, so they
are checked here too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa

FLT_MAX = float(np.finfo(np.float32).max)

#: (B, Tq, Tk, H, G, D, causal, window)
CASES = [
    (2, 33, 33, 4, 2, 16, True, None),       # causal, GQA R = 2
    (1, 50, 50, 4, 2, 32, True, 7),          # a window
    (2, 9, 21, 4, 2, 16, False, None),       # bidirectional, Tq < Tk
    (1, 30, 10, 4, 1, 16, False, 4),         # Tq > Tk: fully masked rows
    (2, 1, 17, 4, 4, 32, False, None),       # Tq = 1 (cross decode)
    (1, 40, 40, 8, 1, 64, True, None),       # MQA
    (1, 24, 24, 4, 2, 128, True, None),      # qwen3-1.7b's head size
    (1, 20, 20, 4, 4, 80, True, None),       # stablelm-3b's
    (1, 18, 18, 4, 2, 160, True, None),      # pixtral-12b's
    (1, 17, 17, 4, 1, 256, True, 5),         # recurrentgemma-9b's, window
    # the column pair's head sizes, bidirectional with a window (Tq > Tk:
    # rows with no key in reach; Tq < Tk)
    (1, 21, 15, 4, 2, 160, False, 5),
    (2, 12, 19, 4, 1, 256, False, 6),
]
FWD_ATOL = 2e-5
BWD_LIMIT = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs(case, seed=0):
    B, Tq, Tk, H, G, D, _, _ = case
    rng = np.random.default_rng(seed + Tq + 7 * Tk + D)
    return (rng.standard_normal((B, Tq, H, D)).astype(np.float32),
            rng.standard_normal((B, Tk, G, D)).astype(np.float32),
            rng.standard_normal((B, Tk, G, D)).astype(np.float32),
            rng.standard_normal((B, Tq, H, D)).astype(np.float32))


def _mantissas(rng, n):
    """n floats in [1, 2) with random 23-bit fractions."""
    bits = rng.integers(0, 1 << 23, n, dtype=np.int64)
    return (1.0 + bits / float(1 << 23)).astype(np.float64)


def _values(kind, rng, n=4096):
    signs = rng.choice([-1.0, 1.0], n)
    if kind == "normal":
        x = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 9, n)
    elif kind == "every_exponent":
        x = _mantissas(rng, n) * 2.0 ** rng.integers(-110, 128, n)
    elif kind == "largest":
        x = _mantissas(rng, n) * 2.0 ** 127
        x[:4] = FLT_MAX
    else:  # "smallest": the least magnitudes whose last bit a piece holds
        x = _mantissas(rng, n) * 2.0 ** rng.integers(-110, -100, n)
        x[:4] = 2.0 ** -110
    return torch.from_numpy((signs * x).astype(np.float32))


@pytest.mark.parametrize("kind", ["normal", "every_exponent", "largest",
                                  "smallest"])
def test_split_pieces_rebuild_fp32_exactly(kind):
    """Three bf16 pieces sum to every value exactly (in float64, where
    their sum is exact): random signs and mantissas, across the exponent
    range, near the largest float (p0 rounds toward zero where rounding
    to nearest overflows) and down to 2^-110."""
    x = _values(kind, np.random.default_rng(len(kind)))
    assert bool(torch.isfinite(x).all())
    p = fa.split_pieces(x)
    assert p.dtype == torch.bfloat16 and p.shape == (3,) + x.shape
    assert bool(torch.isfinite(p.float()).all())
    assert torch.equal(p.double().sum(0), x.double())
    # the pieces shrink: |p1| <= 2^-8 |p0|, |p2| <= 2^-8 |p1| (round to
    # nearest; toward zero p1 takes up to 2^-7)
    a = p.double().abs()
    assert bool((a[1] <= 2.0 ** -7 * a[0]).all())
    assert bool((a[2] <= 2.0 ** -8 * a[1]).all())


def test_split_pieces_lose_bits_below_the_bf16_step():
    """Below 2^-110 the third piece's rounding drops what lies under the
    smallest bf16 step (2^-133): the smallest normal float plus its last
    bit is not rebuilt.  The limit the kernels' note states."""
    x = torch.tensor([2.0 ** -126 * (1 + 2.0 ** -23)], dtype=torch.float32)
    assert float(fa.split_pieces(x).double().sum()) != float(x.double())


@pytest.mark.parametrize("K", [128, 256, 1024])
@pytest.mark.parametrize("a_kind", ["normal", "softmax"])
def test_six_products_keep_fp32_accuracy(K, a_kind):
    """A (64 x K) (K x 128) product as six piece products sits within 4
    times the relative L2 distance of fp32 FMAs from float64; the one bf16
    product does not (it is about 10^4 times farther).  A as random
    normals, or as softmax rows (P V)."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((64, K)).astype(np.float32)
    if a_kind == "softmax":
        e = np.exp(a - a.max(1, keepdims=True))
        a = (e / e.sum(1, keepdims=True)).astype(np.float32)
    b = rng.standard_normal((K, 128)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    fp32 = _rel((ta @ tb).numpy(), want)
    six = _rel(fa.piece_einsum("ik,kj->ij", ta, tb).numpy(), want)
    one = _rel(fa.piece_einsum("ik,kj->ij", ta, tb, pieces=1).numpy(), want)
    assert six <= 4 * fp32, (six, fp32)
    assert one > 4 * fp32, (one, fp32)


def test_split_pairs_are_the_six_that_keep_fp32():
    """The six pairs (i, j) with i + j <= 2, each once, smallest first."""
    assert sorted(fa.SPLIT_PAIRS) == sorted(
        (i, j) for i in range(3) for j in range(3) if i + j <= 2)
    assert [i + j for i, j in fa.SPLIT_PAIRS] == [2, 2, 2, 1, 1, 0]


def _jax_ref(q, k, v, causal, window):
    return jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_split_model_forward_matches_reference(case):
    """The split forward's arithmetic against the reference's fp32 oracle
    within atol 2e-5; the one-piece (bf16 operand) model misses it."""
    _, _, _, _, _, _, causal, window = case
    q, k, v, _ = _inputs(case)
    want = np.asarray(_jax_ref(q, k, v, causal, window))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = fa.attention_split_model(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL, rtol=0)
    one = fa.attention_split_model(tq, tk, tv, causal=causal, window=window,
                                   pieces=1)
    assert float(np.abs(one.numpy() - want).max()) > FWD_ATOL


@pytest.mark.parametrize("case", CASES, ids=str)
def test_split_model_backward_matches_reference_vjp(case):
    """The split backward's arithmetic against ``jax.vjp`` of the
    reference's oracle: each of dq, dk, dv within relative L2 1e-5; the
    one-piece model misses it."""
    _, _, _, _, _, _, causal, window = case
    q, k, v, do = _inputs(case)
    o, vjp = jax.vjp(lambda a, b, c: _jax_ref(a, b, c, causal, window),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    args = [torch.from_numpy(x) for x in (q, k, v, np.array(o), do)]
    got = fa.attention_bwd_split_model(*args, causal=causal, window=window)
    one = fa.attention_bwd_split_model(*args, causal=causal, window=window,
                                       pieces=1)
    for name, g, g1, w in zip(("dq", "dk", "dv"), got, one, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _rel(g.numpy(), w) < BWD_LIMIT, (name, _rel(g.numpy(), w))
    assert max(_rel(g1.numpy(), w) for g1, w in zip(one, want)) > BWD_LIMIT


@pytest.mark.parametrize("dtype,D,kind,match", [
    (torch.bfloat16, 128, "split", "takes float32 at head sizes"),
    (torch.float32, 128, "tc", "takes bf16 at head sizes"),
    (torch.float32, 64, "fast", "unknown")], ids=str)
def test_launch_refuses_what_the_variant_does_not_take(dtype, D, kind,
                                                       match):
    """The forward's ``_launch(kind=...)`` raises where ``variant`` names
    another kernel, and on an unknown variant, before anything is built or
    launched."""
    q, k, v, _ = (torch.from_numpy(a).to(dtype) for a in _inputs(
        (1, 8, 8, 2, 1, D, True, None)))
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        fa._launch(q, k, v, True, None, kind)
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_fp32_routes_to_the_split_kernels(D):
    """fp32 takes the split forward and the split backward at every head
    size (at D = 160 and 256 the backward's column pair); the scalar
    kernels only by name."""
    assert fa.variant(torch.float32, D) == "split"
    assert fa.bwd_variant(torch.float32, D) == "split"
    assert fa.BWD_SPLIT_HEAD_DIMS == fa.HEAD_DIMS
    assert (D in fa.BWD_PAIR_HEAD_DIMS) == (D > 128)


_PTXAS_HEAD = ("ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__"
               "1c2d3e4f_18_flash_attention_cu_5a6b7c8d{}' for 'sm_90a'\n"
               "ptxas info    : Function properties for _ZN55_GLOBAL__N__"
               "1c2d3e4f_18_flash_attention_cu_5a6b7c8d{}\n")
_PTXAS_SPILL = ("    {} bytes stack frame, {} bytes spill stores, {} bytes "
                "spill loads\nptxas info    : Used 168 registers\n")


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("functions,spills,refused", [
    # the scalar forward may spill; the tensor-core kernel's bf16 and fp32
    # instantiations may not
    ([("16flash_fwd_kernelIfLi256EEEvPKT_S3_S3_PS1_iiiiiif", (8, 4, 4)),
      ("14flash_fwd_sm90ILi128ELi1EEEvN2tc4MapsEP13__nv_bfloat16iiiiiiif",
       (0, 0, 0))], {"flash_fwd_kernel<fp32, 256>": (4, 4)}, False),
    ([("14flash_fwd_sm90ILi256ELi3EEEvN2tc4MapsEPfiiiiiiif", (16, 8, 8))],
     {"flash_fwd_sm90<256, 3>": (8, 8)}, True),
], ids=["scalar", "split"])
def test_forward_spill_check_reads_ptxas(functions, spills, refused):
    """``chip_smoke.fwd_spills`` reads the forward source's spill lines by
    function: the scalar kernel may spill, the tensor-core kernel (bf16,
    or fp32 on three pieces) may not."""
    cs = _chip_smoke()
    text = "".join(_PTXAS_HEAD.format(fn, fn) + _PTXAS_SPILL.format(*n)
                   for fn, n in functions)
    assert cs.ptxas_spills(text) == spills
    if refused:
        with pytest.raises(cs.CheckFailed, match="spill to local memory"):
            cs.fwd_spills(text)
    else:
        assert cs.fwd_spills(text) == spills
