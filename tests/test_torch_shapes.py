"""The port's cell shapes (``repro_torch.configs.shapes``) against the
reference's ``repro.configs.shapes``: the four assigned shapes, which
cells each architecture runs and why it skips the others, and the batch
and decode stand-ins (meta tensors for ShapeDtypeStructs), shape and
dtype, for every architecture x shape; ``make_batch`` draws what the specs
say from a ``torch.Generator``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.configs import shapes as RS
from repro_torch import configs as TC
from repro_torch.configs import shapes as TS

DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}


def _same(ref_specs, port_specs):
    assert list(ref_specs) == list(port_specs)
    for name, r in ref_specs.items():
        t = port_specs[name]
        assert t.device.type == "meta", name
        assert tuple(t.shape) == tuple(r.shape), name
        assert t.dtype == DTYPES[jnp.dtype(r.dtype)], name


def test_shapes_match_reference():
    assert list(TS.SHAPES) == list(RS.SHAPES)
    for name, r in RS.SHAPES.items():
        t = TS.SHAPES[name]
        assert (t.name, t.seq_len, t.global_batch, t.kind,
                t.tokens_per_step) == (r.name, r.seq_len, r.global_batch,
                                       r.kind, r.tokens_per_step)
    assert TS.SUBQUADRATIC_FAMILIES == RS.SUBQUADRATIC_FAMILIES


@pytest.mark.parametrize("arch", RC.ARCH_NAMES)
def test_cells_and_skips_match_reference(arch):
    rcfg, tcfg = RC.get(arch), TC.get(arch)
    assert [s.name for s in TS.cells(tcfg)] == \
        [s.name for s in RS.cells(rcfg)]
    for name in RS.SHAPES:
        assert TS.applicable(tcfg, TS.SHAPES[name]) == \
            RS.applicable(rcfg, RS.SHAPES[name])
        assert TS.skip_reason(tcfg, TS.SHAPES[name]) == \
            RS.skip_reason(rcfg, RS.SHAPES[name])


@pytest.mark.parametrize("arch", RC.ARCH_NAMES)
@pytest.mark.parametrize("shape", list(RS.SHAPES))
def test_batch_and_decode_specs_match_reference(arch, shape):
    rcfg, tcfg = RC.get(arch), TC.get(arch)
    rs, ts = RS.SHAPES[shape], TS.SHAPES[shape]
    for labels in (True, False):
        _same(RS.batch_specs(rcfg, rs, with_labels=labels),
              TS.batch_specs(tcfg, ts, with_labels=labels))
    _same(RS.decode_specs(rcfg, rs), TS.decode_specs(tcfg, ts))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "seamless-m4t-large-v2",
                                  "pixtral-12b"])
def test_make_batch_draws_the_specs(arch):
    """Every leaf of ``batch_specs``, in its shape and dtype, on the
    generator's device; tokens in the vocabulary; the same seed gives the
    same batch."""
    cfg = TC.reduced(TC.get(arch))
    shape = TS.SHAPES["train_4k"].__class__("s", 64, 2, "train")
    specs = TS.batch_specs(cfg, shape, with_labels=True)
    draw = lambda: TS.make_batch(cfg, shape,
                                 torch.Generator().manual_seed(3))
    a, b = draw(), draw()
    assert list(a) == list(specs)
    for name, s in specs.items():
        assert a[name].shape == s.shape and a[name].dtype == s.dtype
        assert a[name].device.type == "cpu"
        assert torch.equal(a[name], b[name])
        if s.dtype == torch.int32:
            v = a[name].numpy()
            assert v.min() >= 0 and v.max() < cfg.vocab_size
        else:
            assert 0 < float(a[name].float().std()) < 0.1
    assert not np.array_equal(
        TS.make_batch(cfg, shape, torch.Generator().manual_seed(4),
                      with_labels=False)["tokens"].numpy(),
        a["tokens"].numpy())
