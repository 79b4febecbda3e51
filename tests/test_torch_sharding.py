"""The port's sharding rules, context and meshes against the reference's
(``repro.sharding``, ``repro.launch.mesh``).

* Every case of ``tests/test_sharding.py``, run on both packages (a fake
  mesh whose ``shape`` is a dict, as there).
* ``spec_for`` over every architecture's parameters, the port's per-layer
  leaves against the reference's cycle-stacked ones (whose leading
  ``layers`` axis is never split), on 16x16, 2x16x16 and every
  ``mesh_options(256)`` split, with each kind's ``arch_overrides`` and
  without them; ``bytes_per_device`` at float32 equal to the reference's.
* The local slices: four gloo CPU ranks on a 2 x 2 mesh (and a 2 x 2 x 1
  one for a tuple entry) hold the slices JAX puts on the same device
  index of a mesh over 4 XLA CPU devices (a subprocess with
  ``XLA_FLAGS``), for one tensor of each spec kind.
* ``ctx.constrain``: a no-op without a context, a redistribution (of the
  value and of its gradient) with one, and a refusal of a plain tensor
  on more than one device.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as RC
from repro.launch import mesh as RM
from repro.models import build_model as ref_build_model
from repro.models.types import ParamSpec as RefParamSpec
from repro.sharding import rules as R
from repro_torch import configs as TC
from repro_torch.launch import mesh as TM
from repro_torch.models import encdec as t_encdec
from repro_torch.models import lm as t_lm
from repro_torch.models.types import ParamSpec as TorchParamSpec
from repro_torch.sharding import ctx as T_ctx
from repro_torch.sharding import rules as T

ROOT = Path(__file__).resolve().parent.parent


class FakeMesh:
    """Only `.shape` (a dict) is consulted by spec_for."""
    def __init__(self, **shape):
        self.shape = shape


MESH = FakeMesh(data=16, model=16)
MESH_MP = FakeMesh(pod=2, data=16, model=16)


def _ref_specs(cfg):
    return ref_build_model(cfg).param_specs()


def _ref_leaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, RefParamSpec))


def _port_specs(cfg):
    return (t_encdec if cfg.is_encdec else t_lm).param_specs(cfg)


def _port_leaves(tree):
    out = []
    t_lm.map_specs(out.append, tree)
    return out


# one entry a package: (rules module, PartitionSpec, configs, spec tree of a
# config, its leaves, ParamSpec)
PACKAGES = {
    "reference": (R, JP, RC, _ref_specs, _ref_leaves, RefParamSpec),
    "port": (T, T.PartitionSpec, TC, _port_specs, _port_leaves,
             TorchParamSpec),
}
pkg = pytest.mark.parametrize("pkg", list(PACKAGES))


@pkg
def test_basic_tp_fsdp_resolution(pkg):
    Rm, P = PACKAGES[pkg][:2]
    rules = Rm.production_rules()
    spec = Rm.spec_for((4096, 32, 128), ("embed", "heads", "head_dim"),
                       rules, MESH)
    assert spec == P("data", "model")
    assert Rm.spec_for((4096, 11008), ("embed", "mlp"), rules, MESH) == \
        P("data", "model")
    assert Rm.spec_for((128, 4096, 768), ("experts", "embed", "mlp"),
                       rules, MESH) == P("model", "data")


@pkg
def test_divisibility_fallback_replicates(pkg):
    Rm, P = PACKAGES[pkg][:2]
    rules = Rm.production_rules()
    assert Rm.spec_for((5120, 40, 128), ("embed", "heads", "head_dim"),
                       rules, MESH) == P("data", None, "model")
    assert Rm.spec_for((5120, 8, 128), ("embed", "kv_heads", "head_dim"),
                       rules, MESH) == P("data", None, "model")


@pkg
def test_mesh_axis_used_once(pkg):
    Rm, P = PACKAGES[pkg][:2]
    assert Rm.spec_for((4096, 32, 128), (None, "heads", "head_dim"),
                       Rm.production_rules(), MESH) == P(None, "model")


@pkg
def test_multi_pod_batch_spans_pod_and_data(pkg):
    Rm, P = PACKAGES[pkg][:2]
    rules = Rm.production_rules(multi_pod=True)
    assert Rm.spec_for((256, 4096), ("batch", "seq"), rules, MESH_MP) == \
        P(("pod", "data"))
    assert Rm.spec_for((1, 4096), ("batch", "seq"), rules, MESH_MP) == P()


@pkg
def test_arch_overrides_consistency(pkg):
    Rm, _, C = PACKAGES[pkg][:3]
    assert Rm.arch_overrides(C.get("deepseek-7b"), 16) == {"head_dim": None}
    cfg = C.get("qwen3-1.7b")
    assert Rm.arch_overrides(cfg, 16, "train") == {"head_dim": None}
    assert Rm.arch_overrides(cfg, 16, "decode") == \
        {"heads": None, "kv_heads": None}
    cfg = C.get("llama4-maverick-400b-a17b")
    assert Rm.arch_overrides(cfg, 16, "train") == \
        {"heads": None, "kv_heads": None, "head_dim": None}
    assert Rm.arch_overrides(cfg, 8, "train") == {"head_dim": None}


@pkg
def test_every_arch_has_some_model_sharding(pkg):
    Rm, _, C, specs_of, leaves_of, _ = PACKAGES[pkg]
    rules = Rm.production_rules()
    for name in C.ARCH_NAMES:
        cfg = C.get(name)
        rules_a = rules.with_overrides(**Rm.arch_overrides(cfg, 16))
        leaves = leaves_of(specs_of(cfg))
        sharded = sum(
            1 for s in leaves
            if any(e is not None
                   for e in Rm.spec_for(s.shape, s.axes, rules_a, MESH)))
        assert sharded / len(leaves) > 0.3, name


@pkg
def test_bytes_per_device_accounting(pkg):
    Rm, ParamSpec = PACKAGES[pkg][0], PACKAGES[pkg][5]
    tree = {"w": ParamSpec((1024, 1024), ("embed", "mlp"))}   # f32
    per_dev = Rm.bytes_per_device(tree, Rm.production_rules(), MESH)
    assert per_dev == 1024 * 1024 * 4 // 256


# --- spec_for over every config's parameters -----------------------------------

def _named_port_specs(cfg):
    """{the port's parameter name (``LM.named_parameters``): ParamSpec}."""
    stacks = {"layers": "blocks", "enc_layers": "enc_blocks",
              "dec_layers": "dec_blocks"}
    out = {}

    def walk(tree, prefix):
        if isinstance(tree, TorchParamSpec):
            out[prefix] = tree
        else:
            for k, v in tree.items():
                walk(v, f"{prefix}.{k}")
    for key, sub in _port_specs(cfg).items():
        if key in stacks:
            for i, layer in enumerate(sub):
                walk(layer, f"{stacks[key]}.{i}.groups")
        else:
            walk(sub, key)
    return out


def _groups(cfg):
    return (t_encdec if cfg.is_encdec else t_lm).model_groups(cfg)


MESHES = [("16x16", False, FakeMesh(data=16, model=16)),
          ("2x16x16", True, FakeMesh(pod=2, data=16, model=16))] + [
    (name, False, FakeMesh(data=d, model=m))
    for (d, m), name in RM.mesh_options(256)]


def _padded(spec, n):
    return list(spec) + [None] * (n - len(spec))


@pytest.mark.parametrize("arch", RC.ARCH_NAMES)
def test_spec_for_matches_reference_on_every_parameter(arch):
    rcfg, tcfg = RC.get(arch), TC.get(arch)
    ref_tree, port = _ref_specs(rcfg), _named_port_specs(tcfg)
    groups = _groups(tcfg)
    assert sorted(n for _, members in groups for n in members) == \
        sorted(port)
    checked = 0
    for mesh_name, multi, mesh in MESHES:
        tp = mesh.shape["model"]
        for kind in (None, "train", "prefill", "decode"):
            r_rules = R.production_rules(multi_pod=multi)
            t_rules = T.production_rules(multi_pod=multi)
            assert dict(r_rules.table) == dict(t_rules.table)
            if kind:
                over = R.arch_overrides(rcfg, tp, kind)
                assert T.arch_overrides(tcfg, tp, kind) == over
                r_rules = r_rules.with_overrides(**over)
                t_rules = t_rules.with_overrides(**over)
            for path, members in groups:
                leaf = ref_tree
                for key in path:
                    leaf = leaf[key]
                ref = R.spec_for(leaf.shape, leaf.axes, r_rules, mesh)
                stacked = leaf.axes[:1] == ("layers",)
                want = _padded(ref, len(leaf.shape))[1 if stacked else 0:]
                for name in members:
                    s = port[name]
                    assert s.shape == leaf.shape[1 if stacked else 0:]
                    got = T.spec_for(s.shape, s.axes, t_rules, mesh)
                    assert _padded(got, len(s.shape)) == want, \
                        (mesh_name, kind, name)
                    checked += 1
            assert T.bytes_per_device(_port_specs(tcfg), t_rules, mesh,
                                      torch.float32) == \
                R.bytes_per_device(ref_tree, r_rules, mesh)
    assert checked


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b"])
def test_bytes_per_device_at_the_models_dtype(arch):
    """At the model's dtype each leaf counts at its storage dtype: bf16
    weights, float32 norm scales (and RWKV's decay base and bonus)."""
    cfg = TC.get(arch)
    specs = _port_specs(cfg)
    rules = T.production_rules().with_overrides(
        **T.arch_overrides(cfg, 16))
    want = 0
    for s in _port_leaves(specs):
        p = T.spec_for(s.shape, s.axes, rules, MESH)
        want += np.prod(T.local_shape(s.shape, p, MESH)) \
            * s.storage_dtype(torch.bfloat16).itemsize
    got = T.bytes_per_device(specs, rules, MESH, cfg.compute_dtype)
    assert got == want
    assert got < T.bytes_per_device(specs, rules, MESH, torch.float32)


def test_placements_and_local_shape():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh(pod=2, data=4, model=8)
    P = T.PartitionSpec
    assert T.placements_for(P("data", None, "model"), mesh) == \
        (Replicate(), Shard(0), Shard(2))
    assert T.placements_for(P(("pod", "data")), mesh) == \
        (Shard(0), Shard(0), Replicate())
    assert T.placements_for(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        T.placements_for(P(("data", "pod")), mesh)
    assert T.local_shape((16, 3, 64), P(("pod", "data"), None, "model"),
                         mesh) == (2, 3, 8)
    sh = T.sharding_for_spec(TorchParamSpec((64, 16), ("embed", "mlp")),
                             T.production_rules(), mesh)
    assert sh.spec == P("data", "model")
    assert sh.placements == (Replicate(), Shard(0), Shard(1))
    assert "embed" not in T.describe(
        {"w": TorchParamSpec((64, 16), ("embed", "mlp"))},
        T.production_rules(), mesh)


def test_mesh_options_match_reference():
    for chips in (1, 4, 16, 256, 512):
        assert TM.mesh_options(chips) == RM.mesh_options(chips)


def test_make_mesh_needs_the_devices():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="need 256 devices, have 0"):
        TM.make_production_mesh()
    with TM.fake_world(4):
        with pytest.raises(RuntimeError, match="need 256 devices, have 4"):
            TM.make_production_mesh(device_type="cpu")
        mesh = TM.make_mesh((2, 2), ("data", "model"), device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert T.mesh_sizes(mesh) == {"data": 2, "model": 2}
        with pytest.raises(RuntimeError, match="already open"):
            with TM.fake_world(4):
                pass
    assert not dist.is_initialized()


# --- ctx.constrain ------------------------------------------------------------

def test_constrain_is_a_noop_without_context():
    x = torch.ones(4, 6)
    assert T_ctx.current() is None
    assert T_ctx.constrain(x, ("batch", "mlp")) is x
    assert T_ctx.constrain_merged(x, ("batch", "heads", "head_dim"),
                                  (2, 3)) is x


def test_constrain_redistributes_value_and_gradient():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    rules = T.production_rules()
    with TM.fake_world(4):
        mesh = TM.make_mesh((2, 2), ("data", "model"), device_type="cpu")
        x = distribute_tensor(torch.ones(8, 6), mesh,
                              [Replicate(), Replicate()])
        x.requires_grad_(True)
        with T_ctx.use(rules, mesh):
            y = T_ctx.constrain(x, ("batch", "mlp"))
            assert y.placements == (Shard(0), Shard(1))
            assert tuple(y.to_local().shape) == (4, 3)
            y.sum().backward()
            assert x.grad.placements == (Shard(0), Shard(1))
            # (8, 6) as (8, 2 heads, 3): heads split, so is the merge
            z = T_ctx.constrain_merged(x.detach(), ("batch", "heads",
                                                    "head_dim"), (2, 3))
            assert z.placements == (Shard(0), Shard(1))
            # (8, 6) as (8, 3 heads, 2): only head_dim splits: kept whole
            z = T_ctx.constrain_merged(x.detach(), ("batch", "heads",
                                                    "head_dim"), (3, 2))
            assert z.placements == (Shard(0), Replicate())
            with pytest.raises(TypeError, match="plain tensor"):
                T_ctx.constrain(torch.ones(8, 6), ("batch", None))
        with T_ctx.use(rules, TM.make_mesh((1, 1), ("data", "model"),
                                           device_type="cpu")):
            plain = torch.ones(8, 6)
            assert T_ctx.constrain(plain, ("batch", None)) is plain
    assert T_ctx.current() is None


# --- local slices: gloo ranks against JAX's shards -----------------------------

#: (mesh shape, axes, tensor shape, spec entries)
SLICE_CASES = [
    ((2, 2), ("data", "model"), (8, 6), ("data", "model")),
    ((2, 2), ("data", "model"), (8, 6), ("model", "data")),
    ((2, 2), ("data", "model"), (4, 6, 8), (None, "model")),
    ((2, 2), ("data", "model"), (4, 6, 8), ("data", None, "model")),
    ((2, 2), ("data", "model"), (8, 6), ("data",)),
    ((2, 2), ("data", "model"), (8, 6), ()),
    ((2, 2, 1), ("pod", "data", "model"), (8, 6), (("pod", "data"),)),
    ((2, 2, 1), ("pod", "data", "model"), (4, 8, 6),
     (None, ("pod", "data"), "model")),
]

JAX_CHILD = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.launch.mesh import make_mesh
    cases = json.loads(sys.argv[1])
    out = []
    for mesh_shape, axes, shape, spec in cases:
        mesh = make_mesh(tuple(mesh_shape), tuple(axes))
        spec = [tuple(e) if isinstance(e, list) else e for e in spec]
        x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        arr = jax.device_put(x, NamedSharding(mesh, P(*spec)))
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        out.append([by_dev[d].tolist() for d in mesh.devices.flat])
    print(json.dumps(out))
""")

TORCH_CHILD = textwrap.dedent("""
    import json, os, sys
    import torch, torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.rules import PartitionSpec, placements_for
    cases = json.loads(sys.argv[1])
    dist.init_process_group("gloo")
    out = []
    for mesh_shape, axes, shape, spec in cases:
        mesh = make_mesh(tuple(mesh_shape), tuple(axes), device_type="cpu")
        spec = [tuple(e) if isinstance(e, list) else e for e in spec]
        x = torch.arange(int(torch.tensor(shape).prod()),
                         dtype=torch.float32).reshape(shape)
        d = distribute_tensor(x, mesh, placements_for(PartitionSpec(*spec),
                                                      mesh))
        out.append(d.to_local().tolist())
    with open(sys.argv[2] % dist.get_rank(), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_local_slices_match_jax_shards(tmp_path):
    cases = json.dumps([[list(m), list(a), list(s), list(e)]
                        for m, a, s, e in SLICE_CASES])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_out = subprocess.run([sys.executable, "-c", JAX_CHILD, cases],
                             env=env, capture_output=True, text=True,
                             timeout=300)
    assert jax_out.returncode == 0, jax_out.stderr[-3000:]
    want = json.loads(jax_out.stdout.strip().splitlines()[-1])

    port = _free_port()
    procs = []
    for rank in range(4):
        renv = dict(env, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                    RANK=str(rank), WORLD_SIZE="4")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", TORCH_CHILD, cases,
             str(tmp_path / "rank%d.json")], env=renv,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    got = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(4)]
    for i, case in enumerate(SLICE_CASES):
        for rank in range(4):
            assert np.array_equal(np.asarray(got[rank][i]),
                                  np.asarray(want[i][rank])), (case, rank)
