"""The port's sharding rules, meshes and abstract trees
(`repro_torch.sharding.rules`, `repro_torch.launch.mesh`,
`repro_torch.models.spec`, `Model.abstract_*`, `abstract_quantized_params`,
`abstract_train_state`) against the JAX package's, on the CPU.

The port's meshes live in one process on torch's ``fake`` process-group
backend, which gives this process any rank of any world size and moves no
data; each test starts its own group and destroys it. The reference's
meshes repeat the one CPU device, as tests/test_sharding_and_roofline.py
builds them. Every leaf of every registered config, at full size, on both
production meshes and under all three tables, must get the reference's
``PartitionSpec`` (as a tuple), the placements that spec means, and the
shard shape ``NamedSharding.shard_shape`` gives. Nothing is allocated: the
port's abstract leaves are ``meta`` tensors and `DTensor`s over ``meta``
shards.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.models import make_model as jax_make_model
from repro.models import quant as JQ
from repro.sharding import rules as JR
from repro.train import abstract_train_state as jax_abstract_train_state
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.launch.mesh import (
    make_debug_mesh,
    make_mesh_compat,
    make_production_mesh,
    mesh_host_shard,
)
from repro_torch.models import make_model
from repro_torch.models.quant import abstract_quantized_params
from repro_torch.models.spec import abstract_like, abstract_tensor
from repro_torch.sharding.rules import (
    DECODE_RULES,
    DECODE_TP_RULES,
    TRAIN_RULES,
    NamedSharding,
    ShardingRules,
    constrain,
    placements_of,
    use_rules,
)
from repro_torch.train import abstract_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(jax_all_configs())
TABLES = {"train": "TRAIN_RULES", "decode": "DECODE_RULES", "decode_tp": "DECODE_TP_RULES"}
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


def fake_group(world: int, rank: int = 0) -> None:
    """This process as `rank` of a ``fake`` group of `world` ranks (the
    group started before is destroyed)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)


@pytest.fixture
def port_mesh():
    """`make(shape, names, rank=0)`: a CPU `DeviceMesh` of `shape` as seen
    from `rank`, in a ``fake`` group of that many ranks; the last group
    started is destroyed at teardown."""

    def make(shape, names, rank: int = 0):
        fake_group(math.prod(shape), rank)
        return make_mesh_compat(shape, names, device_type="cpu")

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def jax_mesh(shape, names):
    devs = np.array(jax.devices()[:1] * int(np.prod(shape))).reshape(shape)
    return jax.sharding.Mesh(devs, names)


def both_rules(port_mesh, shape, names, table: str = "TRAIN_RULES"):
    port = ShardingRules(port_mesh(shape, names), dict(globals()[table]))
    ref = JR.ShardingRules(jax_mesh(shape, names), dict(getattr(JR, table)))
    return port, ref


# --------------------------------------------------------------------------- #
# tests/test_sharding_and_roofline.py::TestShardingRules, mirrored
# --------------------------------------------------------------------------- #
class TestShardingRules:
    """Each expectation of the reference's test, held on the port and on the
    reference's own rules over the same mesh shape."""

    @pytest.fixture(autouse=True)
    def rules(self, port_mesh):
        self.port_mesh = port_mesh
        self.rules, self.ref = both_rules(port_mesh, (4, 2), ("data", "model"))

    def check(self, axes, shape, want, rules=None, ref=None):
        got = (rules or self.rules).spec(axes, shape)
        assert got == tuple(want)
        assert got == tuple((ref or self.ref).spec(axes, shape))

    def test_divisible_dims_shard(self):
        self.check(("fsdp", "tp"), (64, 32), P("data", "model"))

    def test_indivisible_falls_back_to_replicated(self):
        # 9 not divisible by model=2 -> None
        self.check(("fsdp", "tp"), (64, 9), P("data", None))

    def test_axis_used_once_per_tensor(self):
        # expert resolves to model; tp then may not reuse model.
        self.check(("expert", "fsdp", "tp"), (2, 64, 32), P("model", "data", None))

    def test_expert_fallback_lets_tp_take_model(self):
        # 5 experts don't divide model=2 -> expert replicated, tp gets model.
        self.check(("expert", "fsdp", "tp"), (5, 64, 32), P(None, "data", "model"))

    def test_missing_mesh_axis_skipped(self):
        # "batch" candidates ("pod","data"): no pod axis in this mesh.
        self.check(("batch", None), (8, 3), P("data", None))

    def test_multi_pod_axes_compose(self):
        rules, ref = both_rules(self.port_mesh, (2, 4, 2), ("pod", "data", "model"))
        self.check(("batch", None, "residual"), (16, 128, 64), P(("pod", "data"), None, "model"),
                   rules, ref)
        assert rules.sharding(("batch", None, "residual"), (16, 128, 64)).placements == (
            Shard(0), Shard(0), Shard(2))

    def test_decode_rules_shard_kv_seq(self):
        rules = ShardingRules(self.rules.mesh, dict(DECODE_RULES))
        ref = JR.ShardingRules(self.ref.mesh, dict(JR.DECODE_RULES))
        self.check(("batch", "kv_seq", None, None), (8, 4096, 8, 128),
                   P("data", "model", None, None), rules, ref)

    def test_constrain_noop_without_rules(self):
        x = torch.ones((4, 4))
        assert constrain(x, "batch", None) is x

    def test_constrain_applies_in_context(self):
        x = torch.ones((8, 64))

        with use_rules(ShardingRules(None)):
            assert constrain(x, "batch", None) is x


def test_tables_are_the_references():
    assert (TRAIN_RULES, DECODE_RULES, DECODE_TP_RULES) == (
        JR.TRAIN_RULES, JR.DECODE_RULES, JR.DECODE_TP_RULES)


def test_constrain_lays_out_under_a_mesh(port_mesh):
    """Under rules with a mesh, a plain tensor is distributed (this rank's
    rows) and a `DTensor` redistributed to the rules' placements."""
    mesh = port_mesh((4, 2), ("data", "model"))
    x = torch.arange(8 * 64, dtype=torch.float32).reshape(8, 64)
    with use_rules(ShardingRules(mesh)):
        d = constrain(x, "batch", None)
        assert isinstance(d, DTensor) and d.placements == (Shard(0), Replicate())
        assert torch.equal(d.to_local(), x[:2])
        e = constrain(d, "batch", "residual")
        assert e.placements == (Shard(0), Shard(1)) and e.shape == x.shape
    assert constrain(x, "batch", None) is x


def test_composite_axes_out_of_mesh_order_raise(port_mesh):
    """DTensor splits a dimension over mesh dims in the mesh's order; an
    axis tuple in another order has no placement that means it."""
    mesh = port_mesh((2, 2, 2), ("pod", "data", "model"))
    assert placements_of(mesh, (("pod", "data"), None)).placements == (
        Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        placements_of(mesh, (("data", "pod"), None))


# --------------------------------------------------------------------------- #
# Meshes
# --------------------------------------------------------------------------- #
def test_mesh_builders(port_mesh):
    """The production meshes' shapes and names, ranks in row-major order,
    and the host shard of a rank."""
    fake_group(256, rank=3)
    mesh = make_production_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (16, 16)
    assert tuple(mesh.get_coordinate()) == (0, 3)
    assert mesh_host_shard() == (3, 256)
    fake_group(512)
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    assert mesh.mesh_dim_names == ("pod", "data", "model") and tuple(mesh.shape) == (2, 16, 16)
    fake_group(8)
    mesh = make_debug_mesh(4, 2, device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (4, 2)


def test_mesh_needs_a_process_group_and_host_shard_defaults():
    """No group is started for the caller; one process alone is host 0 of 1."""
    assert not dist.is_initialized()
    assert mesh_host_shard() == (0, 1)
    with pytest.raises(RuntimeError, match="process group"):
        make_debug_mesh(1, 1, device_type="cpu")


def test_shard_order_over_composite_axes_is_jaxs(port_mesh):
    """P(("pod", "data"), "model") on a (2, 2, 2) mesh: the elements each
    device holds in JAX (8 forced host devices, in a process of their own)
    are the elements the port's rank of the same index holds."""
    script = textwrap.dedent("""
        import json, os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, numpy as np
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
        s = NamedSharding(mesh, P(("pod", "data"), "model"))
        out = {d.id: [[sl.start or 0, sl.stop if sl.stop is not None else n]
                      for sl, n in zip(idx, (8, 6))]
               for d, idx in s.devices_indices_map((8, 6)).items()}
        print(json.dumps(out))
    """)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": os.path.join(REPO, "src")}
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    want = {int(k): v for k, v in json.loads(res.stdout.strip().splitlines()[-1]).items()}
    assert sorted(want) == list(range(8))
    x = torch.arange(48).reshape(8, 6)
    for rank in range(8):
        mesh = port_mesh((2, 2, 2), ("pod", "data", "model"), rank=rank)
        s = placements_of(mesh, (("pod", "data"), "model"))
        got = distribute_tensor(x, mesh, s.placements, src_data_rank=None).to_local()
        (r0, r1), (c0, c1) = want[rank]
        assert torch.equal(got, x[r0:r1, c0:c1]), rank


# --------------------------------------------------------------------------- #
# Abstract trees at full size against the reference's
# --------------------------------------------------------------------------- #
def _spec_leaves(spec_tree, prefix=""):
    """(path, ParamSpec) of a nested-dict spec tree of either package."""
    for k in sorted(spec_tree):
        v = spec_tree[k]
        if isinstance(v, dict):
            yield from _spec_leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _check_leaf(got, want_shape, want_sharding, mesh, what):
    """A port abstract leaf against the reference's shape and sharding:
    the placements its spec means, and this rank's shard shape."""
    assert isinstance(got, DTensor), what
    assert got.device.type == "meta" and got.to_local().device.type == "meta", what
    assert tuple(got.shape) == tuple(want_shape), what
    assert got.placements == placements_of(mesh, tuple(want_sharding.spec)).placements, what
    assert tuple(got.to_local().shape) == tuple(want_sharding.shard_shape(tuple(want_shape))), what


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_param_specs_match_the_reference(port_mesh, name, mesh_name, table):
    """Every leaf of the full-size config: `spec` equals the reference's
    PartitionSpec, and `abstract_params` (and `param_shardings`) lay it
    out as that spec says, with the reference's shard shape on rank 0."""
    rules, ref = both_rules(port_mesh, *MESHES[mesh_name], TABLES[table])
    model = make_model(get_config(name))
    jmodel = jax_make_model(jax_get_config(name))
    ours, theirs = list(_spec_leaves(model.spec())), list(_spec_leaves(jmodel.spec()))
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    abstract = dict(zip([p for p, _ in ours], tree.flatten(model.abstract_params(rules))))
    jabstract = jax.tree_util.tree_leaves(jmodel.abstract_params(ref))
    for (path, s), (_, js), w in zip(ours, theirs, jabstract):
        assert rules.spec(s.axes, s.shape) == tuple(ref.spec(js.axes, js.shape)), path
        assert tuple(w.sharding.spec) == tuple(ref.spec(js.axes, js.shape)), path
        _check_leaf(abstract[path], w.shape, w.sharding, rules.mesh, path)
        assert str(abstract[path].dtype).removeprefix("torch.") == np.dtype(w.dtype).name


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_quantized_specs_match_the_reference(port_mesh, name, mesh_name):
    """`abstract_quantized_params` under DECODE_TP_RULES at full size: the
    reference's leaves in its order (q and scale), dtypes, placements and
    shard shapes; a scale unsharded along its collapsed axes."""
    rules, ref = both_rules(port_mesh, *MESHES[mesh_name], "DECODE_TP_RULES")
    got = tree.flatten(abstract_quantized_params(make_model(get_config(name)).spec(), rules))
    want = jax.tree_util.tree_leaves(
        JQ.abstract_quantized_params(jax_make_model(jax_get_config(name)).spec(), ref))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _check_leaf(g, w.shape, w.sharding, rules.mesh, i)
        assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name, i


def _cache_leaves(x, path=""):
    """(path, leaf) of a port cache tree in the reference's keystr spelling:
    dict keys as ``['k']``, dataclass fields as ``.name``."""
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _cache_leaves(x[k], f"{path}[{k!r}]")
    elif hasattr(x, "__dataclass_fields__"):
        for f in x.__dataclass_fields__:
            yield from _cache_leaves(getattr(x, f), f"{path}.{f}")
    else:
        yield path, x


@pytest.mark.parametrize("name", CONFIGS)
def test_abstract_decode_caches_match_the_reference(port_mesh, name):
    """`abstract_decode_caches(2, 16)`: the reference's tree (paths and
    leaf count: 3 a dense or MoE config, 4 mamba2, 6 whisper, 31 jamba),
    its shapes and dtypes, unsharded without rules; on the 16 x 16 mesh
    under DECODE_RULES the reference's shardings (a cache's host-side
    length has none, as the reference's length leaf has no axes)."""
    model, jmodel = make_model(get_config(name)), jax_make_model(jax_get_config(name))
    want = jax.tree_util.tree_flatten_with_path(jmodel.abstract_decode_caches(2, 16, None))[0]
    got = list(_cache_leaves(model.abstract_decode_caches(2, 16, None)))
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    assert len(got) == {"whisper-large-v3": 6, "mamba2-1.3b": 4,
                        "jamba-1.5-large-398b": 31}.get(name, 3)
    for (path, g), (_, w) in zip(got, want):
        if path.endswith(".length"):
            # The self-attention cache holds 15 valid positions, the cross cache 16.
            assert g == (16 if "cross" in path else 15), path
            assert w.shape == (jmodel.cfg.periods,), path
            continue
        assert g.device.type == "meta" and not isinstance(g, DTensor), path
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name, path

    rules, ref = both_rules(port_mesh, *MESHES["pod"], "DECODE_RULES")
    want = jax.tree_util.tree_leaves(jmodel.abstract_decode_caches(2, 16, ref))
    got = [g for _, g in _cache_leaves(model.abstract_decode_caches(2, 16, rules))]
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, int):
            assert w.sharding is None or all(a is None for a in w.sharding.spec), i
        else:
            _check_leaf(g, w.shape, w.sharding, rules.mesh, i)


@pytest.mark.parametrize("name", ["olmo-1b", "granite-moe-3b-a800m"])
def test_abstract_train_state_matches_the_reference(port_mesh, name):
    """A dense and an MoE config at full size on the 16 x 16 mesh: the
    reference's leaves in order (params, then step, m, v), moments like
    their parameters in the moments' dtype with the same placements, the
    step a 0-d int32."""
    from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
    from repro_torch.train import AdamWConfig

    rules, ref = both_rules(port_mesh, *MESHES["pod"])
    for cfg_port, cfg_ref in ((None, None), (AdamWConfig(moments_dtype="bfloat16"),
                                             JaxAdamWConfig(moments_dtype="bfloat16"))):
        got = tree.flatten(abstract_train_state(make_model(get_config(name)), rules,
                                                opt_cfg=cfg_port))
        want = jax.tree_util.tree_leaves(jax_abstract_train_state(
            jax_make_model(jax_get_config(name)), ref, opt_cfg=cfg_ref))
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name, i
            if w.shape == ():
                assert tuple(g.shape) == () and g.device.type == "meta"
                assert not isinstance(g, DTensor) and g.dtype == torch.int32
            else:
                _check_leaf(g, w.shape, w.sharding, rules.mesh, i)


def test_abstract_helpers_without_rules_are_meta_tensors():
    """No rules, no mesh: plain ``meta`` tensors, as the reference's
    ShapeDtypeStructs carry no sharding."""
    model = make_model(get_config("olmo-1b"))
    for leaf in tree.flatten(model.abstract_params()):
        assert type(leaf) is torch.Tensor and leaf.device.type == "meta"
    assert all(type(x) is torch.Tensor
               for x in tree.flatten(model.abstract_params(ShardingRules(None))))
    x = abstract_tensor((4, 6), torch.bfloat16)
    assert x.device.type == "meta" and x.dtype == torch.bfloat16 and tuple(x.shape) == (4, 6)
    shapes = {"w": torch.empty((4, 6), device="meta")}
    out = abstract_like(shapes, {"w": None}, None)
    assert type(out["w"]) is torch.Tensor and out["w"].device.type == "meta"


def test_sharded_abstract_tensor_on_every_rank(port_mesh):
    """A DTensor over a ``meta`` shard has the global shape and stride on
    every rank, and the shard shape of its rank's coordinate."""
    for rank in (0, 5):
        mesh = port_mesh((4, 2), ("data", "model"), rank=rank)
        s = NamedSharding(mesh, (Shard(1), Shard(0)))
        x = abstract_tensor((6, 8), torch.float32, s)
        assert isinstance(x, DTensor) and tuple(x.shape) == (6, 8) and x.stride() == (8, 1)
        assert tuple(x.to_local().shape) == (3, 2) and x.placements == s.placements
        with pytest.raises(ValueError, match="does not split"):
            abstract_tensor((7, 8), torch.float32, s)

